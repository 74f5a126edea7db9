// Fused geometry kernel for Hopper (sm_90a): LANES lanes of a warp per ray.
//
// Replaces the Pallas TPU kernel madarch_tpu/ops/march.py:_geometry_kernel
// (reached through pallas_geometry), in all three of its scene layouts:
// unrolled and rolled slots (spheres, planes, boxes) and the chunked
// layout of meshes and of sphere and box types of more than 64 slots.
// Per ray it runs the over-relaxed primary sphere trace, classifies the
// hit (nearest global primitive index and material id), takes the
// tetrahedron finite-difference normal, the AO probes, one penumbra march
// per light and the 8 probe-visibility marches;
// with REFL it also folds in the specular mode-2 reflection bounce (gate,
// reflect, march, classify, normal, shadows, visibility) and the best-probe
// pick.  An optional per-ray `enabled` mask (specular mode 3's reflection
// launch) keeps a ray from marching at all; ao_steps = 0 skips the AO probes.
//
// What bounds it: latency and control flow, not bytes or arithmetic.  A ray
// reads 28 bytes and, with one light, writes 72 (148 with REFL), but runs
// up to 300 march steps per march (1 + lights + 8 marches, twice with
// REFL), each step a scene evaluation whose running minimum makes every
// box test wait for the one before.  One thread per ray left a warp
// executing the union of what its 32 rays admitted, and a launch of a few
// ten thousand rays left most of the card's 132 SMs idle.  So a group of
// LANES lanes shares one ray (scene.cuh): each lane holds the ray's whole
// state and only the scene evaluation is split, a box, a triangle or a
// slot a lane.  A warp then diverges on 32 / LANES rays, an evaluation is
// a few short rounds, and a launch has LANES times the threads.  The
// library is built once per LANES (ops/build.py); the wrapper picks the
// build from the scene's layout and the ray count (ops/march.py).
//
// A ray that hits nothing pays none of the hit's fixed work: its normal is
// the reversed ray direction and its AO 1 (the plain version defines the
// same), so the four normal and the AO evaluations run on hits only.  The
// hit's index and material id are classified only on a bounce that can
// hit: one that is enabled and whose march ended short of max_dist.  Any
// other bounce (a capped miss, a disabled or gated-off reflection) reports
// index -1 and material 0 without evaluating the scene at its end point,
// where pruning would open most chunks; the plain version classifies every
// bounce, and the two differ only in the material of a non-hit, which no
// consumer reads.  On a scene
// whose every type has a global box (obj_mesh's triangles) the primary,
// reflection and probe-visibility marches end at the ray's exit from the
// grown boxes (scene.cuh:box_cap, the TPU kernel's _ray_box_cap), a ray
// that misses them does not march, and a miss so capped reports t =
// max_dist; the penumbra marches go to the light (scene.cuh:march_shadow).
//
// The typed slot runs, the chunk boxes, light positions and roughness sit
// in shared memory: up to 48 KiB as is, past that after the opt-in, and
// past the card's opt-in limit (227 KiB on an H100) they are read in place
// from device memory through the read-only path, an instantiation of its
// own (scene.cuh:Layout).  The chunk table (~108 KB for obj_mesh's 968
// triangles) stays in device memory behind the read-only cache.  Every
// typed slot is evaluated exactly; the chunked types (triangles, and
// spheres and boxes of more than 64 slots, the TPU kernel's chunked
// layout) are pruned exactly by their boxes (scene.cuh:chunk_min), where
// the TPU kernel's culling gave margin lower bounds that moved the march.
//
// Built with COUNT_WORK, which no path of the package does, the kernel sums
// the scene evaluations, box tests and chunk-slot evaluations of the
// launch, and the bounces whose classification it skipped.
//
// Built with -fmad=false so each float operation rounds like the plain
// PyTorch version (ops/march.py:geometry_reference), which composes the
// same marches from render/raymarch.py.
#include <cuda_runtime.h>
#include <math.h>

#include "scene.cuh"

#ifndef LANES
#define LANES 1
#endif

namespace {

constexpr int MAX_AO_STEPS = 8;
constexpr int THREADS = 128;

}  // namespace

// Mirrored field for field by ops/march.py:_GeomArgs (ctypes).
struct GeomArgs {
  SceneArgs scene;
  const float* lpos;    // f32[3 * n_lights]
  int n_lights;
  const float* rough;   // f32[n_mats] (REFL only)
  int n_mats;
  const float* origins; // f32[n, 3]
  const float* dirs;    // f32[n, 3]
  const unsigned char* enabled;  // bool[n]; null: every ray
  int n;
  float max_dist;
  float eps;
  int max_steps;
  float omega;
  float one_minus_omega;
  float shadow_k;
  float surf_off;
  float ndotl_min;
  float normal_h;
  int ao_steps;
  float ao_h[MAX_AO_STEPS];
  float ao_max_sum;
  float spx, spy, spz;
  int dimx, dimy, dimz;
  int refl_shadows;
  int want_shadows;     // 0: skip the primary's penumbra marches (ones)
  int want_vis;         // 0: skip its 8 probe-visibility marches (ones)
  // primary outputs
  float* t;
  float* hit;
  int* idx;
  int* mid;
  float* normal;        // f32[n, 3]
  float* ao;
  float* shadows;       // f32[n_lights, n]
  float* vis8;          // f32[8, n]
  // reflection outputs (REFL only)
  float* r_t;
  float* r_hit;
  int* r_mid;
  float* r_normal;      // f32[n, 3]
  float* r_shadows;     // f32[n_lights, n]
  float* r_vis8;        // f32[8, n]
  float* best_pid;
  float* best_dir;      // f32[n, 3]
};

namespace {

// Tetrahedron finite-difference normal of the scene SDF.
template <int G, class L>
__device__ void fd_normal(const Scene& sc, const Group<G>& g, float h,
                          float px, float py, float pz, float* nx, float* ny,
                          float* nz) {
  const float f0 = scene_dist<G, L>(sc, g, px + h, py - h, pz - h);
  const float f1 = scene_dist<G, L>(sc, g, px - h, py - h, pz + h);
  const float f2 = scene_dist<G, L>(sc, g, px - h, py + h, pz - h);
  const float f3 = scene_dist<G, L>(sc, g, px + h, py + h, pz + h);
  const float gx = f0 - f1 - f2 + f3;
  const float gy = -f0 - f1 + f2 + f3;
  const float gz = -f0 + f1 - f2 + f3;
  const float norm = sqrtf(gx * gx + gy * gy + gz * gz + 1e-24f);
  *nx = gx / norm;
  *ny = gy / norm;
  *nz = gz / norm;
}

// Per-light penumbra: origin (sx,sy,sz) is the offset surface point, the
// light direction and distance come from the un-offset point p; enabled
// only where n·l > ndotl_min.
template <int G, class L>
__device__ void shadow_block(const Scene& sc, const Group<G>& g,
                             const March& m, const GeomArgs& a,
                             const float* lpos, float px, float py, float pz,
                             float sx, float sy, float sz, float nx, float ny,
                             float nz, bool hit, float* out, int i) {
  for (int li = 0; li < a.n_lights; ++li) {
    const float tlx = ld<L>(lpos + 3 * li + 0) - px;
    const float tly = ld<L>(lpos + 3 * li + 1) - py;
    const float tlz = ld<L>(lpos + 3 * li + 2) - pz;
    const float ldist = sqrtf(tlx * tlx + tly * tly + tlz * tlz);
    const float inv = 1.f / fmaxf(ldist, 1e-9f);
    const float ldx = tlx * inv;
    const float ldy = tly * inv;
    const float ldz = tlz * inv;
    const float ndotl = nx * ldx + ny * ldy + nz * ldz;
    const float sh =
        march_shadow<G, L>(sc, g, m, sx, sy, sz, ldx, ldy, ldz, 0.f,
                              ldist, hit && ndotl > a.ndotl_min);
    if (g.lane == 0) out[li * a.n + i] = sh;
  }
}

// Corner k of the probe cell holding p, clamped to the grid: its probe id
// and the direction and distance to it from p.
struct Corner {
  float pid, vdx, vdy, vdz, pdist;
};

__device__ __forceinline__ Corner probe_corner(const GeomArgs& a, int k,
                                               float px, float py,
                                               float pz) {
  const float cx = fminf(fmaxf(floorf(px / a.spx) +
                               static_cast<float>(k & 1), 0.f),
                         static_cast<float>(a.dimx - 1));
  const float cy = fminf(fmaxf(floorf(py / a.spy) +
                               static_cast<float>((k >> 1) & 1), 0.f),
                         static_cast<float>(a.dimy - 1));
  const float cz = fminf(fmaxf(floorf(pz / a.spz) +
                               static_cast<float>((k >> 2) & 1), 0.f),
                         static_cast<float>(a.dimz - 1));
  const float wx = cx * a.spx - px;
  const float wy = cy * a.spy - py;
  const float wz = cz * a.spz - pz;
  Corner c;
  c.pdist = fmaxf(sqrtf(wx * wx + wy * wy + wz * wz), 1e-6f);
  const float inv = 1.f / c.pdist;
  c.vdx = wx * inv;
  c.vdy = wy * inv;
  c.vdz = wz * inv;
  c.pid = cz * static_cast<float>(a.dimx * a.dimy) +
          cy * static_cast<float>(a.dimx) + cx;
  return c;
}

// The 8 probe-visibility marches to the clamped corners of the probe cell
// holding p (direction and distance from p, origin the offset point).
// With pick, also the mode-2 best probe: weight dot(dir, n)·vis from -BIG,
// strict > so the first corner wins a tie; emits -dir of the winner.
template <bool PICK, int G, class L>
__device__ void vis_block(const Scene& sc, const Group<G>& g, const March& m,
                          const GeomArgs& a, float px, float py, float pz,
                          float sx, float sy, float sz, float nx, float ny,
                          float nz, bool hit, float* out, int i,
                          float* best_pid, float* best_dir) {
  float bw = 0.f - BIG, bpid = 0.f, bdx = 0.f, bdy = 0.f, bdz = 0.f;
  for (int k = 0; k < 8; ++k) {
    const Corner c = probe_corner(a, k, px, py, pz);
    const float cap =
        hit ? box_cap(sc, sx, sy, sz, c.vdx, c.vdy, c.vdz) : 0.f;
    const float vis = march_visibility<G, L>(
        sc, g, m, sx, sy, sz, c.vdx, c.vdy, c.vdz, c.pdist - a.surf_off,
        hit, cap);
    if (g.lane == 0) out[k * a.n + i] = vis;
    if (PICK) {
      const float w = (c.vdx * nx + c.vdy * ny + c.vdz * nz) * vis;
      if (w > bw) {
        bpid = c.pid;
        bdx = -c.vdx;
        bdy = -c.vdy;
        bdz = -c.vdz;
      }
      bw = fmaxf(bw, w);
    }
  }
  if (PICK && g.lane == 0) {
    best_pid[i] = bpid;
    best_dir[3 * i + 0] = bdx;
    best_dir[3 * i + 1] = bdy;
    best_dir[3 * i + 2] = bdz;
  }
}

// One bounce from (o, d): the march, the classification of its end point
// where the bounce can hit, and on a hit the FD normal; on a miss the
// normal is -d.
template <int G, class L>
__device__ void bounce(const Scene& sc, const Group<G>& g, const March& m,
                       const GeomArgs& a, float ox, float oy, float oz,
                       float dx, float dy, float dz, bool en, float* t,
                       float* px, float* py, float* pz, bool* hit, int* idx,
                       int* mid, float* nx, float* ny, float* nz) {
  const float cap = en ? box_cap(sc, ox, oy, oz, dx, dy, dz) : 0.f;
  *t = march_primary<G, L>(sc, g, m, ox, oy, oz, dx, dy, dz, en, cap);
  *px = ox + *t * dx;
  *py = oy + *t * dy;
  *pz = oz + *t * dz;
  // A hit needs en and t < max_dist whatever the end point's distance, so
  // a bounce without them is no hit and is not classified: index -1 and
  // material 0, scene_info's answer where nothing lies under max_dist.
  // Every lane of the group holds the ray's en and t alike, so the group
  // takes one branch and scene_info's shuffles name all its lanes.
  *hit = false;
  *idx = -1;
  *mid = 0;
  if (en && *t < a.max_dist) {
    *hit = scene_info<G, L>(sc, g, *px, *py, *pz, idx, mid) < a.eps;
  } else if (g.lane == 0) {
    count_work(sc, 3, 1);
  }
  *nx = -dx;
  *ny = -dy;
  *nz = -dz;
  if (*hit) fd_normal<G, L>(sc, g, a.normal_h, *px, *py, *pz, nx, ny, nz);
}

template <int G, bool REFL, int CHUNKS, bool STAGED>
__global__ void geometry_kernel(const GeomArgs a) {
  using L = Layout<CHUNKS, STAGED>;
  // shared memory, STAGED: the typed slot runs, boxes (with chunks), light
  // positions, roughness
  extern __shared__ float4 smem[];
  Scene sc = stage_scene<L>(a.scene, smem, a.max_dist);
  const float* lpos = a.lpos;
  const float* rough = a.rough;
  if (STAGED) {
    const int n_light_f = 3 * a.n_lights;
    const int n_rough = REFL ? a.n_mats : 0;
    float4* s_end = smem + scene_row4(a.scene) +
                    (CHUNKS != NO_CHUNKS ? scene_aabb4(a.scene) : 0);
    float* s_lpos = reinterpret_cast<float*>(s_end);
    float* s_rough = s_lpos + n_light_f;
    for (int j = threadIdx.x; j < n_light_f + n_rough; j += blockDim.x) {
      s_lpos[j] = j < n_light_f ? a.lpos[j] : a.rough[j - n_light_f];
    }
    __syncthreads();
    lpos = s_lpos;
    rough = s_rough;
  }

  // the lanes of a group share ray i and leave together
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (i >= a.n) return;
  const Group<G> g;
  const bool writer = g.lane == 0;
#ifdef COUNT_WORK
  unsigned long long work[4] = {0, 0, 0, 0};
  sc.work = work;
#endif

  const March m{a.max_dist, a.eps, a.omega, a.one_minus_omega, a.shadow_k,
                a.max_steps};
  const float ox = a.origins[3 * i + 0];
  const float oy = a.origins[3 * i + 1];
  const float oz = a.origins[3 * i + 2];
  const float dx = a.dirs[3 * i + 0];
  const float dy = a.dirs[3 * i + 1];
  const float dz = a.dirs[3 * i + 2];

  // ---- 1. primary bounce; a disabled ray stays at t = 0, is no hit and so
  // enables none of the marches below
  const bool en = a.enabled == nullptr || a.enabled[i] != 0;
  float t, px, py, pz, nx, ny, nz;
  bool hit;
  int idx, mid;
  bounce<G, L>(sc, g, m, a, ox, oy, oz, dx, dy, dz, en, &t, &px, &py, &pz,
                  &hit, &idx, &mid, &nx, &ny, &nz);

  float ao = 1.f;
  if (hit && a.ao_steps > 0) {
    float ao_sum = 0.f;
    for (int s = 0; s < a.ao_steps; ++s) {
      const float h = a.ao_h[s];
      const float factor = 1.f / static_cast<float>(1 << s);
      ao_sum = ao_sum + factor * scene_dist<G, L>(
                                     sc, g, px + nx * h, py + ny * h,
                                     pz + nz * h);
    }
    ao = 0.6f + 0.4f * ao_sum / a.ao_max_sum;
  }

  const float sox = px + nx * a.surf_off;
  const float soy = py + ny * a.surf_off;
  const float soz = pz + nz * a.surf_off;

  if (a.want_shadows) {
    shadow_block<G, L>(sc, g, m, a, lpos, px, py, pz, sox, soy, soz, nx,
                          ny, nz, hit, a.shadows, i);
  } else if (writer) {
    for (int li = 0; li < a.n_lights; ++li) a.shadows[li * a.n + i] = 1.f;
  }
  if (a.want_vis) {
    vis_block<false, G, L>(sc, g, m, a, px, py, pz, sox, soy, soz, nx, ny,
                              nz, hit, a.vis8, i, nullptr, nullptr);
  } else if (writer) {
    for (int k = 0; k < 8; ++k) a.vis8[k * a.n + i] = 1.f;
  }

  if (writer) {
    a.t[i] = t;
    a.hit[i] = hit ? 1.f : 0.f;
    a.idx[i] = hit ? idx : -1;
    a.mid[i] = mid;
    a.normal[3 * i + 0] = nx;
    a.normal[3 * i + 1] = ny;
    a.normal[3 * i + 2] = nz;
    a.ao[i] = ao;
  }

  if (REFL) {
    // ---- 2. reflection bounce (specular mode 2): roughness(mid) < 0.75
    // gate, reflected ray from the offset primary hit
    const float r_rough =
        (mid >= 0 && mid < a.n_mats) ? ld<L>(rough + mid) : 0.f;
    const bool r_en = hit && r_rough < 0.75f;
    const float ddn = dx * nx + dy * ny + dz * nz;
    const float rdx = dx - 2.f * ddn * nx;
    const float rdy = dy - 2.f * ddn * ny;
    const float rdz = dz - 2.f * ddn * nz;
    float r_t, rpx, rpy, rpz, rnx, rny, rnz;
    bool r_hit;
    int r_idx, r_mid;
    bounce<G, L>(sc, g, m, a, sox, soy, soz, rdx, rdy, rdz, r_en, &r_t,
                    &rpx, &rpy, &rpz, &r_hit, &r_idx, &r_mid, &rnx, &rny,
                    &rnz);
    const float rsox = rpx + rnx * a.surf_off;
    const float rsoy = rpy + rny * a.surf_off;
    const float rsoz = rpz + rnz * a.surf_off;

    if (a.refl_shadows) {
      shadow_block<G, L>(sc, g, m, a, lpos, rpx, rpy, rpz, rsox, rsoy,
                            rsoz, rnx, rny, rnz, r_hit, a.r_shadows, i);
    } else if (writer) {
      for (int li = 0; li < a.n_lights; ++li) {
        a.r_shadows[li * a.n + i] = 1.f;
      }
    }
    vis_block<true, G, L>(sc, g, m, a, rpx, rpy, rpz, rsox, rsoy, rsoz,
                             rnx, rny, rnz, r_hit, a.r_vis8, i, a.best_pid,
                             a.best_dir);

    if (writer) {
      a.r_t[i] = r_t;
      a.r_hit[i] = r_hit ? 1.f : 0.f;
      a.r_mid[i] = r_mid;
      a.r_normal[3 * i + 0] = rnx;
      a.r_normal[3 * i + 1] = rny;
      a.r_normal[3 * i + 2] = rnz;
    }
  }

#ifdef COUNT_WORK
  for (int k = 0; k < 4; ++k) {
    if (work[k]) atomicAdd(a.scene.work + k, work[k]);
  }
#endif
}

}  // namespace

namespace {

// The instantiation for the scene's chunk layout and placement.
template <bool REFL, int CHUNKS>
void (*placed_kernel(const GeomArgs& a))(const GeomArgs) {
  return a.scene.placement == PLACE_GLOBAL
             ? geometry_kernel<LANES, REFL, CHUNKS, false>
             : geometry_kernel<LANES, REFL, CHUNKS, true>;
}

template <bool REFL>
void (*pick_kernel(const GeomArgs& a))(const GeomArgs) {
  switch (scene_chunks(a.scene)) {
    case NO_CHUNKS:
      return placed_kernel<REFL, NO_CHUNKS>(a);
    case TRI_CHUNKS:
      return placed_kernel<REFL, TRI_CHUNKS>(a);
    default:
      return placed_kernel<REFL, ANY_CHUNKS>(a);
  }
}

}  // namespace

// Launches on `stream` and returns the launch's error (0 on success): the
// instantiation for the scene's chunk layout and placement, after the
// opt-in where the placement asks for it.
extern "C" int madarch_geometry(const GeomArgs* a, int refl, void* stream) {
  if (a->n == 0) return 0;
  if (a->ao_steps > MAX_AO_STEPS ||
      a->n > (0x7fffffff - THREADS) / LANES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rays = THREADS / LANES;
  const int blocks = (a->n + rays - 1) / rays;
  const size_t smem =
      sizeof(float4) * (scene_row4(a->scene) + scene_aabb4(a->scene)) +
      sizeof(float) * (3 * a->n_lights + (refl ? a->n_mats : 0));
  return launch_placed(refl ? pick_kernel<true>(*a) : pick_kernel<false>(*a),
                       *a, blocks, THREADS, smem, stream);
}
