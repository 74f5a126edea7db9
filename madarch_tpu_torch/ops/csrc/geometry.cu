// Fused geometry kernel for Hopper (sm_90a): one thread per ray.
//
// Replaces the Pallas TPU kernel madarch_tpu/ops/march.py:_geometry_kernel
// (reached through pallas_geometry), in all three of its scene layouts:
// unrolled and rolled slots (spheres, planes, boxes) and the chunked
// triangle layout of meshes.  Per ray it runs the over-relaxed primary
// sphere trace, classifies the hit (nearest global primitive index and
// material id), takes the tetrahedron finite-difference normal, the AO
// probes, one penumbra march per light and the 8 probe-visibility marches;
// with REFL it also folds in the specular mode-2 reflection bounce (gate,
// reflect, march, classify, normal, shadows, visibility) and the best-probe
// pick.  An optional per-ray `enabled` mask (specular mode 3's reflection
// launch) keeps a ray from marching at all; ao_steps = 0 skips the AO probes.
//
// What bounds it: control flow and scene evaluations, not bytes.  A ray
// reads 28 bytes and, with one light, writes 72 (148 with REFL), but runs
// up to 300 march steps per march (1 + lights + 8 marches, twice with
// REFL), each step a scene evaluation.  The TPU kernel marched (8,128)
// tiles that exit only when their slowest lane does; here each thread
// exits its own loops (a warp still waits for its slowest lane).  The slot
// table, the triangle chunks' boxes, light positions and roughness sit in
// shared memory, read by every thread at the same address (a broadcast).
// Every live slot is evaluated exactly, with no culling.  Triangles (the
// TRIS variant) stay in device memory, ~124 KB for obj_mesh's 968, read
// through the read-only cache: shared memory that large would leave one
// block per SM.  They are pruned exactly by their chunk boxes
// (scene.cuh:tri_min), where the TPU kernel's culling gave margin lower
// bounds that moved the march.
//
// Built with -fmad=false so each float operation rounds like the plain
// PyTorch version (ops/march.py:geometry_reference), which composes the
// same marches from render/raymarch.py.  The scene evaluation and the
// marches live in scene.cuh, shared with march.cu.
#include <cuda_runtime.h>
#include <math.h>

#include "scene.cuh"

namespace {

constexpr int MAX_AO_STEPS = 8;

}  // namespace

// Mirrored field for field by ops/march.py:_GeomArgs (ctypes).
struct GeomArgs {
  const float* slots;   // f32[n_slots, SLOT_WIDTH]
  int n_slots;
  const float* tris;    // f32[n_chunks * CHUNK, TRI_WIDTH] (TRIS only)
  const float* boxes;   // f32[n_box_f]: scale row, super and chunk boxes
  int n_box_f;
  int n_chunks;
  int n_supers;
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
template <bool TRIS>
__device__ void fd_normal(const Scene& sc, float h, float px, float py,
                          float pz, float* nx, float* ny, float* nz) {
  const float f0 = scene_dist<TRIS>(sc, px + h, py - h, pz - h);
  const float f1 = scene_dist<TRIS>(sc, px - h, py - h, pz + h);
  const float f2 = scene_dist<TRIS>(sc, px - h, py + h, pz - h);
  const float f3 = scene_dist<TRIS>(sc, px + h, py + h, pz + h);
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
template <bool TRIS>
__device__ void shadow_block(const Scene& sc, const March& m,
                             const GeomArgs& a, const float* lpos,
                             float px, float py, float pz, float sx,
                             float sy, float sz, float nx, float ny,
                             float nz, bool hit, float* out, int i) {
  for (int li = 0; li < a.n_lights; ++li) {
    const float tlx = lpos[3 * li + 0] - px;
    const float tly = lpos[3 * li + 1] - py;
    const float tlz = lpos[3 * li + 2] - pz;
    const float ldist = sqrtf(tlx * tlx + tly * tly + tlz * tlz);
    const float inv = 1.f / fmaxf(ldist, 1e-9f);
    const float ldx = tlx * inv;
    const float ldy = tly * inv;
    const float ldz = tlz * inv;
    const float ndotl = nx * ldx + ny * ldy + nz * ldz;
    out[li * a.n + i] =
        march_shadow<TRIS>(sc, m, sx, sy, sz, ldx, ldy, ldz, 0.f, ldist,
                           hit && ndotl > a.ndotl_min);
  }
}

// The 8 probe-visibility marches to the clamped corners of the probe cell
// holding p (direction and distance from p, origin the offset point).
// With pick, also the mode-2 best probe: weight dot(dir, n)·vis from -BIG,
// strict > so the first corner wins a tie; emits -dir of the winner.
template <bool PICK, bool TRIS>
__device__ void vis_block(const Scene& sc, const March& m, const GeomArgs& a,
                          float px, float py, float pz, float sx, float sy,
                          float sz, float nx, float ny, float nz, bool hit,
                          float* out, int i, float* best_pid,
                          float* best_dir) {
  const float cellx = floorf(px / a.spx);
  const float celly = floorf(py / a.spy);
  const float cellz = floorf(pz / a.spz);
  const float fx = static_cast<float>(a.dimx);
  const float fxy = static_cast<float>(a.dimx * a.dimy);
  float bw = 0.f - BIG, bpid = 0.f, bdx = 0.f, bdy = 0.f, bdz = 0.f;
  for (int k = 0; k < 8; ++k) {
    const float cx = fminf(fmaxf(cellx + static_cast<float>(k & 1), 0.f),
                           static_cast<float>(a.dimx - 1));
    const float cy = fminf(fmaxf(celly + static_cast<float>((k >> 1) & 1),
                                 0.f),
                           static_cast<float>(a.dimy - 1));
    const float cz = fminf(fmaxf(cellz + static_cast<float>((k >> 2) & 1),
                                 0.f),
                           static_cast<float>(a.dimz - 1));
    const float wx = cx * a.spx - px;
    const float wy = cy * a.spy - py;
    const float wz = cz * a.spz - pz;
    const float pdist = fmaxf(sqrtf(wx * wx + wy * wy + wz * wz), 1e-6f);
    const float inv = 1.f / pdist;
    const float vdx = wx * inv;
    const float vdy = wy * inv;
    const float vdz = wz * inv;
    const float vis = march_visibility<TRIS>(
        sc, m, sx, sy, sz, vdx, vdy, vdz, pdist - a.surf_off, hit);
    out[k * a.n + i] = vis;
    if (PICK) {
      const float pid = cz * fxy + cy * fx + cx;
      const float w = (vdx * nx + vdy * ny + vdz * nz) * vis;
      if (w > bw) {
        bpid = pid;
        bdx = -vdx;
        bdy = -vdy;
        bdz = -vdz;
      }
      bw = fmaxf(bw, w);
    }
  }
  if (PICK) {
    best_pid[i] = bpid;
    best_dir[3 * i + 0] = bdx;
    best_dir[3 * i + 1] = bdy;
    best_dir[3 * i + 2] = bdz;
  }
}

template <bool REFL, bool TRIS>
__global__ void geometry_kernel(const GeomArgs a) {
  // shared memory: slot table, boxes (TRIS), light positions, roughness
  extern __shared__ float smem[];
  const int n_slot_f = a.n_slots * SLOT_WIDTH;
  const int n_box_f = TRIS ? a.n_box_f : 0;
  const int n_light_f = 3 * a.n_lights;
  const int n_rough = REFL ? a.n_mats : 0;
  float* s_slots = smem;
  float* s_boxes = s_slots + n_slot_f;
  float* s_lpos = s_boxes + n_box_f;
  float* s_rough = s_lpos + n_light_f;
  for (int j = threadIdx.x; j < n_slot_f + n_box_f + n_light_f + n_rough;
       j += blockDim.x) {
    int k = j;
    if (k < n_slot_f) {
      s_slots[k] = a.slots[k];
      continue;
    }
    k -= n_slot_f;
    if (k < n_box_f) {
      s_boxes[k] = a.boxes[k];
      continue;
    }
    k -= n_box_f;
    if (k < n_light_f) {
      s_lpos[k] = a.lpos[k];
      continue;
    }
    s_rough[k - n_light_f] = a.rough[k - n_light_f];
  }
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;

  const Scene sc{s_slots, a.n_slots, a.max_dist, a.tris, s_boxes,
                 a.n_chunks, a.n_supers};
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
  const float t = march_primary<TRIS>(sc, m, ox, oy, oz, dx, dy, dz, en);
  const float px = ox + t * dx;
  const float py = oy + t * dy;
  const float pz = oz + t * dz;
  int idx, mid;
  const float d_end = scene_info<TRIS>(sc, px, py, pz, &idx, &mid);
  const bool hit = en && d_end < a.eps && t < a.max_dist;
  float nx, ny, nz;
  fd_normal<TRIS>(sc, a.normal_h, px, py, pz, &nx, &ny, &nz);

  float ao = 1.f;
  if (a.ao_steps > 0) {
    float ao_sum = 0.f;
    for (int s = 0; s < a.ao_steps; ++s) {
      const float h = a.ao_h[s];
      const float factor = 1.f / static_cast<float>(1 << s);
      ao_sum = ao_sum + factor * scene_dist<TRIS>(sc, px + nx * h,
                                                   py + ny * h, pz + nz * h);
    }
    ao = 0.6f + 0.4f * ao_sum / a.ao_max_sum;
  }

  const float sox = px + nx * a.surf_off;
  const float soy = py + ny * a.surf_off;
  const float soz = pz + nz * a.surf_off;

  shadow_block<TRIS>(sc, m, a, s_lpos, px, py, pz, sox, soy, soz, nx, ny,
                     nz, hit, a.shadows, i);
  vis_block<false, TRIS>(sc, m, a, px, py, pz, sox, soy, soz, nx, ny, nz,
                         hit, a.vis8, i, nullptr, nullptr);

  a.t[i] = t;
  a.hit[i] = hit ? 1.f : 0.f;
  a.idx[i] = hit ? idx : -1;
  a.mid[i] = mid;
  a.normal[3 * i + 0] = nx;
  a.normal[3 * i + 1] = ny;
  a.normal[3 * i + 2] = nz;
  a.ao[i] = ao;

  if (!REFL) return;

  // ---- 2. reflection bounce (specular mode 2): roughness(mid) < 0.75 gate,
  // reflected ray from the offset primary hit
  const float rough = (mid >= 0 && mid < a.n_mats) ? s_rough[mid] : 0.f;
  const bool r_en = hit && rough < 0.75f;
  const float ddn = dx * nx + dy * ny + dz * nz;
  const float rdx = dx - 2.f * ddn * nx;
  const float rdy = dy - 2.f * ddn * ny;
  const float rdz = dz - 2.f * ddn * nz;
  const float r_t =
      march_primary<TRIS>(sc, m, sox, soy, soz, rdx, rdy, rdz, r_en);
  const float rpx = sox + r_t * rdx;
  const float rpy = soy + r_t * rdy;
  const float rpz = soz + r_t * rdz;
  int r_idx, r_mid;
  const float r_end = scene_info<TRIS>(sc, rpx, rpy, rpz, &r_idx, &r_mid);
  const bool r_hit = r_en && r_end < a.eps && r_t < a.max_dist;
  float rnx, rny, rnz;
  fd_normal<TRIS>(sc, a.normal_h, rpx, rpy, rpz, &rnx, &rny, &rnz);
  const float rsox = rpx + rnx * a.surf_off;
  const float rsoy = rpy + rny * a.surf_off;
  const float rsoz = rpz + rnz * a.surf_off;

  if (a.refl_shadows) {
    shadow_block<TRIS>(sc, m, a, s_lpos, rpx, rpy, rpz, rsox, rsoy, rsoz,
                       rnx, rny, rnz, r_hit, a.r_shadows, i);
  } else {
    for (int li = 0; li < a.n_lights; ++li) a.r_shadows[li * a.n + i] = 1.f;
  }
  vis_block<true, TRIS>(sc, m, a, rpx, rpy, rpz, rsox, rsoy, rsoz, rnx, rny,
                        rnz, r_hit, a.r_vis8, i, a.best_pid, a.best_dir);

  a.r_t[i] = r_t;
  a.r_hit[i] = r_hit ? 1.f : 0.f;
  a.r_mid[i] = r_mid;
  a.r_normal[3 * i + 0] = rnx;
  a.r_normal[3 * i + 1] = rny;
  a.r_normal[3 * i + 2] = rnz;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success); the
// triangle variant runs when the scene has triangle chunks.
extern "C" int madarch_geometry(const GeomArgs* a, int refl, void* stream) {
  if (a->n == 0) return 0;
  if (a->ao_steps > MAX_AO_STEPS) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  const int blocks = (a->n + threads - 1) / threads;
  const bool tris = a->n_chunks > 0;
  const size_t smem =
      sizeof(float) * (a->n_slots * SLOT_WIDTH + (tris ? a->n_box_f : 0) +
                       3 * a->n_lights + (refl ? a->n_mats : 0));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (refl && tris) {
    geometry_kernel<true, true><<<blocks, threads, smem, s>>>(*a);
  } else if (refl) {
    geometry_kernel<true, false><<<blocks, threads, smem, s>>>(*a);
  } else if (tris) {
    geometry_kernel<false, true><<<blocks, threads, smem, s>>>(*a);
  } else {
    geometry_kernel<false, false><<<blocks, threads, smem, s>>>(*a);
  }
  return static_cast<int>(cudaGetLastError());
}
