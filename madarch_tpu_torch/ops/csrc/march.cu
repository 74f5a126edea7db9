// Raycast, visibility and penumbra kernels for Hopper (sm_90a).
//
// raycast_kernel replaces the Pallas TPU kernel
// madarch_tpu/ops/march.py:_raycast_kernel (reached through
// pallas_raycast): the over-relaxed primary march to max_dist, then
// hit = d(o + t·d) < eps ∧ t < max_dist, both masked by `enabled`.  The
// volumetric scattering pass casts one such ray per scattering texel, and
// specular mode 1 one reflection ray per pixel.
// visibility_kernel replaces _visibility_kernel (pallas_visibility):
// 1 if the ray reaches its own max distance unblocked, else 0, with the
// same march; the froxel visibility pass casts one per froxel and light.
// softshadow_kernel replaces _softshadow_kernel (pallas_softshadows): the
// improved-penumbra march (omega = 1) from t0 = min_dist to max_dist,
// min(k·sqrt(d² − y²)/(t − y)) over its steps, 0 where it hits geometry;
// specular mode 1 marches 8 per pixel (k = 0.5) from the reflection hit
// back toward the probe-cell corners.
//
// What bounds them on this card.  A ray reads 25 to 33 bytes and writes 4
// or 5, and a step is one scene evaluation (some 76 float operations in
// the GI room); the bytes would take a few hundredths of a millisecond at
// the path's shapes.  What the kernels spend instead is instruction issue
// and latency: with -fmad=false a step issues some 150 instructions one by
// one, and a ray takes 1 to max_steps steps.  Measured at the path's full
// shapes (PERF.md §6), one thread a ray keeps 0.80 (5,120,000 penumbra
// rays) and 0.86 (640,000 reflection rays) of its lanes busy, so
// divergence costs the large launches a fifth at most; the 62,500-ray
// scattering launch, a few warps an SM, lasts as long as its longest ray's
// chain of dependent steps.
//
// The design: one thread a ray, each running scene.cuh's march
// (march_primary, march_visibility, march_shadow; G = 1), and a build of
// this file per scene layout.  For a scene without triangles whose typed
// runs fill at most 20 float4 rows the wrappers launch the library built
// with FIXED_SPHERES, FIXED_PLANES and FIXED_BOXES set to its counts
// (ops/march.py:march_layout, UNROLL_ROWS_MAX): scene_dist's slot loops
// unroll whole, with no loop control and no run-time counts, and ptxas
// keeps the rows in registers (some four a row); they evaluate the same
// slots in the same order, so the outputs are bit for bit the generic
// build's.  That cut a third to a half off the room scenes' launches; at
// 32 rows the registers (159 a thread) cost the penumbra launch more than
// they won.  Two other
// schedules were measured and lost at every shape (PERF.md §6): warps
// that refill their lanes from a ray counter (their ballots and shuffles
// cost more than the fifth of idle lanes they win back), and 8 lanes a ray
// (each lane repeats the ray's arithmetic, and every step waits on the
// shuffles).
//
// The visibility kernel (replacing _visibility_kernel).  Its marches are
// short and uneven: on light_shafts' 1,000,000 froxel rays 4.9 steps on
// average, 3 at the median, 11 at the 90th percentile and 143 at most,
// so one thread a ray keeps 0.51 of its lanes busy; on the lamp room's
// 294,912 radiance-corner rays (8 a probe point) 0.34, with quantiles
// 3/6/8/14 and 117 at most; on its 5,120,000 screen-corner rays 0.75 to
// 0.78 (PERF.md §6).  A ray reads 33 bytes and writes 4, and the froxel
// launch (0.06 ms) sits six times above that bound: what holds it is
// issue at that efficiency, not the bytes.  A two-phase schedule was
// built and timed against this one-phase kernel on the froxel rays and
// on one screen-corner launch (PERF.md §6): phase A marched every ray K
// steps and queued the rays still marching (one atomic a warp), phase B,
// a second launch sized to the card, marched them from step 0.  On the
// froxel rays it lost at every K from 4 to 48, by 0.012 to 0.032 ms
// (0.019 at K 48, with 1,214 rays in phase B); on the screen corners it
// tied at best (K 24).  There the step histogram promised little: half
// the lanes idle within the first 11 steps, where no compaction reaches,
// so the lane-steps issued fall by a tenth at best (K 16 to 24), while
// phase B lasts as long as its longest straggler's chain of some 140
// dependent steps on a card that is nearly empty, which the one-phase
// launch hides under the other warps' work.  The radiance-corner launch,
// where the histogram promised most (0.34 to 0.51 at K 4), was not timed
// with the split.  So the kernel stays one thread a ray in the layout's
// build, as raycast, in blocks of 128 threads (64 and 256 timed within a
// few per cent of it, PERF.md §6).
//
// The typed slot runs (and the chunks' boxes) sit in shared memory, read
// by every thread at the same address (a broadcast), up to 48 KiB; past
// that they are read in place from device memory (scene.cuh:Layout),
// which beat staging them after the opt-in (ops/march.py:OPTIN_KERNELS;
// a forced placement still takes it).  The chunked types (triangles;
// spheres and boxes of more than 64 slots) stay in device memory and are
// pruned exactly by their boxes (scene.cuh:chunk_min), so a march steps
// as the unculled plain version does.  On a scene whose every type has a
// global box (all bounded: ops/march.py:pack_scene; obj_mesh's
// triangles, not a scene with a plane) raycast and visibility end a ray
// at its exit from those boxes grown by 0.015 (scene.cuh:box_cap, the TPU
// kernels' _ray_box_cap), and a raycast miss so capped reports t =
// max_dist, as the TPU kernel's does.
// The penumbra march takes no cap (scene.cuh:march_shadow says why); the
// TPU penumbra kernel's cap and far-field skip for k >= 32 used a margin
// (0.15) below max_dist/k and darkened shadows.
//
// Each launch passes its own scene-distance cap: raycast caps at its
// max_dist, visibility and softshadows at 1e4 (as pallas_visibility and
// pallas_softshadows do); dead dynamic-count slots are packed inert.
#include <cuda_runtime.h>

// Each kernel here inlines one scene evaluation, and four slots in flight
// hide a slot's latency (scene.cuh).
#define SLOT_UNROLL 4

#include "scene.cuh"

// Mirrored field for field by ops/march.py:_MarchArgs (ctypes).
struct MarchArgs {
  SceneArgs scene;
  const float* origins;          // f32[n, 3]
  const float* dirs;             // f32[n, 3]
  const float* min_dists;        // f32[n] (softshadows)
  const float* max_dists;        // f32[n] (visibility, softshadows)
  const unsigned char* enabled;  // bool[n]
  int n;
  float max_dist;                // raycast's march budget
  float cap;                     // scene-distance cap
  float eps;
  int max_steps;
  float omega;
  float one_minus_omega;
  float k;                       // penumbra sharpness (softshadows)
  float* t;                      // f32[n] (raycast)
  unsigned char* hit;            // bool[n] (raycast)
  float* vis;                    // f32[n] (visibility: 0/1; softshadows)
};

namespace {

// The scene, staged in shared memory where L is STAGED, with
// scene-distance cap a.cap.  Every thread of the block takes part before
// any returns.
template <class L>
__device__ __forceinline__ Scene load_scene(const MarchArgs& a, float4* s) {
  const Scene sc = stage_scene<L>(a.scene, s, a.cap);
  if (L::STAGED) __syncthreads();
  return sc;
}

template <int CHUNKS, bool STAGED>
__global__ void raycast_kernel(const MarchArgs a) {
  using L = Layout<CHUNKS, STAGED>;
  extern __shared__ float4 smem[];
  const Scene sc = load_scene<L>(a, smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const Group<1> g;
  const March m{a.max_dist, a.eps, a.omega, a.one_minus_omega, 0.f,
                a.max_steps};
  const float ox = a.origins[3 * i + 0];
  const float oy = a.origins[3 * i + 1];
  const float oz = a.origins[3 * i + 2];
  const float dx = a.dirs[3 * i + 0];
  const float dy = a.dirs[3 * i + 1];
  const float dz = a.dirs[3 * i + 2];
  const bool en = a.enabled[i] != 0;
  const float cap = en ? box_cap(sc, ox, oy, oz, dx, dy, dz) : 0.f;
  const float t = march_primary<1, L>(sc, g, m, ox, oy, oz, dx, dy, dz,
                                      en, cap);
  bool hit = false;
  if (en && t < a.max_dist) {
    hit = scene_dist<1, L>(sc, g, ox + t * dx, oy + t * dy,
                           oz + t * dz) < a.eps;
  }
  a.t[i] = t;
  a.hit[i] = hit ? 1 : 0;
}

template <int CHUNKS, bool STAGED>
__global__ void visibility_kernel(const MarchArgs a) {
  using L = Layout<CHUNKS, STAGED>;
  extern __shared__ float4 smem[];
  const Scene sc = load_scene<L>(a, smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const March m{a.cap, a.eps, a.omega, a.one_minus_omega, 0.f, a.max_steps};
  const float ox = a.origins[3 * i + 0];
  const float oy = a.origins[3 * i + 1];
  const float oz = a.origins[3 * i + 2];
  const float dx = a.dirs[3 * i + 0];
  const float dy = a.dirs[3 * i + 1];
  const float dz = a.dirs[3 * i + 2];
  const bool en = a.enabled[i] != 0;
  const float cap = en ? box_cap(sc, ox, oy, oz, dx, dy, dz) : 0.f;
  a.vis[i] = march_visibility<1, L>(sc, Group<1>(), m, ox, oy, oz, dx, dy,
                                    dz, a.max_dists[i], en, cap);
}

template <int CHUNKS, bool STAGED>
__global__ void softshadow_kernel(const MarchArgs a) {
  using L = Layout<CHUNKS, STAGED>;
  extern __shared__ float4 smem[];
  const Scene sc = load_scene<L>(a, smem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const March m{a.cap, a.eps, 1.f, 0.f, a.k, a.max_steps};
  a.vis[i] = march_shadow<1, L>(
      sc, Group<1>(), m, a.origins[3 * i + 0], a.origins[3 * i + 1],
      a.origins[3 * i + 2], a.dirs[3 * i + 0], a.dirs[3 * i + 1],
      a.dirs[3 * i + 2], a.min_dists[i], a.max_dists[i], a.enabled[i] != 0);
}

// Each kernel's instantiations by chunk layout and placement.
#define MARCH_KERNEL(Name, kernel)                          \
  struct Name {                                             \
    template <int CHUNKS, bool STAGED>                      \
    static void (*get())(const MarchArgs) {                 \
      return kernel<CHUNKS, STAGED>;                        \
    }                                                       \
  };
MARCH_KERNEL(Raycast, raycast_kernel)
MARCH_KERNEL(Visibility, visibility_kernel)
MARCH_KERNEL(Softshadows, softshadow_kernel)
#undef MARCH_KERNEL

template <class K, int CHUNKS>
void (*placed_kernel(const MarchArgs& a))(const MarchArgs) {
  return a.scene.placement == PLACE_GLOBAL
             ? K::template get<CHUNKS, false>()
             : K::template get<CHUNKS, true>();
}

// Launches K's instantiation for the scene's chunk layout and placement;
// a layout's build has the chunkless ones only.
template <class K>
int launch(const MarchArgs* a, void* stream) {
  if (a->n == 0) return 0;
  const int threads = 128;
  const int blocks = (a->n + threads - 1) / threads;
  const size_t smem =
      sizeof(float4) * (scene_row4(a->scene) + scene_aabb4(a->scene));
#ifdef FIXED_SPHERES
  // a layout's build runs only scenes of that layout
  if (a->scene.n_spheres != FIXED_COUNTS[0] ||
      a->scene.n_planes != FIXED_COUNTS[1] ||
      a->scene.n_boxes != FIXED_COUNTS[2] || a->scene.n_chunks != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void (*kernel)(const MarchArgs) = placed_kernel<K, NO_CHUNKS>(*a);
#else
  const int chunks = scene_chunks(a->scene);
  void (*kernel)(const MarchArgs) =
      chunks == NO_CHUNKS    ? placed_kernel<K, NO_CHUNKS>(*a)
      : chunks == TRI_CHUNKS ? placed_kernel<K, TRI_CHUNKS>(*a)
                             : placed_kernel<K, ANY_CHUNKS>(*a);
#endif
  return launch_placed(kernel, *a, blocks, threads, smem, stream);
}

}  // namespace

// Each launches on `stream` and returns the launch's error (0 on success).
extern "C" int madarch_raycast(const MarchArgs* a, void* stream) {
  return launch<Raycast>(a, stream);
}

extern "C" int madarch_visibility(const MarchArgs* a, void* stream) {
  return launch<Visibility>(a, stream);
}

extern "C" int madarch_softshadows(const MarchArgs* a, void* stream) {
  return launch<Softshadows>(a, stream);
}
