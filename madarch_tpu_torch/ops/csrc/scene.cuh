// Scene evaluation and the sphere-tracing marches shared by the kernels of
// this directory (geometry.cu, march.cu): a group of G lanes of one warp
// works on one ray (G = 1: one thread per ray).
//
// What held the thread-per-ray evaluation back on an H100 was control flow
// and latency, not arithmetic: a warp ran the union of the triangle chunks
// its 32 rays admitted, each chunk a serial chain of 8 dependent row loads,
// and a launch of a few ten thousand rays left most of the card idle.  So
// the lanes of a group share one ray: every lane holds the whole state of
// the ray and takes the same branches, and only the scene evaluation is
// split, one box, triangle or slot a lane, folded with xor shuffles that
// leave the same bits in every lane.  No lane of a group can leave a loop
// its partners stay in, so every shuffle names exactly the group's lanes
// (Group::mask); the groups of a warp diverge from each other freely.
//
// The scene is what ops/march.py:pack_scene packs:
//  - `rows`, float4 rows in three typed runs: spheres (center, radius),
//    planes (normal, offset), boxes (all centers, then all half-sides).
//    Three branch-free loops read them, a lane every G-th row.  A dead
//    slot (past a dynamic count) is packed so that its distance is about
//    1e9 and never wins a minimum that starts at max_dist;
//  - `info`, int2 (global index, material id) per slot in run order, then
//    per chunk slot: read only where a hit is classified;
//  - `chunks`, the chunked types (triangles; spheres and boxes of more
//    than 64 slots, where the TPU kernels chunk them), per chunk of CHUNK
//    slots of one type TRI_ROWS x CHUNK float4: row k of all CHUNK slots,
//    then row k + 1 (a triangle's 28 derived constants; a sphere's
//    (center, radius) in row 0; a box's center and half-side in rows 0
//    and 1), so the lanes of a group load one 128-byte line per row.  The
//    chunks run spheres, boxes, triangles (box_chunk0 and tri_chunk0 mark
//    where each run begins), each run but the last padded with inert
//    chunks to whole super-chunks.  It stays in device memory behind the
//    read-only cache;
//  - `aabbs`, two float4 (lo, hi) per box: first a row holding the
//    coordinate scale, then the super-chunk boxes (SUPER chunks each),
//    then the chunk boxes; padded and dead slots make inert boxes.
//
// Where a launch keeps `rows` and `aabbs` is its placement (the wrappers'
// choice, ops/march.py:placement_for): staged into shared memory, up to
// 48 KiB as is and past that after the opt-in (allow_smem; the geometry
// kernel), or read in place from device memory through the read-only
// path (the march kernels past 48 KiB, every kernel past the card's
// opt-in limit).  STAGED, a template argument (Layout), decides it at
// build time, so every staged load stays a shared-memory load.
//
// Chunked slots are pruned exactly.  A box's point-to-box distance bounds
// every slot in it from below, so a box whose bound exceeds the running
// minimum cannot change the minimum.  chunk_min tests the super-chunk
// boxes a lane each and opens them nearest bound first while the bound is
// within `slack` of the running minimum; an opened super-chunk's chunk
// boxes are tested a lane each and its chunks taken nearest bound first,
// each re-checked against the running minimum, its slots evaluated a lane
// each with their type's distance.  The slack (PRUNE_REL times the
// scene's and the point's coordinate scale) covers the rounding of a
// bound and of a slot's distance, and fminf is exact in any order, so the
// pruned minimum is the unpruned one bit for bit.  Ties go to the lower
// global index in every fold: the first minimum of the plain version's
// spec-order scan.
//
// Built with -fmad=false, so each float operation rounds like the plain
// PyTorch marches of render/raymarch.py.  The scene functions and marches
// are templates on a Layout: scenes without chunks compile without the
// pruning code, and scenes whose chunks are all triangles without the
// sphere and box chunk code.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>

#include <mutex>
#include <vector>

// SLOT_UNROLL: how far scene_dist's three slot loops are unrolled, set by
// the including source.  Rolled (1, the default) suits geometry.cu, whose
// marches inline the evaluation some 25 times: unrolled four-fold its
// screen passes took up to three times as long.  march.cu, with one
// evaluation a kernel, sets 4.
#ifndef SLOT_UNROLL
#define SLOT_UNROLL 1
#endif

namespace {

constexpr int CHUNK = 8;      // slots per chunk box
constexpr int SUPER = 8;      // chunks per super-chunk box
constexpr int TRI_ROWS = 7;   // float4 rows of a triangle's 28 constants
constexpr float PRUNE_REL = 1e-4f;
// The dynamic shared memory a block gets without an opt-in
// (ops/march.py:SMEM_LIMIT).
constexpr size_t SMEM_DEFAULT = 48 * 1024;
constexpr float BIG = 1e9f;
// FIXED_SPHERES, FIXED_PLANES and FIXED_BOXES, set together by a build for
// one scene layout (ops/march.py:march_layout), fix scene_dist's loop
// bounds at build time: the loops unroll whole and evaluate the same slots
// in the same order.
#ifdef FIXED_SPHERES
constexpr int FIXED_COUNTS[3] = {FIXED_SPHERES, FIXED_PLANES, FIXED_BOXES};
constexpr int SLOT_UNROLL_N = FIXED_SPHERES + FIXED_PLANES + FIXED_BOXES;
#else
constexpr int SLOT_UNROLL_N = SLOT_UNROLL;
#endif

// The chunk layouts a kernel is built for: no chunks, triangle chunks
// only, or chunks of any chunked type (each chunk's type from its index).
constexpr int NO_CHUNKS = 0;
constexpr int TRI_CHUNKS = 1;
constexpr int ANY_CHUNKS = 2;
// The placements of ops/march.py:PLACEMENTS.
constexpr int PLACE_STAGED = 0;
constexpr int PLACE_OPTIN = 1;
constexpr int PLACE_GLOBAL = 2;

// What a kernel instantiation is built for: its chunk layout, and whether
// `rows` and `aabbs` are staged in shared memory (else read in place).
template <int CHUNKS_, bool STAGED_>
struct Layout {
  static constexpr int CHUNKS = CHUNKS_;
  static constexpr bool STAGED = STAGED_;
};

// A load from the staged tables: shared memory, or the read-only path.
template <class L>
__device__ __forceinline__ float4 ld(const float4* p) {
  if constexpr (L::STAGED) {
    return *p;
  } else {
    return __ldg(p);
  }
}

template <class L>
__device__ __forceinline__ float ld(const float* p) {
  if constexpr (L::STAGED) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// The scene's tables as the wrappers pass them; mirrored field for field
// by ops/march.py:_SceneArgs (ctypes).
struct SceneArgs {
  const float4* rows;   // [n_spheres + n_planes + 2 n_boxes]
  int n_spheres;
  int n_planes;
  int n_boxes;
  const int2* info;     // [slots + n_chunks * CHUNK]
  const float4* chunks; // [n_chunks][TRI_ROWS][CHUNK]
  const float4* aabbs;  // [1 + n_supers + n_chunks][2]
  int n_chunks;
  int n_supers;
  // the first box chunk and the first triangle chunk (chunks before
  // box_chunk0 hold spheres)
  int box_chunk0;
  int tri_chunk0;
  // the grown global box of each bounded type (lo xyz, hi xyz), by which
  // a march ends at the ray's exit from the scene (box_cap); none on a
  // scene that is not all bounded, or with the cap turned off
  const float* cap_boxes;  // [n_cap_boxes][6]
  int n_cap_boxes;
  int placement;        // PLACE_STAGED, PLACE_OPTIN or PLACE_GLOBAL
  // scene evaluations, box tests, chunk-slot evaluations and bounces not
  // classified, summed over the launch by geometry.cu built with
  // COUNT_WORK; else unused
  unsigned long long* work;
};

// The scene as a kernel reads it: `rows` and `aabbs` in shared memory, or
// in device memory where the layout is not STAGED.  max_dist caps every
// scene distance.
struct Scene {
  const float4* rows;
  int n_spheres, n_planes, n_boxes;
  float max_dist;
  const int2* info;
  const float4* chunks;
  const float4* aabbs;
  int n_chunks, n_supers;
  int box_chunk0, tri_chunk0;
  const float* cap_boxes;
  int n_cap_boxes;
#ifdef COUNT_WORK
  // this thread's scene evaluations, box tests, chunk-slot evaluations and
  // bounces not classified
  unsigned long long* work;
#endif
};

// float4s of the typed runs and of the boxes.
__host__ __device__ inline int scene_row4(const SceneArgs& a) {
  return a.n_spheres + a.n_planes + 2 * a.n_boxes;
}

__host__ __device__ inline int scene_aabb4(const SceneArgs& a) {
  return a.n_chunks > 0 ? 2 * (1 + a.n_supers + a.n_chunks) : 0;
}

// The chunk layout of the scene a launch is given.
__host__ inline int scene_chunks(const SceneArgs& a) {
  if (a.n_chunks == 0) return NO_CHUNKS;
  return a.tri_chunk0 == 0 ? TRI_CHUNKS : ANY_CHUNKS;
}

// The scene with scene-distance cap max_dist.  STAGED, it copies the typed
// runs and, with chunks, the boxes into shared memory at s, and the caller
// synchronises the block before the first evaluation; else the scene
// points at the tables in device memory.
template <class L>
__device__ __forceinline__ Scene stage_scene(const SceneArgs& a, float4* s,
                                             float max_dist) {
  const int n_row4 = scene_row4(a);
  if (L::STAGED) {
    const int n4 = n_row4 + (L::CHUNKS != NO_CHUNKS ? scene_aabb4(a) : 0);
    for (int j = threadIdx.x; j < n4; j += blockDim.x) {
      s[j] = j < n_row4 ? a.rows[j] : a.aabbs[j - n_row4];
    }
  }
  Scene sc;
  sc.rows = L::STAGED ? s : a.rows;
  sc.n_spheres = a.n_spheres;
  sc.n_planes = a.n_planes;
  sc.n_boxes = a.n_boxes;
  sc.max_dist = max_dist;
  sc.info = a.info;
  sc.chunks = a.chunks;
  sc.aabbs = L::STAGED ? s + n_row4 : a.aabbs;
  sc.n_chunks = a.n_chunks;
  sc.n_supers = a.n_supers;
  sc.box_chunk0 = a.box_chunk0;
  sc.tri_chunk0 = a.tri_chunk0;
  sc.cap_boxes = a.cap_boxes;
  sc.n_cap_boxes = a.n_cap_boxes;
  return sc;
}

// Raises `kernel`'s dynamic shared memory limit on the current device to
// `bytes` (the opt-in past 48 KiB) where it has not been raised that far
// yet: each instantiation keeps its high-water mark.  The attribute sets
// the limit, lowering it too, so it is never set below the 48 KiB every
// kernel starts with.
inline cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= SMEM_DEFAULT) return cudaSuccess;
  struct Grant {
    const void* kernel;
    int device;
    size_t bytes;
  };
  static std::mutex mu;
  static std::vector<Grant> granted;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  Grant* g = nullptr;
  for (Grant& x : granted) {
    if (x.kernel == kernel && x.device == device) g = &x;
  }
  if (g != nullptr && g->bytes >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  if (g != nullptr) {
    g->bytes = bytes;
  } else {
    granted.push_back({kernel, device, bytes});
  }
  return cudaSuccess;
}

// Launches `kernel` on `stream` with `smem` bytes of staged tables at the
// scene's placement (none staged in device-memory placement): the opt-in
// first where the placement asks for it.  Returns the launch's error.
template <typename Args>
int launch_placed(void (*kernel)(const Args), const Args& a, int blocks,
                  int threads, size_t smem, void* stream) {
  if (a.scene.placement == PLACE_GLOBAL) {
    smem = 0;
  } else if (a.scene.placement == PLACE_OPTIN) {
    const cudaError_t err =
        allow_smem(reinterpret_cast<const void*>(kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// (distance, global index, material id) of the nearest primitive so far.
struct Near {
  float d;
  int gi;
  int mid;
};

// The lower distance wins, then the lower global index.
__device__ __forceinline__ void take(Near& a, float d, int gi, int mid) {
  if (d < a.d || (d == a.d && gi < a.gi)) {
    a.d = d;
    a.gi = gi;
    a.mid = mid;
  }
}

// The G lanes (a power of two, consecutive in their warp) that share one
// ray.  Each fold leaves the same value in every lane of the group.
template <int G>
struct Group {
  int lane;       // 0 .. G - 1
  unsigned mask;  // the group's lanes within the warp

  __device__ Group()
      : lane(threadIdx.x & (G - 1)),
        mask((0xffffffffu >> (32 - G)) << ((threadIdx.x & 31) & ~(G - 1))) {}

  __device__ __forceinline__ float min(float v) const {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      v = fminf(v, __shfl_xor_sync(mask, v, o));
    }
    return v;
  }

  // The least v and, among equal v, the least i.
  __device__ __forceinline__ void argmin(float& v, int& i) const {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(mask, v, o);
      const int oi = __shfl_xor_sync(mask, i, o);
      if (ov < v || (ov == v && oi < i)) {
        v = ov;
        i = oi;
      }
    }
  }

  __device__ __forceinline__ Near nearest(Near a) const {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      const float od = __shfl_xor_sync(mask, a.d, o);
      const int ogi = __shfl_xor_sync(mask, a.gi, o);
      const int omid = __shfl_xor_sync(mask, a.mid, o);
      take(a, od, ogi, omid);
    }
    return a;
  }

  // Bit k set where lane k of the group holds p.
  __device__ __forceinline__ unsigned ballot(bool p) const {
    if (G == 1) return p ? 1u : 0u;
    return (__ballot_sync(mask, p) & mask) >> (__ffs(mask) - 1);
  }
};

__device__ __forceinline__ float sphere_dist(float4 r, float px, float py,
                                             float pz) {
  const float dx = r.x - px;
  const float dy = r.y - py;
  const float dz = r.z - pz;
  return sqrtf(dx * dx + dy * dy + dz * dz) - r.w;
}

__device__ __forceinline__ float plane_dist(float4 r, float px, float py,
                                            float pz) {
  return r.x * px + r.y * py + r.z * pz + r.w;
}

__device__ __forceinline__ float box_dist(float4 c, float4 s, float px,
                                          float py, float pz) {
  const float qx = fabsf(c.x - px) - s.x;
  const float qy = fabsf(c.y - py) - s.y;
  const float qz = fabsf(c.z - pz) - s.z;
  const float ox = fmaxf(qx, 0.f);
  const float oy = fmaxf(qy, 0.f);
  const float oz = fmaxf(qz, 0.f);
  const float outside = sqrtf(ox * ox + oy * oy + oz * oz);
  const float inside = fminf(fmaxf(qx, fmaxf(qy, qz)), 0.f);
  return outside + inside;
}

// torch.sign: -1, 0 or 1.
__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>(x > 0.f) - static_cast<float>(x < 0.f);
}

// Squared edge distance of the iq SDF: edge vector v, point offset q,
// iv = 1 / |v|².
__device__ __forceinline__ float tri_edge(float vx, float vy, float vz,
                                          float qx, float qy, float qz,
                                          float iv) {
  const float t = fminf(fmaxf((vx * qx + vy * qy + vz * qz) * iv, 0.f),
                        1.f);
  const float ex = vx * t - qx;
  const float ey = vy * t - qy;
  const float ez = vz * t - qz;
  return ex * ex + ey * ey + ez * ez;
}

// Distance from p to triangle j of the chunk at `rows` (primitives.py:
// _triangle_sdf_planar_derived, operation for operation).
__device__ __forceinline__ float tri_dist(const float4* rows, int j,
                                          float px, float py, float pz) {
  const float4 a = __ldg(rows + 0 * CHUNK + j);  // v1 xyz, v21 x
  const float4 b = __ldg(rows + 1 * CHUNK + j);  // v21 yz, v32 xy
  const float4 c = __ldg(rows + 2 * CHUNK + j);  // v32 z, v13 xyz
  const float4 d = __ldg(rows + 3 * CHUNK + j);  // nor xyz, n21 x
  const float4 e = __ldg(rows + 4 * CHUNK + j);  // n21 yz, n32 xy
  const float4 f = __ldg(rows + 5 * CHUNK + j);  // n32 z, n13 xyz
  const float4 g = __ldg(rows + 6 * CHUNK + j);  // i21, i32, i13, inor
  const float p1x = px - a.x;
  const float p1y = py - a.y;
  const float p1z = pz - a.z;
  const float p2x = p1x - a.w;
  const float p2y = p1y - b.x;
  const float p2z = p1z - b.y;
  const float p3x = p1x + c.y;
  const float p3y = p1y + c.z;
  const float p3z = p1z + c.w;
  const float s = sgn(d.w * p1x + e.x * p1y + e.y * p1z) +
                  sgn(e.z * p2x + e.w * p2y + f.x * p2z) +
                  sgn(f.y * p3x + f.z * p3y + f.w * p3z);
  const float edge_d2 =
      fminf(fminf(tri_edge(a.w, b.x, b.y, p1x, p1y, p1z, g.x),
                  tri_edge(b.z, b.w, c.x, p2x, p2y, p2z, g.y)),
            tri_edge(c.y, c.z, c.w, p3x, p3y, p3z, g.z));
  const float dn = d.x * p1x + d.y * p1y + d.z * p1z;
  const float plane_d2 = dn * dn * g.w;
  return sqrtf(fmaxf(s < 2.f ? edge_d2 : plane_d2, 1e-30f));
}

// Squared distance from p to the box at b (lo, hi); 0 inside it.
template <class L>
__device__ __forceinline__ float aabb_d2(const float4* b, float px, float py,
                                         float pz) {
  const float4 lo = ld<L>(b);
  const float4 hi = ld<L>(b + 1);
  const float dx = fmaxf(fmaxf(lo.x - px, px - hi.x), 0.f);
  const float dy = fmaxf(fmaxf(lo.y - py, py - hi.y), 0.f);
  const float dz = fmaxf(fmaxf(lo.z - pz, pz - hi.z), 0.f);
  return dx * dx + dy * dy + dz * dz;
}

__device__ __forceinline__ void count_work(const Scene& sc, int what,
                                           int n) {
#ifdef COUNT_WORK
  sc.work[what] += n;
#endif
}

// The type of chunk ch's slots.
enum ChunkKind { SPHERE_CHUNK, BOX_CHUNK, TRI_CHUNK };

template <class L>
__device__ __forceinline__ ChunkKind chunk_kind(const Scene& sc, int ch) {
  if (L::CHUNKS == TRI_CHUNKS) return TRI_CHUNK;
  return ch < sc.box_chunk0   ? SPHERE_CHUNK
         : ch < sc.tri_chunk0 ? BOX_CHUNK
                              : TRI_CHUNK;
}

// Folds the slots of chunk ch that fall to this lane into `mine`, each by
// its type's distance; INFO keeps the global index and material id of the
// minimum.
template <int G, bool INFO, class L>
__device__ __forceinline__ void chunk_eval(const Scene& sc,
                                           const Group<G>& g, int ch,
                                           float px, float py, float pz,
                                           Near& mine) {
  const float4* rows = sc.chunks + ch * (TRI_ROWS * CHUNK);
  const int2* info =
      sc.info + sc.n_spheres + sc.n_planes + sc.n_boxes + ch * CHUNK;
  const ChunkKind kind = chunk_kind<L>(sc, ch);
  for (int j = g.lane; j < CHUNK; j += G) {
    float d;
    if (kind == TRI_CHUNK) {
      d = tri_dist(rows, j, px, py, pz);
    } else if (kind == SPHERE_CHUNK) {
      d = sphere_dist(__ldg(rows + j), px, py, pz);
    } else {
      d = box_dist(__ldg(rows + j), __ldg(rows + CHUNK + j), px, py, pz);
    }
    count_work(sc, 2, 1);
    if (INFO) {
      const int2 im = __ldg(info + j);
      take(mine, d, im.x, im.y);
    } else {
      mine.d = fminf(mine.d, d);
    }
  }
}

// The lanes' minima folded into one that every lane holds.
template <int G, bool INFO>
__device__ __forceinline__ Near fold(const Group<G>& g, Near mine) {
  if (INFO) return g.nearest(mine);
  mine.d = g.min(mine.d);
  return mine;
}

// Folds super-chunk s into nb: its chunk boxes tested a lane each, in
// rounds of G, and of each round the chunks within slack of the running
// minimum taken nearest bound first, with a fold after every chunk: the
// next chunk is re-checked against what the last one left.  (Taking a
// round's admitted chunks in slot order, or all of them between two folds,
// evaluates more triangles and took longer on the card: the time follows
// the triangles evaluated, not the folds.)
template <int G, bool INFO, class L>
__device__ void chunk_super(const Scene& sc, const Group<G>& g, int s,
                            float slack, float px, float py, float pz,
                            Near& nb) {
  const float4* chunk_boxes = sc.aabbs + 2 * (1 + sc.n_supers);
  const int c_end = min(sc.n_chunks, (s + 1) * SUPER);
  for (int c0 = s * SUPER; c0 < c_end; c0 += G) {
    const int c = c0 + g.lane;
    float key = CUDART_INF_F;
    if (c < c_end) {
      key = aabb_d2<L>(chunk_boxes + 2 * c, px, py, pz);
      count_work(sc, 1, 1);
    }
    for (;;) {
      const float nearest = g.min(key);
      const float lim = nb.d + slack;
      if (!(nearest <= lim * lim)) break;
      const int owner = __ffs(g.ballot(key == nearest)) - 1;
      if (g.lane == owner) key = CUDART_INF_F;
      Near mine = nb;
      chunk_eval<G, INFO, L>(sc, g, c0 + owner, px, py, pz, mine);
      nb = fold<G, INFO>(g, mine);
    }
  }
}

// The pruned minimum over the chunked slots folded into nb, which every
// lane of the group holds alike.  Super-chunks are opened in order of
// their bound (the next one found by testing every box again, a lane
// each: two tests a lane for obj_mesh's 16), until the next bound lies
// beyond slack of the running minimum: every box after it lies farther
// still.  In this order the opened set is the least any exact pruning
// opens: a super-chunk opened before the one that holds the minimum has a
// bound below the minimum.
template <int G, bool INFO, class L>
__device__ void chunk_min(const Scene& sc, const Group<G>& g, float px,
                          float py, float pz, Near& nb) {
  const float scale = ld<L>(reinterpret_cast<const float*>(sc.aabbs));
  const float slack = PRUNE_REL * (scale + fabsf(px) + fabsf(py) + fabsf(pz));
  const float4* super_boxes = sc.aabbs + 2;
  if (g.lane == 0) count_work(sc, 0, 1);
  float last_d2 = -1.f;
  int last = -1;
  for (;;) {
    // the nearest super-chunk after (last_d2, last), ties by index
    float next_d2 = CUDART_INF_F;
    int next = 0x7fffffff;
    for (int s = g.lane; s < sc.n_supers; s += G) {
      const float d2 = aabb_d2<L>(super_boxes + 2 * s, px, py, pz);
      count_work(sc, 1, 1);
      const bool after = d2 > last_d2 || (d2 == last_d2 && s > last);
      if (after && (d2 < next_d2 || (d2 == next_d2 && s < next))) {
        next_d2 = d2;
        next = s;
      }
    }
    g.argmin(next_d2, next);
    const float lim = nb.d + slack;
    if (!(next_d2 <= lim * lim)) break;
    chunk_super<G, INFO, L>(sc, g, next, slack, px, py, pz, nb);
    last_d2 = next_d2;
    last = next;
  }
}

// Scene distance: min over the typed slots and the chunked ones, capped
// at max_dist.
template <int G, class L>
__device__ float scene_dist(const Scene& sc, const Group<G>& g, float px,
                            float py, float pz) {
#ifdef FIXED_SPHERES
  constexpr int n_spheres = FIXED_COUNTS[0], n_planes = FIXED_COUNTS[1],
                n_boxes = FIXED_COUNTS[2];
#else
  const int n_spheres = sc.n_spheres, n_planes = sc.n_planes,
            n_boxes = sc.n_boxes;
#endif
  float best = sc.max_dist;
  const float4* r = sc.rows;
#pragma unroll SLOT_UNROLL_N
  for (int s = g.lane; s < n_spheres; s += G) {
    best = fminf(best, sphere_dist(ld<L>(r + s), px, py, pz));
  }
  r += n_spheres;
#pragma unroll SLOT_UNROLL_N
  for (int s = g.lane; s < n_planes; s += G) {
    best = fminf(best, plane_dist(ld<L>(r + s), px, py, pz));
  }
  r += n_planes;
#pragma unroll SLOT_UNROLL_N
  for (int s = g.lane; s < n_boxes; s += G) {
    best = fminf(best, box_dist(ld<L>(r + s), ld<L>(r + n_boxes + s), px,
                                py, pz));
  }
  if (G > 1 && n_spheres + n_planes + n_boxes > 0) {
    best = g.min(best);
  }
  if (L::CHUNKS != NO_CHUNKS) {
    Near nb{best, -1, 0};
    chunk_min<G, false, L>(sc, g, px, py, pz, nb);
    best = nb.d;
  }
  return best;
}

// (distance, global index, material id); among equal distances the lower
// global index wins (the first minimum in spec order); index -1 and
// material 0 when nothing is under max_dist.
template <int G, class L>
__device__ float scene_info(const Scene& sc, const Group<G>& g, float px,
                            float py, float pz, int* idx, int* mid) {
  Near nb{sc.max_dist, -1, 0};
  const float4* r = sc.rows;
  const int2* info = sc.info;
  for (int s = g.lane; s < sc.n_spheres; s += G) {
    const int2 im = __ldg(info + s);
    take(nb, sphere_dist(ld<L>(r + s), px, py, pz), im.x, im.y);
  }
  r += sc.n_spheres;
  info += sc.n_spheres;
  for (int s = g.lane; s < sc.n_planes; s += G) {
    const int2 im = __ldg(info + s);
    take(nb, plane_dist(ld<L>(r + s), px, py, pz), im.x, im.y);
  }
  r += sc.n_planes;
  info += sc.n_planes;
  for (int s = g.lane; s < sc.n_boxes; s += G) {
    const int2 im = __ldg(info + s);
    take(nb, box_dist(ld<L>(r + s), ld<L>(r + sc.n_boxes + s), px, py, pz),
         im.x, im.y);
  }
  if (G > 1) nb = g.nearest(nb);
  if (L::CHUNKS != NO_CHUNKS) chunk_min<G, true, L>(sc, g, px, py, pz, nb);
  *idx = nb.gi;
  *mid = nb.mid;
  return nb.d;
}

// One axis of the slab test: the entry and exit t of the ray o + t·d in
// [lo, hi], a direction component under 1e-12 in magnitude taken as 1e-12.
__device__ __forceinline__ void slab(float lo, float hi, float o, float d,
                                     float* t_in, float* t_out) {
  const float ds = fabsf(d) < 1e-12f ? 1e-12f : d;
  const float inv = 1.f / ds;
  const float t1 = (lo - o) * inv;
  const float t2 = (hi - o) * inv;
  *t_in = fminf(t1, t2);
  *t_out = fmaxf(t1, t2);
}

// The box-exit cap of the ray o + t·d (the TPU kernels' _ray_box_cap,
// ops/march.py:ray_box_cap): per grown box, its exit t where the ray
// enters it before it leaves, else 0, clamped at 0; the largest over the
// boxes.  Infinite on a scene without cap boxes.  Past the cap the ray
// stays outside every grown box, more than the margin (0.015) from every
// primitive, so on a scene whose every type has its box a march can
// neither hit nor be blocked there.
__device__ __forceinline__ float box_cap(const Scene& sc, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz) {
  if (sc.n_cap_boxes == 0) return CUDART_INF_F;
  float cap = 0.f;
  for (int b = 0; b < sc.n_cap_boxes; ++b) {
    const float* box = sc.cap_boxes + 6 * b;
    float n1, x1, n2, x2, n3, x3;
    slab(__ldg(box + 0), __ldg(box + 3), ox, dx, &n1, &x1);
    slab(__ldg(box + 1), __ldg(box + 4), oy, dy, &n2, &x2);
    slab(__ldg(box + 2), __ldg(box + 5), oz, dz, &n3, &x3);
    const float t_en = fmaxf(fmaxf(n1, n2), n3);
    const float t_ex = fminf(fminf(x1, x2), x3);
    cap = fmaxf(cap, t_en <= t_ex ? fmaxf(t_ex, 0.f) : 0.f);
  }
  return cap;
}

struct March {
  float max_dist, eps, omega, one_minus_omega, shadow_k;
  int max_steps;
};

// Over-relaxed sphere trace with the Keinert backtrack; t = the march
// distance where it stopped (t >= max_dist on a miss).  `cap` is the
// ray's box_cap: a ray whose cap is 0 does not march, and one retires at
// the first position at or past the cap that is not a backtrack (retiring
// on the raw t >= cap would end an over-relaxed step mid-overshoot, before
// its backtrack, and lose the hit it skipped).  An enabled ray that ended
// at its cap short of max_dist is a miss and reports t = max_dist; a
// disabled one stays at 0.
template <int G, class L>
__device__ float march_primary(const Scene& sc, const Group<G>& g,
                               const March& m, float ox, float oy, float oz,
                               float dx, float dy, float dz, bool en,
                               float cap) {
  float t = 0.f, prev_r = 0.f, step_len = 0.f, om = m.omega;
  bool active = en && 0.f < cap;
  for (int step = 0; step < m.max_steps && active; ++step) {
    const float dist =
        scene_dist<G, L>(sc, g, ox + t * dx, oy + t * dy, oz + t * dz);
    const bool fail = om > 1.f && fabsf(dist) + prev_r <= step_len;
    if (!fail && (dist < m.eps || t >= cap)) break;
    const float new_step = fail ? step_len * m.one_minus_omega : dist * om;
    if (fail) om = 1.f;
    t = t + new_step;
    prev_r = fabsf(dist);
    step_len = new_step;
    active = t < m.max_dist;
  }
  const float eff = fminf(m.max_dist, cap);
  return en && t >= eff && eff < m.max_dist ? m.max_dist : t;
}

// 1 if the ray reaches mx unobstructed, else 0; starts only if 0 < mx and
// 0 < cap, and retires unblocked at the cap as march_primary does.
template <int G, class L>
__device__ float march_visibility(const Scene& sc, const Group<G>& g,
                                  const March& m, float ox, float oy,
                                  float oz, float dx, float dy, float dz,
                                  float mx, bool active, float cap) {
  float t = 0.f, prev_r = 0.f, step_len = 0.f, om = m.omega;
  active = active && 0.f < mx && 0.f < cap;
  for (int step = 0; step < m.max_steps && active; ++step) {
    const float dist =
        scene_dist<G, L>(sc, g, ox + t * dx, oy + t * dy, oz + t * dz);
    const bool fail = om > 1.f && fabsf(dist) + prev_r <= step_len;
    if (!fail && dist < m.eps) return 0.f;
    if (!fail && t >= cap) return 1.f;
    const float new_step = fail ? step_len * m.one_minus_omega : dist * om;
    if (fail) om = 1.f;
    t = t + new_step;
    prev_r = fabsf(dist);
    step_len = new_step;
    active = t < mx;
  }
  return 1.f;
}

// Penumbra march (omega = 1) from t = t0: res starts at 1, prev at 1e20;
// starts only if t0 < mx; 0 when the shadow ray hits geometry.  The
// penumbra term's denominator t - y counts t from the origin, so t0 > 0
// shifts every sample's estimate.
//
// It takes no box cap, whatever the margin.  Past a box the distance is
// more than the margin, but the penumbra term is not bounded by it: with
// y = d²/(2·prev) the term k·sqrt(d² − y²)/(t − y) is k times the
// tangent of the angle at which the two last samples' spheres place the
// occluder, and on a ray leaving the scene d grows at nearly the rate t
// does (d → 2·prev), so those samples can set the minimum however far
// out they lie.  Ending the march at a box exit then lightens the shadow
// (tests/test_torch_box_cap.py holds a case on the torus).
template <int G, class L>
__device__ float march_shadow(const Scene& sc, const Group<G>& g,
                              const March& m, float ox, float oy, float oz,
                              float dx, float dy, float dz, float t0,
                              float mx, bool active) {
  float t = t0, res = 1.f, prev = 1e20f;
  active = active && t < mx;
  for (int step = 0; step < m.max_steps && active; ++step) {
    const float dist =
        scene_dist<G, L>(sc, g, ox + t * dx, oy + t * dy, oz + t * dz);
    if (dist < m.eps) return 0.f;
    const float y = dist * dist / (2.f * prev);
    const float dd = sqrtf(fmaxf(dist * dist - y * y, 0.f));
    const float denom = t - y;
    const float pen =
        denom > 1e-9f ? m.shadow_k * dd / fmaxf(denom, 1e-9f) : BIG;
    res = fminf(res, pen);
    prev = dist;
    t = t + dist;
    active = t < mx;
  }
  return res;
}

}  // namespace

// The most dynamic shared memory a block may opt in to on `device`
// (cudaDevAttrMaxSharedMemoryPerBlockOptin, in bytes), or -1 on an error:
// ops/march.py:optin_limit asks it of whichever library it holds.
extern "C" int madarch_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return bytes;
}
