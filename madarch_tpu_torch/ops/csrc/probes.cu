// The shade's two probe lookups for Hopper (sm_90a): one thread a point.
//
// Replaces no Pallas kernel.  The JAX package looks the probes up in XLA
// (madarch_tpu/render/probes.py:sample_irradiance and
// madarch_tpu/render/shading.py:sample_radiance_no_specular) as dense
// contractions written for the TPU's matrix unit: a lookup is a bilinear
// weight row over every texel of a tile, multiplied by every probe tile, then
// a one-hot over the probes picks the wanted tiles, so that no gather is
// needed.  Ported as it is (render/probes.py's "matmul" route), a 1000x1000
// frame wrote and read back ~15 GB of intermediates and ran ~69 GFLOP of
// SIMT gemm for the 8 x 4 irradiance taps and the 4 radiance taps each pixel
// needs.
//
// What bounds it: bytes.  An irradiance lookup reads 56 bytes of its point
// (position, normal, the 8 corner visibilities) and writes 12; a radiance
// lookup reads 16 (probe id, direction) and writes 12.  The atlases are small
// (27.6 KB of irradiance, 110.6 KB of radiance mip 1 in the benchmark's
// rooms) and are read through the read-only cache, where every tap hits L1
// or L2.  So the design gathers only the taps a point needs and keeps
// everything else in registers: one thread a point, the point's data read
// coalesced (vis8 is corner-major, so thread i reads word i of each row),
// the taps by __ldg.
//
// Built with -fmad=false, each kernel repeats its plain version's arithmetic
// (render/probes.py: sample_irradiance(method="gather") and
// sample_tile_bilinear) in that order: the corner weights, the crush's
// branch, the probe ids and every tap round as there.  Only the sum over
// the 8 corners (here in corner order) may round otherwise.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
// The backface weight's floor and the crush below it: w -> w^3 / 0.2^2,
// which PyTorch computes on a card as w^3 times the float reciprocal of the
// Python number 0.2 * 0.2, 25.
constexpr float kCrush = 0.2f;
constexpr float kCrushScale = 25.0f;

}  // namespace

// Mirrored field for field by ops/probe_lookup.py:_IrradianceArgs (ctypes).
struct IrradianceArgs {
  const float* pos;     // f32[n, 3]
  const float* normal;  // f32[n, 3]
  const float* vis8;    // f32[8, n]
  const float* atlas;   // f32[tiles_y * res, tiles_x * res, 3]
  float* out;           // f32[n, 3]
  int n;
  float spx, spy, spz;  // probe grid spacing
  int dimx, dimy, dimz; // probe grid dimensions
  int tiles_x;          // probe tiles a row of the atlas
  int res;              // texels a tile side
  float lo, hi;         // 0.5 / res and 1 - 0.5 / res, rounded to float
};

// Mirrored field for field by ops/probe_lookup.py:_RadianceArgs (ctypes).
struct RadianceArgs {
  const float* best_pid;  // f32[n]
  const float* best_dir;  // f32[n, 3]
  const float* atlas;     // f32[tiles_y * res, tiles_x * res, 3]: mip 1
  float* out;             // f32[n, 3]
  int n;
  int tiles_x;
  int n_tiles;
  int res;                // texels a tile side at mip 1
  float lo, hi;
};

namespace {

// dir_to_ray_id: the octahedral tile coordinates in [0, 1]^2 of a unit
// direction (the clamp guards a zero vector).
__device__ __forceinline__ void ray_id(float vx, float vy, float vz,
                                       float* rx, float* ry) {
  const float denom = fmaxf(fabsf(vx) + fabsf(vy) + fabsf(vz), 1e-12f);
  float ox = vx / denom;
  float oy = vy / denom;
  if (vz <= 0.f) {
    const float fx = (1.f - fabsf(oy)) * (ox >= 0.f ? 1.f : -1.f);
    const float fy = (1.f - fabsf(ox)) * (oy >= 0.f ? 1.f : -1.f);
    ox = fx;
    oy = fy;
  }
  *rx = (ox + 1.f) * 0.5f;
  *ry = (oy + 1.f) * 0.5f;
}

// torch.clamp(x, lo, hi): NaN passes through.
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// One axis of a bilinear tap: the first texel, the second and the weight
// of the second.
__device__ __forceinline__ void axis(float r, int res, float lo, float hi,
                                     int* i0, int* i1, float* w) {
  const float f = clampf(r, lo, hi) * static_cast<float>(res) - 0.5f;
  *i0 = min(max(static_cast<int>(floorf(f)), 0), res - 1);
  *i1 = min(*i0 + 1, res - 1);
  *w = f - static_cast<float>(*i0);
}

struct Tap {
  int x0, x1, y0, y1;
  float wx, wy;
};

__device__ __forceinline__ Tap tap(float rx, float ry, int res, float lo,
                                   float hi) {
  Tap t;
  axis(rx, res, lo, hi, &t.x0, &t.x1, &t.wx);
  axis(ry, res, lo, hi, &t.y0, &t.y1, &t.wy);
  return t;
}

// sample_tile_bilinear: the tap t of the tile (tx, ty) of an atlas of
// width texels, through the read-only cache.
__device__ __forceinline__ void sample(const float* __restrict__ atlas,
                                       int width, int res, int tx, int ty,
                                       const Tap& t, float* out) {
  const float* row0 = atlas + 3 * (ty * res + t.y0) * width;
  const float* row1 = atlas + 3 * (ty * res + t.y1) * width;
  const int c0 = 3 * (tx * res + t.x0);
  const int c1 = 3 * (tx * res + t.x1);
  const float ux = 1.f - t.wx;
  const float uy = 1.f - t.wy;
  for (int c = 0; c < 3; ++c) {
    const float top = __ldg(row0 + c0 + c) * ux + __ldg(row0 + c1 + c) * t.wx;
    const float bot = __ldg(row1 + c0 + c) * ux + __ldg(row1 + c1 + c) * t.wx;
    out[c] = top * uy + bot * t.wy;
  }
}

// The corner weight's trilinear factor on one axis: mix(1 - a, a, o).
__device__ __forceinline__ float tri(float a, float o) {
  const float om = 1.f - a;
  return om + (a - om) * o;
}

__global__ void __launch_bounds__(THREADS)
    probe_irradiance_kernel(const IrradianceArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  const float px = a.pos[3 * i + 0];
  const float py = a.pos[3 * i + 1];
  const float pz = a.pos[3 * i + 2];
  const float nx = a.normal[3 * i + 0];
  const float ny = a.normal[3 * i + 1];
  const float nz = a.normal[3 * i + 2];

  // probe_corners: the cell holding p and p's offset in it
  const int gx = static_cast<int>(floorf(px / a.spx));
  const int gy = static_cast<int>(floorf(py / a.spy));
  const int gz = static_cast<int>(floorf(pz / a.spz));
  const float ax = px / a.spx - static_cast<float>(gx);
  const float ay = py / a.spy - static_cast<float>(gy);
  const float az = pz / a.spz - static_cast<float>(gz);

  float rx, ry;
  ray_id(nx, ny, nz, &rx, &ry);
  const Tap t = tap(rx, ry, a.res, a.lo, a.hi);
  const int width = a.tiles_x * a.res;

  float acc[3] = {0.f, 0.f, 0.f};
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ox = k & 1, oy = (k >> 1) & 1, oz = (k >> 2) & 1;
    const int cx = min(max(gx + ox, 0), a.dimx - 1);
    const int cy = min(max(gy + oy, 0), a.dimy - 1);
    const int cz = min(max(gz + oz, 0), a.dimz - 1);
    // unit(probe_world - p)
    const float vx = static_cast<float>(cx) * a.spx - px;
    const float vy = static_cast<float>(cy) * a.spy - py;
    const float vz = static_cast<float>(cz) * a.spz - pz;
    const float d = sqrtf(fmaxf(vx * vx + vy * vy + vz * vz, 1e-12f));
    const float dx = vx / d, dy = vy / d, dz = vz / d;
    // backface weight, visibility, crush, trilinear factors
    const float angle = (dx * nx + dy * ny + dz * nz + 1.f) * 0.5f;
    float w = (angle * angle + kCrush) * a.vis8[k * a.n + i];
    if (w < kCrush) w = w * w * w * kCrushScale;
    w = w * tri(ax, static_cast<float>(ox)) * tri(ay, static_cast<float>(oy)) *
        tri(az, static_cast<float>(oz));

    const int pid = cz * a.dimx * a.dimy + cy * a.dimx + cx;
    const int ty = pid / a.tiles_x;
    float v[3];
    sample(a.atlas, width, a.res, pid - ty * a.tiles_x, ty, t, v);
    for (int c = 0; c < 3; ++c) acc[c] += sqrtf(fmaxf(v[c], 1e-12f)) * w;
    total += w;
  }
  total = fmaxf(total, 1e-9f);
  for (int c = 0; c < 3; ++c) {
    const float e = acc[c] / total;
    a.out[3 * i + c] = e * e;
  }
}

__global__ void __launch_bounds__(THREADS)
    probe_radiance_kernel(const RadianceArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  const int pid = static_cast<int>(a.best_pid[i]);
  float v[3] = {0.f, 0.f, 0.f};
  // an id outside the atlas picks no tile, as the dense route's one-hot
  if (pid >= 0 && pid < a.n_tiles) {
    float rx, ry;
    ray_id(a.best_dir[3 * i + 0], a.best_dir[3 * i + 1],
           a.best_dir[3 * i + 2], &rx, &ry);
    const int ty = pid / a.tiles_x;
    sample(a.atlas, a.tiles_x * a.res, a.res, pid - ty * a.tiles_x, ty,
           tap(rx, ry, a.res, a.lo, a.hi), v);
  }
  for (int c = 0; c < 3; ++c) a.out[3 * i + c] = v[c];
}

int blocks_for(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

extern "C" int madarch_irradiance_lookup(const IrradianceArgs* a,
                                         void* stream) {
  if (a->n == 0) return 0;
  probe_irradiance_kernel<<<blocks_for(a->n), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int madarch_radiance_lookup(const RadianceArgs* a, void* stream) {
  if (a->n == 0) return 0;
  probe_radiance_kernel<<<blocks_for(a->n), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
