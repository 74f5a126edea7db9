// The volumetric passes' tensor math, for Hopper (sm_90a): the scattering
// integral (one thread a texel), the depth-aware fog composite (one thread a
// pixel) and the froxel in-scatter after each light slot's visibility launch
// (one thread a froxel).
//
// Replaces no Pallas kernel.  The JAX package leaves this math to XLA, which
// fuses each pass into a loop or two.  Ported op for op to PyTorch
// (render/volumetrics.py), it is ~600 launches a frame at light_shafts'
// shapes: the 100-tap loop over a 100x250x250x3 upsampled copy of the froxel
// grid, the composite's nine pairs of gathers over 10^6 pixels, and the
// in-scatter's dozen elementwise ops over 10^6 froxels a light slot.
//
// What bounds it: bytes.  The integral reads the froxel grid (12 MB at 100^3)
// and each texel's hit distance and writes 16 bytes a texel; the composite
// reads ~16 bytes a pixel and the 1 MB scattering map (9 taps a pixel, from
// the caches) and writes 12; the in-scatter reads 44 bytes and the running
// sum of a froxel and writes 12.  So no intermediate goes to device memory:
// the integral reads the froxel column under its texel in place of an
// upsampled copy, and every other value lives in registers.
//
// Built with -fmad=false, each kernel repeats its plain version's arithmetic
// in its order, including PyTorch's own roundings on a card: a Python number
// goes in rounded to float, 1.0 / x is a reciprocal, x ** 1.5 is powf,
// torch.exp is expf, torch.minimum and torch.clamp_max pass NaN through.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

}  // namespace

// Mirrored field for field by ops/volumetrics_kernel.py:_ScatterArgs.
struct ScatterArgs {
  const float* t;           // f32[sy * sx]: the raycast's hit distance
  const bool* hit;          // bool[sy * sx], or null: t is the length itself
  const float* visibility;  // f32[vz, vy, vx, 3]: the froxel grid
  const float* weights;     // f32[n_steps]: exp(-f_i * tau) of each tap
  float* out;               // f32[sy, sx, 4]: (in-scattered L, length)
  int sx, sy;
  int vx, vy, vz;
  int n_steps;
  float max_depth;
  float step;               // the scattering step
  float vis_step;           // the froxel slices' step
};

// Mirrored field for field by ops/volumetrics_kernel.py:_CompositeArgs.
struct CompositeArgs {
  const float* scattering;  // f32[sy, sx, 4]
  const float* color;       // f32[h * w, 3]
  const float* ray_len;     // f32[h * w]
  const int* ix;            // i32[w]: each pixel column's nearest texel
  const int* iy;            // i32[h]: each pixel row's
  float* out;               // f32[h * w, 3]
  int w, h;
  int sx, sy;
  float max_dist;
  float tau;
};

// Mirrored field for field by ops/volumetrics_kernel.py:_InscatterArgs.
struct InscatterArgs {
  const float* ldist;       // f32[n]: distance to the light
  const float* vis;         // f32[n]: the visibility launch's 0/1
  const float* radiance;    // f32[n, 3]: the light's sample
  const float* ldir;        // f32[n, 3]: direction to the light
  const float* dirs;        // f32[n, 3]: the froxel's camera ray
  const bool* live;         // bool[]: the slot is live; null, a static slot
  float* result;            // f32[n, 3]: the sum over the slots, in place
  int n;
  float tau;
  float hg_num;             // 1 - g^2
  float hg_base;            // 1 + g^2
  float hg_2g;              // 2 g
  float four_pi;            // 4 PI
};

namespace {

// torch.clamp_max and torch.minimum: NaN passes through
__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x != x ? x : fminf(x, hi);
}

__device__ __forceinline__ float minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// scattering_pass after the raycast: length = min(hit ? t : max_depth,
// max_depth), then acc = acc + vis[z_i] * w_i over the taps in order, w_i
// the tap's weight where f_i < length, else 0; z_i = int(f_i / vis_step)
// clamped.  The froxel column is the texel's floor(y vy / sy),
// floor(x vx / sx).
__global__ void __launch_bounds__(THREADS)
    scatter_integral_kernel(const ScatterArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.sx * a.sy) return;
  const int y = i / a.sx;
  const int x = i - y * a.sx;
  const int fy = min(y * a.vy / a.sy, a.vy - 1);
  const int fx = min(x * a.vx / a.sx, a.vx - 1);
  const float length = clamp_max(
      a.hit == nullptr || a.hit[i] ? a.t[i] : a.max_depth, a.max_depth);
  const float* __restrict__ column = a.visibility + 3 * (fy * a.vx + fx);
  const long long plane = 3LL * a.vy * a.vx;
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f;
#pragma unroll 4
  for (int k = 0; k < a.n_steps; ++k) {
    const float f = static_cast<float>(k) * a.step;
    const int z = min(max(static_cast<int>(f / a.vis_step), 0), a.vz - 1);
    const float w = f < length ? __ldg(a.weights + k) : 0.f;
    const float* __restrict__ v = column + z * plane;
    acc0 = acc0 + __ldg(v + 0) * w;
    acc1 = acc1 + __ldg(v + 1) * w;
    acc2 = acc2 + __ldg(v + 2) * w;
  }
  float4 o;
  o.x = acc0 * a.step;
  o.y = acc1 * a.step;
  o.z = acc2 * a.step;
  o.w = length;
  reinterpret_cast<float4*>(a.out)[i] = o;
}

// composite: the 3x3 search (dx outer, dy inner, the texel indices clamped
// after the shift) for the texel whose stored length is closest to the
// pixel's, strict < so the first tap wins a tie, closest starting at
// max_dist; then color * exp(-len * tau) + fog.
__global__ void __launch_bounds__(THREADS)
    fog_composite_kernel(const CompositeArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.w * a.h) return;
  const int r = i / a.w;
  const int c = i - r * a.w;
  const int cx = __ldg(a.ix + c);
  const int cy = __ldg(a.iy + r);
  const float len = a.ray_len[i];
  float closest = a.max_dist;
  float fog0 = 0.f, fog1 = 0.f, fog2 = 0.f;
#pragma unroll
  for (int dx = -1; dx <= 1; ++dx) {
    const int tx = min(max(cx + dx, 0), a.sx - 1);
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const int ty = min(max(cy + dy, 0), a.sy - 1);
      const float* __restrict__ s = a.scattering + 4 * (ty * a.sx + tx);
      const float dist = fabsf(__ldg(s + 3) - len);
      if (dist < closest) {
        fog0 = __ldg(s + 0);
        fog1 = __ldg(s + 1);
        fog2 = __ldg(s + 2);
      }
      closest = minimum(closest, dist);
    }
  }
  const float e = expf(-len * a.tau);
  a.out[3 * i + 0] = a.color[3 * i + 0] * e + fog0;
  a.out[3 * i + 1] = a.color[3 * i + 1] * e + fog1;
  a.out[3 * i + 2] = a.color[3 * i + 2] * e + fog2;
}

// visibility_pass's froxel_light after one slot's visibility launch:
// result += (exp(-ldist * tau) * vis) * radiance * tau * HG(ldir, dir), with
// HG = (1 / (4 PI * (1 + g^2 - 2 g cos) ** 1.5)) * (1 - g^2) as PyTorch's
// x / tensor is; a dead slot adds 0.
__global__ void __launch_bounds__(THREADS)
    froxel_inscatter_kernel(const InscatterArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const float ev = expf(-a.ldist[i] * a.tau) * a.vis[i];
  const float cos_angle = a.ldir[3 * i + 0] * a.dirs[3 * i + 0]
      + a.ldir[3 * i + 1] * a.dirs[3 * i + 1]
      + a.ldir[3 * i + 2] * a.dirs[3 * i + 2];
  const float hg = (1.f / (a.four_pi * powf(a.hg_base - cos_angle * a.hg_2g,
                                            1.5f))) * a.hg_num;
  const bool live = a.live == nullptr || *a.live;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float contrib = ev * a.radiance[3 * i + c] * a.tau * hg;
    a.result[3 * i + c] = a.result[3 * i + c] + (live ? contrib : 0.f);
  }
}

int blocks(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

extern "C" int madarch_scatter_integral(const ScatterArgs* a, void* stream) {
  const int n = a->sx * a->sy;
  if (n == 0) return 0;
  scatter_integral_kernel<<<blocks(n), THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int madarch_fog_composite(const CompositeArgs* a, void* stream) {
  const int n = a->w * a->h;
  if (n == 0) return 0;
  fog_composite_kernel<<<blocks(n), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int madarch_froxel_inscatter(const InscatterArgs* a,
                                        void* stream) {
  if (a->n == 0) return 0;
  froxel_inscatter_kernel<<<blocks(a->n), THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
