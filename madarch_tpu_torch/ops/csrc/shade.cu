// The shade of a ray batch given its geometry, for Hopper (sm_90a): one
// thread a ray.
//
// Replaces no Pallas kernel.  The JAX package shades in XLA, which fuses
// render/shading.py's chain (material gather, every light slot's sample and
// Cook-Torrance BRDF, specular mode 2's highlight at the reflection hit, the
// indirect term, AO, the sky) into a few loops over the rays.  Ported op for
// op to PyTorch (render/shading.py:shade_hits and its callees), the chain is
// ~200 elementwise launches a pass, each reading and writing whole [N] or
// [N, 3] float32 tensors: ~2.7 ms of a 1000x1000 GI frame.
//
// What bounds it: bytes.  A ray reads ~150 bytes (its origin, direction, the
// geometry kernel's t, hit, normal, material, AO and shadows and its folded
// reflection's, the two probe lookups' results) and writes 24 (colour and
// hit position); the material and light tables are a few hundred bytes,
// read through the read-only cache.  So the design keeps every intermediate
// in registers: one thread a ray, a miss shades only the sky, a ray whose
// reflection does not count skips the highlight.
//
// Built with -fmad=false, the kernel repeats the plain chain's arithmetic in
// its order (render/brdf.py, render/lighting.py, scene/lights.py,
// render/shading.py), including PyTorch's own roundings on a card: a
// division by a Python number is a product with its float reciprocal (1/PI
// comes in as inv_pi), 1.0 / x is a reciprocal, torch.clamp passes NaN
// through, x ** 5.0 and x ** 8.0 are powf.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
// Floats a light slot takes in the light table (ops/shade_kernel.py).
constexpr int LIGHT_FLOATS = 16;
constexpr int SPOT = 1;

}  // namespace

// Mirrored field for field by ops/shade_kernel.py:_ShadeArgs (ctypes).
struct ShadeArgs {
  const float* origins;     // f32[n, 3]
  const float* dirs;        // f32[n, 3]
  const float* t;           // f32[n]
  const bool* hit;          // bool[n]
  const float* normal;      // f32[n, 3]
  const int* mid;           // i32[n]
  const float* ao;          // f32[n]
  const float* shadows;     // f32[n_lights, n]
  const float* irradiance;  // f32[n, 3]: the irradiance lookup's
  // specular mode 2's folded reflection (null in mode 0)
  const float* r_t;         // f32[n]
  const bool* r_hit;        // bool[n]
  const int* r_mid;         // i32[n]
  const float* r_normal;    // f32[n, 3]
  const float* r_shadows;   // f32[n_lights, n]
  const float* radiance;    // f32[n, 3]: the mip-1 radiance lookup's
  const float* albedo;      // f32[n_mats, 3]
  const float* metallic;    // f32[n_mats]
  const float* roughness;   // f32[n_mats]
  const float* lights;      // f32[n_lights, LIGHT_FLOATS]
  float* color;             // f32[n, 3]
  float* hit_pos;           // f32[n, 3]
  int n;
  int n_mats;
  int n_lights;
  int mode;                 // indirect specular mode: 0 or 2
  int direct_specular;
  int add_indirect_specular;
  float max_dist;
  float surf_off;           // SURFACE_OFFSET
  float ndotl_min;          // EPSILON: a shadow counts above it
  float pi;                 // PI rounded to float
  float inv_pi;             // 1 / PI in float, as PyTorch's x / PI
};

namespace {

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* __restrict__ p, int i) {
  return {p[3 * i + 0], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* __restrict__ p, int i, V3 v) {
  p[3 * i + 0] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// vecmath.dot: x + y + z in that order
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// torch.clamp_min, clamp_max, clamp: NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x != x ? x : fminf(x, hi);
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// brdf.geometry_schlick_ggx
__device__ __forceinline__ float schlick_ggx(float ndotv, float roughness) {
  const float r = roughness + 1.f;
  const float k = (r * r) / 8.f;
  return ndotv / (ndotv * (1.f - k) + k);
}

// brdf.cook_torrance_coefficients: kD and kS
__device__ __forceinline__ void cook_torrance(V3 n, V3 v, V3 l, float ndotl,
                                              V3 albedo, float metallic,
                                              float roughness, float pi,
                                              V3* kd, V3* ks) {
  const V3 s = {v.x + l.x, v.y + l.y, v.z + l.z};
  const float len = sqrtf(clamp_min(dot3(s, s), 1e-30f));
  const V3 h = {s.x / len, s.y / len, s.z / len};
  const float ndotv = clamp_min(dot3(n, v), 0.f);

  // f0 = mix(0.04, albedo, metallic)
  const float f0[3] = {0.04f + (albedo.x - 0.04f) * metallic,
                       0.04f + (albedo.y - 0.04f) * metallic,
                       0.04f + (albedo.z - 0.04f) * metallic};
  // distribution_ggx
  const float a = roughness * roughness;
  const float a2 = a * a;
  const float ndoth = clamp_min(dot3(n, h), 0.f);
  const float denom = ndoth * ndoth * (a2 - 1.f) + 1.f;
  const float ndf = a2 / (denom * pi * denom);
  const float g = schlick_ggx(ndotv, roughness) * schlick_ggx(ndotl, roughness);
  // fresnel_schlick; the 1.001 bias is the reference's
  const float p = powf(1.001f - clamp_min(dot3(h, v), 0.f), 5.f);
  const float ndf_g = ndf * g;
  const float den = clamp_min(4.f * ndotv * ndotl, 1e-3f);
  const float om = 1.f - metallic;
  float kdv[3], ksv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float f = f0[c] + (1.f - f0[c]) * p;
    kdv[c] = (1.f - f) * om;
    ksv[c] = clamp_max(ndf_g * f / den, 1.f);
  }
  *kd = {kdv[0], kdv[1], kdv[2]};
  *ks = {ksv[0], ksv[1], ksv[2]};
}

// lighting.direct_lighting at one point over every light slot: the slot's
// sample (scene/lights.py), its BRDF, its penumbra factor (shadows[slot * n
// + i]) where ndotl > ndotl_min, the slot is live and ``enabled`` holds.
__device__ V3 direct_lighting(const ShadeArgs& a, int i, V3 pos, V3 n,
                              V3 view_dir, V3 albedo, float metallic,
                              float roughness, bool enabled,
                              const float* __restrict__ shadows) {
  const V3 v = {-view_dir.x, -view_dir.y, -view_dir.z};
  V3 lo = {0.f, 0.f, 0.f};
  for (int s = 0; s < a.n_lights; ++s) {
    const float* L = a.lights + s * LIGHT_FLOATS;
    const int type = static_cast<int>(__ldg(L + 0));
    const bool live = __ldg(L + 1) != 0.f;
    const V3 lpos = {__ldg(L + 2), __ldg(L + 3), __ldg(L + 4)};
    const V3 lcol = {__ldg(L + 5), __ldg(L + 6), __ldg(L + 7)};

    // _to_light
    const V3 to_l = {lpos.x - pos.x, lpos.y - pos.y, lpos.z - pos.z};
    const float dist = sqrtf(clamp_min(dot3(to_l, to_l), 1e-30f));
    const V3 ldir = {to_l.x / dist, to_l.y / dist, to_l.z / dist};
    const float attenuation = 1.f / (dist * dist * 0.03f);
    V3 radiance;
    if (type == SPOT) {
      const V3 sdir = {__ldg(L + 8), __ldg(L + 9), __ldg(L + 10)};
      const V3 back = {-ldir.x, -ldir.y, -ldir.z};
      const float cos_theta = clamp_min(dot3(back, sdir), 0.f);
      const float theta = acosf(clampf(cos_theta, -1.f, 1.f));
      const float ratio = clampf(theta / __ldg(L + 11), 0.f, 1.f);
      const float visible = 1.f - powf(ratio, 8.f);
      const float w = clamp_max(attenuation, 1.5f) * visible;
      radiance = {lcol.x * w, lcol.y * w, lcol.z * w};
    } else {
      radiance = {lcol.x * attenuation, lcol.y * attenuation,
                  lcol.z * attenuation};
    }

    const float ndotl = clamp_min(dot3(n, ldir), 0.f);
    V3 kd, ks;
    cook_torrance(n, v, ldir, ndotl, albedo, metallic, roughness, a.pi, &kd,
                  &ks);
    if (!a.direct_specular) ks = {0.f, 0.f, 0.f};
    const bool on = ndotl > a.ndotl_min && live && enabled;
    const float w = ndotl * (on ? shadows[s * a.n + i] : 0.f);
    const V3 c = {(kd.x * albedo.x * a.inv_pi + ks.x) * radiance.x * w,
                  (kd.y * albedo.y * a.inv_pi + ks.y) * radiance.y * w,
                  (kd.z * albedo.z * a.inv_pi + ks.z) * radiance.z * w};
    lo = {lo.x + (live ? c.x : 0.f), lo.y + (live ? c.y : 0.f),
          lo.z + (live ? c.z : 0.f)};
  }
  return lo;
}

__device__ __forceinline__ int material(const ShadeArgs& a, int mid) {
  return min(max(mid, 0), a.n_mats - 1);
}

__global__ void __launch_bounds__(THREADS) shade_kernel(const ShadeArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  const V3 o = load3(a.origins, i);
  const V3 d = load3(a.dirs, i);
  if (!a.hit[i]) {
    // the sky gradient, and the max_dist point
    const float up = d.y * 0.7f;
    store3(a.color, i, {0.30f - up, 0.36f - up, 0.60f - up});
    store3(a.hit_pos, i,
           {o.x + d.x * a.max_dist, o.y + d.y * a.max_dist,
            o.z + d.z * a.max_dist});
    return;
  }
  const float t = a.t[i];
  const V3 pos = {o.x + t * d.x, o.y + t * d.y, o.z + t * d.z};
  const V3 n = load3(a.normal, i);
  const int m = material(a, a.mid[i]);
  const V3 albedo = {__ldg(a.albedo + 3 * m + 0), __ldg(a.albedo + 3 * m + 1),
                     __ldg(a.albedo + 3 * m + 2)};
  const float metallic = __ldg(a.metallic + m);
  const float roughness = __ldg(a.roughness + m);

  const V3 direct = direct_lighting(a, i, pos, n, d, albedo, metallic,
                                    roughness, true, a.shadows);

  // reflect(dirs, normal)
  const float dn2 = dot3(d, n) * 2.f;
  const V3 sd = {d.x - dn2 * n.x, d.y - dn2 * n.y, d.z - dn2 * n.z};

  V3 spec = {0.f, 0.f, 0.f};
  if (a.mode == 2 && roughness < 0.75f && a.r_hit[i]) {
    // sample_radiance_no_specular: the lookup plus the highlight at the
    // reflection hit (zero albedo), masked by the reflection's hit and the
    // roughness gate
    spec = load3(a.radiance, i);
    if (a.add_indirect_specular) {
      const V3 from = {pos.x + n.x * a.surf_off, pos.y + n.y * a.surf_off,
                       pos.z + n.z * a.surf_off};
      const float rt = a.r_t[i];
      const V3 spos = {from.x + rt * sd.x, from.y + rt * sd.y,
                       from.z + rt * sd.z};
      const int sm = material(a, a.r_mid[i]);
      const V3 hl = direct_lighting(
          a, i, spos, load3(a.r_normal, i), sd, {0.f, 0.f, 0.f},
          __ldg(a.metallic + sm), __ldg(a.roughness + sm), true,
          a.r_shadows);
      spec = {spec.x + hl.x, spec.y + hl.y, spec.z + hl.z};
    }
  }

  // indirect_lighting with V = -dir and L the specular direction
  const V3 v = {-d.x, -d.y, -d.z};
  const float ndotl = clamp_min(dot3(n, sd), 0.f);
  V3 kd, ks;
  cook_torrance(n, v, sd, ndotl, albedo, metallic, roughness, a.pi, &kd, &ks);
  const float ao = a.ao[i];
  const V3 irr = load3(a.irradiance, i);
  store3(a.color, i,
         {ao * (direct.x + (kd.x * irr.x * a.inv_pi + ks.x * spec.x * ndotl)),
          ao * (direct.y + (kd.y * irr.y * a.inv_pi + ks.y * spec.y * ndotl)),
          ao * (direct.z + (kd.z * irr.z * a.inv_pi + ks.z * spec.z * ndotl))});
  store3(a.hit_pos, i, pos);
}

}  // namespace

extern "C" int madarch_shade(const ShadeArgs* a, void* stream) {
  if (a->n == 0) return 0;
  shade_kernel<<<(a->n + THREADS - 1) / THREADS, THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
