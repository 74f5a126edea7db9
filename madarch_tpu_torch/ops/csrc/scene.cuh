// Scene evaluation and the sphere-tracing marches shared by the kernels of
// this directory (geometry.cu, march.cu): one thread marches one ray.
//
// The scene is the packed table of ops/march.py:pack_scene, one row of
// SLOT_WIDTH floats per evaluated slot: (type, global index, material id,
// live flag, 6 params).  Every live slot is evaluated exactly (no culling).
// Built with -fmad=false, so each float operation rounds like the plain
// PyTorch marches of render/raymarch.py.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int SLOT_WIDTH = 10;  // type, gidx, mid, live, 6 params
constexpr float BIG = 1e9f;
enum SlotType { SPHERE = 0, PLANE = 1, BOX = 2 };

// max_dist caps every scene distance; dead slots read as it.
struct Scene {
  const float* slots;
  int n_slots;
  float max_dist;
};

__device__ __forceinline__ float slot_dist(const float* r, float px,
                                           float py, float pz) {
  const int type = static_cast<int>(r[0]);
  if (type == SPHERE) {
    const float dx = r[4] - px;
    const float dy = r[5] - py;
    const float dz = r[6] - pz;
    return sqrtf(dx * dx + dy * dy + dz * dz) - r[7];
  }
  if (type == PLANE) {
    return r[4] * px + r[5] * py + r[6] * pz + r[7];
  }
  const float qx = fabsf(r[4] - px) - r[7];
  const float qy = fabsf(r[5] - py) - r[8];
  const float qz = fabsf(r[6] - pz) - r[9];
  const float ox = fmaxf(qx, 0.f);
  const float oy = fmaxf(qy, 0.f);
  const float oz = fmaxf(qz, 0.f);
  const float outside = sqrtf(ox * ox + oy * oy + oz * oz);
  const float inside = fminf(fmaxf(qx, fmaxf(qy, qz)), 0.f);
  return outside + inside;
}

// Scene distance: min over live slots, capped at max_dist.  Dead slots
// (dynamic counts) read as max_dist and so never win.
__device__ float scene_dist(const Scene& sc, float px, float py, float pz) {
  float best = sc.max_dist;
  for (int s = 0; s < sc.n_slots; ++s) {
    const float* r = sc.slots + s * SLOT_WIDTH;
    float d = slot_dist(r, px, py, pz);
    if (r[3] < 0.5f) d = sc.max_dist;
    best = fminf(best, d);
  }
  return best;
}

// (distance, global index, material id); strict < so the first minimum in
// spec order wins; index -1 and material 0 when nothing is under max_dist.
__device__ float scene_info(const Scene& sc, float px, float py, float pz,
                            int* idx, int* mid) {
  float best = sc.max_dist;
  int bi = -1;
  int bm = 0;
  for (int s = 0; s < sc.n_slots; ++s) {
    const float* r = sc.slots + s * SLOT_WIDTH;
    float d = slot_dist(r, px, py, pz);
    if (r[3] < 0.5f) d = sc.max_dist;
    if (d < best) {
      best = d;
      bi = static_cast<int>(r[1]);
      bm = static_cast<int>(r[2]);
    }
  }
  *idx = bi;
  *mid = bm;
  return best;
}

struct March {
  float max_dist, eps, omega, one_minus_omega, shadow_k;
  int max_steps;
};

// Over-relaxed sphere trace with the Keinert backtrack; t = the march
// distance where it stopped (t >= max_dist on a miss).
__device__ float march_primary(const Scene& sc, const March& m, float ox,
                               float oy, float oz, float dx, float dy,
                               float dz, bool active) {
  float t = 0.f, prev_r = 0.f, step_len = 0.f, om = m.omega;
  for (int step = 0; step < m.max_steps && active; ++step) {
    const float dist = scene_dist(sc, ox + t * dx, oy + t * dy, oz + t * dz);
    const bool fail = om > 1.f && fabsf(dist) + prev_r <= step_len;
    if (!fail && dist < m.eps) break;
    const float new_step = fail ? step_len * m.one_minus_omega : dist * om;
    if (fail) om = 1.f;
    t = t + new_step;
    prev_r = fabsf(dist);
    step_len = new_step;
    active = t < m.max_dist;
  }
  return t;
}

// 1 if the ray reaches mx unobstructed, else 0; starts only if 0 < mx.
__device__ float march_visibility(const Scene& sc, const March& m, float ox,
                                  float oy, float oz, float dx, float dy,
                                  float dz, float mx, bool active) {
  float t = 0.f, prev_r = 0.f, step_len = 0.f, om = m.omega;
  active = active && 0.f < mx;
  for (int step = 0; step < m.max_steps && active; ++step) {
    const float dist = scene_dist(sc, ox + t * dx, oy + t * dy, oz + t * dz);
    const bool fail = om > 1.f && fabsf(dist) + prev_r <= step_len;
    if (!fail && dist < m.eps) return 0.f;
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
__device__ float march_shadow(const Scene& sc, const March& m, float ox,
                              float oy, float oz, float dx, float dy,
                              float dz, float t0, float mx, bool active) {
  float t = t0, res = 1.f, prev = 1e20f;
  active = active && t < mx;
  for (int step = 0; step < m.max_steps && active; ++step) {
    const float dist = scene_dist(sc, ox + t * dx, oy + t * dy, oz + t * dz);
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
