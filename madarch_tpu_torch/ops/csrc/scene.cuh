// Scene evaluation and the sphere-tracing marches shared by the kernels of
// this directory (geometry.cu, march.cu): one thread marches one ray.
//
// The scene is what ops/march.py:pack_scene packs:
//  - the slot table, one row of SLOT_WIDTH floats per sphere, plane or box
//    slot: (type, global index, material id, live flag, 6 params); every
//    live slot is evaluated at every point;
//  - the triangle table, one row of TRI_WIDTH floats per triangle slot in
//    slot (Morton) order: the 28 constants of the derived triangle SDF,
//    then global index, material id and live flag.  Slots come in chunks
//    of CHUNK with one bounding box each, chunks in super-chunks of SUPER
//    with one box each; padded and dead slots make inert boxes.
//
// Triangles are pruned exactly.  A box's point-to-box distance bounds
// every triangle in it from below, so a box whose bound exceeds the
// running minimum cannot change the minimum.  tri_min visits the nearest
// super-chunk first, then every other super-chunk, and within each only
// the chunks whose bound is within `slack` of the running minimum.  The
// slack (PRUNE_REL times the scene's and the point's coordinate scale)
// covers the rounding of a bound and of a triangle's distance, so the
// pruned minimum is the unpruned one bit for bit.  Ties go to the lower
// global index: the first minimum of the plain version's spec-order scan.
//
// Built with -fmad=false, so each float operation rounds like the plain
// PyTorch marches of render/raymarch.py.  The scene functions and marches
// are templates on TRIS: scenes without triangles compile to the code
// they had before triangles came.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int SLOT_WIDTH = 10;  // type, gidx, mid, live, 6 params
constexpr int TRI_WIDTH = 32;   // 28 derived constants, gidx, mid, live, 0
constexpr int CHUNK = 8;        // triangle slots per chunk box
constexpr int SUPER = 8;        // chunks per super-chunk box
constexpr int BOX_WIDTH = 6;    // lo xyz, hi xyz
constexpr float PRUNE_REL = 1e-4f;
constexpr float BIG = 1e9f;
enum SlotType { SPHERE = 0, PLANE = 1, BOX = 2 };

// max_dist caps every scene distance; dead slots read as it.  With
// triangles: `tris` in device memory (read through the read-only cache)
// and `boxes` in shared memory: boxes[0] the coordinate scale, then from
// boxes + BOX_WIDTH n_supers super-chunk boxes and n_chunks chunk boxes.
struct Scene {
  const float* slots;
  int n_slots;
  float max_dist;
  const float* tris;
  const float* boxes;
  int n_chunks;
  int n_supers;
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

// Distance from p to one triangle row (primitives.py:
// _triangle_sdf_planar_derived, operation for operation); the row's
// global index, material id and live flag come back through the pointers.
__device__ __forceinline__ float tri_dist(const float* row, float px,
                                          float py, float pz, float* gidx,
                                          float* mid, float* live) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4 a = __ldg(r4 + 0);  // v1 xyz, v21 x
  const float4 b = __ldg(r4 + 1);  // v21 yz, v32 xy
  const float4 c = __ldg(r4 + 2);  // v32 z, v13 xyz
  const float4 d = __ldg(r4 + 3);  // nor xyz, n21 x
  const float4 e = __ldg(r4 + 4);  // n21 yz, n32 xy
  const float4 f = __ldg(r4 + 5);  // n32 z, n13 xyz
  const float4 g = __ldg(r4 + 6);  // i21, i32, i13, inor
  const float4 h = __ldg(r4 + 7);  // gidx, mid, live, 0
  *gidx = h.x;
  *mid = h.y;
  *live = h.z;
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

// Squared distance from p to a box (0 inside it).
__device__ __forceinline__ float box_d2(const float* b, float px, float py,
                                        float pz) {
  const float dx = fmaxf(fmaxf(b[0] - px, px - b[3]), 0.f);
  const float dy = fmaxf(fmaxf(b[1] - py, py - b[4]), 0.f);
  const float dz = fmaxf(fmaxf(b[2] - pz, pz - b[5]), 0.f);
  return dx * dx + dy * dy + dz * dz;
}

// Folds one super-chunk's admitted chunks into (best, bi, bm); INFO keeps
// the first minimum by global index.
template <bool INFO>
__device__ void tri_super(const Scene& sc, int s, float slack, float px,
                          float py, float pz, float& best, int& bi,
                          int& bm) {
  const float* chunk_boxes = sc.boxes + BOX_WIDTH * (1 + sc.n_supers);
  const int c_end = min(sc.n_chunks, (s + 1) * SUPER);
  for (int ch = s * SUPER; ch < c_end; ++ch) {
    const float lim = best + slack;
    if (box_d2(chunk_boxes + BOX_WIDTH * ch, px, py, pz) > lim * lim) {
      continue;
    }
    for (int j = 0; j < CHUNK; ++j) {
      float gidx, mid, live;
      const float d = tri_dist(sc.tris + (ch * CHUNK + j) * TRI_WIDTH, px,
                               py, pz, &gidx, &mid, &live);
      if (live < 0.5f) continue;
      if (INFO) {
        const int gi = static_cast<int>(gidx);
        if (d < best || (d == best && gi < bi)) {
          best = d;
          bi = gi;
          bm = static_cast<int>(mid);
        }
      } else {
        best = fminf(best, d);
      }
    }
  }
}

// The pruned triangle minimum folded into (best, bi, bm): the nearest
// super-chunk first, then the others whose bound is within slack.
template <bool INFO>
__device__ void tri_min(const Scene& sc, float px, float py, float pz,
                        float& best, int& bi, int& bm) {
  const float slack =
      PRUNE_REL * (sc.boxes[0] + fabsf(px) + fabsf(py) + fabsf(pz));
  const float* super_boxes = sc.boxes + BOX_WIDTH;
  int first = 0;
  float first_d2 = box_d2(super_boxes, px, py, pz);
  for (int s = 1; s < sc.n_supers; ++s) {
    const float d2 = box_d2(super_boxes + BOX_WIDTH * s, px, py, pz);
    if (d2 < first_d2) {
      first_d2 = d2;
      first = s;
    }
  }
  for (int k = -1; k < sc.n_supers; ++k) {
    if (k == first) continue;
    const int s = k < 0 ? first : k;
    const float lim = best + slack;
    if (box_d2(super_boxes + BOX_WIDTH * s, px, py, pz) > lim * lim) {
      continue;
    }
    tri_super<INFO>(sc, s, slack, px, py, pz, best, bi, bm);
  }
}

// Scene distance: min over live slots, capped at max_dist.  Dead slots
// (dynamic counts) read as max_dist and so never win.
template <bool TRIS>
__device__ float scene_dist(const Scene& sc, float px, float py, float pz) {
  float best = sc.max_dist;
  for (int s = 0; s < sc.n_slots; ++s) {
    const float* r = sc.slots + s * SLOT_WIDTH;
    float d = slot_dist(r, px, py, pz);
    if (r[3] < 0.5f) d = sc.max_dist;
    best = fminf(best, d);
  }
  if (TRIS) {
    int bi = -1, bm = 0;
    tri_min<false>(sc, px, py, pz, best, bi, bm);
  }
  return best;
}

// (distance, global index, material id); the first minimum in spec (=
// global index) order wins; index -1 and material 0 when nothing is under
// max_dist.
template <bool TRIS>
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
  if (TRIS) tri_min<true>(sc, px, py, pz, best, bi, bm);
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
template <bool TRIS>
__device__ float march_primary(const Scene& sc, const March& m, float ox,
                               float oy, float oz, float dx, float dy,
                               float dz, bool active) {
  float t = 0.f, prev_r = 0.f, step_len = 0.f, om = m.omega;
  for (int step = 0; step < m.max_steps && active; ++step) {
    const float dist =
        scene_dist<TRIS>(sc, ox + t * dx, oy + t * dy, oz + t * dz);
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
template <bool TRIS>
__device__ float march_visibility(const Scene& sc, const March& m, float ox,
                                  float oy, float oz, float dx, float dy,
                                  float dz, float mx, bool active) {
  float t = 0.f, prev_r = 0.f, step_len = 0.f, om = m.omega;
  active = active && 0.f < mx;
  for (int step = 0; step < m.max_steps && active; ++step) {
    const float dist =
        scene_dist<TRIS>(sc, ox + t * dx, oy + t * dy, oz + t * dz);
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
template <bool TRIS>
__device__ float march_shadow(const Scene& sc, const March& m, float ox,
                              float oy, float oz, float dx, float dy,
                              float dz, float t0, float mx, bool active) {
  float t = t0, res = 1.f, prev = 1e20f;
  active = active && t < mx;
  for (int step = 0; step < m.max_steps && active; ++step) {
    const float dist =
        scene_dist<TRIS>(sc, ox + t * dx, oy + t * dy, oz + t * dz);
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
