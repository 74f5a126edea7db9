"""Batched sphere-tracing loops: raycast, visibility, soft shadows, AO,
and the two places where gradients re-enter (port of
madarch_tpu/render/raymarch.py).

The marches are the plain PyTorch versions: the CPU path and the oracles
that ``ops.march.geometry_reference`` composes.  Each step evaluates the
scene only at the lanes still marching (gathered by index), which gives the
same per-lane arithmetic as the reference's masked full-batch step at a
fraction of the work; the loop ends when no lane is active.  A march is a
non-differentiable estimator: it runs under no_grad (the JAX package
stop-gradients its rays and closes its scene over stop-gradient data), so
no autograd graph grows through its steps whatever it is given.
Gradients come back through ``attach_hit_gradient`` (the implicit function
theorem at the hit) and ``scene_normal`` (the autodiff SDF gradient).
"""
from __future__ import annotations

import torch

from ..core.vecmath import EPSILON, dot

MAX_STEPS = 300
MIN_STEP_SIZE = 0.05
# Over-relaxation factor (Keinert et al., "Enhanced Sphere Tracing"): step
# ω·d and back up when consecutive bounding spheres stop overlapping
# (|d|+prev < step), then fall back to ω=1 for that lane.
RELAXATION = 1.6
# Offset of secondary-ray origins off the surface.
SURFACE_OFFSET = MIN_STEP_SIZE * 5.0


def _active0(origins, enabled):
    n = origins.shape[0]
    if enabled is None:
        return torch.ones(n, dtype=torch.bool, device=origins.device)
    return enabled.to(torch.bool).clone()


def _over_relaxed(sdf_b, origins, dirs, max_dists, active, eps, max_steps,
                  omega, count_steps=False, caps=None):
    """The ω-relaxed march with the Keinert backtrack shared by raycast and
    raycast_visibility.  ``max_dists`` is per ray.  Returns (t, blocked,
    steps): blocked marks lanes that stopped on a hit; with
    ``count_steps``, steps i32[N] is each lane's march steps (its scene
    evaluations), else None.  ``caps`` f32[N], optional: a lane whose cap
    is 0 does not march, and one retires unblocked at the first position
    t >= cap that is not a backtrack (the kernels' box-exit cap,
    ops/march.py:ray_box_cap)."""
    n = origins.shape[0]
    if caps is not None:
        active = active & (caps > 0.0)
    t = torch.zeros(n, dtype=torch.float32, device=origins.device)
    prev_r = torch.zeros_like(t)
    step_len = torch.zeros_like(t)
    om = torch.full_like(t, omega)
    blocked = torch.zeros_like(active)
    steps = torch.zeros(n, dtype=torch.int32, device=origins.device) \
        if count_steps else None
    for _ in range(max_steps):
        ids = active.nonzero().squeeze(1)
        if ids.numel() == 0:
            break
        if steps is not None:
            steps[ids] += 1
        ta = t[ids]
        d = sdf_b(origins[ids] + ta[:, None] * dirs[ids])
        pr, sl, o = prev_r[ids], step_len[ids], om[ids]
        fail = (o > 1.0) & (torch.abs(d) + pr <= sl)
        hit = ~fail & (d < eps)
        new_step = torch.where(fail, sl * (1.0 - omega), d * o)
        om[ids] = torch.where(fail, 1.0, o)
        still = ~hit
        if caps is not None:
            still = still & (fail | (ta < caps[ids]))
        ta = torch.where(still, ta + new_step, ta)
        t[ids] = ta
        prev_r[ids] = torch.where(still, torch.abs(d), pr)
        step_len[ids] = torch.where(still, new_step, sl)
        blocked[ids] = hit
        active[ids] = still & (ta < max_dists[ids])
    return t, blocked, steps


def _snap_capped(t, caps, en, max_dist):
    """t with max_dist where an enabled ray ended at its cap short of
    max_dist: such a ray is a miss (the kernels' miss convention)."""
    eff = torch.clamp_max(caps, max_dist)
    return torch.where(en & (t >= eff) & (eff < max_dist), max_dist, t)


@torch.no_grad()
def raycast_distance(sdf_b, origins, dirs, max_dist, *, eps=EPSILON,
                     max_steps=MAX_STEPS, enabled=None, omega=RELAXATION,
                     caps=None):
    """The march of ``raycast`` alone: t f32[N], where each ray stopped (0
    where disabled), for a caller that classifies the end point itself;
    ``caps`` as raycast's."""
    max_dists = torch.full((origins.shape[0],), max_dist,
                           dtype=torch.float32, device=origins.device)
    en = _active0(origins, enabled)
    t = _over_relaxed(sdf_b, origins, dirs, max_dists, en.clone(), eps,
                      max_steps, omega, caps=caps)[0]
    return t if caps is None else _snap_capped(t, caps, en, max_dist)


@torch.no_grad()
@torch.no_grad()
def raycast_visibility(sdf_b, origins, dirs, max_dists, *, eps=EPSILON,
                       max_steps=MAX_STEPS, enabled=None, omega=RELAXATION,
                       return_steps=False, caps=None):
    """1.0 if the ray reaches its own max distance unobstructed, else 0.0;
    max_dists is per ray f32[N].  With ``return_steps`` also each ray's
    march steps i32[N].  ``caps``: optional f32[N] box-exit caps, at which
    a ray ends unblocked."""
    active = _active0(origins, enabled) & (0.0 < max_dists)
    _, blocked, steps = _over_relaxed(sdf_b, origins, dirs, max_dists,
                                      active, eps, max_steps, omega,
                                      return_steps, caps)
    vis = torch.where(blocked, 0.0, 1.0)
    return (vis, steps) if return_steps else vis


@torch.no_grad()
def softshadows(sdf_b, origins, dirs, min_dists, max_dists, k, *,
                eps=EPSILON, max_steps=MAX_STEPS, enabled=None,
                return_steps=False):
    """Cone-approximation penumbra march with the improved-penumbra trick:
    y = d²/(2·prev), shadow = min(shadow, k·sqrt(d²−y²)/(t−y)), the sample
    counted only where t−y > 1e-9.  Returns f32[N], 0 where the shadow ray
    hits geometry, and with ``return_steps`` each ray's march steps
    i32[N]."""
    n = origins.shape[0]
    dev = origins.device
    t = torch.broadcast_to(torch.as_tensor(min_dists, dtype=torch.float32,
                                           device=dev), (n,)).clone()
    max_dists = torch.broadcast_to(
        torch.as_tensor(max_dists, dtype=torch.float32, device=dev), (n,))
    res = torch.ones(n, dtype=torch.float32, device=dev)
    prev = torch.full_like(res, 1e20)
    active = _active0(origins, enabled) & (t < max_dists)
    blocked = torch.zeros_like(active)
    steps = torch.zeros(n, dtype=torch.int32, device=dev) \
        if return_steps else None
    for _ in range(max_steps):
        ids = active.nonzero().squeeze(1)
        if ids.numel() == 0:
            break
        if steps is not None:
            steps[ids] += 1
        ta = t[ids]
        d = sdf_b(origins[ids] + ta[:, None] * dirs[ids])
        hit = d < eps
        still = ~hit
        pv = prev[ids]
        y = d * d / (2.0 * pv)
        dd = torch.sqrt(torch.clamp_min(d * d - y * y, 0.0))
        denom = ta - y
        pen = torch.where(denom > 1e-9, k * dd / torch.clamp_min(denom, 1e-9),
                          torch.inf)
        r = res[ids]
        res[ids] = torch.where(still, torch.minimum(r, pen), r)
        prev[ids] = torch.where(still, d, pv)
        ta = torch.where(still, ta + d, ta)
        t[ids] = ta
        blocked[ids] = hit
        active[ids] = still & (ta < max_dists[ids])
    res = torch.where(blocked, 0.0, res)
    return (res, steps) if return_steps else res


def ambient_occlusion(sdf_b, pos, normal, *, steps=3, step_size=0.1):
    """Exponentially-weighted SDF probes along the normal:
    ao = 0.6 + 0.4·Σ(wᵢ·sdf(p+n·(i+1)h)) / Σ(wᵢ·(i+1)h), wᵢ = 2^-i."""
    if steps <= 0:
        return torch.ones(pos.shape[:-1], dtype=torch.float32,
                          device=pos.device)
    ao_sum = 0.0
    max_ao_sum = 0.0
    for i in range(steps):
        factor = 1.0 / (2.0 ** i)
        h = (i + 1) * step_size
        ao_sum = ao_sum + factor * sdf_b(pos + normal * h)
        max_ao_sum = max_ao_sum + factor * h
    return 0.6 + 0.4 * ao_sum / max_ao_sum


def attach_hit_gradient(sdf_b_diff, origins, dirs, t):
    """Re-attach parameter gradients to a march distance t f32[N] that
    carries none (a kernel's or a plain march's).

    ``sdf_b_diff`` is the batched scene distance over the live scene data.
    Returns t' equal to t in value whose derivative obeys the implicit
    function theorem at the surface:
        t' = t − (f(o + t·d; θ) − sg(f)) / sg(d·∇f).
    Gradients flow to the scene parameters and to origins and dirs (camera
    derivatives need them).  d·∇f is taken on detached copies, and a
    grazing |d·∇f| < 1e-3 is pushed out to ±1e-3 (+1e-3 at exactly 0), bit
    for bit the JAX package's guard."""
    t_sg = t.detach()
    p = origins + t_sg[:, None] * dirs
    f = sdf_b_diff(p)
    with torch.enable_grad():
        q = p.detach().requires_grad_(True)
        grad_q, = torch.autograd.grad(sdf_b_diff(q).sum(), q)
    denom = dot(grad_q, dirs.detach())
    denom = torch.where(torch.abs(denom) < 1e-3,
                        torch.sign(denom) * 1e-3 + (denom == 0.0) * 1e-3,
                        denom)
    return t_sg - (f - f.detach()) / denom


def scene_normal(sdf_b_diff, pos):
    """Surface normal as the normalized scene-SDF gradient at pos f32[N,3]:
    g = ∂(Σ f)/∂q, kept differentiable in the scene parameters (through
    sdf_b_diff's data) and in pos when either carries gradients.  The
    gradient is taken inside enable_grad, so under no_grad it returns the
    same values without a graph.  g / sqrt(|g|² + 1e-24), the JAX form:
    max(|g|, eps) has a 0·inf = NaN backward at g = 0 (far-miss lanes sit
    on the constant max_dist cap)."""
    outer = torch.is_grad_enabled()
    with torch.enable_grad():
        q = pos if pos.requires_grad and outer \
            else pos.detach().requires_grad_(True)
        g, = torch.autograd.grad(sdf_b_diff(q).sum(), q, create_graph=outer)
    return g / torch.sqrt(dot(g, g) + 1e-24)[..., None]
