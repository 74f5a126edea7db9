"""Alternate render modes: direct light only, an N-sample one-bounce
Monte-Carlo estimator, and a bounded path tracer (port of
madarch_tpu/render/pathtrace.py).

Each function shades a flat ray batch origins, dirs f32[N, 3] and returns
f32[N, 3] before tonemapping.  Every surface query is one raycast
(``SceneCtx.raycast``: the raycast kernel where the kernels take the
scene, else the plain march) and every light slot's shadow rays one
penumbra march (``SceneCtx.softshadows``, through ``direct_lighting``).
Bounce and sample loops are Python loops of fixed counts, as in the
reference; the random directions come from ``render/sampling.py`` with a
``torch.Generator`` in place of the JAX package's key (None: the default
generator of the rays' device).

The functions are differentiable where autograd is on and the scene or
the rays carry gradients: the hit distance is reattached by the implicit
function theorem and the normals are the autodiff ones, as in the JAX
package.  Otherwise they run without autograd, so a frame of 101 queries
holds no graph.
"""
from __future__ import annotations

import torch

from madarch_tpu_torch.core.vecmath import absolute, dot, normalize, reflect
from madarch_tpu_torch.render import sampling
from madarch_tpu_torch.render.context import SceneCtx
from madarch_tpu_torch.render.lighting import direct_lighting
from madarch_tpu_torch.render.raymarch import (SURFACE_OFFSET,
                                               ambient_occlusion,
                                               attach_hit_gradient,
                                               scene_normal)
from madarch_tpu_torch.render.shading import _nearest_index, sky_color
from madarch_tpu_torch.scene.scene import (material_lookup,
                                           primitive_material_id,
                                           tree_leaves)


def _grad_mode(data, *rays):
    """Autograd on only where it is on and the scene or a ray batch needs
    gradients."""
    return torch.set_grad_enabled(torch.is_grad_enabled() and any(
        x.requires_grad for x in tree_leaves(data) + list(rays)))


def _surface_query(spec, data, ctx, origins, dirs, max_steps):
    """(hit, pos, normal, albedo, metallic, roughness) of one raycast: the
    material of the primitive nearest the hit (the same material as the
    JAX package's primitive_info, whose normal this discards)."""
    t, hit, _ = ctx.raycast(origins.contiguous(), dirs.contiguous(),
                            spec.max_dist, max_steps=max_steps)
    if torch.is_grad_enabled():
        t = attach_hit_gradient(ctx.sdf_b_diff, origins, dirs, t)
    pos = origins + t[:, None] * dirs
    normal = scene_normal(ctx.sdf_b_diff, pos)
    mid = primitive_material_id(spec, data, _nearest_index(spec, data, pos))
    albedo, metallic, roughness = material_lookup(data, mid)
    return hit, pos, normal, albedo, metallic, roughness


def pixel_color_direct(spec, data, origins, dirs, *, ao_steps=3,
                       compute_specular=True, max_steps=300, ctx=None):
    """render_direct.glsl: AO × direct light at the primary hit, the sky
    on a miss.  ``ctx``: the scene's SceneCtx, built here when None."""
    with _grad_mode(data, origins, dirs):
        if ctx is None:
            ctx = SceneCtx(spec, data)
        hit, pos, normal, albedo, metallic, roughness = _surface_query(
            spec, data, ctx, origins, dirs, max_steps)
        direct = direct_lighting(
            spec, data, pos, normal, dirs, albedo, metallic, roughness,
            compute_specular=compute_specular, enabled=hit, ctx=ctx,
            max_steps=max_steps)
        ao = ambient_occlusion(ctx.sdf_b, pos, normal, steps=ao_steps)
        return torch.where(hit[..., None], ao[..., None] * direct,
                           sky_color(dirs))


def pixel_color_many(spec, data, origins, dirs, generator=None, *,
                     gi_samples=100, max_steps=300):
    """render_many.glsl: direct + (1/S)·Σ direct(one sampled bounce)·|n·d|
    over S = ``gi_samples`` bounces from pos + normal·SURFACE_OFFSET.  The
    bounce direction, per the reference: with probability ``roughness`` a
    uniform hemisphere direction, else the mirror direction perturbed by
    roughness·uniform_vector.  Each sample draws u, the hemisphere point
    and the perturbation, in that order."""
    with _grad_mode(data, origins, dirs):
        ctx = SceneCtx(spec, data)
        hit, pos, normal, albedo, metallic, roughness = _surface_query(
            spec, data, ctx, origins, dirs, max_steps)
        direct = direct_lighting(
            spec, data, pos, normal, dirs, albedo, metallic, roughness,
            compute_specular=True, enabled=hit, ctx=ctx, max_steps=max_steps)
        from_ = pos + normal * SURFACE_OFFSET
        reflected = reflect(dirs, normal)
        acc = torch.zeros_like(direct)
        dev = origins.device
        for _ in range(gi_samples):
            u = sampling.uniform(generator, hit.shape, dev)
            d_diff = sampling.random_hemisphere_point(generator, normal)
            d_spec = normalize(reflected + sampling.uniform_vector(
                generator, hit.shape, dev) * roughness[..., None])
            d = torch.where((u < roughness)[..., None], d_diff, d_spec)
            sample = pixel_color_direct(spec, data, from_, d, ao_steps=0,
                                        max_steps=max_steps, ctx=ctx)
            acc = acc + sample * absolute(dot(d, normal))[..., None]
        out = direct + acc / gi_samples
        return torch.where(hit[..., None], out, sky_color(dirs))


def pixel_color_path(spec, data, origins, dirs, generator=None, *,
                     gi_bounces=3, max_steps=300):
    """render_path.glsl: a path of gi_bounces + 1 segments with an albedo
    throughput mask.  Two behaviours of the reference are kept on purpose
    (ROADMAP C): a segment that misses adds the sky unmasked, and as its
    ray goes on unchanged it misses and adds the sky again on every
    remaining segment; the next segment starts at the hit itself, with no
    surface offset, so it hits again at t = 0.  Each bounce draws u, the
    cosine direction and the perturbation, in that order."""
    with _grad_mode(data, origins, dirs):
        ctx = SceneCtx(spec, data)
        dev = origins.device
        result = torch.zeros(origins.shape, dtype=torch.float32, device=dev)
        mask = torch.ones_like(result)
        from_, d = origins, dirs
        for bounce in range(gi_bounces + 1):
            hit, pos, normal, albedo, metallic, roughness = _surface_query(
                spec, data, ctx, from_, d, max_steps)
            direct = direct_lighting(
                spec, data, pos, normal, d, albedo, metallic, roughness,
                compute_specular=True, enabled=hit, ctx=ctx,
                max_steps=max_steps)
            result = result + torch.where(hit[..., None], mask * direct, 0.0)
            result = result + torch.where(hit[..., None], 0.0, sky_color(d))
            mask = torch.where(hit[..., None], mask * albedo, mask)
            if bounce == gi_bounces:
                break
            u = sampling.uniform(generator, hit.shape, dev)
            d_diff = sampling.cosine_direction(generator, normal)
            d_spec = normalize(reflect(d, normal) + sampling.uniform_vector(
                generator, hit.shape, dev) * roughness[..., None])
            new_d = torch.where((u < roughness)[..., None], d_diff, d_spec)
            d = torch.where(hit[..., None], new_d, d)
            from_ = torch.where(hit[..., None], pos, from_)
        return result
