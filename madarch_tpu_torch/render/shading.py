"""Per-ray shading (port of madarch_tpu/render/shading.py: specular modes 0
to 3, plain and differentiable, on both of the scene's routes).

Where the geometry kernel serves the scene (``SceneCtx.fused_available``),
one launch per ray batch returns hit distance, material, FD normal, AO,
per-light penumbra factors and the 8 probe-visibility bits (and, for mode
2, the folded reflection bounce with its best-probe pick); PyTorch then
does materials and BRDF, and the probe lookups take the kernels of
ops/probe_lookup.py on a card where no gradient passes through them, the
dense atlas contractions elsewhere (render/probes.py:lookup_method).
Mode 1 marches its reflection rays through the raycast kernel and its 8
probe penumbras per point through the softshadow kernel; mode 3 shades
the reflection hit from a second, masked geometry launch without AO.

Elsewhere (a scene the kernels do not take, or a light without a vec3
position) the shade takes the JAX package's unfused branches: a raycast,
the normal as the autodiff scene gradient, the material of the nearest
primitive, AO by SDF probes, one shadow march per light slot and one
batched march of the 8 probe-visibility rays (``ctx``'s marches: the
kernels where the scene is packed, the plain marches on the generic route);
modes 2 and 3 find the reflection hit with a raycast, its normal and
material with ``primitive_info`` and pick mode 2's probe in PyTorch.

With ``cfg.differentiable`` the shade is differentiable in the primitive,
material and light parameters and in the rays: the marches still run
(their outputs are constants to autograd), the hit distance is reattached
by the implicit function theorem and the normals are the autodiff gradient
of the scene distance (render/raymarch.py).  The material, AO, shadows,
probe visibility and mode 2's best-probe pick stay discrete or constant;
mode 3 keeps the masked launch's FD normal at reflection hits, as the JAX
package's kernel path does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from madarch_tpu_torch.core.config import ProbeSettings, ShadeConfig
from madarch_tpu_torch.core.constants import constant
from madarch_tpu_torch.core.vecmath import dot, reflect
from madarch_tpu_torch.ops import probe_lookup
from madarch_tpu_torch.render import probes as probes_mod
from madarch_tpu_torch.render.context import SceneCtx
from madarch_tpu_torch.render.lighting import (direct_lighting,
                                               indirect_lighting)
from madarch_tpu_torch.render.raymarch import (SURFACE_OFFSET,
                                               ambient_occlusion,
                                               attach_hit_gradient,
                                               scene_normal)
from madarch_tpu_torch.scene.scene import (SceneData, SceneSpec,
                                           material_lookup, primitive_info,
                                           primitive_material_id,
                                           scene_sdf, scene_sdf_info,
                                           tree_map)
from madarch_tpu_torch.utils import profiling


def make_sdf_b(spec: SceneSpec, data: SceneData, *, stop_grad: bool):
    """The batched scene distance f32[N,3] -> f32[N]; with ``stop_grad``
    over the scene detached, so no gradient reaches its leaves."""
    d = tree_map(torch.Tensor.detach, data) if stop_grad else data
    return lambda p: scene_sdf(spec, d, p)


def sky_color(dirs):
    """Sky gradient on miss."""
    base = constant((0.30, 0.36, 0.60), dirs.device)
    return base - 0.7 * dirs[..., 1:2]


# Penumbra sharpness of mode 1's probe weights.
GLOSSY_K = 0.5


def _nearest_index(spec, data, pos):
    """Global index i32[N] of the primitive nearest each point, on the
    scene detached (an index carries no gradient)."""
    with torch.no_grad():
        return scene_sdf_info(spec, tree_map(torch.Tensor.detach, data),
                              pos.detach())[1]


def shade_hits(spec, data, probe_settings, cfg, ctx, irr_atlas, rad_atlas,
               pos, normal, dirs, hit, geom=None):
    """Direct + indirect (+ specular) × AO for hit points; f32[N,3].
    ``geom``: the geometry kernel's outputs for these rays (material, AO,
    shadows, probe visibility), or None, and then those are found here;
    ``ctx``: the SceneCtx whose marches they take."""
    if geom is not None:
        material_id = geom["mid"]
        shadows_by_slot, vis8 = geom["shadows"], geom["vis8"]
    else:
        material_id = primitive_material_id(
            spec, data, _nearest_index(spec, data, pos))
        shadows_by_slot = vis8 = None
    albedo, metallic, roughness = material_lookup(data, material_id)

    direct = direct_lighting(
        spec, data, pos, normal, dirs, albedo, metallic, roughness,
        compute_specular=cfg.direct_specular, enabled=hit,
        shadows_by_slot=shadows_by_slot, ctx=ctx,
        max_steps=cfg.max_march_steps)

    irradiance = probes_mod.sample_irradiance(
        probe_settings, irr_atlas, pos, normal, vis8=vis8, ctx=ctx,
        enabled=hit, max_steps=cfg.max_march_steps,
        method=probes_mod.lookup_method(pos.shape[0], irr_atlas, pos,
                                        normal, vis8))

    specular_dir = reflect(dirs, normal)
    specular_col = torch.zeros_like(pos)
    if cfg.indirect_specular_mode > 0:
        # roughness < 0.75 gate
        spec_enabled = hit & (roughness < 0.75)
        if cfg.indirect_specular_mode == 1:
            specular_col = sample_radiance_with_specular(
                spec, probe_settings, cfg, ctx, rad_atlas, pos, normal,
                specular_dir, roughness, enabled=spec_enabled)
        elif cfg.indirect_specular_mode == 2:
            specular_col = sample_radiance_no_specular(
                spec, data, probe_settings, cfg, ctx, rad_atlas, pos,
                normal, specular_dir, enabled=spec_enabled,
                refl=None if geom is None else geom["refl"])
        else:
            specular_col = compute_indirect_specular(
                spec, data, probe_settings, cfg, ctx, irr_atlas, pos,
                normal, specular_dir, enabled=spec_enabled)
        specular_col = torch.where(spec_enabled[..., None], specular_col,
                                   0.0)

    indirect = indirect_lighting(
        irradiance, specular_col, -dirs, normal, specular_dir,
        albedo, metallic, roughness)
    ao = geom["ao"] if geom is not None else ambient_occlusion(
        ctx.sdf_b, pos, normal, steps=cfg.ambient_occlusion_steps)
    return ao[..., None] * (direct + indirect)


def _reflection_geometry(spec, data, probe_settings, cfg, ctx, from_,
                         spec_dir, *, enabled):
    """The reflection ray's geometry for specular modes 2 and 3: (hit,
    spec_pos, normal, material id, vis8 f32[8,N] around the hit, shadows
    f32[L,N] or None).  The masked geometry launch without AO where it
    serves the scene; else a raycast, the nearest primitive's normal and
    material (``primitive_info``; differentiable, its material and the
    autodiff normal), the 8 corner visibility marches, and no shadows:
    direct_lighting marches them."""
    if ctx.fused_available:
        g = ctx.geometry(from_, spec_dir, probe_settings, cfg,
                         enabled=enabled, want_ao=False)
        spec_pos = from_ + g["t"][:, None] * spec_dir
        return (g["hit"], spec_pos, g["normal"], g["mid"], g["vis8"],
                g["shadows"])

    _, hit, spec_pos = ctx.raycast(from_.contiguous(), spec_dir.contiguous(),
                                   spec.max_dist, enabled=enabled,
                                   max_steps=cfg.max_march_steps)
    index = _nearest_index(spec, data, spec_pos)
    if cfg.differentiable:
        s_mid = primitive_material_id(spec, data, index)
        s_normal = scene_normal(ctx.sdf_b_diff, spec_pos)
    else:
        s_normal, s_mid = primitive_info(spec, data, index, spec_pos)

    _, probe_world, _ = probes_mod.probe_corners(probe_settings, spec_pos)
    dir_to_probe, p_dist = probes_mod.unit(probe_world - spec_pos[None])
    vis = probes_mod.corner_visibility(
        ctx, spec_pos, s_normal, dir_to_probe, p_dist, enabled=enabled & hit,
        max_steps=cfg.max_march_steps)
    return hit, spec_pos, s_normal, s_mid, vis, None


def sample_radiance_no_specular(spec, data, probe_settings, cfg, ctx,
                                rad_atlas, pos, normal, spec_dir, *, enabled,
                                refl=None):
    """Indirect specular mode 2: the reflection ray's best probe (by
    backface+visibility weight, the first maximum winning), radiance lookup
    at mip 1, plus the direct specular highlight at the reflection point
    when add_indirect_specular.  ``refl``: the geometry kernel's folded
    reflection geometry (geometry()'s "refl" dict), whose pick the kernel
    made; without it ``_reflection_geometry`` finds the hit and the pick is
    made here.  Differentiable, the reflection hit is a constant and its
    normal the autodiff one there (the JAX package's XLA path); the pick
    stays discrete."""
    n_pts = pos.shape[0]
    settings = probe_settings
    from_ = pos + normal * SURFACE_OFFSET
    if refl is not None:
        hit = refl["hit"]
        spec_pos = from_ + refl["t"][:, None] * spec_dir
        spec_normal, spec_mid = refl["normal"], refl["mid"]
        shadows = refl["shadows"]
        best_pid, best_dir = refl["best_pid"], refl["best_dir"]
    else:
        hit, spec_pos, spec_normal, spec_mid, vis, shadows = \
            _reflection_geometry(spec, data, probe_settings, cfg, ctx,
                                 from_, spec_dir, enabled=enabled)
        offseted, probe_world, _ = probes_mod.probe_corners(settings,
                                                            spec_pos)
        probe_to_spec, _ = probes_mod.unit(spec_pos[None] - probe_world)
        weight = dot(probe_to_spec, -spec_normal[None]) * vis    # [8,N]
        best = torch.argmax(weight, dim=0)
        rows = torch.arange(n_pts, device=pos.device)
        best_dir = probe_to_spec[best, rows]
        best_pid = probes_mod.grid_position_to_probe_id(
            settings, offseted[best, rows]).to(torch.float32)

    with profiling.device_span("probes", pos.device):
        mip1 = probes_mod.radiance_mip1(settings, rad_atlas)
        if probes_mod.lookup_method(n_pts, mip1, best_pid,
                                    best_dir) == "kernel":
            radiance = probe_lookup.radiance_lookup(
                settings, mip1, best_pid.contiguous(), best_dir.contiguous())
        else:
            rad_ray_id = probes_mod.dir_to_ray_id(best_dir)
            px_c, py_c = settings.probe_count
            vals_all = probes_mod.sample_all_tiles_bilinear(
                settings, mip1, rad_ray_id, settings.radiance_resolution // 2)
            radiance = probes_mod.probe_one_hot_combine(
                px_c * py_c, best_pid.to(torch.int32)[None],
                torch.ones((1, n_pts), dtype=torch.float32,
                           device=pos.device),
                vals_all)

    if cfg.add_indirect_specular:
        if refl is not None and cfg.differentiable:
            spec_pos = spec_pos.detach()
            spec_normal = scene_normal(ctx.sdf_b_diff, spec_pos)
        _, spec_metallic, spec_roughness = material_lookup(data, spec_mid)
        highlight = direct_lighting(
            spec, data, spec_pos, spec_normal, spec_dir,
            torch.zeros((n_pts, 3), dtype=torch.float32, device=pos.device),
            spec_metallic, spec_roughness,
            compute_specular=cfg.direct_specular, enabled=enabled & hit,
            shadows_by_slot=shadows, ctx=ctx,
            max_steps=cfg.max_march_steps)
        radiance = radiance + highlight

    return torch.where(hit[..., None], radiance, 0.0)


def glossy_corners(settings: ProbeSettings, pos, spec_pos, enabled):
    """Mode 1's 8 probe-cell corners around pos, seen from the reflection
    hit spec_pos: (corner grid positions i32[8,N,3], trilinear alpha
    f32[N,3], unit corner-to-spec_pos directions f32[8,N,3], and the
    penumbra rays as softshadows' keyword arguments: 8 per point in
    corner-major order, from spec_pos back toward each corner, from
    SURFACE_OFFSET to the corner's distance less SURFACE_OFFSET, enabled
    where ``enabled`` holds)."""
    n_pts = pos.shape[0]
    offseted, probe_world, alpha = probes_mod.probe_corners(settings, pos)
    probe_to_spec, p_dist = probes_mod.unit(
        (pos[None] - probe_world) + (spec_pos - pos)[None])
    rays = {
        "origins": spec_pos[None].expand(8, n_pts, 3).reshape(-1, 3),
        "dirs": (-probe_to_spec).reshape(-1, 3),
        "min_dists": torch.full((8 * n_pts,), SURFACE_OFFSET,
                                dtype=torch.float32, device=pos.device),
        "max_dists": (p_dist - SURFACE_OFFSET).reshape(-1),
        "enabled": enabled[None].expand(8, n_pts).reshape(-1),
    }
    return offseted, alpha, probe_to_spec, rays


def sample_radiance_with_specular(spec, probe_settings, cfg, ctx, rad_atlas,
                                  pos, normal, spec_dir, roughness, *,
                                  enabled):
    """Indirect specular mode 1: glossy probe lookup.  The reflection ray
    (raycast kernel), one penumbra march per probe-cell corner back from
    its hit (softshadow kernel, k = GLOSSY_K) weighting a trilinear
    radiance sample at a roughness-driven mip LOD."""
    n_pts = pos.shape[0]
    settings = probe_settings
    radiance_lods = int(math.log2(settings.radiance_resolution))

    from_ = pos + normal * SURFACE_OFFSET
    _, hit, spec_pos = ctx.raycast(from_, spec_dir, spec.max_dist,
                                   max_steps=cfg.max_march_steps,
                                   enabled=enabled)
    offseted, alpha, probe_to_spec, rays = glossy_corners(
        settings, pos, spec_pos, enabled & hit)
    w = ctx.softshadows(k=GLOSSY_K, max_steps=cfg.max_march_steps,
                        **rays).reshape(8, n_pts)
    weight = torch.clamp_min(w, 0.001)
    offsets = constant(probes_mod.CORNER_OFFSETS, pos.device, np.int32)
    tri = (1.0 - alpha[None]) * (1 - offsets[:, None]) \
        + alpha[None] * offsets[:, None]
    weight = weight * tri[..., 0] * tri[..., 1] * tri[..., 2]

    lod = radiance_lods * torch.clamp(roughness * 2.0, 0.0, 1.0)   # [N]
    pid = probes_mod.grid_position_to_probe_id(settings, offseted)
    tx, ty = probes_mod.probe_id_to_tile(settings, pid)
    rad_ray_id = probes_mod.dir_to_ray_id(probe_to_spec)          # [8,N,2]
    mips = probes_mod.radiance_mips(settings, rad_atlas, radiance_lods)
    vals = probes_mod.sample_tile_lod(
        settings, mips, tx.reshape(-1), ty.reshape(-1),
        rad_ray_id.reshape(-1, 2), lod[None].expand(8, n_pts).reshape(-1))
    vals = vals.reshape(8, n_pts, 3)

    total_w = torch.clamp_min(weight.sum(dim=0), 1e-9)
    radiance = (vals * weight[..., None]).sum(dim=0) / total_w[..., None]
    return torch.where(hit[..., None], radiance, 0.0)


def compute_indirect_specular(spec, data, probe_settings, cfg, ctx,
                              irr_atlas, pos, normal, spec_dir, *, enabled):
    """Indirect specular mode 3: mirror.  A full secondary shade (direct +
    irradiance-lit indirect) at the reflection hit, whose geometry comes
    from ``_reflection_geometry`` (the masked geometry launch without AO
    where it serves the scene); sky gradient on a miss."""
    from_ = pos + normal * SURFACE_OFFSET
    hit, spec_pos, s_normal, s_mid, vis, shadows = _reflection_geometry(
        spec, data, probe_settings, cfg, ctx, from_, spec_dir,
        enabled=enabled)
    s_albedo, s_metallic, s_roughness = material_lookup(data, s_mid)

    direct = direct_lighting(
        spec, data, spec_pos, s_normal, spec_dir, s_albedo, s_metallic,
        s_roughness, compute_specular=cfg.direct_specular,
        enabled=enabled & hit, shadows_by_slot=shadows, ctx=ctx,
        max_steps=cfg.max_march_steps)
    irradiance = probes_mod.sample_irradiance(
        probe_settings, irr_atlas, spec_pos, s_normal, vis8=vis, ctx=ctx,
        enabled=enabled & hit, max_steps=cfg.max_march_steps,
        method=probes_mod.lookup_method(spec_pos.shape[0], irr_atlas,
                                        spec_pos, s_normal, vis))
    sec_spec_dir = reflect(spec_dir, s_normal)
    indirect = indirect_lighting(
        irradiance, torch.zeros_like(spec_pos), -spec_dir, s_normal,
        sec_spec_dir, s_albedo, s_metallic, s_roughness)
    return torch.where(hit[..., None], indirect + direct,
                       sky_color(spec_dir))


def pixel_color(spec: SceneSpec, data: SceneData,
                probe_settings: ProbeSettings, cfg: ShadeConfig,
                irr_atlas, rad_atlas, origins, dirs):
    """Shade a ray batch.  Returns (color f32[N,3], hit bool[N],
    hit_pos f32[N,3]); hit_pos on a miss is the max_dist point.  With
    ``cfg.differentiable`` the hit distance is reattached by the implicit
    function theorem and the normal is the autodiff one, so color and
    hit_pos carry gradients to the scene data and to origins and dirs.
    The geometry kernel serves the batch where ``ctx.fused_available``;
    otherwise a raycast and the autodiff normal (the JAX package's
    ``_fused_ctx`` choice)."""
    ctx = SceneCtx(spec, data)
    geom = None
    if ctx.fused_available:
        geom = ctx.geometry(origins, dirs, probe_settings, cfg,
                            want_reflection=cfg.indirect_specular_mode == 2)
        t, hit, normal = geom["t"], geom["hit"], geom["normal"]
    else:
        t, hit, _ = ctx.raycast(origins, dirs, spec.max_dist,
                                max_steps=cfg.max_march_steps)
    if cfg.differentiable:
        t = attach_hit_gradient(ctx.sdf_b_diff, origins, dirs, t)
    pos = origins + t[:, None] * dirs
    if cfg.differentiable:
        normal = scene_normal(ctx.sdf_b_diff, pos)
    elif geom is None:
        with torch.no_grad():
            normal = scene_normal(ctx.sdf_b_diff, pos)
    lit = shade_hits(spec, data, probe_settings, cfg, ctx, irr_atlas,
                     rad_atlas, pos, normal, dirs, hit, geom)
    color = torch.where(hit[..., None], lit, sky_color(dirs))

    miss_pos = origins + spec.max_dist * dirs
    hit_pos = torch.where(hit[..., None], pos, miss_pos)
    return color, hit, hit_pos
