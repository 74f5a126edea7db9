"""Per-ray shading (port of madarch_tpu/render/shading.py's kernel path,
specular modes 0 to 3, plain and differentiable).

One geometry-kernel launch per ray batch returns hit distance, material,
FD normal, AO, per-light penumbra factors and the 8 probe-visibility bits
(and, for mode 2, the folded reflection bounce with its best-probe pick);
PyTorch then does materials, BRDF and the atlas contractions.  Mode 1
marches its reflection rays through the raycast kernel and its 8 probe
penumbras per point through the softshadow kernel; mode 3 shades the
reflection hit from a second, masked geometry launch without AO.

With ``cfg.differentiable`` the shade is differentiable in the primitive,
material and light parameters and in the rays: the kernels still march
(their outputs are constants to autograd), the hit distance is reattached
by the implicit function theorem and the normals are the autodiff gradient
of the scene distance (render/raymarch.py).  The kernel's material, AO,
shadows, probe visibility and mode 2's best-probe pick stay discrete or
constant; mode 3 keeps the masked launch's FD normal at reflection hits,
as the JAX package's kernel path does.
"""
from __future__ import annotations

import math

import torch

from madarch_tpu_torch.core.config import ProbeSettings, ShadeConfig
from madarch_tpu_torch.core.vecmath import dot, reflect, vec3
from madarch_tpu_torch.render import probes as probes_mod
from madarch_tpu_torch.render.context import SceneCtx
from madarch_tpu_torch.render.lighting import (direct_lighting,
                                               indirect_lighting)
from madarch_tpu_torch.render.raymarch import (SURFACE_OFFSET,
                                               attach_hit_gradient,
                                               scene_normal)
from madarch_tpu_torch.scene.scene import (SceneData, SceneSpec,
                                           material_lookup)


def sky_color(dirs):
    """Sky gradient on miss."""
    base = vec3(0.30, 0.36, 0.60, device=dirs.device)
    return base - 0.7 * dirs[..., 1:2]


# Penumbra sharpness of mode 1's probe weights.
GLOSSY_K = 0.5


def shade_hits(spec, data, probe_settings, cfg, ctx, irr_atlas, rad_atlas,
               pos, normal, dirs, hit, geom):
    """Direct + indirect (+ specular) × AO for hit points; f32[N,3].
    ``geom``: the geometry kernel's outputs for these rays; ``ctx``: the
    SceneCtx whose kernels modes 1 and 3 launch."""
    albedo, metallic, roughness = material_lookup(data, geom["mid"])

    direct = direct_lighting(
        spec, data, pos, normal, dirs, albedo, metallic, roughness,
        compute_specular=cfg.direct_specular, enabled=hit,
        shadows_by_slot=geom["shadows"])

    irradiance = probes_mod.sample_irradiance(
        probe_settings, irr_atlas, pos, normal, vis8=geom["vis8"])

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
                refl=geom["refl"])
        else:
            specular_col = compute_indirect_specular(
                spec, data, probe_settings, cfg, ctx, irr_atlas, pos,
                normal, specular_dir, enabled=spec_enabled)
        specular_col = torch.where(spec_enabled[..., None], specular_col,
                                   0.0)

    indirect = indirect_lighting(
        irradiance, specular_col, -dirs, normal, specular_dir,
        albedo, metallic, roughness)
    return geom["ao"][..., None] * (direct + indirect)


def sample_radiance_no_specular(spec, data, probe_settings, cfg, ctx,
                                rad_atlas, pos, normal, spec_dir, *, enabled,
                                refl):
    """Indirect specular mode 2: the reflection ray's best probe (picked in
    the kernel by backface+visibility weight), radiance lookup at mip 1,
    plus the direct specular highlight at the reflection point when
    add_indirect_specular.  ``refl``: the kernel's folded reflection
    geometry (geometry()'s "refl" dict).  Differentiable, the reflection
    hit is a constant and its normal the autodiff one there (the JAX
    package's XLA path); the pick stays the kernel's discrete one."""
    n_pts = pos.shape[0]
    settings = probe_settings
    from_ = pos + normal * SURFACE_OFFSET
    hit = refl["hit"]
    spec_pos = from_ + refl["t"][:, None] * spec_dir

    pid = refl["best_pid"].to(torch.int32)
    rad_ray_id = probes_mod.dir_to_ray_id(refl["best_dir"])
    mip1 = probes_mod.radiance_mip1(settings, rad_atlas)
    px_c, py_c = settings.probe_count
    vals_all = probes_mod.sample_all_tiles_bilinear(
        settings, mip1, rad_ray_id, settings.radiance_resolution // 2)
    radiance = probes_mod.probe_one_hot_combine(
        px_c * py_c, pid[None],
        torch.ones((1, n_pts), dtype=torch.float32, device=pos.device),
        vals_all)

    if cfg.add_indirect_specular:
        spec_normal = refl["normal"]
        if cfg.differentiable:
            spec_pos = spec_pos.detach()
            spec_normal = scene_normal(ctx.sdf_b_diff, spec_pos)
        _, spec_metallic, spec_roughness = material_lookup(data, refl["mid"])
        highlight = direct_lighting(
            spec, data, spec_pos, spec_normal, spec_dir,
            torch.zeros((n_pts, 3), dtype=torch.float32, device=pos.device),
            spec_metallic, spec_roughness,
            compute_specular=cfg.direct_specular, enabled=enabled & hit,
            shadows_by_slot=refl["shadows"])
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
    dev = pos.device
    spacing = torch.tensor(settings.grid_spacing, dtype=torch.float32,
                           device=dev)
    dims = torch.tensor(settings.grid_dimensions, dtype=torch.int32,
                        device=dev)
    grid_pos = torch.floor(pos / spacing).to(torch.int32)
    alpha = pos / spacing - grid_pos.to(torch.float32)
    offsets = torch.tensor(probes_mod.CORNER_OFFSETS, dtype=torch.int32,
                           device=dev)
    offseted = torch.minimum(
        torch.clamp_min(grid_pos[None] + offsets[:, None], 0), dims - 1)
    probe_world = offseted.to(torch.float32) * spacing
    probe_to_spec = (pos[None] - probe_world) + (spec_pos - pos)[None]
    # max(|v|, 1e-6) with a finite backward at v = 0 (probes.py)
    p_dist = torch.sqrt(torch.clamp_min(dot(probe_to_spec, probe_to_spec),
                                        1e-12))
    probe_to_spec = probe_to_spec / p_dist[..., None]
    rays = {
        "origins": spec_pos[None].expand(8, n_pts, 3).reshape(-1, 3),
        "dirs": (-probe_to_spec).reshape(-1, 3),
        "min_dists": torch.full((8 * n_pts,), SURFACE_OFFSET,
                                dtype=torch.float32, device=dev),
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
    offsets = torch.tensor(probes_mod.CORNER_OFFSETS, dtype=torch.int32,
                           device=pos.device)
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
    from a masked geometry launch without AO; sky gradient on a miss."""
    from_ = pos + normal * SURFACE_OFFSET
    g = ctx.geometry(from_, spec_dir, probe_settings, cfg, enabled=enabled,
                     want_ao=False)
    hit = g["hit"]
    spec_pos = from_ + g["t"][:, None] * spec_dir
    s_normal = g["normal"]
    s_albedo, s_metallic, s_roughness = material_lookup(data, g["mid"])

    direct = direct_lighting(
        spec, data, spec_pos, s_normal, spec_dir, s_albedo, s_metallic,
        s_roughness, compute_specular=cfg.direct_specular,
        enabled=enabled & hit, shadows_by_slot=g["shadows"])
    irradiance = probes_mod.sample_irradiance(
        probe_settings, irr_atlas, spec_pos, s_normal, vis8=g["vis8"])
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
    hit_pos carry gradients to the scene data and to origins and dirs."""
    ctx = SceneCtx(spec, data)
    geom = ctx.geometry(origins, dirs, probe_settings, cfg,
                        want_reflection=cfg.indirect_specular_mode == 2)
    t, hit = geom["t"], geom["hit"]
    normal = geom["normal"]
    if cfg.differentiable:
        t = attach_hit_gradient(ctx.sdf_b_diff, origins, dirs, t)
    pos = origins + t[:, None] * dirs
    if cfg.differentiable:
        normal = scene_normal(ctx.sdf_b_diff, pos)
    lit = shade_hits(spec, data, probe_settings, cfg, ctx, irr_atlas,
                     rad_atlas, pos, normal, dirs, hit, geom)
    color = torch.where(hit[..., None], lit, sky_color(dirs))

    miss_pos = origins + spec.max_dist * dirs
    hit_pos = torch.where(hit[..., None], pos, miss_pos)
    return color, hit, hit_pos
