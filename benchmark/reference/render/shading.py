"""Per-ray shading (a frozen copy of the port's render/shading.py, cut to
what the benchmark's cells run: specular mode 2 on the kernel route,
plain and differentiable).

Where the geometry kernel serves the scene (``SceneCtx.fused_available``),
one launch per ray batch returns hit distance, material, FD normal, AO,
per-light penumbra factors and the 8 probe-visibility bits, and for mode
2 the folded reflection bounce with its best-probe pick; PyTorch then
does materials, BRDF and the atlas contractions.  Modes 1 and 3 and the
generic route (a scene the kernels do not take) are not copied: no cell
runs them.

With ``cfg.differentiable`` the shade is differentiable in the primitive,
material and light parameters and in the rays: the marches still run
(their outputs are constants to autograd), the hit distance is reattached
by the implicit function theorem and the normals are the autodiff gradient
of the scene distance (render/raymarch.py).  The material, AO, shadows,
probe visibility and mode 2's best-probe pick stay discrete or constant.
"""
from __future__ import annotations

import torch

from ..core.config import ProbeSettings, ShadeConfig
from ..core.constants import constant
from ..core.vecmath import reflect
from ..render import probes as probes_mod
from ..render.context import SceneCtx
from ..render.lighting import direct_lighting, indirect_lighting
from ..render.raymarch import (SURFACE_OFFSET, attach_hit_gradient,
                               scene_normal)
from ..scene.scene import SceneData, SceneSpec, material_lookup


def sky_color(dirs):
    """Sky gradient on miss."""
    base = constant((0.30, 0.36, 0.60), dirs.device)
    return base - 0.7 * dirs[..., 1:2]


def shade_hits(spec, data, probe_settings, cfg, ctx, irr_atlas, rad_atlas,
               pos, normal, dirs, hit, geom):
    """Direct + indirect (+ specular) × AO for hit points; f32[N,3].
    ``geom``: the geometry kernel's outputs for these rays (material, AO,
    shadows, probe visibility, the folded reflection); ``ctx``: their
    SceneCtx."""
    material_id = geom["mid"]
    albedo, metallic, roughness = material_lookup(data, material_id)

    direct = direct_lighting(
        spec, data, pos, normal, dirs, albedo, metallic, roughness,
        compute_specular=cfg.direct_specular, enabled=hit,
        shadows_by_slot=geom["shadows"])

    irradiance = probes_mod.sample_irradiance(
        probe_settings, irr_atlas, pos, normal, vis8=geom["vis8"])

    specular_dir = reflect(dirs, normal)
    specular_col = torch.zeros_like(pos)
    if cfg.indirect_specular_mode == 2:
        # roughness < 0.75 gate
        spec_enabled = hit & (roughness < 0.75)
        specular_col = sample_radiance_no_specular(
            spec, data, probe_settings, cfg, ctx, rad_atlas, pos, normal,
            specular_dir, enabled=spec_enabled, refl=geom["refl"])
        specular_col = torch.where(spec_enabled[..., None], specular_col,
                                   0.0)
    elif cfg.indirect_specular_mode != 0:
        raise NotImplementedError("the reference copies specular modes 0 "
                                  "and 2 only")

    indirect = indirect_lighting(
        irradiance, specular_col, -dirs, normal, specular_dir,
        albedo, metallic, roughness)
    return geom["ao"][..., None] * (direct + indirect)


def sample_radiance_no_specular(spec, data, probe_settings, cfg, ctx,
                                rad_atlas, pos, normal, spec_dir, *, enabled,
                                refl):
    """Indirect specular mode 2: the reflection ray's best probe (by
    backface+visibility weight, the first maximum winning), radiance lookup
    at mip 1, plus the direct specular highlight at the reflection point
    when add_indirect_specular.  ``refl``: the geometry kernel's folded
    reflection geometry (geometry()'s "refl" dict), whose pick the kernel
    made.  Differentiable, the reflection hit is a constant and its
    normal the autodiff one there; the pick stays discrete."""
    n_pts = pos.shape[0]
    settings = probe_settings
    from_ = pos + normal * SURFACE_OFFSET
    hit = refl["hit"]
    spec_pos = from_ + refl["t"][:, None] * spec_dir
    spec_normal, spec_mid = refl["normal"], refl["mid"]
    pid = refl["best_pid"].to(torch.int32)
    best_dir = refl["best_dir"]

    rad_ray_id = probes_mod.dir_to_ray_id(best_dir)
    mip1 = probes_mod.radiance_mip1(settings, rad_atlas)
    px_c, py_c = settings.probe_count
    vals_all = probes_mod.sample_all_tiles_bilinear(
        settings, mip1, rad_ray_id, settings.radiance_resolution // 2)
    radiance = probes_mod.probe_one_hot_combine(
        px_c * py_c, pid[None],
        torch.ones((1, n_pts), dtype=torch.float32, device=pos.device),
        vals_all)

    if cfg.add_indirect_specular:
        if cfg.differentiable:
            spec_pos = spec_pos.detach()
            spec_normal = scene_normal(ctx.sdf_b_diff, spec_pos)
        _, spec_metallic, spec_roughness = material_lookup(data, spec_mid)
        highlight = direct_lighting(
            spec, data, spec_pos, spec_normal, spec_dir,
            torch.zeros((n_pts, 3), dtype=torch.float32, device=pos.device),
            spec_metallic, spec_roughness,
            compute_specular=cfg.direct_specular, enabled=enabled & hit,
            shadows_by_slot=refl["shadows"])
        radiance = radiance + highlight

    return torch.where(hit[..., None], radiance, 0.0)


def pixel_color(spec: SceneSpec, data: SceneData,
                probe_settings: ProbeSettings, cfg: ShadeConfig,
                irr_atlas, rad_atlas, origins, dirs):
    """Shade a ray batch.  Returns (color f32[N,3], hit bool[N],
    hit_pos f32[N,3]); hit_pos on a miss is the max_dist point.  With
    ``cfg.differentiable`` the hit distance is reattached by the implicit
    function theorem and the normal is the autodiff one, so color and
    hit_pos carry gradients to the scene data and to origins and dirs.
    Only where the geometry kernel serves the scene."""
    ctx = SceneCtx(spec, data)
    geom = ctx.geometry(origins, dirs, probe_settings, cfg,
                        want_reflection=cfg.indirect_specular_mode == 2)
    t, hit, normal = geom["t"], geom["hit"], geom["normal"]
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
