"""Per-ray shading (port of madarch_tpu/render/shading.py, the
non-differentiable path with specular modes 0 and 2).

One geometry-kernel launch per ray batch returns hit distance, material,
FD normal, AO, per-light penumbra factors and the 8 probe-visibility bits
(and, for mode 2, the folded reflection bounce with its best-probe pick);
PyTorch then does materials, BRDF and the atlas contractions.
"""
from __future__ import annotations

import torch

from madarch_tpu_torch.core.config import ProbeSettings, ShadeConfig
from madarch_tpu_torch.core.vecmath import reflect, vec3
from madarch_tpu_torch.render import probes as probes_mod
from madarch_tpu_torch.render.context import SceneCtx
from madarch_tpu_torch.render.lighting import (direct_lighting,
                                               indirect_lighting)
from madarch_tpu_torch.render.raymarch import SURFACE_OFFSET
from madarch_tpu_torch.scene.scene import (SceneData, SceneSpec,
                                           material_lookup)


def sky_color(dirs):
    """Sky gradient on miss."""
    base = vec3(0.30, 0.36, 0.60, device=dirs.device)
    return base - 0.7 * dirs[..., 1:2]


def shade_hits(spec, data, probe_settings, cfg, irr_atlas, rad_atlas, pos,
               normal, dirs, hit, geom):
    """Direct + indirect (+ specular) × AO for hit points; f32[N,3].
    ``geom``: the geometry kernel's outputs for these rays."""
    albedo, metallic, roughness = material_lookup(data, geom["mid"])

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
            spec, data, probe_settings, cfg, rad_atlas, pos, normal,
            specular_dir, enabled=spec_enabled, refl=geom["refl"])
        specular_col = torch.where(spec_enabled[..., None], specular_col,
                                   0.0)

    indirect = indirect_lighting(
        irradiance, specular_col, -dirs, normal, specular_dir,
        albedo, metallic, roughness)
    return geom["ao"][..., None] * (direct + indirect)


def sample_radiance_no_specular(spec, data, probe_settings, cfg, rad_atlas,
                                pos, normal, spec_dir, *, enabled, refl):
    """Indirect specular mode 2: the reflection ray's best probe (picked in
    the kernel by backface+visibility weight), radiance lookup at mip 1,
    plus the direct specular highlight at the reflection point when
    add_indirect_specular.  ``refl``: the kernel's folded reflection
    geometry (geometry()'s "refl" dict)."""
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
        _, spec_metallic, spec_roughness = material_lookup(data, refl["mid"])
        highlight = direct_lighting(
            spec, data, spec_pos, refl["normal"], spec_dir,
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
    hit_pos f32[N,3]); hit_pos on a miss is the max_dist point."""
    if cfg.differentiable:
        raise NotImplementedError("the differentiable shade is not ported")
    if cfg.indirect_specular_mode not in (0, 2):
        raise NotImplementedError(
            f"specular mode {cfg.indirect_specular_mode} is not ported")
    ctx = SceneCtx(spec, data)
    geom = ctx.geometry(origins, dirs, probe_settings, cfg,
                        want_reflection=cfg.indirect_specular_mode == 2)
    t, hit = geom["t"], geom["hit"]
    pos = origins + t[:, None] * dirs
    lit = shade_hits(spec, data, probe_settings, cfg, irr_atlas, rad_atlas,
                     pos, geom["normal"], dirs, hit, geom)
    color = torch.where(hit[..., None], lit, sky_color(dirs))

    miss_pos = origins + spec.max_dist * dirs
    hit_pos = torch.where(hit[..., None], pos, miss_pos)
    return color, hit, hit_pos
