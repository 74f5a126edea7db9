"""Direct and indirect lighting (port of madarch_tpu/render/lighting.py).

The per-light penumbra factors come from the geometry kernel
(``shadows_by_slot``), which marches every light slot's shadow ray in the
same launch as the primary trace (the port's march of its own per light,
for scenes the geometry kernel does not take, is not copied: no cell
runs it).
"""
from __future__ import annotations

import torch

from ..core.vecmath import EPSILON, PI, dot
from ..render.brdf import cook_torrance_coefficients


def direct_lighting(spec, data, pos, normal, view_dir, albedo, metallic,
                    roughness, *, compute_specular, shadows_by_slot,
                    enabled=None):
    """compute_direct_lighting for a batch of points.

    view_dir is the *incoming* ray direction; shading uses V = -dir.
    ``shadows_by_slot`` f32[L, N] holds one penumbra factor per light slot
    in light_bounds order (ops.march.geometry's "shadows").
    """
    n_pts = pos.shape[0]
    v = -view_dir
    lo = torch.zeros((n_pts, 3), dtype=torch.float32, device=pos.device)

    slot_i = 0
    for ltype, cap, n, static in spec.light_bounds():
        count = None if static else data.light_counts[ltype.name]
        for slot in range(n):
            live = True if static else slot < count
            params = {k: a[slot] for k, a in data.lights[ltype.name].items()}
            radiance, ldir, _ = ltype.sample(params, pos, normal)
            ndotl = torch.clamp_min(dot(normal, ldir), 0.0)

            kd, ks = cook_torrance_coefficients(
                normal, v, ldir, ndotl, albedo, metallic, roughness)
            if not compute_specular:
                ks = torch.zeros_like(ks)

            shadow_on = (ndotl > EPSILON) if static \
                else (ndotl > EPSILON) & live
            if enabled is not None:
                shadow_on = shadow_on & enabled
            shadows = shadows_by_slot[slot_i]
            slot_i += 1
            shadows = torch.where(shadow_on, shadows, 0.0)

            contrib = ((kd * albedo / PI + ks)
                       * radiance * (ndotl * shadows)[..., None])
            lo = lo + (contrib if static else torch.where(live, contrib, 0.0))
    return lo


def indirect_lighting(irradiance, radiance, v, n, l, albedo, metallic,
                      roughness):
    """compute_indirect_lighting: kD·irradiance/π + kS·radiance·NdotL, with
    L the specular direction."""
    ndotl = torch.clamp_min(dot(n, l), 0.0)
    kd, ks = cook_torrance_coefficients(
        n, v, l, ndotl, albedo, metallic, roughness)
    return kd * irradiance / PI + ks * radiance * ndotl[..., None]
