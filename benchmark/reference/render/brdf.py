"""Cook-Torrance BRDF (port of madarch_tpu/render/brdf.py).

All functions broadcast over leading batch dimensions.
"""
from __future__ import annotations

import torch

from ..core.vecmath import PI, dot, mix, normalize


def fresnel_schlick(cos_theta, f0):
    # pow(1.001 - cosTheta, 5): the 1.001 bias is reference behavior
    return f0 + (1.0 - f0) * ((1.001 - cos_theta) ** 5.0)[..., None]


def distribution_ggx(n, h, roughness):
    a = roughness * roughness
    a2 = a * a
    ndoth = torch.clamp_min(dot(n, h), 0.0)
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom)


def geometry_schlick_ggx(ndotv, roughness):
    r = roughness + 1.0
    k = (r * r) / 8.0
    return ndotv / (ndotv * (1.0 - k) + k)


def geometry_smith(ndotv, ndotl, roughness):
    return (geometry_schlick_ggx(ndotv, roughness)
            * geometry_schlick_ggx(ndotl, roughness))


def cook_torrance_coefficients(n, v, l, ndotl, albedo, metallic, roughness):
    """Returns (kD, kS)."""
    h = normalize(v + l)
    ndotv = torch.clamp_min(dot(n, v), 0.0)

    f0 = mix(torch.full_like(albedo, 0.04), albedo, metallic[..., None])
    ndf = distribution_ggx(n, h, roughness)
    g = geometry_smith(ndotv, ndotl, roughness)
    f = fresnel_schlick(torch.clamp_min(dot(h, v), 0.0), f0)

    numerator = (ndf * g)[..., None] * f
    denominator = 4.0 * ndotv * ndotl

    kd = (1.0 - f) * (1.0 - metallic)[..., None]
    ks = torch.clamp_max(
        numerator / torch.clamp_min(denominator, 1e-3)[..., None], 1.0)
    return kd, ks
