"""The shade of a ray batch given its geometry as one CUDA kernel
(csrc/shade.cu; the design notes are there).

``shade`` is render/shading.py:pixel_color's work after the geometry launch
and the probe lookups, for specular modes 0 and 2 with point and spot
lights: the material, every light slot's direct term, mode 2's highlight at
the folded reflection hit, the indirect term, AO, the sky and the hit
position, one thread a ray.  Its plain version is that chain itself
(``shade_hits`` and the end of ``pixel_color``); the shade takes the kernel
where render/shading.py:shade_method says so, and the chain elsewhere.

``pack_lights`` packs the light table the kernel reads: LIGHT_FLOATS floats
a slot in ``spec.light_bounds()`` order (the geometry kernel's shadow
order), built on the device from the scene data, so a frame captured into
a CUDA graph packs it from its input buffers.

The wrapper runs on a card only: a tensor of another dtype or shape, not
contiguous, one that requires grad or one on another device raises
(ops/launch.py:check); nothing falls back.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from madarch_tpu_torch.core.vecmath import EPSILON, PI
from madarch_tpu_torch.ops import launch
from madarch_tpu_torch.scene.lights import PointLight, SpotLight

# Floats a light slot takes in the table: type, live, position (3), colour
# (3), spot direction (3), spot aperture, 4 of padding.
LIGHT_FLOATS = 16
# The table's type codes (csrc/shade.cu: SPOT).
LIGHT_CODES = {PointLight: 0.0, SpotLight: 1.0}


class _ShadeArgs(ctypes.Structure):
    """csrc/shade.cu:ShadeArgs."""
    _fields_ = [
        *((name, ctypes.c_void_p) for name in (
            "origins", "dirs", "t", "hit", "normal", "mid", "ao", "shadows",
            "irradiance", "r_t", "r_hit", "r_mid", "r_normal", "r_shadows",
            "radiance", "albedo", "metallic", "roughness", "lights", "color",
            "hit_pos")),
        *((name, ctypes.c_int) for name in (
            "n", "n_mats", "n_lights", "mode", "direct_specular",
            "add_indirect_specular")),
        *((name, ctypes.c_float) for name in (
            "max_dist", "surf_off", "ndotl_min", "pi", "inv_pi")),
    ]


def kernel_lights(spec) -> bool:
    """Whether the kernel takes the scene's lights: every light type of
    ``spec.light_bounds()`` is the built-in point or spot light."""
    return all(ltype in LIGHT_CODES for ltype, _, _, _ in spec.light_bounds())


def pack_lights(spec, data):
    """f32[L, LIGHT_FLOATS]: every light slot of ``spec.light_bounds()``
    (L = ops/march.py:pack_light_positions's count), its type code, 1.0 if
    live (the slots past a dynamic count 0.0), position, colour, and for a
    spot light its direction and aperture.  Raises ValueError on a light
    type the kernel does not take."""
    dev = data.materials["albedo"].device
    rows = []
    for ltype, _, n, static in spec.light_bounds():
        if n == 0:
            continue
        if ltype not in LIGHT_CODES:
            raise ValueError(f"the shade kernel takes point and spot lights, "
                             f"not {ltype.name}")
        p = {k: v[:n].to(torch.float32) for k, v in
             data.lights[ltype.name].items()}
        zeros = torch.zeros((n, 1), dtype=torch.float32, device=dev)
        live = zeros + 1.0 if static else (
            torch.arange(n, device=dev) < data.light_counts[ltype.name]
        ).to(torch.float32)[:, None]
        spot = ltype is SpotLight
        rows.append(torch.cat([
            zeros + LIGHT_CODES[ltype], live, p["position"], p["color"],
            p["direction"] if spot else zeros.expand(n, 3),
            p["aperture"][:, None] if spot else zeros,
            zeros.expand(n, 4)], dim=1))
    if not rows:
        return torch.zeros((0, LIGHT_FLOATS), dtype=torch.float32,
                           device=dev)
    return torch.cat(rows).contiguous()


# PyTorch divides a card's tensor by a Python number as a product with the
# number's float reciprocal: kd * albedo / PI is (kd * albedo) * INV_PI
_PI = float(np.float32(PI))
_INV_PI = float(np.float32(1.0) / np.float32(PI))


def shade(lights, materials, origins, dirs, geom, irradiance, radiance=None,
          *, mode, direct_specular, add_indirect_specular, max_dist,
          surface_offset):
    """(color f32[N, 3], hit_pos f32[N, 3]) of pixel_color on the card.

    ``lights``: pack_lights' table; ``materials``: the scene data's
    material dict (albedo f32[M, 3], metallic and roughness f32[M]);
    origins, dirs f32[N, 3]; ``geom``: the geometry kernel's outputs for
    these rays (ops/march.py:geometry: t, hit, normal, mid, ao, shadows
    [L, N], and with ``mode`` 2 "refl"); ``irradiance`` f32[N, 3]: the
    irradiance lookup at the hits; ``radiance`` f32[N, 3]: mode 2's mip-1
    lookup at the reflection's pick (None in mode 0)."""
    if mode not in (0, 2):
        raise ValueError(f"the shade kernel takes specular modes 0 and 2, "
                         f"not {mode}")
    dev = origins.device
    n = origins.shape[0]
    n_lights = lights.shape[0]
    m = materials["albedo"].shape[0]
    f32, i32 = torch.float32, torch.int32
    inputs = [("lights", lights, f32, (n_lights, LIGHT_FLOATS)),
              ("albedo", materials["albedo"], f32, (m, 3)),
              ("metallic", materials["metallic"], f32, (m,)),
              ("roughness", materials["roughness"], f32, (m,)),
              ("origins", origins, f32, (n, 3)),
              ("dirs", dirs, f32, (n, 3)),
              ("irradiance", irradiance, f32, (n, 3))]

    def geometry_inputs(prefix, g):
        return [(prefix + "t", g["t"], f32, (n,)),
                (prefix + "hit", g["hit"], torch.bool, (n,)),
                (prefix + "normal", g["normal"], f32, (n, 3)),
                (prefix + "mid", g["mid"], i32, (n,)),
                (prefix + "shadows", g["shadows"], f32, (n_lights, n))]

    inputs += geometry_inputs("", geom) + [("ao", geom["ao"], f32, (n,))]
    if mode == 2:
        if geom["refl"] is None or radiance is None:
            raise ValueError("specular mode 2 needs the folded reflection "
                             "(geom['refl']) and the radiance lookup")
        inputs += geometry_inputs("r_", geom["refl"]) + [
            ("radiance", radiance, f32, (n, 3))]
    launch.check(inputs, dev, card=True)
    if m == 0:
        raise ValueError("the scene has no material")

    color = torch.empty((n, 3), dtype=f32, device=dev)
    hit_pos = torch.empty((n, 3), dtype=f32, device=dev)
    ptrs = {name: x.data_ptr() for name, x, _, _ in inputs}
    args = _ShadeArgs(
        **ptrs, color=color.data_ptr(), hit_pos=hit_pos.data_ptr(), n=n,
        n_mats=m, n_lights=n_lights, mode=mode,
        direct_specular=int(direct_specular),
        add_indirect_specular=int(add_indirect_specular), max_dist=max_dist,
        surf_off=surface_offset, ndotl_min=EPSILON, pi=_PI, inv_pi=_INV_PI)
    launch.run(launch.library("shade").madarch_shade, args, dev)
    launch.record("shade")
    return color, hit_pos
