"""Baked signed-distance-field primitives: a mesh rendered through a dense
3D distance grid instead of exact triangles (port of
madarch_tpu/scene/baked_sdf.py).

The grid is sampled trilinearly, translated by the instance's ``position``
field, with the grid's box SDF as a conservative far field so sphere
tracing converges from outside the grid.  It has no kernel form: a scene
holding it renders on the generic route (render/context.py), PyTorch ops
on either device, where the JAX package runs XLA.  The grid and its box
live on the device the scene is evaluated on, copied there once
(primitives.DeviceConstant).
"""
from __future__ import annotations

import numpy as np
import torch

from madarch_tpu_torch.core import vecmath as vm
from madarch_tpu_torch.scene.primitives import (INT, VEC3, DeviceConstant,
                                                PrimitiveType)


def _trilinear(grid, lo, hi, span, top, p):
    """trilinear_sample with its shape constants on p's device: span =
    dims - 1 and top = dims - 2 (f32[3]; the cell index is clamped to top
    in floats, where it is exact)."""
    rel = (p - lo) / (hi - lo) * span
    rel = torch.minimum(torch.clamp_min(rel, 0.0), span)
    i0 = torch.clamp_min(torch.minimum(torch.floor(rel), top), 0.0)
    f = rel - i0
    i0 = i0.long()
    ix, iy, iz = i0[..., 0], i0[..., 1], i0[..., 2]

    def g(dx, dy, dz):
        return grid[ix + dx, iy + dy, iz + dz]

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = g(0, 0, 0) * (1 - fx) + g(1, 0, 0) * fx
    c10 = g(0, 1, 0) * (1 - fx) + g(1, 1, 0) * fx
    c01 = g(0, 0, 1) * (1 - fx) + g(1, 0, 1) * fx
    c11 = g(0, 1, 1) * (1 - fx) + g(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def trilinear_sample(grid, lo, hi, p):
    """Trilinear lookup of grid f32[X,Y,Z] over the box [lo, hi] (f32[3]
    tensors on p's device) at world points p[..., 3]; coordinates clamp to
    the grid border."""
    dims = np.asarray(grid.shape, np.float32)
    span, top = (torch.as_tensor(dims - k).to(p.device) for k in (1, 2))
    return _trilinear(grid, lo, hi, span, top, p)


def make_baked_sdf_primitive(name: str, dist_grid, lo, hi,
                             margin: float = 0.0) -> PrimitiveType:
    """PrimitiveType sampling a baked distance grid.

    dist_grid: f32[X,Y,Z] distances baked over the [lo, hi] box (e.g. from
    ``mesh.bake_distance_map``).  Outside the box the SDF is the box's
    distance plus ``margin``, a lower bound for sphere tracing; the outside
    test is geometric, max(d) > 1e-5, since the 1e-30 under the box's sqrt
    would make it about 1e-15 at the boundary and fake a surface there.
    """
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    dims = np.asarray(np.shape(dist_grid), np.float32)
    consts = {
        "grid": DeviceConstant(dist_grid), "lo": DeviceConstant(lo),
        "hi": DeviceConstant(hi), "span": DeviceConstant(dims - 1),
        "top": DeviceConstant(dims - 2),
        "center": DeviceConstant((lo + hi) / np.float32(2.0)),
        "half": DeviceConstant((hi - lo) / np.float32(2.0)),
    }

    def sdf(params, p):
        c = {k: v.on(p.device) for k, v in consts.items()}
        q = p - params["position"]
        inside_val = _trilinear(c["grid"], c["lo"], c["hi"], c["span"],
                                c["top"], q)
        d = vm.absolute(q - c["center"]) - c["half"]
        o = torch.clamp_min(d, 0.0)
        box = (torch.sqrt(vm.dot(o, o) + 1e-30)
               + torch.clamp_max(torch.amax(d, dim=-1), 0.0))
        outside = torch.amax(d, dim=-1) > 1e-5
        return torch.where(outside, box + margin, inside_val)

    return PrimitiveType(
        name=name,
        fields=(("position", VEC3), ("material_id", INT)),
        sdf=sdf,
        normal=None,  # the autograd gradient of the trilinear field
    )
