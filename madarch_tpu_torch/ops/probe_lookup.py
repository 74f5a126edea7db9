"""The shade's probe lookups as CUDA kernels (csrc/probes.cu; the design
notes are there).

``irradiance_lookup`` is render/probes.py's ``sample_irradiance`` given the
corner visibilities: the 8-corner trilinear, backface- and
visibility-weighted blend of the irradiance atlas, one thread a point.
``radiance_lookup`` is specular mode 2's read of one probe tile of the
radiance atlas's mip 1 (render/probes.py:mode2_radiance).  Their plain
versions are ``sample_irradiance(method="gather")`` and
``sample_tile_bilinear``; render/probes.py takes the kernels on a card
where no gradient has to pass through the lookup (``lookup_method``), and
the dense contraction elsewhere.

The wrappers run on a card only: a tensor on another device, of another
dtype or shape, not contiguous, or one that requires grad raises
(ops/launch.py:check); nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from madarch_tpu_torch.ops import launch


class _IrradianceArgs(ctypes.Structure):
    """csrc/probes.cu:IrradianceArgs."""
    _fields_ = [
        ("pos", ctypes.c_void_p), ("normal", ctypes.c_void_p),
        ("vis8", ctypes.c_void_p), ("atlas", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("n", ctypes.c_int),
        ("spx", ctypes.c_float), ("spy", ctypes.c_float),
        ("spz", ctypes.c_float),
        ("dimx", ctypes.c_int), ("dimy", ctypes.c_int),
        ("dimz", ctypes.c_int),
        ("tiles_x", ctypes.c_int), ("res", ctypes.c_int),
        ("lo", ctypes.c_float), ("hi", ctypes.c_float),
    ]


class _RadianceArgs(ctypes.Structure):
    """csrc/probes.cu:RadianceArgs."""
    _fields_ = [
        ("best_pid", ctypes.c_void_p), ("best_dir", ctypes.c_void_p),
        ("atlas", ctypes.c_void_p), ("out", ctypes.c_void_p),
        ("n", ctypes.c_int), ("tiles_x", ctypes.c_int),
        ("n_tiles", ctypes.c_int), ("res", ctypes.c_int),
        ("lo", ctypes.c_float), ("hi", ctypes.c_float),
    ]


def _tap_bounds(res):
    """sample_tile_bilinear's clamp of the tile coordinates, half a texel
    from the border."""
    return 0.5 / res, 1.0 - 0.5 / res


def irradiance_lookup(settings, atlas, pos, normal, vis8):
    """f32[N, 3]: sample_irradiance(settings, atlas, pos, normal,
    vis8=vis8) on the card.  atlas f32[py·ir, px·ir, 3]; pos, normal
    f32[N, 3]; vis8 f32[8, N], corner-major."""
    dev = pos.device
    n = pos.shape[0]
    res = settings.irradiance_resolution
    px, py = settings.probe_count
    f32 = torch.float32
    launch.check([("pos", pos, f32, (n, 3)), ("normal", normal, f32, (n, 3)),
                  ("vis8", vis8, f32, (8, n)),
                  ("atlas", atlas, f32, (py * res, px * res, 3))], dev,
                 card=True)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    sx, sy, sz = settings.grid_spacing
    dx, dy, dz = settings.grid_dimensions
    lo, hi = _tap_bounds(res)
    args = _IrradianceArgs(
        pos=pos.data_ptr(), normal=normal.data_ptr(), vis8=vis8.data_ptr(),
        atlas=atlas.data_ptr(), out=out.data_ptr(), n=n, spx=sx, spy=sy,
        spz=sz, dimx=dx, dimy=dy, dimz=dz, tiles_x=px, res=res, lo=lo, hi=hi)
    launch.run(launch.library("probes").madarch_irradiance_lookup, args, dev)
    launch.record("irradiance_lookup")
    return out


def radiance_lookup(settings, mip1, best_pid, best_dir):
    """f32[N, 3]: the bilinear tap of tile ``best_pid`` (f32[N], the
    geometry kernel's pick; an id outside the atlas reads 0, as the dense
    route's one-hot) of the radiance atlas's mip 1 (f32[py·rr/2, px·rr/2,
    3], render/probes.py:radiance_mip1) at dir_to_ray_id(best_dir)
    (f32[N, 3])."""
    dev = best_pid.device
    n = best_pid.shape[0]
    res = settings.radiance_resolution // 2
    px, py = settings.probe_count
    f32 = torch.float32
    launch.check([("best_pid", best_pid, f32, (n,)),
                  ("best_dir", best_dir, f32, (n, 3)),
                  ("mip1", mip1, f32, (py * res, px * res, 3))], dev,
                 card=True)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    lo, hi = _tap_bounds(res)
    args = _RadianceArgs(
        best_pid=best_pid.data_ptr(), best_dir=best_dir.data_ptr(),
        atlas=mip1.data_ptr(), out=out.data_ptr(), n=n, tiles_x=px,
        n_tiles=px * py, res=res, lo=lo, hi=hi)
    launch.run(launch.library("probes").madarch_radiance_lookup, args, dev)
    launch.record("radiance_lookup")
    return out
