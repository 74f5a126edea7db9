"""The shade's probe lookups as CUDA kernels (csrc/probes.cu; the design
notes are there).

``irradiance_lookup`` is render/probes.py's ``sample_irradiance`` given the
corner visibilities: the 8-corner trilinear, backface- and
visibility-weighted blend of the irradiance atlas, one thread a point.
``radiance_lookup`` is specular mode 2's read of one probe tile of the
radiance atlas's mip 1 (render/shading.py:sample_radiance_no_specular).
Their plain versions are ``sample_irradiance(method="gather")`` and
``sample_tile_bilinear``; the shade takes the kernels on a card where no
gradient has to pass through the lookup (render/probes.py:lookup_method),
and the dense contraction elsewhere.

The wrappers run on a card only: a tensor on another device, of another
dtype or shape, not contiguous, or one that requires grad (a ctypes launch
would drop its gradient silently) raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from madarch_tpu_torch.ops import build


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


@functools.cache
def library():
    """csrc/probes.cu built (on first use) and loaded."""
    lib = build.load("probes")
    for fn in (lib.madarch_irradiance_lookup, lib.madarch_radiance_lookup):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(name, x, device, shape):
    if x.device.type != "cuda" or x.device != device:
        raise ValueError(f"{name} is on {x.device}: the probe lookup "
                         f"kernels take tensors on one card ({device})")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {x.dtype}, expected float32")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.requires_grad:
        raise ValueError(f"{name} requires grad: the kernel would drop its "
                         f"gradient (take the dense lookup)")


def _tap_bounds(res):
    """sample_tile_bilinear's clamp of the tile coordinates, half a texel
    from the border."""
    return 0.5 / res, 1.0 - 0.5 / res


def _launch(fn, args, dev):
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.addressof(args), stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")


def irradiance_lookup(settings, atlas, pos, normal, vis8):
    """f32[N, 3]: sample_irradiance(settings, atlas, pos, normal,
    vis8=vis8) on the card.  atlas f32[py·ir, px·ir, 3]; pos, normal
    f32[N, 3]; vis8 f32[8, N], corner-major."""
    dev = pos.device
    n = pos.shape[0]
    res = settings.irradiance_resolution
    px, py = settings.probe_count
    _check("pos", pos, dev, (n, 3))
    _check("normal", normal, dev, (n, 3))
    _check("vis8", vis8, dev, (8, n))
    _check("atlas", atlas, dev, (py * res, px * res, 3))
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    sx, sy, sz = settings.grid_spacing
    dx, dy, dz = settings.grid_dimensions
    lo, hi = _tap_bounds(res)
    args = _IrradianceArgs(
        pos=pos.data_ptr(), normal=normal.data_ptr(), vis8=vis8.data_ptr(),
        atlas=atlas.data_ptr(), out=out.data_ptr(), n=n, spx=sx, spy=sy,
        spz=sz, dimx=dx, dimy=dy, dimz=dz, tiles_x=px, res=res, lo=lo, hi=hi)
    _launch(library().madarch_irradiance_lookup, args, dev)
    irradiance_lookup.launches += 1
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
    _check("best_pid", best_pid, dev, (n,))
    _check("best_dir", best_dir, dev, (n, 3))
    _check("mip1", mip1, dev, (py * res, px * res, 3))
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    lo, hi = _tap_bounds(res)
    args = _RadianceArgs(
        best_pid=best_pid.data_ptr(), best_dir=best_dir.data_ptr(),
        atlas=mip1.data_ptr(), out=out.data_ptr(), n=n, tiles_x=px,
        n_tiles=px * py, res=res, lo=lo, hi=hi)
    _launch(library().madarch_radiance_lookup, args, dev)
    radiance_lookup.launches += 1
    return out


# Kernel launches since the count was last reset, counted as the march
# wrappers' are (ops/march.py:add_launches: a frame captured into a CUDA
# graph takes its capture's calls back out and adds them at each replay).
irradiance_lookup.launches = 0
radiance_lookup.launches = 0
