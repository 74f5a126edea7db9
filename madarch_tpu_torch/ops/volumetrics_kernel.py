"""The volumetric passes' tensor math as CUDA kernels (csrc/volumetrics.cu;
the design notes are there).

``scatter_integral`` is render/volumetrics.py:scattering_pass after its
raycast: each texel's length and its n_steps weighted taps of the froxel
column under it, one thread a texel.  ``fog_composite`` is ``composite``:
the 3x3 depth-aware search and the fog blend, one thread a pixel.
``froxel_inscatter`` is one light slot's term of visibility_pass's
``froxel_light`` after the slot's sample and visibility launch, added into
the running sum in place, one thread a froxel.  Their plain versions are
those functions' PyTorch ops; render/volumetrics.py takes the kernels where
ops/launch.py:takes says so (``method``), and the ops elsewhere.

The wrappers run on a card only: a tensor on another device, of another
dtype or shape, not contiguous, or one that requires grad raises
(ops/launch.py:check); nothing falls back.
"""
from __future__ import annotations

import ctypes

import torch

from madarch_tpu_torch.core.vecmath import PI
from madarch_tpu_torch.ops import launch


class _ScatterArgs(ctypes.Structure):
    """csrc/volumetrics.cu:ScatterArgs."""
    _fields_ = [
        *((name, ctypes.c_void_p) for name in (
            "t", "hit", "visibility", "weights", "out")),
        *((name, ctypes.c_int) for name in (
            "sx", "sy", "vx", "vy", "vz", "n_steps")),
        *((name, ctypes.c_float) for name in (
            "max_depth", "step", "vis_step")),
    ]


class _CompositeArgs(ctypes.Structure):
    """csrc/volumetrics.cu:CompositeArgs."""
    _fields_ = [
        *((name, ctypes.c_void_p) for name in (
            "scattering", "color", "ray_len", "ix", "iy", "out")),
        *((name, ctypes.c_int) for name in ("w", "h", "sx", "sy")),
        *((name, ctypes.c_float) for name in ("max_dist", "tau")),
    ]


class _InscatterArgs(ctypes.Structure):
    """csrc/volumetrics.cu:InscatterArgs."""
    _fields_ = [
        *((name, ctypes.c_void_p) for name in (
            "ldist", "vis", "radiance", "ldir", "dirs", "live", "result")),
        ("n", ctypes.c_int),
        *((name, ctypes.c_float) for name in (
            "tau", "hg_num", "hg_base", "hg_2g", "four_pi")),
    ]


def scatter_integral(t, hit, visibility, weights, *, scattering_resolution,
                     max_depth, step, visibility_step):
    """f32[sy, sx, 4]: each texel's (in-scattered L, length).  t f32[sy·sx]
    and hit bool[sy·sx]: the raycast's, texel-major (hit None: t is the
    length already, every texel counts as a hit); visibility f32[vz, vy,
    vx, 3]; weights f32[n_steps]: each tap's exp(−f·τ)."""
    dev = t.device
    sx, sy = scattering_resolution
    vz, vy, vx, _ = visibility.shape
    n, n_steps = sx * sy, weights.shape[0]
    f32 = torch.float32
    inputs = [("t", t, f32, (n,)),
              ("visibility", visibility, f32, (vz, vy, vx, 3)),
              ("weights", weights, f32, (n_steps,))]
    if hit is not None:
        inputs.append(("hit", hit, torch.bool, (n,)))
    launch.check(inputs, dev, card=True)
    out = torch.empty((sy, sx, 4), dtype=f32, device=dev)
    args = _ScatterArgs(
        t=t.data_ptr(), hit=None if hit is None else hit.data_ptr(),
        visibility=visibility.data_ptr(), weights=weights.data_ptr(),
        out=out.data_ptr(), sx=sx, sy=sy, vx=vx, vy=vy, vz=vz,
        n_steps=n_steps, max_depth=max_depth, step=step,
        vis_step=visibility_step)
    launch.run(launch.library("volumetrics").madarch_scatter_integral, args,
               dev)
    launch.record("scatter_integral")
    return out


def fog_composite(scattering, color, ray_len, ix, iy, *, max_dist, tau):
    """f32[H·W, 3]: the pixels' colours fogged.  scattering f32[sy, sx, 4];
    color f32[H·W, 3], ray_len f32[H·W], scanline order; ix i32[W], iy
    i32[H]: each pixel column's and row's nearest texel."""
    dev = color.device
    sy, sx, _ = scattering.shape
    w, h = ix.shape[0], iy.shape[0]
    f32, i32 = torch.float32, torch.int32
    launch.check([("scattering", scattering, f32, (sy, sx, 4)),
                  ("color", color, f32, (h * w, 3)),
                  ("ray_len", ray_len, f32, (h * w,)),
                  ("ix", ix, i32, (w,)), ("iy", iy, i32, (h,))], dev,
                 card=True)
    out = torch.empty((h * w, 3), dtype=f32, device=dev)
    args = _CompositeArgs(
        scattering=scattering.data_ptr(), color=color.data_ptr(),
        ray_len=ray_len.data_ptr(), ix=ix.data_ptr(), iy=iy.data_ptr(),
        out=out.data_ptr(), w=w, h=h, sx=sx, sy=sy, max_dist=max_dist,
        tau=tau)
    launch.run(launch.library("volumetrics").madarch_fog_composite, args,
               dev)
    launch.record("fog_composite")
    return out


def froxel_inscatter(result, ldist, vis, radiance, ldir, dirs, live=None,
                     *, tau):
    """Adds one light slot's in-scatter into ``result`` f32[N, 3] in place:
    (exp(−ldist·τ)·vis)·radiance·τ·HG(ldir, dirs), HG the Henyey-Greenstein
    phase with g = τ; 0 where ``live`` (bool[], on the card) is false, and
    every froxel for a static slot (live None).  ldist, vis f32[N];
    radiance, ldir, dirs f32[N, 3]."""
    dev = result.device
    n = result.shape[0]
    f32 = torch.float32
    inputs = [("result", result, f32, (n, 3)), ("ldist", ldist, f32, (n,)),
              ("vis", vis, f32, (n,)), ("radiance", radiance, f32, (n, 3)),
              ("ldir", ldir, f32, (n, 3)), ("dirs", dirs, f32, (n, 3))]
    if live is not None:
        inputs.append(("live", live, torch.bool, ()))
    launch.check(inputs, dev, card=True)
    # the phase's Python numbers as render/volumetrics.py has them, each
    # rounded to float when it meets a tensor
    g2 = tau * tau
    args = _InscatterArgs(
        ldist=ldist.data_ptr(), vis=vis.data_ptr(),
        radiance=radiance.data_ptr(), ldir=ldir.data_ptr(),
        dirs=dirs.data_ptr(), live=None if live is None else live.data_ptr(),
        result=result.data_ptr(), n=n, tau=tau, hg_num=1.0 - g2,
        hg_base=1.0 + g2, hg_2g=2.0 * tau, four_pi=4.0 * PI)
    launch.run(launch.library("volumetrics").madarch_froxel_inscatter, args,
               dev)
    launch.record("froxel_inscatter")
    return result
