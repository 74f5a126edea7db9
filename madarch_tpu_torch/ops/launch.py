"""The one seam between the port and its hand-written CUDA kernels
(ops/csrc/*.cu, built and loaded by ops/build.py).

A kernel wrapper (ops/march.py, ops/probe_lookup.py, ops/shade_kernel.py,
ops/volumetrics_kernel.py) loads its library with ``library``, holds its
inputs to what the kernel reads with ``check``, fills its argument struct,
launches it with ``run`` and counts the launch with ``record``; no wrapper
imports another.
``takes`` answers, for every route of render/ that may call a wrapper,
whether a kernel may take its tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from madarch_tpu_torch.ops import build

_LAUNCH = (ctypes.c_void_p, ctypes.c_void_p)
_OPTIN = (ctypes.c_int,)
# Each library's entry points and their arguments: a launch takes a pointer
# to its argument struct (the geometry launch then its refl flag) and the
# stream; madarch_smem_optin a device index.  Each returns an int: a
# launch 0 or a cudaError code, the query a byte count (negative on error).
ENTRY_POINTS = {
    "geometry": {"madarch_geometry": (ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p),
                 "madarch_smem_optin": _OPTIN},
    "march": {"madarch_raycast": _LAUNCH, "madarch_visibility": _LAUNCH,
              "madarch_softshadows": _LAUNCH, "madarch_smem_optin": _OPTIN},
    "probes": {"madarch_irradiance_lookup": _LAUNCH,
               "madarch_radiance_lookup": _LAUNCH},
    "shade": {"madarch_shade": _LAUNCH},
    "volumetrics": {"madarch_scatter_integral": _LAUNCH,
                    "madarch_fog_composite": _LAUNCH,
                    "madarch_froxel_inscatter": _LAUNCH},
}
# The wrappers whose launches are counted, by name.
KERNELS = ("geometry", "raycast", "visibility", "softshadows",
           "irradiance_lookup", "radiance_lookup", "shade", "scatter_integral",
           "fog_composite", "froxel_inscatter")


@functools.cache
def library(name, defines=()):
    """csrc/<name>.cu built with the macros ``defines`` (ops/build.py:load)
    and loaded, its entry points declared."""
    lib = build.load(name, defines)
    for symbol, argtypes in ENTRY_POINTS[name].items():
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def takes(x, *inputs):
    """Whether a kernel may take tensor ``x`` and ``inputs`` (None: an
    input absent): x lies on a card, and no gradient has to pass (grad is
    off, or none of them requires it)."""
    return x.is_cuda and not (torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, *inputs)))


def check(inputs, device, *, card=False):
    """Raises unless each of a launch's ``inputs``, (name, tensor, dtype,
    shape), is what its kernel reads: first every input's dtype
    (TypeError), shape, contiguity and, with ``card``, that it requires no
    grad (a ctypes launch would drop its gradient silently); then that
    every input lies on ``device``, with ``card`` a card (ValueError)."""
    for name, x, dtype, shape in inputs:
        if x.dtype != dtype:
            raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if card and x.requires_grad:
            raise ValueError(f"{name} requires grad: the kernel would drop "
                             f"its gradient")
    placed = device.type == "cuda" or not card
    for name, x, _, _ in inputs:
        if x.device != device or not placed:
            raise ValueError(f"{name} is on {x.device}, expected "
                             f"{device if placed else 'a card'}")


def run(fn, args, device, *flags):
    """Launches the entry point ``fn`` on ``device``'s current stream with
    a pointer to its argument struct ``args`` (then ``flags``); raises
    RuntimeError with the cudaError code of a launch that failed."""
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(args), *flags,
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")


# Kernel launches since the count was last reset, by wrapper (the CPU path
# does not count): lets a run show that its main path went through the
# kernels.  A frame captured into a CUDA graph (render/pipeline.py:
# Captured) launches nothing while it is captured and takes those calls
# back out of the count; each replay launches the captured kernels again
# and adds them (add_launches).
_launches = dict.fromkeys(KERNELS, 0)


def record(kernel):
    """Counts one launch of the wrapper named ``kernel``."""
    _launches[kernel] += 1


def launch_counts():
    """{wrapper name: its launch count}, every one of KERNELS."""
    return dict(_launches)


def add_launches(counts):
    """Adds {wrapper name: launches} to the wrappers' counts."""
    for name in KERNELS:
        _launches[name] += counts.get(name, 0)
