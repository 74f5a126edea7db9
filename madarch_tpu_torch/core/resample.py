"""Nearest-neighbour resampling with static index maps (port of
madarch_tpu/core/resample.py).

Every texture resample of the volumetric passes uses an index map that the
two resolutions fix: destination pixel -> source texel.  The JAX package
lowers a periodic map to strided slices because TPU gathers run on the
scalar unit; that is a TPU layout, so here ``take_static`` is one
``index_select`` with the same map.
"""
from __future__ import annotations

import numpy as np
import torch

from madarch_tpu_torch.core.constants import cached


def take_static(x, idx: np.ndarray, axis: int = 0):
    """``x`` gathered along ``axis`` at the host-known in-bounds indices
    ``idx`` (what ``jnp.take(x, idx, axis)`` returns).  The index map goes
    to the device once per map and device (core/constants.py)."""
    idx = np.asarray(idx, np.int64)
    index = cached(("take_static", idx.shape, idx.tobytes()), x.device,
                   lambda: idx)
    return torch.index_select(x, axis, index)


def floor_map(dst: int, src: int, offset: float = 0.5) -> np.ndarray:
    """floor((j + offset)·src/dst), clipped: the GL nearest-texel map."""
    j = np.arange(dst)
    return np.clip(np.floor((j + offset) * src / dst).astype(np.int64),
                   0, src - 1)


def resample_axis(x, axis: int, dst: int, *, offset: float = 0.5):
    """Nearest-neighbour resample of one axis to size ``dst``; ``x`` itself
    when that axis already has the size."""
    if x.shape[axis] == dst:
        return x
    return take_static(x, floor_map(dst, x.shape[axis], offset), axis)


def shift_clamped(x, axis: int, delta: int):
    """``x`` shifted along ``axis`` by ``delta`` with its edge repeated:
    out[i] = x[clip(i + delta, 0, n - 1)]."""
    if delta == 0:
        return x
    n = x.shape[axis]
    if delta > 0:
        body = x.narrow(axis, delta, n - delta)
        edge = x.narrow(axis, n - 1, 1)
        parts = [body, edge.repeat_interleave(delta, dim=axis)]
    else:
        body = x.narrow(axis, 0, n + delta)
        edge = x.narrow(axis, 0, 1)
        parts = [edge.repeat_interleave(-delta, dim=axis), body]
    return torch.cat(parts, dim=axis)
