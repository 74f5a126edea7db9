"""Nearest-neighbour resampling with static index maps (port of
madarch_tpu/core/resample.py's ``floor_map`` and ``take_static``).

Every texture resample of the volumetric passes uses an index map that the
two resolutions fix: destination pixel -> source texel.  The JAX package
lowers a periodic map to strided slices because TPU gathers run on the
scalar unit; that is a TPU layout, so here ``take_static`` is one
``index_select`` with the same map.
"""
from __future__ import annotations

import numpy as np
import torch


def take_static(x, idx: np.ndarray, axis: int = 0):
    """``x`` gathered along ``axis`` at the host-known in-bounds indices
    ``idx`` (what ``jnp.take(x, idx, axis)`` returns)."""
    index = torch.as_tensor(np.asarray(idx, np.int64)).to(x.device)
    return torch.index_select(x, axis, index)


def floor_map(dst: int, src: int, offset: float = 0.5) -> np.ndarray:
    """floor((j + offset)·src/dst), clipped: the GL nearest-texel map."""
    j = np.arange(dst)
    return np.clip(np.floor((j + offset) * src / dst).astype(np.int64),
                   0, src - 1)
