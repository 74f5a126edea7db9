"""Device constants and host-to-device copies that a captured frame can
live with.

A frame that runs as a CUDA graph (render/pipeline.py:CompiledFrame) may
neither copy from the host nor wait for the device while it is captured,
and the graph reads every tensor at the address it had then.  So the
tables a frame needs that its static arguments fix (pixel grids, texel
directions, index maps, literal vectors) are made here once per key and
device and kept for the process: their buffers never move and never come
from the host again.  ``to_device`` copies a host array through pinned
memory without making the host wait, for the data a frame takes (a scene
snapshot, the camera).
"""
from __future__ import annotations

import numpy as np
import torch

_cache = {}


def cached(key, device, build):
    """The tensor ``build()`` (a numpy array or a tensor) on ``device``,
    made and copied once per (key, device) and kept: callers read it and
    never write to it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    t = _cache.get((key, device))
    if t is None:
        t = _cache[(key, device)] = torch.as_tensor(build()).to(device)
    return t


def constant(value, device, dtype=np.float32):
    """A literal (a number or a nested tuple of numbers) as a ``dtype``
    tensor on ``device``, through ``cached``: the same bits as
    ``torch.tensor(value, dtype=...)``."""
    return cached(("constant", value, np.dtype(dtype).str), device,
                  lambda: np.asarray(value, dtype))


def to_device(array, device):
    """A host array as a tensor on ``device``: on a card through pinned
    memory and a copy the host does not wait for (PyTorch's pinned-memory
    allocator keeps the staging buffer until the copy has run)."""
    t = torch.as_tensor(np.array(array))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
