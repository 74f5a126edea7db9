"""Pinhole camera model (port of madarch_tpu/render/camera.py).

Image plane is z=0 spanning [-1,1]², eye at (0,0,-1.5) in camera space:
dir = R · normalize(frag − eye), origin = R · frag + camera_position.
Row 0 of the ray grid is the *bottom* image row (GL convention).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.constants import cached, constant
from ..core.vecmath import length

EYE = (0.0, 0.0, -1.5)


def pixel_grid(width: int, height: int, device):
    """Fragment positions at pixel centers: f32[H, W, 2] in [-1, 1]², a
    device constant (core/constants.py): read it, never write to it."""
    def build():
        xs = (np.arange(width, dtype=np.float32) + 0.5) / width * 2.0 - 1.0
        ys = (np.arange(height, dtype=np.float32) + 0.5) / height * 2.0 \
            - 1.0
        gx, gy = np.meshgrid(xs, ys)
        return np.stack([gx, gy], axis=-1)
    return cached(("pixel_grid", width, height), device, build)


def camera_rays(frag_xy, position, orientation):
    """frag_xy: f32[..., 2] image-plane coords -> (origins, dirs) f32[..., 3].

    position: f32[3]; orientation: f32[3,3] applied as R @ v.
    """
    frag = torch.cat([frag_xy, torch.zeros_like(frag_xy[..., :1])], dim=-1)
    to_frag = frag - constant(EYE, frag.device)
    local_dir = to_frag / length(to_frag)[..., None]
    dirs = local_dir @ orientation.T
    origins = frag @ orientation.T + position
    return origins, dirs
