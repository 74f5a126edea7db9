"""Static configuration dataclasses (the port's own copy of what it needs
from madarch_tpu/core/config.py: same names, fields and defaults), and the
probe grid's corner offsets, which the probe lookups and the geometry
kernel's plain version share.

Frozen and hashable, as in the JAX package, so a settings object can key a
cache; the port reads them as plain Python values.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ProbeSettings:
    """DDGI probe configuration."""

    radiance_resolution: int = 32
    irradiance_resolution: int = 8
    probe_count: Tuple[int, int] = (6, 6)           # atlas tiles (x, y)
    grid_dimensions: Tuple[int, int, int] = (4, 3, 3)
    grid_spacing: Tuple[float, float, float] = (2.0, 3.0, 3.0)

    @property
    def num_probes(self) -> int:
        gx, gy, gz = self.grid_dimensions
        return gx * gy * gz

    @property
    def radiance_atlas_shape(self):
        px, py = self.probe_count
        r = self.radiance_resolution
        return (py * r, px * r, 3)

    @property
    def irradiance_atlas_shape(self):
        px, py = self.probe_count
        r = self.irradiance_resolution
        return (py * r, px * r, 3)


# The 8 probe-cell corners, bit k of the corner index selecting +1 on axis k.
CORNER_OFFSETS = tuple(((i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1)
                       for i in range(8))


@dataclasses.dataclass(frozen=True)
class VolumetricsSettings:
    """Light-shaft configuration: the froxel visibility grid (x, y, z
    slices) and the scattering map (x, y)."""

    enabled: bool = True
    visibility_resolution: Tuple[int, int, int] = (100, 100, 100)
    visibility_step_size: float = 0.1
    scattering_resolution: Tuple[int, int] = (250, 250)
    scattering_step_size: float = 0.1

    @property
    def max_depth(self) -> float:
        return self.visibility_step_size * self.visibility_resolution[2]


NO_VOLUMETRICS = VolumetricsSettings(enabled=False)


@dataclasses.dataclass(frozen=True)
class PartitioningSettings:
    """Uniform-grid space partitioning.  ``border_behavior``: 'clamp'
    clamps out-of-grid lookups to the border cell; 'fallback' evaluates the
    whole scene outside the grid."""

    index_count: int = 20                     # K candidates per cell
    border_behavior: str = "clamp"            # 'clamp' | 'fallback'
    grid_dimensions: Tuple[int, int, int] = (10, 10, 20)
    grid_spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    grid_offset: Tuple[float, float, float] = (-1.5, -1.5, -10.0)

    @property
    def num_cells(self) -> int:
        nx, ny, nz = self.grid_dimensions
        return nx * ny * nz

    @property
    def cell_diag(self) -> float:
        return float(np.linalg.norm(self.grid_spacing))


@dataclasses.dataclass(frozen=True)
class ShadeConfig:
    """Per-pass shading flags."""

    direct_specular: bool = True
    indirect_specular_mode: int = 2     # 0/1/2/3
    add_indirect_specular: bool = True
    ambient_occlusion_steps: int = 3
    render_volumetrics: bool = False
    max_march_steps: int = 300
    differentiable: bool = False


# The probe-radiance pass shades without specular, AO or volumetrics.
PROBE_SHADE_CONFIG = ShadeConfig(
    direct_specular=False,
    indirect_specular_mode=0,
    add_indirect_specular=False,
    ambient_occlusion_steps=0,
    render_volumetrics=False,
)


def screen_shade_config(volumetrics_enabled: bool,
                        max_march_steps: int = 300,
                        differentiable: bool = False) -> ShadeConfig:
    """The screen pass's flags: specular mode 2 with AO, volumetrics as
    the scene has them."""
    return ShadeConfig(
        direct_specular=True,
        indirect_specular_mode=2,
        add_indirect_specular=True,
        ambient_occlusion_steps=3,
        render_volumetrics=volumetrics_enabled,
        max_march_steps=max_march_steps,
        differentiable=differentiable,
    )
