"""The engine facade: the scene mutation API and the camera (a frozen
copy of the port's render/renderer.py without its frame loop and physics
query: the package's view.py and train.py call the pipeline's passes).
Volumetrics are on by default, as in the JAX package; the renderer runs on
the CUDA card unless the caller names another device.

Mutations edit a host-side numpy mirror; ``scene_data`` copies the
snapshot to ``device`` once and reuses it until the next mutation.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.config import (PROBE_SHADE_CONFIG, ProbeSettings, ShadeConfig,
                           VolumetricsSettings, screen_shade_config)
from ..core.constants import to_device
from ..render.pipeline import Camera, initial_state
from ..scene.scene import SceneBuilder, SceneSpec


class Renderer:
    """Owns the scene mirror, camera and probe feedback state on one
    device: ``cuda`` (the card) unless the caller asks for another, with
    no auto-detection and no CPU fallback."""

    def __init__(self, spec: SceneSpec, width: int = 1000,
                 height: int = 1000,
                 probes: ProbeSettings = ProbeSettings(),
                 volumetrics: VolumetricsSettings = VolumetricsSettings(),
                 screen_cfg: Optional[ShadeConfig] = None,
                 probe_cfg: ShadeConfig = PROBE_SHADE_CONFIG,
                 specialize_counts: bool = True, *, device="cuda"):
        """``specialize_counts`` bakes the live primitive and light counts
        into the spec, and so into the compiled frame's key: only the live
        slots are packed, and a count change compiles the frame anew on
        the next render().  False keeps one compiled frame for any count,
        every slot packed and the dead ones masked by the live counts (for
        scenes whose counts change as they run)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Renderer asked for a CUDA device and none is available; "
                "pass device='cpu' to render on the CPU")
        self.base_spec = spec
        self.specialize_counts = specialize_counts
        self.width = width
        self.height = height
        self.probes = probes
        self.volumetrics = volumetrics
        self.screen_cfg = screen_cfg or screen_shade_config(
            volumetrics.enabled)
        self.probe_cfg = probe_cfg
        self.builder = SceneBuilder(spec)
        self.state = initial_state(probes, volumetrics, self.device)
        self.camera_position = np.zeros(3, np.float32)
        self.camera_orientation = np.eye(3, dtype=np.float32)
        self._camera = (None, None)  # (host bytes, device Camera)
        self._data = None  # device snapshot; invalidated on mutation
        self.frame = None  # the CompiledFrame of the last render()

    # -- scene mutation (invalidates the device snapshot) --
    def add_primitive(self, ptype, **fields):
        self._data = None
        return self.builder.add_primitive(ptype, **fields)

    def add_light(self, ltype, **fields):
        self._data = None
        return self.builder.add_light(ltype, **fields)

    def set_light(self, ltype, index, **fields):
        self._data = None
        self.builder.set_light(ltype, index, **fields)

    def add_material(self, albedo, metallic, roughness):
        self._data = None
        return self.builder.add_material(albedo, metallic, roughness)

    def set_material(self, index, albedo, metallic, roughness):
        self._data = None
        self.builder.set_material(index, albedo, metallic, roughness)

    # -- camera --
    def set_camera_position(self, position):
        self.camera_position = np.asarray(position, np.float32)

    def set_camera_orientation(self, orientation):
        self.camera_orientation = np.asarray(orientation, np.float32)

    @property
    def spec(self) -> SceneSpec:
        """The spec the pipeline runs against: the live counts baked in
        when ``specialize_counts`` (a count change is a new key of the
        compiled frame)."""
        if not self.specialize_counts:
            return self.base_spec
        return self.base_spec.specialized(self.builder._prim_counts,
                                          self.builder._light_counts)

    @property
    def scene_data(self):
        if self._data is None:
            self._data = self.builder.device_data(self.device)
        return self._data

    @property
    def camera(self) -> Camera:
        """The camera on the device, copied there once per move (of
        ``camera_position`` / ``camera_orientation``, however set)."""
        key = (np.asarray(self.camera_position, np.float32).tobytes(),
               np.asarray(self.camera_orientation, np.float32).tobytes())
        if self._camera[0] != key:
            self._camera = (key, Camera(
                position=to_device(self.camera_position, self.device),
                orientation=to_device(self.camera_orientation,
                                      self.device)))
        return self._camera[1]
