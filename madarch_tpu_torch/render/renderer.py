"""The engine facade: scene mutation API, frame loop and the physics query
eval_distance_to (port of madarch_tpu/render/renderer.py).  Volumetrics
are on by default, as in the JAX package; the renderer runs on the CUDA
card unless the caller names another device.

Mutations edit a host-side numpy mirror; the next ``render()`` copies the
snapshot to ``device`` once and reuses it until the next mutation.  On the
kernel route the frame is compiled per static (spec, settings,
resolution), as the JAX package jits it (render/pipeline.py:
compiled_frame: on a card a CUDA graph captured once and replayed), and a
mutation that keeps that key only copies the new snapshot into the
graph's buffers.

With the recorder of utils/profiling.py on, ``render()`` is the root span
``render`` (one frame id), around ``render.spec``, ``render.data`` (a
rebuild of the device snapshot: counters ``data_builds``, ``data_bytes``)
and ``render.camera`` (a pose upload: ``camera_uploads``), then the
compiled frame's spans (render/pipeline.py).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from madarch_tpu_torch.core.config import (PROBE_SHADE_CONFIG,
                                           ProbeSettings, ShadeConfig,
                                           VolumetricsSettings,
                                           screen_shade_config)
from madarch_tpu_torch.core.constants import to_device
from madarch_tpu_torch.ops.march import kernel_scene
from madarch_tpu_torch.render.camera import orientation_from_angles
from madarch_tpu_torch.render.pipeline import (Camera, compiled_frame,
                                               eager_active, initial_state,
                                               render_frame)
from madarch_tpu_torch.render.raymarch import scene_normal
from madarch_tpu_torch.scene.primitives import PrimitiveType
from madarch_tpu_torch.scene.scene import (SceneBuilder, SceneSpec,
                                           scene_sdf, tree_leaves)
from madarch_tpu_torch.utils import profiling


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
        self._grid = None  # partitioning grid of update_partitioning
        self._eval_specs = {}  # eval_distance_to's spec per type subset

    # -- scene mutation (invalidates the device snapshot) --
    def add_primitive(self, ptype, **fields):
        self._data = None
        return self.builder.add_primitive(ptype, **fields)

    def set_primitive(self, ptype, index, **fields):
        self._data = None
        self.builder.set_primitive(ptype, index, **fields)

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

    def set_camera_angles(self, rot_x: float, rot_y: float):
        self.camera_orientation = np.asarray(
            orientation_from_angles(rot_x, rot_y))

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
    def compiled(self) -> bool:
        """Whether render() runs the compiled frame: on the kernel route,
        decided by the spec's types alone (ops/march.py:kernel_scene),
        outside pipeline.eager().  The generic route, whose plain marches
        wait on the device at every step, renders eagerly."""
        return kernel_scene(self.spec) and not eager_active()

    @property
    def scene_data(self):
        if self._data is None:
            with profiling.span("render.data"):
                self._data = self.builder.device_data(self.device,
                                                      grid=self._grid)
            if profiling.enabled():
                profiling.count("data_builds")
                profiling.count("data_bytes", sum(
                    x.nbytes for x in tree_leaves(self._data)))
        return self._data

    def update_partitioning(self, method: str = "gpu_fast"):
        """Rebuild the uniform grid's candidate lists on the renderer's
        device (methods gpu_fast, cpu_fast, cpu_best); a no-op when the
        spec has no partitioning settings."""
        if self.spec.partitioning is None:
            return
        from madarch_tpu_torch.scene.partitioning import build_grid
        base = self.builder.device_data(self.device)
        self._grid = build_grid(self.spec, self.spec.partitioning, base,
                                method=method)
        self._data = None

    @property
    def camera(self) -> Camera:
        """The camera on the device, copied there once per move (of
        ``camera_position`` / ``camera_orientation``, however set)."""
        key = (np.asarray(self.camera_position, np.float32).tobytes(),
               np.asarray(self.camera_orientation, np.float32).tobytes())
        if self._camera[0] != key:
            with profiling.span("render.camera"):
                self._camera = (key, Camera(
                    position=to_device(self.camera_position, self.device),
                    orientation=to_device(self.camera_orientation,
                                          self.device)))
            profiling.count("camera_uploads")
        return self._camera[1]

    # -- frame loop --
    def render(self):
        """Render one frame; advances the probe feedback state.  Returns
        the tonemapped image f32[H, W, 3] (row 0 = bottom) on the
        renderer's device.  No gradient: a differentiable frame goes
        through parallel/spmd.py:make_train_step, as in the JAX
        package."""
        with profiling.span("render"):
            with profiling.span("render.spec"):
                spec = self.spec
            args = (spec, self.probes, self.volumetrics, self.width,
                    self.height, self.scene_data, self.camera, self.state)
            kwargs = dict(screen_cfg=self.screen_cfg,
                          probe_cfg=self.probe_cfg)
            with torch.no_grad():
                if self.compiled:
                    self.frame = compiled_frame(*args, **kwargs)
                    image, self.state = self.frame(*args[5:])
                else:
                    image, self.state = render_frame(*args, **kwargs)
        return image

    def converge(self, frames: int = 4):
        """Run several frames so multi-bounce GI reaches steady state."""
        img = None
        for _ in range(frames):
            img = self.render()
        return img

    # -- physics query --
    def eval_distance_to(self, position,
                         prims: Optional[Sequence[PrimitiveType]] = None):
        """(distance float, normal numpy f32[3]) of the closest primitive
        among the types ``prims`` (all types if None) to a world position:
        the scene distance over those types and its autograd normal, on
        the renderer's device.  The spec of each type subset is kept; it
        masks dead slots by the live counts, so it stays right as
        primitives are added."""
        names = (tuple(p.name for p in prims) if prims is not None
                 else tuple(pt.name for pt, _ in self.base_spec.prims))
        sub_spec = self._eval_specs.get(names)
        if sub_spec is None:
            base = self.base_spec
            sub_spec = self._eval_specs[names] = SceneSpec(
                prims=tuple((pt, c) for pt, c in base.prims
                            if pt.name in names),
                lights=base.lights, max_dist=base.max_dist,
                max_materials=base.max_materials)
        data = self.scene_data
        pos = torch.as_tensor(np.asarray(position, np.float32)[None]).to(
            self.device)

        def sdf_b(p):
            return scene_sdf(sub_spec, data, p)

        with torch.no_grad():
            dist = sdf_b(pos)
            normal = scene_normal(sdf_b, pos)
        return float(dist[0]), normal[0].cpu().numpy()
