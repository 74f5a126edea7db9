"""The system under test: the entries of madarch_tpu_torch that the
window drives.  The only module of the benchmark that imports the port.

- ``ViewProgram``: a ``Renderer`` of the configuration's scene;
  ``render()`` is the facade's, on the kernel route a replay of the
  compiled frame (render/pipeline.py:compiled_frame).
- ``FitProgram``: the train step of parallel/spmd.py:make_train_step (a
  CompiledStep replay) over the scene's data, one camera per view and the
  targets the benchmark hands it.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from benchmark.cells import build_scene


def _examples(module):
    """The port's ``examples.<module>``."""
    return importlib.import_module("madarch_tpu_torch.examples." + module)


def _renderer(config, root, device, width=None, height=None):
    from madarch_tpu_torch.core.config import ProbeSettings
    return build_scene(_examples, ProbeSettings, config, root, device, width,
                       height)


def counters():
    """The port's own counters: kernel launches by wrapper
    (ops/march.py:launch_counts) and the nvcc builds of this process
    (ops/build.py:load.builds, load.build_s)."""
    from madarch_tpu_torch.ops import build, march
    return {"launches": march.launch_counts(),
            "builds": getattr(build.load, "builds", None),
            "build_s": getattr(build.load, "build_s", None)}


def captured(obj):
    """A compiled frame's or step's own record: launches a replay,
    warm-up and capture seconds, graph pool bytes."""
    if obj is None:
        return None
    return {"launches": obj.launches, "warmup_s": obj.warmup_s,
            "capture_s": obj.capture_s, "pool_bytes": obj.pool_bytes}


class ViewProgram:
    """The viewer's side of a view cell."""

    def __init__(self, config, root, device):
        self.r = _renderer(config, root, device)
        self.scene_position = np.array(self.r.camera_position)

    def set_pose(self, position, orientation):
        self.r.set_camera_position(position)
        self.r.set_camera_orientation(orientation)

    def edit(self, edit):
        """A scene edit (light type name, index, fields) through the
        facade's mutation API."""
        from madarch_tpu_torch.scene import lights
        name, index, fields = edit
        self.r.set_light(getattr(lights, name), index, **fields)

    @property
    def state(self):
        """The probe feedback state the next frame reads (a FrameState;
        render() replaces it, never writes into it)."""
        return self.r.state

    def render(self):
        """One frame: the tonemapped image f32[H, W, 3] on the device."""
        return self.r.render()

    def record(self):
        return captured(self.r.frame)

    def close(self):
        """Drops the renderer and every compiled frame with its graph."""
        from madarch_tpu_torch.render import pipeline
        self.r = None
        pipeline.clear_compiled()


class FitProgram:
    """The fitting side of a fit cell: ``step(k)`` runs train step k on
    view ``traffic.view(k)`` and returns its loss (a device scalar)."""

    def __init__(self, config, root, device, traffic, targets):
        from madarch_tpu_torch.parallel.spmd import (make_train_step,
                                                     split_float_leaves)
        w, h = traffic.resolution
        r = _renderer(config, root, device, w, h)
        self.traffic = traffic
        self.train_step = make_train_step(
            r.spec, r.probes, r.volumetrics, w, h, lr=traffic.lr,
            screen_cfg=r.screen_cfg, probe_cfg=r.probe_cfg)
        self.cameras = []
        for position, orientation in traffic.views:
            r.set_camera_position(position)
            r.set_camera_orientation(orientation)
            self.cameras.append(r.camera)
        self.data = r.scene_data
        self.state = r.state
        self.targets = targets
        self._split = split_float_leaves

    def step(self, k):
        v = self.traffic.view(k)
        loss, self.data, self.state = self.train_step(
            self.data, self.cameras[v], self.state, self.targets[v])
        return loss

    def floats(self):
        """Copies of the scene data's float leaves (the fitted
        parameters), in the step's order."""
        with torch.no_grad():
            return [x.clone() for x in self._split(self.data)[0]]

    def float_leaves(self):
        """The scene data's float leaves themselves, in the step's order
        (each step returns fresh ones)."""
        return self._split(self.data)[0]

    def record(self):
        return captured(self.train_step.compiled_step)

    def close(self):
        self.train_step = self.data = self.state = None
