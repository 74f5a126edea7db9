"""The frame pipeline: radiance → irradiance → [visibility → scattering] →
screen, with probe-atlas feedback across frames (port of
madarch_tpu/render/pipeline.py).

The radiance pass reads the *previous* frame's irradiance atlas (the GI
feedback that accumulates light bounces over frames), the irradiance pass
integrates the new radiance, the volumetric passes (when the scene has
them) build this frame's scattering map, and the screen pass consumes
everything.

``render_frame`` runs a frame eagerly, op by op.  ``compiled_frame`` is
the port's counterpart of the JAX package's ``jax.jit(render_frame_impl)``
with its static arguments: a ``CompiledFrame`` per static key, which on a
card captures the frame into a CUDA graph once and replays it, and
``eager()`` is the counterpart of ``jax.disable_jit()``.

With the recorder of utils/profiling.py on, each pass is a device interval
(``pass.radiance``, ``pass.irradiance``, ``pass.visibility``,
``pass.scattering``, ``pass.screen``; each SceneCtx's packing ``pack``
inside them, render/context.py), and the compiled frame records the host
spans ``frame.lookup`` (counters ``frame_captures``, ``frame_evictions``),
``frame.copy_in`` (``copy_in_leaves``, ``copy_in_bytes``),
``frame.warmup`` and ``frame.capture`` (set-up), ``frame.replay`` and
``frame.out``, and the device interval ``frame.writeback``.  A frame
captured while the recorder is on keeps the passes' event pairs as nodes
of its graph and reports them at each replay; one captured while it is
off has none and reports no passes.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import time

import numpy as np
import torch

from madarch_tpu_torch.core.config import (PROBE_SHADE_CONFIG,
                                           ProbeSettings, ShadeConfig,
                                           VolumetricsSettings,
                                           screen_shade_config)
from madarch_tpu_torch.ops import march as march_ops
from madarch_tpu_torch.render import probes as probes_mod
from madarch_tpu_torch.render import volumetrics as vol_mod
from madarch_tpu_torch.render.camera import camera_rays, pixel_grid
from madarch_tpu_torch.render.context import SceneCtx
from madarch_tpu_torch.render.shading import pixel_color
from madarch_tpu_torch.scene.scene import (SceneData, SceneSpec, tree_items,
                                           tree_leaves, tree_map)
from madarch_tpu_torch.utils import profiling


@dataclasses.dataclass
class FrameState:
    """Per-frame feedback textures."""

    radiance: torch.Tensor     # f32[py·rr, px·rr, 3]
    irradiance: torch.Tensor   # f32[py·ir, px·ir, 3]
    scattering: torch.Tensor   # f32[sy, sx, 4]

    @classmethod
    def from_numpy(cls, tree, device) -> "FrameState":
        """FrameState from any object with these fields holding numpy
        arrays, e.g. ``jax.tree.map(np.asarray, jax_renderer.state)``."""
        return cls(**{f.name: torch.as_tensor(
            np.array(getattr(tree, f.name))).to(device)
            for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class Camera:
    position: torch.Tensor     # f32[3]
    orientation: torch.Tensor  # f32[3,3]


def initial_state(probes: ProbeSettings, vol: VolumetricsSettings,
                  device) -> FrameState:
    sy, sx = (vol.scattering_resolution[1], vol.scattering_resolution[0]) \
        if vol.enabled else (1, 1)
    return FrameState(
        radiance=torch.zeros(probes.radiance_atlas_shape, device=device),
        irradiance=torch.zeros(probes.irradiance_atlas_shape,
                               device=device),
        scattering=torch.zeros((sy, sx, 4), device=device))


def radiance_pass(spec: SceneSpec, data: SceneData, probes: ProbeSettings,
                  cfg: ShadeConfig, irr_atlas, rad_atlas, shard=None):
    """Trace every probe's octahedral ray set and shade it: one batch of
    num_probes·radiance_resolution² rays in direction-major order (rays
    of one texel direction across probes sit together; a permutation,
    inverted below).  ``shard``: a parallel.spmd.RaySharder splitting the
    batch over its ranks, or None."""
    dev = irr_atlas.device
    rr = probes.radiance_resolution
    p_world = probes_mod.probe_world_positions(probes, dev)   # [P,3]
    dirs = probes_mod.texel_directions(rr, dev)              # [rr²,3]
    n_probes = probes.num_probes

    origins = p_world.repeat(rr * rr, 1)                     # [rr²·P,3]
    ray_dirs = dirs.repeat_interleave(n_probes, dim=0)

    def shade(o, d):
        return pixel_color(spec, data, probes, cfg, irr_atlas, rad_atlas, o,
                           d)[0]
    color = shade(origins, ray_dirs) if shard is None \
        else shard.map_rays(shade, (origins, ray_dirs))
    tiles = color.reshape(rr * rr, n_probes, 3).transpose(0, 1)
    px, py = probes.probe_count
    if px * py != n_probes:
        pad = torch.zeros((px * py - n_probes, rr * rr, 3), device=dev)
        tiles = torch.cat([tiles, pad], dim=0)
    return probes_mod.tiles_to_atlas(probes, tiles, rr)


BLOCK_H = 32
BLOCK_W = 32


def _to_blocks(arr, height, width):
    """Scanline-flat [H·W, ...] -> 32×32-block-major flat order, so
    neighbouring rays of the batch cover one compact screen square."""
    tail = arr.shape[1:]
    a = arr.reshape(height // BLOCK_H, BLOCK_H, width // BLOCK_W, BLOCK_W,
                    *tail)
    return a.permute(0, 2, 1, 3, *range(4, a.ndim)).reshape(
        height * width, *tail)


def _from_blocks(arr, height, width):
    tail = arr.shape[1:]
    a = arr.reshape(height // BLOCK_H, width // BLOCK_W, BLOCK_H, BLOCK_W,
                    *tail)
    return a.permute(0, 2, 1, 3, *range(4, a.ndim)).reshape(
        height * width, *tail)


def screen_pass(spec: SceneSpec, data: SceneData, probes: ProbeSettings,
                vol: VolumetricsSettings, cfg: ShadeConfig, width: int,
                height: int, camera: Camera, irr_atlas, rad_atlas,
                scattering, shard=None):
    """Primary rays -> shade -> volumetric composite (when
    cfg.render_volumetrics) -> Reinhard tonemap + gamma.  Returns
    f32[H, W, 3], row 0 = bottom.  ``shard``: as radiance_pass's."""
    frag = pixel_grid(width, height, irr_atlas.device)
    origins, dirs = camera_rays(frag, camera.position, camera.orientation)
    origins_f = origins.reshape(-1, 3)
    dirs_f = dirs.reshape(-1, 3)
    blocked = height % BLOCK_H == 0 and width % BLOCK_W == 0
    if blocked:
        origins_f = _to_blocks(origins_f, height, width).contiguous()
        dirs_f = _to_blocks(dirs_f, height, width).contiguous()

    def shade(o, d):
        c, _, hp = pixel_color(spec, data, probes, cfg, irr_atlas, rad_atlas,
                               o, d)
        return c, hp
    color, hit_pos = shade(origins_f, dirs_f) if shard is None \
        else shard.map_rays(shade, (origins_f, dirs_f))
    if blocked:
        color = _from_blocks(color, height, width)
    if cfg.render_volumetrics:
        if blocked:
            hit_pos = _from_blocks(hit_pos, height, width)
        ray_len = torch.linalg.vector_norm(hit_pos - origins.reshape(-1, 3),
                                           dim=-1)
        color = vol_mod.composite(vol, scattering, color, ray_len, width,
                                  height, spec.max_dist)

    color = torch.clamp_min(color, 0.0)
    # Reinhard + gamma; the 1e-8 matches the reference's finite-derivative
    # guard at pure black
    color = ((color + 1e-8) / (color + 1.0)) ** 0.4545
    return color.reshape(height, width, 3)


def render_frame(spec: SceneSpec, probes: ProbeSettings,
                 vol: VolumetricsSettings, width: int, height: int,
                 data: SceneData, camera: Camera, state: FrameState,
                 screen_cfg: ShadeConfig = None,
                 probe_cfg: ShadeConfig = PROBE_SHADE_CONFIG, shard=None):
    """One full frame; returns (image f32[H,W,3], new FrameState).  The
    image carries the frame's gradients (differentiable configs); the new
    state is detached, the feedback that the next frame reads as data (the
    JAX package returns it outside the gradient).  ``shard``: a
    parallel.spmd.RaySharder that splits every pass's rays over its
    ranks (each rank gets the whole image and state), or None."""
    if screen_cfg is None:
        screen_cfg = screen_shade_config(vol.enabled)
    dev = state.irradiance.device
    with profiling.device_span("pass.radiance", dev):
        radiance = radiance_pass(spec, data, probes, probe_cfg,
                                 state.irradiance, state.radiance, shard)
    with profiling.device_span("pass.irradiance", dev):
        irradiance = probes_mod.integrate_irradiance(probes, radiance)

    scattering = state.scattering
    if vol.enabled:
        with profiling.device_span("pass.visibility", dev):
            ctx = SceneCtx(spec, data)
            visibility = vol_mod.visibility_pass(
                spec, data, vol, ctx, camera.position, camera.orientation,
                max_steps=screen_cfg.max_march_steps, shard=shard)
        with profiling.device_span("pass.scattering", dev):
            scattering = vol_mod.scattering_pass(
                spec, data, vol, ctx, visibility, camera.position,
                camera.orientation, max_steps=screen_cfg.max_march_steps,
                shard=shard)

    with profiling.device_span("pass.screen", dev):
        image = screen_pass(spec, data, probes, vol, screen_cfg, width,
                            height, camera, irradiance, radiance,
                            scattering, shard)
    return image, FrameState(radiance=radiance.detach(),
                             irradiance=irradiance.detach(),
                             scattering=scattering.detach())


# ---------------------------------------------------------------------------
# The compiled frame
# ---------------------------------------------------------------------------

# Compiled frames kept by compiled_frame, for every renderer together (as
# the JAX package's jit cache is one for the process): past this many the
# least recently used is dropped, and with it its graph and the graph's
# memory pool.
GRAPH_CACHE_SIZE = 4

_frames = collections.OrderedDict()
_eager = [False]


@contextlib.contextmanager
def eager():
    """Inside the block no frame is compiled: ``Renderer.render()`` runs
    ``render_frame`` op by op, as under ``jax.disable_jit()``."""
    before = _eager[0]
    _eager[0] = True
    try:
        yield
    finally:
        _eager[0] = before


def eager_active() -> bool:
    """Whether an ``eager()`` block is open."""
    return _eager[0]


def tree_shapes(tree):
    return tuple((path, tuple(x.shape), x.dtype)
                 for path, x in tree_items(tree))


class Captured:
    """What the compiled frame and the compiled train step share: a
    function of tensor trees run on input buffers of its own, on a card
    captured once into a CUDA graph and replayed (the JAX package's jit).

    Each input (a tree of tensors) gets one buffer a leaf, an attribute of
    the input's name.  ``copy_in`` copies each argument into its buffers
    at every call, whatever object it is: an argument is a snapshot of
    its values at the call, and a tensor the caller changed in place
    (a returned one too) reaches the next call.  ``run`` runs the
    body on the buffers and returns its outputs: ``_body()`` writes what
    chains from call to call back into the buffers, ``_warmup()`` is the
    same work writing nothing back.

    On a card the first ``run`` runs ``_warmup()`` op by op on a side
    stream (so that every kernel is built and loaded, the shared-memory
    opt-in set, cuBLAS and autograd set up outside the capture), then
    captures ``_body()`` into a CUDA graph; every run replays the graph
    and returns the outputs the capture left in its pool.  A capture or
    replay that fails raises: nothing falls back to the eager body.  On
    the CPU ``run`` calls ``_body()`` with no graph: the same buffers and
    copies, so a stale buffer shows there too.

    After the capture: ``launches`` (the kernel launches of one body, by
    wrapper), ``warmup_s`` and ``capture_s`` (host seconds of the warm-up
    and of the capture) and ``pool_bytes`` (the device memory the graph's
    private pool holds).  ``captures`` counts, per subclass, the bodies
    captured (on the CPU: set up) in this process.

    With the recorder of utils/profiling.py on: spans ``frame.copy_in``
    (counters ``copy_in_leaves``, ``copy_in_bytes``: every buffer
    copied), ``frame.warmup``, ``frame.capture`` and ``frame.replay`` (on
    the CPU the body's run in the replay's place); the device intervals
    the body records, if the capture ran with the recorder on
    (``_events``, the graph's event pairs)."""

    captures = 0

    def __init__(self, device, **inputs):
        self.device = device
        with torch.no_grad():
            for name, tree in inputs.items():
                setattr(self, name, tree_map(torch.clone, tree))
        self.graph = None
        self._out = None
        self._events = []
        self.launches = None
        self.warmup_s = self.capture_s = self.pool_bytes = None
        if device.type != "cuda":
            type(self).captures += 1

    def copy_in(self, **args):
        """Each argument (input name = tree) into its buffers."""
        with torch.no_grad(), profiling.span("frame.copy_in"):
            for name, src in args.items():
                for buf, x in zip(tree_leaves(getattr(self, name)),
                                  tree_leaves(src)):
                    buf.copy_(x)
        if profiling.enabled():
            bufs = [b for name in args for b in tree_leaves(getattr(self,
                                                                    name))]
            profiling.count("copy_in_leaves", len(bufs))
            profiling.count("copy_in_bytes", sum(b.nbytes for b in bufs))

    def run(self):
        """The body's outputs on the buffers: replayed on a card."""
        if self.device.type != "cuda":
            with profiling.span("frame.replay"):
                return self._body()
        if self.graph is None:
            self._capture()
        profiling.before_replay(self._events)
        with profiling.span("frame.replay"):
            self.graph.replay()
        profiling.after_replay(self._events)
        march_ops.add_launches(self.launches)
        return self._out

    def _capture(self):
        dev = self.device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with profiling.span("frame.warmup"):
            with torch.cuda.stream(side):
                self._warmup()
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
        self.warmup_s = time.perf_counter() - t0
        before = march_ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # A graph the cyclic garbage collector destroys while this one is
        # captured invalidates the capture: collect first, then hold it off
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        try:
            with profiling.span("frame.capture"), \
                    profiling.graph_events() as events, \
                    torch.cuda.graph(graph):
                reserved = torch.cuda.memory_reserved(dev)
                self._out = self._body()
        finally:
            if collecting:
                gc.enable()
            # the capture launched nothing
            after = march_ops.launch_counts()
            march_ops.add_launches({k: before[k] - after[k]
                                    for k in after})
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = {k: after[k] - before[k] for k in after}
        self._events = events
        self.graph = graph
        type(self).captures += 1


class CompiledFrame(Captured):
    """``render_frame`` for one static key: the JAX package's static
    arguments (spec, probes, vol, width, height, screen_cfg, probe_cfg)
    and the shapes of the scene data, camera and state, on one device.

    A ``Captured`` with inputs data, camera and state.  The frame writes
    the new feedback state back into the state buffers, so the state
    chains from call to call, and the call returns the image and the
    state as fresh tensors, which the next call leaves alone.  The frame
    packs the scene itself, as the JAX package packs it inside its jit, so
    a mutation needs nothing but the copy."""

    captures = 0   # frames captured (on the CPU: set up) in this process

    def __init__(self, spec, probes, vol, width, height, data, camera,
                 state, screen_cfg=None, probe_cfg=PROBE_SHADE_CONFIG):
        self.spec, self.probes, self.vol = spec, probes, vol
        self.width, self.height = width, height
        self.screen_cfg, self.probe_cfg = screen_cfg, probe_cfg
        super().__init__(state.radiance.device, data=data, camera=camera,
                         state=state)

    def __call__(self, data: SceneData, camera: Camera, state: FrameState):
        """(image f32[H,W,3], new FrameState), as render_frame returns
        them."""
        with torch.no_grad():
            self.copy_in(data=data, camera=camera, state=state)
            out = self.run()
            with profiling.span("frame.out"):
                image = out.clone()
                new = tree_map(torch.clone, self.state)
        return image, new

    def _warmup(self):
        """One frame on the buffers (the state buffers keep this call's
        input)."""
        return render_frame(self.spec, self.probes, self.vol, self.width,
                            self.height, self.data, self.camera, self.state,
                            screen_cfg=self.screen_cfg,
                            probe_cfg=self.probe_cfg)

    def _body(self):
        """One frame on the buffers, its state written back into them."""
        image, new = self._warmup()
        with profiling.device_span("frame.writeback", self.device):
            for buf, x in zip(tree_leaves(self.state), tree_leaves(new)):
                buf.copy_(x)
        return image


def compiled_frame(spec: SceneSpec, probes: ProbeSettings,
                   vol: VolumetricsSettings, width: int, height: int,
                   data: SceneData, camera: Camera, state: FrameState,
                   screen_cfg: ShadeConfig = None,
                   probe_cfg: ShadeConfig = PROBE_SHADE_CONFIG
                   ) -> CompiledFrame:
    """The CompiledFrame of this static key, made on first use and kept
    among the GRAPH_CACHE_SIZE most recently used; call it with (data,
    camera, state).  For a scene on the kernel route (ops/march.py:
    kernel_scene); the generic route's plain marches wait on the device
    at every step and run eagerly."""
    with profiling.span("frame.lookup"):
        key = (spec, probes, vol, width, height, screen_cfg, probe_cfg,
               tree_shapes(data), tree_shapes(camera), tree_shapes(state),
               state.radiance.device)
        frame = _frames.pop(key, None)
        if frame is None:
            frame = CompiledFrame(spec, probes, vol, width, height, data,
                                  camera, state, screen_cfg, probe_cfg)
            profiling.count("frame_captures")
            while len(_frames) >= GRAPH_CACHE_SIZE:
                _frames.popitem(last=False)
                profiling.count("frame_evictions")
        _frames[key] = frame
    return frame


def cache_size() -> int:
    """The compiled frames kept (JAX: ``render_frame._cache_size()``)."""
    return len(_frames)


def clear_compiled():
    """Drops every compiled frame, and with it its graph and memory."""
    _frames.clear()
