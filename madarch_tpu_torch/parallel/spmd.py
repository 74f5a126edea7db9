"""The differentiable-rendering train step and ray sharding over processes
(port of madarch_tpu/parallel/spmd.py).

The JAX package shards rays over a device mesh inside one process; the
port runs one process per device under ``torch.distributed``.  A
``RaySharder`` pads each flat ray batch of a pass (radiance texels,
screen pixels, froxel and scattering rays) to a multiple of the world
size, each rank marches its contiguous share, and the outputs are
all-gathered, differentiably; scene data and probe atlases are
replicated.  A march runs inside one rank's share and holds no
collective.  The sharder records every collective it issues
(``collective_report``).

The train step's loss is the mean squared error between the rendered
frame and a target image, its gradient is taken with respect to every
float leaf of the scene data (primitive fields, materials, lights), and
the update is plain SGD.  Sharded, every rank forms the same full-image
loss from the gathered image; the backward of each all-gather already
sums the ranks' gradients of its shares, so each rank differentiates
loss / world size and the parameter gradients are all-reduced with SUM:
the one-process gradient, not world size times it.  The marches run in
the kernels as in any frame; gradients re-enter through the
implicit-function-theorem hit distance and the autodiff normals
(render/shading.py).

Without a mesh, on the kernel route, ``make_train_step`` compiles the
step as the JAX package jits it with its data and state donated: a
``CompiledStep`` per static key, on a card forward, backward and update
captured into one CUDA graph that updates its data and state buffers in
place, then replayed.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

from madarch_tpu_torch.core.config import (PROBE_SHADE_CONFIG,
                                           ProbeSettings, ShadeConfig,
                                           VolumetricsSettings,
                                           screen_shade_config)
from madarch_tpu_torch.ops.march import kernel_scene
from madarch_tpu_torch.render.pipeline import (GRAPH_CACHE_SIZE, Captured,
                                               eager_active, render_frame,
                                               tree_shapes)
from madarch_tpu_torch.scene.scene import SceneSpec, tree_leaves, tree_map

ENV_VARS = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def init_distributed(init_method=None, world_size=None, rank=None,
                     backend=None):
    """Join a torch.distributed process group; True when one exists
    after the call.  With ``init_method`` (``tcp://host:port``) it joins
    that group as ``rank`` of ``world_size``; without, it joins by the
    environment (MASTER_ADDR, RANK, WORLD_SIZE) and returns False where
    that is absent.  A no-op when a group already exists.  ``backend``:
    nccl where CUDA is available, else gloo, unless named."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if not all(os.environ.get(k) for k in ENV_VARS):
            return False
        init_method = "env://"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {k: v for k, v in (("world_size", world_size), ("rank", rank))
              if v is not None}
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The processes rays are shared over, one device each: the world's
    size, this process's rank, its device and the process group (None:
    the default group)."""

    world_size: int
    rank: int
    device: torch.device
    group: object = None


def make_mesh(device=None, group=None) -> Mesh:
    """This process's mesh: the group's size and rank (a world of 1 where
    no group exists) and ``device``, by default the CUDA card of the
    process's LOCAL_RANK (else its rank) among the host's cards."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        world, rank = 1, 0
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % max(torch.cuda.device_count(),
                                                  1))
    return Mesh(world, rank, torch.device(device), group)


class RaySharder:
    """Sharding of flat ray batches over a mesh.  ``pad`` zero-pads the
    leading (ray) dimension to a multiple of the world size, ``share``
    takes this rank's contiguous part of it, ``gather`` concatenates every
    rank's part in rank order and ``unpad`` slices back to the true
    count; ``map_rays`` runs a pass's function through all four.
    ``record`` lists each collective issued: {"op", "bytes" (of the
    gathered or reduced tensor), "in_loop" (issued while a map_rays
    function ran, where the marches run)}."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.record = []
        self._in_fn = 0

    @property
    def n(self) -> int:
        return self.mesh.world_size

    def pad(self, arr):
        rem = (-arr.shape[0]) % self.n
        if rem == 0:
            return arr
        return torch.cat([arr, arr.new_zeros((rem,) + arr.shape[1:])])

    def unpad(self, arr, n_true: int):
        return arr[:n_true] if arr.shape[0] != n_true else arr

    def share(self, arr):
        """This rank's contiguous share of the padded batch."""
        arr = self.pad(arr)
        k = arr.shape[0] // self.n
        return arr[self.mesh.rank * k:(self.mesh.rank + 1) * k]

    def _log(self, op, x, ranks=1):
        self.record.append({"op": op, "bytes": x.numel() * x.element_size()
                            * ranks, "in_loop": self._in_fn > 0})

    def gather(self, x):
        """Every rank's x (its share's output) in rank order; the backward
        sums each rank's gradient of this rank's part (a reduce-scatter,
        recorded when it runs)."""
        self._log("all-gather", x, self.n)
        if x.requires_grad:
            x.register_hook(
                lambda g: self._log("reduce-scatter", g, self.n))
        return torch.cat(dist_nn.all_gather(x.contiguous(),
                                            group=self.mesh.group))

    def map_rays(self, fn, sharded, replicated=()):
        """fn(*shares, *replicated) on this rank's share of each ray batch
        of ``sharded`` (all of one length), its output (a tensor or a
        tuple of them) gathered over the ranks and sliced back to the
        batches' true length: the sharded counterpart of fn(*sharded,
        *replicated).  fn marches its rays alone and issues no
        collective."""
        n = sharded[0].shape[0]
        shares = [self.share(a) for a in sharded]
        self._in_fn += 1
        try:
            out = fn(*shares, *replicated)
        finally:
            self._in_fn -= 1
        if isinstance(out, tuple):
            return tuple(self.unpad(self.gather(o), n) for o in out)
        return self.unpad(self.gather(out), n)

    def all_reduce(self, tensors):
        """The tensors summed over the ranks, in one collective."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self._log("all-reduce", flat)
        dist.all_reduce(flat, group=self.mesh.group)
        return [part.view_as(t) for part, t in
                zip(flat.split([t.numel() for t in tensors]), tensors)]


def ray_sharder(mesh: Mesh) -> RaySharder:
    return RaySharder(mesh)


def replicate(mesh: Mesh, tree):
    """``tree`` (a SceneData, FrameState, Camera) on mesh.device with rank
    0's values on every rank: one broadcast a leaf."""
    src = 0 if mesh.group is None else dist.get_global_rank(mesh.group, 0)

    def bcast(x):
        x = x.detach().to(mesh.device).clone()
        if mesh.world_size > 1:
            dist.broadcast(x, src=src, group=mesh.group)
        return x
    return tree_map(bcast, tree)


def collective_report(sharder: RaySharder, fn, *args):
    """(fn(*args), the collectives it issued through ``sharder``): the
    counterpart of the JAX package's scan of XLA's HLO, read from the
    sharder's record.  {"in_loops": issued inside a map_rays function
    (where the marches run; 0 for a sound frame), "n_collectives",
    "bytes", "ops"}."""
    start = len(sharder.record)
    out = fn(*args)
    ops = sharder.record[start:]
    return out, {"in_loops": sum(op["in_loop"] for op in ops),
                 "n_collectives": len(ops),
                 "bytes": sum(op["bytes"] for op in ops), "ops": ops}


def make_sharded_render(spec: SceneSpec, probes: ProbeSettings,
                        vol: VolumetricsSettings, width: int, height: int,
                        mesh: Mesh, screen_cfg: ShadeConfig = None,
                        probe_cfg: ShadeConfig = PROBE_SHADE_CONFIG):
    """Frame function run(data, camera, state) -> (image, new state) with
    rays sharded over the mesh; every rank returns the whole image.  A
    world of 1 skips the sharder, as the JAX package skips shard_map on
    one device.  ``run.sharder`` is the sharder (None at a world of
    1)."""
    shard = ray_sharder(mesh) if mesh.world_size > 1 else None

    def run(data, camera, state):
        return render_frame(spec, probes, vol, width, height, data, camera,
                            state, screen_cfg=screen_cfg,
                            probe_cfg=probe_cfg, shard=shard)

    run.sharder = shard
    return run


def split_float_leaves(tree):
    """(float leaves, aux): the leaves to differentiate, in tree_leaves'
    order, and what merge_float_leaves needs to put them back."""
    leaves = tree_leaves(tree)
    is_f = tuple(leaf.is_floating_point() for leaf in leaves)
    floats = [leaf for leaf, f in zip(leaves, is_f) if f]
    return floats, (tree, leaves, is_f)


def merge_float_leaves(aux, floats):
    """The tree of ``aux`` with its float leaves replaced by ``floats``
    (in order) and its other leaves as they were."""
    tree, leaves, is_f = aux
    new = iter(floats)
    merged = iter([next(new) if f else leaf
                   for leaf, f in zip(leaves, is_f)])
    return tree_map(lambda _: next(merged), tree)


def _differentiable(vol, screen_cfg, probe_cfg):
    """The train step's shade configs: the scene's with differentiable
    set (screen_cfg None: screen_shade_config's)."""
    if screen_cfg is None:
        screen_cfg = screen_shade_config(vol.enabled)
    return (dataclasses.replace(screen_cfg, differentiable=True),
            dataclasses.replace(probe_cfg, differentiable=True))


def make_value_and_grad(spec: SceneSpec, probes: ProbeSettings,
                        vol: VolumetricsSettings, width: int, height: int,
                        screen_cfg: ShadeConfig = None,
                        probe_cfg: ShadeConfig = PROBE_SHADE_CONFIG,
                        mesh: Mesh = None):
    """The train step's loss and gradient: fn(data, camera, state, target)
    -> (loss, grads, new state).  Both passes render differentiable;
    ``target`` is an f32[H, W, 3] image on the data's device; the loss is
    mean((image − target)²), detached; grads holds d loss / d leaf for
    every float leaf of data in split_float_leaves' order (zeros for a
    leaf the frame does not reach); the new state is the frame's detached
    feedback.  With a ``mesh`` the frame's rays are sharded over it (at
    any world size: at 1 the collectives are copies) and the gradients
    are summed over the ranks; ``value_and_grad.sharder`` is the
    sharder.  It runs op by op (make_train_step compiles its step)."""
    screen_cfg, probe_cfg = _differentiable(vol, screen_cfg, probe_cfg)
    shard = None if mesh is None else ray_sharder(mesh)
    scale = 1 if shard is None else shard.n

    def value_and_grad(data, camera, state, target):
        floats, aux = split_float_leaves(data)
        params = [p.detach().requires_grad_(True) for p in floats]
        with torch.enable_grad():
            image, new_state = render_frame(
                spec, probes, vol, width, height,
                merge_float_leaves(aux, params), camera, state,
                screen_cfg=screen_cfg, probe_cfg=probe_cfg, shard=shard)
            loss = torch.mean((image - target) ** 2)
            grads = torch.autograd.grad(loss / scale, params,
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if shard is not None:
            grads = shard.all_reduce(grads)
        return loss.detach(), grads, new_state

    value_and_grad.sharder = shard
    return value_and_grad


def _sgd_update(floats, grads, lr):
    """The train step's update of the float leaves: p − lr·g each."""
    with torch.no_grad():
        return [p - lr * g for p, g in zip(floats, grads)]


class CompiledStep(Captured):
    """The train step for one static key, the counterpart of the JAX
    package's ``jax.jit(step, donate_argnums=(0, 2))``: make_train_step's
    static arguments (spec, probes, vol, width, height, lr and the
    differentiable screen_cfg and probe_cfg) and the shapes of the scene
    data, camera, state and target, on one device.

    A ``Captured`` (render/pipeline.py) with inputs data, camera, state
    and target.  Its body is the eager step on the buffers: the loss, the
    gradients of the float data buffers themselves (``value_and_grad``
    differentiates ``buf.detach().requires_grad_(True)``, which shares
    their storage; the autodiff normals' nested gradients inside), the
    update ``_sgd_update`` computes, written into the float data buffers,
    and the new feedback state, written into the state buffers: the data
    and state are updated in place, donation's counterpart.  On a card
    forward, backward and update are one CUDA graph.  The warm-up takes
    the gradients and writes nothing back.

    A call returns (loss, new data, new state) as fresh tensors, the new
    data the argument's tree with its float leaves replaced
    (merge_float_leaves; its other leaves as they were).  Every call
    copies its arguments into the buffers, a chained call's too, so a
    returned tensor the caller changed in place reaches the next step."""

    captures = 0   # steps captured (on the CPU: set up) in this process

    def __init__(self, value_and_grad, lr, data, camera, state, target):
        self.value_and_grad, self.lr = value_and_grad, lr
        super().__init__(state.radiance.device, data=data, camera=camera,
                         state=state, target=target)
        self.floats = split_float_leaves(self.data)[0]

    def __call__(self, data, camera, state, target):
        with torch.no_grad():
            self.copy_in(data=data, camera=camera, state=state,
                         target=target)
            loss = self.run().clone()
            floats = [x.clone() for x in self.floats]
            new_state = tree_map(torch.clone, self.state)
        new_data = merge_float_leaves(split_float_leaves(data)[1], floats)
        return loss, new_data, new_state

    def _warmup(self):
        """The loss, gradients and new state on the buffers."""
        return self.value_and_grad(self.data, self.camera, self.state,
                                   self.target)

    def _body(self):
        """One step on the buffers, the update and the state written back
        into them."""
        loss, grads, new_state = self._warmup()
        with torch.no_grad():
            for buf, x in zip(self.floats,
                              _sgd_update(self.floats, grads, self.lr)):
                buf.copy_(x)
            for buf, x in zip(tree_leaves(self.state),
                              tree_leaves(new_state)):
                buf.copy_(x)
        return loss


class TrainStep:
    """make_train_step's step (see there): ``step(data, camera, state,
    target)``, ``step.sharder``, ``step.compiled_step`` (the CompiledStep
    of the last call, None after an eager call) and ``step.cache_size()``.
    An object, not a closure that names itself: a closure's cycle would
    keep its compiled steps, and their graphs and pools, alive until the
    cyclic garbage collector runs, which may be during another capture."""

    def __init__(self, value_and_grad, lr, compiled_route):
        self.value_and_grad, self.lr = value_and_grad, lr
        self.compiled_route = compiled_route
        self.sharder = value_and_grad.sharder
        self.compiled_step = None
        self._compiled = collections.OrderedDict()   # keyed by the shapes

    def cache_size(self) -> int:
        return len(self._compiled)

    def __call__(self, data, camera, state, target):
        if not self.compiled_route or eager_active():
            self.compiled_step = None
            loss, grads, new_state = self.value_and_grad(data, camera, state,
                                                         target)
            floats, aux = split_float_leaves(data)
            new = _sgd_update(floats, grads, self.lr)
            return loss, merge_float_leaves(aux, new), new_state
        key = (tree_shapes(data), tree_shapes(camera), tree_shapes(state),
               tree_shapes(target), state.radiance.device)
        fn = self._compiled.pop(key, None)
        if fn is None:
            fn = CompiledStep(self.value_and_grad, self.lr, data, camera,
                              state, target)
            while len(self._compiled) >= GRAPH_CACHE_SIZE:
                self._compiled.popitem(last=False)
        self._compiled[key] = self.compiled_step = fn
        return fn(data, camera, state, target)


def make_train_step(spec: SceneSpec, probes: ProbeSettings,
                    vol: VolumetricsSettings, width: int, height: int,
                    lr: float = 0.01, screen_cfg: ShadeConfig = None,
                    probe_cfg: ShadeConfig = PROBE_SHADE_CONFIG,
                    mesh: Mesh = None) -> TrainStep:
    """The train step: step(data, camera, state, target) -> (loss, new
    data, new state), make_value_and_grad's loss and state with new data
    holding the updated float leaves p − lr·g and the integer leaves as
    they were.

    Without a ``mesh``, on a scene of the kernel route (ops/march.py:
    kernel_scene) and outside a ``pipeline.eager()`` block, checked at
    each call, the step is compiled: a CompiledStep per static key, made
    on first use and kept among the GRAPH_CACHE_SIZE most recently used
    of this step (as jit caches per function: the static arguments are
    this call's, so a key holds the shapes; ``step.cache_size()``, the
    CompiledStep of the last call ``step.compiled_step``, None after an
    eager call).  Otherwise it runs op by op: the generic route's plain
    marches wait on the device at every step, and a mesh issues
    collectives; sharded over ``mesh`` when given (``step.sharder``)."""
    value_and_grad = make_value_and_grad(spec, probes, vol, width, height,
                                         screen_cfg, probe_cfg, mesh)
    return TrainStep(value_and_grad, lr, mesh is None and kernel_scene(spec))


def measure_scaling(builder=None, width: int = 256, height: int = 256,
                    frames: int = 4, mesh: Mesh = None, **builder_kw):
    """Frame time of the sharded render on the whole world against a
    world of 1 (each rank rendering the whole frame alone), same scene
    and shapes: {"devices", "t1_s", "tN_s", "efficiency" = t1 / (tN·N)}.
    Every rank of the world must call it."""
    if builder is None:
        from madarch_tpu_torch.examples.scenes import global_illumination
        builder = global_illumination
    mesh = mesh or make_mesh()
    one = dataclasses.replace(mesh, world_size=1, rank=0)
    results = {}
    for m in (one, mesh) if mesh.world_size > 1 else (mesh,):
        r = builder(width=width, height=height, device=mesh.device,
                    **builder_kw)
        run = make_sharded_render(r.spec, r.probes, r.volumetrics, width,
                                  height, m, screen_cfg=r.screen_cfg,
                                  probe_cfg=r.probe_cfg)
        data, cam, state = r.scene_data, r.camera, r.state
        img, state = run(data, cam, state)
        _barrier(mesh, img)
        t0 = time.perf_counter()
        for _ in range(frames):
            img, state = run(data, cam, state)
        _barrier(mesh, img)
        results[m.world_size] = (time.perf_counter() - t0) / frames
    n = mesh.world_size
    return {"devices": n, "t1_s": results[1], "tN_s": results[n],
            "efficiency": results[1] / (results[n] * n)}


def _barrier(mesh, x):
    """Wait for this rank's device, then for every rank."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    if mesh.world_size > 1:
        dist.barrier(group=mesh.group)
