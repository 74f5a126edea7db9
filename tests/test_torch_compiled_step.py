"""The compiled train step (parallel/spmd.py:make_train_step, CompiledStep)
against the eager step and the JAX package's jitted, donating step.

On the CPU a CompiledStep runs the eager step on its own input buffers,
as a replayed CUDA graph does on the card, so these tests catch what a
graph would get wrong there: a buffer left stale, an update or a state not
chained.

- Equality: compiled and eager steps bit-equal over 3 chained steps (loss,
  every leaf of the updated data, the three state textures) on GI in
  specular modes 0-3 and light_shafts.
- Stale buffers: a mutated scene, a new camera and a new target reach the
  compiled step with no new capture; an argument is a snapshot; a change
  made in place to an argument, a returned tensor too, reaches the next
  step (and the next compiled frame); a dropped step frees its compiled
  steps at once.
- The compiled steps follow the JAX package's jit cache: the port sets up
  a step exactly where JAX's jitted step's _cache_size() grows.
- The route: bvh_test (the generic route), a mesh and pipeline.eager()
  take the eager step.
- JAX parity: one compiled step against JAX's make_train_step on a
  1-device mesh, at tests/test_torch_spmd.py's tolerances (the loss to
  rtol 1e-4, measured 4.2e-5 when set there; every updated float leaf to
  1e-6 absolute, measured 1.2e-7; the same values measured here on the
  compiled step, which is the eager step bit for bit).
"""
import contextlib
import dataclasses
import gc
import socket
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.parallel import spmd as jspmd
from madarch_tpu_torch.core.config import (NO_VOLUMETRICS, ProbeSettings,
                                           ShadeConfig, VolumetricsSettings,
                                           screen_shade_config)
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.parallel import spmd as tspmd
from madarch_tpu_torch.render import pipeline as TPL
from madarch_tpu_torch.scene import lights as TL
from madarch_tpu_torch.scene import primitives as TP
from madarch_tpu_torch.scene.scene import scene_data_from_numpy, tree_leaves
from test_torch_config import jax_config, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

TINY = ProbeSettings(**chip_smoke.TINY_PROBES)
SMALL_VOL = VolumetricsSettings(**chip_smoke.SMALL_VOL)
SIZE = 16
FIELDS = ("radiance", "irradiance", "scattering")
# tests/test_torch_spmd.py's probes spread to 5 m, shade config and lr
SPREAD = ProbeSettings(radiance_resolution=8, irradiance_resolution=4,
                       probe_count=(4, 2), grid_dimensions=(2, 2, 2),
                       grid_spacing=(5.0, 5.0, 5.0))
CFG = ShadeConfig(direct_specular=True, indirect_specular_mode=0,
                  add_indirect_specular=False, ambient_occlusion_steps=0,
                  render_volumetrics=False, max_march_steps=48)
LR = 0.05


def scene(name, size=SIZE):
    """The example ``name`` on the CPU at size² with the tiny probes."""
    if name.startswith("gi"):
        return tscenes.global_illumination(
            width=size, height=size, probes=TINY, device="cpu",
            screen_cfg=ShadeConfig(indirect_specular_mode=int(name[-1])))
    return tscenes.light_shafts(width=size, height=size, probes=TINY,
                                volumetrics=SMALL_VOL, device="cpu")


def make_step(r, **kw):
    return tspmd.make_train_step(r.spec, r.probes, r.volumetrics, r.width,
                                 r.height, screen_cfg=r.screen_cfg,
                                 probe_cfg=r.probe_cfg, **kw)


def target(r, value=0.0):
    return torch.full((r.height, r.width, 3), value)


def same_step(a, b):
    """Loss, every data leaf and the three state textures bit-equal."""
    (la, da, sa), (lb, db, sb) = a, b
    return (torch.equal(la, lb)
            and all(torch.equal(x, y)
                    for x, y in zip(tree_leaves(da), tree_leaves(db)))
            and all(torch.equal(getattr(sa, f), getattr(sb, f))
                    for f in FIELDS))


def eager_step(step, *args):
    with TPL.eager():
        return step(*args)


@pytest.mark.parametrize("name", ["gi0", "gi1", "gi2", "gi3",
                                  "light_shafts"])
def test_compiled_steps_equal_eager_steps(name):
    r = scene(name)
    step = make_step(r)
    tgt = target(r)
    comp = eager = (r.scene_data, r.state)
    for _ in range(3):
        c = step(comp[0], r.camera, comp[1], tgt)
        assert step.compiled_step is not None
        e = eager_step(step, eager[0], r.camera, eager[1], tgt)
        assert step.compiled_step is None
        assert same_step(c, e)
        comp, eager = c[1:], e[1:]
    moved = [not torch.equal(x, y) for x, y in zip(
        tspmd.split_float_leaves(comp[0])[0],
        tspmd.split_float_leaves(r.scene_data)[0])]
    assert any(moved) and float(c[0]) > 0.0
    assert step.cache_size() == 1


def test_a_mutation_a_camera_and_a_target_reach_the_compiled_step():
    """After the first step, a moved sphere, a moved light, a changed
    material, a moved camera and a grey target each reach the compiled
    step: its step equals the eager step on the new inputs, differs from
    the old inputs' step, and nothing new is set up."""
    r = scene("gi2")
    step = make_step(r)
    args = {"data": r.scene_data, "camera": r.camera, "state": r.state,
            "target": target(r)}

    def run(a):
        return step(a["data"], a["camera"], a["state"], a["target"])

    loss, args["data"], args["state"] = run(args)
    compiled, captures = step.compiled_step, tspmd.CompiledStep.captures

    def check(change):
        new = dict(args, **change())
        got = run(new)
        assert step.compiled_step is compiled
        ref = eager_step(step, new["data"], new["camera"], new["state"],
                         new["target"])
        old = eager_step(step, args["data"], args["camera"], args["state"],
                         args["target"])
        assert same_step(got, ref)
        assert not torch.equal(got[0], old[0])       # the change shows
        assert tspmd.CompiledStep.captures == captures
        args.update(new, data=got[1], state=got[2])

    def renderer_data(mutate):
        """The renderer's scene (no step taken) after ``mutate``."""
        def change():
            mutate()
            return {"data": r.scene_data}
        return change

    check(renderer_data(
        lambda: r.set_primitive(TP.Sphere, 0, center=(2.0, 1.8, 3.0))))
    check(renderer_data(
        lambda: r.set_light(TL.SpotLight, 0, position=(2.0, 5.0, 3.0))))
    check(renderer_data(
        lambda: r.set_material(3, (0.9, 0.9, 0.1), 0.0, 0.9)))

    def camera():
        r.set_camera_position((1.5, 2.0, 0.5))
        return {"camera": r.camera}
    check(camera)
    check(lambda: {"target": target(r, 0.5)})


def test_an_argument_is_a_snapshot():
    """The step never writes into its arguments nor into what it
    returned, and what it returned is no buffer of it: a returned tensor
    changed by the caller leaves the step's buffers as they were."""
    r = scene("gi2")
    step = make_step(r)
    data, state, tgt = r.scene_data, r.state, target(r)
    kept = [x.clone() for x in tree_leaves(data) + tree_leaves(state)]
    loss, data1, state1 = step(data, r.camera, state, tgt)
    assert all(torch.equal(a, b) for a, b in zip(
        kept, tree_leaves(data) + tree_leaves(state)))
    compiled = step.compiled_step
    buffers = [x.clone() for x in tree_leaves(compiled.data)
               + tree_leaves(compiled.state)]
    returned = tspmd.split_float_leaves(data1)[0] + tree_leaves(state1)
    kept1 = [x.clone() for x in returned]
    for x in returned:
        x.add_(1.0)
    assert all(torch.equal(a, b) for a, b in zip(
        buffers, tree_leaves(compiled.data) + tree_leaves(compiled.state)))
    for x, k in zip(returned, kept1):
        x.copy_(k)
    # the next step leaves what the last one returned alone
    step(data1, r.camera, state1, tgt)
    assert all(torch.equal(a, b) for a, b in zip(kept1, returned))
    # and the returned tensors carry no graph; integer leaves pass through
    assert not any(x.requires_grad for x in [loss] + tree_leaves(data1))
    for a, b in zip(tree_leaves(data), tree_leaves(data1)):
        if not a.is_floating_point():
            assert a is b


def test_a_change_in_place_reaches_the_next_step():
    """Two training loops of 3 steps, compiled and eager, from one start:
    before each step the caller clamps the returned albedo in place,
    refills its one target tensor in place and
    moves its one camera tensor in place.  Every compiled step equals the
    eager step bit for bit, and the changes show in it."""
    r = scene("gi2")
    r.scene_data.materials["albedo"].clamp_(0.2, 0.6)
    step = make_step(r)
    tgt, pos = target(r), r.camera.position.clone()
    cam = dataclasses.replace(r.camera, position=pos)
    runs = {"compiled": r.scene_data, "eager": r.scene_data}
    states = {"compiled": r.state, "eager": r.state}
    for i in range(3):
        tgt.fill_(0.1 * (i + 1))
        pos.add_(0.1)
        got = {}
        for way in ("compiled", "eager"):
            albedo = runs[way].materials["albedo"]
            before = albedo.clone()
            albedo.clamp_(0.2, 0.6)
            assert i == 0 or not torch.equal(albedo, before)
            with TPL.eager() if way == "eager" \
                    else contextlib.nullcontext():
                got[way] = step(runs[way], cam, states[way], tgt)
            runs[way], states[way] = got[way][1:]
        assert step.compiled_step is None and step.cache_size() == 1
        assert same_step(got["compiled"], got["eager"])


def test_a_dropped_step_frees_its_compiled_steps():
    """A train step is in no reference cycle: dropping it frees its
    compiled steps (on a card their graphs and pools) at once, not when
    the cyclic garbage collector runs, which may be during another
    capture."""
    r = scene("gi2", 8)
    step = make_step(r)
    step(r.scene_data, r.camera, r.state, target(r))
    compiled = weakref.ref(step.compiled_step)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del step
        assert compiled() is None
    finally:
        if collecting:
            gc.enable()


def test_a_change_in_place_reaches_the_next_frame():
    """The compiled frame too: the returned state zeroed in place and the
    scene's albedo changed in place between frames reach the next frame,
    which equals render_frame on the same inputs bit for bit."""
    r = scene("gi2")
    data = r.scene_data
    frame = TPL.compiled_frame(r.spec, r.probes, r.volumetrics, r.width,
                               r.height, data, r.camera, r.state,
                               r.screen_cfg, r.probe_cfg)
    _, state = frame(data, r.camera, r.state)
    state.radiance.zero_()
    data.materials["albedo"].mul_(0.5)
    image, new = frame(data, r.camera, state)
    ref_image, ref = TPL.render_frame(r.spec, r.probes, r.volumetrics,
                                      r.width, r.height, data, r.camera,
                                      state, screen_cfg=r.screen_cfg,
                                      probe_cfg=r.probe_cfg)
    assert torch.equal(image, ref_image)
    assert all(torch.equal(getattr(new, f), getattr(ref, f)) for f in FIELDS)


def test_compiled_steps_follow_the_jax_jit_cache():
    """On one sequence of calls the port sets up a compiled step exactly
    where the JAX package's jitted step's _cache_size() grows: the first
    step, a chained step, a moved camera, a new target of the same shape
    (none), a target of another shape (one), and a new make_train_step
    with another lr (one: a new function, a new cache).  At 8x8, with
    test_torch_spmd.py's shade config."""
    size = 8
    jr = jscenes.global_illumination(width=size, height=size,
                                     probes=jax_config(SPREAD))
    tr = tscenes.global_illumination(width=size, height=size, probes=SPREAD,
                                     device="cpu")

    def j_make(lr):
        return jspmd.make_train_step(
            jr.spec, jax_config(SPREAD), jr.volumetrics, size, size,
            jspmd.make_mesh(1), lr=lr, screen_cfg=jax_config(CFG))

    def t_make(lr):
        return tspmd.make_train_step(tr.spec, SPREAD, NO_VOLUMETRICS, size,
                                     size, lr=lr, screen_cfg=CFG)

    black = np.zeros((size, size, 3), np.float32)
    grey = np.full((size, size, 3), 0.5, np.float32)
    colour = np.array([[[0.2, 0.3, 0.4]]], np.float32)
    calls = [("first", LR, None, black), ("chained", LR, None, black),
             ("move the camera", LR, (1.5, 2.0, 0.5), black),
             ("a new target", LR, None, grey),
             ("another target shape", LR, None, colour),
             ("another lr", 0.01, None, colour)]
    j_steps, t_steps = {}, {}
    j_run = {"data": jr.scene_data, "state": jr.state}
    t_run = {"data": tr.scene_data, "state": tr.state}
    jax_growth, port_growth = [], []
    for _, lr, cam, tgt in calls:
        if cam is not None:
            jr.set_camera_position(cam)
            tr.set_camera_position(cam)
        if lr not in j_steps:
            j_steps[lr], t_steps[lr] = j_make(lr), t_make(lr)
        j_step, t_step = j_steps[lr], t_steps[lr]
        before = j_step._cache_size()
        # the JAX step donates its data and state: hand it copies
        _, j_run["data"], j_run["state"] = j_step(
            jax.tree.map(jnp.copy, j_run["data"]), jr.camera,
            jax.tree.map(jnp.copy, j_run["state"]), jnp.asarray(tgt))
        jax_growth.append(j_step._cache_size() - before)
        before = tspmd.CompiledStep.captures
        _, t_run["data"], t_run["state"] = t_step(
            t_run["data"], tr.camera, t_run["state"], torch.from_numpy(tgt))
        port_growth.append(tspmd.CompiledStep.captures - before)
    assert port_growth == jax_growth
    assert jax_growth == [1, 0, 0, 0, 1, 1]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("route", ["bvh_test", "mesh", "eager"])
def test_these_routes_take_the_eager_step(route):
    """bvh_test (the generic route), a mesh (a gloo world of 1 on the CPU)
    and a pipeline.eager() block: no compiled step is set up and the step
    runs, finite."""
    if route == "bvh_test":
        r = tscenes.bvh_test(width=8, height=8, n_spheres=4, probes=TINY,
                             device="cpu")
        r.screen_cfg = screen_shade_config(False, max_march_steps=48)
    else:
        r = scene("gi2", 8)
    captures = tspmd.CompiledStep.captures
    group = route == "mesh"
    if group:
        tspmd.init_distributed(f"tcp://127.0.0.1:{_free_port()}", 1, 0,
                               backend="gloo")
    try:
        kw = {"mesh": tspmd.make_mesh(device="cpu")} if group else {}
        step = make_step(r, **kw)
        with TPL.eager() if route == "eager" \
                else contextlib.nullcontext():
            loss, data, state = step(r.scene_data, r.camera, r.state,
                                     target(r))
    finally:
        if group:
            torch.distributed.destroy_process_group()
    assert step.compiled_step is None and step.cache_size() == 0
    assert tspmd.CompiledStep.captures == captures
    assert np.isfinite(float(loss))
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(data))
    assert (step.sharder is not None) == group


def test_one_compiled_step_matches_jax():
    """test_torch_spmd.py:test_one_step_matches_jax through the compiled
    step: one step of each package from the same scene and atlases (the
    JAX package's after one frame), the loss and every updated float
    leaf."""
    jr = jscenes.global_illumination(width=SIZE, height=SIZE,
                                     probes=jax_config(SPREAD))
    jr.converge(frames=1)
    j_step = jspmd.make_train_step(jr.spec, jax_config(SPREAD),
                                   jr.volumetrics, SIZE, SIZE,
                                   jspmd.make_mesh(1), lr=LR,
                                   screen_cfg=jax_config(CFG))
    data = scene_data_from_numpy(jax.tree.map(np.asarray, jr.scene_data),
                                 "cpu")
    state = TPL.FrameState.from_numpy(jax.tree.map(np.asarray, jr.state),
                                      "cpu")
    j_loss, j_data, _ = j_step(jax.tree.map(jnp.copy, jr.scene_data),
                               jr.camera, jax.tree.map(jnp.copy, jr.state),
                               jnp.zeros((SIZE, SIZE, 3), jnp.float32))
    tr = tscenes.global_illumination(width=SIZE, height=SIZE, probes=SPREAD,
                                     device="cpu")
    step = tspmd.make_train_step(tr.spec, SPREAD, NO_VOLUMETRICS, SIZE, SIZE,
                                 lr=LR, screen_cfg=CFG)
    loss, new, _ = step(data, tr.camera, state, torch.zeros((SIZE, SIZE, 3)))
    assert step.compiled_step is not None
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    j_floats, _ = jspmd.split_float_leaves(j_data)
    floats, _ = tspmd.split_float_leaves(new)
    assert len(floats) == len(j_floats)
    for a, b in zip(j_floats, floats):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)


def test_the_step_keeps_graph_cache_size_compiled_steps():
    """As many target shapes as GRAPH_CACHE_SIZE + 1: each a compiled
    step, at most GRAPH_CACHE_SIZE kept, the oldest dropped."""
    r = scene("gi2", 8)
    step = make_step(r)
    shapes = [(8, 8, 3), (1, 1, 3), (8, 1, 3), (1, 8, 3), (8, 8, 1)]
    assert len(shapes) == TPL.GRAPH_CACHE_SIZE + 1
    made = []
    for shape in shapes:
        step(r.scene_data, r.camera, r.state, torch.zeros(shape))
        made.append(step.compiled_step)
        assert step.cache_size() <= TPL.GRAPH_CACHE_SIZE
    assert len({id(s) for s in made}) == len(shapes)
    step(r.scene_data, r.camera, r.state, torch.zeros(shapes[-1]))
    assert step.compiled_step is made[-1]
    captures = tspmd.CompiledStep.captures
    step(r.scene_data, r.camera, r.state, torch.zeros(shapes[0]))
    assert step.compiled_step is not made[0]
    assert tspmd.CompiledStep.captures == captures + 1
