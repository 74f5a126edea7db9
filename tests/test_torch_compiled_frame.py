"""The compiled frame (render/pipeline.py:compiled_frame, CompiledFrame)
and Renderer(specialize_counts) against the eager frame and the JAX
package.

On the CPU a CompiledFrame runs render_frame on its own input buffers, as
a replayed CUDA graph does on the card, so these tests catch what a graph
would get wrong there: a buffer left stale, a state not chained.

- Equality: compiled and eager frames bit-equal, image and the three
  state textures, over two frames of GI in specular modes 0-3,
  light_shafts, simple_scene, obj_mesh on the in-repo torus and ball_game
  after throws.
- Stale buffers: after moving a sphere, a light or a material, after
  update_partitioning and after assigning the state, no new frame is
  compiled and the image equals render_frame's on the new inputs (and
  differs from the old inputs' image).
- The compiled frames follow the JAX package's jit cache: on one
  sequence of mutations the port compiles a frame exactly where JAX's
  render_frame._cache_size() grows, with specialize_counts True and
  False.
- JAX parity: a compiled frame from the JAX renderer's state matches the
  JAX Renderer.render() under the golden gates, as test_torch_pipeline.py
  holds render_frame (mean absolute difference < 1e-3).
- The route: bvh_test is not compiled and renders; eager() keeps a
  kernel scene eager; the cache keeps GRAPH_CACHE_SIZE frames.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.render import pipeline as JPL
from madarch_tpu.scene import primitives as JP
from madarch_tpu_torch.core.config import (ProbeSettings, ShadeConfig,
                                           VolumetricsSettings,
                                           screen_shade_config)
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.render import pipeline as TPL
from madarch_tpu_torch.scene import lights as TL
from madarch_tpu_torch.scene import primitives as TP
from madarch_tpu_torch.utils.golden import image_stats
from test_torch_config import jax_config, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

FAST = ProbeSettings(radiance_resolution=8, irradiance_resolution=4,
                     probe_count=(4, 2), grid_dimensions=(2, 2, 2),
                     grid_spacing=(4.0, 4.0, 4.0))
MESH_PROBES = dataclasses.replace(FAST, grid_spacing=(2.0, 3.0, 3.0))
SMALL_VOL = VolumetricsSettings(visibility_resolution=(8, 8, 8),
                                visibility_step_size=0.5,
                                scattering_resolution=(12, 12),
                                scattering_step_size=0.5)
SIZE = 16
FIELDS = ("radiance", "irradiance", "scattering")


def scene(name, size=SIZE, **kw):
    """The example ``name`` on the CPU at size² with small probes."""
    if name.startswith("gi"):
        return tscenes.global_illumination(
            width=size, height=size, probes=FAST, device="cpu",
            screen_cfg=ShadeConfig(indirect_specular_mode=int(name[-1])),
            **kw)
    if name == "light_shafts":
        return tscenes.light_shafts(width=size, height=size, probes=FAST,
                                    volumetrics=SMALL_VOL, device="cpu",
                                    **kw)
    if name == "obj_mesh":
        return tscenes.obj_mesh(width=size, height=size, probes=MESH_PROBES,
                                obj_path=tscenes.TORUS_OBJ, device="cpu",
                                **kw)
    if name == "ball_game":
        r, step, throw = tscenes.ball_game(width=size, height=size,
                                           probes=FAST, device="cpu", **kw)
        throw((2.0, 2.0, 0.0), (2.0, 2.0, 4.0))
        throw((3.0, 2.5, 1.0), (0.0, 1.0, 4.0), radius=0.4)
        step()
        return r
    return getattr(tscenes, name)(width=size, height=size, probes=FAST,
                                  device="cpu", **kw)


def same_state(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f)) for f in FIELDS)


def eager_frame(r, state):
    """render_frame on renderer r's inputs from ``state``."""
    with torch.no_grad():
        return TPL.render_frame(r.spec, r.probes, r.volumetrics, r.width,
                                r.height, r.scene_data, r.camera, state,
                                screen_cfg=r.screen_cfg,
                                probe_cfg=r.probe_cfg)


@pytest.mark.parametrize("name", ["gi0", "gi1", "gi2", "gi3",
                                  "light_shafts", "simple_scene",
                                  "obj_mesh", "ball_game"])
def test_compiled_frames_equal_eager_frames(name):
    compiled, eager = scene(name), scene(name)
    assert compiled.compiled
    for _ in range(2):
        img = compiled.render()
        with TPL.eager():
            ref = eager.render()
        assert torch.equal(img, ref)
        assert same_state(compiled.state, eager.state)
    assert compiled.frame is not None and eager.frame is None
    assert float(img.var()) > 0.0


def test_a_mutation_that_keeps_the_key_copies_into_the_buffers():
    r = scene("gi2")
    r.render()
    captures = TPL.CompiledFrame.captures
    frame = r.frame

    def check(mutate):
        state, data = r.state, r.scene_data
        mutate()
        ref, ref_state = eager_frame(r, state)
        old, _ = TPL.render_frame(r.spec, r.probes, r.volumetrics, r.width,
                                  r.height, data, r.camera, state,
                                  screen_cfg=r.screen_cfg)
        img = r.render()
        assert torch.equal(img, ref) and same_state(r.state, ref_state)
        assert not torch.equal(img, old)     # the mutation shows
        assert r.frame is frame and TPL.CompiledFrame.captures == captures

    # the sphere into the camera's view, the spot light above it, the
    # sphere's material from a dark mirror to a rough yellow
    check(lambda: r.set_primitive(TP.Sphere, 0, center=(2.0, 1.8, 3.0)))
    check(lambda: r.set_light(TL.SpotLight, 0, position=(2.0, 5.0, 3.0)))
    check(lambda: r.set_material(3, (0.9, 0.9, 0.1), 0.0, 0.9))


def test_update_partitioning_reaches_the_compiled_frame():
    r = scene("obj_mesh")
    r.render()
    captures = TPL.CompiledFrame.captures
    grid = r.scene_data.grid
    r.update_partitioning("cpu_best")
    assert r.scene_data.grid is not grid
    state = r.state
    ref, _ = eager_frame(r, state)
    assert torch.equal(r.render(), ref)
    assert TPL.CompiledFrame.captures == captures
    # the compiled frame's buffers hold the new grid
    for name, x in dataclasses.asdict(r.scene_data.grid).items():
        assert torch.equal(getattr(r.frame.data.grid, name), x)


def test_an_assigned_state_reaches_the_compiled_frame():
    r = scene("light_shafts")
    r.render()
    g = torch.Generator().manual_seed(17)
    state = TPL.FrameState(**{f: torch.rand(getattr(r.state, f).shape,
                                            generator=g) for f in FIELDS})
    r.state = state
    ref, ref_state = eager_frame(r, state)
    assert torch.equal(r.render(), ref)
    assert same_state(r.state, ref_state)
    # the returned state is fresh: the next frame leaves it alone
    kept = TPL.FrameState(**{f: getattr(r.state, f).clone()
                             for f in FIELDS})
    returned = r.state
    r.render()
    assert same_state(returned, kept)


def _sequence(r, mods):
    """The mutation sequence of the jit-cache parity test on renderer r,
    with ``mods`` (primitives module, shade config class, config adapter):
    a frame before the sequence and after each step."""
    P, cfg = mods

    def add():
        r.add_primitive(P.Sphere, center=(3.0, 1.0, 4.5), radius=0.3,
                        material_id=1)
    return [("first", lambda: None),
            ("move a primitive",
             lambda: r.set_primitive(P.Sphere, 0, center=(2.5, 0.5, 3.0))),
            ("add a primitive", add),
            ("move the camera",
             lambda: r.set_camera_position((1.5, 2.0, 0.5))),
            ("change screen_cfg",
             lambda: setattr(r, "screen_cfg", cfg))]


@pytest.mark.parametrize("specialize", [True, False])
def test_compiled_frames_follow_the_jax_jit_cache(specialize):
    """At 24x16, a size no other test of this module renders, so the JAX
    cache starts without this key."""
    w, h = 24, 16
    jr = jscenes.global_illumination(width=w, height=h,
                                     probes=jax_config(FAST),
                                     specialize_counts=specialize)
    tr = tscenes.global_illumination(width=w, height=h, probes=FAST,
                                     device="cpu",
                                     specialize_counts=specialize)
    mode1 = ShadeConfig(indirect_specular_mode=1)
    jax_steps = _sequence(jr, (JP, jax_config(mode1)))
    port_steps = _sequence(tr, (TP, mode1))
    jax_growth, port_growth = [], []
    for (name, jstep), (_, tstep) in zip(jax_steps, port_steps):
        jstep()
        tstep()
        before = JPL.render_frame._cache_size()
        jr.render()
        jax_growth.append(JPL.render_frame._cache_size() - before)
        before = TPL.CompiledFrame.captures
        tr.render()
        port_growth.append(TPL.CompiledFrame.captures - before)
    assert port_growth == jax_growth
    assert jax_growth == ([1, 0, 1, 0, 1] if specialize
                         else [1, 0, 0, 0, 1])


@pytest.mark.parametrize("name", ["global_illumination", "light_shafts"])
def test_a_compiled_frame_from_the_jax_state_matches_jax(name):
    size = 32
    vol = {"volumetrics": SMALL_VOL} if name == "light_shafts" else {}
    jvol = {k: jax_config(v) for k, v in vol.items()}
    jr = getattr(jscenes, name)(width=size, height=size,
                                probes=jax_config(FAST), **jvol)
    tr = getattr(tscenes, name)(width=size, height=size, probes=FAST,
                                device="cpu", **vol)
    jr.render()
    tr.state = TPL.FrameState.from_numpy(
        jax.tree.map(np.asarray, jr.state), "cpu")
    for _ in range(2):
        ref = np.asarray(jr.render())
        img = tr.render().numpy()
    assert tr.frame is not None
    stats = image_stats(img, ref)
    assert not stats["breached"], stats
    assert stats["mean_absdiff"] < 1e-3
    np.testing.assert_allclose(tr.state.scattering.numpy(),
                               np.asarray(jr.state.scattering), atol=1e-5)


def test_the_generic_route_is_not_compiled():
    r = tscenes.bvh_test(width=SIZE, height=SIZE, n_spheres=4,
                         probes=FAST, device="cpu")
    r.screen_cfg = screen_shade_config(False, max_march_steps=48)
    captures = TPL.CompiledFrame.captures
    assert not r.compiled
    img = r.render()
    assert img.shape == (SIZE, SIZE, 3) and torch.isfinite(img).all()
    assert r.frame is None and TPL.CompiledFrame.captures == captures


def test_eager_keeps_a_kernel_scene_eager_and_render_has_no_gradient():
    r = scene("simple_scene")
    captures = TPL.CompiledFrame.captures
    with TPL.eager():
        assert TPL.eager_active() and not r.compiled
        img = r.render()
    assert not TPL.eager_active()
    assert r.frame is None and TPL.CompiledFrame.captures == captures
    assert not img.requires_grad and not r.render().requires_grad


def test_the_cache_keeps_graph_cache_size_frames():
    r = scene("gi2")
    sizes = [(16 + 2 * i, 16) for i in range(TPL.GRAPH_CACHE_SIZE + 1)]
    frames = []
    for w, h in sizes:
        r.width, r.height = w, h
        r.state = TPL.initial_state(r.probes, r.volumetrics, "cpu")
        r.render()
        frames.append(r.frame)
        assert TPL.cache_size() <= TPL.GRAPH_CACHE_SIZE
    assert len({id(f) for f in frames}) == len(sizes)
    # the most recent keys are kept, the oldest was dropped
    r.width, r.height = sizes[-1]
    r.render()
    assert r.frame is frames[-1]
    captures = TPL.CompiledFrame.captures
    r.width, r.height = sizes[0]
    r.render()
    assert r.frame is not frames[0]
    assert TPL.CompiledFrame.captures == captures + 1
