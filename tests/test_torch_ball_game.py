"""Port parity: ball_game and Renderer.eval_distance_to of
madarch_tpu_torch against madarch_tpu.

- tests/test_examples.py's physics check: a thrown ball falls under
  gravity and bounces off the floor.
- eval_distance_to at 64 seeded points, over all types and over [Plane,
  Box], against the JAX package's: distances to 1e-6 absolute (measured
  2.4e-7) and normals to 1e-5 (measured 1.2e-7).
- The golden's script (tools/make_goldens.py): a ball thrown, two physics
  steps, two frames, at 32² with the tiny probes: the ball's path equal
  to 1e-6 and the frame under the golden gates (measured mean_absdiff
  1.7e-4, no pixel above 0.05; ball_game runs the geometry kernel's plain
  version here, the JAX package its XLA path).
- examples/run.py drives ball_game and bvh_test.
"""
import numpy as np
import pytest
import torch

from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.scene import primitives as JP
from madarch_tpu_torch.core.config import ProbeSettings, screen_shade_config
from madarch_tpu_torch.examples import run as trun
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.ops import march as TM
from madarch_tpu_torch.render import pipeline as TPL
from madarch_tpu_torch.scene import primitives as TP
from madarch_tpu_torch.utils.golden import image_stats
from test_torch_config import jax_config, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

TINY = ProbeSettings(radiance_resolution=8, irradiance_resolution=4,
                     probe_count=(4, 2), grid_dimensions=(2, 2, 2),
                     grid_spacing=(4.0, 4.0, 4.0))


def test_ball_falls_and_bounces():
    r, step_physics, throw_ball = tscenes.ball_game(
        width=16, height=16, probes=TINY, device="cpu")
    r.screen_cfg = screen_shade_config(False, max_march_steps=48)
    throw_ball(origin=(2.0, 3.0, 2.0), velocity=(0.0, 0.0, 1.0))
    ys = []
    for _ in range(60):
        step_physics(dt=0.05)
        ys.append(float(r.builder._prims["sphere"]["center"][0, 1]))
    assert min(ys) > -1.05
    went_down = any(ys[i + 1] < ys[i] for i in range(len(ys) - 1))
    went_up = any(ys[i + 1] > ys[i] + 1e-4 for i in range(20, len(ys) - 1))
    assert went_down and went_up
    img = r.render().numpy()
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert 0.0 <= img.min() and img.max() <= 1.0 and img.std() > 1e-4


def after_script(size):
    """ball_game in both packages at size² after the golden's script."""
    out = []
    for mod, probes, kw in ((jscenes, jax_config(TINY), {}),
                            (tscenes, TINY, {"device": "cpu"})):
        r, step, throw = mod.ball_game(width=size, height=size,
                                       probes=probes, **kw)
        throw((2.0, 2.0, 0.0), (2.0, 2.0, 4.0))
        for _ in range(2):
            step()
        out.append(r)
    return out


@pytest.fixture(scope="module")
def games():
    return after_script(16)


@pytest.mark.parametrize("prims", [None, "plane_box"])
def test_eval_distance_to_matches_jax(games, prims):
    jr, tr = games
    jp = None if prims is None else [JP.Plane, JP.Box]
    tp = None if prims is None else [TP.Plane, TP.Box]
    pts = np.random.RandomState(41).uniform(-0.5, 6.5, (64, 3)).astype(
        np.float32)
    for p in pts:
        jd, jn = jr.eval_distance_to(p, prims=jp)
        td, tn = tr.eval_distance_to(p, prims=tp)
        assert isinstance(td, float) and tn.dtype == np.float32
        assert tn.shape == (3,)
        assert abs(td - jd) <= 1e-6
        np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-5)


def test_ball_game_frame_matches_jax():
    """At 32²: at 16² the camera's row 6 runs exactly along the box's top
    front edge (y = 1.5, z = 2.5), where the geometry kernel's tetrahedron
    FD normal blends the two faces and the JAX package's XLA path takes
    one face's normal (ROADMAP C4); 6 of its 256 pixels differ by up to
    0.23 there, past the gates' 2%, as in the GI room, which shares the
    box and the camera."""
    jr, tr = after_script(32)
    np.testing.assert_allclose(tr.builder._prims["sphere"]["center"],
                               jr.builder._prims["sphere"]["center"],
                               rtol=0, atol=1e-6)
    # count-dynamic, as the JAX package's: every slot packed, the dead
    # ones masked by the live counts (1 sphere, 6 planes, 1 box)
    assert tr.spec.live_prims is None is jr.spec.live_prims
    assert tr.builder._prim_counts == jr.builder._prim_counts \
        == {"sphere": 1, "plane": 6, "box": 1}
    assert TM.kernel_scene(tr.spec)
    for _ in range(2):
        ref = np.asarray(jr.render())
        img = tr.render().numpy()
    stats = image_stats(img, ref)
    assert not stats["breached"], stats
    assert float(ref.var()) > 0.0


@pytest.mark.parametrize("scene", ["ball_game", "bvh_test"])
def test_run_cli_renders_the_new_scenes(tmp_path, scene):
    out = tmp_path / "frame.png"
    trun.main([scene, "--device", "cpu", "--fast", "--size", "16x16",
               "--frames", "2", "--out", str(out)])
    assert out.stat().st_size > 0


def test_ball_game_throws_balls_without_capturing_again():
    """ball_game is count-dynamic, as the JAX package's: with
    specialize_counts False (its default) a thrown ball keeps the
    compiled frame; True compiles one per live count."""
    for specialize, more in ((False, 0), (True, 2)):
        kw = {} if not specialize else {"specialize_counts": True}
        r, step, throw = tscenes.ball_game(width=8, height=8, probes=TINY,
                                           device="cpu", **kw)
        assert r.specialize_counts is specialize
        r.render()
        frame, captures = r.frame, TPL.CompiledFrame.captures
        for k in range(2):
            throw((2.0 + 0.5 * k, 2.0, 1.0), (1.0, 1.0, 2.0))
            step()
            r.render()
        assert r.builder._prim_counts["sphere"] == 2
        assert TPL.CompiledFrame.captures - captures == more
        assert (r.frame is frame) is (not specialize)
