"""Port parity: the GI frame's loss gradient, leaf by leaf, against the JAX
package's kernel path (its Pallas kernels in interpret mode,
MADARCH_FORCE_PALLAS=1, set inside each test).

Both packages march under stop gradient there, and gradients re-enter
through the implicit-function-theorem hit distance and the autodiff
normal.  The JAX package's default CPU path (XLA) is not the port's: its AO
is differentiable and its mode-3 reflection normal the autodiff one
(tests/test_torch_differentiability.py holds the port to it where AO is
off).  The scene is global_illumination at 16², FAST's probe tiles (8²
radiance, 4² irradiance, 2×2×2 probes) with the grid spread to 5 m, one
frame of the JAX package's feedback atlases carried across, and the loss
the frame's mean square (the train step's against a black target).

Tolerance: 1e-3 relative norm per leaf; measured 2.5e-4 at most (the box
in mode 2, where lanes of the folded reflection near a tie flip between
backends, ROADMAP C3 and C4), 6.1e-5 or less on the other leaves.  Mode 3
is held on the light and material leaves only: the JAX kernel path has no
mode-3 gradient for geometry (its second launch marches from pos +
normal·offset, which then carries a tangent into a while_loop without a
reverse rule); tests/test_torch_differentiability.py holds mode 3's
geometry gradient by finite differences, chip_smoke.py card against CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.parallel import spmd as jspmd
from madarch_tpu.render import pipeline as JPL
from madarch_tpu_torch.core.config import (PROBE_SHADE_CONFIG, ProbeSettings,
                                           screen_shade_config)
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.parallel import spmd as tspmd
from madarch_tpu_torch.render import pipeline as TPL
from madarch_tpu_torch.scene.scene import scene_data_from_numpy
from test_torch_config import jax_config, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


# FAST's tiles (tests/test_torch_pipeline.py) with the grid spread from 4 to
# 5 m: FAST puts the probe at (4, 0, 4) inside the room's box, where the
# JAX package's primitive gradients are NaN
# (test_torch_differentiability.py:test_probe_inside_geometry_*).
SPREAD = ProbeSettings(radiance_resolution=8, irradiance_resolution=4,
                       probe_count=(4, 2), grid_dimensions=(2, 2, 2),
                       grid_spacing=(5.0, 5.0, 5.0))
FAST = dataclasses.replace(SPREAD, grid_spacing=(4.0, 4.0, 4.0))
SIZE = 16


def gi_scene(probes):
    """The GI scene in both packages at SIZE² with ``probes``, and the JAX
    package's feedback atlases after one frame (its XLA path)."""
    jr = jscenes.global_illumination(width=SIZE, height=SIZE,
                                     probes=jax_config(probes))
    jr.converge(frames=1)
    data = scene_data_from_numpy(jax.tree.map(np.asarray, jr.scene_data),
                                 "cpu")
    state = TPL.FrameState.from_numpy(jax.tree.map(np.asarray, jr.state),
                                      "cpu")
    tr = tscenes.global_illumination(width=SIZE, height=SIZE, probes=probes,
                                     device="cpu")
    return jr, tr, data, state


@pytest.fixture(scope="module")
def gi():
    return gi_scene(SPREAD)


def cfgs(mode):
    screen = dataclasses.replace(screen_shade_config(False),
                                 indirect_specular_mode=mode,
                                 differentiable=True)
    return screen, dataclasses.replace(PROBE_SHADE_CONFIG,
                                       differentiable=True)


def leaf_names(tree):
    """The float leaves' key paths, in jax.tree.flatten's order."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [jax.tree_util.keystr(path) for path, leaf in flat
            if jnp.issubdtype(leaf.dtype, jnp.floating)]


def jax_tree_grads(jr, probes, mode, select=None):
    """jax.grad of the frame's MSE against a black image with respect to
    the float leaves (those whose index is in ``select``, else all), on
    whichever path MADARCH_FORCE_PALLAS picks when it traces."""
    screen, probe = cfgs(mode)
    floats, aux = jspmd.split_float_leaves(jr.scene_data)
    select = range(len(floats)) if select is None else select

    def loss(sub):
        fl = list(floats)
        for i, x in zip(select, sub):
            fl[i] = x
        img, _ = JPL.render_frame_impl(
            jr.spec, jax_config(probes), jr.volumetrics, SIZE, SIZE,
            jspmd.merge_float_leaves(aux, fl), jr.camera, jr.state,
            screen_cfg=jax_config(screen), probe_cfg=jax_config(probe))
        return jnp.mean(img ** 2)

    return [np.asarray(g) for g in jax.jit(jax.grad(loss))(
        [floats[i] for i in select])]


def port_tree_grads(tr, data, state, probes, mode):
    """The same gradient from the port's train step without its update
    (parallel/spmd.py:make_value_and_grad), as numpy leaves."""
    screen, probe = cfgs(mode)
    value_and_grad = tspmd.make_value_and_grad(
        tr.spec, probes, tr.volumetrics, SIZE, SIZE, screen_cfg=screen,
        probe_cfg=probe)
    _, grads, _ = value_and_grad(data, tr.camera, state,
                                 torch.zeros((SIZE, SIZE, 3)))
    return [g.numpy() for g in grads]


def rel_norm(a, b):
    """Relative norm of b's difference from a (b's norm when a is 0)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    na = np.linalg.norm(a)
    return np.linalg.norm(a - b) / na if na > 0 else np.linalg.norm(b)


def hold(names, ref, got, tol=1e-3):
    """Each leaf's relative norm under ``tol``."""
    rel = {n: rel_norm(a, b) for n, a, b in zip(names, ref, got)}
    bad = {n: r for n, r in rel.items() if not r < tol}
    assert not bad, bad


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_gi_gradient_tree_matches_jax_kernel_path(gi, monkeypatch, mode):
    """Every float leaf of the GI frame's loss gradient, in specular modes
    0 to 2, against the JAX package's kernel path (Pallas in interpret
    mode), which marches under stop gradient as the port does."""
    jr, tr, data, state = gi
    monkeypatch.setenv("MADARCH_FORCE_PALLAS", "1")
    ref = jax_tree_grads(jr, SPREAD, mode)
    hold(leaf_names(jr.scene_data), ref,
         port_tree_grads(tr, data, state, SPREAD, mode))


def test_gi_mode3_light_and_material_gradients_match_jax(gi, monkeypatch):
    """Mode 3 on the JAX kernel path, with respect to the light and
    material leaves only (its geometry gradient fails to linearize; the
    primitive leaves are held by finite differences in
    test_torch_differentiability.py and card against CPU in
    chip_smoke.py)."""
    jr, tr, data, state = gi
    names = leaf_names(jr.scene_data)
    select = [i for i, n in enumerate(names) if not n.startswith(".prims")]
    monkeypatch.setenv("MADARCH_FORCE_PALLAS", "1")
    ref = jax_tree_grads(jr, SPREAD, 3, select)
    got = port_tree_grads(tr, data, state, SPREAD, 3)
    hold([names[i] for i in select], ref, [got[i] for i in select])
