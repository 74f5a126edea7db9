"""Port parity: madarch_tpu_torch/parallel/spmd.py (the train step on one
device, split_float_leaves and merge_float_leaves) against
madarch_tpu/parallel/spmd.py.

The JAX package's step runs on a 1-device mesh, its XLA path here; with
tests/test_spmd.py's shade config (mode 0, no AO) that path and the
port's kernel path differ in their gradients only by rounding.  The
probes are tests/test_spmd.py's tiles with the grid spread from 4 to 5 m
where a step is compared with JAX's: at 4 m the probe (4, 0, 4) sits
inside the room's box and the JAX package's primitive gradients are NaN
(tests/test_torch_differentiability.py); the port's step is finite there
too (test_train_step_runs_and_descends).

Tolerances (measured when set, this host): the loss to rtol 1e-4
(measured 4.2e-5: the XLA path marches the shadow and probe-visibility
rays itself, from points offset along its autodiff normal, where the
kernel path offsets along the kernel's FD normal), every updated float
leaf to 1e-6 absolute (measured 1.2e-7, an ulp of the box's half side
1.5).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.parallel import spmd as jspmd
from madarch_tpu_torch.core.config import (NO_VOLUMETRICS, ProbeSettings,
                                           ShadeConfig)
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.parallel import spmd as tspmd
from madarch_tpu_torch.render.pipeline import FrameState
from madarch_tpu_torch.scene.scene import (scene_data_from_numpy, tree_items,
                                           tree_leaves)
from test_torch_config import jax_config, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

# tests/test_spmd.py's probes and shade config
PROBES = ProbeSettings(radiance_resolution=8, irradiance_resolution=4,
                       probe_count=(4, 2), grid_dimensions=(2, 2, 2),
                       grid_spacing=(4.0, 4.0, 4.0))
SPREAD = dataclasses.replace(PROBES, grid_spacing=(5.0, 5.0, 5.0))
CFG = ShadeConfig(direct_specular=True, indirect_specular_mode=0,
                  add_indirect_specular=False, ambient_occlusion_steps=0,
                  render_volumetrics=False, max_march_steps=48)
LR = 0.05
SIZE = 16


def test_split_merge_float_leaves_roundtrip_in_jax_order():
    """The port's leaves come in jax.tree.flatten's order: the same count,
    shapes, kinds and values as the JAX package's leaves of the same
    scene, pair by pair, and merge_float_leaves puts the split back."""
    jr = jscenes.global_illumination(width=8, height=8)
    data = scene_data_from_numpy(jax.tree.map(np.asarray, jr.scene_data),
                                 "cpu")
    j_floats, j_aux = jspmd.split_float_leaves(jr.scene_data)
    floats, aux = tspmd.split_float_leaves(data)
    assert aux[2] == j_aux[2]
    j_leaves = jax.tree.leaves(jr.scene_data)
    leaves = tree_leaves(data)
    assert len(leaves) == len(j_leaves)
    # the same key paths: .prims['box']['center'] is prims.box.center
    j_paths = [jax.tree_util.keystr(path).replace("']['", ".")
               .replace("['", ".").replace("']", "").lstrip(".")
               for path, _ in jax.tree_util.tree_flatten_with_path(
                   jr.scene_data)[0]]
    assert [path for path, _ in tree_items(data)] == j_paths
    for a, b in zip(j_leaves, leaves):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(j_floats, floats):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())

    back = tspmd.merge_float_leaves(aux, floats)
    assert type(back) is type(data)
    for a, b in zip(leaves, tree_leaves(back)):
        assert a is b
    # the dicts keep their own key order, only the leaves are replaced
    assert list(back.prims) == list(data.prims)
    assert list(back.materials) == list(data.materials)


def test_train_step_runs_and_descends():
    """tests/test_spmd.py:test_train_step_runs_and_descends on the port,
    with the probe inside the box: two steps, finite, every float leaf
    finite, the albedo moved and the loss down."""
    r = tscenes.global_illumination(width=SIZE, height=SIZE, probes=PROBES,
                                    device="cpu")
    step = tspmd.make_train_step(r.spec, PROBES, NO_VOLUMETRICS, SIZE, SIZE,
                                 lr=LR, screen_cfg=CFG)
    target = torch.zeros((SIZE, SIZE, 3))
    data0 = r.scene_data
    loss0, data1, state1 = step(data0, r.camera, r.state, target)
    assert np.isfinite(float(loss0))
    assert all(bool(torch.isfinite(x).all())
               for x in tspmd.split_float_leaves(data1)[0])
    moved = float((data1.materials["albedo"]
                   - data0.materials["albedo"]).abs().max())
    assert moved > 0.0
    loss1, _, _ = step(data1, r.camera, state1, target)
    assert np.isfinite(float(loss1))
    assert float(loss1) < float(loss0)


def test_train_step_output_carries_no_graph():
    r = tscenes.global_illumination(width=8, height=8, probes=PROBES,
                                    device="cpu")
    step = tspmd.make_train_step(r.spec, PROBES, NO_VOLUMETRICS, 8, 8,
                                 screen_cfg=CFG)
    loss, data1, state1 = step(r.scene_data, r.camera, r.state,
                               torch.zeros((8, 8, 3)))
    tensors = [loss] + tree_leaves(data1) + [
        getattr(state1, f.name) for f in dataclasses.fields(FrameState)]
    assert not any(x.requires_grad for x in tensors)
    # integer leaves are passed through as they were
    before = tree_leaves(r.scene_data)
    for a, b in zip(before, tree_leaves(data1)):
        if not a.is_floating_point():
            assert a is b


def test_one_step_matches_jax():
    """One step of each package from the same scene and atlases (the JAX
    package's after one frame): the loss and every updated float leaf."""
    jr = jscenes.global_illumination(width=SIZE, height=SIZE,
                                     probes=jax_config(SPREAD))
    jr.converge(frames=1)
    mesh = jspmd.make_mesh(1)
    j_step = jspmd.make_train_step(jr.spec, jax_config(SPREAD),
                                   jr.volumetrics, SIZE, SIZE, mesh, lr=LR,
                                   screen_cfg=jax_config(CFG))
    data = scene_data_from_numpy(jax.tree.map(np.asarray, jr.scene_data),
                                 "cpu")
    state = FrameState.from_numpy(jax.tree.map(np.asarray, jr.state), "cpu")
    # the JAX step donates its data and state: hand it copies
    j_loss, j_data, _ = j_step(jax.tree.map(jnp.copy, jr.scene_data),
                               jr.camera, jax.tree.map(jnp.copy, jr.state),
                               jnp.zeros((SIZE, SIZE, 3), jnp.float32))
    tr = tscenes.global_illumination(width=SIZE, height=SIZE, probes=SPREAD,
                                     device="cpu")
    step = tspmd.make_train_step(tr.spec, SPREAD, NO_VOLUMETRICS, SIZE, SIZE,
                                 lr=LR, screen_cfg=CFG)
    loss, new, _ = step(data, tr.camera, state, torch.zeros((SIZE, SIZE, 3)))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-4)
    j_floats, _ = jspmd.split_float_leaves(j_data)
    floats, _ = tspmd.split_float_leaves(new)
    assert len(floats) == len(j_floats)
    for a, b in zip(j_floats, floats):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)


def test_init_distributed_without_environment_is_false(monkeypatch):
    """tests/test_spmd.py:test_init_distributed_is_guarded_noop on the
    port: no group, no arguments and no MASTER_ADDR/RANK/WORLD_SIZE."""
    for k in tspmd.ENV_VARS:
        monkeypatch.delenv(k, raising=False)
    assert not torch.distributed.is_initialized()
    assert tspmd.init_distributed() is False
    assert not torch.distributed.is_initialized()
    mesh = tspmd.make_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank) == (1, 0)


@pytest.mark.parametrize("n,world", [(12, 3), (11, 3), (1, 4), (9, 1)])
def test_pad_share_unpad(n, world):
    """Zero padding to a multiple of the world size, contiguous shares in
    rank order that cover the padded batch, and unpad back to the true
    count (no process group needed)."""
    arr = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3) + 1.0
    shares = []
    for rank in range(world):
        s = tspmd.RaySharder(tspmd.Mesh(world, rank, torch.device("cpu")))
        padded = s.pad(arr)
        assert padded.shape[0] % world == 0
        assert padded.shape[0] - n < world
        assert torch.equal(padded[:n], arr) and not bool(padded[n:].any())
        shares.append(s.share(arr))
    assert len({x.shape for x in shares}) == 1
    assert torch.equal(torch.cat(shares), padded)
    assert torch.equal(s.unpad(padded, n), arr)
    assert s.unpad(arr, n) is arr


def test_a_world_of_one_skips_the_sharder():
    """make_sharded_render on a world of 1 renders without a sharder, the
    very frame of render_frame."""
    from madarch_tpu_torch.render.pipeline import render_frame
    r = tscenes.global_illumination(width=8, height=8, probes=PROBES,
                                    device="cpu")
    mesh = tspmd.make_mesh(device="cpu")
    run = tspmd.make_sharded_render(r.spec, PROBES, NO_VOLUMETRICS, 8, 8,
                                    mesh, screen_cfg=CFG)
    assert run.sharder is None
    img, _ = run(r.scene_data, r.camera, r.state)
    ref, _ = render_frame(r.spec, PROBES, NO_VOLUMETRICS, 8, 8,
                          r.scene_data, r.camera, r.state, screen_cfg=CFG)
    assert torch.equal(img, ref)
