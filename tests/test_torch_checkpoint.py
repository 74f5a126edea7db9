"""Port parity: madarch_tpu_torch/utils/checkpoint.py against
madarch_tpu/utils/checkpoint.py.

Both packages write the same entries for the same global_illumination
scene data, frame state and camera (tests/test_utils.py's
test_checkpoint_roundtrip, with the camera added), so a file saved by
either loads into the other, bit for bit.
"""
import os

import jax
import numpy as np
import pytest
import torch

from madarch_tpu.core.config import NO_VOLUMETRICS as J_NO_VOL
from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.render import pipeline as JPL
from madarch_tpu.utils import checkpoint as jckpt
from madarch_tpu_torch.core.config import NO_VOLUMETRICS, ProbeSettings
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.render.pipeline import Camera, initial_state
from madarch_tpu_torch.scene.scene import (SceneBuilder,
                                           scene_data_from_numpy,
                                           tree_leaves)
from madarch_tpu_torch.utils import checkpoint as tckpt
from test_torch_config import jax_config

PROBES = ProbeSettings(radiance_resolution=8, irradiance_resolution=4,
                       probe_count=(4, 2), grid_dimensions=(2, 2, 2),
                       grid_spacing=(4.0, 4.0, 4.0))


def _port_trees():
    r = tscenes.global_illumination(width=8, height=8, probes=PROBES,
                                    device="cpu")
    state = initial_state(PROBES, NO_VOLUMETRICS, "cpu")
    state.radiance = state.radiance + 0.5
    state.irradiance = torch.rand(state.irradiance.shape,
                                  generator=torch.Generator().manual_seed(0))
    r.set_camera_angles(0.3, -0.2)
    return r, {"scene": r.scene_data, "state": state, "camera": r.camera}


def _port_templates(r):
    return {"scene": r.base_spec.empty_data("cpu"),
            "state": initial_state(PROBES, NO_VOLUMETRICS, "cpu"),
            "camera": Camera(position=torch.zeros(3),
                             orientation=torch.zeros((3, 3)))}


def _jax_templates(jr):
    return {"scene": jr.spec.empty_data(),
            "state": JPL.initial_state(jax_config(PROBES), J_NO_VOL),
            "camera": JPL.Camera(position=np.zeros(3, np.float32),
                                 orientation=np.zeros((3, 3), np.float32))}


def _equal_leaves(port_tree, jax_tree):
    a, b = tree_leaves(port_tree), jax.tree.leaves(jax_tree)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        y = np.asarray(y)
        assert x.numpy().dtype == y.dtype
        np.testing.assert_array_equal(x.numpy(), y)


def test_key_paths_are_jaxs():
    r, trees = _port_trees()
    jr = jscenes.global_illumination(width=8, height=8,
                                     probes=jax_config(PROBES))
    for name, jtree in (("scene", jr.scene_data), ("state", jr.state),
                        ("camera", jr.camera)):
        want = ["/".join(str(k) for k in path) for path, _ in
                jax.tree_util.tree_flatten_with_path(jtree)[0]]
        assert [k for k, _ in tckpt.key_paths(trees[name])] == want


def test_round_trip(tmp_path):
    r, trees = _port_trees()
    path = os.path.join(tmp_path, "ckpt.npz")
    tckpt.save(path, **trees)
    back = tckpt.load(path, **_port_templates(r))
    for name, tree in trees.items():
        assert type(back[name]) is type(tree)
        for x, y in zip(tree_leaves(back[name]), tree_leaves(tree)):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
    assert int(back["scene"].prim_counts["plane"]) == 6
    # onto a device the caller names
    meta = tckpt.load(path, device="meta", **_port_templates(r))
    assert all(x.is_meta for t in meta.values() for x in tree_leaves(t))


def test_round_trip_into_a_builder_template(tmp_path):
    """A builder's snapshot serves as the scene's template as well as
    empty_data does."""
    r, trees = _port_trees()
    path = os.path.join(tmp_path, "ckpt.npz")
    tckpt.save(path, scene=trees["scene"])
    back = tckpt.load(path, scene=SceneBuilder(r.base_spec)
                      .device_data("cpu"))["scene"]
    for x, y in zip(tree_leaves(back), tree_leaves(trees["scene"]),
                    strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_empty_data_template_restores_a_jax_matching_scene(tmp_path):
    """The port saves the JAX package's GI scene (handed over by
    scene_data_from_numpy); its load with spec.empty_data("cpu") as the
    template gives JAX's leaves back, bit for bit."""
    jr = jscenes.global_illumination(width=8, height=8,
                                     probes=jax_config(PROBES))
    data = scene_data_from_numpy(jax.tree.map(np.asarray, jr.scene_data),
                                 "cpu")
    path = os.path.join(tmp_path, "scene.npz")
    tckpt.save(path, scene=data)
    r, _ = _port_trees()
    back = tckpt.load(path, scene=r.base_spec.empty_data("cpu"))["scene"]
    _equal_leaves(back, jr.scene_data)
    assert back.grid is None


def test_a_jax_file_loads_into_the_port(tmp_path):
    jr = jscenes.global_illumination(width=8, height=8,
                                     probes=jax_config(PROBES))
    jr.state.radiance = jr.state.radiance + 0.5
    jr.set_camera_angles(0.3, -0.2)
    path = os.path.join(tmp_path, "jax.npz")
    jckpt.save(path, scene=jr.scene_data, state=jr.state, camera=jr.camera)
    r, _ = _port_trees()
    back = tckpt.load(path, **_port_templates(r))
    _equal_leaves(back["scene"], jr.scene_data)
    _equal_leaves(back["state"], jr.state)
    _equal_leaves(back["camera"], jr.camera)


def test_a_port_file_loads_into_jax(tmp_path):
    r, trees = _port_trees()
    path = os.path.join(tmp_path, "port.npz")
    tckpt.save(path, **trees)
    jr = jscenes.global_illumination(width=8, height=8,
                                     probes=jax_config(PROBES))
    back = jckpt.load(path, **_jax_templates(jr))
    for name, tree in trees.items():
        _equal_leaves(tree, back[name])
    # the same entries and __meta__ as the JAX package's file of the trees
    jpath = os.path.join(tmp_path, "jax.npz")
    jckpt.save(jpath, **back)
    mine, theirs = np.load(path), np.load(jpath)
    assert sorted(mine.files) == sorted(theirs.files)
    assert bytes(mine["__meta__"]) == bytes(theirs["__meta__"])
    for k in mine.files:
        np.testing.assert_array_equal(mine[k], theirs[k])


@pytest.mark.parametrize("missing", ["scene", "camera"])
def test_a_missing_entry_raises(tmp_path, missing):
    r, trees = _port_trees()
    path = os.path.join(tmp_path, "part.npz")
    tckpt.save(path, **{k: v for k, v in trees.items() if k != missing})
    with pytest.raises(KeyError):
        tckpt.load(path, **_port_templates(r))
