"""Port parity: the SAH BVH and the BVH-compiled scene SDF
(madarch_tpu_torch/scene/bvh.py) against madarch_tpu/scene/bvh.py, and the
bvh_test scene, which renders on the generic route.

- The tree: the port's numpy builder against the JAX package's, node for
  node (boxes, split axes, leaf indices), on tests/test_bvh.py's spheres
  and on bvh_test's 16 seeded ones.
- aabb_sdf and the compiled traversal at 4,096 seeded points against the
  JAX package's to 1e-6 absolute or relative (both take the same float32
  arithmetic; XLA's CPU backend may fuse multiply-adds the port rounds one
  by one; measured 9.5e-7 and 4.8e-7 absolute on distances up to 15);
  near the spheres exact and far away a lower bound, as
  tests/test_bvh.py holds the JAX package.
- bvh_test at 16² with the tiny probes and 8 spheres, two frames of each
  package's Renderer: the camera stands on the room's axis, so the
  room's four corner edges project onto the image diagonals, where the
  two walls' distances tie exactly and the last bits of each package's
  march decide which wall's normal a pixel takes (ROADMAP C3).  Off the
  diagonals every pixel agrees to 1e-4 (measured 2.0e-5); the whole image
  is held under the golden gates' mean.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madarch_tpu.core import config as JC
from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.scene import bvh as JB
from madarch_tpu_torch.core.config import ProbeSettings, screen_shade_config
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.ops import march as TM
from madarch_tpu_torch.render import raymarch as trm
from madarch_tpu_torch.scene import bvh as TB
from madarch_tpu_torch.utils.golden import GOLDEN_GATES, image_stats
from test_bvh import CENTERS, R, leaf_sdfs, sphere_boxes
from test_torch_config import jax_config, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

TINY = ProbeSettings(radiance_resolution=8, irradiance_resolution=4,
                     probe_count=(4, 2), grid_dimensions=(2, 2, 2),
                     grid_spacing=(4.0, 4.0, 4.0))
TOL = dict(rtol=1e-6, atol=1e-6)


def torch_leaf_sdfs(centers, radius):
    return [(lambda p, c=torch.tensor(c, dtype=torch.float32):
             torch.sqrt(((p - c) ** 2).sum(-1)) - radius) for c in centers]


def bvh_test_boxes(n_spheres=16, seed=7, radius=0.4):
    """bvh_test's seeded sphere boxes (examples/scenes.py)."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0.5, 5.5, (n_spheres, 3)).astype(np.float32)
    return [(c - radius, c + radius) for c in centers]


def _nodes(node):
    """The tree in depth-first order: (lo, hi, axis, leaf indices)."""
    out = []
    JB.visit(node, lambda n: out.append((n.lo, n.hi, n.axis,
                                         list(n.indices))),
             lambda n, left, right: None)
    inner = []
    JB.visit(node, lambda n: None,
             lambda n, left, right: inner.append((n.lo, n.hi, n.axis)))
    return out, inner


@pytest.mark.parametrize("boxes", ["test_bvh", "bvh_test"])
def test_tree_equals_jax_node_for_node(boxes):
    bb = sphere_boxes(CENTERS, R) if boxes == "test_bvh" \
        else bvh_test_boxes()
    jt, tt = JB.build_bvh(bb), TB.build_bvh(bb)
    (jl, ji), (tl, ti) = _nodes(jt), _nodes(tt)
    assert len(tl) == len(bb) and len(ti) == len(bb) - 1
    for a, b in zip(jl + ji, tl + ti, strict=True):
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    seen = []
    TB.visit(tt, lambda n: seen.extend(n.indices), lambda n, le, r: None)
    assert sorted(seen) == list(range(len(bb)))


def _points(n=4096, seed=3):
    return np.random.RandomState(seed).uniform(-8, 12, (n, 3)).astype(
        np.float32)


def test_aabb_sdf_matches_jax():
    lo = np.asarray([0.0, 0.0, 0.0])
    hi = np.asarray([2.0, 2.0, 2.0])
    assert float(TB.aabb_sdf(lo, hi, torch.tensor([[1.0, 1.0, 5.0]]))[0]) \
        == 2.0
    pts = _points()
    for lo, hi in bvh_test_boxes()[:4] + [(lo, hi)]:
        got = TB.aabb_sdf(lo, hi, torch.as_tensor(pts)).numpy()
        ref = np.asarray(JB.aabb_sdf(lo, hi, jnp.asarray(pts)))
        np.testing.assert_allclose(got, ref, **TOL)


def _traversals():
    bb = sphere_boxes(CENTERS, R)
    return (jax.jit(JB.bvh_sdf(JB.build_bvh(bb), leaf_sdfs())),
            TB.bvh_sdf(TB.build_bvh(bb), torch_leaf_sdfs(CENTERS, R)))


def _exact(pts):
    return np.min([np.linalg.norm(pts - np.asarray(c), axis=-1) - R
                   for c in CENTERS], axis=0)


def test_bvh_sdf_matches_jax_and_is_exact_near():
    jf, tf = _traversals()
    pts = _points()
    np.testing.assert_allclose(tf(torch.as_tensor(pts)).numpy(),
                               np.asarray(jf(jnp.asarray(pts))), **TOL)
    near = np.asarray([[0.0, 0.0, 0.6], [4.0, 0.0, 0.8], [2.0, 2.0, 4.3]],
                      np.float32)
    np.testing.assert_allclose(tf(torch.as_tensor(near)).numpy(),
                               _exact(near), atol=1e-5)


def test_bvh_sdf_is_conservative_far():
    _, tf = _traversals()
    pts = _points(seed=0)
    assert np.all(tf(torch.as_tensor(pts)).numpy() <= _exact(pts) + 1e-5)


def test_bvh_primitive_marches_and_has_a_normal():
    tree = TB.build_bvh(sphere_boxes(CENTERS, R))
    ptype = TB.make_bvh_primitive("bvh_scene", tree,
                                  torch_leaf_sdfs(CENTERS, R))
    params = {"position": torch.zeros(3), "material_id": torch.tensor(0)}
    t, hit, pos = trm.raycast(lambda p: ptype.sdf(params, p),
                              torch.tensor([[0.0, 0.0, -5.0]]),
                              torch.tensor([[0.0, 0.0, 1.0]]), 30.0)
    assert bool(hit[0])
    np.testing.assert_allclose(pos[0].numpy(), [0.0, 0.0, -0.5], atol=5e-3)
    with torch.no_grad():
        n = ptype.analytic_or_grad_normal(params,
                                          torch.tensor([0.0, 0.0, -0.5]))
    np.testing.assert_allclose(n.numpy(), [0.0, 0.0, -1.0], atol=1e-4)


def test_bvh_test_frame_matches_jax():
    jr = jscenes.bvh_test(width=16, height=16, probes=jax_config(TINY),
                          n_spheres=8)
    jr.screen_cfg = JC.screen_shade_config(False, max_march_steps=48)
    tr = tscenes.bvh_test(width=16, height=16, probes=TINY, n_spheres=8,
                          device="cpu")
    tr.screen_cfg = screen_shade_config(False, max_march_steps=48)
    assert not TM.kernel_scene(tr.spec)
    for _ in range(2):
        ref = np.asarray(jr.render())
        img = tr.render().numpy()
    diff = np.abs(img - ref).max(axis=-1)
    i, j = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    diagonal = (i == j) | (i + j == 15)
    assert diff[~diagonal].max() < 1e-4
    stats = image_stats(img, ref)
    assert stats["mean_absdiff"] < GOLDEN_GATES["mean_absdiff"], stats
    assert float(ref.var()) > 0.0


@pytest.mark.parametrize("boxes", ["test_bvh", "bvh_test"])
def test_dump_prints_jaxs_text(boxes, capsys):
    """BVHNode.dump: the JAX package's text exactly, a line a node."""
    bb = sphere_boxes(CENTERS, R) if boxes == "test_bvh" \
        else bvh_test_boxes()
    JB.build_bvh(bb).dump()
    want = capsys.readouterr().out
    TB.build_bvh(bb).dump(depth=1)
    assert capsys.readouterr().out == "".join(
        "  " + line + "\n" for line in want.splitlines())
    TB.build_bvh(bb).dump()
    got = capsys.readouterr().out
    assert got == want and got.count("\n") == 2 * len(bb) - 1
