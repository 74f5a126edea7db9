"""Port parity: baked distance-field primitives
(madarch_tpu_torch/scene/baked_sdf.py), voxelize and bake_distance_map of
madarch_tpu_torch/scene/mesh.py, and obj_mesh's baked mode, against
madarch_tpu.

- trilinear_sample: exact at the grid's nodes, and against the JAX
  package's at 4,096 seeded points, inside the grid and past its border,
  to 1e-6 absolute (measured 0: XLA's CPU backend may fuse the
  multiply-adds of the lerps on another host).
- The baked sphere against the analytic one (tests/test_baked_sdf.py's
  5e-3 at its 64 points) and against the JAX package's primitive at 4,096
  points inside and outside the grid's box, to 1e-6 (measured 2.4e-7).
- voxelize equal to the JAX package's, voxel for voxel.
- bake_distance_map on tests/test_baked_sdf.py's quad (17³) and on the
  in-repo torus (16³, 968 triangles) against the JAX package's: the
  distances to 1e-5 absolute (measured 0 and 3.0e-8), the back-face
  zeroing included (49% and 90% of the grid: the rule zeroes a point
  behind its closest face, and the face normal cross(v2 - v1, v1 - v3)
  points into the torus).  The normal is the chosen face's; where several
  faces are equally close (a shared vertex or edge: 8.2% of the torus's
  grid) the last bits choose, so there the port's face must be one the JAX
  package finds within 1e-5 of its closest distance.
- obj_mesh(mode="baked") on the torus at 16² (bake 16³, the scene's own
  tiny probes): two frames of each package's Renderer under the golden
  gates, mean_absdiff below 1e-4 (measured 1.0e-8, largest 3.6e-7).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.scene import baked_sdf as JBS
from madarch_tpu.scene import mesh as JMesh
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.ops import march as TM
from madarch_tpu_torch.scene import baked_sdf as TBS
from madarch_tpu_torch.scene import mesh as TMesh
from madarch_tpu_torch.utils.golden import image_stats
from test_baked_sdf import sphere_grid
from test_torch_config import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


def _points(n=4096, seed=5, lo=-2.5, hi=2.5):
    return np.random.RandomState(seed).uniform(lo, hi, (n, 3)).astype(
        np.float32)


def test_trilinear_exact_at_nodes_and_matches_jax():
    grid, lo, hi = sphere_grid()
    tg, tlo, thi = (torch.as_tensor(np.asarray(x, np.float32))
                    for x in (grid, lo, hi))
    v = TBS.trilinear_sample(tg, tlo, thi, torch.tensor(
        [[0.0, 0.0, 0.0], [2.0, 0.0, 0.0]]))
    np.testing.assert_allclose(v.numpy(), [-1.0, 1.0], atol=1e-5)
    pts = _points()
    got = TBS.trilinear_sample(tg, tlo, thi, torch.as_tensor(pts)).numpy()
    ref = np.asarray(JBS.trilinear_sample(jnp.asarray(grid), jnp.asarray(lo),
                                          jnp.asarray(hi), jnp.asarray(pts)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_baked_primitive_matches_analytic_and_jax():
    grid, lo, hi = sphere_grid(n=65)
    tp = TBS.make_baked_sdf_primitive("baked_sphere", grid, lo, hi)
    jp = JBS.make_baked_sdf_primitive("baked_sphere", grid, lo, hi)
    c = np.asarray([1.0, 2.0, 3.0], np.float32)
    # tests/test_baked_sdf.py's points
    pts = (np.random.RandomState(0).uniform(-1.5, 1.5, (64, 3))
           .astype(np.float32) + c)
    params = {"position": torch.as_tensor(c), "material_id": torch.tensor(0)}
    got = tp.sdf(params, torch.as_tensor(pts)).numpy()
    exact = np.linalg.norm(pts - c, axis=-1) - 1.0
    np.testing.assert_allclose(got, exact, atol=5e-3)
    near = _points(lo=-1.5, hi=1.5) + c
    far = _points(lo=-4.0, hi=4.0) + c
    jparams = {"position": jnp.asarray(c), "material_id": jnp.int32(0)}
    for p in (near, far):
        ref = np.asarray(jp.sdf(jparams, jnp.asarray(p)))
        np.testing.assert_allclose(
            tp.sdf(params, torch.as_tensor(p)).numpy(), ref, rtol=0,
            atol=1e-6)


def _quad():
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]],
                       np.float32)
    tris = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, tris


def _meshes(name):
    if name == "quad":
        verts, tris = _quad()
        mk = dict(vertices=verts, normals=np.zeros((0, 3), np.float32),
                  triangles=tris, tri_normals=np.zeros_like(tris))
        return (TMesh.Mesh(**mk), JMesh.Mesh(**mk),
                (17, 17, 17), (-0.5, -0.5, -1.0), (1.5, 1.5, 1.0))
    tm = TMesh.load_obj(tscenes.TORUS_OBJ)
    jm = JMesh.Mesh(vertices=tm.vertices, normals=tm.normals,
                    triangles=tm.triangles, tri_normals=tm.tri_normals)
    lo, hi = tm.bounding_box()
    margin = 0.1 * float(np.max(hi - lo))
    return tm, jm, (16, 16, 16), lo - margin, hi + margin


@pytest.mark.parametrize("name", ["quad", "torus"])
def test_voxelize_equals_jax(name):
    tm, jm, dims, lo, hi = _meshes(name)
    for box in ((None, None), (lo, hi)):
        np.testing.assert_array_equal(TMesh.voxelize(tm, dims, *box),
                                      JMesh.voxelize(jm, dims, *box))


@pytest.mark.parametrize("name", ["quad", "torus"])
def test_bake_distance_map_matches_jax(name):
    tm, jm, dims, lo, hi = _meshes(name)
    d, n = TMesh.bake_distance_map(tm, dims, lo, hi, device="cpu")
    jd, jn = (np.asarray(x) for x in JMesh.bake_distance_map(jm, dims, lo,
                                                             hi))
    assert d.shape == dims and n.shape == dims + (3,)
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-5)
    assert (d > 0).any() and (d == 0).any()
    # where the bakes chose faces of other normals, the port's face is one
    # of those the JAX package finds equally close (a shared vertex or
    # edge): the JAX package's distance to it within 1e-5 of its minimum
    n, jn = n.reshape(-1, 3), jn.reshape(-1, 3)
    other = np.abs(n - jn).max(axis=-1) > 1e-6
    xs = [np.linspace(lo[i], hi[i], dims[i], dtype=np.float32)
          for i in range(3)]
    pts = np.stack(np.meshgrid(*xs, indexing="ij"), -1).reshape(-1, 3)
    tv = jnp.asarray(jm.triangle_vertices())
    d2s, _, nns = jax.vmap(lambda t: JMesh._triangle_dist_and_closest(
        t[0], t[1], t[2], jnp.asarray(pts[other])))(tv)
    dist = np.sqrt(np.asarray(d2s))                           # [T, M]
    close = dist <= dist.min(axis=0) + 1e-5
    same = np.abs(np.asarray(nns)[:, None] - n[other][None]).max(-1) <= 1e-6
    assert (close & same).any(axis=0).all()


def test_obj_mesh_baked_frame_matches_jax():
    jr = jscenes.obj_mesh(width=16, height=16, obj_path=tscenes.TORUS_OBJ,
                          mode="baked", bake_dims=(16, 16, 16))
    tr = tscenes.obj_mesh(width=16, height=16, obj_path=tscenes.TORUS_OBJ,
                          mode="baked", bake_dims=(16, 16, 16),
                          device="cpu")
    assert not TM.kernel_scene(tr.spec)
    for _ in range(2):
        ref = np.asarray(jr.render())
        img = tr.render().numpy()
    stats = image_stats(img, ref)
    assert not stats["breached"], stats
    assert stats["mean_absdiff"] < 1e-4, stats
    assert float(ref.var()) > 0.0
