"""Port parity: meshes (madarch_tpu_torch/scene/mesh.py) against
madarch_tpu/scene/mesh.py, and the in-repo test mesh.

madarch_tpu_torch/examples/media/torus968.obj is regenerated here with
numpy and must equal the committed file byte for byte.  The port's
load_obj, morton_order and add_mesh_to_renderer must give arrays equal to
the JAX package's (no tolerance: the same parse and the same order).
"""
import jax
import numpy as np
import pytest

from madarch_tpu import native
from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.scene import mesh as jmesh
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.scene import mesh as tmesh

TORUS = tscenes.TORUS_OBJ


def torus_obj_text(major=0.8, minor=0.3, segments=22, tilt_deg=30.0):
    """A closed torus about the z axis, centred at the origin and turned
    ``tilt_deg`` about the x axis: ``segments``² vertices and
    2·``segments``² outward-wound triangles, as OBJ ``v`` and ``f``
    lines."""
    ang = 2.0 * np.pi * np.arange(segments) / segments
    u, v = np.meshgrid(ang, ang, indexing="ij")      # around major, minor
    ring = major + minor * np.cos(v)
    x, y, z = ring * np.cos(u), ring * np.sin(u), minor * np.sin(v)
    th = np.radians(tilt_deg)
    y, z = y * np.cos(th) - z * np.sin(th), y * np.sin(th) + z * np.cos(th)
    lines = [f"v {a:.6f} {b:.6f} {c:.6f}"
             for a, b, c in zip(x.ravel(), y.ravel(), z.ravel())]

    def vid(i, j):
        return (i % segments) * segments + (j % segments) + 1

    for i in range(segments):
        for j in range(segments):
            a, b = vid(i, j), vid(i + 1, j)
            c, d = vid(i + 1, j + 1), vid(i, j + 1)
            lines += [f"f {a} {b} {c}", f"f {a} {c} {d}"]
    return "\n".join(lines) + "\n"


def test_committed_torus_is_reproducible():
    with open(TORUS) as f:
        assert f.read() == torus_obj_text()


def test_torus_shape_and_winding():
    m = tmesh.load_obj(TORUS)
    assert m.vertices.shape == (484, 3) and m.num_triangles == 968
    tv = m.triangle_vertices().astype(np.float64)
    nrm = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    # outward: the face normal points away from the tube's centre line
    c = tv.mean(axis=1)
    th = np.radians(30.0)
    rot = np.array([[1, 0, 0], [0, np.cos(th), -np.sin(th)],
                    [0, np.sin(th), np.cos(th)]])
    local = c @ rot                   # back to the untilted frame
    core = local.copy()
    core[:, 2] = 0.0
    core *= (0.8 / np.linalg.norm(core, axis=1))[:, None]
    assert ((nrm @ rot) * (local - core)).sum(axis=1).min() > 0.0
    # every edge is shared by exactly two triangles: the surface is closed
    edges = np.sort(np.concatenate([m.triangles[:, [0, 1]],
                                    m.triangles[:, [1, 2]],
                                    m.triangles[:, [2, 0]]]), axis=1)
    _, n = np.unique(edges, axis=0, return_counts=True)
    assert (n == 2).all()
    lo, hi = m.bounding_box()
    np.testing.assert_allclose(lo + (1.5, 1.0, 1.0), (0.40, 0.02, 0.31),
                               atol=5e-3)
    np.testing.assert_allclose(hi + (1.5, 1.0, 1.0), (2.60, 1.98, 1.69),
                               atol=5e-3)


def test_load_obj_matches_jax():
    t = tmesh.load_obj(TORUS)
    for j in (native.load_obj(TORUS), jmesh.load_obj(TORUS)):
        for name in ("vertices", "normals", "triangles", "tri_normals"):
            a, b = getattr(t, name), getattr(j, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_load_obj_fans_polygons_and_reads_normals(tmp_path):
    path = tmp_path / "quad.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvn 0 0 1\n"
                    "f 1//1 2//1 3//1 4//1\nf 1/5 3/6 4/7\n")
    t, j = tmesh.load_obj(str(path)), jmesh.load_obj(str(path))
    assert t.num_triangles == 3
    for name in ("vertices", "normals", "triangles", "tri_normals"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))


def test_morton_order_matches_jax():
    rng = np.random.RandomState(5)
    for pts in (rng.randn(500, 3).astype(np.float32),
                tmesh.load_obj(TORUS).triangle_vertices().mean(axis=1),
                np.zeros((7, 3), np.float32)):
        np.testing.assert_array_equal(tmesh.morton_order(pts),
                                      jmesh.morton_order(pts))


@pytest.fixture(scope="module")
def mesh_renderers():
    """obj_mesh on the torus in both packages, 16², the default grid."""
    jr = jscenes.obj_mesh(width=16, height=16, obj_path=TORUS)
    tr = tscenes.obj_mesh(width=16, height=16, obj_path=TORUS, device="cpu")
    return jr, tr


def test_add_mesh_to_renderer_matches_jax(mesh_renderers):
    jr, tr = mesh_renderers
    jd = jax.tree.map(np.asarray, jr.scene_data)
    td = tr.scene_data
    assert tr.builder._prim_counts == {"triangle": 968}
    for name in ("v1", "v2", "v3", "material_id"):
        np.testing.assert_array_equal(td.prims["triangle"][name].numpy(),
                                      jd.prims["triangle"][name], name)
    assert tr.spec.live_prims == jr.spec.live_prims == (968,)


def test_obj_mesh_refuses_baked_mode_and_missing_file(tmp_path):
    """obj_mesh refuses a mode other than its exact and baked ones (the
    baked mode renders: tests/test_torch_baked_sdf.py) and a missing
    mesh file."""
    with pytest.raises(ValueError, match="baked"):
        tscenes.obj_mesh(width=8, height=8, obj_path=TORUS, mode="voxels",
                         device="cpu")
    with pytest.raises(FileNotFoundError, match="--obj"):
        tscenes.obj_mesh(width=8, height=8,
                         obj_path=str(tmp_path / "absent.obj"), device="cpu")


def test_dump_info_prints_jaxs_text(capsys):
    """Mesh.dump_info: the JAX package's text exactly (numpy's format of
    the box)."""
    jmesh.load_obj(TORUS).dump_info()
    want = capsys.readouterr().out
    tmesh.load_obj(TORUS).dump_info()
    got = capsys.readouterr().out
    assert got == want and got.startswith("mesh: 484 vertices, 968 "
                                          "triangles, bb [")
