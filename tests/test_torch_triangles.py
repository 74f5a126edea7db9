"""Port parity: triangles (madarch_tpu_torch's Triangle primitive, the
triangle table of ops/march.py and the plain marches over it) against
madarch_tpu.

- The primitive: sdf, sdf_planar, derive and sdf_planar_derived against
  the JAX package's on seeded triangles (a quarter of them degenerate:
  collinear or repeated vertices) and points, to 1e-6 absolute or
  relative: both packages run the same float32 arithmetic, and XLA's CPU
  backend may fuse multiply-adds that the port rounds one by one.
- The plain versions of the kernels (geometry_reference,
  raycast_reference, visibility_reference, softshadows_reference) on
  test_march_kernels.build_chunked_scene() (80 and 200 triangles and a
  plane) and on the in-repo torus as obj_mesh places it (968 triangles),
  against the JAX package's unculled XLA marches (render/raymarch.py)
  over scene_sdf and scene_sdf_info: hit, visibility, the blocked set of
  the penumbras, idx and mid equal; t and the penumbra factors to 1e-5
  relative or absolute (a miss's t only past max_dist on both, and at
  max_dist exactly on the port's side on the torus, whose scene packs a
  box-exit cap); the
  primary normal, which the JAX package takes by autodiff, to 2e-3 (1e-4
  on average, NORMAL_ATOL says why) against a tetrahedron FD of its
  scene_sdf computed here.
- The same plain version against the JAX package's pallas_geometry in
  interpret mode on the chunked plan, with the JAX package's own chunked
  tolerances (at least 98% of hits agree, t within 5e-3 on rays both
  hit): that kernel's culling moves march steps.
- The vectorised emulation of exact pruning (what the bound counts)
  gives the unpruned minimum on every point, and the count equals one
  made in numpy.
Rays and points are made with numpy from seeds and handed to both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.ops import march as JM
from madarch_tpu.render import raymarch as jrm
from madarch_tpu.scene import primitives as JP
from madarch_tpu.scene.scene import primitive_material_id, scene_sdf, \
    scene_sdf_info
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.ops import march as TM
from madarch_tpu_torch.render.raymarch import SURFACE_OFFSET
from madarch_tpu_torch.scene import primitives as TP
from madarch_tpu_torch.scene.scene import scene_data_from_numpy
from test_march_kernels import build_chunked_scene, rand_rays
from test_torch_config import torch_threads  # noqa: F401
from test_torch_march import port_spec

pytestmark = pytest.mark.usefixtures("torch_threads")

TOL = dict(rtol=1e-5, atol=1e-5)
PRIM_TOL = dict(rtol=1e-6, atol=1e-6)
# The tetrahedron FD normal divides distance differences by 2e-3; the
# port's derived triangle form and the JAX package's vector form differ in
# the last bits of a triangle's distance (~1e-7 of |p - v1|), so normals
# differ by up to ~1e-3 (and by 1e-4 on average).
NORMAL_ATOL = 2e-3
TET = np.array([(1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0),
                (1.0, 1.0, 1.0)], np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# The primitive
# ---------------------------------------------------------------------------

def _triangles(n=32, seed=13):
    rng = np.random.RandomState(seed)
    v = (rng.randn(n, 3, 3) * 1.5).astype(np.float32)
    v[::8, 2] = v[::8, 1]                              # repeated vertex
    v[1::8, 2] = v[1::8, 0]
    v[2::8, 2] = 2.0 * v[2::8, 1] - v[2::8, 0]         # collinear
    v[3::8] = v[3::8, :1]                              # a point
    pts = (rng.randn(64, 3) * 2.5).astype(np.float32)
    return v, pts


def _params(v, lib):
    return {"v1": lib(v[:, 0]), "v2": lib(v[:, 1]), "v3": lib(v[:, 2]),
            "material_id": lib(np.zeros(len(v), np.int32))}


def _scalars(fields, arrs, i, lib):
    s = {}
    for name, kind in fields:
        if name == "material_id":
            continue
        if kind == "vec3":
            for j, ax in enumerate("xyz"):
                s[f"{name}_{ax}"] = lib(np.asarray(arrs[name])[i, j])
        else:
            s[name] = lib(np.asarray(arrs[name])[i])
    return s


def test_triangle_sdf_matches_jax():
    v, pts = _triangles()
    j = jax.vmap(lambda p: jax.vmap(lambda prm: JP.Triangle.sdf(prm, p))(
        _params(v, jnp.asarray)))(jnp.asarray(pts))
    t = TP.Triangle.sdf(_params(v, torch.as_tensor),
                        torch.as_tensor(pts)[:, None, :])
    assert t.shape == (64, 32)
    np.testing.assert_allclose(_np(t), np.asarray(j), **PRIM_TOL)


def test_triangle_bounds_and_derive_match_jax():
    v, _ = _triangles()
    jlo, jhi = JP.Triangle.bounds(_params(v, jnp.asarray))
    tlo, thi = TP.Triangle.bounds(_params(v, torch.as_tensor))
    np.testing.assert_array_equal(_np(tlo), np.asarray(jlo))
    np.testing.assert_array_equal(_np(thi), np.asarray(jhi))
    jd = JP.Triangle.derive(_params(v, jnp.asarray))
    td = TP.Triangle.derive(_params(v, torch.as_tensor))
    assert TP.Triangle.derived_fields == JP.Triangle.derived_fields
    for name, _ in TP.Triangle.derived_fields:
        a, b = _np(td[name]), np.asarray(jd[name])
        if name.startswith("i"):
            # 1/|e|²: above 1e10 on both for a degenerate edge or normal
            # (1e30 at an exact zero, which rounding may miss)
            flat = b > 1e10
            assert (a[flat] > 1e10).all(), name
            np.testing.assert_allclose(a[~flat], b[~flat], rtol=1e-6,
                                       err_msg=name)
        elif name in ("nor", "n21", "n32", "n13"):
            # cross products: relative to the field's scale (a degenerate
            # triangle's normal is a cancellation XLA fuses into FMAs)
            np.testing.assert_allclose(a, b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max(),
                                       err_msg=name)
        else:
            np.testing.assert_allclose(a, b, err_msg=name, **PRIM_TOL)


@pytest.mark.parametrize("form", ["planar", "planar_derived"])
def test_triangle_planar_forms_match_jax(form):
    v, pts = _triangles()
    jd = JP.Triangle.derive(_params(v, jnp.asarray))
    td = TP.Triangle.derive(_params(v, torch.as_tensor))
    jpx, jpy, jpz = (jnp.asarray(pts[:, k]) for k in range(3))
    tpx, tpy, tpz = (torch.as_tensor(pts[:, k]) for k in range(3))
    for i in range(len(v)):
        if form == "planar":
            fields = JP.Triangle.fields
            j = JP.Triangle.sdf_planar(
                _scalars(fields, _params(v, np.asarray), i, jnp.asarray),
                jpx, jpy, jpz)
            t = TP.Triangle.sdf_planar(
                _scalars(fields, _params(v, np.asarray), i, torch.as_tensor),
                tpx, tpy, tpz)
        else:
            fields = JP.Triangle.derived_fields
            j = JP.Triangle.sdf_planar_derived(
                _scalars(fields, jd, i, jnp.asarray), jpx, jpy, jpz)
            t = TP.Triangle.sdf_planar_derived(
                _scalars(fields, {k: _np(x) for k, x in td.items()}, i,
                         torch.as_tensor), tpx, tpy, tpz)
        np.testing.assert_allclose(_np(t), np.asarray(j), err_msg=str(i),
                                   **PRIM_TOL)


def test_triangle_forms_agree_within_the_port():
    """The vector, planar and derived forms of the port agree (the kernel
    evaluates the derived one, the partitioning grid the vector one)."""
    v, pts = _triangles()
    vec = TP.Triangle.sdf(_params(v, torch.as_tensor),
                          torch.as_tensor(pts)[:, None, :])
    td = {k: _np(x) for k, x in
          TP.Triangle.derive(_params(v, torch.as_tensor)).items()}
    p = [torch.as_tensor(pts[:, k:k + 1]) for k in range(3)]
    planar = TP.Triangle.sdf_planar(_scalars(
        TP.Triangle.fields, _params(v, np.asarray),
        slice(None), torch.as_tensor), *p)
    derived = TP.Triangle.sdf_planar_derived(_scalars(
        TP.Triangle.derived_fields, td, slice(None), torch.as_tensor), *p)
    torch.testing.assert_close(planar, vec, rtol=0, atol=0)
    torch.testing.assert_close(derived, vec, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The triangle table
# ---------------------------------------------------------------------------

def _port(jspec, jdata):
    tdata = scene_data_from_numpy(jax.tree.map(np.asarray, jdata), "cpu")
    return port_spec(jspec), tdata


def test_triangle_table_layout():
    """Derived constants per slot, chunk-major with a triangle's float4
    rows CHUNK apart; global index and material id in the info table after
    the slots'; chunk boxes hold their slots' vertices, super-chunk boxes
    their chunks; columns keep spec order."""
    jspec, jdata = build_chunked_scene(n_tris=80)
    tspec, tdata = _port(jspec, jdata)
    packed = TM.pack_scene(tspec, tdata)
    assert packed.n_chunks == 10 and packed.n_supers == 2
    assert packed.chunks.shape == (10, TM.TRI_ROWS, TM.CHUNK, 4)
    assert packed.n_slots == 1 and packed.n_columns == 81
    # triangle 8·c + j's float4 row k sits at tris[c, k, j]
    tris = packed.triangle_rows().numpy()
    np.testing.assert_array_equal(
        tris.reshape(10, TM.CHUNK, TM.TRI_ROWS, 4),
        packed.chunks.numpy().transpose(0, 2, 1, 3))
    # the plane's slot first (gidx 80), then the triangle slots
    np.testing.assert_array_equal(packed.info[:, 0].numpy(),
                                  [80] + list(range(80)))
    np.testing.assert_array_equal(packed.chunk_live.numpy(), 1.0)
    np.testing.assert_array_equal(packed.col_gidx.numpy(),
                                  list(range(80)) + [80])
    jd = JP.Triangle.derive(jax.tree.map(lambda a: a[:80],
                                         jdata.prims["triangle"]))
    col = 0
    for name, kind in TP.Triangle.derived_fields[:-1]:
        width = 3 if kind == "vec3" else 1
        np.testing.assert_allclose(
            tris[:, col:col + width].reshape(np.asarray(jd[name]).shape),
            np.asarray(jd[name]), err_msg=name, **PRIM_TOL)
        col += width
    boxes = packed.aabbs.numpy()
    assert boxes.shape == (1 + 2 + 10, 8)
    assert (boxes[1:, 3] == 0).all() and (boxes[1:, 7] == 0).all()
    scale = 1.0 + max(np.abs(np.asarray(jdata.prims["triangle"][k][:80]))
                      .max() for k in ("v1", "v2", "v3"))
    np.testing.assert_allclose(boxes[0, 0], scale)
    sup = boxes[1:3][:, [0, 1, 2, 4, 5, 6]]
    chunks = boxes[3:][:, [0, 1, 2, 4, 5, 6]]
    verts = np.stack([np.asarray(jdata.prims["triangle"][k][:80])
                      for k in ("v1", "v2", "v3")], axis=1)
    for c in range(10):
        vs = verts[c * 8:(c + 1) * 8].reshape(-1, 3)
        np.testing.assert_array_equal(chunks[c, :3], vs.min(0))
        np.testing.assert_array_equal(chunks[c, 3:], vs.max(0))
    np.testing.assert_array_equal(sup[1, :3], chunks[8:, :3].min(0))
    np.testing.assert_array_equal(sup[1, 3:], chunks[8:, 3:].max(0))


def test_dead_and_padded_triangle_slots_are_inert():
    """Dynamic counts: dead slots carry live 0, hold the inert triangle
    and leave their chunk's box; a chunk of dead or padded slots has the
    inert box (BIG, -BIG)."""
    jspec, jdata = build_chunked_scene(n_tris=80)
    tspec, tdata = _port(jspec, jdata)
    tspec = tspec.__class__(prims=tspec.prims, lights=tspec.lights,
                            max_dist=tspec.max_dist)
    tdata.prim_counts["triangle"] = torch.tensor(13, dtype=torch.int32)
    packed = TM.pack_scene(tspec, tdata)
    assert packed.n_chunks == 10 and packed.chunk_live.shape[0] == 80
    np.testing.assert_array_equal(packed.chunk_live.numpy(),
                                  [1.0] * 13 + [0.0] * 67)
    dead = packed.triangle_rows().numpy()[13:]
    assert (dead[:, 0] == TM.DEAD_TRIANGLE_X).all() and not dead[:, 1:].any()
    chunks = packed.aabbs.numpy()[3:][:, [0, 1, 2, 4, 5, 6]]
    assert (chunks[2:, :3] == TM.BIG).all() and (chunks[2:, 3:] ==
                                                 -TM.BIG).all()
    verts = np.stack([np.asarray(jdata.prims["triangle"][k][8:13])
                      for k in ("v1", "v2", "v3")], axis=1).reshape(-1, 3)
    np.testing.assert_array_equal(chunks[1, :3], verts.min(0))
    o, d = (torch.as_tensor(np.array(x)) for x in rand_rays(64, seed=61))
    # dead slots never win: the scene is the 13 live triangles and a plane
    d13 = TM.scene_dist(packed, o, 20.0)
    live_spec = tspec.specialized({"triangle": 13, "plane": 1},
                                  {"point_light": 1})
    d_live = TM.scene_dist(TM.pack_scene(live_spec, tdata), o, 20.0)
    torch.testing.assert_close(d13, d_live, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Marches against the JAX package's unculled XLA marches
# ---------------------------------------------------------------------------

def _mesh_rays(jr, n, seed):
    """Seeded rays from the camera and from the probe positions toward
    points in the mesh's bounding box."""
    rng = np.random.RandomState(seed)
    v = np.asarray(jr.scene_data.prims["triangle"]["v1"])[:968]
    lo, hi = v.min(0), v.max(0)
    probes = jr.probes
    gx, gy, gz = probes.grid_dimensions
    sp = np.asarray(probes.grid_spacing, np.float32)
    idx = np.stack(np.meshgrid(np.arange(gx), np.arange(gy), np.arange(gz),
                               indexing="ij"), -1).reshape(-1, 3)
    starts = np.concatenate([np.asarray(jr.camera_position)[None],
                             idx * sp]).astype(np.float32)
    o = starts[rng.randint(0, len(starts), n)]
    o[: n // 2] = np.asarray(jr.camera_position)
    target = lo + rng.rand(n, 3).astype(np.float32) * (hi - lo)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


SCENES = ["tris80", "tris200", "torus"]


@pytest.fixture(scope="module", params=SCENES)
def tri_scene(request):
    """(name, jax spec, jax data, port spec, port data, origins, dirs)."""
    name = request.param
    if name == "torus":
        jr = jscenes.obj_mesh(width=16, height=16, obj_path=tscenes.TORUS_OBJ)
        jspec, jdata = jr.spec, jr.scene_data
        o, d = _mesh_rays(jr, 96, seed=71)
    else:
        jspec, jdata = build_chunked_scene(n_tris=int(name[4:]))
        o, d = (np.array(x) for x in rand_rays(128, seed=72))
    tspec, tdata = _port(jspec, jdata)
    return name, jspec, jdata, tspec, tdata, o, d


def _assert_t_close(got, ref, max_dist, capped):
    """t to TOL where either march stopped under max_dist; a miss past
    max_dist on both otherwise (its overshoot is the last step, ω·d at a
    far point, where the two SDF forms' last bits differ), and at exactly
    max_dist on the port's side where its scene packs a box-exit cap
    (``capped``: the torus; the JAX XLA march has none)."""
    got, ref = _np(got), np.asarray(ref)
    near = (got < max_dist) | (ref < max_dist)
    np.testing.assert_allclose(got[near], ref[near], **TOL)
    assert (got[~near] >= max_dist).all() and (ref[~near] >= max_dist).all()
    if capped:
        assert (got[~near] == max_dist).all()


def _jax_sdf(jspec, jdata, cap=None):
    """JAX's batched scene_sdf, capped at the spec's max_dist or at cap
    (the port's visibility and penumbra marches cap at VIS_CAP)."""
    if cap is not None:
        jspec = dataclasses.replace(jspec, max_dist=cap)
    return jax.jit(jax.vmap(lambda p: scene_sdf(jspec, jdata, p)))


def test_raycast_reference_matches_xla(tri_scene):
    name, jspec, jdata, tspec, tdata, o, d = tri_scene
    jt, jhit, _ = jrm.raycast(_jax_sdf(jspec, jdata), jnp.asarray(o),
                              jnp.asarray(d), jspec.max_dist)
    packed = TM.pack_scene(tspec, tdata)
    tt, thit, _ = TM.raycast(packed, torch.as_tensor(o), torch.as_tensor(d),
                             tspec.max_dist)
    np.testing.assert_array_equal(_np(thit), np.asarray(jhit))
    assert (packed.cap_margin is not None) == (name == "torus")
    _assert_t_close(tt, jt, tspec.max_dist, packed.cap_margin is not None)
    assert _np(thit).mean() > (0.6 if name == "torus" else 0.2)


def test_geometry_reference_primary_matches_xla(tri_scene):
    """t, hit, idx and mid of the plain geometry pass against JAX's
    raycast and scene_sdf_info; its FD normal against a tetrahedron FD of
    JAX's scene_sdf at the same points."""
    name, jspec, jdata, tspec, tdata, o, d = tri_scene
    sdf = _jax_sdf(jspec, jdata)
    jt, jhit, jpos = jrm.raycast(sdf, jnp.asarray(o), jnp.asarray(d),
                                 jspec.max_dist)
    _, jidx = jax.vmap(lambda p: scene_sdf_info(jspec, jdata, p))(jpos)
    jmid = primitive_material_id(jspec, jdata, jidx)
    jhit = np.asarray(jhit)
    packed = TM.pack_scene(tspec, tdata)
    lpos, n_lights = TM.pack_light_positions(tspec, tdata)
    g = TM.geometry(packed, lpos, n_lights, torch.as_tensor(o),
                    torch.as_tensor(d), tspec.max_dist,
                    probe_spacing=(2.0, 3.0, 3.0), probe_dims=(3, 3, 4),
                    surface_offset=SURFACE_OFFSET, ao_steps=3)
    np.testing.assert_array_equal(_np(g["hit"]), jhit)
    np.testing.assert_array_equal(_np(g["idx"])[jhit], np.asarray(jidx)[jhit])
    np.testing.assert_array_equal(_np(g["mid"])[jhit], np.asarray(jmid)[jhit])
    _assert_t_close(g["t"], jt, tspec.max_dist,
                    packed.cap_margin is not None)
    pos = np.asarray(jpos)
    h = TM.NORMAL_H
    f = [np.asarray(sdf(jnp.asarray(pos + h * k))) for k in TET]
    gx = f[0] - f[1] - f[2] + f[3]
    gy = -f[0] - f[1] + f[2] + f[3]
    gz = -f[0] + f[1] - f[2] + f[3]
    n = np.stack([gx, gy, gz], -1)
    n /= np.sqrt((n * n).sum(-1) + 1e-24)[:, None]
    err = np.abs(_np(g["normal"])[jhit] - n[jhit])
    assert err.max() < NORMAL_ATOL and err.mean() < NORMAL_ATOL / 10
    assert jhit.mean() > 0.2


def test_visibility_reference_matches_xla(tri_scene):
    name, jspec, jdata, tspec, tdata, o, d = tri_scene
    mx = np.random.RandomState(73).uniform(-1.0, 20.0, len(o)).astype(
        np.float32)
    jv = jrm.raycast_visibility(_jax_sdf(jspec, jdata, TM.VIS_CAP),
                                jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(mx))
    packed = TM.pack_scene(tspec, tdata)
    tv = TM.visibility(packed, torch.as_tensor(o), torch.as_tensor(d),
                       torch.as_tensor(mx))
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    assert 0.0 < _np(tv).mean() < 1.0


@pytest.mark.parametrize("k", [64.0, 0.5])
def test_softshadows_reference_matches_xla(tri_scene, k):
    """Penumbras from 0 to 20 (the scene's max_dist) at k = 64 and 0.5:
    the unculled march, with no margin below max_dist/k."""
    name, jspec, jdata, tspec, tdata, o, d = tri_scene
    rng = np.random.RandomState(74)
    mn = rng.uniform(0.0, 0.5, len(o)).astype(np.float32)
    mx = rng.uniform(0.0, 20.0, len(o)).astype(np.float32)
    js = jrm.softshadows(_jax_sdf(jspec, jdata, TM.VIS_CAP), jnp.asarray(o),
                         jnp.asarray(d), jnp.asarray(mn), jnp.asarray(mx), k)
    packed = TM.pack_scene(tspec, tdata)
    ts = TM.softshadows(packed, torch.as_tensor(o), torch.as_tensor(d),
                        torch.as_tensor(mn), torch.as_tensor(mx), k)
    np.testing.assert_array_equal(_np(ts) == 0.0, np.asarray(js) == 0.0)
    np.testing.assert_allclose(_np(ts), np.asarray(js), **TOL)
    assert (_np(ts) == 0.0).any() and ((_np(ts) > 0) & (_np(ts) < 1)).any()


def test_pruning_emulation_gives_the_unpruned_minimum(tri_scene):
    """On march-like points (along the rays, near and far from the
    surface), the minimum over the admitted chunks equals the minimum over
    every triangle, and the admitted work is a fraction of the unculled.
    The count (inside counting() only) equals one made here: per point
    every super-chunk box, the chunk boxes of the admitted super-chunks
    and the live triangles of the admitted chunks."""
    name, jspec, jdata, tspec, tdata, o, d = tri_scene
    packed = TM.pack_scene(tspec, tdata)
    ts = np.linspace(0.0, 12.0, 25, dtype=np.float32)
    p = torch.as_tensor((o[None] + ts[:, None, None] * d[None])
                        .reshape(-1, 3))
    with TM.counting():
        full = TM.scene_dist(packed, p, tspec.max_dist)
    counted = dict(TM.pruned_evals)
    TM.scene_dist(packed, p, tspec.max_dist)
    assert TM.pruned_evals == counted
    n_tri = packed.chunk_live.shape[0]
    assert TM.scene_evals[TM.TRIANGLE_CODE] == 2 * p.shape[0] * n_tri

    pts, b = _np(p), _np(packed.aabbs)
    ns, nc = packed.n_supers, packed.n_chunks
    lim = _np(full) + np.float32(TM.PRUNE_REL) * (
        b[0, 0] + np.abs(pts[:, 0]) + np.abs(pts[:, 1]) + np.abs(pts[:, 2]))

    def within(boxes):
        g = np.maximum(np.maximum(boxes[None, :, :3] - pts[:, None],
                                  pts[:, None] - boxes[None, :, 3:]), 0.0)
        return g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] \
            + g[..., 2] * g[..., 2] <= (lim * lim)[:, None]

    boxes = b[1:][:, [0, 1, 2, 4, 5, 6]]
    sup = within(boxes[:ns])
    chunk = within(boxes[ns:]) & sup[:, np.arange(nc) // TM.SUPER]
    live = _np(packed.chunk_live).reshape(nc, TM.CHUNK).sum(1)
    per_super = np.bincount(np.arange(nc) // TM.SUPER)
    assert counted == {
        "aabb": len(pts) * ns + int((sup * per_super).sum()),
        "triangles": int((chunk * live).sum()), "spheres": 0, "boxes": 0}
    assert counted["aabb"] < len(pts) * (ns + nc)
    assert 0 < counted["triangles"] < 0.5 * len(pts) * n_tri
    with TM.counting():
        TM.scene_dist(packed, p, tspec.max_dist)
        assert TM.scene_eval_flops() < TM.scene_eval_flops(pruned=False)
    pruned = TM.pruned_scene_dist(packed, p, tspec.max_dist)
    torch.testing.assert_close(pruned, full, rtol=0, atol=0)


def test_plain_versions_chunk_many_slot_scenes(monkeypatch):
    """Above CHUNK_SLOT_THRESHOLD columns the plain scene evaluation runs
    GRID_CHUNK points at a time, with the same results."""
    jspec, jdata = build_chunked_scene(n_tris=200)
    tspec, tdata = _port(jspec, jdata)
    packed = TM.pack_scene(tspec, tdata)
    p = torch.as_tensor(np.random.RandomState(75).uniform(
        -3.0, 6.0, (1000, 3)).astype(np.float32))
    whole = TM.scene_dist_info(packed, p, 20.0)
    monkeypatch.setattr(TM, "GRID_CHUNK", 96)
    calls = []
    real = TM._slot_dists
    monkeypatch.setattr(TM, "_slot_dists",
                        lambda *a: calls.append(1) or real(*a))
    for a, b in zip(TM.scene_dist_info(packed, p, 20.0), whole):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len(calls) == 11


def test_plain_geometry_against_interpret_mode_chunked_kernel():
    """The JAX package's Pallas geometry kernel on the chunked plan (in
    interpret mode) against the port's plain version: its culling moves
    the march, so the JAX package's chunked tolerances hold."""
    jspec, jdata = build_chunked_scene(n_tris=80)
    tspec, tdata = _port(jspec, jdata)
    o, d = (np.array(x) for x in rand_rays(64, seed=76))
    plan = JM.build_plan(jspec)
    assert {e.ptype.name: e.kind for e in plan.entries}["triangle"] == "c"
    kw = dict(probe_spacing=(2.0, 3.0, 3.0), probe_dims=(4, 3, 3),
              surface_offset=SURFACE_OFFSET, ao_steps=3)
    lpos, n_lights = JM.pack_light_positions(jspec, jdata)
    j = JM.pallas_geometry(plan, JM.pack_params(plan, jdata), lpos, n_lights,
                           jnp.asarray(o), jnp.asarray(d), jspec.max_dist,
                           **kw)
    packed = TM.pack_scene(tspec, tdata)
    tl, tn = TM.pack_light_positions(tspec, tdata)
    t = TM.geometry(packed, tl, tn, torch.as_tensor(o), torch.as_tensor(d),
                    tspec.max_dist, **kw)
    jhit, thit = np.asarray(j["hit"]), _np(t["hit"])
    assert (jhit == thit).mean() >= 0.98
    both = jhit & thit
    assert both.sum() > 10
    np.testing.assert_allclose(_np(t["t"])[both], np.asarray(j["t"])[both],
                               atol=5e-3)
    np.testing.assert_array_equal(_np(t["mid"])[both],
                                  np.asarray(j["mid"])[both])
