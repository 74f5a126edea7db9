"""Port parity: scenes past 48 KiB of staged tables, and the JAX package's
chunked layout for sphere and box types (madarch_tpu_torch/ops/march.py:
placement_for, chunked_layout, pack_scene; csrc/scene.cuh:chunk_min).

- Placement: a pure function of the staged bytes and the device's opt-in
  limit, at its edges; no size raises.  The wrapper's scene arguments
  carry it, and a forced placement that cannot hold the tables raises.
- The three large scenes of examples/large_scenes.py pack as planned: the
  3,500 spheres chunked (15,808 bytes of boxes: staged), 12,000 triangles
  (54,048 bytes: the opt-in), 65,000 triangles (292,544 bytes: device
  memory).
- A sphere or box type is chunked exactly where the JAX package's
  build_plan gives it kind "c" (8, 9, 64, 65, 200 slots, static and
  dynamic counts); its chunk and super-chunk boxes equal a numpy
  restatement over each chunk's live slots.
- On ~100 spheres, ~80 boxes and a plane (chunked in JAX) the port's
  plain versions against the JAX kernels in interpret mode, with the JAX
  package's chunked tolerances (tests/test_march_kernels.py: hit flags
  and visibility agree on at least 98% of rays, t within 5e-3 on rays
  both hit; its margin culling moves march steps, ROADMAP C2), and
  against the JAX package's unculled XLA marches to 1e-5 (the port is
  exact).  Pruning: the pruned minimum is the unpruned one bit for bit,
  in the lane groups' order too, for less counted work.
- A 16² frame of the sphere field and of a grid mesh against the JAX
  package's XLA path under the golden gates.
Rays are made with numpy from seeds and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madarch_tpu.core import config as JC
from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.ops import march as JM
from madarch_tpu.render import raymarch as jrm
from madarch_tpu.render.renderer import Renderer as JRenderer
from madarch_tpu.scene import lights as JL
from madarch_tpu.scene import primitives as JP
from madarch_tpu.scene.scene import SceneBuilder as JSceneBuilder
from madarch_tpu.scene.scene import SceneSpec as JSceneSpec
from madarch_tpu.scene.scene import scene_sdf
from madarch_tpu_torch.core.config import ProbeSettings, screen_shade_config
from madarch_tpu_torch.examples import large_scenes as LS
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.ops import march as TM
from madarch_tpu_torch.scene import lights as TL
from madarch_tpu_torch.scene import primitives as TP
from madarch_tpu_torch.scene.mesh import morton_order
from madarch_tpu_torch.scene.scene import SceneBuilder, SceneSpec
from madarch_tpu_torch.scene.scene import scene_sdf as tscene_sdf
from madarch_tpu_torch.utils.golden import image_stats
from test_torch_box_cap import GEOM, _np, _scene
from test_torch_config import jax_config, torch_threads  # noqa: F401
from test_torch_packing import _group_tri_min, _take
from test_torch_triangles import _port

pytestmark = pytest.mark.usefixtures("torch_threads")

# An H100's cudaDevAttrMaxSharedMemoryPerBlockOptin.
H100_OPTIN = 232_448
# The JAX package's chunked tolerances (tests/test_march_kernels.py): the
# share of rays whose hit flag (or visibility) must agree, and t on rays
# both hit.
CHUNK_AGREE = 0.98
CHUNK_T_ATOL = 5e-3
# The port against the JAX package's unculled XLA marches.
TOL = dict(rtol=1e-5, atol=1e-5)
FAST = ProbeSettings(radiance_resolution=8, irradiance_resolution=4,
                     probe_count=(4, 2), grid_dimensions=(2, 2, 2),
                     grid_spacing=(4.0, 4.0, 4.0))


@pytest.mark.parametrize("kernel, n_bytes, want", [
    ("geometry", 49_152, "staged"), ("geometry", 49_153, "optin"),
    ("geometry", 232_448, "optin"), ("geometry", 232_449, "global"),
    ("geometry", 10 ** 10, "global"), ("geometry", 0, "staged"),
    ("raycast", 49_152, "staged"), ("visibility", 49_153, "global"),
    ("softshadows", 232_448, "global")])
def test_placement_at_its_edges(kernel, n_bytes, want):
    """The geometry kernel takes the opt-in past 48 KiB, the march kernels
    device memory (ops/march.py:OPTIN_KERNELS)."""
    assert TM.placement_for(kernel, n_bytes, H100_OPTIN) == want


def _mesh(n_tris, size=2.0):
    """The port's spec and data of a grid mesh of n_tris triangles (no
    partitioning grid) and one light."""
    verts, faces = LS.grid_vertices(n_tris, size)
    spec = SceneSpec(prims=((TP.Triangle, n_tris),),
                     lights=((TL.PointLight, 1),))
    b = SceneBuilder(spec)
    b.add_material((0.5, 0.5, 0.5), 0.0, 0.5)
    for v1, v2, v3 in verts[faces]:
        b.add_primitive(TP.Triangle, v1=v1, v2=v2, v3=v3, material_id=0)
    b.add_light(TL.PointLight, position=(0.0, 5.0, 2.0), color=(1.0,) * 3)
    return spec, b.device_data("cpu")


def _spheres():
    r = LS.sphere_field(16, 16, device="cpu")
    return r.spec, r.scene_data


LARGE = {
    # scene: (build, chunk runs, super-chunks, staged bytes, placement)
    "spheres": (_spheres, ((0, 0, 438),), 55, 16 + 15_808, "staged"),
    "mesh": (lambda: _mesh(LS.MESH_TRIANGLES), ((3, 0, 1500),), 188,
             54_048, "optin"),
    "huge_mesh": (lambda: _mesh(LS.HUGE_MESH_TRIANGLES), ((3, 0, 8125),),
                  1016, 292_544, "global"),
}


@pytest.fixture(scope="module", params=list(LARGE))
def large(request):
    build, runs, supers, n_bytes, placement = LARGE[request.param]
    spec, data = build()
    return (request.param, spec, data, TM.pack_scene(spec, data), runs,
            supers, n_bytes, placement)


def test_large_scenes_pack_chunk_major(large):
    """Chunk runs, super-chunks and staged bytes as planned; every slot's
    rows at its chunk slot (col_slot) of the chunk table, its global index
    there in the info table; the plain scene distance over the chunks
    equals the one over each primitive's own SDF."""
    name, spec, data, packed, runs, supers, n_bytes, _ = large
    assert packed.chunk_runs == runs and packed.n_supers == supers
    assert TM.smem_bytes(packed) == n_bytes
    (ptype, n), = [(pt, n) for pt, _, n, _ in spec.prim_bounds()
                   if pt is not TP.Plane]
    assert TM.chunked_layout(ptype, n)
    assert packed.chunks.shape == (packed.n_chunks, TM.TRI_ROWS, TM.CHUNK, 4)
    assert packed.info.shape == (packed.n_slots + packed.n_chunks * TM.CHUNK,
                                 2)
    slot = packed.col_slot[:n]
    np.testing.assert_array_equal(
        packed.info[packed.n_slots + slot, 0].numpy(), np.arange(n))
    assert int(packed.chunk_live.sum()) == n
    rows = packed.chunks.permute(0, 2, 1, 3).reshape(-1, 4 * TM.TRI_ROWS)
    prm = data.prims[ptype.name]
    if ptype is TP.Sphere:
        np.testing.assert_array_equal(rows[slot, :3].numpy(),
                                      prm["center"][:n].numpy())
        np.testing.assert_array_equal(rows[slot, 3].numpy(),
                                      prm["radius"][:n].numpy())
        assert not rows[:, 4:].any()
    else:
        assert packed.triangle_rows().shape == (n, 4 * TM.TRI_ROWS)
    p = torch.as_tensor(np.random.RandomState(1).uniform(
        -3.0, 9.0, (64, 3)).astype(np.float32))
    want = ptype.sdf_planar(
        {k: v[:n] for k, v in _scalars(ptype, prm).items()},
        p[:, 0:1], p[:, 1:2], p[:, 2:3]).amin(dim=1) \
        if ptype is TP.Sphere else None
    got = TM.scene_dist(packed, p, spec.max_dist)
    if want is not None:
        planes = p[:, 1] + 1.0
        torch.testing.assert_close(
            got, torch.clamp_max(torch.minimum(want, planes),
                                 spec.max_dist), rtol=0, atol=0)
    torch.testing.assert_close(TM.pruned_scene_dist(packed, p,
                                                    spec.max_dist), got,
                               rtol=0, atol=0)


def _scalars(ptype, prm):
    """A primitive type's planar scalars (name_x, ...) from its params."""
    out = {}
    for name, kind in ptype.fields:
        if name == "material_id":
            continue
        v = prm[name].to(torch.float32)
        if kind == TP.VEC3:
            out.update({f"{name}_{ax}": v[:, i] for i, ax in
                        enumerate("xyz")})
        else:
            out[name] = v
    return out


class _OptinLib:
    """Stands in for a kernel library: the opt-in limit query only."""

    @staticmethod
    def madarch_smem_optin(index):
        return H100_OPTIN


def test_scene_args_carry_the_placement(large, monkeypatch):
    """The wrappers' _SceneArgs pick placement_for's placement from the
    staged bytes (the geometry kernel's light positions and roughness
    counted) and the device's opt-in limit, for the geometry kernel and
    for raycast; a forced placement that holds the tables is taken, one
    that cannot raises ValueError; every placement takes device memory.
    The chunk runs' bounds reach the kernels as box_chunk0 and
    tri_chunk0."""
    name, spec, data, packed, runs, _, n_bytes, placement = large
    monkeypatch.setattr(TM, "_optin_limits", {})
    dev = torch.device("cuda", 0)
    lib = _OptinLib()
    extra = 3 + data.materials["roughness"].shape[0]
    args = TM._scene_args(packed, extra, "geometry", lib, dev)
    assert TM.PLACEMENTS[args.placement] == TM.placement_for(
        "geometry", n_bytes + 4 * extra, H100_OPTIN) == placement
    args = TM._scene_args(packed, 0, "raycast", lib, dev)
    assert TM.PLACEMENTS[args.placement] == (
        "global" if placement == "optin" else placement)
    assert (args.box_chunk0, args.tri_chunk0) == (
        (packed.n_chunks, packed.n_chunks) if name == "spheres" else (0, 0))
    for forced in TM.PLACEMENTS:
        limit = {"staged": TM.SMEM_LIMIT, "optin": H100_OPTIN}.get(forced)
        if limit is not None and n_bytes + 4 * extra > limit:
            with pytest.raises(ValueError):
                TM._scene_args(packed, extra, "geometry", lib, dev, forced)
        else:
            args = TM._scene_args(packed, extra, "geometry", lib, dev,
                                  forced)
            assert TM.PLACEMENTS[args.placement] == forced
    with pytest.raises(ValueError):
        TM._check_placement("shared")


def _typed_scene(ptype, n, static):
    """A JAX scene of one sphere or box type of n slots (static counts, or
    capacity n with n - 3 live) and a floor plane."""
    spec = JSceneSpec(prims=((ptype, n), (JP.Plane, 1)),
                      lights=((JL.PointLight, 1),), max_dist=20.0)
    live = n if static else n - 3
    if static:
        spec = spec.specialized({ptype.name: n, "plane": 1},
                                {"point_light": 1})
    b = JSceneBuilder(spec)
    b.add_material((0.5, 0.5, 0.5), 0.0, 0.5)
    rng = np.random.RandomState(n)
    for _ in range(live):
        c = rng.uniform(-2.0, 2.0, 3) + np.array([0.0, 1.5, 5.0])
        if ptype is JP.Sphere:
            b.add_primitive(ptype, center=c, radius=rng.uniform(0.1, 0.3),
                            material_id=0)
        else:
            b.add_primitive(ptype, center=c, side=rng.uniform(0.1, 0.3, 3),
                            material_id=0)
    b.add_primitive(JP.Plane, normal=(0.0, 1.0, 0.0), offset=1.0,
                    material_id=0)
    b.add_light(JL.PointLight, position=(0.0, 5.0, 3.0), color=(1.0,) * 3)
    return spec, b.device_data()


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("n", [8, 9, 64, 65, 200])
@pytest.mark.parametrize("ptype", [JP.Sphere, JP.Box], ids=["sphere", "box"])
def test_chunked_exactly_where_the_plan_says(ptype, n, static):
    """The type leaves the typed runs for the chunk table where the JAX
    plan's entry is kind "c", and the scene distance is the same either
    way: the generic route's (each primitive's own SDF) at seeded
    points."""
    jspec, jdata = _typed_scene(ptype, n, static)
    entry = next(e for e in JM.build_plan(jspec).entries
                 if e.ptype is ptype)
    tspec, tdata = _port(jspec, jdata)
    packed = TM.pack_scene(tspec, tdata)
    tptype = {"sphere": TP.Sphere, "box": TP.Box}[ptype.name]
    chunked = entry.kind == "c"
    assert TM.chunked_layout(tptype, n) == chunked
    assert [c for c, _, _ in packed.chunk_runs] == (
        [TM.KERNEL_TYPES[tptype][0]] if chunked else [])
    code = TM.KERNEL_TYPES[tptype][0]
    assert packed.counts[code] == (0 if chunked else n)
    assert packed.counts[1] == 1          # the plane stays in its run
    assert int(packed.chunk_live.sum()) == (
        (n if static else n - 3) if chunked else 0)
    p = np.random.RandomState(2).uniform(-3.0, 8.0, (48, 3)).astype(
        np.float32)
    want = _np(tscene_sdf(tspec, tdata, torch.as_tensor(p)))
    got = _np(TM.scene_dist(packed, torch.as_tensor(p), jspec.max_dist))
    np.testing.assert_allclose(got, np.minimum(want, jspec.max_dist), **TOL)


def _mixed(static=True):
    """~100 spheres, ~80 boxes, 30 triangles and a plane; dynamic: 90, 70
    and 25 of them live."""
    if static:
        return _scene(((JP.Sphere, 100), (JP.Box, 80), (JP.Plane, 1)))
    spec = JSceneSpec(prims=((JP.Sphere, 100), (JP.Box, 80),
                             (JP.Triangle, 30), (JP.Plane, 1)),
                      lights=((JL.PointLight, 1),), max_dist=20.0)
    b = JSceneBuilder(spec)
    b.add_material((0.5, 0.5, 0.5), 0.0, 0.5)
    rng = np.random.RandomState(9)
    for pt, live in ((JP.Sphere, 90), (JP.Box, 70), (JP.Triangle, 25)):
        for _ in range(live):
            c = rng.uniform(-2.0, 2.0, 3) + np.array([0.0, 1.5, 5.0])
            if pt is JP.Sphere:
                b.add_primitive(pt, center=c, radius=rng.uniform(0.1, 0.3),
                                material_id=0)
            elif pt is JP.Box:
                b.add_primitive(pt, center=c, side=rng.uniform(0.1, 0.3, 3),
                                material_id=0)
            else:
                v = c + rng.uniform(-0.4, 0.4, (3, 3))
                b.add_primitive(pt, v1=v[0], v2=v[1], v3=v[2],
                                material_id=0)
    b.add_primitive(JP.Plane, normal=(0.0, 1.0, 0.0), offset=1.0,
                    material_id=0)
    b.add_light(JL.PointLight, position=(0.0, 5.0, 3.0), color=(1.0,) * 3)
    return spec, b.device_data()


def test_chunk_boxes_restate_in_numpy():
    """Dynamic counts, three chunked types: the chunk runs go spheres,
    boxes, triangles, the first two padded with inert chunks to whole
    super-chunks (13 → 16, 10 → 16; the triangles' 4 last); the live
    spheres and boxes in Z-order of their centers (scene/mesh.py:
    morton_order), the dead after them, the triangles in slot order; each
    chunk's box is the least box of its live slots (a sphere's center ±
    radius, a box's center ± half-side, a triangle's vertices), inert
    where none is live; each super-chunk's box holds its SUPER chunks; the
    coordinate scale is 1 + the largest coordinate of a live slot's box;
    dead and padded slots hold the inert rows; the info table holds each
    slot's global index at its chunk slot."""
    jspec, jdata = _mixed(static=False)
    tspec, tdata = _port(jspec, jdata)
    packed = TM.pack_scene(tspec, tdata)
    assert packed.chunk_runs == ((0, 0, 16), (2, 16, 16), (3, 32, 4))
    assert packed.counts == (0, 1, 0) and packed.n_supers == 5
    big = np.float32(TM.BIG)
    n_slots = packed.n_chunks * TM.CHUNK
    lo = np.full((n_slots, 3), big, np.float32)
    hi = np.full((n_slots, 3), -big, np.float32)
    live = np.zeros(n_slots, bool)
    col_slot = packed.col_slot.numpy()
    col = 0
    for name, cap, n_live, first in (("sphere", 100, 90, 0),
                                     ("box", 80, 70, 128),
                                     ("triangle", 30, 25, 256)):
        prm = {k: np.asarray(v)[:cap] for k, v in jdata.prims[name].items()}
        if name == "sphere":
            r = prm["radius"][:, None]
            l, h = prm["center"] - r, prm["center"] + r
        elif name == "box":
            l, h = prm["center"] - prm["side"], prm["center"] + prm["side"]
        else:
            v = np.stack([prm[k] for k in ("v1", "v2", "v3")])
            l, h = v.min(0), v.max(0)
        slots = col_slot[col:col + cap]
        order = np.argsort(slots)
        np.testing.assert_array_equal(slots[order], first + np.arange(cap))
        np.testing.assert_array_equal(
            order[:n_live], morton_order(prm["center"][:n_live])
            if name != "triangle" else np.arange(n_live))
        alive = np.arange(cap) < n_live
        lo[slots[alive]], hi[slots[alive]] = l[alive], h[alive]
        live[slots[alive]] = True
        col += cap
    np.testing.assert_array_equal(_np(packed.chunk_live), live)
    boxes = _np(packed.aabbs)
    chunks = boxes[1 + packed.n_supers:]
    np.testing.assert_array_equal(chunks[:, 0:3],
                                  lo.reshape(-1, TM.CHUNK, 3).min(1))
    np.testing.assert_array_equal(chunks[:, 4:7],
                                  hi.reshape(-1, TM.CHUNK, 3).max(1))
    supers = boxes[1:1 + packed.n_supers]
    for s in range(packed.n_supers):
        np.testing.assert_array_equal(
            supers[s, 0:3], chunks[TM.SUPER * s:TM.SUPER * (s + 1), 0:3]
            .min(0))
        np.testing.assert_array_equal(
            supers[s, 4:7], chunks[TM.SUPER * s:TM.SUPER * (s + 1), 4:7]
            .max(0))
    assert not boxes[1:, 3].any() and not boxes[1:, 7].any()
    np.testing.assert_allclose(
        boxes[0, 0], 1.0 + np.maximum(np.abs(lo), np.abs(hi))[live].max(),
        rtol=0)
    rows = _np(packed.chunks.permute(0, 2, 1, 3)).reshape(-1, 28)
    for first, end, dead in ((0, 128, [0, 0, 0, -big]),
                             (128, 256, [0, 0, 0, 0, -big, -big, -big, 0]),
                             (256, 288, [TM.DEAD_TRIANGLE_X, 0, 0, 0])):
        tail = rows[first:end][~live[first:end]]
        np.testing.assert_array_equal(tail[:, :len(dead)],
                                      np.broadcast_to(dead, (len(tail),
                                                             len(dead))))
        assert not tail[:, len(dead):].any()
    # the plane's slot first, then every chunk slot
    info = packed.info[:, 0].numpy()
    assert info[0] == 210
    chunked = col_slot >= 0
    np.testing.assert_array_equal(info[1 + col_slot[chunked]],
                                  packed.col_gidx.numpy()[chunked])


@pytest.fixture(scope="module")
def mixed():
    """(jax spec, data, plan, packed params, port spec, data, packed,
    origins, dirs) of the static mixed scene, with 192 seeded rays from
    in front of the cluster toward it."""
    jspec, jdata = _mixed()
    tspec, tdata = _port(jspec, jdata)
    plan = JM.build_plan(jspec)
    rng = np.random.RandomState(3)
    n = 192
    o = (np.float32([0.0, 1.5, -1.0])
         + rng.uniform(-1.0, 1.0, (n, 3))).astype(np.float32)
    d = np.float32([0.0, 1.5, 5.0]) + rng.uniform(-2.5, 2.5, (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return (jspec, jdata, plan, JM.pack_params(plan, jdata), tspec, tdata,
            TM.pack_scene(tspec, tdata), o, d)


def test_mixed_scene_is_chunked_in_both_packages(mixed):
    jspec, _, plan, _, _, _, packed, _, _ = mixed
    assert {e.ptype.name: e.kind for e in plan.entries} == {
        "sphere": "c", "box": "c", "plane": "u"}
    assert packed.chunk_runs == ((0, 0, 16), (2, 16, 10))
    assert packed.counts == (0, 1, 0)


def _hold_hits(jt, jhit, tt, thit):
    """The JAX kernel's chunked tolerances: hit flags agree on at least
    CHUNK_AGREE of the rays, t within CHUNK_T_ATOL on as many of the rays
    both hit.  Returns the rays both hit with t so close."""
    jt, jhit, tt, thit = (np.asarray(x) for x in (jt, jhit, tt, thit))
    assert (jhit == thit).mean() >= CHUNK_AGREE
    both = jhit & thit
    close = np.abs(tt - jt) <= CHUNK_T_ATOL
    assert close[both].mean() >= CHUNK_AGREE
    return both & close


def _xla_sdf(jspec, jdata):
    return jax.vmap(lambda p: scene_sdf(jspec, jdata, p))


def test_raycast_matches_jax(mixed):
    """Against the interpret-mode kernel at its chunked tolerances, and
    against the unculled XLA march exactly (hits equal, t to 1e-5)."""
    jspec, jdata, plan, jp, tspec, tdata, packed, o, d = mixed
    jt, jhit, _ = JM.pallas_raycast(plan, jp, jnp.asarray(o),
                                    jnp.asarray(d), jspec.max_dist)
    tt, thit, _ = TM.raycast(packed, torch.as_tensor(o), torch.as_tensor(d),
                             tspec.max_dist)
    _hold_hits(jt, jhit, _np(tt), _np(thit))
    rt, rhit, _ = jrm.raycast(_xla_sdf(jspec, jdata), jnp.asarray(o),
                              jnp.asarray(d), jspec.max_dist)
    np.testing.assert_array_equal(_np(thit), np.asarray(rhit))
    assert 0.5 < _np(thit).mean() < 1.0
    np.testing.assert_allclose(_np(tt)[_np(thit)],
                               np.asarray(rt)[_np(thit)], **TOL)


def test_visibility_matches_jax(mixed):
    """Rays to their own max (-1 to 20): the interpret-mode kernel's 0/1
    on at least CHUNK_AGREE of them, the unculled XLA march's on all."""
    jspec, jdata, plan, jp, tspec, tdata, packed, o, d = mixed
    mx = np.random.RandomState(4).uniform(-1.0, 20.0, len(o)).astype(
        np.float32)
    jv = np.asarray(JM.pallas_visibility(plan, jp, jnp.asarray(o),
                                         jnp.asarray(d), jnp.asarray(mx)))
    tv = _np(TM.visibility(packed, torch.as_tensor(o), torch.as_tensor(d),
                           torch.as_tensor(mx)))
    assert (tv == jv).mean() >= CHUNK_AGREE
    rv = np.asarray(jrm.raycast_visibility(
        _xla_sdf(jspec, jdata), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(mx)))
    np.testing.assert_array_equal(tv, rv)
    assert 0.0 < tv.mean() < 1.0


def test_softshadows_match_jax(mixed):
    """k = 16, where the JAX kernel's penumbra march takes no culling: the
    interpret-mode kernel's factors to 1e-5, blocked on the same rays."""
    jspec, jdata, plan, jp, tspec, tdata, packed, o, d = mixed
    rng = np.random.RandomState(5)
    mn = rng.uniform(0.0, 0.5, len(o)).astype(np.float32)
    mx = rng.uniform(0.0, 20.0, len(o)).astype(np.float32)
    js = np.asarray(JM.pallas_softshadows(
        plan, jp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(mn),
        jnp.asarray(mx), 16.0))
    ts = _np(TM.softshadows(packed, torch.as_tensor(o), torch.as_tensor(d),
                            torch.as_tensor(mn), torch.as_tensor(mx), 16.0))
    np.testing.assert_array_equal(ts == 0.0, js == 0.0)
    np.testing.assert_allclose(ts, js, **TOL)
    assert (ts == 0.0).any() and ((ts > 0.0) & (ts < 1.0)).any()


def test_geometry_matches_the_interpret_mode_kernel(mixed):
    """The primary: hits and t at the chunked tolerances, idx and mid equal
    on the rays both hit at the same t."""
    jspec, jdata, plan, jp, tspec, tdata, packed, o, d = mixed
    lpos, n_lights = JM.pack_light_positions(jspec, jdata)
    j = JM.pallas_geometry(plan, jp, lpos, n_lights, jnp.asarray(o),
                           jnp.asarray(d), jspec.max_dist, **GEOM)
    tl, tn = TM.pack_light_positions(tspec, tdata)
    t = TM.geometry(packed, tl, tn, torch.as_tensor(o), torch.as_tensor(d),
                    tspec.max_dist, **GEOM)
    same = _hold_hits(j["t"], j["hit"], _np(t["t"]), _np(t["hit"]))
    assert same.mean() > 0.5
    for key in ("idx", "mid"):
        np.testing.assert_array_equal(_np(t[key])[same],
                                      np.asarray(j[key])[same])


def test_pruning_is_exact_for_less_work(mixed):
    """On march-like points the pruned minimum (the admitted chunks only)
    is the unpruned one bit for bit, and the counted work of exact pruning
    (box tests, admitted spheres and boxes) is below the unpruned work."""
    *_, tspec, tdata, packed, o, d = mixed
    ts = np.linspace(0.0, 12.0, 13, dtype=np.float32)
    p = torch.as_tensor((o[None] + ts[:, None, None] * d[None])
                        .reshape(-1, 3))
    with TM.counting():
        full = TM.scene_dist(packed, p, tspec.max_dist)
        counted = dict(TM.pruned_evals)
        pruned_flops = TM.scene_eval_flops()
        unpruned_flops = TM.scene_eval_flops(pruned=False)
    assert TM.chunk_evals == {0: len(p) * 100, 2: len(p) * 80, 3: 0}
    assert 0 < counted["spheres"] < len(p) * 100
    assert 0 < counted["boxes"] < len(p) * 80
    assert counted["triangles"] == 0
    assert pruned_flops < unpruned_flops
    torch.testing.assert_close(TM.pruned_scene_dist(packed, p,
                                                    tspec.max_dist), full,
                               rtol=0, atol=0)


@pytest.mark.parametrize("lanes", [1, 8, 32])
def test_lane_group_pruning_gives_the_unpruned_minimum(mixed, lanes):
    """scene.cuh:chunk_min's order for a group of ``lanes`` lanes, emulated
    in numpy over every chunk slot (spheres and boxes of the dynamic mixed
    scene, triangles too): the unpruned (distance, global index) at every
    point, with fewer slots evaluated."""
    jspec, jdata = _mixed(static=False)
    tspec, tdata = _port(jspec, jdata)
    packed = TM.pack_scene(tspec, tdata)
    o, d = mixed[-2:]
    ts = np.linspace(0.0, 8.0, 5, dtype=np.float32)
    p = (o[None, :40] + ts[:, None, None] * d[None, :40]).reshape(-1, 3)
    cols = TM._slot_dists(packed, torch.as_tensor(p)).numpy()
    col_slot = packed.col_slot.numpy()
    chunked = col_slot >= 0
    dists = np.full((len(p), packed.n_chunks * TM.CHUNK), np.float32(3e9))
    dists[:, col_slot[chunked]] = cols[:, chunked]
    gidx = packed.info[packed.n_slots:, 0].numpy()
    start = []
    for i in range(len(p)):
        best = (np.float32(tspec.max_dist), -1)
        for dd, gi in zip(cols[i, ~chunked],
                          packed.col_gidx.numpy()[~chunked]):
            best = _take(best, dd, gi)
        start.append(best)
    got, evaluated = _group_tri_min(packed, dists, gidx, p, start, lanes)
    d_full, idx_full, _ = TM.scene_dist_info(packed, torch.as_tensor(p),
                                             tspec.max_dist)
    np.testing.assert_array_equal(np.float32([g[0] for g in got]),
                                  d_full.numpy())
    np.testing.assert_array_equal([g[1] if g[0] < tspec.max_dist else -1
                                   for g in got], idx_full.numpy())
    assert evaluated < len(p) * int(packed.chunk_live.sum())


def test_sphere_field_frame_matches_jax():
    """The 3,500-sphere field (chunked in both packages) at 16² with the
    fast probes and 48 march steps, two frames of each package's Renderer
    (the JAX package's XLA path; the port's plain versions of its
    kernels) under the golden gates."""
    jr = JRenderer(JSceneSpec(prims=((JP.Sphere, LS.SPHERES), (JP.Plane, 1)),
                              lights=((JL.PointLight, 1),)),
                   16, 16, probes=jax_config(FAST),
                   volumetrics=JC.NO_VOLUMETRICS)
    LS.add_sphere_field(jr, JP.Sphere, JP.Plane, JL.PointLight)
    jr.screen_cfg = JC.screen_shade_config(False, max_march_steps=48)
    tr = LS.sphere_field(16, 16, probes=FAST, device="cpu")
    tr.screen_cfg = screen_shade_config(False, max_march_steps=48)
    assert TM.pack_scene(tr.spec, tr.scene_data).chunk_runs == (
        (0, 0, 438),)
    for _ in range(2):
        ref = np.asarray(jr.render())
        img = tr.render().numpy()
    stats = image_stats(img, ref)
    assert not stats["breached"], stats
    assert float(ref.var()) > 0.0


def test_mesh_frame_matches_jax(tmp_path):
    """A 3,000-triangle grid OBJ written to tmp_path and loaded by both
    packages' obj_mesh(obj_path=..., triangle_capacity=3000) at 16², as
    test_torch_pipeline.py's torus frame: the fast probes, 48 march
    steps, two frames, under the golden gates.  The grid spans 1 × 1
    units, some 4% of the frame as the torus does: on its pixels the two
    packages shade with different normals (ROADMAP C5: the JAX XLA path's
    autodiff normal against the FD normal of the JAX kernel the port
    follows), which on a 2 × 2 grid reaches frac_above_0.05 (2.3 to 3.0%
    of the pixels, measured).  3,000 triangles and not 12,000: the port's
    partitioning grid alone takes ~26 s on the CPU at 12,000."""
    path = LS.write_grid_obj(str(tmp_path / "grid.obj"), 3000, size=1.0)
    jr = jscenes.obj_mesh(width=16, height=16, obj_path=path,
                          triangle_capacity=3000, probes=jax_config(FAST))
    jr.screen_cfg = JC.screen_shade_config(False, max_march_steps=48)
    tr = tscenes.obj_mesh(width=16, height=16, obj_path=path,
                          triangle_capacity=3000, probes=FAST, device="cpu")
    tr.screen_cfg = screen_shade_config(False, max_march_steps=48)
    assert tr.spec.live_prims == jr.spec.live_prims == (3000,)
    for _ in range(2):
        ref = np.asarray(jr.render())
        img = tr.render().numpy()
    stats = image_stats(img, ref)
    assert not stats["breached"], stats
    assert stats["mean_absdiff"] < 3e-3
    assert float(ref.var()) > 0.0
