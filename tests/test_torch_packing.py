"""The packed scene layouts of madarch_tpu_torch/ops/march.py, which the
CUDA kernels read (csrc/scene.cuh), on the CPU at small sizes.

- The typed slot runs and the chunk-major triangle table hold the
  primitives of the specs they were packed from: a round trip against
  ``scene_data_from_numpy`` inputs made with numpy from a seed, whatever
  the order of the types in the spec.
- A dead slot of each type (past a dynamic count) never wins:
  ``scene_dist`` and ``scene_dist_info`` are bit-equal to an evaluation of
  the spec's own parameters that reads a dead slot as the scene-distance
  cap (what the tables held before the dead slots were packed inert).
- Exact ties across types (a box face and a plane through the point where
  both touch a sphere, twin spheres) go to the lowest global index, in
  every order of the types.
- An emulation of the order in which a group of G lanes prunes triangles
  (super-chunks nearest bound first; rounds of G chunk boxes, chunks
  nearest bound first and re-checked; a lane per triangle; folds by
  distance, then global index) gives the unpruned minimum and index bit
  for bit on seeded points of the 80- and 200-triangle scenes and of the
  torus, for G = 1, 8 and 32.
"""
import itertools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.ops import march as TM
from madarch_tpu_torch.scene import lights as TL
from madarch_tpu_torch.scene import primitives as TP
from madarch_tpu_torch.scene import scene as TS
from test_march_kernels import build_chunked_scene
from test_torch_config import torch_threads  # noqa: F401
from test_torch_march import port_spec

pytestmark = pytest.mark.usefixtures("torch_threads")

TYPES = {"sphere": TP.Sphere, "plane": TP.Plane, "box": TP.Box,
         "triangle": TP.Triangle}
CAPS = {"sphere": 5, "plane": 4, "box": 6, "triangle": 29}
MAX_DIST = 20.0


def _random_prims(rng):
    """Numpy parameters of every type at its capacity."""
    n = CAPS
    normal = rng.randn(n["plane"], 3).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)

    def mids(k):
        return rng.randint(0, 4, k).astype(np.int32)

    return {
        "sphere": {"center": rng.randn(n["sphere"], 3).astype(np.float32),
                   "radius": rng.uniform(0.2, 1.0, n["sphere"])
                   .astype(np.float32), "material_id": mids(n["sphere"])},
        "plane": {"normal": normal,
                  "offset": rng.uniform(1.0, 3.0, n["plane"])
                  .astype(np.float32), "material_id": mids(n["plane"])},
        "box": {"center": rng.randn(n["box"], 3).astype(np.float32) * 2.0,
                "side": rng.uniform(0.1, 0.8, (n["box"], 3))
                .astype(np.float32), "material_id": mids(n["box"])},
        "triangle": {"v1": rng.randn(n["triangle"], 3).astype(np.float32),
                     "v2": rng.randn(n["triangle"], 3).astype(np.float32),
                     "v3": rng.randn(n["triangle"], 3).astype(np.float32),
                     "material_id": mids(n["triangle"])},
    }


def _scene(order, prims, counts, dynamic=True):
    """(spec, data) with the types in ``order``, ``counts`` live slots of
    each; dynamic counts unless ``dynamic`` is False (then the spec is
    specialised to the counts)."""
    spec = TS.SceneSpec(prims=tuple((TYPES[k], CAPS[k]) for k in order),
                        lights=((TL.PointLight, 1),), max_dist=MAX_DIST)
    tree = SimpleNamespace(
        prims={k: prims[k] for k in order},
        prim_counts={k: np.int32(counts[k]) for k in order},
        lights={"point_light": {
            "position": np.zeros((1, 3), np.float32),
            "color": np.ones((1, 3), np.float32),
            "intensity": np.ones(1, np.float32)}},
        light_counts={"point_light": np.int32(1)},
        materials={"albedo": np.ones((4, 3), np.float32),
                   "metallic": np.zeros(4, np.float32),
                   "roughness": np.ones(4, np.float32)})
    data = TS.scene_data_from_numpy(tree, "cpu")
    if not dynamic:
        spec = spec.specialized({k: counts[k] for k in order},
                                {"point_light": 1})
    return spec, data


def _points(rng, n=200):
    return torch.as_tensor((rng.randn(n, 3) * 2.0).astype(np.float32))


def _spec_eval(spec, data, counts, p, max_dist):
    """(distance, global index, material id) at p from the spec's own
    parameters, a dead slot reading as max_dist; the first minimum in spec
    (global index) order wins."""
    px, py, pz = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    cols, gidx, mid = [], [], []
    goff = 0
    for ptype, cap, n, _ in spec.prim_bounds():
        prm = {k: v[:n] for k, v in data.prims[ptype.name].items()}
        # a triangle in the derived form, which the marches evaluate
        derived = ptype.derive is not None
        fields, sdf = (ptype.derived_fields, ptype.sdf_planar_derived) \
            if derived else (ptype.fields, ptype.sdf_planar)
        vals = ptype.derive(prm) if derived else prm
        s = {}
        for name, kind in fields:
            if name == "material_id":
                continue
            if kind == TP.VEC3:
                for j, ax in enumerate("xyz"):
                    s[f"{name}_{ax}"] = vals[name][:, j]
            else:
                s[name] = vals[name]
        d = sdf(s, px, py, pz)
        live = torch.arange(n) < counts[ptype.name]
        cols.append(torch.where(live, d, max_dist))
        gidx.append(goff + torch.arange(n))
        mid.append(prm["material_id"])
        goff += cap
    dmin, arg = torch.min(torch.cat(cols, dim=1), dim=1)
    near = dmin < max_dist
    idx = torch.where(near, torch.cat(gidx)[arg], -1).to(torch.int32)
    m = torch.where(near, torch.cat(mid)[arg], 0).to(torch.int32)
    return torch.clamp_max(dmin, max_dist), idx, m


ORDERS = [("sphere", "plane", "box"), ("plane", "box", "sphere"),
          ("box", "sphere", "plane")]


# ---------------------------------------------------------------------------
# Round trips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", ORDERS, ids="-".join)
def test_typed_runs_hold_the_specs_slots(order):
    rng = np.random.RandomState(71)
    prims = _random_prims(rng)
    counts = {"sphere": 3, "plane": 4, "box": 2}
    spec, data = _scene(order, prims, counts)
    packed = TM.pack_scene(spec, data)
    ns, npl, nb = CAPS["sphere"], CAPS["plane"], CAPS["box"]
    assert packed.counts == (ns, npl, nb)
    assert packed.rows.shape == (ns + npl + 2 * nb, 4)
    rows, info = packed.rows.numpy(), packed.info.numpy()
    goff = {k: sum(CAPS[o] for o in order[:order.index(k)]) for k in order}
    live = TM.slot_live(packed).numpy()
    first = {"sphere": 0, "plane": ns, "box": ns + npl}
    for k in order:
        n, c, f = CAPS[k], counts[k], first[k]
        slot = first[k] if k != "box" else ns + npl    # info row of slot 0
        np.testing.assert_array_equal(info[slot:slot + n, 0],
                                      goff[k] + np.arange(n))
        np.testing.assert_array_equal(info[slot:slot + n, 1],
                                      prims[k]["material_id"])
        np.testing.assert_array_equal(live[slot:slot + n],
                                      np.arange(n) < c)
        if k == "sphere":
            np.testing.assert_array_equal(rows[f:f + c, :3],
                                          prims[k]["center"][:c])
            np.testing.assert_array_equal(rows[f:f + c, 3],
                                          prims[k]["radius"][:c])
            np.testing.assert_array_equal(
                rows[f + c:f + n], [[0, 0, 0, -TM.BIG]] * (n - c))
        elif k == "plane":
            np.testing.assert_array_equal(rows[f:f + c, :3],
                                          prims[k]["normal"][:c])
            np.testing.assert_array_equal(rows[f:f + c, 3],
                                          prims[k]["offset"][:c])
        else:
            # every center, then every half-side, each padded to a float4
            np.testing.assert_array_equal(rows[f:f + c, :3],
                                          prims[k]["center"][:c])
            np.testing.assert_array_equal(rows[f + n:f + n + c, :3],
                                          prims[k]["side"][:c])
            assert not rows[f:f + 2 * n, 3].any()
            np.testing.assert_array_equal(
                rows[f + n + c:f + 2 * n, :3], -TM.BIG)
    # the plain versions' columns keep spec order
    np.testing.assert_array_equal(
        packed.col_gidx.numpy(),
        np.concatenate([goff[k] + np.arange(CAPS[k]) for k in order]))
    assert [e[0].name for e in packed.entries] == list(order)


@pytest.mark.parametrize("n_live", [29, 21, 8])
def test_triangle_table_holds_the_specs_triangles(n_live):
    """tris[c, k, j] is float4 row k of triangle 8·c + j's 28 derived
    constants; 29 slots pad to 4 chunks; dead and padded slots hold the
    inert triangle and stay out of the boxes."""
    rng = np.random.RandomState(72)
    prims = _random_prims(rng)
    order = ("plane", "triangle")
    spec, data = _scene(order, prims, {"plane": 4, "triangle": n_live})
    packed = TM.pack_scene(spec, data)
    assert packed.n_chunks == 4 and packed.n_supers == 1
    assert packed.chunks.shape == (4, TM.TRI_ROWS, TM.CHUNK, 4)
    assert packed.chunks.is_contiguous()
    der = TP.Triangle.derive({k: torch.as_tensor(v)
                              for k, v in prims["triangle"].items()})
    want = torch.cat([der[name].reshape(29, -1)
                      for name, _ in TP.Triangle.derived_fields[:-1]],
                     dim=1).numpy()
    tris = packed.chunks.numpy()
    for slot in range(32):
        got = tris[slot // 8, :, slot % 8, :].reshape(-1)
        if slot < n_live:
            np.testing.assert_array_equal(got, want[slot], err_msg=str(slot))
        else:
            np.testing.assert_array_equal(
                got, [TM.DEAD_TRIANGLE_X] + [0.0] * 27, err_msg=str(slot))
    np.testing.assert_array_equal(packed.chunk_live.numpy(),
                                  np.arange(32) < n_live)
    info = packed.info.numpy()
    assert info.shape == (4 + 32, 2)
    np.testing.assert_array_equal(info[4:4 + 29, 0], 4 + np.arange(29))
    np.testing.assert_array_equal(info[4:4 + 29, 1],
                                  prims["triangle"]["material_id"])
    # boxes: the live vertices of each chunk
    aabbs = packed.aabbs.numpy()
    assert aabbs.shape == (1 + 1 + 4, 8)
    v = np.stack([prims["triangle"][k] for k in ("v1", "v2", "v3")], axis=1)
    for c in range(4):
        vs = v[8 * c:min(8 * c + 8, n_live)].reshape(-1, 3)
        if len(vs):
            np.testing.assert_array_equal(aabbs[2 + c, 0:3], vs.min(0))
            np.testing.assert_array_equal(aabbs[2 + c, 4:7], vs.max(0))
        else:
            np.testing.assert_array_equal(aabbs[2 + c, 0:3], TM.BIG)
            np.testing.assert_array_equal(aabbs[2 + c, 4:7], -TM.BIG)
    np.testing.assert_array_equal(aabbs[1, 0:3], v[:n_live].reshape(-1, 3)
                                  .min(0))
    assert aabbs[0, 0] == np.float32(1.0 + np.abs(v[:n_live]).max())


# ---------------------------------------------------------------------------
# Dead slots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dead", ["sphere", "plane", "box", "triangle"])
@pytest.mark.parametrize("max_dist", [MAX_DIST, TM.VIS_CAP])
def test_a_dead_slot_never_wins(dead, max_dist):
    """The dead slots of one type hold parameters that would be nearest
    everywhere (a sphere of radius 50, a plane and a box over all points,
    triangles through the points' cloud) were they read."""
    rng = np.random.RandomState(73)
    prims = _random_prims(rng)
    counts = {"sphere": 5, "plane": 4, "box": 6, "triangle": 29}
    counts[dead] = {"sphere": 2, "plane": 1, "box": 3, "triangle": 11}[dead]
    c = counts[dead]
    if dead == "sphere":
        prims[dead]["radius"][c:] = 50.0
    elif dead == "plane":
        prims[dead]["offset"][c:] = -50.0
    elif dead == "box":
        prims[dead]["side"][c:] = 50.0
    order = ("box", "triangle", "sphere", "plane")
    spec, data = _scene(order, prims, counts)
    packed = TM.pack_scene(spec, data)
    p = _points(rng)
    want = _spec_eval(spec, data, counts, p, max_dist)
    all_live = _spec_eval(spec, data, CAPS, p, max_dist)
    assert not torch.equal(want[0], all_live[0]), "the dead slots matter"
    d, idx, mid = TM.scene_dist_info(packed, p, max_dist)
    torch.testing.assert_close(d, want[0], rtol=0, atol=0)
    torch.testing.assert_close(idx, want[1], rtol=0, atol=0)
    torch.testing.assert_close(mid, want[2], rtol=0, atol=0)
    torch.testing.assert_close(TM.scene_dist(packed, p, max_dist), want[0],
                               rtol=0, atol=0)
    # the same scene with the dead slots left out of the loops
    live_spec, _ = _scene(order, prims, counts, dynamic=False)
    d_live = TM.scene_dist(TM.pack_scene(live_spec, data), p, max_dist)
    torch.testing.assert_close(d, d_live, rtol=0, atol=0)


def test_nothing_under_the_cap_is_index_minus_one():
    rng = np.random.RandomState(74)
    prims = _random_prims(rng)
    spec, data = _scene(("sphere",), prims, {"sphere": 0})
    packed = TM.pack_scene(spec, data)
    d, idx, mid = TM.scene_dist_info(packed, _points(rng, 16), MAX_DIST)
    assert (d == MAX_DIST).all() and (idx == -1).all() and (mid == 0).all()


# ---------------------------------------------------------------------------
# Exact ties
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", list(itertools.permutations(
    ("sphere", "plane", "box"))), ids="-".join)
def test_exact_ties_go_to_the_lowest_global_index(order):
    """A unit sphere (twice, coincident), a box whose bottom face y = 1
    touches it at (0, 1, 0), and the plane y = 1 through both, facing
    down: the three types tie exactly at the touching point, the box and
    the plane all over the face and 0.5 inside it.  The typed runs reorder
    the slots; the winner is the lowest global index all the same."""
    prims = {
        "sphere": {"center": np.zeros((5, 3), np.float32),
                   "radius": np.ones(5, np.float32),
                   "material_id": np.arange(5, dtype=np.int32) % 4},
        "plane": {"normal": np.tile(np.float32([0, -1, 0]), (4, 1)),
                  "offset": np.ones(4, np.float32),
                  "material_id": np.arange(4, dtype=np.int32)},
        "box": {"center": np.tile(np.float32([0, 2, 0]), (6, 1)),
                "side": np.ones((6, 3), np.float32),
                "material_id": np.arange(6, dtype=np.int32) % 4},
    }
    counts = {"sphere": 2, "plane": 1, "box": 1}
    spec, data = _scene(order, prims, counts)
    packed = TM.pack_scene(spec, data)
    p = torch.tensor([[0.0, 1.0, 0.0],       # all three
                      [0.5, 1.0, 0.25],      # box face and plane
                      [-0.75, 1.0, 0.5],
                      [0.0, -1.0, 0.0],      # the spheres alone (twins)
                      [0.0, 1.5, 0.0]])      # in the box, behind the plane
    d, idx, mid = TM.scene_dist_info(packed, p, MAX_DIST)
    goff = {k: sum(CAPS[o] for o in order[:order.index(k)]) for k in order}
    np.testing.assert_array_equal(d[:4].numpy(), 0.0)
    tied = [("sphere", "plane", "box"), ("plane", "box"), ("plane", "box"),
            ("sphere",), ("plane", "box")]
    want = [min(goff[k] for k in ks) for ks in tied]
    np.testing.assert_array_equal(idx.numpy(), want)
    want_d, want_idx, want_mid = _spec_eval(spec, data, counts, p, MAX_DIST)
    torch.testing.assert_close(d, want_d, rtol=0, atol=0)
    torch.testing.assert_close(idx, want_idx, rtol=0, atol=0)
    torch.testing.assert_close(mid, want_mid, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The order in which a group of lanes prunes triangles
# ---------------------------------------------------------------------------

def _aabb_d2(b, p):
    """f32 squared point-to-box distances [N, boxes] (scene.cuh:aabb_d2)."""
    lo, hi = b[None, :, 0:3], b[None, :, 4:7]
    g = np.maximum(np.maximum(lo - p[:, None], p[:, None] - hi),
                   np.float32(0.0))
    return g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] \
        + g[..., 2] * g[..., 2]


def _take(best, d, gi):
    """scene.cuh:take on (distance, global index)."""
    if d < best[0] or (d == best[0] and gi < best[1]):
        return (d, gi)
    return best


def _group_tri_min(packed, dists, gidx, p, start, lanes):
    """scene.cuh:chunk_min for a group of ``lanes`` lanes at each point:
    (distance, global index) folded from ``start`` and the triangles
    evaluated.  dists[N, slots]: every triangle slot's distance, read
    where the kernel would evaluate it."""
    aabbs = packed.aabbs.numpy()
    ns, nc = packed.n_supers, packed.n_chunks
    sup_d2 = _aabb_d2(aabbs[1:1 + ns], p)
    chunk_d2 = _aabb_d2(aabbs[1 + ns:], p)
    slack = np.float32(TM.PRUNE_REL) * (
        aabbs[0, 0] + np.abs(p[:, 0]) + np.abs(p[:, 1]) + np.abs(p[:, 2]))
    out, evaluated = [], 0
    for i in range(len(p)):
        best = start[i]
        last = (np.float32(-1.0), -1)
        while True:
            after = [(sup_d2[i, s], s) for s in range(ns)
                     if (sup_d2[i, s], s) > last]
            if not after:
                break
            nxt = min(after)
            lim = np.float32(best[0] + slack[i])
            if not nxt[0] <= lim * lim:
                break
            s = nxt[1]
            c_end = min(nc, (s + 1) * TM.SUPER)
            for c0 in range(s * TM.SUPER, c_end, lanes):
                keys = {c: chunk_d2[i, c]
                        for c in range(c0, min(c0 + lanes, c_end))}
                while keys:
                    c = min(keys, key=lambda k: (keys[k], k))
                    lim = np.float32(best[0] + slack[i])
                    if not keys.pop(c) <= lim * lim:
                        break
                    # a lane per triangle, each folding from the group's
                    # minimum, then the lanes folded together
                    mine = [best] * lanes
                    for j in range(TM.CHUNK):
                        slot = c * TM.CHUNK + j
                        mine[j % lanes] = _take(
                            mine[j % lanes], dists[i, slot], gidx[slot])
                        evaluated += 1
                    for m in mine:
                        best = _take(best, *m)
            last = nxt
        out.append(best)
    return out, evaluated


def _tri_scene(name):
    if name == "torus":
        r = tscenes.obj_mesh(width=16, height=16, obj_path=tscenes.TORUS_OBJ,
                             device="cpu")
        return r.spec, r.scene_data
    jspec, jdata = build_chunked_scene(n_tris=int(name))
    return port_spec(jspec), TS.scene_data_from_numpy(
        jax.tree.map(np.asarray, jdata), "cpu")


@pytest.fixture(scope="module", params=["80", "200", "torus"])
def tri_points(request):
    """A triangle scene, seeded points around and inside it, every slot's
    distance there and the unpruned (distance, index, material)."""
    spec, data = _tri_scene(request.param)
    packed = TM.pack_scene(spec, data)
    rng = np.random.RandomState(75)
    aabbs = packed.aabbs.numpy()
    lo = aabbs[1:1 + packed.n_supers, 0:3].min(0)
    hi = aabbs[1:1 + packed.n_supers, 4:7].max(0)
    p = np.concatenate([
        rng.uniform(lo, hi, (40, 3)),
        rng.uniform(lo - 6.0, hi + 6.0, (40, 3))]).astype(np.float32)
    pt = torch.as_tensor(p)
    cols = TM._slot_dists(packed, pt).numpy()
    tri = packed.col_slot.numpy() >= 0
    n = int(tri.sum())
    dists = np.full((len(p), packed.n_chunks * TM.CHUNK),
                    np.float32(TM.DEAD_TRIANGLE_X))
    dists[:, :n] = cols[:, tri]
    gidx = packed.info[packed.n_slots:, 0].numpy()
    # the slots before the triangles fold first, as scene_info folds them
    others = cols[:, ~tri]
    other_gidx = packed.col_gidx.numpy()[~tri]
    start = []
    for i in range(len(p)):
        best = (np.float32(spec.max_dist), -1)
        for d, gi in zip(others[i], other_gidx):
            best = _take(best, d, gi)
        start.append(best)
    full = TM.scene_dist_info(packed, pt, spec.max_dist)
    return packed, p, dists, gidx, start, full, n


@pytest.mark.parametrize("lanes", [1, 8, 32])
def test_group_pruning_order_gives_the_unpruned_minimum(tri_points, lanes):
    packed, p, dists, gidx, start, (d, idx, _), n = tri_points
    got, evaluated = _group_tri_min(packed, dists, gidx, p, start, lanes)
    np.testing.assert_array_equal(np.float32([g[0] for g in got]), d.numpy())
    np.testing.assert_array_equal([g[1] for g in got], idx.numpy())
    # pruning prunes, and no less than the least exact pruning needs
    with TM.counting():
        TM.scene_dist(packed, torch.as_tensor(p), 20.0)
        least = TM.pruned_evals["triangles"]
    assert least <= evaluated < len(p) * n


def test_lanes_follow_the_layout_and_the_ray_count():
    """geometry_lanes: 8 lanes a ray on a mesh, on a scene of at least 16
    slots and on a launch under 100,000 rays, else 1."""
    packed = {name: TM.pack_scene(r.spec, r.scene_data) for name, r in (
        ("gi", tscenes.global_illumination(width=16, height=16,
                                           device="cpu")),
        ("simple", tscenes.simple_scene(width=16, height=16, device="cpu")),
        ("mesh", tscenes.obj_mesh(width=16, height=16,
                                  obj_path=tscenes.TORUS_OBJ,
                                  device="cpu")))}
    assert (packed["gi"].n_slots, packed["simple"].n_slots) == (8, 40)
    got = {(name, n): TM.geometry_lanes(p, n) for name, p in packed.items()
           for n in (36_864, 640_000)}
    assert got == {("gi", 36_864): 8, ("gi", 640_000): 1,
                   ("simple", 36_864): 8, ("simple", 640_000): 8,
                   ("mesh", 36_864): 8, ("mesh", 640_000): 8}
    assert set(got.values()) <= set(TM.LANE_CHOICES)
