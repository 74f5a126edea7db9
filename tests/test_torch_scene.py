"""Port parity: scene model of madarch_tpu_torch against madarch_tpu.

The same seeded numpy inputs go through both packages; distances and light
samples agree to atol 1e-6 and indices exactly.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.scene import lights as JL
from madarch_tpu.scene import primitives as JP
from madarch_tpu.scene import scene as JS
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.scene import lights as TL
from madarch_tpu_torch.scene import primitives as TP
from madarch_tpu_torch.scene import scene as TS
from madarch_tpu_torch.utils.checkpoint import key_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6


def _params(rng, ptype):
    if ptype.name == "sphere":
        return {"center": rng.randn(3).astype(np.float32),
                "radius": np.float32(rng.uniform(0.3, 2.0))}
    if ptype.name == "plane":
        n = rng.randn(3).astype(np.float32)
        return {"normal": n / np.linalg.norm(n),
                "offset": np.float32(rng.uniform(-2, 2))}
    return {"center": rng.randn(3).astype(np.float32),
            "side": rng.uniform(0.2, 1.5, 3).astype(np.float32)}


def _points(rng, n=64):
    return (rng.randn(n, 3) * 2.0).astype(np.float32)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("name", ["sphere", "plane", "box"])
def test_primitive_sdf_matches_jax(name):
    rng = np.random.RandomState({"sphere": 1, "plane": 2, "box": 3}[name])
    jp, tp = getattr(JP, name.capitalize()), getattr(TP, name.capitalize())
    prm, pts = _params(rng, jp), _points(rng)
    ref = jax.vmap(lambda p: jp.sdf({k: jnp.asarray(v) for k, v in
                                     prm.items()}, p))(jnp.asarray(pts))
    got = tp.sdf({k: _t(v) for k, v in prm.items()}, _t(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("name", ["sphere", "plane", "box"])
def test_primitive_sdf_planar_matches_jax(name):
    rng = np.random.RandomState({"sphere": 4, "plane": 5, "box": 6}[name])
    jp, tp = getattr(JP, name.capitalize()), getattr(TP, name.capitalize())
    prm, pts = _params(rng, jp), _points(rng)
    scal = {}
    for k, v in prm.items():
        if np.ndim(v) == 1:
            for i, ax in enumerate("xyz"):
                scal[f"{k}_{ax}"] = v[i]
        else:
            scal[k] = v
    ref = jp.sdf_planar({k: jnp.float32(v) for k, v in scal.items()},
                        *(jnp.asarray(pts[:, i]) for i in range(3)))
    got = tp.sdf_planar({k: torch.tensor(v) for k, v in scal.items()},
                        *(_t(pts[:, i]) for i in range(3)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("name", ["sphere", "plane", "box"])
def test_primitive_normal_and_bounds_match_jax(name):
    """Analytic normals (the box's axis select with its 0.002 tie-break,
    exercised on points at edges) and batched bounds."""
    rng = np.random.RandomState({"sphere": 7, "plane": 8, "box": 9}[name])
    jp, tp = getattr(JP, name.capitalize()), getattr(TP, name.capitalize())
    prm, pts = _params(rng, jp), _points(rng)
    if name == "box":
        # points on edges and corners: two or three axes tie
        c, s = prm["center"], prm["side"]
        signs = np.sign(rng.randn(16, 3)).astype(np.float32)
        pts[:16] = c + signs * s
        pts[16:24, 2] = c[2]
        pts[16:24, :2] = (c + signs[:8] * s)[:, :2]
    ref = jax.vmap(lambda p: jp.normal({k: jnp.asarray(v) for k, v in
                                        prm.items()}, p))(jnp.asarray(pts))
    got = tp.normal({k: _t(v) for k, v in prm.items()}, _t(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    if jp.bounds is not None:
        batched = {k: np.stack([v, v]) for k, v in prm.items()}
        ref_lo, ref_hi = jp.bounds({k: jnp.asarray(v) for k, v in
                                    batched.items()})
        lo, hi = tp.bounds({k: _t(v) for k, v in batched.items()})
        np.testing.assert_allclose(lo.numpy(), np.asarray(ref_lo), atol=ATOL)
        np.testing.assert_allclose(hi.numpy(), np.asarray(ref_hi), atol=ATOL)


@pytest.mark.parametrize("name", ["point_light", "spot_light"])
def test_light_sample_matches_jax(name):
    rng = np.random.RandomState(11 if name == "point_light" else 12)
    jl = JL.PointLight if name == "point_light" else JL.SpotLight
    tl = TL.PointLight if name == "point_light" else TL.SpotLight
    d = rng.randn(3).astype(np.float32)
    prm = {"position": np.array([3.5, 5.0, 2.0], np.float32),
           "color": np.array([0.9, 0.9, 0.8], np.float32),
           "direction": d / np.linalg.norm(d),
           "aperture": np.float32(3.1415 / 4.0)}
    prm = {k: v for k, v in prm.items() if k in jl.field_names}
    # points near the light, where the spot's 1.5 attenuation cap binds
    pts = np.concatenate([_points(rng), prm["position"]
                          + rng.randn(16, 3).astype(np.float32) * 0.5])
    nrm = np.zeros_like(pts)
    ref = jl.sample({k: jnp.asarray(v) for k, v in prm.items()},
                    jnp.asarray(pts), jnp.asarray(nrm))
    got = tl.sample({k: _t(v) for k, v in prm.items()}, _t(pts), _t(nrm))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=1e-6)


def _gi_pair():
    jr = jscenes.global_illumination(width=32, height=32)
    tr = tscenes.global_illumination(width=32, height=32, device="cpu")
    return jr, tr


def test_scene_data_from_numpy_round_trips():
    jr, tr = _gi_pair()
    tree = jax.tree.map(np.asarray, jr.scene_data)
    data = TS.scene_data_from_numpy(tree, "cpu")
    own = tr.scene_data
    for t, a, b in ((TP.Sphere, data, own), (TP.Box, data, own)):
        for f in t.field_names:
            np.testing.assert_array_equal(a.prims[t.name][f].numpy(),
                                          b.prims[t.name][f].numpy())
    assert int(data.prim_counts["plane"]) == 6
    assert data.materials["albedo"].dtype == torch.float32
    assert tr.spec.live_prims == jr.spec.live_prims == (1, 6, 1)


@pytest.mark.parametrize("specialized", [True, False])
def test_scene_sdf_info_matches_jax(specialized):
    """Distances, capacity-based global indices (first minimum wins) and
    material lookups, on the GI scene with static and dynamic counts."""
    jr, tr = _gi_pair()
    jspec = jr.spec if specialized else jr.base_spec
    tspec = tr.spec if specialized else tr.base_spec
    jdata = jr.scene_data
    tdata = TS.scene_data_from_numpy(jax.tree.map(np.asarray, jdata), "cpu")
    rng = np.random.RandomState(13)
    pts = rng.uniform([-1, -1, -6], [7, 7, 7], (256, 3)).astype(np.float32)
    # points equidistant from two walls exercise the first-minimum rule
    pts[:16] = np.array([3.0, 3.0, 0.5], np.float32) \
        + rng.randn(16, 3).astype(np.float32) * [0, 0, 1]
    ref_d, ref_i = jax.vmap(lambda p: JS.scene_sdf_info(jspec, jdata, p))(
        jnp.asarray(pts))
    d, i = TS.scene_sdf_info(tspec, tdata, _t(pts))
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), atol=ATOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    ref_sdf = jax.vmap(lambda p: JS.scene_sdf(jspec, jdata, p))(
        jnp.asarray(pts))
    np.testing.assert_allclose(TS.scene_sdf(tspec, tdata, _t(pts)).numpy(),
                               np.asarray(ref_sdf), atol=ATOL)

    ref_mid = JS.primitive_material_id(jspec, jdata, ref_i)
    mid = TS.primitive_material_id(tspec, tdata, i)
    np.testing.assert_array_equal(mid.numpy(), np.asarray(ref_mid))
    for g, r in zip(TS.material_lookup(tdata, mid),
                    JS.material_lookup(jdata, ref_mid)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)


def test_material_lookup_clamps_like_jax():
    jr, tr = _gi_pair()
    jdata = jr.scene_data
    tdata = TS.scene_data_from_numpy(jax.tree.map(np.asarray, jdata), "cpu")
    ids = np.array([-3, 0, 1, 4, 19, 25], np.int32)
    for g, r in zip(TS.material_lookup(tdata, _t(ids)),
                    JS.material_lookup(jdata, jnp.asarray(ids))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)


def test_builder_rejects_overflow_like_jax():
    spec = TS.SceneSpec(prims=((TP.Sphere, 1),), lights=())
    b = TS.SceneBuilder(spec)
    b.add_primitive(TP.Sphere, center=(0, 0, 0), radius=1.0, material_id=0)
    with pytest.raises(ValueError):
        b.add_primitive(TP.Sphere, center=(0, 0, 0), radius=1.0,
                        material_id=0)
    with pytest.raises(ValueError):
        b.set_material(spec.max_materials, (0, 0, 0), 0.0, 0.5)


# The JAX package's own top-level names: the port may import none of them.
JAX_SIDE = ("jax", "jaxlib", "madarch_tpu")

_NO_JAX = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "madarch_tpu")
for name in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[name]

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("the port imported " + name)

sys.meta_path.insert(0, BlockJax())
import madarch_tpu_torch
names = [m.name for m in pkgutil.walk_packages(madarch_tpu_torch.__path__,
                                               "madarch_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
chip_smoke.port_modules()      # the imports chip_smoke makes inside main()
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print(" ".join(names))
"""


def test_port_never_imports_jax():
    """Every module of the port, and chip_smoke.py with the imports its
    main() makes, import with JAX and the JAX package made unimportable,
    and leave none of their modules behind."""
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 20
    for module in ("scene.bvh", "scene.baked_sdf", "scene.mesh",
                   "render.context", "render.pathtrace", "render.sampling",
                   "utils.checkpoint", "parallel.spmd", "core.vecmath",
                   "core.resample", "io.image", "scene.primitives",
                   "scene.lights", "scene.scene", "scene.partitioning",
                   "render.shading", "render.probes", "utils.profiling",
                   "bench", "tools.perf_probe", "tools.geom_probe",
                   "tools.train_probe", "tools.diag_golden",
                   "tools.tree_outputs", "examples.large_scenes"):
        assert "madarch_tpu_torch." + module in names


def _port_sources():
    root = os.path.join(REPO, "madarch_tpu_torch")
    paths = [os.path.join(d, f) for d, _, files in os.walk(root)
             for f in files if f.endswith(".py")]
    return sorted(paths) + [os.path.join(REPO, "chip_smoke.py")]


def test_port_sources_import_nothing_of_jax():
    """No import statement anywhere in the port's sources or chip_smoke.py,
    at any depth (inside functions too), names jax, jaxlib or
    madarch_tpu."""
    import ast
    paths = _port_sources()
    assert len(paths) > 20
    bad = []
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {m}"
                    for m in mods if m.split(".")[0] in JAX_SIDE]
    assert not bad, bad


def _light_scene(pkg_p, pkg_l, pkg_s):
    """tests/test_scene.py's make_scene in one package: a point light and
    a spot light, each type with capacity 2 and one live."""
    spec = pkg_s.SceneSpec(prims=((pkg_p.Sphere, 4), (pkg_p.Plane, 4)),
                           lights=((pkg_l.PointLight, 2),
                                   (pkg_l.SpotLight, 2)))
    b = pkg_s.SceneBuilder(spec)
    b.add_material(albedo=(1.0, 0.0, 0.0), metallic=0.0, roughness=0.6)
    b.add_primitive(pkg_p.Sphere, center=(0.0, 0.0, 5.0), radius=1.0,
                    material_id=0)
    b.add_light(pkg_l.PointLight, position=(0.0, 3.0, 0.0),
                color=(0.9, 0.9, 0.9))
    b.add_light(pkg_l.SpotLight, position=(3.5, 5.0, 2.0),
                direction=(1.0, 0.0, 0.0), aperture=np.pi / 4,
                color=(0.9, 0.9, 0.8))
    return spec, b


def test_sample_light_dispatch_like_jax():
    """tests/test_scene.py:test_sample_light_dispatch on the port: index 0
    is the point light, index 1 the spot light (a live-count offset, not
    the point lights' capacity of 2)."""
    spec, b = _light_scene(TP, TL, TS)
    data = b.device_data("cpu")
    p = torch.zeros((1, 3))
    n = torch.tensor([[0.0, 1.0, 0.0]])
    rad, ldir, ldist = TS.sample_light(spec, data, 0, p, n)
    np.testing.assert_allclose(ldir.numpy(), [[0.0, 1.0, 0.0]], atol=1e-6)
    np.testing.assert_allclose(ldist.numpy(), [3.0], atol=1e-6)
    np.testing.assert_allclose(rad.numpy(), [[0.9 / (9.0 * 0.03)] * 3],
                               rtol=1e-5)
    _, _, ldist2 = TS.sample_light(spec, data, 1, p, n)
    np.testing.assert_allclose(ldist2.numpy(),
                               [np.linalg.norm([3.5, 5.0, 2.0])], rtol=1e-5)


@pytest.mark.parametrize("specialized", [False, True])
def test_sample_light_matches_jax_per_index(specialized):
    """Every index, the live ones and those past them (zero radiance,
    distance 1), at seeded points, batched on the port and vmapped in the
    JAX package; with dynamic counts and with the counts baked in, which
    pick the same light for the same index."""
    jspec, jb = _light_scene(JP, JL, JS)
    tspec, tb = _light_scene(TP, TL, TS)
    if specialized:
        counts = {"point_light": 1, "spot_light": 1}
        jspec = jspec.specialized({}, counts)
        tspec = tspec.specialized({}, counts)
    jdata, tdata = jb.device_data(), tb.device_data("cpu")
    rng = np.random.RandomState(21)
    pts = _points(rng, 32)
    nrm = rng.randn(32, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    idx = np.arange(32, dtype=np.int32) % 4
    ref = jax.vmap(lambda i, p, n: JS.sample_light(jspec, jdata, i, p, n))(
        jnp.asarray(idx), jnp.asarray(pts), jnp.asarray(nrm))
    got = TS.sample_light(tspec, tdata, _t(idx), _t(pts), _t(nrm))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=1e-6)
    past = idx >= 2
    assert (got[0].numpy()[past] == 0.0).all()
    assert (got[2].numpy()[past] == 1.0).all()


def test_sample_light_passes_surface_normal_through():
    """tests/test_scene.py's light whose radiance reads the normal."""
    def sample(params, pos, normal):
        to_l = params["position"] - pos
        dist = torch.linalg.vector_norm(to_l, dim=-1)
        return (params["color"] * (normal * normal).sum(-1, keepdim=True),
                to_l / dist[..., None], dist)

    normal_lit = TL.LightType(name="normal_lit", fields=(
        ("position", TP.VEC3), ("color", TP.VEC3)), sample=sample)
    spec = TS.SceneSpec(prims=((TP.Sphere, 2),), lights=((normal_lit, 2),))
    b = TS.SceneBuilder(spec)
    b.add_light(normal_lit, position=(0.0, 3.0, 0.0), color=(1.0, 1.0, 1.0))
    rad, _, _ = TS.sample_light(spec, b.device_data("cpu"), 0,
                                torch.zeros((1, 3)),
                                torch.tensor([[0.0, 1.0, 0.0]]))
    np.testing.assert_allclose(rad.numpy(), [[1.0, 1.0, 1.0]], atol=1e-6)


@pytest.mark.parametrize("name", ["sphere", "plane", "box"])
def test_primitive_distance_is_its_sdf_like_jax(name):
    """PrimitiveType.distance equals the type's sdf exactly, and JAX's
    distance at atol 1e-6."""
    rng = np.random.RandomState({"sphere": 31, "plane": 32, "box": 33}[name])
    jp, tp = getattr(JP, name.capitalize()), getattr(TP, name.capitalize())
    prm, pts = _params(rng, jp), _points(rng)
    tprm = {k: _t(v) for k, v in prm.items()}
    got = tp.distance(tprm, _t(pts))
    assert torch.equal(got, tp.sdf(tprm, _t(pts)))
    ref = jax.vmap(lambda p: jp.distance(
        {k: jnp.asarray(v) for k, v in prm.items()}, p))(jnp.asarray(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("lights", ["both", "point only", "none"])
def test_total_light_count_matches_jax(lights):
    """An i32[] on the scene's device, equal to JAX's; zero with no light
    type."""
    def scene(pkg_p, pkg_l, pkg_s, device=()):
        types = {"both": ((pkg_l.PointLight, 2), (pkg_l.SpotLight, 3)),
                 "point only": ((pkg_l.PointLight, 2),),
                 "none": ()}[lights]
        spec = pkg_s.SceneSpec(prims=((pkg_p.Sphere, 2),), lights=types)
        b = pkg_s.SceneBuilder(spec)
        for ltype, cap in types:
            for _ in range(cap - 1):
                b.add_light(ltype, position=(0.0, 3.0, 0.0))
        return b.device_data(*device)

    got = scene(TP, TL, TS, ("cpu",)).total_light_count()
    ref = scene(JP, JL, JS).total_light_count()
    assert got.dtype == torch.int32 and got.shape == () \
        and got.device.type == "cpu"
    assert int(got) == int(ref) == {"both": 3, "point only": 1,
                                    "none": 0}[lights]


def _empty_pair():
    spec_j = jscenes.global_illumination(width=8, height=8).base_spec
    spec_t = tscenes.global_illumination(width=8, height=8,
                                         device="cpu").base_spec
    return spec_j.empty_data(), spec_t.empty_data("cpu")


def test_empty_data_matches_jax_leaf_for_leaf():
    """SceneSpec.empty_data: the leaves in jax.tree.flatten's order with
    JAX's key paths, shapes and dtypes, all zero, and no grid."""
    jdata, tdata = _empty_pair()
    want = [("/".join(str(k) for k in path), np.asarray(leaf)) for path, leaf
            in jax.tree_util.tree_flatten_with_path(jdata)[0]]
    got = key_paths(tdata)
    assert len(got) == len(want) > 0
    for (tpath, t), (jpath, j) in zip(got, want):
        assert tpath == jpath
        assert t.numpy().dtype == j.dtype and t.shape == j.shape, tpath
        assert t.device.type == "cpu"
        assert not t.any() and not j.any()
    assert tdata.grid is None and jdata.grid is None


def test_empty_data_is_a_builders_snapshot():
    """Leaf for leaf the dtypes and shapes SceneBuilder(spec).device_data
    gives, on the device asked for."""
    _, tdata = _empty_pair()
    spec = tscenes.global_illumination(width=8, height=8,
                                       device="cpu").base_spec
    built = TS.SceneBuilder(spec).device_data("cpu")
    for (pa, a), (pb, b) in zip(TS.tree_items(tdata), TS.tree_items(built)):
        assert pa == pb and a.dtype == b.dtype and a.shape == b.shape
    assert all(x.is_meta for x in TS.tree_leaves(spec.empty_data("meta")))


def test_make_light_normal_lit_matches_jax():
    """tests/test_scene.py's normal_lit light, built with each package's
    make_light: the radiance reads the surface normal, and the port's
    sample_light gives JAX's at atol 1e-6."""
    def sample_t(params, pos, normal):
        to_l = params["position"] - pos
        dist = torch.linalg.vector_norm(to_l, dim=-1)
        return (params["color"] * (normal * normal).sum(-1, keepdim=True),
                to_l / dist[..., None], dist)

    def sample_j(params, pos, normal):
        to_l = params["position"] - pos
        dist = jnp.linalg.norm(to_l)
        return (params["color"] * jnp.sum(normal * normal, -1, keepdims=True),
                to_l / dist, dist)

    lights = {}
    for pkg_p, pkg_l, pkg_s, sample, dev in (
            (TP, TL, TS, sample_t, ("cpu",)), (JP, JL, JS, sample_j, ())):
        normal_lit = pkg_l.make_light(
            "normal_lit", fields=(("position", pkg_p.VEC3),
                                  ("color", pkg_p.VEC3)),
            sample=sample, position=lambda params: params["position"])
        assert isinstance(normal_lit, pkg_l.LightType)
        assert normal_lit.field_names == ("position", "color")
        spec = pkg_s.SceneSpec(prims=((pkg_p.Sphere, 2),),
                               lights=((normal_lit, 2),))
        b = pkg_s.SceneBuilder(spec)
        b.add_light(normal_lit, position=(0.0, 3.0, 0.0),
                    color=(1.0, 1.0, 1.0))
        lights[pkg_s] = (spec, b.device_data(*dev), normal_lit)
    spec, data, light = lights[TS]
    p = torch.zeros((1, 3))
    n = torch.tensor([[0.0, 1.0, 0.0]])
    got = TS.sample_light(spec, data, 0, p, n)
    np.testing.assert_allclose(got[0].numpy(), [[1.0, 1.0, 1.0]], atol=1e-6)
    np.testing.assert_array_equal(light.position(data.lights["normal_lit"])
                                  [0].numpy(), [0.0, 3.0, 0.0])
    jspec, jdata, _ = lights[JS]
    ref = JS.sample_light(jspec, jdata, jnp.int32(0), jnp.zeros(3),
                          jnp.asarray([0.0, 1.0, 0.0]))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy()[0], np.asarray(r), atol=1e-6)
