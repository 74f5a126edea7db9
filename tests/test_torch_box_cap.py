"""Port parity: the box-exit cap (madarch_tpu_torch/ops/march.py:
ray_box_cap and csrc/scene.cuh:box_cap) against the JAX package's
_ray_box_cap in its Pallas kernels.

On a scene whose every live type has a global box (``ScenePlan.
all_bounded``: triangles or bounded types of more than 8 slots, no plane)
the kernels end a march at the ray's exit from those boxes grown by
FAR_MARGIN, and a raycast or geometry miss so capped reports t = max_dist.

- pack_scene packs a cap exactly where the JAX plan is all bounded, with
  the JAX package's global boxes grown by its margin, bit for bit.
- The fault: on the in-repo torus placed as obj_mesh places it, the
  port's raycast, geometry, visibility and softshadows (their plain
  versions here) against the JAX kernels in interpret mode, on seeded
  rays from the camera and the probe grid, most of them missing: every
  miss at t = max_dist on both, hits and visibility equal; on rays both
  hit t within 5e-3 and idx / mid equal (the JAX package's chunked
  tolerances: its culling moves march steps).  Penumbras at k = 16, where
  the JAX kernel takes no cap or culling (k < 32), to 1e-5.
- Soundness: the capped plain versions against the uncapped ones
  (without_box_cap) on the torus and on a triangles-only scene: every
  output equal but a miss's t, with fewer march steps.
- The penumbra takes no cap: on a flat all-bounded mesh a shadow ray
  leaving it at a grazing angle takes its darkest samples past the box,
  so a march ended there, at FAR_MARGIN or at max_dist / k, is lighter.
- Scenes with a plane (GI, simple_scene) pack no cap.
- An obj_mesh frame is bit-equal with the cap on and off.
Rays are made with numpy from seeds and handed to both packages.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.ops import march as JM
from madarch_tpu.scene import lights as JL
from madarch_tpu.scene import primitives as JP
from madarch_tpu.scene.scene import SceneBuilder, SceneSpec
from madarch_tpu_torch.core.config import ProbeSettings
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.ops import march as TM
from madarch_tpu_torch.render import raymarch as trm
from madarch_tpu_torch.render.raymarch import SURFACE_OFFSET
from test_torch_config import torch_threads  # noqa: F401
from test_torch_triangles import _port

pytestmark = pytest.mark.usefixtures("torch_threads")

TOL = dict(rtol=1e-5, atol=1e-5)
# The JAX package's chunked tolerance on t (tests/test_march_kernels.py).
CHUNK_T_ATOL = 5e-3
GEOM = dict(probe_spacing=(2.0, 3.0, 3.0), probe_dims=(3, 3, 4),
            surface_offset=SURFACE_OFFSET, ao_steps=3)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _scene(prims, n_lights=1, seed=3):
    """A JAX scene of (type, count) prims, static counts: triangles and
    spheres and boxes scattered in a 4-unit cube, planes as a floor."""
    spec = SceneSpec(prims=tuple(prims),
                     lights=((JL.PointLight, n_lights),), max_dist=20.0)
    spec = spec.specialized({pt.name: n for pt, n in prims},
                            {"point_light": n_lights})
    b = SceneBuilder(spec)
    b.add_material((0.5, 0.5, 0.5), 0.0, 0.5)
    rng = np.random.RandomState(seed)
    for pt, n in prims:
        for _ in range(n):
            c = rng.uniform(-2.0, 2.0, 3) + np.array([0.0, 1.5, 5.0])
            if pt is JP.Triangle:
                v = c + rng.uniform(-0.4, 0.4, (3, 3))
                b.add_primitive(pt, v1=v[0], v2=v[1], v3=v[2], material_id=0)
            elif pt is JP.Sphere:
                b.add_primitive(pt, center=c, radius=rng.uniform(0.1, 0.3),
                                material_id=0)
            elif pt is JP.Box:
                b.add_primitive(pt, center=c, side=rng.uniform(0.1, 0.3, 3),
                                material_id=0)
            else:
                b.add_primitive(pt, normal=(0.0, 1.0, 0.0), offset=1.0,
                                material_id=0)
    b.add_light(JL.PointLight, position=(0.0, 5.0, 3.0), color=(1.0,) * 3)
    return spec, b.device_data()


def _torus():
    jr = jscenes.obj_mesh(width=16, height=16, obj_path=tscenes.TORUS_OBJ)
    return jr.spec, jr.scene_data, jr


CASES = {
    "torus": lambda: _torus()[:2],
    "gi": lambda: (lambda r: (r.spec, r.scene_data))(
        jscenes.global_illumination(width=16, height=16)),
    "simple_scene": lambda: (lambda r: (r.spec, r.scene_data))(
        jscenes.simple_scene(width=16, height=16)),
    "triangles_and_plane": lambda: _scene(((JP.Triangle, 80), (JP.Plane, 1))),
    "triangles": lambda: _scene(((JP.Triangle, 80),)),
    "spheres_20": lambda: _scene(((JP.Sphere, 20),)),
    "spheres_8": lambda: _scene(((JP.Sphere, 8),)),
    "spheres_and_boxes": lambda: _scene(((JP.Sphere, 20), (JP.Box, 12))),
    "triangles_and_boxes_8": lambda: _scene(((JP.Triangle, 80),
                                             (JP.Box, 8))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pack_scene_caps_exactly_the_all_bounded_plans(case):
    """A cap where the JAX plan is all bounded, none elsewhere; its boxes
    the JAX package's global boxes (its pack_params rows) grown by
    FAR_MARGIN, in spec order."""
    jspec, jdata = CASES[case]()
    tspec, tdata = _port(jspec, jdata)
    plan = JM.build_plan(jspec)
    packed = TM.pack_scene(tspec, tdata)
    assert (packed.cap_margin is not None) == plan.all_bounded
    assert TM.FAR_MARGIN == JM.FAR_MARGIN
    if not plan.all_bounded:
        assert packed.cap_boxes.shape == (0, 6)
        assert TM.ray_box_cap(packed, torch.zeros(4, 3),
                              torch.ones(4, 3)) is None
        return
    assert packed.cap_margin == JM.FAR_MARGIN
    jp = JM.pack_params(plan, jdata)
    m = np.float32(JM.FAR_MARGIN)
    want = [np.concatenate([
        np.asarray(jp.spheres[e.sph_idx][:3, 0]) - m,
        np.asarray(jp.spheres[e.sph_idx][3:6, 0]) + m])
        for e in plan.entries]
    np.testing.assert_array_equal(_np(packed.cap_boxes), np.stack(want))


def _cap_rays(jr, n, seed):
    """n seeded rays: half from the camera, half from the probe grid's
    points, toward points of a box twice the torus's (most miss)."""
    rng = np.random.RandomState(seed)
    v = np.asarray(jr.scene_data.prims["triangle"]["v1"])[:968]
    lo, hi = v.min(0), v.max(0)
    mid, half = (lo + hi) / 2, hi - lo
    gx, gy, gz = jr.probes.grid_dimensions
    sp = np.asarray(jr.probes.grid_spacing, np.float32)
    grid = np.stack(np.meshgrid(np.arange(gx), np.arange(gy), np.arange(gz),
                                indexing="ij"), -1).reshape(-1, 3) * sp
    o = grid[rng.randint(0, len(grid), n)].astype(np.float32)
    o[: n // 2] = np.asarray(jr.camera_position)
    d = mid + rng.uniform(-1.0, 1.0, (n, 3)) * half - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def torus():
    """(jax spec, jax data, plan, packed params, port spec, port data,
    port packed, origins, dirs) of the torus with 192 seeded rays."""
    jspec, jdata, jr = _torus()
    tspec, tdata = _port(jspec, jdata)
    plan = JM.build_plan(jspec)
    o, d = _cap_rays(jr, 192, seed=3)
    return (jspec, jdata, plan, JM.pack_params(plan, jdata), tspec, tdata,
            TM.pack_scene(tspec, tdata), o, d)


def _hold_primary(jt, jhit, tt, thit, max_dist):
    """Hits equal; every miss at t = max_dist on both; t within the
    chunked tolerance on rays both hit.  Returns the hits."""
    jt, jhit, tt, thit = (np.asarray(x) for x in (jt, jhit, tt, thit))
    np.testing.assert_array_equal(thit, jhit)
    assert (jt[~jhit] == max_dist).all() and (tt[~thit] == max_dist).all()
    np.testing.assert_allclose(tt[thit], jt[thit], atol=CHUNK_T_ATOL)
    return thit


def test_raycast_misses_at_max_dist_as_the_interpret_mode_kernel(torus):
    jspec, jdata, plan, jp, tspec, tdata, packed, o, d = torus
    jt, jhit, _ = JM.pallas_raycast(plan, jp, jnp.asarray(o), jnp.asarray(d),
                                    jspec.max_dist)
    tt, thit, tpos = TM.raycast(packed, torch.as_tensor(o),
                                torch.as_tensor(d), tspec.max_dist)
    hit = _hold_primary(jt, jhit, _np(tt), _np(thit), tspec.max_dist)
    assert 0.1 < hit.mean() < 0.5
    np.testing.assert_array_equal(_np(tpos)[~hit],
                                  o[~hit] + np.float32(20.0) * d[~hit])


def test_geometry_misses_at_max_dist_as_the_interpret_mode_kernel(torus):
    """The primary and the folded reflection: misses at max_dist, hits
    equal, idx and mid equal on rays both hit.  Every material at
    roughness 0, so every hit reflects (the torus's is 1, which gates the
    reflection off)."""
    jspec, jdata, plan, jp, tspec, tdata, packed, o, d = torus
    lpos, n_lights = JM.pack_light_positions(jspec, jdata)
    rough = jnp.zeros((jdata.materials["roughness"].shape[0], 1),
                      jnp.float32)
    j = JM.pallas_geometry(plan, jp, lpos, n_lights, jnp.asarray(o),
                           jnp.asarray(d), jspec.max_dist,
                           mat_rough_vec=rough, **GEOM)
    tl, tn = TM.pack_light_positions(tspec, tdata)
    t = TM.geometry(packed, tl, tn, torch.as_tensor(o), torch.as_tensor(d),
                    tspec.max_dist, mat_rough_vec=torch.as_tensor(
                        np.asarray(rough)).reshape(-1), **GEOM)
    both = _hold_primary(j["t"], j["hit"], _np(t["t"]), _np(t["hit"]),
                         tspec.max_dist)
    assert 0.1 < both.mean() < 0.5
    for key in ("idx", "mid"):
        np.testing.assert_array_equal(_np(t[key])[both],
                                      np.asarray(j[key])[both])
    # the reflection leaves from each side's own hit normal, and those
    # differ by C5's FD noise: each side's reflection misses on its own hits
    for side in (j, t):
        r_miss = _np(side["hit"]) & ~_np(side["refl"]["hit"])
        assert r_miss.mean() > 0.05
        assert (_np(side["refl"]["t"])[r_miss] == tspec.max_dist).all()


def test_visibility_matches_the_interpret_mode_kernel(torus):
    """Rays ending at their own max (-1 to 20): the capped march gives
    the JAX kernel's 0/1 on every ray."""
    jspec, jdata, plan, jp, tspec, tdata, packed, o, d = torus
    mx = np.random.RandomState(4).uniform(-1.0, 20.0, len(o)).astype(
        np.float32)
    jv = JM.pallas_visibility(plan, jp, jnp.asarray(o), jnp.asarray(d),
                              jnp.asarray(mx))
    tv = TM.visibility(packed, torch.as_tensor(o), torch.as_tensor(d),
                       torch.as_tensor(mx))
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    assert 0.0 < _np(tv).mean() < 1.0


def test_softshadows_match_the_interpret_mode_kernel(torus):
    """k = 16: the JAX kernel's march takes no cap or culling below
    k = 32, the port's none at any k; the same factors to 1e-5."""
    jspec, jdata, plan, jp, tspec, tdata, packed, o, d = torus
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


def _same_but_miss_t(on, off, max_dist):
    """Capped outputs on against uncapped off of the same rays, the
    primary's and the reflection's each on its own hits: hit equal, every
    output equal on hits, a miss's t at max_dist where capped (else the
    uncapped t).  Returns the misses capped."""
    n_capped = 0
    pairs = [(on, off)] + ([(on["refl"], off["refl"])] if on["refl"] else [])
    for a, b in pairs:
        hit = a["hit"]
        assert torch.equal(hit, b["hit"])
        for key, x in a.items():
            if key == "refl":
                continue
            mask = hit.view(-1, *[1] * (x.dim() - 1)) \
                if x.shape[0] == hit.shape[0] else hit[None]
            assert not bool(((x != b[key]) & mask).any()), key
        capped = ~hit & (a["t"] == max_dist)
        assert bool(((a["t"] == b["t"]) | capped)[~hit].all())
        n_capped += int(capped.sum())
    return n_capped


SOUND = {"torus": lambda: _torus()[:2],
         "triangles": lambda: _scene(((JP.Triangle, 80),))}


@pytest.mark.parametrize("case", list(SOUND))
def test_capped_plain_versions_equal_the_uncapped_but_miss_t(case):
    """geometry (with the reflection fold, every material at roughness 0
    so that every hit reflects), raycast and visibility with and without
    the cap: the same outputs but a capped miss's t, in fewer march steps
    and fewer counted operations."""
    jspec, jdata = SOUND[case]()
    tspec, tdata = _port(jspec, jdata)
    packed = TM.pack_scene(tspec, tdata)
    assert packed.cap_margin == TM.FAR_MARGIN
    rng = np.random.RandomState(6)
    o = torch.as_tensor(rng.uniform(-3.0, 3.0, (256, 3)).astype(np.float32)
                        + np.float32([0.0, 1.5, 5.0]))
    d = torch.as_tensor(rng.randn(256, 3).astype(np.float32))
    if case == "torus":
        jr = _torus()[2]
        o, d = (torch.as_tensor(x) for x in _cap_rays(jr, 256, seed=7))
    d = d / d.norm(dim=1, keepdim=True)
    tl, tn = TM.pack_light_positions(tspec, tdata)
    geo = dict(GEOM, mat_rough_vec=torch.zeros_like(
        tdata.materials["roughness"]))
    max_dist = tspec.max_dist
    scenes = {True: packed, False: TM.without_box_cap(packed)}
    flops = {}
    out = {}
    for cap, pk in scenes.items():
        with TM.counting():
            out[cap] = TM.geometry_reference(pk, tl, tn, o, d, max_dist,
                                             **geo)
            flops[cap] = TM.scene_eval_flops()
    assert _same_but_miss_t(out[True], out[False], max_dist) > 64
    assert flops[True] < flops[False]

    rc = {cap: TM.raycast_reference(pk, o, d, max_dist, return_steps=True)
          for cap, pk in scenes.items()}
    (t1, h1, _, s1), (t0, h0, _, s0) = rc[True], rc[False]
    assert torch.equal(h1, h0) and torch.equal(t1[h1], t0[h1])
    assert bool((t1[~h1] == max_dist).all()) and bool((t0[~h0] > max_dist)
                                                      .all())
    assert bool((s1 <= s0).all()) and int(s1.sum()) < int(s0.sum())
    mx = torch.full((o.shape[0],), max_dist)
    v1, s1 = TM.visibility_reference(packed, o, d, mx, return_steps=True)
    v0, s0 = TM.visibility_reference(scenes[False], o, d, mx,
                                     return_steps=True)
    assert torch.equal(v1, v0) and 0.0 < float(v1.mean()) < 1.0
    assert bool((s1 <= s0).all()) and int(s1.sum()) < int(s0.sum())


def test_raycast_disabled_rays_stay_at_zero_with_the_cap(torus):
    """A disabled ray does not march and reports t = 0, capped or not."""
    *_, tspec, tdata, packed, o, d = torus
    en = torch.as_tensor(np.random.RandomState(8).rand(len(o)) > 0.5)
    for cap in (True, False):
        t, hit, _ = TM.raycast(packed, torch.as_tensor(o),
                               torch.as_tensor(d), tspec.max_dist,
                               enabled=en, box_cap=cap)
        assert bool((t[~en] == 0.0).all()) and not bool(hit[~en].any())
        assert bool((t[en & ~hit] >= tspec.max_dist).all())


def _flat_mesh(n=4, size=40.0):
    """A square of 2·n² triangles in the plane y = 0 (all bounded)."""
    prims = ((JP.Triangle, 2 * n * n),)
    spec = SceneSpec(prims=prims, lights=((JL.PointLight, 1),),
                     max_dist=20.0).specialized({"triangle": 2 * n * n},
                                                {"point_light": 1})
    b = SceneBuilder(spec)
    b.add_material((0.5, 0.5, 0.5), 0.0, 0.5)
    step = size / n
    for i in range(n):
        for k in range(n):
            x0, z0 = -size / 2 + i * step, -size / 2 + k * step
            a, bb = (x0, 0.0, z0), (x0 + step, 0.0, z0)
            c, dd = (x0, 0.0, z0 + step), (x0 + step, 0.0, z0 + step)
            b.add_primitive(JP.Triangle, v1=a, v2=bb, v3=dd, material_id=0)
            b.add_primitive(JP.Triangle, v1=a, v2=dd, v3=c, material_id=0)
    b.add_light(JL.PointLight, position=(0.0, 5.0, 0.0), color=(1.0,) * 3)
    return spec, b.device_data()


def test_softshadows_take_no_cap():
    """A flat 40 x 40 mesh is all bounded, its box 0.015 thick.  Shadow
    rays from 0.05 above it, leaving at grazing angles toward lights out
    to max_dist: the port's penumbra marches to the light (equal to the
    plain march over the scene distance), and its darkest samples lie
    past the box, so a march ended at the box exit, grown by FAR_MARGIN
    or by max_dist / k, is lighter on some rays."""
    tspec, tdata = _port(*_flat_mesh())
    packed = TM.pack_scene(tspec, tdata)
    assert packed.cap_margin == TM.FAR_MARGIN
    n, k = 64, 64.0
    rng = np.random.RandomState(9)
    ang = np.linspace(0.002, 0.02, n)
    az = rng.uniform(0.0, 2.0 * np.pi, n)
    d = np.stack([np.cos(az) * np.cos(ang), np.sin(ang),
                  np.sin(az) * np.cos(ang)], -1).astype(np.float32)
    o = np.stack([rng.uniform(-2.0, 2.0, n), np.full(n, 0.05),
                  rng.uniform(-2.0, 2.0, n)], -1).astype(np.float32)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    mn, mx = torch.zeros(n), torch.full((n,), tspec.max_dist)
    res = TM.softshadows(packed, o, d, mn, mx, k)
    plain = trm.softshadows(
        lambda p: TM.scene_dist(packed, p, TM.VIS_CAP), o, d, mn, mx, k)
    assert torch.equal(res, plain)
    assert bool((res < 1.0).any())
    for margin in (TM.FAR_MARGIN, tspec.max_dist / k):
        boxes = packed.cap_boxes.clone()
        boxes[:, :3] -= margin - TM.FAR_MARGIN
        boxes[:, 3:] += margin - TM.FAR_MARGIN
        cap = TM.ray_box_cap(dataclasses.replace(packed, cap_boxes=boxes),
                             o, d)
        capped = TM.softshadows(packed, o, d, mn, torch.minimum(mx, cap), k)
        assert bool((capped >= res).all()) and bool((capped > res).any()), \
            margin


@pytest.mark.parametrize("scene", ["global_illumination", "simple_scene"])
def test_scenes_with_a_plane_pack_no_cap(scene):
    """GI and simple_scene have planes (and simple_scene types of at most
    8 slots): no cap boxes, and geometry is bit-equal to box_cap=False."""
    r = getattr(tscenes, scene)(width=16, height=16, device="cpu")
    packed = TM.pack_scene(r.spec, r.scene_data)
    assert packed.cap_margin is None and packed.cap_boxes.shape == (0, 6)
    o = r.camera.position.expand(64, 3).contiguous()
    d = torch.as_tensor(np.random.RandomState(10).randn(64, 3)
                        .astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    lpos, n_l = TM.pack_light_positions(r.spec, r.scene_data)
    kw = dict(probe_spacing=r.probes.grid_spacing,
              probe_dims=r.probes.grid_dimensions,
              surface_offset=SURFACE_OFFSET, ao_steps=3,
              mat_rough_vec=r.scene_data.materials["roughness"])
    on = TM.geometry(packed, lpos, n_l, o, d, r.spec.max_dist, **kw)
    off = TM.geometry(packed, lpos, n_l, o, d, r.spec.max_dist,
                      box_cap=False, **kw)
    for a, b in ((on, off), (on["refl"], off["refl"])):
        for key, x in a.items():
            if key != "refl":
                assert torch.equal(x, b[key]), key


def test_obj_mesh_frame_is_bit_equal_with_the_cap_off(monkeypatch):
    """Two 24² frames of the torus: a capped miss's t is read nowhere
    but where hit masks it, so the image is the uncapped image."""
    def frames():
        r = tscenes.obj_mesh(width=24, height=24, obj_path=tscenes.TORUS_OBJ,
                             probes=ProbeSettings(radiance_resolution=4,
                                                  irradiance_resolution=4,
                                                  grid_dimensions=(3, 3, 4)),
                             device="cpu")
        return r.converge(frames=2)

    capped = frames()
    pack = TM.pack_scene
    monkeypatch.setattr(TM, "pack_scene",
                        lambda spec, data: TM.without_box_cap(
                            pack(spec, data)))
    assert torch.equal(frames(), capped)


def test_obj_mesh_train_step_gradients_are_equal_with_the_cap_off(
        monkeypatch):
    """The train step's loss and every leaf's gradient on the torus at
    16² (parallel/spmd.py:make_value_and_grad), bit-equal with the cap on
    and off: attach_hit_gradient and the normal read t only where a ray
    hits."""
    from madarch_tpu_torch.parallel import spmd

    def value_and_grad():
        r = tscenes.obj_mesh(width=16, height=16, obj_path=tscenes.TORUS_OBJ,
                             probes=ProbeSettings(radiance_resolution=4,
                                                  irradiance_resolution=4,
                                                  grid_dimensions=(3, 3, 4)),
                             device="cpu")
        fn = spmd.make_value_and_grad(r.spec, r.probes, r.volumetrics, 16, 16)
        loss, grads, _ = fn(r.scene_data, r.camera, r.state,
                            torch.zeros((16, 16, 3)))
        return loss, grads

    loss, grads = value_and_grad()
    pack = TM.pack_scene
    monkeypatch.setattr(TM, "pack_scene",
                        lambda spec, data: TM.without_box_cap(
                            pack(spec, data)))
    loss_off, grads_off = value_and_grad()
    assert torch.equal(loss, loss_off)
    assert any(bool(g.abs().sum() > 0) for g in grads)
    for g, h in zip(grads, grads_off):
        assert torch.equal(g, h)
