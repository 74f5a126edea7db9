"""Port parity: the geometry pass and the plain marches of
madarch_tpu_torch against madarch_tpu.

``geometry_reference`` (the plain PyTorch version of the CUDA geometry
kernel, which ``geometry`` runs on CPU tensors) is held to the JAX
package's Pallas ``pallas_geometry`` run in interpret mode, on the
global_illumination scene (spec specialised as the Renderer does) and on
test_march_kernels.build_scene() (dynamic counts), for the radiance-pass
variant (no AO, no reflection) and the screen-pass variant (AO, folded
mode-2 reflection).  Tolerances: hit, idx, mid, r_hit, r_mid and best_pid
exactly equal; t rtol/atol 1e-5; normals and best_dir atol 1e-4 on hit
lanes (the tetrahedron FD normal divides fp32 distance differences by
2e-3, so last-bit differences between backends show at ~1e-5); ao 1e-5 on
hit lanes; shadows 1e-4 and vis8 exactly on the lanes whose marches were
enabled; the reflection outputs as stated in their test.  Other lanes
are don't-care outputs.
"""
import ctypes
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.ops import march as JM
from madarch_tpu.render import raymarch as jrm
from madarch_tpu.scene.scene import scene_sdf as jscene_sdf
from madarch_tpu_torch.core.config import (PROBE_SHADE_CONFIG,
                                           PartitioningSettings, ProbeSettings,
                                           screen_shade_config)
from madarch_tpu_torch.core.vecmath import dot, reflect
from madarch_tpu_torch.ops import march as TM
from madarch_tpu_torch.render import raymarch as trm
from madarch_tpu_torch.render.camera import camera_rays, pixel_grid
from madarch_tpu_torch.render import probes as tprobes
from madarch_tpu_torch.scene import lights as TL
from madarch_tpu_torch.scene import primitives as TP
from madarch_tpu_torch.scene import scene as TS
from test_march_kernels import build_scene, rand_rays
from test_torch_config import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

N_RAYS = 256
GRID = {"spacing": (2.0, 3.0, 3.0), "dims": (4, 3, 3)}
# Reflection hits whose primary FD normal is not bit-equal between the
# backends ("loose" lanes, held 10x looser): how many there are is the
# host's XLA rounding, since XLA's CPU backend fuses multiply-adds as the
# host's CPU allows.  Of the 256 GI screen rays (all of which reflect to a
# hit) 19 were loose on one host and 29 on another; none of build_scene()'s
# 7 reflection hits.  Each loose lane is proved to be XLA's FMA by
# _fused_sphere_normal (_loose_lanes); their share of the reflection hits
# is capped at a quarter, about twice the most measured, so that most hits
# stay held at the primary tolerances.  See
# test_geometry_reflection_matches_jax and test_loose_lanes_are_xla_fma.
MAX_LOOSE_SHARE = 0.25
TET = ((1.0, -1.0, -1.0), (-1.0, -1.0, 1.0), (-1.0, 1.0, -1.0),
       (1.0, 1.0, 1.0))


def port_spec(jspec):
    """The port's SceneSpec for a JAX SceneSpec (types matched by name,
    the partitioning settings copied field for field)."""
    prims = {"sphere": TP.Sphere, "plane": TP.Plane, "box": TP.Box,
             "triangle": TP.Triangle}
    lights = {"point_light": TL.PointLight, "spot_light": TL.SpotLight}
    part = jspec.partitioning
    return TS.SceneSpec(
        prims=tuple((prims[pt.name], c) for pt, c in jspec.prims),
        lights=tuple((lights[lt.name], c) for lt, c in jspec.lights),
        max_dist=jspec.max_dist, max_materials=jspec.max_materials,
        partitioning=None if part is None else PartitioningSettings(
            **dataclasses.asdict(part)),
        live_prims=jspec.live_prims, live_lights=jspec.live_lights)


def _gi_rays(variant):
    """N_RAYS seeded rays of the GI radiance pass (direction-major probe
    rays) or screen pass (128² camera rays)."""
    rng = np.random.RandomState(21 if variant == "radiance" else 22)
    if variant == "radiance":
        probes = ProbeSettings()
        rr = probes.radiance_resolution
        o = tprobes.probe_world_positions(probes, "cpu").repeat(rr * rr, 1)
        d = tprobes.texel_directions(rr, "cpu").repeat_interleave(
            probes.num_probes, dim=0)
    else:
        o, d = camera_rays(pixel_grid(128, 128, "cpu"),
                           torch.tensor([2.0, 2.0, 0.0]), torch.eye(3))
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    ids = rng.choice(o.shape[0], N_RAYS, replace=False)
    return o[ids].numpy(), d[ids].numpy()


def _scene(name):
    """(jax spec, jax data, port spec, port data) for a named scene."""
    if name == "gi":
        jr = jscenes.global_illumination(width=32, height=32)
        jspec, jdata = jr.spec, jr.scene_data
    else:
        jspec, jdata = build_scene()
    tdata = TS.scene_data_from_numpy(jax.tree.map(np.asarray, jdata), "cpu")
    return jspec, jdata, port_spec(jspec), tdata


def _run_both(scene, variant, **flags):
    """Both packages' geometry outputs on one case; ``flags``
    (want_shadows, want_vis) go to both."""
    jspec, jdata, tspec, tdata = _scene(scene)
    if scene == "gi":
        o, d = _gi_rays(variant)
        grid = {"spacing": (2.0, 3.0, 3.0), "dims": (4, 3, 3)}
    else:
        o, d = (np.array(x) for x in rand_rays(N_RAYS, seed=31))
        grid = GRID
    cfg = PROBE_SHADE_CONFIG if variant == "radiance" \
        else screen_shade_config(False)
    refl = variant == "screen"
    kw = dict(probe_spacing=grid["spacing"], probe_dims=grid["dims"],
              surface_offset=trm.SURFACE_OFFSET,
              ao_steps=cfg.ambient_occlusion_steps,
              max_steps=cfg.max_march_steps,
              refl_shadows=cfg.add_indirect_specular, **flags)

    plan = JM.build_plan(jspec)
    packed = JM.pack_params(plan, jdata)
    lpos, n_lights = JM.pack_light_positions(jspec, jdata)
    rough = jdata.materials["roughness"].reshape(-1, 1)
    jout = JM.pallas_geometry(plan, packed, lpos, n_lights, jnp.asarray(o),
                              jnp.asarray(d), jspec.max_dist,
                              mat_rough_vec=rough if refl else None, **kw)
    jout = jax.tree.map(np.asarray, jout)

    tpacked = TM.pack_scene(tspec, tdata)
    tlpos, t_lights = TM.pack_light_positions(tspec, tdata)
    assert t_lights == n_lights
    tout = TM.geometry(tpacked, tlpos, t_lights, torch.as_tensor(o),
                       torch.as_tensor(d), tspec.max_dist,
                       mat_rough_vec=tdata.materials["roughness"]
                       if refl else None, **kw)
    return jout, tout, (o, d, jspec, jdata, n_lights, tpacked)


CASES = [("gi", "radiance"), ("gi", "screen"), ("basic", "radiance"),
         ("basic", "screen")]


@functools.cache
def _run_once(case, flags=()):
    """_run_both, each (case, flags) run once per module: the JAX run is
    the slow part."""
    return _run_both(*case, **dict(flags))


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def geom(request):
    """JAX interpret-mode and port outputs for one (scene, variant)."""
    return request.param, _run_once(request.param)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _shadow_enabled(pos, normal, hit, lpos, n_lights):
    """The kernel's shadow-march enable: hit and n·l > EPSILON, with the
    light direction from the un-offset hit point."""
    en = []
    for li in range(n_lights):
        tl = lpos[3 * li:3 * li + 3, 0][None] - pos
        dist = np.sqrt((tl * tl).sum(-1))
        ldir = tl * (1.0 / np.maximum(dist, 1e-9))[:, None]
        en.append(hit & ((normal * ldir).sum(-1) > 1e-3))
    return np.stack(en) if en else np.zeros((0, pos.shape[0]), bool)


def test_geometry_primary_matches_jax(geom):
    case, (j, t, _) = geom
    np.testing.assert_array_equal(_np(t["hit"]), j["hit"])
    np.testing.assert_array_equal(_np(t["idx"]), j["idx"])
    np.testing.assert_array_equal(_np(t["mid"]), j["mid"])
    np.testing.assert_allclose(_np(t["t"]), j["t"], rtol=1e-5, atol=1e-5)
    assert j["hit"].sum() > N_RAYS // 4, "too few hits to test anything"


def test_geometry_surface_outputs_match_jax(geom):
    case, (j, t, (o, d, jspec, jdata, n_lights, _)) = geom
    hit = j["hit"]
    np.testing.assert_allclose(_np(t["normal"])[hit], j["normal"][hit],
                               atol=1e-4)
    np.testing.assert_allclose(_np(t["ao"])[hit], j["ao"][hit], atol=1e-5)
    lpos, _ = JM.pack_light_positions(jspec, jdata)
    pos = o + j["t"][:, None] * d
    sh_on = _shadow_enabled(pos, j["normal"], hit, np.asarray(lpos),
                            n_lights)
    assert _np(t["shadows"]).shape == j["shadows"].shape
    np.testing.assert_allclose(_np(t["shadows"])[sh_on], j["shadows"][sh_on],
                               atol=1e-4)
    np.testing.assert_array_equal(_np(t["vis8"])[:, hit], j["vis8"][:, hit])


def test_geometry_reflection_matches_jax(geom):
    (scene, variant), (j, t, (o, d, jspec, jdata, n_lights, packed)) = geom
    if variant != "screen":
        assert t["refl"] is None and j["refl"] is None
        return
    jr, tr = j["refl"], t["refl"]
    r_hit = jr["hit"]
    assert r_hit.sum() > 0
    np.testing.assert_array_equal(_np(tr["hit"]), r_hit)
    np.testing.assert_array_equal(_np(tr["mid"])[r_hit], jr["mid"][r_hit])
    np.testing.assert_array_equal(_np(tr["best_pid"])[r_hit],
                                  jr["best_pid"][r_hit])
    np.testing.assert_allclose(_np(tr["normal"])[r_hit], jr["normal"][r_hit],
                               atol=1e-4)
    # The reflected ray starts from the primary hit point and FD normal.
    # On a few rays the normals are not bit-equal between the backends,
    # because XLA's CPU backend fuses multiply-adds where the port rounds
    # every operation; the FD normal's division by 2e-3 turns that into up
    # to ~1e-4, and the bounce carries it on (a 3.6e-5 normal difference
    # moved r_t by 1.2e-4 relative 6.8 units on).  The loose lanes are
    # those whose JAX normal the fused recompute reproduces bit for bit
    # (_loose_lanes), at most MAX_LOOSE_SHARE of the reflection hits.  Their
    # JAX reflection starts from JAX's own rounding, so the port's bounce is
    # held instead to JAX's bounce from the port's reflection rays
    # (_jax_bounce), at the primary tolerances.  Every other reflection hit,
    # a differing normal the witness does not explain included, is held to
    # JAX's reflection at the primary tolerances.  Misses: both past
    # max_dist; rays not reflected: 0.
    _, loose = _loose_lanes(j, t, o, d, packed)
    assert loose.sum() <= MAX_LOOSE_SHARE * r_hit.sum()
    pos = o + j["t"][:, None] * d
    so = pos + j["normal"] * trm.SURFACE_OFFSET
    rd = d - (2.0 * (d * j["normal"]).sum(-1))[:, None] * j["normal"]
    lpos, _ = JM.pack_light_positions(jspec, jdata)
    tight = r_hit & ~loose
    sh_on = _shadow_enabled(so + jr["t"][:, None] * rd, jr["normal"], tight,
                            np.asarray(lpos), n_lights)
    np.testing.assert_allclose(_np(tr["t"])[tight], jr["t"][tight],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tr["best_dir"])[tight],
                               jr["best_dir"][tight], atol=1e-4)
    np.testing.assert_allclose(_np(tr["shadows"])[sh_on], jr["shadows"][sh_on],
                               atol=1e-4)
    if loose.any():
        b, (bo, bd) = _jax_bounce(t, o, d, jspec, jdata, n_lights, loose)
        sub = {k: _np(v)[..., loose] if k in ("shadows", "vis8")
               else _np(v)[loose] for k, v in tr.items()}
        np.testing.assert_array_equal(b["hit"], True)
        np.testing.assert_array_equal(sub["mid"], b["mid"])
        np.testing.assert_allclose(sub["t"], b["t"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(sub["normal"], b["normal"], atol=1e-4)
        b_on = _shadow_enabled(bo + b["t"][:, None] * bd, b["normal"],
                               b["hit"], np.asarray(lpos), n_lights)
        np.testing.assert_allclose(sub["shadows"][b_on], b["shadows"][b_on],
                                   atol=1e-4)
        np.testing.assert_array_equal(sub["vis8"], b["vis8"])
        np.testing.assert_allclose(
            sub["best_dir"], _best_dir(bo + b["t"][:, None] * bd,
                                       sub["best_pid"]), atol=1e-4)
    rt, jt = _np(tr["t"]), jr["t"]
    on = jt > 0
    np.testing.assert_array_equal(rt[on & ~r_hit] >= jspec.max_dist,
                                  jt[on & ~r_hit] >= jspec.max_dist)
    np.testing.assert_array_equal(rt[~on], 0.0)
    np.testing.assert_array_equal(_np(tr["vis8"])[:, r_hit],
                                  jr["vis8"][:, r_hit])


def _jax_bounce(t, o, d, jspec, jdata, n_lights, lanes):
    """JAX's pallas_geometry (interpret mode, no AO) on the port's
    reflection rays of ``lanes``, built as geometry_reference builds them
    from the port's primary t and normal: (outputs, (origins, dirs))."""
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    normal = t["normal"]
    so = to + t["t"][:, None] * td + normal * trm.SURFACE_OFFSET
    rd = td - (2.0 * dot(td, normal))[:, None] * normal
    bo, bd = so[lanes].numpy(), rd[lanes].numpy()
    plan = JM.build_plan(jspec)
    lpos, _ = JM.pack_light_positions(jspec, jdata)
    cfg = screen_shade_config(False)
    out = JM.pallas_geometry(
        plan, JM.pack_params(plan, jdata), lpos, n_lights, jnp.asarray(bo),
        jnp.asarray(bd), jspec.max_dist, probe_spacing=GRID["spacing"],
        probe_dims=GRID["dims"], surface_offset=trm.SURFACE_OFFSET,
        ao_steps=cfg.ambient_occlusion_steps, want_ao=False,
        max_steps=cfg.max_march_steps)
    return jax.tree.map(np.asarray, out), (bo, bd)


def _best_dir(p, pid):
    """The direction from the probe id ``pid`` of GRID to p, as the mode-2
    best-probe pick emits it."""
    dims, sp = GRID["dims"], np.float32(GRID["spacing"])
    pid = pid.astype(np.int64)
    corner = np.stack([pid % dims[0], pid // dims[0] % dims[1],
                       pid // (dims[0] * dims[1])], axis=1).astype(np.float32)
    w = corner * sp - p
    pdist = np.maximum(np.sqrt((w * w).sum(-1)), np.float32(1e-6))
    return -(w * (np.float32(1.0) / pdist)[:, None])


def _fma(a, b, c):
    """f32 fused multiply-add: the float64 product of two float32 values is
    exact, so only the sum rounds (to float64, then float32)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _fused_sphere_normal(o, d, t, center, radius):
    """The tetrahedron FD normal at o + t·d of the sphere (center[K, 3],
    radius[K]) with the multiply-adds fused as XLA's CPU backend fuses
    them: p = fma(t, d, o) and every sum of squares as
    fma(z, z, fma(x, x, y*y))."""
    p = _fma(t[:, None], d, o)
    f = []
    for s in TET:
        q = [p[:, a] + np.float32(s[a] * TM.NORMAL_H) for a in range(3)]
        dx, dy, dz = (center[:, a] - q[a] for a in range(3))
        f.append(np.sqrt(_fma(dz, dz, _fma(dx, dx, dy * dy))) - radius)
    gx = f[0] - f[1] - f[2] + f[3]
    gy = -f[0] - f[1] + f[2] + f[3]
    gz = -f[0] + f[1] - f[2] + f[3]
    norm = np.sqrt(_fma(gz, gz, _fma(gx, gx, gy * gy)) + np.float32(1e-24))
    return np.stack([gx / norm, gy / norm, gz / norm], axis=1)


def _loose_lanes(j, t, o, d, packed):
    """(differ, loose): the reflection hits whose primary normal is not
    bit-equal between the backends, and those of them whose JAX normal is
    XLA's rounding: the hit lies on a sphere and _fused_sphere_normal,
    recomputed from JAX's t, reproduces JAX's normal bit for bit."""
    differ = j["refl"]["hit"] & ~np.all(_np(t["normal"]) == j["normal"],
                                        axis=1)
    ids = np.flatnonzero(differ)
    gidx = packed.info[:, 0].numpy()
    slot = np.array([np.flatnonzero(gidx == i)[0] for i in j["idx"][ids]],
                    dtype=int)
    on_sphere = slot < packed.counts[0]    # the sphere run comes first
    ids, slot = ids[on_sphere], slot[on_sphere]
    rows = packed.rows.numpy()[slot]
    fused = _fused_sphere_normal(o[ids], d[ids], j["t"][ids], rows[:, 0:3],
                                 rows[:, 3])
    loose = np.zeros_like(differ)
    loose[ids[np.all(fused == j["normal"][ids], axis=1)]] = True
    return differ, loose


def test_loose_lanes_are_xla_fma(geom):
    """Witness for the loose reflection lanes: every primary normal that is
    not bit-equal between the backends lies on a sphere, and recomputing
    it from JAX's t with XLA's fused multiply-adds reproduces JAX's normal
    bit for bit, lane by lane.  So the difference is the JAX reference's
    rounding, not the port's arithmetic (which the CUDA kernel, built with
    -fmad=false, follows).  How many lanes differ depends on the host
    (MAX_LOOSE_SHARE)."""
    (scene, variant), (j, t, (o, d, _, _, _, packed)) = geom
    if variant != "screen":
        return
    differ, loose = _loose_lanes(j, t, o, d, packed)
    np.testing.assert_array_equal(loose, differ)
    assert loose.sum() <= MAX_LOOSE_SHARE * j["refl"]["hit"].sum()


# ---------------------------------------------------------------------------
# want_shadows / want_vis: the primary hit's marches skipped
# ---------------------------------------------------------------------------

MARCHES_OFF = {"no-shadows": {"want_shadows": False},
               "no-vis": {"want_vis": False},
               "neither": {"want_shadows": False, "want_vis": False}}


@pytest.fixture(scope="module",
                params=[(c, f) for c in CASES for f in MARCHES_OFF],
                ids=lambda p: "-".join(p[0]) + "-" + p[1])
def geom_off(request):
    """The cases of ``geom`` rerun in both packages with marches turned
    off: (flags, the same tuple as ``geom``, the case's flags-on run)."""
    case, name = request.param
    flags = MARCHES_OFF[name]
    return (flags, (case, _run_once(case, tuple(sorted(flags.items())))),
            (case, _run_once(case)))


def test_geometry_with_marches_off_matches_jax(geom_off):
    """JAX's interpret-mode kernel and the port's plain version with the
    same want_* flags, under the tolerances of the three tests above."""
    _, run, _ = geom_off
    test_geometry_primary_matches_jax(run)
    test_geometry_surface_outputs_match_jax(run)
    test_geometry_reflection_matches_jax(run)


def test_marches_off_give_ones_and_leave_the_rest(geom_off):
    """A skipped march's output is exactly one on every ray, in both
    packages (the port keeps its f32[L, N] shape); every other output,
    the reflection's included, is bit-equal to the flags-on call."""
    flags, (_, (j, t, _)), (_, (_, t_on, _)) = geom_off
    off = [k for k, want in (("shadows", "want_shadows"), ("vis8", "want_vis"))
           if not flags.get(want, True)]
    for key in off:
        np.testing.assert_array_equal(_np(t[key]), 1.0)
        np.testing.assert_array_equal(j[key], 1.0)
        assert t[key].shape == t_on[key].shape
    for key in ("t", "hit", "idx", "mid", "normal", "ao", "shadows",
                "vis8"):
        if key not in off:
            assert torch.equal(t[key], t_on[key]), key
    if t_on["refl"] is None:
        assert t["refl"] is None
        return
    for key, val in t_on["refl"].items():
        assert torch.equal(t["refl"][key], val), key


@pytest.mark.parametrize("flags", list(MARCHES_OFF.values()),
                         ids=list(MARCHES_OFF))
def test_scene_ctx_geometry_forwards_the_march_flags(flags):
    """SceneCtx.geometry passes want_shadows and want_vis on to the
    wrapper, as the JAX package's SceneCtx passes them to
    pallas_geometry."""
    from madarch_tpu_torch.examples import scenes as tscenes
    from madarch_tpu_torch.render.context import SceneCtx
    r = tscenes.global_illumination(width=16, height=16, device="cpu")
    o, d = (torch.as_tensor(x[:64]) for x in _gi_rays("screen"))
    ctx = SceneCtx(r.spec, r.scene_data)
    got = ctx.geometry(o, d, r.probes, r.screen_cfg, **flags)
    want = TM.geometry(ctx.packed, ctx.lpos_vec, ctx.n_light_slots, o, d,
                       ctx.max_dist, probe_spacing=r.probes.grid_spacing,
                       probe_dims=r.probes.grid_dimensions,
                       surface_offset=trm.SURFACE_OFFSET,
                       ao_steps=r.screen_cfg.ambient_occlusion_steps,
                       max_steps=r.screen_cfg.max_march_steps,
                       refl_shadows=r.screen_cfg.add_indirect_specular,
                       **flags)
    assert got["hit"].any()
    for key in ("t", "normal", "ao", "shadows", "vis8"):
        assert torch.equal(got[key], want[key]), key
    on = ctx.geometry(o, d, r.probes, r.screen_cfg)
    for key, want_key in (("shadows", "want_shadows"), ("vis8", "want_vis")):
        if flags.get(want_key, True):
            assert torch.equal(got[key], on[key])
        else:
            assert bool((got[key] == 1).all())
            assert not bool((on[key][:, on["hit"]] == 1).all())


# ---------------------------------------------------------------------------
# The masked launch without AO (specular mode 3's reflection geometry)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["gi", "basic"])
def masked(request):
    """Mode-3 reflection rays: from each primary hit of the screen variant
    offset along its normal, the view ray reflected, enabled where the hit
    is on a material of roughness < 0.75, and further on a seeded 3 in 4
    (the GI room's walls are all glossy enough, so every GI ray would be
    on).  Both packages get these rays as the same numpy arrays; JAX runs
    ``pallas_geometry(enabled=..., want_ao=False)``, the port
    ``geometry(enabled=..., ao_steps=0)``."""
    jspec, jdata, tspec, tdata = _scene(request.param)
    if request.param == "gi":
        o, d = _gi_rays("screen")
    else:
        o, d = (np.array(x) for x in rand_rays(N_RAYS, seed=31))
    kw = dict(probe_spacing=GRID["spacing"], probe_dims=GRID["dims"],
              surface_offset=trm.SURFACE_OFFSET, max_steps=300)
    packed = TM.pack_scene(tspec, tdata)
    lpos, n_lights = TM.pack_light_positions(tspec, tdata)
    g = TM.geometry(packed, lpos, n_lights, torch.as_tensor(o),
                    torch.as_tensor(d), tspec.max_dist, ao_steps=3, **kw)
    pos = torch.as_tensor(o) + g["t"][:, None] * torch.as_tensor(d)
    _, _, rough = TS.material_lookup(tdata, g["mid"])
    keep = np.random.RandomState(32).rand(N_RAYS) > 0.25
    en = (g["hit"] & (rough < 0.75)).numpy() & keep
    ro = (pos + g["normal"] * trm.SURFACE_OFFSET).numpy()
    rd = reflect(torch.as_tensor(d), g["normal"]).numpy()

    plan = JM.build_plan(jspec)
    jlpos, _ = JM.pack_light_positions(jspec, jdata)
    jout = JM.pallas_geometry(plan, JM.pack_params(plan, jdata), jlpos,
                              n_lights, jnp.asarray(ro), jnp.asarray(rd),
                              jspec.max_dist, enabled=jnp.asarray(en),
                              want_ao=False, ao_steps=3, **kw)
    tout = TM.geometry(packed, lpos, n_lights, torch.as_tensor(ro),
                       torch.as_tensor(rd), tspec.max_dist, ao_steps=0,
                       enabled=torch.as_tensor(en), **kw)
    return (jax.tree.map(np.asarray, jout), tout,
            (ro, rd, en, jspec, jdata, n_lights))


def test_masked_geometry_matches_jax(masked):
    """Tolerances as for the primary outputs above.  A disabled ray does
    not march (t exactly 0), is no hit (idx -1) and enables none of its
    shadow and visibility marches; AO is off (all ones) in both."""
    j, t, (o, d, en, jspec, jdata, n_lights) = masked
    assert en.any() and not en.all()
    np.testing.assert_array_equal(_np(t["hit"]), j["hit"])
    np.testing.assert_array_equal(_np(t["idx"]), j["idx"])
    np.testing.assert_allclose(_np(t["t"]), j["t"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(t["t"])[~en], 0.0)
    np.testing.assert_array_equal(j["t"][~en], 0.0)
    assert not j["hit"][~en].any() and (j["idx"][~en] == -1).all()
    np.testing.assert_array_equal(_np(t["ao"]), 1.0)
    np.testing.assert_array_equal(j["ao"], 1.0)
    hit = j["hit"]
    assert hit.any(), "too few hits to test anything"
    np.testing.assert_array_equal(_np(t["mid"])[hit], j["mid"][hit])
    np.testing.assert_allclose(_np(t["normal"])[hit], j["normal"][hit],
                               atol=1e-4)
    lpos, _ = JM.pack_light_positions(jspec, jdata)
    sh_on = _shadow_enabled(o + j["t"][:, None] * d, j["normal"], hit,
                            np.asarray(lpos), n_lights)
    np.testing.assert_allclose(_np(t["shadows"])[sh_on], j["shadows"][sh_on],
                               atol=1e-4)
    np.testing.assert_array_equal(_np(t["vis8"])[:, hit], j["vis8"][:, hit])
    assert t["refl"] is None and j["refl"] is None


# ---------------------------------------------------------------------------
# Packing and the wrapper
# ---------------------------------------------------------------------------

def test_pack_scene_layout():
    """One slot per evaluated primitive in three typed runs (spheres,
    planes, boxes: two rows each), with capacity-based global indices;
    dynamic counts pack dead slots inert."""
    jspec, jdata, tspec, tdata = _scene("basic")
    packed = TM.pack_scene(tspec, tdata)
    assert packed.counts == (4, 6, 4)      # capacities: counts are dynamic
    assert packed.n_slots == 14 and packed.rows.shape == (4 + 6 + 2 * 4, 4)
    np.testing.assert_array_equal(packed.info[:, 0].numpy(), np.arange(14))
    np.testing.assert_array_equal(
        TM.slot_live(packed).numpy(),
        np.array([1, 1, 0, 0, 1] + [0] * 5 + [1, 0, 0, 0], bool))
    r = packed.rows.numpy()
    np.testing.assert_allclose(r[1], [2.0, 1.0, 7.0, 0.7])
    np.testing.assert_array_equal(r[2], [0, 0, 0, -TM.BIG])      # sphere
    np.testing.assert_array_equal(r[5], [0, 0, 0, TM.BIG])       # plane
    np.testing.assert_array_equal(r[14 + 1, :3], [-TM.BIG] * 3)  # box side
    gspec, _, gtspec, gtdata = _scene("gi")
    gpacked = TM.pack_scene(gtspec, gtdata)
    np.testing.assert_array_equal(gpacked.info[:, 0].numpy(),
                                  [0] + list(range(20, 26)) + [30])
    assert TM.slot_live(gpacked).all()


def test_pack_scene_rejects_unported_types():
    tri = TP.PrimitiveType(name="sphere", fields=TP.Sphere.fields,
                           sdf=TP.Sphere.sdf)
    spec = TS.SceneSpec(prims=((tri, 2),), lights=())
    b = TS.SceneBuilder(spec)
    b.add_primitive(tri, center=(0, 0, 0), radius=1.0, material_id=0)
    with pytest.raises(NotImplementedError):
        TM.pack_scene(spec, b.device_data("cpu"))


def test_geometry_on_cpu_runs_the_plain_version_uncounted():
    _, _, tspec, tdata = _scene("gi")
    packed = TM.pack_scene(tspec, tdata)
    lpos, n_lights = TM.pack_light_positions(tspec, tdata)
    o, d = (torch.as_tensor(x) for x in _gi_rays("screen"))
    kw = dict(probe_spacing=GRID["spacing"], probe_dims=GRID["dims"],
              surface_offset=trm.SURFACE_OFFSET, ao_steps=3)
    before = TM.launch_counts()["geometry"]
    a = TM.geometry(packed, lpos, n_lights, o[:32], d[:32], 20.0, **kw)
    b = TM.geometry_reference(packed, lpos, n_lights, o[:32], d[:32], 20.0,
                              **kw)
    assert TM.launch_counts()["geometry"] == before
    for k in ("t", "hit", "idx", "mid", "normal", "ao", "shadows", "vis8"):
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    with pytest.raises(TypeError):
        TM.geometry(packed, lpos, n_lights, o[:8].double(), d[:8], 20.0,
                    **kw)
    with pytest.raises(ValueError):
        TM.geometry(packed, lpos, n_lights, o[:8], d[:9], 20.0, **kw)
    with pytest.raises(ValueError):
        TM.geometry(packed, lpos, n_lights, o[:8].T.contiguous().T, d[:8],
                    20.0, **kw)
    with pytest.raises(TypeError):
        TM.geometry(packed, lpos, n_lights, o[:8], d[:8], 20.0,
                    enabled=torch.ones(8), **kw)


# ---------------------------------------------------------------------------
# The plain marches against madarch_tpu.render.raymarch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def basic():
    jspec, jdata, tspec, tdata = _scene("basic")
    jsdf = jax.vmap(lambda p: jscene_sdf(jspec, jdata, p))

    def tsdf(p):
        return TS.scene_sdf(tspec, tdata, p)
    return jsdf, tsdf


@pytest.mark.parametrize("masked", [False, True])
def test_raycast_matches_jax(basic, masked):
    jsdf, tsdf = basic
    o, d = rand_rays(64, seed=41)
    en = np.random.RandomState(42).rand(64) > 0.5 if masked else None
    t_ref, hit_ref, _ = jrm.raycast(jsdf, o, d, 20.0, enabled=None
                                    if en is None else jnp.asarray(en))
    t, hit, _ = trm.raycast(tsdf, torch.as_tensor(np.array(o)),
                            torch.as_tensor(np.array(d)), 20.0,
                            enabled=None if en is None
                            else torch.as_tensor(en))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_ref))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), rtol=1e-5,
                               atol=1e-5)


def test_raycast_visibility_matches_jax(basic):
    jsdf, tsdf = basic
    o, d = rand_rays(64, seed=43)
    mx = np.random.RandomState(44).uniform(0.5, 10.0, 64).astype(np.float32)
    ref = jrm.raycast_visibility(jsdf, o, d, jnp.asarray(mx))
    got = trm.raycast_visibility(tsdf, torch.as_tensor(np.array(o)),
                                 torch.as_tensor(np.array(d)),
                                 torch.as_tensor(mx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("k", [64.0, 0.5])
def test_softshadows_matches_jax(basic, k):
    jsdf, tsdf = basic
    o, d = rand_rays(64, seed=45)
    mx = np.full(64, 12.0, np.float32)
    ref = jrm.softshadows(jsdf, o, d, jnp.zeros(64), jnp.asarray(mx), k)
    got = trm.softshadows(tsdf, torch.as_tensor(np.array(o)),
                          torch.as_tensor(np.array(d)), torch.zeros(64),
                          torch.as_tensor(mx), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_ambient_occlusion_matches_jax(basic):
    jsdf, tsdf = basic
    rng = np.random.RandomState(46)
    pos = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    n = rng.randn(64, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    ref = jrm.ambient_occlusion(jsdf, jnp.asarray(pos), jnp.asarray(n))
    got = trm.ambient_occlusion(tsdf, torch.as_tensor(pos),
                                torch.as_tensor(n))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def _struct_fields(source, struct):
    """(name, ctypes type) of each field of ``struct`` in csrc/<source>,
    in order."""
    import ctypes
    import os
    import re
    src = open(os.path.join(os.path.dirname(TM.__file__), "csrc",
                            source)).read()
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, src, re.S).group(1)
    want = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        if decl == "SceneArgs scene":
            want.append(("scene", TM._SceneArgs))
            continue
        m = re.match(r"(const )?(float4|float|int2|int|unsigned char|"
                     r"unsigned long long)(\*?) (.*)", decl)
        ptr, base = m.group(3), m.group(2)
        assert ptr or base in ("float", "int"), decl
        for name in m.group(4).split(","):
            name = name.strip()
            arr = re.match(r"(\w+)\[(\w+)\]", name)
            if arr:
                want.append((arr.group(1), ctypes.c_float * TM.MAX_AO_STEPS))
            else:
                want.append((name, ctypes.c_void_p if ptr else
                             ctypes.c_float if base == "float"
                             else ctypes.c_int))
    return want


def _assert_mirrors(got, want):
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, g), (_, w) in zip(got, want):
        if hasattr(w, "_length_"):
            assert g._type_ is w._type_ and g._length_ == w._length_, n
        else:
            assert g is w, n


def test_ctypes_args_mirror_the_kernel_struct():
    """The wrapper's ctypes struct lists GeomArgs's fields of
    csrc/geometry.cu in order, with matching C types (the kernel cannot
    run here, so drift would show only on the card)."""
    _assert_mirrors(TM._GeomArgs._fields_,
                    _struct_fields("geometry.cu", "GeomArgs"))
    _assert_mirrors(TM._SceneArgs._fields_,
                    _struct_fields("scene.cuh", "SceneArgs"))
    # the per-ray mask of specular mode 3's reflection launch
    assert dict(TM._GeomArgs._fields_)["enabled"] is ctypes.c_void_p


def test_ctypes_march_args_mirror_the_kernel_struct():
    """The same for MarchArgs of csrc/march.cu (raycast, visibility,
    softshadows)."""
    _assert_mirrors(TM._MarchArgs._fields_,
                    _struct_fields("march.cu", "MarchArgs"))
    fields = dict(TM._MarchArgs._fields_)
    assert fields["min_dists"] is ctypes.c_void_p
    assert fields["k"] is ctypes.c_float


def test_raycast_and_visibility_on_cpu_run_the_plain_versions_uncounted():
    """On CPU tensors the wrappers are their plain versions, launch no
    kernel and count nothing; they check their arguments as on the card."""
    _, _, tspec, tdata = _scene("basic")
    packed = TM.pack_scene(tspec, tdata)
    o, d = (torch.as_tensor(np.array(x)) for x in rand_rays(64, seed=51))
    en = torch.as_tensor(np.random.RandomState(52).rand(64) > 0.3)
    mx = torch.as_tensor(np.random.RandomState(53).uniform(
        -1.0, 12.0, 64).astype(np.float32))
    before = TM.launch_counts()
    for a, b in zip(TM.raycast(packed, o, d, 10.0, enabled=en),
                    TM.raycast_reference(packed, o, d, 10.0, enabled=en)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(
        TM.visibility(packed, o, d, mx, enabled=en),
        TM.visibility_reference(packed, o, d, mx, enabled=en), rtol=0,
        atol=0)
    assert TM.launch_counts() == before
    with pytest.raises(TypeError):
        TM.raycast(packed, o, d, 10.0, enabled=en.float())
    with pytest.raises(ValueError):
        TM.visibility(packed, o, d, mx[:8])
    with pytest.raises(TypeError):
        TM.visibility(packed, o, d, mx.double())


def test_scene_evals_count_active_lanes_times_slots():
    """The plain marches' evaluation count (the bound's operation count):
    a march step evaluates every live slot at each active lane only."""
    _, _, tspec, tdata = _scene("gi")
    packed = TM.pack_scene(tspec, tdata)
    slots = dict(zip(TM.scene_evals, (*packed.counts, 0)))
    p = torch.zeros((5, 3))
    with TM.counting():
        TM.scene_dist(packed, p, 20.0)
    assert TM.scene_evals == {c: 5 * n for c, n in slots.items()}
    assert TM.scene_eval_flops() == 5 * sum(TM.SLOT_FLOPS[c] * n
                                            for c, n in slots.items())
    # one ray that starts inside the floor stops on a hit after one step:
    # that step evaluated its end point, so no classification follows
    with TM.counting():
        TM.raycast_reference(packed, torch.tensor([[0.0, -2.0, 0.0]]),
                             torch.tensor([[0.0, 1.0, 0.0]]), 10.0)
    assert TM.scene_evals == {c: n for c, n in slots.items()}
    # one ray cut short of any surface by max_steps is classified once more
    o, d = torch.tensor([[0.0, 1.0, 0.0]]), torch.tensor([[0.0, 1.0, 0.0]])
    assert float(TM.scene_dist(packed, o, 20.0)[0]) > 0.5
    with TM.counting():
        t, hit, _ = TM.raycast_reference(packed, o, d, 10.0, max_steps=1)
    assert TM.scene_evals == {c: 2 * n for c, n in slots.items()}
    assert not bool(hit[0]) and 0.0 < float(t[0]) < 10.0


def test_geometry_reference_spends_nothing_at_a_miss():
    """At a miss the normal is the reversed ray and the AO 1, and the plain
    version evaluates the scene there no more than the kernel does (its
    count is behind the kernel's bound): a miss costs its march steps and
    one classification, the AO ao_steps evaluations per hit."""
    _, _, tspec, tdata = _scene("basic")
    packed = TM.pack_scene(tspec, tdata)
    lpos, n_lights = TM.pack_light_positions(tspec, tdata)
    o, d = (torch.as_tensor(np.array(x)) for x in rand_rays(96, seed=61))
    kw = dict(probe_spacing=GRID["spacing"], probe_dims=GRID["dims"],
              surface_offset=trm.SURFACE_OFFSET)

    def evaluations(**extra):
        with TM.counting():
            out = TM.geometry_reference(packed, lpos, n_lights, o, d, 20.0,
                                        **kw, **extra)
        per_point = {n // c for n, c in zip(TM.scene_evals.values(),
                                            packed.counts) if c}
        assert len(per_point) == 1
        return out, per_point.pop()

    out, with_ao = evaluations(ao_steps=3)
    hit = out["hit"]
    n_hit = int(hit.sum())
    assert 0 < n_hit < 96
    torch.testing.assert_close(out["normal"][~hit], -d[~hit], rtol=0, atol=0)
    assert bool((out["ao"][~hit] == 1.0).all())
    assert bool((out["ao"][hit] != 1.0).any())
    _, without_ao = evaluations(ao_steps=0)
    assert with_ao - without_ao == 3 * n_hit
    # the missing rays alone cost their march steps (raycast_reference's
    # count) and one classification each: no normal, AO, shadow or
    # visibility evaluation
    o, d = o[~hit].contiguous(), d[~hit].contiguous()
    out, misses = evaluations(ao_steps=3)
    assert not bool(out["hit"].any())
    steps = TM.raycast_reference(packed, o, d, 20.0, return_steps=True)[3]
    assert misses == int(steps.sum()) + o.shape[0]
