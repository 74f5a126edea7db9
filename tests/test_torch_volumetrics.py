"""Port parity: the volumetric (light_shafts) path of madarch_tpu_torch
against madarch_tpu.

- The plain raycast and visibility versions (``raycast_reference``,
  ``visibility_reference``: what the CUDA kernels of csrc/march.cu compute,
  and what their wrappers run on CPU tensors) against the JAX package's
  ``pallas_raycast`` / ``pallas_visibility`` in interpret mode, on the
  light_shafts scene (rays of the scattering pass, froxel-to-light rays)
  and on test_march_kernels.build_scene() (dynamic counts: dead slots read
  as each kernel's scene-distance cap).  Tolerances: hit and visibility
  exactly equal; t at rtol/atol 1e-5.
- ``take_static`` against the JAX package's, exactly.
- ``visibility_pass``, ``scattering_pass`` and ``composite`` against the
  JAX functions (jitted, XLA path) at small settings, a square and a
  non-square one: the visibility grid at atol 1e-5 with at most 0.1% of
  froxels apart (a visibility ray that ties flips a whole light term);
  the scattering map at atol 1e-5 from the same visibility grid; the
  composite at atol 1e-6 from identical inputs.

Inputs are made with numpy from seeds and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madarch_tpu.core import resample as JR
from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.ops import march as JM
from madarch_tpu.render import volumetrics as JV
from madarch_tpu.render.context import SceneCtx as JSceneCtx
from madarch_tpu_torch.core import resample as TR
from madarch_tpu_torch.core.config import ProbeSettings, VolumetricsSettings
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.ops import march as TM
from madarch_tpu_torch.render import volumetrics as TV
from madarch_tpu_torch.render.camera import camera_rays, pixel_grid
from madarch_tpu_torch.render.context import SceneCtx
from madarch_tpu_torch.scene import lights as TL
from madarch_tpu_torch.scene.scene import scene_data_from_numpy
from test_march_kernels import build_scene, rand_rays
from test_torch_config import jax_config, torch_threads  # noqa: F401
from test_torch_march import port_spec

pytestmark = pytest.mark.usefixtures("torch_threads")

FAST = ProbeSettings(radiance_resolution=8, irradiance_resolution=4,
                     probe_count=(4, 2), grid_dimensions=(2, 2, 2),
                     grid_spacing=(4.0, 4.0, 4.0))
VOLS = {
    "square": VolumetricsSettings(visibility_resolution=(8, 8, 8),
                                  visibility_step_size=0.5,
                                  scattering_resolution=(12, 12),
                                  scattering_step_size=0.5),
    "odd": VolumetricsSettings(visibility_resolution=(10, 6, 8),
                               visibility_step_size=0.5,
                               scattering_resolution=(14, 9),
                               scattering_step_size=0.5),
}
N_RAYS = 1024
DEFAULT_VOL = VolumetricsSettings()


def _light_shafts(vol=DEFAULT_VOL, size=32):
    """(JAX renderer, port spec, port data) of light_shafts: the port
    gets the JAX renderer's scene through scene_data_from_numpy."""
    jr = jscenes.light_shafts(width=size, height=size,
                              probes=jax_config(FAST),
                              volumetrics=jax_config(vol))
    tr = tscenes.light_shafts(width=size, height=size, probes=FAST,
                              volumetrics=vol, device="cpu")
    data = scene_data_from_numpy(jax.tree.map(np.asarray, jr.scene_data),
                                 "cpu")
    return jr, tr.spec, data


def _pallas(jspec, jdata):
    plan = JM.build_plan(jspec)
    assert plan.margin is None          # no culling on these scenes
    return plan, JM.pack_params(plan, jdata)


def _scattering_rays(rng, n):
    """n of the default scattering pass's 250² camera rays."""
    sx, sy = DEFAULT_VOL.scattering_resolution
    o, d = camera_rays(pixel_grid(sx, sy, "cpu"),
                       torch.tensor([2.0, 2.0, 0.0]), torch.eye(3))
    ids = rng.choice(sx * sy, n, replace=False)
    return o.reshape(-1, 3)[ids].numpy(), d.reshape(-1, 3)[ids].numpy()


def _froxel_rays(rng, n):
    """n froxel-to-light rays of the default visibility grid: points
    o + d·depth computed once in numpy (both packages get the same
    array), then the point light's direction and distance."""
    vx, vy, vz = DEFAULT_VOL.visibility_resolution
    o, d = camera_rays(pixel_grid(vx, vy, "cpu"),
                       torch.tensor([2.0, 2.0, 0.0]), torch.eye(3))
    o, d = o.reshape(-1, 3).numpy(), d.reshape(-1, 3).numpy()
    pix = rng.randint(0, vx * vy, n)
    depth = rng.randint(0, vz, n).astype(np.float32) \
        * np.float32(DEFAULT_VOL.visibility_step_size)
    pts = o[pix] + d[pix] * depth[:, None]
    light = {"position": torch.tensor([5.0, 3.0, 6.0]),
             "color": torch.tensor([0.9, 0.9, 0.9])}
    _, ldir, ldist = TL.PointLight.sample(light, torch.as_tensor(pts),
                                          torch.zeros(n, 3))
    return pts, ldir.numpy(), ldist.numpy()


def _pallas_raycast(jspec, jdata, o, d, max_dist, en):
    plan, packed = _pallas(jspec, jdata)
    jt, jhit, _ = JM.pallas_raycast(plan, packed, jnp.asarray(o),
                                    jnp.asarray(d), max_dist,
                                    enabled=jnp.asarray(en))
    return np.asarray(jt), np.asarray(jhit)


def test_raycast_matches_pallas_on_scattering_rays():
    """The scattering pass's rays, max_dist = max_depth = 10: with an
    enable mask, and without one (the enabled lanes of the masked JAX run
    are the unmasked run's, lane by lane)."""
    jr, tspec, tdata = _light_shafts()
    rng = np.random.RandomState(61)
    o, d = _scattering_rays(rng, N_RAYS)
    en = rng.rand(N_RAYS) > 0.25
    max_depth = DEFAULT_VOL.max_depth
    assert max_depth == 10.0
    jt, jhit = _pallas_raycast(jr.spec, jr.scene_data, o, d, max_depth,
                               en)
    packed = TM.pack_scene(tspec, tdata)
    t, hit, pos = TM.raycast_reference(packed, torch.as_tensor(o),
                                       torch.as_tensor(d), max_depth,
                                       enabled=torch.as_tensor(en))
    np.testing.assert_array_equal(hit.numpy(), jhit)
    np.testing.assert_allclose(t.numpy(), jt, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t.numpy()[~en], 0.0)
    # the room is closed: every enabled ray meets a wall inside max_depth
    assert jhit[en].all() and not jhit[~en].any()
    t1, hit1, _ = TM.raycast_reference(packed, torch.as_tensor(o),
                                       torch.as_tensor(d), max_depth)
    np.testing.assert_array_equal(hit1.numpy()[en], jhit[en])
    np.testing.assert_allclose(t1.numpy()[en], jt[en], rtol=1e-5, atol=1e-5)


def test_visibility_matches_pallas_on_froxel_rays():
    """Froxel-to-light rays of the default grid, with rays whose max
    distance is 0 or negative and disabled lanes: exactly equal."""
    jr, tspec, tdata = _light_shafts()
    rng = np.random.RandomState(62)
    pts, ldir, ldist = _froxel_rays(rng, N_RAYS)
    ldist[:16] = 0.0
    ldist[16:32] = -1.0
    en = rng.rand(N_RAYS) > 0.2
    plan, packed = _pallas(jr.spec, jr.scene_data)
    jvis = np.asarray(JM.pallas_visibility(
        plan, packed, jnp.asarray(pts), jnp.asarray(ldir),
        jnp.asarray(ldist), enabled=jnp.asarray(en)))
    vis = TM.visibility_reference(
        TM.pack_scene(tspec, tdata), torch.as_tensor(pts),
        torch.as_tensor(ldir), torch.as_tensor(ldist),
        enabled=torch.as_tensor(en))
    np.testing.assert_array_equal(vis.numpy(), jvis)
    np.testing.assert_array_equal(jvis[:32], 1.0)   # never marched
    np.testing.assert_array_equal(jvis[~en], 1.0)
    assert 0.1 < jvis[32:][en[32:]].mean() < 0.9, "want both outcomes"


@pytest.fixture(scope="module")
def dynamic():
    """build_scene(): capacities above the live counts (dead slots)."""
    jspec, jdata = build_scene()
    tdata = scene_data_from_numpy(jax.tree.map(np.asarray, jdata), "cpu")
    packed = TM.pack_scene(port_spec(jspec), tdata)
    assert (~TM.slot_live(packed)).sum() > 0
    return jspec, jdata, packed


def test_raycast_matches_pallas_with_dead_slots(dynamic):
    """Dead slots read as the raycast's own max_dist (10, below the scene's
    max_dist of 20); rays that leave upward see distances past it."""
    jspec, jdata, packed = dynamic
    o, d = (np.array(x) for x in rand_rays(512, seed=63))
    en = np.random.RandomState(64).rand(512) > 0.25
    jt, jhit = _pallas_raycast(jspec, jdata, o, d, 10.0, en)
    t, hit, _ = TM.raycast_reference(packed, torch.as_tensor(o),
                                     torch.as_tensor(d), 10.0,
                                     enabled=torch.as_tensor(en))
    np.testing.assert_array_equal(hit.numpy(), jhit)
    np.testing.assert_allclose(t.numpy(), jt, rtol=1e-5, atol=1e-5)
    assert jhit.any() and (jt[en] >= 10.0).any()


def test_visibility_matches_pallas_with_dead_slots(dynamic):
    """Dead slots read as the visibility kernel's cap (1e4); max distances
    out to 30 take rays past every live slot's reach."""
    jspec, jdata, packed = dynamic
    o, d = (np.array(x) for x in rand_rays(512, seed=65))
    rng = np.random.RandomState(66)
    mx = rng.uniform(-1.0, 30.0, 512).astype(np.float32)
    en = rng.rand(512) > 0.2
    plan, jpacked = _pallas(jspec, jdata)
    jvis = np.asarray(JM.pallas_visibility(
        plan, jpacked, jnp.asarray(o), jnp.asarray(d), jnp.asarray(mx),
        enabled=jnp.asarray(en)))
    vis = TM.visibility_reference(packed, torch.as_tensor(o),
                                  torch.as_tensor(d), torch.as_tensor(mx),
                                  enabled=torch.as_tensor(en))
    np.testing.assert_array_equal(vis.numpy(), jvis)
    on = en & (mx > 0)
    assert 0.0 < jvis[on].mean() < 1.0


# ---------------------------------------------------------------------------
# Resampling and the passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dst,src", [(12, 8), (250, 100), (9, 6), (7, 11)])
def test_take_static_matches_jax(dst, src):
    """Periodic (resolution resample) and aperiodic index maps."""
    rng = np.random.RandomState(dst * src)
    x = rng.randn(5, src, 3).astype(np.float32)
    for idx in (JR.floor_map(dst, src, offset=0.0), JR.floor_map(dst, src),
                rng.randint(0, src, dst)):
        np.testing.assert_array_equal(TR.floor_map(dst, src, offset=0.0),
                                      JR.floor_map(dst, src, offset=0.0))
        got = TR.take_static(torch.as_tensor(x), idx, axis=1)
        ref = JR.take_static(jnp.asarray(x), idx, axis=1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.fixture(scope="module", params=sorted(VOLS))
def passes(request):
    """Both packages' visibility grid, and scattering maps from the JAX
    grid, for one volumetrics setting."""
    vol = VOLS[request.param]
    jvol = jax_config(vol)
    jr, tspec, tdata = _light_shafts(vol)
    cam = jr.camera
    jvis = np.asarray(jax.jit(
        lambda data, pos, rot: JV.visibility_pass(
            jr.spec, data, jvol, None, pos, rot, max_steps=300))(
        jr.scene_data, cam.position, cam.orientation))
    jscat = np.asarray(jax.jit(
        lambda data, vis, pos, rot: JV.scattering_pass(
            jr.spec, data, jvol, JSceneCtx(jr.spec, data), vis, pos, rot,
            max_steps=300))(
        jr.scene_data, jnp.asarray(jvis), cam.position, cam.orientation))
    pos = torch.as_tensor(np.array(cam.position))
    rot = torch.as_tensor(np.array(cam.orientation))
    ctx = SceneCtx(tspec, tdata)
    tvis = TV.visibility_pass(tspec, tdata, vol, ctx, pos, rot)
    tscat = TV.scattering_pass(tspec, tdata, vol, ctx,
                               torch.tensor(jvis), pos, rot)
    return vol, jvis, tvis.numpy(), jscat, tscat.numpy()


def test_visibility_pass_matches_jax(passes):
    vol, jvis, tvis, _, _ = passes
    vx, vy, vz = vol.visibility_resolution
    assert tvis.shape == jvis.shape == (vz, vy, vx, 3)
    apart = np.abs(tvis - jvis).max(axis=-1) > 1e-5
    assert apart.mean() <= 1e-3, apart.sum()
    np.testing.assert_allclose(tvis[~apart], jvis[~apart], atol=1e-5)
    assert (jvis > 0).any() and (jvis == 0).any()


def test_scattering_pass_matches_jax(passes):
    vol, _, _, jscat, tscat = passes
    sx, sy = vol.scattering_resolution
    assert tscat.shape == jscat.shape == (sy, sx, 4)
    np.testing.assert_allclose(tscat, jscat, atol=1e-5)
    # some texels see a wall inside max_depth, some march to it
    assert (jscat[..., 3] < vol.max_depth).any()


@pytest.mark.parametrize("vol_name,w,h", [("square", 24, 24),
                                          ("odd", 20, 12), ("odd", 7, 30)])
def test_composite_matches_jax(vol_name, w, h):
    """Identical inputs: stored lengths drawn near the pixels' ray lengths,
    so the 3×3 search has close calls to settle."""
    vol = VOLS[vol_name]
    sx, sy = vol.scattering_resolution
    rng = np.random.RandomState(w * h)
    scat = rng.uniform(0.0, 1.0, (sy, sx, 4)).astype(np.float32)
    scat[..., 3] = rng.uniform(0.0, 10.0, (sy, sx))
    color = rng.uniform(0.0, 2.0, (h * w, 3)).astype(np.float32)
    ray_len = rng.uniform(0.0, 10.0, h * w).astype(np.float32)
    ref = JV.composite(jax_config(vol), jnp.asarray(scat),
                       jnp.asarray(color), jnp.asarray(ray_len), w, h, 20.0)
    got = TV.composite(vol, torch.as_tensor(scat), torch.as_tensor(color),
                       torch.as_tensor(ray_len), w, h, 20.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_phase_functions_match_jax():
    rng = np.random.RandomState(67)
    a = rng.randn(64, 3).astype(np.float32)
    b = rng.randn(64, 3).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    for tf, jf in ((TV.henyey_greenstein_phase, JV.henyey_greenstein_phase),
                   (TV.rayleigh_phase, JV.rayleigh_phase)):
        np.testing.assert_allclose(
            tf(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
            np.asarray(jf(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
