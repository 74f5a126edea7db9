"""Port parity: the penumbra march of madarch_tpu_torch against
madarch_tpu.

- ``softshadows`` on CPU tensors (its plain version, ``softshadows_reference``:
  what the CUDA kernel of csrc/march.cu computes) against the JAX package's
  ``pallas_softshadows`` in interpret mode, at k = 0.5 (where the Pallas
  kernel never culls): on the penumbra rays of a global_illumination
  mode-1 screen pass (from the reflection hit back toward each probe-cell
  corner, min 0.25) and on test_march_kernels.build_scene() (dead slots
  read as the 1e4 cap; disabled rays and max <= min return 1).
- the plain version against the JAX package's unculled XLA
  ``raymarch.softshadows`` on simple_scene at k = 64 and k = 0.5, with
  march lengths out to max_dist 20: the port is held to the unculled
  march, never to the culled Pallas output, whose penumbra margin sits
  below max_dist/k.

Tolerances: rtol/atol 1e-5, and the rays that hit geometry (factor 0)
the same set: both packages march the same steps, and XLA's CPU backend
may fuse multiply-adds that the port rounds one by one (last bits).
Inputs are made with numpy from seeds and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.ops import march as JM
from madarch_tpu.render import raymarch as jrm
from madarch_tpu.scene.scene import scene_sdf as jscene_sdf
from madarch_tpu_torch.core.config import ShadeConfig
from madarch_tpu_torch.core.vecmath import reflect
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.ops import march as TM
from madarch_tpu_torch.render import shading as TSH
from madarch_tpu_torch.render.camera import camera_rays, pixel_grid
from madarch_tpu_torch.render.context import SceneCtx
from madarch_tpu_torch.render.raymarch import SURFACE_OFFSET
from madarch_tpu_torch.scene.scene import material_lookup, \
    scene_data_from_numpy
from test_march_kernels import build_scene, rand_rays
from test_torch_config import torch_threads  # noqa: F401
from test_torch_march import port_spec

pytestmark = pytest.mark.usefixtures("torch_threads")

N_RAYS = 512
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_penumbra_close(got, ref):
    got, ref = _np(got), _np(ref)
    np.testing.assert_array_equal(got == 0.0, ref == 0.0)
    np.testing.assert_allclose(got, ref, **TOL)


def _pallas(jspec, jdata, rays, k):
    plan = JM.build_plan(jspec)
    packed = JM.pack_params(plan, jdata)
    return np.asarray(JM.pallas_softshadows(
        plan, packed, *(jnp.asarray(rays[key]) for key in
                        ("origins", "dirs", "min_dists", "max_dists")),
        k, enabled=jnp.asarray(rays["enabled"])))


def _port(packed, rays, k):
    return TM.softshadows(packed, *(torch.as_tensor(rays[key]) for key in
                                    ("origins", "dirs", "min_dists",
                                     "max_dists")),
                          k, enabled=torch.as_tensor(rays["enabled"]))


def mode1_penumbra_rays(r, data, n, seed):
    """n seeded penumbra rays of a mode-1 screen pass of renderer r over
    scene data ``data``, built as shading.sample_radiance_with_specular
    builds them (the primary geometry, the roughness gate, the reflection
    raycast, then glossy_corners), as numpy arrays."""
    cfg = ShadeConfig(indirect_specular_mode=1)
    ctx = SceneCtx(r.spec, data)
    cam = r.camera
    o, d = camera_rays(pixel_grid(r.width, r.height, "cpu"), cam.position,
                       cam.orientation)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    g = ctx.geometry(o, d, r.probes, cfg)
    pos = o + g["t"][:, None] * d
    _, _, rough = material_lookup(data, g["mid"])
    en = g["hit"] & (rough < 0.75)
    spec_dir = reflect(d, g["normal"])
    _, hit, spec_pos = ctx.raycast(pos + g["normal"] * SURFACE_OFFSET,
                                   spec_dir, r.spec.max_dist,
                                   max_steps=cfg.max_march_steps, enabled=en)
    rays = TSH.glossy_corners(r.probes, pos, spec_pos, en & hit)[3]
    ids = np.random.RandomState(seed).choice(rays["origins"].shape[0], n,
                                             replace=False)
    return {key: v[ids].contiguous().numpy() for key, v in rays.items()}


def test_softshadows_matches_pallas_on_gi_mode1_rays():
    jr = jscenes.global_illumination(width=48, height=48)
    port_gi = tscenes.global_illumination(width=48, height=48, device="cpu")
    data = scene_data_from_numpy(jax.tree.map(np.asarray, jr.scene_data),
                                 "cpu")
    rays = mode1_penumbra_rays(port_gi, data, N_RAYS, seed=71)
    assert np.all(rays["min_dists"] == np.float32(SURFACE_OFFSET))
    on = rays["enabled"] & (rays["min_dists"] < rays["max_dists"])
    assert on.mean() > 0.5, "most screen rays reflect to a hit"
    ref = _pallas(jr.spec, jr.scene_data, rays, TSH.GLOSSY_K)
    got = _port(TM.pack_scene(port_gi.spec, data), rays, TSH.GLOSSY_K)
    _assert_penumbra_close(got, ref)
    np.testing.assert_array_equal(ref[~on], 1.0)
    # both outcomes and a spread of soft values on the marched rays
    soft = (ref > 0.0) & (ref < 1.0)
    assert (ref[on] == 0.0).any() and soft[on].any()


@pytest.fixture(scope="module")
def dynamic():
    """build_scene(): capacities above the live counts (dead slots)."""
    jspec, jdata = build_scene()
    tdata = scene_data_from_numpy(jax.tree.map(np.asarray, jdata), "cpu")
    packed = TM.pack_scene(port_spec(jspec), tdata)
    assert (~TM.slot_live(packed)).sum() > 0
    return jspec, jdata, packed


def _random_rays(seed, n, min_hi, max_hi):
    o, d = (np.array(x) for x in rand_rays(n, seed=seed))
    rng = np.random.RandomState(seed + 1)
    mn = rng.uniform(0.0, min_hi, n).astype(np.float32)
    mx = rng.uniform(-1.0, max_hi, n).astype(np.float32)
    mx[:16] = mn[:16]                    # max == min: never marched
    return {"origins": o, "dirs": d, "min_dists": mn, "max_dists": mx,
            "enabled": rng.rand(n) > 0.2}


def test_softshadows_matches_pallas_with_dead_slots(dynamic):
    """Dead slots read as the 1e4 cap; march lengths out to 30 take rays
    past every live slot's reach; disabled rays and max <= min give 1."""
    jspec, jdata, packed = dynamic
    rays = _random_rays(72, N_RAYS, 1.0, 30.0)
    ref = _pallas(jspec, jdata, rays, TSH.GLOSSY_K)
    got = _port(packed, rays, TSH.GLOSSY_K)
    _assert_penumbra_close(got, ref)
    on = rays["enabled"] & (rays["min_dists"] < rays["max_dists"])
    np.testing.assert_array_equal(ref[~on], 1.0)
    assert (ref[on] == 0.0).any() and (ref[on] > 0.0).any()


@pytest.fixture(scope="module")
def simple():
    """simple_scene in both packages: its JAX spec with the 40 live counts
    baked in (the port's Renderer bakes them in too)."""
    jr = jscenes.simple_scene(width=32, height=32)
    tdata = scene_data_from_numpy(jax.tree.map(np.asarray, jr.scene_data),
                                  "cpu")
    tspec = port_spec(jr.spec)
    packed = TM.pack_scene(tspec, tdata)
    assert packed.n_slots == 40
    return jr.spec, jr.scene_data, packed


@pytest.mark.parametrize("k,min_hi", [(64.0, 0.0), (0.5, 0.5)])
def test_softshadows_matches_unculled_xla_on_simple_scene(simple, k, min_hi):
    """Rays from points of the room toward random directions, marched out
    to lengths of up to max_dist (20): the JAX package's XLA march over its
    own scene_sdf (no culling).  The room is closed, so no distance reaches
    either package's cap."""
    jspec, jdata, packed = simple
    rng = np.random.RandomState(73 if k > 1 else 74)
    o = rng.uniform((-0.9, -0.9, -5.9), (6.9, 6.9, 6.9),
                    (N_RAYS, 3)).astype(np.float32)
    d = rng.randn(N_RAYS, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mn = rng.uniform(0.0, min_hi, N_RAYS).astype(np.float32)
    mx = rng.uniform(0.0, jspec.max_dist, N_RAYS).astype(np.float32)
    en = rng.rand(N_RAYS) > 0.1
    jsdf = jax.vmap(lambda p: jscene_sdf(jspec, jdata, p))
    ref = jrm.softshadows(jsdf, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(mn), jnp.asarray(mx), k,
                          enabled=jnp.asarray(en))
    got = TM.softshadows(packed, torch.as_tensor(o), torch.as_tensor(d),
                         torch.as_tensor(mn), torch.as_tensor(mx), k,
                         enabled=torch.as_tensor(en))
    _assert_penumbra_close(got, ref)
    ref = np.asarray(ref)
    on = en & (mn < mx)
    soft = (ref > 0.0) & (ref < 1.0)
    assert (ref[on] == 0.0).any() and soft[on].any()


def test_softshadows_on_cpu_runs_the_plain_version_uncounted(dynamic):
    """On CPU tensors the wrapper is its plain version, launches no kernel
    and counts nothing; it checks its arguments as on the card."""
    _, _, packed = dynamic
    rays = {k: torch.as_tensor(v)
            for k, v in _random_rays(75, 64, 0.5, 12.0).items()}
    before = TM.launch_counts()["softshadows"]
    args = (packed, rays["origins"], rays["dirs"], rays["min_dists"],
            rays["max_dists"], 0.5)
    torch.testing.assert_close(
        TM.softshadows(*args, enabled=rays["enabled"]),
        TM.softshadows_reference(*args, enabled=rays["enabled"]),
        rtol=0, atol=0)
    assert TM.launch_counts()["softshadows"] == before
    with pytest.raises(TypeError):
        TM.softshadows(*args, enabled=rays["enabled"].float())
    with pytest.raises(ValueError):
        TM.softshadows(packed, rays["origins"], rays["dirs"],
                       rays["min_dists"][:8], rays["max_dists"], 0.5)
    with pytest.raises(TypeError):
        TM.softshadows(packed, rays["origins"], rays["dirs"],
                       rays["min_dists"], rays["max_dists"].double(), 0.5)

