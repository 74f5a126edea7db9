"""Port parity: DDGI probe atlases of madarch_tpu_torch against
madarch_tpu, on seeded random atlases and lookups, at atol 1e-5 (float32
contractions summed in another order).  Each package gets its own
ProbeSettings, built from the same fields."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madarch_tpu.render import probes as JP
from madarch_tpu_torch.core.config import ProbeSettings
from madarch_tpu_torch.render import probes as TP
from test_torch_config import jax_config, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

ATOL = 1e-5
SETTINGS = {
    "default": ProbeSettings(),
    "fast": ProbeSettings(radiance_resolution=8, irradiance_resolution=4,
                          probe_count=(4, 2), grid_dimensions=(2, 2, 2),
                          grid_spacing=(4.0, 4.0, 4.0)),
}


def _atlas(rng, shape):
    return rng.uniform(0.0, 2.0, shape).astype(np.float32)


def _dirs(rng, n):
    v = rng.randn(n, 3).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol,
                               rtol=1e-5)


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_integrate_irradiance_matches_jax(name):
    s = SETTINGS[name]
    js = jax_config(s)
    rad = _atlas(np.random.RandomState(1), s.radiance_atlas_shape)
    _close(TP.integrate_irradiance(s, torch.as_tensor(rad)),
           JP.integrate_irradiance(js, jnp.asarray(rad)))


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_sample_irradiance_with_vis8_matches_jax(name):
    s = SETTINGS[name]
    js = jax_config(s)
    rng = np.random.RandomState(2)
    irr = _atlas(rng, s.irradiance_atlas_shape)
    hi = np.array(s.grid_dimensions) * np.array(s.grid_spacing)
    pos = rng.uniform(-1.0, hi + 1.0, (128, 3)).astype(np.float32)
    normal = _dirs(rng, 128)
    vis8 = (rng.rand(8, 128) > 0.3).astype(np.float32)
    ref = JP.sample_irradiance(js, None, jnp.asarray(irr), jnp.asarray(pos),
                               jnp.asarray(normal), vis8=jnp.asarray(vis8))
    got = TP.sample_irradiance(s, torch.as_tensor(irr), torch.as_tensor(pos),
                               torch.as_tensor(normal),
                               vis8=torch.as_tensor(vis8))
    _close(got, ref)


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_radiance_mip1_all_tiles_matches_jax(name):
    """The mode-2 lookup: mip 1 of the radiance atlas sampled in every tile
    at once."""
    s = SETTINGS[name]
    js = jax_config(s)
    rng = np.random.RandomState(3)
    rad = _atlas(rng, s.radiance_atlas_shape)
    ray_id = np.array(JP.dir_to_ray_id(jnp.asarray(_dirs(rng, 96))))
    res = s.radiance_resolution // 2
    jm = JP.radiance_mip1(js, jnp.asarray(rad))
    tm = TP.radiance_mip1(s, torch.as_tensor(rad))
    _close(tm, jm)
    _close(TP.sample_all_tiles_bilinear(s, tm, torch.as_tensor(ray_id), res),
           JP.sample_all_tiles_bilinear(js, jm, jnp.asarray(ray_id), res))


def test_bilinear_weights_match_jax():
    rng = np.random.RandomState(4)
    # includes lookups at and beyond the half-texel clamp
    ray_id = np.concatenate([rng.rand(64, 2), [[0.0, 1.0], [1.0, 0.0],
                                               [0.01, 0.99]]]).astype(
        np.float32)
    for res in (4, 8, 16):
        for g, r in zip(
                TP.bilinear_tile_weight_factors(torch.as_tensor(ray_id), res),
                JP.bilinear_tile_weight_factors(jnp.asarray(ray_id), res)):
            _close(g, r)


def test_probe_one_hot_combine_matches_jax():
    rng = np.random.RandomState(5)
    n, p, k = 64, 36, 8
    vals = rng.randn(n, p, 3).astype(np.float32)
    pids = rng.randint(0, p, (k, n)).astype(np.int32)
    weights = rng.rand(k, n).astype(np.float32)
    _close(TP.probe_one_hot_combine(p, torch.as_tensor(pids),
                                    torch.as_tensor(weights),
                                    torch.as_tensor(vals)),
           JP.probe_one_hot_combine(p, jnp.asarray(pids),
                                    jnp.asarray(weights), jnp.asarray(vals)))


def test_octahedral_mapping_matches_jax():
    rng = np.random.RandomState(6)
    v = np.concatenate([_dirs(rng, 64), np.eye(3, dtype=np.float32),
                        -np.eye(3, dtype=np.float32)])
    rid = TP.dir_to_ray_id(torch.as_tensor(v))
    _close(rid, JP.dir_to_ray_id(jnp.asarray(v)))
    _close(TP.ray_id_to_dir(rid), JP.ray_id_to_dir(jnp.asarray(rid.numpy())))
    _close(TP.ray_id_to_dir(rid), v, atol=1e-5)


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_probe_addressing_matches_jax(name):
    s = SETTINGS[name]
    js = jax_config(s)
    _close(TP.probe_world_positions(s, "cpu"), JP.probe_world_positions(js))
    _close(TP.texel_directions(s.radiance_resolution, "cpu"),
           JP.texel_directions(s.radiance_resolution))
    rad = _atlas(np.random.RandomState(7), s.radiance_atlas_shape)
    tiles = TP.atlas_to_tiles(s, torch.as_tensor(rad), s.radiance_resolution)
    _close(tiles, JP.atlas_to_tiles(js, jnp.asarray(rad),
                                    s.radiance_resolution))
    _close(TP.tiles_to_atlas(s, tiles, s.radiance_resolution), rad)
    gp = np.stack(np.meshgrid(*(np.arange(d) for d in s.grid_dimensions),
                              indexing="ij"), -1).reshape(-1, 3)
    pid = TP.grid_position_to_probe_id(s, torch.as_tensor(gp))
    np.testing.assert_array_equal(
        pid.numpy(), np.asarray(JP.grid_position_to_probe_id(js, gp)))
    np.testing.assert_array_equal(
        TP.probe_id_to_grid_position(s, pid).numpy(), gp)


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_radiance_mips_and_sample_tile_lod_match_jax(name):
    """The mode-1 lookup: the mip pyramid, and fractional-LOD samples in
    seeded tiles at LODs across and beyond the pyramid (clamped), at atol
    1e-6 (the 2×2 means and lerps in f32, summed in the same order)."""
    s = SETTINGS[name]
    js = jax_config(s)
    rng = np.random.RandomState(8)
    rad = _atlas(rng, s.radiance_atlas_shape)
    levels = int(np.log2(s.radiance_resolution))
    jm = JP.radiance_mips(js, jnp.asarray(rad), levels)
    tm = TP.radiance_mips(s, torch.as_tensor(rad), levels)
    assert len(tm) == len(jm) == levels + 1
    for g, r in zip(tm, jm):
        _close(g, r, atol=1e-6)
    n = 256
    pid = rng.randint(0, s.num_probes, n).astype(np.int32)
    ray_id = np.array(JP.dir_to_ray_id(jnp.asarray(_dirs(rng, n))))
    lod = rng.uniform(-0.5, levels + 0.5, n).astype(np.float32)
    lod[:levels + 1] = np.arange(levels + 1)      # whole levels
    jtx, jty = JP.probe_id_to_tile(js, jnp.asarray(pid))
    ttx, tty = TP.probe_id_to_tile(s, torch.as_tensor(pid))
    np.testing.assert_array_equal(ttx.numpy(), np.asarray(jtx))
    np.testing.assert_array_equal(tty.numpy(), np.asarray(jty))
    _close(TP.sample_tile_bilinear(tm[0], ttx, tty, torch.as_tensor(ray_id),
                                   s.radiance_resolution),
           JP.sample_tile_bilinear(jm[0], jtx, jty, jnp.asarray(ray_id),
                                   s.radiance_resolution), atol=1e-6)
    _close(TP.sample_tile_lod(s, tm, ttx, tty, torch.as_tensor(ray_id),
                              torch.as_tensor(lod)),
           JP.sample_tile_lod(js, jm, jtx, jty, jnp.asarray(ray_id),
                              jnp.asarray(lod)), atol=1e-6)


def _lookup_inputs(s, seed, n=128):
    rng = np.random.RandomState(seed)
    irr = _atlas(rng, s.irradiance_atlas_shape)
    hi = np.array(s.grid_dimensions) * np.array(s.grid_spacing)
    pos = rng.uniform(-1.0, hi + 1.0, (n, 3)).astype(np.float32)
    vis8 = (rng.rand(8, n) > 0.3).astype(np.float32)
    return irr, pos, _dirs(rng, n), vis8


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_sample_irradiance_gather_matches_jax(name):
    """The gather method (each corner's tile fetched bilinearly) against
    JAX's gather at atol 1e-5, and against the port's matmul method at
    atol 1e-5 (tests/test_probes.py's tolerance between JAX's two)."""
    s = SETTINGS[name]
    irr, pos, normal, vis8 = _lookup_inputs(s, 9)
    ref = JP.sample_irradiance(jax_config(s), None, jnp.asarray(irr),
                               jnp.asarray(pos), jnp.asarray(normal),
                               vis8=jnp.asarray(vis8), method="gather")
    args = (s, torch.as_tensor(irr), torch.as_tensor(pos),
            torch.as_tensor(normal))
    got = TP.sample_irradiance(*args, vis8=torch.as_tensor(vis8),
                               method="gather")
    _close(got, ref)
    matmul = TP.sample_irradiance(*args, vis8=torch.as_tensor(vis8))
    np.testing.assert_allclose(got.numpy(), matmul.numpy(), atol=1e-5,
                               rtol=0)


def test_sample_irradiance_rejects_an_unknown_method():
    s = SETTINGS["fast"]
    irr, pos, normal, vis8 = (torch.as_tensor(x)
                              for x in _lookup_inputs(s, 10, n=4))
    with pytest.raises(ValueError):
        TP.sample_irradiance(s, irr, pos, normal, vis8=vis8, method="nearest")
