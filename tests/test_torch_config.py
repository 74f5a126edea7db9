"""Port parity: the port's own copy of the configuration dataclasses
(madarch_tpu_torch/core/config.py) against madarch_tpu/core/config.py:
the same classes and instances, field for field, with the same defaults
and derived properties."""
import dataclasses

import pytest
import torch

from madarch_tpu.core import config as JC
from madarch_tpu_torch.core import config as TC

CLASSES = ["ProbeSettings", "VolumetricsSettings", "ShadeConfig",
           "PartitioningSettings"]


@pytest.fixture(scope="module")
def torch_threads():
    """Runs a module's tests with 2 torch intra-op threads, then restores
    the count: parallel test workers share the host's cores, and torch's
    default of one thread per core in each worker oversubscribes them (a
    render that takes seconds alone then takes minutes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_config(settings):
    """The JAX package's dataclass with the same fields as the port's
    ``settings``: how the parity tests hand one setting to both."""
    return getattr(JC, type(settings).__name__)(
        **dataclasses.asdict(settings))


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_fields_and_defaults_match_jax(name):
    t, j = getattr(TC, name), getattr(JC, name)
    assert _fields(t) == _fields(j)
    assert t.__dataclass_params__.frozen and j.__dataclass_params__.frozen
    assert dataclasses.asdict(t()) == dataclasses.asdict(j())


def test_jax_config_copies_every_field():
    s = TC.VolumetricsSettings(visibility_resolution=(10, 6, 8),
                               scattering_step_size=0.5)
    j = jax_config(s)
    assert type(j) is JC.VolumetricsSettings
    assert dataclasses.asdict(j) == dataclasses.asdict(s)


def test_instances_and_derived_values_match_jax():
    assert dataclasses.asdict(TC.NO_VOLUMETRICS) \
        == dataclasses.asdict(JC.NO_VOLUMETRICS)
    assert dataclasses.asdict(TC.PROBE_SHADE_CONFIG) \
        == dataclasses.asdict(JC.PROBE_SHADE_CONFIG)
    for args in ((False,), (True,), (True, 128), (False, 48, True)):
        assert dataclasses.asdict(TC.screen_shade_config(*args)) \
            == dataclasses.asdict(JC.screen_shade_config(*args))
    for kw in ({}, {"visibility_resolution": (10, 6, 8),
                    "visibility_step_size": 0.5},
               {"visibility_resolution": (8, 8, 30),
                "visibility_step_size": 0.3}):
        assert TC.VolumetricsSettings(**kw).max_depth \
            == JC.VolumetricsSettings(**kw).max_depth
    for kw in ({}, {"radiance_resolution": 8, "irradiance_resolution": 4,
                    "probe_count": (4, 2), "grid_dimensions": (2, 2, 2)}):
        t, j = TC.ProbeSettings(**kw), JC.ProbeSettings(**kw)
        assert (t.num_probes, t.radiance_atlas_shape,
                t.irradiance_atlas_shape) == (j.num_probes,
                                              j.radiance_atlas_shape,
                                              j.irradiance_atlas_shape)


def test_partitioning_derived_values_match_jax():
    for kw in ({}, {"grid_dimensions": (30, 20, 20),
                    "grid_spacing": (0.1, 0.1, 0.1)},
               {"grid_spacing": (0.5, 1.0, 2.0)}):
        t = TC.PartitioningSettings(**kw)
        j = JC.PartitioningSettings(**kw)
        assert (t.num_cells, t.cell_diag) == (j.num_cells, j.cell_diag)
