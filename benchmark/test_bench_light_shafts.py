"""The light_shafts.look cell on the CPU: it loads from BENCHMARK.json with
its own reference package and limits; a tiny view run of it is correct,
and one whose program shifts the scattering map is not; the volumetric
readers on a synthetic trace.

The tiny runs cut the volumetrics as well as the screen and the probes:
both sides' ``light_shafts`` builders are given SMALL_VOLUMETRICS (the
configuration states no volumetric settings: its builders' defaults are
upstream's)."""
import functools
import json
import os
import time

import pytest
import torch

from benchmark import cells, check, harness, tracing
from benchmark.conftest import BENCH, ROOT

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4099
CELL = "light_shafts.look"
SMALL_VOLUMETRICS = dict(visibility_resolution=(8, 8, 8),
                         visibility_step_size=0.5,
                         scattering_resolution=(16, 16),
                         scattering_step_size=0.5)
MS = 1_000_000


@pytest.fixture
def small_volumetrics(monkeypatch):
    """Both sides' light_shafts builders at SMALL_VOLUMETRICS."""
    from benchmark.reference.core.config import VolumetricsSettings as RV
    from benchmark.reference_shafts.examples import scenes as ref
    from madarch_tpu_torch.core.config import VolumetricsSettings as PV
    from madarch_tpu_torch.examples import scenes as port
    for mod, cls in ((port, PV), (ref, RV)):
        monkeypatch.setattr(mod, "light_shafts", functools.partial(
            mod.light_shafts, volumetrics=cls(**SMALL_VOLUMETRICS)))


def run(root):
    cell = cells.load_cell(CELL, root)
    with open(os.devnull, "w") as sink:
        return harness.run_cell(cell, SEED, 0.3, False, CPU,
                                time.perf_counter(), out=sink, err=sink)


def test_the_cell_loads_with_its_package_and_limits():
    """One chip, the light_shafts configuration at upstream's 1000x1000
    with gi_room's probes and nothing cut, the look mix, its own reference
    package (whose frame leaves the scattering map) and a limit for every
    number that package's frame gives."""
    cell = cells.load_cell(CELL, ROOT)
    assert cell.chips == 1 and cell.mix["loop"] == "view"
    cfg = cell.config
    assert cfg["builder"] == "light_shafts"
    assert cfg["resolution"] == [1000, 1000]
    assert cfg["reduced"] == [] and cfg["assumed"] == []
    with open(os.path.join(BENCH, "configs", "gi_room.json")) as f:
        assert cfg["probes"] == json.load(f)["probes"]
    entry = cells.reference_package(cfg, ROOT)
    assert entry.__name__ == "benchmark.reference_shafts.entry"
    leaves = entry.leaves(cfg)
    assert set(leaves) == {"radiance", "irradiance", "scattering"}
    check.require_limits(leaves, cell.limits)
    assert set(cell.limits) == {"image", "image_wrong", *leaves}
    assert {"volumetrics_ms.view", "volumetrics_roofline.view",
            "geometry_roofline.view"} <= set(cell.readers)
    assert {m["name"] for m in cell.end_to_end} == {
        "frame_ms", "frame_p95_ms", "setup_s"}


def test_a_tiny_view_run_is_correct(tiny_root, small_volumetrics):
    r = run(tiny_root)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0
    assert set(r["checks"]) == {"image", "image_wrong", "radiance",
                                "irradiance", "scattering"}


def test_a_shifted_scattering_map_is_not_correct(tiny_root,
                                                 small_volumetrics,
                                                 monkeypatch):
    """The program's scattering map rolled by one texel along x: the
    scattering number (and the composite's pixels) leave their limits."""
    from madarch_tpu_torch.render import pipeline
    from madarch_tpu_torch.render import volumetrics as vol
    scattering_pass = vol.scattering_pass

    def shifted(*args, **kwargs):
        return torch.roll(scattering_pass(*args, **kwargs), 1, dims=1)

    monkeypatch.setattr(vol, "scattering_pass", shifted)
    pipeline.clear_compiled()
    r = run(tiny_root)
    pipeline.clear_compiled()
    assert not r["correct"], r["checks"]
    limits = cells.load_cell(CELL, tiny_root).limits
    assert r["checks"]["scattering"]["value"] > limits["scattering"]


def _reader(name):
    return cells.load_reader(os.path.join(BENCH, "metrics", name + ".py"))


def synthetic(frames=2, volumetrics=True):
    """``frames`` traced frames of 10 ms, each with (``volumetrics``) a
    visibility launch of 0.06 ms and a raycast launch of 0.03 ms, and a
    geometry launch and a shade op (not the volumetric kernels')."""
    spans, device = [], []
    for i in range(frames):
        t0 = i * 10 * MS
        spans.append(("bench.frame", t0, t0 + 10 * MS))
        if volumetrics:
            device += [
                ("void (anonymous namespace)::visibility_kernel<0, true>"
                 "(MarchArgs)", t0 + MS, t0 + MS + 60_000),
                ("void (anonymous namespace)::raycast_kernel<0, true>"
                 "(MarchArgs)", t0 + 2 * MS, t0 + 2 * MS + 30_000)]
        device += [
            ("void (anonymous namespace)::geometry_kernel<1, true, 0, "
             "true>(GeomArgs)", t0 + 3 * MS, t0 + 4 * MS),
            ("elementwise_kernel", t0 + 4 * MS, t0 + 6 * MS)]
    t = tracing.Trace(device=device, spans=spans,
                      window=(0, frames * 10 * MS))
    return harness.Window(kind="view", n=frames, wall_s=0.01 * frames,
                          latency_s=[0.01] * frames,
                          host_s=[0.001] * frames, edit_s=[0.0] * frames,
                          trace=t)


def test_the_volumetric_readers_on_a_synthetic_trace():
    w = synthetic(frames=3)
    assert _reader("volumetrics_ms.view")(w) == pytest.approx(0.09)
    # a frame's bound: 33e6 + 1.875e6 bytes at 3.35 TB/s, 0.0104104 ms,
    # over its 0.09 ms of the two kernels
    bound_ms = (33e6 + 1.875e6) / 3.35e12 * 1e3
    assert _reader("volumetrics_roofline.view")(w) == pytest.approx(
        100.0 * bound_ms / 0.09)
    # the volumetric kernels fall out of shade_ms.view
    assert _reader("shade_ms.view")(w) == pytest.approx(2.0)


@pytest.mark.parametrize("name", ["volumetrics_ms.view",
                                  "volumetrics_roofline.view"])
def test_the_volumetric_readers_find_nothing_without_their_kernels(name):
    """No trace, a fit window or a trace without the two kernels (a
    program without volumetrics) read None, and do not raise."""
    read = _reader(name)
    assert read(synthetic(volumetrics=False)) is None
    assert read(harness.Window(kind="view", n=1, wall_s=0.01,
                               latency_s=[0.01], host_s=[0.001],
                               edit_s=[0.0])) is None
    fit = synthetic()
    fit.kind = "fit"
    assert read(fit) is None
