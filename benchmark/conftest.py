"""The benchmark's own tests (``python -m pytest benchmark -q``): the
harness, the traffic generator, the metric readers and the check, on the
CPU at tiny sizes.  A test that needs a card is marked ``cuda`` and
decides inside itself whether there is one."""
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BENCH = os.path.join(ROOT, "benchmark")
# The tiny size the tests run the cells at: whole 32x32 screen blocks and
# 4x4-texel probes.
TINY = {"resolution": [64, 64], "radiance_resolution": 4,
        "irradiance_resolution": 2, "fit_resolution": [32, 32]}
# The fit cell the tests add to their checkout's BENCHMARK.json: the fit
# loop's harness, traffic, readers and limits are kept for it, but the
# cell is out of the benchmark while the port's spot-light gradient turns
# NaN on some seeds (PERF.md, Open questions).
FIT_CELL = {
    "workload": {"name": "gi_room.fit512", "config": "gi_room",
                 "traffic": "fit512", "chips": 1,
                 "why": "the compiled train step at 512x512 over 4 views"},
    "end_to_end": [{"name": "step_ms", "unit": "ms", "better": "lower",
                    "bound": 0.25, "source": "host_clock",
                    "workloads": ["gi_room.fit512"]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": "lower", "source": source,
         "layer": layer, "moves": "step_ms", "workloads": ["gi_room.fit512"]}
        for name, unit, source, layer in (
            ("host_ms.fit", "ms", "program_span", "train step"),
            ("busy_ms.fit", "ms", "device_trace", "autograd"),
            ("idle_share.fit", "%", "device_trace", "device"))]}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


def make_root(tmp, tiny=True):
    """A checkout in ``tmp`` holding BENCHMARK.json and copies of the
    benchmark's data files (configurations, traffic, metric readers,
    limits, media) with FIT_CELL added, the configurations and the fit mix
    cut to TINY.  Returns its path."""
    dst = os.path.join(str(tmp), "benchmark")
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(dst, sub))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    if FIT_CELL["workload"]["name"] not in {w["name"]
                                            for w in bench["workloads"]}:
        bench["workloads"].append(FIT_CELL["workload"])
        bench["end_to_end"][-1:-1] = FIT_CELL["end_to_end"]
        bench["per_layer"] += FIT_CELL["per_layer"]
    with open(os.path.join(str(tmp), "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    if tiny:
        for name in os.listdir(os.path.join(dst, "configs")):
            if not name.endswith(".json"):
                continue
            path = os.path.join(dst, "configs", name)
            with open(path) as f:
                cfg = json.load(f)
            cfg["resolution"] = TINY["resolution"]
            cfg["probes"]["radiance_resolution"] = TINY["radiance_resolution"]
            cfg["probes"]["irradiance_resolution"] = \
                TINY["irradiance_resolution"]
            with open(path, "w") as f:
                json.dump(cfg, f)
        for name in os.listdir(os.path.join(dst, "traffic")):
            path = os.path.join(dst, "traffic", name)
            with open(path) as f:
                mix = json.load(f)
            if mix["loop"] == "fit":
                mix["resolution"] = TINY["fit_resolution"]
                with open(path, "w") as f:
                    json.dump(mix, f)
    return str(tmp)


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
