"""The port's bench (madarch_tpu_torch/bench.py) and its probes
(madarch_tpu_torch/tools/) on the CPU, at 16x16 on room_reflections (the
GI room with the bench's small probes): the functions' keys and values,
the JSON line's keys, and that the configurations, probe settings and
golden gates are the root bench.py's.  The root bench.py imports only the
standard library at top level, so it is imported here without JAX; its
main() is read with ``ast``.  No card is needed: off a card the bench
times by the host clock and leaves the device metrics None.

    python -m pytest tests/test_torch_bench.py -q
"""
import ast
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from madarch_tpu_torch import bench
from madarch_tpu_torch.core.config import ProbeSettings
from madarch_tpu_torch.tools import (diag_golden, geom_probe, perf_probe,
                                     train_probe)
from madarch_tpu_torch.utils.profiling import rays_per_frame
from test_torch_config import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BENCH = os.path.join(REPO, "bench.py")
SIZE = 16
CPU = torch.device("cpu")
RENDERER_KEYS = {"first_frame_s", "build_s", "nvcc_runs", "compiled",
                 "warmup_s", "capture_s", "graph_pool_bytes", "frame_ms",
                 "eager_frame_ms", "rays_per_s", "rays_per_frame", "frames",
                 "launches_per_frame", "traced_launches_per_frame",
                 "device_busy_ms", "profiled_wall_ms", "idle_share",
                 "kernel_ms_per_launch"}
DEVICE_ONLY = ("warmup_s", "capture_s", "graph_pool_bytes",
               "traced_launches_per_frame", "device_busy_ms",
               "profiled_wall_ms", "idle_share", "kernel_ms_per_launch")


def jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", JAX_BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_renderer_on_the_cpu():
    """The table's keys, finite numbers, the ray count of rays_per_frame;
    the compiled frame timed beside the eager one; the device metrics
    None off a card, and no kernel launched (the wrappers run their plain
    versions, uncounted, on CPU tensors)."""
    r = bench.make_config("room_reflections", SIZE, CPU)
    out = bench.bench_renderer("room_reflections", r, 1, frames=2,
                               converge_frames=1)
    assert set(out) == RENDERER_KEYS
    assert out["compiled"] and r.frame is not None
    assert out["rays_per_frame"] == rays_per_frame(
        SIZE, SIZE, r.probes, 1, r.screen_cfg, r.volumetrics)
    for key in ("first_frame_s", "build_s", "frame_ms", "eager_frame_ms",
                "rays_per_s"):
        assert math.isfinite(out[key]) and out[key] >= 0.0, key
    assert out["frame_ms"] > 0.0 and out["eager_frame_ms"] > 0.0
    assert out["rays_per_s"] == pytest.approx(
        out["rays_per_frame"] / out["frame_ms"] * 1e3)
    assert out["launches_per_frame"] == dict.fromkeys(bench.KERNELS, 0.0)
    for key in DEVICE_ONLY:
        assert out[key] is None, key


def _stub_renderer(rays_per_s):
    return dict.fromkeys(RENDERER_KEYS, 1.0) | {"rays_per_s": rays_per_s}


def _stubs(breached=(), loss_finite=True, scaling=None):
    configs = {name: _stub_renderer(float(i + 1))
               for i, name in enumerate(bench.CONFIGS)}
    train = {"frame_ms": 1.0, "rays_per_s": 2.0, "size": 256,
             "loss_finite": True,
             "at_512": {"frame_ms": 3.0, "rays_per_s": 4.0, "size": 512,
                        "fwd_ms": 1.0, "bwd_update_ms": 2.0,
                        "loss_finite": loss_finite}}
    passes = {"radiance": 1.0, "irradiance_integrate": 0.1, "screen": 2.0,
              "screen_geom_fused": 0.5, "screen_primary_geom": 0.4}
    golden = {"global_illumination": {"breached": list(breached)},
              "simple_scene": {"breached": []}}
    scaling = scaling if scaling is not None else {
        "devices": 2, "efficiency": 0.5, "collectives_in_march_loops": 0}
    return configs, train, passes, golden, scaling, {"platform": "cpu"}


def test_the_json_line_has_exactly_the_named_keys():
    out = bench.assemble(*_stubs())
    assert set(out) == {"metric", "value", "unit", "configs", "train_step",
                        "per_pass_ms", "golden_breaches",
                        "scaling_efficiency", "gpu_vs_golden", "device"}
    assert out["metric"] == "rays_per_s_per_chip_gi_800"
    assert out["unit"] == "rays/s"
    assert out["value"] == out["configs"]["global_illumination"][
        "rays_per_s"]
    assert list(out["configs"]) == list(bench.CONFIGS)
    assert out["golden_breaches"] == []
    json.dumps(out)
    assert bench.failures(out) == []


@pytest.mark.parametrize("stubs, why", [
    (dict(breached=["p99_absdiff"]), "global_illumination:p99_absdiff"),
    (dict(loss_finite=False), "at_512:loss_finite"),
    (dict(scaling={"error": "rank 1 exited 1"}), "scaling_efficiency:error"),
    (dict(scaling={"collectives_in_march_loops": 1}),
     "scaling_efficiency:collectives_in_march_loops"),
])
def test_the_bench_fails_on_a_breach_a_bad_loss_or_a_bad_world(stubs, why):
    out = bench.assemble(*_stubs(**stubs))
    assert bench.failures(out) == [why]
    if "breached" in stubs:
        assert out["golden_breaches"] == [why]


def test_golden_gates_are_the_jax_bench_s():
    assert bench.GOLDEN_GATES == jax_bench().GOLDEN_GATES


def _jax_main_configs():
    """{config: (scene, probe settings or None, frames, converge_frames)}
    read from bench.py:main's statements in order: ProbeSettings(...)
    assignments, renderers built by scenes.<scene>(...), and the
    bench_renderer(name, r, ...) calls."""
    with open(JAX_BENCH) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    probes, renderers, configs = {}, {}, {}
    for node in main.body:
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        call, kw = node.value, {k.arg: k.value for k in node.value.keywords}
        func = call.func
        target = node.targets[0]
        if isinstance(func, ast.Name) and func.id == "ProbeSettings":
            probes[target.id] = {k: ast.literal_eval(v)
                                 for k, v in kw.items()}
        elif isinstance(func, ast.Attribute) and func.value.id == "scenes":
            p = kw.get("probes")
            renderers[target.id] = (func.attr,
                                    None if p is None else probes[p.id])
        elif isinstance(func, ast.Name) and func.id == "bench_renderer":
            name = ast.literal_eval(call.args[0])
            frames = ast.literal_eval(kw["frames"]) if "frames" in kw else 5
            conv = ast.literal_eval(kw["converge_frames"]) \
                if "converge_frames" in kw else 3
            configs[name] = (*renderers[call.args[1].id], frames, conv)
    return configs


def test_configs_and_probe_settings_are_the_jax_bench_s():
    want = _jax_main_configs()
    assert list(want) == list(bench.CONFIGS)
    got = {name: (c["scene"], c["probes"], c["frames"], c["converge_frames"])
           for name, c in bench.CONFIGS.items()}
    assert got == want
    r = bench.make_config("room_reflections", SIZE, CPU)
    assert r.probes == ProbeSettings(**want["room_reflections"][1])


def test_golden_stats_restate_tpu_vs_golden():
    """bench.py:tpu_vs_golden's statistics, restated in numpy, on a seeded
    pair (mean_tpu there is mean_gpu here)."""
    rng = np.random.default_rng(0)
    ref = rng.random((32, 32, 3), dtype=np.float32)
    img = np.clip(ref + rng.normal(0.0, 0.03, ref.shape), 0.0,
                  1.0).astype(np.float32)
    diff = np.abs(img - ref)
    want = {
        "mean_gpu": round(float(img.mean()), 5),
        "mean_golden": round(float(ref.mean()), 5),
        "max_absdiff": round(float(diff.max()), 5),
        "mean_absdiff": round(float(diff.mean()), 6),
        "p99_absdiff": round(float(np.quantile(diff, 0.99)), 5),
        "frac_above_0.05": round(float((diff > 0.05).mean()), 6),
    }
    want["breached"] = sorted(k for k, lim in jax_bench().GOLDEN_GATES.items()
                              if want[k] > lim)
    got = bench.golden_stats(img, ref)
    assert got == want
    assert got["breached"] == ["frac_above_0.05", "mean_absdiff"]


def test_kernel_ms_reads_each_kernel_from_the_trace():
    ops = {"void (anonymous namespace)::geometry_kernel<8, true, false>"
           "(GeomArgs)": 3.0,
           "void (anonymous namespace)::geometry_kernel<1, false, false>"
           "(GeomArgs)": 1.0,
           "raycast_kernel(MarchArgs)": 0.5, "elementwise_kernel": 9.0,
           "(anonymous namespace)::probe_irradiance_kernel(IrradianceArgs)":
           0.2,
           "(anonymous namespace)::probe_radiance_kernel(RadianceArgs)": 0.1}
    got = bench.kernel_ms(ops, {"geometry": 2.0, "raycast": 1.0,
                                "visibility": 1.0, "softshadows": 0.0,
                                "irradiance_lookup": 2.0,
                                "radiance_lookup": 1.0})
    assert got == {"geometry": 2.0, "raycast": 0.5, "visibility": None,
                   "irradiance_lookup": 0.1, "radiance_lookup": 0.1}


def test_the_bench_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main([])


def test_scaling_efficiency_in_two_cpu_processes():
    out = bench.scaling_efficiency(size=SIZE, frames=1, timeout=120)
    assert "error" not in out, out
    assert out["devices"] == bench.SCALING_WORLD
    assert out["efficiency"] > 0.0 and out["collectives_in_march_loops"] == 0
    assert out["n_collectives"] == 3 and out["collective_bytes_per_frame"] > 0


def test_perf_probe_main(capsys):
    out = perf_probe.main(["room_reflections", "--size", str(SIZE),
                           "--frames", "1", "--passes", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    assert out["frame_ms"] > 0.0 and out["config"] == "room_reflections"
    assert set(out["per_pass_ms"]) == {
        "radiance", "irradiance_integrate", "screen", "screen_geom_fused",
        "screen_primary_geom"}


def test_geom_probe_main(capsys):
    out = geom_probe.main(["room_reflections", "--size", str(SIZE),
                           "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    assert out["rays"] == SIZE * SIZE and out["lanes"] == 8
    assert set(out["ms"]) == set(geom_probe.VARIANTS)
    assert all(v > 0.0 for v in out["ms"].values())
    assert sum(out["split"].values()) == pytest.approx(out["ms"]["full"])


def test_train_step_at_times_the_compiled_and_the_eager_step(monkeypatch):
    """train_step_at on the CPU at 16x16 (the room's small probes in
    place of the GI scene's): the compiled step (a CompiledStep running
    the eager step on its buffers) and the eager one, both halves of the
    split each way, finite losses; the capture's numbers None off a
    card."""
    gi = bench.scenes.global_illumination
    monkeypatch.setattr(
        bench.scenes, "global_illumination",
        lambda **kw: gi(probes=ProbeSettings(**bench.ROOM_PROBES), **kw))
    out = bench.train_step_at(SIZE, torch.device("cpu"), steps=1,
                              split=True)
    assert out["compiled"] and out["loss_finite"] and out["size"] == SIZE
    for key in ("frame_ms", "eager_ms_per_step", "first_step_s", "fwd_ms",
                "eager_fwd_ms"):
        assert math.isfinite(out[key]) and out[key] > 0.0, key
    assert out["bwd_update_ms"] == out["frame_ms"] - out["fwd_ms"]
    assert out["eager_bwd_update_ms"] \
        == out["eager_ms_per_step"] - out["eager_fwd_ms"]
    for key in ("warmup_s", "capture_s", "graph_pool_bytes"):
        assert out[key] is None, key


def test_train_probe_main(capsys):
    out = train_probe.main(["room_reflections", "--size", str(SIZE),
                            "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    assert set(out["ms"]) == {"fwd_diff_cfg_no_grad", "fwd_fused_cfg",
                              "grad_materials", "grad_all_floats",
                              "train_step", "train_step_eager"}
    assert all(v > 0.0 for v in out["ms"].values())


def test_diag_golden_main(tmp_path, capsys):
    """Against a seeded 16x16 stand-in golden: both renders compared, the
    worst pixel traced on both sides and classified."""
    path = tmp_path / "goldens.npz"
    np.savez(path, room_reflections=np.random.default_rng(1).random(
        (SIZE, SIZE, 3), dtype=np.float32))
    out = diag_golden.main(["room_reflections", "--size", str(SIZE),
                            "--device", "cpu", "--golden", str(path)])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    assert set(out["stats"]) == {"device", "cpu"}
    rays = out["worst"]["rays"]
    assert rays["device"] == rays["cpu"]      # both the plain version here
    assert out["verdict"] == "drift"
