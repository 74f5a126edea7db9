"""The harness on the CPU: a cell found by name from files alone, the
window's end-to-end metrics, the exit without a card, and the faults and
the control that ``correct`` has to catch."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import cells, check, harness
from benchmark.conftest import ROOT

CPU = torch.device("cpu")
SEED = 2 ** 31 + 977


def run(root, name, seconds=0.5, trace=False, control=False):
    cell = cells.load_cell(name, root)
    with open(os.devnull, "w") as sink:
        return harness.run_cell(cell, SEED, seconds, trace, CPU,
                                time.perf_counter(), control=control,
                                out=sink, err=sink)


def test_a_cell_from_new_files_alone(tmp_path):
    """A configuration, a traffic mix, a metric reader and limits added as
    files, and a workload entry naming them, make a cell the harness runs
    with no edit of its own."""
    root = os.path.join(str(tmp_path), "root")
    os.makedirs(root)
    from benchmark.conftest import make_root
    make_root(root)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "gi_room.json")) as f:
        cfg = json.load(f)
    cfg["resolution"] = [32, 32]
    with open(os.path.join(b, "configs", "small_room.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "traffic", "nod.json"), "w") as f:
        json.dump({"loop": "view", "cycle_frames": 8,
                   "camera": {"path": "turn", "yaw_step_deg": 0.0,
                              "pitch_amplitude_deg": 5.0,
                              "pitch_cycles": 1}}, f)
    with open(os.path.join(b, "metrics", "frames.view.py"), "w") as f:
        f.write("def read(w):\n    return float(w.n)\n")
    with open(os.path.join(b, "limits", "small_room.nod.json"), "w") as f:
        json.dump({"image": 1e-6, "image_wrong": 0.0, "radiance": 1e-6,
                   "irradiance": 1e-6}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "small_room", "source": "test",
                             "file": "benchmark/configs/small_room.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "small_room.nod",
                               "config": "small_room", "traffic": "nod",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("frame_ms", "frame_p95_ms"):
            m["workloads"].append("small_room.nod")
    bench["per_layer"].append({"name": "frames.view", "unit": "frames",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "test", "moves": "frame_ms",
                               "workloads": ["small_room.nod"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    traced = run(root, "small_room.nod", trace=True)
    assert traced["correct"]
    assert traced["metrics"]["frames.view"]["value"] == traced["attempted"]
    plain = run(root, "small_room.nod")
    assert set(plain["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    with pytest.raises(KeyError):
        cells.load_cell("small_room.nowhere", root)


def test_end_to_end_over_the_whole_window():
    """frame_ms is the window's wall time over its frames; frame_p95_ms
    the 95th percentile of every frame's latency, not of chunk medians."""
    lat = [0.010] * 90 + [0.050] * 10
    w = harness.Window(kind="view", n=100, wall_s=1.4, latency_s=lat,
                       host_s=[0.001] * 100, edit_s=[0.0] * 100)
    e2e = harness.end_to_end(w, 3.0)
    assert e2e["frame_ms"] == pytest.approx(14.0)
    assert e2e["frame_p95_ms"] == pytest.approx(50.0)
    assert e2e["setup_s"] == 3.0
    f = harness.Window(kind="fit", n=40, wall_s=1.0, latency_s=[0.025] * 40,
                       host_s=[0.002] * 40, edit_s=[0.0] * 40)
    assert harness.end_to_end(f, 1.0)["step_ms"] == pytest.approx(25.0)


def test_no_card_no_result(tmp_path):
    """Without a card the run fails and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", "gi_room.look", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=str(tmp_path),
        timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


@pytest.mark.parametrize("name", ["gi_room.look", "gi_room.sweep",
                                  "torus_mesh.orbit"])
def test_sound_view_run_is_correct(tiny_root, name):
    r = run(tiny_root, name)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0


def _broken(monkeypatch, fault):
    """Plants ``fault`` in the program underneath the harness."""
    from benchmark import program
    if fault == "state_unchanged":
        def render(self):
            state = self.r.state
            image = self.r.render()
            self.r.state = state
            return image
        monkeypatch.setattr(program.ViewProgram, "render", render)
    elif fault == "answer_altered":
        def render(self, _render=program.ViewProgram.render):
            image = _render(self).clone()
            image[:32, :32] += 0.25
            return image
        monkeypatch.setattr(program.ViewProgram, "render", render)
    elif fault == "window_state_unchanged":
        def render(self, _render=program.ViewProgram.render):
            state = self.r.state
            image = _render(self)
            if getattr(self, "frames", 0) >= harness.SETUP_FRAMES:
                self.r.state = state
            self.frames = getattr(self, "frames", 0) + 1
            return image
        monkeypatch.setattr(program.ViewProgram, "render", render)
    elif fault in ("step_unchanged", "window_step_unchanged"):
        first = 0 if fault == "step_unchanged" else harness.SETUP_STEPS

        def step(self, k, _step=program.FitProgram.step):
            if k < first:
                return _step(self, k)
            data, state = self.data, self.state
            loss = self.train_step(data, self.cameras[self.traffic.view(k)],
                                   state,
                                   self.targets[self.traffic.view(k)])[0]
            return loss
        monkeypatch.setattr(program.FitProgram, "step", step)
    elif fault == "half_batch":
        from madarch_tpu_torch.parallel import spmd
        render_frame = spmd.render_frame

        def half(*args, **kwargs):
            image, state = render_frame(*args, **kwargs)
            return image[: image.shape[0] // 2], state
        monkeypatch.setattr(spmd, "render_frame", half)
        init = program.FitProgram.__init__

        def init_half(self, *args, **kwargs):
            init(self, *args, **kwargs)
            self.targets = [t[: t.shape[0] // 2] for t in self.targets]
        monkeypatch.setattr(program.FitProgram, "__init__", init_half)


@pytest.mark.parametrize("name,fault", [
    ("gi_room.look", "state_unchanged"),
    ("gi_room.look", "window_state_unchanged"),
    ("gi_room.look", "answer_altered"),
    ("gi_room.sweep", "state_unchanged"),
    ("gi_room.fit512", "step_unchanged"),
    ("gi_room.fit512", "window_step_unchanged"),
    ("gi_room.fit512", "half_batch"),
])
def test_a_broken_program_is_not_correct(tiny_root, monkeypatch, name,
                                         fault):
    """Each fault the cell can have, planted under the timed path, turns
    ``correct`` false under the cell's own limits; a fault that starts
    with the window (after the set-up frames or steps) too."""
    _broken(monkeypatch, fault)
    r = run(tiny_root, name)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", ["gi_room.look", "gi_room.fit512"])
def test_the_control_is_not_correct(tiny_root, name):
    """The reference in bfloat16, put in the program's place, fails the
    cell's limits."""
    r = run(tiny_root, name, control=True)
    limits = cells.load_cell(name, tiny_root).limits
    assert r["correct"]
    for kind, readings in r["controls"].items():
        ok, _ = check.judge(readings, limits)
        assert not ok, (kind, readings)


def test_judge_compares_the_numbers_the_limits_name():
    """A cell's limits file says which numbers it compares: each has to
    be read, finite and within its limit; a reading it does not name is
    not compared."""
    ok, rows = check.judge({"a": 0.5, "b": 9.0}, {"a": 1.0})
    assert ok and rows == [("a", 0.5, 1.0)]
    assert not check.judge({"b": 0.0}, {"a": 1.0})[0]
    assert not check.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert not check.judge({"a": 1.5}, {"a": 1.0})[0]
