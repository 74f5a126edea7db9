"""The harness on the CPU: a cell found by name from files alone (with a
reference package, renderer settings and a builder of its own), the
window's end-to-end metrics, the exit without a card, the faults and the
control that ``correct`` has to catch, and the check's dispatch to a
configuration's reference package."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import cells, check, harness
from benchmark.conftest import BENCH, ROOT

CPU = torch.device("cpu")
SEED = 2 ** 31 + 977


def run(root, name, seconds=0.5, trace=False, control=False):
    cell = cells.load_cell(name, root)
    with open(os.devnull, "w") as sink:
        return harness.run_cell(cell, SEED, seconds, trace, CPU,
                                time.perf_counter(), control=control,
                                out=sink, err=sink)


# A builder that the default reference package lacks: the sphere field of
# the port's examples/large_scenes.py on a reference package's modules.
FIELD_BUILDER = '''"""The port's sphere field (examples/large_scenes.py)."""
import numpy as np

from ..core.config import NO_VOLUMETRICS
from ..render.renderer import Renderer
from ..scene import lights as L
from ..scene import primitives as P
from ..scene.scene import SceneSpec


def sphere_field(width=800, height=800, n=3500, seed=0, **kwargs):
    spec = SceneSpec(prims=((P.Sphere, n), (P.Plane, 1)),
                     lights=((L.PointLight, 1),))
    r = Renderer(spec, width, height, volumetrics=NO_VOLUMETRICS, **kwargs)
    rng = np.random.RandomState(seed)
    centers = rng.uniform((-3.0, -0.5, 3.0), (3.0, 2.0, 9.0),
                          (n, 3)).astype(np.float32)
    radii = rng.uniform(0.05, 0.12, n).astype(np.float32)
    ball = r.add_material((0.8, 0.3, 0.2), 0.0, 0.5)
    mirror = r.add_material((0.9, 0.9, 0.9), 1.0, 0.1)
    floor = r.add_material((0.6, 0.6, 0.6), 0.0, 0.9)
    for i in range(n):
        r.add_primitive(P.Sphere, center=centers[i], radius=float(radii[i]),
                        material_id=mirror if i % 7 == 0 else ball)
    r.add_primitive(P.Plane, normal=(0.0, 1.0, 0.0), offset=1.0,
                    material_id=floor)
    r.add_light(L.PointLight, position=(0.0, 5.0, 2.0),
                color=(1.0, 1.0, 1.0))
    r.set_camera_position((0.0, 1.0, -5.0))
    return r
'''
# A fault planted in a copied package's frame: every colour off by 0.25.
FRAME_FAULT = '''

_frame = frame


def frame(rr, data, camera, state, pixels, q):
    c, state = _frame(rr, data, camera, state, pixels, q)
    return c + 0.25, state
'''
# A package whose entry takes the default's and defines its frame again:
# the frame leaves the scattering map too, SHIFT added to it.
SCATTER_ENTRY = '''"""The default frame, leaving the scattering map too."""
import dataclasses

from benchmark.reference import entry as base
from benchmark.reference.entry import *  # noqa: F401,F403

SHIFT = {shift!r}


def leaves(config):
    return base.leaves(config) + ("scattering",)


def frame(rr, data, camera, state, pixels, q):
    c, left = base.frame(rr, data, camera, state, pixels, q)
    return c, dataclasses.replace(
        left, scattering=base.adopt(rr, state).scattering + SHIFT)
'''
EXACT = {"image": 1e-6, "image_wrong": 0.0, "radiance": 1e-6,
         "irradiance": 1e-6}


def _tiny_config(root, name="gi_room"):
    with open(os.path.join(root, "benchmark", "configs", name + ".json")) \
            as f:
        return json.load(f)


def add_cell(root, config_name, config, traffic, limits):
    """Adds to checkout ``root`` the configuration file ``config_name``,
    the cell ``<config_name>.<traffic>`` of it under an existing traffic
    mix, reporting frame_ms and frame_p95_ms, and its limits file.
    Returns the cell's name."""
    b = os.path.join(root, "benchmark")
    cell = f"{config_name}.{traffic}"
    with open(os.path.join(b, "configs", config_name + ".json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(b, "limits", cell + ".json"), "w") as f:
        json.dump(limits, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({
        "name": config_name, "source": "test",
        "file": f"benchmark/configs/{config_name}.json", "reduced": [],
        "why": "test"})
    bench["workloads"].append({"name": cell, "config": config_name,
                               "traffic": traffic, "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("frame_ms", "frame_p95_ms"):
            m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return cell


def copy_reference(root, name, extra=None):
    """Copies the default reference package into checkout ``root`` as
    ``benchmark/<name>``, with ``extra`` {relative path: text} written
    into it (appended where the file is there).  Returns its path."""
    dst = os.path.join(root, "benchmark", name)
    shutil.copytree(os.path.join(BENCH, "reference"), dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text in (extra or {}).items():
        with open(os.path.join(dst, rel), "a") as f:
            f.write(text)
    return dst


def field_cell(root, package, frame_fault=False):
    """A sphere-field cell in checkout ``root`` whose configuration names
    ``package``, a copy of the default reference with the sphere field's
    builder added (and with ``frame_fault`` the fault in its frame): the
    builder named ``large_scenes.sphere_field``."""
    extra = {os.path.join("examples", "large_scenes.py"): FIELD_BUILDER}
    if frame_fault:
        extra["entry.py"] = FRAME_FAULT
    copy_reference(root, package, extra)
    cfg = _tiny_config(root, "torus_mesh")
    cfg.update({"reference": package, "builder": "large_scenes.sphere_field",
                "builder_args": {"n": 24, "seed": 3},
                "resolution": [32, 32]})
    return add_cell(root, "field_" + package, cfg, "look", EXACT)


def test_a_cell_from_new_files_alone(tmp_path):
    """A configuration, a traffic mix, a metric reader and limits added as
    files, and a workload entry naming them, make a cell the harness runs
    with no edit of its own; so does a configuration that names a
    reference package of its own (a copy of the default with a builder
    added, from another examples module)."""
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
    field = field_cell(root, "reference_field")
    traced = run(root, field, trace=True)
    assert traced["correct"], traced["checks"]
    assert set(traced["checks"]) == set(EXACT)
    assert cells.reference_package(cells.load_cell(field, root).config,
                                   root).__file__.startswith(root)


def test_a_fault_in_the_configurations_reference_is_not_correct(tmp_path):
    """The check runs the configuration's own reference package: a fault
    planted in that package's frame turns ``correct`` false."""
    root = make_root_at(tmp_path)
    field = field_cell(root, "reference_faulty", frame_fault=True)
    r = run(root, field)
    assert not r["correct"]
    assert r["checks"]["image"]["value"] > 0.2, r["checks"]


def make_root_at(tmp_path):
    from benchmark.conftest import make_root
    return make_root(tmp_path)


@pytest.mark.parametrize("shift,correct", [(0.0, True), (1.0, False)])
def test_every_state_leaf_is_compared(tmp_path, shift, correct):
    """A package whose frame leaves a further state leaf (the scattering
    map) gets it compared with the program's under its name; a fault in
    it alone turns ``correct`` false; and a cell whose limits do not name
    it cannot run: it raises before the check reads a frame."""
    root = make_root_at(tmp_path)
    pkg = os.path.join(root, "benchmark", "reference_scatter")
    os.makedirs(pkg)
    open(os.path.join(pkg, "__init__.py"), "w").close()
    with open(os.path.join(pkg, "entry.py"), "w") as f:
        f.write(SCATTER_ENTRY.format(shift=shift))
    cfg = dict(_tiny_config(root), reference="reference_scatter")
    cell = add_cell(root, "scatter_room", cfg, "look",
                    dict(EXACT, scattering=1e-6))
    r = run(root, cell)
    assert r["correct"] is correct, r["checks"]
    assert r["checks"]["scattering"]["value"] == (0.0 if correct else 1.0)
    assert r["checks"]["image"]["value"] <= EXACT["image"]
    cell = add_cell(root, "unnamed_room", cfg, "look", EXACT)
    with pytest.raises(ValueError, match="scattering"):
        run(root, cell)


def test_a_program_leaf_the_package_leaves_out_raises(tiny_root):
    """A leaf of the program's state that the reference package does not
    compare (the default's frame leaves no scattering map) passes while
    it is the reference's zero state, and raises once it has moved."""
    cell = cells.load_cell("gi_room.look", tiny_root)
    frames = program_frames(cell)
    ref = check.ViewReference(cell.config, cell.root, CPU)
    assert "scattering" not in ref.leaves
    check.view_readings(ref, frames, SEED)
    last = frames[-1]
    frames[-1] = dataclasses.replace(last, state_out=dataclasses.replace(
        last.state_out, scattering=last.state_out.scattering + 1.0))
    with pytest.raises(ValueError, match="scattering"):
        check.view_readings(ref, frames, SEED)


def test_renderer_settings_reach_both_sides(tiny_root):
    """A configuration's ``renderer`` object sets the stated fields of
    each side's built renderer's ``screen_cfg``, every other field the
    scene's own; a cell of it runs correct; an unknown setting or field
    raises on each side."""
    from benchmark import program
    from benchmark.reference.core import config as ref_config
    from madarch_tpu_torch.core import config as port_config
    cfg = _tiny_config(tiny_root)
    cfg["renderer"] = {"screen_cfg": {"ambient_occlusion_steps": 1}}
    for side, mod in ((program._renderer(cfg, tiny_root, CPU), port_config),
                      (check.reference_renderer(cfg, tiny_root, CPU),
                       ref_config)):
        assert side.screen_cfg == dataclasses.replace(
            mod.screen_shade_config(False), ambient_occlusion_steps=1)
    cell = add_cell(tiny_root, "ao_room", cfg, "look", EXACT)
    r = run(tiny_root, cell)
    assert r["correct"], r["checks"]
    for bad in ({"screen_cfg": {"no_such_field": 1}},
                {"no_such": {}}, {"volumetrics": {}}):
        cfg["renderer"] = bad
        with pytest.raises(ValueError, match="no_such|volumetrics"):
            program._renderer(cfg, tiny_root, CPU)
        with pytest.raises(ValueError, match="no_such|volumetrics"):
            check.reference_renderer(cfg, tiny_root, CPU)


def test_renderer_settings_keep_a_scenes_volumetrics(tiny_root):
    """On a scene with volumetrics, a ``screen_cfg`` object that states
    only the specular mode keeps the composite of the volumetric passes
    (``render_volumetrics``), on the port's light-shafts scene and on a
    reference renderer with volumetrics."""
    from benchmark import program
    from benchmark.reference.core import config as ref_config
    from benchmark.reference.render.renderer import Renderer
    from benchmark.reference.scene.scene import SceneSpec
    from madarch_tpu_torch.core import config as port_config
    stated = {"renderer": {"screen_cfg": {"indirect_specular_mode": 1}}}
    cfg = dict(_tiny_config(tiny_root), builder="light_shafts", **stated)
    port = program._renderer(cfg, tiny_root, CPU)
    assert port.volumetrics.enabled
    assert port.screen_cfg == dataclasses.replace(
        port_config.screen_shade_config(True), indirect_specular_mode=1)
    ref = Renderer(SceneSpec(prims=(), lights=()), 8, 8, device=CPU)
    assert ref.volumetrics.enabled
    cells.apply_settings(ref, stated)
    assert ref.screen_cfg == dataclasses.replace(
        ref_config.screen_shade_config(True), indirect_specular_mode=1)


class FrozenViewReference:
    """The check's reference frame as it was before reference packages:
    ViewReference.frame and .state composing the default package's
    passes inline (kept frozen here, to hold the dispatch to it)."""

    def __init__(self, config, root, device):
        from benchmark.reference.render import pipeline
        self.rr = check.reference_renderer(config, root, device)
        self.pipeline = pipeline
        self.tally = []

    def state(self, rad, irr):
        return self.pipeline.FrameState(
            radiance=rad, irradiance=irr,
            scattering=self.pipeline.initial_state(
                self.rr.probes, self.rr.volumetrics,
                self.rr.device).scattering)

    def frame(self, pose, edit, state, pixels, control=False):
        from benchmark.reference.render import probes as probes_mod
        from benchmark.reference.render.camera import (camera_rays,
                                                       pixel_grid)
        from benchmark.reference.render.shading import pixel_color
        from benchmark.reference.scene import lights
        from benchmark.reference.scene.scene import tree_map
        rr, P = self.rr, self.pipeline
        rr.set_camera_position(pose[0])
        rr.set_camera_orientation(pose[1])
        if edit is not None:
            name, index, fields = edit
            rr.set_light(getattr(lights, name), index, **fields)
        dev = rr.device
        if state is None:
            state = P.initial_state(rr.probes, rr.volumetrics, dev)
        else:
            state = P.FrameState(radiance=state.radiance.to(dev),
                                 irradiance=state.irradiance.to(dev),
                                 scattering=state.scattering.to(dev))
        q = check._bf if control else check._same
        data = tree_map(q, rr.scene_data)
        cam = rr.camera
        cam = P.Camera(position=q(cam.position),
                       orientation=q(cam.orientation))
        state = tree_map(q, state)
        with torch.no_grad():
            rad = q(P.radiance_pass(rr.spec, data, rr.probes,
                                    rr.probe_cfg, state.irradiance,
                                    state.radiance))
            irr = q(probes_mod.integrate_irradiance(rr.probes, rad))
            frag = pixel_grid(rr.width, rr.height, dev).reshape(-1, 2)
            frag = frag[torch.as_tensor(pixels, device=dev)]
            o, d = camera_rays(frag, cam.position, cam.orientation)
            c = pixel_color(rr.spec, data, rr.probes, rr.screen_cfg, irr,
                            rad, o, d)[0]
            c = torch.clamp_min(c, 0.0)
            c = q(((c + 1e-8) / (c + 1.0)) ** 0.4545)
        return c, rad, irr


def frozen_view_readings(ref, frames, seed, control=False):
    """check.view_readings as it was before reference packages."""
    worst = {"image": 0.0, "image_wrong": 0.0, "radiance": 0.0,
             "irradiance": 0.0}
    ref_state = ctl_state = None
    for f in frames:
        if f.pixels is None:
            h, w = f.image.shape[:2]
            pixels = check.pixel_sample(seed, f.k, h * w)
        else:
            pixels = f.pixels
        chained = isinstance(f.state_in, str) and f.state_in == check.CHAIN
        c_ref, rad_ref, irr_ref = ref.frame(
            f.pose, f.edit, ref_state if chained else f.state_in, pixels)
        ref_state = ref.state(rad_ref, irr_ref)
        if control:
            c, rad, irr = ref.frame(f.pose, f.edit,
                                    ctl_state if chained else f.state_in,
                                    pixels, control=True)
            ctl_state = ref.state(rad, irr)
        else:
            dev = c_ref.device
            if f.pixels is None:
                c = f.image.reshape(-1, 3)[torch.as_tensor(
                    pixels, device=f.image.device)]
            else:
                c = f.image
            c = c.to(dev)
            rad = f.state_out.radiance.to(dev)
            irr = f.state_out.irradiance.to(dev)
        gap = (c - c_ref).abs()
        got = {"image": float(gap.mean()),
               "image_wrong": float((gap.amax(dim=1) > check.WRONG)
                                    .float().mean()),
               "radiance": check.rel_l1(rad, rad_ref),
               "irradiance": check.rel_l1(irr, irr_ref)}
        for key, v in got.items():
            worst[key] = max(worst[key], v)
    return worst


def program_frames(cell, n=4):
    """n frames of the program on the CPU as a view run keeps them: the
    first n − 1 chained from the zero state on the chain's pixels, the
    last whole, from the program's state before it."""
    from benchmark import program, traffic
    prog = program.ViewProgram(cell.config, cell.root, CPU)
    gen = traffic.make(cell.mix, SEED, prog.scene_position)
    w, h = cell.config["resolution"]
    px = check.pixel_sample(SEED, check.CHAIN_KEY, w * h)
    frames = []
    for i in range(n):
        k = i - harness.SETUP_FRAMES
        pose, edit = gen.pose(k), gen.edit(k)
        if edit is not None:
            prog.edit(edit)
        prog.set_pose(*pose)
        state_in = prog.state
        image = prog.render()
        if i < n - 1:
            frames.append(check.Frame(
                k, pose, edit, None if i == 0 else check.CHAIN,
                image.reshape(-1, 3)[torch.as_tensor(px)], prog.state,
                pixels=px))
        else:
            frames.append(check.Frame(k, pose, edit, state_in, image,
                                      prog.state))
    prog.close()
    return frames


@pytest.mark.parametrize("name", ["gi_room.look", "torus_mesh.orbit"])
def test_the_dispatch_is_the_frozen_frame(tiny_root, name):
    """Through the default reference package, the check reads bit for bit
    what its frame composed inline before reference packages gave: each
    frame's colours and atlases, the readings against the program's
    frames, and the control's."""
    cell = cells.load_cell(name, tiny_root)
    frames = program_frames(cell)
    new = check.ViewReference(cell.config, cell.root, CPU)
    old = FrozenViewReference(cell.config, cell.root, CPU)
    new_state = old_state = None
    for f in frames:
        pixels = f.pixels if f.pixels is not None else np.arange(
            f.image.shape[0] * f.image.shape[1])
        chained = isinstance(f.state_in, str)
        c, new_state = new.frame(f.pose, f.edit,
                                 new_state if chained else f.state_in,
                                 pixels)
        c_old, rad, irr = old.frame(f.pose, f.edit,
                                    old_state if chained else f.state_in,
                                    pixels)
        old_state = old.state(rad, irr)
        assert torch.equal(c, c_old)
        assert torch.equal(new_state.radiance, rad)
        assert torch.equal(new_state.irradiance, irr)
    for control in (False, True):
        got = check.view_readings(new, frames, SEED, control=control)
        want = frozen_view_readings(old, frames, SEED, control=control)
        assert got == want, (control, got, want)


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
