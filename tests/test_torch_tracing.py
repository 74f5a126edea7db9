"""The port's own recorder (utils/profiling.py: spans, counters and device
intervals) inside Renderer.render() and the compiled frame, on the CPU.

On the CPU a device interval is a host span of the same name around the
same code, so these tests cover the wiring the card's event pairs follow:

- Off: nothing is recorded, and span() is one shared no-op context.
- On and off give bit-equal images and states.
- The spans nest with the right parents, one frame id a render().
- Counters: copy_in_bytes is the Captured buffers' nbytes; data_builds
  is 1 on a frame after set_light and 0 on an unedited one;
  frame_captures and frame_evictions follow GRAPH_CACHE_SIZE.
- The pass names appear once a frame and ``pack`` once a kernel-route
  SceneCtx (GI and, with volumetrics, light_shafts); ``probes`` once a
  probe lookup, inside its pass.
- A compiled step records its copy-in and replay under frame ids of its
  own.
- The card's path for device intervals (before_replay, after_replay,
  drain) on stand-in events: read once done, dropped when a replay would
  record them again before they are done, waited for at drain().
"""
import pytest
import torch

from madarch_tpu_torch.core.config import ProbeSettings, VolumetricsSettings
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.parallel import spmd as tspmd
from madarch_tpu_torch.render import context as ctx_mod
from madarch_tpu_torch.render import pipeline as TPL
from madarch_tpu_torch.scene import lights as TL
from madarch_tpu_torch.scene.scene import tree_leaves
from madarch_tpu_torch.utils import profiling
from test_torch_config import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

# 64x64 (two screen blocks a side) with the benchmark's tiny probes
SIZE = 64
PROBES = ProbeSettings(radiance_resolution=4, irradiance_resolution=2)
SMALL_VOL = VolumetricsSettings(visibility_resolution=(8, 8, 8),
                                visibility_step_size=0.5,
                                scattering_resolution=(12, 12),
                                scattering_step_size=0.5)
FIELDS = ("radiance", "irradiance", "scattering")
GI_PASSES = ("pass.radiance", "pass.irradiance", "pass.screen",
             "frame.writeback")
HOST_CHILDREN = ("render.spec", "frame.lookup", "frame.copy_in",
                 "frame.replay", "frame.out")
# each span's parent in a GI frame
PARENTS = {**{name: ("render",) for name in HOST_CHILDREN
              + ("render.data", "render.camera")},
           **{name: ("frame.replay",) for name in GI_PASSES},
           "pack": ("pass.radiance", "pass.screen"),
           "probes": ("pass.radiance", "pass.screen")}
# the shade's probe lookups a GI frame (mode 2): the irradiance in the
# radiance and the screen pass, the reflection's radiance tile
GI_LOOKUPS = 3


def gi(size=SIZE):
    return tscenes.global_illumination(width=size, height=size,
                                       probes=PROBES, device="cpu")


def shafts():
    return tscenes.light_shafts(width=32, height=32, probes=PROBES,
                                volumetrics=SMALL_VOL, device="cpu")


@pytest.fixture
def recorder():
    """The recorder on, empty and with no compiled frame kept; off and
    drained afterwards."""
    TPL.clear_compiled()
    profiling.drain()
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()
        profiling.drain()
        TPL.clear_compiled()


def frames_of(rec):
    """{frame id: [span records]} of a drain."""
    out = {}
    for s in rec["spans"]:
        out.setdefault(s[4], []).append(s)
    return out


def counter(rec, name, frame):
    return sum(v for f, n, v in rec["counters"] if n == name and f == frame)


def render_ids(rec):
    return [s[4] for s in rec["spans"] if s[0] == "render"]


def test_off_records_nothing():
    TPL.clear_compiled()
    profiling.drain()
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.span("b")
    assert profiling.device_span("a", "cpu") is profiling.span("a")
    r = gi(32)
    r.render()
    r.set_light(TL.SpotLight, 0, color=(0.5, 0.5, 0.5))
    r.render()
    profiling.count("x", 3)
    assert profiling.drain() == {"spans": [], "counters": [], "device": []}
    TPL.clear_compiled()


def test_on_and_off_render_bit_equal_frames(recorder):
    runs = []
    for on in (False, True):
        (profiling.enable if on else profiling.disable)()
        TPL.clear_compiled()
        r = gi()
        frames = []
        for k in range(3):
            if k == 2:
                r.set_light(TL.SpotLight, 0, direction=(0.0, -1.0, 0.0))
            frames.append((r.render(), r.state))
        runs.append(frames)
    assert len(render_ids(profiling.drain())) == 3
    for (img_a, st_a), (img_b, st_b) in zip(*runs):
        assert torch.equal(img_a, img_b)
        assert all(torch.equal(getattr(st_a, f), getattr(st_b, f))
                   for f in FIELDS)


def test_spans_nest_with_one_frame_id_a_render(recorder):
    r = gi()
    for _ in range(2):
        r.render()
    rec = profiling.drain()
    spans = rec["spans"]
    ids = render_ids(rec)
    assert len(ids) == 2 and ids[0] < ids[1]
    by_frame = frames_of(rec)
    assert sorted(by_frame) == ids
    for fid in ids:
        names = [s[0] for s in by_frame[fid]]
        assert names[0] == "render"
        for name in HOST_CHILDREN + GI_PASSES:
            assert names.count(name) == 1, name
        assert names.count("probes") == GI_LOOKUPS
    for s in spans:
        name, start, end, parent, fid = s
        assert start <= end
        if name == "render":
            assert parent == -1
            continue
        p = spans[parent]
        # a child lies inside its parent, in the same frame
        assert p[4] == fid and p[1] <= start and end <= p[2]
        assert p[0] in PARENTS[name], name
    # the first frame builds the data and uploads the camera, the second
    # neither
    first, second = ([s[0] for s in by_frame[f]] for f in ids)
    assert "render.data" in first and "render.camera" in first
    assert "render.data" not in second and "render.camera" not in second


def test_copy_in_bytes_are_the_buffers(recorder):
    r = gi()
    r.render()
    r.render()
    rec = profiling.drain()
    bufs = [b for name in ("data", "camera", "state")
            for b in tree_leaves(getattr(r.frame, name))]
    for fid in render_ids(rec):
        assert counter(rec, "copy_in_bytes", fid) == sum(
            b.nbytes for b in bufs)
        assert counter(rec, "copy_in_leaves", fid) == len(bufs)


def test_a_scene_edit_rebuilds_the_data_once(recorder):
    r = gi()
    r.render()
    profiling.drain()
    r.render()
    r.set_light(TL.SpotLight, 0, direction=(0.0, 1.0, 0.0))
    r.render()
    rec = profiling.drain()
    unedited, edited = render_ids(rec)
    assert counter(rec, "data_builds", unedited) == 0
    assert counter(rec, "data_builds", edited) == 1
    assert counter(rec, "data_bytes", edited) == sum(
        x.nbytes for x in tree_leaves(r.scene_data))
    assert counter(rec, "camera_uploads", edited) == 0
    assert [s[0] for s in rec["spans"]].count("render.data") == 1


@pytest.mark.parametrize("name,passes", [
    ("gi", GI_PASSES),
    ("light_shafts", GI_PASSES + ("pass.visibility", "pass.scattering"))])
def test_passes_once_a_frame_and_pack_once_a_scene_ctx(recorder,
                                                       monkeypatch, name,
                                                       passes):
    r = gi() if name == "gi" else shafts()
    built = []
    init = ctx_mod.SceneCtx.__init__

    def counting(self, *args, **kwargs):
        init(self, *args, **kwargs)
        built.append(self.use_kernel)

    monkeypatch.setattr(ctx_mod.SceneCtx, "__init__", counting)
    for _ in range(2):
        r.render()
    rec = profiling.drain()
    names = [s[0] for s in rec["spans"]]
    for p in passes:
        assert names.count(p) == 2, p
    assert all(built)
    assert names.count("pack") == len(built) > 0


def test_captures_and_evictions_follow_the_cache_size(recorder):
    r = gi(16)
    sizes = [(16 + 2 * i, 16) for i in range(TPL.GRAPH_CACHE_SIZE + 2)]
    for w, h in sizes:
        r.width, r.height = w, h
        r.state = TPL.initial_state(r.probes, r.volumetrics, "cpu")
        r.render()
    r.render()   # the last key again: found
    rec = profiling.drain()
    ids = render_ids(rec)
    captures = [counter(rec, "frame_captures", f) for f in ids]
    evictions = [counter(rec, "frame_evictions", f) for f in ids]
    assert captures == [1] * len(sizes) + [0]
    assert evictions == [0] * TPL.GRAPH_CACHE_SIZE + [1, 1, 0]
    assert TPL.cache_size() == TPL.GRAPH_CACHE_SIZE


def test_a_compiled_step_records_under_its_own_frame_ids(recorder):
    r = gi(16)
    step = tspmd.make_train_step(r.spec, r.probes, r.volumetrics, r.width,
                                 r.height, screen_cfg=r.screen_cfg,
                                 probe_cfg=r.probe_cfg)
    data, camera, state = r.scene_data, r.camera, r.state
    profiling.drain()
    step(data, camera, state, torch.zeros((16, 16, 3)))
    rec = profiling.drain()
    roots = [s for s in rec["spans"] if s[3] == -1]
    assert [s[0] for s in roots] == ["frame.copy_in", "frame.replay"]
    assert roots[0][4] != roots[1][4]
    assert "render" not in [s[0] for s in rec["spans"]]
    assert counter(rec, "copy_in_bytes", roots[0][4]) == sum(
        b.nbytes for name in ("data", "camera", "state", "target")
        for b in tree_leaves(getattr(step.compiled_step, name)))


class _Event:
    """A stand-in for a timing CUDA event at host time ``t`` ms."""

    def __init__(self, t, done=True):
        self.t, self.done = t, done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return end.t - self.t


def test_graph_event_pairs_are_read_once_done(recorder):
    pairs = [("pass.radiance", _Event(0.0), _Event(2.0)),
             ("pass.screen", _Event(2.0), _Event(7.0))]
    for done in (True, False, True):
        with profiling.span("render"):
            profiling.before_replay(pairs)
            for _, _, end in pairs:
                end.done = done
            profiling.after_replay(pairs)
    rec = profiling.drain()
    fids = render_ids(rec)
    # the first replay's pairs were read at the second replay; the
    # second's were not done at the third and were dropped; the third's
    # were waited for at drain()
    assert rec["device"] == [(fids[0], "pass.radiance", 2.0),
                             (fids[0], "pass.screen", 5.0),
                             (fids[2], "pass.radiance", 2.0),
                             (fids[2], "pass.screen", 5.0)]
    assert counter(rec, "device_dropped", fids[2]) == 1
    # a graph captured with the recorder off has no pairs: nothing pends
    profiling.after_replay([])
    assert profiling.drain()["device"] == []


def test_drain_inside_a_span_raises(recorder):
    with profiling.span("render"):
        with pytest.raises(RuntimeError):
            profiling.drain()
    assert render_ids(profiling.drain()) != []


def test_trace_probe_turns_the_recorder_off_and_on():
    from madarch_tpu_torch.tools import trace_probe
    TPL.clear_compiled()
    out = trace_probe.main(["global_illumination", "--size", "32",
                            "--frames", "1", "--turns", "2",
                            "--device", "cpu"])
    assert [s["recorder"] for s in out["segments"]] == [False, True,
                                                         True, False]
    assert not profiling.enabled()
    for seg in out["segments"]:
        assert seg["host_ms"] > 0 and seg["frame_ms"] > 0
        if seg["recorder"]:
            # on the CPU the passes are host spans
            assert seg["device_ms"] == {}
            for name in GI_PASSES + ("render", "frame.replay"):
                assert seg["span_ms"][name] > 0, name
            assert "frame_captures" not in seg["counters"]
            assert seg["counters"]["camera_uploads"] == 1
    TPL.clear_compiled()
