"""The trace readers, the metric readers and the roofline arithmetic on
synthetic inputs, and the reference's operation count on a tiny scene
against a hand count."""
import os

import pytest
import torch

from benchmark import cells, harness, roofline, tracing
from benchmark.conftest import BENCH

MS = 1_000_000


def reader(name):
    return cells.load_reader(os.path.join(BENCH, "metrics", name + ".py"))


def synthetic():
    """Two frames of 10 ms on the device clock: frame 0 busy 6 ms (geometry
    1 ms), frame 1 busy 8 ms (geometry 2 ms), the host inside render while
    the device waits."""
    spans = [("bench.frame", 0, 10 * MS), ("bench.render", 0, 3 * MS),
             ("bench.wait", 3 * MS, 10 * MS),
             ("bench.frame", 10 * MS, 20 * MS),
             ("bench.render", 10 * MS, 11 * MS),
             ("bench.wait", 11 * MS, 20 * MS)]
    device = [("shade_a", 3 * MS, 8 * MS),
              ("void geometry_kernel<1>", 8 * MS, 9 * MS),
              ("shade_b", 11 * MS, 17 * MS),
              ("void geometry_kernel<8>", 17 * MS, 19 * MS)]
    t = tracing.Trace(device=device, spans=spans, window=(0, 20 * MS))
    return harness.Window(kind="view", n=4, wall_s=0.02,
                          latency_s=[0.01] * 2, host_s=[0.002, 0.004],
                          edit_s=[0.0, 0.001], trace=t, trace_k0=2,
                          roofline=[(3, 0.5)])


def test_view_readers():
    w = synthetic()
    assert reader("host_ms.view")(w) == pytest.approx(3.5)
    assert reader("shade_ms.view")(w) == pytest.approx(5.5)
    assert reader("geometry_ms.view")(w) == pytest.approx(1.5)
    assert reader("idle_share.view")(w) == pytest.approx(30.0)
    # frame k = 3 is the second traced frame: 0.5 ms bound over 2 ms
    assert reader("geometry_roofline.view")(w) == pytest.approx(25.0)
    assert reader("host_ms.fit")(w) is None


def test_breakdown_by_host_span():
    b = tracing.breakdown(synthetic().trace)
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"render": 0.005, "wait": 0.001})
    assert b["device_ops"][0] == ["shade_b", pytest.approx(0.006)]


def test_busy_is_the_union():
    ev = [("a", 0, 10), ("b", 5, 12), ("c", 20, 25)]
    assert tracing.busy_ns(ev, 0, 30) == 17
    assert tracing.busy_ns(ev, 6, 22) == 8


class _Event:
    def __init__(self, name, s, e):
        self.n, self.s, self.e = name, s, e

    def name(self):
        return self.n

    def device_type(self):
        return torch.autograd.DeviceType.CUDA

    def is_user_annotation(self):
        return False

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e


class _Prof:
    def __init__(self, events):
        class R:
            def events(_):
                return events

        class P:
            kineto_results = R()
        self.profiler = P()


def test_markers_put_the_host_spans_on_the_device_clock():
    spans = tracing.Spans(torch.device("cpu"))
    spans.spans = [("bench.frame", 100, 200), ("bench.frame", 300, 400)]
    spans.marks = [101, 301]
    prof = _Prof([_Event("at::cuda::spin_kernel(long)", 5101, 5102),
                  _Event("k", 5110, 5190),
                  _Event("at::cuda::spin_kernel(long)", 5305, 5306),
                  _Event("k", 5310, 5390)])
    t = tracing.read_trace(prof, spans, "frame")
    assert t.window == (5100, 5400)
    assert [e[0] for e in t.device] == ["k", "k"]
    with pytest.raises(RuntimeError):
        spans.marks.append(500)
        tracing.read_trace(prof, spans, "frame")


def test_bound():
    ms, by = roofline.bound(67e9, 1e6)
    assert ms == pytest.approx(1.0) and by == "operations"
    ms, by = roofline.bound(1.0, 3.35e9)
    assert ms == pytest.approx(1.0) and by == "bytes"
    t = {"rays": 100, "flops": 6.7e9, "per_ray": 100, "fixed_bytes": 0}
    # 1,000 rays: 6.7e10 flops = 1 ms against 1e5 bytes
    assert roofline.launch_bound_ms(t, 1000) == pytest.approx(1.0)


def test_frozen_count_by_hand():
    """One sphere and one plane: every scene evaluation of a point costs
    SLOT_FLOPS of each, and the tally's bytes are the kernel's inputs and
    outputs once."""
    from benchmark.reference.core.config import ShadeConfig
    from benchmark.reference.ops import march
    from benchmark.reference.render.context import SceneCtx
    from benchmark.reference.scene import lights as L
    from benchmark.reference.scene import primitives as P
    from benchmark.reference.scene.scene import SceneBuilder, SceneSpec
    spec = SceneSpec(prims=((P.Sphere, 1), (P.Plane, 1)),
                     lights=((L.PointLight, 1),))
    b = SceneBuilder(spec)
    b.add_primitive(P.Sphere, center=(0.0, 0.0, 3.0), radius=1.0,
                    material_id=0)
    b.add_primitive(P.Plane, normal=(0.0, 1.0, 0.0), offset=2.0,
                    material_id=0)
    b.add_light(L.PointLight, position=(0.0, 3.0, 0.0), color=(1.0,) * 3)
    packed = march.pack_scene(spec, b.device_data("cpu"))
    pts = torch.randn(37, 3)
    with march.counting():
        march.scene_dist(packed, pts, 100.0)
        flops = march.scene_eval_flops()
    assert flops == 37 * (march.SLOT_FLOPS[0] + march.SLOT_FLOPS[1])

    n = 16
    o = torch.zeros(n, 3)
    d = torch.nn.functional.normalize(torch.randn(n, 3), dim=1)
    march.geometry.tally = []
    try:
        march.geometry(packed, torch.tensor([0.0, 3.0, 0.0]), 1, o, d, 100.0,
                       probe_spacing=(2.0, 3.0, 3.0),
                       probe_dims=(4, 3, 3), surface_offset=0.01,
                       ao_steps=3)
        (t,) = march.geometry.tally
    finally:
        march.geometry.tally = None
    assert t["rays"] == n
    assert t["per_ray"] == 24 + 4 * (10 + 1 + 8)
    assert t["fixed_bytes"] == 4 * (packed.rows.numel() + packed.info.numel()
                                    + packed.chunks.numel()
                                    + packed.aabbs.numel()
                                    + packed.cap_boxes.numel() + 3)
    assert t["flops"] > 0 and t["flops"] % 1 == 0
    del ShadeConfig, SceneCtx
