"""Reading a traced run: the profiler's raw device events (kineto, as
recorded, which include the kernels a replayed CUDA graph launches), the
benchmark's own host spans, and the window's busy time, idle gaps and
heaviest device operations.

The profiler records the device alone: recording the host's PyTorch ops
as well would slow the host side of every frame several-fold.  The
benchmark times its own host spans (``Spans``, on ``time.perf_counter_ns``)
and, in a traced run, launches a marker kernel (``mark``) just before each
frame or step.  The device is idle when it comes (the loop waited for the
previous item), so the marker starts a launch latency after its host
time; the smallest gap over the window puts the host spans on the
device's clock.  The markers are the benchmark's and are left out of the
device events.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

SPAN = "bench."
# The marker kernel (ATen's spin kernel of torch.cuda._sleep, 0 cycles).
MARK = "spin_kernel"
# Deepest nesting of the benchmark's spans looked through.
NEST = 8
# Kernels written by hand in the port (ops/csrc): the rest of a frame's
# device work is the PyTorch ops of the shade, the probes and the packing.
HAND_WRITTEN = ("geometry_kernel", "raycast_kernel", "visibility_kernel",
                "softshadow_kernel")


class Spans:
    """The benchmark's host spans: ``with spans("frame"): ...`` records
    (SPAN + name, start_ns, end_ns) on the host clock; ``mark()`` launches
    the marker kernel on a card and records its host time."""

    def __init__(self, device):
        self.device = device
        self.spans = []
        self.marks = []

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((SPAN + name, t0, time.perf_counter_ns()))

    def mark(self):
        import torch
        if self.device.type == "cuda":
            self.marks.append(time.perf_counter_ns())
            torch.cuda._sleep(0)


@dataclasses.dataclass
class Trace:
    """``device``: [(name, start_ns, end_ns)] of the device's operations
    (kernels, copies, sets) in start order; ``spans``: [(name, start_ns,
    end_ns)] of the benchmark's host spans in start order; ``window``:
    (start_ns, end_ns) of the traced window, on the same clock."""

    device: list
    spans: list
    window: tuple

    def __post_init__(self):
        self._device_starts = [e[1] for e in self.device]

    def spans_named(self, name):
        return [s for s in self.spans if s[0] == SPAN + name]

    def device_in(self, start, end):
        """The device operations that start inside [start, end)."""
        starts = self._device_starts
        return self.device[bisect.bisect_left(starts, start):
                           bisect.bisect_left(starts, end)]


def read_trace(prof, spans, item):
    """A Trace from a torch.profiler profile of the device and the
    benchmark's ``Spans``: the spans moved onto the device's clock by the
    markers (left where they are when the run traced no card), the window
    from the start of the first span ``item`` (a frame or a step) to the
    end of the last.  Raises RuntimeError when the trace does not hold one
    marker for each one marked."""
    import torch
    device, marks = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        if MARK in e.name():
            marks.append(e.start_ns())
        else:
            device.append((e.name(), e.start_ns(), e.end_ns()))
    device.sort(key=lambda e: e[1])
    marks.sort()
    if len(marks) != len(spans.marks):
        raise RuntimeError(f"the trace holds {len(marks)} markers, "
                           f"{len(spans.marks)} were launched")
    offset = min((d - h for d, h in zip(marks, spans.marks)), default=0)
    moved = sorted(((n, s + offset, e + offset) for n, s, e in spans.spans),
                   key=lambda x: x[1])
    items = [x for x in moved if x[0] == SPAN + item]
    window = (items[0][1], max(e for _, _, e in items)) if items else (0, 0)
    return Trace(device=device, spans=moved, window=window)


def busy_ns(events, start, end):
    """Nanoseconds of [start, end) in which some operation ran on the
    device (the union of the events' intervals, clipped)."""
    total, cur_s, cur_e = 0, None, None
    for _, s, e in sorted(events, key=lambda x: x[1]):
        s, e = max(s, start), min(e, end)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(trace):
    """[(start_ns, end_ns)] of the window's stretches with no device
    operation running."""
    start, end = trace.window
    gaps, cursor = [], start
    for _, s, e in trace.device:
        if e <= start or s >= end:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < end:
        gaps.append((cursor, end))
    return gaps


def host_at(trace, t, starts=None):
    """The innermost benchmark span open at ``t`` (its name without the
    prefix), or "outside" when none is; ``starts`` the spans' start times
    (for many lookups)."""
    if starts is None:
        starts = [s for _, s, _ in trace.spans]
    i = bisect.bisect_right(starts, t) - 1
    # spans nest a few deep: an open one lies among the last few started
    for j in range(i, max(i - NEST, -1), -1):
        name, _, e = trace.spans[j]
        if e > t:
            return name[len(SPAN):]
    return "outside"


def breakdown(trace, top=10):
    """{"device_ops": [[name, seconds]] the device operations of most
    time, "idle_gaps": [[what the host was doing, seconds]] the idle time
    by the benchmark span open at each gap's middle}, each the ``top``
    largest."""
    ops = {}
    start, end = trace.window
    for name, s, e in trace.device:
        if start <= s < end:
            ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
    idle = {}
    starts = [s for _, s, _ in trace.spans]
    for s, e in idle_gaps(trace):
        what = host_at(trace, (s + e) // 2, starts)
        idle[what] = idle.get(what, 0.0) + (e - s) / 1e9
    return {"device_ops": [[k, v] for k, v in sorted(
                ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]]}


def is_hand_written(name):
    return any(k in name for k in HAND_WRITTEN)

