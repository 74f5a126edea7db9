"""The port's own recorder (utils/profiling.py) over a closed loop of
frames, and what it costs, in turns with the recorder off:

    python -m madarch_tpu_torch.tools.trace_probe [CONFIG] [--size 1000] \\
        [--frames 300] [--turns 2] [--device cuda]

CONFIG is one of the bench's configurations (madarch_tpu_torch/bench.py:
CONFIGS; default global_illumination, the benchmark's gi_room scene).
Each turn renders two segments, the recorder off and on (the order
alternating between turns), each from a fresh compiled frame (captured
with the recorder in that state: a frame captured off holds no event
nodes) after SETUP_FRAMES frames; the camera turns 3 degrees a frame and
each frame is waited for, as a viewer's are.  For each segment: host ms
a frame inside render() (median) and wall ms a frame; with the recorder
on, its spans' host ms, its device intervals' ms and its counters, each
a frame.  Then ``frame_counters``: the counters of one eager frame, which
a compiled frame records only while it is set up (its warm-up and capture
run the Python; a replay runs none), such as light_shafts'
``froxel_rays``, ``scattering_rays``, ``scattering_taps`` and
``volumetrics.kernel`` / ``volumetrics.plain``.  Then ``geometry``: that
frame's GEOMETRY_COUNTERS, 0 where none was recorded (the CPU launches
no 8-lane group), and its bounces (each geometry call's rays, twice where
the reflection is folded) with the share of them the kernel did not
classify (it classifies only a bounce that can hit), counted by a
COUNT_WORK launch of each of the frame's geometry calls on its own
inputs; on the CPU, which has no such build, ``skipped_bounces`` and
``skipped_share`` are None.  One JSON line on stdout.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from madarch_tpu_torch import bench
from madarch_tpu_torch.ops import march as march_ops
from madarch_tpu_torch.render import pipeline
from madarch_tpu_torch.utils import profiling

SETUP_FRAMES = 3
YAW_STEP = np.deg2rad(3.0)
# the geometry passes' counters (render/context.py:SceneCtx.geometry,
# ops/march.py:geometry)
GEOMETRY_COUNTERS = ("geometry.rays", "geometry.slot_rays.typed",
                     "geometry.slot_rays.chunked", "geometry.lanes8_rays")


def per_frame(rec):
    """{"span_ms", "device_ms", "counters"}: each name's sum a frame over
    the drain's render() frames (host ms of the spans, ms of the device
    intervals, the counters)."""
    frames = {s[4] for s in rec["spans"] if s[0] == "render"}
    n = max(len(frames), 1)
    out = {"span_ms": {}, "device_ms": {}, "counters": {}}
    for name, start, end, _, f in rec["spans"]:
        if f in frames:
            out["span_ms"][name] = out["span_ms"].get(name, 0.0) \
                + (end - start) / 1e6 / n
    for key, records in (("device_ms", rec["device"]),
                         ("counters", rec["counters"])):
        for f, name, v in records:
            if f in frames:
                out[key][name] = out[key].get(name, 0) + v / n
    return out


def segment(r, frames, on, k0):
    """One segment of ``frames`` timed frames from a fresh capture."""
    pipeline.clear_compiled()
    (profiling.enable if on else profiling.disable)()
    host = []
    k = k0
    t0 = None
    for i in range(SETUP_FRAMES + frames):
        if i == SETUP_FRAMES:
            profiling.drain()
            t0 = time.perf_counter()
        r.set_camera_angles(0.0, k * YAW_STEP)
        t_b = time.perf_counter()
        r.render()
        host.append(time.perf_counter() - t_b)
        bench.sync(r.device)
        k += 1
    wall = time.perf_counter() - t0
    rec = profiling.drain()
    profiling.disable()
    out = {"recorder": on, "frames": frames,
           "host_ms": statistics.median(host[SETUP_FRAMES:]) * 1e3,
           "frame_ms": wall * 1e3 / frames}
    if on:
        out.update(per_frame(rec))
    return out, k


def frame_counters(r):
    """({name: value} of the counters of one eager frame of ``r``, the
    (args, kwargs) of each geometry call that frame made)."""
    calls = []
    launch = march_ops.geometry

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return launch(*args, **kwargs)

    profiling.drain()
    profiling.enable()
    march_ops.geometry = record
    try:
        with pipeline.eager():
            r.render()
    finally:
        march_ops.geometry = launch
        profiling.disable()
    return per_frame(profiling.drain())["counters"], calls


def skipped_bounces(calls, device):
    """{"bounces", "skipped_bounces", "skipped_share"} over the geometry
    ``calls``: each launched again by the COUNT_WORK build of the lanes the
    wrapper chose, whose fourth sum counts the bounces not classified; the
    skip counts are None off a card."""
    bounces = sum(args[3].shape[0] * (1 if kw.get("mat_rough_vec") is None
                                      else 2) for args, kw in calls)
    skipped = None
    if device.type == "cuda":
        skipped = 0
        for args, kw in calls:
            work = torch.zeros(march_ops.WORK_COUNTS, dtype=torch.int64,
                               device=device)
            lanes = march_ops.geometry_lanes(args[0], args[3].shape[0])
            march_ops.geometry(*args, **kw, work=work,
                               library=march_ops.geometry_library(
                                   lanes, count_work=True))
            skipped += int(work[3])
    return {"bounces": bounces, "skipped_bounces": skipped,
            "skipped_share": None if skipped is None or not bounces
            else skipped / bounces}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", nargs="?", default="global_illumination",
                    choices=list(bench.CONFIGS))
    ap.add_argument("--size", type=int, default=1000)
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    r = bench.make_config(args.config, args.size, dev)
    segments, k = [], 0
    for turn in range(args.turns):
        for on in ((False, True) if turn % 2 == 0 else (True, False)):
            seg, k = segment(r, args.frames, on, k)
            segments.append(seg)
    counters, calls = frame_counters(r)
    out = {"config": args.config, "size": args.size,
           "device": torch.cuda.get_device_name(dev)
           if dev.type == "cuda" else dev.type, "segments": segments,
           "frame_counters": counters,
           "geometry": {name: counters.get(name, 0)
                        for name in GEOMETRY_COUNTERS}
           | skipped_bounces(calls, dev)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
