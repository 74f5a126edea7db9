"""One run of one cell: set-up, the measured window, the reference check,
the metrics, and the result line.

A view cell is one viewer in a closed loop: each frame's pose (and edit)
is sent, ``render()`` called, and its image waited for before the next.
A fit cell runs the train step in a loop, each step waited for.  The
window lasts ``seconds``; its metrics are taken over all its frames or
steps and all its time.  With ``trace`` the window runs under
torch.profiler and the cell's per-layer metrics are read from the trace
and the benchmark's spans instead of its end-to-end metrics.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from benchmark import check, tracing, traffic as traffic_mod

# Frames rendered in set-up: the first captures the compiled frame, the
# rest replay it.
SETUP_FRAMES = 3
# Consecutive frames from the zero state, the set-up frames and the
# window's first, that the reference follows from its own state.
CHAIN_FRAMES = 8
# Train steps in set-up: the first captures the compiled step; the
# reference follows the first check.STEPS.
SETUP_STEPS = check.STEPS
# The window step the reference runs again from the program's parameters
# and state before it is drawn from the seed among the window's first
# WINDOW_STEPS (a window of 10 s holds several hundred).
WINDOW_STEPS = 32
# Window frames kept for the check, drawn uniformly from the seed over the
# whole window (reservoir sampling), besides the window's last frame.
SAMPLED_FRAMES = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "madarch_tpu")


class Failed(Exception):
    """A run that may print no result."""


def forbidden_modules():
    """Loaded modules whose top-level name (compared whole) is JAX's, a
    JAX library's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Window:
    """What a run measured, handed to the metric readers.  ``kind``: view
    or fit; ``n``: frames or steps completed in the window; ``wall_s``:
    from the window's start to the end of its last frame or step (a
    traced run: of its untraced first half);
    ``latency_s``, ``host_s`` (host time inside the call), ``edit_s``
    (host time of the scene edit): per untraced frame or step (a traced
    run's first half); ``trace``: a tracing.Trace of a traced run's
    second half, whose spans "frame" or "step" bracket each of its items,
    the first of them item ``trace_k0``;
    ``roofline``: [(k, bound ms)] of the checked window frames' geometry
    launches (traced view runs); ``check_s``: the seconds of the
    reference's check after the window."""

    kind: str
    n: int
    wall_s: float
    latency_s: list
    host_s: list
    edit_s: list
    trace: object = None
    trace_k0: int = 0
    roofline: list = dataclasses.field(default_factory=list)
    check_s: float = 0.0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA
                               if device.type == "cuda"
                               else ProfilerActivity.CPU])


def _window(kind, item, seconds, trace, device, call, k0=0):
    """The measured window: items k0, k0 + 1, ... until ``seconds`` have
    passed, each ``call(k, spans)`` -> (host time its call began, when it
    returned, host seconds of its scene edit), then waited for.  Returns
    the Window.  A traced run takes the host's spans over a first half,
    untraced, then traces the device over a second half of the same length
    (the profiler started between them): tracing the device slows the host
    side of each item by some milliseconds, and its hooks stay in the
    process once the profiler has stopped."""
    lat, host, edits = [], [], []
    k, prof, traced_spans, wall_s, k_traced = k0, None, None, 0.0, k0
    for traced in ([False, True] if trace else [False]):
        if traced:
            prof = _profiler(device)
            prof.start()
            k_traced = k
        spans = tracing.Spans(device)
        t0 = t_done = time.perf_counter()
        end = t0 + (seconds / 2 if trace else seconds)
        while t_done < end:
            with spans(item):
                if traced:
                    spans.mark()
                t_b, t_c, edit_s = call(k, spans)
                with spans("wait"):
                    _sync(device)
                t_done = time.perf_counter()
            if not traced:
                lat.append(t_done - t_b)
                host.append(t_c - t_b)
                edits.append(edit_s)
            k += 1
        if traced:
            prof.stop()
            traced_spans = spans
        else:
            wall_s = t_done - t0
    window = Window(kind=kind, n=k - k0, wall_s=wall_s, latency_s=lat,
                    host_s=host, edit_s=edits)
    bad = forbidden_modules()
    if bad:
        raise Failed(f"modules of JAX or the JAX package loaded: {bad}")
    if prof is not None:
        window.trace = tracing.read_trace(prof, traced_spans, item)
        window.trace_k0 = k_traced
    return window


def view_run(cell, seed, seconds, trace, device, t_start, control=False):
    """(window, readings, control readings or None, set-up s, memory peak,
    program record) of a view cell."""
    from benchmark.program import ViewProgram
    prog = ViewProgram(cell.config, cell.root, device)
    gen = traffic_mod.make(cell.mix, seed, prog.scene_position)
    w, h = cell.config["resolution"]
    chain_px = check.pixel_sample(seed, check.CHAIN_KEY, w * h)
    chain_idx = torch.as_tensor(chain_px, device=device)
    frames = []

    def chained(k, pose, edit, image):
        """Keeps frame k of the chain from the zero state: its colours at
        the chain's pixels and the state it left."""
        if k < CHAIN_FRAMES - SETUP_FRAMES:
            frames.append(check.Frame(
                k, pose, edit, None if k == -SETUP_FRAMES else check.CHAIN,
                image.reshape(-1, 3).index_select(0, chain_idx), prog.state,
                pixels=chain_px))

    for k in range(-SETUP_FRAMES, 0):
        pose, edit = gen.pose(k), gen.edit(k)
        if edit is not None:
            prog.edit(edit)
        prog.set_pose(*pose)
        image = prog.render()
        chained(k, pose, edit, image)
        _sync(device)
    record = prog.record()
    rng = np.random.default_rng(seed % 2 ** 63)
    sampled, kept = [], {}

    def frame(k, spans):
        pose, edit = gen.pose(k), gen.edit(k)
        t_a = time.perf_counter()
        if edit is not None:
            with spans("edit"):
                prog.edit(edit)
        prog.set_pose(*pose)
        state_in = prog.state
        t_b = time.perf_counter()
        with spans("render"):
            image = prog.render()
        t_c = time.perf_counter()
        chained(k, pose, edit, image)
        last = check.Frame(k, pose, edit, state_in, image, prog.state)
        kept["last"] = last
        # reservoir sampling: each window frame kept with equal chance
        if len(sampled) < SAMPLED_FRAMES:
            sampled.append(last)
        else:
            j = int(rng.integers(k + 1))
            if j < SAMPLED_FRAMES:
                sampled[j] = last
        return t_b, t_c, (t_b - t_a) if edit is not None else 0.0

    t_setup = time.perf_counter() - t_start
    window = _window("view", "frame", seconds, trace, device, frame)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    # the chain, then (each from the program's state before it) the
    # sampled frames past it and the last frame (in a traced run, traced:
    # its geometry launches give the roofline share)
    skip = {f.k for f in frames}
    for f in sampled + [kept["last"]]:
        if f.k not in skip:
            frames.append(f)
            skip.add(f.k)
    prog.close()
    del prog, image, kept, sampled
    torch.backends.cuda.matmul.allow_tf32 = False
    t_check = time.perf_counter()
    ref = check.ViewReference(cell.config, cell.root, device)
    check.require_limits(ref.leaves, cell.limits)
    readings = check.view_readings(ref, frames, seed, count=trace)
    _sync(device)
    window.check_s = time.perf_counter() - t_check
    if trace:
        from benchmark.roofline import launch_bound_ms
        for t in ref.tally:
            b = launch_bound_ms(t["radiance"], t["radiance"]["rays"]) \
                + launch_bound_ms(t["screen"], t["screen_rays"])
            window.roofline.append((t["k"], b))
    controls = None
    if control:
        controls = {"bf16": check.view_readings(ref, frames, seed,
                                                control=True)}
    return window, readings, controls, t_setup, peak, record


def fit_run(cell, seed, seconds, trace, device, t_start, control=False):
    """As view_run, for a fit cell.  The targets are the reference's
    work: their seconds are left out of set-up, and the memory peak is
    counted from after them."""
    from benchmark.program import FitProgram
    gen = traffic_mod.make(cell.mix, seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    t_ref = time.perf_counter()
    targets = check.make_targets(cell.config, cell.root, device, gen)
    _sync(device)
    t_ref = time.perf_counter() - t_ref
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    prog = FitProgram(cell.config, cell.root, device, gen, targets)
    got = {"losses": [], "floats0": prog.floats()}
    for k in range(SETUP_STEPS):
        got["losses"].append(float(prog.step(k)))
        if k == 0:
            got["floats1"] = prog.floats()
    got["floats"] = prog.floats()
    got["state"] = prog.state
    record = prog.record()
    k_check = SETUP_STEPS + int(np.random.default_rng(
        seed % 2 ** 63).integers(WINDOW_STEPS))
    snap = {}

    def step(k, spans):
        t_b = time.perf_counter()
        if k == k_check:
            # each step returns fresh tensors: references suffice
            snap["floats0"], snap["state0"] = prog.float_leaves(), prog.state
        with spans("call"):
            loss = prog.step(k)
        if k == k_check:
            snap["loss"], snap["floats"], snap["state"] = \
                loss, prog.float_leaves(), prog.state
        return t_b, time.perf_counter(), 0.0

    t_setup = time.perf_counter() - t_start - t_ref
    window = _window("fit", "step", seconds, trace, device, step,
                     k0=SETUP_STEPS)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    # a window too short to reach the checked step goes on to it, untimed
    k = SETUP_STEPS + window.n
    while "loss" not in snap:
        step(k, tracing.Spans(device))
        k += 1
    got_w = {"loss": float(snap["loss"]), "floats0": snap["floats0"],
             "floats": snap["floats"], "state": snap["state"]}
    prog.close()
    del prog
    t_check = time.perf_counter()
    ref = check.FitReference(cell.config, cell.root, device, gen, targets)
    ref_first = ref.first_steps()
    ref_w = ref.window_step(k_check, got_w["floats0"], snap["state0"])
    readings = check.fit_readings(ref_first, got, gen.lr, ref_w, got_w,
                                  leaves=ref.leaves)
    _sync(device)
    window.check_s = time.perf_counter() - t_check + t_ref
    controls = None
    if control:
        controls = {}
        for kind in ("control", "half_batch"):
            side = check.FitReference(cell.config, cell.root, device, gen,
                                      targets, **{kind: True})
            controls[kind] = check.fit_readings(
                ref_first, side.first_steps(), gen.lr, ref_w,
                side.window_step(k_check, got_w["floats0"],
                                 snap["state0"]), leaves=ref.leaves)
    return window, readings, controls, t_setup, peak, record


def _median_ms(values):
    return float(np.median(values)) * 1e3 if values else None


def end_to_end(window, setup_s):
    """{metric name: value} of every end-to-end metric the window gives."""
    out = {"setup_s": setup_s}
    if window.n == 0:
        return out
    if window.kind == "view":
        out["frame_ms"] = window.wall_s * 1e3 / window.n
        out["frame_p95_ms"] = float(np.percentile(window.latency_s, 95)) \
            * 1e3
    else:
        out["step_ms"] = window.wall_s * 1e3 / window.n
    return out


def run_cell(cell, seed, seconds, trace, device, t_start, control=False,
             out=sys.stdout, err=sys.stderr):
    """Runs one cell once; prints the program's counters, then the result
    line (the last of ``out``), and the numbers compared as the last lines
    of ``err``.  Returns the result dict (with "controls" when
    ``control``, which is not printed)."""
    run = view_run if cell.mix["loop"] == "view" else fit_run
    window, readings, controls, setup_s, peak, record = run(
        cell, seed, seconds, trace, device, t_start, control)
    from benchmark.program import counters
    print(json.dumps({"program": {"counters": counters(),
                                  "captured": record},
                      "window": {"n": window.n, "wall_s": window.wall_s,
                                 "check_s": window.check_s,
                                 "host_ms_median": _median_ms(window.host_s),
                                 "latency_ms_median": _median_ms(
                                     window.latency_s)}}),
          file=out)
    bad = forbidden_modules()
    if bad:
        raise Failed(f"modules of JAX or the JAX package loaded: {bad}")
    correct, rows = check.judge(readings, cell.limits)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": window.n,
              "failed": sum(1 for _, v, lim in rows
                            if not v <= lim)}
    if trace:
        t = window.trace
        w0, w1 = t.window
        dev["busy_s"] = tracing.busy_ns(t.device, w0, w1) / 1e9
        dev["window_s"] = (w1 - w0) / 1e9
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](window)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = end_to_end(window, setup_s)
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    result["metrics"] = metrics
    result["device"] = dev
    if trace:
        result["breakdown"] = tracing.breakdown(window.trace)
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in rows}
    print(json.dumps(result), file=out)
    for name, v, lim in rows:
        print(f"check {name}: {v!r} limit {lim!r}", file=err)
    if controls is not None:
        result["controls"] = controls
    return result
