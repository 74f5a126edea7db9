"""Frame timing on the GPU (port of madarch_tpu/utils/profiling.py).

``FrameTimer`` times frames and calls with CUDA events on the device's own
clock and refuses a device that is not a GPU; ``trace`` is a context
manager that writes a torch.profiler trace for TensorBoard; ``device_ops``
and ``device_busy`` trace calls with torch.profiler for the device's busy
time (``trace_calls``, read by ``kernel_ops`` and ``kernel_events``, or
by ``averaged_busy`` through key_averages()); ``rays_per_frame`` is the
JAX package's ray accounting unchanged, so rays/s compare across
packages.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch


def sync(x) -> float:
    """Wait for the device and read x's sum back (the barrier)."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(x.sum())


class FrameTimer:
    """Device frame timer: ``with timer.frame(): img = r.render()``; each
    frame's time is the span between two CUDA events, in seconds."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"FrameTimer measures a GPU, not {self.device}")
        self.times = []

    @contextlib.contextmanager
    def frame(self):
        with torch.cuda.device(self.device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
        end.synchronize()
        self.times.append(start.elapsed_time(end) / 1e3)

    def time_fn(self, fn, *args, warmup=1, iters=3):
        """(seconds per call, the last output) of ``iters`` calls of
        ``fn(*args)`` between two CUDA events, after ``warmup`` calls."""
        out = None
        with torch.cuda.device(self.device):
            for _ in range(warmup):
                out = fn(*args)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                out = fn(*args)
            end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / iters
        self.times.append(dt)
        return dt, out

    @property
    def mean(self):
        return sum(self.times) / max(len(self.times), 1)


@contextlib.contextmanager
def trace(log_dir=None):
    """torch.profiler around the block, its trace written on exit into
    ``log_dir`` (default: madarch_trace in the temporary directory) as
    ``*.pt.trace.json`` for TensorBoard; yields log_dir.  It records the
    host, and the device where a CUDA card is present."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "madarch_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def trace_calls(fn, calls):
    """(the profiler, wall ms per call) of ``calls`` calls of ``fn()``
    traced with torch.profiler, the host and the device."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    return prof, wall * 1e3 / calls


def kernel_ops(prof, calls):
    """{op name: device ms per call} of a trace, read from its device
    events as recorded, without key_averages' parse into Python events,
    which takes minutes for the ~10^6 kernels of a generic-route frame."""
    ops = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ops[e.name()] = ops.get(e.name(), 0.0) \
                + e.duration_ns() / 1e6 / calls
    return ops


def kernel_events(prof, calls):
    """{op name: device events per call} of a trace: how often each
    kernel ran, also inside a replayed CUDA graph, whose kernels the
    trace records as the graph launches them."""
    counts = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            counts[e.name()] = counts.get(e.name(), 0) + 1 / calls
    return counts


def averaged_busy(prof, calls):
    """Device ms per call of the same trace as key_averages() sums it (the
    device ops' self times), to hold kernel_ops' sum against."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / calls


def device_ops(fn, calls):
    """Trace ``calls`` calls of ``fn()`` with torch.profiler: returns
    (device ms per call, summed over the kernels' own times; wall ms per
    call under the profiler; {op name: device ms per call}).  The device
    runs one stream, so its busy time is the sum of its kernels' times."""
    prof, wall = trace_calls(fn, calls)
    ops = kernel_ops(prof, calls)
    return sum(ops.values()), wall, ops


def device_busy(render, frames):
    """device_ops over ``frames`` calls of ``render()``, with the 8 op
    names of the most device time as [(name, ms per frame)] in place of
    the whole table."""
    busy, wall, ops = device_ops(render, frames)
    return busy, wall, sorted(ops.items(), key=lambda kv: -kv[1])[:8]


def rays_per_frame(width, height, probes, n_lights, screen_cfg,
                   volumetrics=None):
    """Count marched rays per frame (primary + shadow + AO + probe
    visibility + reflection)."""
    wh = width * height
    per_pixel = 1 + n_lights + 8 + screen_cfg.ambient_occlusion_steps
    if screen_cfg.indirect_specular_mode in (1, 2, 3):
        per_pixel += 1 + (8 if screen_cfg.indirect_specular_mode in (1, 2)
                          else 0)
        if screen_cfg.indirect_specular_mode == 2 \
                and screen_cfg.add_indirect_specular:
            per_pixel += n_lights
        if screen_cfg.indirect_specular_mode == 3:
            per_pixel += n_lights + 8  # secondary direct + irradiance vis
    total = wh * per_pixel

    texels = probes.num_probes * probes.radiance_resolution ** 2
    total += texels * (1 + n_lights + 8)

    if volumetrics is not None and volumetrics.enabled:
        vx, vy, vz = volumetrics.visibility_resolution
        total += vx * vy * vz * n_lights           # froxel shadow rays
        sx, sy = volumetrics.scattering_resolution
        total += sx * sy                           # scattering primaries
    return total
