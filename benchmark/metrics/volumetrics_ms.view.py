"""volumetrics_ms.view (ms): device time per frame in the volumetric
passes' march kernels, ``visibility_kernel`` (the froxel-to-light rays)
and ``raycast_kernel`` (the scattering map's rays; ops/csrc/march.cu),
over the traced frames.  Moves frame_ms."""

KERNELS = ("visibility_kernel", "raycast_kernel")


def read(w):
    t = w.trace
    n = len(t.spans_named("frame")) if t is not None else 0
    if w.kind != "view" or not n:
        return None
    ns = sum(e - s for name, s, e in t.device_in(*t.window)
             if any(k in name for k in KERNELS))
    return ns / 1e6 / n if ns else None
