"""idle_share.view (%): 1 − device busy per frame / wall time per frame.
The busy time (the union of the device operations' intervals) is read
over the traced frames of a traced run's second half, the wall time over
the untraced frames of its first half, since tracing the device slows
the host side of each frame by some milliseconds.  Moves frame_ms."""
from benchmark import tracing


def read(w):
    t = w.trace
    n = len(t.spans_named("frame")) if t is not None else 0
    if w.kind != "view" or not n or not w.latency_s:
        return None
    busy_s = tracing.busy_ns(t.device, *t.window) / 1e9 / n
    return 100.0 * (1.0 - busy_s / (w.wall_s / len(w.latency_s)))
