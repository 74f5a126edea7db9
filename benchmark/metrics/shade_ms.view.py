"""shade_ms.view (ms): device time per frame in every operation other
than the four hand-written kernels (the shade's, the probes' and the
packing's PyTorch ops, and the compiled frame's input copies), over the
traced frames.  Moves frame_ms."""
from benchmark import tracing


def read(w):
    t = w.trace
    n = len(t.spans_named("frame")) if t is not None else 0
    if w.kind != "view" or not n:
        return None
    ns = sum(e - s for name, s, e in t.device_in(*t.window)
             if not tracing.is_hand_written(name))
    return ns / 1e6 / n
