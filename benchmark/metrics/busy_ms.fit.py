"""busy_ms.fit (ms): device busy time per train step (forward, autograd
backward and update), over the traced steps.  Moves step_ms."""
from benchmark import tracing


def read(w):
    t = w.trace
    n = len(t.spans_named("step")) if t is not None else 0
    if w.kind != "fit" or not n:
        return None
    return tracing.busy_ns(t.device, *t.window) / 1e6 / n
