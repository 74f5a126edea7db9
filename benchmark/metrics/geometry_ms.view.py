"""geometry_ms.view (ms): device time per frame in the geometry kernel's
launches (ops/csrc/geometry.cu), over the traced frames.  Moves
frame_ms."""


def read(w):
    t = w.trace
    n = len(t.spans_named("frame")) if t is not None else 0
    if w.kind != "view" or not n:
        return None
    ns = sum(e - s for name, s, e in t.device_in(*t.window)
             if "geometry_kernel" in name)
    return ns / 1e6 / n if ns else None
