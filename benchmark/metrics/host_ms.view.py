"""host_ms.view (ms): host time per frame inside ``render()``, and in a
mix that edits the scene the edit's too, from the benchmark's own spans
around the calls, over the untraced frames (a traced run's first half,
before the profiler starts: tracing slows the host).  Moves frame_ms."""


def read(w):
    if w.kind != "view" or not w.host_s:
        return None
    return (sum(w.host_s) + sum(w.edit_s)) * 1e3 / len(w.host_s)
