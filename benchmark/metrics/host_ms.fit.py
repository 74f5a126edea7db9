"""host_ms.fit (ms): host time per train step inside the step call, from
the benchmark's own spans around it, over the untraced steps (a traced
run's first half, before the profiler starts).  Moves step_ms."""


def read(w):
    if w.kind != "fit" or not w.host_s:
        return None
    return sum(w.host_s) * 1e3 / len(w.host_s)
