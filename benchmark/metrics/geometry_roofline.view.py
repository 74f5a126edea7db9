"""geometry_roofline.view (%): the checked traced frames' geometry
launches' bound (roofline.py: the larger of their float operations over
the fp32 peak and their bytes over the HBM peak, counted by the
reference's plain version on each frame's own rays) as a share of the
device time of those frames' geometry launches.  Moves frame_ms."""


def read(w):
    t = w.trace
    if w.kind != "view" or t is None:
        return None
    frames = t.spans_named("frame")
    bound_ms = busy_ns = 0.0
    for k, b in w.roofline:
        i = k - w.trace_k0
        if not 0 <= i < len(frames):
            continue
        _, s, e = frames[i]
        ns = sum(oe - os_ for name, os_, oe in t.device_in(s, e)
                 if "geometry_kernel" in name)
        if ns:
            bound_ms += b
            busy_ns += ns
    return 100.0 * bound_ms * 1e6 / busy_ns if busy_ns else None
