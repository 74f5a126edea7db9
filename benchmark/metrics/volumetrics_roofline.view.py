"""volumetrics_roofline.view (%): the bound of the traced frames'
``visibility_kernel`` and ``raycast_kernel`` launches (roofline.py) as a
share of their device time.  Moves frame_ms.

Each launch's bound is ``roofline.bound`` of its bytes: each input of the
plain version read once and each output written once, at the light_shafts
configuration's fixed ray counts (upstream's 100x100x100 froxels and
250x250 scattering texels), summed over the launches that the trace shows
in the traced frames:

- visibility, 1,000,000 froxel-to-light rays a live light slot: origins
  and directions f32[N, 3] (24 bytes a ray), max distances f32[N] (4) and
  the enable mask bool[N] (1) read, the visibility f32[N] (4) written:
  33 bytes a ray, 33,000,000 bytes, 0.009851 ms at 3.35 TB/s;
- raycast, 62,500 rays: origins and directions (24) and the enable mask
  (1) read, t f32[N] (4) and hit bool[N] (1) written: 30 bytes a ray,
  1,875,000 bytes, 0.000560 ms (the wrapper's pos = o + t·d is an op of
  its own, outside the kernel).

The packed scene's tables (under a kilobyte) are left out.  No operations
are counted: the harness's Window carries only the geometry launches'
tally, and a reader cannot count the march steps.  So the bound is the
bytes' alone, and the share is a floor of the kernels' true roofline share
(the march's float operations bound raycast at 0.00099 ms, PERF.md §6).
"""
from benchmark import roofline

FROXEL_RAYS = 100 * 100 * 100
SCATTERING_RAYS = 250 * 250
# kernel name: bytes of one launch
LAUNCH_BYTES = {"visibility_kernel": FROXEL_RAYS * (24 + 4 + 1 + 4),
                "raycast_kernel": SCATTERING_RAYS * (24 + 1 + 4 + 1)}


def read(w):
    t = w.trace
    if w.kind != "view" or t is None or not t.spans_named("frame"):
        return None
    bound_ms = busy_ns = 0.0
    for name, s, e in t.device_in(*t.window):
        for kernel, n_bytes in LAUNCH_BYTES.items():
            if kernel in name:
                bound_ms += roofline.bound(0.0, n_bytes)[0]
                busy_ns += e - s
    return 100.0 * bound_ms * 1e6 / busy_ns if busy_ns else None
