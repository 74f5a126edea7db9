"""One configuration's frame time and rays/s without the whole bench (port
of tools/perf_probe.py):

    python -m madarch_tpu_torch.tools.perf_probe [CONFIG] [--size 800] \\
        [--frames 3] [--passes] [--device cuda]

CONFIG is one of the bench's configurations (madarch_tpu_torch/bench.py:
CONFIGS; default obj_mesh).  One converge frame (on the card the capture
of the compiled frame), then ``--frames`` timed frames through
bench.bench_renderer: the compiled frame users get, and as many eager
frames beside it; launches a frame from the capture, each kernel's
ms per launch from the profiler.  ``--passes`` adds
bench.per_pass_breakdown.  Progress on stderr, one JSON line on stdout.
"""
from __future__ import annotations

import argparse
import json

import torch

from madarch_tpu_torch import bench


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", nargs="?", default="obj_mesh",
                    choices=list(bench.CONFIGS))
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--passes", action="store_true",
                    help="also the per-pass split")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    r = bench.make_config(args.config, args.size, dev)
    out = {"config": args.config, "size": args.size,
           **bench.bench_renderer(args.config, r, 1, frames=args.frames,
                                  converge_frames=1)}
    if args.passes:
        out["per_pass_ms"] = bench.per_pass_breakdown(r)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
