"""The geometry kernel on a configuration's screen rays with its marches
turned off one group at a time, to attribute its time (port of
tools/geom_probe.py):

    python -m madarch_tpu_torch.tools.geom_probe [CONFIG] [--size 800] \\
        [--device cuda]

CONFIG is one of the bench's configurations (default obj_mesh).  The
primary launch of the screen pass (SceneCtx.geometry, no reflection fold,
as the JAX probe times it) on all size² camera rays, in four variants:
full; want_vis=False; want_vis=False, want_shadows=False; and also
want_ao=False (ao_steps 0).  Each is timed over REPS launches after a
warm-up, in turns (every variant, then every variant again in reverse,
the lower of the two kept).  Prints the lanes per ray geometry_lanes chose
and the ms of each variant on stderr, and one JSON line on stdout with
``split``: the primary march + normal, AO, shadows and probe visibility,
each the difference of two variants.
"""
from __future__ import annotations

import argparse
import json

import torch

from madarch_tpu_torch import bench
from madarch_tpu_torch.ops import march as march_ops
from madarch_tpu_torch.render.context import SceneCtx

VARIANTS = {
    "full": {},
    "no_vis": {"want_vis": False},
    "no_vis_shadows": {"want_vis": False, "want_shadows": False},
    "no_vis_shadows_ao": {"want_vis": False, "want_shadows": False,
                          "want_ao": False},
}
REPS = 3


def time_variants(r, reps=REPS, box_cap=True):
    """({variant: ms per launch}, lanes per ray, rays) of renderer r's
    screen-ray geometry launch in each of VARIANTS; ``box_cap`` False drops
    the scene's box-exit cap."""
    ctx = SceneCtx(r.spec, r.scene_data)
    if not box_cap:
        ctx.packed = march_ops.without_box_cap(ctx.packed)
    o, d = bench.screen_rays(r)

    def launch(flags):
        return ctx.geometry(o, d, r.probes, r.screen_cfg, **flags)["t"]

    best = {}
    for names in (list(VARIANTS), list(reversed(VARIANTS))):
        for name in names:
            launch(VARIANTS[name])
            bench.sync(r.device)
            ms = bench.time_ms(lambda: launch(VARIANTS[name]), reps,
                               r.device)[0]
            best[name] = min(ms, best.get(name, ms))
    lanes = march_ops.geometry_lanes(ctx.packed, o.shape[0])
    return {name: best[name] for name in VARIANTS}, lanes, o.shape[0]


def split(ms):
    """The launch's ms by march group, as differences of the variants."""
    return {"primary_normal": ms["no_vis_shadows_ao"],
            "ao": ms["no_vis_shadows"] - ms["no_vis_shadows_ao"],
            "shadows": ms["no_vis"] - ms["no_vis_shadows"],
            "probe_vis": ms["full"] - ms["no_vis"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", nargs="?", default="obj_mesh",
                    choices=list(bench.CONFIGS))
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = bench.make_config(args.config, args.size, torch.device(args.device))
    ms, lanes, n = time_variants(r)
    bench.log(f"{args.config} {args.size}x{args.size}: {n} rays, {lanes} "
              f"lanes a ray")
    for name, flags in VARIANTS.items():
        bench.log(f"{name:20s} {flags} {ms[name]:9.4f} ms")
    out = {"config": args.config, "size": args.size, "rays": n,
           "lanes": lanes, "ms": ms, "split": split(ms)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
