"""The kernel route's outputs and launch times with the madarch_tpu_torch
package of a given checkout, saved so that two checkouts can be held to
each other bit for bit:

    python madarch_tpu_torch/tools/tree_outputs.py save OUT.pt [--tree DIR]
    python madarch_tpu_torch/tools/tree_outputs.py compare A.pt B.pt

``save`` imports madarch_tpu_torch from DIR (default: the checkout this
file lies in), builds the bench's global_illumination, light_shafts,
simple_scene and obj_mesh configurations at SIZE² (the benchmark cells'
1000²) on the CUDA card, and saves each one's image after CONVERGE_FRAMES
frames, every output of the geometry kernel's folded screen launch
(SceneCtx.geometry with the reflection, on all camera rays) and of
raycast, visibility and softshadows on those rays, and the ms of the
folded launch and of the primary launch on its misses alone (CUDA events,
REPS launches after a warm-up).  Run it for two checkouts in turns (A, B,
B, A) in one call on one card, then ``compare`` reports, per
configuration, whether the images and outputs are bit-equal and both
sides' ms.  A material id (the primary's and the reflection's ``mid``) is
compared on its bounce's hits alone, where ops/march.py:geometry defines
it.  Only names that every port since the bench entry point has are used.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

CONFIGS = ("global_illumination", "light_shafts", "simple_scene",
           "obj_mesh")
SIZE = 1000
CONVERGE_FRAMES = 2
REPS = 5


def save(out, tree):
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from madarch_tpu_torch import bench
    from madarch_tpu_torch.ops import march as march_ops
    from madarch_tpu_torch.render.context import SceneCtx

    dev = torch.device("cuda:0")
    if not march_ops.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {march_ops.__file__}, not from {tree}")
    saved = {}
    for name in CONFIGS:
        r = bench.make_config(name, SIZE, dev)
        image = r.converge(frames=CONVERGE_FRAMES)
        ctx = SceneCtx(r.spec, r.scene_data)
        o, d = bench.screen_rays(r)

        def folded():
            return ctx.geometry(o, d, r.probes, r.screen_cfg,
                                want_reflection=True)

        geo = folded()
        torch.cuda.synchronize()
        ms = bench.time_ms(folded, REPS, dev)[0]
        miss = ~geo["hit"]
        om, dm = o[miss].contiguous(), d[miss].contiguous()
        misses_ms = bench.time_ms(
            lambda: ctx.geometry(om, dm, r.probes, r.screen_cfg), REPS,
            dev)[0]
        mx = torch.full((o.shape[0],), 0.5 * ctx.max_dist, device=dev)
        mn = torch.zeros_like(mx)
        marches = {
            "raycast": ctx.raycast(o, d, ctx.max_dist,
                                   max_steps=r.screen_cfg.max_march_steps),
            "visibility": ctx.visibility(
                o, d, mx, max_steps=r.screen_cfg.max_march_steps),
            "softshadows": ctx.softshadows(
                o, d, mn, mx, 64.0, max_steps=r.screen_cfg.max_march_steps)}
        saved[name] = {"image": image.cpu(), "geometry": _cpu(geo),
                       "marches": _cpu(marches), "ms": ms,
                       "misses_ms": misses_ms}
        print(f"{name}: folded screen launch {ms:.4f} ms "
              f"({o.shape[0]} rays), its {om.shape[0]} misses alone "
              f"{misses_ms:.4f} ms", file=sys.stderr)
    torch.save({"tree": os.path.abspath(tree),
                "card": torch.cuda.get_device_name(0), "configs": saved},
               out)


def _cpu(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [_cpu(v) for v in x]
    return x


def _equal(a, b):
    import torch
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _equal(x, y) for x, y in zip(a, b))
    return a == b


def _geometry_equal(a, b):
    """Two geometry launches' outputs bit-equal, each bounce's ``mid`` on
    its hits."""
    if not (_equal(a["hit"], b["hit"]) and _equal(a["mid"][a["hit"]],
                                                  b["mid"][b["hit"]])):
        return False
    if not _equal({k: v for k, v in a.items() if k not in ("mid", "refl")},
                  {k: v for k, v in b.items() if k not in ("mid", "refl")}):
        return False
    if a["refl"] is None or b["refl"] is None:
        return a["refl"] is b["refl"]
    return _geometry_equal(dict(a["refl"], refl=None),
                           dict(b["refl"], refl=None))


def compare(path_a, path_b):
    import torch
    a, b = (torch.load(p, weights_only=False) for p in (path_a, path_b))
    report = {}
    for name in CONFIGS:
        x, y = a["configs"][name], b["configs"][name]
        report[name] = {k: _equal(x[k], y[k]) for k in ("image", "marches")}
        report[name]["geometry"] = _geometry_equal(x["geometry"],
                                                   y["geometry"])
        report[name]["ms"] = [x["ms"], y["ms"]]
        report[name]["misses_ms"] = [x.get("misses_ms"), y.get("misses_ms")]
    print(json.dumps({"a": a["tree"], "b": b["tree"], "card": a["card"],
                      "configs": report}))
    return all(v for r in report.values() for k, v in r.items()
               if not k.endswith("ms"))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("save")
    s.add_argument("out")
    s.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = p.parse_args(argv)
    if args.cmd == "save":
        save(args.out, args.tree)
        return 0
    return 0 if compare(args.a, args.b) else 1


if __name__ == "__main__":
    sys.exit(main())
