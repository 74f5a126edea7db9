"""Diagnose the card-against-golden difference (port of
tools/diag_golden.py):

    python -m madarch_tpu_torch.tools.diag_golden [CONFIG] [--size 128] \\
        [--device cuda] [--golden tests/goldens/images.npz]

CONFIG is one of the bench's configurations that has a golden (default
simple_scene).  Renders it at size² on ``--device`` through the kernels
and on the CPU through their plain versions (the JAX tool's "Pallas path
against XLA path": on a CUDA tensor a kernel wrapper never takes its plain
version), holds each to the golden, locates the worst pixel of the device
image and traces that pixel's primary ray through both (t, hit, idx,
normal of the geometry launch).  It classifies the pixel: a silhouette
flip (hit on one side only), a normal divergence (both hit, normals apart
by more than NORMAL_TOL, or t by more than T_TOL), or drift (the geometry
agrees; the difference is in the shading).  Report on stdout, the last
line one JSON object.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from madarch_tpu_torch import bench
from madarch_tpu_torch.render.camera import camera_rays, pixel_grid
from madarch_tpu_torch.render.context import SceneCtx

# The frames before the comparison, as the goldens were made.
FRAMES = {"global_illumination": 4}
NORMAL_TOL = 1e-3
T_TOL = 1e-3


def diff_stats(img, golden):
    d = np.abs(img - golden)
    return {"mean": float(d.mean()), "p99": float(np.quantile(d, 0.99)),
            "max": float(d.max()), "frac_above_0.05": float((d > 0.05).mean())}


def primary(r, y, x):
    """The geometry launch's t, hit, idx and normal for pixel (y, x)'s
    primary ray of renderer r (image row 0 at the bottom, as rendered)."""
    cam = r.camera
    o, d = camera_rays(pixel_grid(r.width, r.height, r.device),
                       cam.position, cam.orientation)
    o = o[y, x][None].contiguous()
    d = d[y, x][None].contiguous()
    g = SceneCtx(r.spec, r.scene_data).geometry(o, d, r.probes,
                                                r.screen_cfg)
    return {"t": float(g["t"][0]), "hit": bool(g["hit"][0]),
            "idx": int(g["idx"][0]), "normal": g["normal"][0].tolist()}


def classify(dev_ray, cpu_ray):
    if dev_ray["hit"] != cpu_ray["hit"]:
        return "silhouette flip"
    dn = max(abs(a - b) for a, b in zip(dev_ray["normal"],
                                        cpu_ray["normal"]))
    if dev_ray["hit"] and (dn > NORMAL_TOL
                           or abs(dev_ray["t"] - cpu_ray["t"]) > T_TOL):
        return "normal divergence"
    return "drift"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", nargs="?", default="simple_scene",
                    choices=list(bench.CONFIGS))
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--golden", default=bench.GOLDENS,
                    help="an .npz holding an image per configuration")
    args = ap.parse_args(argv)
    golden = np.load(args.golden)[args.config]
    frames = FRAMES.get(args.config, 2)
    renders = {}
    for label, dev in (("device", torch.device(args.device)),
                       ("cpu", torch.device("cpu"))):
        r = bench.make_config(args.config, args.size, dev)
        renders[label] = (r, r.converge(frames=frames).cpu().numpy())
    (r_dev, img_dev), (r_cpu, img_cpu) = renders["device"], renders["cpu"]
    stats = {label: diff_stats(img, golden)
             for label, (_, img) in renders.items()}
    for label, s in stats.items():
        print(f"{label:7s} vs golden: " + ", ".join(
            f"{k} {v:.6f}" for k, v in s.items()))
    worst = np.abs(img_dev - golden).max(axis=-1)
    y, x = (int(v) for v in np.unravel_index(np.argmax(worst), worst.shape))
    print(f"worst device pixel (y={y}, x={x}): diff {worst[y, x]:.4f}; "
          f"golden rgb {golden[y, x]}, device rgb {img_dev[y, x]}, cpu rgb "
          f"{img_cpu[y, x]}")
    y0, x0 = max(y - 1, 0), max(x - 1, 0)
    print(f"  3x3 golden luma:\n{golden[y0:y + 2, x0:x + 2].mean(axis=-1)}")
    rays = {"device": primary(r_dev, y, x), "cpu": primary(r_cpu, y, x)}
    for label, ray in rays.items():
        print(f"  primary ray, {label}: {ray}")
    verdict = classify(rays["device"], rays["cpu"])
    print(f"  => {verdict}")
    out = {"config": args.config, "size": args.size, "stats": stats,
           "worst": {"y": y, "x": x, "diff": float(worst[y, x]),
                     "rays": rays}, "verdict": verdict}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
