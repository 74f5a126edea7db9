"""Headless example runner (port of madarch_tpu/examples/run.py): renders
frames of an example scene, prints each frame's time and writes the last
frame as a PNG.

Usage:
    python -m madarch_tpu_torch.examples.run SCENE [--device cuda] \\
        [--frames N] [--size WxH] [--out out.png] [--fast] [--obj PATH]

SCENE: simple_scene | global_illumination | light_shafts | obj_mesh |
ball_game | bvh_test (obj_mesh reads the mesh at --obj; the repository
carries madarch_tpu_torch/examples/media/torus968.obj; ball_game throws
one ball and steps its physics before each frame).  The device
defaults to the CUDA card; ``--device cpu`` renders on the CPU (the plain
versions of the kernels).

On a GPU the frame times come from CUDA events; on the CPU from the host
clock.
"""
from __future__ import annotations

import argparse
import time

from madarch_tpu_torch.core.config import ProbeSettings, screen_shade_config
from madarch_tpu_torch.examples import scenes as S
from madarch_tpu_torch.io.image import write_png
from madarch_tpu_torch.utils.profiling import FrameTimer, device_busy, sync


def parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("scene", choices=["simple_scene", "global_illumination",
                                      "light_shafts", "obj_mesh",
                                      "ball_game", "bvh_test"])
    ap.add_argument("--device", default="cuda",
                    help="torch device, e.g. cuda (the default), cuda:0 or "
                         "cpu")
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--size", default="800x800")
    ap.add_argument("--out", default=None)
    ap.add_argument("--fast", action="store_true",
                    help="small probes + capped march steps")
    ap.add_argument("--obj", default=None, metavar="PATH",
                    help="obj_mesh's mesh (an OBJ file)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="then trace N more frames with torch.profiler and "
                         "print the device's busy time (CUDA only)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)

    w, h = (int(x) for x in args.size.split("x"))
    kwargs = {"width": w, "height": h, "device": args.device}
    if args.fast:
        kwargs["probes"] = ProbeSettings(
            radiance_resolution=8, irradiance_resolution=4,
            probe_count=(4, 2), grid_dimensions=(2, 2, 2),
            grid_spacing=(4.0, 4.0, 4.0))
    if args.obj is not None:
        if args.scene != "obj_mesh":
            raise SystemExit("--obj is obj_mesh's option")
        kwargs["obj_path"] = args.obj
    step_physics = None
    if args.scene == "ball_game":
        r, step_physics, throw_ball = S.ball_game(**kwargs)
        throw_ball(origin=(2.0, 3.0, 2.0), velocity=(0.5, 1.0, 2.0))
    else:
        r = getattr(S, args.scene)(**kwargs)
    if args.profile and r.device.type != "cuda":
        raise SystemExit("--profile traces the CUDA card; the renderer is "
                         f"on {r.device}")
    if args.fast:
        r.screen_cfg = screen_shade_config(
            r.volumetrics.enabled, max_march_steps=128)

    timer = FrameTimer(r.device) if r.device.type == "cuda" else None
    img = None
    for i in range(args.frames):
        if step_physics is not None:
            step_physics()
        if timer is not None:
            with timer.frame():
                img = r.render()
            print(f"frame {i}: {timer.times[-1]:.4f}s (CUDA events)")
        else:
            t0 = time.perf_counter()
            img = r.render()
            sync(img)
            print(f"frame {i}: {time.perf_counter() - t0:.3f}s (host clock)")

    if args.profile:
        busy, wall, top = device_busy(r.render, args.profile)
        print(f"profile: {args.profile} frames, device busy {busy:.3f} "
              f"ms/frame of {wall:.3f} ms/frame under the profiler "
              f"(idle share {1.0 - busy / wall:.3f})")
        for name, ms in top:
            print(f"  {ms:8.3f} ms/frame  {name[:100]}")

    if args.out:
        write_png(args.out, img.cpu().numpy())
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
