"""Bisect the train step's time (port of tools/train_probe.py):

    python -m madarch_tpu_torch.tools.train_probe [CONFIG] [--size 256] \\
        [--device cuda]

CONFIG is one of the bench's configurations (default global_illumination).
Times, each over ITERS calls after a warm-up:
(a) the forward frame with the differentiable configs, no graph;
(a2) the forward frame with the scene's own configs (the fused path);
(b) loss and gradient with respect to the materials only;
(b2) loss and gradient with respect to every float leaf
    (parallel/spmd.py:make_value_and_grad, no mesh);
(c) the full train step as make_train_step gives it: compiled on the
    kernel route (on a card one CUDA graph replayed; its first call, the
    capture, is the warm-up);
(c2) the same step op by op, inside pipeline.eager().
Each gradient is consumed inside the timed calls (summed and read back),
so that no part of the backward can be skipped and the timing cannot lie.
Progress on stderr, one JSON line on stdout.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from madarch_tpu_torch import bench
from madarch_tpu_torch.parallel import spmd
from madarch_tpu_torch.render.pipeline import eager, render_frame

ITERS = 3


def consume(tensors):
    """The tensors' total, read back to the host."""
    return float(sum(t.sum() for t in tensors))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("config", nargs="?", default="global_illumination",
                    choices=list(bench.CONFIGS))
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    size = args.size
    r = bench.make_config(args.config, size, dev)
    spec, probes, vol, cam = r.spec, r.probes, r.volumetrics, r.camera
    data, state = r.scene_data, r.state
    scfg = dataclasses.replace(r.screen_cfg, differentiable=True)
    pcfg = dataclasses.replace(r.probe_cfg, differentiable=True)
    target = torch.zeros((size, size, 3), device=dev)

    def forward(screen_cfg, probe_cfg):
        with torch.no_grad():
            return render_frame(spec, probes, vol, size, size, data, cam,
                                state, screen_cfg=screen_cfg,
                                probe_cfg=probe_cfg)[0]

    def grad_materials():
        mats = {k: v.detach().requires_grad_(v.is_floating_point())
                for k, v in data.materials.items()}
        leaves = [v for v in mats.values() if v.requires_grad]
        with torch.enable_grad():
            img = render_frame(spec, probes, vol, size, size,
                               dataclasses.replace(data, materials=mats),
                               cam, state, screen_cfg=scfg,
                               probe_cfg=pcfg)[0]
            loss = torch.mean((img - target) ** 2)
            grads = torch.autograd.grad(loss, leaves)
        return consume([loss.detach(), *grads])

    value_and_grad = spmd.make_value_and_grad(
        spec, probes, vol, size, size, screen_cfg=r.screen_cfg,
        probe_cfg=r.probe_cfg)

    def grad_all():
        loss, grads, _ = value_and_grad(data, cam, state, target)
        return consume([loss, *grads])

    step = spmd.make_train_step(spec, probes, vol, size, size,
                                screen_cfg=r.screen_cfg,
                                probe_cfg=r.probe_cfg)
    run = {"data": data, "state": state}

    def train_step():
        loss, run["data"], run["state"] = step(run["data"], cam,
                                               run["state"], target)
        return float(loss)

    def train_step_eager():
        with eager():
            return train_step()

    timed = {
        "fwd_diff_cfg_no_grad": lambda: forward(scfg, pcfg),
        "fwd_fused_cfg": lambda: forward(r.screen_cfg, r.probe_cfg),
        "grad_materials": grad_materials,
        "grad_all_floats": grad_all,
        "train_step": train_step,
        "train_step_eager": train_step_eager,
    }
    ms = {}
    for label, fn in timed.items():
        fn()
        bench.sync(dev)
        ms[label] = bench.time_ms(fn, ITERS, dev)[0]
        bench.log(f"{label:24s} {ms[label]:9.3f} ms")
    out = {"config": args.config, "size": size, "ms": ms}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
