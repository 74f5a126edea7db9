"""The port's multi-device layer (madarch_tpu_torch/parallel/spmd.py and
the ``shard`` arguments of render/pipeline.py and render/volumetrics.py)
in a real 2-process torch.distributed group: gloo on the CPU, one process
per rank, as tests/test_multihost.py runs the JAX package's 2-process
cluster.

One spawn of the group runs every check in both processes (``worker``),
so the suite pays for process start-up once; the spawn has its own
TIMEOUT, so a hang fails this test instead of eating the suite's limit.
Each rank holds its sharded results against the same computation
unsharded in its own process:
- the global_illumination frame at 24² and at 23×17 (391 rays, which 2
  does not divide: one zero-padded ray) to 1e-6 (measured 0 and 7.5e-9:
  every ray's arithmetic is the same in a share as in the whole batch);
- light_shafts with small volumetrics (its froxel, scattering and screen
  rays sharded) to 1e-6 (measured 0);
- one train step: the loss to 1e-6 relative and every updated float leaf
  to 1e-5 relative norm of its update (measured 0 and 3.4e-8: the ranks'
  gradients sum in another order); a gradient world size times too large
  would be off by 1.0;
- RaySharder's shares: real, disjoint, in rank order, covering the padded
  batch;
- the collective record (the counterpart of the JAX package's
  collective_report): no collective inside a map_rays function, where the
  marches run, the frame's bytes under a cap and the count at most a fixed
  number, as tests/test_spmd.py's test_collective_structure holds them.

To run the group by hand:

    python -m pytest tests/test_torch_spmd_multiprocess.py -q
"""
import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
WORLD = 2


def worker(rank, port):
    import dataclasses

    import torch

    from madarch_tpu_torch.core.config import (NO_VOLUMETRICS,
                                               ProbeSettings, ShadeConfig,
                                               VolumetricsSettings)
    from madarch_tpu_torch.examples import scenes
    from madarch_tpu_torch.parallel import spmd
    from madarch_tpu_torch.render.pipeline import render_frame
    from madarch_tpu_torch.scene.scene import tree_leaves

    torch.set_num_threads(1)
    assert spmd.init_distributed(f"tcp://127.0.0.1:{port}", WORLD, rank,
                                 backend="gloo")
    assert spmd.init_distributed()                  # a guarded no-op now
    mesh = spmd.make_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank) == (WORLD, rank)
    out = {}

    # RaySharder: real, disjoint shares in rank order
    sharder = spmd.RaySharder(mesh)
    ids = torch.arange(11)
    share = sharder.share(ids)
    assert share.shape == (6,)
    assert torch.equal(share, torch.arange(6 * rank, 6 * rank + 6) % 12
                       * (torch.arange(6 * rank, 6 * rank + 6) < 11))
    every = sharder.gather(share)
    assert torch.equal(every, sharder.pad(ids))
    assert torch.equal(sharder.unpad(every, 11), ids)

    # replicate: rank 0's values everywhere
    x = torch.full((3,), float(rank))
    assert torch.equal(spmd.replicate(mesh, {"x": x})["x"], torch.zeros(3))

    probes = ProbeSettings(radiance_resolution=8, irradiance_resolution=4,
                           probe_count=(4, 2), grid_dimensions=(2, 2, 2),
                           grid_spacing=(5.0, 5.0, 5.0))
    cfg = ShadeConfig(direct_specular=True, indirect_specular_mode=0,
                      add_indirect_specular=False,
                      ambient_occlusion_steps=0, render_volumetrics=False,
                      max_march_steps=48)

    def frame(name, w, h, vol, screen_cfg):
        build = getattr(scenes, name)
        kw = {} if vol is None else {"volumetrics": vol}
        r = build(width=w, height=h, probes=probes, device="cpu", **kw)
        run = spmd.make_sharded_render(r.spec, probes, r.volumetrics, w, h,
                                       mesh, screen_cfg=screen_cfg)
        args = (r.scene_data, r.camera, r.state)
        (img, state), rep = spmd.collective_report(run.sharder, run, *args)
        ref, ref_state = render_frame(r.spec, probes, r.volumetrics, w, h,
                                      *args, screen_cfg=screen_cfg)
        err = max(float((a - b).abs().max()) for a, b in (
            (img, ref), (state.radiance, ref_state.radiance),
            (state.irradiance, ref_state.irradiance),
            (state.scattering, ref_state.scattering)))
        assert err <= 1e-6, (name, w, h, err)
        assert rep["in_loops"] == 0, rep
        return err, rep

    for w, h in ((24, 24), (23, 17)):
        err, rep = frame("global_illumination", w, h, None, cfg)
        # the radiance pass's colors, the screen pass's colors and hit
        # points
        assert [op["op"] for op in rep["ops"]] == ["all-gather"] * 3, rep
        assert rep["bytes"] == 4 * 3 * (512 + 2 * WORLD
                                        * -(-w * h // WORLD))
        out[f"gi {w}x{h}"] = err
    vol = VolumetricsSettings(visibility_resolution=(6, 6, 6),
                              visibility_step_size=0.5,
                              scattering_resolution=(10, 10),
                              scattering_step_size=0.5)
    err, rep = frame("light_shafts", 16, 16, vol,
                     dataclasses.replace(cfg, render_volumetrics=True))
    # radiance, froxels, scattering lengths, screen colors and hit points
    assert rep["n_collectives"] == 5 and rep["bytes"] < 4 << 20, rep
    out["light_shafts 16x16"] = err

    # one train step against one process's
    r = scenes.global_illumination(width=24, height=24, probes=probes,
                                   device="cpu")
    target = torch.zeros((24, 24, 3))
    args = (r.scene_data, r.camera, r.state, target)
    step = spmd.make_train_step(r.spec, probes, NO_VOLUMETRICS, 24, 24,
                                lr=0.05, screen_cfg=cfg, mesh=mesh)
    (loss, new, _), rep = spmd.collective_report(step.sharder, step, *args)
    ref_loss, ref_new, _ = spmd.make_train_step(
        r.spec, probes, NO_VOLUMETRICS, 24, 24, lr=0.05,
        screen_cfg=cfg)(*args)
    loss_rel = abs(float(loss) - float(ref_loss)) / float(ref_loss)
    assert loss_rel <= 1e-6, (float(loss), float(ref_loss))
    worst = 0.0
    for a, b, old in zip(spmd.split_float_leaves(new)[0],
                         spmd.split_float_leaves(ref_new)[0],
                         spmd.split_float_leaves(r.scene_data)[0]):
        step_ref = float((b - old).norm())
        if step_ref > 0.0:
            worst = max(worst, float((a - b).norm()) / step_ref)
        else:
            assert torch.equal(a, b)
    assert worst <= 1e-5, worst
    moved = float((new.materials["albedo"]
                   - r.scene_data.materials["albedo"]).abs().max())
    assert moved > 0.0
    # three gathers forward, the reduce-scatters of the two the loss
    # reads (the radiance and the screen colors) backward, one all-reduce
    # of the gradients
    assert sorted(op["op"] for op in rep["ops"]) == [
        "all-gather"] * 3 + ["all-reduce"] + ["reduce-scatter"] * 2, rep
    assert rep["in_loops"] == 0
    assert rep["bytes"] < 4 << 20
    out["train loss rel"] = loss_rel
    out["train update rel"] = worst
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(new))

    scaling = spmd.measure_scaling(width=16, height=16, frames=1,
                                   mesh=mesh, probes=probes)
    assert scaling["devices"] == WORLD and scaling["efficiency"] > 0.0
    torch.distributed.destroy_process_group()
    print("WORKER_OK", rank, json.dumps(out), flush=True)


def test_two_process_gloo_group():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    code = (f"import sys; sys.path[:0] = [{REPO!r}, "
            f"{os.path.join(REPO, 'tests')!r}]; "
            f"import test_torch_spmd_multiprocess as t; "
            f"t.worker(int(sys.argv[1]), {port})")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=REPO)
             for i in range(WORLD)]
    deadline = time.monotonic() + TIMEOUT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-4000:]}"
        assert f"WORKER_OK {i}" in out, out[-4000:]
        print(out.strip().splitlines()[-1])
