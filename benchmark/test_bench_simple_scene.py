"""The simple_scene.look cell on the CPU: it loads from BENCHMARK.json with
its own reference package and limits; a tiny view run of it is correct,
and one whose program builds the scene without its first box is not."""
import json
import os
import time

import numpy as np
import torch

from benchmark import cells, check, harness
from benchmark.conftest import BENCH, ROOT

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4127
CELL = "simple_scene.look"


def run(root):
    cell = cells.load_cell(CELL, root)
    with open(os.devnull, "w") as sink:
        return harness.run_cell(cell, SEED, 0.3, False, CPU,
                                time.perf_counter(), out=sink, err=sink)


def test_the_cell_loads_with_its_package_and_limits():
    """One chip, the simple_scene configuration at upstream's 1000x1000
    with gi_room's probes and nothing cut, the look mix, its own reference
    package (the default frame and leaves) and a limit for every number
    that frame gives; the geometry readers and not the volumetric ones."""
    cell = cells.load_cell(CELL, ROOT)
    assert cell.chips == 1 and cell.mix["loop"] == "view"
    with open(os.path.join(BENCH, "traffic", "look.json")) as f:
        assert cell.mix == json.load(f)
    cfg = cell.config
    assert cfg["builder"] == "simple_scene"
    assert cfg["resolution"] == [1000, 1000]
    assert cfg["reduced"] == [] and len(cfg["assumed"]) == 2
    with open(os.path.join(BENCH, "configs", "gi_room.json")) as f:
        assert cfg["probes"] == json.load(f)["probes"]
    entry = cells.reference_package(cfg, ROOT)
    assert entry.__name__ == "benchmark.reference_simple.entry"
    leaves = entry.leaves(cfg)
    assert set(leaves) == {"radiance", "irradiance"}
    check.require_limits(leaves, cell.limits)
    assert set(cell.limits) == {"image", "image_wrong", *leaves}
    assert set(cell.readers) == {"host_ms.view", "shade_ms.view",
                                 "geometry_ms.view", "geometry_roofline.view",
                                 "idle_share.view"}
    assert {m["name"] for m in cell.end_to_end} == {
        "frame_ms", "frame_p95_ms", "setup_s"}


def test_the_tally_counts_every_live_slot(tiny_root):
    """The reference's scene holds 20 spheres, 6 planes and 14 boxes live,
    and the tally behind geometry_roofline.view counts each evaluation of
    the scene as all 40 slots, unculled: the screen launch's sphere, plane
    and box evaluations stand 20 : 6 : 14, no chunk is evaluated or
    pruned, and its flops are those evaluations' and the box-exit caps'."""
    cfg = cells.load_cell(CELL, tiny_root).config
    ref = check.ViewReference(cfg, tiny_root, CPU)
    assert [(p.name, n) for p, _, n, _ in ref.rr.spec.prim_bounds()] == [
        ("sphere", 20), ("plane", 6), ("box", 14)]
    pose = (np.float32((2.0, 2.0, 0.0)), np.eye(3, dtype=np.float32))
    ref.frame(pose, None, None, np.arange(0, 64 * 64, 7), count=0)
    (tally,) = ref.tally
    march = ref.entry.march
    evals = march.scene_evals
    points = evals[0] // 20
    assert points > 0
    assert (evals[0], evals[1], evals[2]) == (20 * points, 6 * points,
                                              14 * points)
    assert not any(march.chunk_evals.values())
    assert not any(march.pruned_evals.values())
    assert tally["screen"]["flops"] == sum(
        march.SLOT_FLOPS[code] * n for code, n in evals.items()) \
        + march.CAP_FLOPS * march.cap_tests["boxes"]


def test_a_tiny_view_run_is_correct(tiny_root):
    r = run(tiny_root)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0
    assert set(r["checks"]) == {"image", "image_wrong", "radiance",
                                "irradiance"}


def test_a_program_without_a_box_is_not_correct(tiny_root, monkeypatch):
    """The program's scene built without its first box (at (3, 1, 2), in
    front of the camera): the image and the atlases leave their limits."""
    from madarch_tpu_torch.render import pipeline
    from madarch_tpu_torch.render.renderer import Renderer
    from madarch_tpu_torch.scene import primitives as P
    add, dropped = Renderer.add_primitive, []

    def add_primitive(self, ptype, **fields):
        if ptype is P.Box and not dropped:
            dropped.append(fields)
            return None
        return add(self, ptype, **fields)

    monkeypatch.setattr(Renderer, "add_primitive", add_primitive)
    pipeline.clear_compiled()
    r = run(tiny_root)
    pipeline.clear_compiled()
    assert dropped and dropped[0]["center"] == (3.0, 1.0, 2.0)
    assert not r["correct"], r["checks"]
    limits = cells.load_cell(CELL, tiny_root).limits
    for number in ("radiance", "irradiance"):
        assert r["checks"][number]["value"] > limits[number]

