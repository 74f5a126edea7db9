"""The march steps of the plain marches and the builds of the raycast,
visibility and softshadow kernels (madarch_tpu_torch/ops/csrc/march.cu),
on the CPU at small sizes.

- The plain marches of render/raymarch.py report each ray's march steps
  on request: a disabled ray, and a ray whose march would start at or past
  its max distance, takes 0; every other ray takes as many as the scene was
  evaluated for it (an sdf_b that counts per ray), the raycast's end-point
  classification aside; and the outputs are the same with the counts on.
- The wrappers' rule for the build of march.cu a scene gets
  (ops/march.py:march_layout) and the macros of that build.
- chip_smoke.py's padded scenes, on which it times a layout's build
  against the generic one: the room with inert slots appended marches
  as the room does in every plain version, bit for bit.
- The rays of test_torch_cuda.py's visibility tests march the long tails
  (or, the short rays, none) they are meant to put on the card, and the
  visibility wrapper on CPU tensors is its plain version, uncounted.
"""
import numpy as np
import pytest
import torch

from madarch_tpu_torch.ops import march as TM
from madarch_tpu_torch.render import raymarch as trm
from test_torch_config import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

N_RAYS = 96


def _rays(n=N_RAYS, seed=0):
    """Rays along +z from distinct (x, y): a ray's points keep its origin's
    x and y exactly (x + t·0 = x), so they name the ray."""
    rng = np.random.RandomState(seed)
    xy = rng.permutation(40 * 40)[:n]
    o = np.stack([xy % 40 * 0.15 - 3.0, xy // 40 * 0.15 - 3.0,
                  rng.uniform(-1.0, 1.0, n)], axis=1).astype(np.float32)
    d = np.tile(np.float32([0.0, 0.0, 1.0]), (n, 1))
    return torch.as_tensor(o), torch.as_tensor(d)


def _counting_sdf(origins):
    """(sdf_b, counts): seeded spheres in front of the rays and a far wall
    at z = 14; counts[i] is how many points of ray i sdf_b evaluated."""
    rng = np.random.RandomState(1)
    centers = torch.as_tensor(rng.uniform([-3, -3, 3], [3, 3, 10], (8, 3))
                              .astype(np.float32))
    radii = torch.as_tensor(rng.uniform(0.3, 1.2, 8).astype(np.float32))
    key = {(x, y): i for i, (x, y) in enumerate(origins[:, :2].tolist())}
    counts = torch.zeros(origins.shape[0], dtype=torch.int32)

    def sdf_b(p):
        ids = torch.tensor([key[(x, y)] for x, y in p[:, :2].tolist()],
                           dtype=torch.long)
        counts.index_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))
        spheres = torch.linalg.vector_norm(p[:, None] - centers, dim=-1) \
            - radii
        return torch.minimum(spheres.amin(dim=1), 14.0 - p[:, 2])

    return sdf_b, counts


def _enabled(n, seed):
    return torch.as_tensor(np.random.RandomState(seed).rand(n) > 0.25)


@pytest.mark.parametrize("max_steps", [300, 6])
def test_raycast_steps_count_the_scene_evaluations(max_steps):
    """March steps = evaluations, less the classification of an end point
    that no hit stopped the march at (a ray cut by max_steps short of
    max_dist); disabled rays take none."""
    o, d = _rays()
    en = _enabled(N_RAYS, 2)
    sdf_b, counts = _counting_sdf(o)
    t, hit, pos, steps = trm.raycast(sdf_b, o, d, 10.0, enabled=en,
                                     max_steps=max_steps, return_steps=True)
    extra = counts - steps
    assert steps.dtype == torch.int32
    assert bool((steps[~en] == 0).all()) and bool((counts[~en] == 0).all())
    assert bool(((extra == 0) | (extra == 1)).all())
    assert bool((extra[hit & (steps < max_steps)] == 0).all())
    assert bool((extra[en & ~hit & (t < 10.0)] == 1).all())
    assert bool((extra[t >= 10.0] == 0).all())
    assert bool((steps[en] >= 1).all()) and int(steps.max()) <= max_steps
    # hits, misses past max_dist and (with 6 steps) rays cut short
    assert bool(hit.any()) and bool((en & (t >= 10.0)).any())
    if max_steps == 6:
        assert bool((en & ~hit & (t < 10.0)).any())
    plain = trm.raycast(sdf_b, o, d, 10.0, enabled=en, max_steps=max_steps)
    for a, b in zip((t, hit, pos), plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_visibility_steps_count_the_scene_evaluations():
    o, d = _rays(seed=3)
    en = _enabled(N_RAYS, 4)
    mx = torch.as_tensor(np.random.RandomState(5).uniform(-2.0, 16.0, N_RAYS)
                         .astype(np.float32))
    sdf_b, counts = _counting_sdf(o)
    vis, steps = trm.raycast_visibility(sdf_b, o, d, mx, enabled=en,
                                        return_steps=True)
    torch.testing.assert_close(steps, counts, rtol=0, atol=0)
    never = ~en | (mx <= 0.0)
    assert bool(never.any()) and bool((steps[never] == 0).all())
    assert bool((steps[~never] >= 1).all())
    assert 0.0 < float(vis[~never].mean()) < 1.0
    torch.testing.assert_close(
        vis, trm.raycast_visibility(sdf_b, o, d, mx, enabled=en), rtol=0,
        atol=0)


@pytest.mark.parametrize("k", [64.0, 0.5])
def test_softshadow_steps_count_the_scene_evaluations(k):
    """Rays that start at or past their max distance (t0 >= max_dist) take
    no step, as disabled rays do."""
    o, d = _rays(seed=6)
    en = _enabled(N_RAYS, 7)
    rng = np.random.RandomState(8)
    mn = torch.as_tensor(rng.uniform(0.0, 2.0, N_RAYS).astype(np.float32))
    mx = torch.as_tensor(rng.uniform(0.0, 16.0, N_RAYS).astype(np.float32))
    mx[:8] = mn[:8]
    sdf_b, counts = _counting_sdf(o)
    res, steps = trm.softshadows(sdf_b, o, d, mn, mx, k, enabled=en,
                                 return_steps=True)
    torch.testing.assert_close(steps, counts, rtol=0, atol=0)
    never = ~en | (mn >= mx)
    assert bool((never[:8]).all()) and bool((steps[never] == 0).all())
    assert bool((res[never] == 1.0).all())
    assert bool((steps[~never] >= 1).all())
    assert bool((res[~never] == 0.0).any()) and bool(
        ((res > 0.0) & (res < 1.0)).any())
    torch.testing.assert_close(
        res, trm.softshadows(sdf_b, o, d, mn, mx, k, enabled=en), rtol=0,
        atol=0)


def test_reference_wrappers_pass_the_steps_through():
    """ops/march.py's plain versions report the same steps as the marches
    they wrap; raycast_reference's outputs are unchanged by the count."""
    from madarch_tpu_torch.examples import scenes as tscenes
    r = tscenes.global_illumination(width=16, height=16, device="cpu")
    packed = TM.pack_scene(r.spec, r.scene_data)
    rng = np.random.RandomState(9)
    o = torch.as_tensor(rng.uniform([-2, 0.5, 1], [2, 3, 5], (64, 3))
                        .astype(np.float32))
    d = torch.as_tensor(rng.randn(64, 3).astype(np.float32))
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    mx = torch.as_tensor(rng.uniform(0.0, 6.0, 64).astype(np.float32))
    t, hit, pos, steps = TM.raycast_reference(packed, o, d, 20.0,
                                              return_steps=True)
    for a, b in zip((t, hit, pos), TM.raycast_reference(packed, o, d, 20.0)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert bool((steps >= 1).all())
    _, vsteps = TM.visibility_reference(packed, o, d, mx, return_steps=True)
    _, ssteps = TM.softshadows_reference(packed, o, d, mx * 0.1, mx, 0.5,
                                         return_steps=True)
    assert vsteps.shape == ssteps.shape == (64,)
    assert int(ssteps.sum()) > 0 and int(vsteps.sum()) > 0


# ---------------------------------------------------------------------------
# The builds of march.cu
# ---------------------------------------------------------------------------

def _room():
    from madarch_tpu_torch.examples import scenes as tscenes
    r = tscenes.global_illumination(width=16, height=16, device="cpu")
    return TM.pack_scene(r.spec, r.scene_data)


def test_march_layout_follows_the_typed_runs():
    """march_layout: the room scenes (1 sphere, 6 planes, 1 box) get a
    build of their layout; simple_scene (20 spheres, 14 boxes) and a mesh
    the generic build."""
    from madarch_tpu_torch.examples import scenes as tscenes
    got = {}
    for name, r in (
            ("gi", tscenes.global_illumination(width=16, height=16,
                                               device="cpu")),
            ("shafts", tscenes.light_shafts(width=16, height=16,
                                            device="cpu")),
            ("simple", tscenes.simple_scene(width=16, height=16,
                                            device="cpu")),
            ("mesh", tscenes.obj_mesh(width=16, height=16,
                                      obj_path=tscenes.TORUS_OBJ,
                                      device="cpu"))):
        got[name] = TM.march_layout(TM.pack_scene(r.spec, r.scene_data))
    assert got == {"gi": (1, 6, 1), "shafts": (1, 6, 1), "simple": None,
                   "mesh": None}


def test_march_defines_name_the_macros_scene_cuh_reads():
    import os
    src = open(os.path.join(os.path.dirname(TM.__file__), "csrc",
                            "scene.cuh")).read()
    defines = TM.march_defines((1, 6, 1))
    assert defines == ("FIXED_SPHERES=1", "FIXED_PLANES=6", "FIXED_BOXES=1")
    for d in defines:
        assert d.split("=")[0] in src
    assert TM.march_defines() == ()


@pytest.mark.parametrize("counts, layout", [
    ((4, 8, 4), (4, 8, 4)), ((12, 6, 1), (12, 6, 1)), ((8, 8, 8), None),
    ((13, 6, 1), None), ((1, 6, 7), None)])
def test_padded_room_marches_as_the_room(counts, layout):
    """chip_smoke.pad_scene: the room padded with inert slots takes the
    layout build up to UNROLL_ROWS_MAX (20) float4 rows, a box two, and the
    generic one past it; its slots past the room's are dead, and the plain
    raycast, visibility and penumbra marches on it equal the room's bit for
    bit."""
    import chip_smoke
    m = chip_smoke.port_modules()
    room = _room()
    padded = chip_smoke.pad_scene(torch, m, room, counts)
    assert padded.counts == counts and TM.march_layout(padded) == layout
    assert padded.rows.shape == (counts[0] + counts[1] + 2 * counts[2], 4)
    live = TM.slot_live(padded)
    assert int(live.sum()) == room.n_slots
    assert live.shape == (sum(counts),)
    TM._check_scene(padded, torch.device("cpu"))
    rng = np.random.RandomState(10)
    o = torch.as_tensor(rng.uniform([-2, 0.5, 1], [2, 3, 5], (64, 3))
                        .astype(np.float32))
    d = torch.as_tensor(rng.randn(64, 3).astype(np.float32))
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    mn = torch.as_tensor(rng.uniform(0.0, 0.5, 64).astype(np.float32))
    mx = torch.as_tensor(rng.uniform(0.0, 6.0, 64).astype(np.float32))
    for scene_run in (
            lambda s: TM.raycast_reference(s, o, d, 20.0),
            lambda s: (TM.visibility_reference(s, o, d, mx),),
            lambda s: (TM.softshadows_reference(s, o, d, mn, mx, 0.5),),
            lambda s: TM.scene_dist_info(s, o, TM.VIS_CAP)):
        for a, b in zip(scene_run(padded), scene_run(room)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The visibility kernel's card tests: their rays' marches
# ---------------------------------------------------------------------------

def test_card_tests_rays_march_long_tails():
    """The plain version's steps: test_torch_cuda.py's grazing rays march
    tails of tens to hundreds of steps (most past TAIL), as a few of the
    light_shafts froxel rays of its tail-block test do; its short rays end
    within TAIL steps."""
    from test_torch_cuda import (TAIL, _grazing_rays, _light_shafts_rays,
                                 _short_rays)
    r, _, (pts, ldir, ldist) = _light_shafts_rays("cpu", n=4096)
    packed = TM.pack_scene(r.spec, r.scene_data)
    _, steps = TM.visibility_reference(packed, pts, ldir, ldist,
                                       return_steps=True)
    assert 0 < int((steps > TAIL).sum()) < steps.numel() // 10
    for scene in ("room", "padded", "fan"):
        packed, o, d, mx, en = _grazing_rays(scene, "cpu", 4099)
        _, steps = TM.visibility_reference(packed, o, d, mx, enabled=en,
                                           return_steps=True)
        assert int((steps > TAIL).sum()) > 4099 // 4, scene
        assert int(steps.max()) > 100, scene
    packed, o, d, mx, en = _short_rays("cpu", 4099)
    _, steps = TM.visibility_reference(packed, o, d, mx, enabled=en,
                                       return_steps=True)
    assert 0 < int(steps.max()) <= TAIL


@pytest.mark.parametrize("max_steps", [1, 16, 300])
def test_visibility_on_the_cpu_is_the_plain_version(max_steps):
    """On CPU tensors visibility() runs visibility_reference and counts no
    launch, whatever the step budget."""
    packed = _room()
    rng = np.random.RandomState(11)
    o = torch.as_tensor(rng.uniform([-0.5, -0.99, -5], [6.5, 6, 6], (64, 3))
                        .astype(np.float32))
    d = torch.as_tensor(rng.randn(64, 3).astype(np.float32))
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    mx = torch.as_tensor(rng.uniform(-1.0, 20.0, 64).astype(np.float32))
    en = torch.as_tensor(rng.rand(64) > 0.2)
    before = TM.launch_counts()["visibility"]
    got = TM.visibility(packed, o, d, mx, enabled=en, max_steps=max_steps)
    assert TM.launch_counts()["visibility"] == before
    torch.testing.assert_close(
        got, TM.visibility_reference(packed, o, d, mx, enabled=en,
                                     max_steps=max_steps), rtol=0, atol=0)
