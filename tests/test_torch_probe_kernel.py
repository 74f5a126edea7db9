"""The shade's probe lookups as CUDA kernels (ops/probe_lookup.py,
csrc/probes.cu) and the route that picks them (render/probes.py:
lookup_method).

On the CPU (tier-1): a frame takes the dense lookups and launches nothing;
a lookup whose position requires grad takes the dense route and carries
the gradient; the kernel route refuses a CPU tensor.

On the card (marker ``cuda``; the file imports no JAX):

    python -m pytest --noconftest tests/test_torch_probe_kernel.py -q

the irradiance kernel against sample_irradiance's "gather" (its plain
version, relative gap at most PLAIN_REL) and "matmul" (the dense route,
DENSE_REL) on random atlases and on the GI room's and the torus's hits,
and on the edge cases (a point on a probe, points outside the grid, every
corner invisible, normals on the axes and below the octahedron's fold);
the mode-2 radiance kernel against sample_tile_bilinear at mip 1 and the
dense one-hot lookup; 64x64 compiled frames by both routes; the wrapper's
refusals.  A relative gap is the largest absolute difference over the
largest magnitude of the reference: the kernels round like their plain
versions but for the sum over the 8 corners.
"""
import math

import numpy as np
import pytest
import torch

from madarch_tpu_torch.core.config import ProbeSettings, ShadeConfig
from madarch_tpu_torch.examples import scenes as S
from madarch_tpu_torch.ops import march as M
from madarch_tpu_torch.ops import probe_lookup as PL
from madarch_tpu_torch.render import pipeline
from madarch_tpu_torch.render import probes as PR
from madarch_tpu_torch.render.camera import camera_rays, pixel_grid
from madarch_tpu_torch.render.context import SceneCtx
from madarch_tpu_torch.utils import profiling

PLAIN_REL = 1e-6
DENSE_REL = 1e-5
# mean absolute gap of a tonemapped 64x64 frame, kernel route against
# dense route
IMAGE_GAP = 1e-5
SETTINGS = ProbeSettings()       # 36 probes, 8x8 irradiance, 32x32 radiance
SMALL = ProbeSettings(radiance_resolution=4, irradiance_resolution=2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def rel_gap(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def lookups(rec, route):
    return sum(v for _, name, v in rec["counters"]
               if name == f"probe_lookups.{route}")


def probe_launches():
    return (PL.irradiance_lookup.launches, PL.radiance_lookup.launches)


# ---------------------------------------------------------------------------
# The route, on the CPU
# ---------------------------------------------------------------------------

def test_a_cpu_frame_takes_the_dense_lookups_and_launches_nothing():
    """A GI frame on the CPU: every lookup (the radiance pass's irradiance,
    the screen's irradiance and mode 2's radiance tile) counts under
    probe_lookups.dense, none under .kernel, and no kernel launches."""
    r = S.global_illumination(width=16, height=16, probes=SMALL,
                              device="cpu")
    before = probe_launches()
    profiling.drain()
    profiling.enable()
    try:
        r.render()
    finally:
        profiling.disable()
    rec = profiling.drain()
    rays = SMALL.num_probes * SMALL.radiance_resolution ** 2
    assert lookups(rec, "dense") == rays + 2 * 16 * 16
    assert lookups(rec, "kernel") == 0
    assert probe_launches() == before


def test_a_lookup_whose_position_requires_grad_takes_the_dense_route():
    """pos requiring grad: lookup_method answers "matmul", the lookup
    launches nothing, and its gradient reaches pos."""
    g = np.random.default_rng(3)
    n = 64
    atlas = torch.as_tensor(
        g.uniform(0.1, 1.0, SETTINGS.irradiance_atlas_shape),
        dtype=torch.float32)
    pos = torch.tensor(g.uniform(0.5, 5.5, (n, 3)), dtype=torch.float32,
                       requires_grad=True)
    normal = torch.nn.functional.normalize(
        torch.as_tensor(g.normal(size=(n, 3)), dtype=torch.float32), dim=-1)
    vis8 = torch.ones((8, n))
    before = probe_launches()
    profiling.drain()
    profiling.enable()
    try:
        method = PR.lookup_method(n, atlas, pos, normal, vis8)
    finally:
        profiling.disable()
    rec = profiling.drain()
    assert method == "matmul"
    assert lookups(rec, "dense") == n and lookups(rec, "kernel") == 0
    irr = PR.sample_irradiance(SETTINGS, atlas, pos, normal, vis8=vis8,
                               method=method)
    irr.sum().backward()
    assert pos.grad is not None and float(pos.grad.abs().max()) > 0
    assert probe_launches() == before


def test_the_kernels_refuse_a_cpu_tensor():
    n = 8
    before = probe_launches()
    atlas = torch.zeros(SETTINGS.irradiance_atlas_shape)
    pos, normal = torch.zeros((n, 3)), torch.ones((n, 3))
    with pytest.raises(ValueError, match="cpu"):
        PR.sample_irradiance(SETTINGS, atlas, pos, normal,
                             vis8=torch.ones((8, n)), method="kernel")
    mip1 = torch.zeros((6 * 16, 6 * 16, 3))
    with pytest.raises(ValueError, match="cpu"):
        PL.radiance_lookup(SETTINGS, mip1, torch.zeros(n), normal)
    assert probe_launches() == before


# ---------------------------------------------------------------------------
# The kernels against their plain versions, on the card
# ---------------------------------------------------------------------------

def _irradiance_cases(settings, atlas, pos, normal, vis8):
    """{method: sample_irradiance(...)} for the kernel, gather and
    matmul."""
    return {m: PR.sample_irradiance(settings, atlas, pos, normal, vis8=vis8,
                                    method=m)
            for m in ("kernel", "gather", "matmul")}


def _hold_irradiance(settings, atlas, pos, normal, vis8):
    before = PL.irradiance_lookup.launches
    got = _irradiance_cases(settings, atlas, pos, normal, vis8)
    torch.cuda.synchronize()
    assert PL.irradiance_lookup.launches == before + 1
    assert bool(torch.isfinite(got["kernel"]).all())
    assert rel_gap(got["kernel"], got["gather"]) <= PLAIN_REL
    assert rel_gap(got["kernel"], got["matmul"]) <= DENSE_REL
    return got


def _unit(g, n, dev):
    v = torch.as_tensor(g.normal(size=(n, 3)), dtype=torch.float32)
    return torch.nn.functional.normalize(v, dim=-1).to(dev).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_irradiance_kernel_on_random_atlases(dev, seed):
    """Random atlases at res 8, points inside and around the probe grid
    (x, y, z in [-2, 9]: clamped corners past it), random normals, the
    corners' visibility 0, 1 or between."""
    g = np.random.default_rng(seed)
    n = 8192
    atlas = torch.as_tensor(g.uniform(0.0, 2.0,
                                      SETTINGS.irradiance_atlas_shape),
                            dtype=torch.float32, device=dev)
    pos = torch.as_tensor(g.uniform(-2.0, 9.0, (n, 3)), dtype=torch.float32,
                          device=dev)
    vis8 = torch.as_tensor(np.where(g.random((8, n)) < 0.5,
                                    g.integers(0, 2, (8, n)),
                                    g.random((8, n))),
                           dtype=torch.float32, device=dev)
    got = _hold_irradiance(SETTINGS, atlas, pos, _unit(g, n, dev), vis8)
    assert float(got["gather"].abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["global_illumination", "obj_mesh"])
def test_irradiance_kernel_on_scene_hits(dev, scene):
    """The GI room's and the torus's screen hits at 128x128 after two
    frames, with the geometry kernel's normals and visibility and the
    converged atlas."""
    if scene == "obj_mesh":
        r = S.obj_mesh(width=128, height=128, obj_path=S.TORUS_OBJ,
                       device=dev)
    else:
        r = S.global_illumination(width=128, height=128, device=dev)
    r.converge(frames=2)
    cam = r.camera
    o, d = camera_rays(pixel_grid(r.width, r.height, dev), cam.position,
                       cam.orientation)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    g = SceneCtx(r.spec, r.scene_data).geometry(o, d, r.probes,
                                                r.screen_cfg)
    hit = g["hit"]
    assert int(hit.sum()) > 400
    pos = (o + d * g["t"][:, None])[hit].contiguous()
    got = _hold_irradiance(r.probes, r.state.irradiance, pos,
                           g["normal"][hit].contiguous(),
                           g["vis8"][:, hit].contiguous())
    assert float(got["gather"].abs().max()) > 0


@pytest.mark.cuda
def test_irradiance_kernel_edge_cases(dev):
    """Points on every probe, far outside the grid on each side, corners
    all invisible, normals on the six axes and with z <= 0 (the fold)."""
    g = np.random.default_rng(5)
    probes = PR.probe_world_positions(SETTINGS, dev)
    far = torch.tensor([[-50.0, 3.0, 3.0], [50.0, 3.0, 3.0],
                        [3.0, -50.0, 3.0], [3.0, 50.0, 3.0],
                        [3.0, 3.0, -50.0], [3.0, 3.0, 50.0],
                        [-50.0, -50.0, -50.0], [50.0, 50.0, 50.0]],
                       device=dev)
    inside = torch.as_tensor(g.uniform(0.0, 6.0, (64, 3)),
                             dtype=torch.float32, device=dev)
    pos = torch.cat([probes, far, inside]).contiguous()
    n = pos.shape[0]
    axes = torch.cat([torch.eye(3), -torch.eye(3)]).to(dev)
    below = _unit(g, n, dev)
    below[:, 2] = -below[:, 2].abs()
    normals = [axes[torch.arange(n, device=dev) % 6].contiguous(),
               torch.nn.functional.normalize(below, dim=-1).contiguous()]
    atlas = torch.as_tensor(g.uniform(0.0, 1.0,
                                      SETTINGS.irradiance_atlas_shape),
                            dtype=torch.float32, device=dev)
    for normal in normals:
        for vis8 in (torch.ones((8, n), device=dev),
                     torch.zeros((8, n), device=dev)):
            got = _hold_irradiance(SETTINGS, atlas, pos, normal, vis8)
            if not bool(vis8.any()):
                # every weight crushed to 0: the blend is 0 everywhere
                assert not bool(got["kernel"].any())
    # a zero atlas: the 1e-12 floor under the square root
    _hold_irradiance(SETTINGS, torch.zeros_like(atlas), pos, normals[0],
                     torch.ones((8, n), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_radiance_kernel_against_the_mip1_lookups(dev, seed):
    """Mode 2's lookup at res 16 (mip 1 of 32x32 tiles) on a random
    atlas: random probe ids, random directions and the axes, against
    sample_tile_bilinear at mip 1 and the dense one-hot lookup; an id
    outside the atlas reads 0 by both the kernel and the dense route."""
    g = np.random.default_rng(seed)
    s = SETTINGS
    res = s.radiance_resolution // 2
    px, py = s.probe_count
    rad = torch.as_tensor(g.uniform(0.0, 3.0, s.radiance_atlas_shape),
                          dtype=torch.float32, device=dev)
    mip1 = PR.radiance_mip1(s, rad)
    n = 4096
    pid = torch.as_tensor(g.integers(0, s.num_probes, n), dtype=torch.int32,
                          device=dev)
    pid[:2] = torch.tensor([-1, px * py], device=dev)
    best_dir = _unit(g, n, dev)
    best_dir[2:8] = torch.cat([torch.eye(3), -torch.eye(3)]).to(dev)
    best_pid = pid.to(torch.float32)
    before = PL.radiance_lookup.launches
    got = PL.radiance_lookup(s, mip1, best_pid, best_dir)
    torch.cuda.synchronize()
    assert PL.radiance_lookup.launches == before + 1
    ray_id = PR.dir_to_ray_id(best_dir)
    dense = PR.probe_one_hot_combine(
        px * py, pid[None], torch.ones((1, n), device=dev),
        PR.sample_all_tiles_bilinear(s, mip1, ray_id, res))
    ok = slice(2, None)
    tx, ty = PR.probe_id_to_tile(s, pid[ok])
    plain = PR.sample_tile_bilinear(mip1, tx, ty, ray_id[ok], res)
    assert not bool(got[:2].any()) and not bool(dense[:2].any())
    assert rel_gap(got[ok], plain) <= PLAIN_REL
    assert rel_gap(got, dense) <= DENSE_REL


# ---------------------------------------------------------------------------
# Frames by both routes
# ---------------------------------------------------------------------------

def _frame_scene(name, dev):
    if name == "obj_mesh":
        return S.obj_mesh(width=64, height=64, obj_path=S.TORUS_OBJ,
                          device=dev)
    if name == "gi_mode3":
        return S.global_illumination(
            width=64, height=64, device=dev,
            screen_cfg=ShadeConfig(indirect_specular_mode=3))
    return S.global_illumination(width=64, height=64, device=dev)


def _eager(r, state):
    with torch.no_grad():
        return pipeline.render_frame(
            r.spec, r.probes, r.volumetrics, r.width, r.height,
            r.scene_data, r.camera, state, screen_cfg=r.screen_cfg,
            probe_cfg=r.probe_cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["global_illumination", "obj_mesh",
                                   "gi_mode3"])
def test_compiled_frames_by_both_routes(dev, scene, monkeypatch):
    """64x64 after two frames: the compiled frame (kernel route) bit-equal
    to its own eager frame on the same inputs, and within IMAGE_GAP of the
    eager frame whose lookups are dense; the captured frame launches the
    irradiance kernel in each shade (mode 3's reflection too) and mode 2's
    radiance kernel."""
    pipeline.clear_compiled()
    r = _frame_scene(scene, dev)
    r.converge(frames=2)
    state = r.state
    img = r.render()
    torch.cuda.synchronize()
    ref, _ = _eager(r, state)
    assert torch.equal(img, ref)
    mode = r.screen_cfg.indirect_specular_mode
    assert r.frame.launches["irradiance_lookup"] == (3 if mode == 3 else 2)
    assert r.frame.launches["radiance_lookup"] == (1 if mode == 2 else 0)
    monkeypatch.setattr(PR, "lookup_method", lambda n, *inputs: "matmul")
    dense, _ = _eager(r, state)
    gap = (img - dense).abs()
    assert float(gap.mean()) <= IMAGE_GAP and math.isfinite(
        float(gap.max()))
    assert float(img.var()) > 0.0
    pipeline.clear_compiled()


# ---------------------------------------------------------------------------
# The wrapper's refusals
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_the_wrapper_refuses_what_the_kernel_does_not_take(dev):
    n = 16
    atlas = torch.rand(SETTINGS.irradiance_atlas_shape, device=dev)
    pos = torch.rand((n, 3), device=dev)
    normal = torch.nn.functional.normalize(torch.rand((n, 3), device=dev),
                                           dim=-1)
    vis8 = torch.ones((8, n), device=dev)
    before = probe_launches()
    with pytest.raises(ValueError, match="cpu"):
        PL.irradiance_lookup(SETTINGS, atlas, pos.cpu(), normal, vis8)
    with pytest.raises(TypeError, match="dtype"):
        PL.irradiance_lookup(SETTINGS, atlas.double(), pos, normal, vis8)
    with pytest.raises(ValueError, match="requires grad"):
        PL.irradiance_lookup(SETTINGS, atlas, pos.requires_grad_(), normal,
                             vis8)
    with pytest.raises(ValueError, match="contiguous"):
        PL.irradiance_lookup(SETTINGS, atlas, pos.detach(), normal,
                             torch.ones((n, 8), device=dev).t())
    mip1 = PR.radiance_mip1(SETTINGS, torch.rand(
        SETTINGS.radiance_atlas_shape, device=dev))
    with pytest.raises(ValueError, match="shape"):
        PL.radiance_lookup(SETTINGS, mip1[:-1], torch.zeros(n, device=dev),
                           normal)
    with pytest.raises(TypeError, match="dtype"):
        PL.radiance_lookup(SETTINGS, mip1,
                           torch.zeros(n, dtype=torch.int32, device=dev),
                           normal)
    assert probe_launches() == before
    assert M.launch_counts()["irradiance_lookup"] == before[0]
