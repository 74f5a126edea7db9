"""The volumetric passes' tensor math as CUDA kernels
(ops/volumetrics_kernel.py, csrc/volumetrics.cu) and the route that picks
them (render/volumetrics.py:method).

On the CPU (tier-1): a light_shafts frame takes the plain route in each
pass and launches nothing, and the counters volumetrics.plain and
volumetrics.kernel record each pass's froxels, texels and pixels under the
route it took; on a card the route is the kernels' only where no gradient
has to pass, and each pass asks it with every tensor its gradient could
come through; the wrappers' refusals; no kernel of the library carries a
name the benchmark reads as a march kernel's.

On the card (marker ``cuda``; the file imports no JAX):

    python -m pytest --noconftest tests/test_torch_volumetrics_kernel.py -q

each entry point against the plain ops it replaces, bit for bit (every
output's bits equal): the froxel in-scatter at upstream's 100^3 froxels
with one static slot, two static slots, and dynamic slots of which some
are dead; the scattering integral at upstream's 250^2 map over 100^3
froxels, at a map that does not divide the froxel grid, on rays shorter
than the first tap, past max_depth and missing, and on a length given
without hits (a sharded raycast's); the composite at a 1000^2 screen over
the 250^2 map, at odd screens whose 3x3 taps clamp at every edge, with
ties; light_shafts' 1000^2 frame by both routes, and compiled frames
launching each kernel once a frame.
"""
import math
import os
import re

import numpy as np
import pytest
import torch

from madarch_tpu_torch.core.config import ProbeSettings, VolumetricsSettings
from madarch_tpu_torch.examples import scenes as S
from madarch_tpu_torch.ops import launch
from madarch_tpu_torch.ops import volumetrics_kernel as VK
from madarch_tpu_torch.render import pipeline
from madarch_tpu_torch.render import volumetrics as V
from madarch_tpu_torch.render.context import SceneCtx
from madarch_tpu_torch.scene import lights as L
from madarch_tpu_torch.scene.scene import tree_leaves
from madarch_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ProbeSettings(radiance_resolution=4, irradiance_resolution=2)
SMALL_VOL = VolumetricsSettings(visibility_resolution=(8, 6, 5),
                                visibility_step_size=0.5,
                                scattering_resolution=(10, 7),
                                scattering_step_size=0.5)
# A scattering map that does not divide the froxel grid, on either axis.
ODD_VOL = VolumetricsSettings(visibility_resolution=(37, 23, 50),
                              scattering_resolution=(61, 45))
KERNEL_NAMES = ("scatter_integral", "fog_composite", "froxel_inscatter")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def counters(rec, name):
    """The values recorded under the counter ``name``, in order."""
    return [v for _, n, v in rec["counters"] if n == name]


def recorded(fn):
    """fn()'s result and the recorder's record of it."""
    profiling.drain()
    profiling.enable()
    try:
        out = fn()
    finally:
        profiling.disable()
    return out, profiling.drain()


def shafts(device, width=16, height=12, vol=SMALL_VOL, **kw):
    return S.light_shafts(width=width, height=height, probes=SMALL,
                          volumetrics=vol, device=device, **kw)


def kernel_launches():
    counts = launch.launch_counts()
    return {k: counts[k] for k in KERNEL_NAMES}


# ---------------------------------------------------------------------------
# The route, on the CPU
# ---------------------------------------------------------------------------

def test_a_cpu_frame_takes_the_plain_route_and_launches_nothing():
    """An eager light_shafts frame on the CPU counts its froxels, texels
    and pixels, in that order, under volumetrics.plain and nothing under
    volumetrics.kernel, and launches none of the three kernels."""
    r = shafts("cpu")
    before = kernel_launches()
    with pipeline.eager():
        _, rec = recorded(r.render)
    vx, vy, vz = SMALL_VOL.visibility_resolution
    sx, sy = SMALL_VOL.scattering_resolution
    assert counters(rec, "volumetrics.plain") == [vx * vy * vz, sx * sy,
                                                  16 * 12]
    assert counters(rec, "volumetrics.kernel") == []
    assert kernel_launches() == before


def test_a_compiled_cpu_frame_counts_each_frame():
    """The compiled frame on the CPU runs its body each frame: each frame
    counts the three passes under volumetrics.plain."""
    pipeline.clear_compiled()
    r = shafts("cpu")
    _, rec = recorded(lambda: [r.render() for _ in range(2)])
    pipeline.clear_compiled()
    assert len(counters(rec, "volumetrics.plain")) == 6
    assert counters(rec, "volumetrics.kernel") == []


def _on_a_card(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda x: True),
                        raising=False)


@pytest.mark.parametrize("grad,requires,want", [
    (True, False, "kernel"), (False, True, "kernel"), (True, True, "plain")])
def test_the_route_on_a_card(monkeypatch, grad, requires, want):
    """On a card (the test patches Tensor.is_cuda) the route is the
    kernels' unless grad is enabled and an input requires it; the pass's
    elements count under the route taken."""
    x, y = torch.zeros(4), torch.zeros(4, requires_grad=requires)
    _on_a_card(monkeypatch)
    with torch.set_grad_enabled(grad):
        got, rec = recorded(lambda: V.method(123, x, y))
    assert got == want
    assert counters(rec, f"volumetrics.{want}") == [123]
    assert counters(rec, "volumetrics."
                    + ("plain" if want == "kernel" else "kernel")) == []


def test_the_route_off_a_card_is_plain():
    got, rec = recorded(lambda: V.method(7, torch.zeros(3)))
    assert got == "plain"
    assert counters(rec, "volumetrics.plain") == [7]


def test_each_pass_asks_the_route_with_its_gradient_inputs(monkeypatch):
    """A frame whose light position requires grad (grad enabled): each of
    the three passes asks the route with a tensor that requires grad, so
    on a card each takes the plain ops; the image's gradient reaches the
    light."""
    r = shafts("cpu")
    data = r.scene_data
    pos = data.lights["point_light"]["position"]
    pos.requires_grad_(True)
    asked = []
    real = V.method

    def spy(n, x, *inputs):
        asked.append((x, *inputs))
        return real(n, x, *inputs)

    monkeypatch.setattr(V, "method", spy)
    image, _ = pipeline.render_frame(
        r.spec, r.probes, r.volumetrics, r.width, r.height, data, r.camera,
        r.state, screen_cfg=r.screen_cfg, probe_cfg=r.probe_cfg)
    assert len(asked) == 3
    _on_a_card(monkeypatch)
    for tensors in asked:
        assert not launch.takes(*tensors)
    with torch.no_grad():
        assert all(launch.takes(*tensors) for tensors in asked)
    monkeypatch.undo()
    image.sum().backward()
    assert pos.grad is not None and float(pos.grad.abs().max()) > 0


def test_the_visibility_pass_asks_with_every_light_leaf(monkeypatch):
    r = shafts("cpu")
    asked = []
    monkeypatch.setattr(V, "method",
                        lambda n, *t: asked.append(t) or "plain")
    ctx = SceneCtx(r.spec, r.scene_data)
    V.visibility_pass(r.spec, r.scene_data, r.volumetrics, ctx,
                      r.camera.position, r.camera.orientation)
    leaves = tree_leaves(r.scene_data.lights)
    assert len(asked) == 1 and leaves
    assert all(any(t is leaf for t in asked[0]) for leaf in leaves)


# ---------------------------------------------------------------------------
# The wrappers' refusals and the kernels' names, on the CPU
# ---------------------------------------------------------------------------

def _scatter_inputs(device="cpu"):
    f32 = dict(dtype=torch.float32, device=device)
    return dict(t=torch.zeros(6, **f32),
                hit=torch.ones(6, dtype=torch.bool, device=device),
                visibility=torch.zeros((4, 2, 3, 3), **f32),
                weights=torch.ones(5, **f32))


@pytest.mark.parametrize("fault,error", [
    ("on_the_cpu", ValueError), ("t_float64", TypeError),
    ("t_short", ValueError), ("hit_not_bool", TypeError),
    ("visibility_not_contiguous", ValueError)])
def test_the_scatter_integral_refuses_what_it_does_not_take(fault, error):
    x = _scatter_inputs()
    if fault == "t_float64":
        x["t"] = x["t"].double()
    elif fault == "t_short":
        x["t"] = x["t"][:5]
    elif fault == "hit_not_bool":
        x["hit"] = x["hit"].float()
    elif fault == "visibility_not_contiguous":
        x["visibility"] = x["visibility"].transpose(1, 2).contiguous() \
            .transpose(1, 2)
    with pytest.raises(error):
        VK.scatter_integral(x["t"], x["hit"], x["visibility"], x["weights"],
                            scattering_resolution=(3, 2), max_depth=1.0,
                            step=0.5, visibility_step=0.25)


@pytest.mark.parametrize("fault,error", [
    ("on_the_cpu", ValueError), ("ix_int64", TypeError),
    ("ray_len_short", ValueError), ("scattering_3_channels", ValueError),
    ("color_requires_grad", ValueError)])
def test_the_composite_refuses_what_it_does_not_take(fault, error):
    scattering = torch.zeros((3, 4, 4))
    color, ray_len = torch.zeros((10, 3)), torch.zeros(10)
    ix = torch.zeros(5, dtype=torch.int32)
    iy = torch.zeros(2, dtype=torch.int32)
    if fault == "ix_int64":
        ix = ix.long()
    elif fault == "ray_len_short":
        ray_len = ray_len[:9]
    elif fault == "scattering_3_channels":
        scattering = scattering[..., :3].contiguous()
    elif fault == "color_requires_grad":
        color.requires_grad_(True)
    with pytest.raises(error):
        VK.fog_composite(scattering, color, ray_len, ix, iy, max_dist=20.0,
                         tau=0.1)


@pytest.mark.parametrize("fault,error", [
    ("on_the_cpu", ValueError), ("radiance_broadcast", ValueError),
    ("live_int", TypeError), ("vis_float16", TypeError)])
def test_the_froxel_inscatter_refuses_what_it_does_not_take(fault, error):
    n = 8
    result, ldist, vis = torch.zeros((n, 3)), torch.ones(n), torch.ones(n)
    radiance, ldir, dirs = (torch.ones((n, 3)) for _ in range(3))
    live = torch.ones((), dtype=torch.bool)
    if fault == "radiance_broadcast":
        radiance = torch.ones(3)
    elif fault == "live_int":
        live = live.int()
    elif fault == "vis_float16":
        vis = vis.half()
    with pytest.raises(error):
        VK.froxel_inscatter(result, ldist, vis, radiance, ldir, dirs, live,
                            tau=0.1)


def _global_names():
    with open(os.path.join(REPO, "madarch_tpu_torch", "ops", "csrc",
                           "volumetrics.cu")) as f:
        src = f.read()
    return src, re.findall(r"__global__\s+void\s+(?:__launch_bounds__\("
                           r"[^)]*\)\s+)?(\w+)\s*\(", src)


def test_no_kernel_name_reads_as_a_march_kernel():
    """The benchmark files a device op whose name holds one of
    benchmark/tracing.py:HAND_WRITTEN under the march kernels
    (geometry_ms.view, volumetrics_ms.view): none of the library's kernels
    does, so their time stays in shade_ms.view."""
    from benchmark.tracing import HAND_WRITTEN
    _, names = _global_names()
    assert sorted(names) == sorted(f"{k}_kernel" for k in KERNEL_NAMES)
    assert not [n for n in names if any(h in n for h in HAND_WRITTEN)]


def test_every_entry_point_and_kernel_is_declared():
    """Each entry point ops/launch.py declares is an extern "C" function of
    the source; each kernel's launches are counted under its wrapper and
    madarch_tpu_torch/bench.py reads its device events by its name."""
    from madarch_tpu_torch import bench
    src, names = _global_names()
    for symbol in launch.ENTRY_POINTS["volumetrics"]:
        assert re.search(rf'extern "C" int {symbol}\(', src), symbol
    for name in KERNEL_NAMES:
        assert name in launch.KERNELS
        assert bench.KERNELS[name] == f"{name}_kernel" in names


# ---------------------------------------------------------------------------
# On the card: each entry point bit for bit against the plain ops
# ---------------------------------------------------------------------------

def bits(x):
    return x.contiguous().view(torch.int32)


def assert_bit_equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(bits(a), bits(b)), float((a - b).abs().max())


def plain(monkeypatch):
    """Inside the block every pass takes the plain ops on the card too."""
    monkeypatch.setattr(V, "method", lambda n, *tensors: "plain")


def light_case(r, case):
    """(spec, data) of light_shafts in ``case``: its one live slot, static
    (upstream); two static slots; dynamic slots, one live and three dead;
    dynamic, two live and two dead."""
    if case in ("two_static", "two_of_four"):
        r.add_light(L.PointLight, position=(1.5, 4.0, 2.5),
                    color=(0.3, 0.6, 0.9))
    spec = r.base_spec if case in ("one_of_four", "two_of_four") else r.spec
    return spec, r.scene_data


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["upstream", "two_static", "one_of_four",
                                  "two_of_four"])
def test_froxel_inscatter_is_bit_equal_to_the_plain_ops(dev, monkeypatch,
                                                        case):
    r = shafts(dev, 64, 64, vol=VolumetricsSettings())
    spec, data = light_case(r, case)
    slots = sum(n for _, _, n, _ in spec.light_bounds())
    assert slots == {"upstream": 1, "two_static": 2, "one_of_four": 4,
                     "two_of_four": 4}[case]
    cam = r.camera

    def run():
        with torch.no_grad():
            ctx = SceneCtx(spec, data)
            return V.visibility_pass(spec, data, r.volumetrics, ctx,
                                     cam.position, cam.orientation)

    before = kernel_launches()
    got, rec = recorded(run)
    torch.cuda.synchronize()
    assert kernel_launches()["froxel_inscatter"] \
        - before["froxel_inscatter"] == slots
    assert counters(rec, "volumetrics.kernel") == [100 ** 3]
    plain(monkeypatch)
    want = run()
    assert got.shape == (100, 100, 100, 3)
    assert float(want.abs().max()) > 0
    assert_bit_equal(got, want)


class FakeRaycast:
    """A SceneCtx whose raycast returns the given t and hit."""

    def __init__(self, t, hit):
        self.t, self.hit = t, hit

    def raycast(self, origins, dirs, max_dist, *, max_steps):
        assert origins.shape[0] == self.t.shape[0]
        return self.t, self.hit, None


def _lengths(rng, n, max_depth, dev):
    """t and hit of n rays: a hit a ray in five, below the first tap (0,
    1e-7, under the step), at a tap's distance exactly, inside and past
    max_depth (inf too), and misses."""
    step = np.float32(0.1)
    t = rng.uniform(0.0, 1.5 * max_depth, n).astype(np.float32)
    special = np.array([0.0, 1e-7, 0.05, step, 2 * step, np.float32(max_depth),
                        np.nextafter(np.float32(max_depth), np.float32(0)),
                        np.inf], np.float32)
    t[:special.size * 50] = np.tile(special, 50)
    hit = rng.random(n) < 0.8
    return (torch.as_tensor(t, device=dev),
            torch.as_tensor(hit, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("vol_name", ["upstream", "odd"])
def test_scattering_integral_is_bit_equal_to_the_plain_ops(dev, monkeypatch,
                                                           vol_name):
    vol = VolumetricsSettings() if vol_name == "upstream" else ODD_VOL
    r = shafts(dev, 64, 64, vol=vol)
    cam = r.camera
    with torch.no_grad():
        visibility = V.visibility_pass(
            r.spec, r.scene_data, vol, SceneCtx(r.spec, r.scene_data),
            cam.position, cam.orientation)
    sx, sy = vol.scattering_resolution
    t, hit = _lengths(np.random.default_rng(5), sx * sy, vol.max_depth, dev)
    ctx = FakeRaycast(t, hit)

    def run():
        with torch.no_grad():
            return V.scattering_pass(r.spec, r.scene_data, vol, ctx,
                                     visibility, cam.position,
                                     cam.orientation)

    before = kernel_launches()
    got = run()
    torch.cuda.synchronize()
    assert kernel_launches()["scatter_integral"] \
        - before["scatter_integral"] == 1
    plain(monkeypatch)
    want = run()
    assert got.shape == (sy, sx, 4)
    assert float(want[..., :3].abs().max()) > 0
    assert_bit_equal(got, want)
    # a length given without hits, as the sharded raycast gives it
    length = want[..., 3].reshape(-1).contiguous()
    n_steps = int(vol.max_depth / vol.scattering_step_size)
    weights = torch.exp(torch.as_tensor(
        -np.arange(n_steps, dtype=np.float32)
        * np.float32(vol.scattering_step_size)
        * np.float32(V.TAU_SCATTERING)).to(dev))
    again = VK.scatter_integral(
        length, None, visibility, weights, scattering_resolution=(sx, sy),
        max_depth=vol.max_depth, step=vol.scattering_step_size,
        visibility_step=vol.visibility_step_size)
    assert_bit_equal(again, want)


def _composite_inputs(rng, w, h, vol, dev, max_dist=20.0):
    """A scattering map and pixels whose lengths sit on a coarse grid, so
    that taps tie and the first must win; lengths past max_dist too."""
    sx, sy = vol.scattering_resolution
    scat = rng.uniform(0.0, 2.0, (sy, sx, 4)).astype(np.float32)
    scat[..., 3] = rng.integers(0, 40, (sy, sx)) * np.float32(0.5)
    ray_len = (rng.integers(0, 44, h * w) * np.float32(0.5)).astype(
        np.float32)
    color = rng.uniform(0.0, 3.0, (h * w, 3)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=dev)
                 for a in (scat, color, ray_len))


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,vol_name", [
    (1000, 1000, "upstream"), (7, 5, "tiny"), (1001, 999, "upstream"),
    (333, 517, "odd")])
def test_composite_is_bit_equal_to_the_plain_ops(dev, monkeypatch, w, h,
                                                 vol_name):
    vol = {"upstream": VolumetricsSettings(), "odd": ODD_VOL,
           "tiny": VolumetricsSettings(scattering_resolution=(4, 3))}[
               vol_name]
    scat, color, ray_len = _composite_inputs(np.random.default_rng(w), w, h,
                                             vol, dev)

    def run():
        return V.composite(vol, scat, color, ray_len, w, h, 20.0)

    before = kernel_launches()
    got = run()
    torch.cuda.synchronize()
    assert kernel_launches()["fog_composite"] - before["fog_composite"] == 1
    plain(monkeypatch)
    assert_bit_equal(got, run())


@pytest.mark.cuda
def test_light_shafts_frames_by_both_routes_are_bit_equal(dev, monkeypatch):
    """light_shafts at upstream's 1000^2 with its volumetrics, after two
    frames: the eager frame's image and state by the kernels and by the
    plain ops, bit for bit."""
    r = S.light_shafts(device=dev)
    r.converge(frames=2)

    def frame():
        with torch.no_grad():
            return pipeline.render_frame(
                r.spec, r.probes, r.volumetrics, r.width, r.height,
                r.scene_data, r.camera, r.state, screen_cfg=r.screen_cfg,
                probe_cfg=r.probe_cfg)

    (img_k, st_k), rec = recorded(frame)
    assert counters(rec, "volumetrics.kernel") == [100 ** 3, 250 ** 2,
                                                   1000 ** 2]
    plain(monkeypatch)
    img_p, st_p = frame()
    assert_bit_equal(img_k, img_p)
    for field in ("radiance", "irradiance", "scattering"):
        assert_bit_equal(getattr(st_k, field), getattr(st_p, field))


@pytest.mark.cuda
def test_a_compiled_frame_launches_each_kernel_once(dev):
    """A captured 64x64 light_shafts frame launches each of the three
    kernels once a replay, and its replays equal eager frames bit for
    bit."""
    pipeline.clear_compiled()
    r = shafts(dev, 64, 64)
    r.render()
    assert {k: r.frame.launches[k] for k in KERNEL_NAMES} == dict.fromkeys(
        KERNEL_NAMES, 1)
    for _ in range(3):
        state = r.state
        img = r.render()
        with torch.no_grad(), pipeline.eager():
            want, want_state = pipeline.render_frame(
                r.spec, r.probes, r.volumetrics, r.width, r.height,
                r.scene_data, r.camera, state, screen_cfg=r.screen_cfg,
                probe_cfg=r.probe_cfg)
        assert_bit_equal(img, want)
        assert_bit_equal(r.state.scattering, want_state.scattering)
    pipeline.clear_compiled()
    assert math.isfinite(float(img.sum()))
