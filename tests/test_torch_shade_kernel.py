"""The shade as one CUDA kernel (ops/shade_kernel.py, csrc/shade.cu) and the
route that picks it (render/shading.py:shade_method).

On the CPU (tier-1): a frame takes the plain shade and launches nothing; a
shade whose position requires grad takes the plain route and carries the
gradient; the route's card conditions (geometry kernel, no gradient, modes
0 and 2, point and spot lights, not differentiable) one by one; the
wrapper's refusals; the packed light table, dynamic counts' dead slots
included.

On the card (marker ``cuda``; the file imports no JAX):

    python -m pytest --noconftest tests/test_torch_shade_kernel.py -q

the kernel against the plain chain (shade_hits and pixel_color's tail, on
the same geometry and lookups) on the screen and probe rays of the GI room,
light_shafts, the torus, simple_scene and ball_game, largest relative gap
PLAIN_REL; the edge cases (misses only, every shadow 0, ndotl at EPSILON,
a point on the spot's axis, metallic 0 and 1, roughness 0, 0.75 and 1, a
dead slot); 64x64 compiled frames by both routes.  A relative gap is the
largest absolute difference over the largest magnitude of the reference;
NaN (Cook-Torrance's 0/0 at roughness 0) must sit at the same places.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from madarch_tpu_torch.core.config import (PROBE_SHADE_CONFIG, ProbeSettings,
                                           ShadeConfig)
from madarch_tpu_torch.core.vecmath import EPSILON
from madarch_tpu_torch.examples import scenes as S
from madarch_tpu_torch.ops import march as M
from madarch_tpu_torch.ops import shade_kernel as SK
from madarch_tpu_torch.render import pipeline
from madarch_tpu_torch.render import probes as PR
from madarch_tpu_torch.render import shading as SH
from madarch_tpu_torch.render.camera import camera_rays, pixel_grid
from madarch_tpu_torch.render.context import SceneCtx
from madarch_tpu_torch.scene import lights as L
from madarch_tpu_torch.scene.scene import SceneSpec, tree_leaves, tree_map
from madarch_tpu_torch.utils import profiling

PLAIN_REL = 1e-6
# mean absolute gap of a tonemapped 64x64 frame, kernel route against the
# plain route
IMAGE_GAP = 1e-5
SMALL = ProbeSettings(radiance_resolution=4, irradiance_resolution=2)
TINY = ProbeSettings(radiance_resolution=8, irradiance_resolution=4)
# march steps of the GI room's passes where its rays have to end without a
# hit: the room is closed by planes
ROOM_STEPS = 6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def counted(rec, name):
    return sum(v for _, n, v in rec["counters"] if n == name)


def recorded(fn):
    """fn()'s result and the recorder's record of it."""
    profiling.drain()
    profiling.enable()
    try:
        out = fn()
    finally:
        profiling.disable()
    return out, profiling.drain()


def rel_gap(a, b):
    nan = torch.isnan(b)
    assert torch.equal(torch.isnan(a), nan)
    a, b = torch.where(nan, 0.0, a), torch.where(nan, 0.0, b)
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# The route, on the CPU
# ---------------------------------------------------------------------------

def test_a_cpu_frame_takes_the_plain_shade_and_launches_nothing():
    """A GI frame on the CPU: both passes' rays count under shade.plain,
    none under shade.kernel, and no kernel launches."""
    r = S.global_illumination(width=16, height=16, probes=SMALL,
                              device="cpu")
    before = M.launch_counts()
    _, rec = recorded(r.render)
    rays = SMALL.num_probes * SMALL.radiance_resolution ** 2
    assert counted(rec, "shade.plain") == rays + 16 * 16
    assert counted(rec, "shade.kernel") == 0
    assert M.launch_counts() == before


def test_a_shade_whose_position_requires_grad_takes_the_plain_route():
    """Ray origins requiring grad: pixel_color takes the plain chain (the
    rays count under shade.plain), launches nothing, and the colour's
    gradient reaches the origins."""
    r = S.global_illumination(width=8, height=8, probes=SMALL, device="cpu")
    cam = r.camera
    o, d = camera_rays(pixel_grid(8, 8, "cpu"), cam.position,
                       cam.orientation)
    o = o.reshape(-1, 3).clone().requires_grad_(True)
    d = d.reshape(-1, 3).contiguous()
    before = M.launch_counts()
    (color, hit, _), rec = recorded(lambda: SH.pixel_color(
        r.spec, r.scene_data, r.probes, r.screen_cfg, r.state.irradiance,
        r.state.radiance, o, d))
    assert counted(rec, "shade.plain") == 64
    assert counted(rec, "shade.kernel") == 0
    color.sum().backward()
    assert o.grad is not None and float(o.grad.abs().max()) > 0
    assert bool(hit.all())
    assert M.launch_counts() == before


def _route_case(case):
    """shade_method's arguments for ``case``, on the GI room whose tensors
    pass for a card's (the test patches Tensor.is_cuda)."""
    r = S.global_illumination(width=4, height=4, probes=SMALL, device="cpu")
    spec, data, cfg = r.spec, r.scene_data, r.screen_cfg
    o, d = torch.zeros((16, 3)), torch.ones((16, 3))
    irr, rad = r.state.irradiance, r.state.radiance
    geom = {}
    if case == "no_geometry_kernel":
        geom = None
    elif case == "origins_require_grad":
        o.requires_grad_(True)
    elif case == "material_requires_grad":
        data.materials["albedo"].requires_grad_(True)
    elif case == "light_requires_grad":
        data.lights["spot_light"]["position"].requires_grad_(True)
    elif case in ("mode_1", "mode_3"):
        cfg = ShadeConfig(indirect_specular_mode=int(case[-1]))
    elif case == "differentiable":
        cfg = ShadeConfig(differentiable=True)
    elif case == "user_light":
        lamp = L.make_light("lamp", L.PointLight.fields,
                            L.PointLight.sample, L.PointLight.position)
        spec = SceneSpec(prims=spec.prims, lights=((lamp, 1),))
    elif case == "probe_pass":
        cfg = PROBE_SHADE_CONFIG
    return spec, data, cfg, geom, o, d, irr, rad


@pytest.mark.parametrize("case,want", [
    ("screen_pass", "kernel"), ("probe_pass", "kernel"),
    ("no_geometry_kernel", "plain"), ("origins_require_grad", "plain"),
    ("material_requires_grad", "plain"), ("light_requires_grad", "plain"),
    ("mode_1", "plain"), ("mode_3", "plain"), ("differentiable", "plain"),
    ("user_light", "plain")])
def test_the_route_on_a_card(monkeypatch, case, want):
    """shade_method with tensors that report a card: the kernel for the
    screen pass (mode 2) and the probe pass (mode 0); the plain chain
    without the geometry kernel's outputs, where an input, a material or
    a light requires grad, in modes 1 and 3, for a differentiable config
    and for a make_light light type.  Each records its rays under the
    counter of its route."""
    args = _route_case(case)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda x: True),
                        raising=False)
    got, rec = recorded(lambda: SH.shade_method(*args))
    assert got == want
    assert counted(rec, f"shade.{want}") == 16
    assert counted(rec, "shade.plain" if want == "kernel"
                   else "shade.kernel") == 0


def test_no_gradient_to_pass_takes_the_kernel(monkeypatch):
    """Inputs that require grad under torch.no_grad(): no gradient has to
    pass, so the route is the kernel's."""
    args = _route_case("material_requires_grad")
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda x: True),
                        raising=False)
    with torch.no_grad():
        assert SH.shade_method(*args) == "kernel"


def test_a_cpu_frame_in_modes_1_and_3_records_the_plain_route():
    """GI at 8x8 in specular modes 1 and 3 on the CPU: every ray plain."""
    for mode in (1, 3):
        r = S.global_illumination(
            width=8, height=8, probes=SMALL, device="cpu",
            screen_cfg=ShadeConfig(indirect_specular_mode=mode))
        _, rec = recorded(r.render)
        rays = SMALL.num_probes * SMALL.radiance_resolution ** 2
        assert counted(rec, "shade.plain") == rays + 64
        assert counted(rec, "shade.kernel") == 0


# ---------------------------------------------------------------------------
# The wrapper's refusals and the light table, on the CPU
# ---------------------------------------------------------------------------

def _cpu_inputs(n=16):
    """The wrapper's arguments for n GI screen rays on the CPU."""
    r = S.global_illumination(width=4, height=4, probes=SMALL, device="cpu")
    cam = r.camera
    o, d = camera_rays(pixel_grid(4, 4, "cpu"), cam.position,
                       cam.orientation)
    o, d = o.reshape(-1, 3)[:n].contiguous(), d.reshape(-1, 3)[:n].contiguous()
    ctx = SceneCtx(r.spec, r.scene_data)
    geom = ctx.geometry(o, d, r.probes, r.screen_cfg, want_reflection=True)
    return dict(lights=ctx.light_table, materials=r.scene_data.materials,
                origins=o, dirs=d, geom=geom, irradiance=torch.zeros((n, 3)),
                radiance=torch.zeros((n, 3)))


def _shade(inputs, mode=2):
    return SK.shade(**inputs, mode=mode, direct_specular=True,
                    add_indirect_specular=True, max_dist=50.0,
                    surface_offset=0.01)


@pytest.mark.parametrize("fault,error,match", [
    ("none", ValueError, "cpu"),
    ("dtype", TypeError, "dtype"),
    ("shape", ValueError, "shape"),
    ("requires_grad", ValueError, "requires grad"),
    ("not_contiguous", ValueError, "contiguous"),
    ("mode", ValueError, "modes 0 and 2"),
    ("no_reflection", ValueError, "folded reflection")])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(fault, error,
                                                           match):
    """On the CPU every call raises before anything launches: a CPU tensor
    (each input well formed), a float64 origin, a short normal, an
    irradiance that requires grad, a transposed light table, specular mode
    1, mode 2 without the folded reflection."""
    x = _cpu_inputs()
    mode = 2
    if fault == "dtype":
        x["origins"] = x["origins"].double()
    elif fault == "shape":
        x["geom"] = dict(x["geom"], normal=x["geom"]["normal"][:-1])
    elif fault == "requires_grad":
        x["irradiance"] = x["irradiance"].requires_grad_(True)
    elif fault == "not_contiguous":
        x["lights"] = torch.zeros((SK.LIGHT_FLOATS, 2)).t()[:1]
    elif fault == "mode":
        mode = 1
    elif fault == "no_reflection":
        x["geom"] = dict(x["geom"], refl=None)
    before = M.launch_counts()
    with pytest.raises(error, match=match):
        _shade(x, mode)
    assert M.launch_counts() == before


def _table(r):
    return SK.pack_lights(r.spec, tree_map(torch.Tensor.detach,
                                           r.scene_data))


def test_the_light_table_of_static_counts():
    """GI's spot light and light_shafts' point light: one live slot each,
    the type code, the fields as the scene data holds them, padding 0."""
    gi = S.global_illumination(width=4, height=4, probes=SMALL, device="cpu")
    t = _table(gi)
    spot = gi.scene_data.lights["spot_light"]
    assert t.shape == (1, SK.LIGHT_FLOATS)
    assert t[0, :2].tolist() == [SK.LIGHT_CODES[L.SpotLight], 1.0]
    assert torch.equal(t[0, 2:5], spot["position"][0])
    assert torch.equal(t[0, 5:8], spot["color"][0])
    assert torch.equal(t[0, 8:11], spot["direction"][0])
    assert float(t[0, 11]) == float(spot["aperture"][0])
    assert not bool(t[0, 12:].any())
    ls = S.light_shafts(width=4, height=4, probes=SMALL, device="cpu")
    t = _table(ls)
    point = ls.scene_data.lights["point_light"]
    assert t.shape == (1, SK.LIGHT_FLOATS)
    assert t[0, :2].tolist() == [SK.LIGHT_CODES[L.PointLight], 1.0]
    assert torch.equal(t[0, 2:5], point["position"][0])
    assert torch.equal(t[0, 5:8], point["color"][0])
    assert not bool(t[0, 8:].any())


def test_the_light_table_holds_the_live_flags_of_dynamic_counts():
    """ball_game's spot lights are count-dynamic: 4 slots, the first live,
    three dead; the table has a row for each, in the geometry kernel's
    shadow order, and follows a count changed on the device."""
    r, _, _ = S.ball_game(width=4, height=4, probes=SMALL, device="cpu")
    t = _table(r)
    n = SceneCtx(r.spec, r.scene_data).n_light_slots
    assert t.shape == (n, SK.LIGHT_FLOATS) == (4, SK.LIGHT_FLOATS)
    assert t[:, 1].tolist() == [1.0, 0.0, 0.0, 0.0]
    assert t[:, 0].tolist() == [SK.LIGHT_CODES[L.SpotLight]] * 4
    r.scene_data.light_counts["spot_light"].fill_(3)
    assert _table(r)[:, 1].tolist() == [1.0, 1.0, 1.0, 0.0]


def test_a_user_light_type_has_no_light_table():
    lamp = L.make_light("lamp", L.PointLight.fields, L.PointLight.sample,
                        L.PointLight.position)
    r = S.global_illumination(width=4, height=4, probes=SMALL, device="cpu")
    spec = SceneSpec(prims=r.spec.prims, lights=((lamp, 1),))
    assert not SK.kernel_lights(spec)
    with pytest.raises(ValueError, match="lamp"):
        SK.pack_lights(spec, r.scene_data)


# ---------------------------------------------------------------------------
# The kernel against the plain chain, on the card
# ---------------------------------------------------------------------------

def plain_shade(r, cfg, o, d, geom, irr_atlas, rad_atlas):
    """pixel_color's plain chain after ``geom``: shade_hits, the sky and
    the hit position."""
    ctx = SceneCtx(r.spec, r.scene_data)
    pos = o + geom["t"][:, None] * d
    hit = geom["hit"]
    lit = SH.shade_hits(r.spec, r.scene_data, r.probes, cfg, ctx, irr_atlas,
                        rad_atlas, pos, geom["normal"], d, hit, geom)
    color = torch.where(hit[..., None], lit, SH.sky_color(d))
    hit_pos = torch.where(hit[..., None], pos, o + r.spec.max_dist * d)
    return color, hit_pos


def kernel_shade(r, cfg, o, d, geom, irr_atlas, rad_atlas):
    ctx = SceneCtx(r.spec, r.scene_data)
    before = M.launch_counts()["shade"]
    out = SH._shade_kernel(r.spec, r.scene_data, r.probes, cfg, ctx,
                           irr_atlas, rad_atlas, o, d, geom)
    assert M.launch_counts()["shade"] == before + 1
    return out


def hold(r, cfg, o, d, geom=None, irr_atlas=None, rad_atlas=None):
    """The kernel and the plain chain on the same geometry: colour and hit
    position within PLAIN_REL.  Returns the plain colour."""
    if geom is None:
        geom = SceneCtx(r.spec, r.scene_data).geometry(
            o, d, r.probes, cfg,
            want_reflection=cfg.indirect_specular_mode == 2)
    irr_atlas = r.state.irradiance if irr_atlas is None else irr_atlas
    rad_atlas = r.state.radiance if rad_atlas is None else rad_atlas
    with torch.no_grad():
        got = kernel_shade(r, cfg, o, d, geom, irr_atlas, rad_atlas)
        ref = plain_shade(r, cfg, o, d, geom, irr_atlas, rad_atlas)
    torch.cuda.synchronize()
    assert rel_gap(got[0], ref[0]) <= PLAIN_REL
    assert rel_gap(got[1], ref[1]) <= PLAIN_REL
    return ref[0]


def screen_rays(r, dev):
    cam = r.camera
    o, d = camera_rays(pixel_grid(r.width, r.height, dev), cam.position,
                       cam.orientation)
    return o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()


def probe_rays(r, dev):
    rr = r.probes.radiance_resolution
    o = PR.probe_world_positions(r.probes, dev).repeat(rr * rr, 1)
    d = PR.texel_directions(rr, dev).repeat_interleave(r.probes.num_probes,
                                                       dim=0)
    return o.contiguous(), d.contiguous()


def _scene(name, dev, size=128):
    kw = dict(width=size, height=size, device=dev)
    if name == "obj_mesh":
        return S.obj_mesh(obj_path=S.TORUS_OBJ, **kw)
    if name == "ball_game":
        r, _, throw = S.ball_game(**kw)
        throw((0.0, 2.0, 3.0), (1.0, 0.5, -1.0))
        return r
    return getattr(S, name)(**kw)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["global_illumination", "light_shafts",
                                   "obj_mesh", "simple_scene", "ball_game"])
def test_the_kernel_against_the_plain_chain_on_scene_rays(dev, scene):
    """Each scene at 128x128 after two frames: its screen rays (mode 2)
    and its probe rays (the probe pass's mode 0, no specular, no AO)."""
    r = _scene(scene, dev)
    r.converge(frames=2)
    for cfg, (o, d) in ((r.screen_cfg, screen_rays(r, dev)),
                        (r.probe_cfg, probe_rays(r, dev))):
        ref = hold(r, cfg, o, d)
        assert float(ref.abs().max()) > 0


def _gi_geometry(dev, size=64):
    r = S.global_illumination(width=size, height=size, device=dev)
    r.converge(frames=2)
    o, d = screen_rays(r, dev)
    g = SceneCtx(r.spec, r.scene_data).geometry(o, d, r.probes,
                                                r.screen_cfg,
                                                want_reflection=True)
    return r, o, d, g


@pytest.mark.cuda
def test_edge_cases_misses_and_shadows(dev):
    """Rays that all miss (the torus seen from outside, looking away),
    and GI's rays with every shadow factor 0 (the primary's and the
    reflection's)."""
    r = _scene("obj_mesh", dev, size=32)
    r.converge(frames=1)
    g = np.random.default_rng(1)
    d = torch.as_tensor(g.normal(size=(256, 3)), dtype=torch.float32)
    d[:, 1] = d[:, 1].abs() + 1.0
    d = torch.nn.functional.normalize(d, dim=-1).to(dev).contiguous()
    o = torch.tensor([0.0, 500.0, 0.0], device=dev).expand(256, 3)
    o = o.contiguous()
    g = SceneCtx(r.spec, r.scene_data).geometry(o, d, r.probes,
                                                r.screen_cfg,
                                                want_reflection=True)
    assert not bool(g["hit"].any())
    hold(r, r.screen_cfg, o, d, g)
    r, o, d, g = _gi_geometry(dev)
    g["shadows"] = torch.zeros_like(g["shadows"])
    g["refl"]["shadows"] = torch.zeros_like(g["refl"]["shadows"])
    hold(r, r.screen_cfg, o, d, g)


@pytest.mark.cuda
def test_edge_cases_at_the_light(dev):
    """Points whose ndotl to the spot light is EPSILON (normals tilted to
    it) and a ray hitting the spot's axis (cos theta 1): the points sit on
    GI's hits, the normals set so."""
    r, o, d, g = _gi_geometry(dev, size=32)
    hit = g["hit"]
    spot = r.scene_data.lights["spot_light"]
    lpos, ldirn = spot["position"][0], spot["direction"][0]
    pos = o + g["t"][:, None] * d
    to_l = torch.nn.functional.normalize(lpos - pos, dim=-1)
    # a unit normal with dot(n, to_l) = EPSILON: the light's direction
    # turned almost 90 degrees about a perpendicular axis
    perp = torch.nn.functional.normalize(
        torch.linalg.cross(to_l, torch.tensor([0.3, 1.0, 0.2], device=dev)
                           .expand_as(to_l)), dim=-1)
    side = torch.linalg.cross(perp, to_l)
    s = math.sqrt(1.0 - EPSILON ** 2)
    tilted = (to_l * EPSILON + side * s).contiguous()
    g["normal"] = torch.where(
        (torch.arange(hit.shape[0], device=dev) % 2 == 0)[:, None], tilted,
        g["normal"]).contiguous()
    hold(r, r.screen_cfg, o, d, g)
    # a ray from the light along its axis: the hit on the spot's axis
    o1 = lpos.expand(64, 3).contiguous()
    d1 = torch.nn.functional.normalize(ldirn, dim=0).expand(64, 3)
    d1 = d1.contiguous()
    hold(r, r.screen_cfg, o1, d1)


@pytest.mark.cuda
@pytest.mark.parametrize("metallic", [0.0, 1.0])
@pytest.mark.parametrize("roughness", [0.0, 0.75, 1.0])
def test_edge_cases_of_the_material(dev, metallic, roughness):
    """Every material metallic 0 or 1 and roughness 0, 0.75 (the mode-2
    gate's edge) or 1, on GI's screen rays: the geometry launch with the
    changed roughness, so the fold follows the gate."""
    r = S.global_illumination(width=64, height=64, device=dev)
    r.converge(frames=2)
    mats = r.scene_data.materials
    mats["metallic"].fill_(metallic)
    mats["roughness"].fill_(roughness)
    o, d = screen_rays(r, dev)
    hold(r, r.screen_cfg, o, d)


@pytest.mark.cuda
def test_edge_case_dead_slots(dev):
    """ball_game's three dead spot-light slots, each given the live
    slot's light in another colour: the kernel adds nothing of them, as
    the chain's where(live, ...), and all four once the count is 4."""
    r = _scene("ball_game", dev, size=64)
    r.converge(frames=2)
    spot = r.scene_data.lights["spot_light"]
    for field in spot.values():
        field[1:] = field[0]
    spot["color"][1:] = 5.0
    o, d = screen_rays(r, dev)
    with_dead = hold(r, r.screen_cfg, o, d)
    r.scene_data.light_counts["spot_light"].fill_(4)
    with_live = hold(r, r.screen_cfg, o, d)
    assert float((with_live - with_dead).abs().max()) > 0


# ---------------------------------------------------------------------------
# Frames by both routes
# ---------------------------------------------------------------------------

def _eager(r, state):
    with torch.no_grad():
        return pipeline.render_frame(
            r.spec, r.probes, r.volumetrics, r.width, r.height,
            r.scene_data, r.camera, state, screen_cfg=r.screen_cfg,
            probe_cfg=r.probe_cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["global_illumination", "obj_mesh",
                                   "light_shafts"])
def test_compiled_frames_by_both_routes(dev, scene, monkeypatch):
    """64x64 after two frames: the compiled frame (kernel route) bit-equal
    to its own eager frame, with a shade launch in each pass, and within
    IMAGE_GAP of the eager frame whose shade is plain."""
    pipeline.clear_compiled()
    r = _scene(scene, dev, size=64)
    r.converge(frames=2)
    state = r.state
    img = r.render()
    torch.cuda.synchronize()
    ref, ref_state = _eager(r, state)
    assert torch.equal(img, ref)
    assert r.frame.launches["shade"] == 2
    monkeypatch.setattr(SH, "shade_method", lambda *a: "plain")
    plain, plain_state = _eager(r, state)
    gap = (img - plain).abs()
    assert float(gap.mean()) <= IMAGE_GAP and math.isfinite(
        float(gap.max()))
    assert rel_gap(ref_state.radiance, plain_state.radiance) <= PLAIN_REL
    assert float(img.var()) > 0.0
    pipeline.clear_compiled()


def _scrambled(g, n_mats, moved):
    """Geometry outputs g with each bounce's material id moved, off its
    hits, to another of the n_mats ids (``moved`` gets how many were)."""
    def move(mid, hit):
        out = torch.where(hit, mid, (mid + 1) % n_mats)
        moved.append(int((out != mid).sum()))
        return out.contiguous()

    g = dict(g, mid=move(g["mid"], g["hit"]))
    if g["refl"] is not None:
        g["refl"] = dict(g["refl"], mid=move(g["refl"]["mid"],
                                             g["refl"]["hit"]))
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["global_illumination", "obj_mesh"])
def test_frames_ignore_the_material_of_non_hits(dev, scene, monkeypatch):
    """The geometry kernel gives material 0 on a bounce it does not
    classify (ops/march.py:geometry): an eager 64x64 frame of the kernel
    route whose every geometry launch has its non-hits' mid and r_mid
    moved to other ids is bit-equal to the frame as launched, image and
    state.  The torus's rays mostly miss; the GI room's march only
    ROOM_STEPS steps, so that some of its rays end without a hit."""
    r = _scene(scene, dev, size=64)
    r.converge(frames=2)
    cfgs = dict(screen_cfg=r.screen_cfg, probe_cfg=r.probe_cfg)
    if scene == "global_illumination":
        cfgs = {k: dataclasses.replace(c, max_march_steps=ROOM_STEPS)
                for k, c in cfgs.items()}

    def frame():
        with torch.no_grad():
            return pipeline.render_frame(
                r.spec, r.probes, r.volumetrics, r.width, r.height,
                r.scene_data, r.camera, r.state, **cfgs)

    before = M.launch_counts()["shade"]
    img, state = frame()
    assert M.launch_counts()["shade"] == before + 2
    geometry, moved = SceneCtx.geometry, []
    n_mats = r.scene_data.materials["roughness"].shape[0]
    assert n_mats >= 2
    monkeypatch.setattr(SceneCtx, "geometry", lambda *a, **kw: _scrambled(
        geometry(*a, **kw), n_mats, moved))
    img2, state2 = frame()
    torch.cuda.synchronize()
    assert len(moved) == 3 and all(moved)
    assert torch.equal(img, img2)
    for a, b in zip(tree_leaves(state), tree_leaves(state2)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_card_shade_whose_position_requires_grad_is_plain(dev):
    """On the card, origins requiring grad take the plain chain and the
    gradient arrives; the same rays without grad take the kernel."""
    r = S.global_illumination(width=16, height=16, probes=TINY, device=dev)
    o, d = screen_rays(r, dev)
    before = M.launch_counts()["shade"]
    og = o.clone().requires_grad_(True)
    (color, _, _), rec = recorded(lambda: SH.pixel_color(
        r.spec, r.scene_data, r.probes, r.screen_cfg, r.state.irradiance,
        r.state.radiance, og, d))
    color.sum().backward()
    assert counted(rec, "shade.plain") == 256
    assert M.launch_counts()["shade"] == before
    assert float(og.grad.abs().max()) > 0
    with torch.no_grad():
        (_, _, _), rec = recorded(lambda: SH.pixel_color(
            r.spec, r.scene_data, r.probes, r.screen_cfg,
            r.state.irradiance, r.state.radiance, o, d))
    assert counted(rec, "shade.kernel") == 256
    assert M.launch_counts()["shade"] == before + 1


@pytest.mark.cuda
def test_the_card_wrapper_refuses_another_device_and_launches_nothing(dev):
    """A CPU irradiance beside card tensors raises before the launch."""
    r, o, d, g = _gi_geometry(dev, size=16)
    ctx = SceneCtx(r.spec, r.scene_data)
    before = M.launch_counts()["shade"]
    n = o.shape[0]
    with pytest.raises(ValueError, match="cpu"):
        SK.shade(ctx.light_table, r.scene_data.materials, o, d, g,
                 torch.zeros((n, 3)), torch.zeros((n, 3), device=dev),
                 mode=2, direct_specular=True, add_indirect_specular=True,
                 max_dist=r.spec.max_dist, surface_offset=0.01)
    assert M.launch_counts()["shade"] == before
