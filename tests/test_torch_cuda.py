"""The CUDA kernels (geometry, raycast, visibility, softshadows) against
their plain PyTorch versions, on the card, on the room scenes and on
obj_mesh's 968-triangle torus (the chunk-pruned triangle path); the
geometry kernel at every lane count per ray its wrapper can choose, the
raycast, visibility and softshadow kernels in the build of the scene's
layout and in the generic build.

The frame compiled into a CUDA graph (render/pipeline.py:CompiledFrame)
is held bit for bit to the eager frame on GI, light_shafts and obj_mesh,
after a mutation too, and with the port's recorder on to the frame with
it off; the train step compiled into one (parallel/spmd.py:
CompiledStep) is held to eager steps on GI modes 2 and 1 and light_shafts
(chip_smoke.hold_step); a capture that fails must raise, the step's and
the frame's (last in the file).

Every test here needs a CUDA device (marker ``cuda``) and skips without
one.  The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

The kernels are built with -fmad=false and round like the plain versions,
so discrete outputs (hit, idx, mid, visibility) must be equal and
continuous ones agree to 1e-5 (t) and 1e-4 (the rest), on the lanes where
they are meaningful; penumbra factors agree to 1e-5 and are 0 (blocked)
on the same rays.
"""
import numpy as np
import pytest
import torch

from madarch_tpu_torch.core.config import ProbeSettings, ShadeConfig
from madarch_tpu_torch.core.vecmath import reflect
from madarch_tpu_torch.examples import large_scenes as LS
from madarch_tpu_torch.examples import scenes as S
from madarch_tpu_torch.ops import march as M
from madarch_tpu_torch.render import probes as PR
from madarch_tpu_torch.render import shading as SH
from madarch_tpu_torch.render.camera import camera_rays, pixel_grid
from madarch_tpu_torch.render.context import SceneCtx
from madarch_tpu_torch.render.raymarch import SURFACE_OFFSET
from madarch_tpu_torch.scene import lights as L
from madarch_tpu_torch.scene import primitives as P
from madarch_tpu_torch.scene.scene import (SceneBuilder, SceneSpec,
                                           material_lookup)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _gi_rays(r, dev, variant, n=4096):
    g = torch.Generator().manual_seed(7)
    if variant == "radiance":
        rr = r.probes.radiance_resolution
        o = PR.probe_world_positions(r.probes, dev).repeat(rr * rr, 1)
        d = PR.texel_directions(rr, dev).repeat_interleave(
            r.probes.num_probes, dim=0)
    else:
        cam = r.camera
        o, d = camera_rays(pixel_grid(r.width, r.height, dev), cam.position,
                           cam.orientation)
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    ids = torch.randperm(o.shape[0], generator=g)[:n].to(dev)
    return o[ids].contiguous(), d[ids].contiguous()


def _dynamic_scene(dev):
    """Capacity > live count on every type (dead slots flagged) and two
    point lights: the packing paths the specialised GI scene skips."""
    spec = SceneSpec(prims=((P.Sphere, 4), (P.Plane, 6), (P.Box, 4)),
                     lights=((L.PointLight, 2),))
    b = SceneBuilder(spec)
    b.add_material((0.5, 0.5, 0.5), 0.0, 0.5)
    b.add_material((0.9, 0.9, 0.9), 1.0, 0.1)
    b.add_primitive(P.Sphere, center=(0.0, 0.0, 5.0), radius=1.0,
                    material_id=1)
    b.add_primitive(P.Sphere, center=(2.0, 1.0, 7.0), radius=0.7,
                    material_id=0)
    b.add_primitive(P.Plane, normal=(0.0, 1.0, 0.0), offset=1.0,
                    material_id=0)
    b.add_primitive(P.Box, center=(-2.0, 0.0, 6.0), side=(1.0, 1.0, 1.0),
                    material_id=1)
    b.add_light(L.PointLight, position=(0.0, 5.0, 3.0), color=(1.0,) * 3)
    b.add_light(L.PointLight, position=(-3.0, 4.0, 8.0), color=(1.0,) * 3)
    return spec, b.device_data(dev)


def _assert_match(k, r):
    for key in ("hit", "idx", "mid"):
        assert torch.equal(k[key], r[key]), key
    hit = r["hit"]
    torch.testing.assert_close(k["t"], r["t"], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(k["normal"][hit], r["normal"][hit],
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(k["ao"][hit], r["ao"][hit], rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(k["shadows"][:, hit], r["shadows"][:, hit],
                               rtol=0, atol=1e-4)
    assert torch.equal(k["vis8"][:, hit], r["vis8"][:, hit])
    if r["refl"] is None:
        assert k["refl"] is None
        return
    kr, rr = k["refl"], r["refl"]
    rhit = rr["hit"]
    assert torch.equal(kr["hit"], rhit)
    for key in ("mid", "best_pid"):
        assert torch.equal(kr[key][rhit], rr[key][rhit]), key
    torch.testing.assert_close(kr["t"], rr["t"], rtol=1e-5, atol=1e-5)
    for key in ("normal", "best_dir"):
        torch.testing.assert_close(kr[key][rhit], rr[key][rhit], rtol=0,
                                   atol=1e-4)
    torch.testing.assert_close(kr["shadows"][:, rhit], rr["shadows"][:, rhit],
                               rtol=0, atol=1e-4)
    assert torch.equal(kr["vis8"][:, rhit], rr["vis8"][:, rhit])


def _both(spec, data, o, d, refl, ao_steps, grid, lanes=None, enabled=None,
          **flags):
    """(kernel, plain version) on the same rays; ``lanes``: the kernel
    built for that many lanes per ray in place of the wrapper's choice;
    ``flags``: want_shadows / want_vis for both."""
    packed = M.pack_scene(spec, data)
    lpos, n_lights = M.pack_light_positions(spec, data)
    kw = dict(probe_spacing=grid.grid_spacing,
              probe_dims=grid.grid_dimensions,
              surface_offset=SURFACE_OFFSET, ao_steps=ao_steps,
              mat_rough_vec=data.materials["roughness"] if refl else None,
              enabled=enabled, **flags)
    before = M.geometry.launches
    k = M.geometry(packed, lpos, n_lights, o, d, spec.max_dist,
                   library=lanes and M.geometry_library(lanes), **kw)
    torch.cuda.synchronize()
    assert M.geometry.launches == before + 1
    r = M.geometry_reference(packed, lpos, n_lights, o, d, spec.max_dist,
                             **kw)
    return k, r


@pytest.mark.parametrize("variant", ["radiance", "screen"])
def test_kernel_matches_plain_version_on_gi(dev, variant):
    r = S.global_illumination(width=256, height=256, device=dev)
    o, d = _gi_rays(r, dev, variant)
    refl = variant == "screen"
    k, ref = _both(r.spec, r.scene_data, o, d, refl, 3 if refl else 0,
                   r.probes)
    assert ref["hit"].float().mean() > 0.5
    _assert_match(k, ref)


def test_kernel_matches_plain_version_with_dead_slots(dev):
    spec, data = _dynamic_scene(dev)
    g = torch.Generator().manual_seed(11)
    o = torch.rand(4096, 3, generator=g) * 2.0 - 1.0
    o[:, 1] += 1.0
    d = torch.randn(4096, 3, generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    o, d = o.to(dev), d.to(dev)
    packed = M.pack_scene(spec, data)
    assert (~M.slot_live(packed)).sum() == 10
    k, ref = _both(spec, data, o, d, True, 3, ProbeSettings())
    assert k["shadows"].shape == (2, 4096)
    _assert_match(k, ref)


def test_kernel_skips_reflection_shadows(dev):
    """refl_shadows=False (a screen config without add_indirect_specular)
    leaves the reflection's shadows at one."""
    r = S.global_illumination(width=64, height=64, device=dev)
    o, d = _gi_rays(r, dev, "screen", n=1024)
    packed = M.pack_scene(r.spec, r.scene_data)
    lpos, n_lights = M.pack_light_positions(r.spec, r.scene_data)
    kw = dict(probe_spacing=r.probes.grid_spacing,
              probe_dims=r.probes.grid_dimensions,
              surface_offset=SURFACE_OFFSET, ao_steps=3,
              mat_rough_vec=r.scene_data.materials["roughness"],
              refl_shadows=False)
    k = M.geometry(packed, lpos, n_lights, o, d, r.spec.max_dist, **kw)
    ref = M.geometry_reference(packed, lpos, n_lights, o, d,
                               r.spec.max_dist, **kw)
    assert (k["refl"]["shadows"] == 1).all()
    _assert_match(k, ref)


# ---------------------------------------------------------------------------
# The raycast and visibility kernels (csrc/march.cu)
# ---------------------------------------------------------------------------

def _light_shafts_rays(dev, n=8192):
    """Seeded subsets of light_shafts' scattering rays (to max_depth) and
    froxel-to-light rays of its point light, with the scene."""
    r = S.light_shafts(width=64, height=64, device=dev)
    vol = r.volumetrics
    cam = r.camera
    g = torch.Generator().manual_seed(13)
    sx, sy = vol.scattering_resolution
    o, d = camera_rays(pixel_grid(sx, sy, dev), cam.position,
                       cam.orientation)
    ids = torch.randperm(sx * sy, generator=g)[:n].to(dev)
    scat = (o.reshape(-1, 3)[ids].contiguous(),
            d.reshape(-1, 3)[ids].contiguous())
    vx, vy, vz = vol.visibility_resolution
    fo, fd = camera_rays(pixel_grid(vx, vy, dev), cam.position,
                         cam.orientation)
    pix = torch.randint(0, vx * vy, (n,), generator=g).to(dev)
    depth = torch.randint(0, vz, (n,), generator=g).to(dev).float() \
        * vol.visibility_step_size
    pts = fo.reshape(-1, 3)[pix] + fd.reshape(-1, 3)[pix] * depth[:, None]
    params = {k: v[0] for k, v in r.scene_data.lights["point_light"].items()}
    _, ldir, ldist = L.PointLight.sample(params, pts, torch.zeros_like(pts))
    return r, scat, (pts.contiguous(), ldir.contiguous(),
                     ldist.contiguous())


def _check_raycast(packed, o, d, max_dist, en):
    before = M.raycast.launches
    kt, khit, kpos = M.raycast(packed, o, d, max_dist, enabled=en)
    torch.cuda.synchronize()
    assert M.raycast.launches == before + 1
    rt, rhit, rpos = M.raycast_reference(packed, o, d, max_dist, enabled=en)
    assert torch.equal(khit, rhit)
    torch.testing.assert_close(kt, rt, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kpos, rpos, rtol=1e-5, atol=1e-5)
    return rhit


def _check_visibility(packed, o, d, mx, en):
    before = M.visibility.launches
    kv = M.visibility(packed, o, d, mx, enabled=en)
    torch.cuda.synchronize()
    assert M.visibility.launches == before + 1
    rv = M.visibility_reference(packed, o, d, mx, enabled=en)
    assert torch.equal(kv, rv)
    return rv


def test_raycast_and_visibility_match_plain_on_light_shafts(dev):
    r, (o, d), (pts, ldir, ldist) = _light_shafts_rays(dev)
    packed = M.pack_scene(r.spec, r.scene_data)
    max_depth = r.volumetrics.max_depth
    en = torch.rand(o.shape[0], generator=torch.Generator().manual_seed(3)
                    ) > 0.2
    assert _check_raycast(packed, o, d, max_depth, None).float().mean() > 0.5
    _check_raycast(packed, o, d, max_depth, en.to(dev))
    ldist[:64] = 0.0
    vis = _check_visibility(packed, pts, ldir, ldist, None)
    assert 0.0 < vis.mean() < 1.0
    _check_visibility(packed, pts, ldir, ldist, en.to(dev))


def test_raycast_and_visibility_match_plain_with_dead_slots(dev):
    spec, data = _dynamic_scene(dev)
    packed = M.pack_scene(spec, data)
    g = torch.Generator().manual_seed(17)
    o = torch.rand(8192, 3, generator=g) * 2.0 - 1.0
    o[:, 1] += 1.0
    d = torch.randn(8192, 3, generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    mx = torch.rand(8192, generator=g) * 31.0 - 1.0
    en = torch.rand(8192, generator=g) > 0.2
    o, d, mx, en = o.to(dev), d.to(dev), mx.to(dev), en.to(dev)
    _check_raycast(packed, o, d, 10.0, en)
    _check_visibility(packed, o, d, mx, en)


def test_visibility_tail_block_at_a_million_rays(dev):
    """The froxel pass's launch size: 7,813 blocks of 128 threads, the
    last one holding 64 rays: every one of the 1,000,000 outputs equals
    the plain version's."""
    r, _, (pts, ldir, ldist) = _light_shafts_rays(dev, n=4096)
    packed = M.pack_scene(r.spec, r.scene_data)
    n = 1_000_000
    reps = -(-n // pts.shape[0])
    o = pts.repeat(reps, 1)[:n].contiguous()
    d = ldir.repeat(reps, 1)[:n].contiguous()
    mx = ldist.repeat(reps)[:n].contiguous()
    v = M.visibility(packed, o, d, mx)
    torch.cuda.synchronize()
    ref = M.visibility_reference(packed, pts, ldir, ldist)
    assert torch.equal(v, ref.repeat(reps)[:n])


# ---------------------------------------------------------------------------
# Specular modes 1 and 3: the softshadow kernel and the masked geometry
# launch
# ---------------------------------------------------------------------------

def _reflection_rays(r, dev, n=4096):
    """Seeded GI screen rays' reflection rays, as specular modes 1 and 3
    cast them: (primary hit points, origins off the surface, reflected
    directions, the roughness < 0.75 gate)."""
    o, d = _gi_rays(r, dev, "screen", n=n)
    packed = M.pack_scene(r.spec, r.scene_data)
    lpos, n_lights = M.pack_light_positions(r.spec, r.scene_data)
    g = M.geometry_reference(packed, lpos, n_lights, o, d, r.spec.max_dist,
                             probe_spacing=r.probes.grid_spacing,
                             probe_dims=r.probes.grid_dimensions,
                             surface_offset=SURFACE_OFFSET, ao_steps=3)
    pos = o + g["t"][:, None] * d
    _, _, rough = material_lookup(r.scene_data, g["mid"])
    return (pos, (pos + g["normal"] * SURFACE_OFFSET).contiguous(),
            reflect(d, g["normal"]).contiguous(), g["hit"] & (rough < 0.75))


def _check_softshadows(packed, rays, k):
    before = M.softshadows.launches
    args = (packed, rays["origins"], rays["dirs"], rays["min_dists"],
            rays["max_dists"], k)
    ks = M.softshadows(*args, enabled=rays["enabled"])
    torch.cuda.synchronize()
    assert M.softshadows.launches == before + 1
    rs = M.softshadows_reference(*args, enabled=rays["enabled"])
    assert torch.equal(ks == 0, rs == 0)
    torch.testing.assert_close(ks, rs, rtol=0, atol=1e-5)
    return rs


def test_softshadows_match_plain_on_gi_mode1_rays(dev):
    """The mode-1 penumbra rays (k = 0.5, from 0.25 to the corner's
    distance less 0.25) of 4,096 GI screen rays: 32,768 rays, with a
    quarter of them disabled on top of the path's own mask."""
    r = S.global_illumination(width=256, height=256, device=dev)
    packed = M.pack_scene(r.spec, r.scene_data)
    pos, ro, rd, en = _reflection_rays(r, dev)
    _, hit, spec_pos = M.raycast(packed, ro, rd, r.spec.max_dist,
                                 enabled=en)
    rays = SH.glossy_corners(r.probes, pos, spec_pos, en & hit)[3]
    g = torch.Generator().manual_seed(19)
    rays["enabled"] = rays["enabled"] & (
        torch.rand(rays["enabled"].shape[0], generator=g) > 0.25).to(dev)
    res = _check_softshadows(packed, rays, SH.GLOSSY_K)
    on = rays["enabled"]
    assert (res[~on] == 1).all()
    assert (res[on] == 0).any() and ((res[on] > 0) & (res[on] < 1)).any()


def test_softshadows_match_plain_with_dead_slots(dev):
    """Dead slots read as the 1e4 cap; k = 64 and 0.5; min dists up to 1,
    max dists from -1 to 30, and max == min on some rays (never marched)."""
    spec, data = _dynamic_scene(dev)
    packed = M.pack_scene(spec, data)
    g = torch.Generator().manual_seed(23)
    n = 8192
    o = torch.rand(n, 3, generator=g) * 2.0 - 1.0
    o[:, 1] += 1.0
    d = torch.randn(n, 3, generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    mn = torch.rand(n, generator=g)
    mx = torch.rand(n, generator=g) * 31.0 - 1.0
    mx[:64] = mn[:64]
    rays = {"origins": o, "dirs": d, "min_dists": mn, "max_dists": mx,
            "enabled": torch.rand(n, generator=g) > 0.2}
    rays = {key: v.to(dev) for key, v in rays.items()}
    for k in (64.0, 0.5):
        res = _check_softshadows(packed, rays, k)
        never = ~rays["enabled"] | (mn.to(dev) >= mx.to(dev))
        assert (res[never] == 1).all()


def test_softshadows_tail_block_beyond_a_million_rays(dev):
    """A launch of 1,000,037 rays: 7,813 blocks of 128 threads, the last
    holding 5 rays; every output equals the plain version's on the rays it
    repeats."""
    r = S.global_illumination(width=128, height=128, device=dev)
    packed = M.pack_scene(r.spec, r.scene_data)
    pos, ro, rd, en = _reflection_rays(r, dev, n=2048)
    _, hit, spec_pos = M.raycast(packed, ro, rd, r.spec.max_dist,
                                 enabled=en)
    rays = SH.glossy_corners(r.probes, pos, spec_pos, en & hit)[3]
    n = 1_000_037
    reps = -(-n // rays["origins"].shape[0])
    big = {key: (v.repeat(reps, 1) if v.ndim == 2 else v.repeat(reps))[:n]
           .contiguous() for key, v in rays.items()}
    res = M.softshadows(packed, big["origins"], big["dirs"],
                        big["min_dists"], big["max_dists"], SH.GLOSSY_K,
                        enabled=big["enabled"])
    torch.cuda.synchronize()
    ref = M.softshadows_reference(packed, rays["origins"], rays["dirs"],
                                  rays["min_dists"], rays["max_dists"],
                                  SH.GLOSSY_K, enabled=rays["enabled"])
    torch.testing.assert_close(res, ref.repeat(reps)[:n], rtol=0, atol=1e-5)


def test_masked_geometry_matches_plain_on_gi_reflections(dev):
    """Specular mode 3's reflection launch: the mask (the roughness gate,
    and a quarter more rays disabled) and no AO.  Disabled rays stay at
    t = 0 and are no hits."""
    r = S.global_illumination(width=256, height=256, device=dev)
    _, ro, rd, en = _reflection_rays(r, dev)
    g = torch.Generator().manual_seed(29)
    en = en & (torch.rand(en.shape[0], generator=g) > 0.25).to(dev)
    packed = M.pack_scene(r.spec, r.scene_data)
    lpos, n_lights = M.pack_light_positions(r.spec, r.scene_data)
    kw = dict(probe_spacing=r.probes.grid_spacing,
              probe_dims=r.probes.grid_dimensions,
              surface_offset=SURFACE_OFFSET, ao_steps=0, enabled=en)
    before = M.geometry.launches
    k = M.geometry(packed, lpos, n_lights, ro, rd, r.spec.max_dist, **kw)
    torch.cuda.synchronize()
    assert M.geometry.launches == before + 1
    ref = M.geometry_reference(packed, lpos, n_lights, ro, rd,
                               r.spec.max_dist, **kw)
    _assert_match(k, ref)
    assert (k["t"][~en] == 0).all() and not k["hit"][~en].any()
    assert (k["ao"] == 1).all() and ref["hit"].float().mean() > 0.5


def test_modes_1_and_3_launch_their_kernels(dev):
    """64² frames per mode through Renderer.render(): a frame of mode 1
    launches the geometry kernel twice (radiance, screen), the raycast and
    the softshadow kernel once; mode 3 the geometry kernel three times.
    Both look the irradiance up with the kernel in the radiance pass and
    the screen pass, mode 3 once more at the reflection hit; neither reads
    mode 2's radiance tile.  The first frame runs the eager warm-up and the
    replay of its capture: twice a frame's launches."""
    from madarch_tpu_torch.render import pipeline
    pipeline.clear_compiled()    # an earlier test may have these keys
    want = {1: (2, 1, 1), 3: (3, 0, 0)}
    lookups = {1: (2, 0), 3: (3, 0)}
    for mode, launches in want.items():
        r = S.global_illumination(
            width=64, height=64, device=dev,
            screen_cfg=ShadeConfig(indirect_specular_mode=mode))
        fns = (M.geometry, M.raycast, M.softshadows)
        for frame in (2, 1):
            before = [f.launches for f in fns]
            img = r.render()
            torch.cuda.synchronize()
            assert tuple(f.launches - b for f, b in zip(fns, before)) \
                == tuple(frame * n for n in launches)
        assert r.frame.launches == dict(zip(
            ("geometry", "raycast", "softshadows", "visibility",
             "irradiance_lookup", "radiance_lookup"),
            launches + (0,) + lookups[mode]))
        assert torch.isfinite(img).all()


# ---------------------------------------------------------------------------
# Triangles: the chunk-pruned triangle path of every kernel (obj_mesh)
# ---------------------------------------------------------------------------

def _mesh_scene(dev, n_live=None, capacity=1000):
    """obj_mesh's torus (968 triangles) on the card; with n_live, the
    spec keeps its capacity and only the first n_live triangles are live
    (dynamic counts: dead slots in the table)."""
    r = S.obj_mesh(width=64, height=64, obj_path=S.TORUS_OBJ,
                   triangle_capacity=capacity, device=dev)
    spec, data = r.spec, r.scene_data
    if n_live is not None:
        spec = SceneSpec(prims=spec.prims, lights=spec.lights,
                         max_dist=spec.max_dist)
        data.prim_counts["triangle"] = torch.tensor(n_live,
                                                    dtype=torch.int32,
                                                    device=dev)
    return r, spec, data


def _mesh_rays(r, dev, n=4096, seed=31):
    """Seeded rays from the camera and the probe positions toward points
    in the torus's bounding box (most hit), and camera rays."""
    g = torch.Generator().manual_seed(seed)
    v = r.scene_data.prims["triangle"]["v1"][:968].cpu()
    lo, hi = v.amin(0), v.amax(0)
    starts = torch.cat([torch.as_tensor(r.camera_position)[None],
                        PR.probe_world_positions(r.probes, "cpu")])
    o = starts[torch.randint(0, starts.shape[0], (n,), generator=g)]
    o[: n // 2] = torch.as_tensor(r.camera_position)
    d = lo + torch.rand(n, 3, generator=g) * (hi - lo) - o
    d = d / d.norm(dim=1, keepdim=True)
    return o.to(dev).contiguous(), d.to(dev).contiguous()


@pytest.mark.parametrize("refl", [False, True])
def test_geometry_matches_plain_on_the_mesh(dev, refl):
    """968 triangles: a 108,416-byte table, beyond the 48 KiB of shared
    memory a launch gets, read from device memory; 4,097 rays (a tail
    block of one ray)."""
    r, spec, data = _mesh_scene(dev)
    o, d = _mesh_rays(r, dev, n=4097)
    packed = M.pack_scene(spec, data)
    assert packed.chunks.numel() * 4 > 48 * 1024 and packed.n_chunks == 121
    k, ref = _both(spec, data, o, d, refl, 3 if refl else 0, r.probes)
    assert ref["hit"].float().mean() > 0.5
    _assert_match(k, ref)


@pytest.mark.parametrize("flags", [
    {"want_shadows": False}, {"want_vis": False},
    {"want_shadows": False, "want_vis": False}],
    ids=["no-shadows", "no-vis", "neither"])
@pytest.mark.parametrize("case", ["gi-radiance", "gi-screen", "mesh-screen"])
def test_kernel_matches_plain_with_marches_off(dev, case, flags):
    """want_shadows / want_vis False: the kernel skips the primary hit's
    penumbra / probe-visibility marches as its plain version does, both
    give ones there, and every other output is the flags-on launch's bit
    for bit."""
    scene, variant = case.split("-")
    refl = variant == "screen"
    if scene == "gi":
        r = S.global_illumination(width=256, height=256, device=dev)
        spec, data = r.spec, r.scene_data
        o, d = _gi_rays(r, dev, variant)
    else:
        r, spec, data = _mesh_scene(dev)
        o, d = _mesh_rays(r, dev)
    ao = 3 if refl else 0
    k, ref = _both(spec, data, o, d, refl, ao, r.probes, **flags)
    _assert_match(k, ref)
    on = _both(spec, data, o, d, refl, ao, r.probes)[0]
    for key, want in (("shadows", "want_shadows"), ("vis8", "want_vis")):
        if not flags.get(want, True):
            assert bool((k[key] == 1).all()) and bool((ref[key] == 1).all())
            on.pop(key)
    k_refl, on_refl = k.pop("refl"), on.pop("refl")
    for key, val in on.items():
        assert torch.equal(k[key], val), key
    if refl:
        for key, val in on_refl.items():
            assert torch.equal(k_refl[key], val), key


def test_geometry_matches_plain_with_dead_triangle_slots(dev):
    """Capacity 1000 and 700 live triangles (dynamic counts): dead slots
    never win, their chunks' boxes are inert."""
    r, spec, data = _mesh_scene(dev, n_live=700)
    o, d = _mesh_rays(r, dev, seed=37)
    packed = M.pack_scene(spec, data)
    assert packed.n_chunks == 125
    assert int((packed.chunk_live == 0).sum()) == 300
    k, ref = _both(spec, data, o, d, True, 3, r.probes)
    assert ref["hit"].float().mean() > 0.3
    _assert_match(k, ref)


def test_march_kernels_match_plain_on_the_mesh(dev):
    """The raycast, visibility and softshadow kernels take triangles
    through the same scene evaluation: held to their plain versions on
    mesh rays, penumbras at k = 64 and 0.5 out to 20."""
    for n_live in (None, 700):
        r, spec, data = _mesh_scene(dev, n_live=n_live)
        packed = M.pack_scene(spec, data)
        o, d = _mesh_rays(r, dev, n=8195, seed=41)
        g = torch.Generator().manual_seed(43)
        en = (torch.rand(o.shape[0], generator=g) > 0.2).to(dev)
        mx = (torch.rand(o.shape[0], generator=g) * 21.0 - 1.0).to(dev)
        mn = (torch.rand(o.shape[0], generator=g) * 0.5).to(dev)
        assert _check_raycast(packed, o, d, spec.max_dist, None) \
            .float().mean() > 0.3
        _check_raycast(packed, o, d, spec.max_dist, en)
        vis = _check_visibility(packed, o, d, mx, en)
        assert 0.0 < vis.mean() < 1.0
        for k in (64.0, 0.5):
            res = _check_softshadows(packed, {
                "origins": o, "dirs": d, "min_dists": mn, "max_dists": mx,
                "enabled": en}, k)
            assert (res == 0).any()


def test_obj_mesh_frame_launches_the_kernel(dev):
    """64² obj_mesh frames through Renderer.render(): two geometry
    launches a frame (radiance, screen; the first frame's warm-up two
    more) and a finite image."""
    from madarch_tpu_torch.render import pipeline
    pipeline.clear_compiled()    # an earlier test may have this key
    r = S.obj_mesh(width=64, height=64, obj_path=S.TORUS_OBJ, device=dev)
    for frame in (2, 1):
        before = M.geometry.launches
        img = r.render()
        torch.cuda.synchronize()
        assert M.geometry.launches - before == 2 * frame
    assert torch.isfinite(img).all() and img.var() > 0


def _camera_rays(r, dev):
    """Renderer r's camera rays: on the torus most of them miss."""
    cam = r.camera
    o, d = camera_rays(pixel_grid(r.width, r.height, dev), cam.position,
                       cam.orientation)
    return o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()


@pytest.mark.parametrize("lanes", M.LANE_CHOICES)
@pytest.mark.parametrize("masked", [False, True])
def test_box_cap_geometry_matches_plain_on_camera_rays(dev, lanes, masked):
    """The torus packs a box-exit cap: on its camera rays (most miss) the
    capped kernel equals the capped plain version, every miss of the
    primary and the reflection at t = max_dist, and with box_cap=False
    both march on to max_dist as before; hits the same either way."""
    r, spec, data = _mesh_scene(dev)
    o, d = _camera_rays(r, dev)
    en = (torch.rand(o.shape[0], generator=torch.Generator().manual_seed(5))
          > 0.3).to(dev) if masked else None
    packed = M.pack_scene(spec, data)
    assert packed.cap_margin == M.FAR_MARGIN
    k, ref = _both(spec, data, o, d, True, 3, r.probes, lanes=lanes,
                   enabled=en)
    _assert_match(k, ref)
    hit = k["hit"]
    assert 0 < int(hit.sum()) < hit.numel() // 2
    live = torch.ones_like(hit) if en is None else en
    assert bool((k["t"][live & ~hit] == spec.max_dist).all())
    assert bool((k["t"][~live] == 0).all())
    kw = dict(probe_spacing=r.probes.grid_spacing,
              probe_dims=r.probes.grid_dimensions,
              surface_offset=SURFACE_OFFSET, ao_steps=3,
              mat_rough_vec=data.materials["roughness"], enabled=en)
    lpos, n_lights = M.pack_light_positions(spec, data)
    k_off = M.geometry(packed, lpos, n_lights, o, d, spec.max_dist,
                       library=M.geometry_library(lanes), box_cap=False,
                       **kw)
    _assert_match(k_off, M.geometry_reference(
        M.without_box_cap(packed), lpos, n_lights, o, d, spec.max_dist,
        **kw))
    assert torch.equal(k_off["hit"], hit)
    assert torch.equal(k_off["t"][hit], k["t"][hit])
    assert bool((k_off["t"][live & ~hit] > spec.max_dist).all())


def _bounded_slots(dev, n_spheres, n_boxes):
    """Spheres and boxes only, each type of more than 8 slots: an
    all-bounded scene without triangles, scattered around (0, 1.5, 5)."""
    prims = tuple((pt, n) for pt, n in ((P.Sphere, n_spheres),
                                        (P.Box, n_boxes)) if n)
    spec = SceneSpec(prims=prims, lights=((L.PointLight, 1),),
                     max_dist=20.0)
    b = SceneBuilder(spec)
    b.add_material((0.5, 0.5, 0.5), 0.0, 0.2)
    rng = np.random.RandomState(11)
    for pt, n in prims:
        for _ in range(n):
            c = tuple(rng.uniform(-2.0, 2.0, 3) + (0.0, 1.5, 5.0))
            if pt is P.Sphere:
                b.add_primitive(pt, center=c, radius=rng.uniform(0.1, 0.4),
                                material_id=0)
            else:
                b.add_primitive(pt, center=c,
                                side=tuple(rng.uniform(0.1, 0.4, 3)),
                                material_id=0)
    b.add_light(L.PointLight, position=(0.0, 5.0, 3.0), color=(1.0,) * 3)
    return spec, b.device_data(dev)


@pytest.mark.parametrize("lanes", M.LANE_CHOICES)
@pytest.mark.parametrize("counts", [(12, 0), (20, 12)])
def test_box_cap_without_triangles_matches_plain(dev, lanes, counts):
    """An all-bounded scene of spheres (12: raycast and visibility in the
    build of its layout) or of spheres and boxes (the generic build; two
    cap boxes): each kernel capped equals its capped plain version, a
    capped miss at t = max_dist."""
    spec, data = _bounded_slots(dev, *counts)
    packed = M.pack_scene(spec, data)
    assert packed.cap_boxes.shape == (len([c for c in counts if c]), 6)
    assert (M.march_layout(packed) is not None) == (counts == (12, 0))
    g = torch.Generator().manual_seed(13)
    o = (torch.rand(4099, 3, generator=g) * 8.0 - 4.0
         + torch.tensor([0.0, 1.5, 5.0])).to(dev)
    d = torch.randn(4099, 3, generator=g).to(dev)
    d = (d / d.norm(dim=1, keepdim=True)).contiguous()
    grid = ProbeSettings(grid_dimensions=(3, 3, 4),
                         grid_spacing=(2.0, 3.0, 3.0))
    k, ref = _both(spec, data, o, d, True, 3, grid, lanes=lanes)
    _assert_match(k, ref)
    hit = k["hit"]
    assert 0 < int(hit.sum()) < hit.numel()
    assert bool((k["t"][~hit] == spec.max_dist).any())
    kt, khit, _ = M.raycast(packed, o, d, spec.max_dist)
    rt, rhit, _ = M.raycast_reference(packed, o, d, spec.max_dist)
    assert torch.equal(khit, rhit)
    torch.testing.assert_close(kt, rt, rtol=1e-5, atol=1e-5)
    mx = torch.full((o.shape[0],), spec.max_dist, device=dev)
    assert torch.equal(M.visibility(packed, o, d, mx),
                       M.visibility_reference(packed, o, d, mx))


def test_box_cap_march_kernels_match_plain_on_camera_rays(dev):
    """raycast and visibility end at the torus's box, capped and with
    box_cap=False, each equal to its plain version; a capped raycast miss
    at t = max_dist."""
    r, spec, data = _mesh_scene(dev)
    packed = M.pack_scene(spec, data)
    o, d = _camera_rays(r, dev)
    mx = torch.full((o.shape[0],), spec.max_dist, device=dev)
    for cap in (True, False):
        plain = packed if cap else M.without_box_cap(packed)
        kt, khit, _ = M.raycast(packed, o, d, spec.max_dist, box_cap=cap)
        rt, rhit, _ = M.raycast_reference(plain, o, d, spec.max_dist)
        assert torch.equal(khit, rhit)
        torch.testing.assert_close(kt, rt, rtol=1e-5, atol=1e-5)
        assert bool((kt[~khit] == spec.max_dist).all()) == cap
        kv = M.visibility(packed, o, d, mx, box_cap=cap)
        assert torch.equal(kv, M.visibility_reference(plain, o, d, mx))


# ---------------------------------------------------------------------------
# Lane groups: the geometry kernel built for each lane count per ray the
# wrapper can choose (ops/march.py:LANE_CHOICES), whatever it would choose
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lanes", M.LANE_CHOICES)
@pytest.mark.parametrize("variant", ["radiance", "screen"])
def test_each_lane_count_matches_plain_on_gi(dev, lanes, variant):
    """Both REFL variants; 4,099 rays: the last block is partly filled and,
    at 8 lanes, so is the last warp (3 of its 4 groups hold a ray)."""
    r = S.global_illumination(width=256, height=256, device=dev)
    o, d = _gi_rays(r, dev, variant, n=4099)
    refl = variant == "screen"
    k, ref = _both(r.spec, r.scene_data, o, d, refl, 3 if refl else 0,
                   r.probes, lanes)
    assert ref["hit"].float().mean() > 0.5
    _assert_match(k, ref)


@pytest.mark.parametrize("lanes", M.LANE_CHOICES)
def test_each_lane_count_matches_plain_on_simple_scene(dev, lanes):
    """40 slots in three typed runs: 20 spheres, 6 planes, 14 boxes."""
    r = S.simple_scene(width=256, height=256, device=dev)
    assert M.pack_scene(r.spec, r.scene_data).counts == (20, 6, 14)
    o, d = _gi_rays(r, dev, "screen", n=4099)
    k, ref = _both(r.spec, r.scene_data, o, d, True, 3, r.probes, lanes)
    assert ref["hit"].float().mean() > 0.5
    _assert_match(k, ref)


@pytest.mark.parametrize("lanes", M.LANE_CHOICES)
def test_each_lane_count_matches_plain_with_dead_slots(dev, lanes):
    """Dead sphere, plane and box slots (dynamic counts), two lights."""
    spec, data = _dynamic_scene(dev)
    g = torch.Generator().manual_seed(47)
    o = torch.rand(4099, 3, generator=g) * 2.0 - 1.0
    o[:, 1] += 1.0
    d = torch.randn(4099, 3, generator=g)
    d = (d / d.norm(dim=1, keepdim=True)).to(dev)
    k, ref = _both(spec, data, o.to(dev), d, True, 3, ProbeSettings(), lanes)
    _assert_match(k, ref)


@pytest.mark.parametrize("lanes", M.LANE_CHOICES)
@pytest.mark.parametrize("n_live", [None, 700])
def test_each_lane_count_matches_plain_on_the_mesh(dev, lanes, n_live):
    """The torus, and the torus with 300 dead triangle slots; 4,099 rays."""
    r, spec, data = _mesh_scene(dev, n_live=n_live)
    o, d = _mesh_rays(r, dev, n=4099, seed=53)
    k, ref = _both(spec, data, o, d, True, 3, r.probes, lanes)
    assert ref["hit"].float().mean() > 0.3
    _assert_match(k, ref)


@pytest.mark.parametrize("lanes", M.LANE_CHOICES)
@pytest.mark.parametrize("scene", ["gi", "mesh"])
def test_each_lane_count_matches_plain_on_a_masked_launch(dev, lanes, scene):
    """The masked launch without AO, with single rays, whole groups' warps
    (runs of 4 rays: the 4 groups of a warp at 8 lanes) and whole warps and
    blocks at one lane a ray (runs of 32 and 128 rays) disabled."""
    if scene == "gi":
        r = S.global_illumination(width=256, height=256, device=dev)
        spec, data = r.spec, r.scene_data
        _, o, d, en = _reflection_rays(r, dev, n=4099)
    else:
        r, spec, data = _mesh_scene(dev)
        o, d = _mesh_rays(r, dev, n=4099, seed=59)
        en = torch.ones(4099, dtype=torch.bool, device=dev)
    i = torch.arange(4099, device=dev)
    g = torch.Generator().manual_seed(61)
    en = en & ((i // 4) % 3 != 0) & ((i // 32) % 5 != 0) \
        & ((i // 128) % 7 != 0) \
        & (torch.rand(4099, generator=g) > 0.1).to(dev)
    assert en.any() and not en.all()
    k, ref = _both(spec, data, o, d, False, 0, r.probes, lanes, enabled=en)
    _assert_match(k, ref)
    assert (k["t"][~en] == 0).all() and not k["hit"][~en].any()
    assert ref["hit"].any()


def test_the_wrapper_launches_its_choice_of_lanes(dev):
    """geometry() without a library launches geometry_lanes' build: on a
    small launch over simple_scene's 40 slots and on the mesh its outputs
    equal the 8-lane build's bit for bit."""
    for r in (S.simple_scene(width=64, height=64, device=dev),
              S.obj_mesh(width=64, height=64, obj_path=S.TORUS_OBJ,
                         device=dev)):
        spec, data = r.spec, r.scene_data
        o, d = _gi_rays(r, dev, "radiance", n=2048)
        assert M.geometry_lanes(M.pack_scene(spec, data), 2048) == 8
        k, _ = _both(spec, data, o, d, False, 0, r.probes)
        k8, _ = _both(spec, data, o, d, False, 0, r.probes, 8)
        for key in ("t", "hit", "idx", "mid", "normal", "shadows", "vis8"):
            assert torch.equal(k[key], k8[key]), key


# ---------------------------------------------------------------------------
# The march.cu kernels' builds (ops/march.py:march_layout): the scene's
# layout or generic
# ---------------------------------------------------------------------------

def _fan_scene(dev, n_tris=80):
    """tests/test_march_kernels.py:build_chunked_scene (a fan of 80 seeded
    triangles over a floor plane, one point light), built with the port:
    that file imports JAX."""
    spec = SceneSpec(prims=((P.Triangle, n_tris), (P.Plane, 2)),
                     lights=((L.PointLight, 1),), max_dist=20.0)
    spec = spec.specialized({"triangle": n_tris, "plane": 1},
                            {"point_light": 1})
    b = SceneBuilder(spec)
    b.add_material((0.5, 0.5, 0.5), 0.0, 0.5)
    rng = np.random.RandomState(3)
    for _ in range(n_tris):
        c = rng.uniform(-2.0, 2.0, 3) + np.array([0.0, 1.5, 5.0])
        v = c + rng.uniform(-0.4, 0.4, (3, 3))
        b.add_primitive(P.Triangle, v1=v[0], v2=v[1], v3=v[2],
                        material_id=0)
    b.add_primitive(P.Plane, normal=(0.0, 1.0, 0.0), offset=1.0,
                    material_id=0)
    b.add_light(L.PointLight, position=(0.0, 5.0, 3.0), color=(1.0,) * 3)
    return spec, b.device_data(dev)


def _march_rays(scene, dev, n):
    """(packed scene, max_dist, n seeded rays): from the GI room's probe
    positions in all directions, or from around (0, 1.5, 0) toward the
    fan; runs of 4, 32 and 128 disabled rays; min dists up to 0.5, max
    dists from -1 to 20 and equal to the min dist (never marched) on every
    ninth ray."""
    g = torch.Generator().manual_seed(67 + n)
    if scene == "gi":
        r = S.global_illumination(width=64, height=64, device=dev)
        spec, data = r.spec, r.scene_data
        starts = PR.probe_world_positions(r.probes, "cpu")
        o = starts[torch.randint(0, starts.shape[0], (n,), generator=g)]
        d = torch.randn(n, 3, generator=g)
    else:
        spec, data = _fan_scene(dev)
        o = torch.rand(n, 3, generator=g) * 2.0 - 1.0
        o[:, 1] += 1.5
        d = torch.tensor([0.0, 1.5, 5.0]) + torch.rand(n, 3, generator=g) \
            * 4.0 - 2.0 - o
    d = d / d.norm(dim=1, keepdim=True).clamp_min(1e-6)
    i = torch.arange(n)
    en = ((i // 4) % 3 != 0) & ((i // 32) % 5 != 0) & ((i // 128) % 7 != 0)
    mn = torch.rand(n, generator=g) * 0.5
    mx = torch.rand(n, generator=g) * 21.0 - 1.0
    mx[::9] = mn[::9]
    rays = [x.to(dev).contiguous() for x in (o, d, en, mn, mx)]
    return (M.pack_scene(spec, data), spec.max_dist, *rays)


def _march_all(packed, max_dist, o, d, en, mn, mx, lib=None):
    """(t, hit, vis, penumbra factors at k = 64 and 0.5) of the raycast,
    visibility and softshadow kernels through the wrappers, or launched
    from the march_library build ``lib``."""
    if lib is None:
        return (*M.raycast(packed, o, d, max_dist, enabled=en)[:2],
                M.visibility(packed, o, d, mx, enabled=en),
                *[M.softshadows(packed, o, d, mn, mx, k, enabled=en)
                  for k in (64.0, 0.5)])
    return (*M._raycast(lib, packed, o, d, max_dist, en),
            M._visibility(lib, packed, o, d, mx, en),
            *[M._softshadows(lib, packed, o, d, mn, mx, k, en)
              for k in (64.0, 0.5)])


def _march_plain(packed, max_dist, o, d, en, mn, mx):
    return (*M.raycast_reference(packed, o, d, max_dist, enabled=en)[:2],
            M.visibility_reference(packed, o, d, mx, enabled=en),
            *[M.softshadows_reference(packed, o, d, mn, mx, k, enabled=en)
              for k in (64.0, 0.5)])


@pytest.mark.parametrize("scene", ["gi", "fan"])
@pytest.mark.parametrize("n", [0, 1, 4099])
def test_march_kernels_match_plain_in_each_build(dev, scene, n):
    """The raycast, visibility and softshadow kernels bit-equal to their
    plain versions on 0 and 1 rays and on 4,099 (a partly filled last
    warp, runs of disabled rays, penumbra rays that start at their max
    distance): through the wrappers (the GI room's layout build, the
    80-triangle fan's generic build with chunk-pruned triangles) and, on
    the room, in the generic build; only the wrappers' launches count."""
    rays = _march_rays(scene, dev, n)
    before = (M.raycast.launches, M.visibility.launches,
              M.softshadows.launches)
    got = [_march_all(*rays)]
    assert (M.raycast.launches, M.visibility.launches,
            M.softshadows.launches) == (before[0] + 1, before[1] + 1,
                                        before[2] + 2)
    if scene == "gi":
        assert M.march_layout(rays[0]) == (1, 6, 1)
        got.append(_march_all(*rays, lib=M.march_library()))
    else:
        assert M.march_layout(rays[0]) is None
    torch.cuda.synchronize()
    want = _march_plain(*rays)
    for outs in got:
        for name, a, b in zip(("t", "hit", "vis", "pen64", "pen05"), outs,
                              want):
            assert torch.equal(a, b), name
    if n == 4099:
        en, hit = rays[4], want[1]
        assert not bool(hit[~en].any()) and bool(hit.any())
        # the room is closed; the fan's rays miss as well
        assert bool((~hit & en).any()) == (scene == "fan")


def test_a_layout_build_holds_its_padded_room_and_refuses_others(dev):
    """The room padded with inert slots to march_layout's limit (4,8,4, 20
    rows; chip_smoke.pad_scene) marches as the room in its layout's build;
    a layout's build refuses a scene of another layout."""
    import chip_smoke
    packed, *rest = _march_rays("gi", dev, 4099)
    padded = chip_smoke.pad_scene(torch, chip_smoke.port_modules(), packed,
                                  (4, 8, 4))
    assert M.march_layout(padded) == (4, 8, 4)
    lib = M.march_library(M.march_layout(padded))
    got = _march_all(padded, *rest, lib=lib)
    torch.cuda.synchronize()
    for a, b in zip(got, _march_plain(packed, *rest)):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError):
        _march_all(packed, *rest, lib=lib)
    fan, max_dist, o, d, en, mn, mx = _march_rays("fan", dev, 64)
    with pytest.raises(RuntimeError):
        M._raycast(M.march_library((1, 6, 1)), fan, o, d, max_dist, en)


# ---------------------------------------------------------------------------
# The visibility kernel on long and short marches (csrc/march.cu)
# ---------------------------------------------------------------------------

# March steps past which a ray is a tail: 97% of light_shafts' froxel rays
# end within them.
TAIL = 16


def _grazing_rays(scene, dev, n, seed=0):
    """(packed scene, origins, dirs, max_dists, enabled): n seeded rays
    from 1 to 5 cm above the floor (y = -1) of the GI room ("room"), of the
    room padded with inert slots to the 4,8,4 layout ("padded") or of the
    80-triangle fan ("fan"; a third of them aimed into the fan), rising 0.1
    to 1 degree, max dists up to 30 m: marches of tens to hundreds of
    steps, most of them tails.  Every seventh ray disabled, every eleventh
    with a max dist of 0 or below."""
    if scene == "fan":
        packed = M.pack_scene(*_fan_scene(dev))
    else:
        r = S.global_illumination(width=16, height=16, device=dev)
        packed = M.pack_scene(r.spec, r.scene_data)
        if scene == "padded":
            import chip_smoke
            packed = chip_smoke.pad_scene(
                torch, chip_smoke.port_modules(), packed, (4, 8, 4))
    rng = np.random.RandomState(seed)
    o = np.stack([rng.uniform(-0.5, 6.5, n),
                  -1.0 + rng.uniform(0.01, 0.05, n),
                  rng.uniform(-5.5, 6.5, n)], axis=1)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    rise = np.radians(rng.uniform(0.1, 1.0, n))
    d = np.stack([np.cos(phi) * np.cos(rise), np.sin(rise),
                  np.sin(phi) * np.cos(rise)], axis=1)
    if scene == "fan":
        # a third aimed into the fan, some of them blocked
        aim = np.array([0.0, 1.5, 5.0]) + rng.uniform(-1.0, 1.0, (n, 3)) - o
        d[::3] = (aim / np.linalg.norm(aim, axis=1, keepdims=True))[::3]
    mx = rng.uniform(0.5, 30.0, n)
    mx[::11] = rng.uniform(-1.0, 0.0, mx[::11].shape)
    en = np.arange(n) % 7 != 3
    return (packed, *[torch.as_tensor(x, dtype=torch.float32).to(dev)
                      for x in (o, d, mx)], torch.as_tensor(en).to(dev))


def _short_rays(dev, n):
    """The GI room's rays of _grazing_rays with max dists of at most 5 cm:
    every march ends within a few steps."""
    packed, o, d, mx, en = _grazing_rays("room", dev, n, seed=5)
    return packed, o, d, mx.clamp(max=0.05), en


def _tails(packed, o, d, mx, en):
    """(the plain version's 0/1, its rays marching more than TAIL
    steps)."""
    ref, steps = M.visibility_reference(packed, o, d, mx, enabled=en,
                                        return_steps=True)
    return ref, int((steps > TAIL).sum())


@pytest.mark.parametrize("scene", ["room", "padded", "fan"])
@pytest.mark.parametrize("n", [0, 1, 4099])
def test_visibility_matches_plain_on_grazing_rays(dev, scene, n):
    """The visibility kernel bit-equal to the plain version on rays that
    graze a floor, with disabled rays and max dists <= 0: through the
    wrapper (the room's layout build; the fan's generic build, with
    triangles), in the room's generic build and in the 4,8,4 build of the
    padded room."""
    packed, o, d, mx, en = _grazing_rays(scene, dev, n)
    ref, tails = _tails(packed, o, d, mx, en)
    if n == 4099:
        assert tails > n // 4
        assert bool((~en).any()) and bool((en & (mx <= 0.0)).any())
    got = []
    if scene != "padded":
        before = M.visibility.launches
        got.append(M.visibility(packed, o, d, mx, enabled=en))
        assert M.visibility.launches == before + 1
    layout = (4, 8, 4) if scene == "padded" else None
    got.append(M._visibility(M.march_library(layout), packed, o, d, mx, en))
    torch.cuda.synchronize()
    for v in got:
        assert torch.equal(v, ref)


def test_visibility_matches_plain_on_short_marches(dev):
    """Rays that all end within a few steps, blocked or not."""
    packed, o, d, mx, en = _short_rays(dev, 4099)
    ref, tails = _tails(packed, o, d, mx, en)
    assert tails == 0 and bool((ref == 0.0).any())
    v = M.visibility(packed, o, d, mx, enabled=en)
    torch.cuda.synchronize()
    assert torch.equal(v, ref)


def test_visibility_back_to_back_calls_are_independent(dev):
    """Three calls on one stream with no wait between them, the second of
    the same size as the first (the allocator may hand it the first's
    memory) and with short marches: each equals its plain version."""
    calls = [_grazing_rays("room", dev, 4099, seed=1),
             _short_rays(dev, 4099), _grazing_rays("room", dev, 2000, seed=2)]
    got = [M.visibility(p, o, d, mx, enabled=en)
           for p, o, d, mx, en in calls]
    torch.cuda.synchronize()
    for (p, o, d, mx, en), v in zip(calls, got):
        assert torch.equal(v, M.visibility_reference(p, o, d, mx,
                                                     enabled=en))


def test_visibility_does_not_synchronise(dev):
    """The wrapper launches without waiting for the card (sync debug mode
    "error" raises on a synchronising call)."""
    packed, o, d, mx, en = _grazing_rays("room", dev, 4099, seed=3)
    ref = M.visibility_reference(packed, o, d, mx, enabled=en)
    M.visibility(packed, o, d, mx, enabled=en)   # builds and loads first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        v = M.visibility(packed, o, d, mx, enabled=en)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(v, ref)


@pytest.mark.parametrize("mode", [2, 3])
def test_train_step_on_the_card_matches_the_cpu(dev, mode):
    """One train step of the GI scene at 64x64 (test_examples.py's tiny
    probes, the atlases of a frame rendered on the CPU) on the card and on
    the CPU: the losses agree and every float leaf's gradient within
    chip_smoke.GRAD_REL_LIMIT relative norm; the step launches the
    geometry kernel twice (three times in mode 3) and moves the
    parameters."""
    import chip_smoke
    from madarch_tpu_torch.parallel import spmd
    m = chip_smoke.port_modules()
    r = S.global_illumination(width=64, height=64, device="cpu",
                              probes=ProbeSettings(**chip_smoke.TINY_PROBES),
                              screen_cfg=ShadeConfig(
                                  indirect_specular_mode=mode))
    r.render()
    args = (r.spec, r.probes, r.volumetrics, 64, 64)
    kw = dict(screen_cfg=r.screen_cfg, probe_cfg=r.probe_cfg)
    value_and_grad = spmd.make_value_and_grad(*args, **kw)
    target = torch.zeros((64, 64, 3))
    loss_c, grads_c, _ = value_and_grad(r.scene_data, r.camera, r.state,
                                        target)
    on_card = chip_smoke.to_device(m, dev, r.scene_data, r.camera, r.state)
    before = M.geometry.launches
    loss_d, grads_d, _ = value_and_grad(*on_card, target.to(dev))
    torch.cuda.synchronize()
    assert M.geometry.launches - before == (3 if mode == 3 else 2)
    np.testing.assert_allclose(float(loss_d), float(loss_c), rtol=1e-5)
    for gd, gc in zip(grads_d, grads_c):
        assert bool(torch.isfinite(gd).all())
        assert chip_smoke.rel_norm(torch, gd.cpu(), gc) \
            <= chip_smoke.GRAD_REL_LIMIT
    step = spmd.make_train_step(*args, **kw)
    _, new, _ = step(*on_card, target.to(dev))
    moved = [(a - b).abs().max() for a, b in zip(
        spmd.split_float_leaves(new)[0],
        spmd.split_float_leaves(on_card[0])[0])]
    assert float(max(moved)) > 0.0


# ---------------------------------------------------------------------------
# The generic route (bvh_test, obj_mesh baked) and ball_game on the card
# ---------------------------------------------------------------------------

# The probe-lookup kernels' launches in a mode-2 frame: the irradiance in
# the radiance and the screen pass, the reflection's radiance tile.
LOOKUPS_A_FRAME = {"irradiance_lookup": 2, "radiance_lookup": 1}


def _launches():
    """Every hand-written kernel's launches by wrapper (the march kernels
    and the probe lookups)."""
    return M.launch_counts()


def _card_and_cpu(make, dev, frames=2, between=None):
    """The frames of renderer make(device) on the card and on the CPU
    (between(renderer) runs before each frame), the card's kernel
    launches per frame (on the kernel route the first frame's are twice
    a frame's: the eager warm-up, then the replay of its capture), and
    its nvcc builds and libraries loaded after the first frame."""
    from madarch_tpu_torch.ops import build
    from madarch_tpu_torch.render import pipeline
    from madarch_tpu_torch.utils.golden import image_stats
    pipeline.clear_compiled()    # the first frame captures its key
    imgs, per_frame, later = [], [], None
    for d in (dev, "cpu"):
        r = make(d)
        for i in range(frames):
            if between is not None:
                between(r)
            before = _launches()
            img = r.render()
            if d == dev:
                torch.cuda.synchronize()
                per_frame.append({k: v - before[k]
                                  for k, v in _launches().items()})
                if i == 0:
                    later = (build.load.builds,
                             build.load.cache_info().misses)
        imgs.append(img.cpu().numpy())
        if d == dev:
            later = (build.load.builds - later[0],
                     build.load.cache_info().misses - later[1])
    stats = image_stats(*imgs)
    assert not stats["breached"], stats
    assert np.isfinite(imgs[0]).all() and imgs[0].var() > 0
    return per_frame, later


TINY = ProbeSettings(radiance_resolution=8, irradiance_resolution=4,
                     probe_count=(4, 2), grid_dimensions=(2, 2, 2),
                     grid_spacing=(4.0, 4.0, 4.0))


@pytest.mark.parametrize("scene", ["bvh_test", "obj_mesh_baked"])
def test_generic_route_frames_match_the_cpu_without_kernels(dev, scene):
    """bvh_test and obj_mesh's baked torus at 32², two frames on the card
    and on the CPU under the golden gates: the generic route launches no
    march kernel; its shade looks the probes up with the kernels, the
    irradiance twice a frame (radiance and screen pass), mode 2's radiance
    tile once."""
    def make(d):
        if scene == "bvh_test":
            return S.bvh_test(width=32, height=32, probes=TINY, device=d)
        return S.obj_mesh(width=32, height=32, obj_path=S.TORUS_OBJ,
                          mode="baked", bake_dims=(16, 16, 16), device=d)

    per_frame, _ = _card_and_cpu(make, dev)
    assert per_frame == [dict.fromkeys(M.launch_counts(), 0)
                         | LOOKUPS_A_FRAME] * 2, per_frame


def test_ball_game_matches_the_cpu_and_builds_nothing_new(dev):
    """ball_game at 32² with the tiny probes: the golden's throw, then the
    physics stepped and three balls thrown before each of four frames, the
    live slots 11, 14, 17 and 20 (past LANES_MIN_SLOTS); card and CPU
    under the golden gates, two geometry launches a frame, and after the
    first frame no nvcc build and no library loaded."""
    def make(d):
        r, step, throw = S.ball_game(width=32, height=32, probes=TINY,
                                     device=d)
        throw((2.0, 2.0, 0.0), (2.0, 2.0, 4.0))
        r.step, r.throw = step, throw
        return r

    def between(r):
        r.step()
        for k in range(3):
            r.throw((1.0 + k, 4.0, 1.0), (0.5, 0.0, 1.0))

    per_frame, later = _card_and_cpu(make, dev, frames=4, between=between)
    frame = {"geometry": 2, "raycast": 0, "visibility": 0, "softshadows": 0,
             **LOOKUPS_A_FRAME}
    # one capture for every live count (specialize_counts False)
    assert per_frame == [{k: 2 * v for k, v in frame.items()}] \
        + [frame] * 3, per_frame
    assert later == (0, 0), later


def test_a_light_without_position_launches_the_march_kernels(dev,
                                                             monkeypatch):
    """The GI room lit by chip_smoke.lamp, a light without a vec3
    'position', at 32² with the tiny probes: the kernels take the scene,
    the geometry kernel does not.  Card against CPU under the golden
    gates; a frame launches raycast, softshadows and visibility three
    times each and geometry never, in chip_smoke.LAMP_CALLS's order and
    batch sizes: the shadow marches one per light slot from distance 0 at
    k = SHADOW_K, the visibility marches 8 corners a point."""
    import chip_smoke
    from madarch_tpu_torch.render import context as C
    from madarch_tpu_torch.render.lighting import SHADOW_K
    calls = []

    def recorder(name, real):
        def record(self, *args, **kwargs):
            if args[0].is_cuda:
                calls.append((name, args[0].shape[0], args))
            return real(self, *args, **kwargs)
        return record

    for name in ("raycast", "visibility", "softshadows"):
        monkeypatch.setattr(C.SceneCtx, name,
                            recorder(name, getattr(C.SceneCtx, name)))
    m = chip_smoke.port_modules()
    # eager frames: the recorder sees each frame's calls and their inputs
    with m.pipeline.eager():
        per_frame, _ = _card_and_cpu(
            lambda d: chip_smoke.lamp_room(np, m, 32, d, probes=TINY), dev)
    assert per_frame == [{"geometry": 0, "raycast": 3, "visibility": 3,
                          "softshadows": 3, **LOOKUPS_A_FRAME}] * 2, per_frame
    n_rad = TINY.num_probes * TINY.radiance_resolution ** 2
    sizes = {"R": n_rad, "8R": 8 * n_rad, "S": 32 * 32, "8S": 8 * 32 * 32}
    want = [(c.split()[0], sizes[c.split()[1]])
            for c in chip_smoke.LAMP_CALLS]
    assert [(name, n) for name, n, _ in calls] == want * 2
    for name, _, args in calls:
        if name == "softshadows":
            assert args[4] == SHADOW_K
            assert not bool(args[2].any())


def _gi_camera_rays(r, dev):
    cam = r.camera
    o, d = camera_rays(pixel_grid(r.width, r.height, dev), cam.position,
                       cam.orientation)
    return o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()


def test_path_tracers_launch_their_kernels(dev):
    """The GI room at 64²: pixel_color_direct launches raycast and
    softshadows once each (one live light slot), pixel_color_many 1 + 100
    times, pixel_color_path 3 + 1 times, at the reference's defaults, and
    no other kernel; direct, and many at 4 samples from one CPU generator,
    equal the CPU's under the golden gates."""
    from madarch_tpu_torch.render import pathtrace as PT
    from madarch_tpu_torch.utils.golden import image_stats
    r = S.global_illumination(width=64, height=64, device=dev)
    o, d = _gi_camera_rays(r, dev)
    cases = (("direct", lambda: PT.pixel_color_direct(
                 r.spec, r.scene_data, o, d), 1),
             ("many", lambda: PT.pixel_color_many(
                 r.spec, r.scene_data, o, d), 101),
             ("path", lambda: PT.pixel_color_path(
                 r.spec, r.scene_data, o, d), 4))
    for name, run, n in cases:
        before = _launches()
        out = run()
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in _launches().items()}
        assert got == {"geometry": 0, "raycast": n, "visibility": 0,
                       "softshadows": n, "irradiance_lookup": 0,
                       "radiance_lookup": 0}, (name, got)
        assert out.shape == (64 * 64, 3) and bool(torch.isfinite(out).all())
    c = S.global_illumination(width=64, height=64, device="cpu")
    oc, dc = _gi_camera_rays(c, "cpu")

    def tone(x):
        x = x.clamp_min(0.0).cpu().numpy()
        return ((x + 1e-8) / (x + 1.0)) ** 0.4545

    def small(mode, r, o, d):
        if mode == "direct":
            return PT.pixel_color_direct(r.spec, r.scene_data, o, d)
        return PT.pixel_color_many(r.spec, r.scene_data, o, d,
                                   torch.Generator().manual_seed(9),
                                   gi_samples=4)

    for mode in ("direct", "many"):
        stats = image_stats(tone(small(mode, r, o, d)),
                            tone(small(mode, c, oc, dc)))
        assert not stats["breached"], (mode, stats)


def test_a_world_of_one_renders_over_nccl(dev):
    """A torch.distributed group of one process on the card (NCCL): the
    GI frame at 64² with every pass's rays through a RaySharder (each
    gather an NCCL all-gather of one rank) equals Renderer.render()'s."""
    import socket
    from madarch_tpu_torch.parallel import spmd
    from madarch_tpu_torch.render.pipeline import render_frame
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    assert spmd.init_distributed(f"tcp://127.0.0.1:{port}", 1, 0,
                                 backend="nccl")
    try:
        mesh = spmd.make_mesh(device=dev)
        r = S.global_illumination(width=64, height=64, device=dev)
        args = (r.scene_data, r.camera, r.state)
        sharder = spmd.RaySharder(mesh)
        img, _ = render_frame(r.spec, r.probes, r.volumetrics, 64, 64,
                              *args, screen_cfg=r.screen_cfg,
                              probe_cfg=r.probe_cfg, shard=sharder)
        assert [op["op"] for op in sharder.record] == ["all-gather"] * 3
        assert torch.equal(img, r.render())
    finally:
        torch.distributed.destroy_process_group()


def test_frame_timer_time_fn_on_the_card(dev):
    """FrameTimer.time_fn: seconds per call between CUDA events after the
    warm-up calls, the last output returned, the time kept."""
    from madarch_tpu_torch.utils.profiling import FrameTimer
    timer = FrameTimer(dev)
    x = torch.ones((256, 256), device=dev)
    calls = []

    def fn(y):
        calls.append(1)
        return y * 2.0

    dt, out = timer.time_fn(fn, x, warmup=2, iters=3)
    assert dt > 0 and timer.times == [dt] and len(calls) == 5
    assert out.is_cuda and bool((out == 2.0).all())


def test_sample_irradiance_gather_matches_matmul_on_the_card(dev):
    """The gather method against the matmul method on the card at atol
    1e-5, and each against the same call on the CPU, on the GI scene's
    hit points with the geometry kernel's visibility."""
    r = S.global_illumination(width=64, height=64, device=dev)
    r.converge(frames=2)
    o, d = _gi_rays(r, dev, "screen", n=4096)
    ctx = SceneCtx(r.spec, r.scene_data)
    g = ctx.geometry(o, d, r.probes, r.screen_cfg)
    hit = g["hit"].bool()
    pos = (o + d * g["t"][:, None])[hit].contiguous()
    nrm, vis8 = g["normal"][hit].contiguous(), g["vis8"][:, hit].contiguous()
    irr = r.state.irradiance
    out = {}
    for method in ("gather", "matmul"):
        card = PR.sample_irradiance(r.probes, irr, pos, nrm, vis8=vis8,
                                    method=method)
        cpu = PR.sample_irradiance(r.probes, irr.cpu(), pos.cpu(), nrm.cpu(),
                                   vis8=vis8.cpu(), method=method)
        np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(),
                                   atol=1e-5, rtol=0)
        out[method] = card
    assert pos.shape[0] > 1000 and float(out["matmul"].abs().max()) > 0
    np.testing.assert_allclose(out["gather"].cpu().numpy(),
                               out["matmul"].cpu().numpy(), atol=1e-5, rtol=0)


def test_trace_names_the_geometry_kernel(dev, tmp_path):
    """trace(log_dir) around a GI frame on the card writes a trace whose
    device events name the geometry kernel."""
    import glob
    import json
    from madarch_tpu_torch.utils.profiling import trace
    r = S.global_illumination(width=32, height=32, device=dev)
    r.render()
    with trace(str(tmp_path)):
        r.render()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("geometry_kernel" in name for name in kernels), kernels[:20]


def test_an_empty_data_template_restores_a_card_checkpoint(dev, tmp_path):
    """checkpoint.load with spec.empty_data(dev) as the scene's template
    gives the saved GI scene back bit for bit, and the same frame."""
    from madarch_tpu_torch.render.pipeline import render_frame
    from madarch_tpu_torch.scene.scene import tree_leaves
    from madarch_tpu_torch.utils import checkpoint
    r = S.global_illumination(width=32, height=32, device=dev)
    r.converge(frames=2)
    path = str(tmp_path / "gi.npz")
    checkpoint.save(path, scene=r.scene_data)
    back = checkpoint.load(path, scene=r.base_spec.empty_data(dev))["scene"]
    for a, b in zip(tree_leaves(r.scene_data), tree_leaves(back),
                    strict=True):
        assert b.device == a.device and torch.equal(a, b)
    frames = [render_frame(r.spec, r.probes, r.volumetrics, 32, 32, data,
                           r.camera, r.state, screen_cfg=r.screen_cfg,
                           probe_cfg=r.probe_cfg)[0]
              for data in (r.scene_data, back)]
    assert torch.equal(*frames)


# ---------------------------------------------------------------------------
# Placements (ops/march.py:placement_for) and large scenes: the chunked
# sphere and box runs, the opt-in and device memory
# (examples/large_scenes.py)
# ---------------------------------------------------------------------------

def _placement_scene(name, dev):
    """(spec, data, probes, 4,096 seeded screen rays) of GI, simple_scene
    or the torus at 64²."""
    if name == "torus":
        r = _mesh_scene(dev)[0]
        o, d = _mesh_rays(r, dev)
    else:
        r = getattr(S, name)(width=64, height=64, device=dev)
        o, d = _gi_rays(r, dev, "screen")
    return r.spec, r.scene_data, r.probes, o, d


def _launch_all(spec, data, probes, o, d, placement, lanes=None):
    """Every kernel at ``placement`` on rays o, d: geometry with the fold
    and a mask, raycast, visibility to seeded max dists, softshadows at k
    = 64 and 0.5; a dict of each kernel's outputs."""
    packed = M.pack_scene(spec, data)
    lpos, n_lights = M.pack_light_positions(spec, data)
    g = torch.Generator().manual_seed(91)
    n = o.shape[0]
    en = (torch.rand(n, generator=g) > 0.2).to(o.device)
    mn = (torch.rand(n, generator=g) * 0.5).to(o.device)
    mx = (torch.rand(n, generator=g) * 20.0).to(o.device)
    geo = M.geometry(packed, lpos, n_lights, o, d, spec.max_dist,
                     probe_spacing=probes.grid_spacing,
                     probe_dims=probes.grid_dimensions,
                     surface_offset=SURFACE_OFFSET, ao_steps=3,
                     mat_rough_vec=data.materials["roughness"], enabled=en,
                     placement=placement,
                     library=lanes and M.geometry_library(lanes))
    out = {"geometry": geo,
           "raycast": M.raycast(packed, o, d, spec.max_dist, enabled=en,
                                placement=placement)[:2],
           "visibility": M.visibility(packed, o, d, mx, enabled=en,
                                      placement=placement),
           "softshadows": [M.softshadows(packed, o, d, mn, mx, k,
                                         enabled=en, placement=placement)
                           for k in (64.0, 0.5)]}
    torch.cuda.synchronize()
    return out


def _flat(x):
    """Every tensor of a kernel's outputs, in a fixed order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) if x[k] is not None for t in _flat(x[k])]
    return [t for v in x for t in _flat(v)]


@pytest.mark.parametrize("lanes", M.LANE_CHOICES)
@pytest.mark.parametrize("scene", ["global_illumination", "simple_scene",
                                   "torus"])
def test_every_placement_is_bit_equal_to_the_staged_launch(dev, scene,
                                                           lanes):
    """The opt-in and device-memory instantiations of the four kernels give
    the staged launch's outputs bit for bit (the same arithmetic, read
    from elsewhere), and each placement's launch counts once."""
    spec, data, probes, o, d = _placement_scene(scene, dev)
    staged = _launch_all(spec, data, probes, o, d, "staged", lanes)
    for placement in ("optin", "global"):
        before = M.geometry.launches
        got = _launch_all(spec, data, probes, o, d, placement, lanes)
        assert M.geometry.launches == before + 1
        for name in staged:
            for a, b in zip(_flat(got[name]), _flat(staged[name]),
                            strict=True):
                assert torch.equal(a, b), (placement, name)


def _large_scene(name, dev):
    """(spec, data, probes, seeded rays from the camera toward the scene)
    of the sphere field, the 12,000-triangle or the 65,000-triangle grid
    (a 2 x 2 grid at the origin, facing the camera at (0, 0, -4)); fewer
    rays on the largest: the plain versions' [points, slots]
    intermediates grow with the slots."""
    g = torch.Generator().manual_seed(53)
    if name == "spheres":
        r = LS.sphere_field(64, 64, device=dev)
        spec, data, probes = r.spec, r.scene_data, r.probes
        n, cam = 1024, torch.tensor([0.0, 1.0, -5.0])
        lo, hi = torch.tensor([-3.0, -0.5, 3.0]), torch.tensor([3.0, 2.0, 9.0])
    else:
        n_tris = {"mesh": LS.MESH_TRIANGLES,
                  "huge_mesh": LS.HUGE_MESH_TRIANGLES}[name]
        verts, faces = LS.grid_vertices(n_tris)
        spec = SceneSpec(prims=((P.Triangle, n_tris),),
                         lights=((L.PointLight, 1),))
        b = SceneBuilder(spec)
        b.add_material((0.5, 0.5, 0.5), 0.0, 0.2)
        for v1, v2, v3 in verts[faces]:
            b.add_primitive(P.Triangle, v1=v1, v2=v2, v3=v3, material_id=0)
        b.add_light(L.PointLight, position=(0.0, 3.0, -3.0),
                    color=(1.0,) * 3)
        spec, data, probes = spec, b.device_data(dev), LS.PROBES
        n = 1024 if name == "mesh" else 256
        cam = torch.tensor([0.0, 0.0, -4.0])
        lo, hi = torch.tensor([-1.2, -1.2, 0.0]), torch.tensor([1.2, 1.2, 0.0])
    o = cam + torch.randn(n, 3, generator=g) * 0.2
    d = lo + torch.rand(n, 3, generator=g) * (hi - lo) - o
    d = d / d.norm(dim=1, keepdim=True)
    return spec, data, probes, o.to(dev).contiguous(), d.to(dev).contiguous()


@pytest.mark.parametrize("scene", ["spheres", "mesh", "huge_mesh"])
def test_large_scenes_match_plain(dev, scene):
    """The sphere field (chunked, staged), 12,000 triangles (the opt-in)
    and 65,000 (device memory): the geometry kernel at both lane counts,
    with and without the fold and the mask, matches its plain version;
    raycast, visibility and softshadows equal theirs."""
    spec, data, probes, o, d = _large_scene(scene, dev)
    packed = M.pack_scene(spec, data)
    lpos, n_lights = M.pack_light_positions(spec, data)
    extra = lpos.numel() + data.materials["roughness"].numel()
    assert M.placement_for("geometry", M.smem_bytes(packed, extra),
                           232_448) == {
        "spheres": "staged", "mesh": "optin", "huge_mesh": "global"}[scene]
    g = torch.Generator().manual_seed(92)
    en = (torch.rand(o.shape[0], generator=g) > 0.2).to(dev)
    for refl, enabled in ((False, None), (True, en)):
        kw = dict(probe_spacing=probes.grid_spacing,
                  probe_dims=probes.grid_dimensions,
                  surface_offset=SURFACE_OFFSET, ao_steps=3,
                  mat_rough_vec=data.materials["roughness"] if refl
                  else None, enabled=enabled)
        ref = M.geometry_reference(packed, lpos, n_lights, o, d,
                                   spec.max_dist, **kw)
        assert ref["hit"].float().mean() > 0.2
        for lanes in M.LANE_CHOICES:
            k = M.geometry(packed, lpos, n_lights, o, d, spec.max_dist,
                           library=M.geometry_library(lanes), **kw)
            torch.cuda.synchronize()
            _assert_match(k, ref)
    mn = (torch.rand(o.shape[0], generator=g) * 0.5).to(dev)
    mx = (torch.rand(o.shape[0], generator=g) * 20.0).to(dev)
    got = _march_all(packed, spec.max_dist, o, d, en, mn, mx)
    torch.cuda.synchronize()
    want = _march_plain(packed, spec.max_dist, o, d, en, mn, mx)
    for name, a, b in zip(("t", "hit", "vis", "pen64", "pen05"), got, want):
        assert torch.equal(a, b), name


def test_chunked_spheres_equal_the_typed_run(dev, monkeypatch):
    """The sphere field packed chunk-major (pruned) and, with
    chunked_layout forced off, as one typed run of 3,500 slots (the
    opt-in, every slot evaluated): every kernel's outputs bit-equal."""
    spec, data, probes, o, d = _large_scene("spheres", dev)
    chunked = _launch_all(spec, data, probes, o, d, None)
    monkeypatch.setattr(M, "chunked_layout", lambda ptype, n:
                        ptype is P.Triangle)
    assert M.pack_scene(spec, data).counts == (LS.SPHERES, 1, 0)
    typed = _launch_all(spec, data, probes, o, d, None)
    for name in chunked:
        for a, b in zip(_flat(typed[name]), _flat(chunked[name]),
                        strict=True):
            assert torch.equal(a, b), name



# ---------------------------------------------------------------------------
# The compiled frame: a CUDA graph captured once per static key, replayed
# ---------------------------------------------------------------------------

COMPILED_SCENES = ("global_illumination", "light_shafts", "obj_mesh")


def _compiled_scene(name, dev, size=64):
    if name == "obj_mesh":
        return S.obj_mesh(width=size, height=size, obj_path=S.TORUS_OBJ,
                          device=dev)
    return getattr(S, name)(width=size, height=size, device=dev)


def _eager_frame(r, state):
    from madarch_tpu_torch.render import pipeline
    with torch.no_grad():
        return pipeline.render_frame(
            r.spec, r.probes, r.volumetrics, r.width, r.height,
            r.scene_data, r.camera, state, screen_cfg=r.screen_cfg,
            probe_cfg=r.probe_cfg)


def _same_state(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("radiance", "irradiance", "scattering"))


@pytest.mark.parametrize("scene", COMPILED_SCENES)
def test_replayed_frames_equal_eager_frames(dev, scene):
    """GI (mode 2), light_shafts and obj_mesh at 64²: three frames
    through Renderer.render(), one capture and two more replays, each
    image and state bit-equal to render_frame's op by op on the same
    inputs; every kernel the frame launches runs from the graph, counted
    once a replay."""
    from madarch_tpu_torch.render import pipeline
    pipeline.clear_compiled()    # an earlier test may have this key
    r = _compiled_scene(scene, dev)
    captures = pipeline.CompiledFrame.captures
    for i in range(3):
        state = r.state
        before = _launches()
        img = r.render()
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in _launches().items()}
        ref, ref_state = _eager_frame(r, state)
        assert torch.equal(img, ref) and _same_state(r.state, ref_state)
        assert got == {k: (2 if i == 0 else 1) * v
                       for k, v in r.frame.launches.items()}
    assert pipeline.CompiledFrame.captures == captures + 1
    assert r.frame.graph is not None and r.frame.pool_bytes > 0
    assert r.frame.launches["geometry"] == 2
    assert float(img.var()) > 0.0


@pytest.mark.parametrize("scene", COMPILED_SCENES)
def test_a_mutation_after_capture_shows_in_the_next_replay(dev, scene):
    """After the capture, a moved light (and on the GI room a moved
    sphere, a changed material) shows in the next replay: the image is
    render_frame's on the new scene, differs from the old scene's, and no
    new graph is captured."""
    from madarch_tpu_torch.render import pipeline
    r = _compiled_scene(scene, dev)
    r.render()
    frame, captures = r.frame, pipeline.CompiledFrame.captures
    ltype = r.base_spec.lights[0][0]
    mutations = [lambda: r.set_light(ltype, 0, position=(2.0, 5.0, 3.0))]
    if scene == "global_illumination":
        mutations += [
            lambda: r.set_primitive(P.Sphere, 0, center=(2.0, 1.8, 3.0)),
            lambda: r.set_material(3, (0.9, 0.9, 0.1), 0.0, 0.9)]
    for mutate in mutations:
        state, data = r.state, r.scene_data
        mutate()
        old, _ = pipeline.render_frame(
            r.spec, r.probes, r.volumetrics, r.width, r.height, data,
            r.camera, state, screen_cfg=r.screen_cfg, probe_cfg=r.probe_cfg)
        ref, _ = _eager_frame(r, state)
        img = r.render()
        torch.cuda.synchronize()
        assert torch.equal(img, ref) and not torch.equal(img, old)
    assert r.frame is frame
    assert pipeline.CompiledFrame.captures == captures


@pytest.mark.parametrize("scene", COMPILED_SCENES)
def test_an_eager_frame_waits_on_nothing(dev, scene):
    """After a first frame (the constants built), an eager kernel-route
    frame neither synchronises nor copies from pageable host memory (sync
    debug mode "error" raises on either): what lets it be captured."""
    from madarch_tpu_torch.render import pipeline
    r = _compiled_scene(scene, dev)
    with pipeline.eager():
        r.render()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            img = r.render()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.isfinite(img).all()


@pytest.mark.parametrize("scene", COMPILED_SCENES)
def test_recorded_frames_equal_unrecorded_frames(dev, scene):
    """The recorder (utils/profiling.py) on and off at 64²: four frames,
    each waited for, bit-equal, image and state.  On, each replay (the
    frames after the capture's) reports every pass, the write-back, one
    ``pack`` a SceneCtx and one ``probes`` a probe lookup, each a positive
    device time, and its replay waits on nothing (sync debug mode "error"
    raises on a synchronisation).  Off,
    nothing is recorded; a frame captured off and replayed with the
    recorder on reports host spans and no device interval."""
    from madarch_tpu_torch.render import pipeline
    from madarch_tpu_torch.utils import profiling
    passes = ["pass.radiance", "pass.irradiance", "pass.screen",
              "frame.writeback"] + ["pack"] * 2 \
        + ["probes"] * sum(LOOKUPS_A_FRAME.values())
    if scene == "light_shafts":
        passes += ["pass.visibility", "pass.scattering", "pack"]
    runs, recs = [], []
    try:
        for on in (False, True):
            pipeline.clear_compiled()
            profiling.drain()
            (profiling.enable if on else profiling.disable)()
            r = _compiled_scene(scene, dev)
            frames = []
            for _ in range(3):
                # each waited for, as a viewer's: a replay's intervals are
                # read at the next one only if done (else dropped)
                frames.append((r.render(), r.state))
                torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                frames.append((r.render(), r.state))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            runs.append(frames)
            recs.append(profiling.drain())
        profiling.disable()
        pipeline.clear_compiled()
        r = _compiled_scene(scene, dev)
        r.render()
        profiling.enable()
        r.render()
        late = profiling.drain()
    finally:
        profiling.disable()
        profiling.drain()
        pipeline.clear_compiled()
    for (img_a, st_a), (img_b, st_b) in zip(*runs, strict=True):
        assert torch.equal(img_a, img_b) and _same_state(st_a, st_b)
    assert recs[0] == {"spans": [], "counters": [], "device": []}
    ids = [s[4] for s in recs[1]["spans"] if s[0] == "render"]
    assert len(ids) == 4
    for fid in ids[1:]:
        got = [(n, ms) for f, n, ms in recs[1]["device"] if f == fid]
        assert sorted(n for n, _ in got) == sorted(passes)
        assert all(0.0 < ms < 1e3 for _, ms in got)
    assert "frame.replay" in [s[0] for s in late["spans"]]
    assert late["device"] == []


# ---------------------------------------------------------------------------
# The compiled train step: forward, backward and update in one CUDA graph
# ---------------------------------------------------------------------------

# Kernel launches a step: GI mode 2, GI mode 1 (raycast and softshadows
# inside the step's graph), light_shafts (raycast and visibility).
STEP_SCENES = {"gi_mode2": {"geometry": 2},
               "gi_mode1": {"geometry": 2, "raycast": 1, "softshadows": 1},
               "light_shafts": {"geometry": 2, "raycast": 1,
                                "visibility": 1}}


def _step_scene(name, dev, size=64):
    """The step's scene at size² with the tiny probes (light_shafts with
    chip_smoke's small volumetrics) and its train step."""
    import chip_smoke
    from madarch_tpu_torch.core.config import VolumetricsSettings
    from madarch_tpu_torch.parallel import spmd
    if name == "light_shafts":
        r = S.light_shafts(width=size, height=size, device=dev, probes=TINY,
                           volumetrics=VolumetricsSettings(
                               **chip_smoke.SMALL_VOL))
    else:
        r = S.global_illumination(
            width=size, height=size, device=dev, probes=TINY,
            screen_cfg=ShadeConfig(indirect_specular_mode=int(name[-1])))
    step = spmd.make_train_step(r.spec, r.probes, r.volumetrics, size, size,
                                screen_cfg=r.screen_cfg,
                                probe_cfg=r.probe_cfg)
    return r, step, torch.zeros((size, size, 3), device=dev)


@pytest.mark.parametrize("scene", list(STEP_SCENES))
def test_replayed_steps_equal_eager_steps(dev, scene):
    """Three train steps at 64², one capture and two more replays, each
    against eager steps on its own inputs.  Under deterministic
    algorithms every item (loss, state, updated leaves) is bit-equal.  As
    users run it, each replay is held by chip_smoke.hold_step: the loss,
    new state and every updated leaf bit-equal but the material table's
    (index_add's atomics in the backward), those within max(2 × the
    eager steps' spread, 1e-6) relative norm and never beyond
    chip_smoke.GRAD_REL_LIMIT.  Every kernel of the step runs from the
    graph, counted once a replay."""
    import itertools

    import chip_smoke
    from madarch_tpu_torch.render import pipeline
    m = chip_smoke.port_modules()
    want = {k: STEP_SCENES[scene].get(k, 0) for k in _launches()}
    for deterministic in (True, False):
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        try:
            r, step, target = _step_scene(scene, dev)
            data, state, held = r.scene_data, r.state, []
            for i in range(3):
                before = _launches()
                got = step(data, r.camera, state, target)
                torch.cuda.synchronize()
                counted = {k: v - before[k] for k, v in _launches().items()}
                cs = step.compiled_step
                assert cs.launches == want
                # the first call's warm-up is an eager step
                assert counted == {k: (2 if i == 0 else 1) * v
                                   for k, v in want.items()}
                with pipeline.eager():
                    refs = [step(data, r.camera, state, target)
                            for _ in range(3)]
                held.append((got, refs))
                data, state = got[1], got[2]
        finally:
            torch.use_deterministic_algorithms(False)
        spread = chip_smoke.eager_spread(torch, m, [
            pair for _, refs in held
            for pair in itertools.combinations(refs, 2)])
        for got, refs in held:
            if deterministic:
                assert not any(spread.values())
                assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
                    chip_smoke.step_items(m, got),
                    chip_smoke.step_items(m, refs[0])))
            else:
                chip_smoke.hold_step(torch, m, scene, got, refs[0], spread)
        assert cs.graph is not None and cs.pool_bytes > 0
        assert np.isfinite(float(got[0])) and float(got[0]) > 0.0


def test_a_step_broken_by_a_host_sync_raises(dev, monkeypatch):
    """A host sync inside the step (a screen pass that reads its image
    back) is legal in the eager warm-up and illegal in the capture: the
    step raises, every time, and never falls back to an eager step."""
    from madarch_tpu_torch.parallel import spmd
    from madarch_tpu_torch.render import pipeline
    real = pipeline.screen_pass

    def reads_back(*args, **kwargs):
        img = real(*args, **kwargs)
        float(img.sum())
        return img

    monkeypatch.setattr(pipeline, "screen_pass", reads_back)
    r, step, target = _step_scene("gi_mode2", dev, size=32)
    captures = spmd.CompiledStep.captures
    for _ in range(2):
        with pytest.raises(RuntimeError):
            step(r.scene_data, r.camera, r.state, target)
        assert step.compiled_step is not None
        assert step.compiled_step.graph is None
    assert spmd.CompiledStep.captures == captures


def test_a_capture_that_fails_raises(dev, monkeypatch):
    """A host sync inside the captured frame (a screen pass that reads
    its image back) is legal in the eager warm-up and illegal in the
    capture: render() raises, every time, and never falls back to an
    eager frame.  Last in this file: the failed capture is dropped."""
    from madarch_tpu_torch.render import pipeline
    real = pipeline.screen_pass

    def reads_back(*args, **kwargs):
        img = real(*args, **kwargs)
        float(img.sum())
        return img

    monkeypatch.setattr(pipeline, "screen_pass", reads_back)
    r = S.global_illumination(width=48, height=48, device=dev)
    captures = pipeline.CompiledFrame.captures
    try:
        for _ in range(2):
            with pytest.raises(RuntimeError):
                r.render()
            assert r.frame is not None and r.frame.graph is None
        assert pipeline.CompiledFrame.captures == captures
    finally:
        pipeline.clear_compiled()
