"""Port parity: the generic scene route of madarch_tpu_torch (a scene the
kernels do not take renders through the plain marches over the batched
scene distance, render/context.py) and the unfused branches of the shade
it takes, against madarch_tpu's XLA path.

The JAX package renders its XLA path on the CPU whatever the scene: its
SceneCtx packs no plan there, so every shade of it takes the unfused
branches.  The port takes them only where the geometry kernel does not
serve the scene; the route is a function of the scene's types and lights
(ops/march.py:kernel_scene, SceneCtx.fused_available).  The scene held
here is the GI room with its sphere made a user's own primitive type
(``make_primitive`` with the sphere's SDF and no planar form, no analytic
normal), so both packages take their generic route on the same data.

Tolerances, each beside the value measured when it was set:
- frames at 16² with the tiny probes, two frames of each package's
  Renderer, modes 0 to 3 and light_shafts with an 8³ froxel grid: the
  golden gates, and mean_absdiff below 1e-4 (measured at most 2.8e-8, the
  largest pixel 1.5e-5);
- the same scenes on the generic route against the port's kernel route on
  the built-in sphere (the plain versions of the kernels here) at 32²,
  under the gates (measured mean_absdiff at most 4.6e-4, at most 0.07% of
  the values above 0.05);
- direct_lighting, sample_irradiance, _reflection_geometry and
  primitive_info on seeded rays: discrete outputs (hit, material,
  visibility) equal but for near-ties, on at most 1% of the rays
  (measured 0), continuous ones to 1e-4 absolute elsewhere (measured
  9.5e-7);
- GRID_CHUNK chunking bit-equal to one evaluation;
- a light without a vec3 position (the unfused shade on a kernel scene)
  against JAX's frame: the gates, mean_absdiff below 1e-3 (measured
  5.6e-8);
- the gradient of a baked-mesh frame with respect to the primitive's
  position and the albedos against jax.grad of JAX's XLA path at 16²:
  1e-3 relative norm (measured 2.8e-7 and 2.2e-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.render import context as JCtx
from madarch_tpu.render import lighting as JL
from madarch_tpu.render import probes as JPr
from madarch_tpu.render import raymarch as jrm
from madarch_tpu.render import shading as JS
from madarch_tpu.scene import lights as JLi
from madarch_tpu.scene import primitives as JP
from madarch_tpu.scene import scene as JSc
from madarch_tpu_torch.core.config import (ProbeSettings, ShadeConfig,
                                           VolumetricsSettings)
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.ops import march as TM
from madarch_tpu_torch.render import context as TCtx
from madarch_tpu_torch.render import lighting as TL
from madarch_tpu_torch.render import probes as TPr
from madarch_tpu_torch.render import shading as TS
from madarch_tpu_torch.scene import lights as TLi
from madarch_tpu_torch.scene import primitives as TP
from madarch_tpu_torch.scene import scene as TSc
from madarch_tpu_torch.scene.scene import scene_data_from_numpy
from madarch_tpu_torch.utils.golden import image_stats
from test_torch_config import jax_config, torch_threads  # noqa: F401
from test_torch_gradient_tree import (hold, jax_tree_grads, leaf_names,
                                      port_tree_grads)

pytestmark = pytest.mark.usefixtures("torch_threads")

SIZE = 16
TINY = ProbeSettings(radiance_resolution=8, irradiance_resolution=4,
                     probe_count=(4, 2), grid_dimensions=(2, 2, 2),
                     grid_spacing=(4.0, 4.0, 4.0))
SMALL_VOL = VolumetricsSettings(visibility_resolution=(8, 8, 8),
                                visibility_step_size=0.5,
                                scattering_resolution=(12, 12),
                                scattering_step_size=0.5)
DISCRETE_MAX_FRAC = 1e-2
ATOL = 1e-4


def custom_sphere(make, sphere):
    """The sphere as a user's type: its SDF, no planar form, no normal."""
    return make("sphere", sphere.fields, sphere.sdf)


def with_type(r, ptype):
    """Renderer r with its spec's type of ptype's name swapped for ptype
    (the data, keyed by name, stays)."""
    r.base_spec = dataclasses.replace(r.base_spec, prims=tuple(
        (ptype if pt.name == ptype.name else pt, c)
        for pt, c in r.base_spec.prims))
    r._data = None
    return r


def scenes(name, mode, size=SIZE):
    """(JAX renderer, port renderer, port renderer on the built-in
    sphere) of scene ``name`` at size², with the sphere a custom type in
    the first two, screen specular mode ``mode``."""
    kw = {"volumetrics": SMALL_VOL} if name == "light_shafts" else {}
    jr = getattr(jscenes, name)(width=size, height=size,
                                probes=jax_config(TINY),
                                **{k: jax_config(v) for k, v in kw.items()})
    tr, tk = (getattr(tscenes, name)(width=size, height=size, probes=TINY,
                                     device="cpu", **kw) for _ in range(2))
    with_type(jr, custom_sphere(JP.make_primitive, JP.Sphere))
    with_type(tr, custom_sphere(TP.make_primitive, TP.Sphere))
    cfg = ShadeConfig(indirect_specular_mode=mode, max_march_steps=64,
                      render_volumetrics=name == "light_shafts")
    jr.screen_cfg = jax_config(cfg)
    tr.screen_cfg = tk.screen_cfg = cfg
    return jr, tr, tk


def _gate(img, ref):
    stats = image_stats(img, ref)
    assert not stats["breached"], stats
    return stats


def test_the_route_is_the_scenes_types():
    gi = tscenes.global_illumination(width=8, height=8, device="cpu")
    ss = tscenes.simple_scene(width=8, height=8, device="cpu")
    mesh = tscenes.obj_mesh(width=8, height=8, device="cpu",
                            obj_path=tscenes.TORUS_OBJ)
    for r in (gi, ss, mesh):
        assert TM.kernel_scene(r.spec)
        assert TCtx.SceneCtx(r.spec, r.scene_data).fused_available
    bvh = tscenes.bvh_test(width=8, height=8, device="cpu", n_spheres=4)
    baked = tscenes.obj_mesh(width=8, height=8, device="cpu",
                             obj_path=tscenes.TORUS_OBJ, mode="baked",
                             bake_dims=(8, 8, 8))
    room = with_type(tscenes.global_illumination(width=8, height=8,
                                                 device="cpu"),
                     custom_sphere(TP.make_primitive, TP.Sphere))
    for r in (bvh, baked, room):
        assert not TM.kernel_scene(r.spec)
        ctx = TCtx.SceneCtx(r.spec, r.scene_data)
        assert not ctx.use_kernel and not ctx.fused_available
        with pytest.raises(ValueError):
            ctx.geometry(torch.zeros((1, 3)), torch.ones((1, 3)),
                         r.probes, r.screen_cfg)
    # a type in two runs, and no live primitive, are not kernel scenes
    spec = gi.spec
    assert not TM.kernel_scene(dataclasses.replace(
        spec, prims=spec.prims + ((TP.Plane, 2),),
        live_prims=spec.live_prims + (2,)))
    assert not TM.kernel_scene(dataclasses.replace(
        spec, live_prims=(0,) * len(spec.prims)))


def test_a_generic_scene_never_packs(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("pack_scene called on a generic scene")

    monkeypatch.setattr(TM, "pack_scene", refuse)
    r = tscenes.bvh_test(width=8, height=8, probes=TINY, device="cpu",
                         n_spheres=4)
    r.screen_cfg = ShadeConfig(max_march_steps=32)
    img = r.render()
    assert img.shape == (8, 8, 3) and bool(torch.isfinite(img).all())


FRAMES = [("global_illumination", 0), ("global_illumination", 1),
          ("global_illumination", 2), ("global_illumination", 3),
          ("light_shafts", 2)]


@pytest.mark.parametrize("name,mode", FRAMES)
def test_custom_type_frame_matches_jax(name, mode):
    jr, tr, _ = scenes(name, mode)
    assert not TM.kernel_scene(tr.spec)
    for _ in range(2):
        ref = np.asarray(jr.render())
        img = tr.render().numpy()
    stats = _gate(img, ref)
    assert stats["mean_absdiff"] < 1e-4, stats
    assert float(ref.var()) > 0.0


@pytest.mark.parametrize("name,mode", FRAMES)
def test_custom_type_frame_matches_the_kernel_route(name, mode):
    """The generic route against the kernel route on the built-in sphere
    (the plain versions of the kernels here), at 32²: at 16² the camera's
    row 6 runs exactly along the box's top front edge (y = 1.5, z = 2.5),
    where the kernel's tetrahedron FD normal blends the two faces and the
    autodiff normal takes one: 7 and 6 of 256 pixels differ past 0.05 in
    modes 2 and 3, the kernel route's known difference from the JAX
    package's XLA path (ROADMAP C4), the same against JAX's frame of the
    built-in sphere."""
    _, tr, tk = scenes(name, mode, size=32)
    assert TM.kernel_scene(tk.spec)
    for _ in range(2):
        img = tr.render().numpy()
        kernel_route = tk.render().numpy()
    _gate(img, kernel_route)
    assert not np.array_equal(img, kernel_route)


# ---------------------------------------------------------------------------
# The unfused branches one by one, on seeded rays of the custom-type room
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def room():
    """The custom-type GI room in both packages after two JAX frames, and
    seeded rays from the camera's position with their JAX hits."""
    jr, tr, _ = scenes("global_illumination", 2)
    jr.converge(frames=2)
    tree = jax.tree.map(np.asarray, jr.scene_data)
    data = scene_data_from_numpy(tree, "cpu")
    state = jax.tree.map(np.asarray, jr.state)
    rng = np.random.RandomState(17)
    n = 512
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.broadcast_to(np.asarray([2.0, 2.0, 0.5], np.float32),
                        (n, 3)).copy()
    jctx = JCtx.SceneCtx(jr.spec, jr.scene_data)
    t, hit, pos = jrm.raycast(jctx, jnp.asarray(o), jnp.asarray(d), 20.0)
    normal = jrm.scene_normal(jctx.sdf_b_diff, pos)
    return SimpleRoom(jr, tr, data, state, o, d,
                      *(np.asarray(x) for x in (hit, pos, normal)))


@dataclasses.dataclass
class SimpleRoom:
    jr: object
    tr: object
    data: object
    state: object
    o: np.ndarray
    d: np.ndarray
    hit: np.ndarray
    pos: np.ndarray
    normal: np.ndarray


def _ctxs(room):
    return (JCtx.SceneCtx(room.jr.spec, room.jr.scene_data),
            TCtx.SceneCtx(room.tr.spec, room.data))


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def _hold(got, ref, discrete=False):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    if discrete:
        assert (got != ref).mean() <= DISCRETE_MAX_FRAC
        return
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_direct_lighting_marches_its_shadows_like_jax(room):
    jctx, tctx = _ctxs(room)
    jm = room.jr.scene_data.materials
    albedo, metallic, rough = (np.asarray(jm[k])[3] for k in
                               ("albedo", "metallic", "roughness"))
    n = room.pos.shape[0]
    args = [room.pos, room.normal, room.d,
            np.tile(albedo, (n, 1)), np.full(n, metallic, np.float32),
            np.full(n, rough, np.float32)]
    ref = JL.direct_lighting(room.jr.spec, room.jr.scene_data, jctx,
                             *(jnp.asarray(a) for a in args),
                             compute_specular=True,
                             enabled=jnp.asarray(room.hit), max_steps=300)
    got = TL.direct_lighting(room.tr.spec, room.data,
                             *(_t(a) for a in args), compute_specular=True,
                             enabled=_t(room.hit), ctx=tctx, max_steps=300)
    _hold(got.numpy(), ref)
    assert float(np.abs(np.asarray(ref)).max()) > 0.0


def test_sample_irradiance_marches_its_visibility_like_jax(room):
    jctx, tctx = _ctxs(room)
    irr = room.state.irradiance
    ref = JPr.sample_irradiance(jax_config(TINY), jctx, jnp.asarray(irr),
                                jnp.asarray(room.pos),
                                jnp.asarray(room.normal),
                                enabled=jnp.asarray(room.hit), max_steps=300)
    got = TPr.sample_irradiance(TINY, _t(irr), _t(room.pos),
                                _t(room.normal), ctx=tctx,
                                enabled=_t(room.hit), max_steps=300)
    _hold(got.numpy(), ref)
    assert float(np.abs(np.asarray(ref)).max()) > 0.0


@pytest.mark.parametrize("differentiable", [False, True])
def test_reflection_geometry_unfused_matches_jax(room, differentiable):
    jctx, tctx = _ctxs(room)
    cfg = ShadeConfig(differentiable=differentiable)
    spec_dir = room.d - 2.0 * (room.d * room.normal).sum(-1)[:, None] \
        * room.normal
    from_ = room.pos + room.normal * TS.SURFACE_OFFSET
    en = room.hit
    ref = JS._reflection_geometry(
        room.jr.spec, room.jr.scene_data, jax_config(TINY), jax_config(cfg),
        jctx, jnp.asarray(from_), jnp.asarray(spec_dir),
        enabled=jnp.asarray(en))
    got = TS._reflection_geometry(
        room.tr.spec, room.data, TINY, cfg, tctx, _t(from_), _t(spec_dir),
        enabled=_t(en))
    assert ref[5] is None and got[5] is None
    hit, jhit = got[0].numpy(), np.asarray(ref[0])
    _hold(hit, jhit, discrete=True)
    both = hit & jhit
    for k in (1, 2):
        _hold(got[k].detach().numpy()[both], np.asarray(ref[k])[both])
    _hold(got[3].numpy()[both], np.asarray(ref[3])[both], discrete=True)
    _hold(got[4].numpy(), ref[4], discrete=True)
    assert both.sum() > 100


def test_primitive_info_matches_jax(room):
    rng = np.random.RandomState(23)
    spec = room.jr.spec
    n = 1024
    index = rng.randint(-1, spec.total_prim_capacity + 2, n).astype(np.int32)
    p = rng.uniform(-1.0, 7.0, (n, 3)).astype(np.float32)
    jn, jm = jax.vmap(lambda i, q: JSc.primitive_info(
        spec, room.jr.scene_data, i, q))(jnp.asarray(index), jnp.asarray(p))
    with torch.no_grad():
        tn, tm = TSc.primitive_info(room.tr.spec, room.data, _t(index), _t(p))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _hold(tn.numpy(), jn)
    assert tm.dtype == torch.int32


def test_grid_chunks_equal_one_evaluation(monkeypatch):
    """200 live slots of a custom type at 40,000 points: sdf_b evaluates
    GRID_CHUNK points at a time, bit for bit the unchunked distance."""
    rng = np.random.RandomState(29)
    ball = custom_sphere(TP.make_primitive, TP.Sphere)
    spec = TSc.SceneSpec(prims=((ball, 200), (TP.Plane, 2)),
                         lights=((TLi.PointLight, 1),)
                         ).specialized({"sphere": 200, "plane": 2},
                                       {"point_light": 1})
    b = TSc.SceneBuilder(spec)
    for c in rng.uniform(0.0, 6.0, (200, 3)):
        b.add_primitive(ball, center=c, radius=0.2, material_id=0)
    b.add_primitive(TP.Plane, normal=(0.0, 1.0, 0.0), offset=1.0,
                    material_id=0)
    b.add_primitive(TP.Plane, normal=(1.0, 0.0, 0.0), offset=1.0,
                    material_id=0)
    data = b.device_data("cpu")
    p = torch.as_tensor(rng.uniform(-1.0, 7.0, (40_000, 3)).astype(
        np.float32))
    calls = []
    real = TCtx.scene_sdf
    monkeypatch.setattr(TCtx, "scene_sdf",
                        lambda *a: calls.append(a[2].shape[0]) or real(*a))
    got = TCtx.SceneCtx(spec, data).sdf_b(p)
    assert calls == [TM.GRID_CHUNK, 40_000 - TM.GRID_CHUNK]
    assert torch.equal(got, real(spec, data, p))


def _lamp(lights, vm, **extra):
    """A point light whose position field is named ``origin``: no vec3
    'position', so no fused geometry launch takes the scene."""
    def sample(params, pos, normal):
        to_l = params["origin"] - pos
        dist = vm.length(to_l)
        radiance = params["color"] / (dist * dist * 0.03)[..., None]
        return radiance, to_l / dist[..., None], dist
    return lights.LightType(name="lamp", fields=(
        ("origin", "vec3"), ("color", "vec3")), sample=sample, **extra)


def test_a_light_without_position_renders_unfused_like_jax():
    """The GI room lit by a point light whose position field has another
    name: a kernel scene whose shade takes the unfused branches (the
    kernels march each light slot's shadows and the corners' visibility),
    against the JAX package's frame."""
    from madarch_tpu.core import vecmath as jvm
    from madarch_tpu_torch.core import vecmath as tvm
    rs = []
    # the JAX package's light types name a position function for its
    # volumetric pass, which this scene does not run
    for pkg, scenes_mod, lamp, kw in (
            ("jax", jscenes, _lamp(JLi, jvm,
                                   position=lambda params: params["origin"]),
             {"probes": jax_config(TINY)}),
            ("torch", tscenes, _lamp(TLi, tvm),
             {"probes": TINY, "device": "cpu"})):
        r = scenes_mod.global_illumination(width=SIZE, height=SIZE, **kw)
        r.base_spec = dataclasses.replace(r.base_spec, lights=((lamp, 1),))
        r.builder.spec = r.base_spec
        r.builder._lights = {"lamp": {
            "origin": np.zeros((1, 3), np.float32),
            "color": np.zeros((1, 3), np.float32)}}
        r.builder._light_counts = {"lamp": 0}
        r.add_light(lamp, origin=(5.0, 3.0, 6.0), color=(0.9, 0.9, 0.9))
        cfg = ShadeConfig(max_march_steps=64)
        r.screen_cfg = jax_config(cfg) if pkg == "jax" else cfg
        rs.append(r)
    jr, tr = rs
    ctx = TCtx.SceneCtx(tr.spec, tr.scene_data)
    assert ctx.use_kernel and not ctx.fused_available
    for _ in range(2):
        ref = np.asarray(jr.render())
        img = tr.render().numpy()
    stats = _gate(img, ref)
    assert stats["mean_absdiff"] < 1e-3, stats
    assert float(ref.mean()) > 0.05


def test_differentiable_generic_route_matches_jax_grad():
    """obj_mesh's baked torus (bake 16³) at 16², specular mode 2 with AO,
    both passes differentiable: the frame's MSE against black, its
    gradient with respect to the baked primitive's position and the
    albedos against jax.grad of the JAX package's XLA path."""
    probes = ProbeSettings(radiance_resolution=8, irradiance_resolution=4,
                           probe_count=(6, 6), grid_dimensions=(3, 3, 4),
                           grid_spacing=(2.0, 3.0, 3.0))
    kw = dict(width=SIZE, height=SIZE, obj_path=tscenes.TORUS_OBJ,
              mode="baked", bake_dims=(16, 16, 16))
    jr = jscenes.obj_mesh(probes=jax_config(probes), **kw)
    tr = tscenes.obj_mesh(probes=probes, device="cpu", **kw)
    jr.converge(frames=2)
    names = leaf_names(jr.scene_data)
    pick = [i for i, nm in enumerate(names)
            if nm.endswith("['suzanne_sdf']['position']")
            or nm.endswith("['albedo']")]
    assert len(pick) == 2
    ref = jax_tree_grads(jr, probes, 2, select=pick)
    data = scene_data_from_numpy(jax.tree.map(np.asarray, jr.scene_data),
                                 "cpu")
    state = tr.state.__class__.from_numpy(jax.tree.map(np.asarray, jr.state),
                                          "cpu")
    got = port_tree_grads(tr, data, state, probes, 2)
    got = [got[i] for i in pick]
    hold([names[i] for i in pick], ref, got)
    assert all(np.abs(g).max() > 0 for g in ref)
