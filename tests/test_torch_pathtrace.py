"""Port parity: madarch_tpu_torch/render/pathtrace.py (pixel_color_direct,
pixel_color_many, pixel_color_path) against madarch_tpu/render/
pathtrace.py on its XLA path, the JAX package's default on the CPU.

The same rays go through both packages, on tests/test_render_modes.py's
scene (a sphere, a plane, a point light; 12²) and the global_illumination
room at 16² with the tiny probes.  The random draws are made equal: the
port's ``sampling.uniform`` is replaced by a queue of the uniforms the JAX
package draws for the same key sequence (its key splits reproduced here),
so each port sampler transforms JAX's own numbers.

Tolerances, each beside the value measured when it was set: per pixel
and channel 1e-4 before tonemapping, on all but at most 1% of the pixels
(near-ties, ROADMAP C3; measured: no pixel beyond, largest difference
2.9e-7); the tonemapped images also under the golden gates.  The GI
room's direct and path images are black at 16²: no pixel sees the spot's
cone directly, and a path never leaves its first hit (the kept t = 0
segments), so only its many-sample image holds light there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.render import pathtrace as JPT
from madarch_tpu.scene import lights as JL
from madarch_tpu.scene import primitives as JP
from madarch_tpu.scene import scene as JS
from madarch_tpu_torch.core.config import ProbeSettings
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.ops import march as TM
from madarch_tpu_torch.render import context as TCtx
from madarch_tpu_torch.render import pathtrace as TPT
from madarch_tpu_torch.render import sampling as TSa
from madarch_tpu_torch.render.camera import camera_rays, pixel_grid
from madarch_tpu_torch.render.shading import sky_color
from madarch_tpu_torch.scene import lights as TL
from madarch_tpu_torch.scene import primitives as TP
from madarch_tpu_torch.scene.scene import SceneSpec, scene_data_from_numpy
from madarch_tpu_torch.utils.golden import image_stats
from test_torch_config import jax_config, torch_threads  # noqa: F401
from test_torch_generic_route import custom_sphere, with_type

pytestmark = pytest.mark.usefixtures("torch_threads")

TINY = ProbeSettings(radiance_resolution=8, irradiance_resolution=4,
                     probe_count=(4, 2), grid_dimensions=(2, 2, 2),
                     grid_spacing=(4.0, 4.0, 4.0))
ATOL = 1e-4
TIE_MAX_FRAC = 1e-2
MAX_STEPS = 300
SAMPLES = 4
BOUNCES = 2


def _modes_scene():
    """(JAX spec, JAX data, port spec, port data, origins, dirs):
    tests/test_render_modes.py's scene and its 12² camera rays."""
    jspec = JS.SceneSpec(prims=((JP.Sphere, 2), (JP.Plane, 2)),
                         lights=((JL.PointLight, 1),))
    b = JS.SceneBuilder(jspec)
    b.add_material((0.8, 0.4, 0.2), 0.1, 0.5)
    b.add_primitive(JP.Sphere, center=(0.0, 0.0, 4.0), radius=1.0,
                    material_id=0)
    b.add_primitive(JP.Plane, normal=(0.0, 1.0, 0.0), offset=2.0,
                    material_id=0)
    b.add_light(JL.PointLight, position=(1.0, 4.0, 1.0),
                color=(0.9, 0.9, 0.9))
    jdata = b.device_data()
    tspec = SceneSpec(prims=((TP.Sphere, 2), (TP.Plane, 2)),
                      lights=((TL.PointLight, 1),))
    tdata = scene_data_from_numpy(jax.tree.map(np.asarray, jdata), "cpu")
    o, d = camera_rays(pixel_grid(12, 12, "cpu"), torch.zeros(3),
                       torch.eye(3))
    return jspec, jdata, tspec, tdata, o.reshape(-1, 3), d.reshape(-1, 3)


def _renderer_scene(jr, tr):
    data = scene_data_from_numpy(jax.tree.map(np.asarray, jr.scene_data),
                                 "cpu")
    cam = tr.camera
    o, d = camera_rays(pixel_grid(tr.width, tr.height, "cpu"), cam.position,
                       cam.orientation)
    return jr.spec, jr.scene_data, tr.spec, data, o.reshape(-1, 3), \
        d.reshape(-1, 3)


def _gi_scene(size=16):
    return _renderer_scene(
        jscenes.global_illumination(width=size, height=size,
                                    probes=jax_config(TINY)),
        tscenes.global_illumination(width=size, height=size, probes=TINY,
                                    device="cpu"))


def _generic_scene(size=16):
    """The GI room with its sphere a user's own type (no planar form): both
    packages on their generic route."""
    jr = jscenes.global_illumination(width=size, height=size,
                                     probes=jax_config(TINY))
    tr = tscenes.global_illumination(width=size, height=size, probes=TINY,
                                     device="cpu")
    with_type(jr, custom_sphere(JP.make_primitive, JP.Sphere))
    with_type(tr, custom_sphere(TP.make_primitive, TP.Sphere))
    return _renderer_scene(jr, tr)


SCENES = {"modes": _modes_scene, "gi": _gi_scene, "generic": _generic_scene}


def jax_uniforms(key, n, iters):
    """The uniforms the JAX package's sample or bounce loop draws from
    ``key``, in the port's order: per iteration u (k1), the direction's
    two (k2 split) and the perturbation's two (k3 split)."""
    out = []
    for _ in range(iters):
        key, k1, k2, k3 = jax.random.split(key, 4)
        out.append(jax.random.uniform(k1, (n,)))
        for k in (k2, k3):
            ka, kb = jax.random.split(k)
            out += [jax.random.uniform(ka, (n,)),
                    jax.random.uniform(kb, (n,))]
    return [torch.as_tensor(np.array(x)) for x in out]


def feed(monkeypatch, queue):
    """Replaces the port's draws by ``queue``, in order."""
    def draw(generator, shape, device):
        return queue.pop(0).reshape(shape).to(device)
    monkeypatch.setattr(TSa, "uniform", draw)


def hold(got, ref):
    """got and ref f32[N, 3] before tonemapping: per pixel within ATOL off
    near-ties (at most TIE_MAX_FRAC of the pixels), and the tonemapped
    images under the golden gates.  Returns the largest difference."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.isfinite(got).all()
    diff = np.abs(got - ref).max(axis=-1)
    assert (diff > ATOL).mean() <= TIE_MAX_FRAC, np.sort(diff)[-8:]

    def tone(x):
        x = np.maximum(x, 0.0)
        return ((x + 1e-8) / (x + 1.0)) ** 0.4545
    stats = image_stats(tone(got)[None], tone(ref)[None])
    assert not stats["breached"], stats
    return float(diff.max())


@pytest.mark.parametrize("scene", list(SCENES))
def test_pixel_color_direct_matches_jax(scene):
    jspec, jdata, tspec, tdata, o, d = SCENES[scene]()
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    ref = jax.jit(lambda dat: JPT.pixel_color_direct(
        jspec, dat, jo, jd, max_steps=MAX_STEPS))(jdata)
    got = TPT.pixel_color_direct(tspec, tdata, o, d, max_steps=MAX_STEPS)
    assert not got.requires_grad
    hold(got, ref)
    if scene == "modes":
        assert float(np.asarray(ref).std()) > 1e-4


@pytest.mark.parametrize("scene", list(SCENES))
def test_pixel_color_many_matches_jax(scene, monkeypatch):
    jspec, jdata, tspec, tdata, o, d = SCENES[scene]()
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    key = jax.random.PRNGKey(3)
    ref = jax.jit(lambda dat, k: JPT.pixel_color_many(
        jspec, dat, jo, jd, k, gi_samples=SAMPLES,
        max_steps=MAX_STEPS))(jdata, key)
    queue = jax_uniforms(key, o.shape[0], SAMPLES)
    feed(monkeypatch, queue)
    got = TPT.pixel_color_many(tspec, tdata, o, d, gi_samples=SAMPLES,
                               max_steps=MAX_STEPS)
    assert not queue
    hold(got, ref)
    # the bounces add light over the direct term alone
    direct = TPT.pixel_color_direct(tspec, tdata, o, d, ao_steps=0,
                                    max_steps=MAX_STEPS)
    assert float(got.sum()) > float(direct.sum())


@pytest.mark.parametrize("scene", list(SCENES))
def test_pixel_color_path_matches_jax(scene, monkeypatch):
    jspec, jdata, tspec, tdata, o, d = SCENES[scene]()
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    key = jax.random.PRNGKey(4)
    ref = jax.jit(lambda dat, k: JPT.pixel_color_path(
        jspec, dat, jo, jd, k, gi_bounces=BOUNCES,
        max_steps=MAX_STEPS))(jdata, key)
    # the port draws nothing after the last segment
    queue = jax_uniforms(key, o.shape[0], BOUNCES)
    feed(monkeypatch, queue)
    got = TPT.pixel_color_path(tspec, tdata, o, d, gi_bounces=BOUNCES,
                               max_steps=MAX_STEPS)
    assert not queue
    hold(got, ref)


def test_a_missing_segment_adds_the_sky_on_every_remaining_bounce():
    """Reference behaviour kept (render_path.glsl:36-38, ROADMAP C): a
    primary ray that misses adds the sky unmasked on each of the
    gi_bounces + 1 segments, as it goes on unchanged and misses again."""
    _, _, tspec, tdata, o, d = _modes_scene()
    out = TPT.pixel_color_path(tspec, tdata, o, d,
                               torch.Generator().manual_seed(0),
                               gi_bounces=BOUNCES, max_steps=MAX_STEPS)
    ctx = TCtx.SceneCtx(tspec, tdata)
    _, hit, _ = ctx.raycast(o, d, tspec.max_dist, max_steps=MAX_STEPS)
    miss = ~hit
    assert int(miss.sum()) > 0
    torch.testing.assert_close(out[miss], (BOUNCES + 1) * sky_color(d[miss]),
                               rtol=1e-6, atol=1e-6)


def test_the_next_segment_starts_on_the_surface(monkeypatch):
    """Reference behaviour kept (pathtrace.py:125, ROADMAP C): a segment
    after a hit starts at the hit itself, with no surface offset, so the
    raycast's first step sits within eps of the surface and it hits again
    at t = 0 on every later segment."""
    _, _, tspec, tdata, o, d = _modes_scene()
    casts = []
    real = TCtx.SceneCtx.raycast

    def record(self, origins, dirs, max_dist, **kwargs):
        out = real(self, origins, dirs, max_dist, **kwargs)
        casts.append(out[:2])
        return out

    monkeypatch.setattr(TCtx.SceneCtx, "raycast", record)
    TPT.pixel_color_path(tspec, tdata, o, d,
                         torch.Generator().manual_seed(1),
                         gi_bounces=BOUNCES, max_steps=MAX_STEPS)
    assert len(casts) == BOUNCES + 1
    first_hit = casts[0][1]
    assert int(first_hit.sum()) > 0
    for t, hit in casts[1:]:
        assert bool(hit[first_hit].all())
        assert bool((t[first_hit] == 0.0).all())


def test_a_generic_scene_launches_no_kernel(monkeypatch):
    """On a scene the kernels do not take the path tracers run the plain
    marches over sdf_b (SceneCtx.use_kernel false), as the JAX package
    runs its XLA path."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper ran on a generic scene")

    for name in ("raycast", "softshadows", "visibility", "geometry"):
        monkeypatch.setattr(TM, name, refuse)
    _, _, tspec, tdata, o, d = _generic_scene(size=8)
    assert not TCtx.SceneCtx(tspec, tdata).use_kernel
    gen = torch.Generator().manual_seed(2)
    for out in (TPT.pixel_color_direct(tspec, tdata, o, d),
                TPT.pixel_color_many(tspec, tdata, o, d, gen, gi_samples=2),
                TPT.pixel_color_path(tspec, tdata, o, d, gen, gi_bounces=1)):
        assert out.shape == o.shape and bool(torch.isfinite(out).all())


def test_a_generator_seeds_the_frame():
    """The same seed renders the same frame, another seed another."""
    _, _, tspec, tdata, o, d = _modes_scene()

    def frame(seed):
        return TPT.pixel_color_many(tspec, tdata, o, d,
                                    torch.Generator().manual_seed(seed),
                                    gi_samples=2, max_steps=64)
    a, b, c = frame(5), frame(5), frame(6)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_direct_is_differentiable_like_jax():
    """With the scene's floats requiring gradients the direct mode carries
    them (the hit reattached by the implicit function theorem, the normal
    the autodiff one): d Σ color / d albedo and d / d the light's position
    against jax.grad, to 1e-4 relative norm (measured 9.6e-8); without,
    its output holds no graph."""
    jspec, jdata, tspec, tdata, o, d = _modes_scene()
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())

    def jloss(albedo, lpos):
        dat = dataclasses.replace(
            jdata, materials=dict(jdata.materials, albedo=albedo),
            lights={"point_light": dict(jdata.lights["point_light"],
                                        position=lpos)})
        return jnp.sum(JPT.pixel_color_direct(jspec, dat, jo, jd,
                                              max_steps=MAX_STEPS))

    jg = jax.grad(jloss, argnums=(0, 1))(
        jdata.materials["albedo"], jdata.lights["point_light"]["position"])
    albedo = tdata.materials["albedo"].clone().requires_grad_(True)
    lpos = tdata.lights["point_light"]["position"].clone() \
        .requires_grad_(True)
    dat = dataclasses.replace(
        tdata, materials=dict(tdata.materials, albedo=albedo),
        lights={"point_light": dict(tdata.lights["point_light"],
                                    position=lpos)})
    out = TPT.pixel_color_direct(tspec, dat, o, d, max_steps=MAX_STEPS)
    grads = torch.autograd.grad(out.sum(), (albedo, lpos))
    for g, r in zip(grads, jg):
        r = np.asarray(r)
        rel = np.linalg.norm(g.numpy() - r) / np.linalg.norm(r)
        assert rel < 1e-4, rel
