"""Port parity: the differentiable path of madarch_tpu_torch against
madarch_tpu: render/raymarch.py's attach_hit_gradient and scene_normal, and
whole-frame gradients of the differentiable shade (render/shading.py).

The port marches through its kernels' plain versions here, under stop
gradient, and gradients re-enter through the implicit-function-theorem hit
distance and the autodiff normal, as in the JAX package.  The JAX package
renders its XLA path on the CPU unless MADARCH_FORCE_PALLAS=1, which runs
its Pallas kernels in interpret mode.  The two paths differ in their
gradients where AO is on (the XLA path's AO is differentiable, the
kernel's a constant) and in mode 3 (the XLA path's reflection normal is
the autodiff one).  The port's path is the kernel path, so it is held here
to the XLA path on tests/test_differentiability.py's scene, which has no
AO: its four finite-difference checks, jax.grad and gradients.npz.  Mode
3's geometry gradient, which the JAX kernel path cannot take, is held by
central differences of the port's loss; tests/test_torch_gradient_tree.py
holds the GI frame's whole gradient tree to the JAX kernel path.

Tolerances, each beside the value measured when it was set (this host):
- finite differences: tests/test_differentiability.py's eps and rtol
  (measured: radius 1.7e-2, albedo 2.8e-4, light height 1.40e-1, camera z
  1.1e-3 relative; the JAX package's own checks measure 1.7e-2, 2.8e-4,
  1.37e-1 and 6.6e-4: the light height's difference quotient crosses a
  shadow edge in both); mode 3's radius at rtol 0.25, the radius check's
  (8.4e-2);
- jax.grad and gradients.npz on the four scalars: rtol 1e-4 and 1e-3
  (measured 4.8e-7 at most);
- scene_normal and attach_hit_gradient, values and vector-Jacobian
  products against JAX's on seeded inputs: 1e-5 relative norm (measured
  2.7e-7 at most);
- the GI tree with a probe inside the box, on the leaves where JAX's are
  finite: 1e-3 relative norm, as tests/test_torch_gradient_tree.py.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_differentiability as jd
from madarch_tpu.examples import scenes as jscenes
from madarch_tpu.parallel import spmd as jspmd
from madarch_tpu.render import raymarch as jrm
from madarch_tpu.render.shading import make_sdf_b as j_make_sdf_b
from madarch_tpu.scene.scene import scene_sdf as j_scene_sdf
from madarch_tpu_torch.core.config import (NO_VOLUMETRICS, ProbeSettings,
                                           ShadeConfig)
from madarch_tpu_torch.examples import scenes as tscenes
from madarch_tpu_torch.parallel import spmd as tspmd
from madarch_tpu_torch.render import pipeline as TPL
from madarch_tpu_torch.render import raymarch as trm
from madarch_tpu_torch.render.camera import camera_rays, pixel_grid
from madarch_tpu_torch.render.shading import make_sdf_b, pixel_color
from madarch_tpu_torch.scene import lights as L
from madarch_tpu_torch.scene import primitives as P
from madarch_tpu_torch.scene.scene import (SceneSpec, scene_data_from_numpy,
                                           scene_sdf)
from test_torch_config import torch_threads  # noqa: F401
from test_torch_gradient_tree import (FAST, SIZE, cfgs, gi_scene, hold,
                                      jax_tree_grads, leaf_names,
                                      port_tree_grads, rel_norm)

pytestmark = pytest.mark.usefixtures("torch_threads")

# ---------------------------------------------------------------------------
# tests/test_differentiability.py's scene, sizes, eps and rtol
# ---------------------------------------------------------------------------

SPEC = SceneSpec(prims=((P.Sphere, 2), (P.Plane, 2)),
                 lights=((L.PointLight, 1),))
DATA = scene_data_from_numpy(jax.tree.map(np.asarray, jd.DATA), "cpu")
PROBES = ProbeSettings(**dataclasses.asdict(jd.PROBES))
CFG = ShadeConfig(**dataclasses.asdict(jd.CFG))
W = H = jd.W
GRADIENT_GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "goldens", "gradients.npz")

# name: (leaf path, index, value, eps, rtol, interior pixels only)
CASES = {
    "sphere_radius": (("prims", "sphere", "radius"), (0,), 1.0, 2e-3, 0.25,
                      True),
    "albedo_r": (("materials", "albedo"), (0, 0), 0.8, 1e-3, 0.05, False),
    "light_y": (("lights", "point_light", "position"), (0, 1), 4.0, 2e-3,
                0.15, False),
    "camera_z": (None, None, -0.5, 2e-3, 0.2, False),
}


def _with_leaf(data, path, leaf):
    """data with the leaf at ``path`` replaced (nothing else copied)."""
    if path[0] == "materials":
        return dataclasses.replace(
            data, materials={**data.materials, path[1]: leaf})
    group = getattr(data, path[0])
    return dataclasses.replace(data, **{path[0]: {
        **group, path[1]: {**group[path[1]], path[2]: leaf}}})


def _leaf(data, path):
    node = getattr(data, path[0])
    for key in path[1:]:
        node = node[key]
    return node


# tests/test_differentiability.py's interior pixels: central pixels,
# strictly inside the sphere's silhouette (rows, then columns)
C = W // 2
INTERIOR = (C - 2, C + 2, C - 2, C + 2)


def render_loss(data, cam_z=0.0, cfg=CFG, crop=None):
    """The port's twin of tests/test_differentiability.py:render_loss, over
    the pixels of ``crop`` (all without one)."""
    cam_z = torch.as_tensor(cam_z, dtype=torch.float32)
    cam = TPL.Camera(position=torch.stack([torch.zeros(()), torch.zeros(()),
                                           cam_z]),
                     orientation=torch.eye(3))
    state = TPL.initial_state(PROBES, NO_VOLUMETRICS, "cpu")
    img, _ = TPL.render_frame(SPEC, PROBES, NO_VOLUMETRICS, W, H, data, cam,
                              state, screen_cfg=cfg, probe_cfg=cfg)
    if crop is not None:
        img = img[crop[0]:crop[1], crop[2]:crop[3]]
    return img.mean()


def port_loss_of(name, cfg=CFG, crop=None):
    """v (a scalar tensor) -> the port's loss with case ``name``'s scalar
    set to v, over ``crop`` (else the case's pixels)."""
    path, idx, _, _, _, interior = CASES[name]
    if crop is None and interior:
        crop = INTERIOR

    def loss_of(v):
        if path is None:
            return render_loss(DATA, cam_z=v, cfg=cfg, crop=crop)
        leaf = _leaf(DATA, path).clone()
        leaf[idx] = v
        return render_loss(_with_leaf(DATA, path, leaf), cfg=cfg, crop=crop)
    return loss_of


def port_grad(loss_of, value):
    v = torch.tensor(value, dtype=torch.float32, requires_grad=True)
    g, = torch.autograd.grad(loss_of(v), v)
    return float(g)


def fd_check(loss_of, value, eps, rtol):
    """tests/test_differentiability.py:_fd_check on the port."""
    g = port_grad(loss_of, value)
    with torch.no_grad():
        fd = float(loss_of(torch.tensor(value + eps))
                   - loss_of(torch.tensor(value - eps))) / (2 * eps)
    assert np.isfinite(g), "gradient is not finite"
    assert abs(fd) > 1e-7, "finite difference is degenerate"
    np.testing.assert_allclose(g, fd, rtol=rtol)
    return g


@pytest.mark.parametrize("name", list(CASES))
def test_port_gradient_matches_finite_difference(name):
    _, _, value, eps, rtol, _ = CASES[name]
    fd_check(port_loss_of(name), value, eps, rtol)


def _jax_loss_of(name):
    path, idx, _, _, _, interior = CASES[name]

    def loss_of(v):
        if path is None:
            return jd.render_loss(jd.DATA, cam_z=v)
        leaf = _leaf(jd.DATA, path).at[idx].set(v)
        return jd.render_loss(jd._set(jd.DATA, path, leaf),
                              interior_only=interior)
    return loss_of


@pytest.fixture(scope="module")
def jax_grads():
    """jax.grad of each case's loss on the JAX package's XLA path, as
    tools/make_goldens.py:gradient_goldens takes them."""
    return {name: float(jax.grad(jax.jit(_jax_loss_of(name)))(
        jnp.float32(CASES[name][2]))) for name in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_port_gradient_matches_jax_grad(jax_grads, name):
    got = port_grad(port_loss_of(name), CASES[name][2])
    np.testing.assert_allclose(got, jax_grads[name], rtol=1e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_port_gradient_matches_golden(name):
    ref = np.load(GRADIENT_GOLDENS)[name]
    got = port_grad(port_loss_of(name), CASES[name][2])
    np.testing.assert_allclose(got, ref, rtol=1e-3,
                               err_msg=f"d(loss)/d({name})")


def test_mode3_radius_matches_finite_difference():
    """Mode 3's geometry gradient, which the JAX kernel path cannot take,
    by central differences of the port's loss (AO off).  Crop: the upper
    interior of the sphere, whose mirror reflections leave the scene (the
    sky's colour is a function of the reflected direction alone).  Lower
    pixels reflect the floor, where the reflection hit keeps its march
    distance stop-gradient, as in the JAX package's kernel path, so their
    gradient leaves out how that hit slides along the floor."""
    cfg = dataclasses.replace(CFG, indirect_specular_mode=3,
                              add_indirect_specular=True)
    fd_check(port_loss_of("sphere_radius", cfg=cfg,
                          crop=(C, C + 3, C - 2, C + 2)), 1.0, 2e-3, 0.25)


# ---------------------------------------------------------------------------
# scene_normal and attach_hit_gradient (tests/test_raymarch.py:120-160)
# ---------------------------------------------------------------------------

def sphere_floor_sdf(p):
    """Unit sphere at (0,0,5) + floor plane y=-1."""
    sph = torch.linalg.vector_norm(p - torch.tensor([0.0, 0.0, 5.0]),
                                   dim=-1) - 1.0
    return torch.minimum(sph, p[..., 1] + 1.0)


def test_scene_normal():
    n = trm.scene_normal(sphere_floor_sdf, torch.tensor([[0.0, 0.0, 4.0]]))
    np.testing.assert_allclose(n[0].detach().numpy(), [0.0, 0.0, -1.0],
                               atol=1e-5)


def _march_t(center, radius, dirs, eps):
    """t of the port's plain raycast to a sphere of ``radius`` (a tensor)
    at ``center``, reattached by the implicit function theorem."""
    origins = torch.zeros((1, 3))

    def sdf(p):
        return torch.linalg.vector_norm(p - torch.tensor(center),
                                        dim=-1) - radius

    t, _, _ = trm.raycast(sdf, origins, dirs, 20.0, eps=eps)
    return trm.attach_hit_gradient(sdf, origins, dirs, t)[0]


def test_attach_hit_gradient_matches_finite_difference():
    """dt/d(radius) via IFT against finite differences of the march."""
    r = torch.tensor(1.0, requires_grad=True)
    g, = torch.autograd.grad(
        _march_t([0.0, 0.0, 5.0], r, torch.tensor([[0.0, 0.0, 1.0]]), 1e-5),
        r)
    # head-on hit: t = 5 - r  =>  dt/dr = -1
    assert np.isclose(float(g), -1.0, atol=1e-3)

    dirs = torch.tensor([[0.6, 0.0, 0.8]])
    r = torch.tensor(1.5, requires_grad=True)
    g, = torch.autograd.grad(_march_t([2.0, 0.0, 5.0], r, dirs, 1e-6), r)
    eps = 1e-3
    with torch.no_grad():
        fd = (_march_t([2.0, 0.0, 5.0], torch.tensor(1.5 + eps), dirs, 1e-6)
              - _march_t([2.0, 0.0, 5.0], torch.tensor(1.5 - eps), dirs,
                         1e-6)) / (2 * eps)
    assert np.isclose(float(g), float(fd), rtol=5e-2)


@pytest.fixture(scope="module")
def room():
    """The GI scene in both packages: (JAX renderer, port renderer, the
    port's SceneData from the JAX package's arrays)."""
    jr = jscenes.global_illumination(width=8, height=8)
    tr = tscenes.global_illumination(width=8, height=8, device="cpu")
    data = scene_data_from_numpy(jax.tree.map(np.asarray, jr.scene_data),
                                 "cpu")
    return jr, tr, data


@pytest.mark.parametrize("fn", ["scene_normal", "attach_hit_gradient"])
def test_gradient_functions_match_jax(room, fn):
    """Each function's value and its vector-Jacobian product with seeded
    weights, with respect to every float leaf of the GI scene and to its
    point (scene_normal) or rays (attach_hit_gradient), against JAX's.
    Seeded points fill the room; seeded rays leave the probes' positions
    and stop at the port's plain march (every kind of slot is hit)."""
    jr, tr, data = room
    rng = np.random.default_rng(0)
    n = 2048
    floats_j, aux_j = jspmd.split_float_leaves(jr.scene_data)
    floats_t, aux_t = tspmd.split_float_leaves(data)
    params = [p.detach().requires_grad_(True) for p in floats_t]
    live = tspmd.merge_float_leaves(aux_t, params)

    def sdf_t(q):
        return scene_sdf(tr.spec, live, q)

    def sdf_j(fl):
        d = jspmd.merge_float_leaves(aux_j, fl)
        return jax.vmap(lambda q: j_scene_sdf(jr.spec, d, q))

    if fn == "scene_normal":
        pts = rng.uniform([-1, -1, -6], [7, 7, 7], (n, 3)).astype(np.float32)
        w = rng.normal(size=(n, 3)).astype(np.float32)
        x_t = [torch.tensor(pts, requires_grad=True)]
        out_t = trm.scene_normal(sdf_t, x_t[0])

        def f_j(fl, p):
            return jrm.scene_normal(sdf_j(fl), p)
        x_j = (jnp.asarray(pts),)
    else:
        o = rng.uniform([0, 0, 0], [6, 6, 6], (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        with torch.no_grad():
            t, hit, _ = trm.raycast(sdf_t, torch.tensor(o), torch.tensor(d),
                                    tr.spec.max_dist)
        assert bool(hit.all())
        w = rng.normal(size=(n,)).astype(np.float32)
        x_t = [torch.tensor(o, requires_grad=True),
               torch.tensor(d, requires_grad=True)]
        out_t = trm.attach_hit_gradient(sdf_t, *x_t, t)

        def f_j(fl, oo, dd):
            return jrm.attach_hit_gradient(sdf_j(fl), oo, dd,
                                           jnp.asarray(t.numpy()))
        x_j = (jnp.asarray(o), jnp.asarray(d))
    out_j, vjp = jax.vjp(f_j, floats_j, *x_j)
    g_j = vjp(jnp.asarray(w))
    g_t = torch.autograd.grad((out_t * torch.tensor(w)).sum(),
                              params + x_t, allow_unused=True)
    assert rel_norm(out_j, out_t.detach().numpy()) < 1e-5
    for a, b in zip(list(g_j[0]) + list(g_j[1:]), g_t):
        b = np.zeros(a.shape) if b is None else b.numpy()
        assert rel_norm(a, b) < 1e-5


@pytest.fixture(scope="module")
def fast():
    """The GI scene at tests/test_torch_gradient_tree.py's size with FAST's
    probes, whose (4, 0, 4) sits inside the room's box."""
    return gi_scene(FAST)


def test_probe_inside_geometry_keeps_primitive_gradients_finite(
        fast, monkeypatch):
    """FAST's probe (4, 0, 4) sits inside the box: its rays hit at t = 0,
    on the probe itself, and the irradiance lookup's |probe − hit| is 0.
    The JAX package's max(|v|, 1e-6) has a NaN backward there, which turns
    every primitive gradient NaN (its kernel path here, as its XLA path).
    The port's sqrt(max(|v|², 1e-12)) is the same value bit for bit with a
    finite backward.  The probe is invisible from outside the box, so its
    texels carry no gradient: the leaves where JAX's gradient is finite
    match it."""
    jr, tr, data, state = fast
    names = leaf_names(jr.scene_data)
    monkeypatch.setenv("MADARCH_FORCE_PALLAS", "1")
    ref = jax_tree_grads(jr, FAST, 0)
    got = port_tree_grads(tr, data, state, FAST, 0)
    assert all(np.isfinite(g).all() for g in got)
    prims = [i for i, n in enumerate(names) if n.startswith(".prims")]
    assert not any(np.isfinite(ref[i]).all() for i in prims)
    rest = [i for i in range(len(names)) if i not in prims]
    hold([names[i] for i in rest], [ref[i] for i in rest],
         [got[i] for i in rest])


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_differentiable_shade_under_no_grad(fast, mode):
    """pixel_color with differentiable=True gives the same values under
    torch.no_grad() (no graph: how the forward is timed) as with gradients
    enabled on leaves that need them."""
    _, tr, data, state = fast
    screen, _ = cfgs(mode)
    o, d = camera_rays(pixel_grid(SIZE, SIZE, "cpu"), tr.camera.position,
                       tr.camera.orientation)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    floats, aux = tspmd.split_float_leaves(data)
    live = tspmd.merge_float_leaves(
        aux, [p.detach().requires_grad_(True) for p in floats])
    args = (tr.spec, live, FAST, screen, state.irradiance, state.radiance,
            o, d)
    with_grad = pixel_color(*args)
    assert with_grad[0].requires_grad
    with torch.no_grad():
        without = pixel_color(*args)
    assert not without[0].requires_grad
    for a, b in zip(with_grad, without):
        assert torch.equal(a.detach(), b)


# ---------------------------------------------------------------------------
# make_sdf_b: the batched scene distance closure
# ---------------------------------------------------------------------------

SDF_LEAVES = [("prims", "sphere", "center"), ("prims", "sphere", "radius"),
              ("prims", "plane", "normal"), ("prims", "plane", "offset")]


def _sdf_inputs():
    rng = np.random.RandomState(91)
    pts = rng.uniform([-3, -3, 0], [3, 3, 8], (128, 3)).astype(np.float32)
    return pts, rng.uniform(0.5, 1.5, 128).astype(np.float32)


@pytest.mark.parametrize("stop_grad", [False, True])
def test_make_sdf_b_matches_jax(stop_grad):
    """The closure's distances within 1e-6 of JAX's make_sdf_b at seeded
    points around tests/test_differentiability.py's scene."""
    pts, _ = _sdf_inputs()
    got = make_sdf_b(SPEC, DATA, stop_grad=stop_grad)(torch.as_tensor(pts))
    ref = j_make_sdf_b(jd.SPEC, jd.DATA, stop_grad=stop_grad)(
        jnp.asarray(pts))
    assert got.shape == (128,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


def test_make_sdf_b_gradient_matches_jax_grad():
    """stop_grad=False: the gradient of a seeded weighted sum of the
    distances in each float primitive leaf against jax.grad at rtol 1e-5;
    stop_grad=True: no gradient reaches the data."""
    pts, w = _sdf_inputs()
    leaves = [_leaf(DATA, path).clone().requires_grad_(True)
              for path in SDF_LEAVES]
    data = DATA
    for path, leaf in zip(SDF_LEAVES, leaves):
        data = _with_leaf(data, path, leaf)
    loss = (make_sdf_b(SPEC, data, stop_grad=False)(torch.as_tensor(pts))
            * torch.as_tensor(w)).sum()
    got = torch.autograd.grad(loss, leaves)

    def jloss(vals):
        jdata = jd.DATA
        for path, v in zip(SDF_LEAVES, vals):
            jdata = _with_leaf(jdata, path, v)
        return jnp.sum(j_make_sdf_b(jd.SPEC, jdata, stop_grad=False)(
            jnp.asarray(pts)) * jnp.asarray(w))

    ref = jax.grad(jloss)([_leaf(jd.DATA, path) for path in SDF_LEAVES])
    for path, g, r in zip(SDF_LEAVES, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=0, err_msg=".".join(path))
    assert any(bool(g.abs().sum() > 0) for g in got)

    sg = make_sdf_b(SPEC, data, stop_grad=True)(torch.as_tensor(pts))
    assert not sg.requires_grad
    assert torch.equal(sg, make_sdf_b(SPEC, data, stop_grad=False)(
        torch.as_tensor(pts)).detach())
