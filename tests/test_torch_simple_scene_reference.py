"""The port's simple_scene frames against the benchmark's plain reference of
that configuration (benchmark/reference_simple: the default reference's
radiance, irradiance and shade over its own simple_scene builder), on the
CPU.

Both sides build the scene at 64x64 with the benchmark's tiny probes,
take the same seeded perturbation of the point light's position and
colour, of the four materials, of every sphere's centre and of every
box's half-side (±0.05), and run a chain of FRAMES frames at seeded
poses, each side from its own state.  The port renders through
``Renderer.render()`` (the compiled frame's CPU body), the reference its
``frame`` over every pixel.  Compared on each frame: the tonemapped
image, and the radiance and irradiance atlases the frame leaves.

A reference with its first box (in front of the camera) dropped, or
with every sphere's radius off by 1e-3, run from the port's state before
the last frame, must fail the same comparison.
"""
import numpy as np
import pytest

from benchmark.reference.core import config as RC
from benchmark.reference.scene import lights as RL
from benchmark.reference_simple import entry as ref_entry
from benchmark.reference_simple.examples import scenes as ref_scenes
from madarch_tpu_torch.core.config import ProbeSettings
from madarch_tpu_torch.examples import scenes
from madarch_tpu_torch.render import pipeline as TPL
from madarch_tpu_torch.render.camera import orientation_from_angles
from madarch_tpu_torch.scene import lights as TL
from madarch_tpu_torch.scene import primitives as TP
from test_torch_config import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

SIZE = 64
PROBES = dict(radiance_resolution=4, irradiance_resolution=2)
FRAMES = 3
SEED = 20261019
MATERIALS = 4
LEAVES = ("radiance", "irradiance")
# Tolerances, as the light_shafts reference test's.  Both sides run the
# same float32 arithmetic on the CPU; the port shades its rays in 32x32
# screen blocks, the reference in scanline order, and each elementwise
# result does not depend on the order.  So the gaps are rounding alone
# (0 today):
# - the image's mean |gap| of the tonemapped colour, 1e-5 (the benchmark
#   cell's own limit);
IMAGE_MEAN = 1e-5
# - no pixel off by more than 4 steps of an 8-bit display: a march that
#   rounds across a discrete choice (a hit, mode 2's best probe) moves
#   single pixels, a missing or moved primitive moves many;
IMAGE_MAX = 4 / 255
# - the relative L1 gap of each atlas, 1e-5: each sums thousands of
#   float32 terms, each within an ulp.
LEAF_REL = 1e-5


def _perturbation(rng):
    """The seeded edit both sides take: the light's position (±0.3) and
    colour (±10%), each material's albedo (±0.2), metallic (+0 to 0.1)
    and roughness (±0.1), each sphere's centre and each box's half-side
    (±0.05 a coordinate)."""
    n_spheres = len(ref_scenes.SPHERE_CENTERS)
    n_boxes = len(ref_scenes.BOXES)
    return {"position": np.float32((0.0, 3.0, 0.0)
                                   + rng.uniform(-0.3, 0.3, 3)),
            "color": np.float32(0.9 * (1.0 + rng.uniform(-0.1, 0.1, 3))),
            "albedo": rng.uniform(-0.2, 0.2, (MATERIALS, 3)),
            "metallic": rng.uniform(0.0, 0.1, MATERIALS),
            "roughness": rng.uniform(-0.1, 0.1, MATERIALS),
            "centers": rng.uniform(-0.05, 0.05, (n_spheres, 3)),
            "sides": rng.uniform(-0.05, 0.05, (n_boxes, 3))}


def _geometry(pert):
    """(sphere centres, boxes) of the perturbed scene, float32 values as
    both builders store them."""
    centers = [tuple(np.float32(c) + np.float32(dc)) for c, dc in
               zip(ref_scenes.SPHERE_CENTERS, pert["centers"])]
    boxes = [(c, tuple(np.float32(s) + np.float32(ds))) for (c, s), ds in
             zip(ref_scenes.BOXES, pert["sides"])]
    return centers, boxes


def _edit(r, light_type, pert, base):
    r.set_light(light_type, 0, position=pert["position"],
                color=pert["color"])
    albedo, metallic, roughness = base
    for i in range(MATERIALS):
        r.set_material(
            i, np.clip(albedo[i] + pert["albedo"][i], 0.0, 1.0),
            float(np.clip(metallic[i] + pert["metallic"][i], 0.0, 1.0)),
            float(np.clip(roughness[i] + pert["roughness"][i], 0.05, 1.0)))


def _poses(rng):
    """FRAMES seeded poses: the scene camera's position moved up to 0.3,
    a yaw of ±0.5 rad and a pitch of ±0.2."""
    return [(np.float32((2.0, 2.0, 0.0) + rng.uniform(-0.3, 0.3, 3)),
             orientation_from_angles(rng.uniform(-0.5, 0.5),
                                     rng.uniform(-0.2, 0.2)).numpy())
            for _ in range(FRAMES)]


def _same(x):
    return x


def _reference_renderer(centers, boxes, radius=ref_scenes.SPHERE_RADIUS):
    """The reference's simple_scene with these spheres and boxes: the
    package's builder over its module constants, set for the call."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_scenes, "SPHERE_CENTERS", centers)
        mp.setattr(ref_scenes, "BOXES", boxes)
        mp.setattr(ref_scenes, "SPHERE_RADIUS", radius)
        return ref_entry.examples("scenes").simple_scene(
            SIZE, SIZE, probes=RC.ProbeSettings(**PROBES), device="cpu")


def _gaps(image, state, c_ref, state_ref):
    """{number: gap} of one frame of the port against the reference's."""
    gap = (image.reshape(-1, 3) - c_ref).abs()
    out = {"image_mean": float(gap.mean()), "image_max": float(gap.max())}
    for leaf in LEAVES:
        a, b = getattr(state, leaf), getattr(state_ref, leaf)
        out[leaf] = float((a - b).abs().sum() / b.abs().sum())
    return out


def _agrees(gaps):
    return gaps["image_mean"] <= IMAGE_MEAN \
        and gaps["image_max"] <= IMAGE_MAX \
        and all(gaps[leaf] <= LEAF_REL for leaf in LEAVES)


@pytest.fixture(scope="module")
def chain(torch_threads):  # noqa: F811
    """The perturbation, the poses and the port's frames: [(image, state
    before, state left)] of the chain."""
    rng = np.random.default_rng(SEED)
    pert, poses = _perturbation(rng), _poses(rng)
    r = scenes.simple_scene(SIZE, SIZE, probes=ProbeSettings(**PROBES),
                            device="cpu")
    b = r.builder
    base = (b._albedo.copy(), b._metallic.copy(), b._roughness.copy())
    centers, boxes = _geometry(pert)
    for i, c in enumerate(centers):
        r.set_primitive(TP.Sphere, i, center=c)
    for i, (_, s) in enumerate(boxes):
        r.set_primitive(TP.Box, i, side=s)
    _edit(r, TL.PointLight, pert, base)
    TPL.clear_compiled()
    frames = []
    for position, orientation in poses:
        r.set_camera_position(position)
        r.set_camera_orientation(orientation)
        before = r.state
        image = r.render()
        frames.append((image, before, r.state))
    TPL.clear_compiled()
    return pert, base, poses, frames


def _reference(rr, pose, state):
    rr.set_camera_position(pose[0])
    rr.set_camera_orientation(pose[1])
    return ref_entry.frame(rr, rr.scene_data, rr.camera, state,
                           np.arange(SIZE * SIZE), _same)


def test_the_port_matches_the_reference(chain):
    pert, base, poses, frames = chain
    rr = _reference_renderer(*_geometry(pert))
    _edit(rr, RL.PointLight, pert, base)
    assert [n for _, _, n, _ in rr.spec.prim_bounds()] == [20, 6, 14]
    state = None
    for pose, (image, _, left) in zip(poses, frames):
        c_ref, state = _reference(rr, pose, state)
        gaps = _gaps(image, left, c_ref, state)
        assert _agrees(gaps), gaps


@pytest.mark.parametrize("fault", ["box_dropped", "sphere_radius"])
def test_a_reference_fault_fails_the_comparison(chain, fault):
    pert, base, poses, frames = chain
    centers, boxes = _geometry(pert)
    if fault == "box_dropped":
        rr = _reference_renderer(centers, boxes[1:])
    else:
        rr = _reference_renderer(centers, boxes,
                                 radius=ref_scenes.SPHERE_RADIUS + 1e-3)
    _edit(rr, RL.PointLight, pert, base)
    image, before, left = frames[-1]
    c_ref, state = _reference(rr, poses[-1], before)
    gaps = _gaps(image, left, c_ref, state)
    assert not _agrees(gaps), gaps
