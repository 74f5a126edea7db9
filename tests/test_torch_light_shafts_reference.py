"""The port's light_shafts frames against the benchmark's plain reference of
that configuration (benchmark/reference_shafts: the default reference's
radiance, irradiance and shade with the volumetric passes in plain float32
torch), on the CPU.

Both sides build the scene at 64x64 with the benchmark's tiny probes and
small volumetrics (8x8x8 froxels, a 16x16 scattering map; set here, not
by a configuration key), take the same seeded perturbation of the point
light's position and colour and of the four materials, and run a chain of
FRAMES frames at seeded poses, each side from its own state.  The port
renders through ``Renderer.render()`` (the compiled frame's CPU body), the
reference its ``frame`` over every pixel.  Compared on each frame: the
tonemapped image, and the radiance and irradiance atlases and the
scattering map the frame leaves.

A reference with the composite dropped, or with its scattering map
shifted by one texel, run from the port's state before the last frame,
must fail the same comparison.
"""
import numpy as np
import pytest
import torch

from benchmark.reference.core import config as RC
from benchmark.reference.scene import lights as RL
from benchmark.reference_shafts import entry as ref_entry
from benchmark.reference_shafts import volumetrics as RV
from madarch_tpu_torch.core.config import ProbeSettings, VolumetricsSettings
from madarch_tpu_torch.examples import scenes
from madarch_tpu_torch.render import pipeline as TPL
from madarch_tpu_torch.render.camera import orientation_from_angles
from madarch_tpu_torch.scene import lights as TL
from test_torch_config import torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

SIZE = 64
PROBES = dict(radiance_resolution=4, irradiance_resolution=2)
VOLUMETRICS = dict(visibility_resolution=(8, 8, 8),
                   visibility_step_size=0.5,
                   scattering_resolution=(16, 16),
                   scattering_step_size=0.5)
FRAMES = 3
SEED = 20261018
MATERIALS = 4
LEAVES = ("radiance", "irradiance", "scattering")
# Tolerances.  Both sides run the same float32 arithmetic on the CPU; the
# port shades its rays in 32x32 screen blocks, the reference in scanline
# order, and each elementwise result does not depend on the order.  So
# the gaps are rounding alone (0 today):
# - the image's mean |gap| of the tonemapped colour, 1e-5 (the benchmark
#   cell's own limit, about 40 float32 ulps at the image's mean of ~0.2);
IMAGE_MEAN = 1e-5
# - no pixel off by more than 4 steps of an 8-bit display: a march that
#   rounds across a discrete choice (a hit, a composite tap) moves single
#   pixels, a missing or shifted volumetric term moves many;
IMAGE_MAX = 4 / 255
# - the relative L1 gap of each state leaf, 1e-5: the atlases and the
#   scattering map sum thousands of float32 terms, each within an ulp.
LEAF_REL = 1e-5


def _perturbation(rng):
    """The seeded edit both sides take: the light's position (±0.3) and
    colour (±10%), each material's albedo (±0.2), metallic (+0 to 0.1)
    and roughness (±0.1)."""
    return {"position": np.float32((5.0, 3.0, 6.0)
                                   + rng.uniform(-0.3, 0.3, 3)),
            "color": np.float32(0.9 * (1.0 + rng.uniform(-0.1, 0.1, 3))),
            "albedo": rng.uniform(-0.2, 0.2, (MATERIALS, 3)),
            "metallic": rng.uniform(0.0, 0.1, MATERIALS),
            "roughness": rng.uniform(-0.1, 0.1, MATERIALS)}


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
    """The reference renderer, the poses and the port's frames: [(image,
    state before, state left)] of the chain."""
    rng = np.random.default_rng(SEED)
    pert, poses = _perturbation(rng), _poses(rng)
    r = scenes.light_shafts(SIZE, SIZE, probes=ProbeSettings(**PROBES),
                            volumetrics=VolumetricsSettings(**VOLUMETRICS),
                            device="cpu")
    rr = ref_entry.examples("scenes").light_shafts(
        SIZE, SIZE, probes=RC.ProbeSettings(**PROBES),
        volumetrics=RC.VolumetricsSettings(**VOLUMETRICS), device="cpu")
    b = r.builder
    base = (b._albedo.copy(), b._metallic.copy(), b._roughness.copy())
    _edit(r, TL.PointLight, pert, base)
    _edit(rr, RL.PointLight, pert, base)
    TPL.clear_compiled()
    frames = []
    for position, orientation in poses:
        r.set_camera_position(position)
        r.set_camera_orientation(orientation)
        before = r.state
        image = r.render()
        frames.append((image, before, r.state))
    TPL.clear_compiled()
    return rr, poses, frames


def _reference(rr, pose, state):
    rr.set_camera_position(pose[0])
    rr.set_camera_orientation(pose[1])
    return ref_entry.frame(rr, rr.scene_data, rr.camera, state,
                           np.arange(SIZE * SIZE), _same)


def test_the_port_matches_the_reference(chain):
    rr, poses, frames = chain
    state = None
    for pose, (image, _, left) in zip(poses, frames):
        c_ref, state = _reference(rr, pose, state)
        gaps = _gaps(image, left, c_ref, state)
        assert _agrees(gaps), gaps
    # the volumetric terms are there to be compared
    assert float(left.scattering[..., :3].abs().sum()) > 0.0


@pytest.mark.parametrize("fault", ["no_composite", "shifted_scattering"])
def test_a_reference_fault_fails_the_comparison(chain, monkeypatch, fault):
    rr, poses, frames = chain
    if fault == "no_composite":
        monkeypatch.setattr(RV, "composite", lambda vol, scattering, color,
                            *args: color)
    else:
        scattering_pass = RV.scattering_pass
        monkeypatch.setattr(RV, "scattering_pass", lambda *a, **k: torch.roll(
            scattering_pass(*a, **k), 1, dims=1))
    image, before, left = frames[-1]
    c_ref, state = _reference(rr, poses[-1], before)
    gaps = _gaps(image, left, c_ref, state)
    assert not _agrees(gaps), gaps
