"""The shade reads a material id only on its bounce's hits.

The geometry kernel (ops/csrc/geometry.cu) classifies only a bounce that
can hit; on any other it gives material 0 where the plain version gives
the nearest slot's (ops/march.py:geometry).  That is sound only while no
consumer reads ``mid`` off a hit: here the plain geometry's ``mid`` (and
the folded reflection's) is replaced on every non-hit by another valid
material id, and render/shading.py:pixel_color's colours, hits and hit
positions must stay bit for bit, in specular mode 0 (the probe pass) and
mode 2 (the screen pass, the reflection folded), on the GI room and the
torus.  The torus's rays mostly miss and its reflections are gated off
(roughness 1).  The GI room is closed by planes, so its rays end on a
surface unless they run out of march steps: there the passes march
ROOM_STEPS steps, which leaves a share of the primaries and reflections
without a hit.  CPU only: the plain chain is what the CPU runs.
"""
import dataclasses

import pytest
import torch

from madarch_tpu_torch.core.config import ProbeSettings
from madarch_tpu_torch.examples import scenes as S
from madarch_tpu_torch.render import probes as PR
from madarch_tpu_torch.render import shading as SH
from madarch_tpu_torch.render.camera import camera_rays, pixel_grid
from madarch_tpu_torch.render.context import SceneCtx

SIZE = 32
SMALL = ProbeSettings(radiance_resolution=4, irradiance_resolution=2)
ROOM_STEPS = 6


def _renderer(scene):
    if scene == "gi_room":
        return S.global_illumination(width=SIZE, height=SIZE, probes=SMALL,
                                     device="cpu")
    return S.obj_mesh(width=SIZE, height=SIZE, obj_path=S.TORUS_OBJ,
                      probes=SMALL, device="cpu")


def _rays(r, mode):
    """The probe pass's rays (mode 0) or the camera's (mode 2)."""
    if mode == 0:
        rr = r.probes.radiance_resolution
        o = PR.probe_world_positions(r.probes, "cpu").repeat(rr * rr, 1)
        d = PR.texel_directions(rr, "cpu").repeat_interleave(
            r.probes.num_probes, dim=0)
        return o.contiguous(), d.contiguous()
    cam = r.camera
    o, d = camera_rays(pixel_grid(SIZE, SIZE, "cpu"), cam.position,
                       cam.orientation)
    return o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()


def _scrambled(mid, hit, n_mats):
    """mid with every entry off ``hit`` moved to another valid id."""
    shift = 1 + torch.arange(mid.shape[0]) % (n_mats - 1)
    return torch.where(hit, mid, (mid + shift) % n_mats).to(mid.dtype)


@pytest.mark.parametrize("mode", [0, 2])
@pytest.mark.parametrize("scene", ["gi_room", "torus"])
def test_colours_ignore_the_material_of_non_hits(monkeypatch, scene, mode):
    r = _renderer(scene)
    r.converge(frames=1)
    cfg = r.probe_cfg if mode == 0 else r.screen_cfg
    assert cfg.indirect_specular_mode == mode
    if scene == "gi_room":
        cfg = dataclasses.replace(cfg, max_march_steps=ROOM_STEPS)
    o, d = _rays(r, mode)
    n_mats = r.scene_data.materials["roughness"].shape[0]
    assert n_mats >= 2
    geometry = SceneCtx.geometry
    moved = []

    def scrambled(self, *args, **kwargs):
        g = dict(geometry(self, *args, **kwargs))
        mid = _scrambled(g["mid"], g["hit"], n_mats)
        moved.append(int((mid != g["mid"]).sum()))
        g["mid"] = mid
        if g["refl"] is not None:
            refl = dict(g["refl"])
            refl["mid"] = _scrambled(refl["mid"], refl["hit"], n_mats)
            moved.append(int((refl["mid"] != g["refl"]["mid"]).sum()))
            g["refl"] = refl
        return g

    def colours():
        with torch.no_grad():
            return SH.pixel_color(r.spec, r.scene_data, r.probes, cfg,
                                  r.state.irradiance, r.state.radiance, o,
                                  d)

    want = colours()
    monkeypatch.setattr(SceneCtx, "geometry", scrambled)
    got = colours()
    assert len(moved) == (2 if mode == 2 else 1) and all(moved)
    hit = want[1]
    assert 0 < int(hit.sum()) < hit.numel()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
