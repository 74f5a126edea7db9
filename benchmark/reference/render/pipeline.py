"""The frame pipeline: radiance → irradiance → screen, with probe-atlas
feedback across frames (a frozen copy of the port's render/pipeline.py;
the volumetric passes are not copied: no cell's scene has them).

The radiance pass reads the *previous* frame's irradiance atlas (the GI
feedback that accumulates light bounces over frames), the irradiance pass
integrates the new radiance, and the screen pass consumes both.

``render_frame`` runs a frame eagerly, op by op (the port's compiled
frame replays the same work).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.config import (PROBE_SHADE_CONFIG, ProbeSettings, ShadeConfig,
                           VolumetricsSettings, screen_shade_config)
from ..render import probes as probes_mod
from ..render.camera import camera_rays, pixel_grid
from ..render.shading import pixel_color
from ..scene.scene import SceneData, SceneSpec


@dataclasses.dataclass
class FrameState:
    """Per-frame feedback textures."""

    radiance: torch.Tensor     # f32[py·rr, px·rr, 3]
    irradiance: torch.Tensor   # f32[py·ir, px·ir, 3]
    scattering: torch.Tensor   # f32[sy, sx, 4]


@dataclasses.dataclass
class Camera:
    position: torch.Tensor     # f32[3]
    orientation: torch.Tensor  # f32[3,3]


def initial_state(probes: ProbeSettings, vol: VolumetricsSettings,
                  device) -> FrameState:
    sy, sx = (vol.scattering_resolution[1], vol.scattering_resolution[0]) \
        if vol.enabled else (1, 1)
    return FrameState(
        radiance=torch.zeros(probes.radiance_atlas_shape, device=device),
        irradiance=torch.zeros(probes.irradiance_atlas_shape,
                               device=device),
        scattering=torch.zeros((sy, sx, 4), device=device))


def radiance_pass(spec: SceneSpec, data: SceneData, probes: ProbeSettings,
                  cfg: ShadeConfig, irr_atlas, rad_atlas):
    """Trace every probe's octahedral ray set and shade it: one batch of
    num_probes·radiance_resolution² rays in direction-major order (rays
    of one texel direction across probes sit together; a permutation,
    inverted below)."""
    dev = irr_atlas.device
    rr = probes.radiance_resolution
    p_world = probes_mod.probe_world_positions(probes, dev)   # [P,3]
    dirs = probes_mod.texel_directions(rr, dev)              # [rr²,3]
    n_probes = probes.num_probes

    origins = p_world.repeat(rr * rr, 1)                     # [rr²·P,3]
    ray_dirs = dirs.repeat_interleave(n_probes, dim=0)

    color = pixel_color(spec, data, probes, cfg, irr_atlas, rad_atlas,
                        origins, ray_dirs)[0]
    tiles = color.reshape(rr * rr, n_probes, 3).transpose(0, 1)
    px, py = probes.probe_count
    if px * py != n_probes:
        pad = torch.zeros((px * py - n_probes, rr * rr, 3), device=dev)
        tiles = torch.cat([tiles, pad], dim=0)
    return probes_mod.tiles_to_atlas(probes, tiles, rr)


BLOCK_H = 32
BLOCK_W = 32


def _to_blocks(arr, height, width):
    """Scanline-flat [H·W, ...] -> 32×32-block-major flat order, so
    neighbouring rays of the batch cover one compact screen square."""
    tail = arr.shape[1:]
    a = arr.reshape(height // BLOCK_H, BLOCK_H, width // BLOCK_W, BLOCK_W,
                    *tail)
    return a.permute(0, 2, 1, 3, *range(4, a.ndim)).reshape(
        height * width, *tail)


def _from_blocks(arr, height, width):
    tail = arr.shape[1:]
    a = arr.reshape(height // BLOCK_H, width // BLOCK_W, BLOCK_H, BLOCK_W,
                    *tail)
    return a.permute(0, 2, 1, 3, *range(4, a.ndim)).reshape(
        height * width, *tail)


def screen_pass(spec: SceneSpec, data: SceneData, probes: ProbeSettings,
                vol: VolumetricsSettings, cfg: ShadeConfig, width: int,
                height: int, camera: Camera, irr_atlas, rad_atlas,
                scattering):
    """Primary rays -> shade -> Reinhard tonemap + gamma.  Returns
    f32[H, W, 3], row 0 = bottom."""
    frag = pixel_grid(width, height, irr_atlas.device)
    origins, dirs = camera_rays(frag, camera.position, camera.orientation)
    origins_f = origins.reshape(-1, 3)
    dirs_f = dirs.reshape(-1, 3)
    blocked = height % BLOCK_H == 0 and width % BLOCK_W == 0
    if blocked:
        origins_f = _to_blocks(origins_f, height, width).contiguous()
        dirs_f = _to_blocks(dirs_f, height, width).contiguous()

    color = pixel_color(spec, data, probes, cfg, irr_atlas, rad_atlas,
                        origins_f, dirs_f)[0]
    if blocked:
        color = _from_blocks(color, height, width)
    if cfg.render_volumetrics:
        raise NotImplementedError("the reference copies no volumetrics")

    color = torch.clamp_min(color, 0.0)
    # Reinhard + gamma; the 1e-8 matches the reference's finite-derivative
    # guard at pure black
    color = ((color + 1e-8) / (color + 1.0)) ** 0.4545
    return color.reshape(height, width, 3)


def render_frame(spec: SceneSpec, probes: ProbeSettings,
                 vol: VolumetricsSettings, width: int, height: int,
                 data: SceneData, camera: Camera, state: FrameState,
                 screen_cfg: ShadeConfig = None,
                 probe_cfg: ShadeConfig = PROBE_SHADE_CONFIG):
    """One full frame; returns (image f32[H,W,3], new FrameState).  The
    image carries the frame's gradients (differentiable configs); the new
    state is detached, the feedback that the next frame reads as data (the
    JAX package returns it outside the gradient)."""
    if screen_cfg is None:
        screen_cfg = screen_shade_config(vol.enabled)
    radiance = radiance_pass(spec, data, probes, probe_cfg,
                             state.irradiance, state.radiance)
    irradiance = probes_mod.integrate_irradiance(probes, radiance)

    scattering = state.scattering
    if vol.enabled:
        raise NotImplementedError("the reference copies no volumetrics")

    image = screen_pass(spec, data, probes, vol, screen_cfg, width, height,
                        camera, irradiance, radiance, scattering)
    return image, FrameState(radiance=radiance.detach(),
                             irradiance=irradiance.detach(),
                             scattering=scattering.detach())
