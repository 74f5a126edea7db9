"""The frame pipeline: radiance → irradiance → [visibility → scattering] →
screen, with probe-atlas feedback across frames (port of
madarch_tpu/render/pipeline.py).

The radiance pass reads the *previous* frame's irradiance atlas (the GI
feedback that accumulates light bounces over frames), the irradiance pass
integrates the new radiance, the volumetric passes (when the scene has
them) build this frame's scattering map, and the screen pass consumes
everything.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from madarch_tpu_torch.core.config import (PROBE_SHADE_CONFIG,
                                           ProbeSettings, ShadeConfig,
                                           VolumetricsSettings,
                                           screen_shade_config)
from madarch_tpu_torch.render import probes as probes_mod
from madarch_tpu_torch.render import volumetrics as vol_mod
from madarch_tpu_torch.render.camera import camera_rays, pixel_grid
from madarch_tpu_torch.render.context import SceneCtx
from madarch_tpu_torch.render.shading import pixel_color
from madarch_tpu_torch.scene.scene import SceneData, SceneSpec


@dataclasses.dataclass
class FrameState:
    """Per-frame feedback textures."""

    radiance: torch.Tensor     # f32[py·rr, px·rr, 3]
    irradiance: torch.Tensor   # f32[py·ir, px·ir, 3]
    scattering: torch.Tensor   # f32[sy, sx, 4]

    @classmethod
    def from_numpy(cls, tree, device) -> "FrameState":
        """FrameState from any object with these fields holding numpy
        arrays, e.g. ``jax.tree.map(np.asarray, jax_renderer.state)``."""
        return cls(**{f.name: torch.as_tensor(
            np.array(getattr(tree, f.name))).to(device)
            for f in dataclasses.fields(cls)})


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
                  cfg: ShadeConfig, irr_atlas, rad_atlas, shard=None):
    """Trace every probe's octahedral ray set and shade it: one batch of
    num_probes·radiance_resolution² rays in direction-major order (rays
    of one texel direction across probes sit together; a permutation,
    inverted below).  ``shard``: a parallel.spmd.RaySharder splitting the
    batch over its ranks, or None."""
    dev = irr_atlas.device
    rr = probes.radiance_resolution
    p_world = probes_mod.probe_world_positions(probes, dev)   # [P,3]
    dirs = probes_mod.texel_directions(rr, dev)              # [rr²,3]
    n_probes = probes.num_probes

    origins = p_world.repeat(rr * rr, 1)                     # [rr²·P,3]
    ray_dirs = dirs.repeat_interleave(n_probes, dim=0)

    def shade(o, d):
        return pixel_color(spec, data, probes, cfg, irr_atlas, rad_atlas, o,
                           d)[0]
    color = shade(origins, ray_dirs) if shard is None \
        else shard.map_rays(shade, (origins, ray_dirs))
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
                scattering, shard=None):
    """Primary rays -> shade -> volumetric composite (when
    cfg.render_volumetrics) -> Reinhard tonemap + gamma.  Returns
    f32[H, W, 3], row 0 = bottom.  ``shard``: as radiance_pass's."""
    frag = pixel_grid(width, height, irr_atlas.device)
    origins, dirs = camera_rays(frag, camera.position, camera.orientation)
    origins_f = origins.reshape(-1, 3)
    dirs_f = dirs.reshape(-1, 3)
    blocked = height % BLOCK_H == 0 and width % BLOCK_W == 0
    if blocked:
        origins_f = _to_blocks(origins_f, height, width).contiguous()
        dirs_f = _to_blocks(dirs_f, height, width).contiguous()

    def shade(o, d):
        c, _, hp = pixel_color(spec, data, probes, cfg, irr_atlas, rad_atlas,
                               o, d)
        return c, hp
    color, hit_pos = shade(origins_f, dirs_f) if shard is None \
        else shard.map_rays(shade, (origins_f, dirs_f))
    if blocked:
        color = _from_blocks(color, height, width)
    if cfg.render_volumetrics:
        if blocked:
            hit_pos = _from_blocks(hit_pos, height, width)
        ray_len = torch.linalg.vector_norm(hit_pos - origins.reshape(-1, 3),
                                           dim=-1)
        color = vol_mod.composite(vol, scattering, color, ray_len, width,
                                  height, spec.max_dist)

    color = torch.clamp_min(color, 0.0)
    # Reinhard + gamma; the 1e-8 matches the reference's finite-derivative
    # guard at pure black
    color = ((color + 1e-8) / (color + 1.0)) ** 0.4545
    return color.reshape(height, width, 3)


def render_frame(spec: SceneSpec, probes: ProbeSettings,
                 vol: VolumetricsSettings, width: int, height: int,
                 data: SceneData, camera: Camera, state: FrameState,
                 screen_cfg: ShadeConfig = None,
                 probe_cfg: ShadeConfig = PROBE_SHADE_CONFIG, shard=None):
    """One full frame; returns (image f32[H,W,3], new FrameState).  The
    image carries the frame's gradients (differentiable configs); the new
    state is detached, the feedback that the next frame reads as data (the
    JAX package returns it outside the gradient).  ``shard``: a
    parallel.spmd.RaySharder that splits every pass's rays over its
    ranks (each rank gets the whole image and state), or None."""
    if screen_cfg is None:
        screen_cfg = screen_shade_config(vol.enabled)
    radiance = radiance_pass(spec, data, probes, probe_cfg,
                             state.irradiance, state.radiance, shard)
    irradiance = probes_mod.integrate_irradiance(probes, radiance)

    scattering = state.scattering
    if vol.enabled:
        ctx = SceneCtx(spec, data)
        visibility = vol_mod.visibility_pass(
            spec, data, vol, ctx, camera.position, camera.orientation,
            max_steps=screen_cfg.max_march_steps, shard=shard)
        scattering = vol_mod.scattering_pass(
            spec, data, vol, ctx, visibility, camera.position,
            camera.orientation, max_steps=screen_cfg.max_march_steps,
            shard=shard)

    image = screen_pass(spec, data, probes, vol, screen_cfg, width, height,
                        camera, irradiance, radiance, scattering, shard)
    return image, FrameState(radiance=radiance.detach(),
                             irradiance=irradiance.detach(),
                             scattering=scattering.detach())
