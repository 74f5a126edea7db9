"""Volumetric lighting (light shafts): froxel visibility grid, scattering
integration, depth-aware composite (port of
madarch_tpu/render/volumetrics.py).

The froxel grid is f32[vz, vy, vx, 3]; the scattering map is
f32[sy, sx, 4] holding (in-scattered L, ray length).  The froxel-to-light
rays go through the visibility kernel and the scattering rays through the
raycast kernel (``SceneCtx.visibility`` / ``SceneCtx.raycast``); the rest
is tensor math with index maps fixed by the resolutions.  That math has
two routes, chosen in each pass by ``method``: the kernels of
ops/volumetrics_kernel.py (the froxel in-scatter after each visibility
launch, the scattering integral, the composite) where ops/launch.py:takes
the pass's tensors (on a card, no gradient to pass), else the PyTorch ops
below, differentiable and on either device.

With the recorder of utils/profiling.py on, the passes count their work,
at the Python call (so at capture in a compiled frame): ``froxel_rays``,
the rays of each visibility launch, summed over the light slots launched;
``scattering_rays``, the raycast's rays (sx·sy); ``scattering_taps``, the
taps of the scattering loop (n_steps); ``volumetrics.kernel`` and
``volumetrics.plain``, the elements each route took (a pass's froxels,
texels or pixels).
"""
from __future__ import annotations

import numpy as np
import torch

from madarch_tpu_torch.core.config import VolumetricsSettings
from madarch_tpu_torch.core.constants import cached, constant
from madarch_tpu_torch.core.resample import floor_map, take_static
from madarch_tpu_torch.core.vecmath import PI, dot
from madarch_tpu_torch.ops import launch
from madarch_tpu_torch.ops import volumetrics_kernel as kernels
from madarch_tpu_torch.render.camera import camera_rays, pixel_grid
from madarch_tpu_torch.scene.scene import tree_leaves
from madarch_tpu_torch.utils import profiling

TAU_SCATTERING = 0.1


def henyey_greenstein_phase(in_dir, out_dir):
    """Henyey-Greenstein phase with g = tau_scattering, as the reference
    has it."""
    cos_angle = dot(in_dir, out_dir)
    g2 = TAU_SCATTERING * TAU_SCATTERING
    return (1.0 - g2) / (4.0 * PI * (1.0 + g2 - 2.0 * TAU_SCATTERING
                                     * cos_angle) ** 1.5)


def rayleigh_phase(in_dir, out_dir):
    cos_angle = dot(in_dir, out_dir)
    return 3.0 * (1.0 + cos_angle * cos_angle) / (16.0 * PI)


def method(n, x, *inputs):
    """The route of a volumetric pass's tensor math over its n elements
    (froxels, texels or pixels), given its tensors ``x`` and ``inputs``:
    "kernel" (ops/volumetrics_kernel.py) where ops/launch.py:takes them
    (they lie on a card and no gradient has to pass), else "plain".
    Records n under the counter volumetrics.kernel or volumetrics.plain."""
    kernel = launch.takes(x, *inputs)
    profiling.count("volumetrics.kernel" if kernel else "volumetrics.plain",
                    n)
    return "kernel" if kernel else "plain"


def visibility_pass(spec, data, vol: VolumetricsSettings, ctx,
                    camera_position, camera_orientation, *, max_steps=300,
                    shard=None):
    """In-scattered light per froxel: froxel (z, y, x) samples the camera
    ray through pixel (x, y) at distance z·step, and sums over the light
    slots exp(−d·τ)·vis·radiance·τ·HG.  ``ctx``: the scene's SceneCtx;
    ``shard``: a parallel.spmd.RaySharder splitting the froxels over its
    ranks, or None.  Returns f32[vz, vy, vx, 3]."""
    dev = camera_position.device
    vx, vy, vz = vol.visibility_resolution
    frag = pixel_grid(vx, vy, dev)                              # [vy,vx,2]
    origins, dirs = camera_rays(frag, camera_position, camera_orientation)
    depths = torch.arange(vz, dtype=torch.float32, device=dev) \
        * vol.visibility_step_size
    # sample point of each froxel: [vz, vy, vx, 3]
    pts = origins[None] + dirs[None] * depths[:, None, None, None]
    pts_f = pts.reshape(-1, 3).contiguous()
    dirs_f = dirs[None].expand(vz, vy, vx, 3).reshape(-1, 3)
    kernel = method(pts_f.shape[0], pts_f, dirs_f,
                    *tree_leaves(data.lights)) == "kernel"

    def froxel_light(pts_f, dirs_f):
        n = pts_f.shape[0]
        result = torch.zeros_like(pts_f)
        dummy_normal = constant((1.0, 0.0, 0.0), dev).expand(n, 3)
        for ltype, cap, n_slots, static in spec.light_bounds():
            count = None if static else data.light_counts[ltype.name]
            for slot in range(n_slots):
                live = torch.ones((), dtype=torch.bool, device=dev) \
                    if static else slot < count
                params = {k: v[slot]
                          for k, v in data.lights[ltype.name].items()}
                radiance, ldir, ldist = ltype.sample(params, pts_f,
                                                     dummy_normal)
                vis = ctx.visibility(pts_f, ldir.contiguous(),
                                     ldist.contiguous(),
                                     enabled=live.expand(n).contiguous(),
                                     max_steps=max_steps)
                profiling.count("froxel_rays", n)
                if kernel:
                    result = kernels.froxel_inscatter(
                        result, ldist.contiguous(), vis,
                        radiance.expand(n, 3).contiguous(),
                        ldir.contiguous(), dirs_f, None if static else live,
                        tau=TAU_SCATTERING)
                    continue
                l_in = (torch.exp(-ldist * TAU_SCATTERING) * vis)[..., None] \
                    * radiance
                contrib = l_in * TAU_SCATTERING \
                    * henyey_greenstein_phase(ldir, dirs_f)[..., None]
                result = result + (contrib if static
                                   else torch.where(live, contrib, 0.0))
        return result

    result = froxel_light(pts_f, dirs_f) if shard is None \
        else shard.map_rays(froxel_light, (pts_f, dirs_f))
    return result.reshape(vz, vy, vx, 3)


def scattering_pass(spec, data, vol: VolumetricsSettings, ctx, visibility,
                    camera_position, camera_orientation, *, max_steps=300,
                    shard=None):
    """Per-texel in-scatter integral along the view ray: raycast to
    max_depth, then n_steps weighted taps of the froxel column under the
    texel.  ``shard``: a parallel.spmd.RaySharder splitting the raycast
    over its ranks, or None.  Returns f32[sy, sx, 4] = (L, length)."""
    dev = camera_position.device
    sx, sy = vol.scattering_resolution
    vx, vy, vz = vol.visibility_resolution
    frag = pixel_grid(sx, sy, dev)                              # [sy,sx,2]
    origins, dirs = camera_rays(frag, camera_position, camera_orientation)
    origins_f = origins.reshape(-1, 3).contiguous()
    dirs_f = dirs.reshape(-1, 3).contiguous()
    n = origins_f.shape[0]
    max_depth = vol.max_depth

    def ray_length(o, d):
        t, hit, _ = ctx.raycast(o, d, max_depth, max_steps=max_steps)
        return torch.clamp_max(torch.where(hit, t, max_depth), max_depth)

    kernel = method(n, visibility) == "kernel"
    hit = None
    if kernel and shard is None:
        # the kernel takes the raycast's t and hit, and makes the length
        length, hit, _ = ctx.raycast(origins_f, dirs_f, max_depth,
                                     max_steps=max_steps)
    else:
        length = ray_length(origins_f, dirs_f) if shard is None \
            else shard.map_rays(ray_length, (origins_f, dirs_f))
    profiling.count("scattering_rays", n)

    n_steps = int(max_depth / vol.scattering_step_size)
    profiling.count("scattering_taps", n_steps)
    step = np.float32(vol.scattering_step_size)
    fs = np.arange(n_steps, dtype=np.float32) * step
    weights = cached(("scattering_weights", n_steps, float(step)), dev,
                     lambda: torch.exp(torch.as_tensor(
                         -fs * np.float32(TAU_SCATTERING)).to(dev)))
    if kernel:
        return kernels.scatter_integral(
            length, hit, visibility, weights,
            scattering_resolution=(sx, sy), max_depth=max_depth,
            step=vol.scattering_step_size,
            visibility_step=vol.visibility_step_size)

    # froxel column per scattering texel: (x·vx)//sx, (y·vy)//sy
    vis_up = take_static(visibility, floor_map(sy, vy, offset=0.0), axis=1)
    vis_up = take_static(vis_up, floor_map(sx, vx, offset=0.0), axis=2)
    vis_flat = vis_up.reshape(vz, n, 3)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for i in range(n_steps):
        f = fs[i]
        z = min(max(int(f / np.float32(vol.visibility_step_size)), 0),
                vz - 1)
        w = torch.where(float(f) < length, weights[i], 0.0)
        acc = acc + vis_flat[z] * w[..., None]
    l_acc = acc * vol.scattering_step_size
    out = torch.cat([l_acc, length[..., None]], dim=-1)
    return out.reshape(sy, sx, 4)


def _center_map(n_pix, n_tex):
    """Nearest scattering texel of each screen pixel along one axis:
    frag = (j+0.5)/n·2−1, tex = (frag+1)/2, i = round(tex·n_tex − 0.5),
    in f32 as the JAX package computes it."""
    frag = ((np.arange(n_pix, dtype=np.float32) + np.float32(0.5))
            / np.float32(n_pix) * np.float32(2.0) - np.float32(1.0))
    tex = (frag + np.float32(1.0)) * np.float32(0.5)
    return np.round(tex * np.float32(n_tex)
                    - np.float32(0.5)).astype(np.int64)


def composite(vol: VolumetricsSettings, scattering, color, ray_len, width,
              height, max_dist):
    """Depth-aware fog composite: a 3×3 clamped neighbourhood search keyed
    on |stored_len − pixel_len| (strict <, so the first tap wins a tie),
    then color·exp(−len·τ) + fog.  color/ray_len are flat pixel batches
    [H·W, 3] / [H·W]."""
    sx, sy = vol.scattering_resolution
    ix = _center_map(width, sx)
    iy = _center_map(height, sy)
    if method(ray_len.shape[0], color, scattering, ray_len) == "kernel":
        dev = color.device
        return kernels.fog_composite(
            scattering.contiguous(), color.contiguous(),
            ray_len.contiguous(),
            cached(("center_map", width, sx), dev,
                   lambda: ix.astype(np.int32)),
            cached(("center_map", height, sy), dev,
                   lambda: iy.astype(np.int32)),
            max_dist=max_dist, tau=TAU_SCATTERING)
    closest = torch.full(ray_len.shape, max_dist, dtype=torch.float32,
                         device=ray_len.device)
    fog = torch.zeros_like(color)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            # the ±1 shift folds into the index maps, clipped after
            # shifting (the per-pixel clamp(i + d))
            up = take_static(take_static(
                scattering, np.clip(iy + dy, 0, sy - 1), axis=0),
                np.clip(ix + dx, 0, sx - 1), axis=1)
            datum = up.reshape(-1, 4)                           # [H·W,4]
            dist = torch.abs(datum[..., 3] - ray_len)
            better = dist < closest
            fog = torch.where(better[..., None], datum[..., :3], fog)
            closest = torch.minimum(closest, dist)
    return color * torch.exp(-ray_len * TAU_SCATTERING)[..., None] + fog
