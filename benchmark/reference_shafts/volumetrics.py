"""The volumetric passes in plain float32 torch (a frozen copy of the
port's render/volumetrics.py, its marches the plain versions of the
visibility and raycast kernels over the packed scene).

The froxel grid is f32[vz, vy, vx, 3]; the scattering map is
f32[sy, sx, 4] holding (in-scattered L, ray length).  ``composite`` works
on a sample of the screen's pixels, given by their flat indices.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.core.constants import constant
from benchmark.reference.core.vecmath import EPSILON, PI, dot
from benchmark.reference.ops.march import VIS_CAP, ray_box_cap, scene_dist
from benchmark.reference.render import raymarch as rm
from benchmark.reference.render.camera import camera_rays, pixel_grid

TAU_SCATTERING = 0.1


def raycast(packed, origins, dirs, max_dist, *, max_steps):
    """(t f32[N], hit bool[N]) of the raycast kernel's plain version: the
    over-relaxed march over the packed scene, whose distances cap at
    max_dist, ended at the rays' box-exit caps where the scene packs them
    (a ray so ended short of max_dist is a miss at t = max_dist); a hit
    where t < max_dist and the scene at the end point is under eps (the
    port's plain raycast evaluates that point again only for the rays that
    did not stop on a hit: the others give the same value there)."""
    def sdf_b(p):
        return scene_dist(packed, p, max_dist)

    t = rm.raycast_distance(sdf_b, origins, dirs, max_dist,
                            max_steps=max_steps,
                            caps=ray_box_cap(packed, origins, dirs))
    hit = (t < max_dist) & (sdf_b(origins + t[:, None] * dirs) < EPSILON)
    return t, hit


def visibility(packed, origins, dirs, max_dists, *, max_steps, enabled):
    """f32[N] of the visibility kernel's plain version: 1 where the ray
    reaches its own max_dists unblocked over the packed scene (distances
    capped at VIS_CAP), else 0, ended unblocked at its box-exit cap where
    the scene packs one."""
    return rm.raycast_visibility(
        lambda p: scene_dist(packed, p, VIS_CAP), origins, dirs, max_dists,
        max_steps=max_steps, enabled=enabled,
        caps=ray_box_cap(packed, origins, dirs))


def henyey_greenstein_phase(in_dir, out_dir):
    cos_angle = dot(in_dir, out_dir)
    g2 = TAU_SCATTERING * TAU_SCATTERING
    return (1.0 - g2) / (4.0 * PI * (1.0 + g2 - 2.0 * TAU_SCATTERING
                                     * cos_angle) ** 1.5)


def _take(x, idx, axis):
    """x gathered along ``axis`` at the host indices ``idx``."""
    return torch.index_select(x, axis, torch.as_tensor(
        np.asarray(idx, np.int64), device=x.device))


def _floor_map(dst, src):
    """floor(j·src/dst), clipped: the froxel column under each texel."""
    j = np.arange(dst)
    return np.clip(np.floor(j * src / dst).astype(np.int64), 0, src - 1)


def visibility_pass(spec, data, vol, packed, camera_position,
                    camera_orientation, *, max_steps):
    """In-scattered light per froxel: froxel (z, y, x) samples the camera
    ray through pixel (x, y) at distance z·step and sums over the light
    slots exp(−d·τ)·vis·radiance·τ·HG.  Returns f32[vz, vy, vx, 3]."""
    dev = camera_position.device
    vx, vy, vz = vol.visibility_resolution
    frag = pixel_grid(vx, vy, dev)
    origins, dirs = camera_rays(frag, camera_position, camera_orientation)
    depths = torch.arange(vz, dtype=torch.float32, device=dev) \
        * vol.visibility_step_size
    pts = origins[None] + dirs[None] * depths[:, None, None, None]
    pts_f = pts.reshape(-1, 3).contiguous()
    dirs_f = dirs[None].expand(vz, vy, vx, 3).reshape(-1, 3)
    n = pts_f.shape[0]
    result = torch.zeros_like(pts_f)
    dummy_normal = constant((1.0, 0.0, 0.0), dev).expand(n, 3)
    for ltype, cap, n_slots, static in spec.light_bounds():
        count = None if static else data.light_counts[ltype.name]
        for slot in range(n_slots):
            live = torch.ones((), dtype=torch.bool, device=dev) \
                if static else slot < count
            params = {k: v[slot] for k, v in data.lights[ltype.name].items()}
            radiance, ldir, ldist = ltype.sample(params, pts_f, dummy_normal)
            vis = visibility(packed, pts_f, ldir.contiguous(),
                             ldist.contiguous(), max_steps=max_steps,
                             enabled=live.expand(n).contiguous())
            l_in = (torch.exp(-ldist * TAU_SCATTERING) * vis)[..., None] \
                * radiance
            contrib = l_in * TAU_SCATTERING \
                * henyey_greenstein_phase(ldir, dirs_f)[..., None]
            result = result + (contrib if static
                               else torch.where(live, contrib, 0.0))
    return result.reshape(vz, vy, vx, 3)


def scattering_pass(vol, packed, visibility_grid, camera_position,
                    camera_orientation, *, max_steps):
    """Per-texel in-scatter integral along the view ray: the raycast to
    max_depth, then n_steps weighted taps of the froxel column under the
    texel.  Returns f32[sy, sx, 4] = (L, length)."""
    dev = camera_position.device
    sx, sy = vol.scattering_resolution
    vx, vy, vz = vol.visibility_resolution
    frag = pixel_grid(sx, sy, dev)
    origins, dirs = camera_rays(frag, camera_position, camera_orientation)
    origins_f = origins.reshape(-1, 3).contiguous()
    dirs_f = dirs.reshape(-1, 3).contiguous()
    n = origins_f.shape[0]
    max_depth = vol.max_depth
    t, hit = raycast(packed, origins_f, dirs_f, max_depth,
                     max_steps=max_steps)
    length = torch.clamp_max(torch.where(hit, t, max_depth), max_depth)

    vis_up = _take(visibility_grid, _floor_map(sy, vy), axis=1)
    vis_up = _take(vis_up, _floor_map(sx, vx), axis=2)
    vis_flat = vis_up.reshape(vz, n, 3)

    n_steps = int(max_depth / vol.scattering_step_size)
    step = np.float32(vol.scattering_step_size)
    fs = np.arange(n_steps, dtype=np.float32) * step
    weights = torch.exp(torch.as_tensor(
        -fs * np.float32(TAU_SCATTERING)).to(dev))
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


def center_map(n_pix, n_tex):
    """The nearest scattering texel of each screen pixel along one axis:
    frag = (j+0.5)/n·2−1, tex = (frag+1)/2, i = round(tex·n_tex − 0.5),
    in float32."""
    frag = ((np.arange(n_pix, dtype=np.float32) + np.float32(0.5))
            / np.float32(n_pix) * np.float32(2.0) - np.float32(1.0))
    tex = (frag + np.float32(1.0)) * np.float32(0.5)
    return np.round(tex * np.float32(n_tex)
                    - np.float32(0.5)).astype(np.int64)


def composite(vol, scattering, color, ray_len, pixels, width, height,
              max_dist):
    """The depth-aware fog composite of the pixels at the flat indices
    ``pixels`` (row-major, width ``width``): a 3×3 clamped search of the
    scattering map around each pixel's texel, keyed on |stored length −
    the pixel's ray length| (strict <, so the first tap wins a tie), then
    color·exp(−len·τ) + fog.  color f32[n, 3], ray_len f32[n]."""
    sx, sy = vol.scattering_resolution
    pixels = np.asarray(pixels, np.int64)
    ix = center_map(width, sx)[pixels % width]
    iy = center_map(height, sy)[pixels // width]
    dev = color.device
    closest = torch.full(ray_len.shape, max_dist, dtype=torch.float32,
                         device=dev)
    fog = torch.zeros_like(color)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            jy = torch.as_tensor(np.clip(iy + dy, 0, sy - 1), device=dev)
            jx = torch.as_tensor(np.clip(ix + dx, 0, sx - 1), device=dev)
            datum = scattering[jy, jx]                          # [n, 4]
            dist = torch.abs(datum[..., 3] - ray_len)
            better = dist < closest
            fog = torch.where(better[..., None], datum[..., :3], fog)
            closest = torch.minimum(closest, dist)
    return color * torch.exp(-ray_len * TAU_SCATTERING)[..., None] + fog
