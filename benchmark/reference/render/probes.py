"""DDGI irradiance probes: octahedral atlases, sampling, integration
(port of madarch_tpu/render/probes.py).

Atlases are f32[H, W, 3] tensors.  Atlas sampling is written as dense
contractions against every probe tile (a bilinear lookup is a [res²] weight
vector with 4 nonzeros), so a batch of lookups is one [N, res²] × [res², P·3]
matmul followed by a per-probe one-hot combine.  Float32 throughout.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core.config import ProbeSettings
from ..core.constants import cached, constant
from ..core.vecmath import absolute, dot, mix, sign_not_zero

# The 8 probe-cell corners, bit k of the corner index selecting +1 on axis k.
CORNER_OFFSETS = tuple(((i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1)
                       for i in range(8))


# ---------------------------------------------------------------------------
# Octahedral mapping
# ---------------------------------------------------------------------------

def dir_to_oct(v):
    """Unit vec3 -> octahedral coords in [-1, 1]²; the clamp guards the
    zero vectors that masked-out lanes carry."""
    denom = torch.clamp_min(
        absolute(v[..., 0]) + absolute(v[..., 1]) + absolute(v[..., 2]),
        1e-12)
    p = v[..., :2] / denom[..., None]
    folded = (1.0 - absolute(torch.flip(p, dims=[-1]))) * sign_not_zero(p)
    return torch.where((v[..., 2] <= 0.0)[..., None], folded, p)


def dir_to_ray_id(v):
    """Unit direction -> tile-local coords in [0, 1]²."""
    return (dir_to_oct(v) + 1.0) * 0.5


# ---------------------------------------------------------------------------
# Probe grid / atlas addressing
# ---------------------------------------------------------------------------

def grid_position_to_probe_id(settings: ProbeSettings, grid_pos):
    gx, gy, _ = settings.grid_dimensions
    return (grid_pos[..., 2] * gx * gy + grid_pos[..., 1] * gx
            + grid_pos[..., 0])


def probe_id_to_grid_position(settings: ProbeSettings, pid):
    gx, gy, _ = settings.grid_dimensions
    z = pid // (gx * gy)
    y = (pid - z * gx * gy) // gx
    x = pid - z * gx * gy - y * gx
    return torch.stack([x, y, z], dim=-1)


def probe_world_positions(settings: ProbeSettings, device):
    """f32[num_probes, 3] world positions of all probes."""
    pid = torch.arange(settings.num_probes, device=device)
    gp = probe_id_to_grid_position(settings, pid)
    spacing = constant(settings.grid_spacing, device)
    return gp.to(torch.float32) * spacing


@lru_cache(maxsize=None)
def _texel_dirs(res: int):
    """Octahedral direction of each texel center of a res×res tile, as a
    numpy constant f32[res*res, 3] in row-major (y, x) order."""
    ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    ray_id = np.stack([(xs + 0.5) / res, (ys + 0.5) / res],
                      axis=-1).reshape(-1, 2).astype(np.float32)
    e = ray_id * 2.0 - 1.0
    z = 1.0 - np.abs(e[:, 0]) - np.abs(e[:, 1])
    xy = np.where((z < 0.0)[:, None],
                  (1.0 - np.abs(e[:, ::-1])) * np.where(e >= 0, 1.0, -1.0),
                  e)
    v = np.concatenate([xy, z[:, None]], axis=-1)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def texel_directions(res: int, device):
    """_texel_dirs(res) as a device constant (core/constants.py)."""
    return cached(("texel_dirs", res), device, lambda: _texel_dirs(res))


@lru_cache(maxsize=None)
def _cosine_weights(irr_res: int, rad_res: int):
    """W[irr_res², rad_res²] with W[i,j] = max(dot(irr_dir_i, rad_dir_j), 0),
    and its row sums."""
    irr_dirs = _texel_dirs(irr_res)
    rad_dirs = _texel_dirs(rad_res)
    w = np.maximum(irr_dirs @ rad_dirs.T, 0.0).astype(np.float32)
    return w, w.sum(axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# Atlas access
# ---------------------------------------------------------------------------

def atlas_to_tiles(settings: ProbeSettings, atlas, res: int):
    """[py·res, px·res, 3] -> [px·py, res·res, 3] (tile row-major)."""
    px, py = settings.probe_count
    t = atlas.reshape(py, res, px, res, 3)
    return t.permute(0, 2, 1, 3, 4).reshape(px * py, res * res, 3)


def tiles_to_atlas(settings: ProbeSettings, tiles, res: int):
    px, py = settings.probe_count
    t = tiles.reshape(py, px, res, res, 3).permute(0, 2, 1, 3, 4)
    return t.reshape(py * res, px * res, 3)


def radiance_mip1(settings: ProbeSettings, atlas):
    """2×2 box-downsample of the radiance atlas (GL mip level 1)."""
    h, w, _ = atlas.shape
    return atlas.reshape(h // 2, 2, w // 2, 2, 3).mean(dim=(1, 3))


def bilinear_tile_weight_factors(ray_id, res: int):
    """Per-axis bilinear weights (Wy [N, res], Wx [N, res]) of a tile-local
    lookup at ``ray_id`` [N, 2], clamped half a texel from the tile border.
    The full weight matrix is the outer product Wy ⊗ Wx."""
    rid = torch.clamp(ray_id, 0.5 / res, 1.0 - 0.5 / res)
    lanes = torch.arange(res, device=ray_id.device)

    def axis_w(f):
        i0 = torch.clamp(torch.floor(f).to(torch.int32), 0, res - 1)
        i1 = torch.clamp_max(i0 + 1, res - 1)
        w1 = (f - i0)[..., None]
        return (torch.where(lanes == i0[..., None], 1.0 - w1, 0.0)
                + torch.where(lanes == i1[..., None], w1, 0.0))

    wx = axis_w(rid[..., 0] * res - 0.5)
    wy = axis_w(rid[..., 1] * res - 0.5)
    return wy, wx


def sample_all_tiles_bilinear(settings: ProbeSettings, atlas, ray_id,
                              res: int):
    """Bilinear sample of EVERY probe tile at each query: f32[N, P, 3], as
    one [N, res²] × [res², P·3] matmul."""
    px, py = settings.probe_count
    n_tiles = px * py
    tiles = atlas_to_tiles(settings, atlas, res)        # [P, res², 3]
    flat = tiles.permute(1, 0, 2).reshape(res * res, n_tiles * 3)
    wy, wx = bilinear_tile_weight_factors(ray_id, res)
    w = (wy[..., :, None] * wx[..., None, :]).reshape(
        ray_id.shape[:-1] + (res * res,))
    vals = w @ flat
    return vals.reshape(ray_id.shape[:-1] + (n_tiles, 3))


def probe_one_hot_combine(n_tiles: int, pids, weights, vals):
    """Σ_k weights[k]·vals[:, pids[k]] without gathers: pids [K, N] int,
    weights [K, N], vals [N, P, 3] -> f32[N, 3]."""
    w_all = torch.zeros(vals.shape[:-1], dtype=vals.dtype,
                        device=vals.device)              # [N, P]
    probe_ids = torch.arange(n_tiles, device=vals.device)
    for k in range(pids.shape[0]):
        w_all = w_all + torch.where(probe_ids == pids[k][..., None],
                                    weights[k][..., None], 0.0)
    return torch.einsum("np,npc->nc", w_all, vals)


# ---------------------------------------------------------------------------
# Irradiance integration pass
# ---------------------------------------------------------------------------

def integrate_irradiance(settings: ProbeSettings, radiance_atlas):
    """Cosine-weighted re-integration of every probe's radiance into its
    irradiance tile: one [ir², rr²] × [P, rr², 3] contraction."""
    rr = settings.radiance_resolution
    ir = settings.irradiance_resolution
    dev = radiance_atlas.device
    w = cached(("cosine_weights", ir, rr), dev,
               lambda: _cosine_weights(ir, rr)[0])
    wsum = cached(("cosine_weight_sums", ir, rr), dev,
                  lambda: _cosine_weights(ir, rr)[1])
    rad = atlas_to_tiles(settings, radiance_atlas, rr)      # [P, rr², 3]
    irr = torch.einsum("ij,pjc->pic", w, rad) / wsum
    return tiles_to_atlas(settings, irr, ir)


# ---------------------------------------------------------------------------
# Irradiance sampling
# ---------------------------------------------------------------------------

def probe_corners(settings: ProbeSettings, p):
    """The 8 probe-cell corners around points p f32[N,3], clamped to the
    grid: (grid positions i32[8,N,3], world positions f32[8,N,3], each
    point's offset in its cell alpha f32[N,3])."""
    dev = p.device
    spacing = constant(settings.grid_spacing, dev)
    dims = constant(settings.grid_dimensions, dev, np.int32)
    grid_pos = torch.floor(p / spacing).to(torch.int32)       # [N,3]
    alpha = p / spacing - grid_pos.to(torch.float32)          # [N,3]
    offsets = constant(CORNER_OFFSETS, dev, np.int32)         # [8,3]
    offseted = torch.minimum(
        torch.clamp_min(grid_pos[None] + offsets[:, None], 0),
        dims - 1)                                             # [8,N,3]
    return offseted, offseted.to(torch.float32) * spacing, alpha


def unit(v):
    """(v / d, d) with d = sqrt(max(|v|², 1e-12)): max(|v|, 1e-6) bit for
    bit in f32 (sqrt rounds monotonically and sqrt(1e-12) rounds to 1e-6),
    and unlike it with a finite backward at v = 0 (a hit on a probe's own
    position)."""
    d = torch.sqrt(torch.clamp_min(dot(v, v), 1e-12))
    return v / d[..., None], d


def sample_irradiance(settings: ProbeSettings, irr_atlas, pos, normal, *,
                      vis8):
    """8-corner trilinear, backface- and visibility-weighted probe lookup.
    pos/normal f32[N,3]; ``vis8`` f32[8,N] is the geometry kernel's probe
    visibility.  Returns f32[N,3] irradiance (sqrt-encoded blend, then
    squared), every tile's sample contracted against the corner weights
    (the render path)."""
    ir = settings.irradiance_resolution
    offseted, probe_world, alpha = probe_corners(settings, pos)
    dir_to_probe, _ = unit(probe_world - pos[None])  # [8,N,3]

    # backface weight: ((dot+1)/2)² + 0.2
    angle = (dot(dir_to_probe, normal[None]) + 1.0) * 0.5
    weight = (angle * angle + 0.2) * vis8

    # crush tiny weights below 0.2: w -> w³ / 0.04
    crush = 0.2
    weight = torch.where(weight < crush,
                         weight * weight * weight / (crush * crush), weight)

    offsets = constant(CORNER_OFFSETS, pos.device)            # [8,3]
    tri = mix(1.0 - alpha[None], alpha[None], offsets[:, None])  # [8,N,3]
    weight = weight * tri[..., 0] * tri[..., 1] * tri[..., 2]

    pid = grid_position_to_probe_id(settings, offseted)       # [8,N]
    irr_ray_id = dir_to_ray_id(normal)                        # [N,2]
    total_w = torch.clamp_min(weight.sum(dim=0), 1e-9)
    # 1e-12 floor: the atlas starts all-zero
    px, py = settings.probe_count
    vals_all = sample_all_tiles_bilinear(settings, irr_atlas, irr_ray_id, ir)
    vals_all = torch.sqrt(torch.clamp_min(vals_all, 1e-12))
    irr = probe_one_hot_combine(px * py, pid, weight, vals_all) \
        / total_w[..., None]
    return irr * irr
