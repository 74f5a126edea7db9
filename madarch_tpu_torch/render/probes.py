"""DDGI irradiance probes: octahedral atlases, sampling, integration
(port of madarch_tpu/render/probes.py).

Atlases are f32[H, W, 3] tensors.  The shade's lookups take one of two
routes (``lookup_method``).  On a card, where no gradient has to pass
through them, a CUDA kernel gathers the taps each point needs
(ops/probe_lookup.py; ``sample_irradiance(method="kernel")``).  Elsewhere
(the CPU, the train step's differentiable lookups) atlas sampling is the
JAX package's dense contraction against every probe tile (a bilinear lookup
is a [res²] weight vector with 4 nonzeros), so a batch of lookups is one
[N, res²] × [res², P·3] matmul followed by a per-probe one-hot combine.
Float32 throughout.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from madarch_tpu_torch.core.config import ProbeSettings
from madarch_tpu_torch.core.constants import cached, constant
from madarch_tpu_torch.core.vecmath import (absolute, dot, length, mix,
                                            sign_not_zero)
from madarch_tpu_torch.ops import probe_lookup
from madarch_tpu_torch.render.raymarch import MAX_STEPS, SURFACE_OFFSET
from madarch_tpu_torch.utils import profiling

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


def oct_to_dir(e):
    """Octahedral coords in [-1, 1]² -> unit vec3."""
    z = 1.0 - torch.abs(e[..., 0]) - torch.abs(e[..., 1])
    xy = torch.where((z < 0.0)[..., None],
                     (1.0 - torch.abs(torch.flip(e, dims=[-1])))
                     * sign_not_zero(e), e)
    v = torch.cat([xy, z[..., None]], dim=-1)
    return v / torch.clamp_min(length(v), 1e-12)[..., None]


def dir_to_ray_id(v):
    """Unit direction -> tile-local coords in [0, 1]²."""
    return (dir_to_oct(v) + 1.0) * 0.5


def ray_id_to_dir(ray_id):
    return oct_to_dir(ray_id * 2.0 - 1.0)


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


def probe_id_to_tile(settings: ProbeSettings, pid):
    """probe id -> (tile_x, tile_y) in the atlas."""
    px, _ = settings.probe_count
    ty = pid // px
    tx = pid - ty * px
    return tx, ty


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


def sample_tile_bilinear(atlas, tile_x, tile_y, ray_id, res: int):
    """Bilinear lookup inside one probe tile, clamped half a texel from the
    tile border.  atlas: f32[H, W, 3]; tile_x, tile_y int [N]; ray_id
    [N, 2]."""
    rid = torch.clamp(ray_id, 0.5 / res, 1.0 - 0.5 / res)
    fx = rid[..., 0] * res - 0.5
    fy = rid[..., 1] * res - 0.5
    x0 = torch.clamp(torch.floor(fx).to(torch.int32), 0, res - 1)
    y0 = torch.clamp(torch.floor(fy).to(torch.int32), 0, res - 1)
    x1 = torch.clamp_max(x0 + 1, res - 1)
    y1 = torch.clamp_max(y0 + 1, res - 1)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]

    bx = tile_x * res
    by = tile_y * res

    def tex(yy, xx):
        return atlas[(by + yy).long(), (bx + xx).long()]

    top = tex(y0, x0) * (1 - wx) + tex(y0, x1) * wx
    bot = tex(y1, x0) * (1 - wx) + tex(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def radiance_mips(settings: ProbeSettings, atlas, levels: int):
    """Mip pyramid of the radiance atlas (2×2 box per level), the
    textureLod source of specular mode 1.  Levels stay tile-aligned while
    the tile resolution divides by 2."""
    mips = [atlas]
    cur = atlas
    for _ in range(levels):
        h, w, _ = cur.shape
        if h % 2 or w % 2:
            break
        cur = cur.reshape(h // 2, 2, w // 2, 2, 3).mean(dim=(1, 3))
        mips.append(cur)
    return mips


def sample_tile_lod(settings: ProbeSettings, mips, tile_x, tile_y, ray_id,
                    lod):
    """Fractional-LOD bilinear sample inside one probe tile (textureLod):
    lerp between the two adjacent mip levels.  Each level is sampled once;
    the level loop selects the lower and upper sample as the JAX package's
    does."""
    n_levels = len(mips)
    lod = torch.clamp(lod, 0.0, n_levels - 1.0)
    lo = torch.floor(lod).to(torch.int32)
    frac = lod - lo.to(torch.float32)

    base_res = settings.radiance_resolution
    v = [sample_tile_bilinear(mips[lvl], tile_x, tile_y, ray_id,
                              base_res >> lvl) for lvl in range(n_levels)]
    out_lo = torch.zeros(ray_id.shape[:-1] + (3,), dtype=torch.float32,
                         device=ray_id.device)
    out_hi = torch.zeros_like(out_lo)
    for lvl in range(n_levels):
        at = (lo == lvl)[..., None]
        out_lo = torch.where(at, v[lvl], out_lo)
        out_hi = torch.where(at, v[min(lvl + 1, n_levels - 1)], out_hi)
    return out_lo * (1.0 - frac[..., None]) + out_hi * frac[..., None]


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


def corner_visibility(ctx, p, normal, dir_to_probe, probe_dist, *,
                      enabled=None, max_steps=MAX_STEPS):
    """f32[8,N]: the 8·N corner visibility rays through ``ctx`` (a
    SceneCtx) as one batched march, from p + normal·SURFACE_OFFSET toward
    each corner (dir_to_probe f32[8,N,3]) to its distance probe_dist less
    SURFACE_OFFSET, where ``enabled`` (optional bool[N]) holds."""
    n_pts = p.shape[0]
    return ctx.visibility(
        (p + normal * SURFACE_OFFSET)[None].expand(8, n_pts, 3)
        .reshape(-1, 3).contiguous(),
        dir_to_probe.reshape(-1, 3).contiguous(),
        (probe_dist - SURFACE_OFFSET).reshape(-1).contiguous(),
        max_steps=max_steps,
        enabled=None if enabled is None
        else enabled[None].expand(8, n_pts).reshape(-1).contiguous(),
    ).reshape(8, n_pts)


def lookup_method(n, atlas, *inputs):
    """The route of a probe lookup of n points over ``atlas`` and its
    per-point ``inputs`` (None: a constant made inside the lookup):
    "kernel" (ops/probe_lookup.py) where they lie on a card and no
    gradient has to pass through the lookup, else "matmul", the dense
    contraction, differentiable and on either device.  Records n under the
    counter probe_lookups.kernel or .dense."""
    kernel = atlas.is_cuda and not (torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in (atlas, *inputs)))
    profiling.count("probe_lookups.kernel" if kernel
                    else "probe_lookups.dense", n)
    return "kernel" if kernel else "matmul"


def sample_irradiance(settings: ProbeSettings, irr_atlas, pos, normal, *,
                      vis8=None, ctx=None, enabled=None,
                      max_steps=MAX_STEPS, method="matmul"):
    """8-corner trilinear, backface- and visibility-weighted probe lookup.
    pos/normal f32[N,3]; ``vis8`` f32[8,N] is the geometry kernel's probe
    visibility; without it the corners' visibility is marched through
    ``ctx`` (corner_visibility) where ``enabled`` (optional bool[N]) holds.
    Returns f32[N,3] irradiance (sqrt-encoded blend, then squared).
    ``method``: 'kernel' runs the CUDA kernel of ops/probe_lookup.py (a
    card only, no gradient), the shade's route on a card (lookup_method);
    'matmul' contracts every tile's sample against the corner weights, the
    shade's route elsewhere; 'gather' fetches each corner's tile
    bilinearly, the reference's texture fetch and the kernel's plain
    version.  The lookup (not the visibility marches) is the device
    interval ``probes``."""
    ir = settings.irradiance_resolution
    if vis8 is None or method != "kernel":
        offseted, probe_world, alpha = probe_corners(settings, pos)
        dir_to_probe, probe_dist = unit(probe_world - pos[None])  # [8,N,3]
    if vis8 is None:
        vis8 = corner_visibility(ctx, pos, normal, dir_to_probe, probe_dist,
                                 enabled=enabled, max_steps=max_steps)
    with profiling.device_span("probes", pos.device):
        if method == "kernel":
            return probe_lookup.irradiance_lookup(
                settings, irr_atlas, pos.contiguous(), normal.contiguous(),
                vis8.contiguous())

        # backface weight: ((dot+1)/2)² + 0.2
        angle = (dot(dir_to_probe, normal[None]) + 1.0) * 0.5
        weight = (angle * angle + 0.2) * vis8

        # crush tiny weights below 0.2: w -> w³ / 0.04
        crush = 0.2
        weight = torch.where(weight < crush,
                             weight * weight * weight / (crush * crush),
                             weight)

        offsets = constant(CORNER_OFFSETS, pos.device)            # [8,3]
        tri = mix(1.0 - alpha[None], alpha[None], offsets[:, None])
        weight = weight * tri[..., 0] * tri[..., 1] * tri[..., 2]

        pid = grid_position_to_probe_id(settings, offseted)       # [8,N]
        irr_ray_id = dir_to_ray_id(normal)                        # [N,2]
        total_w = torch.clamp_min(weight.sum(dim=0), 1e-9)
        # 1e-12 floor: the atlas starts all-zero
        if method == "matmul":
            px, py = settings.probe_count
            vals_all = sample_all_tiles_bilinear(settings, irr_atlas,
                                                 irr_ray_id, ir)
            vals_all = torch.sqrt(torch.clamp_min(vals_all, 1e-12))
            irr = probe_one_hot_combine(px * py, pid, weight, vals_all) \
                / total_w[..., None]
        elif method == "gather":
            n_pts = pos.shape[0]
            tx, ty = probe_id_to_tile(settings, pid)
            vals = sample_tile_bilinear(
                irr_atlas, tx.reshape(-1), ty.reshape(-1),
                irr_ray_id[None].expand(8, n_pts, 2).reshape(-1, 2), ir)
            vals = torch.sqrt(torch.clamp_min(vals, 1e-12)).reshape(
                8, n_pts, 3)
            irr = (vals * weight[..., None]).sum(dim=0) / total_w[..., None]
        else:
            raise ValueError(f"unknown method {method!r}")
        return irr * irr
