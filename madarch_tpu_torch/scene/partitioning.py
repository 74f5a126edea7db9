"""Uniform-grid space partitioning: per-cell candidate lists and the
grid-aware closest-primitive query (port of
madarch_tpu/scene/partitioning.py).

The render path never reads the grid (the geometry kernel prunes with its
own chunk bounding boxes); ``grid_closest`` serves point queries and
tests.  The three builders:

- ``gpu_fast`` and ``cpu_fast``: per cell keep the primitives with
  dist(center) < closest(center) + cell_diag;
- ``cpu_best``: sample 3×3×3 points per cell and keep only primitives that
  are the closest at some sample.

Candidates are dense i32[num_cells, K] plus counts; beyond K the K nearest
to the cell's center are kept.  The queries are batched over points
p[N, 3], where the JAX package's take one point under vmap.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from madarch_tpu_torch.core.config import PartitioningSettings
from madarch_tpu_torch.scene.scene import SceneData, SceneSpec, scene_sdf

# Cap on the [points, capacity] distance table build_grid holds at once.
BUILD_CHUNK_ELEMS = 1 << 22
# cpu_best's 27 sample offsets per cell, in cell spacings.
_BEST_OFFSETS = [[(i % 3 - 1), (i // 3 % 3 - 1), (i // 9 - 1)]
                 for i in range(27)]


@dataclasses.dataclass
class GridData:
    """The partitioning state on the scene's device."""

    cells: torch.Tensor   # i32[num_cells, K] global primitive indices
    counts: torch.Tensor  # i32[num_cells]


def _cell_centers(settings: PartitioningSettings, device):
    """f32[num_cells, 3] cell centers in cell_id order."""
    nx, ny, nz = settings.grid_dimensions
    off = np.asarray(settings.grid_offset, np.float32)
    sp = np.asarray(settings.grid_spacing, np.float32)
    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    idx = np.stack([ix, iy, iz], axis=-1).reshape(-1, 3)
    return torch.as_tensor((off + (idx + 0.5) * sp).astype(np.float32),
                           device=device)


def cell_id(settings: PartitioningSettings, idx3):
    """3D cell index [..., 3] -> flat id, x-major then y then z."""
    nx, ny, nz = settings.grid_dimensions
    return (idx3[..., 0] * ny + idx3[..., 1]) * nz + idx3[..., 2]


def all_slot_dists(spec: SceneSpec, data: SceneData, p):
    """f32[N, total_capacity]: the distance from each point p[N, 3] to
    every capacity slot (dead slots at max_dist), in global-index order."""
    out = []
    n_pts = p.shape[0]
    for ptype, cap, n, static in spec.prim_bounds():
        if cap == 0:
            continue
        if n == 0:
            out.append(torch.full((n_pts, cap), spec.max_dist,
                                  dtype=torch.float32, device=p.device))
            continue
        params = {k: v[:n] for k, v in data.prims[ptype.name].items()}
        dists = ptype.sdf(params, p[:, None, :])
        if not static:
            live = torch.arange(n, device=p.device) \
                < data.prim_counts[ptype.name]
            dists = torch.where(live, dists, spec.max_dist)
        if n < cap:
            dists = torch.cat([dists, torch.full(
                (n_pts, cap - n), spec.max_dist, dtype=torch.float32,
                device=p.device)], dim=1)
        out.append(dists)
    return torch.cat(out, dim=1)


def planar_prims(spec: SceneSpec, data: SceneData):
    """{type name: {field: f32[cap]}} for every type with a planar form:
    each vec3 field split into its components ``name_x/y/z``, each float
    field as it is (material ids are no distance input)."""
    out = {}
    for ptype, _ in spec.prims:
        if ptype.sdf_planar is None:
            continue
        s = {}
        for fname, kind in ptype.fields:
            arr = data.prims[ptype.name][fname]
            if kind == "vec3":
                for i, ax in enumerate("xyz"):
                    s[f"{fname}_{ax}"] = arr[:, i]
            elif kind == "float":
                s[fname] = arr
        out[ptype.name] = s
    return out


def candidate_dists(spec: SceneSpec, data: SceneData, cand, p, planar=None):
    """f32[N, K]: the distance from each point p[N, 3] to its K primitives
    cand i32[N, K] (global indices; -1 entries at max_dist).  With
    ``planar`` (planar_prims' split) a type found there is evaluated by its
    planar form on the components gathered from it."""
    dists = torch.full(cand.shape, spec.max_dist, dtype=torch.float32,
                       device=p.device)
    for ptype, cap in spec.prims:
        if cap == 0:
            continue
        off = spec.prim_offset(ptype)
        in_type = (cand >= off) & (cand < off + cap)
        local = torch.clamp(cand - off, 0, cap - 1).long()
        if planar is not None and ptype.name in planar:
            s = {k: v[local] for k, v in planar[ptype.name].items()}
            d = ptype.sdf_planar(s, *p[:, None, :].unbind(-1))
        else:
            params = {k: v[local] for k, v in data.prims[ptype.name].items()}
            d = ptype.sdf(params, p[:, None, :])
        dists = torch.where(in_type, d, dists)
    return dists


def build_grid(spec: SceneSpec, settings: PartitioningSettings,
               data: SceneData, method: str = "gpu_fast") -> GridData:
    """The per-cell candidate lists, on the scene's device."""
    if method not in ("gpu_fast", "cpu_fast", "cpu_best"):
        raise ValueError(method)
    dev = data.materials["albedo"].device
    centers = _cell_centers(settings, dev)
    k = settings.index_count
    total = spec.total_prim_capacity
    samples = 27 if method == "cpu_best" else 1
    step = max(1, BUILD_CHUNK_ELEMS // (samples * max(total, 1)))
    offs = torch.tensor(_BEST_OFFSETS, dtype=torch.float32, device=dev) * 0.5
    sp = torch.tensor(settings.grid_spacing, dtype=torch.float32, device=dev)
    slots = torch.arange(total, device=dev)
    cells, counts = [], []
    for c0 in range(0, centers.shape[0], step):
        ctr = centers[c0:c0 + step]
        dists = all_slot_dists(spec, data, ctr)           # [c, total]
        closest = torch.amin(dists, dim=1, keepdim=True)
        if method == "cpu_best":
            pts = ctr[:, None, :] + offs * sp               # [c, 27, 3]
            sd = all_slot_dists(spec, data, pts.reshape(-1, 3))
            winners = torch.argmin(sd.reshape(ctr.shape[0], 27, total),
                                   dim=2)
            keep = torch.zeros_like(dists, dtype=torch.bool)
            keep.scatter_(1, winners, True)
        else:
            keep = dists < closest + settings.cell_diag
        keep = keep & (dists < spec.max_dist)
        order = torch.argsort(torch.where(keep, dists, torch.inf), dim=1,
                              stable=True)
        n_keep = keep.sum(dim=1, keepdim=True)
        cand = torch.where(slots < n_keep, order, -1)[:, :k]
        cells.append(cand.to(torch.int32))
        counts.append(torch.clamp_max(n_keep[:, 0], k).to(torch.int32))
    return GridData(cells=torch.cat(cells), counts=torch.cat(counts))


def grid_closest(spec: SceneSpec, settings: PartitioningSettings,
                 data: SceneData, grid: GridData, p, planar=None):
    """f32[N]: the closest distance at points p[N, 3] over their cell's
    candidates, capped at max_dist; outside the grid the border cell's
    ('clamp') or the whole scene's ('fallback').  ``planar``: as
    candidate_dists'."""
    dev = p.device
    off = torch.tensor(settings.grid_offset, dtype=torch.float32, device=dev)
    sp = torch.tensor(settings.grid_spacing, dtype=torch.float32, device=dev)
    dims = torch.tensor(settings.grid_dimensions, dtype=torch.int32,
                        device=dev)
    idx3 = torch.floor((p - off) / sp).to(torch.int32)
    inside = ((idx3 >= 0) & (idx3 < dims)).all(dim=-1)
    cid = cell_id(settings, torch.minimum(torch.clamp_min(idx3, 0),
                                          dims - 1)).long()
    cand = grid.cells[cid]
    count = grid.counts[cid]
    dists = candidate_dists(spec, data, cand, p, planar=planar)
    dists = torch.where(torch.arange(cand.shape[1], device=dev)
                        < count[:, None], dists, spec.max_dist)
    dmin = torch.clamp_max(torch.amin(dists, dim=1), spec.max_dist)
    if settings.border_behavior == "fallback":
        return torch.where(inside, dmin, scene_sdf(spec, data, p))
    return dmin
