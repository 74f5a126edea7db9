"""The march kernels: scene packing, the CUDA kernels' wrappers and their
plain PyTorch versions (port of madarch_tpu/ops/march.py's
pallas_geometry, pallas_raycast, pallas_visibility and pallas_softshadows).

``geometry`` returns what the JAX package's ``pallas_geometry`` returns: a
dict with t, hit, idx, mid, normal, ao, shadows, vis8 and, when
``mat_rough_vec`` is given, "refl" (the folded specular mode-2 bounce).
``raycast`` returns (t, hit, pos), ``visibility`` 0/1 and ``softshadows``
the penumbra factor per ray, as ``pallas_raycast``, ``pallas_visibility``
and ``pallas_softshadows`` do.  On a CUDA tensor each launches its kernel
(``csrc/geometry.cu`` for the TPU kernel ``_geometry_kernel``,
``csrc/march.cu`` for ``_raycast_kernel``, ``_visibility_kernel`` and
``_softshadow_kernel``; the design notes are in those files); on a CPU
tensor it runs its plain version (``geometry_reference``,
``raycast_reference``, ``visibility_reference``,
``softshadows_reference``), the same marches from render/raymarch.py over
``scene_dist``.

The scene packs into two f32 tables, in spec order.  The slot table has
one row per sphere, plane or box slot: (type code, global index, material
id, live flag, 6 params).  The triangle table has one row of TRI_WIDTH per
triangle slot, in slot order: the 28 constants of the derived triangle SDF
(primitives.py:TRIANGLE_DERIVED_FIELDS), global index, material id, live
flag; its slots group into chunks of CHUNK, the chunks into super-chunks
of SUPER, each with a bounding box, by which the kernels prune triangles
exactly (csrc/scene.cuh:tri_min).  Global indices are capacity based (the
type's block offset + slot); the live flag is 0 on slots past a dynamic
count, which then read as the scene-distance cap.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import torch

from madarch_tpu_torch.core.vecmath import EPSILON, dot
from madarch_tpu_torch.ops import build
from madarch_tpu_torch.render import raymarch as rm
from madarch_tpu_torch.render.probes import CORNER_OFFSETS
from madarch_tpu_torch.scene import primitives as P

SLOT_WIDTH = 10
MAX_AO_STEPS = 8
# The kernels copy the slot table, the triangle boxes, light positions and
# roughness into dynamic shared memory, which a launch gets up to 48 KiB
# of without an opt-in: about 1,200 slots, or some 14,500 triangles.  The
# triangle table itself stays in device memory, whatever its size.
SMEM_LIMIT = 48 * 1024
BIG = 1e9
# Central-difference half-step of the tetrahedron normal.
NORMAL_H = 1e-3
# Kernel type codes and each type's params in table order.
KERNEL_TYPES = {
    P.Sphere: (0, ("center", "radius")),
    P.Plane: (1, ("normal", "offset")),
    P.Box: (2, ("center", "side")),
}
TRIANGLE_CODE = 3
# The triangle table: 28 derived constants, then global index, material
# id, live flag and one float of padding (rows of 128 bytes).
TRI_WIDTH = 32
TRI_GIDX, TRI_MID, TRI_LIVE = 28, 29, 30
# Triangle slots per chunk box and chunks per super-chunk box
# (csrc/scene.cuh).
CHUNK = 8
SUPER = 8
# A box is admitted while its point-to-box distance is within
# PRUNE_REL · (coordinate scale + |p|₁) of the running minimum
# (csrc/scene.cuh:tri_min).
PRUNE_REL = 1e-4
# Float operations of one slot evaluation in csrc/scene.cuh, plus the min
# that folds it into the scene distance, by type code: sphere 3 sub, 3
# mul, 2 add, sqrt, sub; plane 3 mul, 3 add; box 3 sub, 3 abs, 3 sub, 3
# max, 3 mul, 2 add, sqrt, 3 max/min, add; triangle (tri_dist) 9 add/sub
# for p1, p2, p3, 3 dots of 5 and 3 signs and 2 adds and a compare for
# the inside test, 3 edges of 19 (dot 5, mul, clamp 2, 3 mul, 3 sub, 5 for
# the square), 2 min, the plane term 7 (dot 5, 2 mul), select, max, sqrt.
SLOT_FLOPS = {0: 11, 1: 7, 2: 23, TRIANGLE_CODE: 100}
# One point-to-box test (scene.cuh:box_d2 and its compare): 3 × (2 sub, 2
# max), 3 mul, 2 add, compare.
AABB_FLOPS = 18
# The visibility and softshadow kernels' scene-distance cap (the 1e4 of
# pallas_visibility and pallas_softshadows).
VIS_CAP = 1e4
# The plain versions evaluate at most this many points at once when the
# scene has more than CHUNK_SLOT_THRESHOLD columns, bounding their
# [points, slots] intermediates (render/context.py:GRID_CHUNK of the JAX
# package).
GRID_CHUNK = 32768
CHUNK_SLOT_THRESHOLD = 128
# Slot evaluations of the plain versions by type code, summed over every
# point they evaluate the scene at (march steps of the active lanes,
# classification, normals, AO): the work the kernels do on the same rays
# with every triangle evaluated.
scene_evals = {code: 0 for code in (0, 1, 2, TRIANGLE_CODE)}
# The work of exact pruning on the same points, given each point's scene
# distance: every super-chunk box test, the chunk box tests inside the
# super-chunks whose box lies within the pruning slack of that distance,
# and the live triangles of the chunks whose box does.  Counted only
# inside counting(): it costs a box test and a host sync per evaluation.
pruned_evals = {"aabb": 0, "triangles": 0}
_counting_pruned = False


@contextlib.contextmanager
def counting():
    """Counts the plain versions' work from zero inside the block, exact
    pruning's included."""
    global _counting_pruned
    for d in (scene_evals, pruned_evals):
        for key in d:
            d[key] = 0
    _counting_pruned = True
    try:
        yield
    finally:
        _counting_pruned = False


def scene_eval_flops(pruned=True):
    """Float operations of the slot evaluations counted since counting()
    last began: with ``pruned`` the triangles as exact pruning must
    evaluate them (box tests and admitted chunks), else every triangle."""
    flops = sum(SLOT_FLOPS[code] * n for code, n in scene_evals.items()
                if code != TRIANGLE_CODE)
    if pruned:
        return flops + AABB_FLOPS * pruned_evals["aabb"] \
            + SLOT_FLOPS[TRIANGLE_CODE] * pruned_evals["triangles"]
    return flops + SLOT_FLOPS[TRIANGLE_CODE] * scene_evals[TRIANGLE_CODE]


@dataclasses.dataclass(frozen=True)
class PackedScene:
    """``entries``: static ((ptype, first_row, n, static_counts), ...) in
    spec order, first_row indexing ``slots`` or, for triangles, ``tris``;
    ``slots``: f32[S, SLOT_WIDTH]; ``tris``: f32[n_chunks·CHUNK,
    TRI_WIDTH] (no rows without triangles); ``boxes``: f32[(1 + n_supers +
    n_chunks)·6], a row holding the coordinate scale, then the super-chunk
    and chunk boxes (lo xyz, hi xyz); ``col_gidx``/``col_mid``: i32 global
    index and material id of each column of the plain versions' distance
    table.  All on the scene's device."""

    entries: tuple
    slots: torch.Tensor
    tris: torch.Tensor
    boxes: torch.Tensor
    n_chunks: int
    col_gidx: torch.Tensor
    col_mid: torch.Tensor

    @property
    def n_slots(self):
        return self.slots.shape[0]

    @property
    def n_supers(self):
        return -(-self.n_chunks // SUPER)

    @property
    def n_columns(self):
        return self.col_gidx.shape[0]


def _pack_triangles(params, n, live, goff):
    """(triangle table, boxes) of the first n triangle slots."""
    dev = live.device
    tri = {k: v[:n].to(torch.float32) for k, v in params.items()
           if k != "material_id"}
    tri["material_id"] = params["material_id"][:n]
    der = P.Triangle.derive(tri)
    cols = []
    for name, kind in P.Triangle.derived_fields:
        if name == "material_id":
            continue
        v = der[name]
        cols += list(v.unbind(-1)) if kind == P.VEC3 else [v]
    slot = torch.arange(n, device=dev)
    cols += [(goff + slot).to(torch.float32),
             tri["material_id"].to(torch.float32), live,
             torch.zeros(n, device=dev)]
    n_chunks = -(-n // CHUNK)
    n_pad = n_chunks * CHUNK
    table = torch.zeros((n_pad, TRI_WIDTH), device=dev)
    table[:n] = torch.stack(cols, dim=1)

    lo, hi = P.Triangle.bounds(tri)
    alive = live[:, None] > 0.5
    lo = torch.where(alive, lo, BIG)
    hi = torch.where(alive, hi, -BIG)
    pad = torch.full((n_pad - n, 3), BIG, device=dev)
    lo = torch.cat([lo, pad]).reshape(n_chunks, CHUNK, 3).amin(dim=1)
    hi = torch.cat([hi, -pad]).reshape(n_chunks, CHUNK, 3).amax(dim=1)
    n_supers = -(-n_chunks // SUPER)
    padc = torch.full((n_supers * SUPER - n_chunks, 3), BIG, device=dev)
    lo_s = torch.cat([lo, padc]).reshape(n_supers, SUPER, 3).amin(dim=1)
    hi_s = torch.cat([hi, -padc]).reshape(n_supers, SUPER, 3).amax(dim=1)
    # the coordinate scale of the pruning slack: 1 + the largest vertex
    # coordinate of a live triangle
    verts = torch.stack([tri["v1"], tri["v2"], tri["v3"]], dim=1)
    scale = 1.0 + torch.where(alive[:, None], verts.abs(), 0.0).amax()
    head = torch.zeros(6, device=dev)
    head[0] = scale
    boxes = torch.cat([head, torch.cat([lo_s, hi_s], dim=1).reshape(-1),
                       torch.cat([lo, hi], dim=1).reshape(-1)])
    return table, boxes, n_chunks


def pack_scene(spec, data) -> PackedScene:
    """Pack every slot the scene loops evaluate.  Raises NotImplementedError
    for a type the kernels do not take (custom types)."""
    dev = data.materials["albedo"].device
    rows = []
    entries = []
    col_gidx, col_mid = [], []
    tris = torch.zeros((0, TRI_WIDTH), device=dev)
    boxes = torch.zeros(0, device=dev)
    n_chunks = 0
    first = 0
    goff = 0
    for ptype, cap, n, static in spec.prim_bounds():
        if n == 0:
            goff += cap
            continue
        if ptype not in KERNEL_TYPES and ptype is not P.Triangle:
            raise NotImplementedError(
                f"the kernels take spheres, planes, boxes and triangles; "
                f"not {ptype.name!r}")
        params = data.prims[ptype.name]
        slot = torch.arange(n, device=dev)
        live = torch.ones(n, dtype=torch.float32, device=dev) if static \
            else (slot < data.prim_counts[ptype.name]).to(torch.float32)
        if ptype is P.Triangle:
            if n_chunks:
                raise NotImplementedError("one triangle type per scene")
            tris, boxes, n_chunks = _pack_triangles(params, n, live, goff)
            entries.append((ptype, 0, n, static))
            col_gidx.append(tris[:n, TRI_GIDX])
            col_mid.append(tris[:n, TRI_MID])
            goff += cap
            continue
        code, names = KERNEL_TYPES[ptype]
        cols = [torch.full((n,), float(code), device=dev),
                (goff + slot).to(torch.float32),
                params["material_id"][:n].to(torch.float32), live]
        for name in names:
            v = params[name][:n].to(torch.float32)
            cols += list(v.unbind(-1)) if v.ndim == 2 else [v]
        cols += [torch.zeros(n, device=dev)] * (SLOT_WIDTH - len(cols))
        rows.append(torch.stack(cols, dim=1))
        col_gidx.append(rows[-1][:, 1])
        col_mid.append(rows[-1][:, 2])
        entries.append((ptype, first, n, static))
        first += n
        goff += cap
    if not entries:
        raise NotImplementedError("the kernels need a live primitive")
    slots = torch.cat(rows).contiguous() if rows \
        else torch.zeros((0, SLOT_WIDTH), device=dev)
    return PackedScene(
        entries=tuple(entries), slots=slots, tris=tris.contiguous(),
        boxes=boxes.contiguous(), n_chunks=n_chunks,
        col_gidx=torch.cat(col_gidx).to(torch.int32),
        col_mid=torch.cat(col_mid).to(torch.int32))


def pack_light_positions(spec, data):
    """(f32[3L] light positions in light_bounds slot order, L), or
    (None, 0) if some live light type has no vec3 'position' field."""
    parts = []
    n_slots = 0
    for ltype, cap, n, static in spec.light_bounds():
        if n == 0:
            continue
        if dict(ltype.fields).get("position") != "vec3":
            return None, 0
        parts.append(data.lights[ltype.name]["position"][:n]
                     .to(torch.float32).reshape(-1))
        n_slots += n
    if n_slots == 0:
        dev = data.materials["albedo"].device
        return torch.zeros(0, dtype=torch.float32, device=dev), 0
    return torch.cat(parts).contiguous(), n_slots


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _planar_scalars(rows, first_col, fields):
    """{scalar name: column} of a table's rows: vec3 fields split into
    name_x/name_y/name_z, in table order from first_col."""
    s = {}
    col = first_col
    for name, kind in fields:
        for sname in ([f"{name}_{ax}" for ax in "xyz"] if kind == P.VEC3
                      else [name]):
            s[sname] = rows[:, col]
            col += 1
    return s


def _slot_dists(packed, p, max_dist):
    """f32[N, C]: every packed slot's planar SDF at points p[N, 3] (a
    triangle's through sdf_planar_derived on its table row), dead slots at
    max_dist; columns in spec order."""
    px, py, pz = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    cols = []
    for ptype, first, n, static in packed.entries:
        if ptype is P.Triangle:
            rows = packed.tris[:n]
            fields = [f for f in ptype.derived_fields
                      if f[0] != "material_id"]
            d = ptype.sdf_planar_derived(_planar_scalars(rows, 0, fields),
                                         px, py, pz)
            live = rows[:, TRI_LIVE]
            code = TRIANGLE_CODE
        else:
            rows = packed.slots[first:first + n]
            code, names = KERNEL_TYPES[ptype]
            kinds = dict(ptype.fields)
            d = ptype.sdf_planar(_planar_scalars(
                rows, 4, [(k, kinds[k]) for k in names]), px, py, pz)
            live = rows[:, 3]
        if not static:
            d = torch.where(live > 0.5, d, max_dist)
        cols.append(d)
        scene_evals[code] += p.shape[0] * n
    return torch.cat(cols, dim=1)


def _tri_columns(packed):
    """(first column, count) of the triangles in the distance table."""
    col = 0
    for ptype, _, n, _ in packed.entries:
        if ptype is P.Triangle:
            return col, n
        col += n
    return col, 0


def _admitted(packed, p, best):
    """(bool[N, n_supers], bool[N, n_chunks]): the super-chunks and the
    chunks whose box lies within the pruning slack of best[N] at points
    p[N, 3] (csrc/scene.cuh:tri_min's test); a chunk only inside an
    admitted super-chunk."""
    px, py, pz = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    slack = PRUNE_REL * (packed.boxes[0] + torch.abs(p[:, 0])
                         + torch.abs(p[:, 1]) + torch.abs(p[:, 2]))
    lim = best + slack

    def within(b):
        def gap(q, lo, hi):
            return torch.clamp_min(torch.maximum(lo - q, q - hi), 0.0)

        dx = gap(px, b[:, 0], b[:, 3])
        dy = gap(py, b[:, 1], b[:, 4])
        dz = gap(pz, b[:, 2], b[:, 5])
        return dx * dx + dy * dy + dz * dz <= (lim * lim)[:, None]

    boxes = packed.boxes[6:].reshape(-1, 6)
    sup = within(boxes[:packed.n_supers])
    chunk = within(boxes[packed.n_supers:]) & sup.repeat_interleave(
        SUPER, dim=1)[:, :packed.n_chunks]
    return sup, chunk


def _count_pruned(packed, p, dmin):
    """Adds the work of exact pruning at points p with scene distances
    dmin to pruned_evals, inside counting()."""
    if not _counting_pruned or not packed.n_chunks:
        return
    sup, chunk = _admitted(packed, p, dmin)
    per_super = torch.full((packed.n_supers,), float(SUPER),
                           dtype=torch.float64, device=p.device)
    per_super[-1] = packed.n_chunks - SUPER * (packed.n_supers - 1)
    live = packed.tris[:, TRI_LIVE].reshape(packed.n_chunks, CHUNK).sum(1)
    pruned_evals["aabb"] += p.shape[0] * packed.n_supers + int(
        (sup.to(torch.float64) @ per_super).sum().item())
    pruned_evals["triangles"] += int(
        (chunk.to(torch.float64) @ live.to(torch.float64)).sum().item())


def _by_chunks(fn, packed, p, max_dist):
    """fn(packed, p, max_dist) over GRID_CHUNK points at a time when the
    scene has many columns."""
    if packed.n_columns <= CHUNK_SLOT_THRESHOLD or p.shape[0] <= GRID_CHUNK:
        return fn(packed, p, max_dist)
    parts = [fn(packed, q, max_dist) for q in p.split(GRID_CHUNK)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(x) for x in zip(*parts))
    return torch.cat(parts)


def _scene_dist(packed, p, max_dist):
    d = torch.clamp_max(torch.amin(_slot_dists(packed, p, max_dist), dim=1),
                        max_dist)
    _count_pruned(packed, p, d)
    return d


def _scene_dist_info(packed, p, max_dist):
    dmin, arg = torch.min(_slot_dists(packed, p, max_dist), dim=1)
    near = dmin < max_dist
    idx = torch.where(near, packed.col_gidx[arg], -1)
    mid = torch.where(near, packed.col_mid[arg], 0)
    dmin = torch.clamp_max(dmin, max_dist)
    _count_pruned(packed, p, dmin)
    return dmin, idx, mid


def scene_dist(packed, p, max_dist):
    """Scene distance at p[N, 3]: min over live slots, capped at max_dist."""
    return _by_chunks(_scene_dist, packed, p, max_dist)


def scene_dist_info(packed, p, max_dist):
    """(distance, global index i32 (-1 when nothing is under max_dist),
    material id i32): the first minimum in spec order wins."""
    return _by_chunks(_scene_dist_info, packed, p, max_dist)


def pruned_scene_dist(packed, p, max_dist):
    """Scene distance at p[N, 3] with only the admitted triangle chunks
    evaluated (those pruned_evals counts): the vectorised emulation of the
    kernels' exact pruning, equal to scene_dist wherever it is exact."""
    d = _slot_dists(packed, p, max_dist)
    dmin = torch.clamp_max(torch.amin(d, dim=1), max_dist)
    first, n = _tri_columns(packed)
    if n:
        admitted = _admitted(packed, p, dmin)[1].repeat_interleave(
            CHUNK, dim=1)[:, :n]
        d = d.clone()
        d[:, first:first + n] = torch.where(admitted, d[:, first:first + n],
                                            torch.inf)
    return torch.clamp_max(torch.amin(d, dim=1), max_dist)


def _fd_normal(sdf_b, p, h):
    """Tetrahedron finite-difference normal, summed in the kernel's order."""
    hx = torch.tensor([h, -h, -h, h], device=p.device)
    hy = torch.tensor([-h, -h, h, h], device=p.device)
    hz = torch.tensor([-h, h, -h, h], device=p.device)
    q = torch.stack([p[None, :, 0] + hx[:, None], p[None, :, 1] + hy[:, None],
                     p[None, :, 2] + hz[:, None]], dim=-1)
    f0, f1, f2, f3 = sdf_b(q.reshape(-1, 3)).reshape(4, -1)
    gx = f0 - f1 - f2 + f3
    gy = -f0 - f1 + f2 + f3
    gz = -f0 + f1 - f2 + f3
    norm = torch.sqrt(gx * gx + gy * gy + gz * gz + 1e-24)
    return torch.stack([gx / norm, gy / norm, gz / norm], dim=-1)


def _shadows(sdf_b, lpos, n_lights, p, so, normal, hit, k, max_steps, eps):
    """f32[L, N] penumbra per light: from the offset point so, toward the
    light as seen from the un-offset point p, enabled where n·l > EPSILON."""
    n = p.shape[0]
    if n_lights == 0:
        return torch.ones((0, n), dtype=torch.float32, device=p.device)
    lp = lpos.reshape(n_lights, 1, 3)
    tl = lp - p[None]                                    # [L, N, 3]
    ldist = torch.sqrt(dot(tl, tl))
    ldir = tl * (1.0 / torch.clamp_min(ldist, 1e-9))[..., None]
    en = hit[None] & (dot(normal[None], ldir) > EPSILON)
    sh = rm.softshadows(
        sdf_b, so.repeat(n_lights, 1), ldir.reshape(-1, 3),
        torch.zeros(n_lights * n, device=p.device), ldist.reshape(-1), k,
        enabled=en.reshape(-1), max_steps=max_steps, eps=eps)
    return sh.reshape(n_lights, n)


def _vis8(sdf_b, p, so, hit, spacing, dims, surface_offset, max_steps, eps,
          omega, pick_normal=None):
    """f32[8, N] probe visibility to the clamped probe-cell corners, and
    with pick_normal the mode-2 best probe (id as f32, -dir to it)."""
    n = p.shape[0]
    dev = p.device
    sp = torch.tensor(spacing, dtype=torch.float32, device=dev)
    hi = torch.tensor([d - 1 for d in dims], dtype=torch.float32, device=dev)
    cell = torch.floor(p / sp)
    bits = torch.tensor(CORNER_OFFSETS, dtype=torch.float32, device=dev)
    corner = torch.minimum(torch.clamp_min(cell[None] + bits[:, None], 0.0),
                           hi)                           # [8, N, 3]
    w = corner * sp - p[None]
    pdist = torch.clamp_min(torch.sqrt(dot(w, w)), 1e-6)
    vdir = w * (1.0 / pdist)[..., None]
    vis = rm.raycast_visibility(
        sdf_b, so.repeat(8, 1), vdir.reshape(-1, 3),
        (pdist - surface_offset).reshape(-1),
        enabled=hit.repeat(8), max_steps=max_steps, eps=eps,
        omega=omega).reshape(8, n)
    if pick_normal is None:
        return vis, None, None
    pid = (corner[..., 2] * float(dims[0] * dims[1])
           + corner[..., 1] * float(dims[0]) + corner[..., 0])
    bw = torch.full((n,), -BIG, device=dev)
    bpid = torch.zeros(n, device=dev)
    bdir = torch.zeros((n, 3), device=dev)
    for k in range(8):
        wk = dot(vdir[k], pick_normal) * vis[k]
        better = wk > bw
        bw = torch.maximum(bw, wk)
        bpid = torch.where(better, pid[k], bpid)
        bdir = torch.where(better[:, None], -vdir[k], bdir)
    return vis, bpid, bdir


def geometry_reference(packed, lpos, n_lights, origins, dirs, max_dist, *,
                       probe_spacing, probe_dims, surface_offset, ao_steps,
                       ao_step_size=0.1, shadow_k=64.0, eps=EPSILON,
                       max_steps=300, omega=1.6, mat_rough_vec=None,
                       refl_shadows=True, enabled=None):
    """Plain PyTorch version of the geometry kernel: the same marches,
    offsets, masks, FD normal and in-order pick, in batched tensor ops."""
    n = origins.shape[0]
    dev = origins.device
    if enabled is None:
        enabled = torch.ones(n, dtype=torch.bool, device=dev)

    def sdf_b(p):
        return scene_dist(packed, p, max_dist)

    march = dict(eps=eps, max_steps=max_steps)

    def bounce(o, d, en_b):
        t, _, _ = rm.raycast(sdf_b, o, d, max_dist, enabled=en_b,
                             omega=omega, **march)
        p = o + t[:, None] * d
        d_end, idx, mid = scene_dist_info(packed, p, max_dist)
        hit = en_b & (d_end < eps) & (t < max_dist)
        normal = _fd_normal(sdf_b, p, NORMAL_H)
        so = p + normal * surface_offset
        return t, p, hit, idx, mid, normal, so

    t, p, hit, idx, mid, normal, so = bounce(origins, dirs, enabled)
    ao = rm.ambient_occlusion(sdf_b, p, normal, steps=ao_steps,
                              step_size=ao_step_size)
    shadows = _shadows(sdf_b, lpos, n_lights, p, so, normal, hit, shadow_k,
                       **march)
    vis8 = _vis8(sdf_b, p, so, hit, probe_spacing, probe_dims,
                 surface_offset, omega=omega, **march)[0]
    out = {"t": t, "hit": hit, "idx": torch.where(hit, idx, -1), "mid": mid,
           "normal": normal, "ao": ao, "shadows": shadows, "vis8": vis8,
           "refl": None}
    if mat_rough_vec is None:
        return out

    n_mats = mat_rough_vec.shape[0]
    in_range = (mid >= 0) & (mid < n_mats)
    rough = torch.where(
        in_range, mat_rough_vec.reshape(-1)[mid.clamp(0, n_mats - 1).long()],
        0.0)
    r_en = hit & (rough < 0.75)
    ddn = dot(dirs, normal)
    r_d = dirs - (2.0 * ddn)[:, None] * normal
    r_t, rp, r_hit, _, r_mid, r_normal, r_so = bounce(so, r_d, r_en)
    r_sh = _shadows(sdf_b, lpos, n_lights, rp, r_so, r_normal, r_hit,
                    shadow_k, **march) if refl_shadows \
        else torch.ones((n_lights, n), dtype=torch.float32, device=dev)
    r_vis, best_pid, best_dir = _vis8(
        sdf_b, rp, r_so, r_hit, probe_spacing, probe_dims, surface_offset,
        omega=omega, pick_normal=r_normal, **march)
    out["refl"] = {"t": r_t, "hit": r_hit, "mid": r_mid, "normal": r_normal,
                   "shadows": r_sh, "vis8": r_vis, "best_pid": best_pid,
                   "best_dir": best_dir}
    return out


def raycast_reference(packed, origins, dirs, max_dist, *, eps=EPSILON,
                      max_steps=300, enabled=None, omega=1.6):
    """Plain PyTorch version of the raycast kernel: render/raymarch.py's
    raycast over the packed scene, whose distances cap at max_dist."""
    return rm.raycast(lambda p: scene_dist(packed, p, max_dist), origins,
                      dirs, max_dist, eps=eps, max_steps=max_steps,
                      enabled=enabled, omega=omega)


def visibility_reference(packed, origins, dirs, max_dists, *, eps=EPSILON,
                         max_steps=300, enabled=None, omega=1.6):
    """Plain PyTorch version of the visibility kernel: render/raymarch.py's
    raycast_visibility over the packed scene, whose distances cap at
    VIS_CAP."""
    return rm.raycast_visibility(
        lambda p: scene_dist(packed, p, VIS_CAP), origins, dirs, max_dists,
        eps=eps, max_steps=max_steps, enabled=enabled, omega=omega)


def softshadows_reference(packed, origins, dirs, min_dists, max_dists, k, *,
                          eps=EPSILON, max_steps=300, enabled=None):
    """Plain PyTorch version of the softshadow kernel: render/raymarch.py's
    softshadows over the packed scene, whose distances cap at VIS_CAP."""
    return rm.softshadows(
        lambda p: scene_dist(packed, p, VIS_CAP), origins, dirs, min_dists,
        max_dists, k, eps=eps, max_steps=max_steps, enabled=enabled)


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------

class _GeomArgs(ctypes.Structure):
    """Field for field the GeomArgs struct of csrc/geometry.cu."""

    _fields_ = [
        ("slots", ctypes.c_void_p), ("n_slots", ctypes.c_int),
        ("tris", ctypes.c_void_p), ("boxes", ctypes.c_void_p),
        ("n_box_f", ctypes.c_int), ("n_chunks", ctypes.c_int),
        ("n_supers", ctypes.c_int),
        ("lpos", ctypes.c_void_p), ("n_lights", ctypes.c_int),
        ("rough", ctypes.c_void_p), ("n_mats", ctypes.c_int),
        ("origins", ctypes.c_void_p), ("dirs", ctypes.c_void_p),
        ("enabled", ctypes.c_void_p), ("n", ctypes.c_int),
        ("max_dist", ctypes.c_float), ("eps", ctypes.c_float),
        ("max_steps", ctypes.c_int), ("omega", ctypes.c_float),
        ("one_minus_omega", ctypes.c_float), ("shadow_k", ctypes.c_float),
        ("surf_off", ctypes.c_float), ("ndotl_min", ctypes.c_float),
        ("normal_h", ctypes.c_float), ("ao_steps", ctypes.c_int),
        ("ao_h", ctypes.c_float * MAX_AO_STEPS),
        ("ao_max_sum", ctypes.c_float),
        ("spx", ctypes.c_float), ("spy", ctypes.c_float),
        ("spz", ctypes.c_float),
        ("dimx", ctypes.c_int), ("dimy", ctypes.c_int),
        ("dimz", ctypes.c_int),
        ("refl_shadows", ctypes.c_int),
        ("t", ctypes.c_void_p), ("hit", ctypes.c_void_p),
        ("idx", ctypes.c_void_p), ("mid", ctypes.c_void_p),
        ("normal", ctypes.c_void_p), ("ao", ctypes.c_void_p),
        ("shadows", ctypes.c_void_p), ("vis8", ctypes.c_void_p),
        ("r_t", ctypes.c_void_p), ("r_hit", ctypes.c_void_p),
        ("r_mid", ctypes.c_void_p), ("r_normal", ctypes.c_void_p),
        ("r_shadows", ctypes.c_void_p), ("r_vis8", ctypes.c_void_p),
        ("best_pid", ctypes.c_void_p), ("best_dir", ctypes.c_void_p),
    ]


def _library():
    lib = build.load("geometry")
    lib.madarch_geometry.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p]
    lib.madarch_geometry.restype = ctypes.c_int
    return lib


def _check(name, x, device, dtype, shape):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _check_scene(packed, dev):
    _check("packed.slots", packed.slots, dev, torch.float32,
           (packed.n_slots, SLOT_WIDTH))
    _check("packed.tris", packed.tris, dev, torch.float32,
           (packed.n_chunks * CHUNK, TRI_WIDTH))
    _check("packed.boxes", packed.boxes, dev, torch.float32,
           ((1 + packed.n_supers + packed.n_chunks) * 6
            if packed.n_chunks else 0,))


def _scene_fields(packed, extra_smem_floats, kernels):
    """The scene's fields of _GeomArgs/_MarchArgs; raises when its shared
    memory (slot table, boxes and extra_smem_floats) exceeds SMEM_LIMIT."""
    n_bytes = 4 * (packed.slots.numel() + packed.boxes.numel()
                   + extra_smem_floats)
    if n_bytes > SMEM_LIMIT:
        raise NotImplementedError(
            f"scene needs {n_bytes} bytes of shared memory; the {kernels} "
            f"kernels hold at most {SMEM_LIMIT}")
    return dict(slots=_ptr(packed.slots), n_slots=packed.n_slots,
                tris=_ptr(packed.tris), boxes=_ptr(packed.boxes),
                n_box_f=packed.boxes.numel(), n_chunks=packed.n_chunks,
                n_supers=packed.n_supers)


def geometry(packed, lpos, n_lights, origins, dirs, max_dist, *,
             probe_spacing, probe_dims, surface_offset, ao_steps,
             ao_step_size=0.1, shadow_k=64.0, eps=EPSILON, max_steps=300,
             omega=1.6, mat_rough_vec=None, refl_shadows=True,
             enabled=None):
    """Fused geometry pass over rays origins/dirs f32[N, 3]: a dict with t,
    hit (bool), idx (i32 global index, -1 where not hit), mid (i32),
    normal f32[N,3], ao f32[N], shadows f32[L,N], vis8 f32[8,N], and
    "refl" = {t, hit, mid, normal, shadows, vis8, best_pid, best_dir} when
    ``mat_rough_vec`` (f32[n_mats] roughness) is given, else None.

    Outputs other than t/hit are meaningful only where hit holds (shadows
    and vis8 also only where their march was enabled); with
    ``refl_shadows`` False the reflection's shadows are all ones;
    ``ao_steps`` 0 gives ao 1.  ``enabled``: optional bool[N]; a disabled
    ray does not march (t 0), is no hit and enables no other march."""
    dev = origins.device
    n = origins.shape[0]
    _check("origins", origins, dev, torch.float32, (n, 3))
    _check("dirs", dirs, dev, torch.float32, (n, 3))
    if enabled is not None:
        _check("enabled", enabled, dev, torch.bool, (n,))
    _check_scene(packed, dev)
    _check("lpos", lpos, dev, torch.float32, (3 * n_lights,))
    if mat_rough_vec is not None:
        _check("mat_rough_vec", mat_rough_vec, dev, torch.float32,
               (mat_rough_vec.shape[0],))
    if not 0 <= ao_steps <= MAX_AO_STEPS:
        raise ValueError(f"ao_steps must be in [0, {MAX_AO_STEPS}]")
    kwargs = dict(probe_spacing=probe_spacing, probe_dims=probe_dims,
                  surface_offset=surface_offset, ao_steps=ao_steps,
                  ao_step_size=ao_step_size, shadow_k=shadow_k, eps=eps,
                  max_steps=max_steps, omega=omega,
                  mat_rough_vec=mat_rough_vec, refl_shadows=refl_shadows,
                  enabled=enabled)
    if dev.type == "cpu":
        return geometry_reference(packed, lpos, n_lights, origins, dirs,
                                  max_dist, **kwargs)
    if dev.type != "cuda":
        raise ValueError(f"geometry runs on cpu or cuda, not {dev}")
    return _launch(packed, lpos, n_lights, origins, dirs, max_dist, **kwargs)


def _launch(packed, lpos, n_lights, origins, dirs, max_dist, *,
            probe_spacing, probe_dims, surface_offset, ao_steps,
            ao_step_size, shadow_k, eps, max_steps, omega, mat_rough_vec,
            refl_shadows, enabled):
    lib = _library()
    dev = origins.device
    n = origins.shape[0]
    refl = mat_rough_vec is not None
    scene = _scene_fields(packed, lpos.numel() + (
        mat_rough_vec.numel() if refl else 0), "geometry")

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    out = {"t": f32(n), "hit": f32(n), "idx": i32(n), "mid": i32(n),
           "normal": f32(n, 3), "ao": f32(n), "shadows": f32(n_lights, n),
           "vis8": f32(8, n)}
    r_out = {"t": f32(n), "hit": f32(n), "mid": i32(n), "normal": f32(n, 3),
             "shadows": f32(n_lights, n), "vis8": f32(8, n),
             "best_pid": f32(n), "best_dir": f32(n, 3)} if refl else {}

    # AO offsets and their weighted sum in double, rounded once to f32 the
    # way the plain version's Python-float constants are
    hs = [(i + 1) * ao_step_size for i in range(ao_steps)]
    ao_max = sum(h / (2.0 ** i) for i, h in enumerate(hs))
    args = _GeomArgs(
        **scene, lpos=_ptr(lpos), n_lights=n_lights,
        rough=_ptr(mat_rough_vec), n_mats=mat_rough_vec.shape[0] if refl
        else 0,
        origins=_ptr(origins), dirs=_ptr(dirs), enabled=_ptr(enabled), n=n,
        max_dist=max_dist, eps=eps, max_steps=max_steps, omega=omega,
        one_minus_omega=1.0 - omega, shadow_k=shadow_k,
        surf_off=surface_offset, ndotl_min=EPSILON, normal_h=NORMAL_H,
        ao_steps=ao_steps,
        ao_h=(ctypes.c_float * MAX_AO_STEPS)(*hs),
        ao_max_sum=ao_max,
        spx=probe_spacing[0], spy=probe_spacing[1], spz=probe_spacing[2],
        dimx=probe_dims[0], dimy=probe_dims[1], dimz=probe_dims[2],
        refl_shadows=int(refl_shadows),
        t=_ptr(out["t"]), hit=_ptr(out["hit"]), idx=_ptr(out["idx"]),
        mid=_ptr(out["mid"]), normal=_ptr(out["normal"]),
        ao=_ptr(out["ao"]), shadows=_ptr(out["shadows"]),
        vis8=_ptr(out["vis8"]),
        r_t=_ptr(r_out.get("t")), r_hit=_ptr(r_out.get("hit")),
        r_mid=_ptr(r_out.get("mid")), r_normal=_ptr(r_out.get("normal")),
        r_shadows=_ptr(r_out.get("shadows")),
        r_vis8=_ptr(r_out.get("vis8")),
        best_pid=_ptr(r_out.get("best_pid")),
        best_dir=_ptr(r_out.get("best_dir")))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.madarch_geometry(ctypes.addressof(args), int(refl),
                                   stream)
    if err != 0:
        raise RuntimeError(f"geometry kernel launch failed: cudaError {err}")
    geometry.launches += 1

    out["hit"] = out["hit"] > 0.5
    out["refl"] = None
    if refl:
        r_out["hit"] = r_out["hit"] > 0.5
        out["refl"] = r_out
    return out


class _MarchArgs(ctypes.Structure):
    """Field for field the MarchArgs struct of csrc/march.cu."""

    _fields_ = [
        ("slots", ctypes.c_void_p), ("n_slots", ctypes.c_int),
        ("tris", ctypes.c_void_p), ("boxes", ctypes.c_void_p),
        ("n_box_f", ctypes.c_int), ("n_chunks", ctypes.c_int),
        ("n_supers", ctypes.c_int),
        ("origins", ctypes.c_void_p), ("dirs", ctypes.c_void_p),
        ("min_dists", ctypes.c_void_p), ("max_dists", ctypes.c_void_p),
        ("enabled", ctypes.c_void_p), ("n", ctypes.c_int),
        ("max_dist", ctypes.c_float), ("cap", ctypes.c_float),
        ("eps", ctypes.c_float), ("max_steps", ctypes.c_int),
        ("omega", ctypes.c_float), ("one_minus_omega", ctypes.c_float),
        ("k", ctypes.c_float),
        ("t", ctypes.c_void_p), ("hit", ctypes.c_void_p),
        ("vis", ctypes.c_void_p),
    ]


def _march_library():
    lib = build.load("march")
    for fn in (lib.madarch_raycast, lib.madarch_visibility,
               lib.madarch_softshadows):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_rays(packed, origins, dirs, enabled):
    """Checks the arguments the raycast and visibility wrappers share and
    returns the enable mask as a bool[N] tensor."""
    dev = origins.device
    n = origins.shape[0]
    _check("origins", origins, dev, torch.float32, (n, 3))
    _check("dirs", dirs, dev, torch.float32, (n, 3))
    _check_scene(packed, dev)
    if enabled is None:
        return torch.ones(n, dtype=torch.bool, device=dev)
    _check("enabled", enabled, dev, torch.bool, (n,))
    return enabled


def _launch_march(fn, packed, origins, dirs, enabled, **fields):
    """Launches one of csrc/march.cu's kernels on the current stream."""
    scene = _scene_fields(packed, 0, "march")
    omega = fields.pop("omega")
    args = _MarchArgs(**scene, origins=_ptr(origins), dirs=_ptr(dirs),
                      enabled=_ptr(enabled), n=origins.shape[0],
                      omega=omega, one_minus_omega=1.0 - omega, **fields)
    dev = origins.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.addressof(args), stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")


def raycast(packed, origins, dirs, max_dist, *, eps=EPSILON, max_steps=300,
            enabled=None, omega=1.6):
    """Over-relaxed primary march of rays origins/dirs f32[N, 3] to
    max_dist (also the scene-distance cap): (t f32[N], max_dist or more
    on a miss and 0 where disabled; hit bool[N]; pos = o + t·d).
    ``enabled``: optional bool[N]; disabled rays never march."""
    dev = origins.device
    en = _check_rays(packed, origins, dirs, enabled)
    kwargs = dict(eps=eps, max_steps=max_steps, omega=omega)
    if dev.type == "cpu":
        return raycast_reference(packed, origins, dirs, max_dist,
                                 enabled=enabled, **kwargs)
    if dev.type != "cuda":
        raise ValueError(f"raycast runs on cpu or cuda, not {dev}")
    n = origins.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    _launch_march(_march_library().madarch_raycast, packed, origins, dirs,
                  en, max_dist=max_dist, cap=max_dist, t=_ptr(t),
                  hit=_ptr(hit), **kwargs)
    raycast.launches += 1
    return t, hit, origins + t[:, None] * dirs


def visibility(packed, origins, dirs, max_dists, *, eps=EPSILON,
               max_steps=300, enabled=None, omega=1.6):
    """f32[N]: 1 where the ray origins/dirs f32[N, 3] reaches its own
    max_dists f32[N] unblocked, else 0; a ray starts only where
    0 < max_dist and ``enabled`` (optional bool[N]) holds."""
    dev = origins.device
    n = origins.shape[0]
    en = _check_rays(packed, origins, dirs, enabled)
    _check("max_dists", max_dists, dev, torch.float32, (n,))
    kwargs = dict(eps=eps, max_steps=max_steps, omega=omega)
    if dev.type == "cpu":
        return visibility_reference(packed, origins, dirs, max_dists,
                                    enabled=enabled, **kwargs)
    if dev.type != "cuda":
        raise ValueError(f"visibility runs on cpu or cuda, not {dev}")
    vis = torch.empty(n, dtype=torch.float32, device=dev)
    _launch_march(_march_library().madarch_visibility, packed, origins,
                  dirs, en, max_dists=_ptr(max_dists), max_dist=VIS_CAP,
                  cap=VIS_CAP, vis=_ptr(vis), **kwargs)
    visibility.launches += 1
    return vis


def softshadows(packed, origins, dirs, min_dists, max_dists, k, *,
                eps=EPSILON, max_steps=300, enabled=None):
    """f32[N]: the improved-penumbra factor of the ray origins/dirs
    f32[N, 3] marched (omega 1) from its min_dists to its max_dists
    f32[N], k the penumbra sharpness; 0 where the ray hits geometry, 1
    where it never starts (``enabled``, optional bool[N], false, or
    min_dist >= max_dist)."""
    dev = origins.device
    n = origins.shape[0]
    en = _check_rays(packed, origins, dirs, enabled)
    _check("min_dists", min_dists, dev, torch.float32, (n,))
    _check("max_dists", max_dists, dev, torch.float32, (n,))
    kwargs = dict(eps=eps, max_steps=max_steps)
    if dev.type == "cpu":
        return softshadows_reference(packed, origins, dirs, min_dists,
                                     max_dists, k, enabled=enabled, **kwargs)
    if dev.type != "cuda":
        raise ValueError(f"softshadows runs on cpu or cuda, not {dev}")
    res = torch.empty(n, dtype=torch.float32, device=dev)
    _launch_march(_march_library().madarch_softshadows, packed, origins,
                  dirs, en, min_dists=_ptr(min_dists),
                  max_dists=_ptr(max_dists), max_dist=VIS_CAP, cap=VIS_CAP,
                  omega=1.0, k=k, vis=_ptr(res), **kwargs)
    softshadows.launches += 1
    return res


# Kernel launches since the count was last reset (the CPU path does not
# count): lets a run show that its main path went through the kernels.
geometry.launches = 0
raycast.launches = 0
visibility.launches = 0
softshadows.launches = 0
