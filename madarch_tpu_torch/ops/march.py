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

The scene packs into the tables csrc/scene.cuh reads.  ``rows``: float4
rows in three typed runs, spheres (center, radius), planes (normal,
offset), boxes (every center, then every half-side).  ``chunks``: the
chunked types, chunk-major, per chunk of CHUNK slots TRI_ROWS x CHUNK
float4, row k of every slot of the chunk before row k + 1: a triangle's
28 derived constants (primitives.py:TRIANGLE_DERIVED_FIELDS), a sphere's
(center, radius) in row 0, a box's center and half-side in rows 0 and 1.
A type is chunked where the JAX package's ``build_plan`` gives it its
chunked layout (kind "c") and it has bounds: triangles, and spheres and
boxes of more than SMEM_ROLLED_SLOTS_MAX slots (``chunked_layout``); the
chunk runs go spheres, boxes, triangles, each but the last padded with
inert chunks to a whole super-chunk, so that no super-chunk holds two
types.  Spheres and boxes go in Z-order of their centers (a chunk's box
then holds neighbours; ``col_slot`` maps each back to its column),
triangles in slot order.  ``info``: (global index, material id) per slot
in run order, then per chunk slot.  ``aabbs``: (lo, 0, hi, 0) per super-chunk of SUPER
chunks and per chunk, by which the kernels prune the chunked slots
exactly (csrc/scene.cuh:chunk_min).  Global indices are capacity based
(the type's block offset + slot).  A slot past a dynamic count is packed
inert: a sphere of radius -1e9, a plane 1e9 away, a box of half-side
-1e9, a triangle 3e9 away, so its distance never comes under a
scene-distance cap.  ``cap_boxes``: on a scene whose every live type has
a global box (all bounded, as the JAX package's
``ScenePlan.all_bounded``), each type's box grown by FAR_MARGIN, at whose
exit raycast, visibility and geometry end a ray (``ray_box_cap``); a ray
so capped short of max_dist is a miss at t = max_dist.

Where a launch keeps the typed runs and the boxes (and, for geometry, the
light positions and roughness) is its placement (``placement_for``):
staged in shared memory up to SMEM_LIMIT; past it, for the geometry
kernel, staged after an opt-in up to the card's limit; else read in place
from device memory.

``geometry`` picks the lanes per ray of its launch from the scene's layout
and the ray count (``geometry_lanes``); ``raycast``, ``visibility`` and
``softshadows`` launch the build of march.cu for the scene's layout when it
has one (``march_layout``).  Each of the four takes ``placement`` to force
one, for a measurement.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from madarch_tpu_torch.core.constants import cached
from madarch_tpu_torch.core.vecmath import EPSILON, dot
from madarch_tpu_torch.ops import build, probe_lookup
from madarch_tpu_torch.render import raymarch as rm
from madarch_tpu_torch.render.probes import CORNER_OFFSETS
from madarch_tpu_torch.scene import primitives as P

MAX_AO_STEPS = 8
# The most dynamic shared memory a block gets without an opt-in.  A launch
# whose staged tables (the typed slot runs, the chunk and super-chunk
# boxes and, for geometry, the light positions and roughness) fit stages
# them there; past it the kernels of OPTIN_KERNELS stage them after
# cudaFuncSetAttribute, up to the card's opt-in limit (232,448 bytes on
# an H100), and read them in place from device memory past that, as the
# other kernels do past SMEM_LIMIT (``placement_for``).  The chunk table
# stays in device memory, whatever its size.
SMEM_LIMIT = 48 * 1024
PLACEMENTS = ("staged", "optin", "global")
# On the 12,000-triangle grid at 800² (chip_smoke.py phase 39, PERF.md
# §6) the opt-in beat device memory on the geometry launches by 2-4%
# and lost to it on visibility and softshadows by 9-14% (a 54 KB block
# leaves 4 blocks an SM), raycast within the noise of two calls.
OPTIN_KERNELS = ("geometry",)
BIG = 1e9
# Central-difference half-step of the tetrahedron normal.
NORMAL_H = 1e-3
# The slot types in run order, each with its params in row order and the
# params of a dead slot.
KERNEL_TYPES = {
    P.Sphere: (0, ("center", "radius"), {"center": 0.0, "radius": -BIG}),
    P.Plane: (1, ("normal", "offset"), {"normal": 0.0, "offset": BIG}),
    P.Box: (2, ("center", "side"), {"center": 0.0, "side": -BIG}),
}
TRIANGLE_CODE = 3
# A triangle's 28 derived constants are TRI_ROWS float4 rows; a dead or
# padded triangle slot holds v1 = (3e9, 0, 0) and zeros, 3e9 from anywhere.
TRI_ROWS = 7
DEAD_TRIANGLE_X = 3e9
# Slots per chunk box and chunks per super-chunk box (csrc/scene.cuh).
CHUNK = 8
SUPER = 8
# The JAX package's build_plan gives a type of more than UNROLL_SLOTS_MAX
# slots its rolled layout while the type has at most SMEM_ROLLED_SLOTS_MAX
# slots and SMEM_ROLLED_SCALARS_MAX scalars (slots x its fields' scalars),
# else its chunked layout; the port chunks a sphere or box type exactly
# there (``chunked_layout``), and triangles always.
SMEM_ROLLED_SLOTS_MAX = 64
SMEM_ROLLED_SCALARS_MAX = 512
# A box is admitted while its point-to-box distance is within
# PRUNE_REL · (coordinate scale + |p|₁) of the running minimum
# (csrc/scene.cuh:chunk_min).
PRUNE_REL = 1e-4
# Lanes per ray the geometry kernel is built for (csrc/geometry.cu).
LANE_CHOICES = (1, 8)
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
# A type of more slots than this has a global box when its primitive has
# bounds (the JAX package's build_plan: its unrolled types have none), and
# a scene whose every live type has one is all bounded: its marches end at
# the exit from those boxes grown by FAR_MARGIN (csrc/scene.cuh:box_cap).
# The margin is the JAX package's; it must exceed a march's eps.
UNROLL_SLOTS_MAX = 8
FAR_MARGIN = 0.015
# Float operations of one ray's slab test against one cap box
# (scene.cuh:box_cap): per axis abs, compare, divide, 2 sub, 2 mul, min and
# max; 2 max and 2 min for entry and exit, a compare, 2 max.
CAP_FLOPS = 31
# The plain versions evaluate at most this many points at once when the
# scene has more than CHUNK_SLOT_THRESHOLD columns, bounding their
# [points, slots] intermediates (render/context.py:GRID_CHUNK of the JAX
# package).
GRID_CHUNK = 32768
CHUNK_SLOT_THRESHOLD = 128
# Slot evaluations of the plain versions by type code, summed over every
# point they evaluate the scene at (march steps of the active lanes,
# classification, normals, AO): the work the kernels do on the same rays
# with every slot evaluated.
scene_evals = {code: 0 for code in (0, 1, 2, TRIANGLE_CODE)}
# The part of scene_evals that fell to chunked types, by type code.
chunk_evals = {code: 0 for code in (0, 2, TRIANGLE_CODE)}
# The work of exact pruning on the same points, given each point's scene
# distance: every super-chunk box test, the chunk box tests inside the
# super-chunks whose box lies within the pruning slack of that distance,
# and the live slots of the chunks whose box does, by chunked type.
# Counted only inside counting(): it costs a box test and a host sync per
# evaluation.
CHUNK_KEYS = {0: "spheres", 2: "boxes", TRIANGLE_CODE: "triangles"}
pruned_evals = {"aabb": 0, **{key: 0 for key in CHUNK_KEYS.values()}}
# Rays x cap boxes slab-tested by the plain versions (ray_box_cap).
cap_tests = {"boxes": 0}
_counting_pruned = False


@contextlib.contextmanager
def counting():
    """Counts the plain versions' work from zero inside the block, exact
    pruning's included."""
    global _counting_pruned
    for d in (scene_evals, chunk_evals, pruned_evals, cap_tests):
        for key in d:
            d[key] = 0
    _counting_pruned = True
    try:
        yield
    finally:
        _counting_pruned = False


def scene_eval_flops(pruned=True):
    """Float operations of the slot evaluations counted since counting()
    last began: with ``pruned`` the chunked slots as exact pruning must
    evaluate them (box tests and admitted chunks), else every chunked
    slot; with the box-exit caps' slab tests either way."""
    flops = sum(SLOT_FLOPS[code] * (n - chunk_evals.get(code, 0))
                for code, n in scene_evals.items()) \
        + CAP_FLOPS * cap_tests["boxes"]
    if pruned:
        return flops + AABB_FLOPS * pruned_evals["aabb"] + sum(
            SLOT_FLOPS[code] * pruned_evals[key]
            for code, key in CHUNK_KEYS.items())
    return flops + sum(SLOT_FLOPS[code] * n
                       for code, n in chunk_evals.items())


@dataclasses.dataclass(frozen=True)
class PackedScene:
    """``entries``: static ((ptype, first, n, static_counts), ...) in spec
    order, first the type's first row of ``rows``, or for a chunked type
    its first chunk of ``chunks``; ``rows``: f32[n_spheres + n_planes +
    2·n_boxes, 4], the typed runs; ``counts``: (n_spheres, n_planes,
    n_boxes) of the typed runs; ``info``: i32[n_slots + n_chunks·CHUNK,
    2]; ``chunks``: f32[n_chunks, TRI_ROWS, CHUNK, 4]; ``chunk_runs``:
    ((type code, first chunk, chunks), ...) in chunk order (spheres, boxes,
    triangles), the chunks padded inert to whole super-chunks but the
    last run's; ``chunk_live``: f32[n_chunks·CHUNK], 1 on live chunk
    slots; ``col_slot``: i64[n_columns], each column's slot of the chunk
    table (chunk·CHUNK + its place in the chunk), -1 for a column of a
    typed run; ``aabbs``: f32[1 + n_supers + n_chunks, 8], a row holding the
    coordinate scale, then the super-chunk and chunk boxes (lo xyz, 0, hi
    xyz, 0), empty without chunks; ``col_gidx``/``col_mid``: i32 global
    index and material id of each column of the plain versions' distance
    table (spec order); ``cap_boxes``: f32[B, 6], on an all-bounded scene
    each live type's global box grown by ``cap_margin`` (lo xyz, hi xyz),
    else empty with ``cap_margin`` None.  All on the scene's device."""

    entries: tuple
    rows: torch.Tensor
    counts: tuple
    info: torch.Tensor
    chunks: torch.Tensor
    chunk_runs: tuple
    chunk_live: torch.Tensor
    col_slot: torch.Tensor
    aabbs: torch.Tensor
    n_chunks: int
    col_gidx: torch.Tensor
    col_mid: torch.Tensor
    cap_boxes: torch.Tensor
    cap_margin: float | None

    @property
    def n_slots(self):
        return sum(self.counts)

    @property
    def n_supers(self):
        return -(-self.n_chunks // SUPER)

    @property
    def n_columns(self):
        return self.col_gidx.shape[0]

    def chunked(self, ptype):
        """Whether ptype's slots sit in ``chunks``."""
        code = TRIANGLE_CODE if ptype is P.Triangle \
            else KERNEL_TYPES[ptype][0]
        return any(c == code for c, _, _ in self.chunk_runs)

    def chunk_end(self, code):
        """The chunks of the runs of the types up to ``code``: the first
        chunk of the run after them."""
        return sum(n for c, _, n in self.chunk_runs if c <= code)

    def triangle_rows(self):
        """f32[n·CHUNK, 28]: each triangle slot's derived constants in
        TRIANGLE_DERIVED_FIELDS order, n the triangle chunks."""
        tri = self.chunks[self.chunk_end(2):]
        return tri.permute(0, 2, 1, 3).reshape(-1, 4 * TRI_ROWS)


def chunked_layout(ptype, n):
    """Whether a type of n slots packs into ``chunks``: triangles always;
    a sphere or box type where the JAX package's build_plan gives it its
    chunked layout (kind "c"); a plane, which has no bounds to prune by,
    never (the plan's "c" entry of planes is unculled)."""
    if ptype is P.Triangle:
        return True
    if ptype not in (P.Sphere, P.Box) or n <= UNROLL_SLOTS_MAX:
        return False
    scalars = sum(3 if kind == P.VEC3 else 1 for _, kind in ptype.fields)
    return not (n <= SMEM_ROLLED_SLOTS_MAX
                and n * scalars <= SMEM_ROLLED_SCALARS_MAX)


def _dead_row(ptype, dev):
    """f32[4·TRI_ROWS]: the rows of a dead or padded chunk slot, 1e9 or
    more from anywhere: a triangle at x = 3e9, a sphere of radius -1e9, a
    box of half-side -1e9.  A device constant (core/constants.py)."""
    def build():
        row = np.zeros(4 * TRI_ROWS, np.float32)
        if ptype is P.Triangle:
            row[0] = DEAD_TRIANGLE_X
        elif ptype is P.Sphere:
            row[3] = -BIG
        else:
            row[4:7] = -BIG
        return row
    return cached(("dead_row", ptype.name), dev, build)


def _chunk_slots(ptype, params, n, live):
    """(f32[n, 4·TRI_ROWS] rows, lo f32[n, 3], hi f32[n, 3]) of a chunked
    type's first n slots: a slot's TRI_ROWS float4 rows and its box, a
    dead slot's rows inert and its box empty (lo BIG, hi -BIG)."""
    prm = {k: v[:n].to(torch.float32) for k, v in params.items()
           if k != "material_id"}
    if ptype is P.Triangle:
        der = P.Triangle.derive(dict(prm,
                                     material_id=params["material_id"][:n]))
        cols = []
        for name, kind in P.Triangle.derived_fields:
            if name == "material_id":
                continue
            v = der[name]
            cols += list(v.unbind(-1)) if kind == P.VEC3 else [v]
        rows = torch.stack(cols, dim=1)
    elif ptype is P.Sphere:
        # (center, radius) in row 0
        rows = torch.cat([prm["center"], prm["radius"][:, None]], dim=1)
    else:
        # the center in row 0, the half-side in row 1
        rows = torch.cat([F.pad(prm["center"], (0, 1)),
                          F.pad(prm["side"], (0, 1))], dim=1)
    rows = F.pad(rows, (0, 4 * TRI_ROWS - rows.shape[1]))
    alive = live[:, None] > 0.5
    lo, hi = ptype.bounds(prm)
    return (torch.where(alive, rows, _dead_row(ptype, live.device)),
            torch.where(alive, lo, BIG), torch.where(alive, hi, -BIG))


def _z_order(points, live, bits=10):
    """The permutation that sorts the live points f32[N, 3] by their
    Z-order key (scene/mesh.py:morton_order's), the dead ones after them:
    neighbours share a chunk, whose box stays tight.  The host never waits
    on the device here (a captured frame packs its scene): the live box
    is a masked reduction, and with no live point every key is the dead
    one, so the stable sort keeps the order."""
    alive = live > 0.5
    lo = torch.where(alive[:, None], points, float("inf")).amin(dim=0)
    hi = torch.where(alive[:, None], points, float("-inf")).amax(dim=0)
    extent = torch.clamp_min(hi - lo, 1e-9)
    q = ((points - lo) / extent * ((1 << bits) - 1))
    # no live point: q is not finite, and its keys are all replaced below
    q = torch.nan_to_num(q).to(torch.int64)
    key = torch.zeros(points.shape[0], dtype=torch.int64,
                      device=points.device)
    for b in range(bits):
        for a in range(3):
            key |= ((q[:, a] >> b) & 1) << (3 * b + a)
    key = torch.where(alive, key, 1 << (3 * bits))
    return torch.argsort(key, stable=True)


def _pack_chunks(parts):
    """(chunks, chunk_runs, chunk_live, chunk info, aabbs, {code: chunk
    slot of each of the type's slots}) of the chunked types' parts {code:
    (ptype, params, n, live, gidx, mid)}, in chunk order.  Spheres and
    boxes go in Z-order of their centers, so that a chunk's box holds
    neighbours; triangles keep their order (a mesh's loader,
    scene/mesh.py:add_mesh_to_renderer, gives them Z-order)."""
    dev = next(iter(parts.values()))[3].device
    codes = sorted(parts)
    rows, lo, hi, live, info, runs, col_slot = [], [], [], [], [], [], {}
    first = 0
    for code in codes:
        ptype, params, n, alive, gidx, mid = parts[code]
        r, l, h = _chunk_slots(ptype, params, n, alive)
        order = torch.arange(n, device=dev) if ptype is P.Triangle \
            else _z_order(params["center"][:n].to(torch.float32), alive)
        r, l, h, alive, gidx, mid = (x[order] for x in (r, l, h, alive,
                                                        gidx, mid))
        col_slot[code] = torch.empty_like(order)
        col_slot[code][order] = first * CHUNK + torch.arange(n, device=dev)
        n_ch = -(-n // CHUNK)
        if code != codes[-1]:
            n_ch = -(-n_ch // SUPER) * SUPER
        pad = n_ch * CHUNK - n
        # padded slots: the inert rows of a dead slot, an empty box
        rows += [r, _dead_row(ptype, dev).expand(pad, -1)]
        lo += [l, torch.full((pad, 3), BIG, device=dev)]
        hi += [h, torch.full((pad, 3), -BIG, device=dev)]
        live += [alive, torch.zeros(pad, device=dev)]
        info += [torch.stack([gidx, mid], dim=1),
                 torch.zeros((pad, 2), dtype=torch.int32, device=dev)]
        runs.append((code, first, n_ch))
        first += n_ch
    n_chunks = first
    table = torch.cat(rows).reshape(n_chunks, CHUNK, TRI_ROWS, 4) \
        .permute(0, 2, 1, 3).contiguous()
    lo, hi = torch.cat(lo), torch.cat(hi)
    chunk_live = torch.cat(live)
    # the coordinate scale of the pruning slack: 1 + the largest
    # coordinate of a live slot's box (of a triangle, a vertex)
    scale = 1.0 + torch.where(chunk_live[:, None] > 0.5,
                              torch.maximum(lo.abs(), hi.abs()), 0.0).amax()
    lo = lo.reshape(n_chunks, CHUNK, 3).amin(dim=1)
    hi = hi.reshape(n_chunks, CHUNK, 3).amax(dim=1)
    n_supers = -(-n_chunks // SUPER)
    padc = torch.full((n_supers * SUPER - n_chunks, 3), BIG, device=dev)
    lo_s = torch.cat([lo, padc]).reshape(n_supers, SUPER, 3).amin(dim=1)
    hi_s = torch.cat([hi, -padc]).reshape(n_supers, SUPER, 3).amax(dim=1)
    aabbs = torch.zeros((1 + n_supers + n_chunks, 8), device=dev)
    aabbs[0, 0] = scale
    aabbs[1:, 0:3] = torch.cat([lo_s, lo])
    aabbs[1:, 4:7] = torch.cat([hi_s, hi])
    return table, tuple(runs), chunk_live, torch.cat(info), aabbs, col_slot


def kernel_scene(spec) -> bool:
    """Whether the kernels take the scene (the JAX package's ``build_plan(
    spec) is not None``): at least one primitive is live, and every live
    type is a sphere, plane, box or triangle, each in one run.  Decided by
    the spec's types alone, before anything runs; a scene it rejects renders
    on the generic route (render/context.py)."""
    live = [ptype for ptype, _, n, _ in spec.prim_bounds() if n]
    return (bool(live) and len(set(live)) == len(live)
            and all(pt in KERNEL_TYPES or pt is P.Triangle for pt in live))


def pack_scene(spec, data) -> PackedScene:
    """Pack every slot the scene loops evaluate, for a scene kernel_scene
    takes.  Raises NotImplementedError on any other (a custom type, a type
    in two runs, no live primitive)."""
    dev = data.materials["albedo"].device
    runs = {}      # type code -> (row blocks, info rows) of the type's run
    parts = {}     # type code -> what _pack_chunks packs of a chunked type
    entries = []
    col_gidx, col_mid = [], []
    goff = 0
    boxes = []     # each live type's global box, None where it has none
    for ptype, cap, n, static in spec.prim_bounds():
        if n == 0:
            goff += cap
            continue
        if ptype not in KERNEL_TYPES and ptype is not P.Triangle:
            raise NotImplementedError(
                f"the kernels take spheres, planes, boxes and triangles; "
                f"not {ptype.name!r}")
        code = TRIANGLE_CODE if ptype is P.Triangle \
            else KERNEL_TYPES[ptype][0]
        if code in runs or code in parts:
            raise NotImplementedError(f"one {ptype.name} type per scene")
        params = data.prims[ptype.name]
        slot = torch.arange(n, device=dev)
        live = torch.ones(n, dtype=torch.float32, device=dev) if static \
            else (slot < data.prim_counts[ptype.name]).to(torch.float32)
        gidx = (goff + slot).to(torch.int32)
        mid = params["material_id"][:n].to(torch.int32)
        col_gidx.append(gidx)
        col_mid.append(mid)
        entries.append((ptype, code, n, static))
        goff += cap
        boxes.append(_global_box(ptype, params, n, live))
        if chunked_layout(ptype, n):
            parts[code] = (ptype, params, n, live, gidx, mid)
            continue
        _, names, dead = KERNEL_TYPES[ptype]
        blocks = []
        for name in names:
            v = params[name][:n].to(torch.float32)
            v = v if v.ndim == 2 else v[:, None]
            if not static:
                v = torch.where(live[:, None] > 0.5, v, dead[name])
            blocks.append(v)
        # a box's two rows, padded to float4: every center, then every side
        block = torch.cat([F.pad(v, (0, 1)) for v in blocks]) \
            if ptype is P.Box else torch.cat(blocks, dim=1)
        runs[code] = (block, torch.stack([gidx, mid], dim=1))
    if not entries:
        raise NotImplementedError("the kernels need a live primitive")
    codes = sorted(runs)
    first, row = {}, 0
    for code in codes:
        first[code] = row
        row += runs[code][0].shape[0]
    rows = torch.cat([runs[c][0] for c in codes]).contiguous() if codes \
        else torch.zeros((0, 4), device=dev)
    counts = tuple(runs[c][1].shape[0] if c in runs else 0
                   for c in range(TRIANGLE_CODE))
    col_slot = {}
    if parts:
        chunks, chunk_runs, chunk_live, chunk_info, aabbs, col_slot = \
            _pack_chunks(parts)
        first.update({c: f for c, f, _ in chunk_runs})
    else:
        chunks = torch.zeros((0, TRI_ROWS, CHUNK, 4), device=dev)
        chunk_runs, chunk_live = (), torch.zeros(0, device=dev)
        chunk_info = torch.zeros((0, 2), dtype=torch.int32, device=dev)
        aabbs = torch.zeros((0, 8), device=dev)
    info = torch.cat([runs[c][1] for c in codes] + [chunk_info]).contiguous()
    bounded = all(b is not None for b in boxes)
    cap_boxes = torch.stack(boxes) if bounded \
        else torch.zeros((0, 6), device=dev)
    cap_boxes[:, :3] -= FAR_MARGIN
    cap_boxes[:, 3:] += FAR_MARGIN
    return PackedScene(
        entries=tuple((ptype, first[code], n, static)
                      for ptype, code, n, static in entries),
        rows=rows, counts=counts, info=info, chunks=chunks,
        chunk_runs=chunk_runs, chunk_live=chunk_live,
        col_slot=torch.cat([col_slot.get(code, torch.full(
            (n,), -1, dtype=torch.int64, device=dev))
            for _, code, n, _ in entries]), aabbs=aabbs,
        n_chunks=chunks.shape[0], col_gidx=torch.cat(col_gidx),
        col_mid=torch.cat(col_mid), cap_boxes=cap_boxes.contiguous(),
        cap_margin=FAR_MARGIN if bounded else None)


def _global_box(ptype, params, n, live):
    """f32[6]: the box (lo xyz, hi xyz) of the live slots of a type of n
    slots, or None where the type has none (a primitive without bounds,
    or at most UNROLL_SLOTS_MAX slots).  No live slot gives lo 1e9 and hi
    -1e9, as the JAX package packs it."""
    if ptype.bounds is None or n <= UNROLL_SLOTS_MAX:
        return None
    lo, hi = ptype.bounds({k: v[:n].to(torch.float32)
                           for k, v in params.items() if k != "material_id"})
    alive = live[:, None] > 0.5
    lo = torch.where(alive, lo, BIG).amin(dim=0)
    hi = torch.where(alive, hi, -BIG).amax(dim=0)
    return torch.cat([lo, hi])


def without_box_cap(packed):
    """The packed scene with its box-exit cap dropped: its marches go to
    max_dist as on a scene that is not all bounded."""
    return dataclasses.replace(packed, cap_boxes=packed.cap_boxes[:0],
                               cap_margin=None)


def ray_box_cap(packed, origins, dirs):
    """f32[N]: each ray's box-exit cap (csrc/scene.cuh:box_cap, the TPU
    kernels' _ray_box_cap), or None on a scene without cap boxes.  Per
    grown box the slab test's exit t where the ray enters the box before
    it leaves, else 0, clamped at 0; the largest over the boxes.  Past it
    the ray stays more than FAR_MARGIN from every box, so on an
    all-bounded scene a march can neither hit nor be blocked there."""
    nb = packed.cap_boxes.shape[0]
    if nb == 0:
        return None
    cap_tests["boxes"] += origins.shape[0] * nb
    ds = torch.where(torch.abs(dirs) < 1e-12, 1e-12, dirs)
    inv = 1.0 / ds
    lo = packed.cap_boxes[:, None, :3]
    hi = packed.cap_boxes[:, None, 3:]
    t1 = (lo - origins[None]) * inv[None]                # [B, N, 3]
    t2 = (hi - origins[None]) * inv[None]
    tn = torch.minimum(t1, t2)
    tx = torch.maximum(t1, t2)
    t_en = torch.maximum(torch.maximum(tn[..., 0], tn[..., 1]), tn[..., 2])
    t_ex = torch.minimum(torch.minimum(tx[..., 0], tx[..., 1]), tx[..., 2])
    return torch.where(t_en <= t_ex, torch.clamp_min(t_ex, 0.0),
                       0.0).amax(dim=0)


def slot_live(packed):
    """bool[n_slots] in run order: False on the slots packed dead."""
    n_spheres, n_planes, n_boxes = packed.counts
    r = packed.rows
    return torch.cat([r[:n_spheres, 3] != -BIG,
                      r[n_spheres:n_spheres + n_planes, 3] != BIG,
                      r[n_spheres + n_planes + n_boxes:, 0] != -BIG])


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

def _planar_scalars(rows, fields):
    """{scalar name: column} of a table's rows: vec3 fields split into
    name_x/name_y/name_z, in table order."""
    s = {}
    col = 0
    for name, kind in fields:
        for sname in ([f"{name}_{ax}" for ax in "xyz"] if kind == P.VEC3
                      else [name]):
            s[sname] = rows[:, col]
            col += 1
    return s


def _slot_dists(packed, p):
    """f32[N, C]: every packed slot's planar SDF at points p[N, 3] (a
    triangle's through sdf_planar_derived on its table row), dead slots at
    1e9 or more; columns in spec order."""
    px, py, pz = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    slots = packed.chunks.permute(0, 2, 1, 3).reshape(-1, 4 * TRI_ROWS)
    cols = []
    col = 0
    for ptype, first, n, _ in packed.entries:
        chunked = packed.chunked(ptype)
        rows = slots[packed.col_slot[col:col + n]] if chunked \
            else packed.rows[first:first + n]
        if ptype is P.Triangle:
            fields = [f for f in ptype.derived_fields
                      if f[0] != "material_id"]
            d = ptype.sdf_planar_derived(_planar_scalars(rows, fields),
                                         px, py, pz)
            code = TRIANGLE_CODE
        else:
            code, names, _ = KERNEL_TYPES[ptype]
            kinds = dict(ptype.fields)
            if ptype is P.Box:
                # the center and the half-side: rows 0 and 1 of a chunk
                # slot, the run's two blocks of a typed one
                rows = torch.cat([rows[:, :3], rows[:, 4:7]], dim=1) \
                    if chunked else torch.cat([
                        rows[:, :3],
                        packed.rows[first + n:first + 2 * n, :3]], dim=1)
            d = ptype.sdf_planar(_planar_scalars(
                rows, [(k, kinds[k]) for k in names]), px, py, pz)
        cols.append(d)
        scene_evals[code] += p.shape[0] * n
        if chunked:
            chunk_evals[code] += p.shape[0] * n
        col += n
    return torch.cat(cols, dim=1)


def _admitted(packed, p, best):
    """(bool[N, n_supers], bool[N, n_chunks]): the super-chunks and the
    chunks whose box lies within the pruning slack of best[N] at points
    p[N, 3] (csrc/scene.cuh:chunk_min's test); a chunk only inside an
    admitted super-chunk."""
    px, py, pz = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    slack = PRUNE_REL * (packed.aabbs[0, 0] + torch.abs(p[:, 0])
                         + torch.abs(p[:, 1]) + torch.abs(p[:, 2]))
    lim = best + slack

    def within(b):
        def gap(q, lo, hi):
            return torch.clamp_min(torch.maximum(lo - q, q - hi), 0.0)

        dx = gap(px, b[:, 0], b[:, 4])
        dy = gap(py, b[:, 1], b[:, 5])
        dz = gap(pz, b[:, 2], b[:, 6])
        return dx * dx + dy * dy + dz * dz <= (lim * lim)[:, None]

    boxes = packed.aabbs[1:]
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
    live = packed.chunk_live.reshape(packed.n_chunks, CHUNK).sum(1).to(
        torch.float64)
    pruned_evals["aabb"] += p.shape[0] * packed.n_supers + int(
        (sup.to(torch.float64) @ per_super).sum().item())
    for code, first, n in packed.chunk_runs:
        pruned_evals[CHUNK_KEYS[code]] += int(
            (chunk[:, first:first + n].to(torch.float64)
             @ live[first:first + n]).sum().item())


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
    d = torch.clamp_max(torch.amin(_slot_dists(packed, p), dim=1),
                        max_dist)
    _count_pruned(packed, p, d)
    return d


def _scene_dist_info(packed, p, max_dist):
    dmin, arg = torch.min(_slot_dists(packed, p), dim=1)
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
    """Scene distance at p[N, 3] with only the admitted chunks evaluated
    (those pruned_evals counts): the vectorised emulation of the kernels'
    exact pruning, equal to scene_dist wherever it is exact."""
    d = _slot_dists(packed, p)
    dmin = torch.clamp_max(torch.amin(d, dim=1), max_dist)
    if packed.n_chunks:
        chunk = packed.col_slot // CHUNK
        admitted = _admitted(packed, p, dmin)[1][:, chunk.clamp_min(0)] \
            | (chunk < 0)
        d = torch.where(admitted, d, torch.inf)
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


def _vis8(sdf_b, packed, p, so, hit, spacing, dims, surface_offset,
          max_steps, eps, omega, pick_normal=None):
    """f32[8, N] probe visibility to the clamped probe-cell corners, each
    march ended at its box-exit cap where the packed scene has one, and
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
    o8, d8 = so.repeat(8, 1), vdir.reshape(-1, 3)
    vis = rm.raycast_visibility(
        sdf_b, o8, d8, (pdist - surface_offset).reshape(-1),
        enabled=hit.repeat(8), max_steps=max_steps, eps=eps, omega=omega,
        caps=ray_box_cap(packed, o8, d8)).reshape(8, n)
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
                       refl_shadows=True, enabled=None, want_shadows=True,
                       want_vis=True):
    """Plain PyTorch version of the geometry kernel: the same marches,
    offsets, masks, FD normal and in-order pick, in batched tensor ops,
    ended at the box-exit caps where the scene packs them;
    ``want_shadows`` / ``want_vis`` False skip the primary hit's penumbra /
    probe-visibility marches, as the kernel does, and give ones."""
    n = origins.shape[0]
    dev = origins.device
    if enabled is None:
        enabled = torch.ones(n, dtype=torch.bool, device=dev)

    def sdf_b(p):
        return scene_dist(packed, p, max_dist)

    march = dict(eps=eps, max_steps=max_steps)

    def bounce(o, d, en_b):
        t = rm.raycast_distance(sdf_b, o, d, max_dist, enabled=en_b,
                                omega=omega, caps=ray_box_cap(packed, o, d),
                                **march)
        p = o + t[:, None] * d
        d_end, idx, mid = scene_dist_info(packed, p, max_dist)
        hit = en_b & (d_end < eps) & (t < max_dist)
        # at a miss the normal is the reversed ray and the AO 1: like the
        # kernel, no evaluation is spent there
        rows = hit.nonzero().squeeze(1)
        normal = -d
        if rows.numel():
            normal[rows] = _fd_normal(sdf_b, p[rows], NORMAL_H)
        so = p + normal * surface_offset
        return t, p, hit, rows, idx, mid, normal, so

    t, p, hit, rows, idx, mid, normal, so = bounce(origins, dirs, enabled)
    ao = torch.ones(n, dtype=torch.float32, device=dev)
    if rows.numel():
        ao[rows] = rm.ambient_occlusion(
            sdf_b, p[rows], normal[rows], steps=ao_steps,
            step_size=ao_step_size)
    shadows = _shadows(sdf_b, lpos, n_lights, p, so, normal, hit, shadow_k,
                       **march) if want_shadows \
        else torch.ones((n_lights, n), dtype=torch.float32, device=dev)
    vis8 = _vis8(sdf_b, packed, p, so, hit, probe_spacing, probe_dims,
                 surface_offset, omega=omega, **march)[0] if want_vis \
        else torch.ones((8, n), dtype=torch.float32, device=dev)
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
    r_t, rp, r_hit, _, _, r_mid, r_normal, r_so = bounce(so, r_d, r_en)
    r_sh = _shadows(sdf_b, lpos, n_lights, rp, r_so, r_normal, r_hit,
                    shadow_k, **march) if refl_shadows \
        else torch.ones((n_lights, n), dtype=torch.float32, device=dev)
    r_vis, best_pid, best_dir = _vis8(
        sdf_b, packed, rp, r_so, r_hit, probe_spacing, probe_dims,
        surface_offset, omega=omega, pick_normal=r_normal, **march)
    out["refl"] = {"t": r_t, "hit": r_hit, "mid": r_mid, "normal": r_normal,
                   "shadows": r_sh, "vis8": r_vis, "best_pid": best_pid,
                   "best_dir": best_dir}
    return out


def raycast_reference(packed, origins, dirs, max_dist, *, eps=EPSILON,
                      max_steps=300, enabled=None, omega=1.6,
                      return_steps=False):
    """Plain PyTorch version of the raycast kernel: render/raymarch.py's
    raycast over the packed scene, whose distances cap at max_dist, ended
    at the rays' box-exit caps where the scene packs them; with
    ``return_steps`` each ray's march steps i32[N] too."""
    return rm.raycast(lambda p: scene_dist(packed, p, max_dist), origins,
                      dirs, max_dist, eps=eps, max_steps=max_steps,
                      enabled=enabled, omega=omega,
                      return_steps=return_steps,
                      caps=ray_box_cap(packed, origins, dirs))


def visibility_reference(packed, origins, dirs, max_dists, *, eps=EPSILON,
                         max_steps=300, enabled=None, omega=1.6,
                         return_steps=False):
    """Plain PyTorch version of the visibility kernel: render/raymarch.py's
    raycast_visibility over the packed scene, whose distances cap at
    VIS_CAP, ended at the rays' box-exit caps where the scene packs them;
    with ``return_steps`` each ray's march steps i32[N] too."""
    return rm.raycast_visibility(
        lambda p: scene_dist(packed, p, VIS_CAP), origins, dirs, max_dists,
        eps=eps, max_steps=max_steps, enabled=enabled, omega=omega,
        return_steps=return_steps, caps=ray_box_cap(packed, origins, dirs))


def softshadows_reference(packed, origins, dirs, min_dists, max_dists, k, *,
                          eps=EPSILON, max_steps=300, enabled=None,
                          return_steps=False):
    """Plain PyTorch version of the softshadow kernel: render/raymarch.py's
    softshadows over the packed scene, whose distances cap at VIS_CAP,
    marched to max_dists on every scene (no box-exit cap:
    csrc/scene.cuh:march_shadow says why); with ``return_steps`` each
    ray's march steps i32[N] too."""
    return rm.softshadows(
        lambda p: scene_dist(packed, p, VIS_CAP), origins, dirs, min_dists,
        max_dists, k, eps=eps, max_steps=max_steps, enabled=enabled,
        return_steps=return_steps)


# ---------------------------------------------------------------------------
# The CUDA kernel's wrapper
# ---------------------------------------------------------------------------

class _SceneArgs(ctypes.Structure):
    """Field for field the SceneArgs struct of csrc/scene.cuh."""

    _fields_ = [
        ("rows", ctypes.c_void_p), ("n_spheres", ctypes.c_int),
        ("n_planes", ctypes.c_int), ("n_boxes", ctypes.c_int),
        ("info", ctypes.c_void_p), ("chunks", ctypes.c_void_p),
        ("aabbs", ctypes.c_void_p), ("n_chunks", ctypes.c_int),
        ("n_supers", ctypes.c_int), ("box_chunk0", ctypes.c_int),
        ("tri_chunk0", ctypes.c_int), ("cap_boxes", ctypes.c_void_p),
        ("n_cap_boxes", ctypes.c_int), ("placement", ctypes.c_int),
        ("work", ctypes.c_void_p),
    ]


class _GeomArgs(ctypes.Structure):
    """Field for field the GeomArgs struct of csrc/geometry.cu."""

    _fields_ = [
        ("scene", _SceneArgs),
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
        ("want_shadows", ctypes.c_int), ("want_vis", ctypes.c_int),
        ("t", ctypes.c_void_p), ("hit", ctypes.c_void_p),
        ("idx", ctypes.c_void_p), ("mid", ctypes.c_void_p),
        ("normal", ctypes.c_void_p), ("ao", ctypes.c_void_p),
        ("shadows", ctypes.c_void_p), ("vis8", ctypes.c_void_p),
        ("r_t", ctypes.c_void_p), ("r_hit", ctypes.c_void_p),
        ("r_mid", ctypes.c_void_p), ("r_normal", ctypes.c_void_p),
        ("r_shadows", ctypes.c_void_p), ("r_vis8", ctypes.c_void_p),
        ("best_pid", ctypes.c_void_p), ("best_dir", ctypes.c_void_p),
    ]


def geometry_library(lanes=1, count_work=False, fmad=False):
    """The geometry kernel's library built for ``lanes`` lanes per ray;
    ``count_work`` (the kernel sums its own work) and ``fmad`` (FMA
    contraction on) select measurement builds that no path of the package
    launches."""
    defines = (f"LANES={lanes}",) + (("COUNT_WORK",) if count_work else ())
    lib = build.load("geometry", defines, fmad)
    lib.madarch_geometry.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p]
    lib.madarch_geometry.restype = ctypes.c_int
    return _with_optin_query(lib)


def _with_optin_query(lib):
    lib.madarch_smem_optin.argtypes = [ctypes.c_int]
    lib.madarch_smem_optin.restype = ctypes.c_int
    return lib


def _stop_gradient(*xs):
    """Each tensor of xs detached from autograd (None and Python numbers as
    they are): what a kernel launch and its plain version read."""
    return tuple(x.detach() if isinstance(x, torch.Tensor) else x
                 for x in xs)


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
    _check("packed.rows", packed.rows, dev, torch.float32,
           (sum(packed.counts) + packed.counts[2], 4))
    _check("packed.info", packed.info, dev, torch.int32,
           (packed.n_slots + packed.n_chunks * CHUNK, 2))
    _check("packed.chunks", packed.chunks, dev, torch.float32,
           (packed.n_chunks, TRI_ROWS, CHUNK, 4))
    _check("packed.aabbs", packed.aabbs, dev, torch.float32,
           (1 + packed.n_supers + packed.n_chunks if packed.n_chunks else 0,
            8))
    _check("packed.cap_boxes", packed.cap_boxes, dev, torch.float32,
           (packed.cap_boxes.shape[0], 6))
    # the kernels read these tables as float4 and int2
    for name, align in (("rows", 16), ("chunks", 16), ("aabbs", 16),
                        ("info", 8)):
        if getattr(packed, name).data_ptr() % align:
            raise ValueError(f"packed.{name} must be {align}-byte aligned")


def placement_for(kernel, n_bytes, optin_limit):
    """Where a launch of ``kernel`` (geometry, raycast, visibility or
    softshadows) whose staged tables take n_bytes keeps them: "staged" in
    shared memory up to SMEM_LIMIT, for OPTIN_KERNELS "optin" (staged
    after raising the kernel's limit) up to optin_limit, the device's
    opt-in maximum, else "global" (read in place from device memory)."""
    if n_bytes <= SMEM_LIMIT:
        return "staged"
    if kernel in OPTIN_KERNELS and n_bytes <= optin_limit:
        return "optin"
    return "global"


def smem_bytes(packed, extra_floats=0):
    """Bytes a launch stages: the typed runs, the boxes and extra_floats
    (the geometry kernel's light positions and roughness)."""
    return 4 * (packed.rows.numel() + packed.aabbs.numel() + extra_floats)


_optin_limits = {}


def optin_limit(lib, dev):
    """The device's cudaDevAttrMaxSharedMemoryPerBlockOptin in bytes, asked
    of a kernel library once per device."""
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    if index not in _optin_limits:
        limit = lib.madarch_smem_optin(index)
        if limit < 0:
            raise RuntimeError(f"cannot read the shared-memory opt-in "
                               f"limit of cuda:{index}")
        _optin_limits[index] = limit
    return _optin_limits[index]


def _check_placement(placement):
    if placement is not None and placement not in PLACEMENTS:
        raise ValueError(f"placement must be None or one of {PLACEMENTS}, "
                         f"not {placement!r}")


def _scene_args(packed, extra_smem_floats, kernel, lib, dev,
                placement=None, work=None):
    """The scene's _SceneArgs for a launch of ``kernel`` at ``placement``
    (None: placement_for's choice); raises ValueError where a forced
    placement cannot hold the staged tables."""
    n_bytes = smem_bytes(packed, extra_smem_floats)
    limit = optin_limit(lib, dev)
    if placement is None:
        placement = placement_for(kernel, n_bytes, limit)
    elif n_bytes > {"staged": SMEM_LIMIT, "optin": limit}.get(
            placement, n_bytes):
        raise ValueError(f"the scene stages {n_bytes} bytes: more than "
                         f"placement {placement!r} holds")
    n_spheres, n_planes, n_boxes = packed.counts
    return _SceneArgs(
        rows=_ptr(packed.rows), n_spheres=n_spheres, n_planes=n_planes,
        n_boxes=n_boxes, info=_ptr(packed.info), chunks=_ptr(packed.chunks),
        aabbs=_ptr(packed.aabbs), n_chunks=packed.n_chunks,
        n_supers=packed.n_supers, box_chunk0=packed.chunk_end(0),
        tri_chunk0=packed.chunk_end(2),
        cap_boxes=_ptr(packed.cap_boxes),
        n_cap_boxes=packed.cap_boxes.shape[0],
        placement=PLACEMENTS.index(placement), work=_ptr(work))


# geometry() gives a ray 8 lanes on a launch of fewer rays than this (a
# thread per ray leaves the card's 132 SMs short of warps) and on a scene
# of at least this many slots (two a lane).  Both are cut-offs placed
# between the two points measured on the card (36,864 and 640,000 rays; 8
# and 40 slots: PERF.md), not fitted crossovers: nothing between them has
# been timed.
LANES_RAY_LIMIT = 100_000
LANES_MIN_SLOTS = 16


def geometry_lanes(packed, n_rays):
    """The lanes per ray geometry() launches with: 8 on a scene with
    chunked types, whose chunks and boxes are 8 wide, on a scene of many
    slots and on a small launch; else 1."""
    if packed.n_chunks or packed.n_slots >= LANES_MIN_SLOTS:
        return 8
    return 8 if n_rays < LANES_RAY_LIMIT else 1


def geometry(packed, lpos, n_lights, origins, dirs, max_dist, *,
             probe_spacing, probe_dims, surface_offset, ao_steps,
             ao_step_size=0.1, shadow_k=64.0, eps=EPSILON, max_steps=300,
             omega=1.6, mat_rough_vec=None, refl_shadows=True,
             enabled=None, want_shadows=True, want_vis=True, box_cap=True,
             placement=None, library=None, work=None):
    """Fused geometry pass over rays origins/dirs f32[N, 3]: a dict with t,
    hit (bool), idx (i32 global index, -1 where not hit), mid (i32),
    normal f32[N,3], ao f32[N], shadows f32[L,N], vis8 f32[8,N], and
    "refl" = {t, hit, mid, normal, shadows, vis8, best_pid, best_dir} when
    ``mat_rough_vec`` (f32[n_mats] roughness) is given, else None.

    Outputs other than t/hit are meaningful only where hit holds (shadows
    and vis8 also only where their march was enabled); with
    ``refl_shadows`` False the reflection's shadows are all ones;
    ``ao_steps`` 0 gives ao 1; ``want_shadows`` / ``want_vis`` False skip
    the primary hit's penumbra / probe-visibility marches and give ones
    (the reflection's marches stay: its visibility feeds the best-probe
    pick).  ``enabled``: optional bool[N]; a disabled
    ray does not march (t 0), is no hit and enables no other march.  At a
    miss the normal is the reversed ray direction and the ao 1.  On an
    all-bounded scene (``packed.cap_boxes``) the primary, reflection and
    probe-visibility marches end at the ray's box-exit cap, and a miss so
    capped has t = max_dist (the JAX kernel's miss convention); elsewhere a
    miss's t is max_dist or more.  ``box_cap`` False drops the cap, for a
    measurement.

    On the card the launch uses ``geometry_lanes`` lanes per ray and
    ``placement_for``'s placement; ``placement`` (one of PLACEMENTS)
    forces one, ``library`` (a ``geometry_library`` build) overrides the
    lanes and ``work`` (i64[3] on the device) receives a COUNT_WORK
    build's counts: all three are for measurements.

    Every output is a constant to autograd: the wrapper detaches its
    inputs, on either device (a ctypes launch would ignore autograd
    silently; the plain version would record a graph through every march
    step).  The same holds for raycast, visibility and softshadows."""
    origins, dirs, enabled, lpos, mat_rough_vec = _stop_gradient(
        origins, dirs, enabled, lpos, mat_rough_vec)
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
    _check_placement(placement)
    kwargs = dict(probe_spacing=probe_spacing, probe_dims=probe_dims,
                  surface_offset=surface_offset, ao_steps=ao_steps,
                  ao_step_size=ao_step_size, shadow_k=shadow_k, eps=eps,
                  max_steps=max_steps, omega=omega,
                  mat_rough_vec=mat_rough_vec, refl_shadows=refl_shadows,
                  enabled=enabled, want_shadows=want_shadows,
                  want_vis=want_vis)
    if not box_cap:
        packed = without_box_cap(packed)
    if dev.type == "cpu":
        return geometry_reference(packed, lpos, n_lights, origins, dirs,
                                  max_dist, **kwargs)
    if dev.type != "cuda":
        raise ValueError(f"geometry runs on cpu or cuda, not {dev}")
    if work is not None:
        _check("work", work, dev, torch.int64, (3,))
    if library is None:
        library = geometry_library(geometry_lanes(packed, n))
    return _launch(library, work, placement, packed, lpos, n_lights,
                   origins, dirs, max_dist, **kwargs)


def _launch(lib, work, placement, packed, lpos, n_lights, origins, dirs,
            max_dist, *, probe_spacing, probe_dims, surface_offset,
            ao_steps, ao_step_size, shadow_k, eps, max_steps, omega,
            mat_rough_vec, refl_shadows, enabled, want_shadows, want_vis):
    dev = origins.device
    n = origins.shape[0]
    refl = mat_rough_vec is not None
    scene = _scene_args(packed, lpos.numel() + (
        mat_rough_vec.numel() if refl else 0), "geometry", lib, dev,
        placement, work)

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
        scene=scene, lpos=_ptr(lpos), n_lights=n_lights,
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
        refl_shadows=int(refl_shadows), want_shadows=int(want_shadows),
        want_vis=int(want_vis),
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
        ("scene", _SceneArgs),
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


def march_defines(counts=None):
    """The macros of march_library's build for layout ``counts``."""
    if counts is None:
        return ()
    return tuple(f"FIXED_{name}={c}" for name, c in zip(
        ("SPHERES", "PLANES", "BOXES"), counts))


def march_library(counts=None):
    """The library of the raycast, visibility and softshadow kernels:
    generic, or with ``counts`` (spheres, planes, boxes: a march_layout)
    the build for that scene layout, whose slot loops unroll whole
    (csrc/scene.cuh)."""
    lib = build.load("march", march_defines(counts))
    for fn in (lib.madarch_raycast, lib.madarch_visibility,
               lib.madarch_softshadows):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return _with_optin_query(lib)


# A scene without triangles whose typed runs fill at most this many float4
# rows (a sphere and a plane one, a box two) gets a march.cu build of its
# own layout.  Such a build keeps the rows in registers: at 20 rows (4,8,4)
# it beat the generic build on every launch of the path, at 32 (8,8,8;
# 159 registers a thread) it lost on the 5,120,000 penumbra rays (PERF.md
# §6).  The cut-off sits at the last layout that won everywhere, not at a
# fitted crossover: nothing between 20 and 32 rows has been timed.
UNROLL_ROWS_MAX = 20


def march_layout(packed):
    """The (spheres, planes, boxes) layout the march kernels are built for
    on this scene, or None for the generic build (chunked types, or typed
    runs of more than UNROLL_ROWS_MAX rows)."""
    if packed.n_chunks or packed.rows.shape[0] > UNROLL_ROWS_MAX:
        return None
    return tuple(packed.counts)


def _check_rays(packed, origins, dirs, enabled, placement=None):
    """Checks the arguments the raycast, visibility and softshadow wrappers
    share and returns the enable mask as a bool[N] tensor."""
    dev = origins.device
    n = origins.shape[0]
    _check("origins", origins, dev, torch.float32, (n, 3))
    _check("dirs", dirs, dev, torch.float32, (n, 3))
    _check_scene(packed, dev)
    _check_placement(placement)
    if enabled is None:
        return torch.ones(n, dtype=torch.bool, device=dev)
    _check("enabled", enabled, dev, torch.bool, (n,))
    return enabled


def _launch_march(lib, kernel, placement, packed, origins, dirs, enabled,
                  **fields):
    """Launches csrc/march.cu's ``kernel`` (raycast, visibility or
    softshadows) of ``lib`` on the current stream."""
    dev = origins.device
    fn = getattr(lib, "madarch_" + kernel)
    scene = _scene_args(packed, 0, kernel, lib, dev, placement)
    omega = fields.pop("omega")
    args = _MarchArgs(scene=scene, origins=_ptr(origins), dirs=_ptr(dirs),
                      enabled=_ptr(enabled), n=origins.shape[0],
                      omega=omega, one_minus_omega=1.0 - omega, **fields)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.addressof(args), stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")


def raycast(packed, origins, dirs, max_dist, *, eps=EPSILON, max_steps=300,
            enabled=None, omega=1.6, box_cap=True, placement=None):
    """Over-relaxed primary march of rays origins/dirs f32[N, 3] to
    max_dist (also the scene-distance cap): (t f32[N], 0 where disabled;
    hit bool[N]; pos = o + t·d).  On a miss t is max_dist where the march
    ended at the ray's box-exit cap (an all-bounded scene), as the JAX
    kernel's is, else max_dist or more; ``box_cap`` False drops the cap,
    for a measurement, as ``placement`` forces where the launch keeps the
    scene's tables (geometry says how).  ``enabled``: optional bool[N];
    disabled rays never march."""
    origins, dirs, enabled = _stop_gradient(origins, dirs, enabled)
    if not box_cap:
        packed = without_box_cap(packed)
    dev = origins.device
    en = _check_rays(packed, origins, dirs, enabled, placement)
    kwargs = dict(eps=eps, max_steps=max_steps, omega=omega)
    if dev.type == "cpu":
        return raycast_reference(packed, origins, dirs, max_dist,
                                 enabled=enabled, **kwargs)
    if dev.type != "cuda":
        raise ValueError(f"raycast runs on cpu or cuda, not {dev}")
    t, hit = _raycast(march_library(march_layout(packed)), packed, origins,
                      dirs, max_dist, en, placement=placement, **kwargs)
    raycast.launches += 1
    return t, hit, origins + t[:, None] * dirs


def _raycast(lib, packed, origins, dirs, max_dist, en, *, eps=EPSILON,
             max_steps=300, omega=1.6, placement=None):
    """raycast's launch on the march_library build ``lib``, en the enable
    mask bool[N]: (t, hit)."""
    n = origins.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=origins.device)
    hit = torch.empty(n, dtype=torch.bool, device=origins.device)
    _launch_march(lib, "raycast", placement, packed, origins, dirs, en,
                  max_dist=max_dist, cap=max_dist, t=_ptr(t), hit=_ptr(hit),
                  eps=eps, max_steps=max_steps, omega=omega)
    return t, hit


def visibility(packed, origins, dirs, max_dists, *, eps=EPSILON,
               max_steps=300, enabled=None, omega=1.6, box_cap=True,
               placement=None):
    """f32[N]: 1 where the ray origins/dirs f32[N, 3] reaches its own
    max_dists f32[N] unblocked, else 0; a ray starts only where
    0 < max_dist and ``enabled`` (optional bool[N]) holds.  On an
    all-bounded scene a ray ends unblocked at its box-exit cap;
    ``box_cap`` False drops the cap and ``placement`` forces one, for a
    measurement."""
    origins, dirs, max_dists, enabled = _stop_gradient(
        origins, dirs, max_dists, enabled)
    if not box_cap:
        packed = without_box_cap(packed)
    dev = origins.device
    n = origins.shape[0]
    en = _check_rays(packed, origins, dirs, enabled, placement)
    _check("max_dists", max_dists, dev, torch.float32, (n,))
    kwargs = dict(eps=eps, max_steps=max_steps, omega=omega)
    if dev.type == "cpu":
        return visibility_reference(packed, origins, dirs, max_dists,
                                    enabled=enabled, **kwargs)
    if dev.type != "cuda":
        raise ValueError(f"visibility runs on cpu or cuda, not {dev}")
    vis = _visibility(march_library(march_layout(packed)), packed, origins,
                      dirs, max_dists, en, placement=placement, **kwargs)
    visibility.launches += 1
    return vis


def _visibility(lib, packed, origins, dirs, max_dists, en, *, eps=EPSILON,
                max_steps=300, omega=1.6, placement=None):
    """visibility's launch on the march_library build ``lib``."""
    vis = torch.empty(origins.shape[0], dtype=torch.float32,
                      device=origins.device)
    _launch_march(lib, "visibility", placement, packed, origins, dirs, en,
                  max_dists=_ptr(max_dists), max_dist=VIS_CAP, cap=VIS_CAP,
                  vis=_ptr(vis), eps=eps, max_steps=max_steps, omega=omega)
    return vis


def softshadows(packed, origins, dirs, min_dists, max_dists, k, *,
                eps=EPSILON, max_steps=300, enabled=None, placement=None):
    """f32[N]: the improved-penumbra factor of the ray origins/dirs
    f32[N, 3] marched (omega 1) from its min_dists to its max_dists
    f32[N], k the penumbra sharpness; 0 where the ray hits geometry, 1
    where it never starts (``enabled``, optional bool[N], false, or
    min_dist >= max_dist).  ``placement`` forces one, for a
    measurement."""
    origins, dirs, min_dists, max_dists, enabled = _stop_gradient(
        origins, dirs, min_dists, max_dists, enabled)
    dev = origins.device
    n = origins.shape[0]
    en = _check_rays(packed, origins, dirs, enabled, placement)
    _check("min_dists", min_dists, dev, torch.float32, (n,))
    _check("max_dists", max_dists, dev, torch.float32, (n,))
    kwargs = dict(eps=eps, max_steps=max_steps)
    if dev.type == "cpu":
        return softshadows_reference(packed, origins, dirs, min_dists,
                                     max_dists, k, enabled=enabled, **kwargs)
    if dev.type != "cuda":
        raise ValueError(f"softshadows runs on cpu or cuda, not {dev}")
    res = _softshadows(march_library(march_layout(packed)), packed, origins,
                       dirs, min_dists, max_dists, k, en,
                       placement=placement, **kwargs)
    softshadows.launches += 1
    return res


def _softshadows(lib, packed, origins, dirs, min_dists, max_dists, k, en, *,
                 eps=EPSILON, max_steps=300, placement=None):
    """softshadows' launch on the march_library build ``lib``."""
    res = torch.empty(origins.shape[0], dtype=torch.float32,
                      device=origins.device)
    _launch_march(lib, "softshadows", placement, packed, origins, dirs,
                  en,
                  min_dists=_ptr(min_dists), max_dists=_ptr(max_dists),
                  max_dist=VIS_CAP, cap=VIS_CAP, omega=1.0, k=k,
                  vis=_ptr(res), eps=eps, max_steps=max_steps)
    return res


# Kernel launches since the count was last reset (the CPU path does not
# count): lets a run show that its main path went through the kernels.
# A frame captured into a CUDA graph (render/pipeline.py:CompiledFrame)
# launches nothing while it is captured and takes those calls back out of
# the count; each replay of the graph launches the captured kernels again
# and adds them (add_launches).  The shade's probe lookups
# (ops/probe_lookup.py) are counted with them.
geometry.launches = 0
raycast.launches = 0
visibility.launches = 0
softshadows.launches = 0
KERNEL_WRAPPERS = (geometry, raycast, visibility, softshadows,
                   probe_lookup.irradiance_lookup,
                   probe_lookup.radiance_lookup)


def launch_counts():
    """{wrapper name: its launch count}."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def add_launches(counts):
    """Adds {wrapper name: launches} to the wrappers' counts."""
    for fn in KERNEL_WRAPPERS:
        fn.launches += counts.get(fn.__name__, 0)
