"""Scene representation: static spec + struct-of-arrays device data
(port of madarch_tpu/scene/scene.py).

``SceneSpec`` is the static half: primitive/light types with capacities,
max_dist and, once ``specialized``, the live counts baked in as loop
bounds.  ``SceneData`` is the dynamic half, a dataclass of tensors on one
device.  Global primitive indices follow the reference convention: each
type occupies a block of size == its *capacity*, in spec order.
``tree_items``, ``tree_leaves`` and ``tree_map`` walk a SceneData's tensors
in jax.tree.flatten's order.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core.constants import to_device
from ..scene.lights import LightType
from ..scene.primitives import PrimitiveType, kind_dtype, kind_shape

MAX_MATERIALS = 20


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Static scene shape: (type, capacity) pairs.  ``partitioning``:
    the uniform grid's PartitioningSettings, or None for no grid."""

    prims: Tuple[Tuple[PrimitiveType, int], ...]
    lights: Tuple[Tuple[LightType, int], ...]
    max_dist: float = 20.0
    max_materials: int = MAX_MATERIALS
    partitioning: object = None
    # Static *live* counts aligned with prims/lights; when set, scene loops
    # run over exactly the live slots with no count masking.
    live_prims: Tuple[int, ...] = None
    live_lights: Tuple[int, ...] = None

    def specialized(self, prim_counts: dict,
                    light_counts: dict) -> "SceneSpec":
        """Bake live counts (name->int dicts) in as static loop bounds."""
        return dataclasses.replace(
            self,
            live_prims=tuple(min(cap, int(prim_counts.get(pt.name, cap)))
                             for pt, cap in self.prims),
            live_lights=tuple(min(cap, int(light_counts.get(lt.name, cap)))
                              for lt, cap in self.lights))

    def prim_bounds(self):
        """Yield (ptype, capacity, static loop bound, counts_are_static)."""
        for k, (ptype, cap) in enumerate(self.prims):
            n = cap if self.live_prims is None else self.live_prims[k]
            yield ptype, cap, n, self.live_prims is not None

    def light_bounds(self):
        for k, (ltype, cap) in enumerate(self.lights):
            n = cap if self.live_lights is None else self.live_lights[k]
            yield ltype, cap, n, self.live_lights is not None

    def prim_offset(self, ptype: PrimitiveType) -> int:
        """Start of this type's global-index block (capacity-based)."""
        off = 0
        for pt, cap in self.prims:
            if pt is ptype:
                return off
            off += cap
        raise KeyError(ptype.name)

    @property
    def total_prim_capacity(self) -> int:
        return sum(cap for _, cap in self.prims)


@dataclasses.dataclass
class SceneData:
    """Device-side scene state: every leaf is a tensor on one device."""

    prims: dict         # type name -> field name -> f32[cap,...]/i32[cap]
    prim_counts: dict   # type name -> i32[]
    lights: dict        # type name -> field name -> tensors
    light_counts: dict  # type name -> i32[]
    materials: dict     # albedo f32[M,3], metallic f32[M], roughness f32[M]
    grid: object = None  # the port's partitioning grid: never built here


def tree_items(tree, path=""):
    """[(key path, tensor leaf)] of a SceneData (or any nest of
    dataclasses, dicts and tensors) in jax.tree.flatten's order: dataclass
    fields in declaration order, dict keys sorted, None holding no leaf.
    So a leaf pairs by position with the JAX package's leaf of the same
    scene.  Paths read like ``prims.sphere.radius``."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, dict):
        keys = sorted(tree)
        children = [(k, tree[k]) for k in keys]
    else:
        children = [(f.name, getattr(tree, f.name))
                    for f in dataclasses.fields(tree)]
    return [item for k, child in children
            for item in tree_items(child, f"{path}.{k}" if path else k)]


def tree_leaves(tree):
    """The tensor leaves of ``tree`` in tree_items' order."""
    return [leaf for _, leaf in tree_items(tree)]


def _rebuild(tree, leaves):
    """``tree`` with its leaves taken in order from the iterator
    ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    return dataclasses.replace(tree, **{
        f.name: _rebuild(getattr(tree, f.name), leaves)
        for f in dataclasses.fields(tree)})


def tree_map(fn, tree):
    """``tree`` with every tensor leaf x replaced by fn(x) (a scene
    detached, or moved to another device), its dicts in their own key
    order."""
    return _rebuild(tree, iter([fn(x) for x in tree_leaves(tree)]))


# ---------------------------------------------------------------------------
# Scene-level queries, batched over points p[..., 3].
# ---------------------------------------------------------------------------

def _masked_type_dists(spec, data, ptype, n, static, p):
    """Distances [..., n] to the first n slots of one type; with dynamic
    counts dead slots -> max_dist."""
    params = {k: v[:n] for k, v in data.prims[ptype.name].items()}
    dists = ptype.sdf(params, p[..., None, :])
    if static:
        return dists
    valid = torch.arange(n, device=p.device) < data.prim_counts[ptype.name]
    return torch.where(valid, dists, spec.max_dist)


def scene_sdf(spec: SceneSpec, data: SceneData, p):
    """closest_primitive: min distance over every live primitive, capped at
    max_dist.  Twice differentiable wherever the JAX package's is: the
    normal of the differentiable shade is its gradient, and the loss's
    gradient goes through that.  torch.minimum and torch.amin split the
    gradient evenly at an exact tie, as jnp.minimum and jnp.min do; so a
    miss lane sitting exactly on the max_dist cap gives the cap and the
    nearest slot half each in both packages."""
    closest = torch.full(p.shape[:-1], spec.max_dist, dtype=torch.float32,
                         device=p.device)
    for ptype, cap, n, static in spec.prim_bounds():
        if n == 0:
            continue
        closest = torch.minimum(closest, torch.amin(
            _masked_type_dists(spec, data, ptype, n, static, p), dim=-1))
    return closest


def material_lookup(data: SceneData, material_id):
    """(albedo, metallic, roughness) of each material id, clamped to the
    table.  index_select, not advanced indexing: the gradient of the one
    is an index_add, of the other an index_put that on the card sorts its
    indices and sums each run serially, and a frame's ids are a few
    distinct values repeated over every ray (81 of the 512x512 train
    step's 102 ms of device time, PERF.md)."""
    m = data.materials["albedo"].shape[0]
    mid = torch.clamp(material_id, 0, m - 1).long()
    return tuple(torch.index_select(data.materials[k], 0, mid)
                 for k in ("albedo", "metallic", "roughness"))


# ---------------------------------------------------------------------------
# Host-side scene builder: numpy mirror with the reference's mutation API.
# ---------------------------------------------------------------------------

class SceneBuilder:
    """Mutable host mirror of a SceneData; ``.device_data(device)``
    snapshots it onto a device."""

    def __init__(self, spec: SceneSpec):
        self.spec = spec
        self._prims = {}
        self._prim_counts = {}
        self._lights = {}
        self._light_counts = {}
        for ptype, cap in spec.prims:
            self._prims[ptype.name] = {
                fname: np.zeros((cap,) + kind_shape(kind), kind_dtype(kind))
                for fname, kind in ptype.fields}
            self._prim_counts[ptype.name] = 0
        for ltype, cap in spec.lights:
            self._lights[ltype.name] = {
                fname: np.zeros((cap,) + kind_shape(kind), kind_dtype(kind))
                for fname, kind in ltype.fields}
            self._light_counts[ltype.name] = 0
        self._albedo = np.zeros((spec.max_materials, 3), np.float32)
        self._metallic = np.zeros((spec.max_materials,), np.float32)
        self._roughness = np.zeros((spec.max_materials,), np.float32)
        self._material_count = 0

    def add_primitive(self, ptype: PrimitiveType, **fields) -> int:
        idx = self._prim_counts[ptype.name]
        cap = dict((pt.name, c) for pt, c in self.spec.prims)[ptype.name]
        if idx >= cap:
            raise ValueError(
                f"capacity exceeded for {ptype.name} (cap={cap})")
        self._prim_counts[ptype.name] = idx + 1
        self.set_primitive(ptype, idx, **fields)
        return idx

    def set_primitive(self, ptype: PrimitiveType, index: int, **fields):
        store = self._prims[ptype.name]
        for fname, value in fields.items():
            store[fname][index] = value

    def add_light(self, ltype: LightType, **fields) -> int:
        idx = self._light_counts[ltype.name]
        cap = dict((lt.name, c) for lt, c in self.spec.lights)[ltype.name]
        if idx >= cap:
            raise ValueError(
                f"capacity exceeded for {ltype.name} (cap={cap})")
        self._light_counts[ltype.name] = idx + 1
        self.set_light(ltype, idx, **fields)
        return idx

    def set_light(self, ltype: LightType, index: int, **fields):
        store = self._lights[ltype.name]
        for fname, value in fields.items():
            store[fname][index] = value

    def add_material(self, albedo, metallic, roughness) -> int:
        idx = self._material_count
        self._material_count += 1
        self.set_material(idx, albedo, metallic, roughness)
        return idx

    def set_material(self, index: int, albedo, metallic, roughness):
        if not 0 <= index < self.spec.max_materials:
            raise ValueError(
                f"material index {index} out of range "
                f"(max_materials={self.spec.max_materials})")
        self._albedo[index] = albedo
        self._metallic[index] = metallic
        self._roughness[index] = roughness
        self._material_count = max(self._material_count, index + 1)

    def device_data(self, device, grid=None) -> SceneData:
        """The scene on ``device``, with the partitioning ``grid`` (a
        GridData already there) when the caller built one."""
        def leaves(d):
            return {k: to_device(v, device) for k, v in d.items()}

        def counts(d):
            return {k: torch.full((), v, dtype=torch.int32, device=device)
                    for k, v in d.items()}

        return SceneData(
            prims={k: leaves(v) for k, v in self._prims.items()},
            prim_counts=counts(self._prim_counts),
            lights={k: leaves(v) for k, v in self._lights.items()},
            light_counts=counts(self._light_counts),
            materials=leaves({"albedo": self._albedo,
                              "metallic": self._metallic,
                              "roughness": self._roughness}),
            grid=grid)
