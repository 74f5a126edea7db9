"""Generic SAH bounding-volume hierarchy and the BVH-compiled scene SDF
(port of madarch_tpu/scene/bvh.py).

``build_bvh`` is the JAX package's numpy sweep-SAH over all 3 axes, node
for node.  ``bvh_sdf`` compiles the tree into one distance function:
node = let bbd = box_sdf(aabb) in (bbd < threshold ? min(left, right) :
bbd), a static ``torch.where`` tree that evaluates both sides and selects,
as the JAX package's ``jnp.where`` tree does.  The primitive has no kernel
form: a scene holding it renders on the generic route (render/context.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from madarch_tpu_torch.core import vecmath as vm
from madarch_tpu_torch.scene.primitives import (INT, VEC3, DeviceConstant,
                                                PrimitiveType)


# ---------------------------------------------------------------------------
# AABB helpers
# ---------------------------------------------------------------------------

def aabb_extend(lo1, hi1, lo2, hi2):
    return np.minimum(lo1, lo2), np.maximum(hi1, hi2)


def aabb_surface_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[0] * d[2])


def aabb_contains(lo, hi, p):
    return bool(np.all(p >= lo) and np.all(p <= hi))


def _box_dist(center, side, p):
    """The box distance of aabb_sdf on center and side f32[3] tensors on
    p's device."""
    q = vm.absolute(center - p) - side
    o = torch.clamp_min(q, 0.0)
    outside = torch.sqrt(torch.clamp_min(vm.dot(o, o), 1e-30))
    inside = torch.clamp_max(torch.amax(q, dim=-1), 0.0)
    return outside + inside


def _center_side(lo, hi):
    """(center, side) f32[3] of an AABB, side its full extent."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    return (lo + hi) / np.float32(2.0), hi - lo


def aabb_sdf(lo, hi, p):
    """Box SDF of an AABB at points p[..., 3], with the full extent hi - lo
    as the half-side (the reference's deliberately loose box: a
    conservative stand-in for the subtree it bounds)."""
    center, side = (torch.as_tensor(x).to(p.device)
                    for x in _center_side(lo, hi))
    return _box_dist(center, side, p)


# ---------------------------------------------------------------------------
# SAH build
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BVHNode:
    lo: np.ndarray
    hi: np.ndarray
    axis: int = -1
    left: Optional["BVHNode"] = None
    right: Optional["BVHNode"] = None
    indices: Optional[np.ndarray] = None  # leaf payload

    @property
    def is_leaf(self):
        return self.indices is not None

    def dump(self, depth=0):
        """Print the tree, a line a node, indented by depth."""
        pad = "  " * depth
        if self.is_leaf:
            print(f"{pad}leaf {list(self.indices)} bb {self.lo}..{self.hi}")
        else:
            print(f"{pad}node axis={self.axis} bb {self.lo}..{self.hi}")
            self.left.dump(depth + 1)
            self.right.dump(depth + 1)


def build_bvh(bboxes: Sequence, leaf_size: int = 1) -> BVHNode:
    """Sweep-SAH over all 3 axes: at each node, every split of the
    primitives sorted (stably) by box centre along each axis, costed as
    prefix area · count + suffix area · count; the first cheapest split
    wins.  bboxes: sequence of (lo f32[3], hi f32[3]) per primitive."""
    los = np.asarray([b[0] for b in bboxes], np.float32)
    his = np.asarray([b[1] for b in bboxes], np.float32)
    centers = (los + his) / 2.0

    def node_bounds(idx):
        return los[idx].min(axis=0), his[idx].max(axis=0)

    def recurse(idx: np.ndarray) -> BVHNode:
        lo, hi = node_bounds(idx)
        if len(idx) <= leaf_size:
            return BVHNode(lo=lo, hi=hi, indices=idx.copy())

        best = None  # (cost, axis, k, order)
        for axis in range(3):
            order = idx[np.argsort(centers[idx, axis], kind="stable")]
            n = len(order)
            pref = np.empty(n)
            suff = np.empty(n)
            l_lo, l_hi = los[order[0]].copy(), his[order[0]].copy()
            for i in range(n):
                l_lo, l_hi = aabb_extend(l_lo, l_hi, los[order[i]],
                                         his[order[i]])
                pref[i] = aabb_surface_area(l_lo, l_hi)
            r_lo, r_hi = los[order[-1]].copy(), his[order[-1]].copy()
            for i in range(n - 1, -1, -1):
                r_lo, r_hi = aabb_extend(r_lo, r_hi, los[order[i]],
                                         his[order[i]])
                suff[i] = aabb_surface_area(r_lo, r_hi)
            for k in range(1, n):
                cost = pref[k - 1] * k + suff[k] * (n - k)
                if best is None or cost < best[0]:
                    best = (cost, axis, k, order)

        _, axis, k, order = best
        return BVHNode(lo=lo, hi=hi, axis=axis,
                       left=recurse(order[:k]), right=recurse(order[k:]))

    return recurse(np.arange(len(bboxes)))


def visit(node: BVHNode, leaf_fn: Callable, node_fn: Callable):
    """Generic fold: leaf_fn(leaf), node_fn(node, left's, right's)."""
    if node.is_leaf:
        return leaf_fn(node)
    left = visit(node.left, leaf_fn, node_fn)
    right = visit(node.right, leaf_fn, node_fn)
    return node_fn(node, left, right)


def bvh_sdf(node: BVHNode, leaf_sdfs: Sequence[Callable],
            threshold: float = 0.2) -> Callable:
    """Compile the tree into one distance function p -> dist: outside a
    node's threshold shell the node's own box distance stands in for its
    subtree (a conservative lower bound); both sides of every node are
    evaluated and selected.  leaf_sdfs[i]: p -> dist for primitive i.  The
    boxes live on each device they are evaluated on, copied there once."""
    boxes = []   # (center, side) per node, in the fold's order

    def box(n):
        boxes.append(_center_side(n.lo, n.hi))
        return len(boxes) - 1

    def leaf_fn(n: BVHNode):
        i, b = int(n.indices[0]), box(n)

        def f(p, table):
            bbd = _box_dist(table[b, 0], table[b, 1], p)
            return torch.where(bbd < threshold, leaf_sdfs[i](p), bbd)
        return f

    def node_fn(n: BVHNode, left, right):
        b = box(n)

        def f(p, table):
            bbd = _box_dist(table[b, 0], table[b, 1], p)
            return torch.where(bbd < threshold,
                               torch.minimum(left(p, table),
                                             right(p, table)), bbd)
        return f

    root = visit(node, leaf_fn, node_fn)
    table = DeviceConstant(np.asarray(boxes, np.float32))   # [nodes, 2, 3]
    return lambda p: root(p, table.on(p.device))


def make_bvh_primitive(name: str, node: BVHNode,
                       leaf_sdfs: Sequence[Callable],
                       threshold: float = 0.2) -> PrimitiveType:
    """A PrimitiveType whose SDF is the compiled BVH traversal (fields:
    position and material_id; the geometry is baked in world space, so
    position is not read; the normal is the autograd gradient of the
    traversal)."""
    traverse = bvh_sdf(node, leaf_sdfs, threshold)

    def sdf(params, p):
        return traverse(p)

    return PrimitiveType(
        name=name,
        fields=(("position", VEC3), ("material_id", INT)),
        sdf=sdf,
        normal=None,  # autograd gradient
    )
