"""Primitive types: analytic signed-distance functions (a frozen copy of
the port's scene/primitives.py: Sphere, Plane, Box, Triangle; their
analytic normals and user-defined types, which only the generic route
reads, are not copied).

A ``PrimitiveType`` carries a field schema plus an ``sdf`` callback on a
dict of parameter tensors and query points ``p[..., 3]``; it
broadcasts, so batched parameters ``[n, ...]`` against points
``[N, 1, 3]`` give ``[N, n]``.  ``sdf_planar`` is the form the march kernel
evaluates (vec3 fields split into name_x/name_y/name_z scalars); the plain
geometry path in ops/march.py evaluates it too, operation for operation.
A type with ``derive`` (the triangle) is evaluated instead through
``sdf_planar_derived`` on per-slot constants ``derive`` computes once.

``sdf`` is what the differentiable shade differentiates twice (the normal
is its gradient in p, and the loss's gradient runs through that).  Its
guards are the JAX package's: ``length`` clamps |v|² at 1e-30 before the
sqrt, so a zero vector (a point inside a box, where max(q, 0) is 0 on every
axis) has finite first and second derivatives; the triangle clamps its
edge parameter to [0, 1] and its divisors at 1e-30.  torch.clamp,
clamp_min and clamp_max pass the whole gradient at an exact tie where
jnp.clip and jnp.maximum pass half: the packages' gradients differ only
at a point exactly on a clamp's edge (q exactly 0, an edge parameter
exactly 0 or 1), which no marched point is in practice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core import vecmath as vm

VEC3 = "vec3"
FLOAT = "float"
INT = "int"

_KIND_SHAPE = {VEC3: (3,), FLOAT: (), INT: ()}
_KIND_DTYPE = {VEC3: np.float32, FLOAT: np.float32, INT: np.int32}


def kind_shape(kind: str):
    return _KIND_SHAPE[kind]


def kind_dtype(kind: str):
    """numpy dtype of a field kind (the host-side SceneBuilder's arrays)."""
    return _KIND_DTYPE[kind]


@dataclasses.dataclass(frozen=True, eq=False)
class PrimitiveType:
    """A primitive *type*: schema + distance/normal functions (identity
    hash/eq, so types key dicts and specs)."""

    name: str
    fields: tuple        # ((field_name, kind), ...); material_id last
    sdf: Callable        # (params, p[..., 3]) -> [...]
    sdf_planar: Optional[Callable] = None   # (scalars, px, py, pz) -> dist
    bounds: Optional[Callable] = None       # batched params -> (lo, hi)
    # batched params -> per-slot constants (schema derived_fields) that
    # sdf_planar_derived reads in place of the raw fields
    derive: Optional[Callable] = None
    derived_fields: Optional[tuple] = None
    sdf_planar_derived: Optional[Callable] = None


# ---------------------------------------------------------------------------
# Sphere
# ---------------------------------------------------------------------------

def _sphere_sdf(params, p):
    return vm.length(params["center"] - p) - params["radius"]


def _sphere_sdf_planar(s, px, py, pz):
    dx = s["center_x"] - px
    dy = s["center_y"] - py
    dz = s["center_z"] - pz
    return torch.sqrt(dx * dx + dy * dy + dz * dz) - s["radius"]


def _sphere_bounds(params):
    r = params["radius"][:, None]
    return params["center"] - r, params["center"] + r


Sphere = PrimitiveType(
    name="sphere",
    fields=(("center", VEC3), ("radius", FLOAT), ("material_id", INT)),
    sdf=_sphere_sdf,
    sdf_planar=_sphere_sdf_planar,
    bounds=_sphere_bounds,
)


# ---------------------------------------------------------------------------
# Plane
# ---------------------------------------------------------------------------

def _plane_sdf(params, p):
    return vm.dot(params["normal"], p) + params["offset"]


def _plane_sdf_planar(s, px, py, pz):
    return (s["normal_x"] * px + s["normal_y"] * py + s["normal_z"] * pz
            + s["offset"])


Plane = PrimitiveType(
    name="plane",
    fields=(("normal", VEC3), ("offset", FLOAT), ("material_id", INT)),
    sdf=_plane_sdf,
    sdf_planar=_plane_sdf_planar,
)


# ---------------------------------------------------------------------------
# Box; `side` holds the half-extents.
# ---------------------------------------------------------------------------

def _box_sdf(params, p):
    q = vm.absolute(params["center"] - p) - params["side"]
    outside = vm.length(torch.clamp_min(q, 0.0))
    inside = torch.clamp_max(torch.amax(q, dim=-1), 0.0)
    return outside + inside


def _box_sdf_planar(s, px, py, pz):
    qx = torch.abs(s["center_x"] - px) - s["side_x"]
    qy = torch.abs(s["center_y"] - py) - s["side_y"]
    qz = torch.abs(s["center_z"] - pz) - s["side_z"]
    ox = torch.clamp_min(qx, 0.0)
    oy = torch.clamp_min(qy, 0.0)
    oz = torch.clamp_min(qz, 0.0)
    outside = torch.sqrt(ox * ox + oy * oy + oz * oz)
    inside = torch.clamp_max(torch.maximum(qx, torch.maximum(qy, qz)), 0.0)
    return outside + inside


def _box_bounds(params):
    return (params["center"] - params["side"],
            params["center"] + params["side"])


Box = PrimitiveType(
    name="box",
    fields=(("center", VEC3), ("side", VEC3), ("material_id", INT)),
    sdf=_box_sdf,
    sdf_planar=_box_sdf_planar,
    bounds=_box_bounds,
)


# ---------------------------------------------------------------------------
# Triangle: exact unsigned distance (the iq triangle SDF).  No analytic
# normal: the render path takes the tetrahedron FD normal of the scene.
# ---------------------------------------------------------------------------

def _triangle_sdf(params, p):
    v1, v2, v3 = params["v1"], params["v2"], params["v3"]
    v21 = v2 - v1
    v32 = v3 - v2
    v13 = v1 - v3
    p1 = p - v1
    p2 = p - v2
    p3 = p - v3
    nor = vm.cross(v21, v13)

    inside = (torch.sign(vm.dot(vm.cross(v21, nor), p1))
              + torch.sign(vm.dot(vm.cross(v32, nor), p2))
              + torch.sign(vm.dot(vm.cross(v13, nor), p3))) < 2.0

    def edge(v, q):
        t = vm.clamp(vm.dot(v, q) / torch.clamp_min(vm.dot2(v), 1e-30),
                     0.0, 1.0)
        return vm.dot2(v * t[..., None] - q)

    edge_d2 = torch.minimum(torch.minimum(edge(v21, p1), edge(v32, p2)),
                            edge(v13, p3))
    dn = vm.dot(nor, p1)
    plane_d2 = dn * dn / torch.clamp_min(vm.dot2(nor), 1e-30)
    return torch.sqrt(torch.clamp_min(torch.where(inside, edge_d2, plane_d2),
                                      1e-30))


def _dotp(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _triangle_bounds(params):
    vs = torch.stack([params["v1"], params["v2"], params["v3"]])  # [3,n,3]
    return vs.amin(dim=0), vs.amax(dim=0)


def _triangle_derive(params):
    """Per-triangle constants: the edges, face normal, edge-normal crosses
    and inverse squared lengths of the iq SDF do not depend on the point,
    so they are computed once per slot instead of at every evaluation."""
    v1, v2, v3 = params["v1"], params["v2"], params["v3"]
    v21 = v2 - v1
    v32 = v3 - v2
    v13 = v1 - v3
    nor = vm.cross(v21, v13)

    def inv(e):
        return 1.0 / torch.clamp_min(vm.dot2(e), 1e-30)

    return {
        "v1": v1, "v21": v21, "v32": v32, "v13": v13, "nor": nor,
        "n21": vm.cross(v21, nor), "n32": vm.cross(v32, nor),
        "n13": vm.cross(v13, nor),
        "i21": inv(v21), "i32": inv(v32), "i13": inv(v13),
        "inor": inv(nor),
        "material_id": params["material_id"],
    }


def _triangle_sdf_planar_derived(s, px, py, pz):
    """The triangle SDF on _triangle_derive's constants (p2 = p1 - v21 and
    p3 = p1 + v13 replace the vertex subtractions); csrc/scene.cuh's
    tri_dist repeats it operation for operation."""
    def v(name):
        return (s[name + "_x"], s[name + "_y"], s[name + "_z"])

    v1, v21, v32, v13 = v("v1"), v("v21"), v("v32"), v("v13")
    nor, n21, n32, n13 = v("nor"), v("n21"), v("n32"), v("n13")
    p1 = (px - v1[0], py - v1[1], pz - v1[2])
    p2 = (p1[0] - v21[0], p1[1] - v21[1], p1[2] - v21[2])
    p3 = (p1[0] + v13[0], p1[1] + v13[1], p1[2] + v13[2])

    inside = (torch.sign(_dotp(n21, p1)) + torch.sign(_dotp(n32, p2))
              + torch.sign(_dotp(n13, p3))) < 2.0

    def edge(vv, q, iv):
        t = torch.clamp(_dotp(vv, q) * iv, 0.0, 1.0)
        ex = vv[0] * t - q[0]
        ey = vv[1] * t - q[1]
        ez = vv[2] * t - q[2]
        return ex * ex + ey * ey + ez * ez

    edge_d2 = torch.minimum(
        torch.minimum(edge(v21, p1, s["i21"]), edge(v32, p2, s["i32"])),
        edge(v13, p3, s["i13"]))
    dn = _dotp(nor, p1)
    plane_d2 = dn * dn * s["inor"]
    return torch.sqrt(torch.clamp_min(torch.where(inside, edge_d2, plane_d2),
                                      1e-30))


TRIANGLE_DERIVED_FIELDS = (
    ("v1", VEC3), ("v21", VEC3), ("v32", VEC3), ("v13", VEC3),
    ("nor", VEC3), ("n21", VEC3), ("n32", VEC3), ("n13", VEC3),
    ("i21", FLOAT), ("i32", FLOAT), ("i13", FLOAT), ("inor", FLOAT),
    ("material_id", INT),
)


Triangle = PrimitiveType(
    name="triangle",
    fields=(("v1", VEC3), ("v2", VEC3), ("v3", VEC3), ("material_id", INT)),
    sdf=_triangle_sdf,
    bounds=_triangle_bounds,
    derive=_triangle_derive,
    derived_fields=TRIANGLE_DERIVED_FIELDS,
    sdf_planar_derived=_triangle_sdf_planar_derived,
)
