"""Triangle meshes: OBJ loading and Morton-ordered insertion into a
renderer (the port's scene/mesh.py: Mesh, load_obj, morton_order,
add_mesh_to_renderer).  Host-side data is numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    """Indexed triangle mesh (vertices f32[V,3], normals f32[N,3],
    triangles i32[T,3] vertex indices, tri_normals i32[T,3] normal ids)."""

    vertices: np.ndarray
    normals: np.ndarray
    triangles: np.ndarray
    tri_normals: np.ndarray

    @property
    def num_triangles(self) -> int:
        return len(self.triangles)

    def triangle_vertices(self):
        """f32[T, 3(corner), 3(xyz)]."""
        return self.vertices[self.triangles]


def load_obj(path: str) -> Mesh:
    """Minimal OBJ parser: ``v``, ``vn`` and ``f`` lines (``v``, ``v/t``,
    ``v//n`` or ``v/t/n`` references, 1-based); polygons are triangulated
    by fanning.  Raises FileNotFoundError for a missing file."""
    vertices, normals, tris, tri_ns = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                vertices.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                refs = []
                for tok in parts[1:]:
                    comps = tok.split("/")
                    vi = int(comps[0])
                    ni = int(comps[-1]) if len(comps) >= 3 and comps[-1] \
                        else vi
                    refs.append((vi - 1, ni - 1))
                for i in range(1, len(refs) - 1):
                    tris.append([refs[0][0], refs[i][0], refs[i + 1][0]])
                    tri_ns.append([refs[0][1], refs[i][1], refs[i + 1][1]])
    return Mesh(
        vertices=np.asarray(vertices, np.float32),
        normals=(np.asarray(normals, np.float32) if normals
                 else np.zeros((0, 3), np.float32)),
        triangles=np.asarray(tris, np.int32).reshape(-1, 3),
        tri_normals=np.asarray(tri_ns, np.int32).reshape(-1, 3),
    )


def morton_order(points: np.ndarray, bits: int = 10) -> np.ndarray:
    """The permutation that sorts [N,3] points by their Z-order key:
    spatially adjacent points land in adjacent slots, which keeps the
    geometry kernel's per-chunk bounding boxes tight."""
    lo = points.min(axis=0)
    extent = np.maximum(points.max(axis=0) - lo, 1e-9)
    q = ((points - lo) / extent * ((1 << bits) - 1)).astype(np.int64)
    key = np.zeros(len(points), np.int64)
    for b in range(bits):
        for a in range(3):
            key |= ((q[:, a] >> b) & 1) << (3 * b + a)
    return np.argsort(key, kind="stable")


def add_mesh_to_renderer(renderer, mesh: Mesh, material_id: int,
                         offset=(0.0, 0.0, 0.0), order="morton"):
    """Add every triangle of ``mesh``, moved by ``offset``, as a Triangle
    primitive; ``order="morton"`` (the default) inserts them in Z-order of
    their centroids.  Returns the number of triangles."""
    from ..scene.primitives import Triangle
    off = np.asarray(offset, np.float32)
    tv = mesh.triangle_vertices() + off
    if order == "morton":
        tv = tv[morton_order(tv.mean(axis=1))]
    for a, b, c in tv:
        renderer.add_primitive(Triangle, v1=a, v2=b, v3=c,
                               material_id=material_id)
    return mesh.num_triangles
