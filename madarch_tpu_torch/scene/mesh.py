"""Triangle meshes: OBJ loading, voxels, baked distance maps and
Morton-ordered insertion into a renderer (port of madarch_tpu/scene/mesh.py:
Mesh, load_obj, voxelize, bake_distance_map, morton_order,
add_mesh_to_renderer).  Host-side data is numpy, as in the JAX package; the
distance bake runs in PyTorch on the device it is given.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from madarch_tpu_torch.core import vecmath as vm


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

    def bounding_box(self):
        """(lo f32[3], hi f32[3])."""
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    def dump_info(self):
        lo, hi = self.bounding_box()
        print(f"mesh: {len(self.vertices)} vertices, "
              f"{self.num_triangles} triangles, bb {lo} .. {hi}")


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


def voxelize(mesh: Mesh, dims, lo=None, hi=None) -> np.ndarray:
    """Vertex-sampling voxelization into a bool[W,H,D] grid over [lo, hi]
    (the mesh's box by default): a voxel is set if any vertex falls in
    it."""
    lo0, hi0 = mesh.bounding_box()
    lo = lo0 if lo is None else np.asarray(lo, np.float32)
    hi = hi0 if hi is None else np.asarray(hi, np.float32)
    dims = np.asarray(dims, np.int64)
    extent = np.maximum(hi - lo, 1e-12)
    cells = ((mesh.vertices - lo) / extent * dims).astype(np.int64)
    cells = np.clip(cells, 0, dims - 1)
    grid = np.zeros(tuple(dims), bool)
    grid[cells[:, 0], cells[:, 1], cells[:, 2]] = True
    return grid


def _triangle_dist_and_closest(v1, v2, v3, p):
    """Exact point-triangle distance² f32[T,N], closest point f32[T,N,3]
    and unit face normal f32[T,3] of triangles v1, v2, v3 f32[T,3] against
    points p f32[N,3] (the iq construction): the closest of the three edge
    points unless the point projects inside the triangle, then the plane's
    foot."""
    v1, v2, v3 = v1[:, None], v2[:, None], v3[:, None]      # [T,1,3]
    v21, v32, v13 = v2 - v1, v3 - v2, v1 - v3
    p1, p2, p3 = p - v1, p - v2, p - v3                     # [T,N,3]
    nor = vm.cross(v21, v13)

    def edge_closest(v, q, base):
        t = torch.clamp(vm.dot(q, v) / torch.clamp_min(vm.dot(v, v), 1e-30),
                        0.0, 1.0)
        c = base + t[..., None] * v
        e = c - p
        return c, vm.dot(e, e)

    c1, d1 = edge_closest(v21, p1, v1)
    c2, d2 = edge_closest(v32, p2, v2)
    c3, d3 = edge_closest(v13, p3, v3)

    inside = (torch.sign(vm.dot(p1, vm.cross(v21, nor)))
              + torch.sign(vm.dot(p2, vm.cross(v32, nor)))
              + torch.sign(vm.dot(p3, vm.cross(v13, nor)))) < 2.0

    nn = nor / torch.clamp_min(torch.sqrt(vm.dot(nor, nor)), 1e-30)[..., None]
    plane_off = vm.dot(p1, nn)
    c_plane = p - plane_off[..., None] * nn
    d_plane = plane_off * plane_off

    edge_d = torch.minimum(torch.minimum(d1, d2), d3)
    c_edge = torch.where(((d1 <= d2) & (d1 <= d3))[..., None], c1,
                         torch.where((d2 <= d3)[..., None], c2, c3))
    d2_final = torch.where(inside, edge_d, d_plane)
    c_final = torch.where(inside[..., None], c_edge, c_plane)
    return d2_final, c_final, nn[:, 0]


def bake_distance_map(mesh: Mesh, dims, lo, hi, batch=8192, *,
                      device="cuda"):
    """Exact closest-triangle distance and face normal over a dense grid of
    dims points spanning [lo, hi] (numpy linspace per axis), in batches of
    ``batch`` points against every triangle on ``device`` (the CUDA card
    unless the caller names another).  The first closest triangle wins, and
    a point behind it (back-facing) gets distance 0.  Returns numpy
    (dist f32[X,Y,Z], normal f32[X,Y,Z,3])."""
    dims = tuple(int(x) for x in dims)
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    xs = [np.linspace(lo[i], hi[i], dims[i], dtype=np.float32)
          for i in range(3)]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    pts = torch.as_tensor(np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
                          ).to(device)
    tv = torch.as_tensor(mesh.triangle_vertices()).to(device)   # [T,3,3]
    out_d, out_n = [], []
    with torch.no_grad():
        for p in pts.split(batch):
            d2s, _, nns = _triangle_dist_and_closest(
                tv[:, 0], tv[:, 1], tv[:, 2], p)
            best = torch.argmin(d2s, dim=0)                   # [N]
            d = torch.sqrt(d2s[best, torch.arange(p.shape[0],
                                                  device=p.device)])
            n = nns[best]
            back = vm.dot(p - tv[best, 0], n) < 0.0
            out_d.append(torch.where(back, 0.0, d))
            out_n.append(n)
    return (torch.cat(out_d).cpu().numpy().reshape(dims),
            torch.cat(out_n).cpu().numpy().reshape(dims + (3,)))


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
    from madarch_tpu_torch.scene.primitives import Triangle
    off = np.asarray(offset, np.float32)
    tv = mesh.triangle_vertices() + off
    if order == "morton":
        tv = tv[morton_order(tv.mean(axis=1))]
    for a, b, c in tv:
        renderer.add_primitive(Triangle, v1=a, v2=b, v3=c,
                               material_id=material_id)
    return mesh.num_triangles
