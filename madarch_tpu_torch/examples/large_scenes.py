"""Scenes past the kernels' 48 KiB of shared memory, built in code from a
seed: a field of thousands of spheres over a floor, and grid meshes of
thousands of triangles written as OBJ files for ``scenes.obj_mesh``.

Their packed sizes (ops/march.py:pack_scene) span the three placements of
the kernels' staged tables (ops/march.py:placement_for):

- SPHERES spheres take the JAX package's chunked layout: 438 chunks and
  55 super-chunks, 15,808 bytes of boxes, staged as is;
- MESH_TRIANGLES triangles: 1,689 box rows, 54,048 bytes, staged after
  the opt-in by the geometry kernel, read from device memory by the
  march kernels;
- HUGE_MESH_TRIANGLES triangles: 9,142 box rows, 292,544 bytes, past an
  H100's opt-in limit (232,448), read in place from device memory.

``add_sphere_field`` fills either package's Renderer (the two share
add_material, add_primitive, add_light and set_camera_position), so a
test can hold the port to the JAX package on the same scene.
"""
from __future__ import annotations

import numpy as np

from madarch_tpu_torch.core.config import NO_VOLUMETRICS, ProbeSettings
from madarch_tpu_torch.render.renderer import Renderer
from madarch_tpu_torch.scene import lights as L
from madarch_tpu_torch.scene import primitives as P
from madarch_tpu_torch.scene.scene import SceneSpec

SPHERES = 3500
MESH_TRIANGLES = 12000
HUGE_MESH_TRIANGLES = 65000
# obj_mesh's own probes: 36 probes of 32² radiance texels
PROBES = ProbeSettings(radiance_resolution=32, irradiance_resolution=8,
                       probe_count=(6, 6), grid_dimensions=(3, 3, 4),
                       grid_spacing=(2.0, 3.0, 3.0))


def grid_shape(n_triangles):
    """(nx, nz) quads of a grid of n_triangles (even) triangles, nz the
    largest divisor of the quad count not above its square root."""
    quads = n_triangles // 2
    if 2 * quads != n_triangles or quads == 0:
        raise ValueError(f"a grid holds an even, positive number of "
                         f"triangles, not {n_triangles}")
    nz = max(d for d in range(1, int(quads ** 0.5) + 1) if quads % d == 0)
    return quads // nz, nz


def grid_vertices(n_triangles, size=2.0, amplitude=0.2):
    """(f32[(nx + 1)·(nz + 1), 3] vertices, i32[n_triangles, 3] faces) of
    a wavy grid of size × size facing -z: x and y span the grid, z is
    amplitude · sin(3x) · cos(2y)."""
    nx, nz = grid_shape(n_triangles)
    xs = np.linspace(-size / 2, size / 2, nx + 1)
    ys = np.linspace(-size / 2, size / 2, nz + 1)
    x, y = np.meshgrid(xs, ys, indexing="ij")
    z = amplitude * np.sin(3.0 * x) * np.cos(2.0 * y)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    a = (np.arange(nx)[:, None] * (nz + 1) + np.arange(nz)[None]).ravel()
    b, c, d = a + 1, a + nz + 1, a + nz + 2
    faces = np.stack([np.stack([a, c, b], 1), np.stack([b, c, d], 1)],
                     axis=1).reshape(-1, 3)
    return verts, faces.astype(np.int32)


def write_grid_obj(path, n_triangles, size=2.0, amplitude=0.2):
    """Writes grid_vertices' mesh as an OBJ file (1-based faces)."""
    verts, faces = grid_vertices(n_triangles, size, amplitude)
    with open(path, "w") as f:
        f.writelines(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in verts)
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces)
    return path


def add_sphere_field(r, sphere, plane, point_light, n=SPHERES, seed=0):
    """Fills renderer r (of either package; sphere, plane and point_light
    its primitive and light types) with n seeded spheres of radius 0.05 to
    0.12 in the box (-3, -0.5, 3) to (3, 2, 9), a floor at y = -1, one
    point light, and the camera at (0, 1, -5)."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform((-3.0, -0.5, 3.0), (3.0, 2.0, 9.0),
                          (n, 3)).astype(np.float32)
    radii = rng.uniform(0.05, 0.12, n).astype(np.float32)
    ball = r.add_material((0.8, 0.3, 0.2), 0.0, 0.5)
    mirror = r.add_material((0.9, 0.9, 0.9), 1.0, 0.1)
    floor = r.add_material((0.6, 0.6, 0.6), 0.0, 0.9)
    for i in range(n):
        r.add_primitive(sphere, center=centers[i], radius=float(radii[i]),
                        material_id=mirror if i % 7 == 0 else ball)
    r.add_primitive(plane, normal=(0.0, 1.0, 0.0), offset=1.0,
                    material_id=floor)
    r.add_light(point_light, position=(0.0, 5.0, 2.0), color=(1.0, 1.0, 1.0))
    r.set_camera_position((0.0, 1.0, -5.0))
    return r


def sphere_field(width=800, height=800, n=SPHERES, seed=0,
                 **kwargs) -> Renderer:
    """The sphere field as a Renderer of the port, with obj_mesh's probes
    unless ``probes`` says otherwise; on the CUDA card unless a ``device``
    keyword says otherwise."""
    spec = SceneSpec(prims=((P.Sphere, n), (P.Plane, 1)),
                     lights=((L.PointLight, 1),))
    kwargs.setdefault("probes", PROBES)
    r = Renderer(spec, width, height, volumetrics=NO_VOLUMETRICS, **kwargs)
    return add_sphere_field(r, P.Sphere, P.Plane, L.PointLight, n, seed)
