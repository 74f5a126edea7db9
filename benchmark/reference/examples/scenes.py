"""The benchmark's configurations' scene builders (the port's
examples/scenes.py: global_illumination and obj_mesh's exact mode).  Each
runs on the CUDA card unless a ``device`` keyword says otherwise."""
from __future__ import annotations

import numpy as np

from ..core.config import NO_VOLUMETRICS, PartitioningSettings, ProbeSettings
from ..render.renderer import Renderer
from ..scene import lights as L
from ..scene import primitives as P
from ..scene.scene import SceneSpec


def _room(r: Renderer, wall_mats):
    """The 6-plane room shared by several examples."""
    w1, w2, w3 = wall_mats
    for nrm, off, m in [((0.0, 1.0, 0.0), 1.0, w1),
                        ((0.0, -1.0, 0.0), 7.0, w1),
                        ((1.0, 0.0, 0.0), 1.0, w2),
                        ((-1.0, 0.0, 0.0), 7.0, w3),
                        ((0.0, 0.0, 1.0), 6.0, w1),
                        ((0.0, 0.0, -1.0), 7.0, w1)]:
        r.add_primitive(P.Plane, normal=nrm, offset=off, material_id=m)


def global_illumination(width=1000, height=1000, time: float = 0.0,
                        **kwargs) -> Renderer:
    """The DDGI showcase: room with a mirror sphere, a metallic green box
    and a spot light."""
    spec = SceneSpec(prims=((P.Sphere, 20), (P.Plane, 10), (P.Box, 10)),
                     lights=((L.SpotLight, 4),))
    r = Renderer(spec, width, height, volumetrics=NO_VOLUMETRICS, **kwargs)
    wall1 = r.add_material((0.0, 0.0, 0.0), 0.0, 0.6)
    wall2 = r.add_material((1.0, 0.0, 0.0), 0.0, 0.6)
    wall3 = r.add_material((0.0, 0.0, 1.0), 0.0, 0.6)
    sphere_m = r.add_material((0.1, 0.1, 0.1), 0.9, 0.1)
    box_m = r.add_material((0.0, 1.0, 0.0), 0.8, 0.3)
    _room(r, (wall1, wall2, wall3))
    r.add_primitive(P.Sphere, center=(3.0, 4.0, 3.0), radius=1.0,
                    material_id=sphere_m)
    r.add_primitive(P.Box, center=(3.0, 0.0, 4.0), side=(1.5, 1.5, 1.5),
                    material_id=box_m)
    r.add_light(L.SpotLight, position=(3.5, 5.0, 2.0),
                direction=(np.cos(time), np.sin(time), 0.0),
                aperture=3.1415 / 4.0, color=(0.9, 0.9, 0.8))
    r.set_camera_position((2.0, 2.0, 0.0))
    return r


def obj_mesh(width=1000, height=1000, obj_path=None,
             triangle_capacity=1000, **kwargs) -> Renderer:
    """A mesh at (1.5, 1, 1) with one point light and the camera at
    (0, 1, -5): Triangle primitives (Morton order) with a 30×20×20 × 0.1
    partitioning grid (the exact mode).  The grid's candidate lists are
    not built: no march reads them (the geometry launch prunes by its own
    chunk boxes)."""
    from ..scene.mesh import add_mesh_to_renderer, load_obj

    mesh = load_obj(obj_path)
    offset = (1.5, 1.0, 1.0)
    spec = SceneSpec(
        prims=((P.Triangle, triangle_capacity),),
        lights=((L.PointLight, 4),),
        partitioning=PartitioningSettings(
            index_count=150, border_behavior="clamp",
            grid_dimensions=(30, 20, 20),
            grid_spacing=(0.1, 0.1, 0.1),
            grid_offset=(0.0, 0.0, 0.0)))
    probes = kwargs.pop("probes", ProbeSettings(
        radiance_resolution=32, irradiance_resolution=8,
        probe_count=(6, 6), grid_dimensions=(3, 3, 4),
        grid_spacing=(2.0, 3.0, 3.0)))
    r = Renderer(spec, width, height, probes=probes,
                 volumetrics=NO_VOLUMETRICS, **kwargs)
    mesh_mat = r.add_material((0.8, 0.2, 0.1), 0.0, 1.0)
    add_mesh_to_renderer(r, mesh, mesh_mat, offset=offset)
    r.add_light(L.PointLight, position=(0.0, 1.0, -5.0),
                color=(0.9, 0.9, 0.9))
    r.set_camera_position((0.0, 1.0, -5.0))
    return r
