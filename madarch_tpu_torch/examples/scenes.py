"""The reference example scenes as Renderer builders (port of
madarch_tpu/examples/scenes.py: simple_scene, global_illumination,
light_shafts, obj_mesh).  Each runs on the CUDA card unless a ``device``
keyword says otherwise."""
from __future__ import annotations

import os

import numpy as np

from madarch_tpu_torch.core.config import (NO_VOLUMETRICS,
                                           PartitioningSettings,
                                           ProbeSettings,
                                           VolumetricsSettings)
from madarch_tpu_torch.render.renderer import Renderer
from madarch_tpu_torch.scene import lights as L
from madarch_tpu_torch.scene import primitives as P
from madarch_tpu_torch.scene.scene import SceneSpec


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


def simple_scene(width=1000, height=1000, **kwargs) -> Renderer:
    """The room with a grid of 20 mirror spheres, 14 blue boxes and a
    point light: 40 live slots, the most of any ported example."""
    spec = SceneSpec(prims=((P.Sphere, 20), (P.Plane, 10), (P.Box, 20)),
                     lights=((L.PointLight, 4),))
    r = Renderer(spec, width, height, volumetrics=NO_VOLUMETRICS, **kwargs)
    r.set_material(0, (0.0, 0.0, 0.0), 0.0, 0.6)
    r.set_material(1, (1.0, 0.0, 0.0), 0.0, 0.6)
    r.set_material(2, (0.0, 0.0, 1.0), 0.0, 0.6)
    r.set_material(3, (0.1, 0.1, 0.1), 0.9, 0.1)
    _room(r, (0, 1, 2))
    sphere_centers = ([(0.5 + i, 3.5, 2.0) for i in range(6)]
                      + [(0.5 + i, 0.5, 2.0) for i in range(6)]
                      + [(0.5 + i, 3.5, 5.0) for i in range(6)]
                      + [(0.5, 0.5, 5.0), (1.5, 0.5, 5.0)])
    for c in sphere_centers:
        r.add_primitive(P.Sphere, center=c, radius=0.5, material_id=3)
    boxes = [((3.0, 1.0, 2.0), (0.5, 0.5, 0.5)),
             ((0.0, 1.0, 2.0), (0.3, 0.3, 0.5)),
             ((3.0, 1.0, 4.0), (0.5, 0.5, 0.5)),
             ((4.0, 2.0, 2.0), (0.5, 0.5, 0.5)),
             ((2.0, 2.0, 2.0), (0.5, 0.5, 0.5)),
             ((1.0, 1.0, 6.0), (0.5, 0.5, 0.5)),
             ((3.0, 1.0, 6.0), (0.5, 0.5, 0.5)),
             ((3.0, 1.0, -2.0), (0.5, 0.5, 0.5)),
             ((1.0, 1.0, -2.0), (0.3, 0.3, 0.5)),
             ((3.0, 1.0, -4.0), (0.5, 0.5, 0.5)),
             ((4.0, 2.0, -2.0), (0.5, 0.5, 0.5)),
             ((2.0, 2.0, -2.0), (0.5, 0.5, 0.5)),
             ((1.0, 1.0, -6.0), (0.5, 0.5, 0.5)),
             ((3.0, 1.0, -6.0), (0.5, 0.5, 0.5))]
    for c, s in boxes:
        r.add_primitive(P.Box, center=c, side=s, material_id=2)
    r.add_light(L.PointLight, position=(0.0, 3.0, 0.0),
                color=(0.9, 0.9, 0.9))
    r.set_camera_position((2.0, 2.0, 0.0))
    return r


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


def light_shafts(width=1000, height=1000, **kwargs) -> Renderer:
    """The room with fully rough matte materials (black walls, red +x,
    green -x), a blue sphere, a green box, a white point light at (5,3,6),
    and volumetrics on (``volumetrics`` overrides the settings)."""
    spec = SceneSpec(prims=((P.Sphere, 20), (P.Plane, 10), (P.Box, 10)),
                     lights=((L.PointLight, 4),))
    r = Renderer(spec, width, height,
                 volumetrics=kwargs.pop("volumetrics",
                                        VolumetricsSettings()), **kwargs)
    r.set_material(0, (0.0, 0.0, 0.0), 0.0, 1.0)
    r.set_material(1, (1.0, 0.0, 0.0), 0.0, 1.0)
    r.set_material(2, (0.0, 1.0, 0.0), 0.0, 1.0)
    r.set_material(3, (0.0, 0.0, 1.0), 0.0, 1.0)
    _room(r, (0, 1, 2))
    r.add_primitive(P.Sphere, center=(3.0, 4.0, 3.0), radius=1.0,
                    material_id=3)
    r.add_primitive(P.Box, center=(3.0, 0.0, 4.0), side=(1.5, 1.5, 1.5),
                    material_id=2)
    r.add_light(L.PointLight, position=(5.0, 3.0, 6.0),
                color=(0.9, 0.9, 0.9))
    r.set_camera_position((2.0, 2.0, 0.0))
    return r


# The JAX package's default mesh, suzanne from the reference project's
# media directory; the repository does not carry it, so callers pass
# obj_path (examples/run.py: --obj), e.g. the in-repo TORUS_OBJ.
DEFAULT_OBJ = os.path.join(os.sep, "root", "reference", "media",
                           "suzanne.obj")
# A closed 968-triangle torus about suzanne's size (test data).
TORUS_OBJ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "media", "torus968.obj")


def obj_mesh(width=1000, height=1000, obj_path=None, triangle_capacity=1000,
             partition_method="gpu_fast", mode="exact",
             bake_dims=(48, 48, 48), **kwargs) -> Renderer:
    """A mesh of exact Triangle primitives (Morton order) at (1.5, 1, 1)
    with a 30×20×20 × 0.1 partitioning grid, one point light and the
    camera at (0, 1, -5).  ``mode="baked"`` (the distance-map primitive)
    is not ported; ``bake_dims`` is its setting."""
    from madarch_tpu_torch.scene.mesh import add_mesh_to_renderer, load_obj

    if mode == "baked":
        raise NotImplementedError(
            "obj_mesh mode='baked' needs the baked distance-map primitive, "
            "not ported yet (ROADMAP A15)")
    if mode != "exact":
        raise ValueError(f"obj_mesh mode must be 'exact' or 'baked', not "
                         f"{mode!r}")
    if obj_path is None:
        obj_path = DEFAULT_OBJ
    if not os.path.exists(obj_path):
        raise FileNotFoundError(
            f"obj_mesh: no mesh at {obj_path}; pass obj_path (run.py: "
            f"--obj PATH), e.g. {TORUS_OBJ}")
    mesh = load_obj(obj_path)
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
    add_mesh_to_renderer(r, mesh, mesh_mat, offset=(1.5, 1.0, 1.0))
    r.add_light(L.PointLight, position=(0.0, 1.0, -5.0),
                color=(0.9, 0.9, 0.9))
    r.set_camera_position((0.0, 1.0, -5.0))
    r.update_partitioning(partition_method)
    return r
