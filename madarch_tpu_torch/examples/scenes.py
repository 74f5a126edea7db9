"""The reference example scenes as Renderer builders (port of
madarch_tpu/examples/scenes.py: simple_scene, global_illumination,
light_shafts).  Each runs on the CUDA card unless a ``device`` keyword
says otherwise."""
from __future__ import annotations

import numpy as np

from madarch_tpu_torch.core.config import (NO_VOLUMETRICS,
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
