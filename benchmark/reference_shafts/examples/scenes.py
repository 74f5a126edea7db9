"""The light_shafts configuration's scene builder (the port's
examples/scenes.py:light_shafts) on the default package's renderer.  It
runs on the CUDA card unless a ``device`` keyword says otherwise."""
from __future__ import annotations

from benchmark.reference.core.config import VolumetricsSettings
from benchmark.reference.examples.scenes import _room
from benchmark.reference.render.renderer import Renderer
from benchmark.reference.scene import lights as L
from benchmark.reference.scene import primitives as P
from benchmark.reference.scene.scene import SceneSpec


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
