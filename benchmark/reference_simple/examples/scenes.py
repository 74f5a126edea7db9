"""The simple_scene configuration's scene builder (the port's
examples/scenes.py:simple_scene) on the default package's renderer.  It
runs on the CUDA card unless a ``device`` keyword says otherwise.

Departures from upstream's examples/simple_scene/main.adb:

- the numbers (the spheres' and boxes' places and sizes, the four
  materials, the light, the camera) are the JAX package's transcription
  of main.adb, which the port holds unchanged;
- upstream builds its default partitioning grid and updates it on the
  CPU (CPU_Best); this builder, like the port, builds none, and every
  march evaluates all 40 live slots, which gives the same distances;
- upstream's render loop and frame timer are the benchmark's traffic.
"""
from __future__ import annotations

from benchmark.reference.core.config import NO_VOLUMETRICS
from benchmark.reference.examples.scenes import _room
from benchmark.reference.render.renderer import Renderer
from benchmark.reference.scene import lights as L
from benchmark.reference.scene import primitives as P
from benchmark.reference.scene.scene import SceneSpec

# 20 spheres of radius 0.5: two rows of six at z = 2, one at z = 5 and
# two more at z = 5
SPHERE_CENTERS = ([(0.5 + i, 3.5, 2.0) for i in range(6)]
                  + [(0.5 + i, 0.5, 2.0) for i in range(6)]
                  + [(0.5 + i, 3.5, 5.0) for i in range(6)]
                  + [(0.5, 0.5, 5.0), (1.5, 0.5, 5.0)])
SPHERE_RADIUS = 0.5
# 14 boxes: (center, half-side)
BOXES = (((3.0, 1.0, 2.0), (0.5, 0.5, 0.5)),
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
         ((3.0, 1.0, -6.0), (0.5, 0.5, 0.5)))


def simple_scene(width=1000, height=1000, **kwargs) -> Renderer:
    """The room (black floor, ceiling and ends, red +x and blue -x walls,
    roughness 0.6) with 20 mirror spheres (albedo 0.1, metallic 0.9,
    roughness 0.1), 14 boxes of the blue wall's material, a white point
    light at (0, 3, 0) and the camera at (2, 2, 0): 40 live slots in
    three typed runs (capacities 20, 10, 20)."""
    spec = SceneSpec(prims=((P.Sphere, 20), (P.Plane, 10), (P.Box, 20)),
                     lights=((L.PointLight, 4),))
    r = Renderer(spec, width, height, volumetrics=NO_VOLUMETRICS, **kwargs)
    r.set_material(0, (0.0, 0.0, 0.0), 0.0, 0.6)
    r.set_material(1, (1.0, 0.0, 0.0), 0.0, 0.6)
    r.set_material(2, (0.0, 0.0, 1.0), 0.0, 0.6)
    r.set_material(3, (0.1, 0.1, 0.1), 0.9, 0.1)
    _room(r, (0, 1, 2))
    for c in SPHERE_CENTERS:
        r.add_primitive(P.Sphere, center=c, radius=SPHERE_RADIUS,
                        material_id=3)
    for c, s in BOXES:
        r.add_primitive(P.Box, center=c, side=s, material_id=2)
    r.add_light(L.PointLight, position=(0.0, 3.0, 0.0),
                color=(0.9, 0.9, 0.9))
    r.set_camera_position((2.0, 2.0, 0.0))
    return r
