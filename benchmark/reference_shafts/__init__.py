"""The plain reference of the light_shafts configuration: the default
package's frame (``benchmark/reference``: radiance pass, irradiance
integration, the shade of the sampled pixels, the tonemap) with the
port's volumetric passes in plain float32 torch between them and the
depth-aware composite on the sampled pixels.  No kernel, no compiled
frame, nothing of the port.

- ``volumetrics.py``: the froxel visibility grid over the plain
  visibility march, the scattering integration over the plain raycast
  (both over the packed scene, each ended at the rays' box-exit caps, as
  the port's ``ops/march.py:visibility_reference`` and
  ``raycast_reference`` are), and the composite of the sampled pixels;
- ``examples/scenes.py``: the ``light_shafts`` builder on the default
  package's renderer;
- ``entry.py``: the default package's entry with ``leaves`` (the two
  atlases and ``scattering``), ``frame`` and ``examples`` defined again.

Departures from the port's plain path (its CPU frame, the kernels' plain
versions): none.  The composite reads, for each sampled pixel, the texel
that the port's ``render/volumetrics.py:_center_map`` gives its column
and row (the same float32 arithmetic), and the ray length is |hit_pos −
origin|, as the port's screen pass takes it; the other pixels of the
frame are not shaded.
"""
