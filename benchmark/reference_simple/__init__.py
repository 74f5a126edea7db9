"""The plain reference of the simple_scene configuration: the default
package's frame (``benchmark/reference``: radiance pass, irradiance
integration, the shade of the sampled pixels, the tonemap) over the
simple_scene room, built by this package's own builder.  No kernel, no
compiled frame, nothing of the port.

- ``examples/scenes.py``: the ``simple_scene`` builder on the default
  package's renderer;
- ``entry.py``: the default package's entry with ``examples`` defined
  again.

The scene has no volumetrics, so the default ``leaves`` (the two probe
atlases) and ``frame`` stand.  Departures from the port's plain path:
none.  Departures from upstream's examples/simple_scene/main.adb are
listed in examples/scenes.py's docstring.
"""
import torch

# float32 matmuls in float32 on the card, not TF32 (the harness sets the
# same before the check; the camera rays are a [n, 3] @ [3, 3] matmul)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
