"""The benchmark's default plain reference: a frozen copy of
madarch_tpu_torch's plain path (scene building, packing, the plain
versions of the four march kernels, the shade, the probes and the frame
pipeline), its imports relative within the package.  It imports nothing
of the port: the port may change under later benchmarks, this copy does
not.  Every march runs its plain PyTorch version, on the CPU or on the
card.

A configuration names its reference package by its ``reference`` key
(this one without it).  The check takes from a package only what its
``entry.py`` exports (this package's lists it): a view cell's frame, a
fit cell's train step and targets, ProbeSettings, the builders of
``examples/<module>.py`` (a configuration's ``builder`` is ``function``
of ``examples/scenes.py`` or ``module.function``), the light types and
the geometry launches' tally.  Another package is a directory of its own
under ``benchmark/``, found in the checkout the cell is loaded from: a
copy of this one changed where it must, or a few modules whose
``entry.py`` starts ``from benchmark.reference.entry import *`` and
defines again what differs.  A configuration's ``renderer`` object sets
fields of the built renderer's ``screen_cfg`` on both sides
(cells.apply_settings).  This package renders no volumetrics and no
specular modes 1 and 3: those raise inside it."""
