"""The package's entry: the default package's (benchmark/reference/
entry.py lists what the check takes), with ``examples`` defined again so
that a configuration's ``builder`` finds this package's simple_scene.
The frame, its leaves and the geometry launches' tally are the
default's: the radiance pass and the screen, each one launch of the
default package's ``march.geometry`` over every live slot."""
from __future__ import annotations

import importlib

from benchmark.reference.entry import *  # noqa: F401,F403

__all__ = ["leaves", "adopt", "frame", "train", "config", "examples",
           "lights", "march"]


def examples(module):
    """This package's ``examples.<module>``."""
    return importlib.import_module(f"{__package__}.examples.{module}")
