"""The package's entry: the whole of what the check
(``benchmark/check.py``) takes from a reference package, as ``__all__``
lists it.

- ``leaves(config)``, ``adopt(rr, state)``, ``frame(rr, data, camera,
  state, pixels, q)``: a view cell's frame (below);
- ``train``: a fit cell's step and its target images (train.py);
- ``config``: ProbeSettings, built from a configuration's ``probes``;
- ``examples(module)``: ``examples/<module>.py``, whose function a
  configuration's ``builder`` names;
- ``lights``: the light types that a traffic mix's edits name;
- ``march``: ``geometry.tally``, the geometry launches' work.

Another package's entry may start ``from benchmark.reference.entry
import *`` and define again only what differs (its frame, its
``examples``).  This package's frame is the radiance pass from the
state's atlases, the irradiance integration of the new radiance, the
shade of the sampled pixels' camera rays, and the Reinhard tonemap with
gamma.  It copies no volumetric pass: a scene with volumetrics raises
here.
"""
from __future__ import annotations

import importlib

import torch

from . import train
from .core import config
from .ops import march
from .render import pipeline as P
from .render import probes as probes_mod
from .render.camera import camera_rays, pixel_grid
from .render.shading import pixel_color
from .scene import lights
from .scene.scene import tree_map

__all__ = ["leaves", "adopt", "frame", "train", "config", "examples",
           "lights", "march"]


def examples(module):
    """This package's ``examples.<module>``."""
    return importlib.import_module(f"{__package__}.examples.{module}")


def leaves(config):
    """The names of the state leaves that a frame of ``config`` leaves,
    each compared with the program's leaf of that name: the two probe
    atlases (no scattering map without volumetrics)."""
    return ("radiance", "irradiance")


def adopt(rr, state):
    """This package's FrameState on ``rr``'s device from ``state``: None
    is the zero state; otherwise any object with the FrameState's leaves
    as attributes (the program's state, or one this package left, whose
    ``scattering`` None is the zero map)."""
    dev = rr.device
    zero = P.initial_state(rr.probes, rr.volumetrics, dev)
    if state is None:
        return zero
    scattering = state.scattering
    return P.FrameState(
        radiance=state.radiance.to(dev), irradiance=state.irradiance.to(dev),
        scattering=zero.scattering if scattering is None
        else scattering.to(dev))


def frame(rr, data, camera, state, pixels, q):
    """(colours f32[n, 3] of the tonemapped image at the flat pixel
    indices ``pixels``, the FrameState the frame leaves) of one frame of
    ``rr``'s scene with the scene data ``data`` and the camera ``camera``,
    from ``state`` (as ``adopt`` takes it).  Every input and every pass's
    output goes through ``q`` (the identity, or the control's rounding).
    The state left holds the new atlases and no scattering map (None)."""
    if rr.volumetrics.enabled or rr.screen_cfg.render_volumetrics:
        raise NotImplementedError("this reference package copies no "
                                  "volumetric pass")
    dev = rr.device
    state = tree_map(q, adopt(rr, state))
    data = tree_map(q, data)
    cam = P.Camera(position=q(camera.position),
                   orientation=q(camera.orientation))
    with torch.no_grad():
        rad = q(P.radiance_pass(rr.spec, data, rr.probes, rr.probe_cfg,
                                state.irradiance, state.radiance))
        irr = q(probes_mod.integrate_irradiance(rr.probes, rad))
        frag = pixel_grid(rr.width, rr.height, dev).reshape(-1, 2)
        frag = frag[torch.as_tensor(pixels, device=dev)]
        o, d = camera_rays(frag, cam.position, cam.orientation)
        c = pixel_color(rr.spec, data, rr.probes, rr.screen_cfg, irr, rad,
                        o, d)[0]
        c = torch.clamp_min(c, 0.0)
        c = q(((c + 1e-8) / (c + 1.0)) ** 0.4545)
    return c, P.FrameState(radiance=rad, irradiance=irr, scattering=None)
