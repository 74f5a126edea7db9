"""The package's entry: the default package's (benchmark/reference/
entry.py lists what the check takes), with ``leaves``, ``frame`` and
``examples`` defined again for a scene with volumetrics.

The frame is the default's radiance pass from the state's atlases and the
irradiance integration of the new radiance, then the volumetric passes
(volumetrics.py: the froxel visibility grid and the scattering map for
this frame's pose, over the scene packed once), the shade of the sampled
pixels' camera rays (the default package's geometry launch), the
depth-aware composite of those pixels over the new scattering map, and
the Reinhard tonemap with gamma.  The march kernels' plain versions go
through volumetrics.py's own functions: ``march.geometry`` is called
twice a frame, for the radiance pass and for the screen.
"""
from __future__ import annotations

import importlib

import torch

from benchmark.reference.entry import *  # noqa: F401,F403
from benchmark.reference.entry import P, adopt, march, probes_mod
from benchmark.reference.render.camera import camera_rays, pixel_grid
from benchmark.reference.render.shading import pixel_color
from benchmark.reference.scene.scene import tree_map

from . import volumetrics as V

__all__ = ["leaves", "adopt", "frame", "train", "config", "examples",
           "lights", "march"]


def examples(module):
    """This package's ``examples.<module>``."""
    return importlib.import_module(f"{__package__}.examples.{module}")


def leaves(config):
    """The state leaves a frame leaves, each compared with the program's
    leaf of that name: the two probe atlases and the scattering map."""
    return ("radiance", "irradiance", "scattering")


def frame(rr, data, camera, state, pixels, q):
    """(colours f32[n, 3] of the tonemapped image at the flat pixel
    indices ``pixels``, the FrameState the frame leaves) of one frame of
    ``rr``'s scene with the scene data ``data`` and the camera ``camera``,
    from ``state`` (as ``adopt`` takes it).  Every input and every pass's
    output goes through ``q`` (the identity, or the control's rounding).
    The state left holds the new atlases and this frame's scattering map
    (the state's own where the scene has no volumetric passes)."""
    dev = rr.device
    vol, cfg = rr.volumetrics, rr.screen_cfg
    state = tree_map(q, adopt(rr, state))
    data = tree_map(q, data)
    cam = P.Camera(position=q(camera.position),
                   orientation=q(camera.orientation))
    with torch.no_grad():
        rad = q(P.radiance_pass(rr.spec, data, rr.probes, rr.probe_cfg,
                                state.irradiance, state.radiance))
        irr = q(probes_mod.integrate_irradiance(rr.probes, rad))
        scattering = state.scattering
        if vol.enabled:
            packed = march.pack_scene(rr.spec, data)
            grid = q(V.visibility_pass(
                rr.spec, data, vol, packed, cam.position, cam.orientation,
                max_steps=cfg.max_march_steps))
            scattering = q(V.scattering_pass(
                vol, packed, grid, cam.position, cam.orientation,
                max_steps=cfg.max_march_steps))
        frag = pixel_grid(rr.width, rr.height, dev).reshape(-1, 2)
        frag = frag[torch.as_tensor(pixels, device=dev)]
        o, d = camera_rays(frag, cam.position, cam.orientation)
        c, _, hit_pos = pixel_color(rr.spec, data, rr.probes, cfg, irr, rad,
                                    o, d)
        if cfg.render_volumetrics:
            ray_len = torch.linalg.vector_norm(hit_pos - o, dim=-1)
            c = q(V.composite(vol, scattering, c, ray_len, pixels, rr.width,
                              rr.height, rr.spec.max_dist))
        c = torch.clamp_min(c, 0.0)
        c = q(((c + 1e-8) / (c + 1.0)) ** 0.4545)
    return c, P.FrameState(radiance=rad, irradiance=irr,
                           scattering=scattering)
