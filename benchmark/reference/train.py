"""The train step's plain version (a frozen copy of madarch_tpu_torch's
parallel/spmd.py make_value_and_grad and its SGD update, on one
device): the loss mean((image − target)²) of a differentiable frame, the
gradient of every float leaf of the scene data, the new feedback state,
and p − lr·g; and ``render_targets``, the fit cell's target images.  A
fit cell's check calls these, with ``tree_map``."""
from __future__ import annotations

import dataclasses

import torch

from .render import probes as probes_mod
from .render.pipeline import radiance_pass, render_frame, screen_pass
from .scene.scene import tree_leaves, tree_map


def split_float_leaves(tree):
    """(float leaves, aux): the leaves to differentiate, in tree_leaves'
    order, and what merge_float_leaves needs to put them back."""
    leaves = tree_leaves(tree)
    is_f = tuple(leaf.is_floating_point() for leaf in leaves)
    floats = [leaf for leaf, f in zip(leaves, is_f) if f]
    return floats, (tree, leaves, is_f)


def merge_float_leaves(aux, floats):
    """The tree of ``aux`` with its float leaves replaced by ``floats``."""
    tree, leaves, is_f = aux
    new = iter(floats)
    merged = iter([next(new) if f else leaf
                   for leaf, f in zip(leaves, is_f)])
    return tree_map(lambda _: next(merged), tree)


def make_value_and_grad(spec, probes, vol, width, height, screen_cfg,
                        probe_cfg, rows=None):
    """fn(data, camera, state, target) -> (loss, grads, new state), both
    passes rendered differentiable; ``rows`` (for a planted fault) takes
    the loss over the image's first rows only."""
    screen_cfg = dataclasses.replace(screen_cfg, differentiable=True)
    probe_cfg = dataclasses.replace(probe_cfg, differentiable=True)

    def value_and_grad(data, camera, state, target):
        floats, aux = split_float_leaves(data)
        params = [p.detach().requires_grad_(True) for p in floats]
        with torch.enable_grad():
            image, new_state = render_frame(
                spec, probes, vol, width, height,
                merge_float_leaves(aux, params), camera, state,
                screen_cfg=screen_cfg, probe_cfg=probe_cfg)
            loss = torch.mean((image[:rows] - target[:rows]) ** 2)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return loss.detach(), grads, new_state

    return value_and_grad


def sgd_update(floats, grads, lr):
    """p − lr·g for each float leaf."""
    with torch.no_grad():
        return [p - lr * g for p, g in zip(floats, grads)]


def render_targets(rr, views):
    """The target images f32[H, W, 3] of ``rr``'s scene (its materials and
    lights as the check set them), one per (position, orientation) of
    ``views``: one radiance pass from the zero state, then the screen
    pass of each view."""
    data, state = rr.scene_data, rr.state
    targets = []
    with torch.no_grad():
        rad = radiance_pass(rr.spec, data, rr.probes, rr.probe_cfg,
                            state.irradiance, state.radiance)
        irr = probes_mod.integrate_irradiance(rr.probes, rad)
        for position, orientation in views:
            rr.set_camera_position(position)
            rr.set_camera_orientation(orientation)
            targets.append(screen_pass(
                rr.spec, data, rr.probes, rr.volumetrics, rr.screen_cfg,
                rr.width, rr.height, rr.camera, irr, rad,
                state.scattering).contiguous())
    return targets
