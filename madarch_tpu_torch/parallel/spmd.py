"""The differentiable-rendering train step on one device (port of
madarch_tpu/parallel/spmd.py's make_train_step, split_float_leaves and
merge_float_leaves; make_value_and_grad is the step without its update).

The JAX package shards the step's rays over a device mesh and all-reduces
the gradients; the port runs it on one device, with no mesh argument and
no all-reduce.  The loss is the mean squared error between the rendered
frame and a target image, its gradient is taken with respect to every
float leaf of the scene data (primitive fields, materials, lights), and
the update is plain SGD.  The marches run in the kernels as in any frame;
gradients re-enter through the implicit-function-theorem hit distance and
the autodiff normals (render/shading.py).
"""
from __future__ import annotations

import dataclasses

import torch

from madarch_tpu_torch.core.config import (PROBE_SHADE_CONFIG,
                                           ProbeSettings, ShadeConfig,
                                           VolumetricsSettings,
                                           screen_shade_config)
from madarch_tpu_torch.render.pipeline import render_frame
from madarch_tpu_torch.scene.scene import SceneSpec, tree_leaves, tree_map


def split_float_leaves(tree):
    """(float leaves, aux): the leaves to differentiate, in tree_leaves'
    order, and what merge_float_leaves needs to put them back."""
    leaves = tree_leaves(tree)
    is_f = tuple(leaf.is_floating_point() for leaf in leaves)
    floats = [leaf for leaf, f in zip(leaves, is_f) if f]
    return floats, (tree, leaves, is_f)


def merge_float_leaves(aux, floats):
    """The tree of ``aux`` with its float leaves replaced by ``floats``
    (in order) and its other leaves as they were."""
    tree, leaves, is_f = aux
    new = iter(floats)
    merged = iter([next(new) if f else leaf
                   for leaf, f in zip(leaves, is_f)])
    return tree_map(lambda _: next(merged), tree)


def make_value_and_grad(spec: SceneSpec, probes: ProbeSettings,
                        vol: VolumetricsSettings, width: int, height: int,
                        screen_cfg: ShadeConfig = None,
                        probe_cfg: ShadeConfig = PROBE_SHADE_CONFIG):
    """The train step's loss and gradient: fn(data, camera, state, target)
    -> (loss, grads, new state).  Both passes render differentiable;
    ``target`` is an f32[H, W, 3] image on the data's device; the loss is
    mean((image − target)²), detached; grads holds d loss / d leaf for
    every float leaf of data in split_float_leaves' order (zeros for a
    leaf the frame does not reach); the new state is the frame's detached
    feedback."""
    if screen_cfg is None:
        screen_cfg = screen_shade_config(vol.enabled)
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
            loss = torch.mean((image - target) ** 2)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return loss.detach(), grads, new_state

    return value_and_grad


def make_train_step(spec: SceneSpec, probes: ProbeSettings,
                    vol: VolumetricsSettings, width: int, height: int,
                    lr: float = 0.01, screen_cfg: ShadeConfig = None,
                    probe_cfg: ShadeConfig = PROBE_SHADE_CONFIG):
    """The train step: step(data, camera, state, target) -> (loss, new
    data, new state), make_value_and_grad's loss and state with new data
    holding the updated float leaves p − lr·g and the integer leaves as
    they were."""
    value_and_grad = make_value_and_grad(spec, probes, vol, width, height,
                                         screen_cfg, probe_cfg)

    def step(data, camera, state, target):
        loss, grads, new_state = value_and_grad(data, camera, state, target)
        floats, aux = split_float_leaves(data)
        with torch.no_grad():
            new = [p - lr * g for p, g in zip(floats, grads)]
        return loss, merge_float_leaves(aux, new), new_state

    return step
