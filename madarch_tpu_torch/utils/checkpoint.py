"""Checkpoint and resume of scene data, probe feedback state and camera
(port of madarch_tpu/utils/checkpoint.py).

A checkpoint is a flat .npz of leaves, one entry per tensor named
``<tree name>|<key path>``, plus an ``__meta__`` entry holding the JSON of
{tree name: sorted key paths}.  The key paths are the JAX package's own
strings (``"/".join(str(k) for k in path)`` of jax's key paths:
``.prims/['sphere']/['center']``, ``.radiance``), so a file either package
saves loads into the other.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from madarch_tpu_torch.scene.scene import tree_map


def key_paths(tree, path=()):
    """[(key path string, tensor leaf)] of a nest of dataclasses, dicts
    and tensors in jax.tree.flatten's order: dataclass fields in
    declaration order as ``.name``, dict keys sorted as ``['key']``, None
    holding no leaf."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [("/".join(path), tree)]
    if isinstance(tree, dict):
        children = [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    else:
        children = [(f".{f.name}", getattr(tree, f.name))
                    for f in dataclasses.fields(tree)]
    return [item for key, child in children
            for item in key_paths(child, path + (key,))]


def save(path: str, **trees):
    """save('ckpt.npz', scene=data, state=frame_state, camera=camera)."""
    payload = {}
    meta = {}
    for name, tree in trees.items():
        leaves = {k: v.detach().cpu().numpy() for k, v in key_paths(tree)}
        meta[name] = sorted(leaves)
        for k, v in leaves.items():
            payload[f"{name}|{k}"] = v
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                        dtype=np.uint8)
    np.savez(path, **payload)


def load(path: str, device=None, **templates):
    """load('ckpt.npz', scene=template_data, ...) -> {name: restored tree}.

    Each template gives a tree's structure and its leaves' dtypes (a
    scene's ``SceneBuilder(spec).device_data(...)``, ``initial_state``);
    each leaf is read by its key path and put on ``device``, or on the
    template leaf's device when None."""
    archive = np.load(path, allow_pickle=False)
    out = {}
    for name, template in templates.items():
        leaves = []
        for key, leaf in key_paths(template):
            stored = archive[f"{name}|{key}"]
            dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
            leaves.append(torch.as_tensor(stored.astype(dtype)).to(
                leaf.device if device is None else device))
        it = iter(leaves)
        out[name] = tree_map(lambda _: next(it), template)
    return out
