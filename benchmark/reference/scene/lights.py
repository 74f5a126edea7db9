"""Light types: point and spot lights (port of madarch_tpu/scene/lights.py).

``sample(params, pos, normal)`` returns (radiance, direction-to-light,
distance) for shading points ``pos[..., 3]``: the point light is
``color / (d² · 0.03)`` uncapped, the spot light caps its attenuation at
1.5 and applies the cone falloff.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..core import vecmath as vm
from ..scene.primitives import FLOAT, VEC3


@dataclasses.dataclass(frozen=True, eq=False)
class LightType:
    """A light *type*: schema + sampling function (identity hash/eq)."""

    name: str
    fields: tuple
    sample: Callable      # (params, pos, normal) -> (radiance, dir, dist)
    # params -> f32[3], the light's position; the marches read the vec3
    # 'position' field (ops/march.py:pack_light_positions), not this
    position: Optional[Callable] = None


def _position(params):
    return params["position"]


def _to_light(params, pos):
    to_l = params["position"] - pos
    dist = vm.length(to_l)
    return to_l / dist[..., None], dist


def _point_sample(params, pos, normal):
    ldir, dist = _to_light(params, pos)
    attenuation = 1.0 / (dist * dist * 0.03)
    radiance = params["color"] * attenuation[..., None]
    return radiance, ldir, dist


PointLight = LightType(
    name="point_light",
    fields=(("position", VEC3), ("color", VEC3)),
    sample=_point_sample,
    position=_position,
)


def _spot_sample(params, pos, normal):
    ldir, dist = _to_light(params, pos)
    attenuation = 1.0 / (dist * dist * 0.03)
    cos_theta = torch.clamp_min(vm.dot(-ldir, params["direction"]), 0.0)
    theta = torch.arccos(torch.clamp(cos_theta, -1.0, 1.0))
    ratio = vm.clamp(theta / params["aperture"], 0.0, 1.0)
    visible = 1.0 - ratio ** 8.0
    radiance = (params["color"]
                * (torch.clamp_max(attenuation, 1.5) * visible)[..., None])
    return radiance, ldir, dist


SpotLight = LightType(
    name="spot_light",
    fields=(("position", VEC3), ("direction", VEC3), ("aperture", FLOAT),
            ("color", VEC3)),
    sample=_spot_sample,
    position=_position,
)
