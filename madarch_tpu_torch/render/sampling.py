"""Random direction sampling for the Monte-Carlo render modes (port of
madarch_tpu/render/sampling.py).

Each sampler is split in two: a deterministic transform from uniforms in
[0, 1) to directions (``sphere_point``, ``hemisphere_point``,
``cosine_point``), and the draw, which takes a ``torch.Generator`` where
the JAX package takes a threefry key.  A draw runs on the generator's
device (the device's default generator when None) and lands on the
device the caller names, so one CPU generator gives the card and the CPU
the same numbers.  A sampler draws its uniforms in a fixed order: the
angle's, then the height's (``cosine_direction``: u, then the angle's),
as the JAX package splits its key.
"""
from __future__ import annotations

import torch

from madarch_tpu_torch.core.vecmath import PI_2, dot, normalize


def uniform(generator, shape, device):
    """f32 uniforms in [0, 1) of ``shape`` on ``device``, drawn from
    ``generator`` on its own device."""
    src = device if generator is None else generator.device
    return torch.rand(shape, generator=generator, device=src).to(device)


def sphere_point(u1, u2):
    """Uniform on S² from two uniforms: angle 2π·u1, height 2·u2 − 1."""
    ang = u1 * PI_2
    u = u2 * 2.0 - 1.0
    s = torch.sqrt(torch.clamp_min(1.0 - u * u, 0.0))
    return torch.stack([s * torch.cos(ang), s * torch.sin(ang), u], dim=-1)


def hemisphere_point(u1, u2, normal):
    """The sphere point mirrored to the normal's side (a point on the
    tangent plane, sign 0, stays)."""
    v = sphere_point(u1, u2)
    s = torch.sign(dot(v, normal))
    s = torch.where(s == 0.0, 1.0, s)
    return v * s[..., None]


def cosine_point(u, v, normal):
    """Cosine-weighted about the normal from two uniforms (the iq
    branchless basis; 1 + z is held off 0 by 1e-6 at n = −z)."""
    nor = normal
    z = nor[..., 2]
    denom = 1.0 + torch.where(torch.abs(1.0 + z) < 1e-6, 1e-6, z)
    tc_x = 1.0 + z - nor[..., 0] * nor[..., 0] / denom
    tc_y = 1.0 + z - nor[..., 1] * nor[..., 1] / denom
    tc_z = -nor[..., 0] * nor[..., 1] / denom
    uu = torch.stack([tc_x, tc_z, -nor[..., 0]], dim=-1)
    vv = torch.stack([tc_z, tc_y, -nor[..., 1]], dim=-1)
    a = PI_2 * v
    d = (torch.sqrt(u)[..., None]
         * (torch.cos(a)[..., None] * uu + torch.sin(a)[..., None] * vv)
         + torch.sqrt(1.0 - u)[..., None] * nor)
    return normalize(d)


def random_sphere_point(generator, shape, device):
    """Uniform on S², f32[*shape, 3]."""
    u1 = uniform(generator, shape, device)
    return sphere_point(u1, uniform(generator, shape, device))


def random_hemisphere_point(generator, normal):
    """Uniform on the hemisphere around each normal f32[..., 3]."""
    shape, dev = normal.shape[:-1], normal.device
    u1 = uniform(generator, shape, dev)
    return hemisphere_point(u1, uniform(generator, shape, dev), normal)


def cosine_direction(generator, normal):
    """Cosine-weighted about each normal f32[..., 3]."""
    shape, dev = normal.shape[:-1], normal.device
    u = uniform(generator, shape, dev)
    return cosine_point(u, uniform(generator, shape, dev), normal)


def uniform_vector(generator, shape, device):
    """The perturbation vector of the specular lobes: a uniform sphere
    point (the reference samples angles uniformly; the JAX package, and so
    the port, takes the true uniform sphere sample)."""
    return random_sphere_point(generator, shape, device)
