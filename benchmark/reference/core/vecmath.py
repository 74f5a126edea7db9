"""Small vector-math helpers (port of madarch_tpu/core/vecmath.py).

Vectors are tensors with a trailing dimension of 3.  Three-term sums are
written out as x + y + z, in that order, so the plain PyTorch code, the
CUDA kernels and the JAX reference round alike.
"""
from __future__ import annotations

import torch

PI = 3.14159265358
PI_2 = 6.28318530718
# GLSL epsilon used as the hit threshold of the sphere tracer.
EPSILON = 1e-3


def dot(a, b):
    """Batched vec3 dot product -> scalar with the same leading dims."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def dot2(a):
    return dot(a, a)


def cross(a, b):
    """Batched vec3 cross product, component by component."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def absolute(x):
    """|x| with the JAX package's derivative, +1 at x = 0 (the JVP of
    jnp.abs is select(x >= 0, g, -g); torch.abs's derivative is sign(x), 0
    at 0).  The normal of an axis-aligned plane has exact zero components,
    and the differentiable shade differentiates |n| there (the octahedral
    lookup).  The value is |x| but for the sign of a zero."""
    return torch.where(x >= 0.0, x, -x)


def length(a):
    return torch.sqrt(torch.clamp_min(dot2(a), 1e-30))


def normalize(a):
    return a / length(a)[..., None]


def clamp(x, lo, hi):
    return torch.clamp(x, lo, hi)


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def mix(a, b, t):
    """GLSL mix == lerp."""
    return a + (b - a) * t


def reflect(d, n):
    """GLSL reflect: d - 2*dot(d,n)*n."""
    return d - 2.0 * dot(d, n)[..., None] * n


def vec3(x, y, z, device=None):
    parts = torch.broadcast_tensors(
        *(torch.as_tensor(v, dtype=torch.float32, device=device)
          for v in (x, y, z)))
    return torch.stack(parts, dim=-1)


def sign_not_zero(v):
    """+1 for >= 0, -1 otherwise."""
    return torch.where(v >= 0.0, 1.0, -1.0)
