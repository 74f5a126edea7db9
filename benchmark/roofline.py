"""The card's peaks and the least time a kernel's work could take (the
benchmark's own copies: the port's may change, these do not).

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): 67 TFLOP/s in float32 outside the tensor
cores, 3.35 TB/s of HBM.  A kernel's work is counted by the reference's
plain version (reference/ops/march.py: ``geometry.tally``): float
operations of its scene evaluations, exact pruning's box tests and the
box-exit cap's slab tests; each input byte read once and each output byte
written once.
"""
from __future__ import annotations

PEAK_FP32_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12


def bound(flops, n_bytes):
    """(ms, what bounds it): the least time the card could take."""
    t_ops = flops / PEAK_FP32_PER_S
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def launch_bound_ms(tally, rays):
    """The bound in ms of one geometry launch over ``rays`` rays, from a
    tally of the plain version over ``tally["rays"]`` of them (all, or a
    seeded subset whose count scales up)."""
    scale = rays / tally["rays"]
    n_bytes = rays * tally["per_ray"] + tally["fixed_bytes"]
    return bound(tally["flops"] * scale, n_bytes)[0]
