"""Port parity: madarch_tpu_torch/core/resample.py against
madarch_tpu/core/resample.py on tests/test_resample.py's cases, exactly
(a resample only moves values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madarch_tpu.core import resample as JR
from madarch_tpu_torch.core import resample as TR

# (source shape, axis, destination size, offset): tests/test_resample.py's
# periodic upsample and downsample and its inner-axis case
CASES = {
    "upsample": ((250, 7), 0, 800, 0.5),
    "downsample": ((100, 3), 0, 250, 0.0),
    "inner_axis": ((6, 100), 1, 250, 0.0),
    "shrink": ((250, 7), 0, 100, 0.5),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_resample_axis_matches_jax(name):
    shape, axis, dst, offset = CASES[name]
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = TR.resample_axis(torch.as_tensor(x), axis, dst, offset=offset)
    ref = JR.resample_axis(jnp.asarray(x), axis, dst, offset=offset)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    idx = TR.floor_map(dst, shape[axis], offset)
    np.testing.assert_array_equal(got.numpy(), np.take(x, idx, axis=axis))


def test_resample_axis_identity():
    x = torch.arange(16.0).reshape(4, 4)
    assert TR.resample_axis(x, 0, 4) is x


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("delta", [-2, -1, 0, 1, 2])
def test_shift_clamped_matches_jax(axis, delta):
    """out[i] = x[clip(i + delta, 0, n - 1)] along the axis, as JAX's."""
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    if axis == 1:
        x = np.ascontiguousarray(x.T)
    got = TR.shift_clamped(torch.as_tensor(x), axis, delta)
    ref = JR.shift_clamped(jnp.asarray(x), axis, delta)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    n = x.shape[axis]
    np.testing.assert_array_equal(
        got.numpy(), np.take(x, np.clip(np.arange(n) + delta, 0, n - 1),
                             axis=axis))
