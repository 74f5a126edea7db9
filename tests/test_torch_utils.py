"""Port parity: small helpers of madarch_tpu_torch against madarch_tpu:
core/vecmath.py's saturate and io/image.py's write_ppm, exactly; and
utils/profiling.py: ``trace`` writes a TensorBoard trace file on the CPU
and ``FrameTimer`` refuses a device that is not a GPU
(``FrameTimer.time_fn`` is tested on the card in test_torch_cuda.py).
"""
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madarch_tpu.core import vecmath as JV
from madarch_tpu.io import image as JI
from madarch_tpu_torch.core import vecmath as TV
from madarch_tpu_torch.io import image as TI
from madarch_tpu_torch.utils import profiling as TPF


def test_saturate_matches_jax():
    rng = np.random.RandomState(1)
    x = (rng.randn(64, 3) * 2.0).astype(np.float32)
    x[:4] = [[0.0, 1.0, -0.0], [np.inf, -np.inf, 0.5], [1.0, 1e-8, -1e-8],
             [2.0, -2.0, 0.999]]
    got = TV.saturate(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(JV.saturate(
        jnp.asarray(x))))


@pytest.mark.parametrize("shape", [(16, 24, 3), (1, 1, 3)])
def test_write_ppm_writes_jaxs_bytes(tmp_path, shape):
    """The same bytes as the JAX package's writer, for a float image with
    values outside [0, 1] (clipped) and row 0 at the bottom (flipped)."""
    img = np.random.RandomState(2).uniform(-0.2, 1.2, shape) \
        .astype(np.float32)
    mine, theirs = tmp_path / "port.ppm", tmp_path / "jax.ppm"
    TI.write_ppm(str(mine), torch.as_tensor(img))
    JI.write_ppm(str(theirs), jnp.asarray(img))
    data = mine.read_bytes()
    assert data == theirs.read_bytes()
    h, w, _ = shape
    header = b"P6\n%d %d\n255\n" % (w, h)
    assert data.startswith(header) and len(data) == len(header) + h * w * 3


def test_trace_writes_a_trace_file(tmp_path):
    """trace(log_dir) profiles the block and writes one *.pt.trace.json
    there, whose events name the ops that ran."""
    with TPF.trace(str(tmp_path)) as log_dir:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert log_dir == str(tmp_path)
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_frame_timer_refuses_a_cpu():
    with pytest.raises(ValueError):
        TPF.FrameTimer("cpu")

