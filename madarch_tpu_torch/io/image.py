"""Image export (port of madarch_tpu/io/image.py).  Frames are f32[H, W, 3]
in [0, 1] with row 0 at the *bottom*; the writers flip to top-down file
order."""
from __future__ import annotations

import numpy as np


def to_uint8(img) -> np.ndarray:
    arr = np.asarray(img)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img) -> None:
    from PIL import Image
    Image.fromarray(to_uint8(img)[::-1]).save(path)


def write_ppm(path: str, img) -> None:
    """The writer with no dependencies: binary PPM (P6)."""
    arr = to_uint8(img)[::-1]
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(arr.tobytes())
