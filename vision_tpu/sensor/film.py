"""Film / frame-buffer post: accumulate, tonemap, gamma, PNG/EXR output.

Parity targets: `/root/reference/src/base/sensor/frame_buffer.cpp`
(accumulate lerp(1/(n+1)), exposure, gamma = linear_to_srgb) and
`render_core/tonemapper/impl.cpp` (linear / ACES Narkowicz / Reinhard).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def accumulate(accum_prev, frame_value, frame_index):
    """Running average: lerp(1/(n+1), prev, new) (frame_buffer.cpp:117-126)."""
    a = 1.0 / (frame_index + 1.0)
    return accum_prev + (frame_value - accum_prev) * a


def tonemap(x, mode="linear", exposure=1.0):
    x = x * exposure
    if mode == "aces":
        a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
        return jnp.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)
    if mode == "reinhard":
        return x / (x + 1.0)
    return x


def linear_to_srgb(x):
    x = jnp.clip(x, 0.0, 1.0)
    return jnp.where(x <= 0.0031308, x * 12.92,
                     1.055 * jnp.power(jnp.maximum(x, 1e-8), 1.0 / 2.4) - 0.055)


def to_png(img, path):
    """Display image in [0, 1] -> 8-bit PNG."""
    from ..core.imageio import write_png
    arr = np.asarray(img)
    write_png(path, np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8))


def to_exr(img, path):
    from ..scene.texture import _optional
    cv2 = _optional("cv2", "OpenEXR output")
    arr = np.asarray(img, np.float32)[..., ::-1]  # RGB -> BGR
    cv2.imwrite(path, arr)
