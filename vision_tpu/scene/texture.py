"""Texture atlas: all scene images packed into one flat device array.

Replacement for the reference's bindless texture array
(`/root/reference/src/base/mgr/image_pool.h` + ocarina BindlessArray):
every image becomes rows of a single [N, 3] float32 array plus an integer
descriptor table. Bilinear sampling is
4 gathers + lerp, fully vectorized over lanes.
"""
from __future__ import annotations

import os

import numpy as np
import jax.numpy as jnp
from ..core import struct


def _srgb_to_linear(x):
    return np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def _optional(module, what):
    """Import PIL or cv2 for formats the stdlib readers do not cover."""
    import importlib
    try:
        return importlib.import_module(module)
    except ImportError as e:
        pkg = {"PIL": "Pillow", "cv2": "opencv-python"}[module]
        raise ImportError(f"reading {what} needs the '{pkg}' package "
                          f"(8-bit PNG and Radiance .hdr need nothing)") from e


def load_image(path, color_space="srgb"):
    """Load LDR/HDR image -> float32 RGB [H, W, 3], linearized."""
    from ..core import imageio
    ext = os.path.splitext(path)[1].lower()
    if ext == ".hdr":
        return imageio.read_hdr(path)
    if ext == ".exr":
        cv2 = _optional("cv2", "OpenEXR images")
        img = cv2.imread(path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
        if img is None:
            raise IOError(f"cannot load {path}")
        img = img.astype(np.float32)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        img = img[..., :3][..., ::-1]  # BGR -> RGB
        return np.ascontiguousarray(img)
    if ext == ".png":
        try:
            img = imageio.read_png(path)
        except ValueError:              # 16-bit or interlaced: use PIL
            img = None
    else:
        img = None
    if img is None:
        Image = _optional("PIL", f"'{ext}' images").Image
        img = np.asarray(Image.open(path).convert("RGB"))
    elif img.shape[-1] < 3:             # grey (+ alpha) -> RGB
        img = np.repeat(img[..., :1], 3, -1)
    img = img[..., :3].astype(np.float32) / 255.0
    if color_space == "srgb":
        img = _srgb_to_linear(img)
    return img.astype(np.float32)


class AtlasBuilder:
    """Host-side accumulation of textures; dedup by path."""

    def __init__(self):
        self.images = []      # list of np [H, W, 3]
        self.by_key = {}

    def add_image(self, path, color_space="srgb"):
        key = (os.path.abspath(path), color_space)
        if key in self.by_key:
            return self.by_key[key]
        img = load_image(path, color_space)
        idx = self.add_array(img)
        self.by_key[key] = idx
        return idx

    def add_array(self, img):
        img = np.ascontiguousarray(np.asarray(img, np.float32))
        key = ("arr", img.shape, hash(img.tobytes()))
        if key in self.by_key:
            return self.by_key[key]
        idx = len(self.images)
        self.images.append(img)
        self.by_key[key] = idx
        return idx

    def build(self):
        n_real = len(self.images)
        if not self.images:
            # one white dummy texel so shapes stay static
            self.images.append(np.ones((1, 1, 3), np.float32))
        offsets, widths, heights = [], [], []
        chunks = []
        off = 0
        for img in self.images:
            h, w = img.shape[:2]
            offsets.append(off)
            widths.append(w)
            heights.append(h)
            chunks.append(img.reshape(-1, 3))
            off += h * w
        data = np.concatenate(chunks, axis=0)
        return TextureAtlas(
            data=jnp.asarray(data),
            offset=jnp.asarray(offsets, jnp.int32),
            width=jnp.asarray(widths, jnp.int32),
            height=jnp.asarray(heights, jnp.int32),
            n_real=n_real,
        )


@struct.dataclass
class TextureAtlas:
    data: jnp.ndarray     # [N, 3] f32
    offset: jnp.ndarray   # [T] int32
    width: jnp.ndarray    # [T]
    height: jnp.ndarray   # [T]
    n_real: int = struct.field(pytree_node=False, default=0)

    @property
    def has_textures(self):
        return self.n_real > 0

    def sample(self, tex_id, uv):
        """Bilinear sample, repeat wrap. tex_id [...] int32, uv [..., 2].
        V flipped (image row 0 = top, uv v=0 = bottom, matching the
        reference image loader convention)."""
        tid = jnp.clip(tex_id, 0, self.offset.shape[0] - 1)
        w = self.width[tid]
        h = self.height[tid]
        off = self.offset[tid]
        u = uv[..., 0] - jnp.floor(uv[..., 0])
        v = uv[..., 1] - jnp.floor(uv[..., 1])
        v = 1.0 - v
        x = u * w.astype(jnp.float32) - 0.5
        y = v * h.astype(jnp.float32) - 0.5
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        fx = x - x0.astype(jnp.float32)
        fy = y - y0.astype(jnp.float32)

        def texel(xi, yi):
            xi = jnp.mod(xi, w)
            yi = jnp.mod(yi, h)
            return self.data[off + yi * w + xi]

        c00 = texel(x0, y0)
        c10 = texel(x0 + 1, y0)
        c01 = texel(x0, y0 + 1)
        c11 = texel(x0 + 1, y0 + 1)
        fx = fx[..., None]
        fy = fy[..., None]
        return (c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy)
                + c01 * (1 - fx) * fy + c11 * fx * fy)
