"""Dependency-free helpers: the struct dataclass pytree, the stdlib PNG
writer/reader, the Radiance .hdr reader, texture loading, and where the
package puts JAX's persistent compilation cache."""
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from vision_tpu.core import imageio, struct

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@struct.dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray = None
    n: int = struct.field(pytree_node=False, default=3)


def test_struct_dataclass_is_a_frozen_pytree():
    p = _Pair(a=jnp.ones(2), b=jnp.zeros(3), n=5)
    leaves, tree = jax.tree.flatten(p)
    assert len(leaves) == 2                     # n is static metadata
    q = jax.tree.unflatten(tree, [x + 1 for x in leaves])
    assert q.n == 5 and float(q.b.sum()) == 3.0
    r = p.replace(n=7)
    assert r.n == 7 and p.n == 5
    with pytest.raises(Exception):
        p.n = 1                                  # frozen

    # static fields key the jit cache; None children are empty subtrees
    @jax.jit
    def f(x):
        return x.a * x.n
    np.testing.assert_allclose(f(p), 5.0)
    np.testing.assert_allclose(f(r), 7.0)
    assert jax.tree.leaves(_Pair(a=jnp.ones(1))) == [jnp.ones(1)]


@pytest.mark.parametrize("shape", [(13, 17, 3), (9, 4, 4), (5, 7), (6, 3, 2)])
def test_png_roundtrip(tmp_path, shape):
    a = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "a.png")
    imageio.write_png(path, a)
    b = imageio.read_png(path)
    np.testing.assert_array_equal(b.reshape(a.shape), a)


def _png_with_filters(path, img, filters):
    """Hand-encode an RGB PNG with the given per-row filter types, so the
    reader's Sub/Up/Average/Paeth reconstruction is exercised."""
    import struct as st
    h, w, bpp = img.shape
    x = img.astype(np.int64)
    raw = b""
    for y in range(h):
        ft = filters[y % len(filters)]
        prior = x[y - 1].reshape(-1) if y else np.zeros(w * bpp, np.int64)
        row = x[y].reshape(-1)
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ft == 0:
            pred = np.zeros_like(row)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prior
        elif ft == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, ul))
        raw += bytes([ft]) + ((row - pred) % 256).astype(np.uint8).tobytes()

    def chunk(tag, data):
        return (st.pack(">I", len(data)) + tag + data
                + st.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", st.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_png_reader_undoes_every_filter(tmp_path):
    y, x = np.mgrid[0:11, 0:19]
    img = np.stack([x * 13 % 256, y * 29 % 256, (x * y) % 256], -1)
    path = str(tmp_path / "f.png")
    _png_with_filters(path, img.astype(np.uint8), [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(imageio.read_png(path), img)


def _rgbe(rgb):
    m = rgb.max(-1)
    e = np.where(m > 1e-32, np.floor(np.log2(np.maximum(m, 1e-32))) + 1, 0)
    scale = np.where(m > 1e-32, 256.0 / np.exp2(e), 0.0)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.floor(rgb * scale[..., None]).clip(0, 255)
    out[..., 3] = np.where(m > 1e-32, e + 128, 0)
    return out


@pytest.mark.parametrize("rle", [False, True])
def test_hdr_reader(tmp_path, rle):
    rs = np.random.RandomState(2)
    h, w = 5, 12
    rgb = (rs.rand(h, w, 3) * 8).astype(np.float32)
    rgb[:, 3:9] = rgb[:, 3:4]                    # runs for the RLE encoder
    q = _rgbe(rgb)
    body = b""
    for y in range(h):
        if not rle:
            body += q[y].tobytes()
            continue
        body += bytes([2, 2, w >> 8, w & 255])
        for ch in range(4):
            v = q[y, :, ch]
            x = 0
            while x < w:                         # runs of equal bytes
                n = 1
                while x + n < w and v[x + n] == v[x] and n < 127:
                    n += 1
                if n > 2:
                    body += bytes([128 + n, v[x]])
                else:
                    body += bytes([n]) + v[x:x + n].tobytes()
                x += n
    path = str(tmp_path / "e.hdr")
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
                + f"-Y {h} +X {w}\n".encode() + body)
    got = imageio.read_hdr(path)
    assert got.shape == (h, w, 3) and got.dtype == np.float32
    # RGBE keeps 8 mantissa bits of the largest channel
    np.testing.assert_allclose(got, rgb, atol=rgb.max() / 128)


def test_texture_png_is_linearized(tmp_path):
    from vision_tpu.scene.texture import load_image
    img = np.array([[[0, 128, 255], [255, 255, 255]]], np.uint8)
    path = str(tmp_path / "t.png")
    imageio.write_png(path, img)
    lin = load_image(path, "srgb")
    np.testing.assert_allclose(lin[0, 0], [0.0, 0.2158605, 1.0], rtol=1e-5)
    raw = load_image(path, "linear")
    np.testing.assert_allclose(raw[0, 0], [0.0, 128 / 255, 1.0], rtol=1e-6)


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_placement(tmp_path, env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT
    want = os.path.join(ROOT, ".jax_cache")
    if env_dir is not None:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c", "import vision_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        check=True, timeout=300).stdout.strip().splitlines()[-1]
    assert out == want
