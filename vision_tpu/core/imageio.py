"""Image files with the standard library and numpy only.

  * write_png: 8-bit grey/grey+alpha/RGB/RGBA, no filtering, zlib-compressed.
  * read_png: 8-bit PNGs of any colour type (palette included), all five
    scanline filters, no interlacing.
  * read_hdr: Radiance RGBE (.hdr), flat or run-length encoded scanlines.

Other formats go through PIL or cv2 where installed (scene/texture.py).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # colour type -> samples/pixel


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path, img):
    """img: uint8 [H, W] or [H, W, C] with C in 1..4."""
    a = np.asarray(img, np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    # filter byte 0 (None) in front of every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)], 1)
    with open(path, "wb") as f:
        f.write(_PNG_SIG
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                              0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _unfilter_row(ftype, row, prior, bpp):
    if ftype == 0:
        return row
    if ftype == 1:      # Sub: running sum per channel, mod 256
        return (np.cumsum(row.reshape(-1, bpp), 0, dtype=np.int64)
                % 256).astype(np.uint8).reshape(-1)
    if ftype == 2:      # Up
        return row + prior
    out = bytearray(row.tobytes())
    up = prior.tobytes()
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        b = up[x]
        if ftype == 3:  # Average
            out[x] = (out[x] + ((a + b) >> 1)) & 0xFF
        else:           # Paeth
            c = up[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            out[x] = (out[x] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path):
    """8-bit PNG -> uint8 [H, W, C] (C = 1, 2, 3 or 4; palette -> RGB/RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIG):
        raise ValueError(f"not a PNG file: {path}")
    pos, idat, palette, trns = 8, [], None, None
    w = h = depth = color = interlace = None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB",
                                                                body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if depth != 8 or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced PNGs are read "
                         f"without PIL (bit depth {depth}, "
                         f"interlace {interlace})")
    bpp = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * bpp
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prior, bpp)
        out[y] = prior
    img = out.reshape(h, w, bpp)
    if color == 3:
        idx = img[..., 0]
        rgb = palette[idx]
        if trns is not None:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[:len(trns)] = trns
            return np.concatenate([rgb, alpha[idx][..., None]], -1)
        return rgb
    return img


def _rgbe_to_float(rgbe):
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def read_hdr(path):
    """Radiance RGBE (.hdr) -> float32 [H, W, 3]. Rows are stored top to
    bottom ('-Y H +X W', the layout every common writer uses)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while True:                      # header: lines up to a blank line
        end = data.index(b"\n", pos)
        line = data[pos:end].strip()
        pos = end + 1
        if not line:
            break
        if line.startswith(b"FORMAT=") and line != b"FORMAT=32-bit_rle_rgbe":
            raise ValueError(f"{path}: unsupported {line.decode()}")
    end = data.index(b"\n", pos)
    res = data[pos:end].split()
    pos = end + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported resolution line {res}")
    h, w = int(res[1]), int(res[3])
    buf = np.frombuffer(data, np.uint8)
    out = np.zeros((h, w, 4), np.uint8)
    for y in range(h):
        rle = (8 <= w < 32768 and buf[pos] == 2 and buf[pos + 1] == 2
               and (int(buf[pos + 2]) << 8 | int(buf[pos + 3])) == w)
        if not rle:                  # flat scanline
            out[y] = buf[pos:pos + 4 * w].reshape(w, 4)
            pos += 4 * w
            continue
        pos += 4
        for ch in range(4):
            x = 0
            while x < w:
                n = int(buf[pos])
                if n > 128:          # run of one value
                    n -= 128
                    out[y, x:x + n, ch] = buf[pos + 1]
                    pos += 2
                else:                # n literal values
                    out[y, x:x + n, ch] = buf[pos + 1:pos + 1 + n]
                    pos += 1 + n
                x += n
    return _rgbe_to_float(out)
