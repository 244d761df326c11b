"""PNG reading and writing with numpy and ``zlib``.

The dataset's images are PNG files. The port reads and writes them without
PIL, which the GPU host lacks. The reader takes 8-bit, non-interlaced gray
(``L``), gray + alpha, RGB and RGBA images with any of the five row filters
(PIL's writer picks a filter per row). It returns the array PIL's
``np.asarray(Image.open(path))`` gives: (H, W) for gray, (H, W, C)
otherwise. The writer stores 8-bit gray, gray + alpha, RGB or RGBA rows
with filter 0, deflated at zlib level 6 unless the caller gives another
(the training patch sets, rewritten every few epochs, use 1, as the JAX
package does). Palette, 16-bit and interlaced PNGs are refused with their
format named.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("png: truncated chunk")
        if zlib.crc32(kind + body) != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"png: bad CRC in chunk {kind!r}")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return


def unfilter(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the row filters: ``raw`` (H, W, bpp) uint8 filtered samples,
    ``ftype`` (H,) filter types -> (H, W, bpp) uint8.

    Sub, Average and Paeth depend on the pixel to the left and the rows
    above, so the pixels are reconstructed one anti-diagonal ``r + c`` at a
    time, each diagonal in one vectorised step."""
    if ftype.size and int(ftype.max()) > 4:
        raise ValueError(f"png: unknown filter type {int(ftype.max())}")
    if not ftype.any():
        return raw.copy()
    h, w, bpp = raw.shape
    # one zero row above and one zero pixel left of the image
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    raw = raw.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        c = d - r
        a = out[r + 1, c]        # left
        b = out[r, c + 1]        # up
        ul = out[r, c]           # up-left
        t = ftype[r][:, None]
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, c + 1] = (raw[r, c] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def png_header(path: str) -> tuple:
    """(height, width, samples per pixel) from a PNG's header, without
    decoding it."""
    with open(path, "rb") as f:
        head = f.read(len(_SIGNATURE) + 18)
    if not head.startswith(_SIGNATURE) or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    color = head[25]
    if color not in _CHANNELS:
        raise ValueError(f"{path}: color type {color} is not read")
    return h, w, _CHANNELS[color]


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        kind = ", ".join(k for k, bad in (
            ("palette", color == 3), (f"bit depth {depth}", depth != 8),
            ("interlaced", interlace != 0)) if bad) or f"color type {color}"
        raise ValueError(
            f"{path}: a {kind} PNG; only 8-bit non-interlaced gray, gray + "
            f"alpha, RGB and RGBA PNGs are read (bit depth {depth}, color "
            f"type {color}, interlace {interlace})")
    bpp = _CHANNELS[color]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * bpp)
    pixels = unfilter(rows[:, 1:].reshape(h, w, bpp), rows[:, 0])
    return pixels[..., 0] if bpp == 1 else pixels


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path: str, image: np.ndarray, level: int = 6) -> None:
    """Write an (H, W) gray or (H, W, C) uint8 array (C = 1 gray, 2 gray +
    alpha, 3 RGB, 4 RGBA), deflated at zlib ``level``."""
    image = np.asarray(image)
    bpp = 1 if image.ndim == 2 else (image.shape[2] if image.ndim == 3
                                     else 0)
    if image.dtype != np.uint8 or bpp not in _COLOR_TYPE:
        raise ValueError(f"png: write takes (H, W) or (H, W, 1-4) uint8, "
                         f"got {image.shape} {image.dtype}")
    h, w = image.shape[:2]
    rows = np.zeros((h, 1 + w * bpp), np.uint8)  # filter 0 per row
    rows[:, 1:] = image.reshape(h, -1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                               _COLOR_TYPE[bpp], 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + _chunk(b"IEND", b""))


def save_unit_image(path: str, array: np.ndarray) -> None:
    """An image in [0, 1] (gray maps become 3 equal channels) as 8-bit RGB,
    truncated like ``(x * 255).astype(uint8)``."""
    arr = np.clip(np.asarray(array), 0.0, 1.0)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    write_png(path, (arr * 255).astype(np.uint8))


def read_unit_image(path: str) -> np.ndarray:
    """The first three channels of an 8-bit PNG as float32 in [0, 1], as
    ``np.asarray(Image.open(path), float32)[..., :3] / 255``."""
    return read_png(path).astype(np.float32)[..., :3] / 255.0
