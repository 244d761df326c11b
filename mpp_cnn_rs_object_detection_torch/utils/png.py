"""PNG reading and writing with numpy and ``zlib``.

The dataset's images are PNG files. The port reads and writes them without
PIL, which the GPU host lacks. The reader takes every PNG the standard
allows: gray at 1, 2, 4, 8 and 16 bits, palette at 1, 2, 4 and 8, gray +
alpha, RGB and RGBA at 8 and 16, non-interlaced or Adam7, with any of the
five row filters (PIL's writer picks a filter per row). It returns the
array PIL's ``np.asarray(Image.open(path))`` gives (Pillow 12): (H, W) for
gray and palette (the indices), (H, W, C) otherwise; see ``_as_pillow``.
The writer stores 8-bit gray, gray + alpha, RGB or RGBA rows with filter
0, deflated at zlib level 6 unless the caller gives another (the training
patch sets, rewritten every few epochs, use 1, as the JAX package does).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples per pixel in the file: gray, RGB, palette, gray +
# alpha, RGBA
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# color type -> the bit depths the standard allows
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# the writer's color type per channel count
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
# Adam7's passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


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


def _check_header(path: str, depth: int, color: int, interlace: int
                  ) -> None:
    if depth not in _DEPTHS.get(color, ()) or interlace not in (0, 1):
        raise ValueError(f"{path}: not a valid PNG header (bit depth "
                         f"{depth}, color type {color}, interlace "
                         f"{interlace})")


def _channels(depth: int, color: int) -> int:
    """The channels of Pillow's array: one for gray and palette, and four
    for a 16-bit gray + alpha image, which Pillow opens as RGBA."""
    if color == 4 and depth == 16:
        return 4
    return _SAMPLES[color]


def png_header(path: str) -> tuple:
    """(height, width, channels of the array ``read_png`` returns) from a
    PNG's header, without decoding it."""
    with open(path, "rb") as f:
        head = f.read(len(_SIGNATURE) + 21)
    if not head.startswith(_SIGNATURE) or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h, depth, color = struct.unpack(">IIBB", head[16:26])
    _check_header(path, depth, color, head[28])
    return h, w, _channels(depth, color)


def _decode_image(data: np.ndarray, h: int, w: int, depth: int,
                  samples: int) -> np.ndarray:
    """One (sub-)image of filtered rows at the head of ``data``: its (h, w,
    samples) sample values (uint8, or uint16 at 16 bits)."""
    row_bytes = (w * samples * depth + 7) // 8
    bpp = max(1, samples * depth // 8)  # the filters' byte distance
    rows = data[:h * (1 + row_bytes)].reshape(h, 1 + row_bytes)
    raw = unfilter(rows[:, 1:].reshape(h, row_bytes // bpp, bpp),
                   rows[:, 0]).reshape(h, row_bytes)
    if depth == 8:
        return raw.reshape(h, w, samples)
    if depth == 16:
        pairs = raw.reshape(h, w, samples, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    # 1, 2 or 4 bits, one sample per pixel, the first in the high bits
    bits = np.unpackbits(raw, axis=1).reshape(h, -1, depth)[:, :w]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=-1, dtype=np.uint8)[..., None]


def _decode(data: np.ndarray, h: int, w: int, depth: int, samples: int,
            interlace: int) -> np.ndarray:
    """The (h, w, samples) sample values of the whole image: its rows, or
    its seven Adam7 passes scattered into place (an empty pass has no
    rows)."""
    if not interlace:
        return _decode_image(data, h, w, depth, samples)
    out = np.zeros((h, w, samples), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for r0, c0, dr, dc in _ADAM7:
        ph, pw = -(-(h - r0) // dr), -(-(w - c0) // dc)
        if ph <= 0 or pw <= 0:
            continue
        out[r0::dr, c0::dc] = _decode_image(data[pos:], ph, pw, depth,
                                            samples)
        pos += ph * (1 + (pw * samples * depth + 7) // 8)
    return out


def _as_pillow(values: np.ndarray, depth: int, color: int) -> np.ndarray:
    """Sample values -> Pillow's array of the same image: palette indices
    as they are; 1-bit gray as bool, 2- and 4-bit gray scaled to 0-255,
    16-bit gray as uint16; the other 16-bit types' high bytes, gray + alpha
    as (L, L, L, A)."""
    if color == 3:
        return values[..., 0]
    if color == 0:
        v = values[..., 0]
        if depth == 1:
            return v.astype(bool)
        if depth in (2, 4):
            return v * np.uint8(255 // ((1 << depth) - 1))
        return v
    if depth == 16:
        values = (values >> 8).astype(np.uint8)
        if color == 4:
            values = values[..., [0, 0, 0, 1]]
    return values


def read_png(path: str) -> np.ndarray:
    """The array Pillow's ``np.asarray(Image.open(path))`` gives for any
    PNG (every color type and bit depth, interlaced or not; a ``tRNS``
    chunk changes no array)."""
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
    _check_header(path, depth, color, interlace)
    stream = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    values = _decode(stream, h, w, depth, _SAMPLES[color], interlace)
    return _as_pillow(values, depth, color)


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
