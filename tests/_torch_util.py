"""Shared fixture of the PyTorch port's CPU tests.

The port's tests run many small tensor ops; with torch's default
intra-op thread pool per process, the parallel test workers oversubscribe
the cores they share. Import ``one_torch_thread`` into a test module to
run that module's torch ops on one thread (restored afterwards). Also a
PNG encoder of every color type, bit depth and interlace (``encode_png``),
the reference the port's reader is held to through Pillow."""

import struct
import zlib

import numpy as np
import pytest
import torch

from mpp_cnn_rs_object_detection_torch.utils import png


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def noisy_view_planes(h, w, elements, pad, seed=0, pitch_extra=0):
    """Per-view head outputs of an (h, w) frame, made with numpy: for each
    dihedral element ``(k, flip)`` a (3, Hp, P) float32 array with standard
    normal ``[vx, vy, mask]`` in the view's crop ((w, h) for odd k) and
    large noise (+-1e3) in the padding around it, which a kernel must never
    read. Hp and P are ``pad`` or the crop, whichever is larger; P is then
    rounded up to a multiple of 4 and widened by ``pitch_extra``.
    Returns ``[(planes, crop, element)]``."""
    rng = np.random.default_rng(seed)
    out = []
    for k, flip in elements:
        crop = (w, h) if k % 2 else (h, w)
        hp = max(pad, crop[0])
        pitch = -(-max(pad, crop[1]) // 4) * 4 + pitch_extra
        planes = rng.uniform(-1e3, 1e3, (3, hp, pitch)).astype(np.float32)
        planes[:, :crop[0], :crop[1]] = rng.normal(
            size=(3,) + crop).astype(np.float32)
        out.append((planes, crop, (k, flip)))
    return out


# Adam7's passes: (first row, first column, row step, column step)
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _filter_png_rows(raw, bpp, ftypes):
    """(h, n) bytes -> (h, 1 + n) rows, row r filtered with ``ftypes[r]``
    (row by row in numpy: the reference for the reader's unfiltering)."""
    h, n = raw.shape
    x = raw.astype(np.int32)
    up = np.vstack([np.zeros((1, n), np.int32), x[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int32), x[:, :-bpp]])
    ul = np.hstack([np.zeros((h, bpp), np.int32), up[:, :-bpp]])
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    preds = np.stack([0 * x, left, up, (left + up) >> 1, paeth])
    out = np.zeros((h, 1 + n), np.uint8)
    out[:, 0] = ftypes
    out[:, 1:] = (x - preds[ftypes, np.arange(h)]) & 0xFF
    return out


def _pack_png(values, depth):
    """(h, w, samples) sample values -> (h, row bytes), big-endian, the
    first sub-byte sample in the high bits."""
    h = values.shape[0]
    if depth == 8:
        return values.reshape(h, -1).astype(np.uint8)
    if depth == 16:
        v = values.reshape(h, -1).astype(np.uint16)
        return np.stack([v >> 8, v & 0xFF], -1).reshape(h, -1).astype(
            np.uint8)
    bits = (values.reshape(h, -1, 1) >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)


def encode_png(path, values, depth, color, interlace, rng, extra=()):
    """A PNG of any color type and bit depth, interlaced or not, its rows
    filtered at random (Pillow writes no Adam7 file and no 2-bit gray)."""
    h, w, s = values.shape
    bpp = max(1, s * depth // 8)
    images = ([values[r0::dr, c0::dc] for r0, c0, dr, dc in ADAM7]
              if interlace else [values])
    stream = b"".join(
        _filter_png_rows(_pack_png(v, depth), bpp,
                         rng.integers(0, 5, len(v))).tobytes()
        for v in images if v.shape[0] and v.shape[1])
    body = png._SIGNATURE + png._chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    for kind, b in extra:
        body += png._chunk(kind, b)
    body += png._chunk(b"IDAT", zlib.compress(stream)) + png._chunk(
        b"IEND", b"")
    with open(path, "wb") as f:
        f.write(body)
