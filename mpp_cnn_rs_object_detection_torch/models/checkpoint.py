"""Checkpoint loading: a msgpack reader for flax checkpoints and the
flax -> torch parameter conversion.

The JAX package writes ``model.msgpack`` with ``flax.serialization.to_bytes``
(``models/train_utils.py:save_checkpoint``): msgpack maps of str keys whose
leaves are ndarrays packed as ext type 1 (``(shape, dtype name, bytes)``),
numpy scalars as ext type 3, and Python ints. The reader below decodes that
subset of msgpack (map, array, str, bin, int, float, nil, bool, ext) without
the ``msgpack`` package, which the GPU host lacks. Weights are converted in
memory at load; nothing converted is written to disk.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in lens:
            return str(self.take(self.unpack(lens[b])), "utf-8")
        bins = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in bins:
            return bytes(self.take(self.unpack(bins[b])))
        if b == 0xDC:
            return self.array(self.unpack(">H"))
        if b == 0xDD:
            return self.array(self.unpack(">I"))
        if b == 0xDE:
            return self.map(self.unpack(">H"))
        if b == 0xDF:
            return self.map(self.unpack(">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        exts = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in exts:
            return self.ext(self.unpack(exts[b]))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = struct.unpack(">b", self.take(1))[0]
        payload = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray_from_payload(payload)
            return arr if code == _EXT_NDARRAY else arr[()]
        raise ValueError(f"msgpack: unsupported ext type {code}")


def _ndarray_from_payload(payload: bytes) -> np.ndarray:
    r = _Reader(payload)
    shape, dtype_name, buffer = r.value()
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        raw = np.frombuffer(buffer, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16).float().numpy()
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _unchunk(tree: Any) -> Any:
    """Reassemble arrays flax split into chunks above 1 GiB."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_msgpack(data: bytes) -> Any:
    """Decode flax's msgpack bytes into a tree of dicts and numpy arrays."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: trailing bytes after the top-level object")
    return _unchunk(tree)


def read_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return read_msgpack(f.read())


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            yield from _flatten(v, path)
        else:
            yield path, v


def params_from_jax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``{"params": ..., "batch_stats": ...}`` of one module (numpy
    leaves) -> a torch state_dict for the same-named torch module.

    Conv kernels go HWIO -> OIHW; flax ``ConvTranspose`` kernels (applied
    without a flip) go to torch ``ConvTranspose2d``'s (in, out, kh, kw) WITH
    the spatial flip; BatchNorm ``scale``/``bias``/``mean``/``var`` become
    ``weight``/``bias``/``running_mean``/``running_var``."""
    sd: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(variables.get("params", {})):
        parent, leaf = path.rsplit(".", 1)
        module = parent.rsplit(".", 1)[-1]
        arr = np.asarray(v, np.float32)
        if leaf == "kernel":
            if module.startswith("ConvTranspose"):
                arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                arr = arr.transpose(3, 2, 0, 1)
            sd[f"{parent}.weight"] = torch.from_numpy(arr.copy())
        elif leaf == "scale":
            sd[f"{parent}.weight"] = torch.from_numpy(arr.copy())
        elif leaf == "bias":
            sd[f"{parent}.bias"] = torch.from_numpy(arr.copy())
        else:
            raise ValueError(f"unexpected parameter {path}")
    for path, v in _flatten(variables.get("batch_stats", {})):
        parent, leaf = path.rsplit(".", 1)
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
        sd[f"{parent}.{name}"] = torch.from_numpy(
            np.asarray(v, np.float32).copy())
        sd.setdefault(f"{parent}.num_batches_tracked",
                      torch.zeros((), dtype=torch.long))
    return sd
