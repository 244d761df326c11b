"""Checkpoints: a msgpack reader and writer for flax checkpoints and the
flax <-> torch parameter conversion.

The JAX package writes ``model.msgpack`` with ``flax.serialization.to_bytes``
(``models/train_utils.py:save_checkpoint``): msgpack maps of str keys whose
leaves are ndarrays packed as ext type 1 (``(shape, dtype name, bytes)``),
numpy scalars as ext type 3, and Python ints. The reader below decodes that
subset of msgpack (map, array, str, bin, int, float, nil, bool, ext) without
the ``msgpack`` package, which the GPU host lacks. The writer is its inverse
and packs a tree the way ``flax.serialization.to_bytes`` does (dict keys in
sorted order). Weights are converted in memory; ``train_state_to_jax`` /
``train_state_from_jax`` carry a whole training state across: parameters,
BatchNorm statistics and the optimizer's state: optax adam's
``(ScaleByAdamState(count, mu, nu), EmptyState())``, which flax stores as
``{"0": {"count", "mu", "nu"}, "1": {}}``, or the detectors'
``chain(clip_by_global_norm, adam(schedule))``, ``(EmptyState(),
(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count)))``, stored
as ``{"0": {}, "1": {"0": {"count", "mu", "nu"}, "1": {"count"}}}``.
"""

from __future__ import annotations

import glob
import os
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


def latest_checkpoint(save_path: str) -> str:
    """``model.msgpack`` of a model directory, else its newest
    ``checkpoint_NNNN.msgpack``; raises when there is neither."""
    model_file = os.path.join(save_path, "model.msgpack")
    if os.path.exists(model_file):
        return model_file
    ckpts = sorted(glob.glob(os.path.join(save_path, "checkpoint_*.msgpack")))
    if not ckpts:
        raise FileNotFoundError(f"no checkpoint in {save_path}")
    return ckpts[-1]


def read_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return read_msgpack(f.read())


class _Writer:
    def __init__(self):
        self.parts = []

    def pack(self, fmt: str, *values) -> None:
        self.parts.append(struct.pack(fmt, *values))

    def header(self, n: int, fix: int, fix_max: int, codes) -> None:
        """A fixed-size header for small ``n``, else the narrowest of
        ``codes`` = ((byte, struct format, max), ...)."""
        if n <= fix_max:
            self.pack(">B", fix | n)
            return
        for byte, fmt, top in codes:
            if n <= top:
                self.pack(">B" + fmt[1:], byte, n)
                return
        raise ValueError(f"msgpack: length {n} too large")

    def value(self, v: Any) -> None:
        if v is None:
            self.pack(">B", 0xC0)
        elif isinstance(v, (bool, np.bool_)):
            self.pack(">B", 0xC3 if v else 0xC2)
        elif isinstance(v, int):
            self.integer(v)
        elif isinstance(v, float):
            self.pack(">Bd", 0xCB, v)
        elif isinstance(v, str):
            raw = v.encode("utf-8")
            self.header(len(raw), 0xA0, 31, ((0xD9, ">B", 0xFF),
                                            (0xDA, ">H", 0xFFFF),
                                            (0xDB, ">I", 0xFFFFFFFF)))
            self.parts.append(raw)
        elif isinstance(v, (bytes, bytearray)):
            self.header(len(v), 0, -1, ((0xC4, ">B", 0xFF),
                                        (0xC5, ">H", 0xFFFF),
                                        (0xC6, ">I", 0xFFFFFFFF)))
            self.parts.append(bytes(v))
        elif isinstance(v, dict):
            self.header(len(v), 0x80, 15, ((0xDE, ">H", 0xFFFF),
                                           (0xDF, ">I", 0xFFFFFFFF)))
            for k in sorted(v):  # flax packs a dict's keys in sorted order
                self.value(k)
                self.value(v[k])
        elif isinstance(v, (list, tuple)):
            self.header(len(v), 0x90, 15, ((0xDC, ">H", 0xFFFF),
                                           (0xDD, ">I", 0xFFFFFFFF)))
            for x in v:
                self.value(x)
        elif isinstance(v, np.ndarray):
            self.ext(_EXT_NDARRAY, _ndarray_payload(v))
        elif isinstance(v, np.generic):
            self.ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(v)))
        else:
            raise TypeError(f"msgpack: cannot pack {type(v).__name__}")

    def integer(self, v: int) -> None:
        if 0 <= v <= 0x7F or -32 <= v < 0:
            self.pack(">b" if v < 0 else ">B", v)
            return
        codes = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) \
            if v > 0 else ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"),
                           (0xD3, ">q"))
        for byte, fmt in codes:
            bits = 8 * struct.calcsize(fmt)
            lo, hi = (0, 2 ** bits - 1) if v > 0 else (-2 ** (bits - 1), -1)
            if lo <= v <= hi:
                self.pack(">B" + fmt[1:], byte, v)
                return
        raise ValueError(f"msgpack: integer {v} out of range")

    def ext(self, code: int, payload: bytes) -> None:
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            self.pack(">Bb", fixext[n], code)
        else:
            for byte, fmt, top in ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                                   (0xC9, ">I", 0xFFFFFFFF)):
                if n <= top:
                    self.pack(">B" + fmt[1:] + "b", byte, n, code)
                    break
        self.parts.append(payload)


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """flax's ndarray ext payload: msgpack ``(shape, dtype name, bytes)``."""
    w = _Writer()
    w.value((tuple(int(d) for d in arr.shape), arr.dtype.name,
             np.ascontiguousarray(arr).tobytes()))
    return b"".join(w.parts)


def write_msgpack(tree: Any) -> bytes:
    """Encode a tree of str-keyed dicts, numpy arrays and scalars as
    ``flax.serialization.to_bytes`` does (so flax and the reader above
    restore it)."""
    w = _Writer()
    w.value(tree)
    return b"".join(w.parts)


def write_checkpoint(path: str, params: Dict[str, Any],
                     batch_stats: Dict[str, Any], epoch: int = 0) -> None:
    """Write ``{"params", "batch_stats", "epoch"}`` (numpy leaves) to
    ``path``; the JAX package's checkpoint loader and ``read_checkpoint``
    restore it."""
    data = write_msgpack({"params": params, "batch_stats": batch_stats,
                          "epoch": int(epoch)})
    with open(path, "wb") as f:
        f.write(data)


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
    the spatial flip; ``Dense`` kernels (in, out) to ``nn.Linear``'s (out,
    in); BatchNorm ``scale``/``bias``/``mean``/``var`` become
    ``weight``/``bias``/``running_mean``/``running_var``. A torch module
    named as the flax one (the detectors' ``FasterRCNN`` and ``CTRBOX``, the
    U-Nets) takes the result as its state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(variables.get("params", {})):
        parent, leaf = path.rsplit(".", 1)
        module = parent.rsplit(".", 1)[-1]
        arr = np.asarray(v, np.float32)
        if leaf == "kernel" and arr.ndim == 2:
            sd[f"{parent}.weight"] = torch.from_numpy(arr.T.copy())
        elif leaf == "kernel":
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


def _nest(tree: Dict[str, Any], path: str, value: np.ndarray) -> None:
    *parents, leaf = path.split(".")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``params_from_jax``: a torch state_dict -> flax
    ``{"params": ..., "batch_stats": ...}`` with float32 numpy leaves."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, t in state_dict.items():
        parent, leaf = key.rsplit(".", 1)
        module = parent.rsplit(".", 1)[-1]
        arr = t.detach().cpu().float().numpy()
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            _nest(stats, f"{parent}.{leaf[len('running_'):]}", arr.copy())
        elif leaf == "bias":
            _nest(params, f"{parent}.bias", arr.copy())
        elif leaf == "weight" and arr.ndim == 2:
            _nest(params, f"{parent}.kernel", np.ascontiguousarray(arr.T))
        elif leaf == "weight" and arr.ndim == 4:
            if module.startswith("ConvTranspose"):
                kernel = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
            else:
                kernel = arr.transpose(2, 3, 1, 0)
            _nest(params, f"{parent}.kernel", np.ascontiguousarray(kernel))
        elif leaf == "weight":
            _nest(params, f"{parent}.scale", arr.copy())
        else:
            raise ValueError(f"unexpected parameter {key}")
    return {"params": params, "batch_stats": stats}


def train_state_to_jax(params: Dict[str, torch.Tensor],
                       buffers: Dict[str, torch.Tensor],
                       mu: Dict[str, torch.Tensor],
                       nu: Dict[str, torch.Tensor], count: int,
                       chain: bool = False) -> Dict[str, Any]:
    """A training state as flax stores it: ``params``, ``mu`` and ``nu``
    are keyed by the same dotted parameter names (their first component is
    the flax tree's, e.g. ``net.`` / ``div.`` for a PosNet), ``buffers``
    the BatchNorm modules' running statistics. Returns ``{"params",
    "batch_stats", "opt_state"}`` with numpy leaves; ``chain`` stores the
    optimizer state in the detectors' clip + scheduled adam layout."""
    adam = {"count": np.asarray(count, np.int32),
            "mu": params_to_jax(mu)["params"],
            "nu": params_to_jax(nu)["params"]}
    opt_state = ({"0": {}, "1": {"0": adam, "1": {
        "count": np.asarray(count, np.int32)}}} if chain
        else {"0": adam, "1": {}})
    return {
        "params": params_to_jax(params)["params"],
        "batch_stats": params_to_jax(buffers)["batch_stats"],
        "opt_state": opt_state,
    }


def _adam_state(opt_state: Any):
    """(adam's state, whether it sits in the chain layout), or (None,
    None) for a tree that holds neither layout."""
    if not isinstance(opt_state, dict):
        return None, None
    keys = {"count", "mu", "nu"}
    first = opt_state.get("0")
    if isinstance(first, dict) and keys <= set(first):
        return first, False
    second = opt_state.get("1")
    inner = second.get("0") if isinstance(second, dict) else None
    if first == {} and isinstance(inner, dict) and keys <= set(inner) \
            and "count" in second.get("1", {}):
        return inner, True
    return None, None


def train_state_from_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``train_state_to_jax`` for a flax state tree (numpy
    leaves, e.g. a checkpoint): ``params``, ``mu``, ``nu`` (dotted names ->
    tensors), ``batch_stats`` (running statistics as a state_dict),
    ``count`` and ``chain`` (the layout it was stored in); the last four
    are None where the tree has no adam state in either layout."""
    out = {"params": params_from_jax({"params": tree["params"]}),
           "batch_stats": params_from_jax(
               {"batch_stats": tree.get("batch_stats", {})}),
           "mu": None, "nu": None, "count": None, "chain": None}
    adam, chain = _adam_state(tree.get("opt_state"))
    if adam is not None:
        out["mu"] = params_from_jax({"params": adam["mu"]})
        out["nu"] = params_from_jax({"params": adam["nu"]})
        out["count"] = int(adam["count"])
        out["chain"] = chain
    return out
