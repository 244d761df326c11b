"""Small file/JSON/pickle helpers.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/utils/files.py``, plus the
reader of result pickles that either package wrote (``load_results``).
"""

from __future__ import annotations

import datetime
import json
import os
import pickle
from typing import Any, Iterable, Union

import numpy as np


def timestamp() -> str:
    """The local time as ``YYYYmmdd-HHMMSS``."""
    return datetime.datetime.now().strftime("%Y%m%d-%H%M%S")


def make_if_not_exist(path: Union[str, Iterable[str]], recursive: bool = False):
    if isinstance(path, (list, tuple)):
        for p in path:
            make_if_not_exist(p, recursive=recursive)
        return
    if not os.path.exists(path):
        if recursive:
            os.makedirs(path, exist_ok=True)
        else:
            os.mkdir(path)


def find_existing_path(candidates: Iterable[str]) -> str:
    """First existing path among candidates (paths_config semantics)."""
    candidates = list(candidates)
    for c in candidates:
        if os.path.exists(c):
            return c
    raise FileNotFoundError(f"none of the candidate paths exist: {candidates}")


class NumpyEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.bool_):
            return bool(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def append_lists_in_dict(d: dict, update: dict):
    for key, value in update.items():
        d.setdefault(key, []).append(value)


JAX_PACKAGE = "mpp_cnn_rs_object_detection_tpu"
# the JAX package's modules whose classes a result pickle may hold, and the
# port's module that defines the same classes
_REMAP = {f"{JAX_PACKAGE}.ops.mappings":
          "mpp_cnn_rs_object_detection_torch.ops.mappings"}


class RemapUnpickler(pickle.Unpickler):
    """Reads result pickles without importing the JAX package: a ShapeNet
    result holds ``ValueMapping`` objects, which the JAX package pickles
    under its own ``ops.mappings``; they load as the port's class of the
    same fields. Any other class of the JAX package is refused."""

    def find_class(self, module: str, name: str):
        if module in _REMAP:
            module = _REMAP[module]
        elif module.split(".")[0] == JAX_PACKAGE:
            raise pickle.UnpicklingError(
                f"refusing {module}.{name}: only {sorted(_REMAP)} of the JAX "
                "package have a counterpart in the port")
        return super().find_class(module, name)


def load_results(path: str) -> Any:
    """A result pickle (``NNNN_results.pkl``) through ``RemapUnpickler``."""
    with open(path, "rb") as f:
        return RemapUnpickler(f).load()
