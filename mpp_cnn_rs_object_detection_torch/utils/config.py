"""Config / paths resolution and model-store layout.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/utils/config.py`` (its
JAX-free parts; the compile cache, the device yield and the attach watchdog
have no counterpart on the GPU):

  - ``paths_config.json`` lists candidate ``dataset_path`` / ``model_path``
    roots; the first existing one wins. The file itself is looked up in the
    working directory, then the repository root, then ``sys.path``;
    relative candidates resolve against the working directory, then the
    repository root;
  - model configs are JSON files under ``model_configs/<type>/``; resolution
    order is full path -> ``model_configs/*/<name>.json`` -> saved model name;
  - a trained model lives in ``<model_path>/<type>/<name>/`` holding
    ``config.json``, ``model.msgpack``, ``log.json``, ``calibration.json``
    and ``energy_combination_model.json``;
  - inference artifacts go to
    ``<dataset_path>/inference/<dataset>/<subset>/<model>/``.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import re
import shutil
import sys
from typing import Any, Dict, List, Optional, Tuple

from mpp_cnn_rs_object_detection_torch.utils.files import (
    find_existing_path,
    make_if_not_exist,
)
from mpp_cnn_rs_object_detection_torch.utils.logger import Logger

Config = Dict[str, Any]

# repo root = two levels above this file's package
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def load_paths_config() -> Optional[dict]:
    candidates = [
        os.path.join(os.getcwd(), "paths_config.json"),
        os.path.join(_REPO_ROOT, "paths_config.json"),
    ] + [os.path.join(p, "paths_config.json") for p in sys.path]
    for c in candidates:
        try:
            with open(c, "r") as f:
                return json.load(f)
        except (FileNotFoundError, NotADirectoryError, IsADirectoryError):
            continue
    return None


def _resolve_candidates(paths: List[str]) -> List[str]:
    """Relative candidates are resolved against cwd and the repo root."""
    out = []
    for p in paths:
        if os.path.isabs(p):
            out.append(p)
        else:
            out.append(os.path.join(os.getcwd(), p))
            out.append(os.path.join(_REPO_ROOT, p))
    return out


def get_dataset_base_path() -> str:
    config = load_paths_config()
    return find_existing_path(_resolve_candidates(config["dataset_path"]))


def get_model_base_path() -> str:
    config = load_paths_config()
    candidates = _resolve_candidates(config["model_path"])
    try:
        return find_existing_path(candidates)
    except FileNotFoundError:
        os.makedirs(candidates[0], exist_ok=True)
        return candidates[0]


def fetch_data_paths(dataset: str, subset: str, images=True, annotations=True,
                     metadata=True) -> Dict[str, List[str]]:
    """Sorted image/annotation/metadata file lists of ``<dataset>/<subset>``.

    Files are matched by their numeric id; orphans are dropped with a
    warning."""
    data_path = os.path.join(get_dataset_base_path(), dataset, subset)
    res = {}
    if images:
        res["images"] = sorted(
            glob.glob(os.path.join(data_path, "images", "*.png")))
    if annotations:
        res["annotations"] = sorted(
            glob.glob(os.path.join(data_path, "annotations", "*.pkl")))
    if metadata:
        res["metadata"] = sorted(
            glob.glob(os.path.join(data_path, "metadata", "*.json")))

    def file_id(p):
        m = re.match(r"[^0-9]*([0-9]+)", os.path.split(p)[1])
        return m.group(1) if m else None

    id_sets = [{file_id(p) for p in v} for v in res.values()]
    common = set.intersection(*id_sets) if id_sets else set()
    if any(len(s) != len(common) for s in id_sets):
        dropped = set.union(*id_sets) - common
        logging.warning(
            f"{dataset}/{subset}: dropping {len(dropped)} orphan file id(s): "
            f"{sorted(dropped)}"
        )
        res = {k: [p for p in v if file_id(p) in common]
               for k, v in res.items()}
    return res


def check_data_match(paths: List[str]) -> int:
    """The numeric id that a group of image, annotation and metadata paths
    share; raises if they do not share one."""
    ids = [re.match(r"([0-9]+)\.[a-zA-Z]+", os.path.split(p)[1]).group(1)
           for p in paths]
    if any(i != ids[0] for i in ids):
        raise ValueError(f"id mismatch in {paths}")
    return int(ids[0])


def get_inference_path(model_name: str, dataset: str, subset: str) -> str:
    return os.path.join(
        get_dataset_base_path(), "inference", dataset, subset, model_name
    )


def get_model_config_by_name(name: str) -> Optional[str]:
    """``config.json`` of the saved model ``name`` (any type)."""
    matches = glob.glob(
        os.path.join(get_model_base_path(), "*", name, "config.json"))
    if len(matches) == 0:
        return None
    if len(matches) > 1:
        logging.warning(f"found more than one model for {name}: {matches}")
    return matches[-1]


def get_config_from_model_configs(name: str) -> Optional[str]:
    for base in [os.getcwd(), _REPO_ROOT] + list(sys.path):
        root = os.path.join(base, "model_configs")
        if os.path.exists(root):
            matches = glob.glob(os.path.join(root, "*", name))
            if matches:
                return matches[-1]
    return None


def resolve_model_config_path(config_file_or_model_name: str) -> str:
    """Full path -> ``model_configs/*/<name>.json`` -> saved model name."""
    if os.path.exists(config_file_or_model_name):
        return config_file_or_model_name
    name = config_file_or_model_name
    if not name.endswith(".json"):
        name = name + ".json"
    config_file = get_config_from_model_configs(name)
    if config_file is None:
        config_file = get_model_config_by_name(config_file_or_model_name)
    if config_file is None:
        raise FileNotFoundError(
            f"no model with name (or config with path) "
            f"{config_file_or_model_name}")
    return config_file


def startup_config(config: Config, model_type: str, load_model=False,
                   overwrite=False) -> Tuple[Config, Logger, str]:
    """Create/load the model dir, freeze the config into it, set up logging."""
    save_path = os.path.join(get_model_base_path(), model_type,
                             config["model_name"])

    if os.path.exists(save_path):
        if not load_model:
            if not overwrite:
                raise FileExistsError(f"found model in {save_path}")
            shutil.rmtree(save_path)
            make_if_not_exist(save_path, recursive=True)
    else:
        make_if_not_exist(save_path, recursive=True)

    local_config_file = os.path.join(save_path, "config.json")
    if not os.path.exists(local_config_file):
        with open(local_config_file, "w") as f:
            json.dump(config, f, indent=1)

    log_file = os.path.join(save_path, "log.json")
    if os.path.exists(log_file) and load_model:
        logger = Logger.load(log_file)
    else:
        logger = Logger(save_dir=save_path)

    logging.basicConfig(
        format="%(levelname)-8s [%(filename)s:%(lineno)d] %(message)s",
        datefmt="%Y-%m-%d:%H:%M:%S",
        level=logging.INFO,
    )
    return config, logger, save_path
