"""Metrics log of a model directory (``log.json``).

Counterpart of ``Logger`` in ``mpp_cnn_rs_object_detection_tpu/utils/
logger.py`` without its rolling training checkpoints (training is not
ported): a dict of lists, rewritten to ``log.json`` on every update.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Dict, List

from mpp_cnn_rs_object_detection_torch.utils.files import (
    NumpyEncoder,
    append_lists_in_dict,
)


class Logger:
    def __init__(self, save_dir: str):
        self.log: Dict[str, List] = dict()
        self.save_dir = save_dir

    @classmethod
    def load(cls, path: str) -> "Logger":
        with open(path, "r") as f:
            log = json.load(f)
        loaded = cls(save_dir=os.path.split(path)[0])
        loaded.log = log
        return loaded

    def update(self, epoch: int, metrics: Dict[str, float], prefix: str = ""):
        timestamp_str = datetime.now().strftime("%m/%d/%y-%H:%M:%S")
        append_lists_in_dict(self.log, {"epoch": epoch})
        append_lists_in_dict(self.log, {"timestamp": timestamp_str})
        append_lists_in_dict(self.log,
                             {prefix + k: v for k, v in metrics.items()})
        with open(os.path.join(self.save_dir, "log.json"), "w") as f:
            json.dump(self.log, f, cls=NumpyEncoder, indent=1)
