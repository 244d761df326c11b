"""Metrics log of a model directory (``log.json``).

Counterpart of ``Logger`` in ``mpp_cnn_rs_object_detection_tpu/utils/
logger.py``: a dict of lists, rewritten to ``log.json`` on every update;
the CNN trainer logs each epoch's means with ``train_`` / ``val_``
prefixes. Its rolling checkpoints are written by the trainer
(``models/train_utils.py:save_checkpoint``), so the logger's own
``log_model`` / ``state_provider`` hook, which no trainer of either
package registers, is not ported.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Dict, List

import numpy as np

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

    def update_train_val(self, epoch: int, train_metrics: Dict[str, float],
                         val_metrics: Dict[str, float]):
        metrics = {
            **{"train_" + k: float(np.mean(v))
               for k, v in train_metrics.items()},
            **{"val_" + k: float(np.mean(v)) for k, v in val_metrics.items()},
        }
        self.update(epoch, metrics=metrics)

    def update(self, epoch: int, metrics: Dict[str, float], prefix: str = ""):
        timestamp_str = datetime.now().strftime("%m/%d/%y-%H:%M:%S")
        append_lists_in_dict(self.log, {"epoch": epoch})
        append_lists_in_dict(self.log, {"timestamp": timestamp_str})
        append_lists_in_dict(self.log,
                             {prefix + k: v for k, v in metrics.items()})
        with open(os.path.join(self.save_dir, "log.json"), "w") as f:
            json.dump(self.log, f, cls=NumpyEncoder, indent=1)
