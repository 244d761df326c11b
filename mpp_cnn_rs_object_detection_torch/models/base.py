"""The model interface of the CLI.

Counterpart of ``BaseModel`` in ``mpp_cnn_rs_object_detection_tpu/models/
base.py`` without training and previews (``ROADMAP.md`` items 9, 12 and
16; the CLI refuses those procedures) and without the patch-based CNN
trainer.
"""

from __future__ import annotations

from abc import ABC, abstractmethod


class BaseModel(ABC):
    @abstractmethod
    def infer(self, subset: str, **kwargs):
        ...

    @abstractmethod
    def eval(self):
        ...

    def infereval(self, subset: str = "val", **kwargs):
        self.infer(subset=subset, **kwargs)
        self.eval()
