"""PyTorch/CUDA port of the MPP+CNN remote-sensing object detector.

Mirrors the JAX package ``mpp_cnn_rs_object_detection_tpu`` module for module
(``ops/``, ``models/``, ``mpp/``, ``parallel/``) and imports nothing from it.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``; the one hand-written kernel (``native/detection_map.cu``)
is built with ``nvcc`` on first use.
"""

from mpp_cnn_rs_object_detection_torch.device import resolve_device

__all__ = ["resolve_device"]
