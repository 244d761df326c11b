"""The device mesh of the port: a tuple of ``torch.device``.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/parallel/mesh.py``. The
JAX package is single-controller: one program drives every device of a
``Mesh`` through ``shard_map``. The port keeps that design rather than one
process per rank. One process, and one host thread, issues every band's or
group's launches in turn, each on its own device; what JAX's collectives
do becomes copies between devices (``Tensor.to``: the halo strips, the
superstep's per-cell records and its variates) and sums on the first
device of the mesh (``psum``'s masked merge). A mesh may name one device
more than once: ``[torch.device("cpu")] * 4`` runs four bands on the CPU
(the tests), ``[torch.device("cuda:0")] * 4`` four bands on one card (the
card check), with the same arithmetic as four cards.

The cost: the cell-parallel superstep is launch-bound (about 2,480
launches for 7.1 ms of device time at the flagship; PERF.md §5), and every
band evaluates the whole cell grid, so n bands cost about n times one
band's host time, whether the bands share a card or not. On distinct
cards the queued work overlaps across them only where the host runs ahead
of the devices.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from mpp_cnn_rs_object_detection_torch.device import resolve_device

Mesh = Tuple[torch.device, ...]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """``devices`` as a mesh, or by default every visible CUDA device; the
    first ``n_devices`` of them when that is given. With no GPU and no
    explicit list it raises: the CPU is only ever named by the caller."""
    if devices is None:
        resolve_device(None)  # raises without a GPU
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        if not 0 < n_devices <= len(mesh):
            raise ValueError(f"{n_devices} devices asked of a mesh of "
                             f"{len(mesh)}")
        mesh = mesh[:n_devices]
    if not mesh:
        raise ValueError("an empty mesh")
    return mesh


def distinct(mesh: Mesh) -> Tuple[torch.device, ...]:
    """The mesh's devices, each once, in their order."""
    return tuple(dict.fromkeys(mesh))
