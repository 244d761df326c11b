"""Halo exchange between row bands and the exact banded U-Net forward.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/parallel/halo.py``. A
scene split into row bands, one per device of a mesh (``parallel/
mesh.py``), gets from each neighbour the strip of rows its convolutions or
its cells read across the border: ``halo_exchange_rows`` copies the strips
to the band's device (``ppermute`` in JAX), with zeros at the scene's top
and bottom, so band borders see their true context and the result is
exact, not stitched.
"""

from __future__ import annotations

import copy
from typing import List, Sequence

import torch

from mpp_cnn_rs_object_detection_torch.parallel.mesh import Mesh, distinct


def halo_exchange_rows(blocks: Sequence[torch.Tensor], halo: int,
                       dim: int = 0) -> List[torch.Tensor]:
    """Each band's block padded with ``halo`` rows (along ``dim``) from its
    neighbours: the rows above from the previous band's last rows, the rows
    below from the next band's first, zeros at the first band's top and
    the last band's bottom. ``blocks[i]`` lies on band i's device and so
    does its result. The exchange is one hop: ``halo`` must not exceed a
    block's height."""
    out = []
    n = len(blocks)
    for i, block in enumerate(blocks):
        if halo > block.shape[dim]:
            raise ValueError(f"halo {halo} exceeds the block height "
                             f"{block.shape[dim]} (one-hop exchange)")
        if i > 0:
            top = blocks[i - 1].narrow(dim, blocks[i - 1].shape[dim] - halo,
                                       halo).to(block.device)
        else:
            top = torch.zeros_like(block.narrow(dim, 0, halo))
        if i < n - 1:
            bottom = blocks[i + 1].narrow(dim, 0, halo).to(block.device)
        else:
            bottom = torch.zeros_like(block.narrow(dim, 0, halo))
        out.append(torch.cat([top, block, bottom], dim=dim))
    return out


def split_rows(x: torch.Tensor, mesh: Mesh, dim: int = 0
               ) -> List[torch.Tensor]:
    """``x`` cut into ``len(mesh)`` equal row bands along ``dim``, band i
    on ``mesh[i]``."""
    n = len(mesh)
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} rows do not split into {n} bands")
    return [b.to(d) for b, d in zip(torch.chunk(x, n, dim=dim), mesh)]


def sharded_unet_inference(forward: torch.nn.Module, scene: torch.Tensor,
                           mesh: Mesh, halo: int = 64) -> torch.Tensor:
    """Exact banded U-Net forward of an (N, C, H, W) ``scene``: each band
    of H / n rows, padded with ``halo`` rows from its neighbours, runs
    through a copy of ``forward`` on its band's device (one copy per
    distinct device), and the bands' outputs, cropped of their halos, are
    joined on ``scene``'s device. The result equals ``forward`` on the
    whole scene zero-padded by ``halo`` rows above and below, cropped: only
    the scene's outer rows see zeros. ``halo`` must cover the U-Net's
    receptive-field radius and keep the padded band a multiple of its
    pooling stride."""
    n = len(mesh)
    h = scene.shape[-2]
    assert h % n == 0, f"scene H {h} not divisible by {n}"
    h_loc = h // n
    assert halo <= h_loc, (
        f"halo {halo} exceeds the local block height {h_loc} "
        "(one-hop exchange)")
    assert (h_loc + 2 * halo) % 8 == 0, (
        f"local block {h_loc}+2*{halo} must be a multiple of 8 for the U-Net")
    home = next(forward.parameters()).device
    nets = {d: forward if d == home else copy.deepcopy(forward).to(d)
            for d in distinct(mesh)}
    padded = halo_exchange_rows(split_rows(scene, mesh, dim=-2), halo,
                                dim=scene.ndim - 2)
    outs = [nets[d](x)[..., halo:-halo, :].to(scene.device)
            for d, x in zip(mesh, padded)]
    return torch.cat(outs, dim=-2)
