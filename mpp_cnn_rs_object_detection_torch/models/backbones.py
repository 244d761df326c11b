"""ResNet backbones, FPN and CTRBOX's decoder block as torch modules (NCHW).

Counterpart of ``mpp_cnn_rs_object_detection_tpu/models/backbones.py``: the
ResNet of depth 18/34/50/101 (``BasicBlock`` / ``Bottleneck`` stages of
64/128/256/512 x expansion, strides /4 /8 /16 /32), the FPN over C2..C5
with P6 a stride-2 subsample of P5, and ``CombinationModule``.

Convolutions run in the module's compute ``dtype`` (bf16 under the real
configs) with fp32 parameters, as flax's ``nn.Conv(dtype=...)``; padding
is flax's ``"SAME"``, asymmetric for a stride-2 window on an even side
((2, 3) for the 7x7/2 stem at 128 px, (0, 1) for the 3x3/2 convs and the
stem's max-pool, which pads with -inf). BatchNorm has flax's semantics
(``nn.BatchNorm(dtype=...)``, momentum 0.99, eps 1e-5): statistics in fp32,
the output cast to ``dtype``; in train mode ``unet.batch_norm_train``.
Submodules carry the flax names (``Conv_0``, ``BatchNorm_0``,
``BasicBlock_3``, ...), so a flax parameter path maps onto a state_dict key
(``models/checkpoint.py:params_from_jax``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mpp_cnn_rs_object_detection_torch.models.unet import (
    BN_EPS,
    batch_norm_train,
)

# depth -> (block kind, per-stage block counts)
RESNET_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
}
# flax nn.BatchNorm's default momentum
BN_MOMENTUM = 0.99


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """flax / XLA ``"SAME"`` padding (low, high) of one spatial side: the
    output has ceil(size / stride) positions, the extra pixel goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype
              ) -> torch.Tensor:
    """``conv`` in ``dtype`` with flax's SAME padding (zeros)."""
    (kh, kw), (sh, sw) = conv.kernel_size, conv.stride
    ph, pw = same_pads(x.shape[2], kh, sh), same_pads(x.shape[3], kw, sw)
    x = x.to(dtype)
    pad = 0
    if ph[0] == ph[1] and pw[0] == pw[1]:
        pad = (ph[0], pw[0])
    else:
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x, conv.weight.to(dtype), bias, stride=conv.stride,
                    padding=pad)


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), (stride, stride), padding="SAME")``: the
    padding holds -inf."""
    ph, pw = same_pads(x.shape[2], k, stride), same_pads(x.shape[3], k,
                                                         stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, k, stride)


def norm(x: torch.Tensor, bn: nn.BatchNorm2d, dtype: torch.dtype
         ) -> torch.Tensor:
    """flax ``nn.BatchNorm(dtype=dtype)``: batch statistics (running ones
    updated) in train mode, running statistics in eval mode; fp32 inside,
    ``dtype`` out."""
    x = x.float()
    if bn.training:
        y = batch_norm_train(x, bn, momentum=BN_MOMENTUM)
    else:
        y = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, False, 0.0, bn.eps)
    return y.to(dtype)


def upsample2_crop(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``jnp.repeat`` by 2 on both sides, cropped to ``like``'s."""
    up = F.interpolate(x, scale_factor=2, mode="nearest")
    return up[:, :, :like.shape[2], :like.shape[3]]


def _bn(features: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(features, eps=BN_EPS)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.add_module("Conv_0", nn.Conv2d(in_ch, features, 3, stride,
                                            bias=False))
        self.add_module("BatchNorm_0", _bn(features))
        self.add_module("Conv_1", nn.Conv2d(features, features, 3,
                                            bias=False))
        self.add_module("BatchNorm_1", _bn(features))
        self.project = in_ch != features or stride != 1
        if self.project:
            self.add_module("Conv_2", nn.Conv2d(in_ch, features, 1, stride,
                                                bias=False))
            self.add_module("BatchNorm_2", _bn(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        y = F.relu(norm(conv_same(x, self.Conv_0, d), self.BatchNorm_0, d))
        y = norm(conv_same(y, self.Conv_1, d), self.BatchNorm_1, d)
        res = x.to(d)
        if self.project:
            res = norm(conv_same(x, self.Conv_2, d), self.BatchNorm_2, d)
        return F.relu(y + res)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        out = features * 4
        self.add_module("Conv_0", nn.Conv2d(in_ch, features, 1, bias=False))
        self.add_module("BatchNorm_0", _bn(features))
        self.add_module("Conv_1", nn.Conv2d(features, features, 3, stride,
                                            bias=False))
        self.add_module("BatchNorm_1", _bn(features))
        self.add_module("Conv_2", nn.Conv2d(features, out, 1, bias=False))
        self.add_module("BatchNorm_2", _bn(out))
        self.project = in_ch != out or stride != 1
        if self.project:
            self.add_module("Conv_3", nn.Conv2d(in_ch, out, 1, stride,
                                                bias=False))
            self.add_module("BatchNorm_3", _bn(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        y = F.relu(norm(conv_same(x, self.Conv_0, d), self.BatchNorm_0, d))
        y = F.relu(norm(conv_same(y, self.Conv_1, d), self.BatchNorm_1, d))
        y = norm(conv_same(y, self.Conv_2, d), self.BatchNorm_2, d)
        res = x.to(d)
        if self.project:
            res = norm(conv_same(x, self.Conv_3, d), self.BatchNorm_3, d)
        return F.relu(y + res)


class ResNet(nn.Module):
    """Returns the C2..C5 feature pyramid (strides 4, 8, 16, 32)."""

    def __init__(self, depth: int = 50, width: int = 64, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        kind, counts = RESNET_SPECS[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        name = block.__name__
        self.add_module("Conv_0", nn.Conv2d(in_channels, width, 7, 2,
                                            bias=False))
        self.add_module("BatchNorm_0", _bn(width))
        self.stages: List[List[str]] = []
        ch, i_block = width, 0
        for stage, n_blocks in enumerate(counts):
            feats = width * (2 ** stage)
            names = []
            for i in range(n_blocks):
                stride = 2 if (i == 0 and stage > 0) else 1
                self.add_module(f"{name}_{i_block}",
                                block(ch, feats, stride, dtype))
                names.append(f"{name}_{i_block}")
                ch = feats * block.expansion
                i_block += 1
            self.stages.append(names)
        self.out_channels: Tuple[int, ...] = tuple(
            width * (2 ** s) * block.expansion for s in range(4))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        d = self.dtype
        y = F.relu(norm(conv_same(x, self.Conv_0, d), self.BatchNorm_0, d))
        y = max_pool_same(y, 3, 2)
        feats = []
        for names in self.stages:
            for n in names:
                y = getattr(self, n)(y)
            feats.append(y)
        return feats  # [C2 /4, C3 /8, C4 /16, C5 /32]


class FPN(nn.Module):
    """Feature Pyramid Network over C2..C5 -> P2..P5 (+P6, the stride-2
    subsample of P5: flax's 1x1 VALID max-pool)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        n = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"Conv_{i}", nn.Conv2d(c, out_channels, 1))
        for i in range(n):
            self.add_module(f"Conv_{n + i}",
                            nn.Conv2d(out_channels, out_channels, 3))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        d, n = self.dtype, len(feats)
        laterals = [conv_same(f, getattr(self, f"Conv_{i}"), d)
                    for i, f in enumerate(feats)]
        outs = [laterals[-1]]
        for lat in laterals[-2::-1]:
            outs.insert(0, lat + upsample2_crop(outs[0], lat))
        outs = [conv_same(o, getattr(self, f"Conv_{n + i}"), d)
                for i, o in enumerate(outs)]
        return outs + [outs[-1][:, :, ::2, ::2]]  # [P2, P3, P4, P5, P6]


class CombinationModule(nn.Module):
    """CTRBOX decoder block: upsample the deep feature, refine the skip,
    sum."""

    def __init__(self, deep_channels: int, skip_channels: int,
                 out_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.add_module("Conv_0", nn.Conv2d(deep_channels, out_channels, 3))
        self.add_module("BatchNorm_0", _bn(out_channels))
        self.add_module("Conv_1", nn.Conv2d(skip_channels, out_channels, 1))
        self.add_module("BatchNorm_1", _bn(out_channels))

    def forward(self, deep: torch.Tensor, skip: torch.Tensor
                ) -> torch.Tensor:
        d = self.dtype
        up = conv_same(upsample2_crop(deep, skip), self.Conv_0, d)
        up = F.relu(norm(up, self.BatchNorm_0, d))
        sk = F.relu(norm(conv_same(skip, self.Conv_1, d), self.BatchNorm_1, d))
        return up + sk
