"""U-Net backbone and heads as torch ``nn.Module``s (NCHW).

Counterpart of ``mpp_cnn_rs_object_detection_tpu/models/unet.py``:
DoubleConv (reflect pad + 3x3 conv + BatchNorm + ReLU, twice), Down (2x2
max-pool), Up (2x2 stride-2 transposed conv, then ``concat([skip, x])``).
Convolutions run in the configured compute ``dtype`` (bf16 by default, as in
the JAX models) with fp32 parameters; BatchNorm (eps 1e-5, running
statistics) and everything between the convolutions stay fp32.

Submodules carry the flax module names (``UNet_0``, ``Down_1``, ``Conv_0``,
``BatchNorm_1``, ...), so a flax parameter path maps onto a state_dict key
by joining it with dots (``models/checkpoint.py:params_from_jax``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


def infer_pad_hw(h: int, w: int) -> tuple:
    """(target_h, target_w) for whole-image inference: 64-multiples up to a
    256 side, square power-of-two sides beyond (the scene bucket)."""
    if max(h, w) <= 256:
        return -(-h // 64) * 64, -(-w // 64) * 64
    side = 256
    while side < max(h, w):
        side *= 2
    return side, side


def _conv(x: torch.Tensor, conv: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    bias = None if conv.bias is None else conv.bias.to(dtype)
    if isinstance(conv, nn.ConvTranspose2d):
        return F.conv_transpose2d(x.to(dtype), conv.weight.to(dtype), bias,
                                  stride=conv.stride)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias)


class DoubleConv(nn.Module):
    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.add_module("Conv_0", nn.Conv2d(in_features, features, 3))
        self.add_module("BatchNorm_0", nn.BatchNorm2d(features, eps=BN_EPS))
        self.add_module("Conv_1", nn.Conv2d(features, features, 3))
        self.add_module("BatchNorm_1", nn.BatchNorm2d(features, eps=BN_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(2):
            x = F.pad(x.to(self.dtype), (1, 1, 1, 1), mode="reflect")
            x = _conv(x, getattr(self, f"Conv_{i}"), self.dtype)
            bn = getattr(self, f"BatchNorm_{i}")
            x = F.batch_norm(x.float(), bn.running_mean, bn.running_var,
                             bn.weight, bn.bias, False, 0.0, bn.eps)
            x = F.relu(x)
        return x


class Down(nn.Module):
    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.add_module("DoubleConv_0", DoubleConv(in_features, features, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.DoubleConv_0(F.max_pool2d(x, 2, 2))


class Up(nn.Module):
    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        half = in_features // 2
        self.add_module("ConvTranspose_0",
                        nn.ConvTranspose2d(in_features, half, 2, stride=2))
        # skip (features channels) ++ upsampled (half) -> DoubleConv
        self.add_module("DoubleConv_0",
                        DoubleConv(features + half, features, dtype))

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = _conv(x, self.ConvTranspose_0, self.dtype)
        x = torch.cat([skip, x.to(skip.dtype)], dim=1)
        return self.DoubleConv_0(x)


class UNet(nn.Module):
    """Encoder/decoder over ``hidden_dims`` (e.g. [32, 64, 128, 256])."""

    def __init__(self, hidden_dims: Sequence[int], in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_dims = list(hidden_dims)
        self.dtype = dtype
        self.add_module("DoubleConv_0",
                        DoubleConv(in_channels, self.hidden_dims[0], dtype))
        for i in range(1, len(self.hidden_dims)):
            self.add_module(f"Down_{i - 1}", Down(
                self.hidden_dims[i - 1], self.hidden_dims[i], dtype))
        rev = self.hidden_dims[::-1]
        for i, feats in enumerate(rev[1:]):
            self.add_module(f"Up_{i}", Up(rev[i], feats, dtype))

    @property
    def out_channels(self) -> int:
        return self.hidden_dims[0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips: List[torch.Tensor] = []
        x = self.DoubleConv_0(x.to(self.dtype))
        skips.append(x)
        for i in range(1, len(self.hidden_dims)):
            x = getattr(self, f"Down_{i - 1}")(x)
            skips.append(x)
        for i, skip in enumerate(skips[::-1][1:]):
            x = getattr(self, f"Up_{i}")(x, skip)
        return x


class PosNet(nn.Module):
    """U-Net + 1x1 head -> [vec_x, vec_y, mask_logit] (fp32 out)."""

    def __init__(self, hidden_dims: Sequence[int], out_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.add_module("UNet_0", UNet(hidden_dims, dtype=dtype))
        self.add_module("Conv_0", nn.Conv2d(hidden_dims[0], out_channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(self.UNet_0(x), self.Conv_0, self.dtype).float()


class ShapeNet(nn.Module):
    """U-Net + three 1x1 heads -> per-mark class logit maps (fp32 out)."""

    def __init__(self, hidden_dims: Sequence[int], out_features: int = 3,
                 n_classes: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.out_features = out_features
        self.add_module("UNet_0", UNet(hidden_dims, dtype=dtype))
        for i in range(out_features):
            self.add_module(f"Conv_{i}",
                            nn.Conv2d(hidden_dims[0], n_classes, 1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        trunk = self.UNet_0(x)
        return [_conv(trunk, getattr(self, f"Conv_{i}"), self.dtype).float()
                for i in range(self.out_features)]


class DivClassifier(nn.Module):
    """``conv1x1(div_ij(vec) * mask)``: the PosNet's center-logit head.

    Input is NHWC ``concat([vec, mask])`` as in the JAX module; the main
    inference path instead runs the same arithmetic plus the sigmoid in the
    CUDA kernel's ``div_clf`` epilogue (``ops/detection_kernel.py``)."""

    def __init__(self):
        super().__init__()
        self.add_module("Conv_0", nn.Conv2d(1, 1, 1))

    @property
    def scalars(self):
        """(w, b) of the 1x1 conv as host floats (read once, not per call)."""
        return (float(self.Conv_0.weight.detach().reshape(())),
                float(self.Conv_0.bias.detach().reshape(())))

    def forward(self, vec_and_mask: torch.Tensor) -> torch.Tensor:
        from mpp_cnn_rs_object_detection_torch.ops.divergence import (
            divergence_ij,
        )

        vec = vec_and_mask[..., :2]
        mask = vec_and_mask[..., 2]
        x = divergence_ij([vec[..., 0], vec[..., 1]]) * mask
        return x * self.Conv_0.weight.reshape(()) + self.Conv_0.bias.reshape(())
