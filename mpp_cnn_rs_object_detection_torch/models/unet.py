"""U-Net backbone and heads as torch ``nn.Module``s (NCHW).

Counterpart of ``mpp_cnn_rs_object_detection_tpu/models/unet.py``:
DoubleConv (reflect pad + 3x3 conv + BatchNorm + ReLU, twice), Down (2x2
max-pool), Up (2x2 stride-2 transposed conv, then ``concat([skip, x])``).
Convolutions run in the configured compute ``dtype`` (bf16 by default, as in
the JAX models) with fp32 parameters, whose gradients come back through the
casts; BatchNorm (eps 1e-5) and everything between the convolutions stay
fp32. In eval mode BatchNorm uses the running statistics; in train mode
(``module.train()``) it normalises with flax's batch statistics and updates
the running ones as flax does (``batch_norm_train``).

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
# flax nn.BatchNorm(momentum=0.9): ra = 0.9 * ra + 0.1 * batch statistic
BN_MOMENTUM = 0.9
# flax's lecun_normal: a normal truncated at two standard deviations, whose
# std is 1 / sqrt(fan_in) after dividing by the truncation's std factor
_TRUNC_STD = 0.87962566103423978


def infer_pad_hw(h: int, w: int) -> tuple:
    """(target_h, target_w) for whole-image inference: 64-multiples up to a
    256 side, square power-of-two sides beyond (the scene bucket)."""
    if max(h, w) <= 256:
        return -(-h // 64) * 64, -(-w // 64) * 64
    side = 256
    while side < max(h, w):
        side *= 2
    return side, side


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d,
                     momentum: float = BN_MOMENTUM) -> torch.Tensor:
    """flax ``nn.BatchNorm(use_running_average=False, momentum=momentum)``
    of an fp32 NCHW tensor: the batch mean and the biased variance
    ``max(E[x^2] - E[x]^2, 0)`` over (N, H, W), ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias``, and the running statistics moved
    to ``momentum * ra + (1 - momentum) * stat`` (torch's own batch norm
    would store the unbiased variance). The U-Nets set momentum 0.9, the
    detectors' backbones keep flax's default 0.99."""
    mean = x.mean(dim=(0, 2, 3))
    mean2 = torch.square(x).mean(dim=(0, 2, 3))
    var = torch.clamp(mean2 - torch.square(mean), min=0.0)
    with torch.no_grad():
        bn.running_mean.copy_(momentum * bn.running_mean
                              + (1 - momentum) * mean)
        bn.running_var.copy_(momentum * bn.running_var
                             + (1 - momentum) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return ((x - mean[:, None, None]) * mul[:, None, None]
            + bn.bias[:, None, None])


def init_like_flax_(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise ``module`` with flax's default initialisers, drawn from
    ``generator``: lecun-normal conv and dense kernels (fan-in = in x kh x
    kw, also for transposed convs; in for ``nn.Linear``), biases zero or
    the module's own constant ``flax_bias_init`` (as a flax
    ``bias_init=constant(c)``), BatchNorm scale 1 and bias 0 with mean-0 /
    var-1 statistics. JAX's own draws (threefry) are not reproducible in
    torch; a state carried over from JAX is exact
    (``models/checkpoint.py:train_state_from_jax``)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = m.weight
                in_ch = w.shape[0] if isinstance(m, nn.ConvTranspose2d) \
                    else w.shape[1]
                fan_in = in_ch * (1 if isinstance(m, nn.Linear)
                                  else w.shape[2] * w.shape[3])
                std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
                z = torch.empty(w.shape, dtype=torch.float32)
                nn.init.trunc_normal_(z, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                w.copy_(z * std)
                if m.bias is not None:
                    m.bias.fill_(getattr(m, "flax_bias_init", 0.0))
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


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
            if self.training:
                x = batch_norm_train(x.float(), bn)
            else:
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

    Input is NHWC ``concat([vec, mask])`` as in the JAX module; training
    runs it under autograd (``ops/divergence.divergence_ij``, as the JAX
    package computes it in XLA), while the main inference path runs the
    same arithmetic plus the sigmoid in the CUDA kernel's ``div_clf``
    epilogue (``ops/detection_kernel.py``)."""

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
