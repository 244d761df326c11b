"""CTRBOX (BBAVectors) oriented detector as a torch module, with its
targets, losses and decoder.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/models/bbavec_arch.py``:
a ResNet, three ``CombinationModule``s back to stride ``down_ratio`` and
four heads (``HEADS``): ``hm`` (center heatmap, focal loss), ``wh`` (the
t/r/b/l box-boundary-aware vectors and the external w, h), ``reg``
(sub-pixel center offset) and ``cls_theta`` (rotated or horizontal decode).
Each head is a 3x3 conv in the model's dtype, a ReLU and a k x k conv in
fp32 (k = 7 for ``hm``, whose bias starts at -2.19). The functions take a
leading batch axis B where JAX's take one sample and are vmapped.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mpp_cnn_rs_object_detection_torch.models.backbones import (
    CombinationModule,
    ResNet,
    conv_same,
)

HEADS = {"hm": 1, "wh": 10, "reg": 2, "cls_theta": 1}
HM_BIAS = -2.19


class CTRBOX(nn.Module):
    """``forward`` maps (B, 3, H, W) images to the heads' fp32 (B, C, H /
    down_ratio, W / down_ratio) maps. The flax module's auto-named
    submodules: ``ResNet_0``, ``CombinationModule_0..2`` and the heads'
    convs ``Conv_{2i}`` (3x3) and ``Conv_{2i+1}`` (k x k) in ``HEADS``
    order."""

    def __init__(self, depth: int = 101, width: int = 64,
                 head_conv: int = 256, down_ratio: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.down_ratio = down_ratio
        backbone = ResNet(depth=depth, width=width, dtype=dtype)
        self.add_module("ResNet_0", backbone)
        c2, c3, c4, c5 = backbone.out_channels
        for i, (deep, skip) in enumerate(((c5, c4), (c4, c3), (c3, c2))):
            self.add_module(f"CombinationModule_{i}",
                            CombinationModule(deep, skip, skip, dtype))
        for i, (head, ch) in enumerate(HEADS.items()):
            k = 7 if head == "hm" else 3
            self.add_module(f"Conv_{2 * i}", nn.Conv2d(c2, head_conv, 3))
            out = nn.Conv2d(head_conv, ch, k)
            out.flax_bias_init = HM_BIAS if head == "hm" else 0.0
            self.add_module(f"Conv_{2 * i + 1}", out)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        c2, c3, c4, c5 = self.ResNet_0(x)
        y = self.CombinationModule_0(c5, c4)
        y = self.CombinationModule_1(y, c3)
        y = self.CombinationModule_2(y, c2)
        out = {}
        for i, head in enumerate(HEADS):
            t = F.relu(conv_same(y, getattr(self, f"Conv_{2 * i}"),
                                 self.dtype))
            out[head] = conv_same(t, getattr(self, f"Conv_{2 * i + 1}"),
                                  torch.float32)
        return out


# ------------------------------------------------------------------ targets


def ctrbox_targets(centers: torch.Tensor, params: torch.Tensor,
                   valid: torch.Tensor, hw: Tuple[int, int],
                   down_ratio: int = 4) -> Dict[str, torch.Tensor]:
    """Target maps of (B, M) padded GT arrays: the gaussian heatmap (B, fh,
    fw), per object its flat feature index, the BBA vectors and external
    w, h (B, M, 10) at feature stride, the sub-pixel offset and the
    orientation class (0 for a near-horizontal or near-square box)."""
    fh, fw = hw[0] // down_ratio, hw[1] // down_ratio
    dev = centers.device
    c_ds = centers / down_ratio
    hi = torch.tensor([fh - 1, fw - 1], device=dev)
    ci = torch.minimum(torch.clamp(torch.floor(c_ds).int(), min=0), hi)
    reg_t = (c_ds - ci).float()

    a, b, w = params[..., 0], params[..., 1], params[..., 2]
    cos, sin = torch.cos(w), torch.sin(w)
    head = torch.stack([cos * b / 2, sin * b / 2], -1)
    flank = torch.stack([-sin * a / 2, cos * a / 2], -1)
    wh_vec = torch.cat([-head, flank, head, -flank], -1)  # t, r, b, l
    ext_w = torch.abs(b * sin) + torch.abs(a * cos)
    ext_h = torch.abs(b * cos) + torch.abs(a * sin)
    wh_t = torch.cat([wh_vec / down_ratio,
                      torch.stack([ext_w, ext_h], -1) / down_ratio], -1)
    near_horiz = (torch.abs(torch.cos(2 * w)) > 0.99) \
        | (b / torch.clamp(a, min=1e-6) < 1.05)
    cls_t = torch.where(near_horiz, 0.0, 1.0)

    gy = torch.arange(fh, device=dev)[:, None]
    gx = torch.arange(fw, device=dev)[None, :]
    radius = torch.clamp(torch.minimum(ext_w, ext_h) / (2.0 * down_ratio),
                         min=2.0)
    sig = torch.clamp(radius / 3.0, min=1e-3)
    d2 = (gy - c_ds[..., 0, None, None]) ** 2 \
        + (gx - c_ds[..., 1, None, None]) ** 2
    g = torch.exp(-d2 / (2 * sig[..., None, None] ** 2))
    g = torch.where(valid[..., None, None], g, 0.0)
    return {"hm": g.max(dim=1).values.float(),
            "ind": (ci[..., 0] * fw + ci[..., 1]).long(),
            "ind_mask": valid, "wh": wh_t.float(), "reg": reg_t,
            "cls_theta": cls_t.float()}


# ------------------------------------------------------------------- losses


def focal_loss(pred_logits: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """CornerNet-style focal loss per sample of (B, H, W) heatmaps."""
    p = torch.sigmoid(pred_logits)
    pos = gt >= 0.999
    neg_w = torch.pow(1.0 - gt, 4.0)
    pos_loss = torch.log(torch.clamp(p, min=1e-6)) * (1 - p) ** 2
    neg_loss = torch.log(torch.clamp(1 - p, min=1e-6)) * p ** 2 * neg_w
    n_pos = torch.clamp(pos.sum((1, 2)).float(), min=1.0)
    return -torch.where(pos, pos_loss, neg_loss).sum((1, 2)) / n_pos


def _gather_map(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) maps and (B, M) flat indices -> (B, M, C)."""
    flat = feat.reshape(feat.shape[0], feat.shape[1], -1)
    idx = ind[:, None, :].expand(-1, feat.shape[1], -1)
    return torch.gather(flat, 2, idx).transpose(1, 2)


def _smooth_l1_sum(d: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    d = torch.abs(d)
    return (torch.where(d < 1.0, 0.5 * d ** 2, d - 0.5)
            * mask[..., None]).sum((1, 2))


def ctrbox_loss(outs: Dict[str, torch.Tensor],
                targets: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-sample (B,) losses: focal on hm, smooth-L1 on wh and reg at the
    GT centers, BCE on cls_theta there."""
    mask = targets["ind_mask"].float()
    n = torch.clamp(mask.sum(1), min=1.0)
    hm_l = focal_loss(outs["hm"][:, 0], targets["hm"])
    wh_l = _smooth_l1_sum(_gather_map(outs["wh"], targets["ind"])
                          - targets["wh"], mask) / (n * 10.0)
    reg_l = _smooth_l1_sum(_gather_map(outs["reg"], targets["ind"])
                           - targets["reg"], mask) / (n * 2.0)
    th = _gather_map(outs["cls_theta"], targets["ind"])[..., 0]
    th_bce = torch.clamp(th, min=0) - th * targets["cls_theta"] \
        + torch.log1p(torch.exp(-torch.abs(th)))
    th_l = (th_bce * mask).sum(1) / n
    return {"loss": hm_l + wh_l + reg_l + th_l, "hm_loss": hm_l,
            "wh_loss": wh_l, "off_loss": reg_l, "cls_theta_loss": th_l}


# ------------------------------------------------------------------ decoder


def ctrbox_decode(outs: Dict[str, torch.Tensor], k: int = 500,
                  down_ratio: int = 4):
    """One image's heads ((C, H, W) maps) -> (scores (K,), quads (K, 4, 2)
    in image (row, col) pixels, centers (K, 2)): the 3x3 max-pool NMS
    (-inf padding) on the heatmap, the top K (ties lower index first, as
    ``lax.top_k``), BBA-vector -> quad decode gated by cls_theta."""
    hm = torch.sigmoid(outs["hm"][0])
    hmax = F.max_pool2d(hm[None], 3, 1, padding=1)[0]
    hm_nms = torch.where(hmax == hm, hm, torch.zeros((), device=hm.device))
    fh, fw = hm.shape
    flat = hm_nms.reshape(-1)
    k = min(k, flat.shape[0])
    scores, inds = torch.sort(flat, descending=True, stable=True)
    scores, inds = scores[:k], inds[:k]
    ys = (inds // fw).float()
    xs = (inds % fw).float()
    reg = outs["reg"].reshape(2, -1)[:, inds].T
    ys = ys + reg[:, 0]
    xs = xs + reg[:, 1]
    wh = outs["wh"].reshape(10, -1)[:, inds].T
    theta = torch.sigmoid(outs["cls_theta"].reshape(-1)[inds])
    rot = (theta > 0.8)[:, None]
    c = torch.stack([ys, xs], -1)
    z = torch.zeros_like(ys)
    tt = torch.where(rot, c + wh[:, 0:2], c - torch.stack([wh[:, 9] / 2, z],
                                                            -1))
    rr = torch.where(rot, c + wh[:, 2:4], c + torch.stack([z, wh[:, 8] / 2],
                                                            -1))
    bb = torch.where(rot, c + wh[:, 4:6], c + torch.stack([wh[:, 9] / 2, z],
                                                            -1))
    ll = torch.where(rot, c + wh[:, 6:8], c - torch.stack([z, wh[:, 8] / 2],
                                                            -1))
    corners = torch.stack([tt + rr - c, rr + bb - c, bb + ll - c,
                           ll + tt - c], 1)
    return scores, corners * down_ratio, c * down_ratio
