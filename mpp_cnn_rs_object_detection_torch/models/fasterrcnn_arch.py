"""Two-stage Faster R-CNN as torch modules and functions: ResNet-FPN + RPN +
ROIAlign + box head.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/models/fasterrcnn_arch.py``
with the same static-shape design (per-level top-K, a greedy NMS over a
bounded pool, exact per-example weighting in place of torchvision's
sampling). Every function takes a leading batch axis B where JAX's takes one
image and is vmapped: ``select_proposals`` and the losses run all images of
a batch in one set of launches. Boxes are (y1, x1, y2, x2) in pixels.

The greedy NMS (``masked_nms``) is sequential: its pass over the pool runs
on the host (numpy) over the IoU test computed on the device, all images
of a batch together, one step per pool position; the proposals it picks
carry no gradient (JAX's ``stop_gradient``). Ranking uses stable sorts, so
ties (common among bf16 logits) keep JAX's lower-index-first order.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mpp_cnn_rs_object_detection_torch.models.backbones import (
    FPN,
    ResNet,
    conv_same,
)

# ------------------------------------------------------------------ anchors


def make_anchors(fm_shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                 sizes: Sequence[float], ratios: Sequence[float]
                 ) -> List[np.ndarray]:
    """Per-level (H*W*A, 4) anchor boxes; level i uses ``sizes[i]`` at all
    ``ratios`` (torchvision AnchorGenerator semantics), ordered (h, w, a)."""
    out = []
    for (h, w), stride, size in zip(fm_shapes, strides, sizes):
        ys = (np.arange(h) + 0.5) * stride
        xs = (np.arange(w) + 0.5) * stride
        cy, cx = np.meshgrid(ys, xs, indexing="ij")
        boxes = []
        for r in ratios:
            ah = size * np.sqrt(r)
            aw = size / np.sqrt(r)
            boxes.append(np.stack(
                [cy - ah / 2, cx - aw / 2, cy + ah / 2, cx + aw / 2],
                axis=-1))
        out.append(np.stack(boxes, axis=2).reshape(-1, 4).astype(np.float32))
    return out


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor
                 ) -> torch.Tensor:
    """(dy, dx, dh, dw) deltas -> boxes over any leading axes; the size
    deltas clipped to +-4 before the exp. In float32 whatever the deltas'
    dtype: XLA folds away the bf16 rounding of JAX's jitted decode."""
    deltas = deltas.float()
    ah = anchors[..., 2] - anchors[..., 0]
    aw = anchors[..., 3] - anchors[..., 1]
    ay = (anchors[..., 0] + anchors[..., 2]) / 2
    ax = (anchors[..., 1] + anchors[..., 3]) / 2
    cy = ay + deltas[..., 0] * ah
    cx = ax + deltas[..., 1] * aw
    h = ah * torch.exp(torch.clamp(deltas[..., 2], -4.0, 4.0))
    w = aw * torch.exp(torch.clamp(deltas[..., 3], -4.0, 4.0))
    return torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)


def encode_boxes(anchors: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    ah = torch.clamp(anchors[..., 2] - anchors[..., 0], min=1e-6)
    aw = torch.clamp(anchors[..., 3] - anchors[..., 1], min=1e-6)
    ay = (anchors[..., 0] + anchors[..., 2]) / 2
    ax = (anchors[..., 1] + anchors[..., 3]) / 2
    bh = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1e-6)
    bw = torch.clamp(boxes[..., 3] - boxes[..., 1], min=1e-6)
    by = (boxes[..., 0] + boxes[..., 2]) / 2
    bx = (boxes[..., 1] + boxes[..., 3]) / 2
    return torch.stack([(by - ay) / ah, (bx - ax) / aw, torch.log(bh / ah),
                        torch.log(bw / aw)], -1)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., Na, Nb) IoU of (..., Na, 4) and (..., Nb, 4) boxes."""
    lo = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    hi = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(hi - lo, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) \
        * torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) \
        * torch.clamp(b[..., 3] - b[..., 1], min=0)
    return inter / torch.clamp(area_a[..., :, None] + area_b[..., None, :]
                               - inter, min=1e-9)


def _desc_order(x: torch.Tensor) -> torch.Tensor:
    """``jnp.argsort(-x)`` along the last axis: stable, ties lower index
    first."""
    return torch.sort(-x, dim=-1, stable=True).indices


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b]]`` for (B, n, ...) ``x`` and (B, k) ``idx``."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx]


def greedy_keep(over: np.ndarray, order: np.ndarray, valid: np.ndarray
                ) -> np.ndarray:
    """The greedy pass of ``masked_nms`` for B pools at once: (B, n, n)
    ``over`` (IoU at or above the threshold), (B, n) visiting ``order`` and
    ``valid``. A box is kept if valid and no box kept before it overlaps
    it (a box not yet visited is not kept, so it never suppresses)."""
    b, n = valid.shape
    rows = np.arange(b)
    kept = np.zeros((b, n), bool)
    for i in range(n):
        idx = order[:, i]
        sup = (kept & over[rows, idx]).any(axis=1)
        kept[rows, idx] = valid[rows, idx] & ~sup
    return kept


def masked_nms(boxes: torch.Tensor, scores: torch.Tensor,
               valid: torch.Tensor, iou_thresh: float, top_n: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of (B, n) pools with static shapes: (keep_idx (B, top_n),
    keep_valid). The IoU test runs on the device, the greedy pass on the
    host, the ranking of the kept boxes on the device."""
    ninf = torch.tensor(float("-inf"), dtype=scores.dtype,
                        device=scores.device)
    over = box_iou(boxes, boxes) >= iou_thresh
    order = _desc_order(torch.where(valid, scores, ninf))
    kept = torch.from_numpy(greedy_keep(
        over.cpu().numpy(), order.cpu().numpy(), valid.cpu().numpy())
    ).to(scores.device)
    top_idx = _desc_order(torch.where(kept, scores, ninf))[:, :top_n]
    return top_idx, _take(kept, top_idx)


# ---------------------------------------------------------------- ROIAlign


def _linspace_mid(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """Bin centres of ``jnp.linspace(lo, hi, n + 1)`` in its float32
    arithmetic (``lo * (1 - t) + hi * t``, the last point ``hi``)."""
    t = torch.arange(n, dtype=torch.float32, device=lo.device) / n
    pts = lo[..., None] * (1 - t) + hi[..., None] * t
    pts = torch.cat([pts, hi[..., None]], -1)
    return (pts[..., :-1] + pts[..., 1:]) / 2


def roi_align(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
              strides: Sequence[int], out_size: int = 7,
              canonical: float = 224.0) -> torch.Tensor:
    """(B, N, out, out, C) fp32 ROI features of (B, N, 4) boxes over the
    (B, C, H, W) levels: one bilinear sample per bin centre, integer
    indices clamped to the map, from the level of the FPN rule
    ``floor(log2(sqrt(area) / canonical + 1e-9)) + L - 1`` clipped to the
    levels. Gradients reach only that level."""
    n_levels = len(feats)
    b, n = boxes.shape[:2]
    c = feats[0].shape[1]
    dev = boxes.device
    area = torch.clamp(boxes[..., 2] - boxes[..., 0], min=1.0) \
        * torch.clamp(boxes[..., 3] - boxes[..., 1], min=1.0)
    k = torch.floor(torch.log2(torch.sqrt(area) / canonical + 1e-9)) \
        + (n_levels - 1)
    k = torch.clamp(k, 0, n_levels - 1).long()
    sizes = [(f.shape[2], f.shape[3]) for f in feats]
    flat = torch.cat([f.permute(0, 2, 3, 1).reshape(b, -1, c) for f in feats],
                     1).reshape(-1, c)
    offs = np.cumsum([0] + [h * w for h, w in sizes])[:-1]
    table = torch.tensor([[o, h, w, s] for o, (h, w), s
                          in zip(offs, sizes, strides)], device=dev)
    off, h, w, stride = (table[k][..., i] for i in range(4))
    off = off + torch.arange(b, device=dev)[:, None] * int(
        sum(hh * ww for hh, ww in sizes))
    st = stride.float()[..., None]
    cy = _linspace_mid(boxes[..., 0], boxes[..., 2], out_size) / st - 0.5
    cx = _linspace_mid(boxes[..., 1], boxes[..., 3], out_size) / st - 0.5
    hm, wm = (h - 1)[..., None], (w - 1)[..., None]
    y0 = torch.minimum(torch.clamp(torch.floor(cy).long(), min=0), hm)
    x0 = torch.minimum(torch.clamp(torch.floor(cx).long(), min=0), wm)
    y1 = torch.minimum(y0 + 1, hm)
    x1 = torch.minimum(x0 + 1, wm)
    fy = torch.clamp(cy - y0, 0.0, 1.0)[..., :, None, None]
    fx = torch.clamp(cx - x0, 0.0, 1.0)[..., None, :, None]
    base = off[..., None, None]
    wd = w[..., None, None]

    def g(yy, xx):
        return flat[base + yy[..., :, None] * wd + xx[..., None, :]]

    return (g(y0, x0) * (1 - fy) * (1 - fx)
            + g(y0, x1) * (1 - fy) * fx
            + g(y1, x0) * fy * (1 - fx)
            + g(y1, x1) * fy * fx)


# ------------------------------------------------------------------ modules


class RPNHead(nn.Module):
    def __init__(self, channels: int, n_anchors: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.rpn_conv = nn.Conv2d(channels, channels, 3)
        self.rpn_cls = nn.Conv2d(channels, n_anchors, 1)
        self.rpn_reg = nn.Conv2d(channels, n_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, sum H*W*A) logits and (B, sum H*W*A, 4) deltas, anchors in
        (h, w, a) order (the NCHW outputs permuted to NHWC first)."""
        logits, deltas = [], []
        for f in feats:
            t = F.relu(conv_same(f, self.rpn_conv, self.dtype))
            b = f.shape[0]
            logits.append(conv_same(t, self.rpn_cls, self.dtype)
                          .permute(0, 2, 3, 1).reshape(b, -1))
            deltas.append(conv_same(t, self.rpn_reg, self.dtype)
                          .permute(0, 2, 3, 1).reshape(b, -1, 4))
        return torch.cat(logits, 1), torch.cat(deltas, 1)


class BoxHead(nn.Module):
    """Two ``hidden`` dense layers in the model's dtype on the (h, w, c)
    flattened rois, then fp32 class logits (background, vehicle) and a
    class-agnostic box refinement."""

    def __init__(self, in_features: int, hidden: int = 1024,
                 n_classes: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.add_module("Dense_0", nn.Linear(in_features, hidden))
        self.add_module("Dense_1", nn.Linear(hidden, hidden))
        self.add_module("Dense_2", nn.Linear(hidden, n_classes))
        self.add_module("Dense_3", nn.Linear(hidden, 4))

    def forward(self, rois: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        d = self.dtype
        x = rois.reshape(rois.shape[0], -1)
        for i in range(2):
            lin = getattr(self, f"Dense_{i}")
            x = F.relu(F.linear(x.to(d), lin.weight.to(d), lin.bias.to(d)))
        x = x.float()
        return self.Dense_2(x), self.Dense_3(x)


class FasterRCNN(nn.Module):
    """Backbone + FPN + RPN + ROI head; ``forward`` returns the per-level
    features [P2..P6] and the RPN outputs (the proposal and ROI logic are
    the functions of this module). Three anchor ratios per location, as
    the JAX module's ``n_ratios``."""

    def __init__(self, depth: int = 50, width: int = 64,
                 fpn_channels: int = 256, n_ratios: int = 3,
                 box_hidden: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNet(depth=depth, width=width, dtype=dtype)
        self.fpn = FPN(self.backbone.out_channels, fpn_channels, dtype=dtype)
        self.rpn = RPNHead(fpn_channels, n_ratios, dtype=dtype)
        self.box_head = BoxHead(7 * 7 * fpn_channels, box_hidden, dtype=dtype)

    def forward(self, x: torch.Tensor):
        """(B, 3, H, W) -> (feats, rpn_logits, rpn_deltas)."""
        feats = self.fpn(self.backbone(x))
        logits, deltas = self.rpn(feats)
        return feats, logits, deltas


# --------------------------------------------------------------- functional


def smooth_l1(x: torch.Tensor, beta: float = 1.0 / 9.0) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax ** 2 / beta, ax - 0.5 * beta)


def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy`` as JAX writes it out, in
    float32 (as XLA computes JAX's jitted bf16 version)."""
    logits = logits.float()
    return torch.clamp(logits, min=0) - logits * labels \
        + torch.log1p(torch.exp(-torch.abs(logits)))


def _matches(boxes: torch.Tensor, gt: torch.Tensor, gt_valid: torch.Tensor):
    """IoU of (B, n) boxes with the (B, M) valid GT (-1 at invalid), its
    best value and the first GT reaching it."""
    iou = torch.where(gt_valid[:, None, :], box_iou(boxes, gt),
                      torch.tensor(-1.0, device=gt.device))
    best, arg = iou.max(dim=2)
    return iou, best, arg


def rpn_targets(anchors: torch.Tensor, gt: torch.Tensor,
                gt_valid: torch.Tensor, pos_iou: float = 0.7,
                neg_iou: float = 0.3):
    """Anchor labels (B, A) (1 pos / 0 neg / -1 ignore) and matched GT
    boxes; every valid GT claims its best anchors (ties within 1e-6)."""
    b = gt.shape[0]
    iou, best, arg = _matches(anchors.expand(b, -1, -1), gt, gt_valid)
    one, zero, ign = (torch.tensor(v, device=gt.device) for v in (1, 0, -1))
    labels = torch.where(best >= pos_iou, one,
                         torch.where(best < neg_iou, zero, ign))
    best_per_gt = iou.max(dim=1).values  # (B, M)
    claims = (iou >= best_per_gt[:, None, :] - 1e-6) \
        & gt_valid[:, None, :] & (best_per_gt[:, None, :] > 0)
    labels = torch.where(claims.any(dim=2), one, labels)
    return labels, _take(gt, arg)


def rpn_loss(logits: torch.Tensor, deltas: torch.Tensor,
             anchors: torch.Tensor, gt: torch.Tensor, gt_valid: torch.Tensor,
             n_sample: float = 256.0, pos_iou: float = 0.7,
             neg_iou: float = 0.3):
    """Per-image (cls, reg) RPN losses (B,), exact weighting standing in
    for torchvision's 1:1 sampling of 256 anchors."""
    labels, matched = rpn_targets(anchors, gt, gt_valid, pos_iou=pos_iou,
                                  neg_iou=neg_iou)
    pos, neg = labels == 1, labels == 0
    n_pos = torch.clamp(pos.sum(1, keepdim=True).float(), min=1.0)
    n_neg = torch.clamp(neg.sum(1, keepdim=True).float(), min=1.0)
    zero = torch.zeros((), device=gt.device)
    w_pos = torch.where(pos, 0.5 * n_sample / n_pos, zero)
    w_neg = torch.where(neg, 0.5 * n_sample / n_neg, zero)
    w = torch.clamp(w_pos + w_neg, max=n_sample)
    cls_loss = (w * sigmoid_ce(logits, pos.float())).sum(1) / n_sample
    t = encode_boxes(anchors, matched)
    reg = torch.where(pos[..., None], smooth_l1(deltas - t), zero).sum(
        (1, 2)) / torch.clamp(pos.sum(1).float() * 4.0, min=1.0)
    return cls_loss, reg


def select_proposals(rpn_logits: torch.Tensor, rpn_deltas: torch.Tensor,
                     anchors_per_level: Sequence[torch.Tensor],
                     hw: Tuple[int, int], pre_nms_top_n: int,
                     post_nms_top_n: int, nms_thresh: float = 0.7,
                     min_size: float = 1.0):
    """Static-shape proposal selection for B images: per level the top
    ``pre_nms_top_n`` logits, decoded and clipped to the image; the pool of
    the best ``max(4 * post_nms_top_n, 64)`` boxes of at least
    ``min_size``; the greedy NMS. Returns (boxes (B, post, 4), scores,
    valid)."""
    start = 0
    cand_boxes, cand_scores = [], []
    for anc in anchors_per_level:
        n = anc.shape[0]
        lg = rpn_logits[:, start:start + n]
        dl = rpn_deltas[:, start:start + n]
        top = _desc_order(lg)[:, :min(pre_nms_top_n, n)]
        boxes = decode_boxes(anc[top], _take(dl, top))
        lim = torch.tensor([hw[0], hw[1], hw[0], hw[1]], dtype=boxes.dtype,
                           device=boxes.device)
        cand_boxes.append(torch.minimum(torch.clamp(boxes, min=0), lim))
        cand_scores.append(_take(lg, top))
        start += n
    boxes = torch.cat(cand_boxes, 1)
    scores = torch.cat(cand_scores, 1)
    ok = (boxes[..., 2] - boxes[..., 0] >= min_size) \
        & (boxes[..., 3] - boxes[..., 1] >= min_size)
    pool = min(boxes.shape[1], max(4 * post_nms_top_n, 64))
    ninf = torch.tensor(float("-inf"), dtype=scores.dtype,
                        device=scores.device)
    top = _desc_order(torch.where(ok, scores, ninf))[:, :pool]
    boxes, scores, ok = _take(boxes, top), _take(scores, top), _take(ok, top)
    keep_idx, keep_valid = masked_nms(boxes, scores, ok, nms_thresh,
                                      post_nms_top_n)
    return _take(boxes, keep_idx), _take(scores, keep_idx), keep_valid


def roi_targets(proposals: torch.Tensor, valid: torch.Tensor,
                gt: torch.Tensor, gt_valid: torch.Tensor,
                pos_iou: float = 0.5):
    """(labels, matched GT, positives) of (B, N) proposals."""
    _, best, arg = _matches(proposals, gt, gt_valid)
    pos = (best >= pos_iou) & valid
    return pos.long(), _take(gt, arg), pos


def roi_loss(cls_logits: torch.Tensor, reg: torch.Tensor,
             proposals: torch.Tensor, labels: torch.Tensor,
             matched: torch.Tensor, pos: torch.Tensor, valid: torch.Tensor,
             n_sample: float = 128.0):
    """Per-image (cls, reg) box-head losses (B,): positives weighted to a
    quarter of ``n_sample``, valid negatives to three quarters."""
    n_pos = torch.clamp(pos.sum(1, keepdim=True).float(), min=1.0)
    n_neg = torch.clamp((valid & ~pos).sum(1, keepdim=True).float(), min=1.0)
    zero = torch.zeros((), device=pos.device)
    w = torch.where(pos, 0.25 * n_sample / n_pos,
                    torch.where(valid, 0.75 * n_sample / n_neg, zero))
    logp = torch.log_softmax(cls_logits, dim=-1)
    ce = -torch.gather(logp, -1, labels[..., None])[..., 0]
    cls_loss = (w * ce).sum(1) / n_sample
    t = encode_boxes(proposals, matched)
    reg_loss = torch.where(pos[..., None], smooth_l1(reg - t), zero).sum(
        (1, 2)) / torch.clamp(n_pos[:, 0] * 4.0, min=1.0)
    return cls_loss, reg_loss
