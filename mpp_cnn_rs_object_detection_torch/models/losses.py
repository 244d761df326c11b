"""Training losses of the PosNet and the ShapeNet.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/models/losses.py``: the
pointing-vector loss (MSE of the vectors, balanced or focal BCE of the mask
and of the DivClassifier head's center logits) and the masked per-pixel
cross-entropy with ordinal label smoothing. The formulas, their order and
the dict keys (``log.json`` is keyed by them) are the JAX package's.

Layout: network outputs are channels-first, as the port's U-Nets emit them
(``(B, C, H, W)``); targets and masks are ``(B, H, W)`` maps and the
pointing target is ``(B, H, W, 2)``, as ``data/device_pipeline.py`` paints
them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

EPS = 1e-5


def binary_focal_loss_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                                  alpha: float = 0.25, gamma: float = 2.0
                                  ) -> torch.Tensor:
    p = torch.sigmoid(logits)
    ce = -(targets * torch.log(p + EPS)
           + (1 - targets) * torch.log(1 - p + EPS))
    p_t = p * targets + (1 - p) * (1 - targets)
    alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
    return torch.mean(alpha_t * (1 - p_t) ** gamma * ce)


def _balanced_bce(logits: torch.Tensor, targets: torch.Tensor,
                  balanced: bool) -> torch.Tensor:
    """BCE of the logits; ``balanced`` weighs positives by ``beta = 1 -
    mean(targets)`` over the whole batch and negatives by ``1 - beta``."""
    sig = torch.sigmoid(logits)
    if not balanced:
        return torch.mean(-(targets * torch.log(sig + EPS)
                            + (1 - targets) * torch.log(1 - sig + EPS)))
    beta = 1 - torch.sum(targets) / targets.numel()
    loss = (-beta * targets * torch.log(sig + EPS)
            - (1 - beta) * (1 - targets) * torch.log(1 - sig + EPS))
    return torch.mean(loss)


def pointing_vector_loss(output: torch.Tensor, target_vec: torch.Tensor,
                         target_mask: Optional[torch.Tensor] = None,
                         div_score: Optional[torch.Tensor] = None,
                         center_bin_map: Optional[torch.Tensor] = None,
                         learn_mask: bool = True, compute_mask: bool = True,
                         balanced_mask_loss: bool = True,
                         focal_loss: bool = False,
                         vec_loss_on_prod: bool = True
                         ) -> Dict[str, torch.Tensor]:
    """PosNet loss. ``output`` is (B, 3, H, W): [vec_x, vec_y, mask_logit];
    ``target_vec`` (B, H, W, 2); the masks and ``div_score`` (B, H, W)."""
    output_vec = output[:, :2].permute(0, 2, 3, 1)
    output_mask = output[:, 2]

    if vec_loss_on_prod:
        sig = torch.sigmoid(output_mask)[..., None]
        vec_loss = torch.mean(torch.square(output_vec * sig - target_vec))
    else:
        pixel_loss = torch.square(output_vec - target_vec)
        if compute_mask and target_mask is not None:
            pixel_loss = torch.mean(pixel_loss, dim=-1) * target_mask
        vec_loss = torch.mean(pixel_loss)

    out = {"vec_loss": vec_loss, "loss": vec_loss}

    if learn_mask and target_mask is not None:
        if focal_loss:
            mask_loss = binary_focal_loss_with_logits(output_mask, target_mask)
        else:
            mask_loss = _balanced_bce(output_mask, target_mask,
                                      balanced_mask_loss)
        out["mask_loss"] = mask_loss
        out["loss"] = out["loss"] + mask_loss

    if div_score is not None:
        assert center_bin_map is not None
        if focal_loss:
            div_loss = binary_focal_loss_with_logits(div_score, center_bin_map)
        else:
            div_loss = _balanced_bce(div_score, center_bin_map,
                                     balanced_mask_loss)
        out["div_loss"] = div_loss
        out["loss"] = out["loss"] + div_loss
    return out


def pixel_ce_loss(inputs: List[torch.Tensor], targets: List[torch.Tensor],
                  loss_mask: torch.Tensor, focal_loss: bool = False,
                  focal_alpha: float = 0.5, focal_gamma: float = 2.0,
                  label_smoothing_sigma: float = 0.0,
                  cyclic_heads: tuple = (2,)) -> Dict[str, torch.Tensor]:
    """ShapeNet loss: per-pixel CE of each mark head, weighted by the
    normalised loss mask, summed over pixels and averaged over the batch.

    ``inputs[i]`` is (B, C, H, W) logits, ``targets[i]`` (B, H, W) int,
    ``loss_mask`` (B, H, W) summing to 1 per item. With
    ``label_smoothing_sigma`` > 0 the target is a Gaussian over the bins
    (sigma in bins), with the cyclic bin distance on ``cyclic_heads``."""
    out: Dict[str, torch.Tensor] = {}
    total = 0.0
    for i, (logits, tgt) in enumerate(zip(inputs, targets)):
        logp = torch.log_softmax(logits, dim=1)
        if label_smoothing_sigma > 0.0:
            n_cls = logits.shape[1]
            cls = torch.arange(n_cls, dtype=torch.float32,
                               device=logits.device)
            d = torch.abs(cls[None, :, None, None]
                          - tgt[:, None].to(torch.float32))
            if i in cyclic_heads:
                d = torch.minimum(d, n_cls - d)
            w = torch.exp(-0.5 * torch.square(d / label_smoothing_sigma))
            w = w / torch.sum(w, dim=1, keepdim=True)
            pp = -torch.sum(w * logp, dim=1)
        else:
            pp = -torch.gather(logp, 1, tgt[:, None].to(torch.int64))[:, 0]
        if focal_loss:
            p_t = torch.exp(-pp)
            pp = focal_alpha * (1 - p_t) ** focal_gamma * pp
        feat_loss = torch.mean(torch.sum(pp * loss_mask, dim=(1, 2)))
        out[f"loss_feat{i}"] = feat_loss
        total = total + feat_loss
    out["loss"] = total
    return out
