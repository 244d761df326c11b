"""Device-resident CNN training data: patch stacks, augmentation and
targets.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/data/device_pipeline.py``:

  - ``build_patch_stack`` (host numpy) samples and extracts a regeneration's
    patches into a uint8 (N, P, P, 3) stack with fixed-capacity annotation
    arrays, with copy-paste on the train stack. It draws from the numpy
    generator in the JAX package's order, so the same seed gives the same
    stack;
  - the stack lives on the device; each batch is gathered from it,
    augmented (dihedral-8 and the 'medium' photometric family) and turned
    into training targets there, batched over B.

JAX draws each batch's augmentation from a threefry key, which torch cannot
reproduce. So augmentation is split into ``draw_augment_variates`` (every
random number of a batch, from an explicit ``torch.Generator``) and the
deterministic ``augment_batch``, which the tests feed with the variates
JAX's ``augment_batch`` draws.

Targets (``pos_targets``, ``shape_targets``) paint per-pixel maps from up to
M objects per patch: (B, M, P, P) wide. The trainer trims M to the batch's
largest object count, known on the host (objects fill each patch's slots
from the front), which changes no target.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Union

import numpy as np
import torch

from mpp_cnn_rs_object_detection_torch.data.dataset import (
    load_annotation,
    load_image,
)
from mpp_cnn_rs_object_detection_torch.data.patch_samplers import (
    MixedSampler,
    ObjectSampler,
    UniformSampler,
)
from mpp_cnn_rs_object_detection_torch.ops.mappings import ValueMapping
from mpp_cnn_rs_object_detection_torch.utils.config import fetch_data_paths

# --------------------------------------------------------------------- host


@dataclass
class PatchStack:
    """A regenerated training set as arrays: images uint8 (N, P, P, 3),
    annotations padded to M objects with a valid mask."""

    images: np.ndarray   # (N, P, P, 3) uint8
    centers: np.ndarray  # (N, M, 2) float32 (row, col)
    params: np.ndarray   # (N, M, 3) float32 (a, b, w)
    valid: np.ndarray    # (N, M) bool


def build_patch_stack(dataset: str, subset: str, n_patches: int,
                      patch_size: int, rng: np.random.Generator,
                      unf_weight: float = 0.33, obj_weight: float = 0.66,
                      sigma: float = 10.0, max_objects: int = 128,
                      copy_paste: dict = None) -> PatchStack:
    """Sample and extract ``n_patches`` patches into arrays: the mixed
    uniform/object sampler, one multinomial split over the images, each
    patch a slice of the zero-padded uint8 image with its objects
    re-anchored. ``copy_paste`` (train stacks) pastes bank objects into a
    patch with probability ``p``."""
    paths = fetch_data_paths(dataset, subset)
    paste_bank = None
    if copy_paste:
        from mpp_cnn_rs_object_detection_torch.data.copy_paste import (
            build_paste_bank,
        )

        paste_bank = build_paste_bank(paths["images"], paths["annotations"])
    sampler = MixedSampler(
        n_patches=n_patches,
        samplers=[
            UniformSampler(n_patches=n_patches, patch_size=patch_size,
                           rng=rng),
            ObjectSampler(n_patches=n_patches, patch_size=patch_size, rng=rng,
                          sigma=sigma),
        ],
        weights=[unf_weight, obj_weight],
        rng=rng,
    )
    sampler.initialise(paths["images"], paths["annotations"],
                       paths["metadata"])
    per_image = rng.multinomial(n=n_patches,
                                pvals=sampler.sample_density_per_image)

    imgs = np.zeros((n_patches, patch_size, patch_size, 3), np.uint8)
    cen = np.zeros((n_patches, max_objects, 2), np.float32)
    par = np.zeros((n_patches, max_objects, 3), np.float32)
    val = np.zeros((n_patches, max_objects), bool)

    k = 0
    overflow = 0
    half = patch_size // 2
    for i, (img_path, ann_path) in enumerate(
            zip(paths["images"], paths["annotations"])):
        if per_image[i] == 0:
            continue
        image = load_image(img_path)
        ann = load_annotation(ann_path)
        centers = np.asarray(ann["centers"], np.float64).reshape(-1, 2)
        params = np.asarray(ann["parameters"], np.float64).reshape(-1, 3)
        shape = np.array(image.shape[:2])
        # pad once; each patch is then a uint8 slice
        padded_u8 = np.pad(
            (np.clip(image, 0, 1) * 255).astype(np.uint8),
            ((half, half), (half, half), (0, 0)),
        )
        for _ in range(int(per_image[i])):
            anchor = np.asarray(sampler.sample_patch_center(
                image_id=i, shape=shape, centers=centers), int)
            imgs[k] = padded_u8[anchor[0]:anchor[0] + patch_size,
                                anchor[1]:anchor[1] + patch_size]
            if len(centers):
                rel = centers - anchor + half
                keep = np.all((rel >= 0) & (rel < patch_size), axis=1)
                idx = np.where(keep)[0]
                p_cen, p_par = rel[idx], params[idx]
            else:
                p_cen = np.zeros((0, 2), np.float64)
                p_par = np.zeros((0, 3), np.float64)
            if paste_bank and rng.random() < float(copy_paste.get("p", 1.0)):
                from mpp_cnn_rs_object_detection_torch.data.copy_paste import (
                    paste_objects,
                )

                n_lo, n_hi = copy_paste.get("n_range", [1, 4])
                pasted, p_cen, p_par, _, _ = paste_objects(
                    imgs[k].astype(np.float32) / 255.0, p_cen, p_par,
                    np.zeros(len(p_cen), np.int64),
                    np.zeros(len(p_cen), bool), paste_bank, rng,
                    n_paste=int(rng.integers(n_lo, n_hi + 1)),
                )
                imgs[k] = (np.clip(pasted, 0, 1) * 255).astype(np.uint8)
            m = min(len(p_cen), max_objects)
            overflow += len(p_cen) - m
            cen[k, :m] = p_cen[:m]
            par[k, :m] = p_par[:m]
            val[k, :m] = True
            k += 1
    if overflow:
        logging.warning(f"patch stack dropped {overflow} objects over the "
                        f"{max_objects}-object patch capacity")
    return PatchStack(images=imgs, centers=cen, params=par, valid=val)


# ----------------------------------------------------- device: augmentation


class AugmentVariates(NamedTuple):
    """Every random number of one batch's augmentation (B samples)."""

    k: torch.Tensor      # (B,) int, rot90 count in 0..3
    f0: torch.Tensor     # (B,) bool, flip rows
    f1: torch.Tensor     # (B,) bool, flip columns
    r: torch.Tensor      # (B,) uniform: stretch (< 0.33), shift (< 0.66)
    shift: torch.Tensor  # (B, 3) uniform in [-0.08, 0.08): the RGB shift
    blur: torch.Tensor   # (B,) uniform: blur where < 0.2
    sigma: torch.Tensor  # (B,) uniform in [0, 0.03): the noise's std
    noise: torch.Tensor  # (B, P, P, 3) standard normal


def draw_augment_variates(gen: torch.Generator, b: int, p: int, device
                          ) -> AugmentVariates:
    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device)

    return AugmentVariates(
        k=torch.randint(0, 4, (b,), generator=gen, device=device),
        f0=uniform(b) < 0.5, f1=uniform(b) < 0.5, r=uniform(b),
        shift=uniform(b, 3) * 0.16 - 0.08, blur=uniform(b),
        sigma=uniform(b) * 0.03,
        noise=torch.randn((b, p, p, 3), generator=gen, device=device))


def _per_sample(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) with ``ndim`` dimensions."""
    return x.reshape((-1,) + (1,) * (ndim - 1))


def dihedral_image(img: torch.Tensor, k: torch.Tensor, f0: torch.Tensor,
                   f1: torch.Tensor) -> torch.Tensor:
    """(B, P, P, C) images: each ``rot90^k`` (counter-clockwise, as
    ``jnp.rot90``), then the optional row and column flips."""
    rots = torch.stack([torch.rot90(img, kk, dims=(1, 2))
                        for kk in range(4)])
    img = rots[k, torch.arange(img.shape[0], device=img.device)]
    img = torch.where(_per_sample(f0, 4), img.flip(1), img)
    return torch.where(_per_sample(f1, 4), img.flip(2), img)


def dihedral_points(centers: torch.Tensor, angles: torch.Tensor, p: int,
                    k: torch.Tensor, f0: torch.Tensor, f1: torch.Tensor):
    """(B, M, 2) (row, col) points and (B, M) rectangle angles under the
    same transform as ``dihedral_image`` (closed forms for a square p x p
    patch); angles come back in [0, pi)."""
    r, c = centers[..., 0], centers[..., 1]
    k = k.to(torch.int64)
    q = float(p - 1)
    rots = [(r, c, angles), (q - c, r, angles - math.pi / 2),
            (q - r, q - c, angles - math.pi),
            (c, q - r, angles - 3 * math.pi / 2)]
    pick = _per_sample(k, 2)
    r2, c2, a2 = (torch.stack([rot[i] for rot in rots]).gather(
        0, pick[None].expand(1, *r.shape))[0] for i in range(3))
    f0, f1 = _per_sample(f0, 2), _per_sample(f1, 2)
    r2 = torch.where(f0, q - r2, r2)
    a2 = torch.where(f0, math.pi - a2, a2)
    c2 = torch.where(f1, q - c2, c2)
    a2 = torch.where(f1, -a2, a2)
    return torch.stack([r2, c2], dim=-1), torch.remainder(a2, math.pi)


def photometric_medium(img: torch.Tensor, v: AugmentVariates
                       ) -> torch.Tensor:
    """The 'medium' photometric family on (B, P, P, 3) images in [0, 1]:
    one of {contrast stretch about the image mean, RGB shift, nothing}, a
    5-point blur whose neighbours wrap around (``roll``) with probability
    0.2, then Gaussian noise; clipped to [0, 1] after each step."""
    mean = torch.mean(img, dim=(1, 2), keepdim=True)
    stretched = torch.clamp(mean + (img - mean) * 1.4, 0.0, 1.0)
    shifted = torch.clamp(img + v.shift[:, None, None, :], 0.0, 1.0)
    r = _per_sample(v.r, 4)
    img = torch.where(r < 0.33, stretched,
                      torch.where(r < 0.66, shifted, img))
    blur = (img + torch.roll(img, 1, 1) + torch.roll(img, -1, 1)
            + torch.roll(img, 1, 2) + torch.roll(img, -1, 2)) / 5.0
    img = torch.where(_per_sample(v.blur, 4) < 0.2, blur, img)
    return torch.clamp(img + _per_sample(v.sigma, 4) * v.noise, 0.0, 1.0)


def augment_batch(imgs_u8: torch.Tensor, centers: torch.Tensor,
                  params: torch.Tensor, valid: torch.Tensor,
                  v: AugmentVariates):
    """Dihedral + photometric augmentation of a gathered batch: float32
    images in [0, 1] and the transformed (centers, params, valid); centers
    truncated to integers as the host pipeline rounds them."""
    p = imgs_u8.shape[1]
    img = dihedral_image(imgs_u8, v.k, v.f0, v.f1).to(torch.float32) / 255.0
    cen2, ang2 = dihedral_points(centers, params[..., 2], p, v.k, v.f0, v.f1)
    par2 = torch.cat([params[..., :2], ang2[..., None]], dim=-1)
    return photometric_medium(img, v), torch.trunc(cen2), par2, valid


# --------------------------------------------------------- device: targets


def _pixel_coords(p: int, device) -> torch.Tensor:
    return torch.arange(p, dtype=torch.float32, device=device)


def _nearest_fields(centers: torch.Tensor, valid: torch.Tensor, p: int):
    """Per pixel of each patch the nearest valid center's index and its
    distance (inf where the patch has no valid center): (B, P, P) each."""
    ax = _pixel_coords(p, centers.device)
    dy2 = torch.square(centers[..., 0, None] - ax)[..., :, None]  # (B,M,P,1)
    dx2 = torch.square(centers[..., 1, None] - ax)[..., None, :]  # (B,M,1,P)
    d = torch.sqrt(dy2 + dx2)
    d = torch.where(valid[..., None, None], d, math.inf)
    dist, nearest = torch.min(d, dim=1)
    return nearest, dist


def _gather_objects(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[b, index[b, i, j]]``: (B, M, C) per-object values at (B, P, P)
    object indices -> (B, P, P, C)."""
    b, p = index.shape[0], index.shape[1]
    flat = index.reshape(b, -1, 1).expand(-1, -1, x.shape[-1])
    return torch.gather(x, 1, flat).reshape(b, p, p, x.shape[-1])


def pos_targets(centers: torch.Tensor, params: torch.Tensor,
                valid: torch.Tensor, p: int,
                max_distance: Union[float, str], sigma_dil: float = 0.6
                ) -> Dict[str, torch.Tensor]:
    """PosNet targets of a batch: unit vectors to the nearest center
    (zero beyond ``max_distance``, or beyond the nearest object's mean side
    for ``"auto"``), that mask, and the dilated center map."""
    nearest, dist = _nearest_fields(centers, valid, p)
    ax = _pixel_coords(p, centers.device)
    coor = torch.stack(torch.meshgrid(ax, ax, indexing="ij"), dim=-1)
    pointy = _gather_objects(centers, nearest) - coor
    no_center = torch.isinf(dist)
    norm = torch.where(no_center, 1e6, dist) + 1e-8
    pointy = torch.where(no_center[..., None], 0.0, pointy / norm[..., None])
    if max_distance == "auto":
        cut = torch.mean(_gather_objects(params[..., :2], nearest), dim=-1)
    else:
        cut = float(max_distance)
    keep = norm <= cut
    pointy = torch.where(keep[..., None], pointy, 0.0)
    bin_dil = torch.exp(-0.5 * torch.square(norm / sigma_dil))
    bin_dil = torch.where(bin_dil < 1e-5, 0.0, bin_dil)
    return {"pointing_map": pointy, "mask": keep.to(torch.float32),
            "center_binary_map_dil": bin_dil}


def _value_to_class(values: torch.Tensor, m: ValueMapping) -> torch.Tensor:
    step = (m.v_max - m.v_min) / m.n_classes
    cls = torch.floor((values - m.v_min) / step).to(torch.int64)
    return torch.clamp(cls, 0, m.n_classes - 1)


def shape_targets(centers: torch.Tensor, params: torch.Tensor,
                  valid: torch.Tensor, p: int, mappings: List[ValueMapping],
                  mask_mode: str = "shapes", mask_sigma="auto"
                  ) -> Dict[str, torch.Tensor]:
    """ShapeNet targets of a batch: per-pixel (size, ratio, angle) class
    maps and the loss mask normalised to sum 1 per patch. ``"shapes"``
    paints inside each rectangle (the last containing object wins, as the
    host painter overwrites in object order; the mask counts the
    containing objects); ``"gaussian"`` takes the nearest center's classes
    and a Gaussian of the distance (sigma = size / 4 for ``"auto"``)."""
    a, b, w = params[..., 0], params[..., 1], params[..., 2]
    sra = torch.stack([(a + b) / 2.0, a / (b + 1e-12),
                       torch.remainder(w, math.pi)], dim=-1)
    classes = torch.stack([_value_to_class(sra[..., i], m)
                           for i, m in enumerate(mappings)], dim=-1)
    n_b = centers.shape[0]

    if mask_mode == "shapes":
        ax = _pixel_coords(p, centers.device)
        d0 = (ax - centers[..., 0, None])[..., :, None]  # (B, M, P, 1)
        d1 = (ax - centers[..., 1, None])[..., None, :]  # (B, M, 1, P)
        cos = torch.cos(w)[..., None, None]
        sin = torch.sin(w)[..., None, None]
        lu = cos * d0 + sin * d1
        lv = -sin * d0 + cos * d1
        contains = ((torch.abs(lu) <= (a / 2)[..., None, None])
                    & (torch.abs(lv) <= (b / 2)[..., None, None])
                    & valid[..., None, None])  # (B, M, P, P)
        m_idx = torch.arange(contains.shape[1], dtype=torch.int32,
                             device=centers.device)
        winner = torch.max(torch.where(contains, m_idx[:, None, None], -1),
                           dim=1).values
        any_obj = winner >= 0
        per_pixel = _gather_objects(classes, torch.clamp(winner, min=0))
        value_class_map = [torch.where(any_obj, per_pixel[..., i], 0)
                           for i in range(len(mappings))]
        count = torch.sum(contains, dim=1).to(torch.float32)
        total = torch.sum(count, dim=(1, 2), keepdim=True)
        loss_mask = torch.where(total > 0,
                                count / torch.clamp(total, min=1e-12), 0.0)
    elif mask_mode == "gaussian":
        nearest, dist = _nearest_fields(centers, valid, p)
        per_pixel = _gather_objects(classes, nearest)
        value_class_map = [per_pixel[..., i] for i in range(len(mappings))]
        size_map = torch.as_tensor(
            mappings[0].feature_mapping, dtype=torch.float32,
            device=centers.device)[value_class_map[0]]
        sigma = (torch.clamp(size_map / 4, min=1e-8)
                 if mask_sigma == "auto" else float(mask_sigma))
        dist_f = torch.where(torch.isinf(dist), 1e6, dist)
        lm = torch.exp(-0.5 * torch.square(dist_f / sigma))
        lm = torch.where(lm < 1e-3, 0.0, lm)
        total = torch.sum(lm.reshape(n_b, -1), dim=1)[:, None, None]
        loss_mask = torch.where(total > 0,
                                lm / torch.clamp(total, min=1e-12), 0.0)
    else:
        raise ValueError(mask_mode)
    return {"value_class_map": value_class_map, "loss_mask": loss_mask}
