"""Training-time augmentation of the host pipeline.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/data/augmentation.py``:
the geometric part (rot90 and flips, with the centers and rectangle angles
moved along) and the photometric families of the ``medium`` and ``strong``
levels (histogram matching to a random train scene, shadow, fog, channel
shuffle or dropout, brightness/contrast, CLAHE on the Lab lightness, RGB
shift, to-gray, a 0.9 downscale and back, a 3 x 3 blur, gaussian noise),
with OpenCV's calls written out in ``data/image_ops.py``.

``DataAugment.draw`` takes every random number of one item from the
generator, in the JAX package's order; they depend only on the image's
shape. ``DataAugment.apply`` is deterministic and computes what JAX's
``transform`` computes, in the same numpy dtypes, so ``transform =
apply(draw)`` equals JAX's on the same generator state.

Coordinate convention: centers are (row, col); angles follow
``polygon_to_abw`` (from the +row axis toward the +col axis, mod pi).
"""

from __future__ import annotations

import functools
import glob
import os
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict

import numpy as np

from mpp_cnn_rs_object_detection_torch.data import image_ops
from mpp_cnn_rs_object_detection_torch.data.dataset import load_image
from mpp_cnn_rs_object_detection_torch.utils.config import (
    get_dataset_base_path,
)


def rot90_points(centers: np.ndarray, angles: np.ndarray, shape_hw, k: int):
    """Rotate (row, col) points and rectangle angles with ``np.rot90(image,
    k)``, which maps (r, c) -> (W - 1 - c, r) for k = 1 on an (H, W)
    image."""
    k = k % 4
    h, w = shape_hw
    r, c = centers[..., 0].astype(float), centers[..., 1].astype(float)
    a = angles.astype(float)
    for _ in range(k):
        r, c = (w - 1 - c), r
        h, w = w, h
        a = a - np.pi / 2
    return np.stack([r, c], axis=-1), a % np.pi


def flip_points(centers: np.ndarray, angles: np.ndarray, shape_hw, axis: int):
    """Flip (row, col) points and angles across image axis 0 or 1."""
    h, w = shape_hw
    out = centers.astype(float).copy()
    if axis == 0:
        out[..., 0] = h - 1 - out[..., 0]
        new_angles = (np.pi - angles) % np.pi
    else:
        out[..., 1] = w - 1 - out[..., 1]
        new_angles = (-angles) % np.pi
    return out, new_angles


# bytes of sorted histogram-match scenes a ``DataAugment`` keeps (the
# most recently used ones; a scene is decoded and sorted again after it
# leaves, as the JAX package loads it on every draw)
REFERENCE_CACHE_BYTES = 1 << 30


@functools.lru_cache(maxsize=8)
def _unit_grid(n: int) -> np.ndarray:
    """``np.linspace(0, 1, n)``, read-only."""
    grid = np.linspace(0, 1, n)
    grid.setflags(write=False)
    return grid


def _histogram_match(image: np.ndarray, ref_sorted_channels, blend: float):
    """Per-channel histogram matching to a reference (given as its sorted
    channels) blended with the input."""
    out = np.empty_like(image)
    for ch in range(image.shape[2]):
        src = image[..., ch].ravel()
        ref_sorted = ref_sorted_channels[ch]
        src_sorted = np.sort(src)
        quantiles = np.searchsorted(src_sorted, src, side="left") / max(
            len(src_sorted) - 1, 1)
        matched = np.interp(quantiles, _unit_grid(len(ref_sorted)),
                            ref_sorted)
        out[..., ch] = matched.reshape(image.shape[:2])
    return np.clip((1 - blend) * image + blend * out, 0, 1)


def _clahe(image: np.ndarray):
    """CLAHE (clip 2, 8 x 8 tiles) of the Lab lightness of the truncated
    8-bit image."""
    lab = image_ops.rgb_to_lab((image * 255).astype(np.uint8))
    lab[..., 0] = image_ops.clahe(lab[..., 0], clip_limit=2.0, tiles=(8, 8))
    return image_ops.lab_to_rgb(lab).astype(np.float32) / 255.0


def _random_shadow(image: np.ndarray, shadow: Dict):
    h, w = image.shape[:2]
    mask = np.zeros((h, w), dtype=np.uint8)
    image_ops.fill_poly(mask, shadow["poly"], 1)
    out = image.copy()
    out[mask > 0] *= shadow["factor"]
    return out


def _random_fog(image: np.ndarray, fog: Dict):
    intensity = fog["intensity"]
    return np.clip(image * (1 - intensity) + fog["fog"] * intensity, 0, 1)


@dataclass
class DataAugment:
    rng: np.random.Generator
    dataset: str
    subset: str
    hist_match_images: bool = False
    aug_level: str = "medium"

    def __post_init__(self):
        self.hist_match_images_paths = None
        if self.hist_match_images:
            # unsorted, as the JAX package lists them: the same draw picks
            # the same file on the same filesystem
            self.hist_match_images_paths = glob.glob(os.path.join(
                get_dataset_base_path(), self.dataset, self.subset,
                "images/*.png"))
            if not self.hist_match_images_paths:
                raise FileNotFoundError(
                    f"no histogram-match images in {self.dataset}/"
                    f"{self.subset}")
        if self.aug_level not in ("medium", "strong"):
            raise ValueError(f"aug_level {self.aug_level}")
        self._references: "OrderedDict[int, list]" = OrderedDict()
        self._reference_bytes = 0
        self._lock = threading.Lock()

    def _reference(self, idx: int):
        """The sorted channels of histogram-match scene ``idx``, from a
        least-recently-used cache of ``REFERENCE_CACHE_BYTES`` shared by
        the loader's threads (a scene two threads miss at once is sorted
        twice, to the same arrays)."""
        with self._lock:
            ref = self._references.get(idx)
            if ref is not None:
                self._references.move_to_end(idx)
                return ref
        image = load_image(self.hist_match_images_paths[idx])
        ref = [np.sort(image[..., ch].ravel())
               for ch in range(image.shape[2])]
        with self._lock:
            if idx not in self._references:
                self._references[idx] = ref
                self._reference_bytes += sum(a.nbytes for a in ref)
            while (self._reference_bytes > REFERENCE_CACHE_BYTES
                   and len(self._references) > 1):
                _, old = self._references.popitem(last=False)
                self._reference_bytes -= sum(a.nbytes for a in old)
        return ref

    # --- drawing ----------------------------------------------------------

    def draw(self, shape) -> Dict:
        """Every random number of one item of ``shape`` (H, W, C), in the
        order JAX's ``transform`` draws them."""
        rng = self.rng
        strong = self.aug_level == "strong"
        d: Dict = {"k": int(rng.integers(4)), "flip0": rng.random() < 0.5,
                   "flip1": rng.random() < 0.5}
        h, w = shape[:2]
        if d["k"] % 2:
            h, w = w, h
        if self.hist_match_images_paths is not None and rng.random() < 0.5:
            d["hist"] = {"ref": int(rng.integers(
                len(self.hist_match_images_paths))),
                "blend": rng.uniform(0.1, 0.75)}
        if strong:
            if rng.random() < 0.5:
                n_vert = rng.integers(3, 6)
                d["shadow"] = {"poly": np.stack(
                    [rng.integers(0, w, n_vert), rng.integers(0, h, n_vert)],
                    axis=-1).astype(np.int32),
                    "factor": rng.uniform(0.4, 0.8)}
            if rng.random() < 0.5:
                d["fog"] = {"intensity": rng.uniform(0.05, 0.3),
                            "fog": rng.uniform(0.7, 1.0)}
            if rng.random() < 0.5:
                if rng.random() < 0.5:
                    d["permutation"] = rng.permutation(3)
                else:
                    d["dropout"] = rng.integers(3)
            if rng.random() < 0.5:
                d["brightness"] = (1.0 + rng.uniform(-0.2, 0.2),
                                   rng.uniform(-0.2, 0.2))
        r = rng.random()
        d["r"] = r
        if 0.33 <= r < 0.66:
            d["shift"] = rng.uniform(-0.08, 0.08, size=3)
        d["downscale"] = strong and rng.random() < 0.5
        d["blur"] = rng.random() < 0.2
        noise_sigma = rng.uniform(0.0, 0.03)
        d["noise"] = rng.normal(0, noise_sigma, (h, w) + tuple(shape[2:]))
        return d

    # --- applying ---------------------------------------------------------

    def _photometric(self, img: np.ndarray, d: Dict) -> np.ndarray:
        strong = self.aug_level == "strong"
        if "hist" in d:
            img = _histogram_match(img, self._reference(d["hist"]["ref"]),
                                   blend=d["hist"]["blend"])
        if "shadow" in d:
            img = _random_shadow(img, d["shadow"])
        if "fog" in d:
            img = _random_fog(img, d["fog"])
        if "permutation" in d:
            img = img[..., d["permutation"]]
        elif "dropout" in d:
            img = img.copy()
            img[..., d["dropout"]] = 0
        if "brightness" in d:
            alpha, beta = d["brightness"]
            img = np.clip(alpha * img + beta, 0, 1)

        r = d["r"]
        if r < 0.33:
            img = _clahe(img)
        elif r < 0.66:
            img = np.clip(img + d["shift"], 0, 1)
        elif strong and r < 0.76:
            gray = img.mean(axis=-1, keepdims=True)
            img = np.repeat(gray, 3, axis=-1)

        if d["downscale"]:
            h, w = img.shape[:2]
            small = image_ops.resize_area(img, (int(w * 0.9), int(h * 0.9)))
            img = image_ops.resize_linear(small, (w, h))
        if d["blur"]:
            img = image_ops.box_blur3(img)
        img = np.clip(img + d["noise"], 0, 1)
        return img.astype(np.float32)

    def apply(self, patch: np.ndarray, centers: np.ndarray,
              params: np.ndarray, d: Dict):
        """The augmented (image, centers, params, None) under draws
        ``d``."""
        n_points = len(centers)
        img = np.asarray(patch, dtype=np.float32)
        centers = np.asarray(centers, dtype=float).reshape(-1, 2)
        params = np.asarray(params, dtype=float).reshape(-1, 3)
        angles = params[:, 2] if n_points > 0 else np.zeros(0)

        k = d["k"]
        if k:
            shape_hw = img.shape[:2]
            img = np.rot90(img, k)
            if n_points:
                centers, angles = rot90_points(centers, angles, shape_hw, k)
        if d["flip0"]:
            img = img[::-1]
            if n_points:
                centers, angles = flip_points(centers, angles, img.shape[:2],
                                              axis=0)
        if d["flip1"]:
            img = img[:, ::-1]
            if n_points:
                centers, angles = flip_points(centers, angles, img.shape[:2],
                                              axis=1)
        img = self._photometric(np.ascontiguousarray(img), d)

        if n_points == 0:
            return img, np.array([]), np.array([]), None
        new_params = np.stack([params[:, 0], params[:, 1], angles % np.pi],
                              axis=-1)
        return img, centers.astype(int), new_params, None

    def transform(self, patch: np.ndarray, centers: np.ndarray,
                  params: np.ndarray):
        return self.apply(patch, centers, params,
                          self.draw(np.asarray(patch).shape))
