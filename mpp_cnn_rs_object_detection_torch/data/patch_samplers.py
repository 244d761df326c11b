"""Where training patches are cropped from the source images.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/data/patch_samplers.py``
(host numpy): ``UniformSampler`` (images weighted by area, uniform
centers), ``ObjectSampler`` (images weighted by object count, centers
jittered around a random object), ``DensitySampler`` (centers drawn from
the PosNet's error-density maps: hard-example mining) and ``MixedSampler``
(a weighted mixture, to which hard mining adds a ``DensitySampler``). Each
consumes its ``numpy`` generator in the JAX package's order, so the same
seed samples the same patches. A density map is channel 0 of its PNG, as
``np.asarray(Image.open(path))[..., 0]`` reads it; the sampler decodes
each map once.
"""

from __future__ import annotations

import json
import os
import re
from abc import abstractmethod
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from mpp_cnn_rs_object_detection_torch.ops.sampler2d import sample_point_2d
from mpp_cnn_rs_object_detection_torch.utils.png import read_png


def _read_meta(meta_files, key):
    """One metadata field per image, as a float array."""
    vals = []
    for mf in meta_files:
        with open(mf, "r") as f:
            vals.append(json.load(f)[key])
    return np.asarray(vals, np.float64)


def _floor_one_density(raw: np.ndarray, n_patches: int) -> np.ndarray:
    """Per-image sampling density proportional to ``raw``, floored so every
    image receives at least ~one of the ``n_patches`` samples in
    expectation."""
    expected = raw / raw.sum() * (n_patches - len(raw)) + 1.0
    return expected / expected.sum()


class PatchSampler:
    sample_density_per_image: Optional[np.ndarray] = None
    n_images: Optional[int] = None

    @abstractmethod
    def initialise(self, patch_files, label_files, meta_files):
        ...

    def sample_image(self) -> int:
        return int(self.rng.choice(np.arange(self.n_images),
                                   p=self.sample_density_per_image))

    @abstractmethod
    def sample_patch_center(self, image_id, shape, centers):
        ...

    def __len__(self):
        return self.n_patches


@dataclass
class UniformSampler(PatchSampler):
    n_patches: int
    patch_size: int
    rng: np.random.Generator

    def initialise(self, patch_files, label_files, meta_files):
        self.n_images = len(meta_files)
        assert self.n_images <= self.n_patches
        areas = np.prod(_read_meta(meta_files, "shape"), axis=-1)
        self.sample_density_per_image = _floor_one_density(
            areas, self.n_patches)

    def sample_patch_center(self, image_id, shape, centers):
        return self.rng.integers((0, 0), shape)


@dataclass
class ObjectSampler(PatchSampler):
    n_patches: int
    patch_size: int
    rng: np.random.Generator
    sigma: float = 0.0

    def initialise(self, patch_files, label_files, meta_files):
        self.n_images = len(patch_files)
        self.sample_density_per_image = _floor_one_density(
            _read_meta(meta_files, "n_objects"), self.n_patches)

    def sample_patch_center(self, image_id, shape, centers):
        if len(centers) > 0:
            anchor = np.asarray(centers)[
                self.rng.integers(len(centers))].astype(int)
            if self.sigma != 0:
                anchor = self.rng.normal(anchor, self.sigma).astype(int)
            return np.clip(anchor, (0, 0), shape)
        return self.rng.integers((0, 0), shape)


@dataclass
class DensitySampler(PatchSampler):
    """Images weighted by the sum of their density map, centers drawn from
    it without replacement (``sample_point_2d``), then scaled back by
    ``1 / rescale_fac`` to the image and clipped; an all-zero map draws
    uniformly. ``density_files`` (sorted) pair with the images by id."""

    n_patches: int
    patch_size: int
    rng: np.random.Generator
    density_files: List[str]
    rescale_fac: float = 1.0

    def __post_init__(self):
        self.density_files = sorted(self.density_files)
        self._maps: Dict[int, np.ndarray] = {}

    def _density(self, image_id: int) -> np.ndarray:
        if image_id not in self._maps:
            self._maps[image_id] = read_png(
                self.density_files[image_id]).astype(np.float64)[..., 0]
        return self._maps[image_id]

    def initialise(self, patch_files, label_files, meta_files):
        self.n_images = len(patch_files)
        if len(self.density_files) != len(patch_files):
            raise ValueError(f"{len(self.density_files)} density maps for "
                             f"{len(patch_files)} images")
        sums = np.array([self._density(i).sum()
                         for i in range(self.n_images)])
        self.sample_density_per_image = sums / sums.sum()
        id_re = re.compile(r"[^0-9]*([0-9]+).*\.png")
        for df, pf in zip(self.density_files, patch_files):
            id_df = id_re.match(os.path.split(df)[1]).group(1)
            id_pf = id_re.match(os.path.split(pf)[1]).group(1)
            if id_df != id_pf:
                raise ValueError(f"density/image id mismatch: {df} vs {pf}")

    def sample_patch_center(self, image_id, shape, centers):
        density = self._density(image_id)
        if self.rescale_fac == 1.0 and \
                not np.all(np.asarray(shape[:2]) == density.shape):
            raise ValueError(f"density map {density.shape} for an image "
                             f"of {tuple(shape[:2])}")
        if density.max() == 0:
            center = self.rng.integers((0, 0), shape)
        else:
            center = sample_point_2d(img_shape=density.shape[:2],
                                     density=density, rng=self.rng).squeeze()
        center = (center / self.rescale_fac).astype(int)
        return np.clip(center, (0, 0), shape)


@dataclass
class MixedSampler(PatchSampler):
    n_patches: int
    samplers: List[PatchSampler]
    weights: List[float]
    rng: np.random.Generator

    def __post_init__(self):
        self.weights = np.array(self.weights, dtype=np.float64)
        self.weights = self.weights / self.weights.sum()

    def add_sampler(self, sampler: PatchSampler, weight: float):
        """Add ``sampler`` at ``weight``, the others scaled by ``1 -
        weight``."""
        self.samplers.append(sampler)
        self.weights = np.concatenate([self.weights * (1 - weight), [weight]])
        self.weights = self.weights / self.weights.sum()

    def initialise(self, patch_files, label_files, meta_files):
        self.n_images = len(patch_files)
        for s in self.samplers:
            s.initialise(patch_files, label_files, meta_files)
        mixed = np.sum([w * s.sample_density_per_image
                        for s, w in zip(self.samplers, self.weights)], axis=0)
        self.sample_density_per_image = mixed / mixed.sum()

    def sample_patch_center(self, image_id, shape, centers):
        sampler = self.samplers[self.rng.choice(len(self.samplers),
                                                p=self.weights)]
        return sampler.sample_patch_center(image_id=image_id, shape=shape,
                                           centers=centers)
