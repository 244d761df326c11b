"""Where training patches are cropped from the source images.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/data/patch_samplers.py``
(host numpy): ``UniformSampler`` (images weighted by area, uniform
centers), ``ObjectSampler`` (images weighted by object count, centers
jittered around a random object) and ``MixedSampler`` (a weighted mixture).
Each consumes its ``numpy`` generator in the JAX package's order, so the
same seed samples the same patches. ``DensitySampler`` (hard-example
mining from PosNet error maps) belongs to the host pipeline, which is not
ported (``ROADMAP.md`` item 12).
"""

from __future__ import annotations

import json
from abc import abstractmethod
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


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

    @abstractmethod
    def sample_patch_center(self, image_id, shape, centers):
        ...


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
class MixedSampler(PatchSampler):
    n_patches: int
    samplers: List[PatchSampler]
    weights: List[float]
    rng: np.random.Generator

    def __post_init__(self):
        self.weights = np.array(self.weights, dtype=np.float64)
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
