"""Dataset files and the host CNN-training input pipeline.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/data/dataset.py``:
``load_image``, ``load_annotation`` and ``save_annotation``;
``extract_patch`` (a crop with the reference's virtual zero padding);
``ImageDataset`` (one patch file per item, decoded once per patch set,
``update_files`` after a regeneration), ``PatchDataset`` (patches cut on
the fly from whole scenes) and ``BatchLoader``, which stacks items into
NHWC numpy batches.

The JAX loader runs ``__getitem__`` in a pool of 8 threads that share one
numpy generator, so with more than one thread the order of the
augmentation's draws depends on scheduling. Every draw of an item depends
only on its shape and object count, never on its pixels. So each dataset
here splits an item into ``draw(item)`` (every random number of the item,
in the JAX package's order, from the one generator) and ``apply(item,
draws)`` (deterministic): the loader draws each batch's items in the
parent, in item order, then applies them in its worker threads. Its
batches are the same for any worker count, and equal the JAX loader's with
one worker.

Dataset-on-disk format: ``<root>/<dataset>/<subset>/{images/NNNN.png,
annotations/NNNN.pkl, metadata/NNNN.json}``; an annotation holds
``centers (N, 2), parameters (N, 3) (a, b, angle), categories,
difficult``.
"""

from __future__ import annotations

import pickle
from abc import abstractmethod
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from mpp_cnn_rs_object_detection_torch.utils.config import fetch_data_paths
from mpp_cnn_rs_object_detection_torch.utils.png import png_header, read_png


def load_image(path: str) -> np.ndarray:
    """PNG -> float32 RGB, divided by 255 only if its max exceeds 1 (the
    JAX package's rule: an image whose levels are all 0 or 1 stays as
    read)."""
    arr = read_png(path).astype(np.float32)
    if arr.max() > 1.0:
        arr = arr / 255.0
    return arr[..., :3]


def image_shape(path: str) -> tuple:
    """The shape of ``load_image(path)``, read from the PNG's header."""
    h, w, c = png_header(path)
    return (h, min(w, 3)) if c == 1 else (h, w, min(c, 3))


def load_annotation(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_annotation(path: str, centers, parameters, categories, difficult):
    with open(path, "wb") as f:
        pickle.dump({"centers": np.asarray(centers),
                     "parameters": np.asarray(parameters),
                     "categories": np.asarray(categories),
                     "difficult": np.asarray(difficult)}, f)


def extract_patch(image: np.ndarray, center_anchor: np.ndarray,
                  patch_size: int):
    """The ``patch_size`` crop centred at ``center_anchor``, zero outside
    the image; returns (patch, tl_anchor, centers_offset) in the frame of
    the image zero-padded by ``patch_size // 2`` along each dimension the
    crop leaves (the reference's), so that an object at ``c`` lies at
    ``c + centers_offset - tl_anchor`` in the patch."""
    center_anchor = np.asarray(center_anchor)
    if center_anchor.shape != (2,):
        raise ValueError(f"anchor of shape {center_anchor.shape}")
    tl_anchor = center_anchor - patch_size // 2
    shape = np.array(image.shape[:2])
    centers_offset = np.zeros((2,), dtype=int)
    src_tl = np.array(tl_anchor)  # in the image's own coordinates
    for d in (0, 1):
        if tl_anchor[d] < 0 or tl_anchor[d] + patch_size >= shape[d]:
            centers_offset[d] = patch_size // 2
            tl_anchor[d] = tl_anchor[d] + patch_size // 2

    y0, x0 = int(src_tl[0]), int(src_tl[1])
    cy0, cx0 = max(y0, 0), max(x0, 0)
    cy1 = min(y0 + patch_size, int(shape[0]))
    cx1 = min(x0 + patch_size, int(shape[1]))
    if cy1 - cy0 == patch_size and cx1 - cx0 == patch_size:
        patch = image[cy0:cy1, cx0:cx1]
    else:
        patch = np.zeros((patch_size, patch_size) + image.shape[2:],
                         image.dtype)
        if cy0 < cy1 and cx0 < cx1:
            patch[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0] = \
                image[cy0:cy1, cx0:cx1]
    return patch, tl_anchor, centers_offset


class LabelProcessor:
    """(patch, centers, params) -> (float32 patch, label dict of numpy
    arrays). ``draw`` returns the random numbers ``process`` needs for an
    item of ``n_points`` objects (none unless a subclass says so)."""

    def draw(self, n_points: int) -> Any:
        return None

    @abstractmethod
    def process(self, patch: np.ndarray, centers: np.ndarray,
                params: np.ndarray, idx: int, draws: Any = None
                ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        ...


class ImageDataset:
    """One file = one item, decoded once per patch set (``update_files``
    reads the regenerated set and drops the decoded copies). ``draw``
    reads only the item's PNG header and annotation; the loader's threads
    decode the image in ``apply``."""

    def __init__(self, dataset: str, subset: str,
                 rng: Optional[np.random.Generator],
                 label_processor: LabelProcessor, augmenter=None,
                 rgb: bool = True, cache: bool = True):
        self.dataset = dataset
        self.subset = subset
        self.paths = fetch_data_paths(dataset, subset, metadata=False)
        self.rng = np.random.default_rng() if rng is None else rng
        self.augmenter = augmenter
        self.rgb = rgb
        self.label_processor = label_processor
        self.cache_enabled = cache
        self._images: Dict[int, np.ndarray] = {}
        self._labels: Dict[int, dict] = {}

    def update_files(self):
        self.paths = fetch_data_paths(self.dataset, self.subset,
                                      metadata=False)
        self._images.clear()
        self._labels.clear()

    def __len__(self):
        return len(self.paths["images"])

    def _cached(self, cache: Dict, item, load):
        if self.cache_enabled and item in cache:
            return cache[item]
        value = load()
        if self.cache_enabled:
            cache[item] = value
        return value

    def _image(self, item) -> np.ndarray:
        return self._cached(self._images, item,
                            lambda: load_image(self.paths["images"][item]))

    def _annotation(self, item) -> dict:
        return self._cached(
            self._labels, item,
            lambda: load_annotation(self.paths["annotations"][item]))

    def draw(self, item) -> tuple:
        """The item's augmentation and label draws, in that order."""
        n_points = len(self._annotation(item)["centers"])
        aug = (self.augmenter.draw(image_shape(self.paths["images"][item]))
               if self.augmenter is not None else None)
        return aug, self.label_processor.draw(n_points)

    def apply(self, item, draws: tuple):
        aug, lab = draws
        patch, labels = self._image(item), self._annotation(item)
        centers, params = labels["centers"], labels["parameters"]
        if self.augmenter is not None:
            patch, centers, params, _ = self.augmenter.apply(
                patch, centers, params, aug)
        return self.label_processor.process(
            patch=patch, centers=centers, params=params, idx=item,
            draws=lab)

    def __getitem__(self, item):
        return self.apply(item, self.draw(item))


class PatchDataset:
    """Patches cut on the fly from whole source images: each item samples
    an (image, center) pair through a ``PatchSampler``, crops with border
    padding, keeps the objects inside, optionally augments, and runs the
    label processor. Decoded source images are cached."""

    def __init__(self, patch_size: int, dataset: str, subset: str,
                 rng: Optional[np.random.Generator],
                 label_processor: LabelProcessor, patch_sampler,
                 augmenter=None, rgb: bool = True):
        self.patch_size = patch_size
        self.paths = fetch_data_paths(dataset, subset)
        self.rng = np.random.default_rng() if rng is None else rng
        self.label_processor = label_processor
        self.augmenter = augmenter
        self.rgb = rgb
        self.patch_sampler = patch_sampler
        self.patch_sampler.initialise(self.paths["images"],
                                      self.paths["annotations"],
                                      self.paths["metadata"])
        self._cache: Dict[int, tuple] = {}

    def __len__(self):
        return len(self.patch_sampler)

    def _source(self, image_id: int):
        if image_id not in self._cache:
            image = load_image(self.paths["images"][image_id])
            if not self.rgb:
                image = image[..., :1]
            labels = load_annotation(self.paths["annotations"][image_id])
            self._cache[image_id] = (image, labels)
        return self._cache[image_id]

    def draw(self, item) -> tuple:
        """Sample and cut the item's patch, then its augmentation and label
        draws."""
        image_id = self.patch_sampler.sample_image()
        image, labels_dict = self._source(image_id)
        centers = np.asarray(labels_dict["centers"]).reshape(-1, 2)
        params = np.asarray(labels_dict["parameters"]).reshape(-1, 3)
        anchor = self.patch_sampler.sample_patch_center(
            image_id=image_id, shape=np.array(image.shape[:2]),
            centers=centers)
        patch, tl, off = extract_patch(image, anchor, self.patch_size)
        if len(centers):
            rel = centers + off - tl
            keep = np.all((rel >= 0) & (rel < self.patch_size), axis=1)
            p_centers, p_params = rel[keep], params[keep]
        else:
            p_centers = np.zeros((0, 2))
            p_params = np.zeros((0, 3))
        n_points = len(p_centers)
        aug = (self.augmenter.draw(patch.shape)
               if self.augmenter is not None else None)
        return (patch, p_centers, p_params), aug, \
            self.label_processor.draw(n_points)

    def apply(self, item, draws: tuple):
        (patch, p_centers, p_params), aug, lab = draws
        if self.augmenter is not None:
            patch, p_centers, p_params, _ = self.augmenter.apply(
                patch, p_centers, p_params, aug)
        return self.label_processor.process(
            patch=patch, centers=p_centers, params=p_params, idx=item,
            draws=lab)

    def __getitem__(self, item):
        return self.apply(item, self.draw(item))


class BatchLoader:
    """Batches of a dataset as stacked numpy arrays: the order (shuffled
    from ``rng`` at each pass), each batch's draws in the parent in item
    order, its items built by ``num_workers`` threads one batch ahead of
    the consumer."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 rng: Optional[np.random.Generator] = None,
                 num_workers: int = 8, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng() if rng is None else rng
        self.num_workers = num_workers
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, Dict[str, Any]]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        pending = []
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for b in range(len(self)):
                idx = order[b * self.batch_size:(b + 1) * self.batch_size]
                draws = [self.dataset.draw(i) for i in idx]
                pending.append([pool.submit(self.dataset.apply, i, d)
                                for i, d in zip(idx, draws)])
                # the threads build batch b while batch b - 1 is consumed
                if len(pending) == 2:
                    yield _collate([f.result() for f in pending.pop(0)])
            for futures in pending:
                yield _collate([f.result() for f in futures])


def _collate(items: List[Tuple[np.ndarray, Dict[str, Any]]]):
    patches = np.stack([it[0] for it in items], axis=0)
    labels = {}
    for k, v0 in items[0][1].items():
        if isinstance(v0, list):
            labels[k] = [np.stack([it[1][k][i] for it in items], axis=0)
                         for i in range(len(v0))]
        else:
            labels[k] = np.stack([it[1][k] for it in items], axis=0)
    return patches, labels
