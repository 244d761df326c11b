"""Temporary patch datasets on disk, cut from a source dataset.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/data/patch_making.py``
(``make_patch_dataset``, ``_make_patches``, ``_make_one_patch``): a mixed
uniform/object sampler (plus a ``DensitySampler`` of error maps when hard
mining gives them) splits the patches over the images and picks their
centers; each patch, its objects re-anchored (and, on the train subset,
copy-paste objects added), goes to
``<dataset_path>/<new_dataset>/<subset>/{images/<id>_<k>.png,
annotations/<id>_<k>.pkl, metadata/<id>_<k>.json}``, the PNGs deflated at
zlib level 1 (the sets are rewritten every few epochs).

The JAX package's default sends the sampler and its generator to a
``spawn`` pool, where each chunk of images draws from a fresh copy of the
generator: its centers depend on the chunk size, so on the CPU count, and
the parent's generator does not advance. Its ``multiprocess=False``
semantics are the deterministic ones, and the port's: every center is
drawn in the parent, image after image, from the one generator; then a
pool of threads crops, pastes (each image from its own generator
``default_rng((seed, i))``, as in JAX) and writes.
"""

from __future__ import annotations

import json
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from mpp_cnn_rs_object_detection_torch.data.dataset import (
    extract_patch,
    load_annotation,
    load_image,
)
from mpp_cnn_rs_object_detection_torch.data.patch_samplers import (
    DensitySampler,
    MixedSampler,
    ObjectSampler,
    PatchSampler,
    UniformSampler,
)
from mpp_cnn_rs_object_detection_torch.utils.config import (
    check_data_match,
    fetch_data_paths,
    get_dataset_base_path,
)
from mpp_cnn_rs_object_detection_torch.utils.files import (
    NumpyEncoder,
    make_if_not_exist,
)
from mpp_cnn_rs_object_detection_torch.utils.png import png_header, write_png

PATCH_PNG_LEVEL = 1


def make_patch_dataset(new_dataset: str, source_dataset: str, config: Dict,
                       rng: np.random.Generator, make_val: bool = False,
                       sampling_densities: Optional[List[str]] = None,
                       d_sampler_weight: Optional[float] = None,
                       densities_rescale_fac: float = 1) -> None:
    """Write the train patch set (and with ``make_val`` the val set, of
    half as many patches, without copy-paste) of ``config``'s
    ``patch_maker_params``; ``sampling_densities`` (error maps of the
    train images) add a ``DensitySampler`` at ``d_sampler_weight``."""
    base_data_path = get_dataset_base_path()
    make_if_not_exist(os.path.join(base_data_path, new_dataset))

    pm = config["data_loader"]["patch_maker_params"]
    n_patches = pm["n_patches"]
    patch_size = pm["patch_size"]
    sigma = pm.get("obj_sampler_sigma") or 0

    paste_bank, copy_paste = None, pm.get("copy_paste")
    if copy_paste:
        from mpp_cnn_rs_object_detection_torch.data.copy_paste import (
            build_paste_bank,
        )

        src = fetch_data_paths(source_dataset, "train")
        paste_bank = build_paste_bank(src["images"], src["annotations"])

    for subset in (["train", "val"] if make_val else ["train"]):
        sampler = MixedSampler(
            n_patches=n_patches,
            samplers=[
                UniformSampler(n_patches=n_patches, patch_size=patch_size,
                               rng=rng),
                ObjectSampler(n_patches=n_patches, patch_size=patch_size,
                              rng=rng, sigma=sigma),
            ],
            weights=[pm["unf_sampler_weight"], pm["obj_sampler_weight"]],
            rng=rng,
        )
        if sampling_densities is not None:
            sampler.add_sampler(
                DensitySampler(n_patches=n_patches, patch_size=patch_size,
                               rng=rng, density_files=sampling_densities,
                               rescale_fac=densities_rescale_fac),
                d_sampler_weight)
        train = subset == "train"
        _make_patches(
            source_dataset=source_dataset, subset=subset,
            new_dataset=new_dataset, sampler=sampler,
            n_patches=n_patches if train else n_patches // 2,
            patch_size=patch_size, rng=rng, clear=True,
            paste_bank=paste_bank if train else None,
            copy_paste=copy_paste if train else None)


def _make_patches(source_dataset: str, subset: str, new_dataset: str,
                  sampler: PatchSampler, n_patches: int, patch_size: int,
                  rng: np.random.Generator, clear: bool = False,
                  paste_bank=None, copy_paste=None) -> None:
    paths = fetch_data_paths(source_dataset, subset)
    sampler.initialise(paths["images"], paths["annotations"],
                       paths["metadata"])
    samples_per_image = rng.multinomial(
        n=n_patches, pvals=sampler.sample_density_per_image)

    dest = os.path.join(get_dataset_base_path(), new_dataset, subset)
    make_if_not_exist(dest, recursive=True)
    make_if_not_exist([os.path.join(dest, d)
                       for d in ["images", "annotations", "metadata"]])
    if clear:
        for d in os.listdir(dest):
            for f in os.listdir(os.path.join(dest, d)):
                os.remove(os.path.join(dest, d, f))

    seed = int(rng.integers(2 ** 31))
    jobs = []
    for i, n_local in enumerate(samples_per_image):
        if n_local == 0:
            continue
        labels = load_annotation(paths["annotations"][i])
        shape = np.array(png_header(paths["images"][i])[:2])
        anchors = [sampler.sample_patch_center(
            image_id=i, shape=shape, centers=labels["centers"])
            for _ in range(int(n_local))]
        jobs.append((i, anchors, paths["images"][i], paths["annotations"][i],
                     paths["metadata"][i]))
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for done in [pool.submit(_make_one_image, *job, patch_size=patch_size,
                                 data_dest=dest, paste_bank=paste_bank,
                                 copy_paste=copy_paste, seed=seed)
                     for job in jobs]:
            done.result()


def _make_one_image(i, anchors, patch_path, label_path, meta_path,
                    patch_size, data_dest, paste_bank=None, copy_paste=None,
                    seed=0) -> None:
    """Cut, paste and write the patches of image ``i`` at ``anchors``."""
    paste_rng = np.random.default_rng((seed, i))
    image = load_image(patch_path)
    image_id = check_data_match([patch_path, label_path, meta_path])
    labels_dict = load_annotation(label_path)
    centers = labels_dict["centers"]
    params = labels_dict["parameters"]
    cats = labels_dict["categories"]
    difficulty = labels_dict["difficult"]
    with open(meta_path, "r") as f:
        meta = json.load(f)

    for k, anchor in enumerate(anchors):
        patch, tl_anchor, centers_offset = extract_patch(
            image=image, center_anchor=anchor, patch_size=patch_size)
        p_centers, p_params, p_cats, p_diff = [], [], [], []
        for j, c in enumerate(centers):
            offset_c = c + centers_offset
            if np.all(tl_anchor <= offset_c) and np.all(
                    offset_c < (tl_anchor + patch_size)):
                p_centers.append(c - tl_anchor + centers_offset)
                p_params.append(params[j])
                p_cats.append(cats[j])
                p_diff.append(difficulty[j])
        if len(p_centers) == 0:
            p_centers, p_params = np.array([]), np.array([])
            p_cats, p_diff = np.array([]), np.array([])
        else:
            p_centers = np.stack(p_centers, axis=0)
            p_params = np.stack(p_params, axis=0)
            p_cats = np.array(p_cats)
            p_diff = np.array(p_diff)

        if paste_bank and copy_paste and paste_rng.random() < float(
                copy_paste.get("p", 1.0)):
            from mpp_cnn_rs_object_detection_torch.data.copy_paste import (
                paste_objects,
            )

            n_lo, n_hi = copy_paste.get("n_range", [1, 4])
            patch, p_centers, p_params, p_cats, p_diff = paste_objects(
                patch, p_centers.reshape(-1, 2), p_params.reshape(-1, 3),
                p_cats, p_diff, paste_bank, paste_rng,
                n_paste=int(paste_rng.integers(n_lo, n_hi + 1)))
            if len(p_centers) == 0:  # keep the empty-annotation convention
                p_centers, p_params = np.array([]), np.array([])
                p_cats, p_diff = np.array([]), np.array([])

        name = f"{image_id:04}_{k:04}"
        write_png(os.path.join(data_dest, "images", f"{name}.png"),
                  (np.clip(patch, 0, 1) * 255).astype(np.uint8),
                  level=PATCH_PNG_LEVEL)
        with open(os.path.join(data_dest, "annotations", f"{name}.pkl"),
                  "wb") as f:
            pickle.dump({"centers": p_centers, "parameters": p_params,
                         "categories": p_cats, "difficult": p_diff}, f)
        with open(os.path.join(data_dest, "metadata", f"{name}.json"),
                  "w") as f:
            json.dump({**meta, "source": os.path.split(patch_path)[1],
                       "anchor": anchor}, f, cls=NumpyEncoder, indent=1)
