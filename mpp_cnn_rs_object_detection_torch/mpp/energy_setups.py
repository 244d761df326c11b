"""Energy setups: which terms exist and how they are calibrated.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/mpp/energy_setups.py``:

  - ``LegacyEnergySetup``: Position + mean-Shape + Overlap + Alignment +
    Area; calibrates the detection threshold (max F1), per-mark logistic
    remaps and area quantiles;
  - ``NoCalibrationEnergySetup``: Position (threshold 0) + three
    single-mark terms (``-p``, or the logistic remap with ``calib_marks``)
    + overlap / alignment / area priors (+ the optional ratio prior);
    calibrates the area quantiles (and the remaps if asked);
  - ``ContrastMeasureEnergySetup``: a CNN-free data term (a contrast
    measure of the image, or the gradient alignment) + the priors;
    calibrates the area quantiles. The CNN maps still give the chain its
    birth proposals.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mpp_cnn_rs_object_detection_torch.mpp.calibration import (
    apply_remap_param_dist,
    calibrate_detection_threshold,
    calibrate_min_area,
    calibrate_param_dists,
)
from mpp_cnn_rs_object_detection_torch.mpp.classic_energies import (
    ContrastConfig,
)
from mpp_cnn_rs_object_detection_torch.mpp.energies import (
    EnergyMaps,
    EnergySpec,
    make_energy_maps,
    stack_param_dists,
)
from mpp_cnn_rs_object_detection_torch.mpp.image_data import ImageWMaps
from mpp_cnn_rs_object_detection_torch.mpp.kernels import (
    KernelData,
    make_kernel_data,
)
from mpp_cnn_rs_object_detection_torch.utils.files import NumpyEncoder

LEGACY_NAMES = (
    "PositionEnergy",
    "ShapeEnergy",
    "RectangleOverlapEnergy",
    "ShapeAlignmentEnergy",
    "AreaPriorEnergy",
)

NO_CALIB_NAMES = (
    "PositionEnergy",
    "SizeEnergy",
    "RatioEnergy",
    "AngleEnergy",
    "OverlapPriorEnergy",
    "AlignmentPriorEnergy",
    "AreaPriorEnergy",
)


class EnergySetup:
    """Compile ImageWMaps -> (EnergyMaps, KernelData); calibrate / load."""

    spec: EnergySpec

    def calibrate(self, image_configs: List[ImageWMaps], rng, save_path: str):
        raise NotImplementedError

    def make_maps(self, data: ImageWMaps) -> EnergyMaps:
        raise NotImplementedError

    @property
    def detection_threshold(self) -> float:
        raise NotImplementedError

    def make_kernel_data(self, data: ImageWMaps, intensity: float,
                         use_split_merge: bool = False) -> KernelData:
        """The sampling inputs of ``data``; ``use_split_merge`` gives the
        sequential chain's kernel mixture its split/merge pair (8 kernels,
        or 10)."""
        return make_kernel_data(data.detection_map, data.param_dist_maps,
                                data.mappings, intensity=intensity,
                                use_split_merge=use_split_merge)

    def load_calibration(self, save_dir: str):
        with open(os.path.join(save_dir, "calibration.json")) as f:
            self.calibration = json.load(f)

    def _save_calibration(self, save_path: str):
        if save_path:
            with open(os.path.join(save_path, "calibration.json"), "w") as f:
                json.dump(self.calibration, f, cls=NumpyEncoder, indent=1)


def _param_dist_fits(image_configs: List[ImageWMaps], rng):
    return calibrate_param_dists(
        [c.param_dist_maps for c in image_configs],
        [c.gt_centers for c in image_configs],
        [c.gt_marks for c in image_configs],
        image_configs[0].mappings, rng)


@dataclass
class LegacyEnergySetup(EnergySetup):
    calibration_params: Dict[str, Any] = field(default_factory=dict)
    rewarding_priors: bool = True
    calibration: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        self.spec = EnergySpec(names=LEGACY_NAMES, shape_mode="mean",
                               rewarding_align=self.rewarding_priors)

    def calibrate(self, image_configs: List[ImageWMaps], rng, save_path: str):
        """Detection threshold at the max F-score, per-mark remaps (draws
        from ``rng``) and area quantiles."""
        threshold = calibrate_detection_threshold(
            [c.detection_map for c in image_configs],
            [c.labels for c in image_configs],
            target=self.calibration_params.get("threshold_target", "f1"))
        coefs, intercepts = _param_dist_fits(image_configs, rng)
        min_area, max_area = calibrate_min_area(
            [c.gt_marks for c in image_configs])
        self.calibration = {
            "detection_threshold": threshold,
            "param_dist_remap_coefs": coefs,
            "param_dist_remap_intercepts": intercepts,
            "min_area": min_area,
            "max_area": max_area,
        }
        self._save_calibration(save_path)

    def make_maps(self, data: ImageWMaps) -> EnergyMaps:
        cal = self.calibration
        remapped = apply_remap_param_dist(
            data.param_dist_maps, cal["param_dist_remap_coefs"],
            cal["param_dist_remap_intercepts"])
        return make_energy_maps(
            detection_map=data.detection_map, mark_energy_maps=remapped,
            threshold=cal["detection_threshold"], min_area=cal["min_area"],
            max_area=cal["max_area"], mappings=data.mappings)

    @property
    def detection_threshold(self) -> float:
        return float(self.calibration["detection_threshold"])


@dataclass
class NoCalibrationEnergySetup(EnergySetup):
    rewarding_priors: bool = True
    ratio_prior: bool = False
    calib_marks: bool = False
    target_ratio: float = 0.5
    calibration: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        names = list(NO_CALIB_NAMES)
        if self.ratio_prior:
            names.append("RatioPriorEnergy")
        self.spec = EnergySpec(
            names=tuple(names), shape_mode="separate",
            use_ratio_prior=self.ratio_prior,
            rewarding_align=self.rewarding_priors,
        )

    def calibrate(self, image_configs: List[ImageWMaps], rng, save_path: str):
        """Area quantiles from the GT marks, and with ``calib_marks`` the
        per-mark remaps (draws from ``rng``)."""
        min_area, max_area = calibrate_min_area(
            [c.gt_marks for c in image_configs])
        cal: Dict[str, Any] = {"min_area": min_area, "max_area": max_area,
                               "detection_threshold": 0.0}
        if self.calib_marks:
            coefs, intercepts = _param_dist_fits(image_configs, rng)
            cal["param_dist_remap_coefs"] = coefs
            cal["param_dist_remap_intercepts"] = intercepts
        self.calibration = cal
        self._save_calibration(save_path)

    def make_maps(self, data: ImageWMaps) -> EnergyMaps:
        cal = self.calibration
        if self.calib_marks and cal.get("param_dist_remap_coefs"):
            mark_maps = apply_remap_param_dist(
                data.param_dist_maps, cal["param_dist_remap_coefs"],
                cal["param_dist_remap_intercepts"])
        else:
            mark_maps = -stack_param_dists(data.param_dist_maps)
        return make_energy_maps(
            detection_map=data.detection_map, mark_energy_maps=mark_maps,
            threshold=0.0, min_area=cal["min_area"],
            max_area=cal["max_area"], mappings=data.mappings,
            target_ratio=self.target_ratio,
        )

    @property
    def detection_threshold(self) -> float:
        # naive-init threshold of this setup
        return 0.5


CONTRAST_NAMES = (
    "ContrastEnergy",
    "OverlapPriorEnergy",
    "AlignmentPriorEnergy",
    "AreaPriorEnergy",
    "RatioPriorEnergy",
)


@dataclass
class ContrastMeasureEnergySetup(EnergySetup):
    """CNN-free data term + priors. ``contrast_type`` names a contrast
    measure (``mpp/classic_energies.py``) or 'gradient'."""

    contrast_type: str = "craciun2"
    rewarding_priors: bool = True
    manual_threshold: Optional[float] = None
    target_ratio: float = 0.5
    calibration: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        gradient = self.contrast_type == "gradient"
        contrast = None if gradient else ContrastConfig(
            measure=self.contrast_type,
            gap=1 if self.contrast_type != "craciun" else 0,
            erode=1 if self.contrast_type != "craciun" else 0,
            rgb=self.contrast_type != "t-test",
            thresh=self.manual_threshold or 0.0)
        self.spec = EnergySpec(
            names=CONTRAST_NAMES, shape_mode="mean", use_ratio_prior=True,
            rewarding_align=self.rewarding_priors,
            data_term="gradient" if gradient else "contrast",
            contrast=contrast)

    def calibrate(self, image_configs: List[ImageWMaps], rng, save_path: str):
        """Area quantiles from the GT marks."""
        min_area, max_area = calibrate_min_area(
            [c.gt_marks for c in image_configs])
        self.calibration = {"min_area": min_area, "max_area": max_area,
                            "detection_threshold": self.manual_threshold
                            or 0.0}
        self._save_calibration(save_path)

    def make_maps(self, data: ImageWMaps) -> EnergyMaps:
        """The maps with the image, or for 'gradient' its gray level's
        ``np.gradient`` (d/dy, d/dx, 0), made on the host."""
        cal = self.calibration
        img = data.image
        if self.contrast_type == "gradient":
            gray = np.mean(img.cpu().numpy() if isinstance(img, torch.Tensor)
                           else np.asarray(img), -1)
            grad = np.stack(np.gradient(gray), axis=-1)
            img = np.concatenate([grad, np.zeros_like(grad[..., :1])], -1)
        return make_energy_maps(
            detection_map=data.detection_map,
            mark_energy_maps=[-m for m in data.param_dist_maps],
            threshold=0.0, min_area=cal["min_area"],
            max_area=cal["max_area"], mappings=data.mappings,
            target_ratio=self.target_ratio, image=img)

    @property
    def detection_threshold(self) -> float:
        return 0.5


def make_energy_setup(config: Dict[str, Any]) -> EnergySetup:
    """The setup named by the mpp config (``energy_setup`` +
    ``energy_setup_params``)."""
    kind = config.get("energy_setup") or "legacy"
    kwargs = config.get("energy_setup_params") or {}
    if kind == "legacy":
        cal_params = (config.get("calibration") or {}).get("params") or {}
        return LegacyEnergySetup(calibration_params=cal_params, **kwargs)
    if kind in ("no-calibration", "no_calibration", "no_calib"):
        return NoCalibrationEnergySetup(**kwargs)
    if kind == "contrast":
        return ContrastMeasureEnergySetup(**kwargs)
    raise ValueError(f"unknown energy setup {kind}")

