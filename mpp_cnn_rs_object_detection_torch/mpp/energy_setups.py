"""Energy setups: which terms exist and how they are calibrated.

Counterpart of ``EnergySetup`` / ``NoCalibrationEnergySetup`` in
``mpp_cnn_rs_object_detection_tpu/mpp/energy_setups.py``: Position
(threshold 0) + three single-mark terms (``-p``, or the logistic remap) +
overlap / alignment / area priors (+ the optional ratio prior).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from mpp_cnn_rs_object_detection_torch.mpp.calibration import (
    apply_remap_param_dist,
    calibrate_min_area,
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

    def load_calibration(self, save_dir: str):
        raise NotImplementedError

    def make_maps(self, data: ImageWMaps) -> EnergyMaps:
        raise NotImplementedError

    @property
    def detection_threshold(self) -> float:
        raise NotImplementedError

    def make_kernel_data(self, data: ImageWMaps, intensity: float
                         ) -> KernelData:
        return make_kernel_data(data.detection_map, data.param_dist_maps,
                                data.mappings, intensity=intensity)


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
        """Area quantiles from the GT marks (the mark-remap calibration,
        ``calib_marks``, is not ported)."""
        if self.calib_marks:
            raise NotImplementedError("mark-remap calibration is not ported")
        min_area, max_area = calibrate_min_area(
            [c.gt_marks for c in image_configs])
        self.calibration = {"min_area": min_area, "max_area": max_area,
                            "detection_threshold": 0.0}
        if save_path:
            with open(os.path.join(save_path, "calibration.json"), "w") as f:
                json.dump(self.calibration, f, indent=1)

    def load_calibration(self, save_dir: str):
        with open(os.path.join(save_dir, "calibration.json")) as f:
            self.calibration = json.load(f)

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


def make_energy_setup(config: Dict[str, Any]) -> EnergySetup:
    """The setup named by the mpp config (``energy_setup`` +
    ``energy_setup_params``); only ``no-calibration`` is ported."""
    kind = config.get("energy_setup") or "legacy"
    kwargs = config.get("energy_setup_params") or {}
    if kind in ("no-calibration", "no_calibration", "no_calib"):
        return NoCalibrationEnergySetup(**kwargs)
    raise NotImplementedError(f"energy setup {kind!r} is not ported")

