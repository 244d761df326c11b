"""The oracle model of the PyTorch port against the JAX package: on one
translated DOTA set (a raw tree of ``tests/test_torch_translate.py``, its
empty scene kept) both packages' ``infer`` and ``eval`` write the same
result pickles, DOTA files and metrics, and the AP is 1.0 at every IoU."""

import json
import os
import pickle
import shutil

import numpy as np

from mpp_cnn_rs_object_detection_torch.__main__ import main as t_main
from mpp_cnn_rs_object_detection_torch.data.translate_dota import (
    translate_dota,
)
from mpp_cnn_rs_object_detection_tpu.models.oracle_model import (
    OracleModel as JOracle,
)
from tests import _torch_workspace as tw
from tests.test_torch_translate import SCENES, _config, write_raw_dota

DATASET = "DOTA_oracle"
IOUS = (0.05, 0.1, 0.25, 0.5, 0.75)


def _results(ws, name="oracle"):
    return ws / "data" / "inference" / DATASET / "val" / name


def test_oracle_matches_jax_with_ap_one(tmp_path):
    raw = tmp_path / "raw"
    # the val subset with the train subset's empty scene 5 moved into it
    scenes = [s if s[0] != 5 else (15, "val") + s[2:] for s in SCENES]
    write_raw_dota(str(raw), scenes)
    ws_j = tw.workspace(tmp_path / "jax")
    ws_t = tw.workspace(tmp_path / "torch")
    cfg = _config(raw, DATASET, prune_empty=False)
    cfg["subsets"] = ["val"]
    with tw.inside(ws_t):
        assert translate_dota(cfg) == {"val": 3}
    shutil.copytree(ws_t / "data" / DATASET, ws_j / "data" / DATASET)
    with open(os.path.join(tw.ROOT, "model_configs", "oracle",
                           "config_oracle.json")) as f:
        oracle_cfg = json.load(f)
    with tw.inside(ws_j):
        jm = JOracle(dict(oracle_cfg), dataset=DATASET)
        jm.infer(subset="val")
        jm.eval()
    with tw.inside(ws_t):
        tm = t_main(["-p", "infereval", "-m", "oracle", "-c",
                     "config_oracle", "-d", DATASET], device="cpu")
    assert tm.dataset == DATASET
    rj, rt = _results(ws_j), _results(ws_t)
    pickles = sorted(f for f in os.listdir(rj) if f.endswith(".pkl"))
    assert pickles == sorted(f for f in os.listdir(rt) if f.endswith(".pkl"))
    assert len(pickles) == 3
    n_det = 0
    for fname in pickles:
        with open(rj / fname, "rb") as f:
            want = pickle.load(f)
        with open(rt / fname, "rb") as f:
            got = pickle.load(f)
        assert got.keys() == want.keys()
        for k, w in want.items():
            g = got[k]
            assert type(g) is type(w), k
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=f"{fname} {k}")
        n_det += len(got["detection_score"])
    assert n_det > 0
    files = ["det/vehicle.txt", "imageSet.txt"] + [
        f"gt/{f}" for f in sorted(os.listdir(rj / "dota" / "gt"))]
    for f in files:
        assert ((rt / "dota" / f).read_bytes()
                == (rj / "dota" / f).read_bytes()), f
    for iou in IOUS:
        name = f"metrics{iou:.2f}.json"
        mj = json.loads((rj / "dota" / name).read_text())
        mt = json.loads((rt / "dota" / name).read_text())
        assert mt == mj, iou
        assert mt["vehicle"]["ap"] == 1.0, (iou, mt["vehicle"]["ap"])
