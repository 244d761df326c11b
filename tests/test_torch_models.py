"""CNN inference of the PyTorch port against the JAX package: the msgpack
reader against flax's, U-Net forwards with the same weights (random narrow
widths, and a real checked-in checkpoint at full width), and the PosNet /
ShapeNet inference paths with 8-way TTA through the port's detection-map
kernel (its plain version on CPU tensors)."""

import os
import types

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpp_cnn_rs_object_detection_torch.models import unet as tunet
from mpp_cnn_rs_object_detection_torch.models.checkpoint import (
    params_from_jax,
    read_checkpoint,
    read_msgpack,
)
from mpp_cnn_rs_object_detection_torch.models.posnet_model import (
    PosNetModel as TPosNetModel,
)
from mpp_cnn_rs_object_detection_torch.models.shapenet_model import (
    ShapeNetModel as TShapeNetModel,
)
from mpp_cnn_rs_object_detection_tpu.models import unet as junet
from mpp_cnn_rs_object_detection_tpu.models.posnet_model import (
    PosNetModel as JPosNetModel,
)
from mpp_cnn_rs_object_detection_tpu.models.shapenet_model import (
    ShapeNetModel as JShapeNetModel,
)
from mpp_cnn_rs_object_detection_tpu.ops.mappings import default_mappings
from tests._torch_util import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "artifacts", "models_storage", "posnet",
                    "pos_r2cp_tta", "model.msgpack")
NARROW = [8, 16]
# fp32 convolutions summed in another order by XLA and by torch's CPU
# kernels: ~1e-6 relative per layer, a few 1e-5 through a U-Net
RTOL, ATOL = 1e-4, 1e-4


def _image(h, w, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(
        np.float32)


def _jax_posnet(hidden, seed=0):
    net = junet.PosNet(hidden_dims=hidden, out_channels=3, dtype=jnp.float32)
    key = jax.random.PRNGKey(seed)
    var = net.init(key, jnp.zeros((1, 64, 64, 3)), train=False)
    # a steep div-classifier head so the detection map has structure
    div = {"Conv_0": {"kernel": jnp.full((1, 1, 1, 1), -12.0),
                      "bias": jnp.full((1,), -0.5)}}
    return net, {"net": var["params"], "div": div}, var["batch_stats"]


def _pos_config(hidden):
    return {"div_clf_model": True, "model": {"hidden_dims": hidden,
                                             "dtype": "float32"},
            "loss": {"learn_mask": True}, "inference": {"tta": True}}


def test_msgpack_reader_matches_flax():
    with open(CKPT, "rb") as f:
        blob = f.read()
    ours = read_msgpack(blob)
    ref = flax.serialization.msgpack_restore(blob)

    def same(a, b, path=""):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                same(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), path)

    same(ours, ref)
    # the scalar and chunked encodings flax also writes
    tree = {"s": np.float32(1.5), "i": 7, "n": None, "t": True,
            "big": {"a": np.arange(5, dtype=np.int64)}, "str": "x"}
    got = read_msgpack(flax.serialization.msgpack_serialize(tree))
    assert got["s"] == np.float32(1.5) and got["i"] == 7
    assert got["n"] is None and got["t"] is True and got["str"] == "x"
    np.testing.assert_array_equal(got["big"]["a"], np.arange(5))


@pytest.mark.parametrize("cls", ["posnet", "shapenet"])
def test_unet_random_narrow_fp32(cls):
    x = _image(64, 48, seed=1)[None]
    if cls == "posnet":
        jnet = junet.PosNet(hidden_dims=NARROW, dtype=jnp.float32)
        tnet = tunet.PosNet(NARROW)
    else:
        jnet = junet.ShapeNet(hidden_dims=NARROW, n_classes=8,
                              dtype=jnp.float32)
        tnet = tunet.ShapeNet(NARROW, n_classes=8)
    var = jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)),
                    train=False)
    # non-trivial BatchNorm statistics
    stats = jax.tree_util.tree_map(
        lambda a: np.random.default_rng(a.size).uniform(0.5, 1.5, a.shape)
        .astype(np.float32), var["batch_stats"])
    tnet.load_state_dict(params_from_jax(
        {"params": jax.device_get(var["params"]), "batch_stats": stats}))
    want = jnet.apply({"params": var["params"], "batch_stats": stats}, x,
                      train=False)
    with torch.no_grad():
        got = tnet.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=RTOL, atol=ATOL)


def test_real_checkpoint_full_width():
    """pos_r2cp_tta at hidden_dims [32, 64, 128, 256] on a 64x64 input:
    pins the reader and the ConvTranspose flip on trained weights."""
    ck = read_checkpoint(CKPT)
    jnet = junet.PosNet(hidden_dims=[32, 64, 128, 256], dtype=jnp.float32)
    tnet = tunet.PosNet([32, 64, 128, 256]).eval()
    tnet.load_state_dict(params_from_jax(
        {"params": ck["params"]["net"], "batch_stats": ck["batch_stats"]}))
    x = _image(64, 64, seed=2)[None]
    want = np.asarray(jnet.apply(
        {"params": ck["params"]["net"], "batch_stats": ck["batch_stats"]}, x,
        train=False))
    with torch.no_grad():
        got = tnet(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=RTOL, atol=ATOL)


def _jax_pos_model(hidden, seed=0):
    net, params, stats = _jax_posnet(hidden, seed)
    m = JPosNetModel.__new__(JPosNetModel)
    m.net, m.div_clf = net, junet.DivClassifier()
    m.state = types.SimpleNamespace(params=params, batch_stats=stats)
    m.config = {"inference": {"tta": True}}
    m._infer_fn_cache = {}
    return m, params, stats


def test_posnet_tta_detection_map():
    jm, params, stats = _jax_pos_model(NARROW)
    tm = TPosNetModel(_pos_config(NARROW), device="cpu")
    tm.load_variables(jax.device_get(params), jax.device_get(stats))
    img = _image(70, 90, seed=4)
    mask_j, vec_j = jm.infer_on_image(img)
    mask_t, vec_t = tm.infer_on_image(torch.from_numpy(img))
    np.testing.assert_allclose(mask_t.numpy(), mask_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(vec_t.numpy(), vec_j, rtol=RTOL, atol=ATOL)
    want = jm.detection_map_on_image(img)
    got = tm.detection_map_on_image(torch.from_numpy(img)).numpy()
    assert got.shape == (70, 90)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the no-div-classifier branch: clip(-div/2, 0, 1) * mask
    jm.div_clf, tm.div_clf = None, None
    np.testing.assert_allclose(
        tm.vec2detection_map(vec_t, mask_t).numpy(),
        jm.vec2detection_map(vec_j, mask_j), rtol=RTOL, atol=ATOL)


def test_shapenet_tta_dist_maps():
    n_cls = 8
    net = junet.ShapeNet(hidden_dims=NARROW, n_classes=n_cls,
                         dtype=jnp.float32)
    var = net.init(jax.random.PRNGKey(5), jnp.zeros((1, 64, 64, 3)),
                   train=False)
    jm = JShapeNetModel.__new__(JShapeNetModel)
    jm.net, jm.n_classes = net, n_cls
    jm.mappings = default_mappings(n_classes=n_cls)
    jm.state = types.SimpleNamespace(params=var["params"],
                                     batch_stats=var["batch_stats"])
    jm.config = {"inference": {"tta": True}}
    jm._infer_fn_cache = {}
    tm = TShapeNetModel({"trainer": {"n_classes": n_cls},
                         "model": {"hidden_dims": NARROW, "dtype": "float32"},
                         "inference": {"tta": True}}, device="cpu")
    tm.load_variables(jax.device_get(var["params"]),
                      jax.device_get(var["batch_stats"]))
    img = _image(70, 90, seed=6)
    want = jm.dist_maps_on_image(img)
    got = tm.dist_maps_on_image(torch.from_numpy(img))
    for w, g in zip(want, got):
        assert g.shape == (70, 90, n_cls)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


def test_tiled_inference_branch(monkeypatch):
    """Images above 2 * PATCH_SIZE per side are inferred in tiles; with a
    small patch size the same branch runs here and agrees with the JAX one."""
    from mpp_cnn_rs_object_detection_torch.models import posnet_model as tpm
    from mpp_cnn_rs_object_detection_tpu.models import posnet_model as jpm

    monkeypatch.setattr(jpm, "PATCH_SIZE", 64)
    monkeypatch.setattr(tpm, "PATCH_SIZE", 64)
    jm, params, stats = _jax_pos_model(NARROW)
    tm = TPosNetModel(_pos_config(NARROW), device="cpu")
    tm.load_variables(jax.device_get(params), jax.device_get(stats))
    img = _image(150, 100, seed=7)
    mask_j, vec_j = jm.infer_on_image(img)
    mask_t, vec_t = tm.infer_on_image(torch.from_numpy(img))
    np.testing.assert_allclose(mask_t.numpy(), mask_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(vec_t.numpy(), vec_j, rtol=RTOL, atol=ATOL)


def test_entry_points_default_to_cuda():
    """Without a device argument a model lives on the card; with no card
    that raises instead of falling back to the CPU."""
    cfg = {"div_clf_model": True, "model": {"hidden_dims": NARROW},
           "loss": {"learn_mask": True}}
    if torch.cuda.is_available():
        assert TPosNetModel(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TPosNetModel(cfg)
    assert TPosNetModel(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("tta", [True, False])
@pytest.mark.parametrize("head", ["div_clf", "detection"])
def test_posnet_detection_map_on_image(tta, head):
    """With and without TTA, with the DivClassifier head and without it:
    the port's fused route (its plain version here) against the JAX
    package's per-view forward + map + pull-back + mean."""
    jm, params, stats = _jax_pos_model(NARROW)
    jm.config = {"inference": {"tta": tta}}
    cfg = _pos_config(NARROW)
    cfg["inference"]["tta"] = tta
    tm = TPosNetModel(cfg, device="cpu")
    tm.load_variables(jax.device_get(params), jax.device_get(stats))
    if head == "detection":
        jm.div_clf, tm.div_clf = None, None
    img = _image(70, 90, seed=8)
    got = tm.detection_map_on_image(torch.from_numpy(img)).numpy()
    assert got.shape == (70, 90)
    np.testing.assert_allclose(got, jm.detection_map_on_image(img),
                               rtol=RTOL, atol=ATOL)


def test_tiled_detection_map_on_image(monkeypatch):
    """The tiled branch (sides above 2 * PATCH_SIZE) assembles each view's
    head planes into one pitched buffer that feeds the fused route."""
    from mpp_cnn_rs_object_detection_torch.models import posnet_model as tpm
    from mpp_cnn_rs_object_detection_tpu.models import posnet_model as jpm

    monkeypatch.setattr(jpm, "PATCH_SIZE", 64)
    monkeypatch.setattr(tpm, "PATCH_SIZE", 64)
    jm, params, stats = _jax_pos_model(NARROW)
    tm = TPosNetModel(_pos_config(NARROW), device="cpu")
    tm.load_variables(jax.device_get(params), jax.device_get(stats))
    img = _image(150, 98, seed=9)
    planes = tm.head_planes(torch.from_numpy(img))
    assert planes.shape == (3, 150, 100) and planes.stride(1) % 4 == 0
    got = tm.detection_map_on_image(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, jm.detection_map_on_image(img),
                               rtol=RTOL, atol=ATOL)


def test_tta_hands_all_views_to_one_fused_call(monkeypatch):
    """One ``detection_map_tta`` call per image, with the 8 views' raw head
    outputs (padded to the bucket, logit mask) in D4 order."""
    from mpp_cnn_rs_object_detection_torch.models import posnet_model as tpm
    from mpp_cnn_rs_object_detection_torch.ops.dihedral import D4_ELEMENTS

    calls = []
    real = tpm.detection_map_tta

    def spy(views, out_hw, **kw):
        calls.append((views, out_hw, kw))
        return real(views, out_hw, **kw)

    monkeypatch.setattr(tpm, "detection_map_tta", spy)
    tm = TPosNetModel(_pos_config(NARROW), device="cpu")
    tm.detection_map_on_image(torch.from_numpy(_image(70, 90, seed=10)))
    assert len(calls) == 1
    views, out_hw, kw = calls[0]
    assert out_hw == (70, 90) and kw["mask_is_logit"]
    assert kw["epilogue"] == "div_clf"
    assert [v.element for v in views] == list(D4_ELEMENTS)
    assert [v.crop for v in views] == [(70, 90), (90, 70)] * 4
    assert all(v.planes.shape == (3, 128, 128) for v in views)
