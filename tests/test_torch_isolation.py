"""The PyTorch port, chip_smoke.py and bench_torch.py must run where the JAX
stack is absent: with jax, flax, optax, msgpack, PIL, ninja and the JAX
package blocked, every module of the port and both scripts import, the
checkpoint reader decodes a checked-in flax checkpoint, and the synthetic
dataset writer and the PNG codec run."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "mpp_cnn_rs_object_detection_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "PIL", "ninja",
           "mpp_cnn_rs_object_detection_tpu")
CKPT = os.path.join(ROOT, "artifacts", "models_storage", "posnet",
                    "pos_r2cp_tta", "model.msgpack")

SCRIPT = f"""
import importlib, os, pkgutil, sys, tempfile
for name in {BLOCKED!r}:
    sys.modules[name] = None
sys.path.insert(0, {ROOT!r})
import {PORT}
mods = [m.name for m in pkgutil.walk_packages({PORT}.__path__, "{PORT}.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
import bench_torch
from {PORT}.models.checkpoint import read_checkpoint
ck = read_checkpoint({CKPT!r})
assert ck["params"]["net"]["Conv_0"]["kernel"].shape == (1, 1, 32, 3)
from {PORT}.data.synth import make_synth_dataset
from {PORT}.utils import png
with tempfile.TemporaryDirectory() as tmp:
    make_synth_dataset(name="s", n_items=1, shape=(32, 40), n_rect=4,
                       base_dir=tmp)
    img = png.read_png(os.path.join(tmp, "s", "val", "images", "0000.png"))
    assert img.shape == (32, 40, 3), img.shape
    png.write_png(os.path.join(tmp, "copy.png"), img)
    assert (png.read_png(os.path.join(tmp, "copy.png")) == img).all()
loaded = [n for n in sys.modules if n.split(".")[0] in {BLOCKED!r}
          and sys.modules[n] is not None]
assert not loaded, loaded
print("OK", len(mods))
"""


def test_port_imports_without_jax_stack():
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[-1])
    assert n_modules >= 20


def _sources():
    for dirpath, _, files in os.walk(os.path.join(ROOT, PORT)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "bench_torch.py")


def test_no_blocked_import_anywhere_in_the_source():
    """Also imports inside functions, which the import test cannot reach."""
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in BLOCKED, (path, n)
