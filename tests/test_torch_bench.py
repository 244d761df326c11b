"""The port's bench script (``bench_torch.py``) on the CPU at tiny shapes:
every stage runs and the last line is one parseable JSON object with the
headline, the B = 1 and B = 3 ms per superstep, and the sequential chains'
moves/s against the plain-Python baseline's.
Without a CUDA device and without ``--device cpu`` it fails and prints no
result."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def _run(*args):
    return subprocess.run([sys.executable, "bench_torch.py", *args],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT, env=ENV)


def test_bench_prints_one_json_line_on_cpu():
    out = _run("--device", "cpu", "--small")
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[-1])
    assert line["metric"] == "scene_seconds_per_scene_batched3"
    assert line["value"] > 0
    extra = line["extra"]
    assert extra["device"] == "cpu" and extra["nvidia_smi"] is None
    assert extra["depth_cut"] is True
    assert set(extra["stages"]) == {"cnn", "scene", "scene_batched",
                                    "superstep", "sequential", "baseline"}
    assert extra["stages"]["cnn"]["mfu"] is None  # no device metric on CPU
    assert extra["stages"]["scene_batched"]["scenes"] == 3
    assert set(extra["ms_per_superstep"]) == {"B1", "B3"}
    seq, base = extra["stages"]["sequential"], extra["stages"]["baseline"]
    assert seq["chains"] == 2 and seq["steps"] == 10
    assert seq["moves_per_s"] > 0 and base["moves_per_s"] > 0
    assert extra["sequential_vs_baseline"] == (seq["moves_per_s"]
                                               / base["moves_per_s"])
    assert "absent" not in extra
    for stage in ("scene", "scene_batched"):
        s = extra["stages"][stage]
        assert s["supersteps"] < s["planned_supersteps"]


def test_bench_refuses_to_run_without_a_card():
    """The default device is CUDA: with none, the script raises."""
    script = ("import sys, torch; torch.cuda.is_available = lambda: False; "
              "sys.argv = ['bench_torch.py', '--small']; "
              "import runpy; runpy.run_path('bench_torch.py', "
              "run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=ENV)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not out.stdout.strip()
