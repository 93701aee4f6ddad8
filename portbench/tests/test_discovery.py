"""The harness finds a configuration, a cell and a per-layer metric that are
dropped in as files, with no edit to any file that is there; and it refuses
to run where the program or a card is missing."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.tests.small import SMALL_TRAFFIC, TINY

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@pytest.fixture
def copy(tmp_path):
    """A checkout holding only ``BENCHMARK.json`` and the benchmark's files."""
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    return tmp_path


def test_new_config_cell_and_metric_by_files_alone(copy):
    cfg = json.load(open(copy / "portbench/configs/vctk_f32.json"))
    cfg["note"] = "a configuration added as a file"
    json.dump(cfg, open(copy / "portbench/configs/vctk_f32_copy.json", "w"))
    wl = json.load(open(copy / "portbench/workloads/f32_convert_batch.json"))
    wl["config"] = "vctk_f32_copy"
    json.dump(wl, open(copy / "portbench/workloads/new_cell.json", "w"))
    (copy / "portbench/metrics/records_done.new.py").write_text(
        "def read(r):\n    return float(r.result['attempted'])\n")
    bench = json.load(open(copy / "BENCHMARK.json"))
    bench["workloads"].append({"name": "new_cell", "config": "vctk_f32_copy",
                               "traffic": "unit_jobs", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "records_done.new", "unit": "records", "better": "higher",
                               "source": "host_clock", "layer": "whole conversion",
                               "moves": "convert_audio_s_per_s", "workloads": ["new_cell"]})
    bench["end_to_end"][1]["workloads"].append("new_cell")
    code = f"""
import json, sys
sys.path.insert(0, {str(copy)!r}); sys.path.append({ROOT!r})
from portbench import run as R
assert R.HERE == {str(copy / 'portbench')!r}
out = R.run_cell("new_cell", 5, 0.3, False, device="cpu", config_over={TINY!r},
                 traffic_over={SMALL_TRAFFIC['f32_convert_batch']!r}, bench={bench!r})
print(json.dumps(out))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=copy,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert set(out["metrics"]) == {"convert_audio_s_per_s", "setup_s"}
    assert out["correct"] is True
    # the new per-layer metric's reader is found by its name
    code2 = code.replace(
        "print(json.dumps(out))",
        "m = R.load_module('metrics', 'records_done.new'); print(m.read(type('r', (), "
        "{'result': {'attempted': 3}})))")
    res2 = subprocess.run([sys.executable, "-c", code2], capture_output=True, text=True,
                          cwd=copy, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res2.returncode == 0, res2.stderr[-3000:]
    assert res2.stdout.strip().splitlines()[-1] == "3.0"


def test_refuses_without_the_program(copy):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "f32_train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=copy,
                         env={"PATH": os.environ["PATH"], "HOME": str(copy)})
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "f32_train",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
