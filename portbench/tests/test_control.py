"""The controls fail the output check: the plain reference put in the
program's place one precision below the configuration's (TF32, emulated on
the CPU, for float32; float8 e4m3 for bfloat16), and, for training, the
reference trained on half of each batch or at 1.25 times the learning rate.

On the card, at each cell's own size (the readings the limits were set
from): ``python3 portbench/control.py --workload <cell> --mode control --seeds 1 2 3``
(``--mode half_batch`` and ``--mode lr_scaled`` for ``f32_train``), or the
``card`` test below."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import control
from portbench import run as R
from portbench.tests.small import CELLS, SMALL_TRAFFIC, TINY

MODES = [(c, "control") for c in CELLS] + [("f32_train", m) for m in ("half_batch", "lr_scaled")]


def fails(cell: str, readings: dict) -> list:
    limits = R.load_json(R.HERE, "workloads", f"{cell}.json")["check"]["limits"]
    return [k for k, v in limits.items() if readings[k] > v]


@pytest.mark.parametrize("cell,mode", MODES)
def test_control_fails_small(cell, mode):
    torch.set_num_threads(4)
    run = R.make_run(cell, 2 ** 31 + 29, "cpu", TINY, SMALL_TRAFFIC[cell])
    try:
        readings = control.control_readings(
            run, R.load_module("drivers", run.workload["driver"]), mode)
    finally:
        shutil.rmtree(run.tmpdir, ignore_errors=True)
    assert fails(cell, readings), readings


@pytest.mark.card
@pytest.mark.parametrize("cell,mode", MODES)
def test_control_fails_on_the_card(card, cell, mode):
    res = subprocess.run([sys.executable, "portbench/control.py", "--workload", cell, "--mode",
                          mode, "--seeds", "3", "4", "5"], capture_output=True, text=True,
                         cwd=R.ROOT, check=True)
    for line in res.stdout.strip().splitlines():
        assert fails(cell, json.loads(line)["readings"]), line
