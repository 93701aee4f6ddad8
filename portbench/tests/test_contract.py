"""Each driver's small CPU run prints a result that meets the benchmark's
contract, and the trace arithmetic is right on a made-up timeline."""
import json

import pytest

from portbench import trace as tr
from portbench.run import ROOT, cell_metrics, load_json
from portbench.tests.small import CELLS, small_run

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    out = small_run(cell)
    line = json.dumps(out, allow_nan=False)
    assert json.loads(line) == out
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    bench = load_json(ROOT, "BENCHMARK.json")
    want = {m["name"]: m["unit"] for m in cell_metrics(bench, cell, "end_to_end")}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["checks"] and all(set(c) == {"value", "limit"} for c in out["checks"].values())


def test_busy_union_and_idle_labels():
    kernels = [("a", 10, 20), ("b", 15, 30), ("a", 50, 60), ("c", 95, 120)]
    spans = {"outer": [(0, 100)], "inner": [(30, 50)]}
    assert tr.busy(kernels, 0, 100) == [(10, 30), (50, 60), (95, 100)]
    assert tr.length_ns(tr.busy(kernels, 0, 100)) == 35
    b = tr.breakdown(kernels, spans, 0, 100)
    assert dict((k, v * 1e9) for k, v in b["device_ops"]) == pytest.approx(
        {"a": 20, "b": 15, "c": 5})
    # gaps: 0-10 and 60-95 in outer, 30-50 in inner
    assert dict((k, v * 1e9) for k, v in b["idle_gaps"]) == pytest.approx(
        {"outer": 45, "inner": 20})
