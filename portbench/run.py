"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the PyTorch port
(``dissc_tpu_torch``) on a machine with enough CUDA cards for the cell.
Everything is found by name:

* ``BENCHMARK.json`` lists the cell's metrics;
* ``portbench/workloads/<cell>.json`` names its configuration, its driver,
  its traffic parameters and the limits of its output check;
* ``portbench/configs/<config>.json`` holds the configuration as it is run;
* ``portbench/drivers/<driver>.py`` builds the program, warms it up, runs
  the measured window and checks what the window produced;
* ``portbench/end_to_end/<metric>.py`` and ``portbench/metrics/<metric>.py``
  read one metric each from what the run recorded; a reader that finds
  nothing returns ``None`` and the metric is left out.

It prints one JSON line last on standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with its limit),
and the same numbers last on standard error.  With ``--trace 0`` the
metrics are the cell's end-to-end ones, with ``--trace 1`` its per-layer
ones, read from a ``torch.profiler`` trace of the window.
"""
from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "dissc_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dissc_tpu")


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``dissc_tpu_torch`` is not
    ``dissc_tpu``."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, key: str) -> list:
    """The metrics of ``bench[key]`` that ``cell`` reports."""
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


def set_cache_dirs() -> None:
    """Kernel and build caches of the program at fixed paths in the checkout."""
    build = os.path.join(ROOT, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def make_run(cell: str, seed: int, device: str = "cuda", config_over: dict = None,
             traffic_over: dict = None) -> SimpleNamespace:
    """What a driver is given: the cell's workload, configuration and
    traffic (``*_over`` update their keys, for small runs in tests), the
    seed, the device, a span recorder, a fresh temporary directory and
    ``reference_s``, the seconds the reference has worked so far (its
    work during set-up is left out of ``setup_s``)."""
    import torch

    from portbench.spans import Spans

    wl = load_json(HERE, "workloads", f"{cell}.json")
    cfg = load_json(HERE, "configs", f"{wl['config']}.json")
    for key, value in (config_over or {}).items():
        cfg[key] = dict(cfg[key], **value) if isinstance(value, dict) else value
    traffic = dict(wl["traffic"], **(traffic_over or {}))
    tmp = tempfile.mkdtemp(prefix=f"portbench_{cell}_", dir=os.environ.get("TMPDIR"))
    return SimpleNamespace(cell=cell, workload=wl, config=cfg, traffic=traffic, seed=seed,
                           device=torch.device(device), spans=Spans(), tmpdir=tmp,
                           reference_s=0.0)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             start: float = PROCESS_START, config_over: dict = None, traffic_over: dict = None,
             bench: dict = None, readings_too: bool = False):
    """One run of ``cell``; returns the result object (with
    ``readings_too``, and every reading of the check, compared or not).
    ``config_over`` and ``traffic_over`` (tests only) update the
    configuration's and the traffic's keys, to run a small cell on the CPU."""
    import torch

    from portbench import trace as tr

    bench = bench or load_json(ROOT, "BENCHMARK.json")
    run = make_run(cell, seed, device, config_over, traffic_over)
    driver = load_module("drivers", run.workload["driver"])
    dev = run.device
    peaks = load_json(HERE, "peaks.json")["cards"]
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    tmp = run.tmpdir
    try:
        state = driver.setup(run)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)  # the peak of the measured window
        setup_s = time.time() - start - run.reference_s
        print(f"portbench: set-up {setup_s:.3f} s, less the reference's {run.reference_s:.3f} s",
              file=sys.stderr)
        kernels = None
        if trace:
            with tr.DeviceTrace() as dt:
                result = driver.window(run, state, seconds)
            kernels = dt.kernels
        else:
            result = driver.window(run, state, seconds)
        peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        driver.release(run, state)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        readings = driver.check(run, state, result)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    t0, t1 = result["t0_ns"], result["t1_ns"]
    reading = SimpleNamespace(
        run=run, result=result, window_s=(t1 - t0) / 1e9, setup_s=setup_s,
        spans=run.spans, peak=peaks.get(card), kernels=kernels, t0=t0, t1=t1,
        busy_s=(tr.length_ns(tr.busy(kernels, t0, t1)) / 1e9 if kernels is not None else None))
    if trace and dev.type == "cuda" and reading.peak is None:
        raise RuntimeError(f"no published peak for the card {card!r} in portbench/peaks.json")
    metrics = {}
    for m in cell_metrics(bench, cell, "per_layer" if trace else "end_to_end"):
        value = load_module("metrics" if trace else "end_to_end", m["name"]).read(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": card,
                   "count": 1, "memory_peak_bytes": int(peak_bytes)}
    checks = [{"name": k, "value": readings[k], "limit": v}
              for k, v in run.workload["check"]["limits"].items()]
    out = {"correct": result["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks),
           "attempted": result["attempted"], "failed": result["failed"],
           "metrics": metrics, "device": device_info}
    if trace:
        device_info.update(busy_s=reading.busy_s, window_s=reading.window_s)
        out["breakdown"] = tr.breakdown(kernels, run.spans.spans, t0, t1)
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return (out, readings) if readings_too else out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[0] = ROOT
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"portbench: the program ({PROGRAM}) is not in {ROOT}", file=sys.stderr)
        return 2
    set_cache_dirs()
    import torch

    wl = load_json(HERE, "workloads", f"{args.workload}.json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"portbench: {args.workload} needs {wl['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"portbench: modules of the JAX package or JAX were loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
