"""Readings that set the limits of a cell's output check (not run by the
benchmark's own runs).

    python3 portbench/control.py --workload <cell> --mode <mode> --seeds 1 2 3 [--seconds s]

Modes, each printing one JSON line a seed with the numbers the check
compares:

* ``program``: whole runs of the cell (short windows), in one process:
  the program's readings, whose largest over a dozen seeds or more is a
  limit's lower reading;
* ``control``: the plain reference put in the program's place, computed
  one precision below the configuration's (TF32 for float32 with TF32 off,
  float8 e4m3 for bfloat16), judged by the float32 reference as a run
  judges the program, on as many records or calls as a run compares: the
  smallest of these is a limit's upper reading;
* ``half_batch`` (training): the reference put in the program's place,
  training on half of each batch, the mean taken over it; a fault the
  training check must catch;
* ``lr_scaled`` (training): the reference put in the program's place with
  its learning rate 1.25 times the configuration's: an optimizer update of
  the wrong size, which the later losses and the leaves' changes must show.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CONTROL_PRECISION = {"float32": "tf32", "bfloat16": "fp8"}
LR_SCALE = 1.25


def control_readings(run, driver, mode: str) -> dict:
    """The readings of ``mode`` (``control``, ``half_batch`` or ``lr_scaled``) for ``run``."""
    import torch

    from portbench import convert as cv
    from portbench import traffic as tf
    from portbench import weights as wt
    from portbench.reference import hubert as rh
    from portbench.reference import yaapt as ry
    from portbench.reference.ops import Ops

    f32 = Ops("float32")
    low = Ops(CONTROL_PRECISION[run.config["precision"]]) if mode == "control" else f32
    kind = run.workload["driver"]
    if kind == "train":
        s = driver.setup(run)
        driver.release(run, s)
        gc.collect()
        truth = driver.reference_readings(run, s, f32)
        if mode == "half_batch":
            half = lambda b: {k: v[: len(v) // 2] for k, v in b.items()}  # noqa: E731
            s["batches"] = [half(b) for b in s["batches"]]
        if mode == "lr_scaled":
            s["h"] = dataclasses.replace(s["h"], learning_rate=s["h"].learning_rate * LR_SCALE)
        return driver.compare(driver.reference_readings(run, s, low), truth)
    if mode != "control":
        raise ValueError(f"mode {mode} is for the training cell")
    if kind == "convert_batch":
        jobs = tf.unit_jobs(run.traffic, wt.rng(run.seed, "jobs"))
        w = cv.model_weights(run, driver.calibration(run, jobs))
        picked = jobs[driver.WARM_JOBS: driver.WARM_JOBS + run.workload["check"]["jobs"]]
        items = cv.reference_items(run, low, w, [(r["units"], j["target"]) for j in picked
                                                 for r in j["records"]])
        return dict(cv.judge(run, w, items, f32), truncations=float(sum(it["cut"] for it in items)))
    calls = tf.wav_calls(run.traffic, wt.rng(run.seed, "calls"))
    hub = driver.encoder_weights(run)
    codebook, cal = driver.make_codebook(run, hub, calls)
    w = cv.model_weights(run, cal)
    done = []
    c = run.config["hubert"]
    with low.numerics():
        for i in range(min(len(calls), run.workload["check"]["calls"] + 1)):
            wav = calls[i]["wav"]
            feats = rh.features(low, hub, c, torch.from_numpy(wav[None]).to(run.device))[0]
            units = rh.distances(low, feats, codebook).argmin(dim=1).tolist()
            f0 = ry.f0_per_unit(ry.yaapt_f0(low, wav, run.device, tf.SR), len(units))
            done.append({"i": i, "record": {"units": units, "f0": f0.tolist()}})
    items = cv.reference_items(run, low, w, [(d["record"]["units"], calls[d["i"]]["target"])
                                             for d in done])
    for d, it in zip(done, items):
        d["converted"] = {"units": it["out_units"], "f0": it["out_f0"]}
        d["wav"] = it["wav"]
    readings = driver.unit_readings(run, hub, codebook, done, calls, f32)
    readings.update(cv.judge(run, w, items, f32))
    return dict(readings, truncations=float(sum(it["cut"] for it in items)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("program", "control", "half_batch", "lr_scaled"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[0] = ROOT
    from portbench import run as R

    R.set_cache_dirs()
    import torch

    for seed in args.seeds:
        t0 = time.time()
        if args.mode == "program":
            out, readings = R.run_cell(args.workload, seed, args.seconds, False,
                                       device=args.device, start=t0, readings_too=True)
            extra = {"correct": out["correct"], "metrics": out["metrics"],
                     "memory_peak_bytes": out["device"]["memory_peak_bytes"]}
        else:
            run = R.make_run(args.workload, seed, args.device)
            try:
                readings = control_readings(run, R.load_module("drivers",
                                                                run.workload["driver"]), args.mode)
            finally:
                shutil.rmtree(run.tmpdir, ignore_errors=True)
            extra = {}
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "seconds": time.time() - t0, "readings": readings, **extra}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
