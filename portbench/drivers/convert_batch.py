"""Driver of batch conversion: ``ConversionPipeline.convert_batch(records,
target, batch_size)``, the path of ``cli.infer`` and ``cli.sr_inference``,
one caller in a closed loop over jobs of unit records, a target speaker
each.

Set-up builds the pipeline from the benchmark's seeded weights, makes the
jobs, runs every prosody and vocoder batch shape the jobs can reach and
converts two jobs.  The window counts the seconds of audio returned, at
the waveforms' true lengths.
A seeded uniform sample of ``check.jobs`` whole jobs that the window
finished (each holds the mix's longest record) is judged by the reference
afterwards (``portbench/convert.py``).
"""
from __future__ import annotations

import time

from portbench import convert as cv
from portbench import traffic as tf
from portbench import weights as wt
from portbench.reference.ops import Ops

WARM_JOBS = 2
CALIBRATION_RECORDS = 4  # a job


def calibration(run, jobs: list) -> list:
    """The rhythm model's calibration records: the first few of every job,
    each with its job's target (the speaker moves the durations), so that
    every seed's jobs convert to about their source lengths."""
    spk = cv.speaker_index(run)
    return [(r["units"], spk[j["target"]])
            for j in jobs for r in j["records"][:CALIBRATION_RECORDS]]


def setup(run):
    jobs = tf.unit_jobs(run.traffic, wt.rng(run.seed, "jobs"))
    cal = calibration(run, jobs)
    pipe = cv.build_pipeline(run, cv.model_weights(run, cal))
    s = {"pipe": pipe, "jobs": jobs, "done": 0, "calibration": cal,
         "sample": cv.Reservoir(run.workload["check"]["jobs"], wt.rng(run.seed, "sample"))}
    run.spans.wrap(pipe.prosody, "convert_records", "prosody",
                   keep=lambda out: s.__setitem__("converted", out))
    run.spans.wrap(pipe.vocoder, "synthesize_utterances", "vocode")
    max_frames = max(len(r["units"]) for j in jobs for r in j["records"])
    cv.warm_shapes(run, pipe, max_frames, run.traffic["batch_size"])
    for _ in range(WARM_JOBS):
        _job(run, s)
    return s


def _job(run, s) -> dict:
    job = s["jobs"][s["done"] % len(s["jobs"])]
    s["done"] += 1
    with run.spans.span("job"):
        wavs, sr = s["pipe"].convert_batch(job["records"], job["target"],
                                           batch_size=run.traffic["batch_size"])
    return {"job": job, "converted": s.pop("converted"), "wavs": wavs, "sr": sr}


def window(run, s, seconds: float) -> dict:
    hop = run.config["code_hop_size"]
    audio_s, records, failed, work = 0.0, 0, 0, []
    cut0 = s["pipe"].prosody.truncation_count
    t0 = time.perf_counter_ns()
    while time.perf_counter_ns() - t0 < seconds * 1e9:
        done = _job(run, s)
        for rec, conv, wav in zip(done["job"]["records"], done["converted"], done["wavs"]):
            records += 1
            failed += len(wav) != len(conv["units"]) * hop
            audio_s += len(wav) / done["sr"]
            work.append((cv.runs_of(rec["units"]), len(conv["units"])))
        s["sample"].offer(done)
    t1 = time.perf_counter_ns()
    return {"t0_ns": t0, "t1_ns": t1, "attempted": records, "failed": failed,
            "audio_s": audio_s, "work": work,
            "truncations": s["pipe"].prosody.truncation_count - cut0}


def release(run, s) -> None:
    s.pop("pipe")
    s.pop("jobs")


def items(sample) -> list:
    return [{"units": rec["units"], "target": done["job"]["target"], "out_units": conv["units"],
             "out_f0": conv["f0"], "wav": wav}
            for done in sample.items
            for rec, conv, wav in zip(done["job"]["records"], done["converted"], done["wavs"])]


def check(run, s, result) -> dict:
    """The reference's readings (``convert.judge``), with the count of the
    window's conversions that the prosody converter cut at its output cap."""
    w = cv.model_weights(run, s["calibration"])
    return dict(cv.judge(run, w, items(s["sample"]), Ops("float32")),
                truncations=float(result["truncations"]))
