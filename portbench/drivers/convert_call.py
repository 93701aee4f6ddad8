"""Driver of single conversion calls: ``ConversionPipeline.convert(wav,
target_speaker, sr=16000, source_speaker)``, one caller in a closed loop: HuBERT and the
k-means codebook for units, YAAPT for the record's f0, then the prosody
and the vocoder at batch 1.

Set-up builds the pipeline and the unit encoder from the benchmark's
seeded weights, with a codebook of HuBERT features (the reference's, of
frames drawn from the seed), makes the calls' waveforms, runs every
prosody and vocoder bucket at batch 1 and converts each waveform once
(every length the window sends).  The window times each call from
call to returned waveform.  A seeded uniform sample of ``check.calls``
calls that the window finished, and the first call of the mix's longest
waveform, are judged by the reference afterwards: the units by the widest
gap of the program's centroid's distance over the nearest one, as a share
of the mean nearest distance; the record's f0 by the count of unit frames
whose f0 differs from the reference tracker's by more than 1e-4 of it (an
exact comparison: the tracker picks one of its candidate lags, so the
program's f0 is the reference's or another lag's);
the rest as ``portbench/convert.py`` judges a converted record.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import convert as cv
from portbench import traffic as tf
from portbench import weights as wt
from portbench.reference import hubert as rh
from portbench.reference import yaapt as ry
from portbench.reference.ops import Ops

CODEBOOK_WAVS = 4
F0_TOL = 1e-4
WRONG_COUNT = 1e6  # the unit gap read when the program returns a wrong number of units


def encoder_weights(run) -> dict:
    return wt.materialize(rh.hubert_spec(run.config["hubert"]),
                          wt.sub_seed(run.seed, "weights") + 3, run.device)


def make_codebook(run, hub: dict, calls: list) -> tuple:
    """(the codebook: the reference features of frames drawn from the seed
    among the first calls' waveforms, as k-means++ starts; the rhythm
    model's calibration records: every call's units under it, with the
    call's target)."""
    c = run.config["hubert"]
    spk = cv.speaker_index(run)
    with cv.reference_time(run), torch.no_grad(), Ops("float32").numerics():
        feats = [rh.features(Ops("float32"), hub, c,
                             torch.from_numpy(k["wav"][None]).to(run.device))[0]
                 for k in calls]
        allf = torch.cat(feats[:CODEBOOK_WAVS])
        pick = wt.rng(run.seed, "codebook").choice(len(allf), run.config["prosody"]["n_tokens"],
                                                  replace=False)
        codebook = allf[torch.from_numpy(pick).to(run.device)]
        cal = [(rh.distances(Ops("float32"), f, codebook).argmin(dim=1).tolist(),
                spk[k["target"]]) for f, k in zip(feats, calls)]
    return codebook, cal


def setup(run):
    from dissc_tpu_torch.models.hubert import HubertConfig, SpeechUnitEncoder

    calls = tf.wav_calls(run.traffic, wt.rng(run.seed, "calls"))
    hub = encoder_weights(run)
    codebook, cal = make_codebook(run, hub, calls)
    encoder = SpeechUnitEncoder(hub, codebook.cpu().numpy(), HubertConfig(**run.config["hubert"]),
                                device=run.device)
    del hub
    pipe = cv.build_pipeline(run, cv.model_weights(run, cal), encoder=encoder)
    s = {"pipe": pipe, "calls": calls, "codebook": codebook, "calibration": cal, "done": 0,
         "longest": int(np.argmax([len(k["wav"]) for k in calls])), "kept_longest": None,
         "sample": cv.Reservoir(run.workload["check"]["calls"], wt.rng(run.seed, "sample"))}
    run.spans.wrap(pipe, "encode", "encode", keep=lambda out: s.__setitem__("record", out))
    run.spans.wrap(pipe.prosody, "convert_records", "prosody",
                   keep=lambda out: s.__setitem__("converted", out[0]))
    run.spans.wrap(pipe.vocoder, "synthesize_utterances", "vocode")
    cv.warm_shapes(run, pipe, max(len(k["wav"]) for k in calls) // run.config["code_hop_size"], 1)
    for _ in calls:
        _call(run, s)
    return s


def _call(run, s) -> dict:
    i = s["done"] % len(s["calls"])
    call = s["calls"][i]
    s["done"] += 1
    with run.spans.span("call"):
        t0 = time.perf_counter_ns()
        wav, sr = s["pipe"].convert(call["wav"], call["target"], sr=tf.SR,
                                    source_speaker=call["source"])
        t1 = time.perf_counter_ns()
    return {"i": i, "ms": (t1 - t0) / 1e6, "wav": wav, "record": s.pop("record"),
            "converted": s.pop("converted")}


def window(run, s, seconds: float) -> dict:
    hop = run.config["code_hop_size"]
    lat, failed, audio_s, work = [], 0, 0.0, []
    cut0 = s["pipe"].prosody.truncation_count
    t0 = time.perf_counter_ns()
    while time.perf_counter_ns() - t0 < seconds * 1e9:
        done = _call(run, s)
        lat.append(done["ms"])
        conv = done["converted"]
        failed += len(done["wav"]) != len(conv["units"]) * hop
        audio_s += len(done["wav"]) / tf.SR
        work.append((len(s["calls"][done["i"]]["wav"]), cv.runs_of(done["record"]["units"]),
                     len(conv["units"])))
        if done["i"] == s["longest"] and s["kept_longest"] is None:
            s["kept_longest"] = done
        else:
            s["sample"].offer(done)
    t1 = time.perf_counter_ns()
    return {"t0_ns": t0, "t1_ns": t1, "attempted": len(lat), "failed": failed,
            "latency_ms": lat, "audio_s": audio_s, "work": work,
            "truncations": s["pipe"].prosody.truncation_count - cut0}


def release(run, s) -> None:
    s.pop("pipe")


def unit_readings(run, hub: dict, codebook: torch.Tensor, judged: list, calls: list,
                  ops: Ops) -> dict:
    c = run.config["hubert"]
    unit_gap, f0_bad = 0.0, 0
    with torch.no_grad(), ops.numerics():
        for done in judged:
            wav = calls[done["i"]]["wav"]
            feats = rh.features(ops, hub, c, torch.from_numpy(wav[None]).to(run.device))[0]
            d = rh.distances(ops, feats, codebook).double()
            units = torch.tensor(done["record"]["units"], device=run.device)
            if len(units) != len(d):  # a unit count the waveform cannot have
                unit_gap = max(unit_gap, WRONG_COUNT)
                continue
            d_min = d.min(dim=1).values
            gap = (d.gather(1, units[:, None])[:, 0] - d_min).max() / d_min.mean().clamp(min=1e-30)
            unit_gap = max(unit_gap, float(gap))
            f0_ref = ry.f0_per_unit(ry.yaapt_f0(ops, wav, run.device, tf.SR), len(units))
            f0 = np.asarray(done["record"]["f0"], np.float64)
            f0_bad += int(np.sum(np.abs(f0 - f0_ref) > F0_TOL * np.maximum(f0_ref, 1.0)))
    return {"unit_gap": unit_gap, "f0_mismatch": float(f0_bad)}


def judged(s) -> list:
    return s["sample"].items + ([s["kept_longest"]] if s["kept_longest"] else [])


def items(s, done_list) -> list:
    return [{"units": d["record"]["units"], "target": s["calls"][d["i"]]["target"],
             "out_units": d["converted"]["units"], "out_f0": d["converted"]["f0"],
             "wav": d["wav"]} for d in done_list]


def check(run, s, result) -> dict:
    """The unit, f0 and conversion readings, with the count of the window's
    conversions that the prosody converter cut at its output cap."""
    ops = Ops("float32")
    done = judged(s)
    readings = unit_readings(run, encoder_weights(run), s["codebook"], done, s["calls"], ops)
    readings.update(cv.judge(run, cv.model_weights(run, s["calibration"]), items(s, done), ops))
    return dict(readings, truncations=float(result["truncations"]))
