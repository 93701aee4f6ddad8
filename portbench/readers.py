"""Helpers the per-layer metric readers share (``portbench/metrics/``).

A reader gets ``r``: ``r.result`` (what the driver's window returned),
``r.window_s``, ``r.spans`` (host spans), ``r.kernels`` (the device trace,
``(name, start_ns, end_ns)`` on the host clock), ``r.busy_s``, ``r.peak``
(the card's row of ``peaks.json``) and ``r.run`` (the cell, its
configuration and traffic).
"""
from __future__ import annotations

import dataclasses

from portbench import flops
from portbench import trace as tr


def peak_flops(r) -> float:
    """The card's dense tensor-core rate for the configuration's input
    precision (``peak`` in the configuration's file)."""
    return r.peak[r.run.config["peak"]]


def vocoder_config(r) -> dict:
    from dissc_tpu_torch.core.config import VocoderConfig

    return dataclasses.asdict(VocoderConfig.from_dict(r.run.config))


def window_spans(r, name: str) -> list:
    return r.spans.within(name, r.t0, r.t1)


def span_mean_ms(r, name: str):
    spans = window_spans(r, name)
    return sum(b - a for a, b in spans) / len(spans) / 1e6 if spans else None


def idle_share(r):
    return 100.0 * (1.0 - r.busy_s / r.window_s)


def conversion_flops(r, encoder: bool) -> tuple:
    """(all model FLOPs of the window's conversions, the generator's part),
    at true lengths: per record the rhythm model over its runs, the pitch
    model and the generator over its re-timed frames; with ``encoder``,
    HuBERT and the k-means distances over each call's samples."""
    h, p = vocoder_config(r), r.run.config["prosody"]
    total = gen = 0.0
    for w in r.result["work"]:
        samples, runs, frames = w if encoder else (None, *w)
        g = flops.generator(h, frames)
        gen += g
        total += g + flops.len_predictor(p, runs) + flops.pitch_predictor(p, frames)
        if encoder:
            total += flops.hubert(r.run.config["hubert"], samples, p["n_tokens"])
    return total, gen


def busy_within(r, name: str) -> float:
    """Seconds the device was busy inside the window's ``name`` spans."""
    return sum(tr.length_ns(tr.busy(r.kernels, a, b)) for a, b in window_spans(r, name)) / 1e9
