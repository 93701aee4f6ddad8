"""The general traffic generator: every traffic mix is a dict of parameters
in a workload file, read here.

The sizes of a mix are the same for every seed: lengths are the quantiles
of the mix's log-normal (``(i + 0.5) / n`` for ``n`` lengths), clipped; a
seed draws their order and every content (units, pitch, waveforms,
speakers).  So runs of different seeds do the same amount of work.

Kinds:

* ``corpus``: a vocoder training corpus written into a directory, as the
  data-preparation CLIs leave one: 16 kHz int16 wavs of voiced harmonics
  between stretches of silence, and a JSONL manifest whose lines carry
  ``units`` (one per 320 samples, held in runs) and per-unit ``f0``
  (0 where unvoiced).  ``lines`` manifest lines cycle over ``files`` wavs;
  each draw of a line crops anew.
* ``unit_jobs``: jobs of unit records as ``cli.encode`` writes them
  (``units``, ``f0``, ``audio`` named by the source speaker), one target
  speaker a job.
* ``wav_calls``: 16 kHz waveforms of voiced harmonics between silences
  for single conversion calls, a target speaker each.
"""
from __future__ import annotations

import json
import os
import wave
from statistics import NormalDist
from typing import Dict, List

import numpy as np

SR = 16000
HOP = 320
N_UNITS = 100


def speaker_names(n: int) -> List[str]:
    """VCTK-style speaker names ``p225`` ... for ``n`` speakers."""
    return [f"p{225 + i}" for i in range(n)]


def length_pool(t: dict, n: int) -> np.ndarray:
    """``n`` lengths in seconds: the log-normal's quantiles, clipped."""
    q = (np.arange(n) + 0.5) / n
    z = np.array([NormalDist().inv_cdf(float(x)) for x in q])
    s = np.exp(np.log(t["median_s"]) + t["sigma"] * z)
    return np.clip(s, *t["clip_s"])


def unit_runs(rng: np.random.Generator, frames: int, run_frames) -> np.ndarray:
    """``frames`` units held in runs of ``run_frames`` (lo, hi) frames, no
    two neighbouring runs alike."""
    out, last = [], -1
    while len(out) < frames:
        u = int(rng.integers(0, N_UNITS - 1))
        u += u >= last >= 0
        out.extend([u] * int(rng.integers(run_frames[0], run_frames[1] + 1)))
        last = u
    return np.asarray(out[:frames], np.int64)


def voicing(rng: np.random.Generator, frames: int, t: dict) -> np.ndarray:
    """Per-frame voiced flags: voiced and unvoiced stretches alternating."""
    flags = np.zeros(frames, bool)
    i, voiced = 0, bool(rng.integers(0, 2))
    while i < frames:
        lo, hi = t["voiced_frames"] if voiced else t["unvoiced_frames"]
        n = int(rng.integers(lo, hi + 1))
        flags[i:i + n] = voiced
        i, voiced = i + n, not voiced
    return flags


def contour(rng: np.random.Generator, flags: np.ndarray, mean_hz: float) -> np.ndarray:
    """A slowly moving f0 around ``mean_hz`` on the voiced frames, 0 elsewhere."""
    n = len(flags)
    drift = np.sin(2 * np.pi * (np.arange(n) / 50.0) * rng.uniform(0.3, 1.0) + rng.uniform(0, 6))
    return np.where(flags, mean_hz * (1 + 0.08 * drift), 0.0).round(2)


def waveform(rng: np.random.Generator, f0_frames: np.ndarray) -> np.ndarray:
    """Two harmonics following the per-frame f0 (silence where it is 0),
    with a little noise: float32 in [-1, 1]."""
    f0 = np.repeat(f0_frames, HOP)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    x = (f0 > 0) * (0.4 * np.sin(phase) + 0.2 * np.sin(2 * phase))
    return (x + 0.02 * rng.standard_normal(len(x))).astype(np.float32)


def write_wav(path: str, x: np.ndarray) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.round(np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())


def write_corpus(t: dict, rng: np.random.Generator, root: str) -> str:
    """Write a ``corpus`` mix into ``root``; returns the manifest's path."""
    names = speaker_names(t["speakers"])
    spk_hz = rng.uniform(*t["f0_hz"], len(names))
    lengths = rng.permutation(np.linspace(*t["file_s"], t["files"]))
    lines = []
    for i, sec in enumerate(lengths):
        s = i % len(names)
        frames = int(sec * SR) // HOP
        f0 = contour(rng, voicing(rng, frames, t), spk_hz[s])
        name = f"{names[s]}_{i:04d}.wav"
        write_wav(os.path.join(root, name), waveform(rng, f0))
        lines.append({"audio": name, "units": unit_runs(rng, frames, t["run_frames"]).tolist(),
                      "f0": f0.tolist()})
    path = os.path.join(root, "train.jsonl")
    with open(path, "w") as fh:
        for k in range(t["lines"]):
            fh.write(json.dumps(lines[k % len(lines)]) + "\n")
    return path


def unit_jobs(t: dict, rng: np.random.Generator) -> List[Dict]:
    """``jobs`` jobs of ``records`` unit records each, every job with the
    same lengths in another order."""
    names = speaker_names(t["speakers"])
    spk_hz = rng.uniform(*t["f0_hz"], len(names))
    pool = length_pool(t, t["records"])
    jobs = []
    for j in range(t["jobs"]):
        recs = []
        for k, sec in enumerate(rng.permutation(pool)):
            s = int(rng.integers(0, len(names)))
            frames = int(round(sec * SR / HOP))
            flags = voicing(rng, frames, t)
            recs.append({"units": unit_runs(rng, frames, t["run_frames"]).tolist(),
                         "f0": contour(rng, flags, spk_hz[s]).tolist(),
                         "audio": f"{names[s]}_{j:03d}_{k:03d}.wav"})
        jobs.append({"records": recs, "target": names[int(rng.integers(0, len(names)))]})
    return jobs


def wav_calls(t: dict, rng: np.random.Generator) -> List[Dict]:
    """``calls`` waveforms (the mix's lengths in a seeded order), a source
    and a target speaker each."""
    names = speaker_names(t["speakers"])
    calls = []
    for sec in rng.permutation(length_pool(t, t["calls"])):
        frames = int(round(sec * SR / HOP))
        f0 = contour(rng, voicing(rng, frames, t), rng.uniform(*t["f0_hz"]))
        calls.append({"wav": waveform(rng, f0),
                      "source": names[int(rng.integers(0, len(names)))],
                      "target": names[int(rng.integers(0, len(names)))]})
    return calls
