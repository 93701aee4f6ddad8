"""What the conversion drivers share: the program's conversion pipeline
built from a configuration and the benchmark's seeded weights, and the
reference's judgement of what a conversion produced.

The judgement of one converted record (its input units, its target, the
program's re-timed units and f0, and its waveform), by the plain
reference on the same weights:

* rhythm: the reference's re-timed units must equal the program's, except
  where the reference's rounding came within ``TIE`` frames of a
  threshold (then either side of the tie is right);
* pitch: the reference's pitch predictor on the program's units; the
  widest gap of the program's f0 against it, over the frames whose
  voicing logit is not within ``TIE`` of 0, as a share of the reference's
  voiced f0's root mean square;
* waveform: the reference's generator on the program's units and f0, with
  the engine's bucket padding (the last unit repeated, f0 zero), cut to
  the true length; the relative L2 gap of the program's waveform (a
  waveform whose length is not 320 samples a re-timed unit counts among
  the run's failed answers, and here in ``length_mismatch``).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import traffic as tf
from portbench import weights as wt
from portbench.reference import prosody as rp
from portbench.reference import vocoder as rv
from portbench.reference.ops import Ops

TIE = 1e-3
FRAME_BUCKETS = (64, 128, 256, 512, 1024, 2048)


@contextlib.contextmanager
def reference_time(run):
    """Adds the seconds of the reference's work inside to ``run.reference_s``
    (the card synchronised at both ends), which ``setup_s`` leaves out."""
    sync = torch.cuda.synchronize if run.device.type == "cuda" else (lambda d: None)
    sync(run.device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sync(run.device)
        run.reference_s += time.perf_counter() - t0


def model_weights(run, calibration: List[tuple]) -> Dict[str, dict]:
    """The benchmark's weights of every model of the conversion, by seed.

    The rhythm model's last bias is then set so that, over the
    ``calibration`` records (``(units, speaker index)``, drawn from the
    cell's own traffic), its mean duration equals their mean run length:
    with random weights converted lengths then stay near the source
    lengths, as a trained model's do, whatever the seed."""
    c, p = run.config, run.config["prosody"]
    seed = wt.sub_seed(run.seed, "weights")
    n_spk, n_tok = p["n_speakers"], p["n_tokens"]
    w = {
        "gen": wt.materialize(rv.generator_spec(c), seed, run.device),
        "len": wt.materialize(rp.len_predictor_spec(n_tok, n_spk, p["emb_size"], p["hidden"]),
                              seed + 1, run.device),
        "pitch": wt.materialize(rp.pitch_predictor_spec(n_tok, n_spk, p["emb_size"],
                                                        p["hidden"]), seed + 2, run.device),
    }
    mean, std = p["len_norm_stats"]
    raw, counts = [], []
    with reference_time(run), torch.no_grad(), Ops("float32").numerics():
        for units, sid in calibration:
            vals, n = rp.dedup(units)
            runs = torch.tensor(vals, device=run.device)
            raw.append(rp.len_predictor(Ops("float32"), w["len"], runs, sid, (0.0, 1.0), n_tok))
            counts += n
    target = (float(np.mean(counts)) - mean) / std
    w["len"]["cnn2.bias"] += target - float(torch.cat(raw).mean())
    return w


def build_pipeline(run, w: dict, encoder=None):
    """The program's ``ConversionPipeline`` over ``w``'s weights: the
    vocoder engine, the prosody converter (rhythm and "new" pitch models)
    and, for waveform input, ``encoder``."""
    from dissc_tpu_torch.core.config import VocoderConfig
    from dissc_tpu_torch.infer.prosody import ProsodyConverter
    from dissc_tpu_torch.infer.vocoder import VocoderEngine
    from dissc_tpu_torch.models.prosody import LenPredictor
    from dissc_tpu_torch.pipeline import ConversionPipeline
    from dissc_tpu_torch.train.prosody_trainer import build_pitch_model

    p = run.config["prosody"]
    h = VocoderConfig.from_dict(run.config)
    engine = VocoderEngine(h, w["gen"], device=run.device)
    len_model = LenPredictor(n_tokens=p["n_tokens"], n_speakers=p["n_speakers"])
    len_model.load_state_dict(w["len"])
    pitch_model = build_pitch_model(p["pitch_model"], p["n_tokens"], p["n_speakers"])
    pitch_model.load_state_dict(w["pitch"])
    conv = ProsodyConverter(n_tokens=p["n_tokens"], device=run.device)
    conv.set_models(len_model=len_model, len_norm_stats=tuple(p["len_norm_stats"]),
                    pitch_model=pitch_model)
    names = tf.speaker_names(p["n_speakers"])
    return ConversionPipeline(engine, conv, {n: i for i, n in enumerate(names)},
                              encoder=encoder, norm_pitch=True)


def warm_shapes(run, pipe, max_frames: int, batch_size: int) -> None:
    """Run every batch shape the traffic can reach once: each prosody bucket
    up to the one of ``max_frames`` units, and each vocoder bucket up to
    the one of its re-timed output's cap, each at 1 to ``batch_size`` rows
    (cuDNN picks and plans its kernels at a shape's first call)."""
    p = run.config["prosody"]
    top = rp.in_bucket(max_frames, p["buckets"])
    names = tf.speaker_names(p["n_speakers"])
    for cap in [b for b in p["buckets"] if b <= top]:
        for rows in range(1, batch_size + 1):
            recs = [{"units": [i % p["n_tokens"] for i in range(cap)], "audio": f"{names[0]}_w.wav"}
                    for _ in range(rows)]
            pipe.prosody.convert_records(recs, pipe.spk_dict, target_speaker=names[0],
                                         norm_pitch=True, batch_size=batch_size)
    out_top = next(b for b in FRAME_BUCKETS if int(top * p["expand_factor"]) <= b
                   or b == FRAME_BUCKETS[-1])
    for cap in [b for b in FRAME_BUCKETS if b <= out_top]:
        for rows in range(1, batch_size + 1):
            code = np.zeros((rows, cap), np.int64)
            pipe.vocoder.synthesize_batch(code, np.zeros((rows, cap, 1), np.float32),
                                          np.zeros((rows, 1), np.int64))


class Reservoir:
    """A uniform sample of ``k`` items of a stream, drawn from a seed."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.n, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.n += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.n))
            if j < self.k:
                self.items[j] = item


def runs_of(units) -> int:
    return len(rp.dedup(units)[0]) if len(units) else 0


def reference_waves(run, ops: Ops, w: dict, items: List[dict]) -> List[np.ndarray]:
    """The reference generator's waveform of each item's ``out_units`` and
    ``out_f0`` for its target, with the engine's bucket padding (the last
    unit repeated, f0 zero), cut to the true length; 8 a batch."""
    c = run.config
    spk = speaker_index(run)
    by_bucket: Dict[int, list] = {}
    for k, it in enumerate(items):
        n = len(it["out_units"])
        by_bucket.setdefault(next(b for b in FRAME_BUCKETS if n <= b), []).append((k, it, n))
    out: List[np.ndarray] = [None] * len(items)
    with torch.no_grad(), ops.numerics():
        for cap, group in by_bucket.items():
            for s in range(0, len(group), 8):
                chunk = group[s:s + 8]
                code = torch.zeros((len(chunk), cap), dtype=torch.long, device=run.device)
                f0 = torch.zeros((len(chunk), cap, 1), device=run.device)
                for j, (_, it, n) in enumerate(chunk):
                    code[j, :n] = torch.tensor(it["out_units"], device=run.device)
                    code[j, n:] = it["out_units"][-1]
                    f0[j, :n, 0] = torch.tensor(it["out_f0"], device=run.device)
                spkr = torch.tensor([[spk[it["target"]]] for _, it, _ in chunk], device=run.device)
                y = rv.generator(ops, w["gen"], c, code, f0, spkr).double().cpu().numpy()
                for j, (k, _, n) in enumerate(chunk):
                    out[k] = y[j, :n * c["code_hop_size"]]
    return out


def speaker_index(run) -> Dict[str, int]:
    return {n: i for i, n in enumerate(tf.speaker_names(run.config["prosody"]["n_speakers"]))}


def reference_rhythm(run, ops: Ops, w: dict, units, target: str) -> tuple:
    """(re-timed units, the near-tie margin of their rounding, whether the
    output cap cut them)."""
    p = run.config["prosody"]
    with torch.no_grad(), ops.numerics():
        return rp.convert_rhythm(ops, w["len"], units, speaker_index(run)[target],
                                 tuple(p["len_norm_stats"]), p["n_tokens"], p["buckets"],
                                 p["expand_factor"])


def reference_pitch(run, ops: Ops, w: dict, units, target: str) -> tuple:
    """(voicing logits, whitened f0) of re-timed ``units``, on the host."""
    with torch.no_grad(), ops.numerics():
        cls, reg = rp.pitch_predictor(ops, w["pitch"], torch.tensor(units, device=run.device),
                                      speaker_index(run)[target], run.config["prosody"]["n_tokens"])
    return cls.double().cpu().numpy(), reg.double().cpu().numpy()


def judge(run, w: dict, items: List[dict], ops: Ops) -> Dict[str, float]:
    """The readings over ``items`` (dicts of ``units``, ``target``,
    ``out_units``, ``out_f0``, ``wav``); see the module doc."""
    mismatch, pitch_gap, wave_gap, ties, bad_len = 0, 0.0, 0.0, 0, 0
    for it in items:
        out, margin, _ = reference_rhythm(run, ops, w, it["units"], it["target"])
        if out != list(it["out_units"]):
            if margin < TIE:
                ties += 1
            else:
                mismatch += 1
        cls, reg = reference_pitch(run, ops, w, it["out_units"], it["target"])
        f0_ref = (cls > 0) * reg
        sure = np.abs(cls) >= TIE
        voiced = f0_ref != 0
        scale = float(np.sqrt(np.mean(f0_ref[voiced] ** 2))) if voiced.any() else 1.0
        if sure.any():
            gap = np.abs(np.asarray(it["out_f0"], np.float64) - f0_ref)[sure]
            pitch_gap = max(pitch_gap, float(np.max(gap)) / scale)
    for it, y_ref in zip(items, reference_waves(run, ops, w, items)):
        y_prog = np.asarray(it["wav"], np.float64)
        if y_prog.shape != y_ref.shape:
            bad_len += 1
            continue
        wave_gap = max(wave_gap, float(np.linalg.norm(y_prog - y_ref)
                                       / max(np.linalg.norm(y_ref), 1e-12)))
    return {"rhythm_mismatch": float(mismatch), "length_mismatch": float(bad_len),
            "pitch_gap": pitch_gap, "wave_gap": wave_gap, "rhythm_ties": float(ties)}


def reference_items(run, ops: Ops, w: dict, records: List[tuple]) -> List[dict]:
    """The reference in the program's place: for each ``(units, target)``
    the re-timed units, f0 and waveform computed in ``ops``' precision,
    as the items :func:`judge` reads (and ``cut``: whether the output cap
    cut the re-timed units)."""
    items = []
    for units, target in records:
        out, _, cut = reference_rhythm(run, ops, w, units, target)
        cls, reg = reference_pitch(run, ops, w, out, target)
        items.append({"units": units, "target": target, "out_units": out,
                      "out_f0": ((cls > 0) * reg).tolist(), "cut": cut})
    for it, y in zip(items, reference_waves(run, ops, w, items)):
        it["wav"] = y.astype(np.float32)
    return items
