"""Plain reference of the prosody conversion: run-length dedup, the rhythm
(duration) predictor, carryover rounding, re-timing and the "new" pitch
predictor, in eval mode.

Written from the DISSC reference (``model/len_predictor.py``,
``model/pitch_predictor.py``, ``infer.py:32,158-172``) and frozen here:
functional float32 PyTorch on one record at a time, at its own length, so
no mask or bucket is needed (the zero padding of a 'same' convolution at
the record's ends is what the program's length masks give).
"""
from __future__ import annotations

from itertools import groupby
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.ops import Ops

Params = Dict[str, torch.Tensor]
LEAKY = 0.01
PE_MAX_LEN = 850
BN_EPS = 1e-5
SPEAKER_STD = 0.25  # a target moves the mean duration by some 10-20 %, not by half
LEN_CONVS = ["cnn1"] + [f"cnn1{i}" for i in range(1, 7)]
PITCH_TRUNK = ["cnn1"] + [f"cnn1{i}" for i in range(1, 8)]


def _conv_spec(spec: dict, name: str, cin: int, cout: int, k: int) -> None:
    """He-normal weights (their scale kept through leaky-ReLUs), zero bias."""
    spec[f"{name}.weight"] = ((cout, cin, k), ("normal", (2.0 / (cin * k)) ** 0.5))
    spec[f"{name}.bias"] = ((cout,), ("const", 0.0))


def _bn_spec(spec: dict, name: str, ch: int) -> None:
    for key, value in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                       ("running_var", 1.0)):
        spec[f"{name}.{key}"] = ((ch,), ("const", value))
    spec[f"{name}.num_batches_tracked"] = ((), ("const", 0))


def len_predictor_spec(n_tokens: int, n_speakers: int, emb: int, hidden: int) -> dict:
    spec: dict = {"token_emb.weight": ((n_tokens + 1, emb), ("normal", 1.0)),
                  "spk_emb.weight": ((n_speakers, emb), ("normal", SPEAKER_STD))}
    for i, name in enumerate(LEN_CONVS):
        _conv_spec(spec, name, 2 * emb if i == 0 else hidden, hidden, 3)
        _bn_spec(spec, "bn" + name[3:], hidden)
    _conv_spec(spec, "cnn2", hidden, 1, 3)
    return spec


def pitch_predictor_spec(n_tokens: int, n_speakers: int, emb: int, hidden: int) -> dict:
    spec: dict = {"token_emb.weight": ((n_tokens + 1, emb), ("normal", 1.0)),
                  "spk_emb.weight": ((n_speakers + 1, emb), ("normal", 1.0))}
    for i, name in enumerate(PITCH_TRUNK):
        _conv_spec(spec, name, 2 * emb if i == 0 else hidden, hidden, 3)
    _conv_spec(spec, "cnn2", hidden, hidden, 3)
    _bn_spec(spec, "bn2", hidden)
    for head in ("class", "reg"):
        _conv_spec(spec, f"cnn_{head}1", hidden, hidden, 3)
        _conv_spec(spec, f"cnn_{head}2", hidden, 1, 1)
    return spec


def _embed(p: Params, seq: torch.Tensor, spk: torch.Tensor, n_tokens: int) -> Tuple:
    tok = F.embedding(seq, p["token_emb.weight"]) * (seq != n_tokens)[..., None]
    return tok, F.embedding(spk, p["spk_emb.weight"]).expand(-1, seq.shape[1], -1)


def _conv(ops: Ops, p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    w = p[f"{name}.weight"]
    return ops.conv1d(x, w, p[f"{name}.bias"], padding=(w.shape[-1] - 1) // 2)


def _bn(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    scale = p[f"{name}.weight"] / torch.sqrt(p[f"{name}.running_var"] + BN_EPS)
    return (x - p[f"{name}.running_mean"][:, None]) * scale[:, None] + p[f"{name}.bias"][:, None]


def len_predictor(ops: Ops, p: Params, runs: torch.Tensor, spk: int, stats: Tuple[float, float],
                  n_tokens: int) -> torch.Tensor:
    """``[n]`` run values -> ``[n]`` float durations, de-normalised by
    ``stats`` (mean, std)."""
    seq = runs[None]
    tok, s = _embed(p, seq, torch.tensor([[spk]], device=seq.device), n_tokens)
    x = torch.cat([tok, s], dim=-1).transpose(1, 2)
    for name in LEN_CONVS:
        x = F.leaky_relu(_bn(p, "bn" + name[3:], _conv(ops, p, name, x)), LEAKY)
    return _conv(ops, p, "cnn2", x)[0, 0] * stats[1] + stats[0]


def pitch_predictor(ops: Ops, p: Params, units: torch.Tensor, spk: int, n_tokens: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[L]`` units -> (voicing logits ``[L]``, whitened f0 ``[L]``)."""
    seq = units[None]
    tok, s = _embed(p, seq, torch.tensor([[spk]], device=seq.device), n_tokens)
    t, d = seq.shape[1], s.shape[-1]
    pos = torch.arange(t, device=seq.device).clamp(max=PE_MAX_LEN - 1).float() / (PE_MAX_LEN - 1)
    pe = torch.cat([pos[:, None].expand(t, d // 2), (1.0 - pos)[:, None].expand(t, d - d // 2)],
                   dim=-1)
    x = torch.cat([tok, s + pe[None]], dim=-1).transpose(1, 2)
    for name in PITCH_TRUNK:
        x = F.leaky_relu(_conv(ops, p, name, x), LEAKY)
    x = F.leaky_relu(_bn(p, "bn2", _conv(ops, p, "cnn2", x)), LEAKY)
    heads = [_conv(ops, p, f"cnn_{h}2", F.leaky_relu(_conv(ops, p, f"cnn_{h}1", x), LEAKY))
             for h in ("class", "reg")]
    return heads[0][0, 0], heads[1][0, 0]


def dedup(seq: Sequence[int]) -> Tuple[List[int], List[int]]:
    vals, counts = [], []
    for k, g in groupby(seq):
        vals.append(int(k))
        counts.append(sum(1 for _ in g))
    return vals, counts


def carryover(lens: np.ndarray) -> Tuple[np.ndarray, float]:
    """Carryover rounding of one record's float32 durations
    (``infer.py:158-172``): each ``round(max(len, 1))`` (half to even) and
    its residual on a running total that emits +-1 whenever it crosses
    +-1.  Returns (int durations, the smallest distance of any rounding
    decision from its threshold: how near a tie the record came)."""
    lens = np.asarray(lens, np.float32)
    clamped = np.maximum(lens, np.float32(1.0))
    base = np.round(clamped)
    margin = float(np.min(np.abs(np.abs(clamped - np.floor(clamped)) - 0.5))) if len(lens) else 1.0
    resid = lens - base
    total = np.float32(0.0)
    out = base.astype(np.int64)
    for c in range(len(lens)):
        total = np.float32(total + resid[c])
        margin = min(margin, abs(abs(float(total)) - 1.0))
        corr = 1 if total >= 1.0 else (-1 if total <= -1.0 else 0)
        total = np.float32(total - np.float32(corr))
        out[c] += corr
    return out, margin


def in_bucket(n: int, buckets: Sequence[int]) -> int:
    return next((b for b in buckets if n <= b), buckets[-1])


def convert_rhythm(ops: Ops, p: Params, units: Sequence[int], spk: int,
                   stats: Tuple[float, float], n_tokens: int, buckets: Sequence[int],
                   expand: float) -> Tuple[List[int], float, bool]:
    """A record's units -> (re-timed units, cut at ``expand`` times its
    input bucket; the near-tie margin of its rounding; whether the cut
    took any)."""
    units = [u for u in units if u != n_tokens]
    cap = in_bucket(len(units), buckets)
    vals, _ = dedup(units[:cap])
    runs = torch.tensor(vals, device=p["token_emb.weight"].device)
    lens = len_predictor(ops, p, runs, spk, stats, n_tokens)
    durs, margin = carryover(lens.cpu().numpy())
    out = np.repeat(np.asarray(vals), np.maximum(durs, 0))
    return out[: int(cap * expand)].tolist(), margin, len(out) > int(cap * expand)
