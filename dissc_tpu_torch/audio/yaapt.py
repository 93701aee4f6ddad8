"""YAAPT-compatible F0 tracker (``dissc_tpu.audio.yaapt``).

The same spectro-temporal tracker as the JAX package (reference call
pattern ``sr/dataset.py:27-43``: 20 ms frames at 5 ms, F0 60-400 Hz):

* host (numpy/scipy, copied): the two-sided padding, the FIR band-pass
  prefilter and the squared ("nonlinear") path, both ``np.convolve``;
* the entry point's device (torch): NCCF on both paths, the per-frame
  candidate peaks, the SHC spectral channel (``torch.fft.rfft``), the
  voicing evidence and the Viterbi emission costs;
* host (numpy float32): the Viterbi recursion, a sequential DP over
  ~200 frames a second of a 6-entry state.  It runs on the host because
  that is faster there: each step is a dozen operations on 6 to 36
  numbers, about a microsecond each in numpy, where the card would take a
  launch per operation.  The additions are float32 and in the JAX scan's
  order.

Two sums differ from the JAX package's in form, not in value: the
shifted windows' energies (NCCF) and the SHC band sums are summed
directly instead of as differences of running sums, so that the card and
the CPU agree (see :func:`_nccf`).  On the JAX package's test signals the
outputs match its tracker: the same voicing on every frame and the same
f0 up to float32 rounding (``tests/test_torch_yaapt.py``).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dissc_tpu_torch.device import DeviceLike, resolve_device

F0_MIN = 60.0
F0_MAX = 400.0
N_CANDS = 5
# NCCF cross terms are computed a chunk of lags at a time, so that no
# [frames, lags, frame_len] tensor is built whole (0.6 GB at 10 s)
_CROSS_CHUNK_ELEMS = 1 << 23


@functools.lru_cache(maxsize=4)
def _bandpass_fir(sr: int, lo: float = 50.0, hi: float = 1500.0, ntaps: int = 151):
    from scipy.signal import firwin

    return firwin(ntaps, [lo, hi], fs=sr, pass_zero=False).astype(np.float32)


def _frames(x: torch.Tensor, frame_len: int, hop: int, n_frames: int) -> torch.Tensor:
    """``[n_frames, frame_len]`` frames at ``hop``; indices past the end read
    the last sample (the JAX gather clamps)."""
    idx = (torch.arange(n_frames, device=x.device)[:, None] * hop
           + torch.arange(frame_len, device=x.device)[None, :])
    return x[idx.clamp(max=x.shape[0] - 1)]


def _nccf(x: torch.Tensor, frame_len: int, hop: int, n_frames: int,
          min_lag: int, max_lag: int) -> torch.Tensor:
    """``[F, max_lag - min_lag + 1]`` normalised cross-correlation per frame:
    ``<x_t[0:N], x_t[k:k+N]> / sqrt(|x_t[0:N]|^2 |x_t[k:k+N]|^2)``.

    The cross terms are batched float32 products of each frame's base
    window with an ``unfold`` view of its span, a chunk of lags at a time.
    The shifted windows' energies are summed directly: the JAX package takes
    them as differences of a running sum, whose rounding depends on the
    order of the scan (a parallel scan on the card, a serial one on the
    CPU) and, where a quiet window follows a loud one, swamps the window's
    own energy.  The direct sum is the same on every device to float32
    rounding and agrees with the JAX package's wherever its difference
    keeps its digits."""
    span = frame_len + max_lag
    fr = _frames(x, span, hop, n_frames)
    base = fr[:, :frame_len]
    e0 = torch.sum(base * base, dim=-1, keepdim=True)

    windows = fr.unfold(1, frame_len, 1)  # [F, span - N + 1, N], a view
    n_lags = max_lag - min_lag + 1
    cross = fr.new_empty((n_frames, n_lags))
    ek = fr.new_empty((n_frames, n_lags))
    step = max(1, _CROSS_CHUNK_ELEMS // (n_frames * frame_len))
    for l0 in range(0, n_lags, step):
        l1 = min(l0 + step, n_lags)
        w = windows[:, min_lag + l0:min_lag + l1]
        cross[:, l0:l1] = torch.bmm(w, base[:, :, None])[..., 0]
        ek[:, l0:l1] = torch.sum(w * w, dim=-1)
    denom = torch.sqrt(torch.clamp(e0 * ek, min=1e-12))
    return cross / denom


def _local_max_mask(a: torch.Tensor) -> torch.Tensor:
    inf = a.new_full((a.shape[0], 1), -float("inf"))
    left = torch.cat([inf, a[:, :-1]], dim=1)
    right = torch.cat([a[:, 1:], inf], dim=1)
    return (a >= left) & (a > right)


def _shc(x: torch.Tensor, sr: int, n_fft: int, hop: int, n_frames: int, frame_len: int,
         n_harm: int = 3, wl_hz: float = 40.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spectral Harmonics Correlation (YAAPT's spectral channel):
    ``SHC(t, f) = prod_{r=1..NH+1} sum_{f' in +-WL/2} |S(t, r f + f')|``, each
    frame scaled to a maximum of 1.  Returns (``[F, n_f0_bins]``, bin centres)."""
    frames = _frames(x, frame_len, hop, n_frames)
    win = torch.from_numpy(np.hanning(frame_len).astype(np.float32)).to(x.device)
    spec = torch.abs(torch.fft.rfft(frames * win, n=n_fft, dim=-1))
    df = sr / n_fft
    half_w = max(1, int(wl_hz / 2 / df))
    f0_bins = torch.arange(int(F0_MIN / df), int(F0_MAX / df) + 1, device=x.device)

    # the sum of the bins within +-half_w of each bin, cut at the spectrum's
    # ends; summed directly, where a difference of running sums would lose
    # a weak band's digits to the strong bins below it
    wsum = F.pad(spec, (half_w, half_w)).unfold(1, 2 * half_w + 1, 1).sum(dim=-1)
    max_bin = spec.shape[-1] - 1

    def harm_window_sum(r):
        return wsum[:, torch.clamp(f0_bins * r, 0, max_bin)]

    shc = harm_window_sum(1)
    for r in range(2, n_harm + 2):
        shc = shc * harm_window_sum(r)
    shc = shc / torch.clamp(torch.max(shc, dim=-1, keepdim=True).values, min=1e-12)
    return shc, f0_bins.float() * df


def _candidates(nccf: torch.Tensor, sr: int, min_lag: int, max_lag: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 5 best local-max NCCF peaks per frame -> (f0 candidates, merits).

    A small lag-proportional decay favours the shortest lag among the equal
    peaks of a periodic signal.  Frames with fewer than 5 peaks are filled
    with merit -1.0; those ties are ordered lowest lag first, as
    ``lax.top_k`` orders them (a stable descending sort), so the candidate
    f0s equal the JAX package's everywhere, fillers included."""
    lag_axis = torch.arange(nccf.shape[1], device=nccf.device) + min_lag
    decay = 0.08 * lag_axis / max_lag
    peaked = torch.where(_local_max_mask(nccf), nccf - decay[None, :], -1.0)
    merits, idx = torch.sort(peaked, dim=-1, descending=True, stable=True)
    merits, idx = merits[:, :N_CANDS], idx[:, :N_CANDS]
    return sr / (idx + min_lag).float(), merits


VOICING_COST = np.float32(0.35)
TRANS_W = 0.6
SPEC_W = 0.25
UV_ALPHA = 0.8   # slope of the unvoiced emission in the score
UV_T = 1.05      # voicing-score operating point


def _emissions(f0_cands: torch.Tensor, merits: torch.Tensor, energy: torch.Tensor,
               spec_f0: torch.Tensor, spec_strength: torch.Tensor,
               voicing_score: torch.Tensor) -> torch.Tensor:
    """``[F, K+1]`` emission costs: voiced ``1 - merit`` (1e3 for a filler)
    plus an octave-distance penalty to a confident, self-validated SHC
    estimate; unvoiced keyed to the voicing score and frame energy."""
    energy_db = 10.0 * torch.log10(energy + 1e-10)
    silent = energy_db < (torch.max(energy_db) - 35.0)

    voiced_cost = torch.where(merits > 0, 1.0 - merits, 1e3)
    spec_dist = torch.abs(torch.log2(torch.clamp(f0_cands, min=1.0))
                          - torch.log2(torch.clamp(spec_f0, min=1.0))[:, None])
    spec_valid = (torch.min(spec_dist, dim=-1).values < 0.08) & (spec_strength > 0.2)
    spec_gate = spec_valid.float() * spec_strength
    voiced_cost = voiced_cost + SPEC_W * spec_gate[:, None] * torch.clamp(spec_dist, max=2.0)

    score = voicing_score + 0.15 * spec_gate
    unvoiced_cost = torch.where(silent, -0.5, UV_ALPHA * (score - UV_T))
    return torch.cat([voiced_cost, unvoiced_cost[:, None]], dim=-1)


def _viterbi_states(emis: np.ndarray, log_f0: np.ndarray) -> np.ndarray:
    """The Viterbi recursion and backtrack on the host, numpy float32.

    ``emis`` ``[F, K+1]`` (state K unvoiced), ``log_f0`` ``[F, K]``.
    Voiced -> voiced costs ``TRANS_W`` times the octave distance, a voicing
    flip ``VOICING_COST``.  Ties go to the voiced state, then the lowest
    index, as in the JAX scan.  As the JAX backtrack emits them, position
    t < F-1 holds the best path's state at frame t+1 and position F-1 the
    last frame's."""
    F, K1 = emis.shape
    K = K1 - 1
    trans = np.float32(TRANS_W) * np.abs(log_f0[1:, None, :] - log_f0[:-1, :, None])
    backs = np.empty((max(F - 1, 0), K1), np.int64)
    cost = emis[0].copy()
    for t in range(1, F):
        vv = cost[:K, None] + trans[t - 1]
        min_vv, arg_vv = vv.min(axis=0), vv.argmin(axis=0)
        uv = cost[K] + VOICING_COST
        to_voiced = min_vv <= uv
        backs[t - 1, :K] = np.where(to_voiced, arg_vv, K)
        best_v = int(cost[:K].argmin())
        vu = cost[best_v] + VOICING_COST
        if vu <= cost[K]:
            to_unvoiced, backs[t - 1, K] = vu, best_v
        else:
            to_unvoiced, backs[t - 1, K] = cost[K], K
        cost = np.append(np.where(to_voiced, min_vv, uv), np.float32(to_unvoiced)) + emis[t]
    states = np.empty(F, np.int64)
    state = int(cost.argmin())
    states[F - 1] = state
    for t in range(F - 2, -1, -1):
        states[t] = state
        state = int(backs[t, state])
    return states


def _viterbi(f0_cands: torch.Tensor, merits: torch.Tensor, energy: torch.Tensor,
             spec_f0: torch.Tensor, spec_strength: torch.Tensor,
             voicing_score: torch.Tensor) -> np.ndarray:
    """DP over [K voiced candidates + 1 unvoiced state] per frame -> the best
    path's f0 on the host (0 = unvoiced)."""
    emis = _emissions(f0_cands, merits, energy, spec_f0, spec_strength, voicing_score)
    log_f0 = torch.log2(torch.clamp(f0_cands, min=1.0))
    f0_cands = f0_cands.cpu().numpy()
    states = _viterbi_states(emis.cpu().numpy(), log_f0.cpu().numpy())
    f0_ext = np.concatenate([f0_cands, np.zeros((f0_cands.shape[0], 1), np.float32)], axis=-1)
    return np.take_along_axis(f0_ext, states[:, None], axis=-1)[:, 0]


def yaapt_f0(audio: np.ndarray, sr: int = 16000, interp: bool = False,
             frame_length_ms: float = 20.0, frame_space_ms: float = 5.0,
             tda_frame_length_ms: float = 25.0, device: DeviceLike = None) -> np.ndarray:
    """Track F0 of a mono waveform; one value per 5 ms frame (0 = unvoiced,
    or interpolated through unvoiced stretches when ``interp``).

    The input is padded by frame_length/2 on both sides, as the reference
    calls pYAAPT.  ``device=None`` runs the tensor stages on the CUDA card
    and raises without one."""
    dev = resolve_device(device)
    audio = np.asarray(audio, np.float32).reshape(-1)
    frame_len = int(frame_length_ms / 1000 * sr)
    hop = int(frame_space_ms / 1000 * sr)
    to_pad = frame_len // 2
    x = np.pad(audio, (to_pad, to_pad))

    fir = _bandpass_fir(sr)
    xf = np.convolve(x, fir, mode="same").astype(np.float32)
    sq = x * x
    xnl = np.convolve(sq - sq.mean(), fir, mode="same").astype(np.float32)

    min_lag = int(sr / F0_MAX)
    max_lag = int(np.ceil(sr / F0_MIN))
    span = frame_len + max_lag
    n_frames = max(1, 1 + (len(x) - span) // hop)

    xf_t, xnl_t, x_t = (torch.from_numpy(a).to(dev) for a in (xf, xnl, x))
    nccf_a = _nccf(xf_t, frame_len, hop, n_frames, min_lag, max_lag)
    nccf_b = _nccf(xnl_t, frame_len, hop, n_frames, min_lag, max_lag)
    nccf = torch.maximum(nccf_a, 0.85 * nccf_b)

    f0_cands, merits = _candidates(nccf, sr, min_lag, max_lag)
    frames = _frames(xf_t, frame_len, hop, n_frames)
    energy = torch.sum(frames * frames, dim=-1)

    # voicing evidence: original-path NCCF merit plus the in-band to
    # full-band energy ratio
    merit_orig = torch.max(nccf_a, dim=-1).values
    frames_raw = _frames(x_t, frame_len, hop, n_frames)
    e_full = torch.sum(frames_raw * frames_raw, dim=-1)
    band_ratio = energy / torch.clamp(e_full, min=1e-12)
    voicing_score = merit_orig + 0.6 * torch.clamp(band_ratio, 0.0, 1.2)

    tda_len = int(tda_frame_length_ms / 1000 * sr)
    if len(x) >= tda_len + (n_frames - 1) * hop:
        shc_a, f0_axis = _shc(xf_t, sr, 2048, hop, n_frames, tda_len)
        shc_b, _ = _shc(xnl_t, sr, 2048, hop, n_frames, tda_len)
        shc = torch.maximum(shc_a, shc_b)
        spec_idx = torch.argmax(shc, dim=-1)
        spec_f0 = f0_axis[spec_idx]
        # boundary-bin argmaxes are window-mainlobe artifacts, not pitch
        interior = (spec_idx > 1) & (spec_idx < shc.shape[-1] - 2)
        peak = shc[torch.arange(n_frames, device=dev), spec_idx]
        spec_strength = torch.where(
            interior,
            torch.clamp(peak / torch.clamp(torch.mean(shc, dim=-1), min=1e-9) / 20.0, 0.0, 1.0),
            0.0)
    else:
        spec_f0 = torch.zeros(n_frames, device=dev)
        spec_strength = torch.zeros(n_frames, device=dev)

    f0 = _viterbi(f0_cands, merits, energy, spec_f0, spec_strength, voicing_score)

    # frame count the reference observes: len(audio)//hop
    target = max(1, int(round(len(audio) / hop)))
    if len(f0) < target:
        f0 = np.pad(f0, (0, target - len(f0)))
    f0 = f0[:target]
    if interp:
        f0 = interp_unvoiced(f0)
    return f0


def interp_unvoiced(f0: np.ndarray) -> np.ndarray:
    """Linear interpolation through unvoiced (0) regions, edges held —
    pYAAPT's ``samp_interp`` behaviour."""
    f0 = np.asarray(f0, np.float64).copy()
    voiced = f0 > 0
    if not voiced.any():
        return f0
    idx = np.arange(len(f0))
    f0[~voiced] = np.interp(idx[~voiced], idx[voiced], f0[voiced])
    return f0


def yaapt_f0_batch(audio: np.ndarray, sr: int = 16000, interp: bool = False,
                   device: DeviceLike = None) -> np.ndarray:
    """[B, T] -> [B, 1, F] like the reference's ``get_yaapt_f0`` vstack."""
    outs = [yaapt_f0(a, sr, interp, device=device)[None, None, :] for a in np.atleast_2d(audio)]
    return np.vstack(outs)
