"""DTW boundary transfer when MFA is absent (``dissc_tpu.eval.align``).

The reference computes word/phone duration and FFE metrics from MFA
TextGrids and falls back to uniform interval grids when alignment fails
(``eval.py:106-125``).  Without the ``mfa`` binary that fallback is the
only path, and uniform grids carry no timing.  This opt-in
(``--dtw_align`` on ``cli.eval`` / ``cli.convert_eval``) aligns the
synthesised audio to the reference recording by dynamic time warping over
log-mel frames and maps the reference TextGrid's boundaries through the
monotone warping path.

The log-mel runs on the device with the plain chain
(:func:`~dissc_tpu_torch.audio.mel.mel_spectrogram`; hop 320 does not
divide n_fft 1024, so no fused kernel takes it, in either package).  The
DP, the warp and the TextGrid text run on the host in numpy, copied from
the JAX package: the text is identical.
"""
from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import Callable, List

import numpy as np
import torch

from dissc_tpu_torch.audio.mel import mel_spectrogram
from dissc_tpu_torch.core.wav import read_wav
from dissc_tpu_torch.device import DeviceLike, resolve_device
from dissc_tpu_torch.eval.textgrid import Interval, TextGrid


def mel_features(wav: np.ndarray, sr: int = 16000, hop: int = 320,
                 device: DeviceLike = None) -> np.ndarray:
    """[T] waveform -> [F, 80] log-mel at sr/hop Hz (default 50 Hz)."""
    dev = resolve_device(device)
    with torch.inference_mode():
        m = mel_spectrogram(torch.as_tensor(np.asarray(wav, np.float32)[None], device=dev),
                            1024, 80, sr, hop, 1024, 0, sr / 2)
    return m[0].cpu().numpy().T


def dtw_path(dist: np.ndarray):
    """Full DTW over a [T1, T2] cost matrix; returns (is, js) path arrays.

    Moves: down / right / diagonal.  T is ~50 Hz frame counts (a few
    hundred per utterance), so the O(T^2) DP runs host-side in numpy.
    """
    t1, t2 = dist.shape
    acc = np.full((t1 + 1, t2 + 1), np.inf, np.float64)
    acc[0, 0] = 0.0
    move = np.zeros((t1, t2), np.int8)  # 0=diag 1=up(ref) 2=left(syn)
    for i in range(1, t1 + 1):
        prev, cur = acc[i - 1], acc[i]
        d = dist[i - 1]
        for j in range(1, t2 + 1):
            c = min(prev[j - 1], prev[j], cur[j - 1])
            cur[j] = d[j - 1] + c
            move[i - 1, j - 1] = (0 if c == prev[j - 1]
                                  else (1 if c == prev[j] else 2))
    i, j = t1 - 1, t2 - 1
    pis, pjs = [i], [j]
    while i > 0 or j > 0:
        m = move[i, j]
        if m == 0 and i > 0 and j > 0:
            i, j = i - 1, j - 1
        elif (m == 1 and i > 0) or j == 0:
            i -= 1
        else:
            j -= 1
        pis.append(i)
        pjs.append(j)
    return np.asarray(pis[::-1]), np.asarray(pjs[::-1])


def warp_function(ref_wav: np.ndarray, syn_wav: np.ndarray, sr: int = 16000,
                  hop: int = 320, device: DeviceLike = None) -> Callable[[np.ndarray], np.ndarray]:
    """Monotone mapping from reference time (s) to synthetic time (s).

    Cosine distance between per-frame log-mel vectors; the path is
    reduced to one synthetic frame per reference frame (mean of paired
    frames) and boundaries interpolate linearly between frame centres.
    """
    fr = mel_features(ref_wav, sr, hop, device)
    fs = mel_features(syn_wav, sr, hop, device)

    def unit(x):
        return x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-8)

    dist = 1.0 - unit(fr) @ unit(fs).T
    pis, pjs = dtw_path(dist)
    syn_of_ref = np.full(fr.shape[0], np.nan)
    for i in range(fr.shape[0]):
        js = pjs[pis == i]
        if js.size:
            syn_of_ref[i] = js.mean()
    # fill any gaps (none expected: the path visits every i) + monotone
    idx = np.arange(fr.shape[0], dtype=np.float64)
    ok = ~np.isnan(syn_of_ref)
    syn_of_ref = np.interp(idx, idx[ok], syn_of_ref[ok])
    syn_of_ref = np.maximum.accumulate(syn_of_ref)
    spf = hop / sr  # seconds per frame

    def warp(t):
        return np.interp(np.asarray(t, np.float64) / spf, idx, syn_of_ref) * spf

    return warp


def grid_to_text(tiers: List[tuple], max_time: float) -> str:
    """Serialize [(name, [Interval, ...]), ...] to long-form TextGrid text."""
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"',
             "xmin = 0", f"xmax = {max_time:.6f}", "tiers? <exists>",
             f"size = {len(tiers)}", "item []:"]
    for ti, (name, ivs) in enumerate(tiers, 1):
        lines += [f"    item [{ti}]:", '        class = "IntervalTier"',
                  f'        name = "{name}"', "        xmin = 0",
                  f"        xmax = {max_time:.6f}",
                  f"        intervals: size = {len(ivs)}"]
        for i, iv in enumerate(ivs, 1):
            lines += [f"        intervals [{i}]:",
                      f"            xmin = {iv.minTime:.6f}",
                      f"            xmax = {iv.maxTime:.6f}",
                      f'            text = "{iv.mark}"']
    return "\n".join(lines) + "\n"


def align_textgrid(ref_wav: np.ndarray, syn_wav: np.ndarray, ref_grid: TextGrid,
                   sr: int = 16000, device: DeviceLike = None) -> str:
    """TextGrid text for the synthetic audio: the reference grid's
    boundaries mapped through the DTW warp (interval marks preserved)."""
    warp = warp_function(ref_wav, syn_wav, sr, device=device)
    syn_dur = len(syn_wav) / sr
    tiers = []
    for tier in ref_grid.tiers:
        ivs = []
        for iv in tier:
            a = float(np.clip(warp(iv.minTime), 0, syn_dur))
            b = float(np.clip(warp(iv.maxTime), 0, syn_dur))
            if b <= a:
                b = min(a + 1e-4, syn_dur)
            ivs.append(Interval(a, b, iv.mark))
        tiers.append((tier.name, ivs))
    return grid_to_text(tiers, syn_dur)


def write_dtw_textgrids(base_path: str, method: str, target_speakers: List[str],
                        sr: int = 16000, device: DeviceLike = None) -> int:
    """Write DTW TextGrids for every (gen, gt) pair in a results tree (the
    walk :func:`~dissc_tpu_torch.eval.metrics.calc_errors` makes), where it
    looks for MFA output (``{gen}/{trg}/txtgrid/{stem}.TextGrid``).
    Returns the count written.  ``device=None`` runs the log-mels on the
    CUDA card and raises without one."""
    device = resolve_device(device)
    gt_path = f"{base_path}/orig"
    n = 0
    for trg in target_speakers:
        for f in sorted(glob.glob(f"{base_path}/{method}/{trg}/*.wav")):
            if trg in f.split("/")[-1]:
                continue
            seq = f.split("_")[-1].split(".")[0]
            gt_file = f"{gt_path}/{trg}_{seq}.wav"
            ref_grid_path = f"{gt_path}/txtgrid/{trg}_{seq}.TextGrid"
            if not (os.path.isfile(gt_file) and os.path.isfile(ref_grid_path)):
                continue
            path = Path(f)
            out_dir = path.parent / "txtgrid"
            os.makedirs(out_dir, exist_ok=True)
            ref_wav, sr_r = read_wav(gt_file, dtype="float32")
            syn_wav, _ = read_wav(f, dtype="float32")
            grid = align_textgrid(ref_wav, syn_wav, TextGrid.fromFile(ref_grid_path), sr_r,
                                  device)
            with open(out_dir / f"{path.stem}.TextGrid", "w") as fh:
                fh.write(grid)
            n += 1
    return n
