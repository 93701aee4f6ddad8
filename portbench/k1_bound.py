"""The least time of one log-mel of a ``[b, t]`` waveform on a card: the
bound that K1, the program's fused log-mel kernel, is held to.

The larger of two: the operations the function needs at the card's FP32
(SIMT) peak, per frame a windowed real FFT (``n_fft`` multiplies and
``2.5 n_fft log2 n_fft``), the magnitudes (4 per bin), the mel projection
over the filters' non-zero weights only (2 each) and the log (1 per mel);
or the bytes, the waveform read once, the log-mel written once and the
window and the non-zero mel weights read once, at the card's HBM rate.
"""
from __future__ import annotations

import numpy as np

from portbench.reference.vocoder import mel_basis


def mel_bound_s(b: int, t: int, h: dict, peak: dict) -> float:
    n_fft, hop = h["n_fft"], h["hop_size"]
    freq = n_fft // 2 + 1
    frames = b * (1 + (t + 2 * ((n_fft - hop) // 2) - n_fft) // hop)
    mel_nnz = int(np.count_nonzero(mel_basis(h["sampling_rate"], n_fft, h["num_mels"],
                                             float(h["fmin"]), h["fmax_for_loss"])))
    per_frame = n_fft + 2.5 * n_fft * np.log2(n_fft) + 4 * freq + 2 * mel_nnz + h["num_mels"]
    nbytes = 4.0 * (b * t + frames * h["num_mels"] + h["win_size"] + mel_nnz)
    return float(max(frames * per_frame / peak["fp32_flops"], nbytes / peak["hbm_bytes_per_s"]))
