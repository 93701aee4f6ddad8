"""Probe waveforms for checking a log-mel against another at its floors."""
from __future__ import annotations

import numpy as np
import torch


def tone_and_silence(b: int, t: int, n_fft: int) -> torch.Tensor:
    """[b, t] float32.  Row i: 0.5 cos at the centre of bin 1 + 37i (mod
    n_fft/2 - 1), with exact zeros over the second quarter and from the last
    eighth to the end, cut on whole periods.  Every bin but the tone's three
    is zero, so the 1e-9 floor and the 1e-5 clip decide most cells, where an
    FFT and a dense DFT round differently."""
    k0 = 1 + (np.arange(b)[:, None] * 37) % max(n_fft // 2 - 1, 1)
    y = 0.5 * np.cos(2 * np.pi * k0 * np.arange(t) / n_fft)
    y[:, t // 4 // n_fft * n_fft:t // 2 // n_fft * n_fft] = 0.0
    y[:, (t - t // 8) // n_fft * n_fft:] = 0.0
    return torch.from_numpy(y.astype(np.float32))
