"""Probe waveforms: a tone with silence for checking a log-mel against
another at its floors, and voiced stretches at known f0 for an F0 tracker."""
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


# (start s, end s, f0 Hz) of the voiced stretches of ``voiced_stretches``
STRETCHES = ((0.5, 2.0, 120.0), (2.5, 4.0, 200.0), (4.5, 6.0, 160.0), (7.0, 8.5, 250.0))


def voiced_stretches(sr: int, seed: int, dur_s: float = 10.0) -> np.ndarray:
    """[dur_s * sr] float32: harmonic tones (5 harmonics, amplitude 0.6/h)
    at the known f0s of ``STRETCHES``, between white noise (std 0.01) and
    exact silence (every other gap)."""
    rng = np.random.default_rng(seed)
    n = int(dur_s * sr)
    x = np.zeros(n)
    gaps = [(0.0, STRETCHES[0][0])] + [(a[1], b[0]) for a, b in zip(STRETCHES, STRETCHES[1:])]
    gaps.append((STRETCHES[-1][1], dur_s))
    for i, (a, b) in enumerate(gaps):
        if i % 2:
            s = slice(int(a * sr), int(b * sr))
            x[s] = rng.standard_normal(s.stop - s.start) * 0.01
    for a, b, f0 in STRETCHES:
        t = np.arange(int(a * sr), int(b * sr)) / sr
        x[int(a * sr):int(b * sr)] = sum(0.6 / h * np.sin(2 * np.pi * f0 * h * t)
                                         for h in range(1, 6))
    return x.astype(np.float32)
