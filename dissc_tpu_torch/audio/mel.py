"""Log-mel spectrogram in plain PyTorch (``dissc_tpu.audio.mel``).

Reference ``sr/dataset.py:46-104``: reflect-pad (n_fft-hop)/2, periodic
Hann window, ``torch.stft(center=False)``, magnitude
``sqrt(re^2+im^2+1e-9)``, slaney-scale/slaney-norm librosa mel basis,
then ``log(clamp(x, 1e-5))``.  It is the mel-loss target of the vocoder
trainer and its validation metric.

The DFT is the matmul form (two real products against cos/sin bases),
as in the JAX package.  This chain is the plain version of the fused
kernel :mod:`dissc_tpu_torch.kernels.mel_kernel` and that kernel's
backward.  It must run in full float32: on the card
:func:`dissc_tpu_torch.device.resolve_device` sets
``torch.backends.cuda.matmul.allow_tf32 = False`` (the JAX chain runs its
products at ``Precision.HIGHEST``; TF32 would move the loss target).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    mels = f / (200.0 / 3.0)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3.0)
    logstep = math.log(6.4) / 27.0
    safe_f = np.maximum(f, 1e-10)
    return np.where(f >= min_log_hz, min_log_mel + np.log(safe_f / min_log_hz) / logstep, mels)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    freqs = m * (200.0 / 3.0)
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / (200.0 / 3.0)
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sampling_rate: int, n_fft: int, num_mels: int, fmin: float,
                   fmax: Optional[float]) -> np.ndarray:
    """[num_mels, n_fft//2+1] triangular filterbank, slaney-normalised
    (``librosa.filters.mel`` defaults; ``fmax=None`` means ``sr/2``)."""
    if fmax is None:
        fmax = sampling_rate / 2.0
    fftfreqs = np.linspace(0, sampling_rate / 2.0, n_fft // 2 + 1)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), num_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2: num_mels + 2] - mel_pts[:num_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _dft_bases(n_fft: int) -> tuple:
    """Real/imag DFT bases [n_fft, n_fft//2+1] for the matmul STFT."""
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = -2.0 * np.pi * np.outer(n, k) / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def hann_window(win_size: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window, centre-padded to ``n_fft`` like ``torch.stft``."""
    window = np.hanning(win_size + 1)[:-1].astype(np.float32)
    if win_size < n_fft:
        lpad = (n_fft - win_size) // 2
        window = np.pad(window, (lpad, n_fft - win_size - lpad))
    return window


# The cached tensors are made outside inference mode even when the first
# call comes from inside it: an inference tensor cannot take part in a later
# autograd graph (the trainer's mel loss), and the cache outlives the call.
@functools.lru_cache(maxsize=16)
def _device_tensors(n_fft: int, win_size: int, device: torch.device):
    cos_b, sin_b = _dft_bases(n_fft)
    with torch.inference_mode(False):
        return (torch.from_numpy(hann_window(win_size, n_fft)).to(device),
                torch.from_numpy(cos_b).to(device), torch.from_numpy(sin_b).to(device))


@functools.lru_cache(maxsize=16)
def _mel_tensor(sampling_rate, n_fft, num_mels, fmin, fmax, device: torch.device):
    with torch.inference_mode(False):
        return torch.from_numpy(
            mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax)).to(device)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop: int, win_size: int,
                   eps: float = 1e-9) -> torch.Tensor:
    """[B, T] -> [B, freq, F] magnitude spectrogram, ``torch.stft`` semantics
    (periodic Hann, center=False, onesided, ``sqrt(.^2 + 1e-9)`` floor)."""
    window, cos_b, sin_b = _device_tensors(n_fft, win_size, y.device)
    frames = y.unfold(-1, n_fft, hop) * window  # [B, F, n_fft]
    re = frames @ cos_b
    im = frames @ sin_b
    mag = torch.sqrt(re * re + im * im + eps)  # [B, F, freq]
    return mag.transpose(1, 2)


def mel_spectrogram(y: torch.Tensor, n_fft: int = 1024, num_mels: int = 80,
                    sampling_rate: int = 16000, hop_size: int = 256,
                    win_size: int = 1024, fmin: float = 0,
                    fmax: Optional[float] = 8000) -> torch.Tensor:
    """[B, T] waveform -> [B, num_mels, 1 + (T + 2*pad - n_fft)//hop] log-mel,
    ``pad = (n_fft - hop)//2`` reflected at both ends."""
    pad = (n_fft - hop_size) // 2
    y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    mag = stft_magnitude(y, n_fft, hop_size, win_size)
    mel = _mel_tensor(sampling_rate, n_fft, num_mels, fmin, fmax, y.device)
    melspec = torch.matmul(mel, mag)
    return torch.log(torch.clamp(melspec, min=1e-5))
