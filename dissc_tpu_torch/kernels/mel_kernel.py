"""Fused log-mel spectrogram: the port's CUDA kernel K1 and its wrapper.

Replaces ``dissc_tpu/kernels/mel_kernel.py::mel_spectrogram_pallas``
(the Pallas kernel ``_mel_kernel`` over the window-folded bases of
``_folded_bases``) and, through :class:`MelSpectrogramFn`,
``mel_spectrogram_pallas_grad``.  Source: ``csrc/mel_kernel.cu``, built
by ``nvcc`` for ``sm_90a`` at first launch and bound with ``ctypes``.

What bounds it on an H100: fp32 operations.  Its dense DFT does ~640 FLOP
per byte moved at the train shape, ~70x the operations of a real FFT; see
the source for what the design does about it.

Dispatch is by the tensor's device, never by failure: a CPU tensor goes
to the plain chain :func:`dissc_tpu_torch.audio.mel.mel_spectrogram`; a
CUDA tensor launches the kernel or raises.  Each launch adds one to
``launch_counts["mel_spectrogram"]``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from dissc_tpu_torch.audio.mel import hann_window, _dft_bases, mel_filterbank, mel_spectrogram

launch_counts = {"mel_spectrogram": 0}
BLOCK_COLUMNS = 128  # basis columns per block (BN in csrc/mel_kernel.cu)


def reset_launch_counts() -> None:
    for key in launch_counts:
        launch_counts[key] = 0


@functools.lru_cache(maxsize=8)
def folded_bases(n_fft: int, win_size: int, sampling_rate: int, num_mels: int,
                 fmin: float, fmax: Optional[float], device: torch.device):
    """(interleaved window-folded DFT basis [n_fft, n_fft], mel.T [freq, mels],
    mel spans [n_fft/128, mels, 2]) on ``device``.

    Column ``2k`` is the Hann-folded cosine of frequency ``k`` and ``2k+1``
    its sine, except that column 1 holds the cosine of ``n_fft/2``: the
    sines of frequencies 0 and ``n_fft/2`` vanish, so ``n_fft`` columns
    carry all ``n_fft/2 + 1`` frequencies.  ``spans[c, m]`` is the
    ``[first, last)`` range of bins ``128c/2 + [0, 64)`` where mel filter
    ``m`` is non-zero (``[0, 0)`` where it is zero on all of them).
    """
    window = hann_window(win_size, n_fft)[:, None]
    cos_b, sin_b = _dft_bases(n_fft)
    basis = np.empty((n_fft, n_fft), np.float32)
    basis[:, 0::2] = (window * cos_b)[:, : n_fft // 2]
    basis[:, 1::2] = (window * sin_b)[:, : n_fft // 2]
    basis[:, 1] = (window * cos_b)[:, n_fft // 2]
    mel = mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax)
    pairs = BLOCK_COLUMNS // 2
    spans = np.zeros((n_fft // BLOCK_COLUMNS, num_mels, 2), np.int32)
    for c in range(spans.shape[0]):
        for m in range(num_mels):
            nz = np.flatnonzero(mel[m, c * pairs:(c + 1) * pairs])
            if nz.size:
                spans[c, m] = nz[0], nz[-1] + 1
    return (torch.from_numpy(basis).to(device),
            torch.from_numpy(np.ascontiguousarray(mel.T)).to(device),
            torch.from_numpy(spans).to(device))


@functools.lru_cache(maxsize=1)
def _launcher():
    from dissc_tpu_torch.kernels import build

    fn = build.load("mel_kernel").mel_spectrogram_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(y: torch.Tensor, n_fft: int, hop_size: int, win_size: int) -> int:
    if y.dim() != 2:
        raise ValueError(f"y must be [B, T], got {tuple(y.shape)}")
    if y.dtype != torch.float32:
        raise TypeError(f"y must be float32, got {y.dtype}")
    if n_fft % hop_size or win_size > n_fft:
        raise ValueError(f"needs hop | n_fft and win <= n_fft (n_fft={n_fft}, "
                         f"hop={hop_size}, win={win_size})")
    pad = (n_fft - hop_size) // 2
    if y.shape[1] <= pad:
        raise ValueError(f"T={y.shape[1]} too short to reflect-pad by {pad}")
    return 1 + (y.shape[1] + 2 * pad - n_fft) // hop_size


def mel_spectrogram_kernel(y: torch.Tensor, n_fft: int = 1024, num_mels: int = 80,
                           sampling_rate: int = 16000, hop_size: int = 256,
                           win_size: int = 1024, fmin: float = 0,
                           fmax: Optional[float] = 8000) -> torch.Tensor:
    """[B, T] float32 waveform -> [B, num_mels, F] log-mel, fused on the card.

    A CPU tensor takes the plain chain.  A CUDA tensor launches K1.
    """
    n_frames = _check(y, n_fft, hop_size, win_size)
    if y.device.type == "cpu":
        return mel_spectrogram(y, n_fft, num_mels, sampling_rate, hop_size,
                               win_size, fmin, fmax)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if n_fft % BLOCK_COLUMNS:
        raise ValueError(f"the kernel takes n_fft % {BLOCK_COLUMNS} == 0, got {n_fft}")
    y = y.detach().contiguous()
    basis, mel_t, spans = folded_bases(n_fft, win_size, sampling_rate, num_mels,
                                       float(fmin), fmax, y.device)
    batch = y.shape[0]
    partial = torch.empty((n_fft // BLOCK_COLUMNS, batch * n_frames, num_mels),
                          dtype=torch.float32, device=y.device)
    out = torch.empty((batch, num_mels, n_frames), dtype=torch.float32, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = _launcher()(y.data_ptr(), basis.data_ptr(), mel_t.data_ptr(), spans.data_ptr(),
                      partial.data_ptr(), out.data_ptr(), batch, y.shape[1], n_frames,
                      n_fft, hop_size, num_mels, stream)
    if err != 0:
        raise RuntimeError(f"mel_spectrogram kernel launch failed: CUDA error {err}")
    launch_counts["mel_spectrogram"] += 1
    return out


class MelSpectrogramFn(torch.autograd.Function):
    """Differentiable fused log-mel (``mel_spectrogram_pallas_grad``).

    The forward is the kernel.  It keeps no magnitudes, so the backward
    recomputes the plain chain and differentiates it with autograd, as the
    JAX package's ``custom_vjp`` does.
    """

    @staticmethod
    def forward(ctx, y, n_fft, num_mels, sampling_rate, hop_size, win_size, fmin, fmax):
        ctx.save_for_backward(y)
        ctx.mel_args = (n_fft, num_mels, sampling_rate, hop_size, win_size, fmin, fmax)
        return mel_spectrogram_kernel(y, *ctx.mel_args)

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        with torch.enable_grad():
            yy = y.detach().requires_grad_(True)
            out = mel_spectrogram(yy, *ctx.mel_args)
            (gy,) = torch.autograd.grad(out, yy, grad)
        return (gy,) + (None,) * 7


def mel_spectrogram_grad(y: torch.Tensor, n_fft: int = 1024, num_mels: int = 80,
                         sampling_rate: int = 16000, hop_size: int = 256,
                         win_size: int = 1024, fmin: float = 0.0,
                         fmax: Optional[float] = 8000.0) -> torch.Tensor:
    """Differentiable :func:`mel_spectrogram_kernel`."""
    return MelSpectrogramFn.apply(y, n_fft, num_mels, sampling_rate, hop_size,
                                  win_size, fmin, fmax)
