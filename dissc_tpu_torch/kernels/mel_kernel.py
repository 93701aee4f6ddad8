"""Fused log-mel spectrogram: the port's CUDA kernel K1 and its wrapper.

Replaces ``dissc_tpu/kernels/mel_kernel.py::mel_spectrogram_pallas``
(the Pallas kernel ``_mel_kernel`` over the window-folded DFT bases of
``_folded_bases``) and, through :class:`MelSpectrogramFn`,
``mel_spectrogram_pallas_grad``.  Source: ``csrc/mel_kernel.cu``, built
by ``nvcc`` for ``sm_90a`` at first launch and bound with ``ctypes``.

One launch per call: each block reads the waveform span of two frames
into shared memory, takes their real FFT there (for an even ``n_fft`` a
mixed-radix Stockham complex FFT of ``n_fft/2`` points and a split step),
keeps the magnitudes on chip, sums each mel filter over its non-zero bins
only and writes the log.  What bounds it on an H100: fp32 operations
(about 1 us of work at the train shape); at these sizes latency sets its
time.  See the source.

It takes the configs :func:`kernel_supports` accepts: every config of the
Pallas kernel (``hop | n_fft``, ``win <= n_fft``) with ``n_fft <= 4096``.
The wrapper raises for any other config, on every device.  Dispatch is by
the tensor's device, never by failure: a CPU tensor goes to the plain
chain :func:`dissc_tpu_torch.audio.mel.mel_spectrogram`; a CUDA tensor
launches the kernel or raises.  Each launch adds one to
``launch_counts["mel_spectrogram"]``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from dissc_tpu_torch.audio.mel import hann_window, mel_filterbank, mel_spectrogram

launch_counts = {"mel_spectrogram": 0}


def reset_launch_counts() -> None:
    for key in launch_counts:
        launch_counts[key] = 0


MAX_N_FFT = 4096  # csrc/mel_kernel.cu's MAX_N_FFT


def kernel_supports(n_fft: int, hop_size: int, win_size: int, num_mels: int) -> bool:
    """Whether K1 takes this config: the Pallas kernel's (``hop | n_fft``,
    ``win <= n_fft``) with ``n_fft`` up to :data:`MAX_N_FFT`, whatever its
    factors."""
    return (1 <= n_fft <= MAX_N_FFT and hop_size >= 1 and n_fft % hop_size == 0
            and 1 <= win_size <= n_fft and num_mels >= 1)


@functools.lru_cache(maxsize=8)
def kernel_tables(n_fft: int, win_size: int, sampling_rate: int, num_mels: int,
                  fmin: float, fmax: Optional[float]):
    """K1's operands, as numpy arrays: the Hann window [n_fft] f32; the
    twiddles ``e^{-2 pi i j / n_fft}``, ``j < n`` (``n = n_fft/2`` for an
    even ``n_fft``, ``n_fft`` for an odd one: the kernel's FFT length), as
    [n, 2] f32 (re, im), computed in float64 and rounded; and the mel basis
    in CSR form: ``mel_lo`` [num_mels] int32, the first non-zero bin of
    each filter, ``mel_ptr`` [num_mels + 1] int32, where filter ``m``'s
    weights sit in ``mel_w[mel_ptr[m]:mel_ptr[m + 1]]`` for bins
    ``mel_lo[m]`` on."""
    window = hann_window(win_size, n_fft)
    n = n_fft // 2 if n_fft % 2 == 0 else n_fft
    ang = -2.0 * np.pi * np.arange(n) / n_fft
    twiddles = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    mel = mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax)
    mel_lo = np.zeros(num_mels, np.int32)
    rows = []
    for m in range(num_mels):
        nz = np.flatnonzero(mel[m])
        lo, hi = (nz[0], nz[-1] + 1) if nz.size else (0, 0)
        mel_lo[m] = lo
        rows.append(mel[m, lo:hi])
    mel_ptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)
    mel_w = np.concatenate(rows).astype(np.float32)
    return window, twiddles, mel_lo, mel_ptr, mel_w


@functools.lru_cache(maxsize=8)
def _device_tables(n_fft: int, win_size: int, sampling_rate: int, num_mels: int,
                   fmin: float, fmax: Optional[float], device: torch.device):
    return tuple(torch.from_numpy(a).to(device)
                 for a in kernel_tables(n_fft, win_size, sampling_rate, num_mels, fmin, fmax))


@functools.lru_cache(maxsize=1)
def _launcher():
    from dissc_tpu_torch.kernels import build

    fn = build.load("mel_kernel").mel_spectrogram_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(y: torch.Tensor, n_fft: int, hop_size: int, win_size: int, num_mels: int) -> int:
    if y.dim() != 2:
        raise ValueError(f"y must be [B, T], got {tuple(y.shape)}")
    if y.dtype != torch.float32:
        raise TypeError(f"y must be float32, got {y.dtype}")
    if not kernel_supports(n_fft, hop_size, win_size, num_mels):
        raise ValueError(f"the kernel takes 1 <= n_fft <= {MAX_N_FFT}, hop | n_fft, "
                         f"1 <= win <= n_fft and num_mels >= 1 (n_fft={n_fft}, "
                         f"hop={hop_size}, win={win_size}, num_mels={num_mels})")
    pad = (n_fft - hop_size) // 2
    n_frames = 1 + (y.shape[1] + 2 * pad - n_fft) // hop_size
    if y.shape[1] <= pad or n_frames < 1:
        raise ValueError(f"T={y.shape[1]} too short for n_fft={n_fft}, hop={hop_size}")
    return n_frames


def mel_spectrogram_kernel(y: torch.Tensor, n_fft: int = 1024, num_mels: int = 80,
                           sampling_rate: int = 16000, hop_size: int = 256,
                           win_size: int = 1024, fmin: float = 0,
                           fmax: Optional[float] = 8000) -> torch.Tensor:
    """[B, T] float32 waveform -> [B, num_mels, F] log-mel, fused on the card.

    A CPU tensor takes the plain chain.  A CUDA tensor launches K1.
    """
    n_frames = _check(y, n_fft, hop_size, win_size, num_mels)
    if y.device.type == "cpu":
        return mel_spectrogram(y, n_fft, num_mels, sampling_rate, hop_size,
                               win_size, fmin, fmax)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    y = y.detach().contiguous()
    tables = _device_tables(n_fft, win_size, sampling_rate, num_mels, float(fmin), fmax,
                            y.device)
    batch = y.shape[0]
    out = torch.empty((batch, num_mels, n_frames), dtype=torch.float32, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = _launcher()(y.data_ptr(), *(t.data_ptr() for t in tables), out.data_ptr(),
                      batch, y.shape[1], n_frames, n_fft, hop_size, num_mels, stream)
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
