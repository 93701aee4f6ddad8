"""Port's log-mel (plain chain and the kernel's wrapper) vs the JAX package.

On the CPU the kernel's wrapper takes the plain chain; the CUDA kernel
itself is checked against that chain on the card by ``chip_smoke.py``.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissc_tpu.audio.mel import mel_spectrogram as jax_mel
from dissc_tpu.kernels import mel_kernel as jax_mel_kernel
from dissc_tpu_torch.audio.mel import hann_window, mel_filterbank, mel_spectrogram
from dissc_tpu_torch.audio.probes import tone_and_silence
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.kernels.mel_kernel import (MAX_N_FFT, kernel_supports, kernel_tables,
                                                launch_counts, mel_spectrogram_grad,
                                                mel_spectrogram_kernel)
from dissc_tpu_torch.train.vocoder_trainer import pick_mel_fn

torch.set_num_threads(2)

# log-mel tolerance of tests/test_kernels.py: f32 sums of 1024 products
# taken in another order; log amplifies relative error near the 1e-5 floor
ATOL, RTOL = 2e-4, 1e-4


def _wave(seed, t, b=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t)).astype(np.float32) * 0.3).clip(-1, 1)


@pytest.mark.parametrize("t", [8960, 2560])
@pytest.mark.parametrize("fmax", [8000, None])
def test_plain_mel_matches_jax_chain_and_pallas(t, fmax):
    y = _wave(t, t)
    ref = np.asarray(jax_mel(jnp.asarray(y), fmax=fmax))
    pallas = np.asarray(jax_mel_kernel.mel_spectrogram_pallas(jnp.asarray(y), fmax=fmax,
                                                              interpret=True))
    out = mel_spectrogram(torch.from_numpy(y), fmax=fmax).numpy()
    assert out.shape == ref.shape == (2, 80, 1 + (t + 768 - 1024) // 256)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, pallas, atol=ATOL, rtol=RTOL)


def test_kernel_wrapper_on_cpu_takes_plain_chain():
    y = torch.from_numpy(_wave(1, 2560))
    before = launch_counts["mel_spectrogram"]
    out = mel_spectrogram_kernel(y, fmax=None)
    torch.testing.assert_close(out, mel_spectrogram(y, fmax=None), rtol=0, atol=0)
    assert launch_counts["mel_spectrogram"] == before  # no kernel on a CPU tensor


def _radices(n):
    """csrc/mel_kernel.cu's factor(): 4 while 4 divides what is left, one
    2, then the odd primes from the smallest; 1 is one copy stage."""
    out = [1] if n == 1 else []
    while n % 4 == 0:
        out, n = out + [4], n // 4
    if n % 2 == 0:
        out, n = out + [2], n // 2
    p = 3
    while n > 1:
        while n % p == 0:
            out, n = out + [p], n // p
        p += 2
    return out


def _fft_kernel_mirror(y, n_fft, hop, win, mels, fmax, sampling_rate=16000):
    """csrc/mel_kernel.cu's steps on the CPU in float32, with the wrapper's
    own tables: frames of the reflect-padded waveform; for an even n_fft
    z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1] and a Stockham FFT of N = n_fft/2
    points, for an odd one the real frame and N = n_fft; the kernel's
    stages (radix-4 and radix-2 butterflies, any other factor a direct DFT
    with one twiddle a term); for an even n_fft the split step to bins
    0..N-1 and X[N] = Re Z[0] - Im Z[0]; sqrt(re^2 + im^2 + 1e-9), the CSR
    mel sum in bin order and the log."""
    window, tw, mel_lo, mel_ptr, mel_w = kernel_tables(n_fft, win, sampling_rate, mels, 0.0,
                                                        fmax)
    packed, pad = n_fft % 2 == 0, (n_fft - hop) // 2
    n = n_fft // 2 if packed else n_fft
    x = torch.nn.functional.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    x = x.unfold(-1, n_fft, hop) * torch.from_numpy(window)  # [B, F, n_fft]
    table = torch.complex(torch.from_numpy(tw[:, 0]), torch.from_numpy(tw[:, 1]))

    def twiddle(j):  # e^{-2 pi i j / n_fft}, 0 <= j < n_fft, from the table of n
        return torch.where(j < n, table[j % n], -table[j % n])

    a = (torch.complex(x[..., 0::2], x[..., 1::2]) if packed
         else torch.complex(x, torch.zeros_like(x)))
    ns = 1
    for r in _radices(n):
        m, step = n // r, n_fft // (ns * r)
        j = torch.arange(m)
        k = j % ns
        b = torch.empty_like(a)
        if r in (2, 4):
            v = [a[..., j + q * m] * twiddle(q * k * step) for q in range(r)]
            if r == 4:
                t0, t1, t2, t3 = v[0] + v[2], v[0] - v[2], v[1] + v[3], -1j * (v[1] - v[3])
                v = [t0 + t2, t1 + t3, t0 - t2, t1 - t3]
            else:
                v = [v[0] + v[1], v[0] - v[1]]
        else:
            v = []
            for p in range(r):
                s = torch.zeros_like(a[..., j])
                for q in range(r):
                    s = s + a[..., j + q * m] * twiddle((q * k * step + (p * q % r) * (n_fft // r))
                                                        % n_fft)
                v.append(s)
        for q in range(r):
            b[..., (j - k) * r + k + q * ns] = v[q]
        a, ns = b, ns * r
    if packed:
        k = torch.arange(n)
        zk, zc = a[..., k], a[..., (n - k) % n].conj()
        spec = 0.5 * (zk + zc) - 0.5j * table * (zk - zc)
        nyquist = a[..., :1].real - a[..., :1].imag  # X[N] = Re Z[0] - Im Z[0]
        power = torch.cat([spec.real ** 2 + spec.imag ** 2, nyquist ** 2], -1)
    else:
        spec = a[..., :n // 2 + 1]
        power = spec.real ** 2 + spec.imag ** 2
    mag = torch.sqrt(power + 1e-9)
    s = torch.zeros(mag.shape[:-1] + (mels,))
    for m in range(mels):
        for p in range(mel_ptr[m], mel_ptr[m + 1]):
            s[..., m] += mag[..., mel_lo[m] + p - mel_ptr[m]] * float(mel_w[p])
    return torch.log(torch.clamp(s, min=1e-5)).transpose(1, 2)


@pytest.mark.parametrize("n_fft, hop, win, mels, fmax, signal", [
    (1024, 256, 1024, 80, 8000, "noise"),
    (1024, 256, 1024, 80, None, "noise"),
    (32, 8, 32, 8, None, "noise"),  # dissc_tpu/parallel/dryrun.py's widths
    (2048, 512, 2048, 80, 8000, "noise"),
    (1024, 256, 1024, 80, None, "tone_and_silence"),
    (1000, 250, 1000, 80, 8000, "noise"),  # N = 500 = 4 * 5^3
    (4095, 315, 4000, 80, 8000, "noise"),  # odd: N = 4095 = 3^2 * 5 * 7 * 13
    (4096, 1024, 3200, 80, 8000, "noise"),  # the top of the range
    (6, 3, 5, 4, None, "noise"),  # N = 3
    (9, 3, 9, 4, None, "tone_and_silence"),  # odd: N = 9 = 3 * 3
])
def test_fft_kernel_algorithm_reproduces_the_chain(n_fft, hop, win, mels, fmax, signal):
    t = 4 * n_fft + 3 * hop
    y = _wave(n_fft, t, b=3) if signal == "noise" else tone_and_silence(3, t, n_fft).numpy()
    kw = dict(n_fft=n_fft, num_mels=mels, hop_size=hop, win_size=win, fmax=fmax)
    out = _fft_kernel_mirror(torch.from_numpy(y), n_fft, hop, win, mels, fmax)
    plain = mel_spectrogram(torch.from_numpy(y), **kw)
    ref = np.asarray(jax_mel(jnp.asarray(y), **kw))
    assert out.shape == plain.shape == ref.shape
    torch.testing.assert_close(out, plain, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)



def _float64_log_mel(y, n_fft, hop, win, mels, fmax):
    """The log-mel in float64 through numpy's FFT."""
    pad = (n_fft - hop) // 2
    x = np.pad(y.astype(np.float64), ((0, 0), (pad, pad)), mode="reflect")
    frames = np.lib.stride_tricks.sliding_window_view(x, n_fft, axis=-1)[:, ::hop]
    spec = np.fft.rfft(frames * hann_window(win, n_fft).astype(np.float64), axis=-1)
    mel = mel_filterbank(16000, n_fft, mels, 0.0, fmax).astype(np.float64)
    mag = np.sqrt(np.abs(spec) ** 2 + 1e-9)
    return np.log(np.maximum(mag @ mel.T, 1e-5)).transpose(0, 2, 1)


@pytest.mark.parametrize("n_fft, hop", [(1024, 256), (1000, 250)])
def test_fft_kernel_algorithm_on_tone_and_silence_matches_float64(n_fft, hop):
    """On the tone at a bin centre, whose empty bins sit at the 1e-9 floor
    and most of whose cells sit at the 1e-5 clip, the FFT stays within the
    tolerance of a float64 log-mel, a reference independent of the plain
    chain.  (Past n_fft 2048 the rounding noise of any fp32 transform in
    those bins outgrows the floor, so the probe stops there.)"""
    y = tone_and_silence(3, 4 * n_fft + 3 * hop, n_fft).numpy()
    out = _fft_kernel_mirror(torch.from_numpy(y), n_fft, hop, n_fft, 80, 8000).numpy()
    np.testing.assert_allclose(out, _float64_log_mel(y, n_fft, hop, n_fft, 80, 8000),
                               atol=ATOL, rtol=RTOL)

DRY_RUN = dict(n_fft=32, hop_size=8, win_size=32, num_mels=8)  # dissc_tpu/parallel/dryrun.py:101


def test_kernel_supports_and_pick_mel_fn():
    accepted = [(1024, 256, 1024, 80), (32, 8, 32, 8), (2048, 512, 2048, 80),
                (4096, 4096, 4096, 80), (1024, 256, 800, 80), (64, 1, 64, 33),
                (1000, 250, 1000, 80), (4095, 315, 4095, 80), (16, 4, 16, 8),
                (32, 8, 32, 18), (1, 1, 1, 1)]
    refused = [(8192, 256, 8192, 80), (1024, 256, 2048, 80), (1024, 384, 1024, 80),
               (1024, 256, 1024, 0), (1024, 256, 0, 80)]
    assert all(kernel_supports(*c) for c in accepted)
    assert not any(kernel_supports(*c) for c in refused)
    # the trainer routes by the JAX _pick_mel_fn's test alone ...
    for n_fft, hop, win, mels in accepted + refused:
        h = VocoderConfig(n_fft=n_fft, hop_size=hop, win_size=win, num_mels=mels)
        jax_route = n_fft % hop == 0 and win <= n_fft
        expect = mel_spectrogram_grad if jax_route else mel_spectrogram
        assert pick_mel_fn(h, torch.device("cuda")).func is expect
        assert pick_mel_fn(h, torch.device("cpu")).func is mel_spectrogram
    # ... and K1 takes every config that route sends it up to MAX_N_FFT
    for n_fft in range(1, MAX_N_FFT + 1):
        for hop in (d for d in range(1, n_fft + 1) if n_fft % d == 0):
            assert kernel_supports(n_fft, hop, n_fft, 80)
    fn = pick_mel_fn(VocoderConfig(**DRY_RUN, fmax_for_loss=None), torch.device("cuda"))
    assert fn.func is mel_spectrogram_grad
    assert fn.keywords == dict(n_fft=32, num_mels=8, sampling_rate=16000, hop_size=8,
                               win_size=32, fmin=0.0, fmax=None)


@pytest.mark.parametrize("y, kw, err", [
    (torch.zeros(2, 20480), dict(n_fft=8192, hop_size=2048, win_size=8192), ValueError),
    (torch.zeros(2, 2560), dict(win_size=2048), ValueError),
    (torch.zeros(2, 2560), dict(hop_size=384), ValueError),
    (torch.zeros(2, 2560), dict(win_size=0), ValueError),
    (torch.zeros(2, 2560), dict(DRY_RUN, num_mels=0), ValueError),
    (torch.zeros(2, 300), {}, ValueError),
    (torch.zeros(2560), {}, ValueError),
    (torch.zeros(2, 2560, dtype=torch.float64), {}, TypeError),
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(y, kw, err):
    with pytest.raises(err):
        mel_spectrogram_kernel(y, **kw)


def test_autograd_fn_value_and_grad_match_jax_custom_vjp():
    """Value and gradient of mean|mel| through the port's autograd Function
    vs JAX value_and_grad of mel_spectrogram_pallas_grad (interpret mode)."""
    y = _wave(2, 2560)
    orig = jax_mel_kernel.mel_spectrogram_pallas
    try:
        jax_mel_kernel.mel_spectrogram_pallas = (
            lambda yy, *a, **kw: orig(yy, *a, interpret=True, **kw))
        vj, gj = jax.value_and_grad(
            lambda yy: jnp.abs(jax_mel_kernel.mel_spectrogram_pallas_grad(yy)).mean()
        )(jnp.asarray(y))
    finally:
        jax_mel_kernel.mel_spectrogram_pallas = orig
    yt = torch.from_numpy(y).requires_grad_(True)
    vt = mel_spectrogram_grad(yt).abs().mean()
    vt.backward()
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-5)
    # gradient tolerance of tests/test_kernels.py:45 (entries are ~1e-4),
    # which is meaningful only while the gradient is far above it
    assert np.abs(np.asarray(gj)).max() > 100 * 1e-6
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gj), atol=1e-6)


def test_importing_kernel_module_builds_nothing(tmp_path):
    """Import needs no nvcc and compiles nothing (the build is lazy)."""
    code = ("import os, sys\n"
            "os.environ['PATH'] = ''\n"
            "import dissc_tpu_torch.kernels.mel_kernel as m\n"
            "from dissc_tpu_torch.kernels import build\n"
            "assert not build._loaded\n"
            "assert m._launcher.cache_info().currsize == 0\n")
    env = {"PYTHONPATH": str(Path(__file__).resolve().parents[1]), "HOME": str(tmp_path)}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)
