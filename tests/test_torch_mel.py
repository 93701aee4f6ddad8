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
from dissc_tpu_torch.audio.mel import mel_spectrogram
from dissc_tpu_torch.kernels.mel_kernel import (folded_bases, launch_counts,
                                                mel_spectrogram_grad, mel_spectrogram_kernel)

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


@pytest.mark.parametrize("fmax", [8000, None])
def test_kernel_operands_reproduce_the_chain(fmax):
    """The CUDA kernel's operands, used as it uses them: frames times the
    interleaved basis, magnitudes from (cos, sin) column pairs with pair 0
    holding (cos 0, cos n_fft/2), per-128-column partial mel sums over the
    non-zero spans only, then the log."""
    y = torch.from_numpy(_wave(3, 2560, b=3))
    basis, mel_t, spans = folded_bases(1024, 1024, 16000, 80, 0.0, fmax, torch.device("cpu"))
    assert basis.shape == (1024, 1024) and spans.shape == (8, 80, 2)
    frames = torch.nn.functional.pad(y[:, None], (384, 384), mode="reflect")[:, 0]
    c = frames.unfold(-1, 1024, 256) @ basis  # [B, F, 1024]
    mag = torch.sqrt(c[..., 0::2] ** 2 + c[..., 1::2] ** 2 + 1e-9)
    mag[..., 0] = torch.sqrt(c[..., 0] ** 2 + 1e-9)
    nyquist = torch.sqrt(c[..., 1] ** 2 + 1e-9)
    mel = nyquist[..., None] * mel_t[512]
    for blk in range(8):
        for m in range(80):
            lo, hi = (blk * 64 + int(v) for v in spans[blk, m])
            mel[..., m] += mag[..., lo:hi] @ mel_t[lo:hi, m]
    out = torch.log(torch.clamp(mel, min=1e-5)).transpose(1, 2)
    torch.testing.assert_close(out, mel_spectrogram(y, fmax=fmax), atol=ATOL, rtol=RTOL)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        mel_spectrogram_kernel(torch.zeros(2, 2560), n_fft=1000, hop_size=256)
    with pytest.raises(TypeError):
        mel_spectrogram_kernel(torch.zeros(2, 2560, dtype=torch.float64))


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
