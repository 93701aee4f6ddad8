"""Port's YAAPT tracker vs the JAX package's on the signals of
``tests/test_yaapt.py``.

Voicing must be identical on every frame and voiced f0 within 1e-4
relative (NCCF, SHC and the emission costs run in float32 in another
summation order; the Viterbi DP runs in float32 in the JAX scan's order).
The port also checks the properties the JAX tests check.
"""
import numpy as np
import pytest
import torch

from dissc_tpu.audio import yaapt as jy
from dissc_tpu_torch.audio import yaapt as ty

torch.set_num_threads(2)


def _voiced_tone(f0_hz, dur_s=0.5, sr=16000, harmonics=5):
    t = np.arange(int(dur_s * sr)) / sr
    x = sum((0.6 / (h + 1)) * np.sin(2 * np.pi * f0_hz * (h + 1) * t) for h in range(harmonics))
    return x.astype(np.float32)


def _signals():
    sr = 16000
    rng = np.random.default_rng(0)
    seg_u = (rng.standard_normal(int(0.3 * sr)) * 0.01).astype(np.float32)
    t = np.arange(sr) / sr
    ramp = np.sin(2 * np.pi * np.cumsum(120 + 80 * t) / sr).astype(np.float32)
    t5 = np.arange(int(0.5 * sr)) / sr
    missing = sum(0.4 / h * np.sin(2 * np.pi * 140.0 * h * t5) for h in range(2, 6))
    silence = np.zeros(8000, np.float32)
    silence[:40] = 1e-4
    noisy = (_voiced_tone(160.0) + np.random.default_rng(3).standard_normal(8000)
             .astype(np.float32) * 0.3)
    return {
        "tone110": _voiced_tone(110.0), "tone180": _voiced_tone(180.0),
        "tone260": _voiced_tone(260.0), "silence": silence,
        "voiced_unvoiced": np.concatenate([_voiced_tone(150.0, 0.3), seg_u,
                                           _voiced_tone(150.0, 0.3)]),
        "ramp": ramp, "noisy": noisy, "missing_fundamental": missing.astype(np.float32),
        "short": _voiced_tone(200.0, 0.02),
    }


@pytest.mark.parametrize("name", sorted(_signals()))
def test_yaapt_matches_jax(name):
    x = _signals()[name]
    ref = jy.yaapt_f0(x, 16000)
    out = ty.yaapt_f0(x, 16000, device="cpu")
    assert out.shape == ref.shape == (max(1, round(len(x) / 80)),)
    np.testing.assert_array_equal(out > 0, ref > 0)
    np.testing.assert_allclose(out, ref, rtol=1e-4)
    if name.startswith("tone"):
        voiced = out[out > 0]
        assert voiced.size > 0.7 * out.size
        assert abs(np.median(voiced) - float(name[4:])) / float(name[4:]) < 0.05


def test_interp_and_batch_match_jax():
    x = np.stack([_voiced_tone(120.0, 0.2), _voiced_tone(200.0, 0.2)])
    out = ty.yaapt_f0_batch(x, interp=True, device="cpu")
    assert out.shape == (2, 1, x.shape[1] // 80)
    np.testing.assert_allclose(out, jy.yaapt_f0_batch(x, interp=True), rtol=1e-4)
    f0 = np.array([0.0, 100.0, 0.0, 0.0, 130.0, 0.0])
    np.testing.assert_array_equal(ty.interp_unvoiced(f0), jy.interp_unvoiced(f0))


def test_candidate_ties_follow_top_k_and_fillers_are_never_chosen():
    """Frames with fewer than 5 NCCF peaks are filled with merit -1.0.  The
    port orders those ties as ``lax.top_k`` does (lowest lag first), so its
    candidate f0s equal the JAX package's, fillers included; and a filler
    (emission cost 1e3) is never on the best path."""
    import jax.numpy as jnp

    x = _signals()["voiced_unvoiced"]
    sr, frame_len, hop = 16000, 320, 80
    xp = np.pad(x, (160, 160))
    xf = np.convolve(xp, ty._bandpass_fir(sr), mode="same").astype(np.float32)
    min_lag, max_lag = int(sr / ty.F0_MAX), int(np.ceil(sr / ty.F0_MIN))
    n_frames = 1 + (len(xp) - frame_len - max_lag) // hop
    nccf = ty._nccf(torch.from_numpy(xf), frame_len, hop, n_frames, min_lag, max_lag)
    # a plateau of equal values: a run of local-max ties beyond the fillers
    nccf[:3, 10:20] = 0.5
    f0, merits = ty._candidates(nccf, sr, min_lag, max_lag)
    jf0, jmerits = jy._candidates(jnp.asarray(nccf.numpy()), sr, min_lag, max_lag)
    # the same lags in the same order; merits and sr / lag to float32
    # rounding (XLA rounds the decay and the division differently)
    np.testing.assert_array_equal(np.rint(sr / f0.numpy()), np.rint(sr / np.asarray(jf0)))
    np.testing.assert_allclose(f0.numpy(), np.asarray(jf0), rtol=1e-6)
    np.testing.assert_allclose(merits.numpy(), np.asarray(jmerits), rtol=0, atol=1e-6)
    fillers = merits.numpy() == -1.0
    assert fillers.any(axis=1).sum() > 0

    energy = torch.ones(n_frames)
    zeros = torch.zeros(n_frames)
    # a voicing score that makes every frame with a real peak voiced
    emis = ty._emissions(f0, merits, energy, zeros, zeros, torch.full((n_frames,), 10.0))
    states = ty._viterbi_states(emis.numpy(), torch.log2(f0.clamp(min=1.0)).numpy())
    # the backtrack reports frame t+1's state at t (as the JAX scan does)
    frame = np.minimum(np.arange(n_frames) + 1, n_frames - 1)
    has_peak = (merits.numpy() > 0).any(axis=1)[frame]
    voiced = states < ty.N_CANDS
    np.testing.assert_array_equal(voiced, has_peak)
    assert (fillers[frame] & voiced[:, None]).any()  # fillers beside the chosen states
    assert (merits.numpy()[frame[voiced], states[voiced]] > 0).all()
