"""The port's ``ops``, ``utils``, ``core``, ``data`` and ``losses`` namespaces
against the JAX package's, and the modules behind the new names
(``core.masking``, ``utils.profiling``) against theirs on the same inputs.

Where the port's name differs (the fused log-mel K1: Pallas in the JAX
package, CUDA here) ``dissc_tpu_torch.ops.RENAMED`` says so.  The JAX
``utils.enable_compilation_cache`` (XLA's persistent cache) has no
counterpart: the port compiles only its CUDA kernels, which
``kernels/build.py`` caches under ``build/``.
"""
import importlib
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dissc_tpu.ops as jax_ops
import dissc_tpu_torch.ops as ops
from dissc_tpu.core import masking as jax_masking
from dissc_tpu.utils import profiling as jax_profiling
from dissc_tpu_torch.core import masking
from dissc_tpu_torch.utils import profiling

NO_COUNTERPART = {"utils": {"enable_compilation_cache"}}


def test_ops_covers_every_jax_op_and_adds_none():
    want = {ops.RENAMED.get(name, name) for name in jax_ops.__all__}
    assert set(ops.__all__) == want
    assert set(ops.RENAMED) <= set(jax_ops.__all__)
    for name in ops.__all__:
        assert callable(getattr(ops, name)), name


@pytest.mark.parametrize("name,module", [
    ("mel_spectrogram", "audio.mel"), ("mel_spectrogram_kernel", "kernels.mel_kernel"),
    ("mel_spectrogram_grad", "kernels.mel_kernel"), ("yaapt_f0_batch", "audio.yaapt"),
    ("repeat_interleave_padded", "core.seqops"), ("kmeans_quantize", "models.hubert"),
    ("fold_weight_norm", "models.layers")])
def test_ops_names_are_the_implementations(name, module):
    impl = importlib.import_module(f"dissc_tpu_torch.{module}")
    assert getattr(ops, name) is getattr(impl, name)


def test_ops_whisper_log_mel_is_the_whisper_front_end():
    from dissc_tpu_torch.models.whisper import log_mel_spectrogram

    assert ops.whisper_log_mel is log_mel_spectrogram


def _public(module):
    """Its public names, less submodules (which any import may add)."""
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)} - {"annotations"}


@pytest.mark.parametrize("namespace", ["utils", "core", "data", "losses"])
def test_namespace_exports_every_jax_name(namespace):
    jax_ns = importlib.import_module(f"dissc_tpu.{namespace}")
    port_ns = importlib.import_module(f"dissc_tpu_torch.{namespace}")
    want = _public(jax_ns) - NO_COUNTERPART.get(namespace, set())
    assert want
    missing = {n for n in want if not hasattr(port_ns, n)}
    assert not missing, missing


def test_core_exports_its_submodules_as_jax_does():
    import dissc_tpu_torch.core as core

    assert core.masking is masking and core.seqops.__name__ == "dissc_tpu_torch.core.seqops"


def _mask_inputs():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 5, (3, 7))
    lengths = np.array([0, 3, 7])
    x = rng.standard_normal((3, 7)).astype(np.float32)
    return labels, lengths, x


@pytest.mark.parametrize("fn", ["pad_mask", "length_mask", "masked_sum", "masked_mean"])
def test_masking_matches_jax(fn):
    labels, lengths, x = _mask_inputs()
    if fn == "pad_mask":
        args = (labels, 4), (torch.from_numpy(labels), 4)
    elif fn == "length_mask":
        args = (jnp.asarray(lengths), 7), (torch.from_numpy(lengths), 7)
    else:
        mask = np.arange(7)[None, :] < lengths[:, None]
        args = ((jnp.asarray(x), jnp.asarray(mask)),
                (torch.from_numpy(x), torch.from_numpy(mask)))
    ref = np.asarray(getattr(jax_masking, fn)(*args[0]))
    out = getattr(masking, fn)(*args[1]).numpy()
    assert out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_masked_mean_of_an_empty_mask_is_zero_as_in_jax():
    x, mask = np.ones((2, 3), np.float32), np.zeros((2, 3), bool)
    ref = float(jax_masking.masked_mean(jnp.asarray(x), jnp.asarray(mask)))
    assert float(masking.masked_mean(torch.from_numpy(x), torch.from_numpy(mask))) == ref == 0.0


class _Clock:
    """A stand-in for ``time.time`` that steps by a fixed list of gaps."""

    def __init__(self, gaps):
        self.now, self.gaps = 100.0, list(gaps)

    def __call__(self):
        t = self.now
        if self.gaps:
            self.now += self.gaps.pop(0)
        return t


def _meter_run(module, monkeypatch):
    monkeypatch.setattr(module.time, "time", _Clock([0.5, 0.0, 0.25, 0.0, 0.0, 0.0]))
    meter = module.RTFMeter(sampling_rate=16000)
    for n in (16000, 8000, 0):
        with meter.measure(n):
            pass
    return meter


def test_rtf_meter_matches_jax(monkeypatch):
    ref, out = _meter_run(jax_profiling, monkeypatch), _meter_run(profiling, monkeypatch)
    assert (out.compute_s, out.audio_s, out.rtf) == (ref.compute_s, ref.audio_s, ref.rtf)
    assert out.per_item == ref.per_item and len(out.per_item) == 3


def test_rtf_meter_synchronises_the_card_at_both_ends(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append("sync"))
    meter = profiling.RTFMeter()
    with meter.measure(16000):
        calls.append("work")
    assert calls == ["sync", "work", "sync"]


def test_trace_if_enabled_writes_a_trace_only_when_asked(tmp_path, monkeypatch):
    monkeypatch.delenv(profiling.TRACE_DIR_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.trace_if_enabled("off"):
        torch.ones(8).sum()
    assert not any(tmp_path.rglob("*"))
    monkeypatch.setenv(profiling.TRACE_DIR_ENV, str(tmp_path / "traces"))
    with profiling.trace_if_enabled("step"):
        torch.ones(8).sum()
    files = list((tmp_path / "traces" / "step").glob("*.pt.trace.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
