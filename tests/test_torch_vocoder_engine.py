"""Port's VocoderEngine vs the JAX VocoderEngine on the same items.

Buckets (8, 16), exact lengths on and off, f0 at the code rate and at
twice it, and one item past the last bucket that streams in chunks of
24 frames.  Outputs must have the JAX engine's lengths and agree to
1e-4 (f32 convs in another order).
"""
import json
import os

import numpy as np
import pytest
import torch

from dissc_tpu.core.config import VocoderConfig as JaxConfig
from dissc_tpu.infer.vocoder import VocoderEngine as JaxEngine
from dissc_tpu.train.checkpoints import save_checkpoint
from dissc_tpu_torch.compat.from_jax import generator_state_dict
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.infer.streaming import receptive_field_frames
from dissc_tpu_torch.infer.vocoder import VocoderEngine
from test_torch_hifigan import SMALL, random_generator_params

torch.set_num_threads(2)


def _items(seed=0):
    rng = np.random.default_rng(seed)
    items = []
    for T, r, spk in [(3, 1, 0), (10, 1, 1), (16, 1, 2), (7, 2, 3), (80, 1, 4)]:
        items.append({"code": rng.integers(0, 100, T).astype(np.int32),
                      "f0": rng.normal(0, 1, (T * r, 1)).astype(np.float32),
                      "spkr": np.array([spk], np.int32)})
    return items


@pytest.mark.parametrize("exact_lengths", [False, True])
def test_engine_matches_jax_engine(exact_lengths):
    jh, th = JaxConfig(**SMALL), VocoderConfig(**SMALL)
    params = random_generator_params(jh, seed=2)
    kw = dict(frame_buckets=(8, 16), stream_chunk=24, exact_lengths=exact_lengths)
    # the 80-frame item streams, whatever exact_lengths says: once is enough
    items = _items() if not exact_lengths else _items()[:-1]
    ref, _ = JaxEngine(jh, params, **kw).synthesize_utterances(items, batch_size=2)
    engine = VocoderEngine(th, generator_state_dict(params, th), device="cpu", **kw)
    out, rtf = engine.synthesize_utterances(items, batch_size=2)
    assert rtf > 0
    assert [len(w) for w in out] == [len(w) for w in ref]
    assert [len(w) for w in out] == [960, 3200, 5120, 4480, 25600][:len(items)]
    for w, rw in zip(out, ref):
        assert np.abs(w - rw).max() < 1e-4
    assert (engine._streamer is not None) == (not exact_lengths)


def test_streamed_item_equals_monolithic_forward():
    th = VocoderConfig(**SMALL)
    engine = VocoderEngine(th, generator_state_dict(random_generator_params(JaxConfig(**SMALL)), th),
                           frame_buckets=(8, 16), stream_chunk=24, device="cpu")
    assert engine._streamer_for_long().context == 24 >= receptive_field_frames(th)
    item = _items()[-1]
    streamed, _ = engine.synthesize_utterances([item])
    with torch.no_grad():
        mono = engine.model(torch.from_numpy(item["code"][None]).long(),
                            torch.from_numpy(item["f0"][None]),
                            torch.from_numpy(item["spkr"][None]).long())[0].numpy()
    assert np.abs(streamed[0] - mono).max() < 1e-5


def test_checkpoint_written_by_the_port_reads_in_the_jax_package(tmp_path):
    from dissc_tpu.train.checkpoints import load_checkpoint as jax_load
    from dissc_tpu.train.checkpoints import scan_checkpoint as jax_scan
    from dissc_tpu_torch.train.checkpoints import save_checkpoint as port_save
    from dissc_tpu_torch.train.checkpoints import step_checkpoint_name

    tree = {"generator": {"conv_pre": {"bias": torch.arange(3.0)}}, "steps": 7}
    for step in (2, 10):
        port_save(os.path.join(tmp_path, step_checkpoint_name("do_", step)), tree)
    path = jax_scan(str(tmp_path), "do_")
    assert path.endswith("do_00000010")
    back = jax_load(path)
    assert back["steps"] == 7
    np.testing.assert_array_equal(back["generator"]["conv_pre"]["bias"], [0.0, 1.0, 2.0])


def test_from_checkpoint_reads_jax_written_files(tmp_path):
    """A g_ pickle and config.json written by the JAX package load into an
    engine that equals one built from the same tree directly (which the
    test above holds against the JAX engine)."""
    jh = JaxConfig(**SMALL)
    params = random_generator_params(jh, seed=3)
    save_checkpoint(os.path.join(tmp_path, "g_00000001"), {"generator": params})
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        json.dump(jh.to_dict(), f)
    engine = VocoderEngine.from_checkpoint(str(tmp_path), frame_buckets=(8, 16), device="cpu")
    assert engine.h.folded_weights
    th = VocoderConfig(**SMALL)
    direct = VocoderEngine(th, generator_state_dict(params, th), frame_buckets=(8, 16),
                           device="cpu")
    out, _ = engine.synthesize_utterances(_items()[:3])
    ref, _ = direct.synthesize_utterances(_items()[:3])
    for w, rw in zip(out, ref):
        assert w.shape == rw.shape and np.array_equal(w, rw)


@pytest.mark.parametrize("target", [7, "p2", "missing"])
def test_renorm_f0_matches_jax(target):
    from dissc_tpu.infer.vocoder import _renorm_f0
    from dissc_tpu_torch.infer.vocoder import renorm_f0

    f0 = np.abs(np.random.default_rng(4).normal(120, 30, (50, 1))).astype(np.float32)
    f0[::7] = 0.0  # unvoiced frames stay zero
    stats = {7: {"f0_mean": 210.0, "f0_std": 25.0}, "p2": {"mean": 95.0, "std": 12.0},
             "f0_mean": 150.0, "f0_std": 20.0}
    spkr_id = target if isinstance(target, int) else 99
    np.testing.assert_allclose(renorm_f0(f0, spkr_id, target, stats),
                               _renorm_f0(f0, spkr_id, target, stats), rtol=1e-6)
