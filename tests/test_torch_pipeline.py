"""Port's ConversionPipeline vs the JAX package's, loaded from the same files.

The artifact layout of ``tests/test_pipeline.py``'s fixture
(``id_to_spkr.pkl``, ``f0_stats.pkl``, prosody and vocoder checkpoint
dirs, written by the JAX package's ``save_checkpoint``), loaded by both
packages.  Waveforms must have the same length
and agree within 1e-4; the prosody stage's units are equal exactly.
``convert(wav)`` runs a tiny HuBERT whose front end downsamples 320x, as
HuBERT-base does, on a 22.05 kHz input (so the resampler runs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pipeline import SPEAKERS, _record
from test_torch_hifigan import random_generator_params
from test_torch_prosody import random_variables

from dissc_tpu.core.config import VocoderConfig
from dissc_tpu.models import hubert as jhub
from dissc_tpu.models.prosody import LenPredictor
from dissc_tpu.pipeline import ConversionPipeline as JaxPipeline
from dissc_tpu.train.checkpoints import save_checkpoint
from dissc_tpu.train.prosody_trainer import build_pitch_model
from dissc_tpu_torch import ConversionPipeline
from dissc_tpu_torch.models import hubert as thub

torch.set_num_threads(2)
VOCODER = {"upsample_initial_channel": 32, "embedding_dim": 8, "model_in_dim": 17}


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The layout of ``tests/test_pipeline.py``'s fixture, with numpy-drawn
    weights in the flax shapes (no flax init is compiled)."""
    import json
    import pickle

    root = tmp_path_factory.mktemp("pipe")
    with open(root / "id_to_spkr.pkl", "wb") as f:
        pickle.dump(SPEAKERS, f)
    with open(root / "f0_stats.pkl", "wb") as f:
        pickle.dump({s: {"mean": 140.0 + 10 * i, "std": 15.0 + i}
                     for i, s in enumerate(SPEAKERS)}, f)
    ids = lambda L: jnp.zeros((1, L), jnp.int32)  # noqa: E731
    for name, model, args, extra in [
            ("len", LenPredictor(n_tokens=100, n_speakers=len(SPEAKERS)), (ids(16), ids(1)),
             ((np.float32(4.0), np.float32(2.0)),)),
            ("pitch", build_pitch_model("new", 100, len(SPEAKERS)), (ids(32), ids(1)), ())]:
        (root / name).mkdir()
        save_checkpoint(str(root / name / "best_model.pth"),
                        random_variables(model, *args, *extra, seed=len(name)))
    save_checkpoint(str(root / "len" / "len_norm_stats.pth"), (4.0, 2.0))
    (root / "vocoder").mkdir()
    with open(root / "vocoder" / "config.json", "w") as f:
        json.dump(VOCODER, f)
    save_checkpoint(str(root / "vocoder" / "g_00000000"),
                    {"generator": random_generator_params(VocoderConfig(**VOCODER), seed=1)})
    return root

HUBERT_320X = dict(conv_dim=(16, 16, 16), conv_kernel=(10, 8, 8), conv_stride=(5, 8, 8),
                   hidden_size=24, num_layers=2, num_heads=4, intermediate_size=48,
                   conv_pos_kernel=16, conv_pos_groups=2, output_layer=2)


def _load_both(artifacts, **kw):
    paths = dict(vocoder_ckpt=str(artifacts / "vocoder"),
                 id_to_spkr=str(artifacts / "id_to_spkr.pkl"))
    paths.update({k: str(artifacts / v) for k, v in kw.pop("paths", {}).items()})
    return JaxPipeline.load(**paths, **kw), ConversionPipeline.load(**paths, device="cpu", **kw)


FULL = {"len_model_dir": "len", "f0_model_dir": "pitch", "f0_stats": "f0_stats.pkl"}


@pytest.fixture(scope="module")
def pipes(artifacts):
    return _load_both(artifacts, paths=FULL)


def _same_wavs(out, ref):
    assert [w.shape for w in out] == [w.shape for w in ref]
    for w, rw in zip(out, ref):
        assert np.isfinite(w).all()
        assert np.abs(w - rw).max() < 1e-4


@pytest.mark.parametrize("renorm_f0", [False, True])
def test_convert_record_matches_jax(pipes, renorm_f0):
    jpipe, tpipe = pipes
    rec = _record(np.random.default_rng(0), "p231")
    ref = jpipe.prosody.convert_records([rec], jpipe.spk_dict, "p245", norm_pitch=True)[0]
    out = tpipe.prosody.convert_records([rec], tpipe.spk_dict, "p245", norm_pitch=True)[0]
    assert out["units"] == ref["units"]
    (w, sr), (rw, rsr) = (p.convert_record(rec, "p245", renorm_f0=renorm_f0) for p in pipes[::-1])
    assert sr == rsr == 16000
    assert w.size == 320 * len(out["units"])
    _same_wavs([w], [rw])


def test_convert_batch_matches_jax(pipes):
    rng = np.random.default_rng(2)
    recs = [_record(rng, s, n=16 + 4 * i) for i, s in enumerate(SPEAKERS)]
    (wavs, _), (ref, _) = (p.convert_batch(recs, "p231") for p in pipes[::-1])
    assert len(wavs) == 3
    _same_wavs(wavs, ref)


@pytest.mark.parametrize("norm_pitch,stats", [(True, True), (False, False)])
def test_heuristic_pitch_path_matches_jax(artifacts, norm_pitch, stats):
    """No pitch model: the source contour re-timed, whitened by the source
    speaker's stats when ``norm_pitch`` (which then needs the stats)."""
    paths = {"len_model_dir": "len", **({"f0_stats": "f0_stats.pkl"} if stats else {})}
    jpipe, tpipe = _load_both(artifacts, paths=paths, norm_pitch=norm_pitch)
    assert tpipe.prosody.pitch_model is None
    rec = _record(np.random.default_rng(7), "p231")
    (w, _), (rw, _) = (p.convert_record(rec, "p245") for p in (tpipe, jpipe))
    _same_wavs([w], [rw])


def test_heuristic_norm_pitch_without_stats_is_a_clean_error(artifacts):
    _, tpipe = _load_both(artifacts, paths={"len_model_dir": "len"})
    rec = _record(np.random.default_rng(8), "p231")
    with pytest.raises(ValueError, match="f0 statistics"):
        tpipe.convert_record(rec, "p245")
    with pytest.raises(KeyError):
        tpipe.convert_record(rec, "nobody")
    with pytest.raises(RuntimeError, match="hubert_weights"):
        tpipe.encode(np.zeros(16000, np.float32))


def test_convert_wav_matches_jax(pipes, tmp_path):
    """wav in, wav out, with a tiny HuBERT from the JAX package's loader
    files; the input is at 22.05 kHz and is resampled to 16 kHz first."""
    jpipe, tpipe = pipes
    jcfg, tcfg = jhub.HubertConfig(**HUBERT_320X), thub.HubertConfig(**HUBERT_320X)
    shapes = jax.eval_shape(jhub.HubertEncoder(jcfg).init, jax.random.key(0),
                            jnp.zeros((1, 3200)))["params"]
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: ((1.0 if path[-1].key in ("scale", "g") else 0.0)
                         + rng.standard_normal(s.shape)
                         * (1 / np.sqrt(np.prod(s.shape[:-1])) if path[-1].key in ("kernel", "v")
                            else 0.1)).astype(np.float32), shapes)
    sr = 22050
    t = np.arange(int(0.6 * sr)) / sr
    wav = (0.4 * np.sin(2 * np.pi * 150 * t) + 0.2 * np.sin(2 * np.pi * 300 * t)
           ).astype(np.float32)
    encode = jax.jit(jhub.HubertEncoder(jcfg).apply)
    feats = np.asarray(encode({"params": params}, jnp.zeros((1, 16000))))[0]
    codebook = (feats[::5][:10] + rng.standard_normal((10, 24)) * 0.5).astype(np.float32)
    save_checkpoint(str(tmp_path / "hubert.pkl"), params)
    np.save(tmp_path / "km.npy", codebook)
    jpipe.encoder = jhub.SpeechUnitEncoder(params, codebook, jcfg)
    tpipe.encoder = thub.load_encoder(str(tmp_path / "hubert.pkl"), str(tmp_path / "km.npy"),
                                      tcfg, device="cpu")
    rec, ref_rec = tpipe.encode(wav, sr), jpipe.encode(wav, sr)
    assert rec["units"] == ref_rec["units"]
    np.testing.assert_allclose(rec["f0"], ref_rec["f0"], rtol=1e-4)
    (w, _), (rw, _) = (p.convert(wav, "p270", sr=sr, source_speaker="p231")
                       for p in (tpipe, jpipe))
    _same_wavs([w], [rw])
