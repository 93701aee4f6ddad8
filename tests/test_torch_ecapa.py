"""Port's ECAPA-TDNN speaker embedder vs ``dissc_tpu.models.ecapa``.

At the reduced width the JAX package's fidelity test uses (64 channels,
SE / attention 16, 24-d output, 20 mels): embeddings from weights drawn
with numpy into the flax shapes and carried by ``compat.from_jax``, and
from a synthetic speechbrain-keyed state dict (loaded strictly by the
port, converted by the JAX ``convert_speechbrain_state_dict``), within
1e-4; the fbank front end within 1e-3 absolute on tones plus noise (the
JAX fbank takes numpy's real FFT, the port the DFT product); and
``EcapaEmbedder`` on a WAV at ``EcapaConfig()``'s 80 mels.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissc_tpu.models import ecapa as jecapa
from dissc_tpu_torch.compat import to_jax
from dissc_tpu_torch.compat.from_jax import ecapa_state_dict
from dissc_tpu_torch.core.wav import read_audio, write_wav
from dissc_tpu_torch.models import ecapa as tecapa

torch.set_num_threads(2)
SMALL = dict(channels=64, se_channels=16, attention_channels=16, lin_neurons=24, n_mels=20)


def random_ecapa_variables(cfg, seed=0):
    """Seeded numpy weights in the flax ``EcapaTDNN`` shapes: convs
    U(+-1/sqrt(fan_in)), BatchNorm scales near 1 and non-trivial running
    statistics."""
    shapes = jax.eval_shape(jecapa.EcapaTDNN(cfg).init, jax.random.key(0),
                            jnp.zeros((1, 30, cfg.n_mels)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return rng.uniform(-bound, bound, s.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)  # bias, mean

    v = jax.tree_util.tree_map_with_path(draw, shapes)
    return v["params"], v["batch_stats"]


def _jax_embed(cfg, params, stats, feats):
    return np.asarray(jax.jit(jecapa.EcapaTDNN(cfg).apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(feats)))


def _feats(cfg, seed=2):
    return np.random.default_rng(seed).standard_normal((2, 50, cfg.n_mels)).astype(np.float32)


def test_ecapa_matches_jax_and_carries_both_ways():
    cfg = jecapa.EcapaConfig(**SMALL)
    params, stats = random_ecapa_variables(cfg)
    feats = _feats(cfg)
    ref = _jax_embed(cfg, params, stats, feats)
    model = tecapa.EcapaTDNN(tecapa.EcapaConfig(**SMALL)).eval()
    model.load_state_dict(ecapa_state_dict(params, stats))
    with torch.no_grad():
        out = model(torch.from_numpy(feats)).numpy()
    assert out.shape == (2, 24)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)

    back_params, back_stats = to_jax.ecapa_variables(model.state_dict())
    for a, b in ((params, back_params), (stats, back_stats)):
        flat_a = jax.tree_util.tree_leaves_with_path(a)
        flat_b = dict(jax.tree_util.tree_leaves_with_path(b))
        assert len(flat_a) == len(flat_b)
        for path, leaf in flat_a:
            np.testing.assert_array_equal(flat_b[path], leaf, err_msg=str(path))


def test_speechbrain_keyed_state_dict_loads_strictly_and_matches_the_jax_converter():
    cfg = tecapa.EcapaConfig(**SMALL)
    rng = np.random.default_rng(3)
    sd = {}
    for key, ref in tecapa.EcapaTDNN(cfg).state_dict().items():
        shape = tuple(ref.shape)
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.tensor(7)
        elif key.endswith("running_var"):
            sd[key] = torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(np.float32))
        elif key.endswith("norm.weight") or key == "asp_bn.weight":
            sd[key] = torch.from_numpy((1 + 0.1 * rng.standard_normal(shape)).astype(np.float32))
        elif key.endswith("weight"):
            bound = 1.0 / np.sqrt(np.prod(shape[1:]))
            sd[key] = torch.from_numpy(rng.uniform(-bound, bound, shape).astype(np.float32))
        else:
            sd[key] = torch.from_numpy((0.1 * rng.standard_normal(shape)).astype(np.float32))
    # speechbrain's layout, as the JAX converter reads it
    assert {"blocks.0.conv.conv.weight", "blocks.1.res2net_block.blocks.6.norm.norm.running_var",
            "blocks.3.se_block.conv2.conv.bias", "asp.conv.conv.weight", "asp_bn.weight",
            "fc.conv.weight"} <= set(sd)
    model = tecapa.EcapaTDNN(cfg).eval()
    model.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(
        model.state_dict()["asp_bn.running_mean"].numpy(), sd["asp_bn.running_mean"].numpy())
    converted = tecapa.convert_speechbrain_state_dict(dict(sd, extra=torch.zeros(1)), cfg)
    assert set(converted) == set(sd)

    jcfg = jecapa.EcapaConfig(**SMALL)
    params, stats = jecapa.convert_speechbrain_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jcfg)
    feats = _feats(jcfg, seed=4)
    ref = _jax_embed(jcfg, params, stats, feats)
    with torch.no_grad():
        out = model(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)

    with pytest.raises(KeyError, match="asp_bn.weight"):
        tecapa.convert_speechbrain_state_dict(
            {k: v for k, v in sd.items() if k != "asp_bn.weight"}, cfg)
    with pytest.raises(ValueError, match="fc.conv.weight"):
        tecapa.convert_speechbrain_state_dict(dict(sd, **{"fc.conv.weight": torch.zeros(1)}), cfg)


def _tones(seconds=1.3, sr=16000, seed=5):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = sum(a * np.sin(2 * np.pi * f * t) for a, f in ((0.4, 140.0), (0.2, 620.0), (0.1, 2300.0)))
    return (x + 0.02 * rng.standard_normal(t.shape)).astype(np.float32)


def test_fbank_features_match_jax():
    wav = _tones()
    ref = jecapa.fbank_features(wav)
    out = tecapa.fbank_features(wav, device="cpu").numpy()
    assert out.shape == ref.shape == (1 + (len(wav) + 2 * 176 - 512) // 160, 80)
    np.testing.assert_allclose(out, ref, atol=1e-3)


def test_embedder_on_a_wav_matches_jax(tmp_path):
    cfg = dataclasses.replace(jecapa.EcapaConfig(), **{k: v for k, v in SMALL.items()
                                                      if k != "n_mels"})
    params, stats = random_ecapa_variables(cfg, seed=6)
    path = str(tmp_path / "a.wav")
    write_wav(path, _tones(seconds=0.9, seed=7), 16000)
    wav = read_audio(path, dtype="float32")[0]
    ref = jecapa.EcapaEmbedder(params, stats, cfg)(wav)
    tcfg = tecapa.EcapaConfig(**{k: v for k, v in SMALL.items() if k != "n_mels"})
    out = tecapa.EcapaEmbedder(ecapa_state_dict(params, stats), tcfg, device="cpu")(wav)
    assert out.shape == ref.shape == (24,) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
