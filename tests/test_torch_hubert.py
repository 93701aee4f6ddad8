"""Port's HuBERT encoder and unit encoder vs the JAX package's, same weights.

The tiny config of ``tests/test_hubert.py``.  Weights: numpy draws into
the flax parameter shapes, carried by ``compat.from_jax.hubert_state_dict``.
Tolerances: features within 1e-4 (float32; flax takes norm variances as
E[x^2] - E[x]^2, torch about the mean); units equal except on frames whose
two nearest JAX distances lie within 1e-5 of each other, which are counted
and must be at most 1 %.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissc_tpu.models import hubert as jhub
from dissc_tpu_torch.compat.from_jax import hubert_state_dict
from dissc_tpu_torch.models import hubert as thub

torch.set_num_threads(2)

TINY = dict(conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2), hidden_size=24,
            num_layers=2, num_heads=4, intermediate_size=48, conv_pos_kernel=16,
            conv_pos_groups=2, output_layer=2)


def random_hubert_params(cfg, seed=0):
    shapes = jax.eval_shape(jhub.HubertEncoder(cfg).init, jax.random.key(0),
                            jnp.zeros((1, 400)))["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name in ("kernel", "v"):
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
                    ).astype(np.float32)
        base = 1.0 if name in ("scale", "g") else 0.0
        return (base + rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _wav(n=2, T=3200, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 16000
    tone = 0.3 * np.sin(2 * np.pi * 140 * t) + 0.15 * np.sin(2 * np.pi * 280 * t)
    return (tone[None] + 0.05 * rng.standard_normal((n, T))).astype(np.float32)


def _near_ties(feats, codebook, tol=1e-5):
    d = (np.sum(feats ** 2, -1, keepdims=True) - 2 * feats @ codebook.T
         + np.sum(codebook ** 2, -1))
    two = np.sort(d, axis=-1)[..., :2]
    return (two[..., 1] - two[..., 0]) <= tol


@pytest.mark.parametrize("output_layer", [2, 1])
def test_encoder_features_and_units_match_jax(output_layer):
    jcfg = jhub.HubertConfig(**{**TINY, "output_layer": output_layer})
    tcfg = thub.HubertConfig(**{**TINY, "output_layer": output_layer})
    params = random_hubert_params(jcfg)
    wav = _wav()
    ref = np.asarray(jax.jit(jhub.HubertEncoder(jcfg).apply)({"params": params}, jnp.asarray(wav)))
    model = thub.HubertEncoder(tcfg)
    assert len(model.encoder.layers) == output_layer  # layers past it are not built
    model.load_hf_state_dict(hubert_state_dict(params, tcfg))
    with torch.no_grad():
        feats = model.eval()(torch.from_numpy(wav))
    assert feats.shape == ref.shape
    assert np.abs(feats.numpy() - ref).max() < 1e-4

    codebook = ref.reshape(-1, ref.shape[-1])[:: 7][:10] + 0.01  # centroids near the data
    ref_units = np.asarray(jhub.kmeans_quantize(jnp.asarray(ref), jnp.asarray(codebook)))
    units = thub.kmeans_quantize(feats, torch.from_numpy(codebook)).numpy()
    ties = _near_ties(ref.astype(np.float64), codebook.astype(np.float64))
    assert ties.mean() <= 0.01
    np.testing.assert_array_equal(units[~ties], ref_units[~ties])
    assert len(np.unique(ref_units)) > 2  # the codebook is not degenerate


def test_hubert_state_dict_inverts_convert_hf_state_dict():
    """HF HubertModel keys -> JAX tree -> HF keys gives the same tensors."""
    cfg = jhub.HubertConfig(**TINY)
    params = random_hubert_params(cfg, seed=2)
    sd = hubert_state_dict(params, thub.HubertConfig(**TINY))
    back = jhub.convert_hf_state_dict({k: v.numpy() for k, v in sd.items()}, cfg)
    flat = jax.tree_util.tree_leaves_with_path(params)
    for path, leaf in flat:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)


def test_speech_unit_encoder_and_loader_match_jax(tmp_path):
    """The JAX package's loader files (param pickle + .npy codebook) read by
    the port's ``load_encoder``; units and 50 Hz f0 vs the JAX encoder."""
    from dissc_tpu.train.checkpoints import save_checkpoint

    jcfg, tcfg = jhub.HubertConfig(**TINY), thub.HubertConfig(**TINY)
    params = random_hubert_params(jcfg, seed=3)
    wav = _wav(n=1, T=3200)[0]
    encode = jax.jit(jhub.HubertEncoder(jcfg).apply)
    feats = np.asarray(encode({"params": params}, jnp.asarray(wav[None])))
    codebook = feats[0, ::27][:12] + 0.01
    save_checkpoint(str(tmp_path / "hubert.pkl"), {"params": params})
    np.save(tmp_path / "km.npy", codebook)
    ref = jhub.SpeechUnitEncoder(params, codebook, jcfg)(wav)
    enc = thub.load_encoder(str(tmp_path / "hubert.pkl"), str(tmp_path / "km.npy"), tcfg,
                            device="cpu")
    out = enc(wav)
    ties = _near_ties(feats[0].astype(np.float64), codebook.astype(np.float64))
    assert ties.mean() <= 0.01
    units, ref_units = np.asarray(out["units"]), np.asarray(ref["units"])
    np.testing.assert_array_equal(units[~ties], ref_units[~ties])
    f0, ref_f0 = np.asarray(out["f0"]), np.asarray(ref["f0"])
    np.testing.assert_array_equal(f0 == 0, ref_f0 == 0)
    np.testing.assert_allclose(f0, ref_f0, rtol=1e-4)
    # the tiny front end runs at 1.6 kHz, so only the first 10 units (40
    # f0 frames of 5 ms) have f0 to take; the tone is tracked there
    assert (ref_f0[:10] > 0).mean() > 0.7

