"""Port's F0-VQ path vs ``dissc_tpu.models.{jukebox,vq}`` and the VQ branch of
``CodeGenerator``.

Weights are numpy draws into the flax shapes, carried by
``compat.from_jax``; the codebook state is given (``initted``, and counts
high enough that no code restarts), since the restart draws come from
each package's own PRNG.  ``Encoder``/``Decoder`` within 1e-5; one
``BottleneckBlock`` step (codes equal; codebook, EMA sums, counts, commit
loss and metrics within 1e-5) and its straight-through gradient against
``jax.grad``; ``Quantizer`` and the VQ ``CodeGenerator`` within 1e-4 of
``apply(mutable=["vq_state"])``, their updated codebooks too.  The restart
and the bootstrap are held to their structure: each drawn row is a data
row plus noise of std ``0.01 / sqrt(D)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissc_tpu.core.config import VocoderConfig as JaxConfig
from dissc_tpu.models import jukebox as jjuke
from dissc_tpu.models import vq as jvq
from dissc_tpu.models.hifigan import CodeGenerator as JaxCodeGenerator
from dissc_tpu_torch.compat import from_jax, to_jax
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.models import jukebox, vq
from dissc_tpu_torch.models.hifigan import CodeGenerator

torch.set_num_threads(2)

ENC = dict(input_emb_width=1, output_emb_width=8, levels=2, downs_t=[2, 1], strides_t=[2, 2],
           width=8, depth=2, m_conv=1.0, dilation_growth_rate=3)
DEC = dict(ENC, reverse_decoder_dilation=True)
QP = dict(f0_encoder_params=dict(ENC, levels=1, downs_t=[4], strides_t=[2]),
          f0_vq_params=dict(l_bins=6, emb_width=8, mu=0.99, levels=1),
          f0_decoder_params=dict(DEC, levels=1, downs_t=[4], strides_t=[2]))


def draw_like(shapes, seed):
    """Numpy draws into a flax shape tree: kernels U(+-1/sqrt(fan_in)),
    weight-norm gains 0.5, embeddings N(0, 1), biases N(0, 0.05)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name in ("kernel", "v"):
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return rng.uniform(-bound, bound, s.shape).astype(np.float32)
        scale = {"embedding": 1.0, "g": 0.5}.get(name, 0.05)
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def given_state(shapes, data, seed, counts=5.0):
    """An initialised codebook per level: rows near the data's spread, EMA
    sums matching, counts ``counts`` (mu * counts >= 1: nothing restarts)."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, st in shapes.items():
        k = (rng.standard_normal(st["k"].shape) * data.std()).astype(np.float32)
        state[name] = {"k": k, "k_sum": k * counts,
                       "k_elem": np.full(st["k_elem"].shape, counts, np.float32),
                       "initted": np.asarray(True)}
    return state


def _enc_dec(seed=0):
    x = np.random.default_rng(seed).standard_normal((2, 32, 1)).astype(np.float32)
    jenc, jdec = jjuke.Encoder(**ENC), jjuke.Decoder(**DEC)
    pe = draw_like(jax.eval_shape(jenc.init, jax.random.key(0), jnp.asarray(x))["params"], 1)
    xs = jenc.apply({"params": pe}, jnp.asarray(x))
    pd = draw_like(jax.eval_shape(jdec.init, jax.random.key(0), xs)["params"], 2)
    return x, pe, pd, [np.asarray(a) for a in xs], np.asarray(jdec.apply({"params": pd}, xs))


def test_encoder_and_decoder_match_jax_and_carry_both_ways():
    x, pe, pd, ref_xs, ref_y = _enc_dec()
    enc, dec = jukebox.Encoder(**ENC), jukebox.Decoder(**DEC)
    sd = from_jax.quantizer_state_dict({"encoder": pe, "decoder": pd}, {"vq": {}},
                                       dict(f0_encoder_params=ENC, f0_decoder_params=DEC))
    enc.load_state_dict({k[8:]: v for k, v in sd.items() if k.startswith("encoder.")})
    dec.load_state_dict({k[8:]: v for k, v in sd.items() if k.startswith("decoder.")})
    with torch.no_grad():
        xs = enc(torch.from_numpy(x).transpose(1, 2))
        y = dec(xs).transpose(1, 2).numpy()
    assert [tuple(a.shape) for a in xs] == [(2, 8, 8), (2, 8, 4)]
    for a, b in zip(xs, ref_xs):
        np.testing.assert_allclose(a.transpose(1, 2).numpy(), b, atol=1e-5)
    np.testing.assert_allclose(y, ref_y, atol=1e-5)
    # the reversed residual stack: the JAX block_1 runs first, as the torch model.0
    np.testing.assert_array_equal(
        sd["decoder.level_blocks.0.model.1.0.model.0.model.1.weight"].numpy(),
        np.asarray(pd["level_0"]["res_0"]["block_1"]["conv1"]["kernel"]).transpose(2, 1, 0))

    back, _ = to_jax.quantizer_trees(sd, dict(f0_encoder_params=ENC, f0_decoder_params=DEC))
    for tree, ref in ((back["encoder"], pe), (back["decoder"], pd)):
        got = dict(jax.tree_util.tree_leaves_with_path(tree))
        for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
            np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


def _bottleneck_case(seed=3, B=2, T=9, D=8, K=6):
    x = np.random.default_rng(seed).standard_normal((B, T, D)).astype(np.float32)
    blk = jvq.BottleneckBlock(K, D, 0.99)
    shapes = jax.eval_shape(blk.init, {"params": jax.random.key(0), "vq": jax.random.key(1)},
                            jnp.asarray(x))["vq_state"]
    state = given_state({"b": shapes}, x, seed + 1)["b"]
    return x, blk, state


def _port_block(state, K=6, D=8):
    blk = vq.BottleneckBlock(K, D, 0.99)
    blk.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state.items()})
    return blk


def test_bottleneck_step_matches_jax():
    x, jblk, state = _bottleneck_case()
    (codes, xq, commit, metrics), new = jblk.apply({"vq_state": state}, jnp.asarray(x),
                                                   rngs={"vq": jax.random.key(5)},
                                                   mutable=["vq_state"])
    blk = _port_block(state)
    t_codes, t_xq, t_commit, t_metrics = blk(torch.from_numpy(x).transpose(1, 2))
    np.testing.assert_array_equal(t_codes.numpy(), np.asarray(codes))
    np.testing.assert_allclose(t_xq.transpose(1, 2).detach().numpy(), np.asarray(xq), atol=1e-5)
    np.testing.assert_allclose(float(t_commit), float(commit), rtol=1e-5)
    assert set(t_metrics) == set(metrics) == {"fit", "pn", "entropy", "used_curr", "usage", "dk"}
    for k in metrics:
        np.testing.assert_allclose(float(t_metrics[k]), float(metrics[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    for k in ("k", "k_sum", "k_elem"):
        np.testing.assert_allclose(getattr(blk, k).numpy(), np.asarray(new["vq_state"][k]),
                                   atol=1e-5, err_msg=k)
    assert bool(blk.initted) and float(metrics["usage"]) == 6  # no restart drew a row


def test_straight_through_gradient_matches_jax():
    x, jblk, state = _bottleneck_case(seed=7)
    w = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)

    def jloss(xx):
        (_, xq, commit, _), _ = jblk.apply({"vq_state": state}, xx, rngs={"vq": jax.random.key(0)},
                                           mutable=["vq_state"])
        return jnp.sum(xq * w) + 0.02 * commit

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    _, xq, commit, _ = _port_block(state)(xt.transpose(1, 2))
    (torch.sum(xq.transpose(1, 2) * torch.from_numpy(w)) + 0.02 * commit).backward()
    np.testing.assert_allclose(xt.grad.numpy(), ref, atol=1e-5)


def _nearest_rows(rows, data):
    """Each row's nearest data row and the pooled per-entry std of the
    differences."""
    d = ((rows[:, None, :] - data[None]) ** 2).sum(-1)
    return d.argmin(1), float(np.sqrt(d.min(1).sum() / rows.size))


def test_bootstrap_and_restart_draw_data_rows_plus_noise(monkeypatch):
    D, K, mu = 64, 40, 0.99
    data = np.random.default_rng(9).standard_normal((2, D, 5)).astype(np.float32)  # 10 rows
    flat = data.transpose(0, 2, 1).reshape(-1, D)
    blk = vq.BottleneckBlock(K, D, mu)
    draws = []
    tile = blk._tile_to_bins
    monkeypatch.setattr(blk, "_tile_to_bins", lambda x, g: draws.append(tile(x, g)) or draws[-1])
    with torch.no_grad():
        codes, _, _, metrics = blk(torch.from_numpy(data), generator=torch.Generator().manual_seed(0))
    assert bool(blk.initted) and len(draws) == 2  # the bootstrap, then the restart rows
    sigma = 0.01 / np.sqrt(D)
    for rows in (d.numpy() for d in draws):
        near, std = _nearest_rows(rows, flat)
        assert np.bincount(near, minlength=10).tolist() == [4] * 10  # 10 rows tiled 4 times
        assert 0.8 * sigma < std < 1.2 * sigma
    k_init, k_rand = (d.numpy() for d in draws)
    onehot = np.eye(K, dtype=np.float32)[codes.numpy().reshape(-1)]
    k_sum = mu * k_init + (1 - mu) * onehot.T @ flat
    k_elem = mu + (1 - mu) * onehot.sum(0)
    np.testing.assert_allclose(blk.k_sum.numpy(), k_sum, atol=1e-6)
    np.testing.assert_allclose(blk.k_elem.numpy(), k_elem, atol=1e-6)
    used = k_elem >= 1.0
    assert 0 < used.sum() < K and float(metrics["usage"]) == used.sum()
    np.testing.assert_array_equal(blk.k.numpy()[~used], k_rand[~used])
    np.testing.assert_allclose(blk.k.numpy()[used], (k_sum / k_elem[:, None])[used], rtol=1e-6)


def _quantizer_case(seed=10):
    f0 = np.random.default_rng(seed).standard_normal((2, 48, 1)).astype(np.float32)
    jq = jvq.Quantizer(**QP)
    shapes = jax.eval_shape(jq.init, {"params": jax.random.key(0), "vq": jax.random.key(1)},
                            jnp.asarray(f0))
    params = draw_like(shapes["params"], seed + 1)
    enc = jjuke.Encoder(**QP["f0_encoder_params"]).apply({"params": params["encoder"]},
                                                         jnp.asarray(f0))
    state = {"vq": given_state(shapes["vq_state"]["vq"], np.asarray(enc[0]), seed + 2)}
    return f0, jq, params, state


def test_quantizer_matches_jax_and_its_tree_crosses_both_ways():
    f0, jq, params, state = _quantizer_case()
    (ref, commits, metrics), new = jq.apply({"params": params, "vq_state": state},
                                            jnp.asarray(f0), rngs={"vq": jax.random.key(3)},
                                            mutable=["vq_state"])
    model = vq.Quantizer(**QP)
    model.load_state_dict(from_jax.quantizer_state_dict(params, state, QP))
    out, t_commits, t_metrics = model(torch.from_numpy(f0).transpose(1, 2))
    np.testing.assert_allclose(out.transpose(1, 2).detach().numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(float(t_commits[0].detach()), float(commits[0]), rtol=1e-4)
    np.testing.assert_allclose(float(t_metrics[0]["entropy"]), float(metrics[0]["entropy"]),
                               rtol=1e-4)
    back_params, back_state = to_jax.quantizer_trees(model.state_dict(), QP)
    for k in ("k", "k_sum", "k_elem"):
        np.testing.assert_allclose(back_state["vq"]["level_0"][k],
                                   np.asarray(new["vq_state"]["vq"]["level_0"][k]), atol=1e-5)
    assert back_state["vq"]["level_0"]["initted"] == np.asarray(True)
    got = dict(jax.tree_util.tree_leaves_with_path(back_params))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))


VQ_GEN = dict(upsample_initial_channel=32, embedding_dim=8, model_in_dim=24, lambda_commit=0.02,
              f0_encoder_params=QP["f0_encoder_params"], f0_vq_params=QP["f0_vq_params"])


def test_config_with_lambda_commit_builds_the_f0_vq_branch():
    h = VocoderConfig(**VQ_GEN)
    model = CodeGenerator(h)
    keys = model.state_dict()
    assert "f0_encoder.level_blocks.0.model.4.weight" in keys  # the projection after 4 downs
    assert {"f0_vq.level_blocks.0.k", "f0_vq.level_blocks.0.initted"} <= set(keys)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VocoderConfig(lambda_commit_code=0.02)


def test_vq_code_generator_matches_jax_and_crosses_both_ways():
    jh, th = JaxConfig(**VQ_GEN), VocoderConfig(**VQ_GEN)
    rng = np.random.default_rng(12)
    code = rng.integers(0, 100, (2, 12)).astype(np.int32)
    f0 = rng.standard_normal((2, 48, 1)).astype(np.float32)
    spkr = np.array([[3], [150]], np.int32)
    jg = JaxCodeGenerator(jh)
    shapes = jax.eval_shape(jg.init, {"params": jax.random.key(0), "vq": jax.random.key(1)},
                            jnp.asarray(code), jnp.asarray(f0), jnp.asarray(spkr))
    params = draw_like(shapes["params"], 13)
    enc = jjuke.Encoder(**QP["f0_encoder_params"]).apply({"params": params["f0_encoder"]},
                                                         jnp.asarray(f0))
    state = {"f0_vq": given_state(shapes["vq_state"]["f0_vq"], np.asarray(enc[0]), 14)}
    apply = jax.jit(lambda v, *args: jg.apply(v, *args, rngs={"vq": jax.random.key(4)},
                                              mutable=["vq_state"]))
    (wav, commits, metrics), new = apply({"params": params, "vq_state": state},
                                         jnp.asarray(code), jnp.asarray(f0), jnp.asarray(spkr))
    model = CodeGenerator(th)
    model.load_state_dict(from_jax.generator_state_dict(params, th, state))
    with torch.no_grad():
        t_wav, t_commits, _ = model(torch.from_numpy(code).long(), torch.from_numpy(f0),
                                    torch.from_numpy(spkr).long())
    assert t_wav.shape == (2, 12 * 320)
    np.testing.assert_allclose(t_wav.numpy(), np.asarray(wav), atol=1e-4)
    np.testing.assert_allclose(float(t_commits[0]), float(commits[0]), rtol=1e-4)
    np.testing.assert_allclose(model.f0_vq.level_blocks[0].k.numpy(),
                               np.asarray(new["vq_state"]["f0_vq"]["level_0"]["k"]), atol=1e-5)

    sd = model.state_dict()
    back = to_jax.generator_tree(sd, th)
    assert set(back) == set(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back["f0_encoder"]))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params["f0_encoder"]):
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))
    vq_back = to_jax.vq_state_tree(sd, "f0_vq")
    np.testing.assert_array_equal(vq_back["level_0"]["k_elem"], sd["f0_vq.level_blocks.0.k_elem"])


def test_trainer_and_engine_refuse_a_vq_config(tmp_path):
    from dissc_tpu_torch.infer.vocoder import VocoderEngine
    from dissc_tpu_torch.train.vocoder_trainer import GANTrainer, train_vocoder

    h = VocoderConfig(**VQ_GEN)
    for call in (lambda: GANTrainer(h, device="cpu"), lambda: VocoderEngine(h, {}, device="cpu"),
                 lambda: train_vocoder(h, str(tmp_path / "ckpt"), device="cpu")):
        with pytest.raises(NotImplementedError, match="lambda_commit"):
            call()
    assert not (tmp_path / "ckpt").exists()
