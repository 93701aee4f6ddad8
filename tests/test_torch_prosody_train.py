"""Port's prosody training (losses, train steps, trainers) vs the JAX package's.

* Losses: the same numpy-drawn predictions and targets through both
  packages, rtol 1e-6.
* One train step of ``LenPredictor``, ``PitchPredictor`` and
  ``PitchPredictorBase`` against ``make_len_steps``/``make_pitch_steps``,
  from the same numpy-drawn variables (emb 8, hidden 16, batch 4 with pad
  rows and slots), masking rate 0 and PE dropout 0 (JAX draws its masks
  from its own PRNG, so only the deterministic step can be held equal):
  loss rtol 1e-5, updated parameters and ``batch_stats`` atol 1e-5.  The
  bias of a conv that feeds a BatchNorm has a gradient of exactly 0 (the
  norm removes it), so each framework's is rounding noise, and Adam's first
  step moves it by up to ``lr`` with that noise's sign; for those biases
  the test holds the gradient at noise level and the move within ``lr``.
* The token mask and PE dropout, in the port alone: the share of zeroed
  positions within 3 sigma of the rate over a seeded draw, whole vectors
  zeroed, the same draw from the same seed.
* The trainers on a toy corpus: ``best_model.pth`` and
  ``len_norm_stats.pth`` load in both packages' ``ProsodyConverter.load``
  and convert to the same units and durations (exact) and f0 (1e-4).
"""
import functools
import importlib
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dissc_tpu.core.config import ProsodyConfig as JaxProsodyConfig
from dissc_tpu.infer import prosody as jinfer
from dissc_tpu.models import prosody as jmodels
from dissc_tpu.train import prosody_trainer as jtrain
from dissc_tpu_torch.compat.from_jax import len_predictor_state_dict, pitch_predictor_state_dict
from dissc_tpu_torch.compat.to_jax import len_predictor_variables, pitch_predictor_variables
from dissc_tpu_torch.core.config import ProsodyConfig
from dissc_tpu_torch.infer import prosody as tinfer
from dissc_tpu_torch.losses import len_loss as tlen
from dissc_tpu_torch.losses import pitch_loss as tpitch
from dissc_tpu_torch.models.prosody import LenPredictor, _mask_embeddings
from dissc_tpu_torch.train import prosody_trainer as ttrain
from test_torch_prosody import random_variables

# the JAX losses package re-exports functions under its modules' names
jlen = importlib.import_module("dissc_tpu.losses.len_loss")
jpitch = importlib.import_module("dissc_tpu.losses.pitch_loss")

torch.set_num_threads(2)
N_SPK, B, L = 5, 4, 24
LR = 3e-4


def _len_batch(seed=3):
    rng = np.random.default_rng(seed)
    vals = np.full((B, L), 100, np.int32)
    lens = np.full((B, L), -1, np.float32)
    for b, n in enumerate([24, 17, 9, 0]):  # a full row, two padded, one all pad
        vals[b, :n] = rng.integers(0, 100, n)
        lens[b, :n] = rng.integers(1, 9, n)
    return vals, lens, (np.arange(B) % N_SPK)[:, None].astype(np.int32)


def _pitch_batch(seed=4):
    rng = np.random.default_rng(seed)
    vals, _, spk = _len_batch(seed)
    gts = np.full((B, L), -100, np.float32)
    for b, n in enumerate([24, 17, 9, 0]):
        g = rng.normal(0, 1, n).astype(np.float32)
        g[rng.random(n) < 0.3] = 0
        gts[b, :n] = g
    id2mean = rng.uniform(100, 200, N_SPK).astype(np.float32)
    id2std = rng.uniform(10, 30, N_SPK).astype(np.float32)
    return vals, gts, spk, id2mean, id2std


@pytest.mark.parametrize("name", ["len_mse_loss", "len_mae_loss", "len_smooth_l1_loss",
                                  "len_sum_loss", "len_exact_accuracy",
                                  "len_one_off_accuracy"])
def test_len_losses_match_jax(name):
    _, lens, _ = _len_batch()
    preds = lens + np.random.default_rng(5).normal(0, 1.5, lens.shape).astype(np.float32)
    ref = float(getattr(jlen, name)(jnp.asarray(preds), jnp.asarray(lens), -1))
    out = float(getattr(tlen, name)(torch.from_numpy(preds), torch.from_numpy(lens), -1))
    assert out == pytest.approx(ref, rel=1e-6)


@pytest.mark.parametrize("name", ["pitch_loss", "pitch_mae", "pitch_mse"])
def test_pitch_losses_match_jax(name):
    _, gts, spk, id2mean, id2std = _pitch_batch()
    rng = np.random.default_rng(6)
    cls_p, reg_p = (rng.normal(0, 2, gts.shape).astype(np.float32) for _ in range(2))
    if name == "pitch_loss":
        jargs, targs = (cls_p, reg_p), (cls_p, reg_p)
    else:  # the metrics take predicted Hz
        freqs = np.asarray(jmodels.calc_freq(cls_p, reg_p, spk, id2mean, id2std))
        jargs = targs = (freqs,)
    ref = float(getattr(jpitch, name)(*map(jnp.asarray, (*jargs, gts, spk, id2mean, id2std))))
    out = float(getattr(tpitch, name)(*map(torch.from_numpy, (*targs, gts, spk)),
                                       torch.from_numpy(id2mean), torch.from_numpy(id2std)))
    assert out == pytest.approx(ref, rel=1e-6)


def _pre_bn_biases(variables):
    """Param paths ``(..., conv, 'bias')`` of the convs that feed a BatchNorm."""
    params = variables["params"].get("core", variables["params"])
    prefix = ("core",) if "core" in variables["params"] else ()
    bn_of = {"cnn1": "bn1", "cnn2": "bn2", "cnn_class1": "bn_c1", "cnn_reg1": "bn_r1",
             **{f"cnn1{i}": f"bn1{i}" for i in range(1, 8)}}
    return {prefix + (c, "bias") for c, bn in bn_of.items() if c in params and bn in params}


def _check_step(ref_state, port_model, init_vars, to_jax, ref_loss, port_loss):
    assert port_loss == pytest.approx(ref_loss, rel=1e-5)
    ref = {"params": jax.device_get(ref_state.params),
           "batch_stats": jax.device_get(ref_state.batch_stats)}
    got = dict(jax.tree_util.tree_flatten_with_path(to_jax(port_model.state_dict()))[0])
    before = dict(jax.tree_util.tree_flatten_with_path(init_vars)[0])
    grads = {name: p.grad for name, p in port_model.named_parameters()}
    largest = max(float(g.abs().max()) for g in grads.values())
    noise_biases = _pre_bn_biases(init_vars)
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert set(got) == {p for p, _ in flat}
    assert any(np.abs(np.asarray(v) - before[p]).max() > 1e-5 for p, v in flat), "no update"
    for path, value in flat:
        keys = tuple(k.key for k in path)
        if keys[0] == "params" and keys[1:] in noise_biases:
            conv = keys[-2]
            assert float(grads[f"{conv}.bias"].abs().max()) <= 1e-5 * largest, conv
            for side in (np.asarray(value), np.asarray(got[path])):
                assert np.abs(side - before[path]).max() <= LR * (1 + 1e-5), conv
            continue
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(value), rtol=0, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_len_train_step_matches_jax():
    vals, lens, spk = _len_batch()
    stats = (4.0, 2.0)
    jm = jmodels.LenPredictor(n_tokens=100, n_speakers=N_SPK, emb_size=8, hidden=16,
                              masking_rate=0.0)
    variables = random_variables(jm, jnp.asarray(vals), jnp.asarray(spk), stats)
    state = jtrain.TrainState.create(apply_fn=jm.apply, params=variables["params"],
                                     tx=optax.adam(LR), batch_stats=variables["batch_stats"])
    train_step, _ = jtrain.make_len_steps(jm, stats, -1.0)
    state, jmetrics = train_step(state, jnp.asarray(vals), jnp.asarray(lens), jnp.asarray(spk),
                                 jax.random.key(0))

    model = LenPredictor(100, N_SPK, emb_size=8, hidden=16, masking_rate=0.0)
    model.load_state_dict(len_predictor_state_dict(variables))
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    step, _ = ttrain.make_len_steps(model, stats, opt, -1.0)
    metrics = step(torch.from_numpy(vals).long(), torch.from_numpy(lens),
                   torch.from_numpy(spk).long())
    for k in ("MAE", "MSE", "Accuracy", "Accuracy_1", "n"):
        assert float(metrics[k]) == pytest.approx(float(jmetrics[k]), rel=1e-5), k
    _check_step(state, model, variables, len_predictor_variables, float(jmetrics["Loss"]),
                float(metrics["Loss"]))


@pytest.mark.parametrize("model_type", ["base", "new"])
def test_pitch_train_step_matches_jax(model_type, monkeypatch):
    vals, gts, spk, id2mean, id2std = _pitch_batch()
    # PE dropout 0 on the JAX side (its rate is fixed at 0.4 in the module)
    monkeypatch.setattr(jmodels, "LinearRampPE", functools.partial(jmodels.LinearRampPE,
                                                                   dropout=0.0))
    jm = jtrain.build_pitch_model(model_type, 100, N_SPK,
                                  JaxProsodyConfig(emb_size=8, hidden=16, pitch_masking_rate=0.0))
    variables = random_variables(jm, jnp.asarray(vals), jnp.asarray(spk), seed=1)
    state = jtrain.TrainState.create(apply_fn=jm.apply, params=variables["params"],
                                     tx=optax.adam(LR), batch_stats=variables["batch_stats"])
    train_step, _ = jtrain.make_pitch_steps(jm, id2mean, id2std, -100.0)
    state, jmetrics = train_step(state, jnp.asarray(vals), jnp.asarray(gts), jnp.asarray(spk),
                                 jax.random.key(0))

    model = ttrain.build_pitch_model(model_type, 100, N_SPK,
                                     ProsodyConfig(emb_size=8, hidden=16, pitch_masking_rate=0.0))
    if model.pe is not None:
        model.pe.dropout = 0.0
    model.load_state_dict(pitch_predictor_state_dict(variables, model_type))
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    step, _ = ttrain.make_pitch_steps(model, torch.from_numpy(id2mean), torch.from_numpy(id2std),
                                      opt, -100.0)
    metrics = step(torch.from_numpy(vals).long(), torch.from_numpy(gts),
                   torch.from_numpy(spk).long())
    for k in ("MAE", "MSE", "n"):
        assert float(metrics[k]) == pytest.approx(float(jmetrics[k]), rel=1e-5), k
    _check_step(state, model, variables, pitch_predictor_variables, float(jmetrics["loss"]),
                float(metrics["loss"]))


def test_batchnorm_running_variance_is_biased_as_in_flax():
    """One train-mode call: running_var = 0.9 + 0.1 * var(ddof=0), where
    ``nn.BatchNorm1d`` would take var(ddof=1)."""
    model = LenPredictor(100, N_SPK, emb_size=8, hidden=16, masking_rate=0.0,
                         generator=torch.Generator().manual_seed(0)).train()
    seen = {}
    model.bn1.register_forward_hook(lambda m, inp, out: seen.setdefault("x", inp[0].detach()))
    vals, _, spk = _len_batch()
    model(torch.from_numpy(vals).long(), torch.from_numpy(spk).long(), (0.0, 1.0))
    x = seen["x"].double()
    biased = x.var(dim=(0, 2), unbiased=False)
    torch.testing.assert_close(model.bn1.running_var.double(), 0.9 + 0.1 * biased,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(model.bn1.running_mean.double(), 0.1 * x.mean(dim=(0, 2)),
                               rtol=1e-6, atol=1e-6)
    assert int(model.bn1.num_batches_tracked) == 1


@pytest.mark.parametrize("rate", [0.2, 0.4])
def test_token_mask_statistics(rate):
    """Share of zeroed (batch, time) positions within 3 sigma of ``rate``,
    whole vectors zeroed, the draw repeated by the seed."""
    emb = torch.ones((64, 200, 8))
    draw = lambda seed: _mask_embeddings(emb, 1.0 - rate, torch.Generator().manual_seed(seed))
    out = draw(42)
    zero_pos = (out == 0).all(-1)
    assert bool(((out == 0).any(-1) == zero_pos).all()), "a masked position zeroes its vector"
    n = zero_pos.numel()
    share = float(zero_pos.float().mean())
    assert abs(share - rate) <= 3 * np.sqrt(rate * (1 - rate) / n)
    assert torch.equal(out, draw(42)) and not torch.equal(out, draw(43))


def test_pe_dropout_statistics_and_model_masks_follow_the_generator():
    cfg = ProsodyConfig(emb_size=8, hidden=16)
    model = ttrain.build_pitch_model("new", 100, N_SPK, cfg,
                                     generator=torch.Generator().manual_seed(0)).train()
    x = torch.ones((32, 100, 8))
    out = model.pe(x, torch.Generator().manual_seed(1))
    ramp = model.pe.eval()(x)
    kept = out != 0
    share = 1 - float(kept.float().mean())
    assert abs(share - 0.4) <= 3 * np.sqrt(0.4 * 0.6 / x.numel())
    torch.testing.assert_close(out[kept], (ramp / 0.6)[kept])
    model.train()
    vals, _, spk = _len_batch()
    args = (torch.from_numpy(vals).long(), torch.from_numpy(spk).long())
    runs = [model(*args, generator=torch.Generator().manual_seed(s))[0] for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


# ---------------------------------------------------------------------------
# the trainers on a toy corpus
# ---------------------------------------------------------------------------


def write_unit_corpus(root, n_train=12, n_val=6, n_spk=3, seed=8):
    """``train.txt``/``val.txt`` unit records with f0, ``id_to_spkr.pkl`` and
    ``f0_stats.pkl`` in ``root``; returns the val records."""
    rng = np.random.default_rng(seed)
    names = [f"spk{i}" for i in range(n_spk)]
    splits = {}
    for split, n in (("train", n_train), ("val", n_val)):
        recs = []
        for j in range(n):
            k = int(rng.integers(20, 60))
            units = np.repeat(rng.integers(0, 100, k), rng.integers(1, 5, k))[:k]
            f0 = np.where(rng.random(k) < 0.3, 0.0, rng.normal(150, 20, k))
            recs.append({"units": units.tolist(), "f0": f0.round(3).tolist(),
                         "audio": f"{names[j % n_spk]}_{split}{j:03d}.wav"})
        with open(root / f"{split}.txt", "w") as f:
            for r in recs:
                f.write(repr(r).replace("'", '"') + "\n")
        splits[split] = recs
    with open(root / "id_to_spkr.pkl", "wb") as f:
        pickle.dump(names, f)
    with open(root / "f0_stats.pkl", "wb") as f:
        pickle.dump({n: {"mean": 140.0 + 5 * i, "std": 20.0} for i, n in enumerate(names)}, f)
    return splits["val"]


def test_trainers_write_checkpoints_both_packages_convert_with(tmp_path):
    data, out = tmp_path / "data", tmp_path / "out"
    os.makedirs(data)
    val = write_unit_corpus(data)
    cfg = ProsodyConfig(batch_size=4, n_epochs=2, model_type="new")
    len_dir = ttrain.train_len_predictor(str(data), str(out), cfg, device="cpu")
    f0_dir = ttrain.train_f0_predictor(str(data), str(data / "f0_stats.pkl"), str(out), cfg,
                                       device="cpu")
    for d in (len_dir, f0_dir):
        assert os.path.exists(os.path.join(d, "best_model.pth"))
        assert os.path.exists(os.path.join(d, "train", "metrics.jsonl"))
    mean, std = pickle.load(open(os.path.join(len_dir, "len_norm_stats.pth"), "rb"))
    assert float(std) > 0

    spk = {f"spk{i}": i for i in range(3)}
    stats = pickle.load(open(data / "f0_stats.pkl", "rb"))
    id2mean = np.array([stats[n]["mean"] for n in spk], np.float32)
    id2std = np.array([stats[n]["std"] for n in spk], np.float32)
    kw = dict(n_speakers=3, len_model_dir=len_dir, f0_model_dir=f0_dir, f0_model_type="new",
              id2pitch_mean=id2mean, id2pitch_std=id2std)
    ref = jinfer.ProsodyConverter.load(**kw).convert_records(val, spk, "spk1", norm_pitch=False)
    got = tinfer.ProsodyConverter.load(**kw, device="cpu").convert_records(val, spk, "spk1",
                                                                            norm_pitch=False)
    for r, g in zip(ref, got):
        assert g["units"] == r["units"]
        np.testing.assert_array_equal(np.asarray(g["f0"]) == 0, np.asarray(r["f0"]) == 0)
        np.testing.assert_allclose(g["f0"], r["f0"], rtol=1e-4, atol=1e-4)
