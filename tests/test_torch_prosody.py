"""Port's prosody models and converter vs the JAX package's, same weights.

Default widths (emb 32, hidden 128).  Weights: numpy draws into the flax
parameter shapes (``eval_shape``), BatchNorm running stats included,
carried by ``compat.from_jax``.  Inputs: a padded batch with lengths past
850 (the ramp PE's clamp).  Tolerances: predictor outputs within 1e-4
(f32 convs in another order); converted units and durations exactly
equal; f0 within 1e-4 relative (de-whitened by stds of 10-40).
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissc_tpu.infer import prosody as jinfer
from dissc_tpu.models.prosody import LenPredictor as JaxLen
from dissc_tpu.train.checkpoints import save_checkpoint
from dissc_tpu.train.prosody_trainer import build_pitch_model as jax_build_pitch
from dissc_tpu_torch.compat.from_jax import len_predictor_state_dict, pitch_predictor_state_dict
from dissc_tpu_torch.infer import prosody as tinfer
from dissc_tpu_torch.models.prosody import LenPredictor
from dissc_tpu_torch.train.prosody_trainer import build_pitch_model

torch.set_num_threads(2)
N_SPK = 5
STATS = (np.float32(4.0), np.float32(2.0))


def random_variables(model, *args, seed=0):
    """Seeded numpy draws in the flax variables' shapes (no init compiled):
    conv kernels N(0, 1/fan_in) as torch's default scale, so activations
    stay O(1) through the trunk."""
    shapes = jax.eval_shape(model.init, jax.random.key(0), *args)
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "kernel":
            scale = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
        else:
            scale = {"embedding": 1.0, "bias": 0.05, "scale": 0.3, "mean": 0.1}[name]
        base = 1.0 if name == "scale" else 0.0
        return (base + rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _batch(L, lengths, seed=1):
    rng = np.random.default_rng(seed)
    seqs = np.full((len(lengths), L), 100, np.int64)
    for b, n in enumerate(lengths):
        seqs[b, :n] = rng.integers(0, 100, n)
    spk = np.arange(len(lengths))[:, None] % N_SPK
    mask = np.arange(L)[None, :] < np.asarray(lengths)[:, None]
    return seqs, spk, mask


def test_len_predictor_matches_jax():
    jm = JaxLen(n_tokens=100, n_speakers=N_SPK)
    seqs, spk, mask = _batch(900, [900, 300, 17])
    args = (jnp.asarray(seqs, jnp.int32), jnp.asarray(spk, jnp.int32))
    variables = random_variables(jm, *args, STATS)
    ref = np.asarray(jax.jit(jm.apply)(variables, *args, STATS, length_mask=jnp.asarray(mask)))
    model = LenPredictor(n_tokens=100, n_speakers=N_SPK)
    model.load_state_dict(len_predictor_state_dict(variables))
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(seqs), torch.from_numpy(spk),
                           tuple(float(s) for s in STATS), length_mask=torch.from_numpy(mask))
    assert np.abs(out.numpy() - ref).max() < 1e-4


@pytest.mark.parametrize("model_type", ["new", "base"])
def test_pitch_predictor_matches_jax(model_type):
    jm = jax_build_pitch(model_type, 100, N_SPK)
    seqs, spk, mask = _batch(1100, [1100, 870, 40])
    args = (jnp.asarray(seqs, jnp.int32), jnp.asarray(spk, jnp.int32))
    variables = random_variables(jm, *args, seed=2)
    ref_cls, ref_reg = jax.jit(jm.apply)(variables, *args, length_mask=jnp.asarray(mask))
    model = build_pitch_model(model_type, 100, N_SPK)
    model.load_state_dict(pitch_predictor_state_dict(variables, model_type))
    with torch.no_grad():
        cls, reg = model.eval()(torch.from_numpy(seqs), torch.from_numpy(spk),
                                length_mask=torch.from_numpy(mask))
    assert np.abs(cls.numpy() - np.asarray(ref_cls)).max() < 1e-4
    assert np.abs(reg.numpy() - np.asarray(ref_reg)).max() < 1e-4


@pytest.fixture(scope="module")
def prosody_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("prosody")
    zeros = lambda L: jnp.zeros((1, L), jnp.int32)  # noqa: E731
    len_vars = random_variables(JaxLen(n_tokens=100, n_speakers=N_SPK), zeros(8),
                                jnp.zeros((1, 1), jnp.int32), STATS, seed=3)
    os.makedirs(root / "len")
    save_checkpoint(str(root / "len" / "best_model.pth"), len_vars)
    save_checkpoint(str(root / "len" / "len_norm_stats.pth"), (4.0, 2.0))
    for model_type in ("new", "base"):
        os.makedirs(root / model_type)
        pv = random_variables(jax_build_pitch(model_type, 100, N_SPK), zeros(8),
                              jnp.zeros((1, 1), jnp.int32), seed=4)
        save_checkpoint(str(root / model_type / "best_model.pth"), pv)
    rng = np.random.default_rng(5)
    id2mean = rng.uniform(100, 250, N_SPK).astype(np.float32)
    id2std = rng.uniform(10, 40, N_SPK).astype(np.float32)
    return root, id2mean, id2std


def _records(seed=6, sizes=(12, 40, 150, 9)):
    rng = np.random.default_rng(seed)
    recs = []
    for i, n in enumerate(sizes):
        units = np.repeat(rng.integers(0, 100, n), rng.integers(1, 4, n))[:n].tolist()
        f0 = np.where(rng.random(n) < 0.3, 0.0, rng.normal(150, 10, n)).tolist()
        recs.append({"units": units, "f0": f0, "audio": f"s{i % N_SPK}_{i:03d}.wav"})
    return recs


def _check_same(out, ref):
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o["audio"] == r["audio"]
        assert o["units"] == r["units"]
        f0, rf0 = np.asarray(o["f0"]), np.asarray(r["f0"])
        assert f0.shape == rf0.shape
        np.testing.assert_array_equal(f0 == 0, rf0 == 0)
        np.testing.assert_allclose(f0, rf0, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pitch,target", [("new", None), ("base", "s3"), (None, "s1")])
def test_convert_records_matches_jax(prosody_dirs, pitch, target):
    root, id2mean, id2std = prosody_dirs
    kw = dict(n_speakers=N_SPK, len_model_dir=str(root / "len"),
              f0_model_dir=str(root / pitch) if pitch else None, f0_model_type=pitch or "new",
              id2pitch_mean=id2mean, id2pitch_std=id2std)
    spk = {f"s{i}": i for i in range(N_SPK)}
    recs = _records()
    ref = jinfer.ProsodyConverter.load(**kw).convert_records(recs, spk, target, norm_pitch=True,
                                                             batch_size=2)
    out = tinfer.ProsodyConverter.load(**kw, device="cpu").convert_records(
        recs, spk, target, norm_pitch=True, batch_size=2)
    _check_same(out, ref)


def test_truncation_is_counted_and_warned_as_in_jax(prosody_dirs):
    root, _, _ = prosody_dirs
    kw = dict(n_speakers=N_SPK, len_model_dir=str(root / "len"), f0_model_dir=str(root / "new"))
    spk = {f"s{i}": i for i in range(N_SPK)}
    recs = _records(sizes=(100, 120))
    convs = [jinfer.ProsodyConverter.load(**kw), tinfer.ProsodyConverter.load(**kw, device="cpu")]
    outs = []
    for conv in convs:
        conv.expand_factor = 1.0  # durations ~4 a run: past the cap
        with pytest.warns(UserWarning, match="truncated"):
            outs.append(conv.convert_records(recs, spk, norm_pitch=False))
    assert convs[1].truncation_count == convs[0].truncation_count == 2
    _check_same(outs[1], outs[0])


def test_heuristic_norm_pitch_without_stats_is_a_clean_error(prosody_dirs):
    root, _, _ = prosody_dirs
    conv = tinfer.ProsodyConverter.load(N_SPK, len_model_dir=str(root / "len"), device="cpu")
    with pytest.raises(ValueError, match="f0 statistics"):
        conv.convert_records(_records(sizes=(10,)), {f"s{i}": i for i in range(N_SPK)},
                             norm_pitch=True)


def test_infer_file_matches_jax_with_pair_csv(prosody_dirs, tmp_path):
    """``sample_df``: the port reads the pair CSV with ``csv``, the JAX
    package with pandas; both write the same per-target files."""
    root, _, _ = prosody_dirs
    data = tmp_path / "data"
    os.makedirs(data)
    recs = _records(sizes=(20, 30, 25))
    with open(data / "test.txt", "w") as f:
        for r in recs:
            f.write(repr(r).replace("'", '"') + "\n")
    with open(data / "id_to_spkr.pkl", "wb") as f:
        pickle.dump([f"s{i}" for i in range(N_SPK)], f)
    with open(data / "f0_stats.pkl", "wb") as f:
        pickle.dump({f"s{i}": {"mean": 120.0 + i, "std": 20.0} for i in range(N_SPK)}, f)
    with open(data / "pairs.csv", "w") as f:
        f.write(",syn_sample,syn_trgt\n0,s0_000,s2\n1,s1_001,s2\n2,s1_001,s4\n3,zz_009,s3\n")
    kw = dict(len_model_dir=str(root / "len"), f0_model_dir=str(root / "new"),
              f0_stats_path=str(data / "f0_stats.pkl"), vc=True,
              sample_df=str(data / "pairs.csv"))
    jinfer.infer_file(str(data / "test.txt"), str(tmp_path / "jax"), **kw)
    tinfer.infer_file(str(data / "test.txt"), str(tmp_path / "port"), device="cpu", **kw)
    from dissc_tpu_torch.data.jsonl import read_unit_records

    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["s2_test.txt", "s4_test.txt"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        _check_same(read_unit_records(str(tmp_path / "port" / name)),
                    read_unit_records(str(tmp_path / "jax" / name)))
