"""The port's data-prep CLIs (``dissc_tpu_torch.cli.{preprocess,prep_dataset,
encode,infer}``) vs the JAX package's, on the same temp-dir corpus.

Each CLI must write what its JAX counterpart writes: resampled, trimmed and
padded WAVs within 1e-6 (the same int16 samples), the split files and the
f0-stats pickle equal, and the unit JSONL with units exactly and f0 within
the port's YAAPT tolerance (1e-4 relative).  The port's ``preprocess`` runs
its ``spawn`` pool; ``encode`` skips only files the readers refuse, where
the JAX CLI skips on any error.
"""
import functools
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissc_tpu.cli import encode as jax_encode
from dissc_tpu.cli import prep_dataset as jax_prep
from dissc_tpu.cli import preprocess as jax_preprocess
from dissc_tpu.models import hubert as jhub
from dissc_tpu.train.checkpoints import save_checkpoint
from dissc_tpu_torch.cli import encode, infer, prep_dataset, preprocess
from dissc_tpu_torch.compat.from_jax import hubert_state_dict
from dissc_tpu_torch.core.wav import read_wav, write_wav
from dissc_tpu_torch.models import hubert as thub
from test_torch_pipeline import HUBERT_320X

torch.set_num_threads(2)


def _speech_like(sr, seconds, f0, seed):
    """A voiced tone with silence at both ends (so ``--trim`` cuts) and noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    x = 0.5 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(4 * np.pi * f0 * t)
    x[: n // 5] = 0.0
    x[-n // 6:] = 0.0
    return (x + 0.003 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    for i, (sr, secs) in enumerate([(48000, 0.5), (22050, 0.45), (16000, 0.6), (44100, 0.3)]):
        os.makedirs(root / f"spk{i}", exist_ok=True)
        write_wav(str(root / f"spk{i}" / f"p23{i}_00{i + 1}.wav"),
                  _speech_like(sr, secs, 110 + 40 * i, i), sr)
    return root


@pytest.fixture(scope="module")
def preprocessed(raw, tmp_path_factory):
    out = tmp_path_factory.mktemp("pre")
    jax_preprocess.main(["--srcdir", str(raw), "--outdir", str(out / "jax"), "--trim", "--pad",
                         "--workers", "1"])
    n = preprocess.main(["--srcdir", str(raw), "--outdir", str(out / "port"), "--trim", "--pad",
                         "--workers", "2", "--device", "cpu"])
    assert n == 4
    return out


def test_preprocess_writes_the_jax_wavs(preprocessed):
    names = sorted(os.listdir(preprocessed / "jax"))
    assert names == sorted(os.listdir(preprocessed / "port")) and len(names) == 4
    for name in names:
        a, sr_a = read_wav(str(preprocessed / "jax" / name), dtype="float32")
        b, sr_b = read_wav(str(preprocessed / "port" / name), dtype="float32")
        assert sr_a == sr_b == 16000 and len(a) == len(b) and len(b) % 1280 == 0
        assert np.abs(a - b).max() <= 1e-6, name


def _unit_file(path, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(12):
            n = int(rng.integers(5, 12))
            f0 = np.where(rng.random(n) < 0.3, 0.0, rng.uniform(90, 250, n)).round(3)
            f.write(json.dumps({"units": rng.integers(0, 100, n).tolist(), "f0": f0.tolist(),
                                "audio": f"p{225 + i % 3}_{(i * 7) % 40 + 1:03d}_mic2.wav"})
                    + "\n")


@pytest.mark.parametrize("split", ["paired_val", "random", None])
def test_prep_dataset_writes_the_jax_split_and_stats(tmp_path, split):
    out = {}
    for name, main in (("jax", jax_prep.main), ("port", prep_dataset.main)):
        os.makedirs(tmp_path / name)
        _unit_file(tmp_path / name / "all.txt")
        argv = ["--encoded_path", str(tmp_path / name / "all.txt"), "--stats_path",
                str(tmp_path / name / "f0_stats.pkl")] + (["--split_method", split] if split
                                                           else [])
        main(argv + (["--device", "cpu"] if name == "port" else []))
        files = {}
        for f in sorted(os.listdir(tmp_path / name)):
            with open(tmp_path / name / f, "rb") as fh:
                files[f] = pickle.load(fh) if f.endswith(".pkl") else fh.read()
        out[name] = files
    assert out["port"].keys() == out["jax"].keys()
    assert ("train.txt" in out["port"]) == (split is not None)
    for f, v in out["jax"].items():
        if f.endswith(".pkl"):
            assert v.keys() == out["port"][f].keys()
            for spk, st in v.items():
                assert {k: float(x) for k, x in st.items()} == \
                    {k: float(x) for k, x in out["port"][f][spk].items()}, (f, spk)
        else:
            assert out["port"][f] == v, f


def _hubert_files(root):
    """Tiny HuBERT (320x front end) params in the JAX layout and a codebook
    of 30 of its own frames (k-means++ starts), so units vary."""
    jcfg = jhub.HubertConfig(**HUBERT_320X)
    shapes = jax.eval_shape(jhub.HubertEncoder(jcfg).init, jax.random.key(0),
                            jnp.zeros((1, 3200)))["params"]
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: ((1.0 if path[-1].key in ("scale", "g") else 0.0)
                         + rng.standard_normal(s.shape)
                         * (1 / np.sqrt(np.prod(s.shape[:-1])) if path[-1].key in ("kernel", "v")
                            else 0.1)).astype(np.float32), shapes)
    save_checkpoint(str(root / "hubert.pkl"), params)
    tcfg = thub.HubertConfig(**HUBERT_320X)
    enc = thub.SpeechUnitEncoder(hubert_state_dict(params, tcfg), np.zeros((1, 24), np.float32),
                                 tcfg, device="cpu")
    wav = _speech_like(16000, 1.0, 150, 9)
    with torch.no_grad():
        feats = enc.model(torch.from_numpy(wav[None]))[0].numpy()
    np.save(str(root / "km.npy"), feats[rng.choice(len(feats), 30, replace=False)])
    return jcfg, tcfg


def test_encode_writes_the_jax_units_and_skips_only_unreadable_files(tmp_path, monkeypatch):
    jcfg, tcfg = _hubert_files(tmp_path)
    wavs = tmp_path / "wavs"
    os.makedirs(wavs)
    for i in range(3):  # one length: the JAX tracker compiles once per length
        write_wav(str(wavs / f"p23{i}_001.wav"), _speech_like(16000, 0.56, 120 + 50 * i, i), 16000)
    (wavs / "notes.txt").write_text("not audio\n")
    monkeypatch.setattr(jhub, "SpeechUnitEncoder",
                        functools.partial(jhub.SpeechUnitEncoder, cfg=jcfg))
    monkeypatch.setattr(encode, "load_encoder", functools.partial(thub.load_encoder, cfg=tcfg))
    common = ["--base_dir", str(wavs), "--hubert_weights", str(tmp_path / "hubert.pkl"),
              "--kmeans_codebook", str(tmp_path / "km.npy")]
    jax_encode.main(common + ["--out_file", str(tmp_path / "jax" / "all.txt")])
    n = encode.main(common + ["--out_file", str(tmp_path / "port" / "all.txt"),
                              "--device", "cpu"])
    assert n == 3
    recs = {}
    for name in ("jax", "port"):
        with open(tmp_path / name / "all.txt") as f:
            recs[name] = [json.loads(line) for line in f]
    assert [r["audio"] for r in recs["port"]] == [r["audio"] for r in recs["jax"]]
    for a, b in zip(recs["jax"], recs["port"]):
        assert a["units"] == b["units"] and len(b["units"]) == len(b["f0"])
        fa, fb = np.asarray(a["f0"]), np.asarray(b["f0"])
        np.testing.assert_array_equal(fa > 0, fb > 0)
        np.testing.assert_allclose(fb, fa, rtol=1e-4)
    assert len({u for r in recs["port"] for u in r["units"]}) > 5

    def broken(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(thub.SpeechUnitEncoder, "__call__", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):  # never skipped
        encode.main(common + ["--out_file", str(tmp_path / "x.txt"), "--device", "cpu"])


def test_infer_cli_keeps_the_jax_asserts_and_refuses_a_multi_card_split():
    with pytest.raises(AssertionError):
        infer.main(["--input_path", "/nonexistent.txt", "--device", "cpu"])
    with pytest.raises(AssertionError):
        infer.main(["--pred_len", "--wild_sample", "--device", "cpu"])
    with pytest.raises(SystemExit) as exit_info:  # a split over cards of a CPU run
        infer.main(["--pred_len", "--data_devices", "4", "--device", "cpu"])
    assert exit_info.value.code == 2
