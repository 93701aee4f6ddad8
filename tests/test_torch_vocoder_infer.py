"""Port's file-level vocoder inference (``infer.vocoder.run_inference``,
``cli.sr_inference``) and the eval-mode ``CodeDataset`` vs the JAX package's.

One tiny generator (``test_torch_hifigan.SMALL``, numpy-drawn flax weights)
written once as a ``g_`` checkpoint and read by both packages.  Every mode
of ``run_inference`` writes the same files in both packages, and each
waveform (peak-normalised, before the int16 write) agrees within 1e-4:
resynthesis with VC and f0 re-normalisation (padded audio, ``-n``), raw
codes (``--code_file``), the pair CSV (``--sample_df``: only its pairs, no
resynthesis, no ground truth) and an unseen speaker (``--parts`` names).
A manifest without f0 takes YAAPT's 5 ms track in eval mode in both
packages: the generator then runs at 4x the code rate and writes
4 x 320 samples a code (the JAX package's output; checked here).
The eval-mode dataset items equal the JAX items bit for bit.
"""
import csv
import dataclasses
import json
import pickle

import numpy as np
import pytest
import torch

from dissc_tpu.core.config import VocoderConfig as JaxConfig
from dissc_tpu.data import code_dataset as jcd
from dissc_tpu.infer import vocoder as jvoc
from dissc_tpu.train.checkpoints import save_checkpoint
from dissc_tpu_torch.cli import sr_inference
from dissc_tpu_torch.data import code_dataset as tcd
from dissc_tpu_torch.infer import vocoder as tvoc
from test_torch_data import write_code_corpus, write_pcm16
from test_torch_hifigan import SMALL, random_generator_params

torch.set_num_threads(2)
SPEAKERS = ["p224", "p225", "p226", "p227"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer")
    train, _ = write_code_corpus(root, n_files=5, seconds=(0.2, 0.35), n_spk=3, f0="train")
    with open(root / "id_to_spkr.pkl", "wb") as f:
        pickle.dump(SPEAKERS, f)
    with open(root / "f0_stats.pkl", "wb") as f:
        pickle.dump({s: {"mean": 120.0 + 20 * i, "std": 10.0 + i}
                     for i, s in enumerate(SPEAKERS)}, f)
    ckpt = root / "ckpt"
    ckpt.mkdir()
    jh = JaxConfig(**SMALL)
    save_checkpoint(str(ckpt / "g_00000002"), {"generator": random_generator_params(jh, 3)})
    with open(ckpt / "config.json", "w") as f:
        json.dump(dict(dataclasses.asdict(jh), input_training_file=train), f)
    # raw codes, the pair CSV and a manifest without f0 (two files of one
    # length: the JAX tracker compiles once per length)
    with open(root / "codes.txt", "w") as f:
        f.write("a/x_1.wav|1 2 3 4 5 6 7\nb/y_2.wav|9 9 8 8 7\n\n")
    with open(root / "pairs.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "syn_sample", "syn_trgt"])
        w.writerows([[0, "p225_0000", "p226"], [1, "p225_0000", "p224"],
                     [2, "p226_0001", "p226"], [3, "p227_0002", "p999"]])
    rng = np.random.default_rng(9)
    with open(root / "nof0.jsonl", "w") as f:
        for i in range(2):
            name = f"p22{5 + i}_9{i}.wav"
            t = np.arange(4800) / 16000
            write_pcm16(root / name, (np.sin(2 * np.pi * (130 + 40 * i) * t) * 0.5
                                      + 0.02 * rng.standard_normal(4800)) * 12000)
            f.write(json.dumps({"audio": name, "units": rng.integers(0, 100, 15).tolist()}) + "\n")
    return root


MODES = {
    "vc": dict(vc=True, target_speakers=["p226", "p224"], f0_stats="f0_stats.pkl", pad=1280,
               n=4),
    "code_file": dict(code_file="codes.txt"),
    "sample_df": dict(vc=True, target_speakers=["p226", "p224", "p225"],
                      sample_df="pairs.csv"),
    "unseen": dict(vc=True, target_speakers=["p224"], unseen_speaker=True,
                   id_to_spkr="id_to_spkr.pkl", parts=True),
    "no_f0": dict(manifest="nof0.jsonl"),
}


def _capture(module, monkeypatch):
    """Record every waveform ``module`` writes (float, before the int16 WAV)."""
    out = {}
    real = module.write_wav

    def write(path, data, sr):
        out[path.rsplit("/", 1)[1]] = np.asarray(data, np.float64)
        real(path, data, sr)

    monkeypatch.setattr(module, "write_wav", write)
    return out


def _kwargs(root, mode, out_dir):
    m = dict(MODES[mode])
    path = lambda k: str(root / m.pop(k)) if k in m else None  # noqa: E731
    return dict(checkpoint_file=str(root / "ckpt"),
                input_code_file=path("manifest") or str(root / "train.jsonl"),
                output_dir=str(out_dir), data_path=str(root), f0_stats_path=path("f0_stats"),
                code_file=path("code_file"), sample_df_path=path("sample_df"),
                id_to_spkr_path=path("id_to_spkr"), **m)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_inference_writes_the_jax_files(setup, mode, tmp_path, monkeypatch):
    ref = _capture(jvoc, monkeypatch)
    ref_rtf = jvoc.run_inference(**_kwargs(setup, mode, tmp_path / "jax"))
    got = _capture(tvoc, monkeypatch)
    rtf = tvoc.run_inference(**_kwargs(setup, mode, tmp_path / "port"), device="cpu")
    assert sorted(got) == sorted(ref) and len(got) > 1
    assert (rtf > 0) == (ref_rtf > 0)
    for name in ref:
        assert got[name].shape == ref[name].shape, name
        assert np.abs(got[name] - ref[name]).max() < 1e-4, name
    expected = {
        "vc": {"p225_0000_gen.wav", "p225_0000_2_gen.wav", "p225_0000_0_gen.wav",
               "p225_0000_gt.wav"},
        "code_file": {"x_1_gen.wav", "y_2_gen.wav"},
        # pairs: p225_0000 -> p226 (2), p224 (0); p226_0001 -> p226; nothing else
        "sample_df": {"p225_0000_2_gen.wav", "p225_0000_0_gen.wav", "p226_0001_2_gen.wav"},
        # parts: the last three path parts joined
        "unseen": {f"{setup.parent.name}_{setup.name}_p225_0000_0_gen.wav",
                   f"{setup.parent.name}_{setup.name}_p225_0000_gt.wav"},
        "no_f0": {"p225_90_gen.wav", "p225_90_gt.wav"},
    }[mode]
    assert expected <= set(got), sorted(got)
    if mode == "sample_df":
        assert set(got) == expected
    if mode == "no_f0":  # the 5 ms track: 4 f0 values a code, 4 x 320 samples a code
        assert got["p225_90_gen.wav"].shape == (15 * 4 * 320,)


@pytest.mark.parametrize("kw", [dict(pad=1280), dict(pad=1000, unseen_speakers=True),
                                dict(f0_normalize=True, f0_median=True)])
def test_eval_mode_items_equal_jax(setup, kw):
    files = jcd.parse_manifest(str(setup / "train.jsonl"), str(setup))
    stats = {s: {"mean": 150.0, "std": 20.0} for s in ("p225", "p226")} | {
        "f0_mean": 140.0, "f0_std": 25.0}
    common = dict(files=files, segment_size=-1, code_hop_size=320, sampling_rate=16000,
                  f0_stats=stats, eval_mode=True, **kw)
    ref = jcd.CodeDataset(**common)
    ds = tcd.CodeDataset(**{**common, "files": tcd.parse_manifest(str(setup / "train.jsonl"),
                                                                   str(setup))}, f0_device="cpu")
    for i in range(len(ref)):
        a, b = ref[i], ds[i]
        assert sorted(a) == sorted(b)
        for key in ("code", "f0", "spkr", "audio"):
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), (i, key)
        assert len(b["code"]) == len(files[1][i])  # whole utterances: codes uncut
        if "pad" in kw:
            assert len(b["audio"]) % kw["pad"] == 0
    if kw.get("unseen_speakers"):
        assert all(ds[i]["spkr"][0] == 0 for i in range(len(ds)))


def test_sr_inference_cli_runs_on_the_cpu(setup, tmp_path):
    out = tmp_path / "cli"
    rtf = sr_inference.main(["--checkpoint_file", str(setup / "ckpt"), "--input_code_file",
                             str(setup / "train.jsonl"), "--data_path", str(setup),
                             "--output_dir", str(out), "--vc", "--target-speakers", "p226",
                             "-n", "2", "--batch_size", "2", "--device", "cpu"])
    assert rtf > 0
    assert sorted(p.name for p in out.iterdir()) == [
        "p225_0000_2_gen.wav", "p225_0000_gen.wav", "p225_0000_gt.wav",
        "p226_0001_2_gen.wav", "p226_0001_gen.wav", "p226_0001_gt.wav"]
    with pytest.raises(NotImplementedError, match="slice I"):
        sr_inference.main(["--data_devices", "2", "--device", "cpu"])
