"""Port's speaker-verification evaluation vs ``dissc_tpu.eval.sv`` and its CLIs.

``compute_eer`` equal to the JAX sweep to 1e-12 on scores with ties (and
raising on an empty class, where JAX divides by zero); ``run_sv_eval`` on
a temp tree whose pair CSV has pandas' leading index column and one row
whose file is missing, against JAX with the same injected scorer;
``cli.eval_sv`` with ``--embedder`` (a pickle the JAX ``save_checkpoint``
wrote, which unpickles without JAX) and with ``--speechbrain_ckpt`` on the
same weights; and ``cli.convert_eval_sv`` end to end on the CPU through
``chip_smoke.py``'s phase 8 helper at tiny widths (ECAPA at its full
width, which the CLI builds).
"""
import functools
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
from dissc_tpu.eval import sv as jsv
from dissc_tpu.train.checkpoints import save_checkpoint as jax_save_checkpoint
from dissc_tpu_torch.cli import encode, eval_sv
from dissc_tpu_torch.compat.to_jax import ecapa_variables
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.core.wav import write_wav
from dissc_tpu_torch.data.stats import read_sv_pairs
from dissc_tpu_torch.eval import sv as tsv
from dissc_tpu_torch.models.ecapa import EcapaConfig, EcapaEmbedder, EcapaTDNN
from dissc_tpu_torch.models.hubert import HubertConfig, load_encoder
from test_torch_hifigan import SMALL
from test_torch_pipeline import HUBERT_320X

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_eer_matches_jax_with_ties(seed):
    rng = np.random.default_rng(seed)
    pos = np.round(rng.normal(0.6, 0.2, 37 + seed), 2)  # rounded: many ties across classes
    neg = np.round(rng.normal(0.3, 0.2, 53), 2)
    eer, thr = tsv.compute_eer(pos, neg)
    ref_eer, ref_thr = jsv.compute_eer(pos, neg)
    assert abs(eer - ref_eer) <= 1e-12 and abs(thr - ref_thr) <= 1e-12


def test_compute_eer_raises_on_an_empty_class():
    with pytest.raises(ValueError, match="0 negative"):
        tsv.compute_eer(np.array([0.5, 0.7]), np.array([]))
    with pytest.raises(ValueError, match="0 positive"):
        tsv.compute_eer(np.array([]), np.array([0.1]))


def _sv_tree(root, rows, missing=(), suffix="_mic2.flac", seconds=0.3, seed=8):
    """``<root>/gt/<ref><suffix>`` and ``<root>/sv/m/<trg>/<sample>.wav``
    (WAVs), and the pair CSV with a leading index column; the files named
    in ``missing`` are not written."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    with open(root / "speaker_verification.csv", "w") as f:
        f.write(",ref,syn_trgt,syn_sample,label\n")
        for i, (ref, trg, sample, label) in enumerate(rows):
            f.write(f"{i},{ref},{trg},{sample},{label}\n")
            for path in (root / "gt" / f"{ref}{suffix}", root / "sv" / "m" / trg / f"{sample}.wav"):
                if path.name not in missing and not path.exists():
                    os.makedirs(path.parent, exist_ok=True)
                    t = np.arange(int(seconds * 16000)) / 16000
                    wav = (0.3 * np.sin(2 * np.pi * rng.uniform(90, 300) * t)
                           + 0.05 * rng.standard_normal(t.shape))
                    write_wav(str(path), wav, 16000)


ROWS = [("p231_025", "p239", "p245_001", 0), ("p239_025", "p239", "p245_001", 1),
        ("p245_025", "p270", "p231_001", 0), ("p270_025", "p270", "p231_001", 1),
        ("p231_025", "p231", "p270_001", 1), ("p245_025", "p231", "p270_001", 0),
        ("p270_025", "p245", "p239_001", 0), ("p245_025", "p245", "p239_001", 1)]


def test_run_sv_eval_matches_jax_with_an_index_column_and_a_missing_file(tmp_path, capsys):
    _sv_tree(tmp_path, ROWS, missing={"p239_001.wav"})

    def score(a, b):  # any deterministic scorer of the two paths
        return zlib.crc32(f"{os.path.basename(a)}|{os.path.relpath(b, tmp_path)}".encode()) / 2**32

    args = (str(tmp_path / "speaker_verification.csv"), str(tmp_path / "gt"),
            str(tmp_path / "sv" / "m"), score)
    ref = jsv.run_sv_eval(*args)
    ref_out = capsys.readouterr().out
    got = tsv.run_sv_eval(*args)
    out = capsys.readouterr().out
    assert got == ref and out == ref_out
    assert "p270_025 p245\n" in out and "p245_025 p245\n" in out  # the skipped pairs, printed
    assert [r["label"] for r in read_sv_pairs(args[0])] == [str(r[3]) for r in ROWS]


def _ecapa_weights(seed=9):
    g = torch.Generator().manual_seed(seed)
    model = EcapaTDNN(EcapaConfig(), generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=g))
    return model.state_dict()


def test_eval_sv_cli_reads_the_jax_pickle_and_the_speechbrain_checkpoint(tmp_path):
    base = tmp_path / "results"
    _sv_tree(base, ROWS[:4], suffix="_mic2.wav")
    sd = _ecapa_weights()
    torch.save(sd, tmp_path / "embedding_model.ckpt")
    jax_save_checkpoint(str(tmp_path / "ecapa.pkl"), ecapa_variables(sd))
    # the JAX pickle holds numpy arrays and dicts only: it loads where JAX is absent
    code = ("import sys, pickle\n"
            "sys.modules['jax'] = sys.modules['jaxlib'] = sys.modules['flax'] = None\n"
            f"params, stats = pickle.load(open({str(tmp_path / 'ecapa.pkl')!r}, 'rb'))\n"
            "assert type(params) is dict and type(stats) is dict\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=60)

    common = ["--base_path", str(base), "--method", "m", "--gt_path", str(base / "gt"),
              "--file_suffix", "_mic2.wav", "--device", "cpu"]
    eer_pickle = eval_sv.main(common + ["--embedder", str(tmp_path / "ecapa.pkl")])
    eer_sb = eval_sv.main(common + ["--speechbrain_ckpt", str(tmp_path / "embedding_model.ckpt")])
    score = tsv.cosine_scorer(EcapaEmbedder(sd, device="cpu"))
    scores = {0: [], 1: []}
    for ref, trg, sample, label in ROWS[:4]:
        scores[label].append(score(str(base / "gt" / f"{ref}_mic2.wav"),
                                   str(base / "sv" / "m" / trg / f"{sample}.wav")))
    assert eer_pickle == eer_sb == tsv.compute_eer(scores[1], scores[0])[0]
    with pytest.raises(SystemExit, match="Provide --embedder"):
        eval_sv.main(common)


def test_convert_eval_sv_runs_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    hub_cfg = HubertConfig(**HUBERT_320X)
    monkeypatch.setattr(encode, "load_encoder", functools.partial(load_encoder, cfg=hub_cfg))
    cpu = torch.device("cpu")
    stems = chip_smoke.prepare_vctk(str(tmp_path), VocoderConfig(**SMALL), hub_cfg, None, cpu,
                                    seconds=(0.4, 0.7), workers=1)
    run = chip_smoke.convert_eval_sv_run(str(tmp_path), cpu)
    assert len(run["rows"]) == 24 and {r["label"] for r in run["rows"]} == {"0", "1"}
    tree = tmp_path / "results" / "vctk" / "sv" / "dissc_b"
    written = sorted(f"{t}/{f}" for t in os.listdir(tree) for f in os.listdir(tree / t))
    assert written == sorted({f"{r['syn_trgt']}/{r['syn_sample']}.wav" for r in run["rows"]})
    assert all(r["ref"] in stems and r["syn_sample"] in stems for r in run["rows"])
    assert 0.0 <= run["eer"] <= 1.0 and len(run["scores"][0]) == len(run["scores"][1]) == 12
