"""Port's eval suite (``dissc_tpu_torch.eval``) vs the JAX package's.

Host parts (edit distance, WER/CER normalisation, EMD, FFE, uniform grids,
TextGrid parsing, the DTW DP) must give the JAX package's values exactly.
On a shared results tree, ``calc_errors`` with an injected transcriber must
give the same WER/CER counts, length errors and duration errors exactly,
and EMD and FFE within what the port's YAAPT allows (voicing identical,
voiced f0 within 1e-4 relative, ``tests/test_torch_yaapt.py``): EMD is
1-Lipschitz in the contours, so within 1e-4 of the largest f0; FFE equal.
The DTW TextGrids must be the JAX package's text, character for character.
Two waveform lengths only: the JAX tracker compiles once per length.
"""
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from dissc_tpu.eval import align as jalign
from dissc_tpu.eval import metrics as jm
from dissc_tpu.eval.textgrid import TextGrid as JaxTextGrid
from dissc_tpu_torch.cli import eval as eval_cli
from dissc_tpu_torch.core.wav import write_wav
from dissc_tpu_torch.eval import align as talign
from dissc_tpu_torch.eval import metrics as tm
from dissc_tpu_torch.eval.textgrid import Interval, TextGrid

torch.set_num_threads(2)
SR = 16000
LENS = (8000, 9920)
TARGETS = ["p231", "p239"]
SOURCES = ["p231", "p239", "p270"]
SEQS = ["001", "002", "024"]


def mfa_grid(dur: float, words=("please", "call", "stella"), phones=("P", "L", "IY", "Z")) -> str:
    """MFA-style long TextGrid text: words and phones spread over ``dur``
    seconds, with an empty interval (silence) in each tier."""
    def tier(i, name, marks):
        n = len(marks) + 1
        edges = [dur * k / n for k in range(n + 1)]
        marks = list(marks[:1]) + [""] + list(marks[1:])
        ivs = "".join(f"""        intervals [{j + 1}]:
            xmin = {edges[j]}
            xmax = {edges[j + 1]}
            text = "{m}"
""" for j, m in enumerate(marks))
        return f"""    item [{i}]:
        class = "IntervalTier"
        name = "{name}"
        xmin = 0
        xmax = {dur}
        intervals: size = {len(marks)}
{ivs}"""
    return f"""File type = "ooTextFile"
Object class = "TextGrid"

xmin = 0
xmax = {dur}
tiers? <exists>
size = 2
item []:
{tier(1, "words", words)}{tier(2, "phones", phones)}"""


def _voiced(f0, n, seed):
    """Harmonics at ``f0`` with a silent middle third and a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = 0.4 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(4 * np.pi * f0 * t)
    x[n // 3: 2 * n // 3] = 0.0
    return (x + 0.01 * rng.standard_normal(n)).astype(np.float32)


def build_tree(base):
    """``orig/`` (ground truth, its MFA-style grids but one) and ``m/<trg>/``
    (conversions with transcripts; a reconstruction, a p270_024, one
    synthetic grid that matches and one with a word too few)."""
    os.makedirs(f"{base}/orig/txtgrid")
    k = 0
    for trg in TARGETS:
        for j, seq in enumerate(SEQS):
            n = LENS[j % 2]
            write_wav(f"{base}/orig/{trg}_{seq}.wav", _voiced(110 + 30 * j, n, k), SR)
            if (trg, seq) != ("p239", "002"):
                with open(f"{base}/orig/txtgrid/{trg}_{seq}.TextGrid", "w") as f:
                    f.write(mfa_grid(n / SR))
            k += 1
        os.makedirs(f"{base}/m/{trg}/txtgrid")
        for src in SOURCES:
            for j, seq in enumerate(SEQS):
                n = LENS[(j + SOURCES.index(src)) % 2]
                write_wav(f"{base}/m/{trg}/{src}_{seq}.wav", _voiced(140 + 20 * j, n, k), SR)
                with open(f"{base}/m/{trg}/{src}_{seq}.txt", "w") as f:
                    f.write(f"Please call Stella, {j + 1} times!\n")
                k += 1
    with open(f"{base}/m/p231/txtgrid/p239_001.TextGrid", "w") as f:
        f.write(mfa_grid(LENS[0] / SR))
    with open(f"{base}/m/p239/txtgrid/p231_001.TextGrid", "w") as f:
        f.write(mfa_grid(LENS[0] / SR, words=("call", "stella")))


def fake_asr(path):
    """A transcript that depends on the file: digits, case and punctuation
    exercise the normalisation."""
    name = os.path.basename(path)
    return {"0": "please call stella 1 time", "1": "Please, fall Stella; 2 times.",
            "2": "plea call bella three times"}[str(sum(map(ord, name)) % 3)]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("results"))
    build_tree(base)
    return base


def _same_errors(got, ref):
    for key in ("wer_s", "wer_d", "cer_s", "cer_d", "len", "w_len", "p_len"):
        assert got[key] == ref[key], key
    assert len(got["emd"]) == len(ref["emd"])
    np.testing.assert_allclose(got["emd"], ref["emd"], rtol=0, atol=1e-4 * 300)
    for key in ("w_ffe", "p_ffe"):
        assert got[key] == ref[key], key


def test_host_metrics_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a, b = (rng.integers(0, 4, rng.integers(0, 9)).tolist() for _ in range(2))
        assert tm.edit_distance(a, b) == jm.edit_distance(a, b)
    for ref, hyp in [("Hello, World!", "hello world"), ("It's 2 o'clock.", "its 2 oclock"),
                     ("a b c", ""), ("", "9 lives")]:
        assert tm.calc_asr_er(ref, hyp) == jm.calc_asr_er(ref, hyp)
    p1, p2 = rng.uniform(0, 200, 50), rng.uniform(0, 200, 61)
    assert tm.pitch_emd(p1, p2) == jm.pitch_emd(p1, p2)
    ivs = [Interval(0.0, 0.2, "a"), Interval(0.2, 0.5, "b")]
    shifted = [Interval(0.05, 0.21, "a"), Interval(0.21, 0.62, "b")]
    assert tm.aligned_ffe(ivs, shifted, p1, p2) == jm.aligned_ffe(ivs, shifted, p1, p2)
    empty = [Interval(0.3, 0.3, "a")]  # an empty synthetic slice raises on both sides
    for mod in (tm, jm):
        with pytest.raises(ValueError):
            mod.aligned_ffe(ivs[:1], empty, p1, p2)
    text = mfa_grid(0.7)
    ours, theirs = TextGrid.fromString(text), JaxTextGrid.fromString(text)
    assert ours.maxTime == theirs.maxTime == 0.7
    for t in (0, 1):
        assert [(i.minTime, i.maxTime, i.mark) for i in ours[t]] == \
            [(i.minTime, i.maxTime, i.mark) for i in theirs[t]]
        assert [(i.minTime, i.maxTime, i.mark) for i in tm.uniform_fallback_grid(ours, t)] == \
            [(i.minTime, i.maxTime, i.mark) for i in jm.uniform_fallback_grid(theirs, t)]


def test_dtw_path_equals_jax():
    rng = np.random.default_rng(1)
    for dist in (rng.random((13, 17)), rng.integers(0, 3, (11, 9)).astype(float),
                 np.ones((4, 6)), rng.random((1, 5)), rng.random((6, 1))):
        for a, b in zip(talign.dtw_path(dist), jalign.dtw_path(dist)):
            np.testing.assert_array_equal(a, b)


def test_calc_errors_matches_jax(tree):
    ref = jm.calc_errors(tree, "m", TARGETS, transcribe=fake_asr)
    got = tm.calc_errors(tree, "m", TARGETS, transcribe=fake_asr, device="cpu")
    # 2 targets x 3 sources x 3 seqs, less the reconstructions (2 x 3) and
    # p270_024 (2): 10 pairs; p239_002 has no reference grid (2 pairs), and
    # the synthetic grid a word short drops its utterance from the word tier
    assert len(got["len"]) == 10 and len(got["p_len"]) == 8 and len(got["w_len"]) == 7
    assert 0 < got["len"].count(0) < 10
    assert got["wer_d"] > 0 and got["wer_s"] > 0
    _same_errors(got, ref)
    assert tm.log_results(got, tree, "port") == pytest.approx(
        jm.log_results(ref, tree, "jax"), rel=1e-4, nan_ok=True)


def test_dtw_textgrids_and_the_eval_cli_match_jax(tree, tmp_path):
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    shutil.copytree(tree, ours)
    shutil.copytree(tree, theirs)
    assert jalign.write_dtw_textgrids(theirs, "m", TARGETS) == 10  # p270_024 too
    summary = eval_cli.main(["--base_path", ours, "--method", "m", "--target_speakers",
                             *TARGETS, "--dtw_align", "--device", "cpu"])
    written = 0
    for trg in TARGETS:
        for name in sorted(os.listdir(f"{theirs}/m/{trg}/txtgrid")):
            with open(f"{theirs}/m/{trg}/txtgrid/{name}") as a, \
                    open(f"{ours}/m/{trg}/txtgrid/{name}") as b:
                assert a.read() == b.read(), name
            written += 1
    assert written == 10
    ref = jm.calc_errors(theirs, "m", TARGETS)
    with open(f"{ours}/m_results.pkl", "rb") as f:
        got = pickle.load(f)
    _same_errors(got, ref)
    assert len(got["p_len"]) == len(got["w_len"]) == 8 and np.isfinite(summary["Word FFE"])
