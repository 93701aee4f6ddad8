"""Content and prosody conversion metrics (``dissc_tpu.eval.metrics``;
reference ``eval.py``).

  * WER/CER by Levenshtein distance with the reference's text
    normalisation (lowercase, no punctuation, digits -> words on the
    hypothesis only, ``eval.py:36-47``);
  * pitch EMD (scipy's Wasserstein distance on YAAPT contours,
    ``eval.py:96-102``);
  * per-word and per-phone duration error and FFE (the fraction of frames
    whose f0 deviates by more than 20 %, ``eval.py:50-57``) over MFA
    TextGrids, or the uniform grids the reference falls back to;
  * the waveform length error.

YAAPT runs on the device (:func:`~dissc_tpu_torch.audio.yaapt.yaapt_f0`);
the rest is host numpy and scipy, copied.  ASR is injected as any
``fn(path) -> text`` (:mod:`dissc_tpu_torch.eval.asr` builds one).
"""
from __future__ import annotations

import glob
import os
import pickle
import string
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
from scipy.stats import wasserstein_distance

from dissc_tpu_torch.audio.yaapt import yaapt_f0
from dissc_tpu_torch.core.seqops import interp
from dissc_tpu_torch.core.wav import peak_normalize, read_wav
from dissc_tpu_torch.device import DeviceLike, resolve_device
from dissc_tpu_torch.eval.textgrid import Interval, TextGrid


def edit_distance(a, b) -> int:
    """Levenshtein distance between two sequences."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def calc_asr_er(ref: str, pred: str):
    """(cer_num, cer_den, wer_num, wer_den) with the reference's
    normalisation (``eval.py:36-47``)."""
    int_dict = {"0": "zero", "1": "one", "2": "two", "3": "three", "4": "four",
                "5": "five", "6": "six", "7": "seven", "8": "eight", "9": "nine"}
    gt_text = ref.lower().strip().translate(str.maketrans("", "", string.punctuation))
    ref_w = gt_text.split()
    ref_c = list(" ".join(ref_w))
    pred_text = pred.lower().strip().translate(str.maketrans("", "", string.punctuation))
    for k, v in int_dict.items():
        pred_text = pred_text.replace(k, v)
    syn_w = pred_text.split()
    syn_c = list(" ".join(syn_w))
    return edit_distance(syn_c, ref_c), len(ref_c), edit_distance(syn_w, ref_w), len(ref_w)


def get_yaapt(audio: np.ndarray, sr: int = 16000, device: DeviceLike = None) -> np.ndarray:
    """Eval-flavour YAAPT (``eval.py:26-33``): pad 10 ms each side,
    peak-normalise * 0.95, track at 5 ms.  ``device=None`` runs on the CUDA
    card and raises without one."""
    to_pad = int(20.0 / 1000 * sr) // 2
    audio = np.pad(audio, (to_pad, to_pad), "constant")
    audio = peak_normalize(audio) * 0.95
    # yaapt_f0 pads frame_length/2 itself; compensate so framing matches
    return yaapt_f0(audio[to_pad:-to_pad], sr, device=device)


def pitch_emd(syn_pitch: np.ndarray, ref_pitch: np.ndarray) -> float:
    """Wasserstein distance between contours, zero-padded to equal length
    (``eval.py:96-102``)."""
    if ref_pitch.shape[0] > syn_pitch.shape[0]:
        syn_pitch = np.pad(syn_pitch, (0, ref_pitch.shape[0] - syn_pitch.shape[0]))
    elif syn_pitch.shape[0] > ref_pitch.shape[0]:
        ref_pitch = np.pad(ref_pitch, (0, syn_pitch.shape[0] - ref_pitch.shape[0]))
    return float(wasserstein_distance(syn_pitch, ref_pitch))


def aligned_ffe(int1, int2, pitch1, pitch2, sr: int = 16000) -> float:
    """FFE over aligned intervals: fraction of frames whose f0 ratio
    deviates >20% after nearest-resampling the synthetic interval to the
    reference's frame count (``eval.py:50-57``).

    Mirrors the reference's edge semantics: an empty synthetic slice
    raises ``ValueError`` (``interp`` of nothing), which the caller's
    per-tier ``except`` turns into "drop this utterance from the tier";
    a skip guard here would shift the corpus mean.
    """
    ffe = []
    for i in range(len(int1)):
        ref = pitch1[int(int1[i].minTime * sr * 0.005 * 2.5 + 2):
                     int(int1[i].maxTime * sr * 0.005 * 2.5 + 2)]
        syn = pitch2[int(int2[i].minTime * sr * 0.005 * 2.5 + 2):
                     int(int2[i].maxTime * sr * 0.005 * 2.5 + 2)]
        syn = interp(syn, ref.shape[0])
        ffe.append((np.abs(((ref + 0.0001) / (syn + 0.0001)) - 1) > 0.2).mean())
    return float(np.mean(ffe)) if ffe else 0.0


def uniform_fallback_grid(ref_grid: TextGrid, tier: int) -> List[Interval]:
    """Uniform-interval grid when MFA fails on corrupted synthesis
    (``eval.py:114,125``)."""
    n = len(ref_grid[tier]) + 1
    return [
        Interval(ref_grid.maxTime / n * i, ref_grid.maxTime / n * (i + 1), inv.mark)
        for i, inv in enumerate(ref_grid[tier]) if inv.mark
    ]


def calc_errors(
    base_path: str,
    method: str,
    target_speakers: List[str],
    transcribe: Optional[Callable[[str], str]] = None,
    sr: int = 16000,
    device: DeviceLike = None,
) -> Dict:
    """Full metric sweep over (target speaker, utterance) pairs.

    Mirrors ``eval.py:60-130`` including the p270_024 exclusion and the
    skip-reconstruction rule.  ``transcribe`` is the injected ASR; when
    None the WER/CER terms stay zero.  ``device=None`` runs YAAPT on the
    CUDA card and raises without one.
    """
    device = resolve_device(device)
    gt_path = f"{base_path}/orig/"
    gen_path = f"{base_path}/{method}/"
    err = {"wer_s": 0, "wer_d": 0, "cer_s": 0, "cer_d": 0, "len": [], "emd": [],
           "w_ffe": [], "w_len": [], "p_ffe": [], "p_len": []}

    for trg in target_speakers:
        print(f"--- speaker {trg} -----")
        for f in sorted(glob.glob(f"{gen_path}/{trg}/*.wav")):
            if trg in f.split("/")[-1]:  # don't evaluate reconstruction
                continue
            seq = f.split("_")[-1].split(".")[0]
            gt_file = f"{gt_path}/{trg}_{seq}.wav"
            if not os.path.isfile(gt_file):
                print("No reference recording: ", f"{trg}_{seq}.wav")
                continue
            path = Path(f)
            if path.stem.split("_")[0] == "p270" and seq == "024":
                print("p270_024 is a problematic sample where content varies notably!")
                continue

            yref, sr_r = read_wav(gt_file, dtype="float32")
            ysyn, sr_s = read_wav(f, dtype="float32")
            assert sr_r == sr_s, f"{sr_r} != {sr_s}"

            err["len"].append(abs(len(yref) - len(ysyn)))

            if transcribe is not None:
                with open(f"{os.path.splitext(f)[0]}.txt") as fh:
                    ref_text = fh.readline()
                res = calc_asr_er(ref_text, transcribe(f))
                err["cer_s"] += res[0]
                err["cer_d"] += res[1]
                err["wer_s"] += res[2]
                err["wer_d"] += res[3]

            syn_pitch = get_yaapt(ysyn, sr_s, device)
            ref_pitch = get_yaapt(yref, sr_r, device)
            # The reference pads the contours *in place* before EMD and the
            # padded arrays then flow into aligned_ffe below (eval.py:96-102),
            # including the quirk that the second branch tests waveform
            # lengths, not pitch lengths.
            if ref_pitch.shape[0] > syn_pitch.shape[0]:
                syn_pitch = np.pad(syn_pitch, (0, ref_pitch.shape[0] - syn_pitch.shape[0]))
            elif len(yref) < len(ysyn):
                ref_pitch = np.pad(ref_pitch, (0, syn_pitch.shape[0] - ref_pitch.shape[0]))
            # not pitch_emd(): that would re-pad to equal length, which the
            # reference does not do when the elif above mis-fires
            err["emd"].append(float(wasserstein_distance(syn_pitch, ref_pitch)))

            ref_grid_path = f"{gt_path}/txtgrid/{trg}_{seq}.TextGrid"
            if not os.path.isfile(ref_grid_path):
                continue
            ref_grid = TextGrid.fromFile(ref_grid_path)
            syn_grid_path = path.parent / f"txtgrid/{path.stem}.TextGrid"
            syn_grid = TextGrid.fromFile(str(syn_grid_path)) if syn_grid_path.is_file() else None

            # host numpy only below: the except mirrors the reference's
            # per-tier drop of an utterance (eval.py:106-129)
            for tier, (len_key, ffe_key) in ((1, ("p_len", "p_ffe")), (0, ("w_len", "w_ffe"))):
                try:
                    ref_iv = [i for i in ref_grid[tier] if i.mark]
                    syn_iv = ([i for i in syn_grid[tier] if i.mark] if syn_grid
                              else uniform_fallback_grid(ref_grid, tier))
                    err[len_key].append(
                        np.abs(np.array([i.duration() for i in ref_iv])
                               - np.array([i.duration() for i in syn_iv])).mean()
                    )
                    err[ffe_key].append(aligned_ffe(ref_iv, syn_iv, ref_pitch, syn_pitch, sr))
                except (ValueError, IndexError):
                    pass
    return err


def log_results(err_dict: Dict, base_path: str, method: str, sr: int = 16000) -> Dict:
    """Pickle the raw errors to ``{base_path}/{method}_results.pkl`` and
    print and return the summary."""
    with open(f"{base_path}/{method}_results.pkl", "wb") as f:
        pickle.dump(err_dict, f)

    def mean(key, scale=1.0):
        return float(np.mean(err_dict[key]) / scale) if err_dict[key] else float("nan")

    summary = {
        "WER": err_dict["wer_s"] / max(err_dict["wer_d"], 1),
        "CER": err_dict["cer_s"] / max(err_dict["cer_d"], 1),
        "EMD": mean("emd"),
        "Len Error": mean("len", sr),
        "Word Len Error": mean("w_len"),
        "Char Len Error": mean("p_len"),
        "Word FFE": mean("w_ffe"),
        "Character FFE": mean("p_ffe"),
    }
    for k, v in summary.items():
        print(f"{k}: ", v)
    return summary
