"""Speaker-verification EER (``dissc_tpu.eval.sv``; reference ``eval_sv.py``).

The reference scores (ground truth, converted) pairs with speechbrain's
ECAPA model and computes EER with ``speechbrain.utils.metric_stats.EER``.
:func:`compute_eer` sweeps every observed score as a threshold, as the
JAX package does; the scorer is pluggable: :func:`run_sv_eval` takes any
``score(path_a, path_b) -> float``, and :func:`cosine_scorer` builds one
from an ``embed(wav) -> vector`` such as
:class:`~dissc_tpu_torch.models.ecapa.EcapaEmbedder`.

One difference from the JAX package: a class with no scored pair raises
``ValueError``, where the JAX sweep divides by zero.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Tuple

import numpy as np

from dissc_tpu_torch.core.wav import read_audio
from dissc_tpu_torch.data.stats import read_sv_pairs


def compute_eer(positive_scores: np.ndarray, negative_scores: np.ndarray) -> Tuple[float, float]:
    """Equal error rate and its threshold: FAR = P(neg >= thr), FRR =
    P(pos < thr) at every observed score; the rate is the mean of the two
    where they are closest."""
    positive_scores = np.sort(np.asarray(positive_scores, np.float64))
    negative_scores = np.sort(np.asarray(negative_scores, np.float64))
    if not len(positive_scores) or not len(negative_scores):
        raise ValueError(f"EER needs scores of both classes: {len(positive_scores)} positive, "
                         f"{len(negative_scores)} negative")
    thresholds = np.unique(np.concatenate([positive_scores, negative_scores]))
    far = (len(negative_scores)
           - np.searchsorted(negative_scores, thresholds, side="left")) / len(negative_scores)
    frr = np.searchsorted(positive_scores, thresholds, side="left") / len(positive_scores)
    i = int(np.argmin(np.abs(far - frr)))
    return float((far[i] + frr[i]) / 2.0), float(thresholds[i])


def cosine_scorer(embed: Callable[[np.ndarray], np.ndarray]) -> Callable[[str, str], float]:
    """A file-pair scorer: cosine similarity of the two files' embeddings."""

    def score(path_a: str, path_b: str) -> float:
        ea = embed(read_audio(path_a, dtype="float32")[0])
        eb = embed(read_audio(path_b, dtype="float32")[0])
        return float(np.dot(ea, eb) / (np.linalg.norm(ea) * np.linalg.norm(eb) + 1e-9))

    return score


def run_sv_eval(sample_csv: str, gt_path: str, syn_path: str,
                score_fn: Callable[[str, str], float], file_suffix: str = "_mic2.flac") -> float:
    """EER over the pair list (reference ``eval_sv.py:40-57``): each row
    scores ``<gt_path>/<ref><file_suffix>`` against
    ``<syn_path>/<syn_trgt>/<syn_sample>.wav`` into its ``label`` (0 or 1);
    a row with a missing file is printed and skipped, as in the reference."""
    scores: Dict[int, List[float]] = {0: [], 1: []}
    for row in read_sv_pairs(sample_csv):
        gt = f"{gt_path}/{row['ref']}{file_suffix}"
        syn = f"{syn_path}/{row['syn_trgt']}/{row['syn_sample']}.wav"
        if os.path.isfile(gt) and os.path.isfile(syn):
            scores[int(row["label"])].append(score_fn(gt, syn))
        else:
            print(row["ref"], row["syn_trgt"])
    eer, _ = compute_eer(np.asarray(scores[1]), np.asarray(scores[0]))
    print("\nEER:", eer)
    return eer
