"""Mini-batch k-means for training unit codebooks (``dissc_tpu.models.kmeans``).

The reference consumes a pretrained sklearn k-means quantizer through
textlesslib (``data/encode.py:21-22``); this trains a ``[vocab, width]``
codebook over HuBERT features: seeds drawn from the data with numpy, then
mini-batch Lloyd updates (Sculley 2010), each one f32 distance product,
an argmin and one-hot sums, with per-cluster rate ``m / (n + m)``.  The
seeding and the batch order follow the JAX package's numpy draws, so the
same seed gives the same run.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dissc_tpu_torch.device import DeviceLike, resolve_device


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """``[N, d]`` -> nearest centroid ids ``[N]`` (squared distance in f32)."""
    dist = (torch.sum(x * x, -1, keepdim=True) - 2 * x @ centroids.T
            + torch.sum(centroids * centroids, -1)[None, :])
    return torch.argmin(dist, -1)


def minibatch_update(x: torch.Tensor, centroids: torch.Tensor, counts: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Lloyd step on a batch: ``c += (mean_batch - c) * m / (n + m)``
    for each cluster with ``m`` batch members and ``n`` earlier ones.
    Returns (centroids, counts, mean inertia of the batch)."""
    k = centroids.shape[0]
    labels = assign(x, centroids)
    onehot = F.one_hot(labels, k).to(x.dtype)
    batch_counts = onehot.sum(0)
    batch_sums = onehot.T @ x
    new_counts = counts + batch_counts
    lr = torch.where(batch_counts > 0, batch_counts / torch.clamp(new_counts, min=1.0),
                     torch.zeros_like(batch_counts))
    batch_means = batch_sums / torch.clamp(batch_counts[:, None], min=1.0)
    centroids = centroids + lr[:, None] * (batch_means - centroids)
    inertia = torch.mean(torch.sum((x - centroids[labels]) ** 2, -1))
    return centroids, new_counts, inertia


def train_kmeans(feature_batches: Iterable[np.ndarray], k: int = 100, n_epochs: int = 5,
                 seed: int = 0, init_samples: Optional[np.ndarray] = None,
                 device: DeviceLike = None) -> Tuple[np.ndarray, float]:
    """Fit a ``[k, d]`` codebook over ``[N, d]`` feature batches on ``device``
    (``None``: the CUDA card).  Returns (centroids, the last batch's mean
    inertia)."""
    dev = resolve_device(device)
    batches = list(feature_batches)
    if not batches:
        raise ValueError("no feature batches")
    d = batches[0].shape[-1]

    rng = np.random.default_rng(seed)
    if init_samples is None:
        init_samples = np.concatenate([b[: max(1, k // len(batches) + 1)]
                                       for b in batches])[: 4 * k]
    if init_samples.shape[0] < k:
        init_samples = np.tile(init_samples, (-(-k // init_samples.shape[0]), 1))
    centroids = torch.as_tensor(
        init_samples[rng.permutation(init_samples.shape[0])[:k]].astype(np.float32), device=dev)
    counts = torch.zeros(k, dtype=torch.float32, device=dev)
    on_dev = [torch.as_tensor(np.asarray(b, np.float32).reshape(-1, d), device=dev)
              for b in batches]

    inertia = torch.tensor(float("inf"))
    for _ in range(n_epochs):
        for bi in rng.permutation(len(batches)):
            centroids, counts, inertia = minibatch_update(on_dev[bi], centroids, counts)
    return centroids.cpu().numpy(), float(inertia)
