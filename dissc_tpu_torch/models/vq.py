"""EMA k-means vector-quantisation bottleneck (``dissc_tpu.models.vq``).

Reference ``sr/modules/vq.py`` (adapted from openai/jukebox):
nearest-centroid quantisation with straight-through gradients, EMA
codebook updates, random restart of dead codes, and usage / entropy
metrics.  The codebook state is four registered buffers per level (``k``,
``k_sum``, ``k_elem``, ``initted``); the JAX package keeps the same four
in its ``vq_state`` collection.  The first batch with ``update_k``
bootstraps the codebook from the data, and the restart draws (the data
tiled, plus ``N(0, 0.01 / sqrt(D))`` noise, permuted) come from the
``generator`` passed to ``forward``.  The reference's cross-rank
reduction of the EMA sums comes with the multi-GPU slice.

Layout NCW: a level's input is ``[B, D, T]``, its codes ``[B, T]``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dissc_tpu_torch.models.jukebox import Decoder, Encoder

Metrics = Dict[str, torch.Tensor]


class BottleneckBlock(nn.Module):
    def __init__(self, k_bins: int, emb_width: int, mu: float, threshold: float = 1.0):
        super().__init__()
        self.k_bins, self.emb_width, self.mu, self.threshold = k_bins, emb_width, mu, threshold
        self.register_buffer("k", torch.zeros(k_bins, emb_width))
        self.register_buffer("k_sum", torch.zeros(k_bins, emb_width))
        self.register_buffer("k_elem", torch.zeros(k_bins))
        self.register_buffer("initted", torch.zeros((), dtype=torch.bool))

    def _tile_to_bins(self, x: torch.Tensor, generator: Optional[torch.Generator]
                      ) -> torch.Tensor:
        """``k_bins`` rows of ``x`` (tiled when it has fewer), each plus
        ``N(0, 0.01 / sqrt(D))`` noise, in a random order."""
        n_repeats = -(-self.k_bins // x.shape[0])
        y = x.repeat(n_repeats, 1)
        std = 0.01 / math.sqrt(x.shape[1])
        y = y + torch.randn(y.shape, generator=generator, device=y.device) * std
        perm = torch.randperm(y.shape[0], generator=generator, device=y.device)
        return y[perm][: self.k_bins]

    def quantise(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``[N, D]`` -> nearest codes ``[N]`` and the mean squared distance."""
        k = self.k
        dist = (torch.sum(x * x, -1, keepdim=True) - 2 * x @ k.T
                + torch.sum(k * k, -1)[None, :])
        min_dist, x_l = torch.min(dist, -1)
        return x_l, torch.mean(min_dist)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        B, D, T = x.shape
        return self.quantise(x.permute(0, 2, 1).reshape(-1, D))[0].reshape(B, T)

    def decode(self, x_l: torch.Tensor) -> torch.Tensor:
        """Codes ``[B, T]`` -> ``[B, D, T]``."""
        return self.k[x_l].permute(0, 2, 1)

    def forward(self, x: torch.Tensor, update_k: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Metrics]:
        """``[B, D, T]`` -> (codes ``[B, T]``, quantised ``[B, D, T]`` with a
        straight-through gradient, commit loss, metrics)."""
        B, D, T = x.shape
        flat = x.permute(0, 2, 1).reshape(-1, D)
        with torch.no_grad():
            prenorm = torch.linalg.vector_norm(flat - torch.mean(flat)) / math.sqrt(flat.numel())
            if update_k and not bool(self.initted):
                k_init = self._tile_to_bins(flat, generator)
                self.k.copy_(k_init)
                self.k_sum.copy_(k_init)
                self.k_elem.fill_(1.0)
                self.initted.fill_(True)
            x_l, fit = self.quantise(flat)
            x_d = self.k[x_l]
            metrics: Metrics = dict(fit=fit, pn=prenorm)
            if update_k:
                metrics.update(self._update_k(flat, x_l, generator))
        commit_loss = torch.linalg.vector_norm(x_d - flat) ** 2 / flat.numel()
        x_q = flat + (x_d - flat).detach()
        return (x_l.reshape(B, T), x_q.reshape(B, T, D).permute(0, 2, 1), commit_loss,
                metrics)

    def _update_k(self, x: torch.Tensor, x_l: torch.Tensor,
                  generator: Optional[torch.Generator]) -> Metrics:
        """EMA codebook update with dead-code restart (``sr/modules/vq.py:59-90``)."""
        onehot = F.one_hot(x_l, self.k_bins).to(x.dtype)
        _k_sum = onehot.T @ x
        _k_elem = onehot.sum(0)
        _k_rand = self._tile_to_bins(x, generator)
        old_k = self.k.clone()
        k_sum = self.mu * self.k_sum + (1.0 - self.mu) * _k_sum
        k_elem = self.mu * self.k_elem + (1.0 - self.mu) * _k_elem
        usage = (k_elem[:, None] >= self.threshold).to(x.dtype)
        new_k = (usage * (k_sum / torch.clamp(k_elem[:, None], min=1e-8))
                 + (1 - usage) * _k_rand)
        self.k_sum.copy_(k_sum)
        self.k_elem.copy_(k_elem)
        self.k.copy_(new_k)
        _k_prob = _k_elem / torch.clamp(torch.sum(_k_elem), min=1e-8)
        return dict(
            entropy=-torch.sum(_k_prob * torch.log(_k_prob + 1e-8)),
            used_curr=torch.sum(_k_elem >= self.threshold),
            usage=torch.sum(usage),
            dk=torch.linalg.vector_norm(new_k - old_k) / math.sqrt(old_k.numel()),
        )


class Bottleneck(nn.Module):
    """One :class:`BottleneckBlock` per level (reference ``sr/modules/vq.py:187-221``)."""

    def __init__(self, l_bins: int, emb_width: int, mu: float, levels: int):
        super().__init__()
        self.level_blocks = nn.ModuleList(BottleneckBlock(l_bins, emb_width, mu)
                                          for _ in range(levels))

    def encode(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [blk.encode(x) for blk, x in zip(self.level_blocks, xs)]

    def decode(self, zs: Sequence[torch.Tensor], start_level: int = 0,
               end_level: Optional[int] = None) -> List[torch.Tensor]:
        blocks = self.level_blocks[start_level:end_level]
        return [blk.decode(z) for blk, z in zip(blocks, zs)]

    def forward(self, xs: Sequence[torch.Tensor], update_k: bool = True,
                generator: Optional[torch.Generator] = None):
        """Per level: codes, quantised maps (gradient stopped when the
        codebook is not updated), commit losses, metrics."""
        zs, xs_q, commit_losses, metrics = [], [], [], []
        for blk, x in zip(self.level_blocks, xs):
            z, x_q, commit, metric = blk(x, update_k=update_k, generator=generator)
            zs.append(z)
            xs_q.append(x_q if update_k else x_q.detach())
            commit_losses.append(commit)
            metrics.append(metric)
        return zs, xs_q, commit_losses, metrics


class Quantizer(nn.Module):
    """Encoder -> VQ -> Decoder F0-VQVAE (reference ``sr/models.py:336-349``):
    ``[B, 1, T]`` f0 -> (reconstruction ``[B, 1, T]``, commit losses,
    metrics)."""

    def __init__(self, f0_encoder_params: dict, f0_vq_params: dict, f0_decoder_params: dict,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = Encoder(**f0_encoder_params, generator=generator)
        self.vq = Bottleneck(**f0_vq_params)
        self.decoder = Decoder(**f0_decoder_params, generator=generator)

    def forward(self, f0: torch.Tensor, update_k: bool = True,
                generator: Optional[torch.Generator] = None):
        _, f0_h_q, commit_losses, metrics = self.vq(self.encoder(f0), update_k, generator)
        return self.decoder(f0_h_q), commit_losses, metrics
