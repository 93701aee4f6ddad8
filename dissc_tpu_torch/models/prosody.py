"""Rhythm (duration) and pitch-contour predictors (``dissc_tpu.models.prosody``).

* :class:`LenPredictor` — reference ``model/len_predictor.py:5-52``:
  token + speaker embeddings -> 8 conv layers with BatchNorm -> one
  duration per run, de-normalised by the train-set length stats.
* :class:`PitchPredictor` ("new": linear-ramp PE on the speaker embedding,
  BatchNorm on the neck only) and :class:`PitchPredictorBase` ("base":
  BatchNorm on the trunk and heads) -> a voicing logit and a whitened-f0
  regression per frame (reference ``model/pitch_predictor.py:41-176``).

Layout NCW; state-dict keys are the reference's, as ``compat.from_jax``
writes them.  ``length_mask`` (``[B, L]`` bool) zeroes activations past
each row's length after every block, so a padded batch equals each
utterance run alone.

In train mode (``module.train()``), as in the JAX models with
``train=True``:

* whole token-embedding vectors are zeroed per (batch, time) position with
  probability ``masking_rate`` (reference ``model/len_predictor.py:37-39``);
* the pitch model's ramp PE is followed by dropout at rate 0.4
  (``LinearRampPE.dropout``, fixed in the JAX model too);
* BatchNorm (:class:`FlaxBatchNorm`) normalises with the biased batch
  variance and moves its running statistics as flax does: momentum 0.1
  on the batch value, the *biased* variance, eps 1e-5.

The masks come from the ``generator`` passed to ``forward`` (a
``torch.Generator`` on the model's device), so a seeded trainer repeats
its draws; JAX's draws come from its own PRNG and are not reproduced.

Data parallelism (:func:`data_parallel`): each BatchNorm sums its batch
statistics over the ranks (differentiably), so the statistics and the
running averages are the global batch's, as in the JAX step on a sharded
batch; and each mask or dropout draw is made at the global batch's shape
from the same generator state on every rank, of which a rank keeps its
rows, so a step does not depend on the number of ranks.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dissc_tpu_torch.models.layers import Embed, torch_conv_init
from dissc_tpu_torch.parallel.collectives import psum_if

LEAKY_SLOPE = 0.01  # torch default, as the reference's nn.LeakyReLU()
PE_MAX_LEN = 850    # reference model/pitch_predictor.py:7


def _conv(in_ch: int, out_ch: int, k: int, generator: Optional[torch.Generator]) -> nn.Conv1d:
    """``nn.Conv1d`` with 'same' padding, torch's default init drawn from
    ``generator``."""
    conv = nn.utils.skip_init(nn.Conv1d, in_ch, out_ch, k, padding=(k - 1) // 2)
    init = torch_conv_init(in_ch * k)
    with torch.no_grad():
        conv.weight.copy_(init(tuple(conv.weight.shape), generator))
        conv.bias.copy_(init((out_ch,), generator))
    return conv


class FlaxBatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` (eps 1e-5, same parameters, buffers and state-dict
    keys) whose train-mode step is flax's ``BatchNorm``: the batch variance
    is E[x^2] - E[x]^2 clipped at 0 (biased), and the running variance moves
    toward that biased value.  ``nn.BatchNorm1d`` moves it toward the
    unbiased one, n/(n-1) larger.  Eval mode is ``nn.BatchNorm1d``'s.

    With a process ``group`` set, the train-mode mean and E[x^2] are the
    sums over every rank's rows divided by the global count (through
    :func:`~dissc_tpu_torch.parallel.collectives.psum_if`, so the gradient
    crosses ranks too).  ``nn.SyncBatchNorm`` would move the running
    variance toward the unbiased value."""

    def __init__(self, ch: int):
        super().__init__(ch, eps=1e-5, momentum=0.1)
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.group is None:
            mean = x.mean(dim=(0, 2))
            sq = (x * x).mean(dim=(0, 2))
        else:
            ch = x.shape[1]
            count = x.new_full((1,), float(x.shape[0] * x.shape[2]))
            sums = psum_if(torch.cat([x.sum(dim=(0, 2)), (x * x).sum(dim=(0, 2)), count]),
                           self.group)
            mean, sq = sums[:ch] / sums[-1], sums[ch:2 * ch] / sums[-1]
        var = torch.clamp(sq - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1 - self.momentum).add_(self.momentum * var)
            self.num_batches_tracked.add_(1)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return (x - mean[:, None]) * scale[:, None] + self.bias[:, None]


Shard = Optional[Tuple[int, int]]  # (rank, world) of a data-parallel step


def _rand(shape, generator: Optional[torch.Generator], device, shard: Shard) -> torch.Tensor:
    """``torch.rand(shape)``; under ``shard = (rank, world)`` the draw at the
    global batch's shape (``world`` times the rows), of which this rank's
    contiguous block is kept."""
    if shard is None:
        return torch.rand(shape, generator=generator, device=device)
    rank, world = shard
    full = torch.rand((shape[0] * world, *shape[1:]), generator=generator, device=device)
    return full[rank * shape[0]:(rank + 1) * shape[0]]


def _mask_embeddings(emb: torch.Tensor, keep_rate: float,
                     generator: Optional[torch.Generator], shard: Shard = None) -> torch.Tensor:
    """Zero whole per-position embedding vectors of ``[B, L, E]`` with
    probability ``1 - keep_rate`` (the JAX ``_mask_embeddings``)."""
    keep = _rand(emb.shape[:2], generator, emb.device, shard) <= keep_rate
    return emb * keep[..., None]


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
             shard: Shard = None) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``, drawn from ``generator``."""
    if rate == 0.0:
        return x
    keep = _rand(x.shape, generator, x.device, shard) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def data_parallel(model: nn.Module, group, rank: int, world: int) -> nn.Module:
    """Set ``model`` (a prosody predictor) for a data-parallel step over
    ``group``: its BatchNorms reduce their statistics over the ranks, and
    its masks and dropout are drawn at the global batch's shape, rank
    ``rank`` of ``world`` keeping its rows.  ``group=None`` undoes it."""
    for m in model.modules():
        if isinstance(m, FlaxBatchNorm):
            m.group = group
    model.batch_shard = None if group is None else (rank, world)
    return model


def _masker(length_mask: Optional[torch.Tensor]):
    if length_mask is None:
        return lambda z: z
    off = ~length_mask[:, None, :]
    return lambda z: z.masked_fill(off, 0.0)


def _embed_inputs(module: nn.Module, seq: torch.Tensor, spk_id: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """``[B, L]`` tokens, ``[B, 1]`` speakers -> ``[B, 2E, L]``; in train
    mode the token embeddings are masked (then the PE dropped out)."""
    emb_seq = module.token_emb(seq)
    if module.training:
        emb_seq = _mask_embeddings(emb_seq, 1.0 - module.masking_rate, generator,
                                   module.batch_shard)
    emb_spk = module.spk_emb(spk_id).expand(-1, seq.shape[1], -1)
    pe = getattr(module, "pe", None)
    if pe is not None:
        emb_spk = pe(emb_spk, generator, module.batch_shard)
    return torch.cat([emb_seq, emb_spk], dim=-1).transpose(1, 2)


class LenPredictor(nn.Module):
    """Per-run duration ("rhythm") predictor."""

    def __init__(self, n_tokens: int = 100, n_speakers: int = 99, emb_size: int = 32,
                 hidden: int = 128, masking_rate: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_tokens, self.masking_rate = n_tokens, masking_rate
        self.batch_shard: Shard = None  # set by data_parallel
        self.token_emb = Embed(n_tokens + 1, emb_size, padding_idx=n_tokens, generator=generator)
        self.spk_emb = Embed(n_speakers, emb_size, generator=generator)
        self.cnn1 = _conv(2 * emb_size, hidden, 3, generator)
        self.bn1 = FlaxBatchNorm(hidden)
        for i in range(1, 7):
            setattr(self, f"cnn1{i}", _conv(hidden, hidden, 3, generator))
            setattr(self, f"bn1{i}", FlaxBatchNorm(hidden))
        self.cnn2 = _conv(hidden, 1, 3, generator)

    def forward(self, seq: torch.Tensor, spk_id: torch.Tensor,
                norm_stats: Tuple[float, float],
                length_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``seq`` ``[B, L]`` (pad = n_tokens), ``spk_id`` ``[B, 1]``,
        ``norm_stats`` (mean, std) -> ``[B, L]`` float durations."""
        clamp = _masker(length_mask)
        x = clamp(_embed_inputs(self, seq, spk_id, generator))
        x = clamp(F.leaky_relu(self.bn1(self.cnn1(x)), LEAKY_SLOPE))
        for i in range(1, 7):
            bn, conv = getattr(self, f"bn1{i}"), getattr(self, f"cnn1{i}")
            x = clamp(F.leaky_relu(bn(conv(x)), LEAKY_SLOPE))
        out = self.cnn2(x)[:, 0]
        mean, std = norm_stats
        return out * std + mean


class LinearRampPE(nn.Module):
    """Linear-ramp positional encoding (reference ``model/pitch_predictor.py:6-38``):
    the first half of the channels ramps 0 -> 1 over ``max_len`` positions,
    the second half 1 -> 0, then dropout in train mode.  Positions past
    ``max_len - 1`` hold the last value, as in the JAX package (the
    reference's fixed buffer ends at 850; conversion at bucket 1280 reaches
    2560 frames)."""

    def __init__(self, d_model: int, max_len: int = PE_MAX_LEN, dropout: float = 0.4):
        super().__init__()
        self.d_model, self.max_len, self.dropout = d_model, max_len, dropout

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                shard: Shard = None) -> torch.Tensor:
        t = x.shape[1]
        pos = torch.arange(t, device=x.device).clamp(max=self.max_len - 1).float() / (self.max_len - 1)
        half = self.d_model // 2
        pe = torch.cat([pos[:, None].expand(t, half),
                        (1.0 - pos)[:, None].expand(t, self.d_model - half)], dim=-1)
        x = x + pe[None]
        return _dropout(x, self.dropout, generator, shard) if self.training else x


class _PitchCore(nn.Module):
    """Shared embed / trunk / heads of the two pitch variants."""

    use_pe = trunk_bn = head_bn = neck_bn = False

    def __init__(self, n_tokens: int = 100, n_speakers: int = 199, emb_size: int = 32,
                 hidden: int = 128, masking_rate: float = 0.4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_tokens, self.masking_rate = n_tokens, masking_rate
        self.batch_shard: Shard = None  # set by data_parallel
        self.token_emb = Embed(n_tokens + 1, emb_size, padding_idx=n_tokens, generator=generator)
        self.spk_emb = Embed(n_speakers + 1, emb_size, padding_idx=n_speakers,
                             generator=generator)
        self.pe = LinearRampPE(emb_size) if self.use_pe else None
        self.cnn1 = _conv(2 * emb_size, hidden, 3, generator)
        for i in range(1, 8):
            setattr(self, f"cnn1{i}", _conv(hidden, hidden, 3, generator))
        self.cnn2 = _conv(hidden, hidden, 3, generator)
        self.cnn_class1 = _conv(hidden, hidden, 3, generator)
        self.cnn_class2 = _conv(hidden, 1, 1, generator)
        self.cnn_reg1 = _conv(hidden, hidden, 3, generator)
        self.cnn_reg2 = _conv(hidden, 1, 1, generator)
        bns = []
        if self.trunk_bn:
            bns += ["bn1"] + [f"bn1{i}" for i in range(1, 8)]
        if self.neck_bn:
            bns.append("bn2")
        if self.head_bn:
            bns += ["bn_c1", "bn_r1"]
        for name in bns:
            setattr(self, name, FlaxBatchNorm(hidden))

    def forward(self, seq: torch.Tensor, spk_id: torch.Tensor,
                length_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``seq`` ``[B, L]``, ``spk_id`` ``[B, 1]`` -> (voicing logits,
        whitened f0), each ``[B, L]``."""
        clamp = _masker(length_mask)

        def block(z, conv, bn_name, with_bn):
            z = getattr(self, conv)(z)
            if with_bn:
                z = getattr(self, bn_name)(z)
            return clamp(F.leaky_relu(z, LEAKY_SLOPE))

        x = clamp(_embed_inputs(self, seq, spk_id, generator))
        x = block(x, "cnn1", "bn1", self.trunk_bn)
        for i in range(1, 8):
            x = block(x, f"cnn1{i}", f"bn1{i}", self.trunk_bn)
        x = block(x, "cnn2", "bn2", self.neck_bn)
        cls = self.cnn_class2(block(x, "cnn_class1", "bn_c1", self.head_bn))[:, 0]
        reg = self.cnn_reg2(block(x, "cnn_reg1", "bn_r1", self.head_bn))[:, 0]
        return cls, reg


class PitchPredictor(_PitchCore):
    """'new' pitch variant: ramp PE on the speaker embedding, BN on the neck only."""

    use_pe, neck_bn = True, True


class PitchPredictorBase(_PitchCore):
    """Paper ('base') pitch variant: no PE, BN on the trunk and heads."""

    trunk_bn, head_bn = True, True


def calc_freq(class_preds: torch.Tensor, reg_preds: torch.Tensor, spk_id: torch.Tensor,
              id2pitch_mean: torch.Tensor, id2pitch_std: torch.Tensor,
              norm: bool = False) -> torch.Tensor:
    """Voicing-gated de-whitened pitch (reference ``model/pitch_predictor.py:100-104``):
    ``(class > 0) * (mean[spk] + reg * std[spk])``, or the normalised
    regression if ``norm``."""
    if not norm:
        reg_preds = id2pitch_mean[spk_id] + reg_preds * id2pitch_std[spk_id]
    return (class_preds > 0) * reg_preds
