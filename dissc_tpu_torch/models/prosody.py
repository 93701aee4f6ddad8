"""Rhythm (duration) and pitch-contour predictors (``dissc_tpu.models.prosody``).

* :class:`LenPredictor` — reference ``model/len_predictor.py:5-52``:
  token + speaker embeddings -> 8 conv layers with BatchNorm -> one
  duration per run, de-normalised by the train-set length stats.
* :class:`PitchPredictor` ("new": linear-ramp PE on the speaker embedding,
  BatchNorm on the neck only) and :class:`PitchPredictorBase` ("base":
  BatchNorm on the trunk and heads) -> a voicing logit and a whitened-f0
  regression per frame (reference ``model/pitch_predictor.py:41-176``).

Inference only: BatchNorm runs in eval mode (eps 1e-5) and the train-time
token masking is not ported.  Layout NCW; state-dict keys are the
reference's, as ``compat.from_jax`` writes them.  ``length_mask``
(``[B, L]`` bool) zeroes activations past each row's length after every
block, so a padded batch equals each utterance run alone.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dissc_tpu_torch.models.layers import Embed, torch_conv_init

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


def _bn(ch: int) -> nn.BatchNorm1d:
    return nn.BatchNorm1d(ch, eps=1e-5, momentum=0.1)


def _masker(length_mask: Optional[torch.Tensor]):
    if length_mask is None:
        return lambda z: z
    off = ~length_mask[:, None, :]
    return lambda z: z.masked_fill(off, 0.0)


def _embed_inputs(token_emb: Embed, spk_emb: Embed, seq: torch.Tensor, spk_id: torch.Tensor,
                  pe: Optional["LinearRampPE"] = None) -> torch.Tensor:
    """``[B, L]`` tokens, ``[B, 1]`` speakers -> ``[B, 2E, L]``."""
    emb_seq = token_emb(seq)
    emb_spk = spk_emb(spk_id).expand(-1, seq.shape[1], -1)
    if pe is not None:
        emb_spk = pe(emb_spk)
    return torch.cat([emb_seq, emb_spk], dim=-1).transpose(1, 2)


class LenPredictor(nn.Module):
    """Per-run duration ("rhythm") predictor."""

    def __init__(self, n_tokens: int = 100, n_speakers: int = 99, emb_size: int = 32,
                 hidden: int = 128, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.token_emb = Embed(n_tokens + 1, emb_size, padding_idx=n_tokens, generator=generator)
        self.spk_emb = Embed(n_speakers, emb_size, generator=generator)
        self.cnn1 = _conv(2 * emb_size, hidden, 3, generator)
        self.bn1 = _bn(hidden)
        for i in range(1, 7):
            setattr(self, f"cnn1{i}", _conv(hidden, hidden, 3, generator))
            setattr(self, f"bn1{i}", _bn(hidden))
        self.cnn2 = _conv(hidden, 1, 3, generator)

    def forward(self, seq: torch.Tensor, spk_id: torch.Tensor,
                norm_stats: Tuple[float, float],
                length_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``seq`` ``[B, L]`` (pad = n_tokens), ``spk_id`` ``[B, 1]``,
        ``norm_stats`` (mean, std) -> ``[B, L]`` float durations."""
        clamp = _masker(length_mask)
        x = clamp(_embed_inputs(self.token_emb, self.spk_emb, seq, spk_id))
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
    the second half 1 -> 0.  Positions past ``max_len - 1`` hold the last
    value, as in the JAX package (the reference's fixed buffer ends at 850;
    conversion at bucket 1280 reaches 2560 frames)."""

    def __init__(self, d_model: int, max_len: int = PE_MAX_LEN):
        super().__init__()
        self.d_model, self.max_len = d_model, max_len

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        pos = torch.arange(t, device=x.device).clamp(max=self.max_len - 1).float() / (self.max_len - 1)
        half = self.d_model // 2
        pe = torch.cat([pos[:, None].expand(t, half),
                        (1.0 - pos)[:, None].expand(t, self.d_model - half)], dim=-1)
        return x + pe[None]


class _PitchCore(nn.Module):
    """Shared embed / trunk / heads of the two pitch variants."""

    use_pe = trunk_bn = head_bn = neck_bn = False

    def __init__(self, n_tokens: int = 100, n_speakers: int = 199, emb_size: int = 32,
                 hidden: int = 128, generator: Optional[torch.Generator] = None):
        super().__init__()
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
            setattr(self, name, _bn(hidden))

    def forward(self, seq: torch.Tensor, spk_id: torch.Tensor,
                length_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``seq`` ``[B, L]``, ``spk_id`` ``[B, 1]`` -> (voicing logits,
        whitened f0), each ``[B, L]``."""
        clamp = _masker(length_mask)

        def block(z, conv, bn_name, with_bn):
            z = getattr(self, conv)(z)
            if with_bn:
                z = getattr(self, bn_name)(z)
            return clamp(F.leaky_relu(z, LEAKY_SLOPE))

        x = clamp(_embed_inputs(self.token_emb, self.spk_emb, seq, spk_id, self.pe))
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
