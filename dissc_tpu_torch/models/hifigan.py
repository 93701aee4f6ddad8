"""HiFi-GAN unit-to-waveform vocoder (``dissc_tpu.models.hifigan``).

Reference ``sr/models.py:16-225`` (adapted from jik876/hifi-gan): a
7-wide pre-conv, weight-norm transposed-conv upsamplers (rates
5*4*4*2*2 = 320 = the unit hop), each followed by a multi-receptive-field
(MRF) bank of dilated ResBlocks whose outputs are averaged, then a tanh
post-conv.  NCW inside; the public forward takes the JAX package's
layout (``code [B, T]``, ``f0 [B, Tf, 1]``, ``spkr [B, 1]``) and returns
``[B, T' * 320]``.  Parameter names are the reference state-dict keys
(``conv_pre``, ``ups.i``, ``resblocks.n.convs1.j``, ``dict``, ``spkr``).

The JAX package's space-to-channel packed MRF and waveform head are TPU
layouts with the same numbers; the port runs the plain MRF.

``compute_dtype="bfloat16"`` runs ``conv_pre``, the upsamplers and the MRF
blocks in bfloat16 (so their leaky-ReLUs, skip sums and the bank average
too), with float32 parameters; the activations are cast back to float32
before ``conv_post``, which runs in float32 with the ``tanh``, so the
waveform is float32 (``dissc_tpu/models/hifigan.py:186-236``).

With ``lambda_commit`` set, ``CodeGenerator`` quantises its f0 through a
jukebox ``Encoder`` (``f0_encoder``) and an EMA ``Bottleneck`` (``f0_vq``)
and returns ``(wav, commit_losses, metrics)``, as the JAX package does
(``dissc_tpu/models/hifigan.py:264-305``).  Reference behaviours mirrored
on purpose: the branch updates the codebook on every forward
(``update_k=True``, at inference too), and the vocoder trainer has no VQ
commit loss; ``GANTrainer`` and ``VocoderEngine`` refuse such a config.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from dissc_tpu_torch.core.config import VocoderConfig, resolve_dtype
from dissc_tpu_torch.core.seqops import nearest_upsample
from dissc_tpu_torch.models.jukebox import Encoder
from dissc_tpu_torch.models.layers import (Conv1d, ConvTranspose1d, Embed, hifigan_init,
                                           leaky_relu)
from dissc_tpu_torch.models.vq import Bottleneck


def refuse_f0_vq(h: VocoderConfig, who: str) -> None:
    """Raise for a ``lambda_commit`` config: its ``CodeGenerator`` returns
    ``(wav, commit_losses, metrics)``, which neither the vocoder trainer nor
    the serving engine takes, in the JAX package (it fails on the tuple)
    or in the reference (no VQ commit loss in ``sr/train.py``)."""
    if h.lambda_commit:
        raise NotImplementedError(
            f"{who} takes the LUT generator only: lambda_commit={h.lambda_commit} builds the "
            "F0-VQ branch, which returns (wav, commit_losses, metrics) and has no commit "
            "loss in the trainer (ROADMAP: deliberate differences)")


class ResBlock1(nn.Module):
    """MRF residual block '1': per dilation, lrelu -> dilated conv -> lrelu
    -> conv, with a skip (reference ``sr/models.py:16-47``)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5), norm: Optional[str] = "weight",
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        conv = lambda d: Conv1d(channels, channels, kernel_size, dilation=d, norm=norm,
                                kernel_init=hifigan_init(), generator=generator, dtype=dtype)
        self.convs1 = nn.ModuleList(conv(d) for d in dilations)
        self.convs2 = nn.ModuleList(conv(1) for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = c2(leaky_relu(c1(leaky_relu(x)))) + x
        return x


class ResBlock2(nn.Module):
    """MRF residual block '2': per dilation, lrelu -> dilated conv, with a
    skip (reference ``sr/models.py:50-65``)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3), norm: Optional[str] = "weight",
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d, norm=norm,
                   kernel_init=hifigan_init(), generator=generator, dtype=dtype)
            for d in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = c(leaky_relu(x)) + x
        return x


class Generator(nn.Module):
    """Conditioning ``[B, model_in_dim, T]`` -> waveform ``[B, T*320]``
    (reference ``sr/models.py:72-122``)."""

    def __init__(self, h: VocoderConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.h = h
        self.num_kernels = len(h.resblock_kernel_sizes)
        wn = None if h.folded_weights else "weight"
        dtype = resolve_dtype(h.compute_dtype)
        block_cls = ResBlock1 if h.resblock == "1" else ResBlock2
        ch = h.upsample_initial_channel
        self.conv_pre = Conv1d(h.model_in_dim, ch, 7, padding=3, norm=wn, generator=generator,
                               dtype=dtype)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
            out_ch = h.upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(ConvTranspose1d(ch, out_ch, k, u, padding=(k - u) // 2, norm=wn,
                                            kernel_init=hifigan_init(), generator=generator,
                                            dtype=dtype))
            for rk, rd in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes):
                self.resblocks.append(block_cls(out_ch, rk, tuple(rd), norm=wn,
                                                generator=generator, dtype=dtype))
            ch = out_ch
        # the waveform head runs in float32 whatever the compute dtype
        self.conv_post = Conv1d(ch, 1, 7, padding=3, norm=wn, kernel_init=hifigan_init(),
                                generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(x)
        for i, up in enumerate(self.ups):
            x = up(leaky_relu(x))
            banks = self.resblocks[i * self.num_kernels:(i + 1) * self.num_kernels]
            acc = banks[0](x)
            for block in banks[1:]:
                acc = acc + block(x)
            x = acc / self.num_kernels
        # slope 0.01, not LRELU_SLOPE: the reference's final activation is
        # F.leaky_relu(x) with torch's default (sr/models.py:110)
        x = leaky_relu(x, 0.01).float()
        return torch.tanh(self.conv_post(x))[:, 0]


class CodeGenerator(Generator):
    """Input assembly + Generator (reference ``sr/models.py:125-225``).

    Unit LUT embedding (+ per-frame F0 channel, nearest-upsampled to the
    finer rate, + speaker embedding broadcast over time) ->
    ``[B, T', model_in_dim]`` -> Generator.  The speaker table holds 200
    rows, the reference's fixed capacity (``sr/models.py:133``).  With
    ``lambda_commit``, the f0 goes through ``f0_encoder`` and ``f0_vq``
    first, and the first level's quantised map takes its place.
    """

    def __init__(self, h: VocoderConfig, generator: Optional[torch.Generator] = None):
        super().__init__(h, generator)
        self.dict = Embed(h.num_embeddings, h.embedding_dim, generator=generator)
        self.spkr = Embed(200, h.embedding_dim, generator=generator) if h.multispkr else None
        if h.lambda_commit:
            self.f0_encoder = Encoder(**h.f0_encoder_params, generator=generator)
            self.f0_vq = Bottleneck(**h.f0_vq_params)

    def assemble(self, code: torch.Tensor, f0: Optional[torch.Tensor] = None,
                 spkr: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``code [B, T]`` ints, ``f0 [B, Tf, 1]``, ``spkr [B, 1]`` ->
        ``[B, T', C]`` conditioning; the coarser of code and f0 is
        nearest-repeated up to the finer rate (``sr/models.py:206-221``)."""
        h = self.h
        x = self.dict(code)
        if h.f0 and f0 is not None:
            if x.shape[1] < f0.shape[1]:
                x = nearest_upsample(x, f0.shape[1] // x.shape[1])
            elif f0.shape[1] < x.shape[1]:
                f0 = nearest_upsample(f0, x.shape[1] // f0.shape[1])
            x = torch.cat([x, f0.to(x.dtype)], dim=-1)
        if self.spkr is not None and spkr is not None:
            s = self.spkr(spkr[..., 0])[:, None, :]
            x = torch.cat([x, s.expand(x.shape[0], x.shape[1], s.shape[-1])], dim=-1)
        return x

    def forward(self, code: torch.Tensor, f0: Optional[torch.Tensor] = None,
                spkr: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """The waveform; with ``lambda_commit``, ``(wav, commit_losses,
        metrics)``, the codebook updated from this batch (restart draws from
        ``generator``)."""
        if self.h.lambda_commit:
            f0_h = self.f0_encoder(f0.transpose(1, 2))
            _, f0_q, commit_losses, metrics = self.f0_vq(f0_h, update_k=True,
                                                         generator=generator)
            x = self.assemble(code, f0_q[0].transpose(1, 2), spkr)
            return super().forward(x.transpose(1, 2)), commit_losses, metrics
        return super().forward(self.assemble(code, f0, spkr).transpose(1, 2))
