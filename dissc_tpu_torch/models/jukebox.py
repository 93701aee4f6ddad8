"""Jukebox-style 1D conv encoder/decoder of the F0-VQ path
(``dissc_tpu.models.jukebox``).

Reference ``sr/modules/jukebox.py`` + ``resnet.py`` (adapted from
openai/jukebox): strided-conv downsampling stacks with dilated residual
blocks, and the transposed-conv mirror.  Used by the F0-VQVAE
``Quantizer`` (``sr/models.py:336-349``) and by ``CodeGenerator``'s
``lambda_commit`` branch.

NCW layout.  The convs are plain (no weight norm), with torch's default
init drawn from an explicit generator.  Modules nest as the reference
builds them, in ``nn.Sequential``s, so state-dict keys are the
reference's: ``level_blocks.l.model.i.0`` (a down conv),
``level_blocks.l.model.i.1.model.d.model.{1,3}`` (a residual block's
convs), ``level_blocks.l.model.<down_t>`` (the projection), and for the
decoder ``level_blocks.l.model.0`` (projection),
``level_blocks.l.model.<i+1>.{0,1}`` (residual stack, up conv) and ``out``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn as nn

from dissc_tpu_torch.models.layers import Conv1d, ConvTranspose1d


def _zeros(shape, generator=None):
    return torch.zeros(shape)


class ResConv1DBlock(nn.Module):
    """relu -> dilated k3 conv -> relu -> k1 conv, scaled residual."""

    def __init__(self, n_in: int, n_state: int, dilation: int = 1, zero_out: bool = False,
                 res_scale: float = 1.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.model = nn.Sequential(
            nn.ReLU(),
            Conv1d(n_in, n_state, 3, dilation=dilation, padding=dilation, generator=generator),
            nn.ReLU(),
            Conv1d(n_state, n_in, 1, padding=0, kernel_init=_zeros if zero_out else None,
                   generator=generator))
        self.res_scale = res_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.res_scale * self.model(x)


class Resnet1D(nn.Module):
    """``n_depth`` residual blocks at dilation ``growth ** (d % cycle)``;
    with ``reverse_dilation`` they run deepest first."""

    def __init__(self, n_in: int, n_depth: int, m_conv: float = 1.0,
                 dilation_growth_rate: int = 1, dilation_cycle: Optional[int] = None,
                 zero_out: bool = False, res_scale: bool = False,
                 reverse_dilation: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        blocks = [ResConv1DBlock(
            n_in, int(m_conv * n_in),
            dilation=dilation_growth_rate ** (d if dilation_cycle is None else d % dilation_cycle),
            zero_out=zero_out,
            res_scale=1.0 if not res_scale else 1.0 / math.sqrt(n_depth),
            generator=generator) for d in range(n_depth)]
        self.model = nn.Sequential(*(blocks[::-1] if reverse_dilation else blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class EncoderConvBlock(nn.Module):
    """``down_t`` x (conv of filter ``2s``, stride ``s``, padding ``s//2``,
    then a residual stack), then a k3 projection."""

    def __init__(self, input_emb_width: int, output_emb_width: int, down_t: int, stride_t: int,
                 width: int, depth: int, m_conv: float, dilation_growth_rate: int = 1,
                 dilation_cycle: Optional[int] = None, zero_out: bool = False,
                 res_scale: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        filt, pad = stride_t * 2, stride_t // 2
        blocks: List[nn.Module] = [nn.Sequential(
            Conv1d(input_emb_width if i == 0 else width, width, filt, stride=stride_t,
                   padding=pad, generator=generator),
            Resnet1D(width, depth, m_conv, dilation_growth_rate, dilation_cycle, zero_out,
                     res_scale, generator=generator)) for i in range(down_t)]
        blocks.append(Conv1d(width, output_emb_width, 3, padding=1, generator=generator))
        self.model = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class DecoderConvBlock(nn.Module):
    """A k3 projection, then ``down_t`` x (residual stack, transposed conv of
    filter ``2s``, stride ``s``, padding ``s//2`` in torch's formula)."""

    def __init__(self, input_emb_width: int, output_emb_width: int, down_t: int, stride_t: int,
                 width: int, depth: int, m_conv: float, dilation_growth_rate: int = 1,
                 dilation_cycle: Optional[int] = None, zero_out: bool = False,
                 res_scale: bool = False, reverse_decoder_dilation: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        filt, pad = stride_t * 2, stride_t // 2
        blocks: List[nn.Module] = [Conv1d(output_emb_width, width, 3, padding=1,
                                          generator=generator)]
        for i in range(down_t):
            blocks.append(nn.Sequential(
                Resnet1D(width, depth, m_conv, dilation_growth_rate, dilation_cycle, zero_out,
                         res_scale, reverse_dilation=reverse_decoder_dilation,
                         generator=generator),
                ConvTranspose1d(width, input_emb_width if i == down_t - 1 else width, filt,
                                stride_t, padding=pad, generator=generator)))
        self.model = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class Encoder(nn.Module):
    """Multi-level strided encoder: ``[B, C_in, T]`` -> one ``[B, D, T_l]``
    feature map per level."""

    def __init__(self, input_emb_width: int, output_emb_width: int, levels: int,
                 downs_t: Sequence[int], strides_t: Sequence[int], width: int = 32,
                 depth: int = 4, m_conv: float = 1.0, dilation_growth_rate: int = 1,
                 dilation_cycle: Optional[int] = None, zero_out: bool = False,
                 res_scale: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.level_blocks = nn.ModuleList(
            EncoderConvBlock(input_emb_width if level == 0 else output_emb_width,
                             output_emb_width, downs_t[level], strides_t[level], width, depth,
                             m_conv, dilation_growth_rate, dilation_cycle, zero_out, res_scale,
                             generator=generator)
            for level in range(levels))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        xs = []
        for block in self.level_blocks:
            x = block(x)
            xs.append(x)
        return xs


class Decoder(nn.Module):
    """Mirror of :class:`Encoder`: consumes the level features coarsest
    first, adding the skip of level ``l - 1`` after level ``l``."""

    def __init__(self, input_emb_width: int, output_emb_width: int, levels: int,
                 downs_t: Sequence[int], strides_t: Sequence[int], width: int = 32,
                 depth: int = 4, m_conv: float = 1.0, dilation_growth_rate: int = 1,
                 dilation_cycle: Optional[int] = None, zero_out: bool = False,
                 res_scale: bool = False, reverse_decoder_dilation: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.level_blocks = nn.ModuleList(
            DecoderConvBlock(output_emb_width, output_emb_width, downs_t[level],
                             strides_t[level], width, depth, m_conv, dilation_growth_rate,
                             dilation_cycle, zero_out, res_scale, reverse_decoder_dilation,
                             generator=generator)
            for level in range(levels))
        self.out = Conv1d(output_emb_width, input_emb_width, 3, padding=1, generator=generator)

    def forward(self, xs: Sequence[torch.Tensor], all_levels: bool = True) -> torch.Tensor:
        x = xs[-1]
        for level in reversed(range(len(self.level_blocks))):
            x = self.level_blocks[level](x)
            if level != 0 and all_levels:
                x = x + xs[level - 1]
        return self.out(x)
