"""GAN discriminators: multi-period (MPD) and multi-scale (MSD).

Reference ``sr/models.py:228-333`` (``dissc_tpu.models.discriminators``).
Inputs are waveforms ``[B, T]``; each sub-discriminator returns its score
``[B, N]`` and its per-layer feature maps (NCHW for the MPD, NCW for the
MSD) for the feature-match loss.  Parameter names are the reference's
(``discriminators.i.convs.j``, ``discriminators.i.conv_post``).

``dtype`` (the config's ``disc_compute_dtype``) runs every conv in that
dtype with float32 parameters, as the JAX discriminators' ``dtype``: the
reflect pad and the average pool act on the float32 waveform, and the
scores and feature maps come out in ``dtype``; the GAN losses cast each
to float32 before they reduce.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dissc_tpu_torch.models.layers import Conv1d, Conv2d, leaky_relu, same_padding

Scores = List[torch.Tensor]
FeatureMaps = List[List[torch.Tensor]]


class DiscriminatorP(nn.Module):
    """Period discriminator: reflect-pad to a multiple of the period, fold
    to ``[B, 1, T/p, p]`` and run ``(k, 1)`` convs along T/p
    (reference ``sr/models.py:228-260``).  Weight norm on every conv: no
    caller of the reference turns on its spectral-norm variant."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.period = period
        conv = functools.partial(Conv2d, norm="weight", generator=generator, dtype=dtype)
        pad = same_padding(5, 1)
        chans = [1, 32, 128, 512, 1024]
        self.convs = nn.ModuleList(
            conv(cin, cout, (kernel_size, 1), (stride, 1), (pad, 0))
            for cin, cout in zip(chans[:-1], chans[1:]))
        self.convs.append(conv(1024, 1024, (kernel_size, 1), (1, 1), (2, 0)))
        self.conv_post = conv(1024, 1, (3, 1), (1, 1), (1, 0))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        b, t = x.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x[:, None], (0, n_pad), mode="reflect")[:, 0]
            t += n_pad
        x = x.reshape(b, 1, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = leaky_relu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """Period discriminators at primes 2,3,5,7,11 (reference ``sr/models.py:263-282``)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorP(p, generator=generator, dtype=dtype)
                                            for p in periods)

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor
                ) -> Tuple[Scores, Scores, FeatureMaps, FeatureMaps]:
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for d in self.discriminators:
            s_r, f_r = d(y)
            s_g, f_g = d(y_hat)
            y_d_rs.append(s_r)
            y_d_gs.append(s_g)
            fmap_rs.append(f_r)
            fmap_gs.append(f_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs


# (in, out, kernel, stride, groups, padding) per conv of a scale discriminator
# (reference sr/models.py:287-300), and of its conv_post
MSD_SPECS = (
    (1, 128, 15, 1, 1, 7),
    (128, 128, 41, 2, 4, 20),
    (128, 256, 41, 2, 16, 20),
    (256, 512, 41, 4, 16, 20),
    (512, 1024, 41, 4, 16, 20),
    (1024, 1024, 41, 1, 16, 20),
    (1024, 1024, 5, 1, 1, 2),
)
MSD_POST = (1024, 1, 3, 1, 1, 1)


class DiscriminatorS(nn.Module):
    """Scale discriminator: grouped wide 1D convs (reference ``sr/models.py:285-307``)."""

    def __init__(self, use_spectral_norm: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        conv = functools.partial(Conv1d, norm="spectral" if use_spectral_norm else "weight",
                                 generator=generator, dtype=dtype)
        self.convs = nn.ModuleList(conv(cin, cout, k, stride=s, groups=g, padding=p)
                                   for cin, cout, k, s, g, p in MSD_SPECS)
        cin, cout, k, s, g, p = MSD_POST
        self.conv_post = conv(cin, cout, k, stride=s, groups=g, padding=p)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        x = x[:, None]
        fmap = []
        for conv in self.convs:
            x = leaky_relu(conv(x))
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class MultiScaleDiscriminator(nn.Module):
    """Scale discriminators on 1x, 2x-, 4x-, ... avg-pooled audio; scale 0
    is spectral-normed (reference ``sr/models.py:310-333``).  The pool is
    ``AvgPool1d(4, 2, padding=2)`` with the zero pads counted."""

    def __init__(self, scales: int = 3, generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.discriminators = nn.ModuleList(
            DiscriminatorS(use_spectral_norm=(i == 0), generator=generator, dtype=dtype)
            for i in range(scales))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor
                ) -> Tuple[Scores, Scores, FeatureMaps, FeatureMaps]:
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        for i, d in enumerate(self.discriminators):
            if i:
                y = F.avg_pool1d(y[:, None], 4, 2, padding=2)[:, 0]
                y_hat = F.avg_pool1d(y_hat[:, None], 4, 2, padding=2)[:, 0]
            s_r, f_r = d(y)
            s_g, f_g = d(y_hat)
            y_d_rs.append(s_r)
            y_d_gs.append(s_g)
            fmap_rs.append(f_r)
            fmap_gs.append(f_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
