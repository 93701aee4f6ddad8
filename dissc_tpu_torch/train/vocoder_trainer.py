"""HiFi-GAN vocoder GAN step (``dissc_tpu.train.vocoder_trainer``).

Step semantics follow the reference order (``sr/train.py:140-191``):

1. generator forward on the segment batch, once;
2. D step: MPD + MSD LS-GAN loss on ``(y, y_hat.detach())``, AdamW update;
3. G step against the *updated* discriminators: LS-GAN adversarial +
   feature-match + 45 x mel-L1, AdamW update.  The discriminators'
   parameters do not take gradients in this step (the JAX step
   differentiates with respect to ``y_hat`` only).

The MSD's spectral-norm ``u`` advances on every call in train mode: real
then fake pass in the D step, and again in the G step, as in the JAX
step and the reference.

Both optimizers are ``torch.optim.AdamW(lr, (b1, b2), eps=1e-8,
weight_decay=0.01)``, which is ``optax.adamw(..., weight_decay=0.01)``.
The mel function is picked by config, as ``_pick_mel_fn`` picks: on the
card with ``hop | n_fft`` and ``win <= n_fft`` it is the fused kernel
(:func:`~dissc_tpu_torch.kernels.mel_kernel.mel_spectrogram_grad`, two
launches per step), otherwise the plain chain.  Synthetic or preloaded
batches are dicts of tensors: ``code [B, T]``, ``f0 [B, T, 1]`` (optional),
``spkr [B, 1]``, ``audio [B, T*320]``.

Reference behaviour mirrored on purpose: there is no VQ commit loss in
the vocoder trainer (the config refuses the VQ paths).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from dissc_tpu_torch.audio.mel import mel_spectrogram
from dissc_tpu_torch.core.config import VocoderConfig
from dissc_tpu_torch.device import DeviceLike, generator_for, resolve_device
from dissc_tpu_torch.kernels.mel_kernel import mel_spectrogram_grad
from dissc_tpu_torch.losses.gan import discriminator_loss, feature_loss, generator_loss
from dissc_tpu_torch.models.discriminators import (MultiPeriodDiscriminator,
                                                   MultiScaleDiscriminator)
from dissc_tpu_torch.models.hifigan import CodeGenerator

Batch = Dict[str, torch.Tensor]


def make_models(h: VocoderConfig, seed: Optional[int] = None
                ) -> Tuple[CodeGenerator, MultiPeriodDiscriminator, MultiScaleDiscriminator]:
    """Generator, MPD and MSD with weights drawn from one seeded generator."""
    g = generator_for(h.seed if seed is None else seed)
    return (CodeGenerator(h, generator=g),
            MultiPeriodDiscriminator(tuple(h.mpd_periods or (2, 3, 5, 7, 11)), generator=g),
            MultiScaleDiscriminator(int(h.msd_scales or 3), generator=g))


def pick_mel_fn(h: VocoderConfig, device: torch.device) -> Callable[[torch.Tensor], torch.Tensor]:
    """The mel-loss function for ``device``, chosen by config alone, by the
    JAX ``_pick_mel_fn``'s test: the fused kernel on the card when
    ``hop | n_fft`` and ``win <= n_fft``, else the plain chain.  The kernel
    takes each such config up to ``n_fft`` 4096 (``kernel_supports``) and
    raises for a larger one; no config it is sent falls back to the plain
    chain."""
    use_kernel = (device.type == "cuda" and h.n_fft % h.hop_size == 0
                  and h.win_size <= h.n_fft)
    return functools.partial(mel_spectrogram_grad if use_kernel else mel_spectrogram,
                             n_fft=h.n_fft, num_mels=h.num_mels,
                             sampling_rate=h.sampling_rate, hop_size=h.hop_size,
                             win_size=h.win_size, fmin=float(h.fmin), fmax=h.fmax_for_loss)


@contextlib.contextmanager
def _frozen(*modules: nn.Module):
    """Parameters of ``modules`` take no gradient inside the block."""
    params = [p for m in modules for p in m.parameters()]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


class GANTrainer:
    """Two-optimizer GAN training state and its step.

    ``device=None`` runs on the CUDA card and raises without one;
    ``device="cpu"`` runs the plain path on the CPU.
    """

    def __init__(self, h: VocoderConfig, device: DeviceLike = None,
                 seed: Optional[int] = None):
        self.h = h
        self.device = resolve_device(device)
        self.gen, self.mpd, self.msd = (m.to(self.device) for m in make_models(h, seed))
        adamw = lambda params: torch.optim.AdamW(params, lr=h.learning_rate,
                                                 betas=(h.adam_b1, h.adam_b2), eps=1e-8,
                                                 weight_decay=0.01)
        self.opt_g = adamw(self.gen.parameters())
        self.opt_d = adamw(list(self.mpd.parameters()) + list(self.msd.parameters()))
        self.mel_fn = pick_mel_fn(h, self.device)
        self.step = 0

    def _inputs(self, batch: Batch):
        get = lambda k: None if batch.get(k) is None else batch[k].to(self.device)
        return get("code"), get("f0") if self.h.f0 else None, get("spkr"), get("audio")

    def train_step(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """One D step then one G step; returns detached loss tensors named
        as the JAX step's metrics."""
        code, f0, spkr, y = self._inputs(batch)
        for m in (self.gen, self.mpd, self.msd):
            m.train()
        y_g_hat = self.gen(code, f0, spkr)

        # D step on the detached fake
        y_det = y_g_hat.detach()
        p_rs, p_gs, _, _ = self.mpd(y, y_det)
        s_rs, s_gs, _, _ = self.msd(y, y_det)
        d_loss = discriminator_loss(p_rs, p_gs)[0] + discriminator_loss(s_rs, s_gs)[0]
        self.opt_d.zero_grad(set_to_none=True)
        d_loss.backward()
        self.opt_d.step()

        # G step against the updated discriminators
        with torch.no_grad():
            y_mel = self.mel_fn(y)
        loss_mel = torch.mean(torch.abs(y_mel - self.mel_fn(y_g_hat))) * 45.0
        with _frozen(self.mpd, self.msd):
            _, p_gs, p_fr, p_fg = self.mpd(y, y_g_hat)
            _, s_gs, s_fr, s_fg = self.msd(y, y_g_hat)
            loss_fm = feature_loss(p_fr, p_fg) + feature_loss(s_fr, s_fg)
            loss_adv = generator_loss(p_gs)[0] + generator_loss(s_gs)[0]
            g_loss = loss_adv + loss_fm + loss_mel
            self.opt_g.zero_grad(set_to_none=True)
            g_loss.backward()
        self.opt_g.step()
        self.step += 1
        return {"loss_disc": d_loss.detach(), "loss_gen_total": g_loss.detach(),
                "loss_mel": loss_mel.detach() / 45.0, "loss_fm": loss_fm.detach(),
                "loss_adv": loss_adv.detach()}

    @torch.no_grad()
    def val_step(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(per-item mean |mel(y) - mel(y_hat)|, y_hat)."""
        code, f0, spkr, y = self._inputs(batch)
        y_g_hat = self.gen(code, f0, spkr)
        err = torch.mean(torch.abs(self.mel_fn(y) - self.mel_fn(y_g_hat)), dim=(1, 2))
        return err, y_g_hat
