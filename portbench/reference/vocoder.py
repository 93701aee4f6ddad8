"""Plain reference of the HiFi-GAN unit vocoder, its discriminators, its
losses, its log-mel and its GAN training step.

Functional float32 PyTorch on dicts of tensors, written from the DISSC
reference (``sr/models.py``, ``sr/dataset.py``, ``sr/train.py``) and
frozen here: nothing of the measured program is imported.  Parameter
names are the reference state-dict keys, so the same dict loads into the
program's modules (``load_state_dict``) and feeds these functions.

* generator: unit table + f0 channel + speaker table -> 7-wide pre-conv,
  transposed-conv upsamplers (5*4*4*2*2), MRF banks of dilated
  ResBlock1s averaged, leaky-ReLU(0.01), 7-wide post-conv, tanh;
* weight norm ``g * v / sqrt(sum v^2 + 1e-12)`` over every dim but 0;
  spectral norm with one power-iteration step of ``u`` on every train-mode
  call of the spectrally normed scale discriminator;
* MPD at periods 2, 3, 5, 7, 11 (reflect pad, fold, (k, 1) convs) and MSD
  at three scales (``AvgPool1d(4, 2, 2)`` between them);
* LS-GAN losses, feature matching, 45 x L1 of log-mels (reflect pad,
  periodic Hann, magnitude with a 1e-9 floor, slaney mel, log clamp 1e-5);
* the step: generator forward, D step (AdamW), then G step against the
  updated discriminators, which take no gradient there (AdamW,
  lr 8e-4, betas (0.8, 0.99), eps 1e-8, weight decay 0.01).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.ops import Ops

Params = Dict[str, torch.Tensor]
LRELU = 0.1
MSD_SPECS = ((1, 128, 15, 1, 1, 7), (128, 128, 41, 2, 4, 20), (128, 256, 41, 2, 16, 20),
             (256, 512, 41, 4, 16, 20), (512, 1024, 41, 4, 16, 20),
             (1024, 1024, 41, 1, 16, 20), (1024, 1024, 5, 1, 1, 2))
MSD_POST = (1024, 1, 3, 1, 1, 1)
MPD_CHANS = (1, 32, 128, 512, 1024)
GEN_GAIN = 0.8  # weight-norm gains of the generator: a waveform at a level of speech


# ---------------------------------------------------------------------------
# parameter specs: name -> (shape, init), materialised by portbench/weights.py
# ---------------------------------------------------------------------------

def _wn(spec: dict, name: str, shape: tuple, v_init, g_init=None, bias: bool = True,
        transposed: bool = False) -> None:
    """A weight-normed conv: ``weight_v``, ``weight_g`` (``g_init``, or the
    norm of ``v`` so that the weight is ``v``) and a bias."""
    fan_in = math.prod(shape[1:]) if not transposed else shape[0] * shape[2]
    spec[f"{name}.weight_v"] = (shape, v_init)
    spec[f"{name}.weight_g"] = ((shape[0],) + (1,) * (len(shape) - 1),
                                g_init or ("norm_of", f"{name}.weight_v"))
    if bias:
        out_ch = shape[1] if transposed else shape[0]
        spec[f"{name}.bias"] = ((out_ch,), ("uniform", 1.0 / math.sqrt(fan_in)))


def generator_spec(h: dict) -> dict:
    """``CodeGenerator`` at ``h`` (the vocoder config): HiFi-GAN's normal(0,
    0.01) directions with gains ``GEN_GAIN`` and zero biases (random
    weights that give a waveform at a level of speech), unit and speaker
    tables N(0, 1)."""
    spec: dict = {}
    v, g, zero = ("normal", 0.01), ("const", GEN_GAIN), ("const", 0.0)

    def conv(name, shape, transposed=False):
        _wn(spec, name, shape, v, g, transposed=transposed)
        spec[f"{name}.bias"] = ((shape[1] if transposed else shape[0],), zero)

    ch = h["upsample_initial_channel"]
    conv("conv_pre", (ch, h["model_in_dim"], 7))
    n = 0
    for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
        out_ch = h["upsample_initial_channel"] // (2 ** (i + 1))
        conv(f"ups.{i}", (ch, out_ch, k), transposed=True)
        for rk, rd in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]):
            for j in range(len(rd)):
                conv(f"resblocks.{n}.convs1.{j}", (out_ch, out_ch, rk))
                conv(f"resblocks.{n}.convs2.{j}", (out_ch, out_ch, rk))
            n += 1
        ch = out_ch
    conv("conv_post", (1, ch, 7))
    spec["dict.weight"] = ((h["num_embeddings"], h["embedding_dim"]), ("normal", 1.0))
    spec["spkr.weight"] = ((200, h["embedding_dim"]), ("normal", 1.0))
    return spec


def _torch_default(shape) -> tuple:
    return ("uniform", 1.0 / math.sqrt(math.prod(shape[1:])))


def mpd_spec(h: dict) -> dict:
    """``MultiPeriodDiscriminator``: torch's default conv init, weight-normed."""
    spec: dict = {}
    for i, _ in enumerate(h["mpd_periods"]):
        convs = [(cout, cin, 5, 1) for cin, cout in zip(MPD_CHANS[:-1], MPD_CHANS[1:])]
        convs.append((1024, 1024, 5, 1))
        for j, shape in enumerate(convs):
            _wn(spec, f"discriminators.{i}.convs.{j}", shape, _torch_default(shape))
        shape = (1, 1024, 3, 1)
        _wn(spec, f"discriminators.{i}.conv_post", shape, _torch_default(shape))
    return spec


def msd_spec(h: dict) -> dict:
    """``MultiScaleDiscriminator``: scale 0 spectral-normed (``weight_orig``,
    ``weight_u``), the others weight-normed; torch's default conv init."""
    spec: dict = {}
    for i in range(h["msd_scales"]):
        for j, (cin, cout, k, s, g, p) in enumerate(MSD_SPECS + (MSD_POST,)):
            name = (f"discriminators.{i}.convs.{j}" if j < len(MSD_SPECS)
                    else f"discriminators.{i}.conv_post")
            shape = (cout, cin // g, k)
            if i == 0:
                spec[f"{name}.weight_orig"] = (shape, _torch_default(shape))
                spec[f"{name}.weight_u"] = ((cout,), ("normal", 1.0))
                spec[f"{name}.bias"] = ((cout,), _torch_default(shape))
            else:
                _wn(spec, name, shape, _torch_default(shape))
    return spec


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    dims = tuple(range(1, v.dim()))
    return g * (v / torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True) + 1e-12))


def _w(p: Params, name: str) -> torch.Tensor:
    return weight_norm(p[f"{name}.weight_v"], p[f"{name}.weight_g"])


def generator(ops: Ops, p: Params, h: dict, code: torch.Tensor, f0: Optional[torch.Tensor],
              spkr: torch.Tensor) -> torch.Tensor:
    """``code [B, T]``, ``f0 [B, Tf, 1]``, ``spkr [B, 1]`` -> ``[B, T' * 320]``."""
    x = F.embedding(code, p["dict.weight"])
    if h["f0"] and f0 is not None:
        if x.shape[1] < f0.shape[1]:
            x = torch.repeat_interleave(x, f0.shape[1] // x.shape[1], dim=1)
        elif f0.shape[1] < x.shape[1]:
            f0 = torch.repeat_interleave(f0, x.shape[1] // f0.shape[1], dim=1)
        x = torch.cat([x, f0.float()], dim=-1)
    s = F.embedding(spkr[..., 0], p["spkr.weight"])[:, None, :]
    x = torch.cat([x, s.expand(x.shape[0], x.shape[1], s.shape[-1])], dim=-1).transpose(1, 2)
    x = ops.conv1d(x, _w(p, "conv_pre"), p["conv_pre.bias"], padding=3)
    n_k = len(h["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
        x = ops.conv_transpose1d(F.leaky_relu(x, LRELU), _w(p, f"ups.{i}"), p[f"ups.{i}.bias"],
                                 stride=u, padding=(k - u) // 2)
        acc = 0.0
        for j, (rk, rd) in enumerate(zip(h["resblock_kernel_sizes"],
                                         h["resblock_dilation_sizes"])):
            name, xb = f"resblocks.{i * n_k + j}", x
            for m, d in enumerate(rd):
                t = ops.conv1d(F.leaky_relu(xb, LRELU), _w(p, f"{name}.convs1.{m}"),
                               p[f"{name}.convs1.{m}.bias"], padding=(rk * d - d) // 2,
                               dilation=d)
                t = ops.conv1d(F.leaky_relu(t, LRELU), _w(p, f"{name}.convs2.{m}"),
                               p[f"{name}.convs2.{m}.bias"], padding=(rk - 1) // 2)
                xb = t + xb
            acc = acc + xb
        x = acc / n_k
    x = ops.conv1d(F.leaky_relu(x, 0.01), _w(p, "conv_post"), p["conv_post.bias"], padding=3)
    return torch.tanh(x)[:, 0]


def _spectral(p: Params, name: str, train: bool) -> torch.Tensor:
    """``weight_orig / sigma``; in train mode ``u`` first advances one
    power-iteration step (stored back into ``p``)."""
    w_orig = p[f"{name}.weight_orig"]
    w = w_orig.reshape(w_orig.shape[0], -1)
    if train:
        with torch.no_grad():
            v = w.t() @ p[f"{name}.weight_u"]
            v = v / (torch.linalg.vector_norm(v) + 1e-12)
            u = w @ v
            u = u / (torch.linalg.vector_norm(u) + 1e-12)
            p[f"{name}.weight_u"] = u
    else:
        u = p[f"{name}.weight_u"]
        v = w.t() @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
    return w_orig / (u @ (w @ v))


def _disc_p(ops: Ops, p: Params, pre: str, period: int, x: torch.Tensor):
    b, t = x.shape
    if t % period:
        n_pad = period - t % period
        x = F.pad(x[:, None], (0, n_pad), mode="reflect")[:, 0]
        t += n_pad
    x = x.reshape(b, 1, t // period, period)
    fmap = []
    for j in range(len(MPD_CHANS)):
        stride = (3, 1) if j < len(MPD_CHANS) - 1 else (1, 1)
        x = F.leaky_relu(ops.conv2d(x, _w(p, f"{pre}.convs.{j}"), p[f"{pre}.convs.{j}.bias"],
                                    stride, (2, 0)), LRELU)
        fmap.append(x)
    x = ops.conv2d(x, _w(p, f"{pre}.conv_post"), p[f"{pre}.conv_post.bias"], (1, 1), (1, 0))
    fmap.append(x)
    return x.flatten(1), fmap


def mpd(ops: Ops, p: Params, h: dict, y: torch.Tensor, y_hat: torch.Tensor):
    out = ([], [], [], [])
    for i, period in enumerate(h["mpd_periods"]):
        for k, x in ((0, y), (1, y_hat)):
            s, f = _disc_p(ops, p, f"discriminators.{i}", period, x)
            out[k].append(s)
            out[k + 2].append(f)
    return out


def _disc_s(ops: Ops, p: Params, pre: str, spectral: bool, train: bool, x: torch.Tensor):
    x = x[:, None]
    fmap = []
    for j, (cin, cout, k, s, g, pad) in enumerate(MSD_SPECS + (MSD_POST,)):
        name = f"{pre}.convs.{j}" if j < len(MSD_SPECS) else f"{pre}.conv_post"
        w = _spectral(p, name, train) if spectral else _w(p, name)
        x = ops.conv1d(x, w, p[f"{name}.bias"], stride=s, padding=pad, groups=g)
        if j < len(MSD_SPECS):
            x = F.leaky_relu(x, LRELU)
        fmap.append(x)
    return x.flatten(1), fmap


def msd(ops: Ops, p: Params, h: dict, y: torch.Tensor, y_hat: torch.Tensor, train: bool):
    out = ([], [], [], [])
    for i in range(h["msd_scales"]):
        if i:
            y = F.avg_pool1d(y[:, None], 4, 2, padding=2)[:, 0]
            y_hat = F.avg_pool1d(y_hat[:, None], 4, 2, padding=2)[:, 0]
        for k, x in ((0, y), (1, y_hat)):
            s, f = _disc_s(ops, p, f"discriminators.{i}", i == 0, train, x)
            out[k].append(s)
            out[k + 2].append(f)
    return out


# ---------------------------------------------------------------------------
# losses and the log-mel
# ---------------------------------------------------------------------------

def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    return 2 * sum(torch.mean(torch.abs(r - g)) for dr, dg in zip(fmap_r, fmap_g)
                   for r, g in zip(dr, dg))


def discriminator_loss(real, fake) -> torch.Tensor:
    return sum(torch.mean((1 - r) ** 2) + torch.mean(g ** 2) for r, g in zip(real, fake))


def generator_loss(fake) -> torch.Tensor:
    return sum(torch.mean((1 - g) ** 2) for g in fake)


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    logstep = math.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / logstep,
                    f / (200.0 / 3.0))


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    logstep = math.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)), m * (200.0 / 3.0))


def mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: Optional[float]) -> np.ndarray:
    """librosa's slaney mel filterbank ``[n_mels, n_fft // 2 + 1]``."""
    fmax = sr / 2.0 if fmax is None else fmax
    fftfreqs = np.linspace(0, sr / 2.0, n_fft // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - fftfreqs[None, :]
    w = np.maximum(0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    return (w * (2.0 / (pts[2:n_mels + 2] - pts[:n_mels]))[:, None]).astype(np.float32)


def log_mel(ops: Ops, y: torch.Tensor, h: dict) -> torch.Tensor:
    """``[B, T]`` -> ``[B, mels, frames]`` (``sr/dataset.py:46-104``)."""
    n_fft, hop, win = h["n_fft"], h["hop_size"], h["win_size"]
    pad = (n_fft - hop) // 2
    y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    window = np.hanning(win + 1)[:-1].astype(np.float32)
    lpad = (n_fft - win) // 2
    window = np.pad(window, (lpad, n_fft - win - lpad))
    k, n = np.arange(n_fft // 2 + 1), np.arange(n_fft)
    ang = -2.0 * np.pi * np.outer(n, k) / n_fft
    dev = y.device
    frames = y.unfold(-1, n_fft, hop) * torch.from_numpy(window).to(dev)
    re = ops.matmul(frames, torch.from_numpy(np.cos(ang).astype(np.float32)).to(dev))
    im = ops.matmul(frames, torch.from_numpy(np.sin(ang).astype(np.float32)).to(dev))
    mag = torch.sqrt(re * re + im * im + 1e-9).transpose(1, 2)
    basis = torch.from_numpy(mel_basis(h["sampling_rate"], n_fft, h["num_mels"],
                                       float(h["fmin"]), h["fmax_for_loss"])).to(dev)
    return torch.log(torch.clamp(ops.matmul(basis, mag), min=1e-5))


# ---------------------------------------------------------------------------
# the GAN step
# ---------------------------------------------------------------------------

class AdamW:
    """torch's AdamW update on a dict of leaves (moments kept per name)."""

    def __init__(self, lr: float, b1: float, b2: float, eps: float = 1e-8, wd: float = 0.01):
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, b1, b2, eps, wd
        self.t = 0
        self.m: Params = {}
        self.v: Params = {}

    @torch.no_grad()
    def update(self, p: Params, grads: Params) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, math.sqrt(1 - self.b2 ** self.t)
        for k, g in grads.items():
            m = self.m.get(k, torch.zeros_like(g)) * self.b1 + (1 - self.b1) * g
            v = self.v.get(k, torch.zeros_like(g)) * self.b2 + (1 - self.b2) * g * g
            self.m[k], self.v[k] = m, v
            x = p[k] * (1 - self.lr * self.wd)
            p[k] = x - (self.lr / c1) * m / (v.sqrt() / c2 + self.eps)


def _leaves(p: Params) -> List[str]:
    return [k for k in p if not k.endswith("weight_u")]


def gan_step(ops: Ops, gp: Params, dp: Params, opt_g: AdamW, opt_d: AdamW, h: dict,
             batch: Dict[str, torch.Tensor]) -> Tuple[Dict[str, float], Params, Params]:
    """One D step then one G step on ``batch`` (``code``, ``f0``, ``spkr``,
    ``audio``); ``gp``/``dp`` (``mpd.``/``msd.``-prefixed) and the
    optimizers advance in place.  Returns the losses and the two
    gradients as the optimizers got them."""
    code, f0, spkr, y = batch["code"], batch.get("f0"), batch["spkr"], batch["audio"]
    mpd_p = {k[4:]: v for k, v in dp.items() if k.startswith("mpd.")}
    msd_p = {k[4:]: v for k, v in dp.items() if k.startswith("msd.")}
    g_names, d_names = _leaves(gp), _leaves(dp)
    for k in g_names:
        gp[k] = gp[k].detach().requires_grad_(True)
    for k in d_names:
        dp[k] = dp[k].detach().requires_grad_(True)
    mpd_p = {k: dp["mpd." + k] for k in mpd_p}
    msd_p = {k: dp["msd." + k] for k in msd_p}

    y_hat = generator(ops, gp, h, code, f0, spkr)
    p_r, p_g, _, _ = mpd(ops, mpd_p, h, y, y_hat.detach())
    s_r, s_g, _, _ = msd(ops, msd_p, h, y, y_hat.detach(), train=True)
    d_loss = discriminator_loss(p_r, p_g) + discriminator_loss(s_r, s_g)
    d_grads = dict(zip(d_names, torch.autograd.grad(d_loss, [dp[k] for k in d_names])))
    for k, v in msd_p.items():
        if k.endswith("weight_u"):
            dp["msd." + k] = v
    opt_d.update(dp, d_grads)

    mpd_p = {k[4:]: v.detach() for k, v in dp.items() if k.startswith("mpd.")}
    msd_p = {k[4:]: v.detach() for k, v in dp.items() if k.startswith("msd.")}
    with torch.no_grad():
        y_mel = log_mel(ops, y, h)
    loss_mel = torch.mean(torch.abs(y_mel - log_mel(ops, y_hat, h))) * 45.0
    _, p_g, p_fr, p_fg = mpd(ops, mpd_p, h, y, y_hat)
    _, s_g, s_fr, s_fg = msd(ops, msd_p, h, y, y_hat, train=True)
    g_loss = (generator_loss(p_g) + generator_loss(s_g) + feature_loss(p_fr, p_fg)
              + feature_loss(s_fr, s_fg) + loss_mel)
    g_grads = dict(zip(g_names, torch.autograd.grad(g_loss, [gp[k] for k in g_names])))
    for k, v in msd_p.items():
        if k.endswith("weight_u"):
            dp["msd." + k] = v
    opt_g.update(gp, g_grads)
    for p in (gp, dp):
        for k in p:
            p[k] = p[k].detach()
    losses = {"loss_disc": float(d_loss.detach()), "loss_gen_total": float(g_loss.detach()),
              "loss_mel": float(loss_mel.detach()) / 45.0}
    return losses, g_grads, d_grads
