"""Model FLOPs, counted from each configuration's layer shapes.

Two operations a multiply-add, over the convolutions and matrix products
only (what a tensor core or a SIMT FMA computes; norms, activations and
the embedding gathers are left out), at the lengths a call really has:
true lengths, not bucket padding.  A transposed convolution counts its
input positions times its kernel, as ``torch.utils.flop_counter`` does.
The training step counts the mel loss's log-mels out: they are under
0.1 % of its work.
"""
from __future__ import annotations

from typing import Sequence

MPD_CHANS = (1, 32, 128, 512, 1024)
MSD_SPECS = ((1, 128, 15, 1, 1, 7), (128, 128, 41, 2, 4, 20), (128, 256, 41, 2, 16, 20),
             (256, 512, 41, 4, 16, 20), (512, 1024, 41, 4, 16, 20),
             (1024, 1024, 41, 1, 16, 20), (1024, 1024, 5, 1, 1, 2), (1024, 1, 3, 1, 1, 1))


def conv_out(n: int, k: int, stride: int = 1, pad: int = 0, dil: int = 1) -> int:
    return (n + 2 * pad - dil * (k - 1) - 1) // stride + 1


def conv(cin: int, cout: int, k: int, out_len: int, groups: int = 1) -> float:
    return 2.0 * cout * (cin // groups) * k * out_len


def generator(h: dict, frames: int) -> float:
    """``CodeGenerator`` forward on ``frames`` code frames (f0 at the code rate)."""
    ch, n = h["upsample_initial_channel"], frames
    total = conv(h["model_in_dim"], ch, 7, n)
    for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
        out_ch = h["upsample_initial_channel"] // (2 ** (i + 1))
        total += 2.0 * ch * out_ch * k * n
        n *= u
        for rk, rd in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]):
            total += 2 * len(rd) * conv(out_ch, out_ch, rk, n)
        ch = out_ch
    return total + conv(ch, 1, 7, n)


def _mpd_one(period: int, t: int) -> Sequence[float]:
    """The flops of each conv of one period discriminator on ``t`` samples."""
    h_len = -(-t // period)
    out = []
    for j, (cin, cout) in enumerate(zip(MPD_CHANS[:-1], MPD_CHANS[1:])):
        h_len = conv_out(h_len, 5, 3, 2)
        out.append(conv(cin, cout, 5, h_len * period))
    out.append(conv(1024, 1024, 5, h_len * period))
    out.append(conv(1024, 1, 3, h_len * period))
    return out


def _msd_one(t: int) -> Sequence[float]:
    out = []
    for cin, cout, k, s, g, p in MSD_SPECS:
        t = conv_out(t, k, s, p)
        out.append(conv(cin, cout, k, t, g))
    return out


def discriminators(h: dict, t: int) -> tuple:
    """(MPD + MSD forward on one ``t``-sample waveform, the part of it in
    each sub-discriminator's first conv, whose input takes no gradient)."""
    parts = [_mpd_one(p, t) for p in h["mpd_periods"]]
    n = t
    for i in range(h["msd_scales"]):
        if i:
            n = conv_out(n, 4, 2, 2)
        parts.append(_msd_one(n))
    return sum(sum(p) for p in parts), sum(p[0] for p in parts)


def train_step(h: dict, batch: int) -> float:
    """One GAN step at ``batch`` x ``segment_size``: the generator forward
    and backward (data and weight gradients: 3 forwards); the D step's
    discriminators on the real and the detached fake, forward and backward
    for their weights and for every input but the waveform's (6 forwards
    less 2 first convs' data gradients); the G step's discriminators on
    the real and the fake forward and the fake's data gradient only, the
    discriminators frozen (3 forwards)."""
    t = h["segment_size"]
    g = generator(h, t // h["code_hop_size"])
    d, d_first = discriminators(h, t)
    return batch * (3 * g + 9 * d - 2 * d_first)


def len_predictor(p: dict, runs: int) -> float:
    e, hid = p["emb_size"], p["hidden"]
    return conv(2 * e, hid, 3, runs) + 6 * conv(hid, hid, 3, runs) + conv(hid, 1, 3, runs)


def pitch_predictor(p: dict, frames: int) -> float:
    e, hid = p["emb_size"], p["hidden"]
    trunk = conv(2 * e, hid, 3, frames) + 8 * conv(hid, hid, 3, frames)
    return trunk + 2 * (conv(hid, hid, 3, frames) + conv(hid, 1, 1, frames))


def hubert(c: dict, samples: int, codebook: int) -> float:
    """HuBERT to ``output_layer`` on ``samples`` samples, and the k-means
    distances to ``codebook`` centroids."""
    n, dims, total = samples, [1] + list(c["conv_dim"]), 0.0
    for i, (k, s) in enumerate(zip(c["conv_kernel"], c["conv_stride"])):
        n = conv_out(n, k, s)
        total += conv(dims[i], dims[i + 1], k, n)
    d, ffn = c["hidden_size"], c["intermediate_size"]
    k = c["conv_pos_kernel"]
    total += 2.0 * n * dims[-1] * d
    total += conv(d, d, k, conv_out(n, k, 1, k // 2), c["conv_pos_groups"])
    layers = min(c["num_layers"], c["output_layer"])
    per_layer = 4 * 2.0 * n * d * d + 2 * 2.0 * n * n * d + 2 * 2.0 * n * d * ffn
    return total + layers * per_layer + 2.0 * n * d * codebook
