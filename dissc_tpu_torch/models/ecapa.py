"""ECAPA-TDNN speaker embedder (``dissc_tpu.models.ecapa``).

The reference scores speaker verification with speechbrain's pretrained
``spkrec-ecapa-voxceleb`` (reference ``eval_sv.py:41-44``); speechbrain is
not a dependency, so the architecture (Desplanques et al. 2020) is built
here: 80-mel fbank -> TDNN stem -> 3 SE-Res2Net blocks (dilations 2/3/4,
scale 8) -> multi-layer feature aggregation -> attentive statistics
pooling -> 192-d embedding.

Module attributes carry the key names that the JAX package's
``convert_speechbrain_state_dict`` reads (speechbrain's
``lobes.models.ECAPA_TDNN`` naming: ``blocks.0.conv.conv.weight``,
``blocks.0.norm.norm.*``, ``blocks.i.res2net_block.blocks.j``,
``se_block.conv1.conv``, ``mfa``, ``asp.tdnn``, ``asp.conv.conv``,
``asp_bn.*``, ``fc.conv``), so a speechbrain-keyed state dict loads with
``load_state_dict(strict=True)``.  Layout NCW inside; the forward takes
``[B, T, n_mels]`` features as speechbrain and the JAX model do.
BatchNorm runs in eval mode (running statistics, eps 1e-5): nothing here
trains ECAPA.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dissc_tpu_torch.audio.mel import mel_filterbank, stft_magnitude
from dissc_tpu_torch.device import DeviceLike, resolve_device
from dissc_tpu_torch.models.layers import torch_conv_init


@dataclasses.dataclass(frozen=True)
class EcapaConfig:
    n_mels: int = 80
    channels: int = 1024
    res2net_scale: int = 8
    se_channels: int = 128
    attention_channels: int = 128
    lin_neurons: int = 192
    kernel_sizes: Sequence[int] = (5, 3, 3, 3, 1)
    dilations: Sequence[int] = (1, 2, 3, 4, 1)


def _init_conv(conv: nn.Conv1d, generator: Optional[torch.Generator]) -> nn.Conv1d:
    init = torch_conv_init(conv.in_channels * conv.kernel_size[0])
    with torch.no_grad():
        conv.weight.copy_(init(tuple(conv.weight.shape), generator))
        conv.bias.copy_(init((conv.out_channels,), generator))
    return conv


class SBConv1d(nn.Module):
    """speechbrain's ``Conv1d``: 'same' reflect padding of ``(k-1)*d//2`` on
    each side, then a VALID conv (the inner ``.conv``)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, dilation: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = _init_conv(nn.Conv1d(in_ch, out_ch, k, dilation=dilation), generator)
        self.pad = (k - 1) * dilation // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad:
            x = F.pad(x, (self.pad, self.pad), mode="reflect")
        return self.conv(x)


class SBBatchNorm1d(nn.Module):
    """speechbrain's ``BatchNorm1d`` wrapper (the inner ``.norm``)."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = nn.BatchNorm1d(ch, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


class TDNNBlock(nn.Module):
    """Conv -> ReLU -> BatchNorm, in speechbrain's order."""

    def __init__(self, in_ch: int, out_ch: int, k: int, dilation: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = SBConv1d(in_ch, out_ch, k, dilation, generator)
        self.norm = SBBatchNorm1d(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(torch.relu(self.conv(x)))


class Res2NetBlock(nn.Module):
    """Channel chunks: chunk 0 passes through, chunk 1 goes in alone, chunk
    ``i >= 2`` goes in as ``chunk_i + y_{i-1}``; sub-block ``j`` serves
    chunk ``j + 1``."""

    def __init__(self, channels: int, scale: int, k: int, dilation: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        width = channels // scale
        self.scale = scale
        self.blocks = nn.ModuleList(TDNNBlock(width, width, k, dilation, generator)
                                    for _ in range(scale - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chunks = torch.chunk(x, self.scale, dim=1)
        ys = [chunks[0]]
        for i, block in enumerate(self.blocks, start=1):
            ys.append(block(chunks[i] if i == 1 else chunks[i] + ys[-1]))
        return torch.cat(ys, dim=1)


class SEBlock(nn.Module):
    """Squeeze-excitation over a plain mean in time (no length mask)."""

    def __init__(self, channels: int, se_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = SBConv1d(channels, se_channels, 1, generator=generator)
        self.conv2 = SBConv1d(se_channels, channels, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=2, keepdim=True)
        return x * torch.sigmoid(self.conv2(torch.relu(self.conv1(s))))


class SERes2NetBlock(nn.Module):
    def __init__(self, channels: int, scale: int, se_channels: int, k: int, dilation: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.tdnn1 = TDNNBlock(channels, channels, 1, 1, generator)
        self.res2net_block = Res2NetBlock(channels, scale, k, dilation, generator)
        self.tdnn2 = TDNNBlock(channels, channels, 1, 1, generator)
        self.se_block = SEBlock(channels, se_channels, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.se_block(self.tdnn2(self.res2net_block(self.tdnn1(x))))


class AttentiveStatisticsPooling(nn.Module):
    """Global-context attention over time, then the weighted mean and std.
    The context std uses the population variance; the pooled std is
    ``sqrt(clip(sum(w x^2) - mu^2, 1e-12))``."""

    def __init__(self, channels: int, attention_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.tdnn = TDNNBlock(channels * 3, attention_channels, 1, 1, generator)
        self.conv = SBConv1d(attention_channels, channels, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=2, keepdim=True).expand_as(x)
        std = torch.sqrt(x.var(dim=2, keepdim=True, correction=0) + 1e-12).expand_as(x)
        attn = self.conv(torch.tanh(self.tdnn(torch.cat([x, mean, std], dim=1))))
        w = torch.softmax(attn, dim=2)
        mu = torch.sum(w * x, dim=2)
        sg = torch.sqrt(torch.clamp(torch.sum(w * x * x, dim=2) - mu * mu, min=1e-12))
        return torch.cat([mu, sg], dim=1)


class FCConv(nn.Module):
    """speechbrain's final ``fc``: a kernel-1 conv over the pooled vector."""

    def __init__(self, in_ch: int, out_ch: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = _init_conv(nn.Conv1d(in_ch, out_ch, 1), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x[:, :, None])[:, :, 0]


class EcapaTDNN(nn.Module):
    """``[B, T, n_mels]`` fbank features -> ``[B, lin_neurons]`` embedding."""

    def __init__(self, cfg: EcapaConfig = EcapaConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            [TDNNBlock(c.n_mels, c.channels, c.kernel_sizes[0], c.dilations[0], generator)]
            + [SERes2NetBlock(c.channels, c.res2net_scale, c.se_channels, c.kernel_sizes[i],
                              c.dilations[i], generator) for i in range(1, 4)])
        self.mfa = TDNNBlock(c.channels * 3, c.channels * 3 // 2, c.kernel_sizes[4],
                             c.dilations[4], generator)
        self.asp = AttentiveStatisticsPooling(c.channels * 3 // 2, c.attention_channels,
                                              generator)
        # a plain BatchNorm1d, as the JAX converter reads it (asp_bn.weight,
        # not asp_bn.norm.weight; ROADMAP "Reference behaviours")
        self.asp_bn = nn.BatchNorm1d(c.channels * 3, eps=1e-5)
        self.fc = FCConv(c.channels * 3, c.lin_neurons, generator)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = self.blocks[0](feats.transpose(1, 2))
        outs = []
        for block in self.blocks[1:]:
            x = block(x)
            outs.append(x)
        x = self.mfa(torch.cat(outs, dim=1))
        return self.fc(self.asp_bn(self.asp(x)))


def fbank_features(wav: np.ndarray, sr: int = 16000, n_mels: int = 80, win: int = 400,
                   hop: int = 160, device: DeviceLike = None) -> torch.Tensor:
    """80-dim log-mel fbank at 25 ms / 10 ms with the sentence mean removed,
    ``[T, n_mels]`` on ``device`` (``None``: the CUDA card): reflect-pad by
    ``(512 - hop) // 2``, STFT magnitude at n_fft 512, power, a slaney mel
    over 0 .. sr/2, ``log(max(., 1e-10))``.  This n_fft / hop pair is not a
    config of the fused log-mel kernel, so it runs the plain DFT product."""
    dev = resolve_device(device)
    y = torch.as_tensor(np.asarray(wav, np.float32), device=dev).reshape(1, -1)
    pad = (512 - hop) // 2
    y = F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]
    power = stft_magnitude(y, 512, hop, win) ** 2
    mel = torch.from_numpy(mel_filterbank(sr, 512, n_mels, 0, sr / 2)).to(dev)
    fb = torch.log(torch.clamp(mel @ power[0], min=1e-10)).T
    return fb - fb.mean(dim=0, keepdim=True)


def convert_speechbrain_state_dict(sd: Mapping[str, torch.Tensor],
                                   cfg: EcapaConfig = EcapaConfig()) -> Dict[str, torch.Tensor]:
    """speechbrain's ``embedding_model.ckpt`` tensors -> the state dict
    :class:`EcapaTDNN` loads.  The module already carries speechbrain's
    names, so this checks keys and shapes: a key the model needs and
    ``sd`` lacks raises ``KeyError`` (``num_batches_tracked`` may be
    absent), a shape that differs raises ``ValueError``, and keys the
    model does not read are left out, as the JAX converter ignores them."""
    want = EcapaTDNN(cfg).state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, ref in want.items():
        if key not in sd:
            if key.endswith("num_batches_tracked"):
                continue
            raise KeyError(f"speechbrain ECAPA state dict lacks {key!r}")
        value = torch.as_tensor(np.asarray(sd[key]) if isinstance(sd[key], np.ndarray)
                                else sd[key])
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)}, model wants {tuple(ref.shape)}")
        out[key] = value.to(ref.dtype)
    return out


class EcapaEmbedder:
    """wav -> embedding (numpy), pluggable into ``eval.sv.cosine_scorer``:
    fbank and forward on ``device`` (``None``: the CUDA card)."""

    def __init__(self, state_dict: Mapping[str, torch.Tensor], cfg: EcapaConfig = EcapaConfig(),
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = EcapaTDNN(cfg)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()

    def __call__(self, wav: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            feats = fbank_features(wav, device=self.device)[None]
            return self.model(feats)[0].cpu().numpy()
