"""HuBERT encoder + k-means unit quantizer (``dissc_tpu.models.hubert``).

The reference extracts units with textlesslib's HuBERT-base (layer 6) and
a 100-cluster k-means (reference ``data/encode.py:21-22``).  Here:
conv feature extractor -> feature projection -> conv positional embedding
-> post-LN transformer layers up to ``output_layer`` (the layers past it
are neither built nor run) -> nearest-centroid argmin.

Parameters are named as transformers' ``HubertModel`` names them, so its
state dict (or one carried from the JAX package by
``compat.from_jax.hubert_state_dict``) loads directly; the pos-conv
weight norm is stored as ``weight_g``/``weight_v``.

Numerics: float32 by default, plain matmuls, softmax in float32.  Flax's
LayerNorm and GroupNorm take the variance as E[x^2] - E[x]^2 where torch
takes it about the mean: the two differ at rounding level, and features
agree with the JAX encoder to 1e-4 (``tests/test_torch_hubert.py``).

``HubertConfig(compute_dtype="bfloat16")`` is flax's mixed precision, as
the JAX encoder runs it (``dissc_tpu/models/hubert.py:43-177``): every
conv, every dense layer and the positional conv cast their input, weight
and bias to bfloat16 and return bfloat16 (the bias added after the
product; the pos-conv weight norm formed in float32 first); the GELUs
after them run in bfloat16.  The norms have float32 parameters, so flax
promotes their output to float32: here their input is cast to float32
first (torch's norms would return bfloat16), which makes the residual
stream after each LayerNorm, and the encoder's output, float32.  The
attention scores are bfloat16, scaled by ``sqrt(head_dim)`` rounded to
bfloat16 as the JAX encoder's divisor is; the softmax runs in float32
and its result is cast back.  The k-means argmin always runs in float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dissc_tpu_torch.core.config import resolve_dtype
from dissc_tpu_torch.device import DeviceLike, resolve_device
from dissc_tpu_torch.models.layers import conv_in_dtype, rounded_scalar


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    """HuBERT-base by default: conv 512 x 7 (kernels 10,3,3,3,3,2,2, strides
    5,2,2,2,2,2,2), hidden 768, 12 heads, FFN 3072, pos-conv 128 / 16
    groups, units from layer 6.  ``compute_dtype``: ``None`` or
    ``"float32"`` (the default path) or ``"bfloat16"`` (the convs and dense
    layers in bfloat16, float32 parameters and norms)."""

    conv_dim: Sequence[int] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2)
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-5
    conv_pos_kernel: int = 128
    conv_pos_groups: int = 16
    output_layer: int = 6  # GSLM/textlesslib km100 operates on layer-6 features
    compute_dtype: Optional[str] = None

    def __post_init__(self):
        resolve_dtype(self.compute_dtype)

    @property
    def dtype(self) -> Optional[torch.dtype]:
        """The compute dtype, ``None`` for float32."""
        return resolve_dtype(self.compute_dtype)

    @property
    def n_layers_run(self) -> int:
        return min(self.num_layers, self.output_layer)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU.  In a low-precision dtype it is formed as the JAX
    encoder's ``nn.gelu`` forms it, ``0.5 * x * erfc(-x * sqrt(1/2))`` with
    each operation rounded to that dtype (torch's fused GELU rounds once)."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    return 0.5 * x * torch.special.erfc(-x * rounded_scalar(math.sqrt(0.5), x.dtype))


def _norm(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A float32-parameter norm, its output float32 (flax's promotion)."""
    return norm(x.float())


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``layer(x)``; with a compute dtype, flax's ``Dense(dtype=...)``: the
    product in ``dtype``, then the bias, cast to it, added."""
    if dtype is None:
        return layer(x)
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


class _ConvLayer(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int, norm: bool, eps: float,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = nn.Conv1d(in_ch, out_ch, k, stride=stride, bias=False)
        # HF GroupNorm with groups == channels: per-channel stats over time
        self.layer_norm = nn.GroupNorm(out_ch, out_ch, eps=eps) if norm else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            x = self.conv(x)
        else:
            x = conv_in_dtype(F.conv1d, x, self.conv.weight, self.dtype, self.conv.stride)
        if self.layer_norm is not None:
            x = _norm(self.layer_norm, x)
        return _gelu(x)


class FeatureExtractor(nn.Module):
    """7 strided convs, 320x downsampling (16 kHz -> 50 Hz): ``[B, T]`` ->
    ``[B, C, F]``.  The first has no bias and a per-channel GroupNorm;
    every one ends in exact GELU."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        dims = (1,) + tuple(cfg.conv_dim)
        self.conv_layers = nn.ModuleList(
            _ConvLayer(dims[i], dims[i + 1], k, s, i == 0, cfg.layer_norm_eps, cfg.dtype)
            for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        h = wav[:, None, :]
        for layer in self.conv_layers:
            h = layer(h)
        return h


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps)
        self.projection = nn.Linear(cfg.conv_dim[-1], cfg.hidden_size)
        self.dtype = cfg.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _dense(self.projection, _norm(self.layer_norm, x), self.dtype)


class _WeightNormedConv(nn.Module):
    """Grouped conv whose weight is ``g * v / sqrt(sum v^2 + 1e-12)`` with one
    gain per *kernel position* (torch ``weight_norm(dim=2)`` on the
    ``[out, in/groups, k]`` weight: the norm over out and in/groups)."""

    def __init__(self, ch: int, k: int, groups: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(1, 1, k))
        self.weight_v = nn.Parameter(torch.zeros(ch, ch // groups, k))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.k, self.groups, self.dtype = k, groups, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = self.weight_v
        kernel = self.weight_g * v / torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True) + 1e-12)
        if self.dtype is None:
            return F.conv1d(x, kernel, self.bias, padding=self.k // 2, groups=self.groups)
        h = conv_in_dtype(F.conv1d, x, kernel, self.dtype, 1, self.k // 2, 1, self.groups)
        return h + self.bias.to(self.dtype)[:, None]


class PositionalConvEmbedding(nn.Module):
    """``[B, D, F]`` -> the conv positional embedding, ``[B, D, F]``: a
    weight-normed grouped conv ('same' padding, the last frame trimmed for
    an even kernel), then exact GELU."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.conv = _WeightNormedConv(cfg.hidden_size, cfg.conv_pos_kernel, cfg.conv_pos_groups,
                                      cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        if self.conv.k % 2 == 0:
            h = h[:, :, :-1]
        return _gelu(h)


class _Attention(nn.Module):
    def __init__(self, d: int, n_heads: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_heads, self.dtype = n_heads, dtype
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, d = x.shape
        hd = d // self.n_heads

        def heads(layer):
            return _dense(layer, x, self.dtype).reshape(B, T, self.n_heads, hd).transpose(1, 2)

        q, k, v = heads(self.q_proj), heads(self.k_proj), heads(self.v_proj)
        # the JAX divisor: sqrt(hd) in the scores' dtype
        scores = torch.matmul(q, k.transpose(-1, -2)) / rounded_scalar(math.sqrt(hd), q.dtype)
        ctx = torch.matmul(torch.softmax(scores.float(), dim=-1).to(v.dtype), v)
        return _dense(self.out_proj, ctx.transpose(1, 2).reshape(B, T, d), self.dtype)


class _FeedForward(nn.Module):
    def __init__(self, d: int, ffn: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.intermediate_dense = nn.Linear(d, ffn)
        self.output_dense = nn.Linear(ffn, d)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _gelu(_dense(self.intermediate_dense, x, self.dtype))
        return _dense(self.output_dense, h, self.dtype)


class TransformerLayer(nn.Module):
    """Post-LN transformer block (HuBERT-base: ``do_stable_layer_norm=False``)."""

    def __init__(self, cfg: HubertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.attention = _Attention(d, cfg.num_heads, cfg.dtype)
        self.layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.feed_forward = _FeedForward(d, cfg.intermediate_size, cfg.dtype)
        self.final_layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _norm(self.layer_norm, x + self.attention(x))
        return _norm(self.final_layer_norm, x + self.feed_forward(x))


class _Encoder(nn.Module):
    def __init__(self, cfg: HubertConfig):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList(TransformerLayer(cfg) for _ in range(cfg.n_layers_run))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = h + self.pos_conv_embed(h.transpose(1, 2)).transpose(1, 2)
        h = _norm(self.layer_norm, h)
        for layer in self.layers:
            h = layer(h)
        return h


class HubertEncoder(nn.Module):
    """Waveform ``[B, T]`` -> float32 features ``[B, F, hidden]`` at
    ``cfg.output_layer``."""

    def __init__(self, cfg: HubertConfig = HubertConfig()):
        super().__init__()
        self.cfg = cfg
        self.feature_extractor = FeatureExtractor(cfg)
        self.feature_projection = _FeatureProjection(cfg)
        self.encoder = _Encoder(cfg)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        h = self.feature_extractor(wav).transpose(1, 2)
        return self.encoder(self.feature_projection(h))

    def load_hf_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load a ``HubertModel``-layout state dict, dropping the layers past
        ``output_layer`` that this encoder does not build (strict otherwise)."""
        n = self.cfg.n_layers_run
        keep = {k: v for k, v in sd.items()
                if not (k.startswith("encoder.layers.") and int(k.split(".")[2]) >= n)}
        self.load_state_dict(keep)


def init_state_dict(cfg: HubertConfig, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random weights for :class:`HubertEncoder`, drawn from ``generator``:
    conv and dense weights LeCun-normal (flax's default, as the JAX encoder's
    init), the pos-conv ``weight_v`` N(0, 0.02) with unit gains, norms at
    scale 1 and every bias 0."""
    with torch.device("meta"):
        shapes = HubertEncoder(cfg).state_dict()
    sd = {}
    for key, t in shapes.items():
        if key.endswith("weight_v"):
            sd[key] = torch.randn(t.shape, generator=generator) * 0.02
        elif key.endswith("bias"):
            sd[key] = torch.zeros(t.shape)
        elif "norm" in key or key.endswith("weight_g"):
            sd[key] = torch.ones(t.shape)
        else:
            fan_in = math.prod(t.shape[1:])
            sd[key] = torch.randn(t.shape, generator=generator) / math.sqrt(fan_in)
    return sd


def kmeans_quantize(features: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest centroid: ``[B, F, D]`` x ``[K, D]`` -> ``[B, F]`` int64.

    Always float32, ``|f|^2 - 2 f.c + |c|^2`` then argmin (first index on a
    tie), as the JAX package; TF32 must be off (``resolve_device``), since
    it flips near-tie units."""
    features, codebook = features.float(), codebook.float()
    sq = torch.sum(features ** 2, dim=-1, keepdim=True)
    cb_sq = torch.sum(codebook ** 2, dim=-1)
    dots = torch.einsum("bfd,kd->bfk", features, codebook)
    return torch.argmin(sq - 2.0 * dots + cb_sq[None, None, :], dim=-1)


class SpeechUnitEncoder:
    """wav -> ``{units, f0}`` (the ``data/encode.py`` engine).

    HuBERT + k-means on the entry point's device; YAAPT f0 at 5 ms, each
    20 ms unit frame taking the median of its block of four values when at
    least two are voiced (else 0), so ``len(f0) == len(units)``.
    ``state_dict`` is in ``HubertModel`` layout.  ``device=None`` runs on
    the CUDA card and raises without one.
    """

    def __init__(self, state_dict: Dict[str, torch.Tensor], codebook: np.ndarray,
                 cfg: HubertConfig = HubertConfig(), device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):  # no init: every weight comes from state_dict
            model = HubertEncoder(cfg)
        self.model = model.to_empty(device=self.device).eval()
        self.model.load_hf_state_dict(state_dict)
        self.codebook = torch.as_tensor(np.asarray(codebook, np.float32), device=self.device)

    @torch.inference_mode()
    def encode_units(self, wav: np.ndarray) -> np.ndarray:
        """``[T]`` -> ``[F]`` units, or ``[B, T]`` -> ``[B, F]``."""
        wav = np.asarray(wav, np.float32)
        x = torch.as_tensor(np.atleast_2d(wav), device=self.device)
        units = kmeans_quantize(self.model(x), self.codebook).cpu().numpy()
        return units[0] if wav.ndim == 1 else units

    def __call__(self, wav: np.ndarray, sr: int = 16000) -> Dict[str, list]:
        from dissc_tpu_torch.audio.yaapt import f0_per_unit, yaapt_f0

        units = self.encode_units(wav)
        f0_5ms = yaapt_f0(wav, sr, device=self.device)
        return {"units": units.tolist(), "f0": f0_per_unit(f0_5ms, len(units)).tolist()}


def load_encoder(weights_path: str, codebook_path: str, cfg: HubertConfig = HubertConfig(),
                 device: DeviceLike = None) -> SpeechUnitEncoder:
    """The files ``dissc_tpu.cli.encode.load_encoder`` reads: a JAX param
    pickle (optionally under ``"params"``) and a ``[vocab, width]`` codebook
    (``.npy`` or pickle)."""
    from dissc_tpu_torch.compat.from_jax import hubert_state_dict
    from dissc_tpu_torch.train.checkpoints import load_checkpoint

    params = load_checkpoint(weights_path)
    if isinstance(params, dict) and "params" in params:
        params = params["params"]
    codebook = (np.load(codebook_path) if codebook_path.endswith(".npy")
                else load_checkpoint(codebook_path))
    return SpeechUnitEncoder(hubert_state_dict(params, cfg), np.asarray(codebook), cfg,
                             device=device)
