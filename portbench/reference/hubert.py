"""Plain reference of the unit encoder: HuBERT-base to layer 6 and the
nearest-centroid k-means quantiser.

Functional float32 PyTorch written from the HuBERT paper and
``transformers``' ``HubertModel`` (post-LN, ``do_stable_layer_norm=False``)
and frozen here; parameter names are ``HubertModel``'s.  Seven strided
convs (the first with a per-channel GroupNorm), exact GELUs, a LayerNorm
and projection, a weight-normed grouped positional conv (gains per kernel
position), then post-LN transformer layers.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.ops import Ops

Params = Dict[str, torch.Tensor]


def hubert_spec(c: dict) -> dict:
    """Random weights as flax initialises them: conv and dense weights
    LeCun-normal, the positional conv's ``weight_v`` N(0, 0.02) with unit
    gains, norms at scale 1, biases 0."""
    spec: dict = {}

    def lecun(name, shape):
        spec[name] = (shape, ("normal", 1.0 / math.sqrt(math.prod(shape[1:]))))

    dims = [1] + list(c["conv_dim"])
    for i, k in enumerate(c["conv_kernel"]):
        lecun(f"feature_extractor.conv_layers.{i}.conv.weight", (dims[i + 1], dims[i], k))
    for key in ("feature_extractor.conv_layers.0.layer_norm",
                "feature_projection.layer_norm", "encoder.layer_norm"):
        n = dims[1] if key.startswith("feature_extractor") else (
            dims[-1] if key.startswith("feature_projection") else c["hidden_size"])
        spec[f"{key}.weight"] = ((n,), ("const", 1.0))
        spec[f"{key}.bias"] = ((n,), ("const", 0.0))
    d, ffn = c["hidden_size"], c["intermediate_size"]

    def dense(name, cin, cout):
        lecun(f"{name}.weight", (cout, cin))
        spec[f"{name}.bias"] = ((cout,), ("const", 0.0))

    dense("feature_projection.projection", dims[-1], d)
    k, g = c["conv_pos_kernel"], c["conv_pos_groups"]
    spec["encoder.pos_conv_embed.conv.weight_g"] = ((1, 1, k), ("const", 1.0))
    spec["encoder.pos_conv_embed.conv.weight_v"] = ((d, d // g, k), ("normal", 0.02))
    spec["encoder.pos_conv_embed.conv.bias"] = ((d,), ("const", 0.0))
    for layer in range(min(c["num_layers"], c["output_layer"])):
        pre = f"encoder.layers.{layer}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{pre}.attention.{proj}", d, d)
        dense(f"{pre}.feed_forward.intermediate_dense", d, ffn)
        dense(f"{pre}.feed_forward.output_dense", ffn, d)
        for norm in ("layer_norm", "final_layer_norm"):
            spec[f"{pre}.{norm}.weight"] = ((d,), ("const", 1.0))
            spec[f"{pre}.{norm}.bias"] = ((d,), ("const", 0.0))
    return spec


def _ln(p: Params, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def features(ops: Ops, p: Params, c: dict, wav: torch.Tensor) -> torch.Tensor:
    """``[B, T]`` waveform -> ``[B, F, hidden]`` layer-``output_layer`` features."""
    eps = c["layer_norm_eps"]
    h = wav[:, None, :].float()
    for i, s in enumerate(c["conv_stride"]):
        pre = f"feature_extractor.conv_layers.{i}"
        h = ops.conv1d(h, p[f"{pre}.conv.weight"], None, stride=s)
        if i == 0:
            h = F.group_norm(h, h.shape[1], p[f"{pre}.layer_norm.weight"],
                             p[f"{pre}.layer_norm.bias"], eps)
        h = F.gelu(h)
    h = _ln(p, "feature_projection.layer_norm", h.transpose(1, 2), eps)
    h = ops.linear(h, p["feature_projection.projection.weight"],
                   p["feature_projection.projection.bias"])
    v, g = p["encoder.pos_conv_embed.conv.weight_v"], p["encoder.pos_conv_embed.conv.weight_g"]
    k = v.shape[-1]
    kernel = g * v / torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True) + 1e-12)
    pos = ops.conv1d(h.transpose(1, 2), kernel, p["encoder.pos_conv_embed.conv.bias"],
                     padding=k // 2, groups=c["conv_pos_groups"])
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    h = _ln(p, "encoder.layer_norm", h + F.gelu(pos).transpose(1, 2), eps)
    n_heads = c["num_heads"]
    for layer in range(min(c["num_layers"], c["output_layer"])):
        pre = f"encoder.layers.{layer}"
        B, T, d = h.shape
        hd = d // n_heads

        def proj(name, x):
            return ops.linear(x, p[f"{pre}.{name}.weight"], p[f"{pre}.{name}.bias"])

        q, kk, vv = (proj(f"attention.{n}", h).reshape(B, T, n_heads, hd).transpose(1, 2)
                     for n in ("q_proj", "k_proj", "v_proj"))
        att = torch.softmax(ops.matmul(q, kk.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        ctx = ops.matmul(att, vv).transpose(1, 2).reshape(B, T, d)
        h = _ln(p, f"{pre}.layer_norm", h + proj("attention.out_proj", ctx), eps)
        ff = proj("feed_forward.output_dense", F.gelu(proj("feed_forward.intermediate_dense", h)))
        h = _ln(p, f"{pre}.final_layer_norm", h + ff, eps)
    return h


def distances(ops: Ops, feats: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """``[F, D]`` x ``[K, D]`` -> ``[F, K]`` squared distances."""
    feats, codebook = feats.float(), codebook.float()
    return (torch.sum(feats ** 2, dim=-1, keepdim=True) - 2.0 * ops.matmul(feats, codebook.t())
            + torch.sum(codebook ** 2, dim=-1)[None, :])
