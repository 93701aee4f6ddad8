"""Carry weights from the JAX package's trees into the port's state dicts.

The logic of ``dissc_tpu/compat/torch_export.py`` (the JAX -> reference
torch layout), without importing it: each function takes a JAX tree as
nested dicts of numpy arrays (as ``jax.device_get`` or a ``g_``/``do_``/
``best_model.pth`` checkpoint gives it) and returns a state dict of CPU
float32 tensors keyed like the reference modules (``sr/models.py``,
``model/len_predictor.py``, ``model/pitch_predictor.py``) or, for HuBERT
and Whisper, like transformers' ``HubertModel`` and
``WhisperForConditionalGeneration``: what the port's modules declare.

Layouts: JAX ``Conv1d`` kernels are ``(k, in, out)``, ``ConvTranspose1d``
``(k, out, in)``, ``Conv2d`` ``(kh, kw, in, out)``; torch wants
``(out, in, k)``, ``(in, out, k)`` and ``(out, in, kh, kw)``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _conv(tree: Mapping[str, Any], perm) -> Dict[str, torch.Tensor]:
    """One conv's params: ``{v, g}`` -> ``weight_v``/``weight_g``,
    ``kernel`` -> ``weight`` (spectral: ``weight_orig``), plus ``bias``."""
    out = {}
    if "v" in tree:
        v = np.asarray(tree["v"]).transpose(perm)
        out["weight_v"] = _t(v)
        out["weight_g"] = _t(np.asarray(tree["g"]).reshape((-1,) + (1,) * (v.ndim - 1)))
    else:
        out["weight"] = _t(np.asarray(tree["kernel"]).transpose(perm))
    if "bias" in tree:
        out["bias"] = _t(tree["bias"])
    return out


_CONV1D = (2, 1, 0)      # (k, in, out) -> (out, in, k)
_CONVT1D = (2, 1, 0)     # (k, out, in) -> (in, out, k)
_CONV2D = (3, 2, 0, 1)   # (kh, kw, in, out) -> (out, in, kh, kw)


def _put(sd: StateDict, prefix: str, tensors: Mapping[str, torch.Tensor]) -> None:
    for k, v in tensors.items():
        sd[f"{prefix}.{k}"] = v


def generator_state_dict(params: Mapping[str, Any], h) -> StateDict:
    """JAX ``CodeGenerator`` params (folded or not) -> port ``CodeGenerator``
    state dict.  ``h`` is the matching ``VocoderConfig``."""
    sd: StateDict = {}
    gen = params["generator"]
    _put(sd, "conv_pre", _conv(gen["conv_pre"], _CONV1D))
    _put(sd, "conv_post", _conv(gen["conv_post"], _CONV1D))
    for i in range(len(h.upsample_rates)):
        _put(sd, f"ups.{i}", _conv(gen[f"ups_{i}"], _CONVT1D))
    for n in range(len(h.upsample_rates) * len(h.resblock_kernel_sizes)):
        block = gen[f"resblocks_{n}"]
        for name, conv in block.items():  # convs1_j / convs2_j, or convs_j
            group, j = name.rsplit("_", 1)
            _put(sd, f"resblocks.{n}.{group}.{j}", _conv(conv, _CONV1D))
    sd["dict.weight"] = _t(params["dict"]["embedding"])
    if "spkr" in params:
        sd["spkr.weight"] = _t(params["spkr"]["embedding"])
    return sd


def mpd_state_dict(params: Mapping[str, Any]) -> StateDict:
    """JAX ``MultiPeriodDiscriminator`` params -> port MPD state dict."""
    sd: StateDict = {}
    for i in range(len(params)):
        d = params[f"disc_{i}"]
        for j in range(5):
            _put(sd, f"discriminators.{i}.convs.{j}", _conv(d[f"convs_{j}"], _CONV2D))
        _put(sd, f"discriminators.{i}.conv_post", _conv(d["conv_post"], _CONV2D))
    return sd


def msd_state_dict(params: Mapping[str, Any], spectral: Mapping[str, Any]) -> StateDict:
    """JAX ``MultiScaleDiscriminator`` params and its ``spectral``
    collection (``u`` per spectral conv) -> port MSD state dict."""
    sd: StateDict = {}
    for i in range(len(params)):
        d = params[f"disc_{i}"]
        spec = spectral.get(f"disc_{i}", {})
        for name in [f"convs_{j}" for j in range(7)] + ["conv_post"]:
            prefix = (f"discriminators.{i}.conv_post" if name == "conv_post"
                      else f"discriminators.{i}.convs.{name.split('_')[1]}")
            tensors = _conv(d[name], _CONV1D)
            if name in spec:
                tensors["weight_orig"] = tensors.pop("weight")
                tensors["weight_u"] = _t(spec[name]["u"])
            _put(sd, prefix, tensors)
    return sd


def _bn(tree: Mapping[str, Any], stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``_BN`` wrapper's params and batch stats -> ``nn.BatchNorm1d``."""
    return {"weight": _t(tree["BatchNorm_0"]["scale"]), "bias": _t(tree["BatchNorm_0"]["bias"]),
            "running_mean": _t(stats["BatchNorm_0"]["mean"]),
            "running_var": _t(stats["BatchNorm_0"]["var"])}


def len_predictor_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """JAX ``LenPredictor`` ``{params, batch_stats}`` -> port ``LenPredictor``
    state dict (``export_len_predictor``'s keys)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: StateDict = {"token_emb.weight": _t(params["token_emb"]["embedding"]),
                     "spk_emb.weight": _t(params["spk_emb"]["embedding"])}
    for c in ["cnn1"] + [f"cnn1{i}" for i in range(1, 7)] + ["cnn2"]:
        _put(sd, c, _conv(params[c], _CONV1D))
    for bn in ["bn1"] + [f"bn1{i}" for i in range(1, 7)]:
        _put(sd, bn, _bn(params[bn], stats[bn]))
    return sd


def pitch_predictor_state_dict(variables: Mapping[str, Any], model_type: str = "new"
                               ) -> StateDict:
    """JAX ``PitchPredictor``/``PitchPredictorBase`` variables -> port state
    dict (``export_pitch_predictor``'s keys; the ramp PE is computed, not
    stored, so ``pe.pe`` is left out)."""
    params, stats = variables["params"]["core"], variables["batch_stats"]["core"]
    sd: StateDict = {"token_emb.weight": _t(params["token_emb"]["embedding"]),
                     "spk_emb.weight": _t(params["spk_emb"]["embedding"])}
    convs = (["cnn1"] + [f"cnn1{i}" for i in range(1, 8)]
             + ["cnn2", "cnn_class1", "cnn_class2", "cnn_reg1", "cnn_reg2"])
    for c in convs:
        _put(sd, c, _conv(params[c], _CONV1D))
    bns = ([f"bn1{i}" for i in range(1, 8)] + ["bn1", "bn_c1", "bn_r1"]
           if model_type == "base" else ["bn2"])
    for bn in bns:
        _put(sd, bn, _bn(params[bn], stats[bn]))
    return sd


def hubert_state_dict(params: Mapping[str, Any], cfg) -> StateDict:
    """JAX ``HubertEncoder`` params -> transformers ``HubertModel`` keys (the
    inverse of ``dissc_tpu.models.hubert.convert_hf_state_dict``), which is
    what the port's ``HubertEncoder`` declares.  Every layer in ``params``
    is carried; the pos-conv weight norm as ``weight_g`` ``[1, 1, k]`` and
    ``weight_v`` ``[out, in/groups, k]``."""
    sd: StateDict = {}

    def ln(prefix: str, tree: Mapping[str, Any]) -> None:
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = _t(tree["scale"]), _t(tree["bias"])

    def dense(prefix: str, tree: Mapping[str, Any]) -> None:
        sd[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
        sd[f"{prefix}.bias"] = _t(tree["bias"])

    fe = params["feature_extractor"]
    for i in range(len(cfg.conv_dim)):
        sd[f"feature_extractor.conv_layers.{i}.conv.weight"] = _t(
            np.asarray(fe[f"conv_{i}"]["kernel"]).transpose(_CONV1D))
    ln("feature_extractor.conv_layers.0.layer_norm", fe["group_norm"])
    ln("feature_projection.layer_norm", params["fp_layer_norm"])
    dense("feature_projection.projection", params["fp_projection"])
    pos = params["pos_conv"]
    sd["encoder.pos_conv_embed.conv.weight_g"] = _t(np.asarray(pos["g"]).reshape(1, 1, -1))
    sd["encoder.pos_conv_embed.conv.weight_v"] = _t(np.asarray(pos["v"]).transpose(_CONV1D))
    sd["encoder.pos_conv_embed.conv.bias"] = _t(pos["bias"])
    ln("encoder.layer_norm", params["encoder_layer_norm"])
    i = 0
    while f"layer_{i}" in params:
        p, tree = f"encoder.layers.{i}", params[f"layer_{i}"]
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense(f"{p}.attention.{name}", tree[name])
        ln(f"{p}.layer_norm", tree["self_attn_layer_norm"])
        dense(f"{p}.feed_forward.intermediate_dense", tree["fc1"])
        dense(f"{p}.feed_forward.output_dense", tree["fc2"])
        ln(f"{p}.final_layer_norm", tree["final_layer_norm"])
        i += 1
    return sd


def whisper_state_dict(params: Mapping[str, Any], cfg) -> StateDict:
    """JAX Whisper params (layers stacked on a leading axis, ``[in, out]``
    kernels, WIO convs) -> transformers ``WhisperForConditionalGeneration``
    keys (the inverse of ``dissc_tpu.models.whisper.convert_hf_state_dict``;
    ``proj_out`` is the tied embedding and is left out)."""
    sd: StateDict = {}

    def ln(prefix: str, tree: Mapping[str, Any], i=None) -> None:
        pick = (lambda a: np.asarray(a)[i]) if i is not None else np.asarray
        sd[f"{prefix}.weight"] = _t(pick(tree["scale"]))
        sd[f"{prefix}.bias"] = _t(pick(tree["bias"]))

    def lin(prefix: str, tree: Mapping[str, Any], i: int) -> None:
        sd[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"])[i].T)
        if "bias" in tree:
            sd[f"{prefix}.bias"] = _t(np.asarray(tree["bias"])[i])

    def attn(prefix: str, tree: Mapping[str, Any], i: int) -> None:
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                             ("out", "out_proj")):
            lin(f"{prefix}.{theirs}", tree[ours], i)

    enc, dec = params["encoder"], params["decoder"]
    for c in ("conv1", "conv2"):
        sd[f"model.encoder.{c}.weight"] = _t(np.asarray(enc[c]["kernel"]).transpose(_CONV1D))
        sd[f"model.encoder.{c}.bias"] = _t(enc[c]["bias"])
    sd["model.encoder.embed_positions.weight"] = _t(enc["pos"])
    for i in range(cfg.encoder_layers):
        p, lp = f"model.encoder.layers.{i}", enc["layers"]
        attn(f"{p}.self_attn", lp["attn"], i)
        ln(f"{p}.self_attn_layer_norm", lp["attn_ln"], i)
        lin(f"{p}.fc1", lp["fc1"], i)
        lin(f"{p}.fc2", lp["fc2"], i)
        ln(f"{p}.final_layer_norm", lp["ffn_ln"], i)
    ln("model.encoder.layer_norm", enc["ln"])
    sd["model.decoder.embed_tokens.weight"] = _t(dec["embed"])
    sd["model.decoder.embed_positions.weight"] = _t(dec["pos"])
    for i in range(cfg.decoder_layers):
        p, lp = f"model.decoder.layers.{i}", dec["layers"]
        attn(f"{p}.self_attn", lp["attn"], i)
        ln(f"{p}.self_attn_layer_norm", lp["attn_ln"], i)
        attn(f"{p}.encoder_attn", lp["xattn"], i)
        ln(f"{p}.encoder_attn_layer_norm", lp["xattn_ln"], i)
        lin(f"{p}.fc1", lp["fc1"], i)
        lin(f"{p}.fc2", lp["fc2"], i)
        ln(f"{p}.final_layer_norm", lp["ffn_ln"], i)
    ln("model.decoder.layer_norm", dec["ln"])
    return sd
