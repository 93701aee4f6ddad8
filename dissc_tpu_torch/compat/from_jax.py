"""Carry weights from the JAX package's trees into the port's state dicts.

The logic of ``dissc_tpu/compat/torch_export.py`` (the JAX -> reference
torch layout), without importing it: each function takes a JAX tree as
nested dicts of numpy arrays (as ``jax.device_get`` or a ``g_``/``do_``/
``best_model.pth`` checkpoint gives it) and returns a state dict of CPU
float32 tensors keyed like the reference modules (``sr/models.py``,
``model/len_predictor.py``, ``model/pitch_predictor.py``, the jukebox
``Encoder``/``Decoder`` and VQ ``Bottleneck`` of ``sr/modules``), like
speechbrain's ECAPA-TDNN, or, for HuBERT and Whisper, like transformers'
``HubertModel`` and ``WhisperForConditionalGeneration``: what the port's
modules declare.

Layouts: JAX ``Conv1d`` kernels are ``(k, in, out)``, ``ConvTranspose1d``
``(k, out, in)``, ``Conv2d`` ``(kh, kw, in, out)``; torch wants
``(out, in, k)``, ``(in, out, k)`` and ``(out, in, kh, kw)``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

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


def _get(tree: Mapping[str, Any], path: Tuple[str, ...]) -> Any:
    for name in path:
        tree = tree[name]
    return tree


def jukebox_layout(cfg: Mapping[str, Any], decoder: bool) -> List[Tuple[Tuple[str, ...], str]]:
    """``(JAX path, port prefix)`` of every conv of a jukebox ``Encoder``
    (or ``Decoder``) built from ``cfg``: the JAX names (``level_l``,
    ``down_i``, ``res_i/block_d/conv{1,2}``, ``proj``, ``up_i``, ``out``)
    against the reference's ``nn.Sequential`` indices, where a reversed
    residual stack runs (and is numbered) deepest first."""
    depth = cfg.get("depth", 4)
    rev = decoder and cfg.get("reverse_decoder_dilation", False)
    rows: List[Tuple[Tuple[str, ...], str]] = []

    def res(jpath: Tuple[str, ...], prefix: str) -> None:
        for d in range(depth):
            j = depth - 1 - d if rev else d
            rows.append((jpath + (f"block_{d}", "conv1"), f"{prefix}.model.{j}.model.1"))
            rows.append((jpath + (f"block_{d}", "conv2"), f"{prefix}.model.{j}.model.3"))

    for level in range(cfg["levels"]):
        down_t, lvl, seq = cfg["downs_t"][level], (f"level_{level}",), f"level_blocks.{level}.model"
        if decoder:
            rows.append((lvl + ("proj",), f"{seq}.0"))
            for i in range(down_t):
                res(lvl + (f"res_{i}",), f"{seq}.{i + 1}.0")
                rows.append((lvl + (f"up_{i}",), f"{seq}.{i + 1}.1"))
        else:
            for i in range(down_t):
                rows.append((lvl + (f"down_{i}",), f"{seq}.{i}.0"))
                res(lvl + (f"res_{i}",), f"{seq}.{i}.1")
            rows.append((lvl + ("proj",), f"{seq}.{down_t}"))
    if decoder:
        rows.append((("out",), "out"))
    return rows


def _jukebox(sd: StateDict, prefix: str, tree: Mapping[str, Any], cfg, decoder: bool) -> None:
    # Conv1d (k, in, out) and ConvTranspose1d (k, out, in) both reverse their axes
    for path, name in jukebox_layout(cfg, decoder):
        _put(sd, f"{prefix}.{name}", _conv(_get(tree, path), _CONV1D))


def _vq_state(sd: StateDict, prefix: str, vq_state: Mapping[str, Any]) -> None:
    """A JAX ``Bottleneck``'s ``vq_state`` (``level_l``: ``k``, ``k_sum``,
    ``k_elem``, ``initted``) -> the port's buffers."""
    for level in range(len(vq_state)):
        st = vq_state[f"level_{level}"]
        for name in ("k", "k_sum", "k_elem"):
            sd[f"{prefix}.level_blocks.{level}.{name}"] = _t(st[name])
        sd[f"{prefix}.level_blocks.{level}.initted"] = torch.tensor(bool(st["initted"]))


def quantizer_state_dict(params: Mapping[str, Any], vq_state: Mapping[str, Any],
                         quantizer_params: Mapping[str, Any]) -> StateDict:
    """JAX ``Quantizer`` params and ``vq_state`` (what a quantizer ``g_``
    holds under ``generator`` and ``vq_state``) -> port ``Quantizer`` state
    dict; ``quantizer_params`` is the ``f0_*_params`` dict both were built
    from."""
    sd: StateDict = {}
    _jukebox(sd, "encoder", params["encoder"], quantizer_params["f0_encoder_params"], False)
    _jukebox(sd, "decoder", params["decoder"], quantizer_params["f0_decoder_params"], True)
    _vq_state(sd, "vq", vq_state["vq"])
    return sd


def generator_state_dict(params: Mapping[str, Any], h,
                         vq_state: Optional[Mapping[str, Any]] = None) -> StateDict:
    """JAX ``CodeGenerator`` params (folded or not) -> port ``CodeGenerator``
    state dict.  ``h`` is the matching ``VocoderConfig``; a ``lambda_commit``
    generator's ``f0_encoder`` comes from ``params`` and its codebook from
    ``vq_state`` (the JAX model's ``vq_state`` collection)."""
    sd: StateDict = {}
    if "f0_encoder" in params:
        _jukebox(sd, "f0_encoder", params["f0_encoder"], h.f0_encoder_params, False)
    if vq_state is not None:
        _vq_state(sd, "f0_vq", vq_state["f0_vq"])
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


def ecapa_layout(scale: int) -> List[Tuple[Tuple[str, ...], str, str]]:
    """``(JAX path, port prefix, kind)`` of every ECAPA layer: the JAX
    ``EcapaTDNN`` names against speechbrain's (what the JAX
    ``convert_speechbrain_state_dict`` reads); kind ``conv`` (a speechbrain
    ``Conv1d``), ``bn`` (params and batch stats) or ``dense`` (the k1-conv
    ``fc``).  ``scale`` is the Res2Net scale."""
    rows: List[Tuple[Tuple[str, ...], str, str]] = []

    def tdnn(jpath: Tuple[str, ...], prefix: str) -> None:
        rows.append((jpath + ("conv",), f"{prefix}.conv.conv", "conv"))
        rows.append((jpath + ("norm",), f"{prefix}.norm.norm", "bn"))

    tdnn(("block_0",), "blocks.0")
    for i in range(1, 4):
        b, p = f"block_{i}", f"blocks.{i}"
        tdnn((b, "tdnn1"), f"{p}.tdnn1")
        for j in range(scale - 1):
            tdnn((b, "res2net_block", f"block_{j}"), f"{p}.res2net_block.blocks.{j}")
        tdnn((b, "tdnn2"), f"{p}.tdnn2")
        for c in ("conv1", "conv2"):
            rows.append(((b, "se_block", c), f"{p}.se_block.{c}.conv", "conv"))
    tdnn(("mfa",), "mfa")
    tdnn(("asp", "tdnn"), "asp.tdnn")
    rows.append((("asp", "conv"), "asp.conv.conv", "conv"))
    rows.append((("asp_bn",), "asp_bn", "bn"))
    rows.append((("fc",), "fc.conv", "dense"))
    return rows


def ecapa_state_dict(params: Mapping[str, Any], batch_stats: Mapping[str, Any]) -> StateDict:
    """JAX ``EcapaTDNN`` ``params`` and ``batch_stats`` -> port ``EcapaTDNN``
    state dict, the inverse of the JAX ``convert_speechbrain_state_dict``."""
    sd: StateDict = {}
    for path, prefix, kind in ecapa_layout(len(params["block_1"]["res2net_block"]) + 1):
        tree = _get(params, path)
        if kind == "bn":
            stats = _get(batch_stats, path)
            _put(sd, prefix, {"weight": _t(tree["scale"]), "bias": _t(tree["bias"]),
                              "running_mean": _t(stats["mean"]),
                              "running_var": _t(stats["var"])})
        elif kind == "dense":
            _put(sd, prefix, {"weight": _t(np.asarray(tree["kernel"]).T[:, :, None]),
                              "bias": _t(tree["bias"])})
        else:
            _put(sd, prefix, _conv(tree, _CONV1D))
    return sd
