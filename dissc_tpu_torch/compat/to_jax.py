"""Carry the port's state dicts into the JAX package's trees: the inverse of
:mod:`dissc_tpu_torch.compat.from_jax`.

The trainers write their checkpoints through these functions, so a
``g_<08d>``, ``do_<08d>`` (the discriminators) or ``best_model.pth``
written by the port has the JAX package's layout (and ``hubert_params``
writes the HuBERT pickle ``cli.encode`` reads, ``ecapa_variables`` the
ECAPA pickle ``cli.eval_sv --embedder`` reads, ``quantizer_trees`` an F0
quantizer's ``g_``): nested dicts of numpy float32 arrays that either
package loads.  Layouts: torch ``Conv1d``
``(out, in, k)`` -> JAX ``(k, in, out)``, ``ConvTranspose1d``
``(in, out, k)`` -> ``(k, out, in)``, ``Conv2d`` ``(out, in, kh, kw)`` ->
``(kh, kw, in, out)``; a weight-norm ``weight_g`` of C channels ->
``g`` of shape ``(1, ..., 1, C)``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from dissc_tpu_torch.compat.from_jax import ecapa_layout, jukebox_layout

Tree = Dict[str, Any]

_CONV1D = (2, 1, 0)      # (out, in, k) -> (k, in, out); (in, out, k) -> (k, out, in)
_CONV2D = (2, 3, 1, 0)   # (out, in, kh, kw) -> (kh, kw, in, out)


def generator_flax_shape(shape) -> Tuple[int, ...]:
    """The shape :func:`generator_tree` writes for a generator tensor of
    ``shape``: a conv kernel (``(out, in, k)``, or ``(in, out, k)`` for a
    transposed conv) or weight-norm gain (``(C, 1, 1)``) in the flax layout,
    so its last dimension is the output channels of a conv and the input
    channels of a transposed conv; an embedding or a bias as it is."""
    return tuple(shape[i] for i in _CONV1D) if len(shape) == 3 else tuple(shape)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _conv(sd: Mapping[str, torch.Tensor], prefix: str, perm) -> Tuple[Tree, Dict[str, np.ndarray]]:
    """One conv's params and, for a spectral-norm conv, its ``{u}`` state."""
    tree: Tree = {}
    spectral: Dict[str, np.ndarray] = {}
    if f"{prefix}.weight_v" in sd:
        v = _np(sd[f"{prefix}.weight_v"]).transpose(perm)
        tree["v"] = np.ascontiguousarray(v)
        tree["g"] = _np(sd[f"{prefix}.weight_g"]).reshape((1,) * (v.ndim - 1) + (-1,))
    elif f"{prefix}.weight_orig" in sd:
        tree["kernel"] = np.ascontiguousarray(_np(sd[f"{prefix}.weight_orig"]).transpose(perm))
        spectral["u"] = _np(sd[f"{prefix}.weight_u"])
    else:
        tree["kernel"] = np.ascontiguousarray(_np(sd[f"{prefix}.weight"]).transpose(perm))
    if f"{prefix}.bias" in sd:
        tree["bias"] = _np(sd[f"{prefix}.bias"])
    return tree, spectral


def _set(tree: Tree, path: Tuple[str, ...], value: Any) -> None:
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = value


def _jukebox(sd: Mapping[str, torch.Tensor], prefix: str, cfg, decoder: bool) -> Tree:
    tree: Tree = {}
    for path, name in jukebox_layout(cfg, decoder):
        _set(tree, path, _conv(sd, f"{prefix}.{name}", _CONV1D)[0])
    return tree


def vq_state_tree(sd: Mapping[str, torch.Tensor], prefix: str) -> Tree:
    """A port ``Bottleneck``'s buffers under ``prefix`` -> the JAX
    ``vq_state`` of that module (``level_l``: ``k``, ``k_sum``, ``k_elem``,
    ``initted``)."""
    levels = {k[len(prefix):].split(".")[2] for k in sd if k.startswith(f"{prefix}.level_blocks.")}
    return {f"level_{level}": {
        "k": _np(sd[f"{prefix}.level_blocks.{level}.k"]),
        "k_sum": _np(sd[f"{prefix}.level_blocks.{level}.k_sum"]),
        "k_elem": _np(sd[f"{prefix}.level_blocks.{level}.k_elem"]),
        "initted": np.asarray(bool(sd[f"{prefix}.level_blocks.{level}.initted"]))}
        for level in sorted(levels, key=int)}


def quantizer_trees(sd: Mapping[str, torch.Tensor], quantizer_params: Mapping[str, Any]
                    ) -> Tuple[Tree, Tree]:
    """Port ``Quantizer`` state dict -> (JAX params, ``vq_state``): what a
    quantizer ``g_`` holds under ``generator`` and ``vq_state``."""
    params = {"encoder": _jukebox(sd, "encoder", quantizer_params["f0_encoder_params"], False),
              "decoder": _jukebox(sd, "decoder", quantizer_params["f0_decoder_params"], True)}
    return params, {"vq": vq_state_tree(sd, "vq")}


def generator_tree(sd: Mapping[str, torch.Tensor], h) -> Tree:
    """Port ``CodeGenerator`` state dict -> the JAX ``CodeGenerator`` params
    (what a ``g_`` checkpoint holds under ``"generator"``), with
    ``f0_encoder`` for a ``lambda_commit`` generator (whose codebook
    :func:`vq_state_tree` carries, prefix ``f0_vq``)."""
    gen: Tree = {"conv_pre": _conv(sd, "conv_pre", _CONV1D)[0],
                 "conv_post": _conv(sd, "conv_post", _CONV1D)[0]}
    for i in range(len(h.upsample_rates)):
        gen[f"ups_{i}"] = _conv(sd, f"ups.{i}", _CONV1D)[0]
    for n in range(len(h.upsample_rates) * len(h.resblock_kernel_sizes)):
        # convs1_j / convs2_j (ResBlock1) or convs_j (ResBlock2), as many as it has
        convs = sorted({k.rsplit(".", 1)[0] for k in sd if k.startswith(f"resblocks.{n}.")})
        gen[f"resblocks_{n}"] = {"_".join(c.split(".")[2:]): _conv(sd, c, _CONV1D)[0]
                                 for c in convs}
    params: Tree = {"generator": gen, "dict": {"embedding": _np(sd["dict.weight"])}}
    if "spkr.weight" in sd:
        params["spkr"] = {"embedding": _np(sd["spkr.weight"])}
    if h.lambda_commit:
        params["f0_encoder"] = _jukebox(sd, "f0_encoder", h.f0_encoder_params, False)
    return params


def mpd_tree(sd: Mapping[str, torch.Tensor]) -> Tree:
    """Port MPD state dict -> JAX ``MultiPeriodDiscriminator`` params."""
    n = len({k.split(".")[1] for k in sd if k.startswith("discriminators.")})
    params: Tree = {}
    for i in range(n):
        d = {f"convs_{j}": _conv(sd, f"discriminators.{i}.convs.{j}", _CONV2D)[0]
             for j in range(5)}
        d["conv_post"] = _conv(sd, f"discriminators.{i}.conv_post", _CONV2D)[0]
        params[f"disc_{i}"] = d
    return params


def msd_trees(sd: Mapping[str, torch.Tensor]) -> Tuple[Tree, Tree]:
    """Port MSD state dict -> (JAX ``MultiScaleDiscriminator`` params, its
    ``spectral`` collection: ``u`` per spectral-norm conv)."""
    n = len({k.split(".")[1] for k in sd if k.startswith("discriminators.")})
    params: Tree = {}
    spectral: Tree = {}
    for i in range(n):
        d: Tree = {}
        s: Tree = {}
        for name in [f"convs_{j}" for j in range(7)] + ["conv_post"]:
            prefix = (f"discriminators.{i}.conv_post" if name == "conv_post"
                      else f"discriminators.{i}.convs.{name.split('_')[1]}")
            d[name], u = _conv(sd, prefix, _CONV1D)
            if u:
                s[name] = u
        params[f"disc_{i}"] = d
        if s:
            spectral[f"disc_{i}"] = s
    return params, spectral


def _bn(sd: Mapping[str, torch.Tensor], name: str) -> Tuple[Tree, Tree]:
    """``FlaxBatchNorm`` -> (``{BatchNorm_0: {scale, bias}}``, ``{BatchNorm_0:
    {mean, var}}``); ``num_batches_tracked`` has no JAX counterpart."""
    return ({"BatchNorm_0": {"scale": _np(sd[f"{name}.weight"]),
                             "bias": _np(sd[f"{name}.bias"])}},
            {"BatchNorm_0": {"mean": _np(sd[f"{name}.running_mean"]),
                             "var": _np(sd[f"{name}.running_var"])}})


def len_predictor_variables(sd: Mapping[str, torch.Tensor]) -> Tree:
    """Port ``LenPredictor`` state dict -> JAX ``{params, batch_stats}``."""
    params: Tree = {"token_emb": {"embedding": _np(sd["token_emb.weight"])},
                    "spk_emb": {"embedding": _np(sd["spk_emb.weight"])}}
    stats: Tree = {}
    for c in ["cnn1"] + [f"cnn1{i}" for i in range(1, 7)] + ["cnn2"]:
        params[c] = _conv(sd, c, _CONV1D)[0]
    for bn in ["bn1"] + [f"bn1{i}" for i in range(1, 7)]:
        params[bn], stats[bn] = _bn(sd, bn)
    return {"params": params, "batch_stats": stats}


def pitch_predictor_variables(sd: Mapping[str, torch.Tensor]) -> Tree:
    """Port ``PitchPredictor``/``PitchPredictorBase`` state dict -> JAX
    ``{params: {core}, batch_stats: {core}}``; the BatchNorms present in
    ``sd`` say which variant it is."""
    params: Tree = {"token_emb": {"embedding": _np(sd["token_emb.weight"])},
                    "spk_emb": {"embedding": _np(sd["spk_emb.weight"])}}
    stats: Tree = {}
    convs = (["cnn1"] + [f"cnn1{i}" for i in range(1, 8)]
             + ["cnn2", "cnn_class1", "cnn_class2", "cnn_reg1", "cnn_reg2"])
    for c in convs:
        params[c] = _conv(sd, c, _CONV1D)[0]
    for bn in sorted({k.split(".")[0] for k in sd if k.startswith("bn")}):
        params[bn], stats[bn] = _bn(sd, bn)
    return {"params": {"core": params}, "batch_stats": {"core": stats}}


def hubert_params(sd: Mapping[str, torch.Tensor], cfg) -> Tree:
    """Port ``HubertEncoder`` state dict (``HubertModel`` keys) -> the JAX
    ``HubertEncoder`` params, what ``cli.encode --hubert_weights`` reads (the
    inverse of ``from_jax.hubert_state_dict``; the pos-conv gain ``[1, 1, k]``
    -> ``g`` ``[k, 1, 1]``)."""
    def ln(prefix: str) -> Tree:
        return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}

    def dense(prefix: str) -> Tree:
        return {"kernel": np.ascontiguousarray(_np(sd[f"{prefix}.weight"]).T),
                "bias": _np(sd[f"{prefix}.bias"])}

    fe: Tree = {f"conv_{i}": {"kernel": np.ascontiguousarray(
        _np(sd[f"feature_extractor.conv_layers.{i}.conv.weight"]).transpose(_CONV1D))}
        for i in range(len(cfg.conv_dim))}
    fe["group_norm"] = ln("feature_extractor.conv_layers.0.layer_norm")
    params: Tree = {
        "feature_extractor": fe,
        "fp_layer_norm": ln("feature_projection.layer_norm"),
        "fp_projection": dense("feature_projection.projection"),
        "pos_conv": {"g": _np(sd["encoder.pos_conv_embed.conv.weight_g"]).reshape(-1, 1, 1),
                     "v": np.ascontiguousarray(
                         _np(sd["encoder.pos_conv_embed.conv.weight_v"]).transpose(_CONV1D)),
                     "bias": _np(sd["encoder.pos_conv_embed.conv.bias"])},
        "encoder_layer_norm": ln("encoder.layer_norm"),
    }
    i = 0
    while f"encoder.layers.{i}.layer_norm.weight" in sd:
        p = f"encoder.layers.{i}"
        layer = {name: dense(f"{p}.attention.{name}")
                 for name in ("q_proj", "k_proj", "v_proj", "out_proj")}
        layer.update(self_attn_layer_norm=ln(f"{p}.layer_norm"),
                     fc1=dense(f"{p}.feed_forward.intermediate_dense"),
                     fc2=dense(f"{p}.feed_forward.output_dense"),
                     final_layer_norm=ln(f"{p}.final_layer_norm"))
        params[f"layer_{i}"] = layer
        i += 1
    return params


def ecapa_variables(sd: Mapping[str, torch.Tensor]) -> Tuple[Tree, Tree]:
    """Port ``EcapaTDNN`` state dict -> JAX ``(params, batch_stats)``: what
    ``cli.eval_sv --embedder`` reads (the pickle the JAX
    ``convert_speechbrain_state_dict`` output is saved as)."""
    scale = 1 + len({k for k in sd if k.startswith("blocks.1.res2net_block.blocks.")
                     and k.endswith(".conv.conv.weight")})
    params: Tree = {}
    stats: Tree = {}
    for path, prefix, kind in ecapa_layout(scale):
        if kind == "bn":
            _set(params, path, {"scale": _np(sd[f"{prefix}.weight"]),
                                "bias": _np(sd[f"{prefix}.bias"])})
            _set(stats, path, {"mean": _np(sd[f"{prefix}.running_mean"]),
                               "var": _np(sd[f"{prefix}.running_var"])})
        elif kind == "dense":
            _set(params, path, {"kernel": np.ascontiguousarray(_np(sd[f"{prefix}.weight"])[:, :, 0].T),
                                "bias": _np(sd[f"{prefix}.bias"])})
        else:
            _set(params, path, _conv(sd, prefix, _CONV1D)[0])
    return params, stats
