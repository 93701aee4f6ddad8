"""Carry weights from the JAX package's trees into the port's state dicts.

The logic of ``dissc_tpu/compat/torch_export.py`` (the JAX -> reference
torch layout), without importing it: each function takes a JAX tree as
nested dicts of numpy arrays (as ``jax.device_get`` or a ``g_``/``do_``
checkpoint gives it) and returns a state dict of CPU float32 tensors keyed
like the reference ``sr/models.py`` modules, which is what the port's
modules declare.

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
