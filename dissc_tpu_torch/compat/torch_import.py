"""Load the reference's own PyTorch checkpoints into the port's modules
(``dissc_tpu.compat.torch_import``).

The reference writes torch ``state_dict`` checkpoints: vocoder ``g_<step>``
= ``{"generator": CodeGenerator.state_dict()}`` and ``do_<step>`` with the
discriminators (``sr/train.py:206-214``), prosody ``best_model.pth`` =
``LenPredictor`` / ``PitchPredictor`` state dicts.  The port's modules
carry the reference's key names, so importing is a strict
``load_state_dict`` once the few layouts that differ are mapped:

* spectral norm (the MSD's first scale): torch keeps ``weight_orig``,
  ``weight_u`` and ``weight_v``; the port keeps ``weight_orig`` and
  ``weight_u`` and re-derives ``v`` from ``u`` on every call, as the JAX
  package does, so ``weight_v`` is dropped;
* the "new" pitch model's linear-ramp PE: the reference stores it as the
  buffer ``pe.pe`` (850 positions); the port computes it, so the buffer is
  checked against the port's ramp and dropped.

Weight norm (``weight_g`` / ``weight_v``, per output channel for a conv,
per input channel for a transposed conv), the BatchNorm buffers and
``num_batches_tracked`` have the same names and shapes in both.  Any other
key, or a key the module needs and ``sd`` lacks, fails the strict load.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from dissc_tpu_torch.models.discriminators import MultiPeriodDiscriminator, MultiScaleDiscriminator
from dissc_tpu_torch.models.hifigan import CodeGenerator
from dissc_tpu_torch.models.prosody import PE_MAX_LEN, LenPredictor, PitchPredictor, PitchPredictorBase

StateDict = Dict[str, torch.Tensor]


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """``torch.load`` with ``weights_only=True``, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def unwrap(obj: Mapping[str, Any], key: str) -> Mapping[str, Any]:
    """``obj[key]`` for a checkpoint that wraps its state dict (``{"generator":
    ...}``, ``{"mpd": ...}``), else ``obj`` itself."""
    return obj[key] if key in obj else obj


def _tensors(sd: Mapping[str, Any]) -> StateDict:
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in sd.items()}


def _drop_power_iteration_v(sd: StateDict) -> StateDict:
    return {k: v for k, v in sd.items()
            if not (k.endswith(".weight_v") and k[:-len("v")] + "orig" in sd)}


def _load(module: torch.nn.Module, sd: StateDict) -> torch.nn.Module:
    module.load_state_dict(sd)
    return module


def import_code_generator(sd: Mapping[str, Any], h) -> CodeGenerator:
    """Reference ``CodeGenerator.state_dict()`` -> port ``CodeGenerator(h)``
    on the CPU.  ``h`` is the matching ``VocoderConfig``.  The reference's
    VQ branch stores only its codebook ``k`` (no EMA statistics), so a
    ``lambda_commit`` state dict is not importable: its keys fail the load."""
    return _load(CodeGenerator(h), _tensors(unwrap(sd, "generator")))


def import_vocoder_checkpoint(path: str, h) -> CodeGenerator:
    """A reference ``g_<step>`` file -> port ``CodeGenerator``."""
    return import_code_generator(load_torch_state_dict(path), h)


def import_mpd(sd: Mapping[str, Any], periods: Sequence[int] = (2, 3, 5, 7, 11)
               ) -> MultiPeriodDiscriminator:
    """Reference ``MultiPeriodDiscriminator.state_dict()`` -> port MPD (the
    periods are not in the state dict; the reference's are the default)."""
    return _load(MultiPeriodDiscriminator(periods), _tensors(unwrap(sd, "mpd")))


def import_msd(sd: Mapping[str, Any], scales: int = 3) -> MultiScaleDiscriminator:
    """Reference ``MultiScaleDiscriminator.state_dict()`` -> port MSD."""
    return _load(MultiScaleDiscriminator(scales),
                 _drop_power_iteration_v(_tensors(unwrap(sd, "msd"))))


def import_len_predictor(sd: Mapping[str, Any]) -> LenPredictor:
    """Reference ``LenPredictor.state_dict()`` -> port ``LenPredictor``, sized
    from its embedding tables."""
    sd = _tensors(sd)
    n_tokens = sd["token_emb.weight"].shape[0] - 1
    return _load(LenPredictor(n_tokens=n_tokens, n_speakers=sd["spk_emb.weight"].shape[0],
                              emb_size=sd["spk_emb.weight"].shape[1],
                              hidden=sd["cnn1.weight"].shape[0]), sd)


def import_pitch_predictor(sd: Mapping[str, Any], model_type: str = "new"):
    """Reference ``PitchPredictor`` ("new") or ``PitchPredictorBase``
    ("base") state dict -> the port's model, sized from its tables."""
    sd = _tensors(sd)
    if "pe.pe" in sd:
        pe = sd.pop("pe.pe")[0]
        ramp = torch.linspace(0.0, 1.0, PE_MAX_LEN)[:, None]
        half = pe.shape[1] // 2
        want = torch.cat([ramp.expand(-1, half), (1.0 - ramp).expand(-1, pe.shape[1] - half)],
                         dim=1)
        if pe.shape != want.shape or not torch.allclose(pe.float(), want, atol=1e-6):
            raise ValueError("pe.pe is not the linear ramp the port computes")
    cls = PitchPredictorBase if model_type == "base" else PitchPredictor
    return _load(cls(n_tokens=sd["token_emb.weight"].shape[0] - 1,
                     n_speakers=sd["spk_emb.weight"].shape[0] - 1,  # a padding row
                     emb_size=sd["spk_emb.weight"].shape[1],
                     hidden=sd["cnn1.weight"].shape[0]), sd)
