"""Configuration: the vocoder hyper-parameters and the reference JSON schema.

A copy of ``dissc_tpu.core.config`` (``AttrDict``, ``load_config``,
``build_env``, ``VocoderConfig``, ``ProsodyConfig``) that imports nothing
of the JAX package, so the port reads the same ``config.json`` files
(``sr/configs/{VCTK,ESD}/hubert100_lut.json``).

Knobs of the JAX package fall in four groups here:

* reference fields and the ensemble sizes (``mpd_periods``,
  ``msd_scales``): honoured;
* ``msd_fused_gstep``: the G step runs the MSD through the fused stack of
  ``models/msd_fused.py`` (same forward, a backward for the waveform that
  keeps no pre-activation maps), as the JAX step does;
* layouts for the TPU's registers with the plain form's numbers
  (``mrf_pack_max_ch``, ``disc_s2d``, ``dp_axis``): accepted and ignored;
  the port's cuDNN convs are their counterpart;
* the mixed-precision knobs: ``compute_dtype`` (the generator) and
  ``disc_compute_dtype`` (MPD and MSD) take ``"bfloat16"``, which runs
  those convolutions in bfloat16 with float32 parameters, as flax's
  ``dtype`` does (:func:`resolve_dtype`); ``param_dtype`` is accepted
  and read by nothing, as in the JAX package, so parameters stay float32;
* the F0-VQ path: ``lambda_commit`` with ``f0_encoder_params`` and
  ``f0_vq_params`` builds ``CodeGenerator``'s quantised-f0 branch;
  ``lambda_commit_code`` raises ``NotImplementedError``, since the JAX
  ``CodeGenerator`` has no code-VQ branch and ignores it.

Reference behaviours mirrored on purpose: ``f0_feats`` is a dead field in
the reference and in ``dissc_tpu`` alike, and ``param_dtype`` in
``dissc_tpu``; both are kept for the schema and read by nothing.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Optional, Sequence

import torch

_F32_NAMES = (None, "float32", "f32")
_COMPUTE_DTYPES = {"bfloat16": torch.bfloat16}


def resolve_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """A compute-dtype name -> the dtype the convolutions and matmuls run in:
    ``None``, ``"float32"`` and ``"f32"`` give ``None`` (the plain float32
    path, as the JAX ``_resolve_dtype``), ``"bfloat16"`` gives
    ``torch.bfloat16``; any other name raises ``ValueError``."""
    if name in _F32_NAMES:
        return None
    if name not in _COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {name!r}: the port computes in float32 or bfloat16 "
                         f"(one of {sorted(_COMPUTE_DTYPES)} or {list(_F32_NAMES)})")
    return _COMPUTE_DTYPES[name]


class AttrDict(dict):
    """Dict with attribute access and ``.get`` defaulting (reference-compatible)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__ = self


def load_config(path: str) -> AttrDict:
    with open(path) as f:
        return AttrDict(json.load(f))


def build_env(config_path: str, config_name: str, out_dir: str) -> None:
    """Copy the config-of-record into the checkpoint dir (reference ``sr/utils.py:70-75``)."""
    target = os.path.join(out_dir, config_name)
    if config_path != target:
        os.makedirs(out_dir, exist_ok=True)
        shutil.copyfile(config_path, target)


@dataclasses.dataclass
class VocoderConfig:
    """HiFi-GAN vocoder hyper-parameters (same fields as ``dissc_tpu``).

    The defaults are the reference ``hubert100_lut.json``: 512 initial
    channels, upsample rates 5*4*4*2*2 = 320, MRF kernels (3, 7, 11) x
    dilations (1, 3, 5), 100 units with 128-dim embeddings, f0 on,
    multi-speaker, 8960-sample segments at batch 64.
    """

    resblock: str = "1"
    num_gpus: int = 0
    batch_size: int = 64
    learning_rate: float = 8e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999
    seed: int = 1234

    upsample_rates: Sequence[int] = (5, 4, 4, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (11, 8, 8, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    num_embeddings: int = 100
    embedding_dim: int = 128
    model_in_dim: Optional[int] = 257

    segment_size: int = 8960
    code_hop_size: int = 320
    f0: bool = True
    multispkr: Optional[str] = "_"
    num_mels: int = 80
    num_freq: int = 1025
    n_fft: int = 1024
    hop_size: int = 256
    win_size: int = 1024

    sampling_rate: int = 16000
    fmin: int = 0
    fmax: Optional[int] = 8000
    fmax_for_loss: Optional[int] = None

    f0_stats: Optional[str] = None
    f0_normalize: bool = False
    f0_feats: bool = False  # dead in the reference too; read by nothing
    f0_median: bool = False
    f0_interp: bool = False

    input_training_file: str = ""
    input_validation_file: str = ""
    train_base_path: str = ""
    val_base_path: str = ""
    test_base_path: str = ""
    num_workers: int = 4

    # VQ options (reference sr/models.py:137-156): the f0 branch is built from
    # lambda_commit; lambda_commit_code raises (see __post_init__)
    lambda_commit: Optional[float] = None
    f0_encoder_params: Optional[dict] = None
    f0_vq_params: Optional[dict] = None
    lambda_commit_code: Optional[float] = None
    code_encoder_params: Optional[dict] = None
    code_vq_params: Optional[dict] = None
    f0_quantizer_path: Optional[str] = None
    f0_quantizer: Optional[dict] = None

    # JAX-package knobs.  Ensemble sizes and msd_fused_gstep are honoured;
    # the TPU layouts (dp_axis, mrf_pack_max_ch, disc_s2d) give the same
    # numbers as the plain form and are accepted and ignored here, as is
    # param_dtype, which the JAX package reads nowhere (params stay f32).
    dp_axis: str = "data"
    mpd_periods: Sequence[int] = (2, 3, 5, 7, 11)
    msd_scales: int = 3
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    mrf_pack_max_ch: int = 64
    disc_s2d: bool = False
    msd_fused_gstep: bool = False
    disc_compute_dtype: str = "float32"
    # True when the generator's weight-norm (v, g) pairs are folded into
    # plain ``weight`` tensors (models.layers.fold_weight_norm).
    folded_weights: bool = False

    def __post_init__(self):
        resolve_dtype(self.compute_dtype)
        resolve_dtype(self.disc_compute_dtype)
        if self.lambda_commit_code:
            raise NotImplementedError(
                "lambda_commit_code is set: the JAX CodeGenerator has no code-VQ branch "
                "(it ignores the key), so the port has none either (ROADMAP: reference "
                "behaviours)")

    @classmethod
    def from_json(cls, path: str) -> "VocoderConfig":
        with open(path) as f:
            raw = json.load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: dict) -> "VocoderConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in fields})

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)


@dataclasses.dataclass
class ProsodyConfig:
    """Shared config of the rhythm and pitch trainers
    (``dissc_tpu.core.config.ProsodyConfig`` without ``max_len``, which
    nothing reads, and ``dp_axis``: the port trains on one device).
    Defaults mirror the reference CLIs (``train_len_predictor.py:118-127``,
    ``train_f0_predictor.py:111-121``)."""

    n_tokens: int = 100
    batch_size: int = 32
    learning_rate: float = 3e-4
    n_epochs: int = 30
    seed: int = 42
    model_type: str = "base"  # pitch model: "base" | "new"
    emb_size: int = 32
    hidden: int = 128
    len_masking_rate: float = 0.2
    pitch_masking_rate: float = 0.4
