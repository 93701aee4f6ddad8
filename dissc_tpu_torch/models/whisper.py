"""Whisper encoder-decoder for WER/CER evaluation (``dissc_tpu.models.whisper``).

The reference transcribes each converted utterance with OpenAI Whisper
``medium.en`` (reference ``eval.py:18,156``).  Here:

  * the log-mel front end in torch, as the JAX package computes it: a
    centred STFT (reflect pad 200, periodic Hann 400, hop 160) as two real
    matmuls, the power spectrum with the last frame dropped, slaney mel
    filters, ``log10(clamp(1e-10))`` floored at ``max - 8``, ``(x + 4) / 4``;
  * ``nn.Module``s named as transformers' ``WhisperForConditionalGeneration``
    names them, so its state dict (or one carried from the JAX package by
    ``compat.from_jax.whisper_state_dict``) loads directly.  Pre-LN layers,
    exact GELU, q scaled by ``head_dim ** -0.5``, no bias on ``k_proj``, the
    output projection tied to the token embedding with no bias, masked
    scores set to ``-1e9`` (not ``-inf``), as in the JAX package;
  * greedy decoding with a KV cache on the device (:func:`greedy_decode`):
    ``max_len`` steps whatever the tokens, nothing read back to the host
    per token (``done`` stays a device tensor, as in the JAX ``lax.scan``),
    ``eos`` after the first EOS.

Float32 throughout; on the card TF32 is off (``device.resolve_device``).
The DFT and the attention products are ``torch.matmul``: the JAX package
computes them outside any Pallas kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dissc_tpu_torch.audio.mel import _device_tensors, _mel_tensor
from dissc_tpu_torch.audio.resample import resample_poly_np
from dissc_tpu_torch.core.wav import read_wav
from dissc_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Architecture hyper-params (defaults: medium.en)."""

    vocab_size: int = 51864
    num_mel_bins: int = 80
    d_model: int = 1024
    encoder_layers: int = 24
    decoder_layers: int = 24
    num_heads: int = 16
    ffn_dim: int = 4096
    max_source_positions: int = 1500
    max_target_positions: int = 448
    eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


# ---------------------------------------------------------------------------
# Log-mel front end (whisper audio.py semantics)
# ---------------------------------------------------------------------------

N_FFT = 400
HOP = 160
SAMPLE_RATE = 16000
CHUNK_SAMPLES = 30 * SAMPLE_RATE  # 480000 -> 3000 mel frames


def log_mel_spectrogram(wav: torch.Tensor, num_mels: int = 80) -> torch.Tensor:
    """``[B, 480000]`` padded/trimmed waveform -> ``[B, 3000, num_mels]`` log-mel."""
    pad = N_FFT // 2
    y = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
    window, cos_b, sin_b = _device_tensors(N_FFT, N_FFT, wav.device)
    frames = y.unfold(-1, N_FFT, HOP) * window  # [B, F, 400]
    re = frames @ cos_b
    im = frames @ sin_b
    power = (re * re + im * im)[:, :-1, :]  # the last frame dropped (whisper audio.py)
    mel = _mel_tensor(SAMPLE_RATE, N_FFT, num_mels, 0.0, None, wav.device)
    log_spec = torch.log10(torch.clamp(power @ mel.T, min=1e-10))
    floor = torch.amax(log_spec, dim=(1, 2), keepdim=True) - 8.0
    return (torch.maximum(log_spec, floor) + 4.0) / 4.0


def pad_or_trim(wav: np.ndarray, length: int = CHUNK_SAMPLES) -> np.ndarray:
    """Whisper's 30 s chunking contract (audio.py ``pad_or_trim``)."""
    if len(wav) >= length:
        return wav[:length]
    return np.pad(wav, (0, length - len(wav)))


# ---------------------------------------------------------------------------
# Layers, with transformers' parameter names
# ---------------------------------------------------------------------------


def _heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], nh, x.shape[-1] // nh)


class WhisperAttention(nn.Module):
    def __init__(self, d: int, nh: int):
        super().__init__()
        self.nh = nh
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def query(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, T, d]`` -> scaled ``[B, T, H, hd]`` queries."""
        return _heads(self.q_proj(x), self.nh) * (x.shape[-1] // self.nh) ** -0.5

    def keys_values(self, x: torch.Tensor):
        return _heads(self.k_proj(x), self.nh), _heads(self.v_proj(x), self.nh)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            scores = torch.where(mask, scores, torch.full_like(scores, -1e9))
        ctx = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
        return self.out_proj(ctx.reshape(*ctx.shape[:-2], -1))

    def forward(self, x: torch.Tensor, kv: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        k, v = self.keys_values(x if kv is None else kv)
        return self.attend(self.query(x), k, v, mask)


def _ffn(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The layer's ``fc1`` -> exact GELU -> ``fc2`` (HF keeps both on the layer)."""
    return layer.fc2(F.gelu(layer.fc1(x)))


class WhisperEncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn = WhisperAttention(d, cfg.num_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=cfg.eps)
        self.fc1 = nn.Linear(d, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=cfg.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x))
        return x + _ffn(self, self.final_layer_norm(x))


class WhisperDecoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn = WhisperAttention(d, cfg.num_heads)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=cfg.eps)
        self.encoder_attn = WhisperAttention(d, cfg.num_heads)
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=cfg.eps)
        self.fc1 = nn.Linear(d, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=cfg.eps)

    def forward(self, x: torch.Tensor, enc_out: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x), mask=mask)
        x = x + self.encoder_attn(self.encoder_attn_layer_norm(x), kv=enc_out)
        return x + _ffn(self, self.final_layer_norm(x))

    def step(self, x: torch.Tensor, pos: int, k_cache: torch.Tensor, v_cache: torch.Tensor,
             xk: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
        """One token ``[B, 1, d]`` at position ``pos``: its key and value go
        into the caches ``[B, total, H, hd]``, it attends to positions
        ``0..pos`` and to the precomputed cross keys/values."""
        y = self.self_attn_layer_norm(x)
        k, v = self.self_attn.keys_values(y)
        k_cache[:, pos] = k[:, 0]
        v_cache[:, pos] = v[:, 0]
        x = x + self.self_attn.attend(self.self_attn.query(y), k_cache[:, : pos + 1],
                                      v_cache[:, : pos + 1])
        y = self.encoder_attn_layer_norm(x)
        x = x + self.encoder_attn.attend(self.encoder_attn.query(y), xk, xv)
        return x + _ffn(self, self.final_layer_norm(x))


class WhisperEncoder(nn.Module):
    """``[B, 2 * max_source_positions, n_mels]`` log-mel -> ``[B, Tsrc, d]``:
    conv (k 3) -> GELU -> conv (k 3, stride 2) -> GELU -> + positions ->
    pre-LN layers -> final LN."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.embed_positions = nn.Embedding(cfg.max_source_positions, d)
        self.layers = nn.ModuleList(WhisperEncoderLayer(cfg) for _ in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(d, eps=cfg.eps)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.conv1(mel.transpose(1, 2)))
        h = F.gelu(self.conv2(h)).transpose(1, 2)
        h = h + self.embed_positions.weight[None, : h.shape[1]]
        for layer in self.layers:
            h = layer(h)
        return self.layer_norm(h)


class WhisperDecoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d)
        self.embed_positions = nn.Embedding(cfg.max_target_positions, d)
        self.layers = nn.ModuleList(WhisperDecoderLayer(cfg) for _ in range(cfg.decoder_layers))
        self.layer_norm = nn.LayerNorm(d, eps=cfg.eps)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """Final LN, then the output projection tied to the embedding (no bias)."""
        return self.layer_norm(h) @ self.embed_tokens.weight.T


class _WhisperModel(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.encoder = WhisperEncoder(cfg)
        self.decoder = WhisperDecoder(cfg)


class Whisper(nn.Module):
    """The encoder-decoder under ``model.`` (transformers'
    ``WhisperForConditionalGeneration`` key layout; ``proj_out`` is the tied
    embedding and has no parameter of its own)."""

    def __init__(self, cfg: WhisperConfig = WhisperConfig()):
        super().__init__()
        self.cfg = cfg
        self.model = _WhisperModel(cfg)

    def load_hf_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Load a ``WhisperForConditionalGeneration`` state dict (strict).  A
        ``proj_out.weight`` must be the embedding: the projection is tied."""
        sd = dict(sd)
        proj = sd.pop("proj_out.weight", None)
        if proj is not None and not torch.equal(proj, sd["model.decoder.embed_tokens.weight"]):
            raise ValueError("proj_out.weight differs from the token embedding: this model "
                             "ties them, as Whisper does")
        self.load_state_dict(sd)


def encode(model: Whisper, mel: torch.Tensor) -> torch.Tensor:
    """``[B, 2 * Tsrc, n_mels]`` log-mel -> ``[B, Tsrc, d]`` encoder states."""
    return model.model.encoder(mel)


def decode_full(model: Whisper, tokens: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder: ``[B, Ttgt]`` tokens -> ``[B, Ttgt, vocab]`` logits."""
    dec = model.model.decoder
    t = tokens.shape[1]
    h = dec.embed_tokens(tokens) + dec.embed_positions.weight[None, :t]
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=tokens.device))[None, None]
    for layer in dec.layers:
        h = layer(h, enc_out, causal)
    return dec.logits(h)


@torch.inference_mode()
def greedy_decode(model: Whisper, mel: torch.Tensor, initial_tokens: Sequence[int], eos_id: int,
                  max_len: int = 224, suppress_ids: Optional[Sequence[int]] = None
                  ) -> torch.Tensor:
    """Encode, then ``max_len`` greedy steps with per-layer KV caches, on
    ``mel``'s device.  ``initial_tokens`` is the forced prompt shared by the
    batch (e.g. ``<|startoftranscript|> <|notimestamps|>``).  Returns
    ``[B, max_len]`` int64 tokens, ``eos_id`` after the first EOS.  No value
    is read back to the host inside the loop."""
    cfg, dec = model.cfg, model.model.decoder
    dev = mel.device
    b, n_init = mel.shape[0], len(initial_tokens)
    total = n_init + max_len
    enc_out = encode(model, mel)
    cross = [layer.encoder_attn.keys_values(enc_out) for layer in dec.layers]
    k_cache = torch.zeros((cfg.decoder_layers, b, total, cfg.num_heads, cfg.head_dim),
                          dtype=enc_out.dtype, device=dev)
    v_cache = torch.zeros_like(k_cache)

    def step(tok: torch.Tensor, pos: int) -> torch.Tensor:
        x = dec.embed_tokens(tok)[:, None] + dec.embed_positions.weight[pos][None, None]
        for i, layer in enumerate(dec.layers):
            x = layer.step(x, pos, k_cache[i], v_cache[i], *cross[i])
        return dec.logits(x[:, 0])

    logits = None
    for i, t in enumerate(initial_tokens):
        logits = step(torch.full((b,), int(t), dtype=torch.long, device=dev), i)
    supp = torch.zeros(cfg.vocab_size, device=dev)
    if suppress_ids is not None:
        supp[torch.as_tensor(list(suppress_ids), device=dev)] = -math.inf
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    eos = torch.full((b,), eos_id, dtype=torch.long, device=dev)
    toks = []
    for i in range(max_len):
        tok = torch.where(done, eos, torch.argmax(logits + supp, dim=-1))
        done = done | (tok == eos_id)
        toks.append(tok)
        if i + 1 < max_len:  # the last step's logits would go unused
            logits = step(tok, n_init + i)
    return torch.stack(toks, dim=1)


def init_state_dict(cfg: WhisperConfig, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random weights in the HF key layout, drawn from ``generator``: every
    matrix, conv kernel, embedding and position table N(0, 0.02), norms at
    scale 1 and every bias 0 (the JAX ``init_params``'s scheme)."""
    with torch.device("meta"):
        shapes = Whisper(cfg).state_dict()
    sd = {}
    for key, t in shapes.items():
        if key.endswith("bias"):
            sd[key] = torch.zeros(t.shape)
        elif "layer_norm" in key:
            sd[key] = torch.ones(t.shape)
        else:
            sd[key] = torch.randn(t.shape, generator=generator) * 0.02
    return sd


def build(sd: Dict[str, torch.Tensor], cfg: WhisperConfig, device: torch.device) -> Whisper:
    """A :class:`Whisper` on ``device`` holding the HF-layout state dict ``sd``."""
    with torch.device("meta"):  # no init: every weight comes from sd
        model = Whisper(cfg)
    model = model.to_empty(device=device).eval()
    model.load_hf_state_dict(sd)
    return model


class WhisperTranscriber:
    """Batched ``wav -> text`` around :func:`greedy_decode`.

    ``tokenizer`` needs ``eos_token_id``, ``convert_tokens_to_ids`` and
    ``decode(ids, skip_special_tokens=True)``
    (:class:`~dissc_tpu_torch.models.whisper_files.WhisperDetokenizer`
    reads them from a checkpoint directory).  ``device=None`` runs on the
    CUDA card and raises without one."""

    def __init__(self, state_dict: Dict[str, torch.Tensor], cfg: WhisperConfig, tokenizer,
                 max_len: int = 224, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build(state_dict, cfg, self.device)
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.eos_id = int(tokenizer.eos_token_id)
        # forced prompt: <|startoftranscript|> <|notimestamps|> (English-only
        # models take no language or task token)
        self.initial_tokens = [int(tokenizer.convert_tokens_to_ids("<|startoftranscript|>")),
                               int(tokenizer.convert_tokens_to_ids("<|notimestamps|>"))]

    def transcribe_wav(self, wav: np.ndarray) -> str:
        return self.transcribe_batch([wav])[0]

    def transcribe_batch(self, wavs: List[np.ndarray]) -> List[str]:
        """One encoder pass and one cached greedy loop over N 30 s chunks."""
        audio = np.stack([pad_or_trim(np.asarray(w, np.float32)) for w in wavs])
        mel = log_mel_spectrogram(torch.as_tensor(audio, device=self.device),
                                  self.cfg.num_mel_bins)
        toks = greedy_decode(self.model, mel, self.initial_tokens, self.eos_id,
                             self.max_len).cpu().numpy()
        out = []
        for ids in toks:
            if (ids == self.eos_id).any():
                ids = ids[: int(np.argmax(ids == self.eos_id))]
            out.append(self.tokenizer.decode(ids.tolist(), skip_special_tokens=True))
        return out

    def __call__(self, path: str) -> str:
        wav, sr = read_wav(path, dtype="float32")
        if sr != SAMPLE_RATE:
            wav = resample_poly_np(wav, sr, SAMPLE_RATE)
        return self.transcribe_wav(wav)
