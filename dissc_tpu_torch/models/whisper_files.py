"""Read a local Hugging Face Whisper checkpoint directory without transformers.

The card's machine has no ``transformers`` and no ``safetensors``, so the
port reads the files itself:

  * ``config.json`` -> :class:`~dissc_tpu_torch.models.whisper.WhisperConfig`
    (the fields ``dissc_tpu.models.whisper.config_from_hf`` reads);
  * the weights from ``model.safetensors`` (:func:`read_safetensors`: an
    8-byte little-endian header length, a JSON header of dtype, shape and
    byte offsets, then the raw little-endian buffers) or, failing that,
    ``pytorch_model.bin`` (``torch.load(weights_only=True)``);
  * :class:`WhisperDetokenizer`: the byte-level BPE *decoder* of
    ``vocab.json`` + ``added_tokens.json`` + ``special_tokens_map.json``
    (or ``tokenizer.json``), which is what transcription needs: the ids of
    the prompt and EOS tokens, and ``decode(ids, skip_special_tokens=True)``
    as transformers' slow ``WhisperTokenizer`` decodes.  Decoding needs no
    merges.
"""
from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, Iterable, Optional, Set

import torch

from dissc_tpu_torch.models.whisper import WhisperConfig

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU.  Raises
    ``ValueError`` on a header that does not describe the file."""
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    if len(buf) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    (n,) = struct.unpack("<Q", bytes(buf[:8]))
    if 8 + n > len(buf):
        raise ValueError(f"{path}: header length {n} past the end of the file")
    header = json.loads(bytes(buf[8: 8 + n]))
    data_start = 8 + n
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has unsupported dtype {meta['dtype']}")
        begin, end = meta["data_offsets"]
        shape = [int(s) for s in meta["shape"]]
        numel = 1
        for s in shape:
            numel *= s
        if not 0 <= begin <= end <= len(buf) - data_start or \
                end - begin != numel * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{path}: {name}'s offsets {begin}..{end} do not hold "
                             f"{meta['dtype']} {shape}")
        t = torch.frombuffer(buf, dtype=dtype, count=numel, offset=data_start + begin)
        out[name] = t.reshape(shape)
    return out


def load_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """The checkpoint's state dict: ``model.safetensors`` if present, else
    ``pytorch_model.bin``."""
    st = os.path.join(model_dir, "model.safetensors")
    if os.path.isfile(st):
        return read_safetensors(st)
    pt = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.isfile(pt):
        return torch.load(pt, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"neither model.safetensors nor pytorch_model.bin in {model_dir}")


def read_config(model_dir: str) -> WhisperConfig:
    """``config.json`` -> :class:`WhisperConfig` (``config_from_hf``'s fields)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        c = json.load(f)
    return WhisperConfig(
        vocab_size=c["vocab_size"], num_mel_bins=c["num_mel_bins"], d_model=c["d_model"],
        encoder_layers=c["encoder_layers"], decoder_layers=c["decoder_layers"],
        num_heads=c["encoder_attention_heads"], ffn_dim=c["encoder_ffn_dim"],
        max_source_positions=c["max_source_positions"],
        max_target_positions=c["max_target_positions"])


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte -> printable character table (byte-level BPE)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


_TIMESTAMP = re.compile(r"<\|(\d+\.\d+)\|>")


def _content(tok) -> str:
    return tok["content"] if isinstance(tok, dict) else tok


class WhisperDetokenizer:
    """Ids -> text, as transformers' slow ``WhisperTokenizer.decode`` gives it:
    with ``skip_special_tokens`` a leading ``<|startofprev|>`` prompt is cut
    up to ``<|startoftranscript|>`` and special ids are dropped; added
    tokens are kept as their text, runs of vocabulary tokens are decoded
    from bytes (UTF-8, invalid bytes replaced), an unknown id is empty, and
    timestamp tokens ``<|x.xx|>`` are removed from the text."""

    def __init__(self, vocab: Dict[str, int], added: Dict[str, int], special: Iterable[str],
                 eos_token: str = "<|endoftext|>"):
        self.token_to_id = {**vocab, **added}
        self.vocab_of = {i: t for t, i in vocab.items()}
        self.added_of = {i: t for t, i in added.items()}
        self.special_ids: Set[int] = {self.token_to_id[t] for t in special
                                      if t in self.token_to_id}
        self.eos_token_id = self.token_to_id[eos_token]
        self.byte_of = {c: b for b, c in bytes_to_unicode().items()}

    @classmethod
    def from_dir(cls, model_dir: str) -> "WhisperDetokenizer":
        def read(name: str) -> Optional[dict]:
            path = os.path.join(model_dir, name)
            if not os.path.isfile(path):
                return None
            with open(path, encoding="utf-8") as f:
                return json.load(f)

        vocab = read("vocab.json")
        if vocab is None:  # a fast-tokenizer-only directory
            tj = read("tokenizer.json")
            if tj is None:
                raise FileNotFoundError(f"neither vocab.json nor tokenizer.json in {model_dir}")
            added = {a["content"]: a["id"] for a in tj["added_tokens"]}
            vocab = {t: i for t, i in tj["model"]["vocab"].items() if t not in added}
            special = [a["content"] for a in tj["added_tokens"] if a["special"]]
            eos = next((t for t in special if t == "<|endoftext|>"), "<|endoftext|>")
            return cls(vocab, added, special, eos)
        added = read("added_tokens.json") or {}
        smap = read("special_tokens_map.json") or read("tokenizer_config.json") or {}
        special = [_content(smap[k]) for k in ("bos_token", "eos_token", "unk_token",
                                               "pad_token") if smap.get(k)]
        special += [_content(t) for t in smap.get("additional_special_tokens", [])]
        return cls(vocab, added, special, _content(smap.get("eos_token", "<|endoftext|>")))

    def convert_tokens_to_ids(self, token: str) -> int:
        return self.token_to_id[token]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        ids = [int(i) for i in ids]
        if skip_special_tokens and ids:
            prompt = self.token_to_id.get("<|startofprev|>")
            sot = self.token_to_id.get("<|startoftranscript|>")
            if prompt is not None and ids[0] == prompt:
                ids = ids[ids.index(sot):] if sot in ids else []
        parts, run = [], []
        for i in ids:
            if skip_special_tokens and i in self.special_ids:
                continue
            if i in self.added_of:
                if run:
                    parts.append(self._bytes_text(run))
                    run = []
                parts.append(self.added_of[i])
            else:
                run.append(self.vocab_of.get(i, ""))
        if run:
            parts.append(self._bytes_text(run))
        return _TIMESTAMP.sub("", "".join(parts))

    def _bytes_text(self, tokens) -> str:
        return bytearray(self.byte_of[c] for c in "".join(tokens)).decode("utf-8", "replace")
