"""ASR for the WER/CER metrics (``dissc_tpu.eval.asr``).

The reference loads OpenAI Whisper ``medium.en`` (``eval.py:18,156``).
:func:`load_whisper` builds ``transcribe(path) -> text`` from a local
Hugging Face checkpoint directory (``config.json``, ``model.safetensors``
or ``pytorch_model.bin``, the tokenizer files), read by the port itself
(:mod:`dissc_tpu_torch.models.whisper_files`), and runs
:class:`~dissc_tpu_torch.models.whisper.WhisperTranscriber` on the card.
The weights are never downloaded: the caller supplies the directory.  Any
``fn(path) -> text`` can also be injected straight into ``calc_errors``.
"""
from __future__ import annotations

from typing import Callable

from dissc_tpu_torch.device import DeviceLike, resolve_device

_MISSING = ("Whisper weights not found at '{}'. Download them on a connected machine and "
            "pass the local directory, or inject a custom transcribe callable into "
            "calc_errors().")


def load_whisper_native(model_path: str = "openai/whisper-medium.en", max_len: int = 224,
                        device: DeviceLike = None) -> Callable[[str], str]:
    """:class:`WhisperTranscriber` over the checkpoint directory
    ``model_path``.  ``device=None`` runs on the CUDA card and raises
    without one."""
    from dissc_tpu_torch.models.whisper import WhisperTranscriber
    from dissc_tpu_torch.models.whisper_files import (
        WhisperDetokenizer,
        load_state_dict,
        read_config,
    )

    device = resolve_device(device)  # refuse before reading gigabytes
    try:
        cfg = read_config(model_path)
        tokenizer = WhisperDetokenizer.from_dir(model_path)
        sd = load_state_dict(model_path)
    except (OSError, KeyError, ValueError) as e:
        raise RuntimeError(_MISSING.format(model_path)) from e
    return WhisperTranscriber(sd, cfg, tokenizer, max_len=max_len, device=device)


def load_whisper(model_path: str = "openai/whisper-medium.en", device: DeviceLike = None,
                 native: bool = True) -> Callable[[str], str]:
    """``transcribe(path) -> text`` from a local Whisper checkpoint.

    ``native=False`` is the JAX package's transformers ``generate`` path,
    kept there for A/B checks; the card's machine has no transformers, so
    here it raises ``NotImplementedError``."""
    if not native:
        raise NotImplementedError(
            "native=False runs transformers' generate pipeline, which the port does not "
            "import (the GPU machine has no transformers); use the native transcriber")
    return load_whisper_native(model_path, device=device)
