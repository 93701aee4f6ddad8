"""Public compute-op API (``dissc_tpu.ops``): the port's counterpart of every
op the JAX package exports, in one namespace.

The implementation lives next to its subsystem (``audio/``, ``core/``,
``kernels/``, ``models/``); this package is the stable import surface.
Every name is the JAX package's except the fused log-mel (K1), whose
Pallas names become the CUDA kernel's (:data:`RENAMED`).

Groups:
  signal     -- STFT / log-mel (the plain matmul-DFT chain and the fused
                CUDA kernel K1), polyphase resampling, Whisper's mel front end
  pitch      -- the YAAPT F0 tracker (single + batched)
  sequences  -- dedup / re-timing / interpolation ops over unit sequences
                (host and capacity-padded forms)
  quantize   -- k-means nearest-centroid assignment
  params     -- weight-norm folding for inference-time state dicts
"""
# signal
from dissc_tpu_torch.audio.mel import mel_filterbank, mel_spectrogram, stft_magnitude
from dissc_tpu_torch.audio.resample import resample_poly_np, trim_silence
from dissc_tpu_torch.kernels.mel_kernel import mel_spectrogram_grad, mel_spectrogram_kernel
from dissc_tpu_torch.models.whisper import log_mel_spectrogram as whisper_log_mel

# pitch
from dissc_tpu_torch.audio.yaapt import interp_unvoiced, yaapt_f0, yaapt_f0_batch

# sequences
from dissc_tpu_torch.core.seqops import (
    dedup_padded,
    dedup_seq,
    interp,
    len_carryover_correction,
    morph_seq_len,
    nearest_upsample,
    repeat_interleave_padded,
)

# quantize
from dissc_tpu_torch.models.hubert import kmeans_quantize

# params
from dissc_tpu_torch.models.layers import fold_weight_norm

# the JAX package's name -> the port's, where they differ
RENAMED = {
    "mel_spectrogram_pallas": "mel_spectrogram_kernel",
    "mel_spectrogram_pallas_grad": "mel_spectrogram_grad",
}

__all__ = [
    "mel_filterbank", "mel_spectrogram", "stft_magnitude",
    "resample_poly_np", "trim_silence", "mel_spectrogram_kernel",
    "mel_spectrogram_grad", "whisper_log_mel",
    "interp_unvoiced", "yaapt_f0", "yaapt_f0_batch",
    "dedup_padded", "dedup_seq", "interp", "len_carryover_correction",
    "morph_seq_len", "nearest_upsample", "repeat_interleave_padded",
    "kmeans_quantize", "fold_weight_norm",
]
