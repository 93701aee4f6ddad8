"""Conversion metrics (``dissc_tpu.eval``): WER/CER, pitch EMD, FFE and
duration errors, the DTW aligner, Whisper ASR and speaker-verification EER."""
from dissc_tpu_torch.eval.metrics import (
    aligned_ffe,
    calc_asr_er,
    edit_distance,
    get_yaapt,
    pitch_emd,
)
from dissc_tpu_torch.eval.sv import compute_eer
