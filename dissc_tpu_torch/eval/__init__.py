"""Conversion metrics (``dissc_tpu.eval``): WER/CER, pitch EMD, FFE and
duration errors, the DTW aligner and Whisper ASR.  Speaker verification
(``sv``) is not ported yet."""
from dissc_tpu_torch.eval.metrics import (
    aligned_ffe,
    calc_asr_er,
    edit_distance,
    get_yaapt,
    pitch_emd,
)
