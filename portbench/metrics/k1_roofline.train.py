"""K1's bound at the training shape (``k1_bound.mel_bound_s``, FP32 SIMT
operations or HBM bytes) over its mean device time in the trace, in %."""

from portbench.k1_bound import mel_bound_s
from portbench.readers import vocoder_config

K1 = "log_mel_fft_kernel"


def read(r):
    times = [e - s for name, s, e in r.kernels if K1 in name and r.t0 <= s and e <= r.t1]
    if not times:
        return None
    h = vocoder_config(r)
    bound = mel_bound_s(r.result["batch"], h["segment_size"], h, r.peak)
    return 100.0 * bound / (sum(times) / len(times) / 1e9)
