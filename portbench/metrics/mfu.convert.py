"""The conversions' model FLOPs at true lengths (rhythm, pitch, generator)
over the window times the card's peak, in %."""

from portbench.readers import conversion_flops, peak_flops


def read(r):
    return 100.0 * conversion_flops(r, encoder=False)[0] / (r.window_s * peak_flops(r))
