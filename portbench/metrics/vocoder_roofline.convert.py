"""The generator's FLOPs at true lengths over the device's busy time inside
the vocoder spans times the card's peak, in %: the same work whatever
kernels implement it."""

from portbench.readers import busy_within, conversion_flops, peak_flops


def read(r):
    busy = busy_within(r, "vocode")
    if busy <= 0:
        return None
    return 100.0 * conversion_flops(r, encoder=False)[1] / (busy * peak_flops(r))
