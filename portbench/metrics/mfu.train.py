"""The GAN steps' model FLOPs in the window (``flops.train_step``) over the
window times the card's peak, in %."""

from portbench import flops
from portbench.readers import peak_flops, vocoder_config


def read(r):
    step = flops.train_step(vocoder_config(r), r.result["batch"])
    return 100.0 * step * r.result["steps"] / (r.window_s * peak_flops(r))
