"""Training segments (``segment_size`` samples each) completed in the
window, over the window: every step's batch over all the time."""


def read(r):
    return r.result["segments"] / r.window_s
