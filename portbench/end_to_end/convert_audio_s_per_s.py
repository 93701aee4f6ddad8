"""Seconds of converted audio returned in the window, at the waveforms'
true lengths (no bucket padding), over the window."""


def read(r):
    return r.result["audio_s"] / r.window_s
