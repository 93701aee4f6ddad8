"""Mean host time of ``VocoderEngine.synthesize_utterances`` a call, in ms."""

from portbench.readers import span_mean_ms


def read(r):
    return span_mean_ms(r, "vocode")
