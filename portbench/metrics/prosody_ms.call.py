"""Mean host time of ``ProsodyConverter.convert_records`` a call, in ms."""

from portbench.readers import span_mean_ms


def read(r):
    return span_mean_ms(r, "prosody")
