"""Mean host time of ``ConversionPipeline.encode`` (HuBERT, k-means,
YAAPT) a call, in ms."""

from portbench.readers import span_mean_ms


def read(r):
    return span_mean_ms(r, "encode")
