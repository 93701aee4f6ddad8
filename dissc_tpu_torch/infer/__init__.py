"""Inference: the bucketed vocoder engine and streaming synthesis."""
