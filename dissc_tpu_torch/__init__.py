"""PyTorch/CUDA port of ``dissc_tpu`` for NVIDIA Hopper (H100).

The package mirrors ``dissc_tpu``'s layout (``core/``, ``audio/``,
``data/``, ``kernels/``, ``models/``, ``losses/``, ``train/``,
``infer/``, ``compat/``, ``parallel/``, ``ops/``, ``utils/``) so each
module's counterpart is found by path.
It imports ``torch``, ``numpy`` and ``scipy`` only: nothing of JAX and
nothing of ``dissc_tpu``.

Entry points run on the CUDA card by default and raise when there is
none; they run on the CPU only when the caller passes ``device="cpu"``
(see :mod:`dissc_tpu_torch.device`).  The one hand-written kernel so far
is the fused log-mel (:mod:`dissc_tpu_torch.kernels.mel_kernel`, source in
``csrc/mel_kernel.cu``).

:class:`ConversionPipeline` (``dissc_tpu_torch.pipeline``) serves the
whole conversion path, wav in and wav out: HuBERT units and YAAPT f0,
prosody conversion, HiFi-GAN synthesis.  ``dissc_tpu_torch.cli`` holds the
training, data-prep, serving and evaluation CLIs (``convert_eval`` scores
conversions with Whisper, DTW alignment and the pitch and length metrics
of ``dissc_tpu_torch.eval``).
"""


def __getattr__(name):
    # lazy, as in dissc_tpu: importing the package loads no model code
    if name == "ConversionPipeline":
        from dissc_tpu_torch.pipeline import ConversionPipeline

        return ConversionPipeline
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
