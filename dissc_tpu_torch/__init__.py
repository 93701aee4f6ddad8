"""PyTorch/CUDA port of ``dissc_tpu`` for NVIDIA Hopper (H100).

The package mirrors ``dissc_tpu``'s layout (``core/``, ``audio/``,
``kernels/``, ``models/``, ``losses/``, ``train/``, ``infer/``,
``compat/``) so each module's counterpart is found by path.  It imports
``torch`` and ``numpy`` only: nothing of JAX and nothing of ``dissc_tpu``.

Entry points run on the CUDA card by default and raise when there is
none; they run on the CPU only when the caller passes ``device="cpu"``
(see :mod:`dissc_tpu_torch.device`).  The one hand-written kernel so far
is the fused log-mel (:mod:`dissc_tpu_torch.kernels.mel_kernel`, source in
``csrc/mel_kernel.cu``).
"""
