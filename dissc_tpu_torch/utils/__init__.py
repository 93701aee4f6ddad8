"""Utility namespace: seeding, logging, profiling, checkpoints
(``dissc_tpu.utils``).

Stable re-export surface over the implementation modules.  The JAX
package's ``enable_compilation_cache`` (XLA's persistent cache) has no
counterpart: the port compiles only its CUDA kernels, and
``kernels/build.py`` keeps those under ``build/`` by source hash.
"""
from dissc_tpu_torch.core.seed import seed_everything
from dissc_tpu_torch.train.checkpoints import (
    load_checkpoint,
    save_checkpoint,
    scan_checkpoint,
)
from dissc_tpu_torch.train.logging import MetricLogger, init_loggers, log_metrics
from dissc_tpu_torch.utils.profiling import RTFMeter, trace_if_enabled
