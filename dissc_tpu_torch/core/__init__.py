"""Configuration, masks and sequence helpers of the port (``dissc_tpu.core``)."""
from dissc_tpu_torch.core import masking, seqops
from dissc_tpu_torch.core.config import AttrDict, load_config
