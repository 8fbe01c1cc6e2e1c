"""Fault-tolerant checkpoints of the training port, written through
MIDAS-scheduled writer lanes (``repro/ckpt``)."""

from repro_torch.ckpt.checkpoint import (  # noqa: F401
    CheckpointManager,
    load_params,
)
from repro_torch.ckpt.midas_writer import WriterPool  # noqa: F401
