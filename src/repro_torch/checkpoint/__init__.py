"""Atomic, async-capable checkpoints in the JAX package's on-disk format."""
from .checkpoint import (CheckpointManager, latest_step, restore_checkpoint,
                         save_checkpoint)
