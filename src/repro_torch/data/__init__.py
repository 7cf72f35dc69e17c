"""``repro_torch.data`` — the token pipeline, the port of ``repro.data``."""
from .pipeline import (HostDataLoader, SyntheticLMDataset, deterministic_shard,
                       make_lm_batches)

__all__ = ["SyntheticLMDataset", "HostDataLoader", "make_lm_batches",
           "deterministic_shard"]
