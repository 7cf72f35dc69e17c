"""yi-34b — [arXiv:2403.04652; hf] [dense]

60L, d_model 7168, 56 heads (GQA kv 8, head_dim 128), d_ff 20480,
vocab 64000. Llama architecture.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64000,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="yi-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=128, param_dtype="float32",
    )
