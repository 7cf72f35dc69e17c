"""h2o-danube-3-4b — [arXiv:2401.16818; unverified] [dense]

24L, d_model 3840, 32 heads (GQA kv 8, head_dim 120), d_ff 10240,
vocab 32000. Llama+Mistral mix with sliding-window attention
(window 4096) → sub-quadratic, runs long_500k.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab=32000,
    window=4096,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="danube-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=128, window=16, param_dtype="float32",
    )
