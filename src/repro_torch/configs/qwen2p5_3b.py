"""qwen2.5-3b — [hf:Qwen/Qwen2.5-3B; hf] [dense]

36L, d_model 2048, 16 heads (GQA kv 2, head_dim 128), d_ff 11008,
vocab 151936, QKV bias.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab=151936,
    qkv_bias=True,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=128, qkv_bias=True, param_dtype="float32",
    )
