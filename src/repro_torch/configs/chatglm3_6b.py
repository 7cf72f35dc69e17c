"""chatglm3-6b — [arXiv:2406.12793; hf] [dense]

28L, d_model 4096, 32 heads (GQA kv 2), d_ff 13696, vocab 65024.
2D/partial RoPE: rotary on half of each head dim (rope_fraction 0.5).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab=65024,
    rope_fraction=0.5,
    qkv_bias=True,              # chatglm uses qkv bias
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="chatglm3-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=128, rope_fraction=0.5, qkv_bias=True,
        param_dtype="float32",
    )
