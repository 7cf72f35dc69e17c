"""grok-1-314b — [hf:xai-org/grok-1; unverified] [moe]

64L, d_model 6144, 48 heads (GQA kv 8), expert d_ff 32768, vocab 131072,
8 experts top-2. Expert count (8) doesn't divide the 16-way model axis →
intra-expert tensor-parallel MoE sharding ("tp").
"""
from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab=131072,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32768, sharding="tp"),
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="grok-1-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=128,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=64, sharding="tp"),
        param_dtype="float32",
    )
