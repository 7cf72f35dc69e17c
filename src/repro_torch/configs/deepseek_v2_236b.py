"""deepseek-v2-236b — [arXiv:2405.04434; hf] [moe]

60L, d_model 5120, 128 heads (MLA, kv_lora 512), per-expert d_ff 1536,
vocab 102400, 160 routed experts top-6 + 2 shared experts; layer 0 uses a
dense FFN (d_ff 12288) per the released config
(``first_k_dense_replace=1``). MLA: q_lora 1536, qk_nope 128, qk_rope 64,
v_head 128.
"""
from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,          # MLA decompresses to full heads
    head_dim=128,
    d_ff=12288,              # dense layer-0 FFN
    vocab=102400,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
                  sharding="ep", first_moe_layer=1, dense_d_ff=12288),
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-smoke",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=128,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                      qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                      sharding="ep", first_moe_layer=1, dense_d_ff=128),
        param_dtype="float32",
    )
