"""zamba2-2.7b — [arXiv:2411.15242; hf] [hybrid]

54 Mamba2 layers, d_model 2560, ssm_state 64, plus ONE weight-tied shared
attention+MLP block applied every 6 layers (32 heads, d_ff 10240).
Sub-quadratic → runs the long_500k shape.
"""
from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32000,
    block="hybrid",
    hybrid_attn_every=6,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, n_groups=1),
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-smoke",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=128, block="hybrid", hybrid_attn_every=2,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, n_groups=1,
                      chunk=32),
        param_dtype="float32",
    )
