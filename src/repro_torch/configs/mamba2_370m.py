"""mamba2-370m — [arXiv:2405.21060; unverified] [ssm]

48L attention-free, d_model 1024, ssm_state 128, vocab 50280.
SSD (state-space duality); expand 2 → d_inner 2048, head_dim 64 →
32 SSD heads. Sub-quadratic → runs long_500k.
"""
from repro_torch.models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    n_layers=48,
    d_model=1024,
    n_heads=32,                 # SSD heads (d_inner / head_dim)
    n_kv_heads=32,
    d_ff=0,                     # attention-free, no FFN sublayer
    vocab=50280,
    block="mamba2",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1),
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-smoke",
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=8, d_ff=0, vocab=128,
        block="mamba2",
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, n_groups=1,
                      chunk=32),
        param_dtype="float32",
    )
