"""llama-3.2-vision-11b — [hf:meta-llama/Llama-3.2-11B-Vision; unverified] [vlm]

40L decoder, d_model 4096, 32 heads (GQA kv 8), d_ff 14336, vocab 128256;
every 5th layer is a cross-attention layer over vision patch embeddings.
The vision tower is a STUB per the brief: ``input_specs()`` provides
precomputed patch embeddings [B, 1600, 4096] as the cross-attn memory.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128256,
    cross_attn_every=5,
    frontend="tokens+vision",
    vision_tokens=1600,
    vision_dim=4096,
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="llama-vision-smoke",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=128, cross_attn_every=2, frontend="tokens+vision",
        vision_tokens=16, vision_dim=32, param_dtype="float32",
    )
