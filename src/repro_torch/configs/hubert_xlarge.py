"""hubert-xlarge — [arXiv:2106.07447; unverified] [audio]

48L encoder-only, d_model 1280, 16 heads, d_ff 5120, 504 output classes
(masked-prediction codebook). The CNN waveform frontend is a STUB per the
brief: ``input_specs()`` provides precomputed frame embeddings
[B, S, 1280]; no decode path (encoder-only → decode shapes skipped).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    causal=False,               # bidirectional encoder
    rope_fraction=0.0,          # learned/conv positional in the original;
    frontend="audio_frames",    # stubbed here — encoder sees frames directly
)


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="hubert-smoke",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=32, causal=False, rope_fraction=0.0,
        frontend="audio_frames", param_dtype="float32",
    )
