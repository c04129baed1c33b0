"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24, MHA) d_ff=6144
vocab=2048, decoder-only over EnCodec tokens (4 codebooks, sum-embedded;
delay-pattern scheduling + EnCodec itself are frontend STUBS per the
assignment). [arXiv:2306.05284; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, d_ff=6144, vocab_size=2048,
    num_heads=24, num_kv_heads=24, head_dim=64,
    mlp="swiglu", rope_theta=10_000.0, n_codebooks=4,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family="audio",
        num_layers=3, d_model=64, d_ff=128, vocab_size=128,
        num_heads=4, num_kv_heads=4, head_dim=16,
        mlp="swiglu", n_codebooks=4,
    )
