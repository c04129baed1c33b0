"""llama-3.2-vision-90b [vlm]: 100L (80 self + 20 cross-attn) d_model=8192
64H GQA kv=8, d_ff=28672, vocab=128256.  Vision frontend is a STUB: the
backbone consumes precomputed patch embeddings (assignment rules).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, d_ff=28672, vocab_size=128256,
    num_heads=64, num_kv_heads=8, head_dim=128,
    mlp="swiglu", rope_theta=500_000.0,
    cross_attn_every=5, n_image_tokens=1601,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-smoke", family="vlm",
        num_layers=10, d_model=64, d_ff=128, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16,
        mlp="swiglu", cross_attn_every=5, n_image_tokens=17,
    )
