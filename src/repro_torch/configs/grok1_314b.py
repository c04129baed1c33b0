"""grok-1-314b [moe]: 64L d_model=6144 48H GQA kv=8 d_ff=32768 vocab=131072,
MoE 8 experts top-2 every layer. [hf:xai-org/grok-1; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, d_ff=32768, vocab_size=131072,
    num_heads=48, num_kv_heads=8, head_dim=128,
    mlp="swiglu", rope_theta=10_000.0,
    num_experts=8, experts_per_token=2, moe_every=1,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok1-smoke", family="moe",
        num_layers=3, d_model=64, d_ff=128, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16,
        mlp="swiglu", num_experts=4, experts_per_token=2,
    )
