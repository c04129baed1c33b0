"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H GQA kv=8,
expert d_ff=8192, vocab=202048, MoE 128 experts top-1 + shared expert,
dense/MoE interleaved every other layer.  Early-fusion multimodal frontend
is a STUB per the assignment.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, d_ff=8192, vocab_size=202048,
    num_heads=40, num_kv_heads=8, head_dim=128,
    mlp="swiglu", rope_theta=500_000.0,
    num_experts=128, experts_per_token=1, moe_shared_expert=True,
    moe_every=2,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-smoke", family="moe",
        num_layers=4, d_model=64, d_ff=96, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16,
        mlp="swiglu", num_experts=8, experts_per_token=1,
        moe_shared_expert=True, moe_every=2,
    )
