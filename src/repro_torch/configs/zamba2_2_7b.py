"""zamba2-2.7b [hybrid]: 54 Mamba2 layers d_model=2560, ssm_state=64, plus a
SHARED transformer block (32H GQA kv=32, d_ff=10240) applied every 6 layers
(parameters shared across applications, as in the Zamba2 design).  At long
context the shared attention uses a sliding window (DESIGN.md adaptation).
[arXiv:2411.15242; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, d_ff=10240, vocab_size=32000,
    num_heads=32, num_kv_heads=32, head_dim=80,
    mlp="swiglu", ssm_state=64, ssm_head_dim=64,
    shared_attn_every=6, attn_window=4096,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        num_layers=6, d_model=64, d_ff=128, vocab_size=256,
        num_heads=4, num_kv_heads=4, head_dim=16,
        mlp="swiglu", ssm_state=16, ssm_head_dim=16,
        shared_attn_every=3, attn_window=64,
    )
