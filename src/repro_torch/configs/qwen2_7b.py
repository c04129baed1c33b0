"""qwen2-7b [dense]: 28L d_model=3584 28H GQA kv=4 d_ff=18944 vocab=152064,
QKV bias. [arXiv:2407.10671; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, d_ff=18944, vocab_size=152064,
    num_heads=28, num_kv_heads=4, head_dim=128,
    mlp="swiglu", qkv_bias=True, rope_theta=1_000_000.0,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke", family="dense",
        num_layers=3, d_model=64, d_ff=192, vocab_size=512,
        num_heads=4, num_kv_heads=2, head_dim=16,
        mlp="swiglu", qkv_bias=True,
    )
