"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (kv=32, i.e. MHA) d_ff=13440
vocab=92416, qwen1.5-arch (QKV bias). [hf:Qwen/CodeQwen1.5-7B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, d_ff=13440, vocab_size=92416,
    num_heads=32, num_kv_heads=32, head_dim=128,
    mlp="swiglu", qkv_bias=True, rope_theta=1_000_000.0,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen-smoke", family="dense",
        num_layers=3, d_model=64, d_ff=160, vocab_size=512,
        num_heads=4, num_kv_heads=4, head_dim=16,
        mlp="swiglu", qkv_bias=True,
    )
