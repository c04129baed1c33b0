"""rwkv6-7b (Finch) [ssm]: 32L d_model=4096 attn-free d_ff=14336 vocab=65536,
data-dependent decay time-mix + channel-mix. head size 64 -> 64 heads.
[arXiv:2404.05892; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, d_ff=14336, vocab_size=65536,
    num_heads=0, num_kv_heads=0, head_dim=0,
    ssm_head_dim=64, mlp="rwkv_channel_mix",
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family="ssm",
        num_layers=3, d_model=64, d_ff=128, vocab_size=256,
        ssm_head_dim=16, mlp="rwkv_channel_mix",
    )
