"""nemotron-4-340b [dense]: 96L d_model=18432 96H GQA kv=8 d_ff=73728
vocab=256000, squared-ReLU (non-gated) MLP. [arXiv:2402.16819; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, d_ff=73728, vocab_size=256000,
    num_heads=96, num_kv_heads=8, head_dim=192,
    mlp="squared_relu", rope_theta=10_000.0,
)

def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke", family="dense",
        num_layers=3, d_model=64, d_ff=256, vocab_size=256,
        num_heads=4, num_kv_heads=2, head_dim=16, mlp="squared_relu",
    )
