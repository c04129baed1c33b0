"""Model/config dataclasses for the architecture zoo (assignment block).

The port's own copy of `repro/configs/base.py` (pure Python), field for
field with the same defaults; `tests/test_torch_lm_configs.py` holds every
config equal to the reference's.

Every assigned architecture gets one file with an exact `CONFIG` from public
literature plus a `smoke_config()` (reduced same-family config for CPU
tests).  Knobs that matter for the dry-run/perf loop (remat, microbatching,
activation sharding, attention chunking) live in `RunConfig` so the
hillclimb can sweep them without touching model definitions.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | vlm | audio | ssm | hybrid | moe
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    num_heads: int = 0          # 0 => attention-free
    num_kv_heads: int = 0
    head_dim: int = 0
    mlp: str = "swiglu"         # swiglu | squared_relu
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # vlm (cross-attention layers; vision frontend is a STUB per assignment)
    cross_attn_every: int = 0   # a cross-attn layer every k layers (0 = none)
    n_image_tokens: int = 0

    # audio (EnCodec token stacks; frontend STUB)
    n_codebooks: int = 0

    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    moe_shared_expert: bool = False
    moe_every: int = 1          # MoE layer every k layers (1 = all layers)
    capacity_factor: float = 1.25

    # ssm / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    shared_attn_every: int = 0  # zamba2: one shared attn block every k layers
    attn_window: int = 0        # sliding window for attn at long context

    # dtypes
    param_dtype: str = "float32"     # master weights
    compute_dtype: str = "bfloat16"

    @property
    def attention_free(self) -> bool:
        return self.num_heads == 0

    @property
    def full_attention(self) -> bool:
        """True if the arch has quadratic attention with no sub-quadratic
        path — such archs skip the long_500k cell (DESIGN.md §4)."""
        return (not self.attention_free) and self.family not in ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution knobs — the hillclimb surface."""
    num_microbatches: int = 1
    remat: str = "full"          # none | full  (full = nothing saveable)
    scan_layers: bool = True
    attn_q_chunk: int = 0        # 0 = unchunked attention
    embed_onehot: bool = False   # one-hot einsum embedding (TP-friendly:
                                 # sharded-vocab gather lowers to full-table
                                 # all-gathers; the einsum reduce-scatters)
    act_shard_embed: bool = False  # shard activations' d_model over "model"
    use_fp32_router: bool = True
    moment_dtype: str = "float32"     # Adam m/v dtype (bfloat16 halves opt state)
    zero_grads: bool = True           # constrain grads to param sharding
                                      # (reduce-scatter instead of all-reduce)
    moe_shard_dispatch: bool = True   # shard dispatch/combine over E (or C)
    moe_decode_pool: bool = True      # decode: pool batch into one routing row
    serve_param_dtype: str = "float32"  # cast params for prefill/decode cells
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    grad_compress: bool = False   # int8 gradient compression (optim/compress)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    mode: str                    # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}
