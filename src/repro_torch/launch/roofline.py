"""Roofline terms of a counted cell, and the models' parameter counts.

Port of `repro/launch/roofline.py`.

  compute term    = FLOPs / peak FLOP/s          (a chip's count)
  memory term     = bytes / HBM bandwidth
  collective term = collective bytes / link bandwidth

The reference reads FLOPs, bytes and collective bytes from XLA's compiled
per-device HLO; the port counts them from the op stream its own step
dispatches on one rank (`launch/hlo_cost.py`'s `CostCounter`, whose `Cost`
`analyze` takes in place of a compiled object).  Both are a chip's counts,
so a chip's terms need no division by the chip count.

Hardware model: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit
(NVIDIA's data sheet, dense rates): 989 TFLOP/s bf16 on the tensor cores,
the rate the LM path's GEMMs run at; 3.35 TB/s HBM; 450 GB/s NVLink each
way (`ICI_BW` keeps the reference's name so that a reader of the rows finds
it; here it is the NVLink rate).  There is one peak, as in the reference:
float32 work outside the tensor cores peaks at 67 TFLOP/s, so for it the
compute term is a lower bound.  A card set below 700 W runs slower than
these peaks.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12      # bf16 tensor cores / chip
HBM_BW = 3.35e12         # bytes/s / chip
ICI_BW = 450e9           # bytes/s, NVLink, each way

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")


def collective_bytes(cost) -> dict[str, int]:
    """Per-collective-kind operand bytes of a counted `hlo_cost.Cost`."""
    return {k: int(cost.collective_bytes.get(k, 0)) for k in COLLECTIVE_OPS}


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    collectives: dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float       # MODEL_FLOPS / (FLOPs * chips)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def analyze(cost, n_chips: int, model_flops: float) -> Roofline:
    """Roofline terms from a chip's counted `hlo_cost.Cost` (the op stream
    one rank dispatches: every rank of the port's programs runs the same
    one)."""
    flops = cost.flops
    byt = cost.bytes
    coll = collective_bytes(cost)
    cbytes = float(sum(coll.values()))
    compute_s = flops / PEAK_FLOPS
    memory_s = byt / HBM_BW
    collective_s = cbytes / ICI_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    total_flops = flops * n_chips
    return Roofline(
        flops_per_chip=flops,
        bytes_per_chip=byt,
        collective_bytes_per_chip=cbytes,
        collectives=coll,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=model_flops,
        useful_ratio=model_flops / total_flops if total_flops else 0.0,
    )


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (train), 2 N D (prefill/decode), with N = active
    non-embedding params (MoE counts top-k + shared experts only)."""
    N = active_params(cfg)
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * N * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * N * tokens
    return 2.0 * N * shape.global_batch   # decode: one token per sequence


def total_params(cfg) -> float:
    return _params(cfg, active_only=False)


def active_params(cfg) -> float:
    return _params(cfg, active_only=True)


def _params(cfg, active_only: bool) -> float:
    D, F, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    n = 0.0
    if cfg.family in ("ssm",):
        per = 4 * D * D + 2 * 32 * 5 * D + 2 * D * cfg.ssm_head_dim
        per += D * F + F * D + D * D  # channel mix
        n += L * per
    elif cfg.family == "hybrid":
        d_inner = 2 * D
        per = D * (2 * d_inner + 2 * cfg.ssm_state +
                   d_inner // cfg.ssm_head_dim) + d_inner * D
        n += L * per
        # one shared attn block
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        n += D * H * hd + 2 * D * KV * hd + H * hd * D + 3 * D * F
    else:
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        if cfg.mlp == "swiglu":
            ffn = 3 * D * F
        else:
            ffn = 2 * D * F
        if cfg.num_experts:
            n_moe = L // cfg.moe_every
            n_dense = L - n_moe
            e = cfg.experts_per_token if active_only else cfg.num_experts
            moe_ffn_params = e * 3 * D * F
            if cfg.moe_shared_expert:
                moe_ffn_params += 3 * D * F
            n += n_dense * (attn + ffn) + n_moe * (attn + moe_ffn_params)
        elif cfg.family == "vlm":
            k = cfg.cross_attn_every
            n_cross = L // k
            n += L * (attn + ffn)  # cross layers ~ same param count
            _ = n_cross
        else:
            n += L * (attn + ffn)
    return n
