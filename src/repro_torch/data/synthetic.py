"""Deterministic synthetic data: the LM token batches and the embedding
datasets.

Port of `repro/data/synthetic.py`.  `batch_for` draws one host's shard of
a batch from a CPU `torch.Generator` seeded by (step, host), so a batch is
reproducible and restart-safe as the reference's counter-based key makes it
(the draws cannot be `jax.random`'s).  `batch_specs` gives `meta`-device
tensors where the reference gives `ShapeDtypeStruct`s.  `coil_like`,
`mnist_like` and `swiss_roll` are copies: the same numpy draws from the
same seeds, so both packages fit identical data.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.estimator import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig

#: the reference's base key, `jax.random.PRNGKey(1234)`
_BATCH_SEED = 1234


def _token_shape(cfg: ModelConfig, mode: str, B: int, S: int) -> tuple:
    if mode == "train":
        tok_shape = (B, S + 1)
    elif mode == "prefill":
        tok_shape = (B, S)
    else:
        tok_shape = (B, 1)
    if cfg.n_codebooks:
        tok_shape = tok_shape + (cfg.n_codebooks,)
    return tok_shape


def batch_for(cfg: ModelConfig, shape: ShapeConfig, step: int = 0,
              host_id: int = 0, n_hosts: int = 1,
              batch_override: int | None = None,
              seq_override: int | None = None, device=None) -> dict:
    """One host's shard of the global batch at `step`, on `device` (default:
    the current CUDA device): int32 tokens and, for vlm outside decode,
    bf16 stand-in patch embeddings (the frontend is a stub)."""
    device = resolve_device(device)
    B = batch_override or max(shape.global_batch // n_hosts, 1)
    S = seq_override or shape.seq_len
    gen = torch.Generator().manual_seed(
        (_BATCH_SEED << 40) + step * 65536 + host_id)
    out: dict = {"tokens": torch.randint(
        0, cfg.vocab_size, _token_shape(cfg, shape.mode, B, S),
        generator=gen, dtype=torch.int32).to(device)}
    if cfg.family == "vlm" and shape.mode != "decode":
        out["vision_embeds"] = (0.02 * torch.randn(
            (B, cfg.n_image_tokens, cfg.d_model), generator=gen,
            dtype=torch.bfloat16)).to(device)
    return out


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Shape-and-dtype stand-ins (no allocation): `meta`-device tensors."""
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": torch.empty(_token_shape(cfg, shape.mode, B, S),
                                 dtype=torch.int32, device="meta")}
    if cfg.family == "vlm" and shape.mode != "decode":
        out["vision_embeds"] = torch.empty(
            (B, cfg.n_image_tokens, cfg.d_model), dtype=torch.bfloat16,
            device="meta")
    return out


def coil_like(n_per: int = 72, loops: int = 10, dim: int = 256,
              seed: int = 0, noise: float = 0.02,
              separation: float = 1.2) -> np.ndarray:
    """Rotation-sequence-like data: `loops` closed 1-D manifolds in R^dim
    (the structure of COIL-20 image sequences).  `separation` keeps the
    perplexity-20 affinity graph connected with weak cross-object links,
    as with real COIL-20 images."""
    rng = np.random.default_rng(seed)
    ts = np.linspace(0, 2 * np.pi, n_per, endpoint=False)
    pts = []
    for _ in range(loops):
        center = rng.normal(size=dim) * separation
        basis = rng.normal(size=(2, dim))
        circ = np.stack([np.cos(ts), np.sin(ts)], -1) @ basis
        pts.append(circ + center + noise * rng.normal(size=(n_per, dim)))
    return np.concatenate(pts).astype(np.float32)


def mnist_like(n: int = 2000, dim: int = 784, n_classes: int = 10,
               seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Clustered data with MNIST-ish geometry: `n_classes` anisotropic
    Gaussian clusters on low-dimensional manifolds in R^dim."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n)
    centers = rng.normal(size=(n_classes, dim)) * 3.0
    sub = rng.normal(size=(n_classes, 8, dim))  # 8-dim class manifolds
    z = rng.normal(size=(n, 8))
    Y = centers[labels] + np.einsum("nk,nkd->nd", z, sub[labels]) * 0.5
    Y += 0.1 * rng.normal(size=(n, dim))
    return Y.astype(np.float32), labels


def swiss_roll(n: int = 1000, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = 1.5 * np.pi * (1 + 2 * rng.uniform(size=n))
    h = 21 * rng.uniform(size=n)
    Y = np.stack([t * np.cos(t), h, t * np.sin(t)], axis=1)
    return (Y + 0.05 * rng.normal(size=Y.shape)).astype(np.float32)
