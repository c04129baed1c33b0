"""Common transformer layers: RMSNorm, RoPE, GQA attention (self/cross,
cached, windowed, q-chunked), gated & squared-ReLU MLPs, embeddings.

Port of `repro/models/layers.py`.  Conventions, as the reference's:
  * params are nested dicts of tensors; every init_* returns (params, axes)
    where `axes` mirrors params with tuples of LOGICAL axis names per dim.
  * master params are cfg.param_dtype; matmuls run in cfg.compute_dtype.
    `_proj` casts each weight to the compute dtype at every call, as the
    reference does (no cached low-precision copies: the same bits, and
    the f32 masters are the only weights held).
  * attention head projections use the FLATTENED (H * head_dim) output dim.
  * the init functions take a `torch.Generator` where the reference takes a
    PRNG key, and draw on its device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Params = dict
Axes = dict


def cdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _dense_init(key: torch.Generator, shape, dtype, in_axis=0):
    fan_in = shape[in_axis]
    return (torch.randn(shape, generator=key, device=key.device)
            / math.sqrt(fan_in)).to(dtype)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """`jax.nn.one_hot`: a comparison, so an index outside [0, n) gives an
    all-zero row (and no host check of the values)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


# -- RMSNorm ------------------------------------------------------------------

def init_rmsnorm(key, cfg: ModelConfig, dim: int | None = None):
    dim = dim or cfg.d_model
    return ({"scale": torch.ones((dim,), dtype=pdt(cfg), device=key.device)},
            {"scale": ("embed",)})


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


# -- RoPE ---------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> cos/sin of shape (..., head_dim//2)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos, sin) -> torch.Tensor:
    """x (..., S, H, D); cos/sin (S, D/2) or broadcastable."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    x1f, x2f = x1.float(), x2.float()
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s],
                     dim=-1).to(x.dtype)


# -- Attention ----------------------------------------------------------------

def init_attention(key, cfg: ModelConfig):
    H, KV, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    dt = pdt(cfg)
    p = {
        "wq": _dense_init(key, (D, H * hd), dt),
        "wk": _dense_init(key, (D, KV * hd), dt),
        "wv": _dense_init(key, (D, KV * hd), dt),
        "wo": _dense_init(key, (H * hd, D), dt),
    }
    a = {
        "wq": ("embed", "q_heads"),
        "wk": ("embed", "kv_heads"),
        "wv": ("embed", "kv_heads"),
        "wo": ("q_heads", "embed"),
    }
    if cfg.qkv_bias:
        p |= {name: torch.zeros((n,), dtype=dt, device=key.device)
              for name, n in (("bq", H * hd), ("bk", KV * hd),
                              ("bv", KV * hd))}
        a |= {"bq": ("q_heads",), "bk": ("kv_heads",), "bv": ("kv_heads",)}
    return p, a


def _proj(x, w, b=None):
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _gqa_scores_to_out(q, k, v, mask, compute_dtype):
    """q (B,S,H,hd), k/v (B,T,KV,hd), mask broadcastable (B,1,1,S,T).
    Grouped attention without materializing repeated KV.

    The reference's scores are f32 sums of the compute-dtype products
    (`preferred_element_type=float32`); a bf16 product here would round its
    output to bf16, so q and k are widened to f32 first (on the card that
    widens the KV cache every decode step)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    qg = q.reshape(B, S, KV, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                          k.to(qg.dtype).float()) / math.sqrt(hd)
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(compute_dtype),
                       v.to(compute_dtype))
    return out.reshape(B, S, H, hd)


def attention(p, cfg: ModelConfig, x, *, positions, kv_src=None,
              cache: dict | None = None, window: int = 0, q_chunk: int = 0):
    """Self/cross attention.

    Train/prefill: cache is None; returns (y, kv) with kv = dict(k, v) so the
    caller can build a decode cache.  kv_src != None => cross-attention (no
    RoPE on kv, no causal mask).
    """
    from . import hooks
    B, S, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = hooks.constrain(
        _proj(x, p["wq"], p.get("bq")).reshape(B, S, H, hd), "qkv")
    src = x if kv_src is None else kv_src
    Skv = src.shape[1]
    k = hooks.constrain(
        _proj(src, p["wk"], p.get("bk")).reshape(B, Skv, KV, hd), "qkv")
    v = hooks.constrain(
        _proj(src, p["wv"], p.get("bv")).reshape(B, Skv, KV, hd), "qkv")

    cross = kv_src is not None
    if not cross:
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if cross:
        mask = torch.ones((1, 1, 1, S, Skv), dtype=torch.bool,
                          device=x.device)
        out = _gqa_scores_to_out(q, k, v, mask, cdt(cfg))
    elif q_chunk and S % q_chunk == 0 and S > q_chunk:
        out = _chunked_causal(q, k, v, positions, window, q_chunk, cdt(cfg))
    else:
        out = _gqa_scores_to_out(
            q, k, v, _causal_mask(positions, positions, window), cdt(cfg))

    y = _proj(out.reshape(B, S, H * hd), p["wo"])
    return y, {"k": k, "v": v}


def _causal_mask(q_pos, k_pos, window: int):
    """(1, 1, 1, Sq, Sk): key j visible from query i when j <= i and, with
    a window, j > i - window."""
    ti = q_pos[:, None]
    tj = k_pos[None, :]
    mask = tj <= ti
    if window:
        mask = mask & (tj > ti - window)
    return mask[None, None, None]


def _chunked_causal(q, k, v, positions, window, q_chunk, compute_dtype):
    """Query chunking: peak memory O(q_chunk * S) per head instead of
    O(S^2); the chunks run in order, as the reference's scan does."""
    B, S, H, hd = q.shape
    outs = [_gqa_scores_to_out(q[:, i:i + q_chunk], k, v,
                               _causal_mask(positions[i:i + q_chunk],
                                            positions, window),
                               compute_dtype)
            for i in range(0, S, q_chunk)]
    return torch.cat(outs, dim=1)


def decode_attention(p, cfg: ModelConfig, x, cache: dict, *,
                     window: int = 0):
    """One-token self-attention step against a KV cache.

    cache: {"k": (B, Smax, KV, hd), "v": ..., "pos": (), "slot_pos": (Smax,)}
    — Smax is the ring size when window > 0 (slot = pos % Smax), else the
    full context.  Returns (y, new_cache); the input cache is not written.
    `pos` stays on the device: the write is an `index_copy` at a device
    index, clamped to [0, Smax - 1] as JAX's `dynamic_update_slice` clamps
    its start (a decode past Smax overwrites the last slot).
    """
    B, S1, D = x.shape
    assert S1 == 1
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pos = cache["pos"]
    q = _proj(x, p["wq"], p.get("bq")).reshape(B, 1, H, hd)
    k = _proj(x, p["wk"], p.get("bk")).reshape(B, 1, KV, hd)
    v = _proj(x, p["wv"], p.get("bv")).reshape(B, 1, KV, hd)
    cos, sin = rope_angles(pos[None], hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    Smax = cache["k"].shape[1]
    slot = pos % Smax if window else pos
    idx = slot.clamp(0, Smax - 1).long().reshape(1)
    ck = cache["k"].index_copy(1, idx, k.to(cache["k"].dtype))
    cv = cache["v"].index_copy(1, idx, v.to(cache["v"].dtype))
    slot_pos = cache["slot_pos"].index_copy(0, idx, pos.reshape(1))

    tj = slot_pos[None, :]                       # (1, Smax) absolute positions
    valid = (tj >= 0) & (tj <= pos)
    if window:
        valid = valid & (tj > pos - window)
    out = _gqa_scores_to_out(q, ck, cv, valid[None, None, :, :], cdt(cfg))
    y = _proj(out.reshape(B, 1, H * hd), p["wo"])
    return y, {"k": ck, "v": cv, "pos": pos + 1, "slot_pos": slot_pos}


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  window: int = 0, dtype=torch.bfloat16, *, device):
    size = min(max_len, window) if window else max_len
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "slot_pos": torch.full((size,), -1, dtype=torch.int32, device=device),
    }


KV_CACHE_AXES = {"k": ("batch", "kv_seq", "kv_heads", None),
                 "v": ("batch", "kv_seq", "kv_heads", None),
                 "pos": (), "slot_pos": (None,)}


# -- MLPs ---------------------------------------------------------------------

def init_mlp(key, cfg: ModelConfig):
    D, Fd = cfg.d_model, cfg.d_ff
    dt = pdt(cfg)
    if cfg.mlp == "swiglu":
        p = {
            "wi_gate": _dense_init(key, (D, Fd), dt),
            "wi_up": _dense_init(key, (D, Fd), dt),
            "wo": _dense_init(key, (Fd, D), dt),
        }
        a = {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"),
             "wo": ("mlp", "embed")}
    elif cfg.mlp == "squared_relu":
        p = {"wi": _dense_init(key, (D, Fd), dt),
             "wo": _dense_init(key, (Fd, D), dt)}
        a = {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}
    else:
        raise ValueError(f"unknown mlp {cfg.mlp!r}")
    return p, a


def mlp(p, cfg: ModelConfig, x):
    if cfg.mlp == "swiglu":
        g = F.silu(_proj(x, p["wi_gate"]))
        u = _proj(x, p["wi_up"])
        return _proj(g * u, p["wo"])
    # squared ReLU (nemotron-4)
    h = torch.relu(_proj(x, p["wi"]))
    return _proj(h * h, p["wo"])


# -- Embeddings / head ---------------------------------------------------------

def init_embedding(key, cfg: ModelConfig, n_tables: int = 1):
    dt = pdt(cfg)
    shape = (cfg.vocab_size, cfg.d_model)
    if n_tables > 1:
        shape = (n_tables,) + shape
        ax = ("codebooks", "vocab", "embed")
    else:
        ax = ("vocab", "embed")
    table = torch.randn(shape, generator=key, device=key.device).to(dt) * 0.02
    return {"table": table}, {"table": ax}


def embed_tokens(p, cfg: ModelConfig, tokens):
    """Gather embedding. tokens (B,S) or (B,S,n_codebooks) with stacked
    tables (n_cb,V,D); codebook embeddings are summed (MusicGen-style).
    The rows are gathered before the cast to the compute dtype: the
    reference's bits without a cast of the whole table."""
    table = p["table"]
    dt = cdt(cfg)
    if tokens.ndim == 3:
        ncb = tokens.shape[-1]
        return sum(table[c][tokens[..., c]].to(dt) for c in range(ncb))
    return table[tokens].to(dt)


def embed_tokens_onehot(p, cfg: ModelConfig, tokens):
    """One-hot einsum embedding (shards over the vocab axis on a mesh)."""
    table = p["table"].to(cdt(cfg))
    oh = _one_hot(tokens, cfg.vocab_size, table.dtype)
    if tokens.ndim == 3:  # (B,S,ncb) with stacked tables (ncb,V,D)
        return torch.einsum("bscv,cvd->bsd", oh, table)
    return torch.einsum("bsv,vd->bsd", oh, table)


def init_lm_head(key, cfg: ModelConfig, n_heads: int = 1):
    dt = pdt(cfg)
    shape = (cfg.d_model, cfg.vocab_size)
    ax = ("embed", "vocab")
    if n_heads > 1:
        shape = (n_heads,) + shape
        ax = ("codebooks",) + ax
    return ({"w": _dense_init(key, shape, dt)}, {"w": ax})


def lm_logits(p, cfg: ModelConfig, x):
    w = p["w"].to(cdt(cfg))
    if w.ndim == 3:
        return torch.einsum("bsd,cdv->bscv", x, w)
    return x @ w
