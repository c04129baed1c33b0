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
    PRNG key, and draw on its device (or `_MetaKey`: shapes only).
  * under the sharded step's tensor-parallel context (`hooks`), a weight
    that is split over "model" is this rank's block, marked with its split
    dim (`hooks.model_split`): `_proj` is column-parallel on a split
    output dim and row-parallel (an all-reduce over "model") on a split
    input dim, attention runs on this rank's heads where the splits hold
    whole heads, the embedding looks up its vocab block and the logits stay
    split over the vocab (`model.py`'s loss is vocab-parallel).  Unmarked
    weights compute as without a context.  A decode step's KV cache block
    is on this rank's kv heads or its slice of the slots (sequence-parallel
    decode attention, `decode_attention`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import mark

from . import hooks

Params = dict
Axes = dict


def cdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


class _MetaKey:
    """The key of a shapes-only init (`models.train.params_specs`): a
    `torch.Generator` has no `meta` device, so `_randn` makes empty `meta`
    tensors from this one and never draws."""

    device = torch.device("meta")


def _randn(key, shape) -> torch.Tensor:
    """A standard normal draw of `shape` from `key` on its device."""
    if isinstance(key, _MetaKey):
        return torch.empty(shape, device=key.device)
    return torch.randn(shape, generator=key, device=key.device)


def _dense_init(key: torch.Generator, shape, dtype, in_axis=0):
    fan_in = shape[in_axis]
    return (_randn(key, shape) / math.sqrt(fan_in)).to(dtype)


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
    """x @ w (+ b).  On a "model" block of w: column-parallel (split output
    dim; `x` has passed `_model_input`, the result is marked split) or
    row-parallel (split input dim; `x` is split alike, the partial products
    are all-reduced over "model")."""
    split = hooks.model_split(w)
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    if split == 0:
        if b is not None:
            raise ValueError("a row-parallel projection takes no bias")
        return hooks.tensor_parallel().reduce_from_model(y)
    return mark(y, -1) if split == 1 else y


def _model_input(x, *ws):
    """`x` as the input of column-parallel projections (Megatron's f: the
    identity, whose backward sums the ranks' partial gradients over
    "model") when one of `ws` is split on its output dim; else `x`."""
    if any(hooks.model_split(w) == 1 for w in ws if w is not None):
        return hooks.tensor_parallel().copy_to_model(x)
    return x


def _whole_on_model(w, partial: bool = True):
    """`w` whole on every rank (off the tensor-parallel context: as it is),
    for compute that reads it whole while each rank's output covers only
    its part (a MoE layer's router under expert parallelism, Mamba2's
    `in_proj` and conv on a rank's heads): `partial`, so its gradient is
    partial on each rank and is summed over "model": `gather`'s
    reduce-scatter where its spec splits it there, `copy_to` where it is
    whole."""
    tp = hooks.tensor_parallel()
    dim = hooks.model_split(w)
    if dim is not None:
        return tp.gather_over_model(w, dim)
    return tp.copy_to_model(w) if partial else w


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
    RoPE on kv, no causal mask).  On "model" blocks k and v come back on
    this rank's kv heads where KV divides over "model" (the cache's
    "kv_heads" layout), else whole (the model cuts its "kv_seq" slice).
    """
    B, S, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    src = x if kv_src is None else kv_src
    Skv = src.shape[1]
    if any(hooks.model_split(p[w]) is not None for w in ("wq", "wk", "wv")):
        q, k, v, q0 = _split_qkv(p, x, src, H, KV, hd)
    else:
        q = _proj(x, p["wq"], p.get("bq")).reshape(B, S, H, hd)
        k = _proj(src, p["wk"], p.get("bk")).reshape(B, Skv, KV, hd)
        v = _proj(src, p["wv"], p.get("bv")).reshape(B, Skv, KV, hd)
        q0 = None
    q = hooks.constrain(q, "qkv")
    k = hooks.constrain(k, "qkv")
    v = hooks.constrain(v, "qkv")
    heads_local = hooks.model_split(q) is not None

    cross = kv_src is not None
    if not cross:
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    kq, vq = (k, v) if q0 is None else _kv_for_heads(k, v, q0, q.shape[2],
                                                      H // KV)
    if cross:
        mask = torch.ones((1, 1, 1, S, Skv), dtype=torch.bool,
                          device=x.device)
        out = _gqa_scores_to_out(q, kq, vq, mask, cdt(cfg))
    elif q_chunk and S % q_chunk == 0 and S > q_chunk:
        out = _chunked_causal(q, kq, vq, positions, window, q_chunk,
                              cdt(cfg))
    else:
        out = _gqa_scores_to_out(
            q, kq, vq, _causal_mask(positions, positions, window), cdt(cfg))

    out = out.reshape(B, S, q.shape[2] * hd)
    if hooks.model_split(p["wo"]) == 0 and not heads_local:
        # every head on every rank, a row-parallel output projection
        out = hooks.tensor_parallel().scatter_to_model(out, -1)
    y = _proj(out, p["wo"])
    return y, {"k": k, "v": v}


def _split_qkv(p, x, src, H, KV, hd):
    """q, k and v on a "model" mesh, in the reference's "qkv" layouts.
    When wq, wk and wv are all column-parallel: q on this rank's heads when
    H divides over "model", k and v when KV does too (a local q head's kv
    group is then local); what stays whole is gathered over "model" from
    the column blocks.  Otherwise the split weights are gathered over
    "model" and every rank computes q, k and v whole.  Returns (q, k, v,
    q0): q0 the first local q head where q is local and k, v whole, else
    None."""
    tp = hooks.tensor_parallel()
    m = tp.model.size
    B, S, Skv = x.shape[0], x.shape[1], src.shape[1]
    if not all(hooks.model_split(p[w]) == 1 for w in ("wq", "wk", "wv")):
        w = {n: (tp.gather_from_model(p[n], -1)
                 if hooks.model_split(p[n]) is not None else p[n])
             for n in ("wq", "wk", "wv", "bq", "bk", "bv") if n in p}
        return (_proj(x, w["wq"], w.get("bq")).reshape(B, S, H, hd),
                _proj(src, w["wk"], w.get("bk")).reshape(B, Skv, KV, hd),
                _proj(src, w["wv"], w.get("bv")).reshape(B, Skv, KV, hd),
                None)
    q_local, kv_local = H % m == 0, KV % m == 0
    xq = _model_input(x, p["wq"])
    xkv = xq if src is x else _model_input(src, p["wk"])
    q = _proj(xq, p["wq"], p.get("bq"))
    k = _proj(xkv, p["wk"], p.get("bk"))
    v = _proj(xkv, p["wv"], p.get("bv"))

    def whole(t):
        # read whole by split compute (this rank's q heads): the ranks'
        # gradients of it differ and are summed; by repeated compute: sliced
        return (tp.gather_over_model(t, -1) if q_local
                else tp.gather_from_model(t, -1))

    if not q_local:
        q = whole(q)
    if not kv_local:
        k, v = whole(k), whole(v)
    q = mark(q.reshape(B, S, -1, hd), 2 if q_local else None)
    k = mark(k.reshape(B, Skv, -1, hd), 2 if kv_local else None)
    v = mark(v.reshape(B, Skv, -1, hd), 2 if kv_local else None)
    q0 = tp.model.index * (H // m) if q_local and not kv_local else None
    return q, k, v, q0


def _kv_for_heads(k, v, q0: int, nq: int, g: int):
    """k and v (all KV heads) for the q heads [q0, q0 + nq), whose groups
    of g share a kv head: a slice when the local heads are whole groups,
    else one kv head a q head (groups of one): the kv heads that the local
    heads cover, each repeated g times by `expand`, narrowed to the local
    heads.  Its backward sums the g copies (a reduction, not an indexed
    add: no atomics on the card)."""
    k0, k1 = q0 // g, (q0 + nq - 1) // g + 1
    if q0 % g == 0 and nq % g == 0:
        return k[:, :, k0:k1], v[:, :, k0:k1]

    def per_head(t):
        B, T, _, hd = t.shape
        t = t[:, :, k0:k1, None].expand(B, T, k1 - k0, g, hd)
        return t.reshape(B, T, (k1 - k0) * g, hd).narrow(2, q0 - k0 * g, nq)

    return per_head(k), per_head(v)


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

    On "model" blocks (the sharded serving program, `models/model.py`) q,
    k and v come in `_split_qkv`'s layouts and the output goes through the
    row-parallel wo, as in `attention`; the cache is this rank's block, its
    layout marked on cache["k"] (`hooks.model_split`): 2, this rank's kv
    heads ("kv_heads"; q is on the heads they serve); 1, this rank's slice
    of the slots ("kv_seq"): q is gathered to every head, the token is
    written only where its slot lies and the softmax is combined over
    "model" (`_seq_parallel_scores_to_out`); None, every slot and head.
    `slot_pos` is whole on every rank, which masks its own window of it.
    """
    B, S1, D = x.shape
    assert S1 == 1
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pos = cache["pos"]
    if any(hooks.model_split(p[w]) is not None for w in ("wq", "wk", "wv")):
        q, k, v, q0 = _split_qkv(p, x, x, H, KV, hd)
    else:
        q = _proj(x, p["wq"], p.get("bq")).reshape(B, 1, H, hd)
        k = _proj(x, p["wk"], p.get("bk")).reshape(B, 1, KV, hd)
        v = _proj(x, p["wv"], p.get("bv")).reshape(B, 1, KV, hd)
        q0 = None
    layout = hooks.model_split(cache["k"])
    if (hooks.model_split(k) == 2) != (layout == 2):
        raise ValueError(f"k of {k.shape[2]} heads against a cache block "
                         f"of {cache['k'].shape[2]} (layout {layout})")
    if layout == 1 and hooks.model_split(q) is not None:
        q, q0 = hooks.tensor_parallel().gather_from_model(q, 2), None
    heads_local = hooks.model_split(q) is not None
    cos, sin = rope_angles(pos[None], hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    Smax = cache["slot_pos"].shape[0]
    slot = pos % Smax if window else pos
    idx = slot.clamp(0, Smax - 1).long().reshape(1)
    slot_pos = cache["slot_pos"].index_copy(0, idx, pos.reshape(1))
    if layout == 1:
        # this rank's slots [start, start + n): the token lands where its
        # (clamped) slot lies, on one rank; elsewhere the block is copied
        n = cache["k"].shape[1]
        start = hooks.tensor_parallel().model.index * n
        here = (torch.arange(start, start + n, device=x.device)
                == idx)[:, None, None]
        ck = torch.where(here, k.to(cache["k"].dtype), cache["k"])
        cv = torch.where(here, v.to(cache["v"].dtype), cache["v"])
        tj = slot_pos[None, start:start + n]
    else:
        ck = cache["k"].index_copy(1, idx, k.to(cache["k"].dtype))
        cv = cache["v"].index_copy(1, idx, v.to(cache["v"].dtype))
        tj = slot_pos[None, :]                   # (1, Smax) absolute positions
    valid = (tj >= 0) & (tj <= pos)
    if window:
        valid = valid & (tj > pos - window)
    mask = valid[None, None, :, :]
    if layout == 1:
        out = _seq_parallel_scores_to_out(q, ck, cv, mask, cdt(cfg))
    else:
        kq, vq = (ck, cv) if q0 is None else _kv_for_heads(
            ck, cv, q0, q.shape[2], H // KV)
        out = _gqa_scores_to_out(q, kq, vq, mask, cdt(cfg))
    out = out.reshape(B, 1, q.shape[2] * hd)
    if hooks.model_split(p["wo"]) == 0 and not heads_local:
        out = hooks.tensor_parallel().scatter_to_model(out, -1)
    y = _proj(out, p["wo"])
    return y, {"k": ck, "v": cv, "pos": pos + 1, "slot_pos": slot_pos}


def _seq_parallel_scores_to_out(q, k, v, mask, compute_dtype):
    """`_gqa_scores_to_out` over slots split over "model": q (B,S,H,hd) on
    every head, k/v (B,T,KV,hd) and the mask this rank's slots.  Each rank
    scores its slots; the max is taken over "model", each rank's exps of
    its scores less that max and its partial sum of p v are summed over
    "model" (one all-reduce, in float32), and the sum is divided once.  No
    rank normalises alone: a rank whose slots are all masked adds zeros.
    The sums run in another order than the whole softmax's, and p v is not
    rounded to the compute dtype before its sum (the whole one rounds the
    probabilities)."""
    tp = hooks.tensor_parallel()
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                          k.to(qg.dtype).float()) / math.sqrt(hd)
    scores = scores.masked_fill(~mask, -1e30)
    mx = tp.max_over_model(scores.amax(dim=-1, keepdim=True))
    probs = torch.exp(scores - mx)
    num = torch.einsum("bkgst,btkh->bskgh", probs,
                       v.to(compute_dtype).float())
    den = probs.sum(dim=-1).permute(0, 3, 1, 2)[..., None]
    both = tp.reduce_from_model(torch.cat([num, den], dim=-1))
    out = both[..., :hd] / both[..., hd:]
    return out.to(compute_dtype).reshape(B, S, H, hd)


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
    """Column-parallel in, row-parallel out on "model" blocks."""
    if cfg.mlp == "swiglu":
        x = _model_input(x, p["wi_gate"], p["wi_up"])
        g = F.silu(_proj(x, p["wi_gate"]))
        u = _proj(x, p["wi_up"])
        return _proj(g * u, p["wo"])
    # squared ReLU (nemotron-4)
    h = torch.relu(_proj(_model_input(x, p["wi"]), p["wi"]))
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
    table = _randn(key, shape).to(dt) * 0.02
    return {"table": table}, {"table": ax}


def embed_tokens(p, cfg: ModelConfig, tokens):
    """Gather embedding. tokens (B,S) or (B,S,n_codebooks) with stacked
    tables (n_cb,V,D); codebook embeddings are summed (MusicGen-style).
    The rows are gathered before the cast to the compute dtype: the
    reference's bits without a cast of the whole table."""
    table = p["table"]
    dt = cdt(cfg)
    if hooks.model_split(table) is not None:
        return _embed_vocab_parallel(table, tokens, dt)
    if tokens.ndim == 3:
        ncb = tokens.shape[-1]
        return sum(table[c][tokens[..., c]].to(dt) for c in range(ncb))
    return table[tokens].to(dt)


def _vocab_block(table, tokens):
    """(this rank's vocab block size, tokens made local to it, the mask of
    the tokens it owns) for a table split over "model" on its vocab dim."""
    tp = hooks.tensor_parallel()
    vl = table.shape[-2]
    local = tokens.long() - tp.model.index * vl
    return vl, local, (local >= 0) & (local < vl)


def _embed_vocab_parallel(table, tokens, dt):
    """The vocab-parallel lookup: a rank gathers the rows of the tokens in
    its vocab block, zeroes the rest and sums over "model" (exactly: one
    rank holds each row), codebook tables summed after, in the whole
    lookup's order."""
    vl, local, own = _vocab_block(table, tokens)
    idx = local.clamp(0, vl - 1)
    if tokens.ndim == 3:
        rows = torch.stack([table[c][idx[..., c]]
                            for c in range(tokens.shape[-1])], dim=2)
    else:
        rows = table[idx]
    rows = torch.where(own[..., None], rows.to(dt), 0)
    rows = hooks.tensor_parallel().reduce_from_model(rows)
    if tokens.ndim == 3:
        return sum(rows[:, :, c] for c in range(tokens.shape[-1]))
    return rows


def embed_tokens_onehot(p, cfg: ModelConfig, tokens):
    """One-hot einsum embedding (shards over the vocab axis on a mesh)."""
    split = hooks.model_split(p["table"]) is not None
    table = p["table"].to(cdt(cfg))
    if split:   # this rank's vocab block: a partial sum over "model"
        vl, local, _ = _vocab_block(table, tokens)
        oh = _one_hot(local, vl, table.dtype)
    else:
        oh = _one_hot(tokens, cfg.vocab_size, table.dtype)
    if tokens.ndim == 3:  # (B,S,ncb) with stacked tables (ncb,V,D)
        y = torch.einsum("bscv,cvd->bsd", oh, table)
    else:
        y = torch.einsum("bsv,vd->bsd", oh, table)
    return hooks.tensor_parallel().reduce_from_model(y) if split else y


def init_lm_head(key, cfg: ModelConfig, n_heads: int = 1):
    dt = pdt(cfg)
    shape = (cfg.d_model, cfg.vocab_size)
    ax = ("embed", "vocab")
    if n_heads > 1:
        shape = (n_heads,) + shape
        ax = ("codebooks",) + ax
    return ({"w": _dense_init(key, shape, dt)}, {"w": ax})


def lm_logits(p, cfg: ModelConfig, x):
    """On a vocab block of the head the logits stay split over the vocab
    (marked): `model.py`'s loss is vocab-parallel."""
    split = hooks.model_split(p["w"]) is not None
    w = p["w"].to(cdt(cfg))
    if split:
        x = hooks.tensor_parallel().copy_to_model(x)
    if w.ndim == 3:
        y = torch.einsum("bsd,cdv->bscv", x, w)
    else:
        y = x @ w
    return mark(y, -1) if split else y
