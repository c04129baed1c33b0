"""Attention-free sequence mixers: RWKV6 (Finch) and Mamba2 (SSD).

Port of `repro/models/ssm.py`.  Both are O(T) in sequence length with
O(1)-state decode.

RWKV6 time-mix (data-dependent decay, arXiv:2404.05892), per head of size
hd, with state S (hd_k x hd_v):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t ( diag(u) k_t v_t^T + S_{t-1} )

Mamba2 (SSD, arXiv:2405.21060 minimal form), per head with state (P x N):

    h_t = exp(A dt_t) h_{t-1} + dt_t * (x_t outer B_t)
    y_t = h_t C_t + D x_t

The reference's `lax.scan` over time is a Python loop over the S steps here,
in float32; decode (S = 1) is one state update.  State dtypes are the
reference's: `x_prev` and `conv` bf16, `wkv` and `ssm` f32.

On a mesh (the sharded train and serving programs, `hooks`' tensor-parallel
context) a rank computes its block of the heads, as the reference's specs
split every leaf whose split dim is a set of heads ("ssm_heads", and
"ssm_proj" on head-aligned columns) over "model":

  * RWKV6's time mix runs the token-shift mix whole (x is whole on
    "model"), its r, k, v and g projections column-parallel on the rank's
    heads, the decay LoRA's output and `ln_scale` cut to the rank's
    columns after `copy_to` (their leaves are whole on "model": each rank's
    gradient of them is partial), the time loop and the group norm on the
    rank's heads (`wkv` (B, H/m, hd, hd)) and `wo` row-parallel;
  * RWKV6's channel mix computes k on the rank's "mlp" block; the partial
    k @ wv is reduce-scattered onto the rank's columns, gated by its block
    of r and all-gathered to the residual width (the bytes of one
    all-reduce);
  * Mamba2 gathers `in_proj`, `conv_w` and `conv_b` over "model" (their
    contiguous blocks cut across z | x | B | C | dt) with `gather`, whose
    reduce-scatter sums the ranks' partial gradients, and computes the
    rank's z, x and dt columns with the whole B and C (one group), the conv
    on the rank's x channels and B and C, the scan on its heads (`ssm`
    (B, H/m, hd, N)), the gated RMSNorm's mean square over all of d_inner
    by `psum` (its gradient summed too), and `out_proj` row-parallel.

`x_prev` and `conv` stay whole on "model" (`Model.cache_shardings`): a
Mamba2 step all-gathers its new conv rows of the rank's x channels to
rewrite the whole conv cache.  Where a mixer's heads do not divide over
"model", `models/model.py` gathers its leaves whole and every rank
computes every head, as off the mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import all_gather

from . import hooks
from .layers import _dense_init, _model_input, _proj, _whole_on_model, pdt

_LORA_R = 32  # LoRA rank for RWKV6 data-dependent modulation


def _full(key, shape, value, dtype):
    return torch.full(shape, value, dtype=dtype, device=key.device)


def n_heads(cfg: ModelConfig, mixer: str) -> int:
    """The heads of an RWKV6 time mix ("rwkv") or of a Mamba2 mixer
    ("mamba")."""
    width = cfg.d_model if mixer == "rwkv" else 2 * cfg.d_model
    return width // cfg.ssm_head_dim


def _on_heads(p, splits: dict) -> bool:
    """Whether this rank computes its block of the heads: True where every
    leaf named in `splits` is the "model" block its spec makes it (marked
    with the split dim `splits` gives), False where none is split (off the
    tensor-parallel context, or gathered whole: the heads do not divide
    over "model"); any other layout raises."""
    got = {k: hooks.model_split(p[k]) for k in splits}
    if all(v is None for v in got.values()):
        return False
    if got != splits:
        raise ValueError(f"SSM leaves split over 'model' as {got}: a rank "
                         f"computes its heads on {splits}")
    return True


def _own(t, dim: int, size: int):
    """This rank's block of `size` along `dim` of a tensor whole on
    "model" (a view)."""
    return t.narrow(dim, hooks.tensor_parallel().model.index * size, size)


def _stack_steps(ys: list, S: int):
    """A time loop's outputs stacked over its S steps on dim 1.  A loop
    that `hooks.time_steps` cut short (a dry-run count on `meta`) stands
    empty tensors in for the steps it skipped."""
    ys = ys + [torch.empty_like(ys[-1]) for _ in range(S - len(ys))]
    return torch.stack(ys, dim=1)


# ====================  RWKV6 (Finch)  ========================================

def init_rwkv6_time_mix(key, cfg: ModelConfig):
    D = cfg.d_model
    hd = cfg.ssm_head_dim
    H = D // hd
    dt = pdt(cfg)
    p = {
        # token-shift interpolation vectors (r, k, v, w, g) + base
        "maa_x": _full(key, (D,), 0.0, dt),
        "maa_rkvwg": _full(key, (5, D), 0.0, dt),
        "lora_A": _dense_init(key, (D, 5 * _LORA_R), dt),
        "lora_B": _full(key, (5, _LORA_R, D), 0.0, dt),
        "w0": _full(key, (H, hd), -6.0, dt),          # decay base (slow decay)
        "w_lora_A": _dense_init(key, (D, _LORA_R), dt),
        "w_lora_B": _full(key, (_LORA_R, D), 0.0, dt),
        "u": _full(key, (H, hd), 0.0, dt),            # per-channel bonus
        "wr": _dense_init(key, (D, D), dt),
        "wk": _dense_init(key, (D, D), dt),
        "wv": _dense_init(key, (D, D), dt),
        "wg": _dense_init(key, (D, D), dt),
        "wo": _dense_init(key, (D, D), dt),
        "ln_scale": _full(key, (D,), 1.0, dt),        # per-head group norm
    }
    a = {
        "maa_x": ("embed",), "maa_rkvwg": (None, "embed"),
        "lora_A": ("embed", None), "lora_B": (None, None, "embed"),
        "w0": ("ssm_heads", None),
        "w_lora_A": ("embed", None), "w_lora_B": (None, "embed"),
        "u": ("ssm_heads", None),
        "wr": ("embed", "ssm_proj"), "wk": ("embed", "ssm_proj"),
        "wv": ("embed", "ssm_proj"), "wg": ("embed", "ssm_proj"),
        "wo": ("ssm_proj", "embed"),
        "ln_scale": ("embed",),
    }
    return p, a


def _token_shift(state_prev, x):
    """The previous token of every position: the state's for the first.
    The bf16 state is widened to x's dtype, as JAX's concatenate promotes."""
    return torch.cat([state_prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _last(x):
    """The last position's rows of x (B, S, D), a copy: a view would keep
    the whole (B, S, D) alive in the caches until a prefill stacks them."""
    return x[:, -1].clone()


def _rwkv_mix(p, x, x_prev):
    """Data-dependent token-shift mixing -> (xr, xk, xv, xw, xg)."""
    d = x_prev - x
    xx = x + d * p["maa_x"].to(x.dtype)
    lo = torch.tanh(xx @ p["lora_A"].to(x.dtype))
    B, S, _ = x.shape
    lo = lo.reshape(B, S, 5, _LORA_R)
    mod = torch.einsum("bsfr,frd->fbsd", lo, p["lora_B"].to(x.dtype))
    maa = p["maa_rkvwg"].to(x.dtype)[:, None, None, :]
    return x[None] + d[None] * (maa + mod)        # (5, B, S, D)


def _rwkv_decay(p, xw, split: bool = False):
    """Data-dependent per-channel decay w in (0, 1).  `split`: on this
    rank's block of `w0`, the LoRA's whole output cut to its columns."""
    lora = torch.tanh(xw @ p["w_lora_A"].to(xw.dtype)) @ \
        p["w_lora_B"].to(xw.dtype)
    w0 = p["w0"].float().reshape(-1)
    if split:
        lora = _own(hooks.tensor_parallel().copy_to_model(lora), -1,
                    w0.shape[0])
    return torch.exp(-torch.exp(w0 + lora.float()))  # (B,S,D) f32


def _rwkv_groupnorm(y, scale, H, eps=1e-5):
    """Per-head LayerNorm on (B, S, H, hd) flattened output, with the
    population variance (`jnp.var`)."""
    B, S, D = y.shape
    yh = y.reshape(B, S, H, D // H).float()
    mu = yh.mean(dim=-1, keepdim=True)
    var = torch.var(yh, dim=-1, keepdim=True, correction=0)
    yn = (yh - mu) * torch.rsqrt(var + eps)
    return (yn.reshape(B, S, D) * scale.float()).to(y.dtype)


#: the time mix's leaves split over "model" where a rank computes its
#: heads, and their split dims
_RWKV6_HEADS = {"w0": 0, "u": 0, "wr": 1, "wk": 1, "wv": 1, "wg": 1,
                "wo": 0}


def rwkv6_time_mix(p, cfg: ModelConfig, x, state: dict):
    """x (B,S,D); state {"x_prev": (B,D), "wkv": (B,H,hd,hd) f32}.
    Returns (y, new_state).  Works for S == 1 (decode) and S > 1.  On a
    rank's heads (the module docstring) `wkv` is its (B, H/m, hd, hd)."""
    B, S, D = x.shape
    hd = cfg.ssm_head_dim
    split = _on_heads(p, _RWKV6_HEADS)
    xr, xk, xv, xw, xg = _rwkv_mix(p, x, _token_shift(state["x_prev"], x))
    if split:
        xr, xk, xv, xg = (_model_input(t, p["wr"]) for t in (xr, xk, xv, xg))
    r = _proj(xr, p["wr"]).reshape(B, S, -1, hd).float()
    k = _proj(xk, p["wk"]).reshape(B, S, -1, hd).float()
    v = _proj(xv, p["wv"]).reshape(B, S, -1, hd).float()
    g = F.silu(_proj(xg, p["wg"]))
    H = r.shape[2]                       # this rank's heads, or every head
    w = _rwkv_decay(p, xw, split).reshape(B, S, H, hd)
    u = p["u"].float()[None, :, :, None]
    scale = p["ln_scale"]
    if split:
        scale = _own(hooks.tensor_parallel().copy_to_model(scale), 0, H * hd)

    S_state = state["wkv"]
    ys = []
    for t in range(hooks.time_steps(S, x.device)):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], u * kv + S_state))
        S_state = w[:, t][..., None] * S_state + kv
    y = _stack_steps(ys, S).reshape(B, S, H * hd).to(x.dtype)
    y = _rwkv_groupnorm(y, scale, H)
    y = _proj(y * g, p["wo"])
    return y, {"x_prev": _last(x), "wkv": S_state}


def init_rwkv6_channel_mix(key, cfg: ModelConfig):
    D, Fd = cfg.d_model, cfg.d_ff
    dt = pdt(cfg)
    p = {
        "maa_k": _full(key, (D,), 0.0, dt),
        "maa_r": _full(key, (D,), 0.0, dt),
        "wk": _dense_init(key, (D, Fd), dt),
        "wv": _dense_init(key, (Fd, D), dt),
        "wr": _dense_init(key, (D, D), dt),
    }
    a = {"maa_k": ("embed",), "maa_r": ("embed",),
         "wk": ("embed", "mlp"), "wv": ("mlp", "embed"),
         "wr": ("embed", "ssm_proj")}
    return p, a


def rwkv6_channel_mix(p, cfg: ModelConfig, x, state: dict):
    """y = sigmoid(xr @ wr) * (relu(xk @ wk)^2 @ wv).  Where `wr` is this
    rank's "ssm_proj" block (its heads' columns), k runs on its "mlp" block
    of `wk` (or whole, where d_ff does not divide over "model"), k @ wv is
    reduce-scattered (sliced, where whole) onto its columns and gated by
    its block of r, and y is all-gathered over "model"."""
    d = _token_shift(state["x_prev"], x) - x
    xk = x + d * p["maa_k"].to(x.dtype)
    xr = x + d * p["maa_r"].to(x.dtype)
    k = torch.relu(_proj(_model_input(xk, p["wk"]), p["wk"]))
    k = k * k
    r = torch.sigmoid(_proj(_model_input(xr, p["wr"]), p["wr"]))
    kv = k @ p["wv"].to(x.dtype)
    if hooks.model_split(p["wr"]) != 1:
        return r * kv, {"x_prev": _last(x)}
    tp = hooks.tensor_parallel()
    kv = (tp.reduce_scatter_from_model(kv, -1)
          if hooks.model_split(p["wv"]) == 0
          else tp.scatter_to_model(kv, -1))
    return tp.gather_from_model(r * kv, -1), {"x_prev": _last(x)}


def init_rwkv6_state(cfg: ModelConfig, batch: int, *, device):
    D, hd = cfg.d_model, cfg.ssm_head_dim
    H = D // hd
    return {
        "tm": {"x_prev": torch.zeros((batch, D), dtype=torch.bfloat16,
                                     device=device),
               "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                                  device=device)},
        "cm": {"x_prev": torch.zeros((batch, D), dtype=torch.bfloat16,
                                     device=device)},
    }


RWKV6_STATE_AXES = {
    "tm": {"x_prev": ("batch", "embed_act"),
           "wkv": ("batch", "ssm_heads", None, None)},
    "cm": {"x_prev": ("batch", "embed_act")},
}


# ====================  Mamba2 (SSD)  =========================================

def init_mamba2(key, cfg: ModelConfig):
    D = cfg.d_model
    d_inner = 2 * D
    hd = cfg.ssm_head_dim
    H = d_inner // hd
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * N
    dt = pdt(cfg)
    p = {
        "in_proj": _dense_init(key, (D, 2 * d_inner + 2 * N + H), dt),
        "conv_w": _dense_init(key, (cfg.ssm_conv, conv_dim), dt),
        "conv_b": _full(key, (conv_dim,), 0.0, dt),
        "A_log": _full(key, (H,), 0.0, dt),
        "D": _full(key, (H,), 1.0, dt),
        "dt_bias": _full(key, (H,), 0.0, dt),
        "norm_scale": _full(key, (d_inner,), 1.0, dt),
        "out_proj": _dense_init(key, (d_inner, D), dt),
    }
    a = {
        "in_proj": ("embed", "ssm_proj"),
        "conv_w": (None, "ssm_proj"), "conv_b": ("ssm_proj",),
        "A_log": ("ssm_heads",), "D": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "norm_scale": ("ssm_proj",),
        "out_proj": ("ssm_proj", "embed"),
    }
    return p, a


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv over time. x (B,S,C), w (K,C).
    conv_state (B,K-1,C) carries the left context for decode/chunks."""
    K = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                 # (B, S+K-1, C)
    out = sum(
        xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(K)
    ) + b.to(x.dtype)
    new_state = xp[:, -(K - 1):].clone()       # not a view of all of xp
    return F.silu(out), new_state


#: the mixer's leaves split over "model" where a rank computes its heads,
#: and their split dims (`in_proj`, `conv_w` and `conv_b` are gathered
#: whole on "model" and cut: their blocks are not head-aligned)
_MAMBA2_HEADS = {"A_log": 0, "D": 0, "dt_bias": 0, "norm_scale": 0,
                 "out_proj": 0}


def _mamba2_heads_inputs(p, cfg: ModelConfig, x, conv):
    """On this rank's heads: (x through `copy_to`, the rank's `in_proj`
    columns z | x | B | C | dt, its `conv_w` and `conv_b` channels x | B |
    C, its channels of the whole conv cache `conv`), each in the whole
    mixer's layout at d_inner / m and H / m."""
    d_inner, N = 2 * cfg.d_model, cfg.ssm_state
    H = n_heads(cfg, "mamba")
    tp = hooks.tensor_parallel()
    m = tp.model.size
    di, hl = d_inner // m, H // m

    def channels(t):                    # x | B | C along the last dim
        return torch.cat([_own(t, -1, di), t[..., d_inner:d_inner + 2 * N]],
                         dim=-1)

    w = _whole_on_model(p["in_proj"])
    dt = w[:, 2 * d_inner + 2 * N:]
    w_in = torch.cat([_own(w[:, :d_inner], -1, di),
                      channels(w[:, d_inner:2 * d_inner + 2 * N]),
                      _own(dt, -1, hl)], dim=-1)
    return (tp.copy_to_model(x), w_in, channels(_whole_on_model(p["conv_w"])),
            channels(_whole_on_model(p["conv_b"])), channels(conv))


def mamba2(p, cfg: ModelConfig, x, state: dict, keep_state: bool = True):
    """x (B,S,D); state {"conv": (B,K-1,conv_dim), "ssm": (B,H,hd,N) f32}.
    On a rank's heads (the module docstring) `ssm` is its (B, H/m, hd, N)
    and `conv` stays whole: its new x-channel rows are all-gathered over
    "model", unless `keep_state` is False (a train step, which drops the
    states: the rank's channels are returned)."""
    B, S, D = x.shape
    d_inner = 2 * D
    hd = cfg.ssm_head_dim
    N = cfg.ssm_state
    split = _on_heads(p, _MAMBA2_HEADS)
    if split:
        x, w_in, conv_w, conv_b, conv = _mamba2_heads_inputs(p, cfg, x,
                                                             state["conv"])
    else:
        w_in, conv_w, conv_b, conv = (p["in_proj"], p["conv_w"], p["conv_b"],
                                      state["conv"])
    di = conv_w.shape[-1] - 2 * N       # this rank's x channels, or all
    H = di // hd

    zxbcdt = x @ w_in.to(x.dtype)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * N]
    dt_raw = zxbcdt[..., -H:]
    xbc, conv_state = _causal_conv(xbc, conv_w, conv_b, conv)
    xs = xbc[..., :di].reshape(B, S, H, hd)
    Bmat = xbc[..., di:di + N].float()              # (B,S,N)
    Cmat = xbc[..., di + N:].float()                # (B,S,N)
    dt_in = dt_raw.float() + p["dt_bias"].float()
    dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in))  # softplus (B,S,H)
    A = -torch.exp(p["A_log"].float())              # (H,)
    dA = torch.exp(dt * A)                          # (B,S,H)

    xs32 = xs.float()
    h = state["ssm"]
    ys = []
    for t in range(hooks.time_steps(S, x.device)):
        upd = torch.einsum("bhp,bn->bhpn", dt[:, t, :, None] * xs32[:, t],
                           Bmat[:, t])
        h = dA[:, t, :, None, None] * h + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cmat[:, t]))
    y = _stack_steps(ys, S)                         # (B,S,H,hd)
    y = y + p["D"].float()[None, None, :, None] * xs32
    y = y.reshape(B, S, di).to(x.dtype)
    # gated RMSNorm (mamba2 style), its mean square over all of d_inner
    y = y * F.silu(z)
    y32 = y.float()
    if split:
        var = hooks.tensor_parallel().psum_model(
            (y32 * y32).sum(dim=-1, keepdim=True)) / d_inner
    else:
        var = (y32 * y32).mean(dim=-1, keepdim=True)
    y = (y32 * torch.rsqrt(var + 1e-5)).to(x.dtype)
    y = y * p["norm_scale"].to(x.dtype)
    y = _proj(y, p["out_proj"])
    conv_state = conv_state.to(state["conv"].dtype)
    if split and keep_state:        # a cache, not differentiated
        conv_state = conv_state.detach()
        conv_state = torch.cat([
            all_gather(conv_state[..., :di], -1,
                       hooks.tensor_parallel().model),
            conv_state[..., di:]], dim=-1)
    return y, {"conv": conv_state, "ssm": h}


def init_mamba2_state(cfg: ModelConfig, batch: int, *, device):
    D = cfg.d_model
    d_inner = 2 * D
    hd = cfg.ssm_head_dim
    H = d_inner // hd
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * N
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=torch.bfloat16, device=device),
        "ssm": torch.zeros((batch, H, hd, N), dtype=torch.float32,
                           device=device),
    }


MAMBA2_STATE_AXES = {"conv": ("batch", None, "ssm_proj"),
                     "ssm": ("batch", "ssm_heads", None, None)}
