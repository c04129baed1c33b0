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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

from .layers import _dense_init, pdt

_LORA_R = 32  # LoRA rank for RWKV6 data-dependent modulation


def _full(key, shape, value, dtype):
    return torch.full(shape, value, dtype=dtype, device=key.device)


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


def _rwkv_decay(p, xw):
    """Data-dependent per-channel decay w in (0, 1)."""
    lora = torch.tanh(xw @ p["w_lora_A"].to(xw.dtype)) @ \
        p["w_lora_B"].to(xw.dtype)
    w0 = p["w0"].float().reshape(-1)
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


def rwkv6_time_mix(p, cfg: ModelConfig, x, state: dict):
    """x (B,S,D); state {"x_prev": (B,D), "wkv": (B,H,hd,hd) f32}.
    Returns (y, new_state).  Works for S == 1 (decode) and S > 1."""
    B, S, D = x.shape
    hd = cfg.ssm_head_dim
    H = D // hd
    xr, xk, xv, xw, xg = _rwkv_mix(p, x, _token_shift(state["x_prev"], x))
    r = (xr @ p["wr"].to(x.dtype)).reshape(B, S, H, hd).float()
    k = (xk @ p["wk"].to(x.dtype)).reshape(B, S, H, hd).float()
    v = (xv @ p["wv"].to(x.dtype)).reshape(B, S, H, hd).float()
    g = F.silu(xg @ p["wg"].to(x.dtype))
    w = _rwkv_decay(p, xw).reshape(B, S, H, hd)
    u = p["u"].float()[None, :, :, None]

    S_state = state["wkv"]
    ys = []
    for t in range(S):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], u * kv + S_state))
        S_state = w[:, t][..., None] * S_state + kv
    y = torch.stack(ys, dim=1).reshape(B, S, D).to(x.dtype)
    y = _rwkv_groupnorm(y, p["ln_scale"], H)
    y = (y * g) @ p["wo"].to(x.dtype)
    return y, {"x_prev": x[:, -1], "wkv": S_state}


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
    d = _token_shift(state["x_prev"], x) - x
    xk = x + d * p["maa_k"].to(x.dtype)
    xr = x + d * p["maa_r"].to(x.dtype)
    k = torch.relu(xk @ p["wk"].to(x.dtype))
    k = k * k
    r = torch.sigmoid(xr @ p["wr"].to(x.dtype))
    y = r * (k @ p["wv"].to(x.dtype))
    return y, {"x_prev": x[:, -1]}


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
    new_state = xp[:, -(K - 1):]
    return F.silu(out), new_state


def mamba2(p, cfg: ModelConfig, x, state: dict):
    """x (B,S,D); state {"conv": (B,K-1,conv_dim), "ssm": (B,H,hd,N) f32}."""
    B, S, D = x.shape
    d_inner = 2 * D
    hd = cfg.ssm_head_dim
    H = d_inner // hd
    N = cfg.ssm_state

    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_inner + 2 * N]
    dt_raw = zxbcdt[..., -H:]
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                   state["conv"])
    xs = xbc[..., :d_inner].reshape(B, S, H, hd)
    Bmat = xbc[..., d_inner:d_inner + N].float()    # (B,S,N)
    Cmat = xbc[..., d_inner + N:].float()           # (B,S,N)
    dt_in = dt_raw.float() + p["dt_bias"].float()
    dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in))  # softplus (B,S,H)
    A = -torch.exp(p["A_log"].float())              # (H,)
    dA = torch.exp(dt * A)                          # (B,S,H)

    xs32 = xs.float()
    h = state["ssm"]
    ys = []
    for t in range(S):
        upd = torch.einsum("bhp,bn->bhpn", dt[:, t, :, None] * xs32[:, t],
                           Bmat[:, t])
        h = dA[:, t, :, None, None] * h + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cmat[:, t]))
    y = torch.stack(ys, dim=1)                      # (B,S,H,hd)
    y = y + p["D"].float()[None, None, :, None] * xs32
    y = y.reshape(B, S, d_inner).to(x.dtype)
    # gated RMSNorm (mamba2 style)
    y = y * F.silu(z)
    y32 = y.float()
    var = (y32 * y32).mean(dim=-1, keepdim=True)
    y = (y32 * torch.rsqrt(var + 1e-5)).to(x.dtype)
    y = y * p["norm_scale"].to(x.dtype)
    y = y @ p["out_proj"].to(x.dtype)
    return y, {"conv": conv_state.to(state["conv"].dtype), "ssm": h}


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
