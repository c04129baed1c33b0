"""Batched LM serving driver: prefill a batch of prompts, then decode with
a KV/state cache, with continuous metrics.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --prompt-len 32 --decode-tokens 16 --batch 4 --device cpu

Port of `repro/launch/serve.py`: the same flags and output lines, plus
`--device` (default: the current CUDA device), as `serve/http.py` has.  The
per-step latency accounting shares `serve.metrics` with the embedding
server.  `serve_lm` runs the loop for any `ModelConfig` (the command line
runs the smoke configs only, as the reference's does).

The sampler is the reference's Gumbel-max draw (`jax.random.categorical`)
from an explicit `torch.Generator` seeded 42, as the reference seeds its
key; its draws cannot be JAX's.  A decode step makes one host wait: the
sampled tokens' read, inside `analysis.guards.explicit_read`, which also
ends the step's timing.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.analysis.guards import explicit_read
from repro_torch.api.estimator import resolve_device
from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data import batch_for
from repro_torch.models import build_model, make_decode_step
from repro_torch.serve.metrics import percentiles

#: the reference's sampling key, `jax.random.PRNGKey(42)`
SAMPLE_SEED = 42


def sample_tokens(logits, temperature: float, gen: torch.Generator):
    """One categorical draw a row over the last axis (Gumbel-max, as
    `jax.random.categorical` draws), int32."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() / temperature + gumbel,
                        dim=-1).to(torch.int32)


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        with explicit_read():
            torch.cuda.synchronize(device)


def serve_lm(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 32,
             decode_tokens: int = 16, temperature: float = 1.0,
             device=None, params=None, seed: int = 0) -> dict:
    """Prefill `batch` synthetic prompts of `prompt_len` tokens, then sample
    `decode_tokens` tokens a row.  `params` default to a fresh
    `init_params(seed)` on `device`.  Returns the timings (seconds), the
    sampled ids (decode_tokens, batch[, n_codebooks]) and the last
    logits."""
    device = resolve_device(device)
    model = build_model(cfg, RunConfig(remat="none"))
    if params is None:
        params, _ = model.init_params(seed, device=device)
    shape = ShapeConfig("p", "prefill", prompt_len, batch)
    inputs = batch_for(cfg, shape, device=device)
    max_len = prompt_len + decode_tokens
    decode = make_decode_step(model)

    t0 = time.perf_counter()
    logits, caches = model.prefill(params, inputs, max_len=max_len)
    _wait(device)
    t_prefill = time.perf_counter() - t0

    gen = torch.Generator(device=device).manual_seed(SAMPLE_SEED)
    tok_shape = ((batch, 1, cfg.n_codebooks) if cfg.n_codebooks
                 else (batch, 1))
    generated, step_s = [], []
    t0 = time.perf_counter()
    for _ in range(decode_tokens):
        ts = time.perf_counter()
        lg = logits.reshape(tok_shape[:1] + (-1, cfg.vocab_size))
        tok = sample_tokens(lg, temperature, gen).reshape(tok_shape)
        logits, caches = decode(params, caches, tok)
        with explicit_read():
            generated.append(tok[:, 0].cpu().numpy())
        step_s.append(time.perf_counter() - ts)
    t_decode = time.perf_counter() - t0
    return {"prefill_s": t_prefill, "decode_s": t_decode, "step_s": step_s,
            "generated": np.stack(generated), "logits": logits}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    # store_true with default True, as the reference's: the command line
    # always runs the smoke config (serve_lm takes a full config)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the current "
                         "CUDA device; 'cpu' for the CPU)")
    a = ap.parse_args(argv)

    cfg = get_smoke_config(a.arch)
    out = serve_lm(cfg, batch=a.batch, prompt_len=a.prompt_len,
                   decode_tokens=a.decode_tokens,
                   temperature=a.temperature, device=a.device)
    t_prefill, t_decode = out["prefill_s"], out["decode_s"]
    toks = a.batch * a.decode_tokens
    pct = percentiles([s * 1e3 for s in out["step_s"]], qs=(50, 99))
    print(f"arch={cfg.name} batch={a.batch} prompt={a.prompt_len}")
    print(f"prefill: {t_prefill*1e3:.1f}ms "
          f"({a.batch*a.prompt_len/t_prefill:.0f} tok/s, first call)")
    print(f"decode:  {t_decode*1e3:.1f}ms total, "
          f"{toks/t_decode:.0f} tok/s, "
          f"p50 {pct['p50']:.1f} / p99 {pct['p99']:.1f} ms/step")
    g = out["generated"]
    print(f"sampled token ids (first sequence): {g[:, 0].reshape(-1)[:16]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
