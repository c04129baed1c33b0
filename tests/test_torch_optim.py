"""The port's optimizer (repro_torch.optim) against the JAX reference.

AdamW: `schedule` at step 0, inside the warm-up, at its end, mid-decay, at
the total and past it; `init`; `global_norm`; `update` over several steps,
float32 and bfloat16 moments, with and without donation.  JAX's ops run one
at a time (no jit) give the port's bits exactly: the port rounds every
product and sum as an op-by-op JAX does.  Under `jax.jit` XLA's CPU backend
contracts ``a * b + c`` into a fused multiply-add, which moves a moment by
up to a few ulps of its larger term, so the jitted update is held within 4
ulps of each leaf's largest value.  The moment-dtype quirk is the
reference's: moments made in bfloat16 come back in `AdamWConfig.moment_dtype`
(float32 by default) after the first update.

Compression: `quantize` / `dequantize` exactly, half-to-even rounding at
exact .5 multiples of the scale, and `compress_with_feedback` carried over
several microbatches, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch.optim import adamw, compress

CFG = dict(warmup_steps=3, total_steps=10)


def _tree(rng, scale=1.0, dyadic=False):
    """A params-like tree: a dict with a nested list, leaves of assorted
    shapes (flattened in sorted-key order).  `dyadic`: integers in
    [-64, 64] times `scale` / 64 (a power of two), whose squares sum
    exactly in float32 in any order, so that both packages' global norms,
    and so their clip scales, are the same bits."""
    def draw(shape, s):
        if dyadic:
            return (rng.integers(-64, 65, size=shape) * (s / 64)).astype(
                np.float32)
        return (rng.normal(size=shape) * s).astype(np.float32)

    return {"w": draw((24, 16), scale), "b": draw((16,), scale),
            "stack": [draw((3, 5, 7), scale), draw((9,), scale / 1024)]}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(tree):
    return jax.tree.map(torch.tensor, tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _leaves(tree):
    return jax.tree.leaves(tree)


@pytest.mark.parametrize("step", [0, 1, 2, 3, 4, 6, 10, 25])
def test_schedule_matches_jax(step):
    """Warm-up, its end, the cosine and past the total: JAX's float32 bits
    (the f32 device computation, not a Python double)."""
    for cfg in (CFG, dict(warmup_steps=0, total_steps=7, min_lr_frac=0.3),
                dict(lr=1.0, warmup_steps=10, total_steps=100)):
        want = jadamw.schedule(jadamw.AdamWConfig(**cfg),
                               jnp.asarray(step, jnp.int32))
        got = adamw.schedule(adamw.AdamWConfig(**cfg),
                             torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == float(want), (cfg, step, float(got), float(want))


def test_config_is_a_copy():
    import dataclasses
    assert ([(f.name, f.default) for f in dataclasses.fields(
        adamw.AdamWConfig)] == [(f.name, f.default) for f in
                                dataclasses.fields(jadamw.AdamWConfig)])


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_init_matches_jax(moment_dtype):
    P = _tree(np.random.default_rng(0))
    want = jadamw.init(_jax(P), moment_dtype)
    got = adamw.init(_port(P), moment_dtype)
    assert got["count"].dtype == torch.int32 and int(got["count"]) == 0
    for a, b in zip(_leaves(want["m"]) + _leaves(want["v"]),
                    _leaves(got["m"]) + _leaves(got["v"])):
        assert str(b.dtype).removeprefix("torch.") == a.dtype.name
        assert tuple(b.shape) == a.shape and not bool(b.any())


def test_global_norm_matches_jax():
    """The per-leaf sums of squares added in JAX's leaf order: within 1e-6
    (XLA's and PyTorch's reductions sum a leaf's squares in other orders,
    a few float32 ulps)."""
    rng = np.random.default_rng(1)
    for scale in (1e-3, 1.0, 1e3):
        G = _tree(rng, scale)
        want = np.float32(jadamw.global_norm(_jax(G)))
        got = adamw.global_norm(_port(G))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= 1e-6 * float(want), (
            float(got), float(want))


def _run_update(moment_dtype, opt_dtype, donate, jit, steps=5):
    rng = np.random.default_rng(2)
    P = _tree(rng)
    cfg = dict(CFG, moment_dtype=opt_dtype)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    jp, tp = _jax(P), _port(P)
    jo, to = jadamw.init(jp, moment_dtype), adamw.init(tp, moment_dtype)
    jupd = (jax.jit(lambda g, o, p: jadamw.update(jcfg, g, o, p)) if jit
            else lambda g, o, p: jadamw.update(jcfg, g, o, p))
    out = []
    for s in range(steps):
        # the last step's gradient is large: the clip scale is below 1
        G = _tree(rng, 0.25 if s < steps - 1 else 64.0, dyadic=True)
        jp, jo, jm = jupd(_jax(G), jo, jp)
        tp_in = tp
        tp, to, tm = adamw.update(tcfg, _port(G), to, tp, donate=donate)
        if donate:
            assert all(a is b for a, b in zip(_leaves(tp), _leaves(tp_in)))
        # donated tensors change at the next step: keep this step's values
        out.append((jp, jo, jm) + jax.tree.map(torch.clone, (tp, to, tm)))
    return out


@pytest.mark.parametrize("moment_dtype,opt_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32"), ("float32", "bfloat16")])
@pytest.mark.parametrize("donate", [False, True])
def test_update_matches_jax_op_by_op(moment_dtype, opt_dtype, donate):
    """Five updates against JAX's op-by-op `update`: params, m, v, count,
    grad_norm and lr bit for bit, whatever the moment dtypes and donation
    (dyadic gradients: the global norm is exact in both).
    The moments come back in the config's dtype (a bf16-moment state under
    a float32 config is float32 after step 1, as the reference's)."""
    for s, (jp, jo, jm, tp, to, tm) in enumerate(
            _run_update(moment_dtype, opt_dtype, donate, jit=False)):
        assert int(to["count"]) == int(jo["count"]) == s + 1
        assert to["count"].dtype == torch.int32
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == float(jm[k]), (s, k)
        for a, b in zip(_leaves(jp) + _leaves(jo["m"]) + _leaves(jo["v"]),
                        _leaves(tp) + _leaves(to["m"]) + _leaves(to["v"])):
            assert str(b.dtype).removeprefix("torch.") == a.dtype.name
            np.testing.assert_array_equal(_np(b), _np(a), err_msg=f"step {s}")
        assert to["m"]["w"].dtype == getattr(torch, opt_dtype)


def test_update_matches_jitted_jax():
    """Against the jitted update (XLA contracts multiply-adds and fuses the
    schedule): grad_norm bit for bit (dyadic gradients), lr within one
    float32 ulp, each leaf within 4 ulps of its largest value, over five
    steps."""
    for s, (jp, jo, jm, tp, to, tm) in enumerate(
            _run_update("float32", "float32", True, jit=True)):
        assert float(tm["grad_norm"]) == float(jm["grad_norm"]), s
        want = np.float32(jm["lr"])
        assert abs(float(tm["lr"]) - float(want)) <= np.spacing(want), s
        for a, b in zip(_leaves(jp) + _leaves(jo["m"]) + _leaves(jo["v"]),
                        _leaves(tp) + _leaves(to["m"]) + _leaves(to["v"])):
            a = np.asarray(a)
            err = np.abs(a.astype(np.float64) - b.double().numpy()).max()
            assert err <= 4 * np.spacing(np.abs(a).max()), (s, err)


def test_adamw_decreases_quadratic():
    """tests/test_optim.py's descent check, on the port."""
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            total_steps=100, min_lr_frac=1.0)
    params = {"x": torch.tensor([5.0, -3.0])}
    opt = adamw.init(params)
    for _ in range(60):
        g = {"x": 2 * params["x"]}
        params, opt, _ = adamw.update(cfg, g, opt, params)
    assert float((params["x"] ** 2).sum()) < 0.15


# -- int8 compression ------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(257,)) * 10.0 ** (seed - 1)).astype(np.float32)
    jq, js = jcompress.quantize(jnp.asarray(x))
    tq, ts = compress.quantize(torch.tensor(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(
        compress.dequantize(tq, ts).numpy(),
        np.asarray(jcompress.dequantize(jq, js)))


def test_quantize_rounds_half_to_even():
    """Values at exact .5 multiples of the scale round to the even
    integer, as `jnp.round` does (a power-of-two scale keeps x / scale
    exact)."""
    scale = np.float32(2.0 ** -4)
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5],
                      np.float32)
    # max |x| / 127 is the scale once 127 * scale is in the tensor
    x = np.concatenate([halves * scale, [127 * scale]]).astype(np.float32)
    tq, ts = compress.quantize(torch.tensor(x))
    jq, js = jcompress.quantize(jnp.asarray(x))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq[:8].tolist() == [0, 2, 2, 0, -2, -2, 4, 126]


def test_compress_with_feedback_over_microbatches():
    """Eight microbatches of a tree through the error feedback: the
    dequantized gradients, the carried residuals and their running sum,
    bit for bit with JAX."""
    rng = np.random.default_rng(5)
    P = _tree(rng)
    jerr = jcompress.init_feedback(_jax(P))
    terr = compress.init_feedback(_port(P))
    for a, b in zip(_leaves(jerr), _leaves(terr)):
        assert b.dtype == torch.float32 and not bool(b.any())
    jsum = tsum = None
    for _ in range(8):
        G = _tree(rng, 0.1)
        jd, jerr = jcompress.compress_with_feedback(_jax(G), jerr)
        td, terr = compress.compress_with_feedback(_port(G), terr)
        jsum = jd if jsum is None else jax.tree.map(jnp.add, jsum, jd)
        tsum = td if tsum is None else jax.tree.map(torch.add, tsum, td)
        for a, b in zip(_leaves(jd) + _leaves(jerr) + _leaves(jsum),
                        _leaves(td) + _leaves(terr) + _leaves(tsum)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
