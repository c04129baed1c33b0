"""SSM heads over "model" in the LM train step's sharded program on gloo
ranks (repro_torch's `ssm.py` on "model" blocks) against JAX.

  * Train steps, three each, from JAX's state with JAX's batches against
    JAX's jitted steps (the test process sees one device, so JAX's step is
    the unsharded program, whose values the sharded one computes) at
    tests/test_torch_lm_tensor_parallel.py's bounds: the losses at rtol
    1e-5, the whole state gathered after every step within 1e-4 of a
    leaf's scale or 3e-5 of its tree's, the leaves that QUANTA names
    within their fraction of their scale (its comment); the ranks' losses
    and norms bit-identical (the float64 steps:
    tests/test_torch_lm_ssm_parallel_grad.py):
      - rwkv6-smoke (4 heads of 16) on (2, 2) and (1, 4): a rank's time mix
        on its 2 or 1 heads (`wkv` its heads' block), the channel mix's k
        on its hidden units, reduce-scattered onto its columns and gated
        there;
      - zamba2-smoke (8 Mamba2 heads of 16) on (2, 2) and (1, 4): `in_proj`
        and the conv gathered over "model" and cut to the rank's z, x and
        dt columns with the whole B and C, the RMSNorm's mean square summed
        over "model";
      - the fallback, heads that do not divide over "model": rwkv6-smoke
        with `ssm_head_dim` 32 (2 heads) and zamba2-smoke with 64 (2 heads)
        on (1, 4): the mixers' leaves gathered whole, every head on every
        rank.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_lm_models import leaves as path_leaves
from tests.test_torch_lm_sharding import OPT, TOL_TREE_STEPS
from tests.test_torch_lm_tensor_parallel import (RUN, STEPS, U_QUANTA,
                                                  _jax_steps)
from tests.test_torch_lm_train import assert_leaves_close
from tests.test_torch_sharding_ranks import spawn_ranks

RWKV, ZAMBA = "rwkv6-7b", "zamba2-2.7b"
#: the fallback's config overrides: 2 heads on a 4-way "model" axis
RWKV_2HEADS, ZAMBA_2HEADS = (("ssm_head_dim", 32),), (("ssm_head_dim", 64),)
#: (name, arch, mesh, config overrides)
CASES = (("rwkv6-2x2", RWKV, (2, 2), ()),
         ("rwkv6-1x4", RWKV, (1, 4), ()),
         ("zamba2-2x2", ZAMBA, (2, 2), ()),
         ("zamba2-1x4", ZAMBA, (1, 4), ()),
         ("rwkv6-2heads-1x4", RWKV, (1, 4), RWKV_2HEADS),
         ("zamba2-2heads-1x4", ZAMBA, (1, 4), ZAMBA_2HEADS))
IDS = [c[0] for c in CASES]
#: the embedding table's moments
EMBED = ("/opt/m/embed/table", "/opt/v/embed/table")
#: each case's leaves held within a fraction of their scale against JAX's
#: (assert_leaves_close's `quanta`), at the largest gaps that float32
#: rounding gives both packages' steps, read against the port's float64
#: step by tests/torch_ssm_f32_readings.py (JAX's own, the sharded port's;
#: the gap to JAX's may be their sum):
#:   * RWKV6's `u` (U_QUANTA) on (2, 2) and (1, 4);
#:   * zamba2's embedding moments: 8.86e-5 and 9.64e-5 of their scale, so
#:     2e-4 (read against JAX's: 9.74e-5 on (2, 2), 1.39e-4 on (1, 4),
#:     1.10e-4 in the fallback);
#:   * the rwkv6 fallback's (2 heads of 32, every head on every rank)
#:     embedding moments at step 3: 3.56e-4 and 1.51e-3, so 2e-3 (read
#:     5.79e-4 against JAX's).  Not the split: the port's one-rank float32
#:     step lies 1.08e-3 from the float64 one there.  From JAX's state after
#:     step 2 the port's float32 step lies 3.2x further from float64 than
#:     JAX's on every leaf alike (the embedding's v 7.3e-4 against 2.3e-4,
#:     the time mix's lora_B 1.0e-3 against 3.2e-4, at the same element),
#:     3.4e-5 with the time mix in float64 and 3.0e-4 with only its
#:     projections in float64, while its loop, group norm, decay or token
#:     shift alone in float64 leave it at 1.0e-3: in this configuration
#:     step 3 amplifies the time mix's float32 rounding some 10^4 times,
#:     and which roundings each package makes sets the size of its gap
QUANTA = {"rwkv6-2x2": U_QUANTA, "rwkv6-1x4": U_QUANTA,
          "zamba2-2x2": dict.fromkeys(EMBED, 2e-4),
          "zamba2-1x4": dict.fromkeys(EMBED, 2e-4),
          "rwkv6-2heads-1x4": dict.fromkeys(EMBED, 2e-3),
          "zamba2-2heads-1x4": dict.fromkeys(EMBED, 2e-4)}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    want = {(arch, kw): _jax_steps(arch, kw)
            for arch, kw in {(a, kw) for _, a, _, kw in CASES}}
    runs = {name: (arch, dict(kw), "float32", RUN, {"data": d, "model": m},
                   want[arch, kw][0], want[arch, kw][1])
            for name, arch, (d, m), kw in CASES}
    out = spawn_ranks(4, [("mesh", "lm_mesh_steps", dict(runs=runs,
                                                         opt=OPT))],
                      tmp_path_factory.mktemp("ssm"))
    return want, out


@pytest.mark.parametrize("name,arch,mesh,kw", CASES, ids=IDS)
def test_sharded_steps_match_jax(mesh_runs, name, arch, mesh, kw):
    want, out = mesh_runs
    _, _, losses, states = want[arch, kw]
    got = [r["mesh"][name] for r in out]
    for r in got[1:]:
        assert r["losses"] == got[0]["losses"]          # bit-identical
        assert r["norms"] == got[0]["norms"]
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-5)
    for k in range(STEPS):
        assert_leaves_close(states[k], got[0]["states"][k],
                            f"{name} step {k + 1} ", quanta=QUANTA[name],
                            tol_tree=TOL_TREE_STEPS)
    for r in got[1:]:
        for (p, a), (_, b) in zip(path_leaves(got[0]["states"][-1]),
                                  path_leaves(r["states"][-1])):
            assert torch.equal(a, b), p
