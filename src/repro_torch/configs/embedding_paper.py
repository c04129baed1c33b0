"""The paper's own workload: spectral-direction nonlinear embedding.

COIL-20 scale (N=720, D=16384) and MNIST-20k scale (N=20000, D=784) as in
the paper's experiments, exposed with the same registry machinery as the LM
architectures so `--arch embedding-mnist20k` dry-runs the distributed
embedding step on the production mesh.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    name: str
    n_points: int
    input_dim: int
    embed_dim: int = 2
    kind: str = "ee"
    lam: float = 100.0
    perplexity: float = 20.0


COIL20 = EmbeddingConfig(
    name="embedding-coil20", n_points=720, input_dim=16384, perplexity=20.0
)
MNIST20K = EmbeddingConfig(
    name="embedding-mnist20k", n_points=20_000, input_dim=784, perplexity=50.0
)
# scaled-up cell for the production mesh (N such that the 2-D-sharded
# pairwise state is ~128 MB/device on 512 chips)
LARGE = EmbeddingConfig(
    name="embedding-large", n_points=131_072, input_dim=1024, perplexity=50.0
)

CONFIG = MNIST20K


def smoke_config() -> EmbeddingConfig:
    return EmbeddingConfig(
        name="embedding-smoke", n_points=64, input_dim=16, perplexity=8.0
    )
