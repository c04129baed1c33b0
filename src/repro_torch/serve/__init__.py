"""`repro_torch.serve`: embedding-as-a-service over fitted artifacts.

Port of `repro.serve`, the serving stack for `Embedding.transform`:

  * `EmbeddingServer`: micro-batched, deadline-aware transform server over
    one fitted or loaded `Embedding`, with power-of-two batch buckets;
  * `MicroBatcher`: the generic request-coalescing queue underneath it;
  * `repro_torch.serve.http`: a stdlib JSON-over-HTTP front-end
    (`python -m repro_torch.serve.http --artifact model.npz`);
  * `metrics`: nearest-rank percentile and latency accounting.

Request configuration is a `TransformSpec` (re-exported here); the server
requires `solver='rowwise'`, the batch-composition-invariant solve that
makes micro-batching and bucket padding response-preserving.  It runs on
CUDA unless its estimator is on the CPU (``device="cpu"``).
"""
from repro_torch.api.spec import TransformSpec

from .batching import BatchStats, MicroBatcher
from .metrics import LatencyStats, percentile, percentiles
from .server import EmbeddingServer, batch_bucket

__all__ = [
    "BatchStats",
    "EmbeddingServer",
    "LatencyStats",
    "MicroBatcher",
    "TransformSpec",
    "batch_bucket",
    "percentile",
    "percentiles",
]
