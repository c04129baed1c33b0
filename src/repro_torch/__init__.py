"""repro_torch: the PyTorch and CUDA port of `repro` for one NVIDIA H100.

It mirrors `repro` module for module (`repro/x/y.py` has its counterpart at
`repro_torch/x/y.py`) and imports neither JAX nor `repro`.  Public fitting
surface: `repro_torch.api` (`Embedding`, `EmbedSpec`).  Entry points run on
CUDA unless the caller passes ``device="cpu"``.

Float32 stays float32: TF32 is switched off for matrix products and cuDNN,
since the affinity Gram product, the Cholesky factor and the refinement
product of the spectral direction all need full float32.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
