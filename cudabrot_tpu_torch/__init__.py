"""cudabrot_tpu_torch — the Buddhabrot renderer on PyTorch and CUDA.

The PyTorch/CUDA port of ``cudabrot_tpu`` for NVIDIA Hopper (H100). The
render pipeline is the same — persistent-lane classification with
in-kernel Threefry refills, unbiased compaction, orbit replay into a
uint32 histogram, tone mapping, PGM output — but the two hand-written
TPU kernels become hand-written CUDA C++ kernels (``csrc/``):

  * ``csrc/classify.cu``: one thread per sampler lane, state in registers
    (counterpart of the Pallas classify kernel);
  * ``csrc/deposit.cu``: the id-stream deposit, and the fused
    replay-and-deposit kernel the main path uses (counterpart of the
    Pallas scatter kernel plus the XLA replay loop around it).

Every kernel has a plain PyTorch version beside it, which the wrappers use
for CPU tensors only; entry points run on CUDA unless the caller asks for
``device="cpu"``. This package never imports ``jax`` or ``cudabrot_tpu``.
"""

from cudabrot_tpu_torch.config import (
    Canvas,
    ConfigError,
    IterationBand,
    RenderConfig,
    SAMPLE_DOMAIN,
)
from cudabrot_tpu_torch.models.fractals import FRACTALS, FractalMap

__version__ = "0.1.0"

__all__ = [
    "Canvas",
    "ConfigError",
    "IterationBand",
    "RenderConfig",
    "SAMPLE_DOMAIN",
    "FRACTALS",
    "FractalMap",
    "__version__",
]
