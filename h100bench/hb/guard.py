"""The import guard: the benchmark measures the PyTorch and CUDA renderer
alone. A run whose process holds JAX or the JAX package once the window
has closed prints no result. Names are compared by their top-level part
whole, so ``cudabrot_tpu_torch`` is not ``cudabrot_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cudabrot_tpu"})


def forbidden_loaded(modules=None) -> list[str]:
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & FORBIDDEN)
