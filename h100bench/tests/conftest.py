"""The harness's tests: they run on the CPU with the renderer's plain
PyTorch kernels at tiny sizes; those marked ``cuda`` run on a card."""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
for p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_cell(band=(20, 100), width=40, height=30, flags=None):
    """A cell at a size the CPU renders in a second: 512 lanes, 256
    steps a pass."""
    from hb import cells

    bench = cells.load_benchmark()
    config = {
        "canvas": {"width": width, "height": height, "min_real": -2.0,
                   "max_real": 2.0, "min_imag": -1.5, "max_imag": 1.5},
        "flags": {"--lane-rows": "4", "--steps-per-pass": "256",
                  "--steps-per-flush": "32", "--replay-capacity": "4096",
                  **(flags or {})},
        "reference": "uniform_f32",
    }
    traffic = {"band": {"min_escape": band[0], "max_escape": band[1]},
               "flags": {}}
    return cells.Cell(name="tiny", chips=1, config=config, traffic=traffic,
                      end_to_end=bench["end_to_end"],
                      per_layer=bench["per_layer"])


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
