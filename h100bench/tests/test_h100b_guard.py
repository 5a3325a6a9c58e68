"""The import guard compares top-level module names whole."""

import pytest

from hb import guard


@pytest.mark.parametrize("mods,found", [
    (["cudabrot_tpu"], ["cudabrot_tpu"]),
    (["cudabrot_tpu.engines.pallas_engine"], ["cudabrot_tpu"]),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client", "flax.linen"], ["flax", "jaxlib"]),
    (["cudabrot_tpu_torch", "cudabrot_tpu_torch.ops.classify"], []),
    (["jaxtyping", "torch", "numpy"], []),
])
def test_forbidden_top_level_names(mods, found):
    assert guard.forbidden_loaded(mods) == found


def test_harness_modules_load_no_jax():
    import subprocess
    import sys

    from conftest import BENCH_DIR

    code = ("import sys; sys.path[:0] = [%r, %r]; import run; "
            "from reference import uniform_f32; from hb import guard; "
            "print(guard.forbidden_loaded())"
            % (str(BENCH_DIR.parent), str(BENCH_DIR)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"
