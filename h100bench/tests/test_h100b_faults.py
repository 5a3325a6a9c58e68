"""A whole run of the harness on the CPU (the renderer's plain kernels, a
tiny cell), sound and with the timed path broken underneath: each fault
the cells can have turns ``correct`` false."""

import pytest
import torch
from conftest import tiny_cell

import run
from cudabrot_tpu_torch.engines import cuda_engine
from cudabrot_tpu_torch.ops import binning
from cudabrot_tpu_torch.ops import classify as cls

SEED = 2 ** 31 + 1234567


def run_tiny(**kw):
    return run.run_cell(tiny_cell(**kw), SEED, 0.5, False, device="cpu",
                        log=lambda msg: None)


def test_sound_run_is_correct():
    out = run_tiny()
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"points_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


def test_sound_run_with_drops_and_long_windows_is_correct():
    out = run_tiny(band=(5, 50), flags={"--replay-capacity": "64",
                                        "--inner-unroll": "4"})
    assert out["correct"], out["checks"]
    assert out["failed"] > 0


def unchanged_state(self, state, pass_index, ordinal=0):
    return state


def half_batch(replay):
    # The kept escapes lead the batch (longest first); the rest is unused.
    def broken(hist, cr, ci, iters, **kw):
        half = int((iters >= 0).sum()) // 2
        iters = iters.clone()
        iters[half:] = -1
        return replay(hist, cr, ci, iters, **kw)
    return broken


def altered_answer(classify_pass):
    def broken(*args, **kw):
        res = classify_pass(*args, **kw)
        flat = res.emit_it.view(-1)
        first = int(torch.nonzero(flat >= 0)[0])
        flat[first] += 1
        return res
    return broken


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "altered_answer", "altered_bin"])
def test_faults_are_caught(monkeypatch, fault):
    if fault == "unchanged_state":
        monkeypatch.setattr(cuda_engine.CudaEngine, "core", unchanged_state)
    elif fault == "half_batch":
        monkeypatch.setattr(binning, "replay_deposit",
                            half_batch(binning.replay_deposit))
    elif fault == "altered_answer":
        monkeypatch.setattr(cls, "classify_pass",
                            altered_answer(cls.classify_pass))
    else:
        replay = binning.replay_deposit

        def broken(hist, *a, **kw):
            out = replay(hist, *a, **kw)
            hist[7] += 1
            return out
        monkeypatch.setattr(binning, "replay_deposit", broken)
    out = run_tiny()
    assert not out["correct"]
    assert any(v["value"] > v["limit"] for v in out["checks"].values())
