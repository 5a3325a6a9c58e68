"""A whole run of the harness on the CPU (the renderer's plain kernels, a
tiny cell), sound and with the timed path broken underneath: each fault
the cells can have turns ``correct`` false. A data-parallel render runs
on two CPU devices, each its own engine at its own RNG ordinal, and is
checked replica by replica."""

import pytest
import torch
from conftest import tiny_cell

import run
from cudabrot_tpu_torch.engines import cuda_engine
from cudabrot_tpu_torch.ops import binning
from cudabrot_tpu_torch.ops import classify as cls
from cudabrot_tpu_torch.parallel import data_parallel

SEED = 2 ** 31 + 1234567


def run_tiny(log=lambda msg: None, **kw):
    return run.run_cell(tiny_cell(**kw), SEED, 0.5, False, device="cpu",
                        log=log)


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


def test_sound_run_on_two_replicas_checks_each():
    logs = []
    out = run_tiny(log=logs.append, flags={"--devices": "2"})
    assert out["correct"], out["checks"]
    checks = out["checks"]
    assert all(c["limit"] == 0 for c in checks.values())
    assert checks["passes.unchecked"]["value"] == 0
    assert list(checks) == ["start.init", "start.bins", "start.counters",
                            "start.lanes", "mid.bins", "mid.counters",
                            "mid.lanes", "passes.unchecked", "total.hist"]
    assert any(msg.endswith("over 4 replica-passes") for msg in logs), logs


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


def added_bin_in_replica_1(core):
    def broken(self, state, pass_index, ordinal=0):
        out = core(self, state, pass_index, ordinal)
        if ordinal == 1:
            state["hist"].view(-1)[7] += 1
        return out
    return broken


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "altered_answer", "altered_bin",
                                   "replica_1_bin", "replica_1_ordinal_0"])
def test_faults_are_caught(monkeypatch, fault):
    flags = None
    if fault.startswith("replica_1"):
        flags = {"--devices": "2"}
    if fault == "replica_1_bin":
        monkeypatch.setattr(
            cuda_engine.CudaEngine, "core",
            added_bin_in_replica_1(cuda_engine.CudaEngine.core))
    elif fault == "replica_1_ordinal_0":
        # Replica 1 draws from replica 0's stream: sound passes, but not
        # the ones its ordinal promises.
        monkeypatch.setattr(data_parallel.DataParallelEngine, "ordinals",
                            lambda self: [0] * len(self.devices))
    elif fault == "unchanged_state":
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
    out = run_tiny(flags=flags)
    assert not out["correct"]
    bad = {k for k, v in out["checks"].items() if v["value"] > v["limit"]}
    assert bad
    if fault == "replica_1_ordinal_0":
        assert "start.lanes" in bad, out["checks"]
