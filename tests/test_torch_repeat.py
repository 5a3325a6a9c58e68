"""chip_smoke.py's repeatability phase (phase 12) and its compute-sanitizer
sweep (--sanitize), exercised on the CPU.

On the card phase 12 records the first call of each kernel's wrapper in a
main-path pass, runs it again on guarded clones of its inputs (every
output the wrapper allocates, and margins around every tensor, filled
with a byte that changes from run to run) and holds every run to the
first bit for bit; a classify mismatch is run once more through the
kernel and the plain version, and every run is saved. Here the wrappers
run their plain versions, and the same machinery is held to faults made
on purpose: an output element left unwritten, a write past a tensor, a
lane that differs.
"""

import os

import pytest
import torch

import chip_smoke as cs
from cudabrot_tpu_torch.config import IterationBand, RenderConfig
from cudabrot_tpu_torch.ops import _build
from cudabrot_tpu_torch.ops import classify as cls

torch.set_num_threads(1)


def test_guard_fills_outputs_and_watches_margins():
    g = cs.Guard(0xA5, "cpu")
    with g.outputs():
        t = torch.empty((3, 4), dtype=torch.float32, device="cpu")
        u = torch.empty(5, dtype=torch.int64, device=torch.device("cpu"))
        v = torch.empty_like(u)
        plain = torch.empty(3)  # no device given: PyTorch's own
    assert len(g.bufs) == 3 and plain.numel() == 3
    for x in (t, u, v):
        assert bool((x.view(-1).view(torch.uint8) == 0xA5).all())
    assert t.is_contiguous() and t.shape == (3, 4)
    assert g.broken_margins() == 0
    t.as_strided((13,), (1,))[12] = 0.0  # one element past t
    assert g.broken_margins() == 1


def _doubling(fault):
    """A stand-in kernel wrapper: out = 2 x in a new torch.empty tensor,
    with the given fault."""
    def kernel(x):
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        n = x.numel() - (fault == "unwritten")
        out.view(-1)[:n] = x.view(-1)[:n] * 2
        if fault == "past the end":
            out.as_strided((x.numel() + 1,), (1,))[-1] = 1.0
        return out
    return kernel


@pytest.mark.parametrize("fault,message", [
    (None, None),
    ("unwritten", "run 1 differs from run 0 in output"),
    ("past the end", "run 0 changed the margin of 1 guarded tensors"),
])
def test_repeat_call_catches_each_fault(tmp_path, monkeypatch, fault,
                                        message):
    monkeypatch.setattr(cs, "DUMP_DIR", str(tmp_path))
    x = torch.arange(64, dtype=torch.float32)
    kernel = _doubling(fault)

    def call(g):
        return kernel(g.clone(x))

    if message is None:
        first = cs.repeat_call("double", call, 4, "cpu")
        assert torch.equal(first[0][1], 2 * x)
        return
    with pytest.raises(cs.SmokeFailure, match=message):
        cs.repeat_call("double", call, 4, "cpu",
                       inputs=cs.tree_leaves({"x": x}))
    if fault == "unwritten":
        saved = torch.load(os.path.join(tmp_path,
                                        "mismatch_double_run_1.pt"))
        assert torch.equal(saved["input"]["x"], x)
        assert saved["run 1"]["output"]["index"].tolist() == [63]


def test_capture_records_the_main_path_calls():
    """One pass of the default cell at a small geometry records classify,
    length_sort, replay_deposit and pass_counters, one on the --scatter
    pallas route replay_ids and deposit_ids, and one of the deep cell,
    whose capacity there is below its slots, threefry_bits; each recorded
    call repeats bitwise, its inputs untouched by the recording."""
    store = cs.capture_calls("cpu", (("default", "auto"),
                                     ("default", "pallas"),
                                     ("deep", "auto")), warm=1,
                             cfg_of=cs.sanitize_config)
    assert set(store) == {"classify", "threefry_bits", "replay_deposit",
                          "replay_ids", "deposit_ids", "length_sort",
                          "pass_counters"}
    for name, (fn, args, kw) in store.items():
        before = [t.clone() for _, t in cs.tree_leaves((args, kw))]

        def run(g, fn=fn, args=args, kw=kw):
            a, k = cs.tree_map(g.clone, args), cs.tree_map(g.clone, kw)
            return fn(*a, **k), a, k

        cs.repeat_call(name, run, 2, "cpu")
        after = [t for _, t in cs.tree_leaves((args, kw))]
        assert all(cs.same_bits(a, b) for a, b in zip(before, after)), name


def _small_classify(rows=2, steps=64, flush=32):
    cfg = RenderConfig(band=IterationBand(min_escape_iterations=20,
                                          max_escape_iterations=100))
    spec, tn = cs.classify_spec(cfg, steps, flush)
    args = cs.plain_classify_args(spec, tn, cfg, steps, flush)
    state = cls.init_lane_state(rows)
    cls.classify_pass(state, (1, 2), **spec)
    return state, spec, args


def test_hold_classify_saves_the_evidence(tmp_path, monkeypatch, capsys):
    """A kernel run whose lane 37 differs is caught: the kernel and the
    plain version run once more on the same input, the printout places
    the lane in classify.cu's warps (two lanes a thread: lane 37 is thread
    5 of warp 0, sub-lane 1), and the input and every run are saved."""
    monkeypatch.setattr(cs, "DUMP_DIR", str(tmp_path))
    state, spec, args = _small_classify()
    seed = (3, 4)
    ra = cls.classify_pass(cs.clone_state(state), seed, **spec)
    rb = cls.classify_pass_plain(cs.clone_state(state), *seed, None, **args)
    cs.hold_classify("same", state, seed, spec, args,
                     {"kernel": ra, "plain": rb})
    ra.state.cr.view(-1)[37] += 1.0
    with pytest.raises(cs.SmokeFailure, match="kernel and plain differ in "
                       "state.cr"):
        cs.hold_classify("bad", state, seed, spec, args,
                         {"kernel": ra, "plain": rb})
    out = capsys.readouterr().out
    assert "bad: kernel != plain" in out
    assert "bad: plain == kernel again" in out
    assert "bad: plain == plain again" in out
    if cs.package_lanes() == 2:
        assert ("lane 37 = (block 0, warp 0, thread 5, sub-lane 1, "
                "window/row 0)") in out
    saved = torch.load(os.path.join(tmp_path, "mismatch_bad.pt"))
    assert torch.equal(saved["input"]["cr"], state.cr)
    assert saved["plain"]["state.cr"]["index"].tolist() == [37]
    assert saved["kernel again"]["state.cr"]["index"].tolist() == [37]


@pytest.mark.parametrize("S", [1, 2, 4])
def test_lane_place_inverts_the_layout(S):
    """Thread t of global warp g holds lanes (g * S + j) * 32 + t."""
    lanes = 64 * 128
    for g, j, t, lead in ((0, 0, 0, 0), (5, S - 1, 31, 1), (63 // S, 0, 7,
                                                            3)):
        lane = (g * S + j) * 32 + t
        where = cs.lane_place(lead * lanes + lane, lanes, S)
        assert where == (f"lane {lane} = (block {g // 4}, warp {g}, "
                         f"thread {t}, sub-lane {j}, window/row {lead})")


SANITIZER_OUTPUT = """\
========= COMPUTE-SANITIZER
========= Invalid __global__ read of size 4 bytes
=========     at void (anonymous namespace)::classify_kernel<2, true, false, 2, 1>(cb::ClassifyArgs)+0x1a0
=========     by thread (3,0,0) in block (0,0,0)
=========
========= Error: Race reported between Write access at void classify_ext_kernel<1>(cb::ExtArgs)+0x10
=========     and Read access at void classify_ext_kernel<1>(cb::ExtArgs)+0x20 [128 hazards]
=========
========= Program hit cudaErrorLaunchFailure (error 719) on CUDA API call to cudaDeviceSynchronize.
=========     Saved host backtrace up to driver entry point at error
=========
========= ERROR SUMMARY: 3 errors
"""


def test_sanitizer_reports_are_attributed_to_kernels():
    counts, loose = cs.sanitizer_errors(SANITIZER_OUTPUT)
    assert counts["classify"] == 1 and counts["classify_ext"] == 1
    assert sum(counts.values()) == 2 and set(counts) == set(cs.KERNELS)
    assert loose == 1


def _fake_toolkit(tmp_path, sanitizer=None):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    if sanitizer is not None:
        path = bin_dir / "compute-sanitizer"
        path.write_text(sanitizer)
        path.chmod(0o755)
    return str(bin_dir / "nvcc")


def test_sanitize_fails_by_name_without_the_tool(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: _fake_toolkit(tmp_path))
    with pytest.raises(cs.SmokeFailure,
                       match="compute-sanitizer not found beside nvcc"):
        cs.phase_sanitize("cpu", "a card")


def test_sanitize_fails_where_the_card_is_refused(tmp_path, monkeypatch):
    """The sanitizer of the H100 machine prints "Device not supported" for
    every tool and runs nothing under it: --sanitize fails and says so."""
    script = ("#!/bin/sh\necho '========= Error: Device not supported. "
              "Please refer to the \"Supported Devices\" section'\nexit 1\n")
    monkeypatch.setattr(_build, "nvcc_path",
                        lambda: _fake_toolkit(tmp_path, script))
    monkeypatch.setattr(cs, "OUT", str(tmp_path / "out"))
    with pytest.raises(cs.SmokeFailure, match="--tool memcheck does not "
                       "support this device"):
        cs.phase_sanitize("cpu", "a card")
