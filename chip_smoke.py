#!/usr/bin/env python3
"""Chip smoke test of cudabrot_tpu_torch on one NVIDIA GPU (H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each fails the run on any mismatch):
  1. Build the CUDA kernels from csrc/ (one nvcc per source, all in
     parallel) and print their registers, shared memory and spills (nvcc
     -Xptxas -v).
  2. classify kernel vs its plain PyTorch version, bitwise (lane state,
     emissions, stats), at full lane width from a carried state: the
     default band [20,100) and [2000,20000) (auto inner window, Brent);
     threefry_bits vs its plain version at the default band's slot count;
     classify_ext (df32) vs its plain version the same way, one pass of
     the deep-zoom cell's geometry (4096 steps: eight flush windows with
     refills, emissions and Brent saves) from a state carried 8 passes;
     classify_mh and classify_ext_mh (the Metropolis-Hastings chain
     kernels) vs their plain version on one whole main-path pass of the
     mhcrop and the mhzoom cell (4096 steps in four flush windows; 16384
     steps in one), from a state carried 4 passes.
  3. deposit_ids vs index_add_ bitwise on random ids with sentinels at
     1000x1000 and 6000x4500; replay_deposit vs its plain version bitwise
     on a compacted batch from phase 2, at the package's resident warps
     per SM and at each of 4..64 (binning.REPLAY_WARPS_PER_SM set for the
     call); replay_deposit_ext (df32) vs its
     plain version on the batch compacted from phase 2's df32 emissions;
     mh_deposit vs mh_scatter's plain version on phase 2's MH emissions,
     as a flat (V, S) batch, as they lie in the emission buffers gated by
     emit_it (the engine's call, adding into given totals) and on the tail
     flush's batch of the pass's lane state, beside index_add_ of the
     materialized (bin, weight) stream.
  4. The main paths through cudabrot_tpu_torch.cli.main at 1000x1000: the
     default band, [2000,20000), the extended-precision deep zoom
     (--precision extended, a 1e-5 window, band [500,20000)), and the two
     Metropolis-Hastings cells: mhzoom (the deep zoom with --sampler mh,
     sample domain 8x the window) and mhcrop (--sampler mh on a 6e-3
     window at float32, band [50,500)). Each: valid PGM, histogram sum
     equal to the on-canvas points, overflow drops <= 1% of in-band samples
     (none at all with MH), every kernel of the path launched, no plain
     version run. The deep-zoom window also renders through --engine
     oracle (float64, 65,536 samples a pass), and the two must agree in
     in-band fraction and orbit points per emission within 15%. The mhzoom
     window also renders by uniform sampling (--precision extended
     --emit-filter canvas over the same 8x domain); two seeds of each must
     agree as measures (block correlation, bright-half mass ratio), and the
     deposited mass per second of both is printed.
  5. The SASS counts of the refill draw and the f32 lane window that
     OPS_DRAW, OPS_STEP and OPS_BOUNDARY rest on (sass_study, cuobjdump);
     kernel times at each cell's main-path shapes (CUDA events; the MH
     deposit, whose call is bound by the host, by its kernel time in
     torch.profiler, which must show the engine's deposit step as one
     launch) beside their bounds and unfused issue floors; where a cell's
     plan takes the length sort, its kernels vs its plain version bitwise
     on that pass's emissions (default: 8,388,608 slots in 80 buckets;
     zoom: 2,097,152 in 19,500, tiles of 2^14); and at the
     default cell beside their plain versions
     and torch.bincount of the replay's id stream; a torch.profiler
     profile of 16 engine passes per cell (8 at mhzoom; device ms per
     kernel, busy share).
  6. The bigtiles route (--scatter bigtiles: replay_ids / replay_ids_ext,
     torch.sort, bigtiles_deposit) for histograms beyond the L2.
     bigtiles_deposit vs its plain version bitwise at 1000x1000, 6000x4500
     and 20000x20000 on four sorted streams (random with 10% sentinels,
     clustered, one id over several chunks, a real replay's ids);
     replay_ids and replay_ids_ext vs their plain versions on phase 2's
     batches. Three cells through cudabrot_tpu_torch.cli.main, each with
     --scatter bigtiles and again with --scatter auto: bigcanvas (the
     README's 6000x4500 canvas, default band, 20 passes), northstar
     (NORTHSTAR.json's 20000x20000 render, band [2000,20000), 10 passes)
     and bigzoom (the zoom cell at 6000x4500, 32 passes). The two routes'
     histograms and stats must be equal bit for bit, the route's kernels
     launched and no plain version run; the PGM's header and size are
     checked and the file deleted (no checkpoint is written). Then each
     cell's kernel times at its main-path shapes (the replay to ids, the
     sort, the deposit, the fused replay-deposit of the same batch, the
     plain versions and index_add_), and both routes' pass times and
     device profiles.
  7. The df32 replay's long-orbit floor: the zoom batch's longest orbit,
     at 19,999 steps, replayed alone (one thread in its own launch), and
     at the head of the whole batch and of its first 32..16384 orbits, by
     replay_deposit_ext and by replay_ids_ext (bigzoom canvas); the batch
     at 4..32 resident warps per SM; both kernels' registers.
  8. Engine passes with the fused replay overlapping the next pass (its
     side streams, as the driver runs them) against the same passes with
     a synchronize() after each and with the replay on the main stream:
     histogram and every stat bitwise at the default, deep and zoom cells.
  9. render-color through cudabrot_tpu_torch.cli.main: the README's HSL
     recipe (H 8000/1000, S 500/20, L 60000/45000, --normalize) at
     6000x4500, 8 passes a band, with --interleave and one band after
     another. Every band's histogram and stats must be equal bit for bit
     between the two, its histogram sum equal to its on-canvas points, and
     the two PNGs byte-identical; each band's ms per pass and each mode's
     wall time are printed.
  10. Multi-device and multi-process rendering on the one card: the
     data-parallel engine over [cuda:0, cuda:0] against two single engines
     at RNG ordinals 0 and 1, summed (default, zoom and mhcrop, the MH
     tails flushed); the row-sharded engine over 2 and 3 shards of cuda:0
     (the replay kernels' row window) against the data-parallel engine
     over the same ordinals (default and zoom on the fused route,
     bigcanvas on the bigtiles route; 3 shards split 1000 and 4500 rows
     unevenly); cli.main in two processes (torch.distributed, gloo, on
     localhost; -d 0 --devices 2) against the single-process data-parallel
     render: histograms, stats, the checkpoint and the PGM bytes bitwise,
     the second process silent, each path's kernels launched and no plain
     version run. Then a pass of DP x2 on one card beside a single
     engine's, the row-sharded pass with and without re-sorting its
     gathered batch (LongestFirst, here only), and the allocator's peak
     on cuda:0 while four row shards of the northstar canvas are built
     and run (the shards, never a whole canvas more).
  11. The host orbit replay through cudabrot_tpu_torch.cli.main: the
     native library's build (g++, beside the nvcc builds of phase 1); the
     calibration probe with --quick (its constants printed, and the auto
     share they give the default cell); the default cell with --replay
     host at device shares 0, 0.3 and the probe's auto share, the zoom
     (the f64 replay of df32 payloads), mhcrop with --hist-dtype uint64
     (auto resolves to host) and with --replay host, and bigcanvas at
     share 0 (the DRAM regime), each against the device-mode render of the
     same seed and passes: every count but on_canvas_points bitwise, the
     histogram's sum equal to on_canvas_points, the mass placed
     differently (half the L1 distance) reported, and below
     HOST_EDGE_SHARE at default; mhcrop's uint64 == uint32 == device
     histograms bitwise; DP host over [cuda:0, cuda:0] == single host
     engines at ordinals 0 and 1, summed; two cli.main processes with
     --replay host == one process (checkpoint and PGM bytes). Then ms a
     pass on the host clock by mode (device, host, hybrid 0.3) at default,
     zoom and bigcanvas, the worker's fetch and replay seconds, host
     replay points/s, payload bytes a pass, and a host-mode pass's device
     busy share (torch.profiler), with the host's CPU and cores.
  12. Repeatability: the first call of each of the fourteen kernels in
     one main-path pass of its cell (default, zoom, mhcrop, mhzoom;
     bigcanvas and bigzoom on the bigtiles route; deposit_ids on the
     default cell's pallas route; threefry_bits at deep, whose capacity
     is below its slots)
     is recorded with its inputs and run REPEAT_RUNS times more, each run
     on clones of those inputs carved from buffers between two margins,
     every output the wrapper allocates and every margin filled with
     another byte (POISON): every output, and every input the kernel
     updates in place, must equal the first run's bitwise, and no margin
     may change (an unwritten output element, a read or a write past a
     tensor). Then classify at the default cell's 262,144 lanes at phase
     2's two bands: REPEAT_SEEDS seeds each run twice from a state carried
     on from seed to seed, and REPEAT_PLAIN_SEEDS seeds through the kernel
     and twice through the plain version. A mismatch prints the tensors
     that differ, how many elements, and the first few with both bit
     patterns (classify's as block, warp, thread and sub-lane of
     csrc/classify.cu), and saves the inputs and both runs under
     chiprun_out/; a classify mismatch, here or in phase 2, first runs
     the kernel and the plain version once more on the same input and
     says which runs agree (hold_classify).
  13. (run after phase 5) The id-stream routes through
     cudabrot_tpu_torch.cli.main: --scatter pallas (replay_ids or
     replay_ids_ext, then deposit_ids) at default, deep, zoom and
     bigcanvas, and --scatter sorted (the bigtiles route: torch.sort, then
     bigtiles_deposit) at default and zoom, each against --scatter auto:
     histogram and every stat bitwise, the histogram's sum the on-canvas
     points, the route's kernels launched and no plain version run; the
     row-sharded engine over two shards of cuda:0 on the pallas route
     against the data-parallel engine on the fused route; then each cell's
     pass by route (auto, pallas, bigtiles in turns).
  3c. (run after phase 13) deposit_ids on the streams the pallas route
     gives it (the default, deep, zoom and bigcanvas cells' replay_ids
     streams, the first group of a pass) and on phase 3's random streams,
     and on views starting 0..3 ids past a 16-byte boundary, against
     deposit_ids_plain bitwise; each stream's sentinel share and share of
     equal ids in 32-id windows; its times beside index_add_,
     torch.bincount, the byte bound and the card's random RED.ADD.U32
     ceiling into 4 MB and 108 MB (RED_CEILING_CU, a microbenchmark at
     full occupancy built beside the package).
  Phases 2, 3 and 3b hold the two df32 replay kernels on a batch whose
  head orbit is set to 19,999 steps.

``--repeat`` builds and runs phase 2's classify checks (the first work
on the card, as in the default run) and phase 12. ``--sanitize`` runs a small
target of the fourteen kernels (``--sanitize-target``: phase 12's capture at
a 64x48 canvas and 2,048 lanes, SANITIZE_CELLS) under compute-sanitizer
(found beside nvcc; its absence fails the run) with each of its memcheck,
racecheck, synccheck and initcheck tools, ``--error-exitcode 1`` and
``--kernel-regex`` on the port's kernels, and prints each tool's verdict
per kernel; it fails on any error, on a kernel the target did not launch,
and where the sanitizer does not support the card.

``--routes`` builds and runs phases 13 and 3c alone. ``--host`` builds
and runs phase 11 alone. ``--multi`` builds and runs phase 10 alone.
``--replay-study`` builds and runs phase 7 and phase 7c (the f32
replay-deposit's long-orbit floor at the deep and northstar batches, and
the default, deep and northstar batches at 4..64 resident warps per SM,
the default batch at each number of groups a warp takes). The flags
combine (one build, the phases in the order given). Run from a copy of
another commit's tree (the script beside its package), each gives that
commit's numbers, so two commits compare within one call.

Prints the card's name and power limit, one JSON line of kernel records,
and as its last line {"ok": true, "device": {...}}. Exits non-zero, with
no result line, when CUDA is unavailable or the package is missing.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "chip_smoke")

#: Published H100 SXM peaks (NVIDIA data sheet): float32 outside the
#: tensor cores, and HBM3 bandwidth.
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12
#: The card's unfused issue rate: 132 SMs x 128 lanes x 1.98 GHz. The
#: kernels build with -fmad=false, so each counted operation but the df32
#: two-products' FFMAs is one issued instruction, and an operation-bound
#: kernel cannot beat instructions / PEAK_ISSUE (PEAK_OPS counts an FFMA
#: as two operations).
PEAK_ISSUE = 33.5e12
#: The integer ALU pipe (adds, logic, shifts, compares): 64 lanes a clock
#: per SM, half the issue rate: 132 x 64 x 1.98 GHz.
PEAK_INT = 16.7e12
#: Operations per unit of work as (instructions, of which on the ALU pipe,
#: of which FFMA). An FFMA is one instruction for the issue floor and two
#: operations for the bound. A refill draw (Threefry-2x32 69 (49 ALU), the
#: domain map of two words 11 (2), the cull 13 (3)), a Threefry word of
#: threefry_bits (the block and the xor): SASS counts that phase 5
#: (sass_study) prints for sm_90a. The f32 classify's
#: inner step and window boundary (the default cell's thin-tracking window
#: with Brent checks): SASS counts, as above, from the loop bodies of one
#: window at U = 0, 1 and 2. A replayed f32 orbit point (step + bin), a
#: deposited id: hand counts from csrc/*.cu, all on the FMA pipe. The df32
#: ones are SASS counts measured in PR 9: the
#: classify_ext inner step (the df32 step, three FFMA two-products, with
#: the survival count and the window's end), the boundary every lane-window
#: takes (a warp with no finished lane pays only this), ext_finish (the
#: rest of a finished lane's boundary and its refill draw, paid per
#: refill), and the MH df32 window boundary. The MH df32 inner step is the
#: df32 step (60, the same count) plus by hand the centre-relative window
#: coordinates (6), the window test (7), the LCG (2) and the visit and
#: survival counts (3): its loop body in the SASS (123) also holds the
#: reservoir's take test and a recorded visit's bin, which few steps run.
#: The df32 replay point is the df32 step plus the df32 bin offset and
#: quantization by hand (27).
OPS_STEP = (15, 9, 0)
OPS_BOUNDARY = (28, 14, 0)
OPS_DRAW = (93, 54, 0)
OPS_REPLAY_POINT = (15, 0, 0)
OPS_DEPOSIT_ID = 3
OPS_THREEFRY_WORD = (70, 50)
OPS_STEP_EXT = (67, 5, 3)
OPS_BOUNDARY_EXT = (6, 5, 0)
OPS_FINISH_EXT = (110, 69, 0)
OPS_STEP_MH_EXT = (78, 0, 3)
OPS_BOUNDARY_MH_EXT = (14, 8, 0)
OPS_REPLAY_POINT_EXT = (87, 0, 3)
#: The MH kernels (csrc/mh.cuh): a finished proposal pays two Threefry
#: calls (SASS, as above), and by hand count the chain boundary, the
#: proposal draw, the sample's rebuild and cull, and up to three V-word
#: reservoir moves (V = 8 here), 84; the df32 one adds the two df32 sums,
#: 114. The f32 MH window's step and boundary are the hand counts of
#: engines/cuda_engine.py (MH_*).
OPS_DRAW_MH = (2 * 69 + 84, 2 * 49, 0)
OPS_DRAW_MH_EXT = (2 * 69 + 114, 2 * 49, 0)


def op_bounds(terms, nbytes):
    """(bound ms, what bounds it, unfused issue floor ms) of the work
    sum(count * n) over (count, n) terms, each count an OPS_* triple, with
    ``nbytes`` of traffic."""
    ins, alu, ffma = (sum(c[i] * n for c, n in terms) for i in range(3))
    bound, by = bound_ms(ins + ffma, nbytes, alu)
    return bound, by, floor_ms(ins, nbytes, alu)


ZOOM = ["-m", "20000", "-c", "500", "--precision", "extended", "--center",
        "-0.743643887037151,0.131825904205330", "--span", "1e-5"]
#: The JAX package's mh_zoom leg (bench.py): the zoom window rendered by
#: Metropolis-Hastings chains, sampled from a domain 8x the window.
MHZOOM = [*ZOOM, "--sampler", "mh"]
MHCROP = ["--sampler", "mh", "--center", "-0.7436,0.1319", "--span", "6e-3",
          "-m", "500", "-c", "50"]
#: The main path's cells at 1000x1000: name, CLI arguments, passes.
CELLS = (
    ("default", [], 20),
    ("deep", ["-m", "20000", "-c", "2000"], 10),
    ("zoom", ZOOM, 96),
    ("mhzoom", MHZOOM, 40),
    ("mhcrop", MHCROP, 40),
)
#: The bigtiles cells: canvases beyond the card's 50 MB L2, each rendered
#: through both deposit routes. bigcanvas is the README's 6000x4500 colour
#: canvas at the default band, northstar NORTHSTAR.json's render, bigzoom
#: the zoom cell's window at 6000x4500 (the df32 route).
BIG_CELLS = (
    ("bigcanvas", ["-w", "6000", "-h", "4500", "--min-imag", "-1.5",
                   "--max-imag", "1.5"], 20),
    ("northstar", ["-w", "20000", "-h", "20000", "-m", "20000", "-c",
                   "2000"], 10),
    ("bigzoom", ["-w", "6000", "-h", "4500", *ZOOM], 32),
)
#: The colour phase: the README's flagship HSL recipe ("Color renders":
#: H 8000/1000, S 500/20, L 60000/45000, --normalize, 6000x4500 over
#: imaginary [-1.5, 1.5]) through cli.main render-color, COLOR_PASSES
#: passes a band, interleaved and one band after another.
COLOR_ARGS = ["render-color", "--mode", "hsl", "--normalize", "-w", "6000",
              "-h", "4500", "--min-imag", "-1.5", "--max-imag", "1.5",
              "--band", "H:8000:1000:-1:400", "--band", "S:500:20:-1:200",
              "--band", "L:60000:45000:-1:1200"]
COLOR_PASSES = 8
#: The measure check of mhzoom: seeds, MH passes (the first MH_BURNIN are
#: burn-in) and uniform comparator passes per seed.
MEASURE_SEEDS = (1337, 4242)
MH_MEASURE_PASSES, MH_MEASURE_BURNIN = 128, 32
UNIFORM_MEASURE_PASSES = 96
#: Oracle passes over the zoom window (65,536 float64 samples each).
ORACLE_PASSES = 2
#: The df32 replay's long-orbit floor (phase 7): steps of the measured
#: orbit, and the heads of the descending zoom batch it is timed inside.
FLOOR_STEPS = 19_999
FLOOR_HEADS = (32, 128, 256, 1024, 4096, 16384)
#: Every hand-written kernel: source, the TPU code it replaces, and the
#: cell whose main-path run counts its launches and gives its shapes
#: ("cell:route": the cell with --scatter route, phase 13; deposit_ids'
#: record comes from phase 3c on that route's stream).
KERNELS = {
    "classify": ("cudabrot_tpu_torch/csrc/classify.cu",
                 "cudabrot_tpu/ops/pallas_kernels.py:182", "default"),
    "threefry_bits": ("cudabrot_tpu_torch/csrc/classify.cu",
                      "cudabrot_tpu/engines/pallas_engine.py:1342",
                      "default"),
    "replay_deposit": ("cudabrot_tpu_torch/csrc/deposit.cu",
                       "cudabrot_tpu/ops/binning.py:154", "default"),
    "deposit_ids": ("cudabrot_tpu_torch/csrc/deposit.cu",
                    "cudabrot_tpu/ops/binning.py:154", "default:pallas"),
    "classify_ext": ("cudabrot_tpu_torch/csrc/classify_ext.cu",
                     "cudabrot_tpu/ops/pallas_kernels_ext.py:134", "zoom"),
    "replay_deposit_ext": ("cudabrot_tpu_torch/csrc/deposit_ext.cu",
                           "cudabrot_tpu/engines/pallas_engine.py:786",
                           "zoom"),
    "classify_mh": ("cudabrot_tpu_torch/csrc/classify_mh.cu",
                    "cudabrot_tpu/ops/pallas_kernels_mh.py:437", "mhcrop"),
    "classify_ext_mh": ("cudabrot_tpu_torch/csrc/classify_mh.cu",
                        "cudabrot_tpu/ops/pallas_kernels_mh.py:998",
                        "mhzoom"),
    "mh_deposit": ("cudabrot_tpu_torch/csrc/deposit.cu",
                   "cudabrot_tpu/ops/binning.py:938", "mhcrop"),
    "replay_ids": ("cudabrot_tpu_torch/csrc/deposit.cu",
                   "cudabrot_tpu/engines/pallas_engine.py:609", "bigcanvas"),
    "replay_ids_ext": ("cudabrot_tpu_torch/csrc/deposit_ext.cu",
                       "cudabrot_tpu/engines/pallas_engine.py:786",
                       "bigzoom"),
    "bigtiles_deposit": ("cudabrot_tpu_torch/csrc/bigtiles.cu",
                         "cudabrot_tpu/ops/binning.py:610", "bigcanvas"),
    "length_sort": ("cudabrot_tpu_torch/csrc/length_sort.cu",
                    "none: the argsorts of cudabrot_tpu/engines/"
                    "pallas_engine.py _classify_and_compact where nothing "
                    "is dropped", "default"),
    "pass_counters": ("cudabrot_tpu_torch/csrc/classify.cu",
                      "none: the stat sums of cudabrot_tpu/engines/"
                      "pallas_engine.py:1431 _classify_and_compact (XLA)",
                      "default"),
}


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    log(f"  ok: {what}")


def time_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean milliseconds per call over ``reps`` calls (CUDA events)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Milliseconds per call on the host clock over ``reps`` calls, each
    followed by a synchronize (launch overhead and device time)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def pass_ms(eng, state, first: int, reps: int) -> float:
    """Mean milliseconds per engine pass over ``reps`` passes (CUDA events,
    after one warm pass); the end event waits for the fused replay's side
    streams, so the last pass's replay is counted."""
    import torch

    eng.run_pass(state, first)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for p in range(reps):
        eng.run_pass(state, first + 1 + p)
    eng.wait_replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops: float, nbytes: float,
             int_ops: float = 0.0) -> tuple[float, str]:
    """The least time for ``ops`` operations (``int_ops`` of them on the
    integer ALU pipe, the rest at the f32 peak) and ``nbytes`` of traffic,
    and which of the two bounds it."""
    t_ops = max((ops - int_ops) / PEAK_OPS, int_ops / PEAK_INT)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def floor_ms(ops: float, nbytes: float, int_ops: float = 0.0) -> float:
    """The unfused issue floor: one instruction per operation at
    PEAK_ISSUE, the ALU's share at PEAK_INT, the bytes at PEAK_BYTES."""
    return 1e3 * max(ops / PEAK_ISSUE, int_ops / PEAK_INT, nbytes / PEAK_BYTES)


def same_bits(a, b) -> bool:
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def max_abs_err(pairs) -> float:
    """Largest |kernel - plain| over pairs of output tensors (inf where
    only one side is NaN)."""
    import torch

    worst = 0.0
    for a, b in pairs:
        a, b = a.to(torch.float64), b.to(torch.float64)
        d = torch.where(torch.isnan(a) & torch.isnan(b), 0.0, (a - b).abs())
        d = torch.where(torch.isnan(d), float("inf"), d)
        if d.numel():
            worst = max(worst, float(d.max()))
    return worst


def clone_state(state):
    return type(state)(*(t.clone() for t in state))


def cell_args(name):
    """A cell's CLI arguments (the CELLS at 1000x1000)."""
    for n, a, _ in CELLS:
        if n == name:
            return ["-w", "1000", "-h", "1000", *a]
    return next(a for n, a, _ in BIG_CELLS if n == name)


def cell_config(name, scatter="auto"):
    """The RenderConfig cli.main builds for a cell's arguments."""
    from cudabrot_tpu_torch import cli

    return cli.parse_args([*cell_args(name), "--scatter", scatter])[0]


def path_kernels(name, scatter="auto"):
    """The kernels a cell's main path launches."""
    o = cell_config(name, scatter).options
    if o.sampler == "mh":
        return ("classify_ext_mh" if o.precision == "extended"
                else "classify_mh", "mh_deposit")
    from cudabrot_tpu_torch.engines import cuda_engine as ce
    from cudabrot_tpu_torch.ops import binning

    ext = o.precision == "extended"
    route = ce.compact_route(ce.Tuning(cell_config(name, scatter)))
    head = ("classify_ext" if ext else "classify",
            "length_sort" if route == "length" else "threefry_bits",
            "pass_counters")
    route = binning.select_scatter_backend(scatter)
    if route == "fused":
        return (*head, "replay_deposit_ext" if ext else "replay_deposit")
    return (*head, "replay_ids_ext" if ext else "replay_ids",
            {"bigtiles": "bigtiles_deposit", "ids": "deposit_ids"}[route])


# ----------------------------------------------------------------------


def phase_build(flags=()):
    """Phase 1: the package's libraries, their registers, shared memory and
    spills (nvcc -Xptxas -v), and the native host replay. Where phase 3c
    runs (the default run and --routes) also the atomic ceiling's
    RED_CEILING_CU."""
    import concurrent.futures

    from cudabrot_tpu_torch.io import native
    from cudabrot_tpu_torch.ops import _build

    log("== phase 1: build")
    t0 = time.monotonic()
    ceiling = not flags or "--routes" in flags
    # The host replay's library builds with g++ beside the nvcc builds.
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native_build = pool.submit(native.load)
        started = start_ceiling_build() if ceiling else None
        _build.build_all()
        native_build.result()
        if started:
            finish_ceiling_build(started)
    log(f"  built {', '.join(_build.LIBS)} in {time.monotonic() - t0:.1f} "
        f"s; the native host replay (g++) in {native.build_seconds:.1f} s")
    for name in _build.LIBS:
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  [{name}] {line.strip()}")


def package_lanes() -> int:
    """The lanes per thread of the package's classify build
    (csrc/classify.cu's kLanesPerThread)."""
    import re

    from cudabrot_tpu_torch.ops import _build

    src = (_build.CSRC / "classify.cu").read_text()
    m = re.search(r"constexpr int kLanesPerThread = (\d+);", src)
    return int(m.group(1)) if m else 1




def classify_spec(cfg, steps, flush):
    from cudabrot_tpu_torch.engines.cuda_engine import Tuning
    from cudabrot_tpu_torch.models.fractals import get_fractal

    tn = Tuning(cfg)
    return dict(
        fractal=get_fractal(cfg.fractal), min_it=tn.min_it,
        max_it=tn.max_it, steps_per_pass=steps, steps_per_flush=flush,
        cycle_detection=True, inner_unroll=tn.inner_unroll,
        thin_tracking=tn.thin_tracking,
    ), tn


def check_classify(tag, fields, ra, rb):
    for name, x, y in zip(fields, ra.state, rb.state):
        check(same_bits(x, y), f"{tag}: lane state {name} bitwise")
    check(same_bits(ra.emit_c, rb.emit_c), f"{tag}: emit_c bitwise")
    check(same_bits(ra.emit_it, rb.emit_it), f"{tag}: emit_it bitwise")
    check(same_bits(ra.stats, rb.stats), f"{tag}: stats bitwise")
    return max_abs_err([*zip(ra.state, rb.state), (ra.emit_c, rb.emit_c),
                        (ra.emit_it, rb.emit_it), (ra.stats, rb.stats)])


def phase_classify(dev):
    """Kernel vs plain version, bitwise, from a carried state. A mismatch
    of the f32 classify kernel runs both once more on the same input and
    saves every run (hold_classify)."""
    from cudabrot_tpu_torch.config import IterationBand, RenderConfig
    from cudabrot_tpu_torch.ops import classify as cls

    log("== phase 2: classify kernels vs plain, bitwise")
    batches, errs = {}, {}
    for band, steps, warm in (((20, 100), 256, 2), ((2000, 20000), 256, 8)):
        cfg = RenderConfig(band=IterationBand(
            min_escape_iterations=band[0], max_escape_iterations=band[1]))
        flush = 128 if band[1] <= 100 else 256
        spec, tn = classify_spec(cfg, steps, flush)
        state = cls.init_lane_state(cfg.options.lane_rows, dev)
        for p in range(warm):
            cls.classify_pass(state, (1337, p), **spec)
        a, b = clone_state(state), clone_state(state)
        seed = (0xC0FFEE, 0xBADF00D)
        ra = cls.classify_pass(a, seed, **spec)
        args = plain_classify_args(spec, tn, cfg, steps, flush)
        rb = cls.classify_pass_plain(b, *seed, None, **args)
        lanes = cfg.options.lane_rows * 128
        tag = f"band {band} U={tn.inner_unroll} lanes={lanes}"
        hold_classify(tag, state, seed, spec, args,
                      {"kernel": ra, "plain": rb})
        err = check_classify(tag, cls.LaneState._fields, ra, rb)
        errs["classify"] = max(errs.get("classify", 0.0), err)
        n_em = int((ra.emit_it >= 0).sum())
        cyc = int(ra.stats[cls.STAT_CYCLES].sum())
        log(f"  {tag}: {n_em} emissions, {cyc} Brent cycles in the pass")
        check(n_em > 0, f"{tag}: pass emitted")
        batches[band] = (ra, tn)

    from cudabrot_tpu_torch.ops import prng

    n = 32 * 2048 * 128  # the default band's emission slots per pass
    key = prng.fold_in(prng.pass_key(1337, 0, 9), 0x7711)
    wk, wp = prng.bits(key, n, dev), prng.bits_plain(key, n, dev)
    check(same_bits(wk, wp), f"threefry_bits: {n} words bitwise vs plain")
    errs["threefry_bits"] = max_abs_err([(wk, wp)])

    from cudabrot_tpu_torch.ops import length_sort as ls

    errs["length_sort"] = 0.0
    for band, (ra, _) in batches.items():
        got = ls.length_sort(ra.emit_c, ra.emit_it, *band)
        want = ls.length_sort_plain(ra.emit_c, ra.emit_it, *band)
        check(all(same_bits(a, b) for a, b in zip(got, want)),
              f"length_sort band {band}: {int(got[3])} of "
              f"{ra.emit_it.numel()} slots kept, bitwise vs plain")
        errs["length_sort"] = max(errs["length_sort"], max_abs_err(
            list(zip(got, want))))
    return batches, errs


def phase_classify_ext(dev):
    """The df32 classify kernel vs its plain version at the zoom cell's
    geometry and full lane width, from a carried state. Returns the pass's
    result, the tuning and the kernel's record (error and plain time)."""
    import torch

    from cudabrot_tpu_torch.engines.cuda_engine import Tuning
    from cudabrot_tpu_torch.models.fractals import get_fractal
    from cudabrot_tpu_torch.ops import classify as cls
    from cudabrot_tpu_torch.ops import classify_ext as cx

    cfg = cell_config("zoom")
    tn = Tuning(cfg)
    fr = get_fractal(cfg.fractal)
    spec = dict(fractal=fr, min_it=tn.min_it, max_it=tn.max_it,
                steps_per_pass=tn.steps_per_pass,
                steps_per_flush=tn.steps_per_flush, cycle_detection=True,
                inner_unroll=tn.inner_unroll,
                sample_domain=cfg.sample_domain)
    state = cx.init_ext_lane_state(cfg.options.lane_rows, dev)
    for p in range(8):
        cx.classify_pass_ext(state, (1337, p), **spec)
    a, b = clone_state(state), clone_state(state)
    seed = (0xC0FFEE, 0xBADF00D)
    ra = cx.classify_pass_ext(a, seed, **spec)
    args = dict(fractal=fr, min_it=tn.min_it, max_it=tn.max_it,
                chunks=tn.steps_per_pass // tn.steps_per_flush,
                windows=tn.steps_per_flush // tn.inner_unroll,
                unroll=tn.inner_unroll, detect=True,
                sample_domain=cfg.sample_domain, visit_window=None)
    out = {}

    def plain():
        out["r"] = cx.classify_pass_ext_plain(b, *seed, None, **args)

    plain_ms = time_ms(plain, 1, warm=False)
    tag = (f"classify_ext band ({tn.min_it}, {tn.max_it}) "
           f"U={tn.inner_unroll} steps={tn.steps_per_pass} "
           f"lanes={tn.lanes}")
    err = check_classify(tag, cx.ExtLaneState._fields, ra, out["r"])
    for f, t in zip(cx.ExtLaneState._fields, ra.state):
        if t.dtype == torch.float32:
            check(bool(torch.isfinite(t).all()),
                  f"{tag}: stored {f} holds no inf/NaN")
    n_em = int((ra.emit_it >= 0).sum())
    st = ra.stats.reshape(cls.STATS_ROWS, -1).sum(dim=1)
    log(f"  {tag}: {n_em} emissions, {int(st[cls.STAT_DRAWN])} refills, "
        f"{int(st[cls.STAT_CYCLES])} Brent cycles; plain version "
        f"{plain_ms:.1f} ms")
    check(n_em > 0 and int(st[cls.STAT_DRAWN]) > 0,
          f"{tag}: pass refilled and emitted")
    return ra, tn, cfg, dict(max_abs_err=err, plain_ms=plain_ms)


def phase_deposit(dev, batches):
    import torch

    from cudabrot_tpu_torch.config import Canvas
    from cudabrot_tpu_torch.engines.cuda_engine import compact
    from cudabrot_tpu_torch.models.fractals import get_fractal
    from cudabrot_tpu_torch.ops import binning

    log("== phase 3: deposit kernels vs plain, bitwise")
    gen = torch.Generator(device=dev).manual_seed(7)
    records, errs = {}, {}
    n_ids = 1 << 24
    for w, h in ((1000, 1000), (6000, 4500)):
        nbins = w * h
        ids = torch.randint(0, nbins, (n_ids,), generator=gen, device=dev,
                            dtype=torch.int32)
        ids[torch.rand(n_ids, generator=gen, device=dev) < 0.1] = nbins
        hk = torch.zeros(nbins, dtype=torch.int32, device=dev)
        hp = torch.zeros_like(hk)
        binning.deposit_ids(hk, ids)
        binning.deposit_ids_plain(hp, ids)
        check(torch.equal(hk, hp), f"deposit_ids {w}x{h}: bitwise vs index_add_")
        check(int(hk.to(torch.int64).sum()) == int((ids < nbins).sum()),
              f"deposit_ids {w}x{h}: every non-sentinel id counted")
        err = max_abs_err([(hk, hp)])
        ms = time_ms(lambda: binning.deposit_ids(hk, ids), 20)
        plain = time_ms(lambda: binning.deposit_ids_plain(hp, ids), 5)
        lib = time_ms(lambda: torch.bincount(ids, minlength=nbins + 1), 5)
        b_ms, b_by = bound_ms(OPS_DEPOSIT_ID * n_ids, 4 * n_ids + 8 * nbins)
        # The histogram atomics per ms this stream reaches: the rate the MH
        # deposit's bound counts its pairs at (a measured rate, not a peak).
        rate = int((ids < nbins).sum()) / ms
        records[(w, h)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                               bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                               atomics_per_ms=rate)
        log(f"  deposit_ids {w}x{h}, {n_ids} ids: kernel {ms:.4f} ms "
            f"({rate:.4e} histogram atomics per ms), index_add_ "
            f"{plain:.4f} ms, bincount {lib:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by})")

    canvas = Canvas()
    fr = get_fractal("buddhabrot")
    for band, (res, tn) in batches.items():
        cr, ci, it, _ = compact(res.emit_c, res.emit_it, (1, 2),
                                tn.replay_capacity, tn.max_it)
        hk = torch.zeros(canvas.num_pixels, dtype=torch.int32, device=dev)
        hp = torch.zeros_like(hk)
        hits_k = binning.replay_deposit(hk, cr, ci, it, canvas=canvas,
                                        fractal=fr)
        hits_p = binning.replay_deposit_plain(hp, cr, ci, it, canvas=canvas,
                                              fractal=fr)
        check(torch.equal(hk, hp), f"replay_deposit band {band}: bitwise")
        check(int(hits_k) == int(hits_p) == int(hk.to(torch.int64).sum()),
              f"replay_deposit band {band}: hits == histogram mass")
        errs["replay_deposit"] = max(
            errs.get("replay_deposit", 0.0),
            max_abs_err([(hk, hp), (hits_k, hits_p)]))
        for w in STUDY_REPLAY_WARPS:
            hw = torch.zeros_like(hk)
            with mock.patch.object(binning, "REPLAY_WARPS_PER_SM", w):
                hits_w = binning.replay_deposit(hw, cr, ci, it,
                                                canvas=canvas, fractal=fr)
            check(torch.equal(hw, hp) and int(hits_w) == int(hits_p),
                  f"replay_deposit band {band}, {w} warps per SM: bitwise")
            errs["replay_deposit"] = max(errs["replay_deposit"], max_abs_err(
                [(hw, hp), (hits_w, hits_p)]))
        log(f"  band {band}: {int((it >= 0).sum())} orbits, "
            f"{int(hits_k)} on-canvas points")
    return records, errs


def phase_deposit_ext(dev, res, tn, cfg):
    """The fused df32 replay-deposit kernel vs its plain version on the
    batch compacted from phase 2's df32 emissions (the zoom cell's canvas
    and capacity)."""
    import torch

    from cudabrot_tpu_torch.engines.cuda_engine import compact
    from cudabrot_tpu_torch.models.fractals import get_fractal
    from cudabrot_tpu_torch.ops import binning

    kr, ki, it, _ = compact(res.emit_c, res.emit_it, (1, 2),
                            tn.replay_capacity, tn.max_it)
    it[0] = FLOOR_STEPS - 1  # a 19,999-step orbit at the batch's head
    kw = dict(canvas=cfg.canvas, fractal=get_fractal(cfg.fractal),
              sample_domain=cfg.sample_domain)
    hk = torch.zeros(cfg.canvas.num_pixels, dtype=torch.int32, device=dev)
    hp = torch.zeros_like(hk)
    hits_k = binning.replay_deposit_ext(hk, kr, ki, it, **kw)
    out = {}

    def plain():
        out["hits"] = binning.replay_deposit_ext_plain(hp, kr, ki, it, **kw)

    plain_ms = time_ms(plain, 1, warm=False)
    hits_p = out["hits"]
    check(torch.equal(hk, hp), "replay_deposit_ext: histogram bitwise")
    check(int(hits_k) == int(hits_p) == int(hk.to(torch.int64).sum()) > 0,
          "replay_deposit_ext: hits == histogram mass > 0")
    orbits = int((it >= 0).sum())
    points = int(torch.where(it >= 0, it + 1, 0).sum())
    log(f"  replay_deposit_ext: {orbits} orbits (longest "
        f"{int(it.max()) + 1} steps), {points} points, {int(hits_k)} on "
        f"canvas; plain version {plain_ms:.1f} ms")
    return dict(max_abs_err=max_abs_err([(hk, hp), (hits_k, hits_p)]),
                plain_ms=plain_ms)


MH_OUT_FIELDS = ("emit_it", "emit_rep", "emit_v", "emit_bins", "stats")


def phase_classify_mh(dev, name):
    """An MH classify kernel (classify_mh at mhcrop, classify_ext_mh at
    mhzoom) vs its plain version on one main-path pass of the cell (its
    own mh_pass_spec, full lane width) from a state carried 4 passes.
    Returns the kernel's result and its record (error, and the plain
    version's time for that pass)."""
    import torch

    from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine
    from cudabrot_tpu_torch.ops import classify_mh as cmh

    eng = CudaEngine(cell_config(name), device=dev)
    spec = eng.mh_pass_spec()
    ext = eng.extended
    kernel = "classify_ext_mh" if ext else "classify_mh"
    classify = cmh.classify_pass_ext_mh if ext else cmh.classify_pass_mh
    state = eng.init_state(None)["lanes"]
    for p in range(4):
        classify(state, (1337, p), **spec)
    a, b = clone_state(state), clone_state(state)
    seed = (0xC0FFEE, 0xBADF00D)
    ra = classify(a, seed, **spec)
    chunks = spec["steps_per_pass"] // spec["steps_per_flush"]
    wx0, wx1, wy0, wy1 = spec["window"]
    cv_w, cv_h = spec["canvas_wh"]
    args = dict(
        fractal=spec["fractal"], min_it=spec["min_it"], max_it=spec["max_it"],
        chunks=chunks,
        windows=spec["steps_per_flush"] // spec["inner_unroll"],
        unroll=spec["inner_unroll"], detect=True,
        sample_domain=spec["sample_domain"],
        window=(wx0, wx1, wy0, wy1, cv_w / (wx1 - wx0), cv_h / (wy1 - wy0)),
        restart256=spec["restart256"], rep_cap=spec["rep_cap"],
        canvas_wh=spec["canvas_wh"])
    out = {}

    def plain():
        out["r"] = cmh.classify_pass_mh_plain(ext, b, *seed, None, **args)

    plain_ms = time_ms(plain, 1, warm=False)
    rb = out["r"]
    tag = (f"{kernel} ({name}) band ({spec['min_it']}, {spec['max_it']}) "
           f"U={spec['inner_unroll']} V={eng.visit_slots} "
           f"steps={spec['steps_per_pass']} lanes={eng.lanes}")
    pairs = [*zip(ra.state, rb.state),
             *((getattr(ra, f), getattr(rb, f)) for f in MH_OUT_FIELDS)]
    for f, (x, y) in zip((*state._fields, *MH_OUT_FIELDS), pairs):
        check(same_bits(x, y), f"{tag}: {f} bitwise")
    for f, t in zip(state._fields, ra.state):
        if t.dtype == torch.float32:
            check(bool(torch.isfinite(t).all()),
                  f"{tag}: stored {f} holds no inf/NaN")
    st = ra.stats.reshape(cmh.MH_STATS_ROWS, -1).sum(dim=1)
    n_em = int((ra.emit_it >= 0).sum())
    log(f"  {tag}: {n_em} emissions, {int(st[0])} proposals resolved, "
        f"{int(st[cmh.STAT_MH_ACCEPT])} accepted, "
        f"{int(st[cmh.STAT_MH_MERGE])} merges; plain version "
        f"{plain_ms:.1f} ms")
    check(n_em > 0 and int(st[cmh.STAT_MH_ACCEPT]) > 0,
          f"{tag}: pass accepted and emitted")
    return ra, dict(max_abs_err=max_abs_err(pairs), plain_ms=plain_ms)


def mh_batch(res, t):
    """A pass's MH emissions as the flat (V, S) batch mh_scatter takes."""
    chunks, slots = res.emit_bins.shape[:2]
    bins = res.emit_bins.reshape(chunks, slots, -1).transpose(0, 1)
    return (bins.reshape(slots, -1).contiguous(), t.reshape(-1),
            res.emit_rep.reshape(-1))


def mh_pairs(bins, t, rep, nbins):
    """A flat MH batch as materialized (bin, weight) pairs, those the
    deposit adds (a non-zero share to a bin of the histogram), and each
    pair's column: what one index_add_ call, the library's form of the
    deposit, takes."""
    import torch

    from cudabrot_tpu_torch.ops import binning

    d, n, _ = binning.mh_deposit_weights(t, rep, bins.shape[0])
    kidx = torch.arange(bins.shape[0], device=bins.device)[:, None]
    take = ((t > 1)[None] & (kidx < n[None]) & (d != 0) & (bins >= 0)
            & (bins < nbins))
    col = torch.nonzero(take, as_tuple=True)[1]
    return bins[take].to(torch.int64), d[take].to(torch.int32), col


def mh_profile(res, nbins):
    """What a pass's MH emission buffers hand the deposit: slots scanned,
    depositable emissions, (bin, weight) pairs, the warp groups (32 lanes
    of one chunk, as the kernel walks them) that hold pairs and the
    distinct bins among each group's pairs (the atomics an equal-bin sum
    leaves), summed over the groups."""
    import torch

    t = torch.where(res.emit_it >= 0, res.emit_v, 0)
    bins_c, t_c, rep_c = mh_batch(res, t)
    idx, _, col = mh_pairs(bins_c, t_c, rep_c, nbins)
    group = col // 32
    return dict(slots=t.numel(), emissions=int((t > 1).sum()),
                pairs=idx.numel(), groups=int(torch.unique(group).numel()),
                distinct=int(torch.unique(group * nbins + idx).numel()))


def mh_deposit_bound(prof, rate):
    """The MH deposit's bound: the larger of its bytes (each slot's gate,
    t and rep, a bin per pair) over the memory rate and its pairs over the
    histogram atomic rate that deposit_ids reaches (``rate``, per ms): a
    rate another kernel reaches, not a published or measured L2 peak."""
    t_bytes = 1e3 * (12 * prof["slots"] + 4 * prof["pairs"]) / PEAK_BYTES
    t_ops = prof["pairs"] / rate
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"



def mh_deposit_step(state, res):
    """The engine's MH deposit step on one pass's emission buffers, as
    cuda_engine._mh_core runs it: one gated launch adding into the
    counters."""
    from cudabrot_tpu_torch.ops import binning

    return lambda: binning.mh_deposit(
        state["hist"].view(-1), res.emit_bins, res.emit_v, res.emit_rep,
        chunked=True, gate=res.emit_it,
        totals=(state["points"], state["mh_deposited"]))


def phase_mh_deposit(dev, res, name):
    """The mh_deposit kernel vs mh_scatter's plain version on the MH
    emissions of phase 2: as a flat (V, S) batch, as they lie in the
    emission buffers gated by emit_it (the main path's call, adding into
    given totals), and on the tail flush's flat (V, lanes) batch of the
    pass's lane state gated by rep >= 1; index_add_ of the materialized
    (bin, weight) pairs, the library yardstick, must give the same
    histogram. Returns the largest error."""
    import torch

    from cudabrot_tpu_torch.ops import binning

    nbins = cell_config(name).canvas.num_pixels
    t = torch.where(res.emit_it >= 0, res.emit_v, 0)
    bins_c, t_c, rep_c = mh_batch(res, t)
    hk, hk2, hp = (torch.zeros(nbins, dtype=torch.int32, device=dev)
                   for _ in range(3))
    dep_k, mass_k = binning.mh_deposit(hk, bins_c, t_c, rep_c)
    totals = tuple(torch.full((), 3, dtype=torch.int64, device=dev)
                   for _ in range(2))
    binning.mh_deposit(hk2, res.emit_bins, res.emit_v, res.emit_rep,
                       chunked=True, gate=res.emit_it, totals=totals)
    dep_k2, mass_k2 = (x - 3 for x in totals)
    _, dep_p, mass_p = binning.mh_scatter(hp, bins_c, t_c, rep_c)
    check(torch.equal(hk, hp), f"mh_deposit ({name}): flat batch bitwise")
    check(torch.equal(hk2, hp),
          f"mh_deposit ({name}): emission buffers as they lie, gated by "
          f"emit_it, bitwise")
    check(int(dep_k) == int(dep_k2) == int(dep_p.sum()) > 0,
          f"mh_deposit ({name}): recorded-bin count {int(dep_k)}")
    check(int(mass_k) == int(mass_k2) == int(mass_p.sum())
          == int(hk.to(torch.int64).sum()) > 0,
          f"mh_deposit ({name}): mass {int(mass_k)} == histogram sum")
    idx, w, _ = mh_pairs(bins_c, t_c, rep_c, nbins)
    check(torch.equal(torch.zeros_like(hp).index_add_(0, idx, w), hp),
          f"mh_deposit ({name}): index_add_ of the pairs agrees")
    # The tail flush: every chain's in-flight tenure.
    lanes = res.state
    slots = lanes.xb.shape[0]
    ht, htp = (torch.zeros(nbins, dtype=torch.int32, device=dev)
               for _ in range(2))
    dep_t, mass_t = binning.mh_deposit(ht, lanes.xb, lanes.xv, lanes.rep,
                                       gate=lanes.rep, gate_min=1)
    _, dep_tp, mass_tp = binning.mh_scatter(
        htp, lanes.xb.reshape(slots, -1),
        torch.where(lanes.rep >= 1, lanes.xv, 0).reshape(-1),
        lanes.rep.reshape(-1))
    check(torch.equal(ht, htp) and int(dep_t) == int(dep_tp.sum()) > 0
          and int(mass_t) == int(mass_tp.sum()) > 0,
          f"mh_deposit ({name}): tail flush ({int(dep_t)} bins, mass "
          f"{int(mass_t)}) bitwise")
    log(f"  mh_deposit ({name}): {int((t > 1).sum())} emissions, "
        f"{idx.numel()} (bin, weight) pairs")
    return max_abs_err(
        [(hk, hp), (hk2, hp), (dep_k, dep_p.sum()), (mass_k, mass_p.sum()),
         (dep_k2, dep_p.sum()), (mass_k2, mass_p.sum()), (ht, htp),
         (dep_t, dep_tp.sum()), (mass_t, mass_tp.sum())])


def run_cli(args, stats_path):
    from cudabrot_tpu_torch import cli
    from cudabrot_tpu_torch.ops import launches

    launches.reset()
    rc = cli.main(args)
    counts = launches.snapshot()
    check(rc == 0, f"cli.main {' '.join(args)} exits 0")
    with open(stats_path) as f:
        return json.load(f), counts


def phase_main_path(dev):
    import numpy as np
    import torch

    from cudabrot_tpu_torch.io import pgm
    from cudabrot_tpu_torch.ops import launches

    log("== phase 4: main paths through cudabrot_tpu_torch.cli.main")
    os.makedirs(OUT, exist_ok=True)
    results = {}
    for name, cell_args, passes in CELLS:
        pgm_path = os.path.join(OUT, f"{name}.pgm")
        ckpt_path = os.path.join(OUT, f"{name}.ckpt")
        stats_path = os.path.join(OUT, f"{name}.json")
        if os.path.exists(ckpt_path):
            os.remove(ckpt_path)
        torch.cuda.reset_peak_memory_stats(dev)
        args = ["-w", "1000", "-h", "1000", *cell_args, "--passes",
                str(passes), "-t", "-1", "-o", pgm_path, "-s", ckpt_path,
                "--stats-json", stats_path]
        stats, counts = run_cli(args, stats_path)
        peak = torch.cuda.max_memory_allocated(dev)
        img = pgm.read_pgm(pgm_path)
        check(img.shape == (1000, 1000) and img.dtype == np.uint16
              and int(img.max()) == 65535, f"{name}: valid 1000x1000 PGM")
        hist = np.load(ckpt_path)["hist"]
        check(int(hist.sum(dtype=np.uint64)) == stats["on_canvas_points"] > 0,
              f"{name}: histogram sum == on_canvas_points "
              f"({stats['on_canvas_points']})")
        check(stats["replay_dropped"] <= 0.01 * stats["in_band"],
              f"{name}: replay_dropped {stats['replay_dropped']} <= 1% of "
              f"in_band {stats['in_band']}")
        mh = "--sampler" in cell_args
        if mh:
            check(stats["mh_deposited"] == stats["on_canvas_points"]
                  and stats["replay_dropped"] == 0
                  and stats["mh_lost_weight"] == 0
                  and stats["weight_scale"] == 256,
                  f"{name}: mh_deposited == on_canvas_points, nothing "
                  f"dropped or lost, weight_scale 256")
            check(stats["mh_accepts"] > 0,
                  f"{name}: {stats['mh_accepts']} chain moves")
        for k in path_kernels(name):
            check(counts[k] > 0, f"{name}: {k} kernel launched "
                  f"({counts[k]} times)")
        for k in launches.KERNELS:
            check(counts[f"{k}_plain"] == 0,
                  f"{name}: plain version of {k} never ran")
        el = stats["elapsed_seconds"]
        lane_steps = stats["classify_iters"] + stats["wasted_steps"]
        log(f"  {name}: {passes} passes in {el:.3f} s; "
            f"{lane_steps / el:.4e} classify lane-steps/s; "
            f"{stats['orbit_points'] / el:.4e} replayed orbit points/s; "
            f"{stats['on_canvas_points'] / el:.4e} deposited points/s"
            + (f" ({stats['on_canvas_points'] / 256 / el:.4e} deposited "
               f"mass/s in orbit-point units)" if mh else "")
            + f"; peak device memory {peak / 2**20:.1f} MiB")
        log(f"  {name} stats: {json.dumps(stats)}")
        results[name] = (stats, counts)
    return results


def phase_color():
    """Phase 9: render-color through cli.main, the README's HSL recipe at
    6000x4500 (COLOR_ARGS), with --interleave and one band after another.
    Each mode's launches are counted from zero: the f32 main path's
    kernels launched, no plain version run. Every band's histogram and
    stats equal between the modes, bit for bit, its histogram sum equals
    its on_canvas_points, its drops stay within 1% of in-band; the two
    PNGs are byte-identical, RGB 6000x4500. Logs each band's ms per pass
    (the sequential render loop, CUDA passes ending in a synchronize) and
    each mode's wall time (render loop, readback, tone mapping, the
    normalize and combine, the PNG encode). The PNGs are then deleted."""
    import numpy as np

    from cudabrot_tpu_torch import cli, color
    from cudabrot_tpu_torch.engines import cuda_engine as ce
    from cudabrot_tpu_torch.ops import launches

    log("== phase 9: render-color, the README's HSL recipe at 6000x4500")
    os.makedirs(OUT, exist_ok=True)
    real = color.render_bands
    runs, walls, pngs = {}, {}, {}
    for mode in ("interleaved", "sequential"):
        pngs[mode] = os.path.join(OUT, f"hsl_{mode}.png")
        box = {}

        def keep(*a, box=box, **k):
            box["cfgs"] = a[0] if a else k["cfgs"]
            box["r"] = real(*a, **k)
            return box["r"]

        args = [*COLOR_ARGS, "--passes", str(COLOR_PASSES), "-o", pngs[mode],
                *(["--interleave"] if mode == "interleaved" else [])]
        launches.reset()
        t0 = time.monotonic()
        with mock.patch.object(color, "render_bands", keep):
            rc = cli.main(args)
        walls[mode] = time.monotonic() - t0
        counts = launches.snapshot()
        check(rc == 0, f"render-color ({mode}) exits 0")
        # Each band's plan decides its compaction (compact_route).
        routes = {key: ce.compact_route(ce.Tuning(c))
                  for key, c in box["cfgs"].items()}
        want = dict.fromkeys(path_kernels("default"), 3 * COLOR_PASSES)
        want["length_sort"] = COLOR_PASSES * sum(
            r == "length" for r in routes.values())
        want["threefry_bits"] = COLOR_PASSES * sum(
            r == "select" for r in routes.values())
        for k, n in want.items():
            check(counts[k] >= n,
                  f"render-color ({mode}): {k} kernel launched "
                  f"({counts[k]} times, {n} wanted; compaction routes "
                  f"{routes})")
        check(all(counts[f"{k}_plain"] == 0 for k in launches.KERNELS),
              f"render-color ({mode}): no plain version ran")
        runs[mode] = box["r"]
    il, sq = runs["interleaved"], runs["sequential"]
    for key in ("H", "S", "L"):
        a, b = il[key], sq[key]
        check(a.passes == b.passes == COLOR_PASSES
              and np.array_equal(a.histogram, b.histogram)
              and a.stats == b.stats,
              f"band {key}: interleaved histogram and stats == sequential, "
              f"bitwise")
        total = int(b.histogram.sum(dtype=np.uint64))
        check(total == b.stats["on_canvas_points"] > 0,
              f"band {key}: histogram sum == on_canvas_points ({total})")
        check(b.stats["replay_dropped"] <= 0.01 * b.stats["in_band"],
              f"band {key}: replay_dropped {b.stats['replay_dropped']} <= "
              f"1% of in_band {b.stats['in_band']}")
        log(f"  band {key}: {b.passes} passes, "
            f"{1e3 * b.elapsed_seconds / b.passes:.4f} ms a pass "
            f"(sequential), {b.stats['emitted']} orbits kept, "
            f"{b.stats['orbit_points']} orbit points, {total} on the canvas")
    data = {m: open(p, "rb").read() for m, p in pngs.items()}
    w, h = (int.from_bytes(data["sequential"][o:o + 4], "big")
            for o in (16, 20))
    check(data["interleaved"] == data["sequential"] and (w, h) == (6000, 4500)
          and data["sequential"][25] == 2,
          f"render-color: the two PNGs are byte-identical RGB {w}x{h} "
          f"({len(data['sequential'])} bytes)")
    for p in pngs.values():
        os.remove(p)
    log(f"  render-color wall time: interleaved {walls['interleaved']:.3f} s "
        f"(render loop {il['H'].elapsed_seconds:.3f} s), sequential "
        f"{walls['sequential']:.3f} s (render loops "
        f"{sum(r.elapsed_seconds for r in sq.values()):.3f} s)")


def phase_oracle(zoom_stats):
    """The zoom window through --engine oracle (float64) on the card, and
    its statistics against the df32 engine's: in-band fraction and orbit
    points per emission. The persistent sampler counts each lane's initial
    dummy draw as a sample, so the lane count is subtracted; samples still
    in flight when the render ends are not counted at all, which the
    tolerance absorbs."""
    import numpy as np

    from cudabrot_tpu_torch.io import pgm

    log("== phase 4b: the zoom window through --engine oracle (float64)")
    pgm_path = os.path.join(OUT, "zoom_oracle.pgm")
    stats_path = os.path.join(OUT, "zoom_oracle.json")
    args = ["-w", "1000", "-h", "1000", *ZOOM, "--engine", "oracle",
            "--passes", str(ORACLE_PASSES), "-t", "-1", "-o", pgm_path,
            "--stats-json", stats_path]
    t0 = time.monotonic()
    ostats, _ = run_cli(args, stats_path)
    log(f"  oracle: {ORACLE_PASSES} passes in {time.monotonic() - t0:.1f} s; "
        f"stats {json.dumps(ostats)}")
    check(ostats["engine"] == "oracle" and ostats["device"].startswith("cuda"),
          "oracle rendered on the card")
    img = pgm.read_pgm(pgm_path)
    check(img.shape == (1000, 1000) and img.dtype == np.uint16,
          "oracle: valid 1000x1000 PGM")
    lanes = cell_config("zoom").options.lane_rows * 128
    e_band = zoom_stats["in_band"] / (zoom_stats["samples"] - lanes)
    o_band = ostats["in_band"] / ostats["samples"]
    e_mass = zoom_stats["orbit_points"] / max(zoom_stats["emitted"], 1)
    o_mass = ostats["orbit_points"] / max(ostats["in_band"], 1)
    log(f"  in-band fraction: df32 engine {e_band:.5f}, f64 oracle "
        f"{o_band:.5f} (ratio {e_band / o_band:.4f}); orbit points per "
        f"emission: {e_mass:.1f} vs {o_mass:.1f} (ratio "
        f"{e_mass / o_mass:.4f})")
    check(abs(e_band / o_band - 1) < 0.15,
          "zoom: in-band fraction within 15% of the float64 oracle")
    check(abs(e_mass / o_mass - 1) < 0.15,
          "zoom: orbit points per emission within 15% of the oracle")


def block_map(hist, blocks: int = 8):
    """A histogram summed over blocks x blocks tiles, normalized to 1."""
    import numpy as np

    h, w = hist.shape
    x = hist.astype(np.float64).reshape(
        blocks, h // blocks, blocks, w // blocks).sum(axis=(1, 3))
    return x / x.sum()


def phase_mh_measure():
    """mhzoom's measure against uniform sampling of the identical
    configuration (the JAX bench's comparator: --precision extended
    --emit-filter canvas over the same domain 8x the window), two seeds of
    each, by the null-calibrated statistic of the package's MH tests at
    8x8 blocks of 125 pixels: the correlation of the two-seed averages must
    reach the smaller of the two self-correlations less 0.05 (two unbiased
    estimators with independent noise exceed it; a bias common to one
    estimator's seeds caps it below), a floor of 0.6, and the MH mass of
    the uniform render's brighter half within 10% of the uniform mass
    there. Prints the deposited mass per second of both and their ratio
    (reported, not checked)."""
    import numpy as np

    log("== phase 4c: mhzoom against uniform sampling of the same window")
    cfg = cell_config("mhzoom")
    cv = cfg.canvas
    geometry = [
        "-w", "1000", "-h", "1000", "-m", "20000", "-c", "500",
        "--precision", "extended",
        "--min-real", repr(cv.min_real), "--max-real", repr(cv.max_real),
        "--min-imag", repr(cv.min_imag), "--max-imag", repr(cv.max_imag),
        "--sample-domain", ",".join(repr(v) for v in cfg.sample_domain)]
    runs = {"mh": (["--sampler", "mh", "--mh-burnin",
                    str(MH_MEASURE_BURNIN)], MH_MEASURE_PASSES),
            "uniform": (["--emit-filter", "canvas"], UNIFORM_MEASURE_PASSES)}
    maps, rates = {}, {}
    for kind, (extra, passes) in runs.items():
        maps[kind], mass, seconds = [], 0.0, 0.0
        for seed in MEASURE_SEEDS:
            ckpt_path = os.path.join(OUT, f"measure_{kind}_{seed}.ckpt")
            stats_path = os.path.join(OUT, f"measure_{kind}_{seed}.json")
            if os.path.exists(ckpt_path):
                os.remove(ckpt_path)
            args = [*geometry, *extra, "--seed", str(seed), "--passes",
                    str(passes), "-t", "-1", "-s", ckpt_path, "-o",
                    os.path.join(OUT, f"measure_{kind}_{seed}.pgm"),
                    "--stats-json", stats_path]
            stats, _ = run_cli(args, stats_path)
            hist = np.load(ckpt_path)["hist"]
            check(int(hist.sum(dtype=np.uint64)) == stats["on_canvas_points"]
                  > 0 and stats["replay_dropped"] <= 0.01 * stats["in_band"],
                  f"{kind} seed {seed}: histogram == on_canvas_points "
                  f"({stats['on_canvas_points']}), drops "
                  f"{stats['replay_dropped']} <= 1% of in-band")
            maps[kind].append(block_map(hist))
            mass += stats["on_canvas_points"] / stats.get("weight_scale", 1)
            seconds += stats["elapsed_seconds"]
        rates[kind] = mass / seconds

    def corr(a, b):
        return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])

    self_mh, self_un = corr(*maps["mh"]), corr(*maps["uniform"])
    avg_mh = (maps["mh"][0] + maps["mh"][1]) / 2
    avg_un = (maps["uniform"][0] + maps["uniform"][1]) / 2
    cross = corr(avg_mh, avg_un)
    bright = avg_un > np.median(avg_un)
    ratio = float(avg_mh[bright].sum() / avg_un[bright].sum())
    log(f"  block correlation: MH seed against seed {self_mh:.4f}, uniform "
        f"seed against seed {self_un:.4f}, MH average against uniform "
        f"average {cross:.4f}; bright-half mass ratio {ratio:.4f}")
    log(f"  deposited mass/s (orbit-point units; MH passes include "
        f"{MH_MEASURE_BURNIN} of burn-in): MH {rates['mh']:.4e}, uniform "
        f"{rates['uniform']:.4e}, ratio {rates['mh'] / rates['uniform']:.2f}")
    check(cross > min(self_mh, self_un) - 0.05 and cross > 0.6,
          "mhzoom: MH and uniform block maps agree (null-calibrated)")
    check(abs(ratio - 1) < 0.1, "mhzoom: bright-half mass ratio within 10%")


#: Device-activity groups of the profile: kernel-name substring -> group.
PROFILE_GROUPS = (("classify_ext_mh_kernel", "classify_ext_mh"),
                  ("classify_mh_kernel", "classify_mh"),
                  ("mh_deposit_kernel", "mh_deposit"),
                  ("classify_ext_kernel", "classify_ext"),
                  ("classify_kernel", "classify"),
                  ("threefry_bits", "threefry_bits"),
                  ("length_sort", "length_sort"),
                  ("replay_deposit_ext", "replay_deposit_ext"),
                  ("replay_deposit", "replay_deposit"),
                  ("replay_ids_ext", "replay_ids_ext"),
                  ("replay_ids", "replay_ids"),
                  ("bigtiles_deposit", "bigtiles_deposit"))
#: The bigtiles cells' profiles also group torch.sort's radix-sort kernels
#: (the compaction's two sorts and, on the bigtiles route, the id sort).
SORT_GROUP = (("RadixSort", "sort"),)


def device_profile(eng, state, first_pass: int, passes: int,
                   groups=PROFILE_GROUPS):
    """Where the device time of ``passes`` engine passes goes (synchronizing
    every 8, as the driver does), from torch.profiler's device activity:
    ms per pass of each main-path kernel and of all other device work
    (sorts, gathers, sums, memsets), and the busy share -- the union of
    device activity over the span from its first start to its last end.
    Returns (busy, span_ms, ms_per_pass), or (None, reason, None) when the
    profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    trace = os.path.join(OUT, "profile_trace.json")
    eng.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for p in range(passes):
                eng.run_pass(state, first_pass + p)
                if (p + 1) % 8 == 0:
                    eng.synchronize()
            eng.synchronize()
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f).get("traceEvents", [])
    except Exception as e:  # noqa: BLE001 -- a measurement, not a check
        return None, f"profiler failed: {e!r}", None
    finally:
        if os.path.exists(trace):
            os.remove(trace)
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memset", "gpu_memcpy")]
    if not device:
        return None, "the profiler recorded no device activity", None
    ms = {g: 0.0 for _, g in groups}
    ms["other"] = 0.0
    for e in device:
        group = next((g for sub, g in groups
                      if sub in e.get("name", "")), "other")
        ms[group] += float(e.get("dur", 0.0)) / 1e3 / passes
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in device)
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo = s
        hi = max(hi, e)
    busy += hi - lo
    span = hi - spans[0][0]
    return busy / span, span / 1e3, ms


def canvas_ids(cr, ci, it, canvas, fractal):
    """The replay batch's on-canvas bin ids as one stream: what the JAX
    engine's batched replay materializes before its scatter."""
    import torch

    from cudabrot_tpu_torch.ops.binning import orbit_bins

    return torch.cat([ids[ids < canvas.num_pixels] for _, ids in orbit_bins(
        cr, ci, it, canvas=canvas, fractal=fractal)])


def cell_times(dev, name, with_plain):
    """Each main-path kernel at one cell's main-path shapes (CUDA events,
    from a lane state carried over some passes), a whole engine pass, and
    the device's busy share. ``with_plain`` adds the plain versions and the
    library calls (the default cell; they take seconds at full width)."""
    import torch

    from cudabrot_tpu_torch.engines import cuda_engine as ce
    from cudabrot_tpu_torch.ops import binning, prng
    from cudabrot_tpu_torch.ops import classify as cls
    from cudabrot_tpu_torch.ops import classify_ext as cx

    log(f"== kernel times at the {name} cell's main-path shapes")
    cfg = cell_config(name)
    eng = ce.CudaEngine(cfg, device=dev)
    tn, ext = eng.tuning, eng.extended
    state = eng.init_state(None)
    warm_passes = 8 if ext else 4
    for p in range(warm_passes):
        eng.run_pass(state, p)
    spec = dict(
        fractal=eng.fractal, min_it=tn.min_it, max_it=tn.max_it,
        steps_per_pass=tn.steps_per_pass, steps_per_flush=tn.steps_per_flush,
        cycle_detection=True, inner_unroll=tn.inner_unroll,
        sample_domain=cfg.sample_domain,
    )
    if ext:
        classify, k1, k2 = cx.classify_pass_ext, "classify_ext", \
            "replay_deposit_ext"
        c_inner, c_boundary, c_draw, c_point = (
            OPS_STEP_EXT, OPS_BOUNDARY_EXT, OPS_FINISH_EXT,
            OPS_REPLAY_POINT_EXT)
    else:
        classify, k1, k2 = cls.classify_pass, "classify", "replay_deposit"
        spec["thin_tracking"] = tn.thin_tracking
        c_inner, c_boundary, c_draw, c_point = (
            OPS_STEP, OPS_BOUNDARY, OPS_DRAW, OPS_REPLAY_POINT)
    lanes = state["lanes"]
    key = prng.pass_key(cfg.seed, 0, warm_passes + 1)
    seed = prng.bits_host(key, 2)
    res = classify(clone_state(lanes), seed, **spec)
    k1_ms = time_ms(lambda: classify(lanes, seed, **spec), 10)
    n_lanes = eng.lanes
    lane_steps = tn.steps_per_pass * n_lanes
    windows = lane_steps // tn.inner_unroll
    draws = int(res.stats[cls.STAT_DRAWN].sum())
    slots = tn.emission_slots
    state_words = len(lanes)
    k1_bound, k1_by, k1_floor = op_bounds(
        ((c_inner, lane_steps), (c_boundary, windows), (c_draw, draws)),
        n_lanes * (2 * 4 * state_words + 20) + slots * 12)

    cr, ci, it, _ = ce.compact(res.emit_c, res.emit_it, key,
                               tn.replay_capacity, tn.max_it)
    hist = torch.zeros(cfg.canvas.num_pixels, dtype=torch.int32, device=dev)
    fr = eng.fractal
    if ext:
        def replay(h=hist):
            return binning.replay_deposit_ext(
                h, cr, ci, it, canvas=cfg.canvas, fractal=fr,
                sample_domain=cfg.sample_domain)
    else:
        def replay(h=hist):
            return binning.replay_deposit(h, cr, ci, it, canvas=cfg.canvas,
                                          fractal=fr)
    k2_ms = time_ms(replay, 10)
    orbits = int((it >= 0).sum())
    points = int(torch.where(it >= 0, it + 1, 0).sum())
    k2_bound, k2_by, k2_floor = op_bounds(
        ((c_point, points),), 12 * cr.numel() + 8 * cfg.canvas.num_pixels)

    sel_key = prng.fold_in(key, 0x7711)
    k3_ms = time_ms(lambda: prng.bits(sel_key, slots, dev), 20)
    k3_bound, k3_by = bound_ms(OPS_THREEFRY_WORD[0] * slots, 8 * slots,
                               OPS_THREEFRY_WORD[1] * slots)
    t_compact = time_ms(lambda: ce.compact(res.emit_c, res.emit_it, key,
                                           tn.replay_capacity, tn.max_it), 5)
    sort_rec = None
    if eng.compact_route == "length":
        from cudabrot_tpu_torch.ops import length_sort as ls

        def sort():
            return ls.length_sort(res.emit_c, res.emit_it, tn.min_it,
                                  tn.max_it)

        # The kernels against the plain version on this pass's emissions,
        # at the main path's slot count, band and tile size.
        nb = ls.buckets(tn.min_it, tn.max_it)
        got = sort()
        want = ls.length_sort_plain(res.emit_c, res.emit_it, tn.min_it,
                                    tn.max_it)
        kept = int(got[3])
        check(all(same_bits(a, b) for a, b in zip(got, want)),
              f"length_sort at the {name} cell: {kept} of {slots} slots "
              f"kept, {nb} buckets, tiles of 2^{ls.tile_bits(slots, nb)}, "
              f"bitwise vs plain")
        del got, want
        k4_ms = time_ms(sort, 20)
        # The escape indices read once, the kept words once, the batch
        # written once (csrc/length_sort.cu).
        k4_bound, k4_by = bound_ms(0, 4 * slots + 12 * kept + 12 * slots)
        sort_rec = dict(ms=k4_ms, bound_ms=k4_bound, bound_by=k4_by,
                        library_ms=t_compact)
        log(f"  length_sort: {slots} slots, {kept} kept, {nb} buckets, "
            f"tiles of 2^{ls.tile_bits(slots, nb)}, bitwise equal to the "
            f"plain version; kernels {k4_ms:.4f} ms, bound {k4_bound:.4f} "
            f"ms ({k4_by}); the selection it replaces (compact) "
            f"{t_compact:.4f} ms")
    pass_time = pass_ms(eng, state, warm_passes + 2, 10)
    busy, span, prof_ms = device_profile(eng, state, 100, 16)

    log(f"  geometry: {n_lanes} lanes, {tn.steps_per_pass} steps per pass, "
        f"flush {tn.steps_per_flush}, U={tn.inner_unroll}, capacity "
        f"{tn.replay_capacity}")
    log(f"  {k1}: {lane_steps} lane-steps, {draws} draws; kernel "
        f"{k1_ms:.4f} ms, bound {k1_bound:.4f} ms ({k1_by})")
    log(f"  {k2}: {orbits} orbits, {points} points; kernel "
        f"{k2_ms:.4f} ms, bound {k2_bound:.4f} ms ({k2_by})")
    log(f"  threefry_bits: {slots} words; kernel {k3_ms:.4f} ms, bound "
        f"{k3_bound:.4f} ms ({k3_by}); whole compaction {t_compact:.4f} ms")
    log(f"  {name} pass (CUDA events, 10 passes): {pass_time:.4f} ms")
    if busy is None:
        log(f"  {name} device profile: not measured ({span})")
    else:
        parts = ", ".join(f"{g} {v:.4f}" for g, v in prof_ms.items() if v)
        log(f"  {name} device profile of 16 passes (torch.profiler): ms per "
            f"pass {parts}; busy {busy:.4f} of a {span:.3f} ms span "
            f"(idle {1 - busy:.4f})")

    rec = {
        k1: dict(ms=k1_ms, bound_ms=k1_bound, bound_by=k1_by,
                 library_ms=None, floor_ms=k1_floor),
        "threefry_bits": dict(ms=k3_ms, bound_ms=k3_bound, bound_by=k3_by,
                              library_ms=None),
        k2: dict(ms=k2_ms, bound_ms=k2_bound, bound_by=k2_by,
                 library_ms=None, floor_ms=k2_floor),
    }
    if sort_rec is not None:
        rec["length_sort"] = sort_rec
    if not with_plain:
        return rec
    plain_state = clone_state(lanes)
    args = dict(
        fractal=eng.fractal, min_it=tn.min_it, max_it=tn.max_it,
        chunks=tn.steps_per_pass // tn.steps_per_flush,
        windows=tn.steps_per_flush // tn.inner_unroll,
        unroll=tn.inner_unroll, thin=tn.thin_tracking, detect=True,
        sample_domain=cfg.sample_domain, visit_window=None,
    )
    rec[k1]["plain_ms"] = time_ms(
        lambda: cls.classify_pass_plain(plain_state, *seed, None, **args), 1)
    rec[k2]["plain_ms"] = time_ms(
        lambda: binning.replay_deposit_plain(
            hist, cr, ci, it, canvas=cfg.canvas, fractal=fr), 1)
    rec["threefry_bits"]["plain_ms"] = time_ms(
        lambda: prng.bits_plain(sel_key, slots, dev), 5)
    if sort_rec is not None:
        sort_rec["plain_ms"] = time_ms(lambda: ls.length_sort_plain(
            res.emit_c, res.emit_it, tn.min_it, tn.max_it), 5)
    log(f"  plain versions: classify {rec[k1]['plain_ms']:.4f} ms, "
        f"replay_deposit {rec[k2]['plain_ms']:.4f} ms, "
        f"threefry_bits {rec['threefry_bits']['plain_ms']:.4f} ms")

    # The batch's id stream, materialized, through the library's counting
    # call and through deposit_ids: the deposit half of replay_deposit.
    ids = canvas_ids(cr, ci, it, cfg.canvas, fr)
    nbins = cfg.canvas.num_pixels
    hk = torch.zeros(nbins, dtype=torch.int32, device=dev)
    replay(hk)
    check(torch.equal(torch.bincount(ids, minlength=nbins),
                      hk.to(torch.int64)),
          f"{name}: bincount of the replay's id stream == replay_deposit")
    lib_ms = time_ms(lambda: torch.bincount(ids, minlength=nbins), 5)
    ids_ms = time_ms(lambda: binning.deposit_ids(hist, ids), 10)
    log(f"  the replay batch's {ids.numel()} on-canvas ids, materialized: "
        f"torch.bincount {lib_ms:.4f} ms, deposit_ids {ids_ms:.4f} ms "
        f"(replay_deposit replays and deposits them in {k2_ms:.4f} ms)")
    return rec


def mh_cell_times(dev, name, rate):
    """The two kernels of an MH cell at its main-path shapes (CUDA events,
    from a lane state carried over some passes): the chain kernel and
    mh_deposit on that pass's emission buffers as the engine calls it (its
    bound counts the pairs at ``rate``, deposit_ids' atomics per ms): its
    kernel time from torch.profiler (the call must be one launch) and the
    host time of the call, the deposit's plain version and index_add_ of
    its materialized (bin, weight) pairs (device time), a one-id
    deposit_ids launch (the floor a deposit this small is up against), a
    whole engine pass, and the device's busy share."""
    import torch

    from cudabrot_tpu_torch.engines import cuda_engine as ce
    from cudabrot_tpu_torch.ops import binning, prng
    from cudabrot_tpu_torch.ops import classify_mh as cmh

    log(f"== kernel times at the {name} cell's main-path shapes")
    cfg = cell_config(name)
    eng = ce.CudaEngine(cfg, device=dev)
    tn, ext, slots = eng.tuning, eng.extended, eng.visit_slots
    state = eng.init_state(None)
    warm_passes = 6
    for p in range(warm_passes):
        eng.run_pass(state, p)
    k1 = "classify_ext_mh" if ext else "classify_mh"
    classify = cmh.classify_pass_ext_mh if ext else cmh.classify_pass_mh
    spec = eng.mh_pass_spec()
    lanes = state["lanes"]
    seed = prng.bits_host(prng.pass_key(cfg.seed, 0, warm_passes + 1), 2)
    res = classify(clone_state(lanes), seed, **spec)
    k1_ms = time_ms(lambda: classify(lanes, seed, **spec), 5)
    n_lanes = eng.lanes
    lane_steps = tn.steps_per_pass * n_lanes
    windows = lane_steps // tn.inner_unroll
    st = res.stats.reshape(cmh.MH_STATS_ROWS, -1).sum(dim=1)
    draws = int(st[0])
    n_slots = tn.emission_slots
    if ext:
        c_inner, c_boundary = OPS_STEP_MH_EXT, OPS_BOUNDARY_MH_EXT
    else:
        c_inner, c_boundary = ((c, 0, 0) for c in ce.step_ops(False, True))
    c_draw = OPS_DRAW_MH_EXT if ext else OPS_DRAW_MH
    state_words = len(lanes) - 2 + 2 * slots
    k1_bound, k1_by, k1_floor = op_bounds(
        ((c_inner, lane_steps), (c_boundary, windows), (c_draw, draws)),
        n_lanes * (2 * 4 * state_words + 4 * cmh.MH_STATS_ROWS)
        + n_slots * (3 + slots) * 4)

    nbins = cfg.canvas.num_pixels
    # A launch this short is bound by the host's enqueue under CUDA events
    # around back-to-back calls: its time is the profiler's kernel time.
    deposit = mh_deposit_step(state, res)
    k2_events = time_ms(deposit, 10)
    k2_call = host_ms(deposit, 50)
    got = profile_calls(deposit, 20)
    check(not isinstance(got, str)
          and got["per_call"] <= 1.0 and len(got["names"]) == 1
          and "mh_deposit_kernel" in got["names"][0],
          f"{name}: the profiler traced the engine's deposit step as one "
          f"launch ({got if isinstance(got, str) else got['names']})")
    k2_ms = got["ms_each"]
    prof = mh_profile(res, nbins)
    t = torch.where(res.emit_it >= 0, res.emit_v, 0)
    bins_c, t_c, rep_c = mh_batch(res, t)
    hp = torch.zeros(nbins, dtype=torch.int32, device=dev)
    k2_plain = time_ms(lambda: binning.mh_scatter(hp, bins_c, t_c, rep_c), 3)
    idx, w, _ = mh_pairs(bins_c, t_c, rep_c, nbins)
    got = profile_calls(lambda: hp.index_add_(0, idx, w), 20)
    check(not isinstance(got, str),
          f"{name}: the profiler traced index_add_ ({got})")
    k2_lib = got["ms_per_call"]
    k2_bound, k2_by = mh_deposit_bound(prof, rate)
    # The cost of the smallest launch through the same binding: one id.
    one_id = torch.zeros(1, dtype=torch.int32, device=dev)
    launch_ms = time_ms(lambda: binning.deposit_ids(hp, one_id), 50)

    pass_time = pass_ms(eng, state, warm_passes + 2, 5)
    busy, span, prof_ms = device_profile(eng, state, 100, 8 if ext else 16)

    log(f"  geometry: {n_lanes} lanes, {tn.steps_per_pass} steps per pass, "
        f"flush {tn.steps_per_flush}, U={tn.inner_unroll}, V={slots}, "
        f"capacity {tn.replay_capacity}")
    log(f"  {k1}: {lane_steps} lane-steps, {draws} proposals resolved, "
        f"{int(st[cmh.STAT_MH_ACCEPT])} accepted; kernel {k1_ms:.4f} ms, "
        f"bound {k1_bound:.4f} ms ({k1_by})")
    log(f"  mh_deposit: {prof['emissions']} emissions of {prof['slots']} "
        f"slots, {prof['pairs']} (bin, weight) pairs in {prof['groups']} "
        f"warp groups, {prof['distinct']} distinct (group, bin); kernel "
        f"{k2_ms:.4f} device ms (torch.profiler, 20 calls), "
        f"{k2_events:.4f} ms a call under CUDA events, {k2_call:.4f} ms a "
        f"call with a synchronize (host clock); bound {k2_bound:.4f} ms "
        f"({k2_by}: {rate:.4e} atomics per ms), plain version "
        f"{k2_plain:.4f} ms, index_add_ of the materialized pairs "
        f"{k2_lib:.4f} device ms, a one-id deposit_ids launch "
        f"{launch_ms:.4f} ms")
    log(f"  {name} pass (CUDA events, 5 passes): {pass_time:.4f} ms")
    if busy is None:
        log(f"  {name} device profile: not measured ({span})")
    else:
        parts = ", ".join(f"{g} {v:.4f}" for g, v in prof_ms.items() if v)
        log(f"  {name} device profile (torch.profiler): ms per pass {parts}; "
            f"busy {busy:.4f} of a {span:.3f} ms span (idle {1 - busy:.4f})")
    rec = {
        k1: dict(ms=k1_ms, bound_ms=k1_bound, bound_by=k1_by,
                 library_ms=None, floor_ms=k1_floor),
        "mh_deposit": dict(ms=k2_ms, bound_ms=k2_bound, bound_by=k2_by,
                           plain_ms=k2_plain, library_ms=k2_lib),
    }
    return rec



#: The plans pass_counters is timed at in phase 5: canvas1k.default's and
#: hires15k.coarse's band (the counters' inputs do not depend on the
#: canvas).
COUNTER_PLANS = {"default": [], "coarse": ["-m", "500", "-c", "20"]}


def old_counters(stats, n_valid, iters, totals, steps_per_pass, capacity):
    """The counters as the engine added them before pass_counters: about
    seventeen PyTorch launches, the points summed over the whole batch."""
    import torch

    from cudabrot_tpu_torch.ops import classify as cls

    st = stats.reshape(cls.STATS_ROWS, -1).sum(dim=1)
    wasted = st[cls.STAT_WASTED]
    emitted = torch.clamp(n_valid, max=capacity)
    for k, v in (
        ("samples", st[cls.STAT_DRAWN]),
        ("culled", st[cls.STAT_CULLED]),
        ("in_band", st[cls.STAT_IN_BAND]),
        ("cycles", st[cls.STAT_CYCLES]),
        ("wasted", wasted),
        ("iters", steps_per_pass - wasted),
        ("emitted", emitted),
        ("replay_dropped", n_valid - emitted),
    ):
        totals[k] += v
    totals["points"] += torch.where(iters >= 0, iters + 1, 0).sum()


def counters_times(dev, name, with_plain):
    """pass_counters at a plan of COUNTER_PLANS, on a pass's stat rows and
    its compaction's own batch (from lanes carried 4 passes): bitwise
    against the plain version, which reads the kept prefix, and against
    old_counters, which reads the whole batch (library_ms); the kernel's
    device ms alone (torch.profiler) and by CUDA events over back-to-back
    calls, beside its byte bound and old_counters' device ms."""
    from cudabrot_tpu_torch import cli
    from cudabrot_tpu_torch.engines import cuda_engine as ce
    from cudabrot_tpu_torch.ops import length_sort as ls
    from cudabrot_tpu_torch.ops import pass_counters as pc
    from cudabrot_tpu_torch.utils import counters

    cfg = cli.parse_args(["-w", "1000", "-h", "1000",
                          *COUNTER_PLANS[name]])[0]
    eng = ce.CudaEngine(cfg, device=dev)
    tn = eng.tuning
    state = eng.init_state(None)
    for p in range(4):
        eng.run_pass(state, p)
    eng.synchronize()
    res = eng.classify(state, 4)
    if eng.compact_route == "length":
        _, _, it, n_valid = ls.length_sort(res.emit_c, res.emit_it,
                                           tn.min_it, tn.max_it)
    else:
        _, _, it, n_valid = ce.compact(
            res.emit_c, res.emit_it, (5, 6), tn.replay_capacity, tn.max_it)
    kw = dict(steps_per_pass=eng.steps_per_pass,
              capacity=eng.replay_capacity)
    runs = {}
    for tag, fn in (("kernel", pc.pass_counters),
                    ("plain", pc.pass_counters_plain),
                    ("old", old_counters)):
        tot = counters.zeros(dev)
        fn(res.stats, n_valid, it, tot, **kw)
        runs[tag] = tot
    err = max_abs_err((runs["kernel"][k], runs[ref][k])
                      for ref in ("plain", "old") for k in pc.TOTALS)
    kept = pc.prefix_bound(it.numel(), int(n_valid), eng.replay_capacity)
    check(all(same_bits(runs["kernel"][k], runs[ref][k])
              for ref in ("plain", "old") for k in pc.TOTALS),
          f"pass_counters at the {name} plan: {kept} of {it.numel()} slots "
          f"read, totals bitwise equal to the plain version and the old "
          f"expression")
    tot = counters.zeros(dev)

    def kernel():
        pc.pass_counters(res.stats, n_valid, it, tot, **kw)

    def old():
        old_counters(res.stats, n_valid, it, tot, **kw)

    prof = profile_calls(kernel, 50, only="pass_counters")
    prof_old = profile_calls(old, 20)
    events_ms = time_ms(kernel, 50)
    old_events_ms = time_ms(old, 20)
    ms = prof["ms_each"] if isinstance(prof, dict) else events_ms
    old_ms = (prof_old["ms_per_call"] if isinstance(prof_old, dict)
              else old_events_ms)
    # The stat rows and the read prefix of the batch, each word once.
    bound, by = bound_ms(0, 4 * res.stats.numel() + 4 * kept)
    how = "profiler" if isinstance(prof, dict) else f"events: {prof}"
    launched = (prof_old["per_call"] if isinstance(prof_old, dict)
                else prof_old)
    log(f"  pass_counters at the {name} plan: {res.stats.numel()} stat "
        f"words, {kept} of {it.numel()} batch slots read; kernel "
        f"{ms:.4f} ms device ({how}), {events_ms:.4f} ms a call by events "
        f"over 50 calls; bound {bound:.4f} ms ({by}); the old expression "
        f"{old_ms:.4f} ms device a pass ({launched} activities a pass), "
        f"{old_events_ms:.4f} ms by events")
    rec = dict(ms=ms, bound_ms=bound, bound_by=by, library_ms=old_ms,
               max_abs_err=err, events_ms=events_ms, kept=kept)
    if with_plain:
        rec["plain_ms"] = time_ms(
            lambda: pc.pass_counters_plain(res.stats, n_valid, it, tot,
                                           **kw), 5)
    return rec


def phase_kernel_times(dev, rate):
    """Phase 5: the SASS counts that OPS_STEP, OPS_BOUNDARY and OPS_DRAW
    rest on (sass_study), then every cell's kernel times at its main-path
    shapes, by cell and kernel, and pass_counters at COUNTER_PLANS.
    ``rate``: the histogram atomics per ms deposit_ids reaches on phase 3's
    1000x1000 stream."""
    sass_study()
    times = {name: (mh_cell_times(dev, name, rate) if "--sampler" in args
                    else cell_times(dev, name, name == "default"))
             for name, args, _ in CELLS}
    times.update({name: big_cell_times(dev, name, name == "bigcanvas")
                  for name, _, _ in BIG_CELLS})
    counter_recs = {name: counters_times(dev, name, name == "default")
                    for name in COUNTER_PLANS}
    log(f"pass_counters records: {json.dumps(counter_recs)}")
    times["default"]["pass_counters"] = counter_recs["default"]
    return times


def kernel_records(times, main_runs, errs, ext_records, deposit_ids):
    """One record per hand-written kernel. Times are phase 5's at the
    shapes of the cell that KERNELS names (the other cells' are printed),
    launches from that cell's main-path run (the bigtiles route's, at the
    bigtiles cells); deposit_ids carries phase 3c's record on the default
    cell's --scatter pallas stream and the launches of that route's run
    (phase 13). plain_ms of the three df32 kernels comes from phases 2, 3
    and 3b, which ran their plain versions at the zoom cell's shapes, and
    those of the two MH classify kernels at one whole pass of their
    cells."""
    records = []
    for k, (source, replaces, cell) in KERNELS.items():
        if k == "deposit_ids":
            body = dict(launches=main_runs[cell][1][k], **deposit_ids)
        else:
            body = dict(launches=main_runs[cell][1][k], **times[cell][k])
            body.update(ext_records.get(k, {}))
            body.setdefault("max_abs_err", errs.get(k))
        records.append(dict(name=k, route="cuda", source=source,
                            replaces=replaces, **body))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for r in records:
        check(all(key in r for key in keys)
              and all(r[key] is not None for key in keys[:-1]),
              f"kernel record of {r['name']} is complete")
        if "floor_ms" in r:
            floor = r["floor_ms"]
            log(f"  {r['name']}: unfused issue floor {floor:.4f} ms "
                f"(operations / {PEAK_ISSUE:.3g}, the ALU's / "
                f"{PEAK_INT:.3g}); kernel {r['ms']:.4f} ms, "
                f"{floor / r['ms']:.3f} of it")
    return [{key: r[key] for key in keys} for r in records]


# ----------------------------------------------------------------------
# The bigtiles route (--scatter bigtiles).


def id_offsets(it):
    """(off, n): each kept emission's first slot in its id stream and the
    stream's length."""
    from cudabrot_tpu_torch.ops import binning

    off, ends = binning.id_offsets(it)
    return off, int(ends[-1]) if ends.numel() else 0


def sorted_streams(dev, nbins, replay_ids):
    """The bigtiles deposit's check streams, sorted: 2^24 random ids with
    10% sentinels, 2^24 ids clustered in the first 1/50 of the bins, one
    id repeated over three chunks and a bit, and a real replay's ids."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(nbins % 9973)
    n = 1 << 24
    rnd = torch.randint(0, nbins, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    rnd[torch.rand(n, generator=gen, device=dev) < 0.1] = nbins
    clustered = torch.randint(0, nbins // 50, (n,), generator=gen,
                              device=dev, dtype=torch.int32)
    repeated = torch.full((3 * 8192 + 17,), nbins // 3, dtype=torch.int32,
                          device=dev)
    return {name: torch.sort(x).values for name, x in (
        ("random", rnd), ("clustered", clustered), ("repeated", repeated),
        ("replay", replay_ids))}


def phase_bigtiles_kernels(dev, batches, ext_res, ext_tn, ext_cfg):
    """The bigtiles route's three kernels against their plain versions,
    bitwise: replay_ids on phase 2's default-band batch (6000x4500
    canvas), bigtiles_deposit on the four sorted streams at 1000x1000,
    6000x4500 and 20000x20000 (the replay stream also against the fused
    replay_deposit's histogram), replay_ids_ext on phase 2's df32 batch
    (the bigzoom canvas). Returns ({kernel: max_abs_err}, the plain
    replay_ids_ext's ms on that batch)."""
    import torch

    from cudabrot_tpu_torch.config import Canvas
    from cudabrot_tpu_torch.engines.cuda_engine import compact
    from cudabrot_tpu_torch.models.fractals import get_fractal
    from cudabrot_tpu_torch.ops import binning

    log("== phase 3b: bigtiles route kernels vs plain, bitwise")
    fr = get_fractal("buddhabrot")
    res, tn = batches[(20, 100)]
    cr, ci, it, _ = compact(res.emit_c, res.emit_it, (1, 2),
                            tn.replay_capacity, tn.max_it)
    off, n = id_offsets(it)
    errs = {"bigtiles_deposit": 0.0}
    for canvas in (Canvas(), cell_config("bigcanvas").canvas,
                   cell_config("northstar").canvas):
        tag = f"{canvas.width}x{canvas.height}"
        nbins = canvas.num_pixels
        kw = dict(canvas=canvas, fractal=fr)
        ids_k, hits_k = binning.replay_ids(cr, ci, it, off, n, **kw)
        if canvas == cell_config("bigcanvas").canvas:
            ids_p, hits_p = binning.replay_ids_plain(cr, ci, it, off, n, **kw)
            check(torch.equal(ids_k, ids_p) and int(hits_k) == int(hits_p),
                  f"replay_ids {tag}: {n} ids, {int(hits_k)} on the canvas, "
                  f"bitwise vs plain")
            errs["replay_ids"] = max_abs_err([(ids_k, ids_p),
                                              (hits_k, hits_p)])
            del ids_p
        fused = torch.zeros(nbins, dtype=torch.int32, device=dev)
        hits_f = binning.replay_deposit(fused, cr, ci, it, **kw)
        for name, ids in sorted_streams(dev, nbins, ids_k).items():
            hk = torch.zeros(nbins, dtype=torch.int32, device=dev)
            hp = torch.zeros_like(hk)
            binning.bigtiles_deposit(hk, ids)
            binning.bigtiles_deposit_plain(hp, ids)
            what = f"bigtiles_deposit {tag}, {name} stream ({ids.numel()} ids)"
            check(torch.equal(hk, hp), f"{what}: bitwise vs plain")
            check(int(hk.sum(dtype=torch.int64))
                  == int(((ids >= 0) & (ids < nbins)).sum()),
                  f"{what}: every id below the sentinel counted")
            errs["bigtiles_deposit"] = max(errs["bigtiles_deposit"],
                                           max_abs_err([(hk, hp)]))
            if name == "replay":
                check(torch.equal(hk, fused) and int(hits_k) == int(hits_f),
                      f"{what}: == the fused replay_deposit's histogram")
            del hk, hp
        del fused, ids_k

    kr, ki, ite, _ = compact(ext_res.emit_c, ext_res.emit_it, (1, 2),
                             ext_tn.replay_capacity, ext_tn.max_it)
    ite[0] = FLOOR_STEPS - 1  # a 19,999-step orbit at the batch's head
    offe, ne = id_offsets(ite)
    canvas = cell_config("bigzoom").canvas
    kw = dict(canvas=canvas, fractal=fr, sample_domain=ext_cfg.sample_domain)
    ids_k, hits_k = binning.replay_ids_ext(kr, ki, ite, offe, ne, **kw)
    out = {}

    def plain():
        out["r"] = binning.replay_ids_ext_plain(kr, ki, ite, offe, ne, **kw)

    plain_ms = time_ms(plain, 1, warm=False)
    ids_p, hits_p = out["r"]
    check(torch.equal(ids_k, ids_p) and int(hits_k) == int(hits_p) > 0,
          f"replay_ids_ext: {ne} ids, {int(hits_k)} on the canvas, bitwise "
          f"vs plain ({plain_ms:.1f} ms)")
    errs["replay_ids_ext"] = max_abs_err([(ids_k, ids_p), (hits_k, hits_p)])
    fused = torch.zeros(canvas.num_pixels, dtype=torch.int32, device=dev)
    binning.replay_deposit_ext(fused, kr, ki, ite, **kw)
    hb = binning.bigtiles_deposit(torch.zeros_like(fused),
                                  torch.sort(ids_k).values)
    check(torch.equal(hb, fused),
          "replay_ids_ext -> sort -> bigtiles_deposit == replay_deposit_ext")
    return errs, plain_ms


def run_cli_capture(args, stats_path):
    """run_cli, keeping the histogram driver.run_render hands cli.main (no
    checkpoint is written at these sizes)."""
    from cudabrot_tpu_torch import driver

    real, box = driver.run_render, {}

    def keep(*a, **k):
        box["result"] = real(*a, **k)
        return box["result"]

    driver.run_render = keep
    try:
        stats, counts = run_cli(args, stats_path)
    finally:
        driver.run_render = real
    return stats, counts, box.pop("result").histogram


def phase_big_cells(dev):
    """The bigtiles cells through cli.main, each with --scatter bigtiles
    and with --scatter auto: a PGM of the right header and size (then
    deleted), histogram sum == on_canvas_points, drops <= 1% of in-band,
    the route's kernels launched and no plain version run; the two
    routes' histograms and stats equal bit for bit. Returns {cell:
    (stats, launch counts)} of the bigtiles runs."""
    import numpy as np
    import torch

    from cudabrot_tpu_torch.ops import launches

    log("== phase 6: the bigtiles cells through cudabrot_tpu_torch.cli.main")
    os.makedirs(OUT, exist_ok=True)
    results = {}
    for name, args, passes in BIG_CELLS:
        cv = cell_config(name).canvas
        runs = {}
        for scatter in ("bigtiles", "auto"):
            tag = f"{name} --scatter {scatter}"
            pgm_path = os.path.join(OUT, f"{name}_{scatter}.pgm")
            stats_path = os.path.join(OUT, f"{name}_{scatter}.json")
            torch.cuda.reset_peak_memory_stats(dev)
            stats, counts, hist = run_cli_capture(
                [*args, "--scatter", scatter, "--passes", str(passes), "-t",
                 "-1", "-o", pgm_path, "--stats-json", stats_path],
                stats_path)
            peak = torch.cuda.max_memory_allocated(dev)
            header = f"P5\n{cv.width} {cv.height}\n65535\n".encode()
            with open(pgm_path, "rb") as f:
                head = f.read(len(header))
            size = os.path.getsize(pgm_path)
            os.remove(pgm_path)
            check(head == header
                  and size == len(header) + 2 * cv.num_pixels,
                  f"{tag}: PGM header and size ({size} bytes)")
            check(hist.shape == (cv.height, cv.width)
                  and int(hist.sum(dtype=np.uint64))
                  == stats["on_canvas_points"] > 0,
                  f"{tag}: histogram sum == on_canvas_points "
                  f"({stats['on_canvas_points']})")
            check(stats["replay_dropped"] <= 0.01 * stats["in_band"],
                  f"{tag}: replay_dropped {stats['replay_dropped']} <= 1% "
                  f"of in_band {stats['in_band']}")
            for k in path_kernels(name, scatter):
                check(counts[k] > 0, f"{tag}: {k} kernel launched "
                      f"({counts[k]} times)")
            for k in launches.KERNELS:
                check(counts[f"{k}_plain"] == 0,
                      f"{tag}: plain version of {k} never ran")
            el = stats["elapsed_seconds"]
            lane_steps = stats["classify_iters"] + stats["wasted_steps"]
            log(f"  {tag}: {passes} passes in {el:.3f} s; "
                f"{lane_steps / el:.4e} classify lane-steps/s; "
                f"{stats['orbit_points'] / el:.4e} replayed orbit points/s; "
                f"{stats['on_canvas_points'] / el:.4e} deposited points/s; "
                f"peak device memory {peak / 2**20:.1f} MiB")
            runs[scatter] = (stats, counts, hist)
        (sb, cb, hb), (sa, _, ha) = runs["bigtiles"], runs["auto"]
        check(np.array_equal(hb, ha),
              f"{name}: the bigtiles route's histogram == the fused "
              f"route's, bit for bit")

        def same(st):
            return {k: v for k, v in st.items() if k != "elapsed_seconds"}

        check(same(sb) == same(sa), f"{name}: every stat equal between the "
              f"routes")
        log(f"  {name} stats: {json.dumps(sb)}")
        log(f"  {name}: sentinel share of the id stream "
            f"{1 - sb['on_canvas_points'] / sb['orbit_points']:.6f}; "
            f"elapsed bigtiles / auto {sb['elapsed_seconds'] / sa['elapsed_seconds']:.4f}")
        results[name] = (sb, cb)
        del runs, hb, ha
    return results


def big_cell_times(dev, name, with_plain):
    """A bigtiles cell at its main-path shapes, from a lane state carried
    over some passes: one pass's kept batch (cut to the id budget where it
    exceeds it) through replay_ids, torch.sort and bigtiles_deposit, the
    fused replay-deposit of the same batch, the deposit's plain version
    and index_add_ of ones at the unsorted ids; with ``with_plain`` the
    plain id replay. Then both routes' pass times (CUDA events) and device
    profiles: the bigtiles route's busy share against the fused route's
    shows what its one synchronization per pass costs."""
    import torch

    from cudabrot_tpu_torch.engines import cuda_engine as ce
    from cudabrot_tpu_torch.ops import binning, prng
    from cudabrot_tpu_torch.ops import classify as cls
    from cudabrot_tpu_torch.ops import classify_ext as cx

    log(f"== bigtiles route times at the {name} cell's main-path shapes")
    cfg = cell_config(name, "bigtiles")
    eng = ce.CudaEngine(cfg, device=dev)
    tn, ext = eng.tuning, eng.extended
    state = eng.init_state(None)
    warm = 8 if ext else 4
    for p in range(warm):
        eng.run_pass(state, p)
    spec = dict(fractal=eng.fractal, min_it=tn.min_it, max_it=tn.max_it,
                steps_per_pass=tn.steps_per_pass,
                steps_per_flush=tn.steps_per_flush, cycle_detection=True,
                inner_unroll=tn.inner_unroll,
                sample_domain=cfg.sample_domain)
    if ext:
        classify = cx.classify_pass_ext
    else:
        classify = cls.classify_pass
        spec["thin_tracking"] = tn.thin_tracking
    key = prng.pass_key(cfg.seed, 0, warm + 1)
    res = classify(clone_state(state["lanes"]), prng.bits_host(key, 2),
                   **spec)
    xr, xi, it, _ = ce.compact(res.emit_c, res.emit_it, key,
                               tn.replay_capacity, tn.max_it)
    del res
    off, n = id_offsets(it)
    if n > binning.BIGTILES_ID_BUDGET:
        ends = off + torch.clamp(it.to(torch.int64) + 1, min=0)
        k = int(torch.searchsorted(
            ends, torch.tensor(binning.BIGTILES_ID_BUDGET, device=dev),
            right=True))
        xr, xi, it, off, n = xr[:k], xi[:k], it[:k], off[:k], int(ends[k - 1])
    nbins = cfg.canvas.num_pixels
    kw = dict(canvas=cfg.canvas, fractal=eng.fractal)
    if ext:
        kw["sample_domain"] = cfg.sample_domain
    k_ids = "replay_ids_ext" if ext else "replay_ids"
    write = binning.replay_ids_ext if ext else binning.replay_ids
    fused = binning.replay_deposit_ext if ext else binning.replay_deposit
    out = {}

    def write_ids():
        out["ids"], out["hits"] = write(xr, xi, it, off, n, **kw)

    ids_ms = time_ms(write_ids, 5)
    ids = out["ids"]
    sort_ms = time_ms(lambda: torch.sort(ids), 5)
    sids = torch.sort(ids).values
    hist = torch.zeros(nbins, dtype=torch.int32, device=dev)
    dep_ms = time_ms(lambda: binning.bigtiles_deposit(hist, sids), 10)
    runs = torch.unique_consecutive(sids[sids < nbins]).numel()
    dep_bound, dep_by = bound_ms(0, 4 * n + 8 * runs)
    dep_plain = time_ms(lambda: binning.bigtiles_deposit_plain(hist, sids), 3)
    lib_hist = torch.zeros(nbins + 1, dtype=torch.int32, device=dev)
    ones = torch.ones(n, dtype=torch.int32, device=dev)
    lib_ms = time_ms(lambda: lib_hist.index_add_(0, ids, ones), 5)
    del lib_hist, ones
    fused_ms = time_ms(lambda: fused(hist, xr, xi, it, **kw), 5)
    c_point = OPS_REPLAY_POINT_EXT if ext else OPS_REPLAY_POINT
    ids_bound, ids_by, ids_floor = op_bounds(((c_point, n),),
                                             4 * n + 20 * xr.numel())
    on_canvas = int(out["hits"])
    log(f"  geometry: {eng.lanes} lanes, {tn.steps_per_pass} steps per "
        f"pass, capacity {tn.replay_capacity}, canvas {cfg.canvas.width}x"
        f"{cfg.canvas.height} ({nbins * 4 / 2**20:.1f} MiB)")
    log(f"  batch: {int((it >= 0).sum())} orbits, {n} ids, {on_canvas} on "
        f"the canvas (sentinel share {1 - on_canvas / n:.6f}), {runs} runs")
    log(f"  {k_ids}: kernel {ids_ms:.4f} ms, bound {ids_bound:.4f} ms "
        f"({ids_by})")
    log(f"  torch.sort of the {n} ids: {sort_ms:.4f} ms")
    log(f"  bigtiles_deposit: kernel {dep_ms:.4f} ms, bound {dep_bound:.4f} "
        f"ms ({dep_by}), plain version {dep_plain:.4f} ms, index_add_ of "
        f"ones at the unsorted ids {lib_ms:.4f} ms")
    log(f"  the whole bigtiles route for the batch "
        f"{ids_ms + sort_ms + dep_ms:.4f} ms; the fused "
        f"{'replay_deposit_ext' if ext else 'replay_deposit'} of the same "
        f"batch {fused_ms:.4f} ms")
    rec = {k_ids: dict(ms=ids_ms, bound_ms=ids_bound, bound_by=ids_by,
                       library_ms=None, floor_ms=ids_floor),
           "bigtiles_deposit": dict(ms=dep_ms, bound_ms=dep_bound,
                                    bound_by=dep_by, plain_ms=dep_plain,
                                    library_ms=lib_ms)}
    if with_plain:
        plain = binning.replay_ids_ext_plain if ext else \
            binning.replay_ids_plain
        rec[k_ids]["plain_ms"] = time_ms(
            lambda: plain(xr, xi, it, off, n, **kw), 1, warm=False)
        log(f"  {k_ids} plain version {rec[k_ids]['plain_ms']:.4f} ms")
    del ids, sids, hist, out

    fused_eng = ce.CudaEngine(cell_config(name), device=dev)
    fused_state = fused_eng.init_state(None)
    for p in range(warm):
        fused_eng.run_pass(fused_state, p)
    busy_of = {}
    for route, e, st in (("bigtiles", eng, state),
                         ("auto", fused_eng, fused_state)):
        pass_time = pass_ms(e, st, warm + 2, 5)
        busy, span, prof = device_profile(e, st, 100, 8,
                                          PROFILE_GROUPS + SORT_GROUP)
        log(f"  {name} --scatter {route} pass (CUDA events, 5 passes): "
            f"{pass_time:.4f} ms")
        if busy is None:
            log(f"  {name} --scatter {route} device profile: not measured "
                f"({span})")
            continue
        busy_of[route] = busy
        parts = ", ".join(f"{g} {v:.4f}" for g, v in prof.items() if v)
        log(f"  {name} --scatter {route} device profile of 8 passes "
            f"(torch.profiler): ms per pass {parts}; busy {busy:.4f} of a "
            f"{span:.3f} ms span (idle {1 - busy:.4f})")
    if len(busy_of) == 2:
        log(f"  {name}: idle share bigtiles {1 - busy_of['bigtiles']:.4f} "
            f"against fused {1 - busy_of['auto']:.4f}: the one "
            f"synchronization per pass costs "
            f"{busy_of['auto'] - busy_of['bigtiles']:.4f} of the span")
    return rec


# ----------------------------------------------------------------------
# deposit_ids on the id-stream routes' streams (phase 3c) and the routes
# through cli.main (phase 13).

#: The card's random-atomic ceiling (phase 3c), built from this source
#: beside the package (not part of it).
RED_CEILING_CU = r"""
// The card's random RED.ADD.U32 ceiling, built by chip_smoke.py beside the
// package (not part of it). The plain C launch function returns the
// cudaError_t of the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

// Random RED.ADD.U32 at full occupancy: each thread adds one at `per`
// addresses of its own LCG, spread uniformly over [0, n) by a
// multiply-high. Nothing is read back (RED, not ATOM).
__global__ void __launch_bounds__(kBlock)
    red_ceiling_kernel(uint32_t* buf, uint32_t n, int per, uint32_t seed) {
  uint32_t x = (blockIdx.x * blockDim.x + threadIdx.x) * 2654435761u ^ seed;
  for (int i = 0; i < per; ++i) {
    x = x * 1664525u + 1013904223u;
    atomicAdd(buf + __umulhi(x, n), 1u);
  }
}

}  // namespace

extern "C" int cbs_red_ceiling(void* buf, unsigned n, int blocks, int per,
                               unsigned seed, void* stream) {
  red_ceiling_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(
                                              stream)>>>(
      static_cast<uint32_t*>(buf), n, per, seed);
  return int(cudaGetLastError());
}
"""
#: The real streams of phase 3c: the cells whose kept batch --scatter
#: pallas replays to ids (the first group of a pass).
STREAM_CELLS = ("default", "deep", "zoom", "bigcanvas")
#: Each random RED of the ceiling kernel: per thread, at 2048 threads an SM.
CEILING_PER_THREAD = 64


def ceiling_lib_path():
    import hashlib

    from cudabrot_tpu_torch.ops import _build

    h = hashlib.sha256((RED_CEILING_CU + " ".join(_build.NVCC_FLAGS))
                       .encode()).hexdigest()[:16]
    return os.path.join(OUT, f"libred_ceiling-{h}.so")


def start_ceiling_build():
    """nvcc of RED_CEILING_CU (started beside the package's builds);
    returns (process, log path), the process None when built."""
    from cudabrot_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    out = ceiling_lib_path()
    log_path = out[:-3] + ".log"
    if os.path.exists(out):
        return None, log_path
    src = os.path.join(OUT, "red_ceiling.cu")
    with open(src, "w") as f:
        f.write(RED_CEILING_CU)
    logf = open(log_path, "w")
    proc = subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                             out, src], stdout=logf, stderr=subprocess.STDOUT)
    return proc, log_path


def finish_ceiling_build(started):
    proc, log_path = started
    if proc is None:
        return
    if proc.wait() != 0:
        with open(log_path) as f:
            raise SmokeFailure(f"nvcc failed on red_ceiling:\n{f.read()}")
    with open(log_path) as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  [red_ceiling] {line.strip()}")


_CEILING = []


def ceiling_lib():
    """The RED ceiling library (ctypes), built if phase 1 did not build
    it."""
    import ctypes

    if not _CEILING:
        finish_ceiling_build(start_ceiling_build())
        lib = ctypes.CDLL(ceiling_lib_path())
        lib.cbs_red_ceiling.argtypes = [ctypes.c_void_p, ctypes.c_uint,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_uint, ctypes.c_void_p]
        lib.cbs_red_ceiling.restype = ctypes.c_int
        _CEILING.append(lib)
    return _CEILING[0]


def atomic_ceiling(dev, words):
    """Random RED.ADD.U32 per ms into a buffer of ``words`` uint32 at full
    occupancy (2048 threads an SM, CEILING_PER_THREAD each), CUDA
    events."""
    import torch

    from cudabrot_tpu_torch.ops import _build

    lib = ceiling_lib()
    buf = torch.zeros(words, dtype=torch.int32, device=dev)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count * 8
    total = blocks * 256 * CEILING_PER_THREAD
    seed = [0]

    def run():
        seed[0] += 1
        _build.check(lib.cbs_red_ceiling(
            _build.ptr(buf), words, blocks, CEILING_PER_THREAD, seed[0],
            _build.stream_of(buf)), "red_ceiling")

    ms = time_ms(run, 20)
    check(int(buf.to(torch.int64).sum()) == total * 21,
          f"atomic ceiling into {words * 4 / 1e6:.0f} MB: every RED landed")
    return total / ms




def equal_share(ids, nbins):
    """The share of a stream's in-range ids that equal an earlier id of
    their aligned 32-id window: the atomics a warp's equal-id sum saves."""
    import torch

    n = ids.numel() // 32 * 32
    s = torch.sort(ids[:n].view(-1, 32), dim=1).values
    valid = s < nbins
    dup = (s[:, 1:] == s[:, :-1]) & valid[:, 1:]
    return int(dup.sum()) / max(int(valid.sum()), 1)


def route_stream(dev, name):
    """The first group of one pass of a cell's kept batch through the
    --scatter pallas route's id replay: (ids, nbins)."""
    from cudabrot_tpu_torch.ops import binning

    eng, (xr, xi, it, off), n = big_batch(dev, name, scatter="pallas")
    kw = dict(canvas=eng.cfg.canvas, fractal=eng.fractal)
    if eng.extended:
        kw["sample_domain"] = eng.cfg.sample_domain
        ids, _ = binning.replay_ids_ext(xr, xi, it, off, n, **kw)
    else:
        ids, _ = binning.replay_ids(xr, xi, it, off, n, **kw)
    return ids, eng.cfg.canvas.num_pixels


def phase_deposit_ids(dev, card):
    """Phase 3c: deposit_ids on the streams the --scatter pallas route
    gives it (the default, deep, zoom and bigcanvas cells' replay_ids
    streams) and on phase 3's random streams at 1000x1000 and 6000x4500:
    the package's kernel against deposit_ids_plain bitwise, each stream's
    sentinel and equal-id shares, and the times: the kernel, index_add_
    (the plain version), torch.bincount, the bound by bytes and the card's
    random-atomic ceiling into a histogram of the stream's size. Returns
    the kernel record at the default stream."""
    import torch

    from cudabrot_tpu_torch.ops import binning

    log(f"== phase 3c: deposit_ids on the id routes' streams [{card}]")
    ceiling = {w: atomic_ceiling(dev, w) for w in (1000 * 1000, 6000 * 4500)}
    for w, rate in ceiling.items():
        log(f"  random RED.ADD.U32 ceiling into {w * 4 / 1e6:.0f} MB: "
            f"{rate:.4e} atomics per ms")
    gen = torch.Generator(device=dev).manual_seed(7)
    streams = {}
    for w, h in ((1000, 1000), (6000, 4500)):
        nbins, n_ids = w * h, 1 << 24
        ids = torch.randint(0, nbins, (n_ids,), generator=gen, device=dev,
                            dtype=torch.int32)
        ids[torch.rand(n_ids, generator=gen, device=dev) < 0.1] = nbins
        streams[f"random {w}x{h}"] = (ids, nbins)
    for name in STREAM_CELLS:
        streams[name] = route_stream(dev, name)
    records, err = {}, 0.0
    base = torch.randint(-2, 4099 + 2, (1 << 17,), generator=gen,
                         device=dev, dtype=torch.int32)
    for off, n in itertools.product(range(4), (1, 3, 4, 7, 1000, 100_003)):
        got = torch.arange(4099, dtype=torch.int32, device=dev)
        want = got.clone()
        binning.deposit_ids(got, base[off:off + n])
        binning.deposit_ids_plain(want, base[off:off + n])
        err = max(err, max_abs_err([(got, want)]))
        if not torch.equal(got, want):
            raise SmokeFailure(f"deposit_ids on a view at id {off} of "
                               f"{n} ids differs from deposit_ids_plain")
    log("  ok: deposit_ids on views starting 0..3 ids past a 16-byte "
        "boundary, 1..100,003 ids: bitwise vs deposit_ids_plain")
    for tag, (ids, nbins) in streams.items():
        n = ids.numel()
        on = int((ids < nbins).sum())
        share = equal_share(ids, nbins)
        want = torch.zeros(nbins, dtype=torch.int32, device=dev)
        binning.deposit_ids_plain(want, ids)
        got = torch.zeros_like(want)
        binning.deposit_ids(got, ids)
        check(torch.equal(got, want) and int(got.to(torch.int64).sum()) == on,
              f"deposit_ids on {tag} ({n} ids): bitwise vs deposit_ids_plain")
        err = max(err, max_abs_err([(got, want)]))
        hist = torch.zeros_like(want)
        # Twice, 20 launches a time into one histogram; the time is the
        # mean of the two.
        ms = sum(time_ms(lambda: binning.deposit_ids(hist, ids), 20)
                 for _ in range(2)) / 2
        plain = time_ms(lambda: binning.deposit_ids_plain(hist, ids), 3)
        lib = time_ms(lambda: torch.bincount(ids, minlength=nbins + 1), 3)
        b_ms, b_by = bound_ms(OPS_DEPOSIT_ID * n, 4 * n + 8 * nbins)
        rate = ceiling[1000 * 1000 if nbins <= 1000 * 1000 else 6000 * 4500]
        ceil_ms = on / rate
        records[tag] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                            bound_ms=b_ms, bound_by=b_by, ceiling_ms=ceil_ms,
                            ids=n, on_canvas=on, equal_share=share)
        log(f"  {tag}: {n} ids into {nbins} bins, sentinel share "
            f"{1 - on / n:.4f}, equal-id share in 32-id windows {share:.6f}; "
            f"deposit_ids {ms:.4f} ms ({on / ms:.4e} atomics per ms; "
            f"{b_ms / ms:.3f} of the bound {b_ms:.4f} ms by {b_by}, "
            f"{ceil_ms / ms:.3f} of the atomic ceiling's {ceil_ms:.4f} ms); "
            f"index_add_ {plain:.4f} ms, bincount {lib:.4f} ms")
    log(f"phase 3c record: {json.dumps(records)}")
    rec = records["default"]
    return dict(max_abs_err=err, **{k: rec[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})


#: The id-stream routes through cli.main (phase 13), each held to --scatter
#: auto: --scatter pallas at default, deep, zoom and bigcanvas, --scatter
#: sorted (the bigtiles route under the JAX package's name) at default and
#: zoom.
ROUTE_RUNS = (("default", ("pallas", "sorted")), ("deep", ("pallas",)),
              ("zoom", ("pallas", "sorted")), ("bigcanvas", ("pallas",)))
#: The cells whose passes phase 13 times by route, and the routes in the
#: order of their first turn (bigtiles is also --scatter sorted's).
ROUTE_TIMES = ("default", "deep", "zoom", "bigcanvas")
TIMED_ROUTES = ("auto", "pallas", "bigtiles")


def cell_passes(name):
    return next(p for n, _, p in (*CELLS, *BIG_CELLS) if n == name)


def cli_cell(name, scatter):
    """A cell through cli.main with ``--scatter``: (stats, launch counts,
    histogram); the PGM is checked for its size and deleted, and the
    device memory's peak printed."""
    import torch

    cv = cell_config(name).canvas
    torch.cuda.reset_peak_memory_stats()
    pgm_path = os.path.join(OUT, f"{name}_{scatter}.pgm")
    stats_path = os.path.join(OUT, f"{name}_{scatter}.json")
    stats, counts, hist = run_cli_capture(
        [*cell_args(name), "--scatter", scatter, "--passes",
         str(cell_passes(name)), "-t", "-1", "-o", pgm_path,
         "--stats-json", stats_path], stats_path)
    size = os.path.getsize(pgm_path)
    os.remove(pgm_path)
    check(size == len(f"P5\n{cv.width} {cv.height}\n65535\n")
          + 2 * cv.num_pixels, f"{name} --scatter {scatter}: PGM size")
    log(f"  {name} --scatter {scatter}: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return stats, counts, hist


def phase_routes(dev, card):
    """Phase 13: --scatter pallas and sorted through cli.main (ROUTE_RUNS),
    each against --scatter auto: histogram and every stat bitwise, the
    histogram's sum the on-canvas points, the route's kernels launched and
    no plain version run; the row-sharded engine over two shards of cuda:0
    on the pallas route against the data-parallel engine on the fused
    route; then the cells' passes by route (TIMED_ROUTES). Returns
    {cell:route: (stats, launch counts)}."""
    import numpy as np

    from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine
    from cudabrot_tpu_torch.ops import launches
    from cudabrot_tpu_torch.parallel.data_parallel import DataParallelEngine
    from cudabrot_tpu_torch.parallel.sharded_hist import (
        ShardedHistogramEngine,
    )

    log("== phase 13: the id-stream routes through cudabrot_tpu_torch.cli.main")
    t0 = time.monotonic()
    os.makedirs(OUT, exist_ok=True)

    def same(st):
        return {k: v for k, v in st.items() if k != "elapsed_seconds"}

    results = {}
    for name, routes in ROUTE_RUNS:
        sa, _, ha = cli_cell(name, "auto")
        for route in routes:
            tag = f"{name} --scatter {route}"
            st, counts, h = cli_cell(name, route)
            check(np.array_equal(h, ha) and same(st) == same(sa),
                  f"{tag}: histogram and every stat == --scatter auto, bit "
                  f"for bit")
            check(int(h.sum(dtype=np.uint64)) == st["on_canvas_points"] > 0,
                  f"{tag}: histogram sum == on_canvas_points "
                  f"({st['on_canvas_points']})")
            check(all(counts[k] > 0 for k in path_kernels(name, route))
                  and not any(counts[f"{k}_plain"] for k in launches.KERNELS),
                  f"{tag}: launched " + ", ".join(
                      f"{k} x{counts[k]}" for k in path_kernels(name, route))
                  + ", no plain version")
            log(f"  {tag}: {st['elapsed_seconds']:.3f} s against auto's "
                f"{sa['elapsed_seconds']:.3f} s")
            results[f"{name}:{route}"] = (st, counts)
    (hr, sr, _), counts = counted_run(
        ShardedHistogramEngine(cell_config("default", "pallas"),
                               devices=[dev, dev]), MULTI_PASSES,
        path_kernels("default", "pallas"), "default pallas: rows x2 on cuda:0")
    hd, sd, _ = engine_run(DataParallelEngine(cell_config("default"),
                                              devices=[dev, dev]),
                           MULTI_PASSES)
    check(np.array_equal(hr, hd)
          and {k: v for k, v in sr.items() if k != "histogram_sharding"} == sd
          and int(hr.sum(dtype=np.uint64)) == sr["on_canvas_points"] > 0,
          "default: rows x2 on the pallas route == DP x2 on the fused route, "
          "histogram and every stat bitwise")
    results["default:pallas rows x2"] = (sr, counts)
    log(f"  phase 13 checks took {time.monotonic() - t0:.1f} s")

    turns = (*TIMED_ROUTES, *reversed(TIMED_ROUTES))
    log(f"-- phase 13 pass times, CUDA events over 5 passes, routes in turn "
        f"({', '.join(turns)}) [{card}]")
    times = {}
    for name in ROUTE_TIMES:
        engs = {}
        for route in TIMED_ROUTES:
            eng = CudaEngine(cell_config(name, route), device=dev)
            state = eng.init_state(None)
            for p in range(4):
                eng.run_pass(state, p)
            engs[route] = (eng, state)
        ms = {r: [] for r in engs}
        for i, route in enumerate(turns):
            eng, state = engs[route]
            ms[route].append(pass_ms(eng, state, 10 + 10 * i, 5))
        times[name] = ms
        log(f"  {name}: " + "; ".join(
            f"{r} {a:.4f}, {b:.4f} ms" for r, (a, b) in ms.items()))
        del engs
    log(f"phase 13 record: {json.dumps(times)}")
    return results


# ----------------------------------------------------------------------
# The df32 replay's long-orbit floor and the engine's pass times.


def kept_batch(dev, name, scatter="auto", warm=8):
    """A cell's engine, its lane state after ``warm`` passes, and the kept
    batch of the next pass: (eng, state, (xr, xi, iters)), compacted and
    ordered by descending orbit length as the main path replays it."""
    from cudabrot_tpu_torch.engines import cuda_engine as ce
    from cudabrot_tpu_torch.ops import classify as cls
    from cudabrot_tpu_torch.ops import classify_ext as cx
    from cudabrot_tpu_torch.ops import prng

    cfg = cell_config(name, scatter)
    eng = ce.CudaEngine(cfg, device=dev)
    tn = eng.tuning
    state = eng.init_state(None)
    for p in range(warm):
        eng.run_pass(state, p)
    spec = dict(fractal=eng.fractal, min_it=tn.min_it, max_it=tn.max_it,
                steps_per_pass=tn.steps_per_pass,
                steps_per_flush=tn.steps_per_flush, cycle_detection=True,
                inner_unroll=tn.inner_unroll,
                sample_domain=cfg.sample_domain)
    if eng.extended:
        classify = cx.classify_pass_ext
    else:
        classify = cls.classify_pass
        spec["thin_tracking"] = tn.thin_tracking
    key = prng.pass_key(cfg.seed, 0, warm + 1)
    res = classify(clone_state(state["lanes"]), prng.bits_host(key, 2),
                   **spec)
    xr, xi, it, _ = ce.compact(res.emit_c, res.emit_it, key,
                               tn.replay_capacity, tn.max_it)
    return eng, state, (xr, xi, it)


def registers(lib, substr):
    """(kernel, registers) of the entry functions of a library's last
    build whose mangled name holds ``substr`` (nvcc -Xptxas -v)."""
    from cudabrot_tpu_torch.ops import _build

    out, entry = [], None
    for line in _build.ptxas_report(lib).splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line and entry and substr in entry:
            out.append((entry, int(line.split("Used")[1].split()[0])))
            entry = None
    return out


def phase_replay_floor(dev, card):
    """What bounds the two df32 replay kernels at the zoom cell's batch:
    the lone-orbit floor (the batch's longest orbit, set to FLOOR_STEPS
    steps, replayed alone: one thread in its own launch), the same orbit
    at the head of the whole batch, and the batch's heads of FLOOR_HEADS
    orbits; the same for replay_ids_ext at the bigzoom canvas; each
    kernel's registers. The time of a lone orbit is its dependent df32
    chain; what the batch adds to it is contention for issue slots and
    layout. Returns the lone-orbit times."""
    import torch

    from cudabrot_tpu_torch.ops import binning

    log("== phase 7: the df32 replay's long-orbit floor (zoom batch)")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    log(f"  card: {card}; max SM clock {clocks}")
    eng, _, (kr, ki, it) = kept_batch(dev, "zoom")
    cfg = eng.cfg
    head = it.clone()
    head[0] = FLOOR_STEPS - 1
    orbits = int((it >= 0).sum())
    log(f"  zoom batch: {orbits} orbits, longest {int(it[0]) + 1} steps "
        f"(timed at {FLOOR_STEPS}), "
        f"{int(torch.where(it >= 0, it + 1, 0).sum())} points")
    out = {}
    big = cell_config("bigzoom").canvas
    for kernel, canvas in (("replay_deposit_ext", cfg.canvas),
                           ("replay_ids_ext", big)):
        kw = dict(canvas=canvas, fractal=eng.fractal,
                  sample_domain=cfg.sample_domain)
        hist = torch.zeros(canvas.num_pixels, dtype=torch.int32, device=dev)

        def call(n, its=head):
            if kernel == "replay_deposit_ext":
                return lambda: binning.replay_deposit_ext(
                    hist, kr[:n], ki[:n], its[:n], **kw)
            off, ends = binning.id_offsets(its[:n])
            n_ids = int(ends[-1])
            return lambda: binning.replay_ids_ext(
                kr[:n], ki[:n], its[:n], off, n_ids, **kw)

        # Three rounds, interleaved: the card's clock under this light load
        # moves between calls, so each figure is the least of its rounds.
        rounds = []
        for _ in range(3):
            rounds.append({n: time_ms(call(n), 5)
                           for n in (1, *FLOOR_HEADS, kr.numel())})
            rounds[-1]["as_is"] = time_ms(call(kr.numel(), it), 5)
        best = {n: min(r[n] for r in rounds) for n in rounds[0]}
        lone, whole = best[1], best[kr.numel()]
        out[kernel] = lone
        log(f"  {kernel} ({canvas.width}x{canvas.height}), least of 3 "
            f"rounds: lone orbit of {FLOOR_STEPS} steps {lone:.4f} ms; at "
            f"the head of the batch's "
            + ", ".join(f"{n} orbits {best[n]:.4f}" for n in FLOOR_HEADS)
            + f", all {kr.numel()} {whole:.4f} ms (the batch as compacted "
            f"{best['as_is']:.4f}); batch / lone {whole / lone:.3f}")
        log(f"  {kernel} rounds (lone, all): " + "; ".join(
            f"{r[1]:.4f}, {r[kr.numel()]:.4f}" for r in rounds))
        warps = getattr(binning, "REPLAY_EXT_WARPS_PER_SM", None)
        if warps is not None:
            sweep = {}
            for w in (4, 8, 16, 32, 4):
                binning.REPLAY_EXT_WARPS_PER_SM = w
                sweep[w] = min(sweep.get(w, 1e9), time_ms(call(kr.numel()), 5))
            binning.REPLAY_EXT_WARPS_PER_SM = warps
            log(f"  {kernel}: the batch at resident warps per SM "
                + ", ".join(f"{w}: {t:.4f} ms" for w, t in sweep.items())
                + f" (the kernel's choice: {warps})")
        del hist
    for lib, sub in (("deposit_ext", "replay"), ("deposit", "replay")):
        for entry, regs in registers(lib, sub):
            log(f"  registers [{lib}] {entry}: {regs}")
    return out


#: Resident warps per SM of the f32 replays that phase 3 holds bitwise and
#: phase 7c times.
STUDY_REPLAY_WARPS = (4, 8, 16, 32, 64)
#: binning.REPLAY_TAKES_PER_WARP values the replay study sweeps at the
#: default batch (the last gives each warp one group at a time).
STUDY_TAKES_PER_WARP = (1, 2, 4, 8, 16, 1 << 30)
#: SASS opcodes by the SM sub-partition pipe that runs them: the integer
#: ALU (16 lanes a clock, 64 per SM), the FMA pipe (f32 arithmetic and
#: IMAD), the conversion unit; the rest (moves, memory, branches) apart.
PIPE_OF = {
    "alu": ("IADD3", "LOP3", "SHF", "SHL", "SHR", "ISETP", "LEA", "IMNMX",
            "IABS", "PRMT", "SEL", "FSEL", "FSETP", "FMNMX", "POPC", "FLO",
            "BREV", "SGXT", "BMSK", "PLOP3", "P2R", "R2P", "VIADD", "VIMNMX"),
    "fma": ("FADD", "FMUL", "FFMA", "IMAD", "IMUL", "FMUL32I", "FADD32I",
            "FFMA32I", "IMAD32I"),
    "xu": ("I2F", "F2I", "MUFU", "F2F", "I2FP", "F2IP", "FRND"),
}
#: Functions of the refill draw and the f32 lane window, compiled with the
#: kernels' flags into one cubin whose SASS the study counts (each kernel
#: less sass_base, or less sass_lane_base for the window: the same loads and
#: stores without the function).
SASS_STUDY_CU = r"""
#include "classify.cuh"
#include "classify_ext.cuh"
#define IO const uint32_t* __restrict__ in, uint32_t* __restrict__ out, \
    uint32_t k0, uint32_t k1, float lo, float span
#define LOAD const int i = blockIdx.x * blockDim.x + threadIdx.x; \
    uint32_t x0 = in[2 * i], x1 = in[2 * i + 1], x2 = x0, x3 = x1, x4 = x0;
#define STORE out[5 * i] = x0; out[5 * i + 1] = x1; out[5 * i + 2] = x2; \
    out[5 * i + 3] = x3; out[5 * i + 4] = x4;
extern "C" __global__ void sass_base(IO) { LOAD STORE }
extern "C" __global__ void sass_threefry(IO) {
  LOAD cb::threefry2x32(k0, k1, x0, x1); STORE }
extern "C" __global__ void sass_domain(IO) {
  LOAD x0 = __float_as_uint(cb::u32_to_domain(x0, lo, span));
  x1 = __float_as_uint(cb::u32_to_domain(x1, span, lo)); STORE }
extern "C" __global__ void sass_cull(IO) {
  LOAD x4 = cb::culled(__uint_as_float(x0), __uint_as_float(x1)); STORE }
extern "C" __global__ void sass_draw_ext(IO) {
  LOAD const float kr = float(int32_t(x0 >> 8)), ki = float(int32_t(x1 >> 8));
  const float off_r = cb::df::grid_offset(kr, lo);
  const float off_i = cb::df::grid_offset(ki, span);
  const cb::df::F2 cr = cb::df::add_f({lo, span}, off_r);
  const cb::df::F2 ci = cb::df::add_f({span, lo}, off_i);
  x0 = __float_as_uint(cr.hi); x1 = __float_as_uint(cr.lo);
  x2 = __float_as_uint(ci.hi); x3 = __float_as_uint(ci.lo);
  x4 = cb::culled(cb::fadd(lo, off_r), cb::fadd(span, off_i)); STORE }
// The default cell's lane (buddhabrot, thin tracking, no visit window,
// Brent checks on) through a.windows windows of U updates, one loop
// iteration each, a finished lane refilled with a fixed draw (as the
// kernel's loop carries it); U = 0 finishes the lane at max_it without a
// window.
template <int U> __device__ void window_loop(cb::ClassifyArgs a) {
  a.detect = 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  cb::Lane l = cb::load_lane(a, i);
  const cb::Draw d{l.ci, l.cr, l.dead};
#pragma unroll 1
  for (int w = 0; w < a.windows; ++w) {
    bool fin = l.it >= a.max_it;
    if constexpr (U > 0)
      fin = cb::lane_window<cb::kBuddhabrot, true, false, U>(a, l);
    if (fin) cb::refill<false>(l, d);
  }
  cb::flush_lane(a, l, 0, i);
  cb::store_lane(a, l, i);
}
extern "C" __global__ void sass_window0(cb::ClassifyArgs a) { window_loop<0>(a); }
extern "C" __global__ void sass_window1(cb::ClassifyArgs a) { window_loop<1>(a); }
extern "C" __global__ void sass_window2(cb::ClassifyArgs a) { window_loop<2>(a); }
"""



def sass_listing(text):
    """{function: [(address, opcode), ...]} of cuobjdump -sass output, NOPs
    left out; a branch's opcode is followed by its target, as
    ("BRA", target)."""
    import re

    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)(?:\S*\s+(0x[0-9a-f]+|`\(\S+\)))?",
                     line)
        if m and cur is not None and m.group(2) != "NOP":
            op = m.group(2)
            tgt = m.group(3)
            if op == "BRA" and tgt and tgt.startswith("0x"):
                op = ("BRA", int(tgt, 16))
            cur.append((int(m.group(1), 16), op))
    return funcs


def _name(op):
    return op[0] if isinstance(op, tuple) else op


def sass_functions(text):
    """{function: [opcode, ...]} of cuobjdump -sass output (NOPs and the
    closing self-branch left out)."""
    funcs = {k: [_name(op) for _, op in v]
             for k, v in sass_listing(text).items()}
    for ops in funcs.values():
        while ops and ops[-1] == "BRA":
            ops.pop()
    return funcs


def loop_body(listing):
    """The opcodes of a function's longest loop: from the target of a
    backward branch to that branch."""
    start, end = max(((op[1], addr) for addr, op in listing
                      if isinstance(op, tuple) and op[1] < addr),
                     key=lambda t: t[1] - t[0])
    return [_name(op) for addr, op in listing if start <= addr <= end]


def pipe_counts(ops):
    """Instruction counts of a SASS opcode list by pipe (PIPE_OF), plus
    'other' and 'all'."""
    out = {p: 0 for p in (*PIPE_OF, "other")}
    for op in ops:
        out[next((p for p, names in PIPE_OF.items() if op in names),
                 "other")] += 1
    out["all"] = len(ops)
    return out


def _cuobjdump():
    import shutil

    from cudabrot_tpu_torch.ops import _build

    path = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    return path if os.path.exists(path) else (shutil.which("cuobjdump")
                                              or path)


def study_sass(name, source):
    """cuobjdump -sass of ``source`` compiled with the kernels' flags
    against csrc/ into one cubin; the source and the listing go to OUT."""
    from cudabrot_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, f"{name}.cu")
    with open(src, "w") as f:
        f.write(source)
    cubin = os.path.join(OUT, f"{name}.cubin")
    flags = [a for a in _build.NVCC_FLAGS
             if a not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    subprocess.run([_build.nvcc_path(), *flags, "-cubin", "-I",
                    str(_build.CSRC), "-o", cubin, src], check=True,
                   capture_output=True, text=True)
    text = subprocess.run([_cuobjdump(), "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    with open(os.path.join(OUT, f"{name}.sass"), "w") as f:
        f.write(text)
    return text


def lib_sass(lib):
    """cuobjdump -sass of a built kernel library (dumped to OUT)."""
    from cudabrot_tpu_torch.ops import _build

    text = subprocess.run([_cuobjdump(), "-sass",
                           str(_build.lib_path(lib))], check=True,
                          capture_output=True, text=True).stdout
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, f"{lib}.sass"), "w") as f:
        f.write(text)
    return text


def sass_study():
    """The refill draw's instructions from the SASS: Threefry-2x32, the
    domain map of two words, the cull, and the df32 grid draw, each less the
    loads and stores of sass_base, by pipe; the f32 lane window of the
    default cell from the loop bodies of sass_window0/1/2 (U = 2 less U = 1
    is one inner step; U = 1 less the step and less U = 0's loop, its
    counter and refill, is the boundary); then the opcode mix of the built
    classify library's default-cell kernel. Dumps go to OUT."""
    import collections

    log("== SASS counts of the refill draw (cuobjdump -sass)")
    text = study_sass("sass_study", SASS_STUDY_CU)
    funcs = {k: pipe_counts(v) for k, v in sass_functions(text).items()}
    base = funcs["sass_base"]
    counts = {}
    for name in ("sass_threefry", "sass_domain", "sass_cull", "sass_draw_ext"):
        c = {p: funcs[name][p] - base[p] for p in base}
        counts[name[5:]] = c
        log(f"  {name[5:]}: {c['all']} instructions ({c['alu']} ALU, "
            f"{c['fma']} FMA pipe, {c['xu']} conversion, {c['other']} other)")
    bodies = {u: loop_body(sass_listing(text)[f"sass_window{u}"])
              for u in (0, 1, 2)}
    b0, b1, b2 = (pipe_counts(bodies[u]) for u in (0, 1, 2))
    counts["inner_step"] = {p: b2[p] - b1[p] for p in b0}
    counts["boundary"] = {p: b1[p] - b0[p] - counts["inner_step"][p]
                          for p in b0}
    for name in ("inner_step", "boundary"):
        c = counts[name]
        log(f"  f32 window {name} (loop bodies U = 0, 1, 2: {b0['all']}, "
            f"{b1['all']}, {b2['all']}): {c['all']} instructions "
            f"({c['alu']} ALU, {c['fma']} FMA pipe, {c['xu']} conversion, "
            f"{c['other']} other)")
    mix = collections.Counter(sass_functions(text)["sass_threefry"])
    log(f"  threefry opcodes (with sass_base's): {dict(mix)}")
    w1_mix = collections.Counter(bodies[1])
    w1_mix.subtract(bodies[0])
    log(f"  window U = 1 loop-body opcodes less U = 0's: "
        f"{ {k: v for k, v in w1_mix.items() if v} }")
    text = lib_sass("classify")
    # The default cell's variant (buddhabrot, thin tracking, no visit
    # window; U = 1 where the kernel has a U argument).
    for name, ops in sorted(sass_functions(text).items()):
        if "classify_kernelILi0ELb1ELb0E" in name and (
                "ELi1EE" in name
                or name.endswith("ELb0EEEvNS_12ClassifyArgsE")):
            log(f"  {name}: {pipe_counts(ops)}")
    return counts

















#: Profiles profile_calls takes before it reports an empty one (a second
#: apart): in whole chip_smoke.py runs on an H100 the profiler twice traced
#: no device activity over 20 short MH deposit calls in phase 5 (two of
#: five runs, with phases 13 and 3c run before it; they now run after it),
#: and traced all of 146 such profiles taken on purpose, 50 of them late
#: in a whole run. Each empty profile is printed and counted
#: (PROFILE_RETRIES, in the last line), so a recurrence shows.
PROFILE_TRIES = 3
#: The empty profiles taken again in this run (printed in the last line).
PROFILE_RETRIES = [0]


def profile_calls(fn, reps: int, only: str = ""):
    """torch.profiler's device activities (kernels, memsets and copies;
    with ``only``, those whose name holds it) over ``reps`` calls of
    ``fn``: a dict of activities per call (``per_call``), device ms per
    call and per activity (``ms_per_call``, ``ms_each``) and their names;
    or the reason, a string, when it records none in PROFILE_TRIES
    profiles (each empty one is printed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    trace = os.path.join(OUT, "calls_trace.json")
    os.makedirs(OUT, exist_ok=True)
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            prof.export_chrome_trace(trace)
            with open(trace) as f:
                events = json.load(f).get("traceEvents", [])
        except Exception as e:  # noqa: BLE001 -- a measurement, not a check
            return f"profiler failed: {e!r}"
        finally:
            if os.path.exists(trace):
                os.remove(trace)
        device = [e for e in events if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")
                  and only in e.get("name", "")]
        if device:
            break
        PROFILE_RETRIES[0] += 1
        free, total = torch.cuda.mem_get_info()
        log(f"  profile {attempt} of {PROFILE_TRIES} over {reps} calls "
            f"traced no device activity {only} (device memory free "
            f"{free / 2**30:.1f} of {total / 2**30:.1f} GiB, "
            f"{torch.cuda.memory_reserved() / 2**30:.1f} GiB reserved by "
            f"the allocator)")
        time.sleep(1.0)
    if not device:
        return f"the profiler recorded no device activity {only}".strip()
    total = sum(float(e.get("dur", 0.0)) for e in device) / 1e3
    return dict(per_call=len(device) / reps, ms_per_call=total / reps,
                ms_each=total / len(device),
                names=sorted({e.get("name", "")[:40] for e in device}))




def phase_replay_floor_f32(dev, card):
    """What bounds the f32 replay-deposit kernel: at the deep batch (its
    1000x1000 canvas) and at the northstar batch (20000x20000), the batch's
    longest orbit set to FLOOR_STEPS steps and replayed alone, at the head
    of the batch's first 128 and 256 orbits and of the whole batch; then
    the whole batch of the default, deep and northstar cells at each
    STUDY_REPLAY_WARPS resident warps per SM (binning.REPLAY_WARPS_PER_SM
    set for the call), and the default batch at each
    STUDY_TAKES_PER_WARP. Least of 3 rounds each."""
    import torch

    from cudabrot_tpu_torch.ops import binning

    log(f"== phase 7c: the f32 replay's long-orbit floor ({card})")
    for name in ("deep", "northstar", "default"):
        eng, _, (cr, ci, it) = kept_batch(dev, name, warm=4)
        canvas = eng.cfg.canvas
        hist = torch.zeros(canvas.num_pixels, dtype=torch.int32, device=dev)
        head = it.clone()
        if name != "default":
            head[0] = FLOOR_STEPS - 1
        k = cr.numel()
        orbits = int((it >= 0).sum())
        log(f"  {name} batch: {orbits} orbits, longest {int(it[0]) + 1} "
            f"steps, {int(torch.where(it >= 0, it + 1, 0).sum())} points, "
            f"canvas {canvas.width}x{canvas.height}")

        def call(m, its=head, const=None, value=None):
            def replay():
                return binning.replay_deposit(hist, cr[:m], ci[:m], its[:m],
                                              canvas=canvas,
                                              fractal=eng.fractal)
            if const is None:
                return replay

            def patched():
                with mock.patch.object(binning, const, value):
                    return replay()
            return patched

        if name != "default":
            rounds = []
            for _ in range(3):
                rounds.append({m: time_ms(call(m), 5)
                               for m in (1, 128, 256, k)})
                rounds[-1]["as_is"] = time_ms(call(k, it), 5)
            best = {m: min(r[m] for r in rounds) for m in rounds[0]}
            log(f"  replay_deposit ({name}), least of 3 rounds: lone orbit "
                f"of {FLOOR_STEPS} steps {best[1]:.4f} ms; at the head of "
                f"128 orbits {best[128]:.4f}, 256 orbits {best[256]:.4f}, "
                f"all {k} {best[k]:.4f} ms (the batch as compacted "
                f"{best['as_is']:.4f}); batch / lone {best[k] / best[1]:.3f}")
        sweep = {}
        for _ in range(3):
            for w in STUDY_REPLAY_WARPS:
                sweep[w] = min(sweep.get(w, 1e9), time_ms(
                    call(k, it, "REPLAY_WARPS_PER_SM", w), 5))
        log(f"  replay_deposit ({name}): the batch as compacted at "
            "resident warps per SM " + ", ".join(
                f"{w}: {t:.4f} ms" for w, t in sweep.items())
            + f" (least of 3 rounds; the package's "
            f"{binning.REPLAY_WARPS_PER_SM})")
        if name == "default":
            takes = {}
            for _ in range(3):
                for g in STUDY_TAKES_PER_WARP:
                    takes[g] = min(takes.get(g, 1e9), time_ms(
                        call(k, it, "REPLAY_TAKES_PER_WARP", g), 5))

            def take_of(g):
                with mock.patch.object(binning, "REPLAY_TAKES_PER_WARP", g):
                    return binning.replay_launch(k, dev)[1]
            log(f"  replay_deposit ({name}): REPLAY_TAKES_PER_WARP (groups "
                "of 32 a warp takes at once) " + ", ".join(
                    f"{g} ({take_of(g)}): {t:.4f} ms"
                    for g, t in takes.items())
                + f" (least of 3 rounds; the package's "
                f"{binning.REPLAY_TAKES_PER_WARP})")
        del hist, eng
        torch.cuda.empty_cache()
    for entry, regs in registers("deposit", "replay"):
        log(f"  registers [deposit] {entry}: {regs}")


def big_batch(dev, name, warm=4, scatter="bigtiles"):
    """A cell's kept batch after ``warm`` passes, cut to an id-stream
    route's id budget as its groups are: (engine, (cr, ci, iters, off),
    ids)."""
    import torch

    from cudabrot_tpu_torch.ops import binning

    eng, _, (cr, ci, it) = kept_batch(dev, name, scatter, warm=warm)
    off, n = id_offsets(it)
    if n > binning.BIGTILES_ID_BUDGET:
        ends = off + torch.clamp(it.to(torch.int64) + 1, min=0)
        k = int(torch.searchsorted(
            ends, torch.tensor(binning.BIGTILES_ID_BUDGET, device=dev),
            right=True))
        cr, ci, it, off, n = cr[:k], ci[:k], it[:k], off[:k], int(ends[k - 1])
    return eng, (cr, ci, it, off), n




def phase_overlap(dev):
    """Engine passes with the fused replay on its side streams (as the
    driver runs them) against the same passes with a synchronize() after
    each and against the replay on the main stream: histogram and every
    stat bitwise, at the default, deep and zoom cells (8 passes each)."""
    import numpy as np

    from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine

    log("== phase 8: overlapped passes vs passes one after another")
    for name in ("default", "deep", "zoom"):
        runs = {}
        for mode in ("overlap", "serial", "main"):
            eng = CudaEngine(cell_config(name), device=dev)
            check(len(eng.replay_streams) == 2,
                  f"{name}: the fused replay has its side streams")
            if mode == "main":
                eng.replay_streams = []
            state = eng.init_state(None)
            for p in range(8):
                eng.run_pass(state, p)
                if mode == "serial":
                    eng.synchronize()
            runs[mode] = (eng.histogram(state), eng.stats(state))
        (ho, so), (hs, ss), (hm, sm) = (runs[m] for m in
                                        ("overlap", "serial", "main"))
        check(np.array_equal(ho, hs) and np.array_equal(ho, hm),
              f"{name}: overlapped histogram == serial == main stream, "
              f"bitwise")
        check(so == ss == sm and int(ho.sum(dtype=np.uint64))
              == so["on_canvas_points"] > 0,
              f"{name}: every stat equal; histogram sum == on_canvas_points "
              f"({so['on_canvas_points']})")


# ----------------------------------------------------------------------
# Phase 10: multi-device and multi-process rendering on one card.

#: Cells and passes of phase 10's data-parallel check (every replica on
#: cuda:0), its row-sharded checks (cell, --scatter route), and the
#: passes of each.
MULTI_DP_CELLS = ("default", "zoom", "mhcrop")
MULTI_ROWS_CELLS = (("default", "auto"), ("zoom", "auto"),
                    ("bigcanvas", "bigtiles"))
MULTI_PASSES = 3

#: The cell, and shards, of phase 10's memory check.
MULTI_MEMORY_CELL, MULTI_MEMORY_SHARDS = "northstar", 4


MULTI_CHILD = """
import sys
sys.path.insert(0, sys.argv[1])
from cudabrot_tpu_torch.cli import main
sys.exit(main(sys.argv[2:]))
"""


def engine_run(eng, passes, first=0):
    """``passes`` passes of an engine from a new state; returns
    (histogram, stats, state)."""
    state = eng.init_state(None)
    for p in range(first, first + passes):
        eng.run_pass(state, p)
    return eng.histogram(state), eng.stats(state), state


def summed_singles(cfg, dev, ordinals, passes, scatter_kw=None):
    """The histogram and stats of single CudaEngine renders at the given
    RNG ordinals, summed (uint32 wrapping; stats by
    data_parallel.sum_stats)."""
    import numpy as np

    from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine
    from cudabrot_tpu_torch.parallel.data_parallel import sum_stats

    total, stats = np.zeros(cfg.canvas.shape, np.uint32), []
    for ordinal in ordinals:
        eng = CudaEngine(cfg, device=dev)
        state = eng.init_state(None)
        for p in range(passes):
            eng.core(state, p, ordinal)
        total += eng.histogram(state)
        stats.append(eng.stats(state))
    return total, sum_stats(stats)


def counted_run(eng, passes, kernels, what):
    """``engine_run`` with the launch counts set to 0 before it and read
    after: every kernel of ``kernels`` launched, no plain version run."""
    from cudabrot_tpu_torch.ops import launches

    launches.reset()
    out = engine_run(eng, passes)
    counts = launches.snapshot()
    check(all(counts[k] > 0 for k in kernels)
          and not any(v for k, v in counts.items() if k.endswith("_plain")),
          f"{what}: launched {', '.join(f'{k} x{counts[k]}' for k in kernels)}"
          f", no plain version")
    return out, counts



def longest_first_engine():
    """The row-sharded engine with each gathered batch re-sorted by
    descending orbit length (stable; unused slots, iters -1, last), so the
    replay queue starts the longest orbits first again: phase 10 times it
    beside the package's engine, which replays the D runs as gathered."""
    import torch

    from cudabrot_tpu_torch.parallel.sharded_hist import (
        ShardedHistogramEngine,
    )

    class LongestFirst(ShardedHistogramEngine):
        @staticmethod
        def gather(batches, dev):
            cr, ci, it = ShardedHistogramEngine.gather(batches, dev)
            order = torch.sort(it, descending=True, stable=True).indices
            return cr[order], ci[order], it[order]

    return LongestFirst


def rows_memory(dev, card):
    """The allocator's peak on ``dev`` while MULTI_MEMORY_SHARDS row shards
    of the MULTI_MEMORY_CELL canvas are built (init_state) and run for two
    passes, above what was allocated before: the shards add up to one
    canvas, and no shard's state passes through a canvas-sized
    histogram, so building them stays below 1.125 canvases."""
    import torch

    from cudabrot_tpu_torch.parallel.sharded_hist import (
        ShardedHistogramEngine,
    )

    cfg = cell_config(MULTI_MEMORY_CELL)
    eng = ShardedHistogramEngine(cfg, devices=[dev] * MULTI_MEMORY_SHARDS)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = eng.init_state(None)
    torch.cuda.synchronize(dev)
    built = torch.cuda.max_memory_allocated(dev) - base
    for p in range(2):
        eng.run_pass(state, p)
    eng.synchronize()
    passes = torch.cuda.max_memory_allocated(dev) - base
    mib = 1 << 20
    canvas = cfg.canvas.num_pixels * 4
    shard = eng.rows_per_shard * cfg.canvas.width * 4
    check(canvas <= built < canvas + canvas // 8,
          f"{MULTI_MEMORY_CELL}: {MULTI_MEMORY_SHARDS} row shards on one "
          f"card: the allocator's peak {built / mib:.1f} MiB while built, "
          f"{passes / mib:.1f} MiB over two passes; the canvas "
          f"{canvas / mib:.1f} MiB, a shard {shard / mib:.1f} MiB; below "
          f"1.125 canvases [{card}]")
    del state, eng
    return {"built_mib": built / mib, "passes_mib": passes / mib,
            "canvas_mib": canvas / mib}


def two_process_run(dev, tmp):
    """cli.main in two processes on cuda:0 (CUDABROT_COORDINATOR on
    localhost, --devices 2: one replica each, ordinals 0 and 1) against
    the single-process data-parallel render over [cuda:0, cuda:0]: the
    checkpoint bitwise, the PGM bytes, process 1 silent."""
    import socket

    import numpy as np

    from cudabrot_tpu_torch import driver
    from cudabrot_tpu_torch.io import checkpoint as ckpt
    from cudabrot_tpu_torch.io import pgm
    from cudabrot_tpu_torch.ops import tonemap
    from cudabrot_tpu_torch.parallel.data_parallel import DataParallelEngine

    args = [*cell_args("default"), "-d", "0", "--devices", "2", "--passes",
            "4", "-t", "-1", "-s", os.path.join(tmp, "multi.ckpt"),
            "-o", os.path.join(tmp, "multi.pgm")]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for pid in range(2):
        env = dict(os.environ, CUDABROT_COORDINATOR=f"127.0.0.1:{port}",
                   CUDABROT_NUM_PROCESSES="2", CUDABROT_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", MULTI_CHILD, ROOT, *args], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    t0 = time.monotonic()
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.monotonic() - t0
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            log(f"  process {pid} stdout:\n{out[-2000:]}\nstderr:\n"
                f"{err[-3000:]}")
        check(p.returncode == 0, f"two processes: process {pid} exits 0")
    check("Buddhabrot passes took" in outs[0][0]
          and outs[1][0].strip() == "",
          "two processes: the primary reports, process 1 prints nothing")
    cfg = cell_config("default").replace(
        max_passes=4, seconds_to_run=-1.0,
        inprogress_file=os.path.join(tmp, "single.ckpt"))
    eng = DataParallelEngine(cfg, devices=[dev, dev])
    res = driver.run_render(cfg, engine=eng, log=lambda *_: None)
    pgm.write_pgm(os.path.join(tmp, "single.pgm"),
                  tonemap.tonemap(res.histogram, cfg.gamma).image)
    h_multi, m_multi = ckpt.load(os.path.join(tmp, "multi.ckpt"), cfg)
    h_single, m_single = ckpt.load(cfg.inprogress_file, cfg)
    check(np.array_equal(h_multi, h_single) and h_single.sum() > 0
          and m_multi["passes"] == m_single["passes"] == 4,
          f"two processes == one process over [cuda:0, cuda:0]: the "
          f"checkpoint bitwise (sum {int(h_single.sum(dtype=np.uint64))}; "
          f"{wall:.1f} s for both processes)")
    with open(os.path.join(tmp, "multi.pgm"), "rb") as a, \
            open(os.path.join(tmp, "single.pgm"), "rb") as b:
        check(a.read() == b.read(), "two processes: PGM bytes identical")


def phase_multi(dev, card):
    """Phase 10: the data-parallel engine over [cuda:0, cuda:0] against
    single engines at ordinals 0 and 1, summed (default, zoom, mhcrop);
    the row-sharded engine over 2 and 3 shards of cuda:0 against the
    data-parallel engine over the same ordinals (default and zoom on the
    fused route, bigcanvas on the bigtiles route); two processes against
    one; each bitwise. Then the times: a pass of DP x2 against a single
    engine's, and the row-sharded pass with and without re-sorting the
    gathered batch."""
    import io
    import tempfile

    import numpy as np
    import torch

    from cudabrot_tpu_torch import cli
    from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine
    from cudabrot_tpu_torch.parallel.data_parallel import DataParallelEngine
    from cudabrot_tpu_torch.parallel.sharded_hist import (
        ShardedHistogramEngine,
    )

    log("== phase 10: multi-device and multi-process rendering on one card")
    t0 = time.monotonic()
    counts = {}
    for name in MULTI_DP_CELLS:
        cfg = cell_config(name)
        (h, st, _), c = counted_run(
            DataParallelEngine(cfg, devices=[dev, dev]), MULTI_PASSES,
            path_kernels(name), f"{name}: DP x2 on cuda:0")
        counts[f"dp {name}"] = c
        hs, sts = summed_singles(cfg, dev, (0, 1), MULTI_PASSES)
        check(np.array_equal(h, hs) and st == sts
              and int(h.sum(dtype=np.uint64)) == st["on_canvas_points"] > 0,
              f"{name}: DP x2 == single engines at ordinals 0 and 1 summed, "
              f"histogram and every stat bitwise (on_canvas_points "
              f"{st['on_canvas_points']})")
    for name, scatter in MULTI_ROWS_CELLS:
        cfg = cell_config(name, scatter)
        for shards in (2, 3):
            devs = [dev] * shards
            (hr, sr, _), c = counted_run(
                ShardedHistogramEngine(cfg, devices=devs), MULTI_PASSES,
                path_kernels(name, scatter),
                f"{name} {scatter}: rows x{shards} on cuda:0")
            counts[f"rows{shards} {name}"] = c
            hd, sd, _ = engine_run(DataParallelEngine(cfg, devices=devs),
                                   MULTI_PASSES)
            same_stats = {k: v for k, v in sr.items()
                          if k != "histogram_sharding"} == sd
            check(np.array_equal(hr, hd) and same_stats
                  and int(hr.sum(dtype=np.uint64))
                  == sr["on_canvas_points"] > 0,
                  f"{name} {scatter}: rows x{shards} == DP x{shards}, "
                  f"histogram and every stat bitwise; on_canvas_points == "
                  f"histogram sum ({sr['on_canvas_points']})")
    os.makedirs(OUT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        two_process_run(dev, tmp)
        want = torch.cuda.device_count() + 1
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main([*cell_args("default"), "--devices", str(want),
                           "--passes", "1", "-t", "-1",
                           "-o", os.path.join(tmp, "none.pgm")])
        check(rc == 1 and f"Requested {want} devices starting at device 0 "
              f"but only {want - 1} are available there." in out.getvalue()
              and not os.path.exists(os.path.join(tmp, "none.pgm")),
              f"--devices {want} on {want - 1} card(s): exit code 1 and the "
              f"JAX package's message, no image")
    log(f"  phase 10 checks took {time.monotonic() - t0:.1f} s")

    log(f"-- phase 10 times [{card}]")
    times = {}
    for name in ("default", "zoom"):
        cfg = cell_config(name)
        single = CudaEngine(cfg, device=dev)
        dp = DataParallelEngine(cfg, devices=[dev, dev])
        t_single = pass_ms(single, single.init_state(None), 0, 10)
        t_dp = pass_ms(dp, dp.init_state(None), 0, 10)
        rows = {True: longest_first_engine()(cfg, devices=[dev, dev]),
                False: ShardedHistogramEngine(cfg, devices=[dev, dev])}
        t_rows = {}
        for resort in (True, False, True, False):
            eng = rows[resort]
            t_rows.setdefault(resort, []).append(
                pass_ms(eng, eng.init_state(None), 0, 10))
        times[name] = dict(single_ms=t_single, dp2_ms=t_dp,
                           rows2_resort_ms=t_rows[True],
                           rows2_unsorted_ms=t_rows[False])
        log(f"  {name}: ms a pass, one engine {t_single:.4f}; DP x2 on one "
            f"card {t_dp:.4f} (two engines' passes, same card: not "
            f"scaling); rows x2 re-sorted "
            f"{', '.join(f'{t:.4f}' for t in t_rows[True])}, unsorted "
            f"{', '.join(f'{t:.4f}' for t in t_rows[False])}")
    times["rows_memory"] = rows_memory(dev, card)
    log(f"phase 10 record: {json.dumps(times)}")
    return counts





#: Phase 11's runs through cli.main: tag, cell, extra arguments, passes.
#: "share" runs compare with the device-mode render of the same seed; the
#: auto-share run reads the --quick probe's calibration.
HOST_RUNS = (
    ("default host", "default", ["--replay-device-share", "0"], 20),
    ("default hybrid 0.3", "default", ["--replay-device-share", "0.3"], 20),
    ("default auto share", "default", [], 20),
    ("zoom host", "zoom", [], 16),
    ("mhcrop uint64", "mhcrop", ["--hist-dtype", "uint64"], 8),
    ("mhcrop host", "mhcrop", ["--replay", "host"], 8),
    ("bigcanvas host", "bigcanvas", ["--replay-device-share", "0"], 6),
)
#: The bound on the mass host and device replays place differently at the
#: default cell (bin edges: the native replay multiplies by a float32
#: reciprocal of the pitch, the device replay divides), as a share of the
#: histogram's mass. The mass placed differently is half the histograms'
#: L1 distance: each point that moved bins, once.
HOST_EDGE_SHARE = 1e-4
#: Stats only a host-mode render reports, or that count differently.
HOST_ONLY_STATS = ("replay", "replay_fetch_seconds", "replay_busy_seconds",
                   "on_canvas_points", "elapsed_seconds", "max_count")


def with_options(cfg, **opts):
    """``cfg`` with some engine options replaced."""
    import dataclasses

    return cfg.replace(options=dataclasses.replace(cfg.options, **opts))


def host_cli(args, tag, tmp):
    """cli.main over ``args`` with a checkpoint and stats; returns (stats,
    histogram, launch counts)."""
    import numpy as np

    ckpt = os.path.join(tmp, f"{tag.replace(' ', '_')}.ckpt")
    stats_path = os.path.join(tmp, f"{tag.replace(' ', '_')}.json")
    out = [*args, "-t", "-1", "-s", ckpt, "--stats-json", stats_path,
           "-o", os.path.join(tmp, "host.pgm")]
    if os.path.exists(ckpt):
        os.remove(ckpt)
    stats, counts = run_cli(out, stats_path)
    return stats, np.load(ckpt)["hist"], counts


def host_timing(eng, passes: int) -> dict:
    """ms a pass on the host clock over ``passes`` passes after one warm
    pass, ending when the card and the worker are done; the worker's fetch
    and replay seconds and points in that span."""
    w = eng._worker

    def done():
        eng.synchronize()
        if w is not None:
            w.drain()

    state = eng.init_state(None)
    eng.run_pass(state, 0)
    done()
    f0 = w.fetch_seconds if w else 0.0
    r0 = w.replay_seconds if w else 0.0
    p0 = w.points if w else 0
    t0 = time.perf_counter()
    for p in range(passes):
        eng.run_pass(state, 1 + p)
    done()
    ms = (time.perf_counter() - t0) * 1e3 / passes
    out = {"pass_ms": ms}
    if w is not None:
        out.update(fetch_s=w.fetch_seconds - f0,
                   replay_s=w.replay_seconds - r0,
                   host_points_per_s=(w.points - p0)
                   / max(w.replay_seconds - r0, 1e-9))
    return out


def phase_host(dev, card):
    """Phase 11: the host orbit replay through cli.main on the card. The
    native library's build; the calibration probe (--quick); the
    HOST_RUNS against device-mode renders of the same seed: every count
    but on_canvas_points bitwise, each histogram's sum == on_canvas_points,
    the mass placed differently reported (under HOST_EDGE_SHARE at
    default); uint64 == uint32 at mhcrop; DP host over [cuda:0, cuda:0] ==
    two single host engines at ordinals 0 and 1, summed; two processes ==
    one (checkpoint and PGM bytes). Then the pass times on the host clock
    by mode, the worker's fetch and replay seconds, host replay points/s,
    payload bytes and the device busy share of a host-mode pass."""
    import dataclasses
    import platform
    import socket
    import tempfile

    import numpy as np

    from cudabrot_tpu_torch import driver
    from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine
    from cudabrot_tpu_torch.engines.host_replay import available_cores
    from cudabrot_tpu_torch.io import checkpoint as ckpt
    from cudabrot_tpu_torch.io import native, pgm
    from cudabrot_tpu_torch.ops import tonemap
    from cudabrot_tpu_torch.parallel.data_parallel import (
        DataParallelHostReplayEngine,
        sum_stats,
    )
    from cudabrot_tpu_torch.utils import calibrate, calibration

    log(f"== phase 11: host orbit replay on the card [{card}]")
    t0 = time.monotonic()
    mach = calibrate.machine()
    log(f"  host: {mach['host_cpu']}, {mach['host_cores']} cores "
        f"(python {platform.python_version()}); native library "
        f"{native.lib_path().name}, built in {native.build_seconds:.2f} s")
    record = {"machine": mach, "native_build_s": native.build_seconds}
    os.makedirs(OUT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT) as tmp:
        cal_path = os.path.join(tmp, "calibration.json")
        tc = time.monotonic()
        cal, probe = calibrate.calibrate(dev, True, (0, 0), log=log)
        calibration.save(cal_path, cal)
        log(f"  calibration probe --quick ({time.monotonic() - tc:.1f} s): "
            f"{json.dumps(dataclasses.asdict(cal))}")
        record["calibration_quick"] = dataclasses.asdict(cal)
        calibration.activate(cal_path)
        auto = CudaEngine(with_options(cell_config("default"),
                                       replay="host"), device=dev)
        log(f"  auto share at default with the probe's calibration: "
            f"{auto.device_share:.4f} (length cut {auto.split_threshold}, "
            f"host prefix {auto.host_payload_slots} of "
            f"{auto.replay_capacity} slots)")
        record["auto_share_default"] = auto.device_share
        del auto
        calibration.activate("")
        refs = {}
        runs = {}
        for tag, cell, extra, passes in HOST_RUNS:
            key = (cell, passes)
            if key not in refs:
                refs[key] = host_cli([*cell_args(cell), "--passes",
                                      str(passes)], f"{cell} device", tmp)
            args = [*cell_args(cell), "--passes", str(passes), *extra]
            if "--replay" not in extra and "--hist-dtype" not in extra:
                args += ["--replay", "host"]
            if tag == "default auto share":
                args += ["--calibration", cal_path]
            stats, hist, counts = host_cli(args, tag, tmp)
            dstats, dhist, _ = refs[key]
            total = int(hist.sum(dtype=np.uint64))
            check(total == stats["on_canvas_points"] > 0,
                  f"{tag}: histogram sum == on_canvas_points ({total})")
            same = {k: v for k, v in stats.items()
                    if k not in HOST_ONLY_STATS} == {
                k: v for k, v in dstats.items() if k not in HOST_ONLY_STATS}
            check(same, f"{tag}: every count but on_canvas_points equals "
                  f"the device-mode render's bitwise")
            kernels = [k for k in path_kernels(cell)
                       if not k.startswith(("replay_deposit", "mh_deposit"))]
            if stats["replay"] == "hybrid":
                kernels += [k for k in path_kernels(cell)
                            if k.startswith("replay_deposit")]
            check(all(counts[k] > 0 for k in kernels)
                  and not any(v for k, v in counts.items()
                              if k.endswith("_plain")),
                  f"{tag}: launched "
                  f"{', '.join(f'{k} x{counts[k]}' for k in kernels)}, no "
                  f"plain version")
            diff = int(np.abs(hist.astype(np.int64)
                              - dhist.astype(np.int64)).sum()) / 2
            share = diff / max(int(dhist.sum(dtype=np.uint64)), 1)
            if cell == "default":
                check(share < HOST_EDGE_SHARE,
                      f"{tag}: mass placed differently from device mode "
                      f"{diff} ({share:.3e} of the histogram) < "
                      f"{HOST_EDGE_SHARE}")
            log(f"  {tag}: replay {stats['replay']}, {passes} passes in "
                f"{stats['elapsed_seconds']:.3f} s; on_canvas_points "
                f"{stats['on_canvas_points']} vs device "
                f"{dstats['on_canvas_points']}; placed differently "
                f"{diff} ({share:.3e}); worker fetch "
                f"{stats['replay_fetch_seconds']} s, replay "
                f"{stats['replay_busy_seconds']} s")
            runs[tag] = (stats, hist)
            record[tag] = dict(
                replay=stats["replay"], elapsed_s=stats["elapsed_seconds"],
                diff=diff, diff_share=share,
                fetch_s=stats["replay_fetch_seconds"],
                replay_s=stats["replay_busy_seconds"], launches=counts)
        s64, h64 = runs["mhcrop uint64"]
        s32, h32 = runs["mhcrop host"]
        check(h64.dtype == np.uint64 and np.array_equal(h64, h32)
              and {k: v for k, v in s64.items() if k not in HOST_ONLY_STATS}
              == {k: v for k, v in s32.items() if k not in HOST_ONLY_STATS},
              "mhcrop: --hist-dtype uint64 (auto: host) == uint32 host, "
              "histogram and counts bitwise")
        check(np.array_equal(h32, refs[("mhcrop", 8)][1]),
              "mhcrop: the host's MH deposit == the device's, bitwise")

        cfg = with_options(cell_config("default"), replay="host",
                           replay_device_share=0.0)
        dp = DataParallelHostReplayEngine(cfg, devices=[dev, dev])
        (hd, sd, _), _ = counted_run(dp, MULTI_PASSES, ("classify",),
                                     "default: DP host x2 on cuda:0")
        total, parts = np.zeros(cfg.canvas.shape, np.uint32), []
        for ordinal in (0, 1):
            eng = CudaEngine(cfg, device=dev)
            st = eng.init_state(None)
            for p in range(MULTI_PASSES):
                eng._worker.make_room()
                eng._worker.submit(eng.stage(*eng.host_pass(st, p, ordinal)))
            total += eng.histogram(st)
            parts.append(eng.stats(st))
        want = sum_stats(
            {k: v for k, v in st_.items() if k not in HOST_ONLY_STATS}
            for st_ in parts)
        got = {k: v for k, v in sd.items() if k not in HOST_ONLY_STATS}
        check(np.array_equal(hd, total) and got == want and sd["replay"]
              == "host" and int(hd.sum(dtype=np.uint64))
              == sd["on_canvas_points"],
              "default: DP host x2 == single host engines at ordinals 0 and "
              "1 summed, histogram and counts bitwise")

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        args = [*cell_args("default"), "-d", "0", "--devices", "2",
                "--replay", "host", "--replay-device-share", "0",
                "--passes", "4", "-t", "-1"]
        procs = []
        for pid in range(2):
            env = dict(os.environ, CUDABROT_COORDINATOR=f"127.0.0.1:{port}",
                       CUDABROT_NUM_PROCESSES="2",
                       CUDABROT_PROCESS_ID=str(pid))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", MULTI_CHILD, ROOT, *args, "-s",
                 os.path.join(tmp, "two.ckpt"), "-o",
                 os.path.join(tmp, "two.pgm")], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        try:
            outs = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                log(f"  process {pid} stdout:\n{out[-2000:]}\nstderr:\n"
                    f"{err[-3000:]}")
        check(all(p.returncode == 0 for p in procs)
              and outs[1][0].strip() == "",
              "two host-replay processes exit 0, process 1 silent")
        one = cfg.replace(max_passes=4, seconds_to_run=-1.0,
                          inprogress_file=os.path.join(tmp, "one.ckpt"))
        res = driver.run_render(
            one, engine=DataParallelHostReplayEngine(one, devices=[dev, dev]),
            log=lambda *_: None)
        pgm.write_pgm(os.path.join(tmp, "one.pgm"),
                      tonemap.tonemap(res.histogram, one.gamma).image)
        h1, _ = ckpt.load(os.path.join(tmp, "one.ckpt"), cfg)
        h2, _ = ckpt.load(os.path.join(tmp, "two.ckpt"), cfg)
        with open(os.path.join(tmp, "one.pgm"), "rb") as a, \
                open(os.path.join(tmp, "two.pgm"), "rb") as b:
            same_pgm = a.read() == b.read()
        check(np.array_equal(h1, h2) and h1.sum() > 0 and same_pgm,
              "two host-replay processes == one process: checkpoint and "
              "PGM bitwise")
    log(f"  phase 11 checks took {time.monotonic() - t0:.1f} s")

    log(f"-- phase 11 times [{card}; {mach['host_cpu']} x "
        f"{available_cores()}]")
    times = {}
    for cell, modes in (("default", (("device", "device", -1.0),
                                     ("host", "host", 0.0),
                                     ("hybrid 0.3", "host", 0.3))),
                        ("zoom", (("device", "device", -1.0),
                                  ("host", "host", 0.0))),
                        ("bigcanvas", (("device", "device", -1.0),
                                       ("host", "host", 0.0),
                                       ("hybrid 0.3", "host", 0.3)))):
        for name, mode, share in modes:
            eng = CudaEngine(with_options(cell_config(cell), replay=mode,
                                          replay_device_share=share),
                             device=dev)
            tm = host_timing(eng, 4)
            if eng._worker is not None:
                n_valid_payload = eng.host_pass(eng.init_state(None), 99)
                tm["payload_bytes"] = (n_valid_payload[1].numel()
                                       * n_valid_payload[1].element_size())
            times[f"{cell} {name}"] = tm
            log(f"  {cell} {name}: {json.dumps(tm)}")
            del eng
    eng = CudaEngine(with_options(cell_config("default"), replay="host",
                                  replay_device_share=0.0), device=dev)
    state = eng.init_state(None)
    busy, span, ms = device_profile(eng, state, 0, 8)
    eng.histogram(state)
    times["default host busy"] = busy
    log(f"  default host: device busy share {busy} over {span} ms; "
        f"device ms a pass {json.dumps(ms)}")
    record["times"] = times
    log(f"phase 11 record: {json.dumps(record)}")
    return {tag: v["launches"] for tag, v in record.items()
            if isinstance(v, dict) and "launches" in v}



# ----------------------------------------------------------------------
# Phase 12: repeatability; --sanitize: the compute-sanitizer sweep.

#: Runs of each kernel on guarded clones of one captured input. Run r fills
#: every output its wrapper allocates, and the margins around every tensor
#: of the call, with the byte POISON[r % len(POISON)]. With REPEAT_SEEDS
#: and REPEAT_PLAIN_SEEDS the phase took 40.4 s on an H100 80GB HBM3
#: (700 W), the script's time limit allowing ~60.
REPEAT_RUNS = 16
POISON = (0x00, 0xFF, 0xA5, 0x7F)
#: Bytes of margin before and after every guarded tensor.
MARGIN = 4096
#: classify at the default cell's lane count: phase 2's two bands (band,
#: steps, flush, warm passes), REPEAT_SEEDS seeds each run twice from a
#: state carried from seed to seed, then REPEAT_PLAIN_SEEDS seeds through
#: the kernel once and the plain version twice.
REPEAT_BANDS = (((20, 100), 256, 128, 2), ((2000, 20000), 256, 256, 8))
REPEAT_SEEDS = 2000
REPEAT_PLAIN_SEEDS = 16
#: The cells and routes whose main-path pass gives the repeated kernels
#: their inputs: the first call of each kernel in one pass after
#: REPEAT_WARM (deposit_ids on the --scatter pallas route's stream).
REPEAT_CELLS = (("default", "auto"), ("zoom", "auto"), ("mhcrop", "auto"),
                ("mhzoom", "auto"), ("bigcanvas", "bigtiles"),
                ("bigzoom", "bigtiles"), ("default", "pallas"),
                ("deep", "auto"))
REPEAT_WARM = 2
#: Each kernel's wrapper, (module of cudabrot_tpu_torch.ops, function): the
#: engines call them through these module attributes.
WRAPPERS = {
    "classify": ("classify", "classify_pass"),
    "threefry_bits": ("prng", "bits"),
    "replay_deposit": ("binning", "replay_deposit"),
    "deposit_ids": ("binning", "deposit_ids"),
    "classify_ext": ("classify_ext", "classify_pass_ext"),
    "replay_deposit_ext": ("binning", "replay_deposit_ext"),
    "classify_mh": ("classify_mh", "classify_pass_mh"),
    "classify_ext_mh": ("classify_mh", "classify_pass_ext_mh"),
    "mh_deposit": ("binning", "mh_deposit"),
    "replay_ids": ("binning", "replay_ids"),
    "replay_ids_ext": ("binning", "replay_ids_ext"),
    "bigtiles_deposit": ("binning", "bigtiles_deposit"),
    "length_sort": ("length_sort", "length_sort"),
    "pass_counters": ("pass_counters", "pass_counters"),
}
#: Where a mismatch saves its inputs and runs (listed in .gitignore).
DUMP_DIR = os.path.join(ROOT, "chiprun_out")


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def tree_map(fn, x):
    """``fn`` applied to every tensor in nested tuples, named tuples,
    lists and dicts; everything else as it is."""
    import torch

    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: tree_map(fn, v) for k, v in x.items()}
    return x


def tree_leaves(x, path="") -> list:
    """(path, tensor) of every tensor in ``x``, in a fixed order (a lone
    tensor's path is "output")."""
    import torch

    if isinstance(x, torch.Tensor):
        return [(path or "output", x)]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        items = zip(x._fields, x)
    elif isinstance(x, (tuple, list)):
        items = enumerate(x)
    elif isinstance(x, dict):
        items = x.items()
    else:
        return []
    return [leaf for k, v in items
            for leaf in tree_leaves(v, f"{path}.{k}" if path else str(k))]


class Guard:
    """Tensors on one device, each carved from a larger buffer between two
    margins of MARGIN bytes. The margins, and the body of every tensor a
    wrapper allocates with torch.empty or torch.empty_like inside
    ``outputs()``, hold one byte. A kernel that leaves an element of its
    output unwritten, or reads past a tensor, gives another result under
    another byte; one that writes past a tensor changes a margin."""

    def __init__(self, byte: int, device):
        import torch

        self.byte, self.device, self.bufs = byte, torch.device(device), []

    def alloc(self, shape, dtype):
        import math

        import torch

        shape = tuple(int(s) for s in shape)
        n = math.prod(shape) * dtype.itemsize
        buf = torch.full((2 * MARGIN + n,), self.byte, dtype=torch.uint8,
                         device=self.device)
        self.bufs.append((buf, n))
        return buf[MARGIN:MARGIN + n].view(dtype).view(shape)

    def clone(self, x):
        return self.alloc(x.shape, x.dtype).copy_(x)

    def _here(self, device) -> bool:
        import torch

        d = torch.device(device)
        return d.type == self.device.type and (d.index or 0) == (
            self.device.index or 0)

    @contextlib.contextmanager
    def outputs(self):
        import torch

        real, real_like = torch.empty, torch.empty_like

        def empty(*size, dtype=None, device=None, **kw):
            if device is None or kw or not self._here(device):
                return real(*size, dtype=dtype, device=device, **kw)
            if len(size) == 1 and hasattr(size[0], "__len__"):
                size = size[0]
            return self.alloc(size, dtype or torch.get_default_dtype())

        def empty_like(x, **kw):
            if kw or not self._here(x.device):
                return real_like(x, **kw)
            return self.alloc(x.shape, x.dtype)

        with mock.patch.object(torch, "empty", empty), \
                mock.patch.object(torch, "empty_like", empty_like):
            yield self

    def broken_margins(self) -> int:
        """Guarded tensors with a changed margin byte."""
        return sum(
            not bool((buf[:MARGIN] == self.byte).all()
                     and (buf[MARGIN + n:] == self.byte).all())
            for buf, n in self.bufs)


@contextlib.contextmanager
def capturing(store: dict):
    """While active, the first call of each kernel's wrapper (WRAPPERS) is
    recorded in ``store`` as (function, args, kwargs), its tensors cloned
    just before the call (some calls update their inputs in place)."""
    import importlib

    import torch

    def shim(name, real):
        def call(*args, **kw):
            if name not in store:
                dev = next((t.device for _, t in tree_leaves((args, kw))),
                           torch.device("cpu"))
                sync(dev)
                store[name] = (real, tree_map(torch.Tensor.clone, args),
                               tree_map(torch.Tensor.clone, kw))
                sync(dev)
            return real(*args, **kw)
        return call

    with contextlib.ExitStack() as stack:
        for name, (mod, fn) in WRAPPERS.items():
            m = importlib.import_module(f"cudabrot_tpu_torch.ops.{mod}")
            stack.enter_context(
                mock.patch.object(m, fn, shim(name, getattr(m, fn))))
        yield store


def capture_calls(dev, cells, warm=REPEAT_WARM, cfg_of=None) -> dict:
    """The first call of each kernel in one engine pass of each cell (after
    ``warm`` passes; ``cfg_of(name, route)`` gives its configuration), as
    ``capturing`` records it."""
    from cudabrot_tpu_torch.engines import cuda_engine as ce

    cfg_of = cfg_of or cell_config
    store = {}
    for name, route in cells:
        eng = ce.CudaEngine(cfg_of(name, route), device=dev)
        state = eng.init_state(None)
        for p in range(warm):
            eng.run_pass(state, p)
        with capturing(store):
            eng.run_pass(state, warm)
            if eng.mh:
                eng.mh_tail_core(state)
        eng.synchronize()
    return store


def flat_bits(t):
    """``t`` flattened, float32 viewed as int32 (NaNs compare by bits)."""
    import torch

    t = t.reshape(-1)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def leaves_equal(a, b) -> bool:
    return len(a) == len(b) and all(same_bits(x, y)
                                    for (_, x), (_, y) in zip(a, b))


def lane_place(i: int, lanes: int, per_thread: int) -> str:
    """Flat index ``i`` of a ([lead,] lanes) array under csrc/classify.cu's
    layout: thread t of global warp g holds lanes (g * S + j) * 32 + t."""
    lead, lane = divmod(i, lanes)
    g, j = divmod(lane // 32, per_thread)
    return (f"lane {lane} = (block {g // 4}, warp {g}, thread {lane % 32}, "
            f"sub-lane {j}, window/row {lead})")


def describe_mismatch(tag, first, got, lanes=0, per_thread=1) -> list:
    """Prints the tensors that differ between two runs, in how many
    elements, and the first few with both bit patterns in hex (for the f32
    classify kernel, ``lanes`` > 0, as places in its warps); returns their
    paths."""
    import torch

    differ = []
    for (path, a), (_, b) in zip(first, got):
        if same_bits(a, b):
            continue
        av, bv = flat_bits(a), flat_bits(b)
        idx = torch.nonzero(av != bv).reshape(-1)
        differ.append(path)
        log(f"  MISMATCH {tag}: {path} differs in {idx.numel()} of "
            f"{av.numel()} elements")
        width = 2 * av.element_size()
        mask = (1 << (8 * av.element_size())) - 1
        for i in idx[:5].tolist():
            where = (lane_place(i, lanes, per_thread) if lanes
                     and tuple(a.shape[-2:]) == (lanes // 128, 128)
                     else f"[{i}]")
            log(f"    {where}: {int(av[i]) & mask:0{width}x} vs "
                f"{int(bv[i]) & mask:0{width}x}")
    return differ


#: Tensors above this size are saved as their differing elements only.
EVIDENCE_FULL_BYTES = 16 << 20


def save_evidence(tag, inputs, base, others) -> str:
    """Saves a mismatch under DUMP_DIR: the inputs and the ``base`` run's
    tensors ((label, [(path, tensor)])), each in full up to
    EVIDENCE_FULL_BYTES, and for every run of ``others`` ({label:
    [(path, tensor)]}) the elements that differ from the base run (flat
    index, value, base value). Returns the file's path."""
    import torch

    def full(leaves):
        return {p: t.cpu() for p, t in leaves
                if t.numel() * t.element_size() <= EVIDENCE_FULL_BYTES}

    data = {"input": full(inputs), base[0]: full(base[1])}
    for label, leaves in others.items():
        diff = {}
        for (p, a), (_, b) in zip(base[1], leaves):
            av, bv = flat_bits(a), flat_bits(b)
            idx = torch.nonzero(av != bv).reshape(-1)[: 1 << 20]
            if idx.numel():
                diff[p] = {"index": idx.cpu(), "value": bv[idx].cpu(),
                           "base": av[idx].cpu()}
        data[label] = diff
    os.makedirs(DUMP_DIR, exist_ok=True)
    path = os.path.join(DUMP_DIR, "mismatch_" + "".join(
        c if c.isalnum() else "_" for c in tag) + ".pt")
    torch.save(data, path)
    log(f"  saved the inputs and every run to {path}")
    return path


def repeat_call(name, call, runs, dev, tag="", lanes=0, per_thread=1,
                inputs=()):
    """``call(guard)`` ``runs`` times, each under a Guard of the next POISON
    byte; returns its tensors (path, tensor) after the first run. Every
    run's tensors must equal the first run's bitwise and keep their
    margins. A mismatch prints and saves both runs and ``inputs``
    ((path, tensor) pairs; describe_mismatch, save_evidence)."""
    first = None
    for r in range(runs):
        guard = Guard(POISON[r % len(POISON)], dev)
        with guard.outputs():
            leaves = tree_leaves(call(guard))
        sync(dev)
        broken = guard.broken_margins()
        if broken:
            raise SmokeFailure(f"{name}{tag}: run {r} changed the margin of "
                               f"{broken} guarded tensors")
        if first is None:
            first = [(p, t.clone()) for p, t in leaves]
        elif not leaves_equal(first, leaves):
            label = f"{name}{tag} run {r}"
            differ = describe_mismatch(label, first, leaves, lanes,
                                       per_thread)
            save_evidence(label, inputs, ("run 0", first),
                          {f"run {r}": leaves})
            raise SmokeFailure(f"{name}{tag}: run {r} differs from run 0 "
                               f"in {', '.join(differ)}")
    return first


def hold_classify(tag, state, seed, spec, plain_args, runs):
    """Holds f32 classify runs on one input ``state`` to each other: ``runs``
    is {label: ClassifyResult}, the first the kernel's. Where any two
    differ, runs the kernel (the build classify_pass loads here) and the
    plain version once more on clones of the same state, prints which runs
    agree with which and what differs, saves the input and every run
    (save_evidence) and fails."""
    from cudabrot_tpu_torch.ops import classify as cls

    leaves = {k: tree_leaves(v) for k, v in runs.items()}
    base = next(iter(leaves.items()))
    if all(leaves_equal(base[1], v) for v in leaves.values()):
        return
    leaves["kernel again"] = tree_leaves(cls.classify_pass(
        clone_state(state), seed, **spec))
    leaves["plain again"] = tree_leaves(cls.classify_pass_plain(
        clone_state(state), *seed, None, **plain_args))
    names = list(leaves)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            same = leaves_equal(leaves[a], leaves[b])
            log(f"  {tag}: {a} {'==' if same else '!='} {b}")
    lanes = state.cr.numel()
    other = next(k for k, v in leaves.items()
                 if not leaves_equal(base[1], v))
    differ = describe_mismatch(f"{tag}: {base[0]} vs {other}", base[1],
                               leaves[other], lanes, package_lanes())
    save_evidence(tag, tree_leaves(state), base,
                  {k: v for k, v in leaves.items() if k != base[0]})
    raise SmokeFailure(f"{tag}: {base[0]} and {other} differ in "
                       f"{', '.join(differ)}")


def plain_classify_args(spec, tn, cfg, steps, flush) -> dict:
    """classify_pass_plain's keywords for classify_spec's ``spec``."""
    return dict(
        fractal=spec["fractal"], min_it=tn.min_it, max_it=tn.max_it,
        chunks=steps // flush, windows=flush // tn.inner_unroll,
        unroll=tn.inner_unroll, thin=tn.thin_tracking, detect=True,
        sample_domain=cfg.sample_domain, visit_window=None)


def repeat_classify(dev, seeds=REPEAT_SEEDS, plain_seeds=REPEAT_PLAIN_SEEDS,
                    lane_rows=None):
    """classify at phase 2's two bands: ``seeds`` seeds, each run twice
    (fills 0x00 and 0xFF) from one state carried on from seed to seed;
    then ``plain_seeds`` seeds through the kernel once and the plain
    version twice, all three bitwise equal (hold_classify). Returns the
    runs."""
    from cudabrot_tpu_torch.config import IterationBand, RenderConfig
    from cudabrot_tpu_torch.ops import classify as cls

    runs = 0
    for band, steps, flush, warm in REPEAT_BANDS:
        cfg = RenderConfig(band=IterationBand(
            min_escape_iterations=band[0], max_escape_iterations=band[1]))
        spec, tn = classify_spec(cfg, steps, flush)
        args = plain_classify_args(spec, tn, cfg, steps, flush)
        rows = lane_rows or cfg.options.lane_rows
        state = cls.init_lane_state(rows, dev)
        for p in range(warm):
            cls.classify_pass(state, (1337, p), **spec)
        t0 = time.monotonic()
        for s in range(seeds):
            seed = (0x5EED, (band[1] << 16) + s)

            def call(g, state=state, seed=seed):
                a = tree_map(g.clone, state)
                return cls.classify_pass(a, seed, **spec)

            first = repeat_call("classify", call, 2, dev,
                                f" band {band} seed {s}", rows * 128,
                                package_lanes(), tree_leaves(state))
            state = cls.LaneState(*(t for _, t in first[:len(state)]))
            runs += 2
        sync(dev)
        log(f"  classify band {band}, {rows * 128} lanes, {steps} steps: "
            f"{seeds} seeds x 2 runs bitwise equal "
            f"({time.monotonic() - t0:.1f} s)")
        t0 = time.monotonic()
        for s in range(plain_seeds):
            seed = (0x9A1E, (band[1] << 16) + s)
            ra = cls.classify_pass(clone_state(state), seed, **spec)
            rp = [cls.classify_pass_plain(clone_state(state), *seed, None,
                                          **args) for _ in range(2)]
            hold_classify(f"classify band {band} plain seed {s}", state,
                          seed, spec, args, {"kernel": ra, "plain": rp[0],
                                             "plain twice": rp[1]})
            state = ra.state
            runs += 1
        log(f"  classify band {band}: {plain_seeds} seeds, the kernel and "
            f"the plain version twice, bitwise equal "
            f"({time.monotonic() - t0:.1f} s)")
    return runs


def phase_repeat(dev, cells=REPEAT_CELLS, cfg_of=None, seeds=REPEAT_SEEDS,
                 plain_seeds=REPEAT_PLAIN_SEEDS, lane_rows=None):
    """Phase 12: every kernel run REPEAT_RUNS times on guarded clones of
    the input its cell's main-path pass gave it (an input it updates in
    place is compared after the call with its outputs), then classify over
    many seeds at the default cell's lane count (repeat_classify). Returns
    the runs of each kernel."""
    log("== phase 12: repeatability")
    t0 = time.monotonic()
    store = capture_calls(dev, cells, cfg_of=cfg_of)
    check(set(store) == set(KERNELS),
          f"phase 12: captured an input of every kernel "
          f"({len(store)} of {len(KERNELS)})")
    tries = {}
    for name in KERNELS:
        fn, args, kw = store.pop(name)

        def run(g, fn=fn, args=args, kw=kw):
            a, k = tree_map(g.clone, args), tree_map(g.clone, kw)
            return fn(*a, **k), a, k

        lanes = args[0].cr.numel() if name == "classify" else 0
        first = repeat_call(name, run, REPEAT_RUNS, dev, lanes=lanes,
                            per_thread=package_lanes(),
                            inputs=tree_leaves((args, kw)))
        shapes = ", ".join(f"{tuple(t.shape)}" for p, t in first
                           if p.startswith("0"))
        log(f"  ok: {name}: {REPEAT_RUNS} runs bitwise equal, margins "
            f"intact (outputs {shapes})")
        tries[name] = REPEAT_RUNS
    tries["classify"] += repeat_classify(dev, seeds, plain_seeds,
                                         lane_rows)
    log(f"phase 12 runs: {json.dumps(tries)}; "
        f"{time.monotonic() - t0:.1f} s")
    return tries


#: The compute-sanitizer tools of --sanitize, each over the whole target.
SANITIZE_TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
#: The sanitizer target's geometry: a few windows of a few thousand lanes
#: on a small canvas, for every cell kind (cell, route, extra arguments;
#: the df32 and MH cells at a band their lanes finish in).
SANITIZE_GEOMETRY = ["-w", "64", "-h", "48", "--lane-rows", "16",
                     "--steps-per-pass", "512", "--steps-per-flush", "128",
                     "--replay-capacity", "8192", "--mh-burnin", "0"]
SANITIZE_CELLS = (("default", "auto"), ("zoom", "auto"), ("mhcrop", "auto"),
                  ("mhzoom", "auto"), ("default", "bigtiles"),
                  ("zoom", "bigtiles"), ("default", "pallas"),
                  ("deep", "auto"))
SANITIZE_BAND = ["-m", "400", "-c", "20"]


def sanitize_config(name, route):
    """A cell's configuration at the sanitizer target's geometry."""
    from cudabrot_tpu_torch import cli

    args = [*cell_args(name)[4:], *SANITIZE_GEOMETRY, "--scatter", route]
    if name in ("zoom", "mhzoom"):
        args += SANITIZE_BAND
    if name == "deep":
        # A capacity below the slots: the selection's compaction.
        args += ["--replay-capacity", "4096"]
    return cli.parse_args(args)[0]


def sanitize_target(dev) -> int:
    """The program --sanitize runs under each compute-sanitizer tool: two
    engine passes of each of SANITIZE_CELLS at their small geometry
    (phase 12's capture, which launches every kernel), then
    the launch counts as one JSON line."""
    from cudabrot_tpu_torch.ops import launches

    launches.reset()
    capture_calls(dev, SANITIZE_CELLS, warm=1, cfg_of=sanitize_config)
    sync(dev)
    log("sanitize target launches: " + json.dumps(
        {k: launches.COUNTS[k] for k in KERNELS}))
    return 0


def sanitizer_path() -> str:
    """compute-sanitizer beside nvcc; its absence fails --sanitize."""
    from cudabrot_tpu_torch.ops import _build

    path = os.path.join(os.path.dirname(_build.nvcc_path()),
                        "compute-sanitizer")
    if not os.path.exists(path):
        raise SmokeFailure(f"compute-sanitizer not found beside nvcc "
                           f"({path}): --sanitize cannot run")
    return path


def sanitizer_errors(text: str) -> tuple[dict, int]:
    """Errors in compute-sanitizer's output, by kernel: each report (a
    "========= " line and its indented continuation) counts against every
    kernel it names; returns (counts, reports naming no kernel)."""
    import re

    names = re.compile(r"\b(" + "|".join(sorted(KERNELS, key=len,
                                                 reverse=True))
                       + r")(_[a-z]+)?_kernel\b")
    counts, loose, report = dict.fromkeys(KERNELS, 0), 0, []
    skip = ("COMPUTE-SANITIZER", "ERROR SUMMARY", "RACECHECK SUMMARY",
            "Target application returned", "LEAK SUMMARY")

    def close():
        nonlocal loose
        if report and not any(s in report[0] for s in skip):
            hit = {m[0] for m in names.findall("\n".join(report))}
            for k in hit:
                counts[k] += 1
            loose += not hit
        report.clear()

    for line in text.splitlines():
        if not line.startswith("========="):
            continue
        body = line[len("========="):]
        if body.startswith("     "):
            report.append(body)
        else:
            close()
            if body.strip():
                report.append(body.strip())
    close()
    return counts, loose


#: The lines of ``nvidia-smi -q`` that bear on whether a debugging tool
#: can attach to the card.
SMI_FACTS = ("Driver Version", "CUDA Version", "Virtualization",
             "Confidential", "CC State", "Compute Mode", "MIG Mode")


def smi_facts() -> list:
    """SMI_FACTS lines of ``nvidia-smi -q`` (none without nvidia-smi)."""
    import shutil

    smi = shutil.which("nvidia-smi")
    if smi is None:
        return ["nvidia-smi not found"]
    out = subprocess.run([smi, "-q"], capture_output=True, text=True,
                         check=False).stdout
    return [" ".join(ln.split()) for ln in out.splitlines()
            if any(k in ln for k in SMI_FACTS)]


def phase_sanitize(dev, card):
    """--sanitize: the target (sanitize_target) under each SANITIZE_TOOLS
    tool of compute-sanitizer, filtered to the port's kernels, with
    --error-exitcode 1. Prints each tool's verdict per kernel and fails on
    any error, on a kernel the target did not launch, or where the
    sanitizer cannot run on this card."""
    log("== phase 12b: compute-sanitizer sweep of the fourteen kernels")
    cs = sanitizer_path()
    version = subprocess.run([cs, "--version"], capture_output=True,
                             text=True, check=False).stdout.strip()
    log(f"  {cs}: {version.splitlines()[-1] if version else '?'}; {card}")
    regex = "kns=(" + "|".join(sorted(KERNELS)) + ")(_[a-z]+)?_kernel"
    os.makedirs(OUT, exist_ok=True)
    verdicts, failed = {}, []
    for tool in SANITIZE_TOOLS:
        cmd = [cs, "--tool", tool, "--error-exitcode", "1",
               "--kernel-regex", regex, sys.executable,
               os.path.abspath(__file__), "--sanitize-target"]
        t0 = time.monotonic()
        p = subprocess.run(cmd, capture_output=True, text=True, check=False,
                           timeout=900)
        text = p.stdout + p.stderr
        log_path = os.path.join(OUT, f"sanitize_{tool}.log")
        with open(log_path, "w") as f:
            f.write(text)
        took = time.monotonic() - t0
        if "Device not supported" in text:
            log("  the card as nvidia-smi -q reports it: "
                + "; ".join(smi_facts()))
            raise SmokeFailure(
                f"compute-sanitizer --tool {tool} does not support this "
                f"device ({card}): it reports \"Device not supported\" and "
                f"runs no kernel under the tool (log: {log_path})")
        line = next((ln for ln in p.stdout.splitlines()
                     if ln.startswith("sanitize target launches: ")), None)
        launched = json.loads(line.split(": ", 1)[1]) if line else {}
        counts, loose = sanitizer_errors(text)
        verdicts[tool] = {k: ("not launched" if not launched.get(k)
                              else f"{counts[k]} errors") for k in KERNELS}
        log(f"  {tool} (rc {p.returncode}, {took:.1f} s): " + ", ".join(
            f"{k} {v}" for k, v in verdicts[tool].items())
            + (f"; {loose} reports naming no kernel" if loose else ""))
        if (p.returncode != 0 or loose or not line
                or any(v != "0 errors" for v in verdicts[tool].values())):
            failed.append(f"{tool} (rc {p.returncode}, log {log_path})")
    log(f"sanitize verdicts: {json.dumps(verdicts)}")
    if failed:
        raise SmokeFailure(f"compute-sanitizer found errors or did not "
                           f"run every kernel: {'; '.join(failed)}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import cudabrot_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cudabrot_tpu_torch not found next to this "
              f"script ({e})", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    t0 = time.monotonic()
    flags = {
        "--replay-study": lambda: (phase_replay_floor(dev, card),
                                   phase_replay_floor_f32(dev, card)),
        "--multi": lambda: phase_multi(dev, card),
        "--host": lambda: phase_host(dev, card),
        "--repeat": lambda: (phase_classify(dev), phase_repeat(dev)),
        "--sanitize": lambda: phase_sanitize(dev, card),
        "--routes": lambda: (phase_routes(dev, card),
                             phase_deposit_ids(dev, card)),
    }
    if sys.argv[1:] == ["--sanitize-target"]:
        return sanitize_target(dev)
    if sys.argv[1:]:
        unknown = [a for a in sys.argv[1:] if a not in flags]
        if unknown:
            print(f"chip_smoke: unknown flags {unknown}; the flags are "
                  f"{', '.join(flags)}", file=sys.stderr)
            return 2
        try:
            phase_build(sys.argv[1:])
            for flag in sys.argv[1:]:
                flags[flag]()
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        log(card)
        return 0
    try:
        phase_build()
        batches, errs = phase_classify(dev)
        ext_res, ext_tn, ext_cfg, ext_classify = phase_classify_ext(dev)
        mh_res, mh_classify = phase_classify_mh(dev, "mhcrop")
        ext_mh_res, ext_mh_classify = phase_classify_mh(dev, "mhzoom")
        deposit, deposit_errs = phase_deposit(dev, batches)
        errs.update(deposit_errs)
        ext_replay = phase_deposit_ext(dev, ext_res, ext_tn, ext_cfg)
        errs["mh_deposit"] = max(phase_mh_deposit(dev, mh_res, "mhcrop"),
                                 phase_mh_deposit(dev, ext_mh_res, "mhzoom"))
        big_errs, ids_ext_plain = phase_bigtiles_kernels(
            dev, batches, ext_res, ext_tn, ext_cfg)
        errs.update(big_errs)
        del batches, ext_res, mh_res, ext_mh_res
        main_runs = phase_main_path(dev)
        phase_oracle(main_runs["zoom"][0])
        phase_mh_measure()
        main_runs.update(phase_big_cells(dev))
        phase_color()
        phase_replay_floor(dev, card)
        phase_overlap(dev)
        multi_runs = phase_multi(dev, card)
        host_runs = phase_host(dev, card)
        repeat_runs = phase_repeat(dev)
        times = phase_kernel_times(dev, deposit[(1000, 1000)]["atomics_per_ms"])
        # The id routes and their deposit's study run after phase 5, so
        # that its torch.profiler traces follow the same phases as before
        # the routes were ported.
        main_runs.update(phase_routes(dev, card))
        deposit_record = phase_deposit_ids(dev, card)
        kernels = kernel_records(
            times, main_runs, errs,
            dict(classify_ext=ext_classify, replay_deposit_ext=ext_replay,
                 classify_mh=mh_classify, classify_ext_mh=ext_mh_classify,
                 replay_ids_ext=dict(plain_ms=ids_ext_plain)),
            deposit_record)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"deposit_ids records: "
        f"{json.dumps({f'{w}x{h}': r for (w, h), r in deposit.items()})}")
    log("main-path launches: " + ", ".join(
        f"{name} {json.dumps(main_runs[name][1])}"
        for name in main_runs))
    log("phase 10 launches: " + ", ".join(
        f"{name} {json.dumps(c)}" for name, c in multi_runs.items()))
    log("phase 11 launches: " + ", ".join(
        f"{name} {json.dumps(c)}" for name, c in host_runs.items()))
    log(f"phase 12 runs: {json.dumps(repeat_runs)}")
    log(f"chip_smoke took {time.monotonic() - t0:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(f"torch.profiler traced no device activity {PROFILE_RETRIES[0]} "
        f"times and was taken again")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()},
        "profile_retries": PROFILE_RETRIES[0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
