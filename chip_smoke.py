#!/usr/bin/env python3
"""Chip smoke test of cudabrot_tpu_torch on one NVIDIA GPU (H100).

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each fails the run on any mismatch):
  1. Build the CUDA kernels from csrc/ (one nvcc per source, in parallel)
     and print their registers and spills (nvcc -Xptxas -v).
  2. classify kernel vs its plain PyTorch version, bitwise (lane state,
     emissions, stats), at full lane width from a carried state: the
     default band [20,100) and [2000,20000) (auto inner window, Brent);
     threefry_bits vs its plain version at the default band's slot count.
  3. deposit_ids vs index_add_ bitwise on random ids with sentinels at
     1000x1000 and 6000x4500; replay_deposit vs its plain version bitwise
     on a compacted batch from phase 2.
  4. The main path through cudabrot_tpu_torch.cli.main at 1000x1000, the
     default band and [2000,20000): valid PGM, histogram sum equal to the
     on-canvas points, overflow drops <= 1% of in-band samples, every
     kernel of the path launched, no plain version run.
  5. Kernel times at each cell's main-path shapes (CUDA events) beside
     their bounds, and at the default cell beside their plain versions and
     torch.bincount of the replay's id stream; a torch.profiler profile of
     16 engine passes per cell (device ms per kernel, busy share).

Prints the card's name and power limit, one JSON line of kernel records,
and as its last line {"ok": true, "device": {...}}. Exits non-zero, with
no result line, when CUDA is unavailable or the package is missing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "chip_smoke")

#: Published H100 SXM peaks (NVIDIA data sheet): float32 outside the
#: tensor cores, and HBM3 bandwidth.
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12
#: 32-bit operations per unit of work, counted from csrc/*.cu: a refill
#: draw (Threefry-2x32 + domain map + cull), a replayed orbit point (step
#: + bin), a deposited id, a Threefry word. A classify inner step and
#: window boundary cost INNER_STEP_OPS and BOUNDARY_OPS
#: (engines/cuda_engine.py), the counts its window choice uses.
OPS_DRAW = 140
OPS_REPLAY_POINT = 15
OPS_DEPOSIT_ID = 3
OPS_THREEFRY_WORD = 120

#: The kernels the render's main path launches.
MAIN_PATH_KERNELS = ("classify", "threefry_bits", "replay_deposit")
#: The main path's two cells at 1000x1000: name, CLI band arguments,
#: passes, (min, max) escape band.
CELLS = (
    ("default", [], 20, (20, 100)),
    ("deep", ["-m", "20000", "-c", "2000"], 10, (2000, 20000)),
)


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    log(f"  ok: {what}")


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls (CUDA events)."""
    import torch

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


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / PEAK_OPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def same_bits(a, b) -> bool:
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def clone_state(state):
    from cudabrot_tpu_torch.ops.classify import LaneState

    return LaneState(*(t.clone() for t in state))


# ----------------------------------------------------------------------


def phase_build():
    from cudabrot_tpu_torch.ops import _build

    log("== phase 1: build")
    t0 = time.monotonic()
    _build.build_all()
    log(f"  built {', '.join(_build.LIBS)} in {time.monotonic() - t0:.1f} s")
    for name in _build.LIBS:
        for line in _build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  [{name}] {line.strip()}")


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


def phase_classify(dev):
    """Kernel vs plain version, bitwise, from a carried state."""
    from cudabrot_tpu_torch.config import IterationBand, RenderConfig
    from cudabrot_tpu_torch.ops import classify as cls

    log("== phase 2: classify kernel vs plain, bitwise")
    batches = {}
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
        args = dict(
            fractal=spec["fractal"], min_it=tn.min_it, max_it=tn.max_it,
            chunks=steps // flush, windows=flush // tn.inner_unroll,
            unroll=tn.inner_unroll, thin=tn.thin_tracking, detect=True,
            sample_domain=cfg.sample_domain, visit_window=None,
        )
        rb = cls.classify_pass_plain(b, *seed, None, **args)
        lanes = cfg.options.lane_rows * 128
        tag = f"band {band} U={tn.inner_unroll} lanes={lanes}"
        for name, x, y in zip(cls.LaneState._fields, ra.state, rb.state):
            check(same_bits(x, y), f"{tag}: lane state {name} bitwise")
        check(same_bits(ra.emit_c, rb.emit_c), f"{tag}: emit_c bitwise")
        check(same_bits(ra.emit_it, rb.emit_it), f"{tag}: emit_it bitwise")
        check(same_bits(ra.stats, rb.stats), f"{tag}: stats bitwise")
        n_em = int((ra.emit_it >= 0).sum())
        cyc = int(ra.stats[cls.STAT_CYCLES].sum())
        log(f"  {tag}: {n_em} emissions, {cyc} Brent cycles in the pass")
        check(n_em > 0, f"{tag}: pass emitted")
        batches[band] = (ra, tn)

    from cudabrot_tpu_torch.ops import prng

    n = 32 * 2048 * 128  # the default band's emission slots per pass
    key = prng.fold_in(prng.pass_key(1337, 0, 9), 0x7711)
    check(same_bits(prng.bits(key, n, dev), prng.bits_plain(key, n, dev)),
          f"threefry_bits: {n} words bitwise vs plain")
    return batches


def phase_deposit(dev, batches):
    import torch

    from cudabrot_tpu_torch.config import Canvas
    from cudabrot_tpu_torch.engines.cuda_engine import compact
    from cudabrot_tpu_torch.models.fractals import get_fractal
    from cudabrot_tpu_torch.ops import binning

    log("== phase 3: deposit kernels vs plain, bitwise")
    gen = torch.Generator(device=dev).manual_seed(7)
    records = {}
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
        ms = time_ms(lambda: binning.deposit_ids(hk, ids), 20)
        plain = time_ms(lambda: binning.deposit_ids_plain(hp, ids), 5)
        lib = time_ms(lambda: torch.bincount(ids, minlength=nbins + 1), 5)
        b_ms, b_by = bound_ms(OPS_DEPOSIT_ID * n_ids, 4 * n_ids + 8 * nbins)
        records[(w, h)] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                               bound_ms=b_ms, bound_by=b_by)
        log(f"  deposit_ids {w}x{h}, {n_ids} ids: kernel {ms:.4f} ms, "
            f"index_add_ {plain:.4f} ms, bincount {lib:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")

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
        log(f"  band {band}: {int((it >= 0).sum())} orbits, "
            f"{int(hits_k)} on-canvas points")
    return records


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

    log("== phase 4: main path through cudabrot_tpu_torch.cli.main")
    os.makedirs(OUT, exist_ok=True)
    results = {}
    for name, band_args, passes, _ in CELLS:
        pgm_path = os.path.join(OUT, f"{name}.pgm")
        ckpt_path = os.path.join(OUT, f"{name}.ckpt")
        stats_path = os.path.join(OUT, f"{name}.json")
        for p in (ckpt_path,):
            if os.path.exists(p):
                os.remove(p)
        torch.cuda.reset_peak_memory_stats(dev)
        args = ["-w", "1000", "-h", "1000", *band_args, "--passes",
                str(passes), "-t", "-1", "-o", pgm_path, "-s", ckpt_path,
                "--stats-json", stats_path]
        stats, counts = run_cli(args, stats_path)
        peak = torch.cuda.max_memory_allocated(dev)
        img = pgm.read_pgm(pgm_path)
        check(img.shape == (1000, 1000) and img.dtype == np.uint16
              and int(img.max()) == 65535, f"{name}: valid 1000x1000 PGM")
        hist = np.load(ckpt_path)["hist"]
        check(int(hist.sum(dtype=np.uint64)) == stats["on_canvas_points"],
              f"{name}: histogram sum == on_canvas_points "
              f"({stats['on_canvas_points']})")
        check(stats["replay_dropped"] <= 0.01 * stats["in_band"],
              f"{name}: replay_dropped {stats['replay_dropped']} <= 1% of "
              f"in_band {stats['in_band']}")
        for k in MAIN_PATH_KERNELS:
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
            f"{stats['on_canvas_points'] / el:.4e} deposited points/s; "
            f"peak device memory {peak / 2**20:.1f} MiB")
        log(f"  {name} stats: {json.dumps(stats)}")
        results[name] = (stats, counts)
    return results


#: Device-activity groups of the profile: kernel-name substring -> group.
PROFILE_GROUPS = (("classify_kernel", "classify"),
                  ("threefry_bits", "threefry_bits"),
                  ("replay_deposit", "replay_deposit"))


def device_profile(eng, state, first_pass: int, passes: int):
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
    ms = {g: 0.0 for _, g in PROFILE_GROUPS}
    ms["other"] = 0.0
    for e in device:
        group = next((g for sub, g in PROFILE_GROUPS
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


def replay_ids(cr, ci, it, canvas, fractal):
    """The replay batch's on-canvas bin ids as one stream: what the JAX
    engine's batched replay materializes before its scatter."""
    import torch

    from cudabrot_tpu_torch.models.fractals import step
    from cudabrot_tpu_torch.ops.binning import points_to_bin_ids

    zr, zi, out = cr, ci, []
    for s in range(int(it.max()) + 1):
        zr, zi = step(fractal, zr, zi, cr, ci)
        ids = points_to_bin_ids(canvas, zr, zi, it >= s)
        out.append(ids[ids < canvas.num_pixels])
    return torch.cat(out)


def cell_times(dev, name, band, with_plain):
    """Each main-path kernel at one cell's main-path shapes (CUDA events,
    from a lane state carried over 4 passes), a whole engine pass, and the
    device's busy share. ``with_plain`` adds the plain versions and the
    library calls (the default cell; they take seconds at full width)."""
    import itertools

    import torch

    from cudabrot_tpu_torch.config import IterationBand, RenderConfig
    from cudabrot_tpu_torch.engines.cuda_engine import (
        BOUNDARY_OPS, INNER_STEP_OPS, CudaEngine, compact)
    from cudabrot_tpu_torch.ops import binning, prng
    from cudabrot_tpu_torch.ops import classify as cls

    log(f"== kernel times at the {name} cell's main-path shapes")
    cfg = RenderConfig(band=IterationBand(min_escape_iterations=band[0],
                                          max_escape_iterations=band[1]))
    eng = CudaEngine(cfg, device=dev)
    tn = eng.tuning
    state = eng.init_state(None)
    for p in range(4):
        eng.run_pass(state, p)
    spec = dict(
        fractal=eng.fractal, min_it=tn.min_it, max_it=tn.max_it,
        steps_per_pass=tn.steps_per_pass, steps_per_flush=tn.steps_per_flush,
        cycle_detection=True, inner_unroll=tn.inner_unroll,
        thin_tracking=tn.thin_tracking,
    )
    lanes = state["lanes"]
    key = prng.pass_key(cfg.seed, 0, 5)
    seed = prng.bits_host(key, 2)
    res = cls.classify_pass(clone_state(lanes), seed, **spec)
    k1_ms = time_ms(lambda: cls.classify_pass(lanes, seed, **spec), 10)
    n_lanes = eng.lanes
    lane_steps = tn.steps_per_pass * n_lanes
    windows = lane_steps // tn.inner_unroll
    draws = int(res.stats[cls.STAT_DRAWN].sum())
    slots = tn.emission_slots
    k1_bound, k1_by = bound_ms(
        INNER_STEP_OPS * lane_steps + BOUNDARY_OPS * windows
        + OPS_DRAW * draws,
        n_lanes * (2 * 40 + 20) + slots * 12,
    )

    cr, ci, it, _ = compact(res.emit_c, res.emit_it, key,
                            tn.replay_capacity, tn.max_it)
    hist = torch.zeros(cfg.canvas.num_pixels, dtype=torch.int32, device=dev)
    fr = eng.fractal
    k2_ms = time_ms(lambda: binning.replay_deposit(
        hist, cr, ci, it, canvas=cfg.canvas, fractal=fr), 10)
    orbits = int((it >= 0).sum())
    points = int(torch.where(it >= 0, it + 1, 0).sum())
    k2_bound, k2_by = bound_ms(
        OPS_REPLAY_POINT * points,
        12 * cr.numel() + 8 * cfg.canvas.num_pixels,
    )

    sel_key = prng.fold_in(key, 0x7711)
    k3_ms = time_ms(lambda: prng.bits(sel_key, slots, dev), 20)
    k3_bound, k3_by = bound_ms(OPS_THREEFRY_WORD * slots, 8 * slots)
    t_compact = time_ms(lambda: compact(res.emit_c, res.emit_it, key,
                                        tn.replay_capacity, tn.max_it), 5)
    pass_ids = itertools.count(6)
    pass_ms = time_ms(lambda: eng.run_pass(state, next(pass_ids)), 10)
    busy, span, prof_ms = device_profile(eng, state, 100, 16)

    log(f"  classify: {lane_steps} lane-steps, {draws} draws; kernel "
        f"{k1_ms:.4f} ms, bound {k1_bound:.4f} ms ({k1_by})")
    log(f"  replay_deposit: {orbits} orbits, {points} points; kernel "
        f"{k2_ms:.4f} ms, bound {k2_bound:.4f} ms ({k2_by})")
    log(f"  threefry_bits: {slots} words; kernel {k3_ms:.4f} ms, bound "
        f"{k3_bound:.4f} ms ({k3_by}); whole compaction {t_compact:.4f} ms")
    log(f"  {name} pass (CUDA events, 10 passes): {pass_ms:.4f} ms")
    if busy is None:
        log(f"  {name} device profile: not measured ({span})")
    else:
        parts = ", ".join(f"{g} {v:.4f}" for g, v in prof_ms.items())
        log(f"  {name} device profile of 16 passes (torch.profiler): ms per "
            f"pass {parts}; busy {busy:.4f} of a {span:.3f} ms span "
            f"(idle {1 - busy:.4f})")

    rec = dict(
        classify=dict(ms=k1_ms, bound_ms=k1_bound, bound_by=k1_by,
                      plain_ms=None, library_ms=None),
        threefry_bits=dict(ms=k3_ms, bound_ms=k3_bound, bound_by=k3_by,
                           plain_ms=None, library_ms=None),
        replay_deposit=dict(ms=k2_ms, bound_ms=k2_bound, bound_by=k2_by,
                            plain_ms=None, library_ms=None),
    )
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
    rec["classify"]["plain_ms"] = time_ms(
        lambda: cls.classify_pass_plain(plain_state, *seed, None, **args), 1)
    rec["replay_deposit"]["plain_ms"] = time_ms(
        lambda: binning.replay_deposit_plain(
            hist, cr, ci, it, canvas=cfg.canvas, fractal=fr), 1)
    rec["threefry_bits"]["plain_ms"] = time_ms(
        lambda: prng.bits_plain(sel_key, slots, dev), 5)
    log(f"  plain versions: classify {rec['classify']['plain_ms']:.4f} ms, "
        f"replay_deposit {rec['replay_deposit']['plain_ms']:.4f} ms, "
        f"threefry_bits {rec['threefry_bits']['plain_ms']:.4f} ms")

    # The batch's id stream, materialized, through the library's counting
    # call and through deposit_ids: the deposit half of replay_deposit.
    ids = replay_ids(cr, ci, it, cfg.canvas, fr)
    nbins = cfg.canvas.num_pixels
    hk = torch.zeros(nbins, dtype=torch.int32, device=dev)
    binning.replay_deposit(hk, cr, ci, it, canvas=cfg.canvas, fractal=fr)
    check(torch.equal(torch.bincount(ids, minlength=nbins),
                      hk.to(torch.int64)),
          f"{name}: bincount of the replay's id stream == replay_deposit")
    lib_ms = time_ms(lambda: torch.bincount(ids, minlength=nbins), 5)
    ids_ms = time_ms(lambda: binning.deposit_ids(hist, ids), 10)
    log(f"  the replay batch's {ids.numel()} on-canvas ids, materialized: "
        f"torch.bincount {lib_ms:.4f} ms, deposit_ids {ids_ms:.4f} ms "
        f"(replay_deposit replays and deposits them in {k2_ms:.4f} ms)")
    return rec


def phase_kernel_times(dev, main):
    """Kernel records of the main path: times at the default cell's shapes
    (the deep cell's are printed too), launches from the default run."""
    times = {name: cell_times(dev, name, band, name == "default")
             for name, _, _, band in CELLS}
    sources = dict(
        classify=("cudabrot_tpu_torch/csrc/classify.cu",
                  "cudabrot_tpu/ops/pallas_kernels.py:182"),
        threefry_bits=("cudabrot_tpu_torch/csrc/classify.cu",
                       "cudabrot_tpu/engines/pallas_engine.py:1342"),
        replay_deposit=("cudabrot_tpu_torch/csrc/deposit.cu",
                        "cudabrot_tpu/ops/binning.py:154"),
    )
    launches_main = main["default"][1]
    return [
        dict(name=k, route="cuda", source=sources[k][0],
             replaces=sources[k][1], launches=launches_main[k],
             **times["default"][k])
        for k in MAIN_PATH_KERNELS
    ]


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
    t0 = time.monotonic()
    try:
        phase_build()
        batches = phase_classify(dev)
        deposit = phase_deposit(dev, batches)
        del batches
        main_runs = phase_main_path(dev)
        kernels = phase_kernel_times(dev, main_runs)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"deposit_ids (off the main path) records: "
        f"{json.dumps({f'{w}x{h}': r for (w, h), r in deposit.items()})}")
    log(f"main-path launches: default band "
        f"{json.dumps(main_runs['default'][1])}, [2000,20000) "
        f"{json.dumps(main_runs['deep'][1])}")
    log(f"chip_smoke took {time.monotonic() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip().splitlines()
    log(smi[0] if smi else "nvidia-smi: no output")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
