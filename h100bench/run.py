"""The benchmark of the PyTorch and CUDA Buddhabrot renderer.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

One run of one cell (``BENCHMARK.json``: ``<config>.<traffic>``) on one
process: it builds the render's configuration from the cell's files
through ``cudabrot_tpu_torch.cli.parse_args`` (the seed and the time box
from the arguments), makes the engine, builds or loads the kernels, warms
up on the cell's shapes (one synchronized group of ``pipeline_depth``
passes, then discarded) and renders for ``--seconds`` through
``cudabrot_tpu_torch.driver.run_render``, writing no file. With
``--trace 1`` the whole render is profiled (``hb/trace.py``) and the
per-layer metrics are reported, else the end-to-end ones; each is read by
``h100bench/metrics/<name>.py``. Two passes of the window, of every
replica of a data-parallel render, are checked against the plain
reference (``hb/check.py``). A render over several cards is read card by
card: rates and shares keep their meaning on one card, and
``memory_peak_bytes`` is the fullest card's.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (in-band samples), ``failed`` (those the replay's capacity
dropped), ``metrics``, ``device`` and, traced, ``breakdown``, then the
compared numbers with their limits under ``checks``; the same numbers are
the last lines of standard error. Without a CUDA device, with fewer
devices than the cell asks for, or with JAX or the JAX package loaded once
the window has closed, the run prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_MONO0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
for _p in (str(ROOT), str(BENCH_DIR)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from hb import cells, check, guard  # noqa: E402
from hb import trace as tracing  # noqa: E402


def _started_before() -> float:
    """Seconds from this process's start to ``T_MONO0`` (the kernel's
    start time of the process, in clock ticks since boot); 0 where it
    cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        now_boot = time.clock_gettime(time.CLOCK_BOOTTIME)
        return max(0.0, now_boot - start - (time.monotonic() - T_MONO0))
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device=None, log=None) -> dict:
    """One run of ``cell``; returns the result object. ``device``: None
    for the first CUDA device (the benchmark), "cpu" for tests."""
    import numpy as np
    import torch

    from cudabrot_tpu_torch import driver, engines
    from cudabrot_tpu_torch.cli import parse_args

    say = log or (lambda msg: print(msg, file=sys.stderr))
    t_import = time.monotonic()
    cfg, _ = parse_args(cell.argv(seed, seconds))
    engine = engines.make_engine(cfg, device=device)
    dev = engine.device
    replicas = check.engines_of(engine)
    ref = cells.reference(cell.config)
    plan = ref.plan_of(engine)
    scene = ref.Scene.from_cell(cell.config["canvas"], cell.traffic["band"])

    t_engine = time.monotonic()
    state = engine.init_state(None)
    engine.warmup(state)
    depth = driver.resolve_pipeline_depth(cfg)
    t = time.monotonic()
    state = engine.run_pass(state, 0)
    engine.synchronize()  # the first pass pays the first launches
    t1 = time.monotonic()
    for p in range(1, depth):
        state = engine.run_pass(state, p)
    engine.synchronize()
    pass_s = (time.monotonic() - t1) / max(depth - 1, 1)
    del state
    passes = check.check_passes(seed, seconds, pass_s)
    say(f"set-up: imports {t_import - T_MONO0:.3f} s, engine "
        f"{t_engine - t_import:.3f} s, state and kernels "
        f"{t - t_engine:.3f} s, first pass {t1 - t:.3f} s, then "
        f"{pass_s * 1e3:.3f} ms a pass; checked passes {passes}")
    capture = check.PassCapture(engine, passes)

    marks = {}

    def render_log(msg: str) -> None:
        if msg.startswith("Running for"):
            if trace:
                with torch.profiler.record_function(tracing.WINDOW_MARK):
                    pass
            marks["start"] = time.monotonic()
        say(msg)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    result = driver.run_render(cfg, engine=engine, log=render_log)
    if prof is not None:
        prof.stop()
    setup_s = marks["start"] - T_MONO0 + _started_before()
    cuda = dev.type == "cuda"
    mem_peak = (max(torch.cuda.max_memory_allocated(e.device)
                    for e in replicas) if cuda else 0)
    capture.to_host()

    reduced = None
    if prof is not None:
        t = time.monotonic()
        dev_ev, host_ev, mark = tracing.events_of(prof)
        del prof
        if mark is not None:
            reduced = tracing.reduce_events(
                dev_ev, host_ev, mark, int(result.elapsed_seconds * 1e9),
                tracing.load_layers(), cards=len(replicas))
        say(f"trace: {len(dev_ev)} device and {len(host_ev)} host events, "
            f"reduced in {time.monotonic() - t:.1f} s")
        del dev_ev, host_ev

    stats = result.stats
    hist_sum = int(result.histogram.sum(dtype=np.uint64))
    m = types.SimpleNamespace(
        elapsed_s=result.elapsed_seconds, passes=result.passes,
        hist_sum=hist_sum, setup_s=setup_s, stats=stats, trace=reduced,
        replicas=len(replicas),
        costs=json.loads((BENCH_DIR / "costs.json").read_text()),
        geometry={"lanes": plan.lanes, "pixels": scene.pixels,
                  "emission_slots": replicas[0].tuning.emission_slots})
    metrics = {}
    for entry in (cell.per_layer if trace else cell.end_to_end):
        value = cells.reader(entry["name"])(m)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    t = time.monotonic()
    checks = check.run_checks(ref, capture, seed, plan, scene, dev)
    checks["passes.unchecked"] = {"value": capture.unchecked,
                                  "limit": check.LIMIT}
    checks.update(check.totals_checks(hist_sum, stats))
    say(f"{result.passes} passes in {result.elapsed_seconds:.6f} s; "
        f"reference took {time.monotonic() - t:.1f} s over "
        f"{len(capture.taken)} replica-passes")
    correct = all(v["value"] <= v["limit"] for v in checks.values())

    device_info = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": cell.chips,
        "memory_peak_bytes": int(mem_peak),
    }
    if cuda:
        device_info["power_limit_w"] = power_limit_w()
    out = {"correct": correct, "attempted": int(stats["in_band"]),
           "failed": int(stats["replay_dropped"]), "metrics": metrics,
           "device": device_info}
    if trace:
        device_info["busy_s"] = reduced.busy_s if reduced else 0.0
        device_info["window_s"] = (reduced.window_s if reduced
                                   else result.elapsed_seconds)
        if reduced is not None:
            out["breakdown"] = reduced.breakdown()
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"cell {cell.name} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = guard.forbidden_loaded()
    if bad:
        print(f"the process holds {', '.join(bad)}: the benchmark measures "
              "the PyTorch and CUDA renderer alone", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
