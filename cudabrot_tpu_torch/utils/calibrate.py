"""Measure the machine constants of ``utils.calibration`` on this card and
host, and write them as a calibration JSON.

Port of ``tools/calibrate.py``. It measures, on a CUDA card:

  1. ``classify_op_rate``: the f32 classify kernel at the default cell
     (1000x1000, band [20, 100), auto geometry: 262,144 lanes), its
     operation count (``Tuning.classify_ops``) over its time (CUDA
     events);
  2. ``pass_overhead_seconds``: the host-mode pass's device work besides
     classify (compaction and payload packing, ``CudaEngine.host_pass``);
  3. ``link_rate_bytes``: the card-to-host copy of that pass's payload into
     pinned memory;
  4. ``host_replay_llc_rate``: the native replay (the worker's auto thread
     count) of in-band orbits of the band [1000, 8000) into a 1000x1000
     histogram;
  5. ``host_replay_dram_rate`` and ``device_replay_rate`` (not with
     ``--quick``): the same orbits into a 16000x12000 histogram on the host,
     and through the fused ``replay_deposit`` kernel on the card.

The orbits are the kept batches of engine passes at that band, longest
first as the engine feeds them. The file also records the card (name and
power limit from nvidia-smi) and the host CPU (model, cores); ``load``
ignores those keys.

Usage: python -m cudabrot_tpu_torch.utils.calibrate [-o calibration.json]
           [--quick] [--big-canvas WxH] [-d N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np

#: The replay probes' band (the JAX probe's "production medium band").
PROBE_BAND = (8000, 1000)
#: Orbits of the replay probes: enough to fill the card's replay, and to
#: bury the host replay's per-call cost (8,192 orbits measured a quarter of
#: the LLC rate of 131,072 on an H100's host).
PROBE_ORBITS = 1 << 17


def machine() -> dict:
    """The card's name and power limit, and the host CPU's model and
    cores."""
    from cudabrot_tpu_torch.engines.host_replay import available_cores

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    return {"card": smi[0] if smi else "unknown", "host_cpu": host_cpu(),
            "host_cores": available_cores()}


def host_cpu() -> str:
    """The CPU model from /proc/cpuinfo; where a virtual machine hides its
    name, the vendor, family and model numbers."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's block
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        return "unknown"
    name = info.get("model name", "unknown")
    if name != "unknown":
        return name
    return (f"{info.get('vendor_id', 'unknown')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')}")


def _config(width: int, height: int, band=None, **opt):
    from cudabrot_tpu_torch import config as c

    kw = {}
    if band is not None:
        kw["band"] = c.IterationBand(max_escape_iterations=band[0],
                                     min_escape_iterations=band[1])
    return c.RenderConfig(canvas=c.Canvas(width=width, height=height),
                          options=c.EngineOptions(**opt), **kw)


def _event_ms(fn, reps: int) -> float:
    """Milliseconds a call of ``fn`` on the current stream (CUDA events),
    after one warm call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def measure_pass(dev, reps: int = 8) -> dict:
    """classify_op_rate, pass_overhead_seconds and link_rate_bytes at the
    default cell."""
    import itertools

    import torch

    from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine
    from cudabrot_tpu_torch.engines.host_replay import PinnedStage

    eng = CudaEngine(_config(1000, 1000), device=dev)
    state = eng.init_state(None)
    passes = itertools.count()
    classify_ms = _event_ms(lambda: eng.classify(state, next(passes)), reps)
    host = CudaEngine(_config(1000, 1000, replay="host",
                              replay_device_share=0.0), device=dev)
    hstate = host.init_state(None)
    out = []
    pass_ms = _event_ms(
        lambda: out.append(host.host_pass(hstate, next(passes))), reps)
    n_valid, payload = out[-1]
    # The copy runs on the stage's stream: timed on the host clock, each
    # one waited for.
    stage = PinnedStage(dev, 2)
    torch.cuda.synchronize(dev)
    stage.stage(n_valid, payload).event.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        stage.stage(n_valid, payload).event.synchronize()
    copy_ms = (time.perf_counter() - t0) * 1e3 / reps
    return {
        "classify_op_rate": eng.tuning.classify_ops / (classify_ms * 1e-3),
        "pass_overhead_seconds": max(pass_ms - classify_ms, 0.0) * 1e-3,
        "link_rate_bytes": payload.numel() * payload.element_size()
        / (copy_ms * 1e-3),
        "_classify_ms": classify_ms, "_host_pass_ms": pass_ms,
        "_payload_bytes": payload.numel() * payload.element_size(),
    }


def probe_batch(dev, n: int):
    """``n`` kept orbits of the probe band, longest first: (cr, ci, iters)
    on ``dev``."""
    import torch

    from cudabrot_tpu_torch.engines.cuda_engine import CudaEngine

    eng = CudaEngine(_config(1000, 1000, band=PROBE_BAND), device=dev)
    state = eng.init_state(None)
    parts, have, p = [], 0, 0
    while have < n:
        (cr, ci, it), _, _ = eng.classify_and_compact(state, p)
        keep = it >= 0
        parts.append((cr[keep], ci[keep], it[keep]))
        have += int(keep.sum())
        p += 1
    cr, ci, it = (torch.cat(x)[:n] for x in zip(*parts))
    order = torch.sort(-it, stable=True).indices
    return cr[order], ci[order], it[order]


def host_rate(canvas, cr, ci, it, threads: int, reps: int = 3) -> float:
    """Native replay points/s of the batch into a zero histogram of
    ``canvas`` (strict orbit, as the engine replays)."""
    from cudabrot_tpu_torch.engines.host_replay import alloc_hist
    from cudabrot_tpu_torch.io import native

    hist = alloc_hist(canvas.shape, np.uint32)
    kw = dict(width=canvas.width, height=canvas.height,
              min_real=canvas.min_real, min_imag=canvas.min_imag,
              delta_real=canvas.delta_real, delta_imag=canvas.delta_imag,
              num_threads=threads, strict=True)
    native.replay_scatter(cr[:4096], ci[:4096], it[:4096], hist, **kw)
    pts = int((it.astype(np.int64) + 1).sum())
    t0 = time.perf_counter()
    for _ in range(reps):
        native.replay_scatter(cr, ci, it, hist, **kw)
    return reps * pts / (time.perf_counter() - t0)


def device_rate(canvas, cr, ci, it, reps: int = 3) -> float:
    """The fused replay_deposit kernel's points/s of the batch into a
    device histogram of ``canvas``."""
    import torch

    from cudabrot_tpu_torch.models import fractals
    from cudabrot_tpu_torch.ops import binning

    fractal = fractals.get_fractal("buddhabrot")
    hist = torch.zeros(canvas.num_pixels, dtype=torch.int32,
                       device=cr.device)
    ms = _event_ms(lambda: binning.replay_deposit(
        hist, cr, ci, it, canvas=canvas, fractal=fractal), reps)
    pts = int((it.to(torch.int64) + 1).sum())
    return pts / (ms * 1e-3)


def calibrate(dev, quick: bool, big: tuple[int, int], log=print):
    """Measure the constants; returns (Calibration, record)."""
    from cudabrot_tpu_torch import config as c
    from cudabrot_tpu_torch.engines.host_replay import available_cores
    from cudabrot_tpu_torch.io import native
    from cudabrot_tpu_torch.utils import calibration

    t0 = time.perf_counter()
    native.load()
    record = {"native_build_seconds": native.build_seconds, **machine()}
    log(f"calibrating on {record['card']}; host {record['host_cpu']}, "
        f"{record['host_cores']} cores")
    updates = measure_pass(dev)
    log(f"  classify {updates['_classify_ms']:.4f} ms a pass -> "
        f"{updates['classify_op_rate']:.4e} operations/s; host-mode pass "
        f"{updates['_host_pass_ms']:.4f} ms -> overhead "
        f"{updates['pass_overhead_seconds']:.4e} s; payload "
        f"{updates['_payload_bytes']} bytes -> "
        f"{updates['link_rate_bytes']:.4e} bytes/s")
    n = PROBE_ORBITS
    cr_d, ci_d, it_d = probe_batch(dev, n)
    cr, ci, it = (x.cpu().numpy() for x in (cr_d, ci_d, it_d))
    threads = available_cores()
    llc = host_rate(c.Canvas(width=1000, height=1000), cr, ci, it, threads)
    updates["host_replay_llc_rate"] = llc
    log(f"  host replay, {threads} threads, {n} orbits of band "
        f"{PROBE_BAND}: 1000x1000 {llc:.4e} points/s")
    if not quick:
        canvas = c.Canvas(width=big[0], height=big[1])
        dram = host_rate(canvas, cr, ci, it, threads)
        updates["host_replay_dram_rate"] = dram
        dev_rate = device_rate(canvas, cr_d, ci_d, it_d)
        updates["device_replay_rate"] = dev_rate
        log(f"  {big[0]}x{big[1]}: host {dram:.4e} points/s, device "
            f"replay_deposit {dev_rate:.4e} points/s")
    record.update({k: v for k, v in updates.items() if k.startswith("_")})
    record["probe_seconds"] = time.perf_counter() - t0
    cal = dataclasses.replace(
        calibration.DEFAULT,
        source=(f"cudabrot_tpu_torch.utils.calibrate{' --quick' * quick} "
                f"on {record['card']}; {record['host_cpu']} x "
                f"{record['host_cores']}"),
        **{k: v for k, v in updates.items() if not k.startswith("_")})
    return cal, record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cudabrot_tpu_torch.utils.calibrate")
    ap.add_argument("-o", "--output", default="calibration.json")
    ap.add_argument("--quick", action="store_true",
                    help="skip the DRAM-canvas and device replay probes")
    ap.add_argument("--big-canvas", default="16000x12000")
    ap.add_argument("-d", "--device", type=int, default=0)
    args = ap.parse_args(argv)

    from cudabrot_tpu_torch.utils import calibration
    from cudabrot_tpu_torch.utils.device import DeviceError, resolve_device

    try:
        dev = resolve_device("cuda", args.device)
    except DeviceError as e:
        print(e)
        return 1
    big = tuple(int(x) for x in args.big_canvas.split("x"))
    cal, record = calibrate(dev, args.quick, big)
    calibration.save(args.output, cal)
    with open(args.output) as f:
        payload = json.load(f)
    payload["machine"] = record
    with open(args.output, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    print(json.dumps(dataclasses.asdict(cal)))
    print(f"wrote {args.output}; activate with --calibration "
          f"{args.output} (or {calibration.ENV_VAR})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
