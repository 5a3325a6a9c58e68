"""Host render loop: time-boxing, cancellation, checkpointing, lifecycle.

Port of ``cudabrot_tpu/driver.py`` — the reference's RenderImage
(cudabrot.cu:471-501), SignalHandler (cudabrot.cu:756-760) and the
lifecycle in main (cudabrot.cu:762-791):

  * the histogram and the lane state stay on the device across passes;
    the only device-to-host copy is the final (or periodic-checkpoint)
    readback;
  * time is checked only between passes, and a negative time box runs
    until SIGINT (cudabrot.cu:483-492);
  * SIGINT sets a flag and the current pass completes before a normal
    save/exit (cudabrot.cu:756-760, 483);
  * PyTorch launches asynchronously, so the loop keeps up to
    ``pipeline_depth`` passes in flight and waits once per depth (the
    reference synchronizes every launch, cudabrot.cu:487), and fully
    once at the end, so the elapsed time covers every pass;
  * checkpoints can be written every N passes;
  * in a multi-process run (``parallel.distributed``) every process runs
    the same passes: the stop verdict of each pass is the primary's (its
    clock, its pass count, its SIGINT) or any process's SIGINT
    (``any_flag``); every process reads the histogram at each readback
    (a collective) and only the primary writes files;
  * while a ``torch.profiler`` records, the loop and the engine's layers
    open spans (``utils.trace``), and the render's stats carry their
    snapshot under ``trace``.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Callable

import numpy as np

from cudabrot_tpu_torch import engines
from cudabrot_tpu_torch.config import RenderConfig
from cudabrot_tpu_torch.io import checkpoint as ckpt
from cudabrot_tpu_torch.parallel import distributed
from cudabrot_tpu_torch.utils import trace

#: In-flight passes between synchronizations at pipeline_depth 0 (auto).
DEFAULT_PIPELINE_DEPTH = 8


@dataclasses.dataclass
class RenderResult:
    histogram: np.ndarray  # uint32 (H, W)
    passes: int
    elapsed_seconds: float
    stats: dict
    engine_name: str
    interrupted: bool


class SigintFlag:
    """Cooperative-cancellation flag (SignalHandler, cudabrot.cu:756-760)."""

    def __init__(self, log: Callable[[str], None]):
        self._log = log
        self.triggered = False
        self._previous = None

    def _handler(self, signum, frame):
        self.triggered = True
        self._log(
            f"Signal {signum} received, waiting for current pass to finish..."
        )

    def __enter__(self):
        try:
            self._previous = signal.signal(signal.SIGINT, self._handler)
        except ValueError:  # non-main thread: run uninterruptible
            self._previous = None
        return self

    def __exit__(self, *exc):
        if self._previous is not None:
            signal.signal(signal.SIGINT, self._previous)
        return False


def _write_preview(cfg: RenderConfig, hist: np.ndarray) -> None:
    """Tone-map and save an in-progress preview (atomic via tmp+rename so
    a watcher never reads a torn file)."""
    from cudabrot_tpu_torch.io import png as png_io
    from cudabrot_tpu_torch.ops import tonemap as tonemap_op

    image = tonemap_op.tonemap(hist, cfg.gamma).image
    directory = os.path.dirname(os.path.abspath(cfg.preview_file)) or "."
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".png.tmp")
    os.close(fd)
    try:
        png_io.write_png(tmp, image)
        os.replace(tmp, cfg.preview_file)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _warn_calibration_drift(cfg: RenderConfig, engine, log) -> None:
    """One line when the host worker's measured replay rate differs 2x or
    more from the calibration's ``host_replay_dram_rate``, the constant
    that sizes the big-canvas hybrid share (the JAX driver's check). Only
    canvases of 256 MiB and more: smaller ones replay from the LLC, whose
    rate varies with orbit length, and the solve uses another constant
    there."""
    from cudabrot_tpu_torch.engines.cuda_engine import BIG_HISTOGRAM_BYTES
    from cudabrot_tpu_torch.utils import calibration

    worker = getattr(engine, "_worker", None)
    if worker is None:
        return
    # Enough work for a stable rate.
    if worker.points < 1_000_000 or worker.replay_seconds < 0.5:
        return
    if cfg.canvas.histogram_nbytes < BIG_HISTOGRAM_BYTES:
        return
    expected = calibration.active().host_replay_dram_rate
    observed = worker.points / worker.replay_seconds
    ratio = observed / expected
    if 0.5 < ratio < 2.0:
        return
    log(
        f"Calibration drift: host replay measured {observed:.2e} pts/s vs "
        f"the model's {expected:.2e} (DRAM regime, x{ratio:.2f}). "
        "Auto-tuned replay shares may be mis-sized on this machine — run "
        "python -m cudabrot_tpu_torch.utils.calibrate and pass "
        "--calibration (or set CUDABROT_TPU_TORCH_CALIBRATION)."
    )


def resolve_pipeline_depth(cfg: RenderConfig) -> int:
    """Passes in flight between synchronizations (explicit, else 8)."""
    if cfg.options.pipeline_depth > 0:
        return cfg.options.pipeline_depth
    return DEFAULT_PIPELINE_DEPTH


def _synchronize(engine, state, drain: bool) -> None:
    """The loop's wait, in a ``cb.sync`` span: at the end of a group of
    passes (``drain``) the engine's ``sync_group`` where it has one (the
    card's fused route leaves its last replays running there), else
    ``synchronize``; at the end of the render a full ``synchronize``.
    Traced, the tracer marks the drained main stream before the wait and
    the completed events after it."""
    with trace.span("cb.sync"):
        if drain:
            trace.mark_drain(engine)
            getattr(engine, "sync_group", engine.synchronize)()
        else:
            engine.synchronize()
    trace.after_sync(state, engine, group=drain)


def run_render(
    cfg: RenderConfig,
    engine=None,
    log: Callable[[str], None] = print,
    device=None,
) -> RenderResult:
    """Execute a full render job: resume -> pass loop -> final readback.

    Runs on CUDA unless ``device`` (or the given engine's device) says
    otherwise. Image tone-mapping and encoding are left to the caller
    (cli.run), so library users get the raw histogram. A resume loads on
    every process; the engine counts the loaded histogram once.
    """
    engine = engine or engines.make_engine(cfg, device=device)
    multiproc = distributed.process_count() > 1
    primary = distributed.is_primary()

    hist0 = None
    resumed_passes = 0
    if cfg.inprogress_file:
        log(f"Loading previous image state from {cfg.inprogress_file}.")
        loaded = ckpt.load(cfg.inprogress_file, cfg)
        if loaded is None:
            log(f"File {cfg.inprogress_file} doesn't exist yet. Not loading.")
        else:
            hist0, meta = loaded
            resumed_passes = int(meta.get("passes", 0))

    # Memory estimate banner (SetupCUDA parity, cudabrot.cu:154-165).
    device_bytes, host_bytes = engine.memory_estimate()
    log(
        f"Approximate memory needed: "
        f"{device_bytes / (1024.0 * 1024.0):.3f} MiB device, "
        f"{host_bytes / (1024.0 * 1024.0):.3f} MiB host"
    )

    state = engine.init_state(hist0)
    engine.warmup(state)

    log("Calculating Buddhabrot.")
    if cfg.seconds_to_run < 0:
        log("Press ctrl+C to finish.")
    else:
        log(f"Running for {cfg.seconds_to_run:.3f} seconds.")

    profiler = None
    if cfg.profile_dir:
        import torch.profiler as tprof

        profiler = tprof.profile(activities=[
            tprof.ProfilerActivity.CPU, tprof.ProfilerActivity.CUDA,
        ])
        profiler.__enter__()

    # Spans at the pass's layers, on while a profiler records (the
    # benchmark's traced run, --profile-dir); off, each costs one read.
    if trace.profiler_recording():
        trace.start()
    depth = resolve_pipeline_depth(cfg)
    passes = 0
    start = time.monotonic()
    last_progress = start
    try:
        with SigintFlag(log) as flag:
            while True:
                stop = flag.triggered
                if cfg.max_passes is not None and passes >= cfg.max_passes:
                    stop = True
                if (
                    passes > 0
                    and cfg.seconds_to_run >= 0
                    and (time.monotonic() - start) > cfg.seconds_to_run
                ):
                    stop = True
                if multiproc:
                    # The primary contributes the whole verdict (its clock
                    # owns the time box); the others their own SIGINT, so
                    # ctrl+C on any process stops every one on the same
                    # pass.
                    stop = distributed.any_flag(
                        stop if primary else flag.triggered)
                if stop:
                    break
                with trace.span("cb.pass", device=engine.device,
                                pass_index=resumed_passes + passes):
                    state = engine.run_pass(state, resumed_passes + passes)
                passes += 1
                if passes % depth == 0:
                    _synchronize(engine, state, drain=True)
                    now = time.monotonic()
                    if (
                        cfg.progress_interval > 0
                        and now - last_progress >= cfg.progress_interval
                    ):
                        # Every pass enqueued has completed but for its
                        # last replays: the rate is the device's, not the
                        # enqueue's.
                        steps = engine.steps_per_pass * passes
                        log(
                            f"  pass {passes}: {now - start:.1f}s elapsed, "
                            f"~{steps / (now - start):.3e} lane-steps/s"
                        )
                        last_progress = now
                if (
                    cfg.checkpoint_interval > 0
                    and passes % cfg.checkpoint_interval == 0
                    and (cfg.inprogress_file or cfg.preview_file)
                ):
                    # A collective in multi-process runs: every process
                    # reads, only the primary writes.
                    with trace.span("cb.checkpoint"):
                        snapshot = engine.histogram(state)
                        if primary and cfg.inprogress_file:
                            ckpt.save(
                                cfg.inprogress_file,
                                snapshot,
                                cfg,
                                resumed_passes + passes,
                            )
                        if primary and cfg.preview_file:
                            _write_preview(cfg, snapshot)
            interrupted = flag.triggered

        _synchronize(engine, state, drain=False)
        elapsed = time.monotonic() - start
    finally:
        traced = trace.stop()
    if profiler is not None:
        profiler.__exit__(None, None, None)
        os.makedirs(cfg.profile_dir, exist_ok=True)
        profiler.export_chrome_trace(
            os.path.join(cfg.profile_dir, "trace.json")
        )
    hist = engine.histogram(state)
    log(f"{passes} Buddhabrot passes took {elapsed:f} seconds.")
    stats = engine.stats(state)
    if traced is not None:
        stats["trace"] = traced
    _warn_calibration_drift(cfg, engine, log)
    dropped = int(stats.get("replay_dropped", 0))
    in_band = int(stats.get("in_band", 0))
    if dropped > 0.01 * max(in_band, 1):
        # Overflow thinning is unbiased (the kept subset is selected by a
        # uniform key, cuda_engine.compact): it costs render efficiency,
        # not statistical correctness.
        log(
            f"Warning: {dropped} of {in_band} in-band samples overflowed "
            "the emission capacity and were dropped (unbiased thinning; "
            "wasted classify work). Raise --replay-capacity or shrink "
            "the --sample-domain window."
        )

    lost_w = int(stats.get("mh_lost_weight", 0))
    if lost_w > 0.02 * max(int(stats.get("on_canvas_points", 0)) + lost_w, 1):
        # An MH deposit path that forfeits tenure mass reports it here; the
        # kernel-recorded bins deposit conserves it, so this stays silent.
        log(
            f"Warning: {lost_w} units of MH tenure mass found no "
            "on-canvas points at replay (trajectory-drift class); "
            "if this grows, the band/crop combination is degenerate."
        )

    if cfg.inprogress_file and primary:
        log(f"Saving in-progress buffer to {cfg.inprogress_file}.")
        ckpt.save(cfg.inprogress_file, hist, cfg, resumed_passes + passes)

    return RenderResult(
        histogram=hist,
        passes=passes,
        elapsed_seconds=elapsed,
        stats=stats,
        engine_name=engine.name,
        interrupted=interrupted,
    )
