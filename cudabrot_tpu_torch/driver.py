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
    ``pipeline_depth`` passes in flight and synchronizes once per depth
    (the reference synchronizes every launch, cudabrot.cu:487);
  * checkpoints can be written every N passes.
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


def resolve_pipeline_depth(cfg: RenderConfig) -> int:
    """Passes in flight between synchronizations (explicit, else 8)."""
    if cfg.options.pipeline_depth > 0:
        return cfg.options.pipeline_depth
    return DEFAULT_PIPELINE_DEPTH


def run_render(
    cfg: RenderConfig,
    engine=None,
    log: Callable[[str], None] = print,
    device=None,
) -> RenderResult:
    """Execute a full render job: resume -> pass loop -> final readback.

    Runs on CUDA unless ``device`` (or the given engine's device) says
    otherwise. Image tone-mapping and encoding are left to the caller
    (cli.run), so library users get the raw histogram.
    """
    engine = engine or engines.make_engine(cfg, device=device)

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

    depth = resolve_pipeline_depth(cfg)
    passes = 0
    start = time.monotonic()
    last_progress = start
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
            if stop:
                break
            state = engine.run_pass(state, resumed_passes + passes)
            passes += 1
            if passes % depth == 0:
                engine.synchronize()
            now = time.monotonic()
            if (
                cfg.progress_interval > 0
                and now - last_progress >= cfg.progress_interval
            ):
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
                snapshot = engine.histogram(state)
                if cfg.inprogress_file:
                    ckpt.save(
                        cfg.inprogress_file,
                        snapshot,
                        cfg,
                        resumed_passes + passes,
                    )
                if cfg.preview_file:
                    _write_preview(cfg, snapshot)
        interrupted = flag.triggered

    engine.synchronize()
    elapsed = time.monotonic() - start
    if profiler is not None:
        profiler.__exit__(None, None, None)
        os.makedirs(cfg.profile_dir, exist_ok=True)
        profiler.export_chrome_trace(
            os.path.join(cfg.profile_dir, "trace.json")
        )
    hist = engine.histogram(state)
    log(f"{passes} Buddhabrot passes took {elapsed:f} seconds.")
    stats = engine.stats(state)
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

    if cfg.inprogress_file:
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
