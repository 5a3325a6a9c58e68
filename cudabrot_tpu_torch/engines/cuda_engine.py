"""The render engine: classify kernel, compaction, fused replay-deposit.

Port of the uniform float32 device-replay path of
``cudabrot_tpu/engines/pallas_engine.py`` (``Tuning``,
``_classify_and_compact``, ``_device_replay``, ``core``). One pass:

  1. ``ops.classify.classify_pass`` (``csrc/classify.cu``): T lane-steps of
     persistent sampling; lane state stays on the device across passes,
     so no orbit is truncated. In-band (c, escape index) candidates land
     in fixed-shape emission buffers.
  2. ``compact``: the JAX engine's selection, bitwise — an unbiased
     uniform key (Threefry words from the ``threefry_bits`` kernel) picks
     at most ``replay_capacity`` emissions, then the kept ones are
     ordered by descending orbit length.
  3. ``ops.binning.replay_deposit`` (``csrc/deposit.cu``): one thread per
     kept emission replays its orbit and deposits every on-canvas point
     into the device histogram with atomics. It replaces both the batched
     (materialized id stream + one scatter) and the blocked replay of the
     JAX engine: no id stream exists, and one kernel covers every band.

The pass key is ``fold_in(fold_in(key(seed), ordinal), pass)`` as in the
JAX engine, so at equal geometry both engines draw the same samples.
Nothing in a pass waits for the device: stats accumulate in int64 device
totals, and the driver synchronizes every ``pipeline_depth`` passes.
"""

from __future__ import annotations

import numpy as np
import torch

from cudabrot_tpu_torch.config import SAMPLE_DOMAIN, RenderConfig
from cudabrot_tpu_torch.models import fractals
from cudabrot_tpu_torch.ops import binning, prng
from cudabrot_tpu_torch.ops import classify as cls
from cudabrot_tpu_torch.utils import counters
from cudabrot_tpu_torch.utils.device import resolve_device

#: Fold-in word of the compaction's selection key (pallas_engine).
_SELECT_FOLD = 0x7711
#: Lane-steps per pass at auto geometry: 2^30 is 4096 steps at 262,144
#: lanes — an emission buffer of ~100 MB at the default band.
LANE_STEP_BUDGET = 1 << 30
#: Largest auto replay capacity: 2^23 emissions (~100 MB of c/iters).
MAX_REPLAY_CAPACITY = 1 << 23
#: Operations the classify kernel spends per inner step and per window
#: boundary (counted from csrc/classify.cu); their ratio picks the
#: inner window. Counts, not times: the choice depends on the
#: configuration alone, so CPU and CUDA runs tune alike.
INNER_STEP_OPS = 9.0
BOUNDARY_OPS = 40.0


def _pow2(x: float) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(x, 1.0)))))


def _mean_lifetime(max_it: int) -> float:
    """Mean classify steps per sample at iteration cap ``max_it``: interior
    samples pay the Brent detection latency, which grows with log(cap)
    (the JAX engine's fit)."""
    return 3.2 + 1.1 * float(np.log(max(max_it, 100) / 100.0))


def _window_useful_fraction(u: int, lifetime: float) -> float:
    """Share of executed lane-steps that are useful at inner window ``u``
    (a finished lane coasts to the window edge; the JAX engine's model)."""
    lp = lifetime + 4.0
    return lp / (lp + (u - 1.0))


def band_emission_rate(min_it: int, max_it: int) -> float:
    """Expected in-band emissions per useful lane-step, from the
    escape-time tail P(T >= t) ~ 0.22/t of uniform samples over the
    default domain (a property of the Mandelbrot set)."""
    frac = 0.22 * (1.0 / max(min_it, 2) - 1.0 / max(max_it, 4))
    return max(frac, 1e-7) / _mean_lifetime(max_it)


class Tuning:
    """Per-band engine geometry. It depends on the configuration alone,
    never on the device, so CPU and CUDA runs draw the same Threefry
    streams. Explicit EngineOptions override every auto value."""

    def __init__(self, cfg: RenderConfig):
        o = cfg.options
        fr = fractals.get_fractal(cfg.fractal)
        self.min_it = cfg.band.min_escape_iterations
        self.max_it = cfg.band.max_escape_iterations
        lifetime = _mean_lifetime(self.max_it)
        if fr.emit == "interior":
            # Every non-escaping draw emits: ~0.10 per draw (the M-set's
            # share of the sample domain plus slow escapers).
            rate = 0.10 / lifetime
        else:
            rate = band_emission_rate(self.min_it, self.max_it)
        if cfg.sample_domain != SAMPLE_DOMAIN:
            # A smaller domain concentrates emissions by up to the area
            # ratio; boost by at most 16x, at most one per sample.
            r0, r1, i0, i1 = cfg.sample_domain
            area = max((r1 - r0) * (i1 - i0), 1e-30)
            rate = min(rate * min(16.0 / area, 16.0), 1.0 / lifetime)
        lanes = o.lane_rows * 128
        self.lanes = lanes
        # Flush window: ~0.25 expected emissions per lane per window, so a
        # second finish rarely overwrites a pending one.
        flush_cap = 4096 if rate > 1e-5 else 65536
        self.steps_per_flush = o.steps_per_flush or int(
            np.clip(_pow2(0.25 / rate), 32, flush_cap)
        )
        self.thin_tracking = o.escape_tracking != "step"
        if o.inner_unroll > 0:
            self.inner_unroll = o.inner_unroll
        elif rate > 1e-4:
            # Emission-heavy bands: samples finish within a few steps, a
            # window would mostly coast.
            self.inner_unroll = 1
        else:
            candidates = (
                (1, 2, 4, 8, 16, 32) if self.thin_tracking else (1, 2, 4, 8)
            )

            def score(u: int) -> float:
                cost = INNER_STEP_OPS + BOUNDARY_OPS / u
                return _window_useful_fraction(u, lifetime) / cost

            self.inner_unroll = max(candidates, key=score)
        if self.steps_per_flush % self.inner_unroll != 0:
            self.inner_unroll = 1
        steps = o.steps_per_pass or max(
            LANE_STEP_BUDGET // lanes, self.steps_per_flush
        )
        # Round down to a whole number of flush windows (at least one).
        self.steps_per_pass = max(
            steps // self.steps_per_flush * self.steps_per_flush,
            self.steps_per_flush,
        )
        useful = _window_useful_fraction(self.inner_unroll, lifetime)
        self.expected_emissions = self.steps_per_pass * lanes * rate * useful
        self.emission_slots = (
            self.steps_per_pass // self.steps_per_flush * lanes
        )
        if o.replay_capacity > 0:
            self.replay_capacity = o.replay_capacity
        else:
            # 2x headroom over the rate model before pow2 rounding:
            # overflow is an unbiased thinning, but wasted classify work.
            self.replay_capacity = min(
                int(np.clip(_pow2(2.0 * self.expected_emissions), 4096,
                            MAX_REPLAY_CAPACITY)),
                self.emission_slots,
            )


def compact(emit_c, emit_it, key, capacity: int, max_it: int):
    """Select at most ``capacity`` valid emissions without bias and order
    them by descending orbit length — the JAX engine's selection, bitwise
    (pallas_engine._classify_and_compact, both branches).

    Returns ``(cr, ci, iters, n_valid)``: the kept batch (``iters`` = -1
    on unused slots) and the 0-dim count of valid emissions.
    """
    em_it = emit_it.reshape(-1)
    em_cr = emit_c[:, 0].reshape(-1)
    em_ci = emit_c[:, 1].reshape(-1)
    valid = em_it >= 0
    nslots = em_it.numel()
    dev = em_it.device
    rbits = prng.bits(prng.fold_in(key, _SELECT_FOLD), nslots, dev)
    if nslots <= (1 << 21) and max_it + 1 < 1024:
        # Packed keys: an 11-bit random key over a 21-bit slot index, then
        # (max_it - length) over a 21-bit rank. Keys are unique, so any
        # sort gives the JAX order.
        r11 = torch.clamp(rbits >> 21, max=2046)
        idx = torch.arange(nslots, dtype=torch.int64, device=dev)
        key1 = torch.where(valid, (r11 << 21) | idx, (2047 << 21) | idx)
        cand = torch.sort(key1).values[:capacity] & 0x1FFFFF
        it_cand = em_it[cand].to(torch.int64)
        pos = torch.arange(cand.numel(), dtype=torch.int64, device=dev)
        len_key = torch.where(it_cand >= 0, max_it - it_cand, max_it + 1)
        take = cand[torch.sort((len_key << 21) | pos).values & 0x1FFFFF]
    else:
        # Stable argsorts, as jnp.argsort is.
        sel_key = torch.where(valid, rbits >> 1, 0x80000000)
        cand = torch.sort(sel_key, stable=True).indices[:capacity]
        it_cand = em_it[cand]
        order = torch.sort(torch.where(it_cand >= 0, -it_cand, 1),
                           stable=True).indices
        take = cand[order]
    return em_cr[take], em_ci[take], em_it[take], valid.sum()


class CudaEngine:
    """Persistent-sampler engine: the CUDA kernels on a CUDA device, their
    plain PyTorch versions on the CPU."""

    name = "cuda"

    def __init__(self, cfg: RenderConfig, device=None):
        cfg.options.validate()
        self.cfg = cfg
        self.device = resolve_device(device, cfg.device_index)
        self.fractal = fractals.get_fractal(cfg.fractal)
        self.tuning = Tuning(cfg)
        self.lane_rows = cfg.options.lane_rows
        self.lanes = self.tuning.lanes
        self.steps_per_pass = self.tuning.steps_per_pass * self.lanes
        self.replay_capacity = self.tuning.replay_capacity
        # Canvas emit filter: emit only orbits that entered the canvas
        # window, inflated one pixel past the upper binning bounds so the
        # gate has no false negatives (the classify trajectory is the
        # replay trajectory).
        self.visit_window = None
        if cfg.options.emit_filter == "canvas":
            cv = cfg.canvas
            self.visit_window = (
                cv.min_real, cv.max_real + cv.delta_real,
                cv.min_imag, cv.max_imag + cv.delta_imag,
            )

    # -- engine interface ---------------------------------------------------

    def init_state(self, hist0: np.ndarray | None) -> dict:
        shape = self.cfg.canvas.shape
        if hist0 is None:
            hist = torch.zeros(shape, dtype=torch.int32, device=self.device)
        else:
            h = np.ascontiguousarray(hist0, dtype=np.uint32).view(np.int32)
            hist = torch.from_numpy(h.copy()).to(self.device)
        state = {
            "hist": hist,
            "lanes": cls.init_lane_state(self.lane_rows, self.device),
        }
        state.update(counters.zeros(self.device))
        return state

    def core(self, state: dict, pass_index: int, ordinal: int = 0) -> dict:
        """One pass, entirely on the device; updates ``state`` in place."""
        cfg, tn = self.cfg, self.tuning
        key = prng.pass_key(cfg.seed, ordinal, pass_index)
        result = cls.classify_pass(
            state["lanes"],
            prng.bits_host(key, 2),
            fractal=self.fractal,
            min_it=tn.min_it,
            max_it=tn.max_it,
            steps_per_pass=tn.steps_per_pass,
            steps_per_flush=tn.steps_per_flush,
            cycle_detection=cfg.options.cycle_detection,
            inner_unroll=tn.inner_unroll,
            thin_tracking=tn.thin_tracking,
            sample_domain=cfg.sample_domain,
            visit_window=self.visit_window,
        )
        cr_c, ci_c, it_c, n_valid = compact(
            result.emit_c, result.emit_it, key, self.replay_capacity,
            tn.max_it,
        )
        hits = binning.replay_deposit(
            state["hist"].view(-1), cr_c, ci_c, it_c,
            canvas=cfg.canvas, fractal=self.fractal,
        )
        st = result.stats.reshape(cls.STATS_ROWS, -1).sum(dim=1)
        wasted = st[cls.STAT_WASTED]
        emitted = torch.clamp(n_valid, max=self.replay_capacity)
        for k, v in (
            ("samples", st[cls.STAT_DRAWN]),
            ("culled", st[cls.STAT_CULLED]),
            ("in_band", st[cls.STAT_IN_BAND]),
            ("cycles", st[cls.STAT_CYCLES]),
            ("wasted", wasted),
            ("iters", self.steps_per_pass - wasted),
            ("emitted", emitted),
            ("replay_dropped", n_valid - emitted),
            ("points", torch.where(it_c >= 0, it_c + 1, 0).sum()),
            ("dev_hits", hits),
        ):
            state[k] += v
        return state

    def run_pass(self, state: dict, pass_index: int) -> dict:
        return self.core(state, pass_index)

    def warmup(self, state: dict) -> None:
        """Build the CUDA kernels before the timed loop (nvcc, both sources
        at once), so the time box covers rendering only."""
        if self.device.type == "cuda":
            from cudabrot_tpu_torch.ops import _build

            _build.build_all()

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def memory_estimate(self) -> tuple[int, int]:
        """(device_bytes, host_bytes) — the reference's startup banner
        equivalent (cudabrot.cu:154-165)."""
        cv = self.cfg.canvas
        slots = self.tuning.emission_slots
        hist = cv.num_pixels * 4
        lanes = self.lanes * (len(cls.LaneState._fields) + cls.STATS_ROWS) * 4
        emission = slots * 12
        # Compaction: int64 keys, sort output and indices per slot.
        sort = slots * 8 * 3
        replay = self.replay_capacity * 12
        return hist + lanes + emission + sort + replay, hist + cv.num_pixels * 2

    def histogram(self, state: dict) -> np.ndarray:
        h = state["hist"].cpu().numpy()
        return h.view(np.uint32).copy()

    def stats(self, state: dict) -> dict:
        out = counters.counter_stats(state)
        out["on_canvas_points"] = out.pop("_device_on_canvas")
        out["replay"] = "device"
        return out
