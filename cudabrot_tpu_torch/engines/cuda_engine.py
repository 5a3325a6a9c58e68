"""The render engine: classify kernel, compaction, fused replay-deposit.

Port of the uniform device-replay paths of
``cudabrot_tpu/engines/pallas_engine.py`` (``Tuning``,
``_classify_and_compact``, ``_device_replay``, ``_blocked_replay_ext``,
``core``), at float32 and at extended precision. One pass:

  1. ``ops.classify.classify_pass`` (``csrc/classify.cu``): T lane-steps of
     persistent sampling; lane state stays on the device across passes,
     so no orbit is truncated. In-band (c, escape index) candidates land
     in fixed-shape emission buffers.
  2. The compaction, by one of two routes the plan decides
     (``compact_route``). Where ``replay_capacity`` holds every emission
     slot, ``ops.length_sort.length_sort`` (``csrc/length_sort.cu``) keeps
     every valid emission, by descending orbit length and then slot.
     Elsewhere ``compact``: the JAX engine's selection, bitwise — an
     unbiased uniform key (Threefry words from the ``threefry_bits``
     kernel) picks at most ``replay_capacity`` emissions, then the kept
     ones are ordered by descending orbit length. Where nothing is
     dropped the two keep the same emissions and differ only in the
     order of equal lengths, which no output reads.
  3. ``ops.binning.replay_deposit`` (``csrc/deposit.cu``): the kernel's
     warps take the kept emissions in groups of 32, longest first, replay
     their orbits and deposit every on-canvas point into the device
     histogram with atomics. It replaces both the batched
     (materialized id stream + one scatter) and the blocked replay of the
     JAX engine: no id stream exists, and one kernel covers every band.

At ``--precision extended`` (deep zoom) the same three steps run on
double-float orbits: ``ops.classify_ext.classify_pass_ext``
(``csrc/classify_ext.cu``) emits 24-bit grid indices instead of c values,
the compaction takes them through the same code, and
``ops.binning.replay_deposit_ext`` (``csrc/deposit_ext.cu``) rebuilds c,
replays in df32 and deposits.

With ``--scatter bigtiles``, ``pallas`` or ``sorted`` step 3 is
``ops.binning.replay_id_stream`` (``replay_id_stream_ext`` at extended
precision): the ``replay_ids`` kernel writes every kept point's bin id
into a flat stream, which the route counts: bigtiles (histograms beyond
the L2) sorts it with ``torch.sort`` and adds each run of equal ids with
one atomic (the ``bigtiles_deposit`` kernel, ``csrc/bigtiles.cu``);
sorted takes the same route (the JAX ``scatter_sorted`` is that sort
and run-length add); pallas counts it as written (the ``deposit_ids``
kernel, ``csrc/deposit.cu``, the JAX package's Mosaic scatter). The
histogram and every stat are the fused route's, bit for bit; the route
reads its id count back once per pass (one host synchronization).

With ``--sampler mh`` (Metropolis-Hastings crop renders, at either
precision) the pass is ``ops.classify_mh.classify_pass_mh`` or
``classify_pass_ext_mh`` (the two kernels of ``csrc/classify_mh.cu``):
every lane runs a Markov chain whose emissions carry their own recorded
canvas bins, so nothing is replayed. ``ops.binning.mh_deposit`` (the
``mh_deposit`` kernel of ``csrc/deposit.cu``) adds each emission's weighted
share to its bins straight from the emission buffers: capacity is one
emission per lane per flush window, so none is ever dropped and the
order-free integer deposit needs no compaction. Histogram counts are then
in 1/256 units (``weight_scale``). Reading the histogram first deposits
every chain's unfinished tenure (``mh_tail_core``).

With ``--replay host`` (and ``auto`` at ``--hist-dtype uint64``) the
orbits replay on the host: ``host_pass`` classifies and compacts on the
card, packs the kept batch into the JAX engine's payload layouts, and the
pass ships it through a ring of pinned buffers to the native replay worker
(``engines/host_replay.py``), which accumulates in uint32 or uint64 while
the card runs the next pass. With a device share (``--replay-device-share``
or the calibrated auto share, ``Tuning.auto_device_share``) the short
orbits of each batch replay on the card instead (the hybrid split) and only
the host's prefix of the batch is copied. ``--replay auto`` stays on the
device: the JAX package takes the host whenever its library loads, because
the TPU has no scatter hardware, and the H100 has.

The pass key is ``fold_in(fold_in(key(seed), ordinal), pass)`` as in the
JAX engine, so at equal geometry both engines draw the same samples.
On the fused route nothing in a pass waits for the device: stats
accumulate in int64 device totals, and the driver waits every
``pipeline_depth`` passes (``sync_group``). On the card the fused replay
runs on a side stream (two, taken in turn by pass), so the next pass's
classify and compaction run under the replay's long-orbit tail
(``_replay_fused``), and the group's wait leaves its last replays
running; ``histogram`` and ``stats`` wait for them before they read.
"""

from __future__ import annotations

import numpy as np
import torch

from cudabrot_tpu_torch.config import (
    SAMPLE_DOMAIN,
    ConfigError,
    RenderConfig,
)
from cudabrot_tpu_torch.models import fractals
from cudabrot_tpu_torch.ops import (
    binning, df32, length_sort, pass_counters, prng)
from cudabrot_tpu_torch.ops import classify as cls
from cudabrot_tpu_torch.ops import classify_ext as cls_ext
from cudabrot_tpu_torch.ops import classify_mh as cls_mh
from cudabrot_tpu_torch.utils import calibration, counters, trace
from cudabrot_tpu_torch.utils.device import resolve_device

#: Fold-in word of the compaction's selection key (pallas_engine).
_SELECT_FOLD = 0x7711
#: Lane-steps per pass at auto geometry: 2^30 is 4096 steps at 262,144
#: lanes — an emission buffer of ~100 MB at the default band. Extended
#: precision keeps it: a deep-zoom pass pays ~3 ms for its longest
#: replayed orbit whatever its length, and on an H100 passes of 2^27, 2^28,
#: 2^29 and 2^30 lane-steps ran at 3.5, 5.5, 8.1 and 10.5e10 lane-steps/s
#: (10 ms a pass at 2^30; measured in PR 2).
LANE_STEP_BUDGET = 1 << 30
#: Largest auto replay capacity: 2^23 emissions (~100 MB of c/iters).
MAX_REPLAY_CAPACITY = 1 << 23
#: Side streams of the fused replay on the card, taken in turn by pass: a
#: replay can overlap the next pass's classify and compaction, and the
#: next pass's replay.
REPLAY_STREAMS = 2
#: Operations the classify kernel spends per inner step and per window
#: boundary (counted from csrc/classify.cu); their ratio picks the
#: inner window. Counts, not times: the choice depends on the
#: configuration alone, so CPU and CUDA runs tune alike.
INNER_STEP_OPS = 9.0
BOUNDARY_OPS = 40.0
#: The same two counts for the extended-precision kernel, SASS
#: instructions of csrc/classify_ext.cu for sm_90a (counted in PR 9;
#: chip_smoke.py's OPS_STEP_EXT and OPS_BOUNDARY_EXT + OPS_FINISH_EXT):
#: a df32 step with three FFMA two-products is 67; a window's boundary is
#: 6 where no lane of the warp finished and 6 + 110 (band filter, stats,
#: refill draw) where one did, which at the rate model's lifetimes (under
#: ten steps) is nearly every window, so the boundary weighs 116.
EXT_INNER_STEP_OPS = 67.0
EXT_BOUNDARY_OPS = 116.0
#: The counts of the two MH kernels, from csrc/mh.cuh: an inner step adds
#: the window test (7), the LCG (2) and the visit count (1) to the orbit
#: step, and at df32 the centre-relative window coordinates (6); the
#: boundary adds the target (4). The chain resolution and the draw are paid
#: per finished proposal, not per window. The df32 ones stay the hand
#: counts of the first df32 MH kernel: the SASS counts (78 and 14) pick
#: the same window at the measured cell (U = 16 at mhzoom) but move it at
#: bands no card run has measured.
MH_INNER_STEP_OPS = 19.0
MH_BOUNDARY_OPS = 44.0
EXT_MH_INNER_STEP_OPS = 110.0
EXT_MH_BOUNDARY_OPS = 46.0
#: Threads of a block of the f32 replay kernels (csrc/deposit.cu
#: kQueueBlock): the granule below which a device share of a pass's
#: emissions does not pay (Tuning.auto_device_share).
REPLAY_BLOCK = 128
#: Histograms from this size on are DRAM-bound on the host (the JAX
#: engine's threshold): the share solve takes the DRAM rates there.
BIG_HISTOGRAM_BYTES = 256 << 20


def step_ops(extended: bool, mh: bool) -> tuple[float, float]:
    """(operations per inner step, per window boundary) of the classify
    kernel a configuration runs."""
    if mh:
        return ((EXT_MH_INNER_STEP_OPS, EXT_MH_BOUNDARY_OPS) if extended
                else (MH_INNER_STEP_OPS, MH_BOUNDARY_OPS))
    return ((EXT_INNER_STEP_OPS, EXT_BOUNDARY_OPS) if extended
            else (INNER_STEP_OPS, BOUNDARY_OPS))


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
        #: Metropolis-Hastings sampling: emissions are chain moves, and
        #: proposals concentrate near in-band states, so their mean cost
        #: approaches the in-band orbit length, not the uniform-draw mean.
        #: Acceptance depends on the crop; the rate is sized for the high
        #: end (0.3 per proposal).
        self.mh = o.sampler == "mh"
        #: Interior (anti-Buddhabrot) orbits are all max_it long, so the
        #: length split of the hybrid does not apply: interior renders stay
        #: host-only.
        self.interior = fr.emit == "interior"
        if self.interior:
            in_band_len = float(self.max_it)
        else:
            mi_b = max(self.min_it, 2)
            ma_b = max(self.max_it, mi_b + 1)
            # E[len | in band] for the ~1/t^2 escape-time tail.
            in_band_len = (mi_b * ma_b / (ma_b - mi_b)) * float(
                np.log(ma_b / mi_b))
        if self.mh:
            lifetime = 0.5 * in_band_len + lifetime
            rate = 0.3 / lifetime
        if cfg.sample_domain != SAMPLE_DOMAIN and not self.mh:
            # A smaller domain concentrates emissions by up to the area
            # ratio; boost by at most 16x, at most one per sample.
            r0, r1, i0, i1 = cfg.sample_domain
            area = max((r1 - r0) * (i1 - i0), 1e-30)
            rate = min(rate * min(16.0 / area, 16.0), 1.0 / lifetime)
        lanes = o.lane_rows * 128
        self.lanes = lanes
        flush_cap = 4096 if rate > 1e-5 else 65536
        if o.steps_per_flush:
            self.steps_per_flush = o.steps_per_flush
        elif self.mh:
            # A pending collision is a mass-conserving merge (a variance
            # cost, not a loss), so the window can be long: it aims at one
            # retirement per lane and is at least 8 mean in-band orbits,
            # up to 16384 steps (the JAX engine's rule).
            self.steps_per_flush = max(
                int(np.clip(_pow2(1.0 / rate), 32, max(flush_cap, 16384))),
                min(16384, _pow2(8.0 * in_band_len)),
            )
        else:
            # ~0.25 expected emissions per lane per window, so a second
            # finish rarely overwrites a pending one.
            self.steps_per_flush = int(
                np.clip(_pow2(0.25 / rate), 32, flush_cap))
        self.thin_tracking = o.escape_tracking != "step"
        #: Extended (df32) deep-zoom iteration; always thin tracking
        #: (EngineOptions.validate).
        self.extended = o.precision == "extended"
        if o.inner_unroll > 0:
            self.inner_unroll = o.inner_unroll
        elif rate > 1e-4 and not self.mh and not self.extended:
            # Emission-heavy bands: samples finish within a few steps, a
            # window would mostly coast. (MH proposals are long orbits next
            # to in-band states: they are scored like deep bands. So are
            # df32 bands, whose warps pay the whole boundary only where a
            # lane finished: the score picks U = 4 at the deep-zoom cell,
            # the most deposited points a second of U = 1, 2, 4 and 8 on
            # an NVIDIA H100 80GB HBM3, 700.00 W; measured in PR 9.)
            self.inner_unroll = 1
        else:
            candidates = (
                (1, 2, 4, 8, 16, 32) if self.thin_tracking else (1, 2, 4, 8)
            )

            c_inner, c_boundary = step_ops(self.extended, self.mh)

            def score(u: int) -> float:
                cost = c_inner + c_boundary / u
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
            if self.mh and o.replay_capacity < self.emission_slots:
                # An MH drop would lose weighted mass (a uniform drop is an
                # unbiased thinning), so MH never drops.
                raise ConfigError(
                    f"--sampler mh needs one replay slot per lane per flush "
                    f"window: --replay-capacity {o.replay_capacity} is below "
                    f"the pass's {self.emission_slots} emission slots. Leave "
                    f"it at 0 (auto) or shorten --steps-per-pass."
                )
            self.replay_capacity = o.replay_capacity
        elif self.mh:
            # A lane emits at most once per flush window, so one slot per
            # lane-window holds every emission: an MH drop would lose
            # weighted mass, where a uniform drop is an unbiased thinning.
            # Beyond the largest capacity the pass is shortened instead.
            windows = self.steps_per_pass // self.steps_per_flush
            self.replay_capacity = int(np.clip(
                _pow2(lanes * windows), 4096, MAX_REPLAY_CAPACITY))
            windows = min(windows, max(self.replay_capacity // lanes, 1))
            self.steps_per_pass = windows * self.steps_per_flush
            self.emission_slots = windows * lanes
        else:
            # 2x headroom over the rate model before pow2 rounding:
            # overflow is an unbiased thinning, but wasted classify work.
            self.replay_capacity = min(
                int(np.clip(_pow2(2.0 * self.expected_emissions), 4096,
                            MAX_REPLAY_CAPACITY)),
                self.emission_slots,
            )
        # Classify operations and expected orbit points a pass: the inputs
        # of the hybrid share solve (auto_device_share), which turns them
        # into seconds with the calibrated rates.
        c_inner, c_boundary = step_ops(self.extended, self.mh)
        self.classify_ops = self.steps_per_pass * lanes * (
            c_inner + c_boundary / self.inner_unroll)
        self.expected_points = self.expected_emissions * in_band_len
        #: Whether host-replay emissions pack into two 32-bit words (24-bit
        #: default-domain grid indices + the split 16-bit iters + 1) or ride
        #: the 12-byte three-row float32 layout.
        self.packed_payload = (
            self.max_it <= 0xFFFF
            and cfg.sample_domain == SAMPLE_DOMAIN
            and not self.extended
            and not self.mh
        )

    def auto_device_share(self, hist_bytes: int,
                          scatter_backend: str = "fused") -> float:
        """Orbit-point share the device should replay in host mode (the
        hybrid split), from the active calibration. The JAX engine's solve
        (pallas_engine.Tuning.auto_device_share), with the port's fused
        replay in the place of its hand-written Mosaic scatter.

        0 for interior, extended and MH renders (the length split does not
        apply, or the rate model covers the f32 replay only), and where a
        pass emits fewer than four replay blocks of orbits. Big canvases
        (the host accumulator DRAM-bound): the share that balances the
        device's classify plus its share against the host's replay of the
        rest. Smaller ones, on the fused route only: a grid search over the
        pass model, the host side the larger of its replay and the payload
        copy, the device side classify, the per-pass overhead and its
        share; the argmin is derated 20% toward the host (overshooting is a
        device-bound cliff). Never above 0.9. The JAX solve keys the small
        canvases on its fastest device deposit, the Mosaic scatter
        ("pallas"); the port's is the fused replay, whose rate the
        calibration measures. The id-stream routes ("ids" for --scatter
        pallas among them) write and count a stream and read its length
        back each pass, which that rate does not hold, so they get 0
        there."""
        if self.interior or self.extended or self.mh:
            return 0.0
        big = hist_bytes >= BIG_HISTOGRAM_BYTES
        if not big and scatter_backend != "fused":
            return 0.0
        if self.expected_emissions < 4 * REPLAY_BLOCK:
            return 0.0
        cal = calibration.active()
        p = self.expected_points
        if p <= 0:
            return 0.0
        classify_s = self.classify_ops / cal.classify_op_rate
        if big:
            t_host_all = p / cal.host_replay_dram_rate
            s = (t_host_all - classify_s) / (
                p / cal.device_replay_rate + t_host_all)
            return float(np.clip(s, 0.0, 0.9))
        t_fixed = classify_s + cal.pass_overhead_seconds
        slot_bytes = 8 if self.packed_payload else 12
        best_s = 0.0
        best_wall = None
        for step in range(19):
            s = step * 0.05
            ks = self.host_payload_slots(self.split_threshold(s))
            fetch_t = ks * slot_bytes / cal.link_rate_bytes
            host_t = max((1.0 - s) * p / cal.host_replay_llc_rate, fetch_t)
            dev_t = t_fixed + s * p / cal.device_replay_rate
            wall = max(host_t, dev_t)
            if best_wall is None or wall < best_wall - 1e-12:
                best_wall, best_s = wall, s
        return float(np.clip(0.8 * best_s, 0.0, 0.9))

    def host_payload_slots(self, theta: int) -> int:
        """Host-payload width for a hybrid split at length threshold
        ``theta``. The compaction orders the kept batch by descending
        length, so the host's orbits (length >= theta) are a prefix of it;
        its expected width follows the ~1/t^2 escape-time tail, rounded up
        to 128. A pass whose long orbits overflow the prefix replays the
        excess on the device: under-sizing costs device time, never
        mass."""
        cap = self.replay_capacity
        if theta <= 0:
            return cap
        mi = max(self.min_it, 2)
        ma = max(self.max_it, mi + 1)
        th = min(max(theta, mi), ma)
        frac = (1.0 / th - 1.0 / ma) / (1.0 / mi - 1.0 / ma)
        k = int(np.ceil(frac * cap / 128.0)) * 128
        return int(np.clip(k, min(1024, cap), cap))

    def split_threshold(self, point_share: float) -> int:
        """Orbit-length cut below which the device replays (hybrid mode).
        Orbit-point mass is roughly uniform in log(length) for the ~1/t^2
        tail, so a point share s maps to min * (max/min)^s."""
        if point_share <= 0 or self.interior:
            return 0
        mi = max(self.min_it, 2)
        ma = max(self.max_it, mi + 1)
        return int(mi * (ma / mi) ** min(point_share, 0.95))


def compact_route(tuning: Tuning) -> str:
    """The compaction of a plan's uniform passes: "length" where its
    replay capacity holds every emission slot (nothing can be dropped, so
    ``length_sort`` keeps every valid emission) and the length sort takes
    the band, else "select" (``compact``, the JAX selection)."""
    if tuning.replay_capacity >= tuning.emission_slots and length_sort.fits(
            tuning.emission_slots, tuning.min_it, tuning.max_it):
        return "length"
    return "select"


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

    def __init__(self, cfg: RenderConfig, device=None,
                 replay_mode: str | None = None, worker=None):
        """``replay_mode``: host or device in place of ``--replay``;
        ``worker``: a ``HostReplayWorker`` to feed in host mode, shared with
        other engines (the data-parallel host replay), else its own."""
        cfg.options.validate()
        if cfg.options.precision == "float64":
            raise ConfigError(
                "float64 iteration is not supported by the cuda engine (its "
                "kernels iterate in float32, or in double-float pairs at "
                "--precision extended). Use --engine oracle for exact "
                "double iteration."
            )
        self.cfg = cfg
        self.device = resolve_device(device, cfg.device_index)
        self.fractal = fractals.get_fractal(cfg.fractal)
        self.tuning = Tuning(cfg)
        self.lane_rows = cfg.options.lane_rows
        self.lanes = self.tuning.lanes
        self.steps_per_pass = self.tuning.steps_per_pass * self.lanes
        self.replay_capacity = self.tuning.replay_capacity
        self.extended = self.tuning.extended
        #: "length" or "select": the compaction of a uniform pass.
        self.compact_route = compact_route(self.tuning)
        #: The uniform samplers' deposit route: "fused" (replay-deposit) or
        #: an id-stream route, "bigtiles" or "ids"
        #: (``binning.ID_ROUTES``). MH deposits
        #: its emissions' recorded bins whatever --scatter says, as the JAX
        #: engine does.
        self.scatter_backend = binning.select_scatter_backend(
            cfg.options.scatter)
        #: The fused replay's side streams (see ``_replay_fused``); high
        #: priority, so its blocks are placed before the next classify's.
        self.replay_streams = []
        if (self.device.type == "cuda" and self.scatter_backend == "fused"
                and cfg.options.sampler != "mh"):
            self.replay_streams = [
                torch.cuda.Stream(self.device, priority=-1)
                for _ in range(REPLAY_STREAMS)]
        #: An event on each side stream, recorded at the last group end
        #: (``sync_group``).
        self._group_ends: list = []
        #: Metropolis-Hastings sampling: deposits are importance weights
        #: in 1/weight_scale histogram units.
        self.mh = self.tuning.mh
        self.weight_scale = cls_mh.WEIGHT_SCALE if self.mh else 1
        self.visit_slots = cfg.options.mh_visit_slots
        # Canvas emit filter: emit only orbits that entered the canvas
        # window, inflated one pixel past the upper binning bounds so the
        # gate has no false negatives (the classify trajectory is the
        # replay trajectory). The df32 kernel tests hi parts only (~2^-24
        # relative slop), so the extended window is padded on both sides
        # by 4 pixels or the f32 quantum 2^-21, whichever is larger: false
        # positives only.
        self.visit_window = None
        if cfg.options.emit_filter == "canvas":
            cv = cfg.canvas
            if self.extended:
                pad_r = max(4 * cv.delta_real, 2.0 ** -21)
                pad_i = max(4 * cv.delta_imag, 2.0 ** -21)
                lo_r, lo_i = pad_r, pad_i
            else:
                pad_r, pad_i = cv.delta_real, cv.delta_imag
                lo_r = lo_i = 0.0
            self.visit_window = (
                cv.min_real - lo_r, cv.max_real + pad_r,
                cv.min_imag - lo_i, cv.max_imag + pad_i,
            )
        self.replay_mode = self._resolve_replay(replay_mode)
        self._worker = None
        self._stage = None
        #: Host mode's split: the orbit-point share the device replays,
        #: the length below which an orbit goes there (0: none), and the
        #: host payload's width.
        self.device_share = 0.0
        self.split_threshold = 0
        self.host_payload_slots = self.replay_capacity
        if self.replay_mode == "host":
            self._setup_host(worker)

    def _resolve_replay(self, replay_mode: str | None) -> str:
        """host or device, with the JAX engine's refusals. ``auto`` is
        device, but for uint64 histograms, which only the host replay
        accumulates."""
        o = self.cfg.options
        mode = replay_mode or o.replay
        if self.mh:
            # MH deposits are kernel-recorded bins, so there is no replay to
            # split; the host worker exists for uint64 or --replay host.
            if o.replay_device_share > 0:
                raise ConfigError(
                    "--replay-device-share does not apply to --sampler "
                    "mh (deposits are kernel-recorded bins; there is no "
                    "replay to split)"
                )
        if mode == "auto":
            mode = "host" if o.hist_dtype == "uint64" else "device"
        if self.extended and o.replay_device_share > 0:
            raise ConfigError(
                "--replay-device-share does not apply to extended-"
                "precision renders (deep-zoom bands are emission-light; "
                "the hybrid split's rate model covers the f32 engines "
                "only)."
            )
        if o.hist_dtype == "uint64" and mode != "host":
            raise ConfigError(
                "uint64 histograms require host replay (the device "
                "scatter path accumulates in uint32); use --replay host."
            )
        return mode

    def _setup_host(self, worker) -> None:
        from cudabrot_tpu_torch.engines.host_replay import (
            HostReplayWorker,
            PinnedStage,
        )

        cfg, o = self.cfg, self.cfg.options
        if o.replay_device_share >= 0:
            share = o.replay_device_share
        elif o.hist_dtype == "uint64":
            share = 0.0  # the device share accumulates in uint32
        else:
            share = self.tuning.auto_device_share(
                cfg.canvas.histogram_nbytes, self.scatter_backend)
        self.device_share = share
        self.split_threshold = self.tuning.split_threshold(share)
        self.host_payload_slots = self.tuning.host_payload_slots(
            self.split_threshold)
        if o.hist_dtype == "uint64" and self.split_threshold > 0:
            raise ConfigError(
                "uint64 histograms cannot use a device replay share "
                "(the device prefix accumulates in uint32)."
            )
        if worker is None:
            grid_decode = None
            if self.extended and not self.mh:
                # The exact f64 value of the df32 window centre and the f32
                # pitches: host c agrees with the kernel's df32 c to the
                # renormalization error.
                c0r, c0i, step_r, step_i = cls_ext.grid_params(
                    cfg.sample_domain)
                grid_decode = (df32.to_float64(*c0r), df32.to_float64(*c0i),
                               step_r, step_i)
            worker = HostReplayWorker(
                cfg.canvas, burning_ship=self.fractal.fold_abs,
                num_threads=o.replay_threads, dtype=np.dtype(o.hist_dtype),
                grid_decode=grid_decode,
                mh_bins=self.visit_slots if self.mh else None)
        self._worker = worker
        if self.device.type == "cuda":
            self._stage = PinnedStage(self.device, worker.max_queue + 1)

    # -- engine interface ---------------------------------------------------

    def init_state(self, hist0: np.ndarray | None,
                   rows: int | None = None) -> dict:
        """A new state; ``hist0`` the histogram to resume from. ``rows``:
        the canvas rows the new histogram holds when there is no
        ``hist0`` (a row shard of ``parallel.sharded_hist``; None, the
        whole canvas)."""
        cv = self.cfg.canvas
        if self._worker is not None:
            # Host mode: the resumed mass lives in the host accumulator; the
            # device histogram holds the device share alone.
            self._worker.reset()
            if hist0 is not None:
                self._worker.add_resumed(hist0)
            hist0 = None
        if hist0 is None:
            hist = torch.zeros((cv.height if rows is None else rows,
                                cv.width), dtype=torch.int32,
                               device=self.device)
        else:
            h = np.ascontiguousarray(hist0, dtype=np.uint32).view(np.int32)
            hist = torch.from_numpy(h.copy()).to(self.device)
        if self.mh:
            init = (cls_mh.init_ext_mh_lane_state if self.extended
                    else cls_mh.init_mh_lane_state)
            state = {
                "hist": hist,
                "lanes": init(self.lane_rows, self.visit_slots, self.device),
            }
        elif self.extended:
            c0r, c0i, _, _ = cls_ext.grid_params(self.cfg.sample_domain)
            state = {
                "hist": hist,
                "lanes": cls_ext.init_ext_lane_state(self.lane_rows,
                                                     self.device),
                # The JAX engine's runtime-constant vector (sample-window
                # centre, canvas minimum, sealing zero), kept so a state
                # converts both ways; the kernels take these constants as
                # arguments, computed from the configuration.
                "dfc": torch.tensor(
                    [*c0r, *c0i,
                     *df32.from_float(self.cfg.canvas.min_real),
                     *df32.from_float(self.cfg.canvas.min_imag), 0.0],
                    dtype=torch.float32, device=self.device),
            }
        else:
            state = {
                "hist": hist,
                "lanes": cls.init_lane_state(self.lane_rows, self.device),
            }
        state.update(counters.zeros(self.device, mh=self.mh))
        return state

    def core(self, state: dict, pass_index: int, ordinal: int = 0) -> dict:
        """One pass, entirely on the device; updates ``state`` in place:
        ``classify_and_compact``, ``replay`` of the kept batch into the
        histogram, ``add_pass_stats``."""
        if self.mh:
            return self._mh_core(state, pass_index, ordinal)
        batch, result, n_valid = self.classify_and_compact(
            state, pass_index, ordinal)
        self.replay(state, pass_index, batch)
        self.add_pass_stats(state, result, n_valid, batch[2])
        return state

    def classify_and_compact(self, state: dict, pass_index: int,
                             ordinal: int = 0):
        """A uniform pass's classify kernel (advancing ``state["lanes"]``)
        and compaction (``compact_route``), keyed by ``pass_key(seed,
        ordinal, pass_index)``: returns ``(batch, result, n_valid)``, the
        kept ``(cr, ci, iters)`` (grid indices at extended precision) longest
        first, the classify result and the count of valid emissions. The
        JAX engine's ``_classify_and_compact``, whose kept set it keeps
        (the same batch, bitwise, on the select route)."""
        result = self.classify(state, pass_index, ordinal)
        tn = self.tuning
        # Extended emissions carry grid indices (kr, ki) where the f32 ones
        # carry (cr, ci); the compaction is the same.
        with trace.span("cb.compact", device=self.device,
                        route=self.compact_route):
            if self.compact_route == "length":
                cr_c, ci_c, it_c, n_valid = length_sort.length_sort(
                    result.emit_c, result.emit_it, tn.min_it, tn.max_it)
            else:
                cr_c, ci_c, it_c, n_valid = compact(
                    result.emit_c, result.emit_it,
                    prng.pass_key(self.cfg.seed, ordinal, pass_index),
                    self.replay_capacity, tn.max_it)
        return (cr_c, ci_c, it_c), result, n_valid

    def classify(self, state: dict, pass_index: int, ordinal: int = 0):
        """A uniform pass's classify kernel alone (``classify_and_compact``
        without the compaction); returns its result."""
        cfg, tn = self.cfg, self.tuning
        seed = prng.bits_host(prng.pass_key(cfg.seed, ordinal, pass_index), 2)
        spec = dict(
            fractal=self.fractal,
            min_it=tn.min_it,
            max_it=tn.max_it,
            steps_per_pass=tn.steps_per_pass,
            steps_per_flush=tn.steps_per_flush,
            cycle_detection=cfg.options.cycle_detection,
            inner_unroll=tn.inner_unroll,
            sample_domain=cfg.sample_domain,
            visit_window=self.visit_window,
        )
        with trace.span("cb.classify", device=self.device):
            if self.extended:
                return cls_ext.classify_pass_ext(state["lanes"], seed, **spec)
            return cls.classify_pass(state["lanes"], seed,
                                     thin_tracking=tn.thin_tracking, **spec)

    def replay(self, state: dict, pass_index: int, batch,
               rows: tuple[int, int] | None = None) -> None:
        """Replays a kept batch into ``state["hist"]`` through the
        configured route, adding the deposited points to ``dev_hits``.
        ``rows``: the histogram's row window (a shard of
        ``parallel.sharded_hist``; None, the whole canvas)."""
        cfg = self.cfg
        kw = dict(canvas=cfg.canvas, fractal=self.fractal, rows=rows)
        if self.extended:
            kw["sample_domain"] = cfg.sample_domain
        if self.scatter_backend == "fused":
            self._replay_fused(state, pass_index, batch, kw)
        else:
            # A kept orbit records at most max_it points.
            replay = (binning.replay_id_stream_ext if self.extended
                      else binning.replay_id_stream)
            with trace.span("cb.deposit", device=self.device):
                state["dev_hits"] += replay(
                    state["hist"].view(-1), *batch,
                    route=self.scatter_backend, max_len=self.tuning.max_it,
                    **kw)

    def add_pass_stats(self, state: dict, result, n_valid,
                       iters: torch.Tensor | None) -> None:
        """Adds a uniform pass's counters to ``state`` (``ops/pass_counters``,
        one kernel on the card): the classify result's stat rows, the kept
        and dropped emissions and the orbit points of the ``iters`` replayed
        on the device (None: none; the host worker counts its own). Only
        the kept prefix of ``iters``, whose emissions come first, is
        read."""
        with trace.span("cb.counters", device=self.device):
            pass_counters.pass_counters(
                result.stats, n_valid, iters,
                {k: state[k] for k in pass_counters.TOTALS},
                steps_per_pass=self.steps_per_pass,
                capacity=self.replay_capacity)

    def host_pass(self, state: dict, pass_index: int, ordinal: int = 0):
        """The card's half of a host-replay pass: classify, compact and
        pack the payload (the JAX engine's ``host_pass``). Returns
        ``(n_valid, payload)`` on the state's device, the payload's valid
        count and one of the JAX layouts (``pack_payload``; MH: int32 rows
        [iters; rep; t; bins] of the emission buffers as they are, the
        order-free deposit needing no compaction), or None on an MH
        burn-in pass, whose emissions are discarded.

        Hybrid split: the device replays every kept orbit shorter than
        ``split_threshold`` and every one past the host prefix
        (``host_payload_slots``) through the render's deposit route, into
        the device histogram and ``dev_hits``; their slots in the host's
        batch are -1, and only the prefix is packed."""
        if self.mh:
            result = self._mh_classify(state, pass_index, ordinal)
            if pass_index < self.cfg.options.mh_burnin_passes:
                return None
            it = result.emit_it.reshape(-1)
            bins = result.emit_bins.transpose(0, 1).reshape(
                self.visit_slots, -1)
            return (it >= 0).sum(), mh_payload(
                it, result.emit_rep.reshape(-1), result.emit_v.reshape(-1),
                bins)
        (cr, ci, it), result, n_valid = self.classify_and_compact(
            state, pass_index, ordinal)
        dev_it = None
        if self.split_threshold > 0:
            pos = torch.arange(it.numel(), device=it.device)
            to_dev = (it < self.split_threshold) | (
                pos >= self.host_payload_slots)
            dev_it = torch.where(to_dev, it, -1)
            self.replay(state, pass_index, (cr, ci, dev_it))
            ks = self.host_payload_slots
            cr, ci, it = cr[:ks], ci[:ks], torch.where(to_dev, -1, it)[:ks]
        # The split's device batch has -1 holes where the host's orbits
        # were, all inside the kept prefix that the counters read.
        self.add_pass_stats(state, result, n_valid, dev_it)
        return (it >= 0).sum(), self.pack_payload(cr, ci, it)

    def pack_payload(self, cr, ci, it) -> torch.Tensor:
        """A kept batch in the JAX engine's payload layout (bit for bit):
        on the default domain with bands up to 0xFFFF two 32-bit words an
        emission, ``k | (iters + 1) & 0xFF << 24`` and ``k | (iters + 1) >>
        8 << 24`` with k = (c + 2) * 2^22 the 24-bit grid index (int32
        tensors holding the words' bits: torch has no uint32 arithmetic;
        k is masked to 24 bits, which changes nothing for a valid c and
        keeps an invalid slot's unset c from reaching the length bits);
        otherwise float32 rows [cr; ci; iters] (grid indices at extended
        precision)."""
        if not self.tuning.packed_payload:
            return torch.stack([cr, ci, it.to(torch.float32)])
        k = (torch.stack([cr, ci]) + 2.0) * 4194304.0
        k = k.to(torch.int64) & 0xFFFFFF
        enc = (it + 1).to(torch.int64)
        words = k | torch.stack([enc & 0xFF, enc >> 8]) << 24
        return (words - ((words >> 31) << 32)).to(torch.int32)

    def _replay_fused(self, state: dict, pass_index: int, batch, kw) -> None:
        """The fused replay-deposit of one pass's kept batch, adding its
        on-canvas count to ``dev_hits``. On the card it runs on a side
        stream, so the next pass's classify and compaction (main stream)
        run under its long-orbit tail: the side stream waits on an event
        recorded after the compaction; the batch, the histogram and
        ``dev_hits`` are marked as used there (``record_stream``), so the
        caching allocator does not hand their memory to the main stream
        before the replay is done; the kernel adds the count into
        ``dev_hits`` with atomics, so the replays of consecutive passes,
        on the two streams, may overlap. Integer adds commute: histogram
        and stats are bitwise those of passes run one after another.
        Everything that reads them waits first (``wait_replay``)."""
        replay = (binning.replay_deposit_ext if self.extended
                  else binning.replay_deposit)
        hist = state["hist"].view(-1)
        if not self.replay_streams:
            with trace.span("cb.deposit", device=self.device):
                replay(hist, *batch, hits=state["dev_hits"], **kw)
            return
        side = self.replay_streams[pass_index % len(self.replay_streams)]
        side.wait_stream(torch.cuda.current_stream(self.device))
        for t in (*batch, state["hist"], state["dev_hits"]):
            t.record_stream(side)
        with torch.cuda.stream(side):
            # On the side stream: the span's events time the replay there.
            with trace.span("cb.deposit", device=self.device):
                replay(hist, *batch, hits=state["dev_hits"], **kw)

    def wait_replay(self) -> None:
        """Make the current stream wait for every fused replay in flight
        (nothing to wait for on the CPU or on an id-stream route)."""
        if self.replay_streams:
            cur = torch.cuda.current_stream(self.device)
            for side in self.replay_streams:
                cur.wait_stream(side)

    def mh_pass_spec(self) -> dict:
        """The keywords of this render's MH classify pass
        (``ops.classify_mh``) other than its seed."""
        cfg, tn, o = self.cfg, self.tuning, self.cfg.options
        cv = cfg.canvas
        c_r = c_i = 0.0
        if self.extended:
            # The df32 kernel tests the window in centre-relative
            # coordinates: the canvas bounds minus the exact f64 value of
            # the df32 sample-window centre.
            c0r, c0i, _, _ = cls_ext.grid_params(cfg.sample_domain)
            c_r = float(df32.to_float64(*c0r))
            c_i = float(df32.to_float64(*c0i))
        return dict(
            fractal=self.fractal, min_it=tn.min_it, max_it=tn.max_it,
            steps_per_pass=tn.steps_per_pass,
            steps_per_flush=tn.steps_per_flush,
            cycle_detection=o.cycle_detection, inner_unroll=tn.inner_unroll,
            sample_domain=cfg.sample_domain,
            window=(cv.min_real - c_r, cv.max_real - c_r,
                    cv.min_imag - c_i, cv.max_imag - c_i),
            restart256=o.mh_restart, rep_cap=o.mh_rep_cap,
            canvas_wh=(cv.width, cv.height),
        )

    def _mh_core(self, state: dict, pass_index: int, ordinal: int) -> dict:
        """The MH pass: the chain kernel, then the weighted deposit of its
        emissions. While ``pass_index < mh_burnin_passes`` the chains
        advance and nothing is deposited; on the last burn-in pass every
        tenure counter is zeroed, so mass gathered during burn-in cannot
        deposit later."""
        result = self._mh_classify(state, pass_index, ordinal)
        if pass_index >= self.cfg.options.mh_burnin_passes:
            # Every emission fits (Tuning sizes the capacity so), and the
            # deposit is order-free integer addition: one launch reads the
            # emission buffers as they are (a slot with emit_it < 0 deposits
            # nothing) and adds its totals straight into the counters.
            with trace.span("cb.deposit", device=self.device):
                binning.mh_deposit(
                    state["hist"].view(-1), result.emit_bins, result.emit_v,
                    result.emit_rep, chunked=True, gate=result.emit_it,
                    totals=(state["points"], state["mh_deposited"]))
        return state

    def _mh_classify(self, state: dict, pass_index: int, ordinal: int):
        """The MH chain kernel of a pass and its counters; zeroes every
        tenure counter on the last burn-in pass (the emissions read
        nothing from them). Returns the classify result."""
        o = self.cfg.options
        seed = prng.bits_host(prng.pass_key(self.cfg.seed, ordinal,
                                            pass_index), 2)
        classify = (cls_mh.classify_pass_ext_mh if self.extended
                    else cls_mh.classify_pass_mh)
        with trace.span("cb.classify", device=self.device, sampler="mh",
                        burnin=pass_index < o.mh_burnin_passes,
                        precision=o.precision):
            result = classify(state["lanes"], seed, **self.mh_pass_spec())
            if pass_index == o.mh_burnin_passes - 1:
                state["lanes"].rep.zero_()
        with trace.span("cb.counters", device=self.device):
            st = result.stats.reshape(cls_mh.MH_STATS_ROWS, -1).sum(dim=1)
            wasted = st[cls.STAT_WASTED]
            for k, v in (
                ("samples", st[cls.STAT_DRAWN]),
                ("culled", st[cls.STAT_CULLED]),
                ("in_band", st[cls.STAT_IN_BAND]),
                ("cycles", st[cls.STAT_CYCLES]),
                ("wasted", wasted),
                ("iters", self.steps_per_pass - wasted),
                ("emitted", (result.emit_it >= 0).sum()),
                ("mh_accepts", st[cls_mh.STAT_MH_ACCEPT]),
                ("mh_merges", st[cls_mh.STAT_MH_MERGE]),
                ("mh_merged_rep", st[cls_mh.STAT_MH_MERGED_REP]),
            ):
                state[k] += v
        return result

    def mh_tail_core(self, state: dict) -> dict:
        """Deposit every chain's in-flight tenure (its recorded visit bins,
        weighted by the rep gathered so far) and zero the tenure counters.
        The two halves of a tenure split this way are additive, so the
        flush is exact at any call point. Without it each chain's last
        unfinished tenure would vanish, and those are the stickiest, that
        is the brightest, states."""
        lanes = state["lanes"]
        with trace.span("cb.mh_tail", device=self.device):
            # Only tenures with rep > 0 and visits (xv > 1) carry mass;
            # xv == 1 is the in-band bridge state.
            binning.mh_deposit(
                state["hist"].view(-1), lanes.xb, lanes.xv, lanes.rep,
                gate=lanes.rep, gate_min=1,
                totals=(state["points"], state["mh_deposited"]))
            lanes.rep.zero_()
        return state

    def run_pass(self, state: dict, pass_index: int) -> dict:
        if self._worker is None:
            return self.core(state, pass_index)
        with trace.span("cb.make_room"):
            self._worker.make_room()
        out = self.host_pass(state, pass_index)
        if out is not None:
            self._worker.submit(self.stage(*out))
        return state

    def stage(self, n_valid: torch.Tensor, payload: torch.Tensor):
        """A pass's payload for the worker: on the card, copied into the
        next pinned ring slot behind the pass (``PinnedStage``; call
        ``worker.make_room`` first); on the CPU, the tensors as they are."""
        from cudabrot_tpu_torch.engines.host_replay import Staged

        if self._stage is None:
            return Staged(None, n_valid, payload)
        return self._stage.stage(n_valid, payload)

    def warmup(self, state: dict) -> None:
        """Build the CUDA kernels (nvcc, all sources at once) and, in host
        mode, the native replay library before the timed loop, so the time
        box covers rendering only."""
        if self.device.type == "cuda":
            from cudabrot_tpu_torch.ops import _build

            _build.build_all()
        if self._worker is not None:
            from cudabrot_tpu_torch.io import native

            native.load()

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def sync_group(self) -> None:
        """The driver's wait at the end of a group of passes. With fused
        replays on the side streams (and no host worker) the host waits for
        the main stream, and for the side streams up to the event each
        recorded at the previous group end: the last passes' replays run on
        while the next group is issued, and at most one group of replays
        trails the main stream. Otherwise a full ``synchronize``."""
        if not self.replay_streams or self._worker is not None:
            self.synchronize()
            return
        torch.cuda.current_stream(self.device).synchronize()
        for ev in self._group_ends:
            ev.synchronize()
        self._group_ends = [side.record_event()
                            for side in self.replay_streams]

    def memory_estimate(self) -> tuple[int, int]:
        """(device_bytes, host_bytes) — the reference's startup banner
        equivalent (cudabrot.cu:154-165)."""
        cv = self.cfg.canvas
        slots = self.tuning.emission_slots
        hist = cv.num_pixels * 4
        host = hist + cv.num_pixels * 2
        if self.mh:
            lane_cls = (cls_mh.ExtMhLaneState if self.extended
                        else cls_mh.MhLaneState)
            # vb/xb are (visit_slots, R, 128) each; an emission is
            # (3 + visit_slots) int32 words, deposited where it lies.
            words = (len(lane_cls._fields) + 2 * (self.visit_slots - 1)
                     + cls_mh.MH_STATS_ROWS)
            emission = slots * (3 + self.visit_slots) * 4
            device = hist + self.lanes * words * 4 + emission
            if self._worker is not None:
                # The payload, and the pinned ring that receives it.
                device += emission
                host += self._host_bytes(emission)
            return device, host
        lane_cls = cls_ext.ExtLaneState if self.extended else cls.LaneState
        lanes = self.lanes * (len(lane_cls._fields) + cls.STATS_ROWS) * 4
        emission = slots * 12
        # Compaction: int64 keys, sort output and indices per slot.
        sort = slots * 8 * 3
        replay = self.replay_capacity * 12
        if self.scatter_backend != "fused":
            # One group's id stream and what its route adds to it.
            ids = min(binning.BIGTILES_ID_BUDGET,
                      self.replay_capacity * self.tuning.max_it)
            replay += ids * binning.ID_ROUTE_BYTES[self.scatter_backend]
        device = hist + lanes + emission + sort + replay
        if self._worker is not None:
            payload = self.host_payload_slots * (
                8 if self.tuning.packed_payload else 12)
            device += payload
            host += self._host_bytes(payload)
        return device, host

    def _host_bytes(self, payload: int) -> int:
        """The host accumulator and the payload ring (host mode)."""
        w = self._worker
        return (self.cfg.canvas.num_pixels * w.hist.dtype.itemsize
                + (w.max_queue + 1) * payload)

    def flush_mh_tails_host(self, state: dict) -> None:
        """Host mode's ``mh_tail_core``: every chain's in-flight tenure
        deposits into the worker's accumulator (``mh_deposit_numpy``, equal
        to the device deposit), and the tenure counters are zeroed."""
        from cudabrot_tpu_torch.engines.host_replay import mh_deposit_numpy

        lanes = state["lanes"]
        with trace.span("cb.mh_tail"):
            xv = lanes.xv.reshape(-1).cpu().numpy()
            rep = lanes.rep.reshape(-1).cpu().numpy()
            live = (xv > 1) & (rep > 0)
            if live.any():
                bins = lanes.xb.reshape(self.visit_slots, -1).cpu().numpy()
                w = self._worker
                w.drain()
                hits, points = mh_deposit_numpy(w.hist, bins[:, live],
                                                xv[live], rep[live])
                w.hits += hits
                w.points += points
            lanes.rep.zero_()

    def device_histogram(self, state: dict) -> np.ndarray:
        """The device histogram (uint32), after every replay in flight."""
        self.wait_replay()
        return state["hist"].cpu().numpy().view(np.uint32).copy()

    def histogram(self, state: dict) -> np.ndarray:
        """The render's histogram: uint32, or the worker's dtype in host
        mode. MH chains' unfinished tenures deposit first. In pure host
        mode the device histogram is never written, so it is not read."""
        if self._worker is None:
            if self.mh:
                self.mh_tail_core(state)
            return self.device_histogram(state)
        if self.mh:
            self.flush_mh_tails_host(state)
        self._worker.drain()
        if self.split_threshold == 0:
            return self._worker.hist.copy()
        return self._worker.hist + self.device_histogram(state)

    def counter_stats(self, state: dict) -> dict:
        """The device counters alone (no host worker tally), as
        ``utils.counters.counter_stats`` names them."""
        self.wait_replay()
        return counters.counter_stats(state)

    def stats(self, state: dict) -> dict:
        out = self.counter_stats(state)
        if self._worker is not None:
            tally = worker_tally(self._worker, self.mh)
            out.update({k: out.get(k, 0) + v for k, v in tally.items()})
            return finish_host_stats(self, out, self._worker)
        out["on_canvas_points"] = out.pop("_device_on_canvas")
        out["replay"] = "device"
        if self.mh:
            # The bins deposit conserves tenure mass by construction, so
            # no weight is ever lost.
            out["weight_scale"] = self.weight_scale
            out["mh_lost_weight"] = 0
            out["on_canvas_points"] = out["mh_deposited"]
        return out


def mh_payload(it, rep, t, bins) -> torch.Tensor:
    """MH emissions in the JAX engine's host payload layout: int32 rows
    [iters; rep; t; bins] with t = 0 on invalid slots (``iters < 0``), which
    then deposit nothing. ``bins``: (V, N) recorded visit bins."""
    t = torch.where(it >= 0, t, 0)
    return torch.cat([torch.stack([it, rep, t]), bins]).to(torch.int32)


def worker_tally(worker, mh: bool) -> dict:
    """A host worker's counts under the stats' names, to add to the device
    counters: its replayed points, and its on-canvas deposits (with MH, its
    deposited mass, which is also ``mh_deposited``)."""
    worker.drain()
    tally = {"orbit_points": worker.points, "_host_on_canvas": worker.hits}
    if mh:
        tally["mh_deposited"] = worker.hits
    return tally


def finish_host_stats(engine, out: dict, worker) -> dict:
    """Host-mode stats from summed counters and tallies:
    ``on_canvas_points`` is the worker's deposits plus the device share's,
    ``replay`` host or hybrid, and the worker's fetch and replay seconds
    (this process's worker)."""
    out["on_canvas_points"] = (out.pop("_device_on_canvas")
                               + out.pop("_host_on_canvas"))
    out["replay_fetch_seconds"] = round(worker.fetch_seconds, 3)
    out["replay_busy_seconds"] = round(worker.replay_seconds, 3)
    out["replay"] = "hybrid" if engine.split_threshold > 0 else "host"
    if engine.mh:
        out["weight_scale"] = engine.weight_scale
        out["mh_lost_weight"] = worker.lost_weight
    return out
