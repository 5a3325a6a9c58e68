"""The Metropolis-Hastings chain functions and the weighted deposit of
cudabrot_tpu_torch against the JAX package's, bitwise.

``_mh_propose``, ``_mh_boundary``, ``_record_visit``, ``_init_rsv``,
``mh_deposit_weights`` and ``mh_scatter`` are pure jnp functions. Called
eagerly (not under jit) JAX runs one XLA primitive per operation, so every
float product rounds once as in eager PyTorch, and the integer arithmetic
is exact in both: the port must agree bit for bit. Inputs come from numpy
seeds and cover the documented extremes: unseeded chains, the rep cap,
occupied and empty pending slots, visits beyond the reservoir width,
t <= 1, v above the reservoir width, v at the 32767 cap, rep at 98303.

The g++ build of the deposit is held to the plain version too: an
emulation of the kernel's warps (host_harness.cpp cbh_mh_deposit_warps:
each group of 32 slots spreads its (emission, k) pairs over the lanes), on
fixed buffers and by a hypothesis property over t, rep, the reservoir
width, gates, partial groups, out-of-range bins and streams of one bin.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cudabrot_tpu.ops import binning as jbin
from cudabrot_tpu.ops import pallas_kernels_mh as pkm
from cudabrot_tpu_torch.ops import binning, launches
from cudabrot_tpu_torch.ops import classify_mh as cmh
from tests.test_torch_df32 import harness  # noqa: F401  (fixture)

# One intra-op thread: the suite runs in several worker processes at once.
torch.set_num_threads(1)

N = 4096


def _words(rng, n=N):
    return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)


def _tw(a):
    """uint32 numpy words as the port's int64 tensors of uint32 values."""
    return torch.from_numpy(a.astype(np.int64))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    if want.dtype == np.float32:
        assert got.dtype == np.float32, msg
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32), err_msg=msg)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=msg)


def test_constants_match():
    assert cmh.WEIGHT_SCALE == pkm.WEIGHT_SCALE
    assert cmh.TARGET_VISIT == pkm.TARGET_VISIT
    assert cmh.T_VCAP == pkm._T_VCAP
    assert (cmh.STAT_MH_ACCEPT, cmh.STAT_MH_MERGE, cmh.STAT_MH_MERGED_REP,
            cmh.MH_STATS_ROWS) == (pkm.STAT_MH_ACCEPT, pkm.STAT_MH_MERGE,
                                   pkm.STAT_MH_MERGED_REP, pkm.MH_STATS_ROWS)
    assert cmh.MhLaneState._fields == pkm.MhLaneState._fields
    assert cmh.ExtMhLaneState._fields == pkm.ExtMhLaneState._fields


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_init_rsv_bitwise(rows):
    _eq(cmh.init_rsv((rows, 128)), pkm._init_rsv((rows, 128)))


@pytest.mark.parametrize("ext", [False, True])
@pytest.mark.parametrize("slots", [2, 8, 32])
def test_init_state_bitwise(ext, slots):
    if ext:
        got = cmh.init_ext_mh_lane_state(3, slots)
        want = pkm.init_ext_mh_lane_state(3, slots)
    else:
        got = cmh.init_mh_lane_state(3, slots)
        want = pkm.init_mh_lane_state(3, slots)
    for name, g, w in zip(got._fields, got, want):
        _eq(g, w, name)


@pytest.mark.parametrize("restart256", [0, 16, 200, 256])
def test_propose_bitwise(restart256):
    rng = np.random.default_rng(restart256 + 1)
    xkr = rng.integers(0, 1 << 24, N).astype(np.float32)
    xki = rng.integers(0, 1 << 24, N).astype(np.float32)
    # Indices at the domain's edges, so local moves leave it.
    xkr[:64] = rng.choice([0.0, 1.0, 16777215.0, 16777214.0], 64)
    xki[32:96] = rng.choice([0.0, 3.0, 16777215.0], 64)
    xv = rng.choice([0, 1, 257, 8388353], N).astype(np.int32)
    rb_r, rb_i, rb_b = _words(rng), _words(rng), _words(rng)
    got = cmh.mh_propose(_t(xkr), _t(xki), _t(xv), _tw(rb_r), _tw(rb_i),
                         _tw(rb_b), restart256)
    want = pkm._mh_propose(jnp.asarray(xkr), jnp.asarray(xki),
                           jnp.asarray(xv), jnp.asarray(rb_r),
                           jnp.asarray(rb_i), jnp.asarray(rb_b), restart256)
    for name, g, w in zip(("nk_r", "nk_i", "oob"), got, want):
        _eq(g, w, name)
    assert bool(got[2].any()) == (restart256 < 256)


@pytest.mark.parametrize("slots,rep_cap", [(2, 2), (8, 64), (32, 4096)])
def test_boundary_bitwise(slots, rep_cap):
    rng = np.random.default_rng(slots)
    i32 = np.int32
    fin = rng.random(N) < 0.7
    v_prop = rng.choice([0, 1, 257, 513, 8388353], N).astype(i32)
    needed = rng.integers(0, 5000, N).astype(i32)
    kr = rng.integers(0, 1 << 24, N).astype(np.float32)
    ki = rng.integers(0, 1 << 24, N).astype(np.float32)
    xkr = rng.integers(0, 1 << 24, N).astype(np.float32)
    xki = rng.integers(0, 1 << 24, N).astype(np.float32)
    xv = rng.choice([0, 1, 257, 769, 8388353], N).astype(i32)
    xit = rng.integers(-1, 5000, N).astype(i32)
    # Tenures below, one short of, and at the cap.
    rep = rng.choice([0, 1, rep_cap - 2, rep_cap - 1, rep_cap], N).astype(i32)
    vb = rng.integers(0, 1600, (slots, N)).astype(i32)
    xb = rng.integers(0, 1600, (slots, N)).astype(i32)
    p_it = np.where(rng.random(N) < 0.5, -1,
                    rng.integers(0, 5000, N)).astype(i32)
    p_rep = np.where(p_it >= 0, rng.integers(1, 70000, N), 0).astype(i32)
    p_v = np.where(p_it >= 0, 257, 0).astype(i32)
    p_b = rng.integers(0, 1600, (slots, N)).astype(i32)
    rb_a, rb_b = _words(rng), _words(rng)
    # Acceptance draws that sit on the compare's edge: u = 0 and u ~ 1.
    rb_a[:128] = 0
    rb_a[128:256] = 0xFFFFFFFF
    args = (fin, v_prop, needed, kr, ki, xkr, xki, xv, xit, rep, vb, xb,
            p_it, p_rep, p_v, p_b)
    got = cmh.mh_boundary(*(_t(a) for a in args), _tw(rb_a), _tw(rb_b),
                          rep_cap)
    want = pkm._mh_boundary(*(jnp.asarray(a) for a in args),
                            jnp.asarray(rb_a), jnp.asarray(rb_b), rep_cap)
    names = ("accept", "xkr", "xki", "xv", "xit", "rep", "xb", "p_it",
             "p_rep", "p_v", "p_b", "d_merges", "d_merged_rep")
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        _eq(g, w, name)
    assert int(got[11].sum()) > 0 and bool(got[0].any())


@pytest.mark.parametrize("slots", [2, 8, 32])
def test_record_visit_bitwise(slots):
    """A run of steps from one LCG state, so the advance composes; the
    window is the 40x40 seahorse crop, positions straddle its edges, and
    visit counts run past the reservoir width."""
    rng = np.random.default_rng(10 + slots)
    win = (-0.78, -0.72, 0.05, 0.11)
    w, h = 40, 37
    jmap = (win[0], win[2], w / (win[1] - win[0]), h / (win[3] - win[2]),
            w, h)
    f32 = np.float32
    tmap = (*(torch.tensor(v, dtype=torch.float32) for v in jmap[:4]), w, h)
    rsv = np.asarray(pkm._init_rsv((N // 128, 128))).reshape(-1)
    vb = rng.integers(0, w * h, (slots, N)).astype(np.int32)
    jvis = rng.integers(0, 3 * slots, N).astype(np.int32)
    t_rsv, t_vb, t_j = _t(rsv), _t(vb), _t(jvis)
    j_rsv, j_vb, j_j = jnp.asarray(rsv), jnp.asarray(vb), jnp.asarray(jvis)
    writes = 0
    for step in range(6):
        dr = rng.uniform(win[0] - 0.01, win[1] + 0.01, N).astype(f32)
        di = rng.uniform(win[2] - 0.01, win[3] + 0.01, N).astype(f32)
        # The upper-edge neighbours, where the quantized bin can round up.
        dr[:16] = np.nextafter(f32(win[1]), f32(-1))
        di[16:32] = np.nextafter(f32(win[3]), f32(-1))
        vis = ((dr >= f32(win[0])) & (dr < f32(win[1]))
               & (di >= f32(win[2])) & (di < f32(win[3])))
        t_rsv, t_new = cmh.record_visit(_t(vis), _t(dr), _t(di), t_j, t_rsv,
                                        t_vb, tmap)
        j_rsv, j_new = pkm._record_visit(
            jnp.asarray(vis), jnp.asarray(dr), jnp.asarray(di), j_j, j_rsv,
            j_vb, jmap)
        writes += int((t_new != t_vb).sum())
        t_vb, j_vb = t_new, j_new
        _eq(t_rsv, j_rsv, f"rsv step {step}")
        _eq(t_vb, j_vb, f"vb step {step}")
        t_j = t_j + _t(vis).to(torch.int32)
        j_j = j_j + jnp.asarray(vis).astype(jnp.int32)
    assert writes > N
    assert int(t_vb.max()) < w * h and int(t_vb.min()) >= 0


def _deposit_inputs(seed=11, extra=200):
    """(t, rep) over the documented extremes, plus invalid t <= 1."""
    rng = np.random.default_rng(seed)
    v = np.concatenate([
        np.array([1, 1, 2, 3, 7, 8, 9, 32767, 32767, 32767], np.int64),
        rng.integers(1, 32768, size=extra)])
    rep = np.concatenate([
        np.array([1, 98303, 1, 7, 4096, 1, 98303, 1, 98303, 32767],
                 np.int64),
        rng.integers(1, 98304, size=extra)])
    t = 256 * v + 1
    t = np.concatenate([t, np.array([1, 0, -5, 1], np.int64)])
    rep = np.concatenate([rep, np.array([5, 9, 3, 0], np.int64)])
    return t.astype(np.int32), rep.astype(np.int32), v


@pytest.mark.parametrize("slots", [2, 8, 32])
def test_deposit_weights_bitwise_and_exact(slots):
    t, rep, v = _deposit_inputs()
    d, n, q = binning.mh_deposit_weights(_t(t), _t(rep), slots)
    jd, jn_, jq = jbin.mh_deposit_weights(jnp.asarray(t), jnp.asarray(rep),
                                          slots)
    _eq(d, jd, "d")
    _eq(n, jn_, "n")
    _eq(q, jq, "q")
    k = len(v)
    want_q = (v * rep[:k].astype(np.int64) * 65536) // (256 * v + 1)
    np.testing.assert_array_equal(q.numpy()[:k], want_q)
    np.testing.assert_array_equal(d.numpy().sum(axis=0)[:k], want_q)
    np.testing.assert_array_equal(n.numpy()[:k], np.minimum(v, slots))
    assert (q.numpy()[k:] == 0).all() and (d.numpy()[:, k:] == 0).all()
    # Every intermediate of the u32 long division stays below 2^32.
    assert int((v * rep[:k].astype(np.int64)).max()) < 1 << 32
    assert int((np.arange(1, slots + 1)[:, None] * want_q[None]).max()) \
        < 1 << 32


@pytest.mark.parametrize("slots", [2, 8, 32])
def test_mh_scatter_bitwise(slots):
    t, rep, _ = _deposit_inputs(seed=5)
    s, nbins = len(t), 900
    rng = np.random.default_rng(slots)
    bins = rng.integers(0, nbins, (slots, s)).astype(np.int32)
    hist0 = rng.integers(0, 1 << 32, nbins, dtype=np.uint64).astype(np.uint32)
    hist = _t(hist0.view(np.int32))
    launches.reset()
    out, deposits, mass = binning.mh_scatter(hist, _t(bins), _t(t), _t(rep))
    assert launches.COUNTS["mh_deposit_plain"] == 1
    jh, jdep, jmass = jbin.mh_scatter(jnp.asarray(hist0), jnp.asarray(bins),
                                      jnp.asarray(t), jnp.asarray(rep))
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  np.asarray(jh))
    _eq(deposits, jdep, "deposits")
    _eq(mass, jmass, "mass")
    added = (out.numpy().view(np.uint32).astype(np.int64)
             - hist0.astype(np.int64)) % (1 << 32)
    assert int(added.sum()) == int(mass.sum())


@pytest.mark.parametrize("chunks,slots", [(1, 8), (3, 4), (8, 8)])
def test_mh_deposit_layouts_agree(chunks, slots):
    """The chunked layout (the classify pass's emission buffers) and the
    compacted (V, S) layout deposit the same histogram and totals."""
    rng = np.random.default_rng(chunks)
    rows, nbins = 2, 1600
    t1, rep1, _ = _deposit_inputs(seed=chunks, extra=chunks * rows * 128 - 14)
    t = t1.reshape(chunks, rows, 128)
    rep = rep1.reshape(chunks, rows, 128)
    bins = rng.integers(0, nbins, (chunks, slots, rows, 128)).astype(np.int32)
    ha = torch.zeros(nbins, dtype=torch.int32)
    dep_a, mass_a = binning.mh_deposit(ha, _t(bins), _t(t), _t(rep),
                                       chunked=True)
    flat = np.moveaxis(bins, 1, 0).reshape(slots, -1)
    hb = torch.zeros(nbins, dtype=torch.int32)
    dep_b, mass_b = binning.mh_deposit(hb, _t(flat), _t(t.reshape(-1)),
                                       _t(rep.reshape(-1)))
    assert torch.equal(ha, hb)
    assert int(dep_a) == int(dep_b) > 0
    assert int(mass_a) == int(mass_b) == int(ha.to(torch.int64).sum())


def test_mh_deposit_validation():
    h = torch.zeros(16, dtype=torch.int32)
    b = torch.zeros((2, 4), dtype=torch.int32)
    t = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        binning.mh_deposit(h, b, t.to(torch.int64), t)
    with pytest.raises(ValueError, match="do not match"):
        binning.mh_deposit(h, b, t[:3], t[:3])
    with pytest.raises(ValueError, match="do not match"):
        binning.mh_deposit(h, b, t, t, chunked=True)
    with pytest.raises(ValueError, match="histogram"):
        binning.mh_deposit(h.to(torch.int64), b, t, t)


@pytest.mark.parametrize("chunks,slots", [(1, 2), (2, 8), (3, 32)])
def test_header_mh_deposit_bitwise(harness, chunks, slots):  # noqa: F811
    """csrc/mh.cuh's deposit functions in the kernel's warps, emulated on
    the CPU, against the plain version: histogram, recorded-bin count and
    mass."""
    rng = np.random.default_rng(slots)
    lanes, nbins = 256, 1000
    t, rep, _ = _deposit_inputs(seed=slots, extra=chunks * lanes - 14)
    bins = rng.integers(0, nbins, (chunks, slots, lanes)).astype(np.int32)
    # Out-of-range bins are dropped, their mass still counted.
    bins[0, 0, :8] = [-1, nbins, nbins + 5, -7, 0, nbins - 1, 1, 2]
    hp = torch.zeros(nbins, dtype=torch.int32)
    dep, mass = binning.mh_deposit(
        hp, _t(bins), _t(t.reshape(chunks, lanes)),
        _t(rep.reshape(chunks, lanes)), chunked=True)
    hist, got_dep, got_mass = _host_deposit_warps(
        harness, bins, None, 0, t, rep, np.zeros(nbins, np.uint32))
    np.testing.assert_array_equal(hist.view(np.int32), hp.numpy())
    assert got_dep == int(dep) > 0
    assert got_mass == int(mass) > 0


def test_mh_deposit_gate_and_totals():
    """A gate closes slots as t <= 1 would (the engine's emit_it >= 0 and
    the tail's rep >= 1), and given totals are added to in place."""
    rng = np.random.default_rng(3)
    slots, n, nbins = 8, 512, 700
    t, rep, _ = _deposit_inputs(seed=3, extra=n - 14)
    bins = rng.integers(0, nbins, (slots, n)).astype(np.int32)
    gate = rng.integers(-2, 3, n).astype(np.int32)
    for gate_min in (0, 1):
        ha, hb = (torch.zeros(nbins, dtype=torch.int32) for _ in range(2))
        totals = (torch.tensor(5, dtype=torch.int64),
                  torch.tensor(7, dtype=torch.int64))
        got = binning.mh_deposit(ha, _t(bins), _t(t), _t(rep), gate=_t(gate),
                                 gate_min=gate_min, totals=totals)
        assert got[0] is totals[0] and got[1] is totals[1]
        dep, mass = binning.mh_deposit(
            hb, _t(bins), _t(np.where(gate >= gate_min, t, 0)), _t(rep))
        assert torch.equal(ha, hb) and int(hb.sum()) > 0
        assert (int(totals[0]), int(totals[1])) == (int(dep) + 5,
                                                    int(mass) + 7)
    with pytest.raises(ValueError, match="gate"):
        binning.mh_deposit(ha, _t(bins), _t(t), _t(rep),
                           gate=_t(gate[:-1]))
    with pytest.raises(ValueError, match="totals"):
        binning.mh_deposit(ha, _t(bins), _t(t), _t(rep),
                           totals=(totals[0], totals[1].to(torch.int32)))


def _host_deposit_warps(harness, bins, gate, gate_min, t, rep, hist):
    """The emulated kernel's deposit of (chunks, V, lanes) bins into a
    copy of ``hist``: (histogram, deposits, mass)."""
    chunks, slots, lanes = bins.shape
    out = hist.copy()
    totals = (ctypes.c_longlong * 2)(0, 0)
    vp = ctypes.c_void_p
    harness.cbh_mh_deposit_warps.argtypes = [
        vp, vp, ctypes.c_int, vp, vp, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, vp, ctypes.c_int, vp, vp]
    rc = harness.cbh_mh_deposit_warps(
        bins.ctypes.data, None if gate is None else gate.ctypes.data,
        gate_min, t.ctypes.data, rep.ctypes.data, t.size, slots, lanes,
        out.ctypes.data, out.size, ctypes.addressof(totals),
        ctypes.addressof(totals) + 8)
    assert rc == 0
    return out, totals[0], totals[1]


@settings(max_examples=40, deadline=None, database=None)
@given(chunks=st.integers(1, 3), lanes=st.sampled_from([1, 31, 32, 40, 96]),
       slots=st.sampled_from([1, 2, 8, 32]),
       t_kind=st.sampled_from(["visits", "any", "mixed"]),
       bin_kind=st.sampled_from(["spread", "one bin", "out of range"]),
       gated=st.sampled_from([None, 0, 1]),
       seed=st.integers(0, 2**16))
def test_header_mh_deposit_warps_property(harness, chunks, lanes, slots,  # noqa: F811
                                          t_kind, bin_kind, gated, seed):
    """The kernel's warp spread over drawn emission buffers: t of the
    chains' form 256 v + 1 (v up to the 32767 cap), any t in (1, 2^23),
    or mixed with t <= 1; rep up to 98303 and below 1; n = min(v, V)
    from 1 to 32; groups of 32 cut by the chunk's end; bins spread over
    the histogram, all one bin (the u32 adds wrapping), or half outside
    it; with and without a gate. Histogram (from random words),
    recorded-bin count and mass equal mh_scatter's bitwise."""
    rng = np.random.default_rng(seed)
    n, nbins = chunks * lanes, 300
    v = rng.choice([1, 2, 7, 8, 9, 31, 32, 33, 32767],
                   n) if seed % 2 else rng.integers(1, 32768, n)
    t = 256 * v + 1
    if t_kind == "any":
        t = rng.integers(2, 1 << 23, n)
    elif t_kind == "mixed":
        t = np.where(rng.random(n) < 0.4, rng.integers(-3, 2, n), t)
    t = t.astype(np.int32).reshape(chunks, lanes)
    rep = rng.choice([-2, 0, 1, 5, 4096, 98303], n) if seed % 3 else \
        rng.integers(1, 98304, n)
    rep = rep.astype(np.int32).reshape(chunks, lanes)
    if bin_kind == "one bin":
        bins = np.full((chunks, slots, lanes), nbins // 2, np.int32)
    elif bin_kind == "out of range":
        bins = rng.integers(-nbins, 2 * nbins, (chunks, slots, lanes))
    else:
        bins = rng.integers(0, nbins, (chunks, slots, lanes))
    bins = bins.astype(np.int32)
    gate = None if gated is None else \
        rng.integers(-1, 3, (chunks, lanes)).astype(np.int32)
    hist0 = rng.integers(0, 1 << 32, nbins, dtype=np.uint64).astype(np.uint32)
    got, dep, mass = _host_deposit_warps(harness, bins, gate, gated or 0, t,
                                         rep, hist0)
    hp = _t(hist0.view(np.int32))
    want_dep, want_mass = binning.mh_deposit(
        hp, _t(bins), _t(t), _t(rep), chunked=True,
        gate=None if gate is None else _t(gate), gate_min=gated or 0)
    np.testing.assert_array_equal(got.view(np.int32), hp.numpy())
    assert (dep, mass) == (int(want_dep), int(want_mass))
