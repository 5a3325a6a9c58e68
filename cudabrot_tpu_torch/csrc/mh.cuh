// Metropolis-Hastings chain functions, the lane functions of the two MH
// classify kernels, and the weighted bin deposit, as __host__ __device__
// code: the two kernels of classify_mh.cu run the lane's functions (the
// f32 and the df32 orbit are their Orbit policy) in one warp template,
// deposit.cu spreads each warp's emissions over its lanes (mh_slot,
// pair_owner, mh_share), and host_harness.cpp loops these on the CPU so a
// g++ build can be held bitwise against the plain PyTorch versions
// (ops/classify_mh.py, ops/binning.py).
//
// The chain functions are the ones cudabrot_tpu/ops/pallas_kernels_mh.py
// shares between its two kernels (_mh_propose, _mh_boundary,
// _record_visit, _mh_bits), written for one lane. Every float compare that
// decides an integer is one rounded product (fmul) of exactly converted
// integers, as the JAX body's astype(float32) products are.
#pragma once

#include "df32.cuh"

namespace cb {
namespace mh {

constexpr int kTargetVisit = 256;   // chain-target units per canvas visit
constexpr int kVisitCap = 32767;    // visits counted toward the target
constexpr int kTwo24 = 1 << 24;     // grid points per axis
constexpr float kInv24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kBig = 1.0e30f;     // Brent "never matches" saved point
constexpr int kSave0 = 16;          // first Brent save index, doubling
// Stat rows: drawn, culled, in_band, cycles, wasted, accepts, merges,
// merged rep mass.
constexpr int kStats = 8;

// The canvas window and its bin map, in the orbit policy's window
// coordinates (absolute for f32, centre-relative for df32).
struct Window {
  float x0, x1, y0, y1;    // bounds, [x0, x1) x [y0, y1)
  float inv_dx, inv_dy;    // f32(width / (x1 - x0)), f32(height / (y1 - y0))
  int width, height;
};

// The top 24 bits of a random word as an f32 (exact).
CB_HD float top24(uint32_t w) { return float(int32_t(w >> 8)); }

CB_HD int32_t imin(int32_t a, int32_t b) { return a < b ? a : b; }

struct Proposal {
  int32_t kr, ki;  // grid indices, clipped into [0, 2^24)
  bool oob;        // a local move left the sample domain: a dead proposal
};

// _mh_propose: a symmetric multi-scale integer mutation of the chain's
// grid indices (mantissa >> scale, scale uniform over 24 octaves, random
// sign), mixed with a uniform restart of weight restart256/256 that is
// forced while the chain is unseeded (xv == 0).
CB_HD Proposal propose(float xkr, float xki, int32_t xv, uint32_t rb_r,
                       uint32_t rb_i, uint32_t rb_b, int restart256) {
  const int32_t m24_r = int32_t(rb_r >> 8), m24_i = int32_t(rb_i >> 8);
  const uint32_t s_r = (rb_b >> 2) & 31u, s_i = (rb_b >> 7) & 31u;
  const int32_t off_r = int32_t(uint32_t(m24_r) >> (s_r < 23u ? s_r : 23u));
  const int32_t off_i = int32_t(uint32_t(m24_i) >> (s_i < 23u ? s_i : 23u));
  const int32_t dk_r = (rb_b & 1u) ? -off_r : off_r;
  const int32_t dk_i = (rb_b & 2u) ? -off_i : off_i;
  const bool restart = int32_t((rb_b >> 12) & 255u) < restart256 || xv == 0;
  const int32_t loc_r = int32_t(xkr) + dk_r, loc_i = int32_t(xki) + dk_i;
  Proposal p;
  p.kr = restart ? m24_r : loc_r;
  p.ki = restart ? m24_i : loc_i;
  p.oob = !restart &&
          (loc_r < 0 || loc_r >= kTwo24 || loc_i < 0 || loc_i >= kTwo24);
  p.kr = p.kr < 0 ? 0 : imin(p.kr, kTwo24 - 1);
  p.ki = p.ki < 0 ? 0 : imin(p.ki, kTwo24 - 1);
  return p;
}

// A lane's V-word reservoir (the visit bins vb, the chain's xb, the
// pending emission's p_b). RegSlots keeps the words in registers: with V
// a compile-time constant and every index either unrolled or the run-time
// slot of set(), an unrolled predicated select, the array never goes to
// local memory. SharedSlots keeps them in a column of shared memory, word
// k at p[k * stride]: set() is one indexed store, and the words cost no
// registers.
template <int V>
struct RegSlots {
  int32_t w[V];
  CB_HD int32_t get(int k) const { return w[k]; }
  CB_HD void set(int slot, int32_t v) {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k == slot) w[k] = v;
  }
};

struct SharedSlots {
  int32_t* p;
  int stride;
  CB_HD int32_t get(int k) const { return p[k * stride]; }
  CB_HD void set(int slot, int32_t v) { p[slot * stride] = v; }
};

// _record_visit: reservoir-record one canvas visit. The LCG advances on
// every call, masked steps included: it is part of the sample schedule.
// The first V visits fill slots in order; visit j >= V replaces a uniform
// slot with probability V / (j + 1). The bin is computed only under `vis`
// (inside the window, so the float -> int conversions are in range) and
// only for a visit the reservoir takes: most steps of most warps skip it,
// which a branch-free form (the bin of every step) measured slower.
template <int V, class Slots>
CB_HD void record_visit(bool vis, float dr, float di, int32_t jvis,
                        uint32_t& rsv, Slots& vb, const Window& w) {
  rsv = rsv * 1664525u + 1013904223u;
  if (!vis) return;
  const uint32_t mix = rsv ^ (rsv >> 16);
  const bool take =
      fmul(top24(mix), float(jvis + 1)) < float(V) * 16777216.0f;
  if (!take) return;
  // Truncation toward zero, then the clamp: a visit at the upper edge can
  // round up to the width.
  const int32_t col = imin(int32_t(fmul(fsub(dr, w.x0), w.inv_dx)),
                           w.width - 1);
  const int32_t row = imin(int32_t(fmul(fsub(di, w.y0), w.inv_dy)),
                           w.height - 1);
  const int32_t slot = jvis < V ? jvis : int32_t(mix & uint32_t(V - 1));
  vb.set(slot, row * w.width + col);
}

// The chain state of one lane, its pending emission, and the chain's
// counters.
template <int V, class Slots = RegSlots<V>>
struct Chain {
  float xkr, xki;         // chain state grid indices
  int32_t xv, xit, rep;   // target t(x) (0 = unseeded), escape index, tenure
  Slots xb;               // the chain state's visit-bin reservoir
  int32_t p_it, p_rep, p_v;  // pending emission (p_it < 0: empty)
  Slots p_b;
  int32_t n_acc, n_merge, n_merged_rep;
};

// _mh_boundary for a lane whose proposal finished: Metropolis acceptance
// on the bridge target (accept iff u * t(x) < t(c')), emission of the
// retiring tenure (on accept, or forced at the rep cap; only tenures with
// visits, xv > 1, emit), the weighted-reservoir merge when the pending
// slot is occupied (keep the new record with probability rep_new / total,
// carry the summed mass either way), and the chain update. The pending
// copy takes the old xb before the accept overwrites it with vb. Returns
// accept.
template <int V, class CS, class VS>
CB_HD bool boundary(Chain<V, CS>& c, int32_t v_prop, int32_t needed, float kr,
                    float ki, const VS& vb, uint32_t rb_a, uint32_t rb_b,
                    int rep_cap) {
  const float u24 = fmul(top24(rb_a), kInv24);
  const bool accept = float(v_prop) > fmul(u24, float(c.xv));
  const int32_t rep_rej = c.rep + 1;
  const bool emit_ok = c.xv > 1;
  const bool emit = accept && emit_ok && c.rep > 0;
  const bool at_cap = !accept && rep_rej >= rep_cap;
  if (emit || (at_cap && emit_ok)) {
    const int32_t rep_used = emit ? c.rep : rep_rej;
    const bool occupied = c.p_it >= 0;
    const int32_t tot = c.p_rep + rep_used;
    const float u12 = float(int32_t((rb_b >> 20) & 0xFFFu));
    const bool take_new =
        !occupied || fmul(u12, float(tot)) < fmul(4096.0f, float(rep_used));
    if (occupied) {
      c.n_merge += 1;
      c.n_merged_rep += imin(c.p_rep, rep_used);
    }
    if (take_new) {
      c.p_it = c.xit;
      c.p_v = c.xv;
#pragma unroll
      for (int k = 0; k < V; ++k) c.p_b.set(k, c.xb.get(k));
    }
    c.p_rep = occupied ? tot : rep_used;
  }
  if (accept) {
    c.xkr = kr;
    c.xki = ki;
    c.xv = v_prop;
    c.xit = needed;
#pragma unroll
    for (int k = 0; k < V; ++k) c.xb.set(k, vb.get(k));
    c.rep = 1;
    c.n_acc += 1;
  } else {
    c.rep = at_cap ? 0 : rep_rej;
  }
  return accept;
}

struct ClassifyMhArgs {
  // Lane state, (lanes,) each except vb/xb, (V, lanes). c and z hold
  // (cr, ci) and (zr, zi) at f32, (crh, crl, cih, cil) and (zr, zrl, zi,
  // zil) at df32.
  float *kr, *ki, *c[4], *z[4], *sr, *si;
  int32_t *it, *sv, *dead, *vcnt, *rsv;
  float *xkr, *xki;
  int32_t *xv, *xit, *rep, *vb, *xb;
  int32_t *emit_it, *emit_rep, *emit_v;  // (chunks, lanes)
  int32_t* emit_b;                       // (chunks, V, lanes)
  int32_t* stats;                        // (8, lanes)
  const uint32_t* bits;  // (chunks, windows, 4, lanes) or null: threefry
  uint32_t k0, k1;
  int lanes, chunks, windows, unroll, min_it, max_it, detect, restart256,
      rep_cap;
  // The sample grid. f32: (dom_r0, dom_rspan, dom_i0, dom_ispan), c =
  // k * 2^-24 * span + lo. df32: the centre (rh, rl, ih, il) and the
  // pitches (step_r, step_i), c = centre (+) (k - 2^23) * step.
  float grid[6];
  Window win;
};

// The C interface's arguments (classify_mh.cu, host_harness.cpp).
// ptrs: the lane-state arrays in MhLaneState (20) or ExtMhLaneState (24)
//       order, then emit_it, emit_rep, emit_v, emit_b, stats, bits (null
//       for threefry).
// iargs: fractal, V, lanes, chunks, windows, unroll, min_it, max_it,
//        detect, restart256, rep_cap, width, height.  (fractal and V select
//        the instantiation.)
// fargs: grid[6], window x0, x1, y0, y1, inv_dx, inv_dy.
inline ClassifyMhArgs classify_mh_args(bool ext, void** ptrs,
                                       const int* iargs, const float* fargs,
                                       uint32_t k0, uint32_t k1) {
  ClassifyMhArgs a;
  int p = 0;
  auto f = [&] { return static_cast<float*>(ptrs[p++]); };
  auto i = [&] { return static_cast<int32_t*>(ptrs[p++]); };
  const int parts = ext ? 4 : 2;
  a.kr = f();
  a.ki = f();
  for (int j = 0; j < 4; ++j) a.c[j] = j < parts ? f() : nullptr;
  for (int j = 0; j < 4; ++j) a.z[j] = j < parts ? f() : nullptr;
  a.sr = f();
  a.si = f();
  a.it = i();
  a.sv = i();
  a.dead = i();
  a.vcnt = i();
  a.rsv = i();
  a.xkr = f();
  a.xki = f();
  a.xv = i();
  a.xit = i();
  a.rep = i();
  a.vb = i();
  a.xb = i();
  a.emit_it = i();
  a.emit_rep = i();
  a.emit_v = i();
  a.emit_b = i();
  a.stats = i();
  a.bits = static_cast<const uint32_t*>(ptrs[p]);
  a.k0 = k0;
  a.k1 = k1;
  a.lanes = iargs[2];
  a.chunks = iargs[3];
  a.windows = iargs[4];
  a.unroll = iargs[5];
  a.min_it = iargs[6];
  a.max_it = iargs[7];
  a.detect = iargs[8];
  a.restart256 = iargs[9];
  a.rep_cap = iargs[10];
  for (int j = 0; j < 6; ++j) a.grid[j] = fargs[j];
  a.win = Window{fargs[6],  fargs[7],  fargs[8],  fargs[9],
                 fargs[10], fargs[11], iargs[11], iargs[12]};
  return a;
}

// The f32 orbit of a lane: plain z^2 + c, window coordinates absolute.
struct OrbitF32 {
  float cr, ci, zr, zi;
  CB_HD void load(const ClassifyMhArgs& a, int lane) {
    cr = a.c[0][lane];
    ci = a.c[1][lane];
    zr = a.z[0][lane];
    zi = a.z[1][lane];
  }
  CB_HD void store(const ClassifyMhArgs& a, int lane) const {
    a.c[0][lane] = cr;
    a.c[1][lane] = ci;
    a.z[0][lane] = zr;
    a.z[1][lane] = zi;
  }
  // One update; returns |z'|^2. The burning ship folds the cross product.
  template <int FR>
  CB_HD float step() {
    const float nzr = fadd(fsub(fmul(zr, zr), fmul(zi, zi)), cr);
    const float nzi = Traits<FR>::fold_abs
                          ? fadd(fmul(2.0f, fabs_(fmul(zr, zi))), ci)
                          : fadd(fmul(fmul(2.0f, zr), zi), ci);
    zr = nzr;
    zi = nzi;
    return fadd(fmul(zr, zr), fmul(zi, zi));
  }
  CB_HD float win_r(const ClassifyMhArgs&) const { return zr; }
  CB_HD float win_i(const ClassifyMhArgs&) const { return zi; }
  CB_HD float hi_r() const { return zr; }
  CB_HD float hi_i() const { return zi; }
  // Installs the sample at grid indices (kr, ki), z = c; returns whether
  // the cardioid/bulb cull rejects it.
  CB_HD bool refill(const ClassifyMhArgs& a, float kr, float ki) {
    cr = fadd(fmul(fmul(kr, kInv24), a.grid[1]), a.grid[0]);
    ci = fadd(fmul(fmul(ki, kInv24), a.grid[3]), a.grid[2]);
    zr = cr;
    zi = ci;
    return culled(cr, ci);
  }
};

// The df32 orbit of a lane. Window coordinates are centre-relative,
// (z.hi - centre.hi) + (z.lo - centre.lo): absolute f32 bounds collapse
// once the span drops below the centre's ulp. Brent compares hi parts; the
// cull runs on the f32 approximation centre.hi + offset.
struct OrbitDf {
  df::F2 cr, ci, zr, zi;
  CB_HD void load(const ClassifyMhArgs& a, int lane) {
    cr = {a.c[0][lane], a.c[1][lane]};
    ci = {a.c[2][lane], a.c[3][lane]};
    zr = {a.z[0][lane], a.z[1][lane]};
    zi = {a.z[2][lane], a.z[3][lane]};
  }
  CB_HD void store(const ClassifyMhArgs& a, int lane) const {
    a.c[0][lane] = cr.hi;
    a.c[1][lane] = cr.lo;
    a.c[2][lane] = ci.hi;
    a.c[3][lane] = ci.lo;
    a.z[0][lane] = zr.hi;
    a.z[1][lane] = zr.lo;
    a.z[2][lane] = zi.hi;
    a.z[3][lane] = zi.lo;
  }
  template <int FR>
  CB_HD float step() {
    return df::complex_sqr_add<FR>(zr, zi, cr, ci);
  }
  CB_HD float win_r(const ClassifyMhArgs& a) const {
    return fadd(fsub(zr.hi, a.grid[0]), fsub(zr.lo, a.grid[1]));
  }
  CB_HD float win_i(const ClassifyMhArgs& a) const {
    return fadd(fsub(zi.hi, a.grid[2]), fsub(zi.lo, a.grid[3]));
  }
  CB_HD float hi_r() const { return zr.hi; }
  CB_HD float hi_i() const { return zi.hi; }
  CB_HD bool refill(const ClassifyMhArgs& a, float kr, float ki) {
    const float off_r = df::grid_offset(kr, a.grid[4]);
    const float off_i = df::grid_offset(ki, a.grid[5]);
    cr = df::add_f(df::F2{a.grid[0], a.grid[1]}, off_r);
    ci = df::add_f(df::F2{a.grid[2], a.grid[3]}, off_i);
    zr = cr;
    zi = ci;
    return culled(fadd(a.grid[0], off_r), fadd(a.grid[2], off_i));
  }
};

// One lane's registers across an MH pass: the orbit, the proposal's grid
// indices and Brent point, its window and visit counters, the visit
// reservoir, the chain with its pending emission, and the pass counters.
// v_prop and needed carry a finished window's target and escape index to
// its resolution. VS and CS hold the visit reservoir and the chain's two
// (RegSlots, or SharedSlots pointed at their columns before the load).
template <int V, class Orbit, class VS = RegSlots<V>, class CS = RegSlots<V>>
struct MhLane {
  Orbit o;
  float kr, ki, sr, si;
  int it, sv, dead, vcnt;
  uint32_t rsv;
  VS vb;
  Chain<V, CS> ch;
  int n_drawn, n_cull, n_band, n_cyc, n_waste;
  int32_t v_prop, needed, jv;
};

template <int V, class Orbit, class VS, class CS>
CB_HD void load_mh_lane(const ClassifyMhArgs& a, int lane,
                        MhLane<V, Orbit, VS, CS>& l) {
  const size_t L = size_t(a.lanes);
  l.o.load(a, lane);
  l.kr = a.kr[lane];
  l.ki = a.ki[lane];
  l.sr = a.sr[lane];
  l.si = a.si[lane];
  l.it = a.it[lane];
  l.sv = a.sv[lane];
  l.dead = a.dead[lane];
  l.vcnt = a.vcnt[lane];
  l.rsv = uint32_t(a.rsv[lane]);
  l.ch.xkr = a.xkr[lane];
  l.ch.xki = a.xki[lane];
  l.ch.xv = a.xv[lane];
  l.ch.xit = a.xit[lane];
  l.ch.rep = a.rep[lane];
  l.ch.p_it = -1;
  l.ch.p_rep = 0;
  l.ch.p_v = 0;
  l.ch.n_acc = l.ch.n_merge = l.ch.n_merged_rep = 0;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    l.vb.set(k, a.vb[size_t(k) * L + lane]);
    l.ch.xb.set(k, a.xb[size_t(k) * L + lane]);
    l.ch.p_b.set(k, 0);
  }
  l.n_drawn = l.n_cull = l.n_band = l.n_cyc = l.n_waste = 0;
}

// One inner step of a lane's window: the orbit update, the survival
// count (`<= 4`, so the NaNs an escaped lane coasts into count as escaped;
// NaN is also outside the window, all four compares false), the in-window
// test and the visit record.
template <int FR, int V, class Orbit, class VS, class CS>
CB_HD void window_step(const ClassifyMhArgs& a, MhLane<V, Orbit, VS, CS>& l,
                       int& nesc, int& jv) {
  nesc += l.o.template step<FR>() <= 4.0f;
  const float dr = l.o.win_r(a), di = l.o.win_i(a);
  const bool vis =
      dr >= a.win.x0 && dr < a.win.x1 && di >= a.win.y0 && di < a.win.y1;
  record_visit<V>(vis, dr, di, jv, l.rsv, l.vb, a.win);
  jv += vis;
}

// One window of a lane: U orbit updates (UC, unrolled, where it is not 0;
// else a.unroll in a loop), then the boundary's tests and counters.
// Returns whether the proposal finished: a finished lane then takes
// mh_resolve, an unfinished one mh_advance.
template <int FR, int UC = 0, int V, class Orbit, class VS, class CS>
CB_HD bool mh_window(const ClassifyMhArgs& a, MhLane<V, Orbit, VS, CS>& l) {
  using T = Traits<FR>;
  const int U = UC > 0 ? UC : a.unroll;
  int nesc = 0;
  int jv = l.vcnt;
  if constexpr (UC > 0) {
#pragma unroll
    for (int k = 0; k < UC; ++k) window_step<FR>(a, l, nesc, jv);
  } else {
    for (int k = 0; k < U; ++k) window_step<FR>(a, l, nesc, jv);
  }
  const bool esc = nesc < U;
  int needed = l.it + nesc;
  const bool cyc =
      a.detect && l.o.hi_r() == l.sr && l.o.hi_i() == l.si && !esc;

  const int it_new = l.it + U;
  const bool maxed = it_new >= a.max_it;
  const bool deadb = l.dead != 0;
  const bool fin = esc || cyc || maxed || deadb;
  bool cand;
  if (T::interior) {
    // Anti-Buddhabrot: candidates finish without escaping within the cap;
    // their orbit is the full capped one.
    const bool esc_in_cap = esc && needed < a.max_it;
    cand = (cyc || maxed) && !esc_in_cap && !deadb;
    if (cand) needed = a.max_it - 1;
  } else {
    cand = esc && !deadb && needed >= a.min_it && needed < a.max_it;
  }
  // The bridge target: 256 per (capped) visit plus 1 for being in band, 0
  // otherwise.
  l.v_prop = cand ? imin(jv, kVisitCap) * kTargetVisit + 1 : 0;
  l.needed = needed;
  l.jv = jv;
  l.n_band += l.v_prop > 0;
  l.n_cyc += cyc && !deadb;
  if (deadb) l.n_waste += U;
  if (esc && !deadb) l.n_waste += it_new - needed - 1;
  return fin;
}

// An unfinished proposal after its window of U steps: the Brent save on
// its schedule, the iteration and visit counts.
template <int V, class Orbit, class VS, class CS>
CB_HD void mh_advance(const ClassifyMhArgs& a, MhLane<V, Orbit, VS, CS>& l,
                      int U) {
  const int it_new = l.it + U;
  if (a.detect && it_new >= l.sv) {
    l.sr = l.o.hi_r();
    l.si = l.o.hi_i();
    l.sv = l.sv * 2;
  }
  l.it = it_new;
  l.vcnt = l.jv;
}

// Block `blk` of the four words a finished boundary of lane `lane` at
// global window gwin draws: Threefry-2x32 of (lane, gwin) for block 0, the
// mutation mantissas (rb_r, rb_i), and of (lane | 2^30, gwin) for block 1,
// the acceptance and control words (rb_a, rb_b); lane ids are below 2^24.
// Or the same words from the bits tensor. The words depend on nothing but
// (lane, gwin, blk), so any thread may compute them.
CB_HD void mh_block(const ClassifyMhArgs& a, int lane, int gwin, int blk,
                    uint32_t& x0, uint32_t& x1) {
  if (a.bits != nullptr) {
    const size_t L = size_t(a.lanes);
    const size_t base = (size_t(gwin) * 4 + 2 * size_t(blk)) * L + lane;
    x0 = a.bits[base];
    x1 = a.bits[base + L];
  } else {
    x0 = uint32_t(lane) | (blk ? 0x40000000u : 0u);
    x1 = uint32_t(gwin);
    threefry2x32(a.k0, a.k1, x0, x1);
  }
}

// A finished proposal: resolves it against the chain (boundary), draws the
// next proposal from the updated chain state (propose) and installs it.
template <int FR, int V, class Orbit, class VS, class CS>
CB_HD void mh_resolve(const ClassifyMhArgs& a, MhLane<V, Orbit, VS, CS>& l,
                      uint32_t rb_r, uint32_t rb_i, uint32_t rb_a,
                      uint32_t rb_b) {
  boundary<V>(l.ch, l.v_prop, l.needed, l.kr, l.ki, l.vb, rb_a, rb_b,
              a.rep_cap);
  const Proposal p = propose(l.ch.xkr, l.ch.xki, l.ch.xv, rb_r, rb_i, rb_b,
                             a.restart256);
  l.kr = float(p.kr);
  l.ki = float(p.ki);
  const bool in_set = l.o.refill(a, l.kr, l.ki);
  const bool ncull = (Traits<FR>::use_cull && in_set) || p.oob;
  l.it = 0;
  l.sr = kBig;
  l.si = kBig;
  l.sv = kSave0;
  l.dead = ncull;
  l.vcnt = 0;
  l.n_drawn += 1;
  l.n_cull += ncull;
}

// Writes the chunk's pending emission and clears it.
template <int V, class Orbit, class VS, class CS>
CB_HD void flush_mh_lane(const ClassifyMhArgs& a, MhLane<V, Orbit, VS, CS>& l,
                         int chunk, int lane) {
  const size_t L = size_t(a.lanes);
  const size_t e = size_t(chunk) * L + lane;
  a.emit_it[e] = l.ch.p_it;
  a.emit_rep[e] = l.ch.p_rep;
  a.emit_v[e] = l.ch.p_v;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    a.emit_b[(size_t(chunk) * V + k) * L + lane] = l.ch.p_b.get(k);
    l.ch.p_b.set(k, 0);
  }
  l.ch.p_it = -1;
  l.ch.p_rep = 0;
  l.ch.p_v = 0;
}

template <int V, class Orbit, class VS, class CS>
CB_HD void store_mh_lane(const ClassifyMhArgs& a,
                         const MhLane<V, Orbit, VS, CS>& l, int lane) {
  const size_t L = size_t(a.lanes);
  l.o.store(a, lane);
  a.kr[lane] = l.kr;
  a.ki[lane] = l.ki;
  a.sr[lane] = l.sr;
  a.si[lane] = l.si;
  a.it[lane] = l.it;
  a.sv[lane] = l.sv;
  a.dead[lane] = l.dead;
  a.vcnt[lane] = l.vcnt;
  a.rsv[lane] = int32_t(l.rsv);
  a.xkr[lane] = l.ch.xkr;
  a.xki[lane] = l.ch.xki;
  a.xv[lane] = l.ch.xv;
  a.xit[lane] = l.ch.xit;
  a.rep[lane] = l.ch.rep;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    a.vb[size_t(k) * L + lane] = l.vb.get(k);
    a.xb[size_t(k) * L + lane] = l.ch.xb.get(k);
  }
  const int counts[kStats] = {l.n_drawn,  l.n_cull,      l.n_band,
                              l.n_cyc,    l.n_waste,     l.ch.n_acc,
                              l.ch.n_merge, l.ch.n_merged_rep};
  for (int s = 0; s < kStats; ++s) a.stats[size_t(s) * L + lane] = counts[s];
}

// ----------------------------------------------------------------------
// The weighted bin deposit (cudabrot_tpu/ops/binning.py
// mh_deposit_weights + mh_scatter).

struct MhDepositArgs {
  // Emission e = chunk * lanes + lane; its recorded bin k lies at
  // bins[(chunk * slots + k) * lanes + lane]. A compacted (V, S) batch is
  // the case of one chunk with lanes = S.
  const int32_t *bins, *t, *rep;
  long long n;  // emissions
  int slots, lanes;
  uint32_t* hist;
  int32_t nbins;
  // A slot with gate[e] < gate_min deposits nothing (the classify pass's
  // emit_it >= 0; the tail flush's rep >= 1); nullptr: every slot is open.
  const int32_t* gate;
  int32_t gate_min;
};

// A tenure's deposit: v = (t - 1) / 256 visits, total q = floor(v * rep *
// 65536 / t) in 1/256 histogram units by three u32 long-division steps
// (t < 2^23, v <= 2^15 and rep < 2^17 keep every intermediate below 2^32),
// spread over the n = min(v, V) recorded bins. t > 1 here.
CB_HD void mh_tenure(int32_t t, int32_t rep, int slots, uint32_t& n,
                     uint32_t& q) {
  const uint32_t tu = uint32_t(t);
  const uint32_t v = (tu - 1u) / uint32_t(kTargetVisit);
  const uint32_t rep_u = rep > 0 ? uint32_t(rep) : 0u;
  n = v < uint32_t(slots) ? v : uint32_t(slots);
  if (n < 1u) n = 1u;
  const uint32_t big_n = v * rep_u;
  const uint32_t q1 = big_n / tu, r1 = big_n - q1 * tu;
  const uint32_t q2 = (r1 * 256u) / tu, r2 = r1 * 256u - q2 * tu;
  const uint32_t q3 = (r2 * 256u) / tu;
  q = q1 * 65536u + q2 * 256u + q3;
}

// Slot e's recorded-bin count n and mass q; both 0 where it deposits
// nothing (a closed gate, t <= 1). The three words are read whatever they
// hold, so a warp's loads are one coalesced access each.
CB_HD void mh_slot(const MhDepositArgs& a, long long e, uint32_t& n,
                   uint32_t& q) {
  const int32_t g = a.gate != nullptr ? a.gate[e] : a.gate_min;
  const int32_t t = a.t[e], rep = a.rep[e];
  n = 0;
  q = 0;
  if (g >= a.gate_min && t > 1) mh_tenure(t, rep, a.slots, n, q);
}

// The share of the k-th of n recorded bins, d_k = floor((k+1) q / n) -
// floor(k q / n): the n shares sum to q exactly.
CB_HD uint32_t mh_share(uint32_t k, uint32_t q, uint32_t n) {
  return ((k + 1u) * q) / n - (k * q) / n;
}

// The lane of a warp's 32 slots that owns pair p of their spread: the
// first j with incl(j) > p, incl the inclusive prefix sum of the slots'
// n (a binary search; `incl(j)` reads lane j's sum, a shuffle on the
// device, which every lane runs). p must be below incl(31).
template <class Incl>
CB_HD int pair_owner(uint32_t p, const Incl& incl) {
  int j = 0;
  for (int s = 16; s > 0; s >>= 1)
    if (incl(j + s - 1) <= p) j += s;
  return j;
}

}  // namespace mh
}  // namespace cb
