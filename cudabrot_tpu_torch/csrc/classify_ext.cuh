// One lane of the extended-precision (df32) classify pass (its window, the
// boundary of a finished lane, the refill draw), and one emission of the
// df32 replay, as __host__ __device__ functions: the CUDA kernels
// (classify_ext.cu with S lanes a thread, deposit_ext.cu with a thread an
// emission) call them, and host_harness.cpp runs them in a host emulation
// of the same warps, so a CPU build can be held bitwise against the plain
// PyTorch versions.
#pragma once

#include "df32.cuh"

namespace cb {

constexpr float kExtBig = 1.0e30f;  // Brent "never matches" saved point
constexpr int kExtSave0 = 16;       // first Brent save index, doubling
constexpr int kExtStats = 5;        // drawn, culled, in_band, cycles, wasted

struct ClassifyExtArgs {
  // Lane state, (lanes,) each: 24-bit grid indices as f32, df32 c, df32 z,
  // Brent saved point (hi parts), counters and flags.
  float *kr, *ki, *crh, *crl, *cih, *cil, *zr, *zrl, *zi, *zil, *sr, *si;
  int32_t *it, *sv, *dead, *vis;
  float* emit_c;         // (chunks, 2, lanes): grid indices (kr, ki)
  int32_t* emit_it;      // (chunks, lanes), -1 = empty slot
  int32_t* stats;        // (5, lanes)
  const uint32_t* bits;  // (chunks, windows, 2, lanes) or null: threefry
  uint32_t k0, k1;
  int lanes, chunks, windows, unroll, min_it, max_it, detect;
  df::F2 center_r, center_i;  // df32 centre of the sample window
  float step_r, step_i;       // f32 grid pitches, span * 2^-24
  float vx0, vx1, vy0, vy1;
};

// The C interface's arguments (classify_ext.cu, host_harness.cpp).
// ptrs: the 16 lane-state arrays in ExtLaneState order, emit_c, emit_it,
//       stats, bits (null for threefry).
// iargs: fractal, visit, lanes, chunks, windows, unroll, min_it, max_it,
//        detect.  (fractal and visit select the instantiation.)
// fargs: centre (rh, rl, ih, il), step_r, step_i, vx0, vx1, vy0, vy1.
inline ClassifyExtArgs classify_ext_args(void** ptrs, const int* iargs,
                                         const float* fargs, uint32_t k0,
                                         uint32_t k1) {
  ClassifyExtArgs a;
  float** f[12] = {&a.kr, &a.ki, &a.crh, &a.crl, &a.cih, &a.cil,
                   &a.zr, &a.zrl, &a.zi, &a.zil, &a.sr, &a.si};
  for (int i = 0; i < 12; ++i) *f[i] = static_cast<float*>(ptrs[i]);
  a.it = static_cast<int32_t*>(ptrs[12]);
  a.sv = static_cast<int32_t*>(ptrs[13]);
  a.dead = static_cast<int32_t*>(ptrs[14]);
  a.vis = static_cast<int32_t*>(ptrs[15]);
  a.emit_c = static_cast<float*>(ptrs[16]);
  a.emit_it = static_cast<int32_t*>(ptrs[17]);
  a.stats = static_cast<int32_t*>(ptrs[18]);
  a.bits = static_cast<const uint32_t*>(ptrs[19]);
  a.k0 = k0;
  a.k1 = k1;
  a.lanes = iargs[2];
  a.chunks = iargs[3];
  a.windows = iargs[4];
  a.unroll = iargs[5];
  a.min_it = iargs[6];
  a.max_it = iargs[7];
  a.detect = iargs[8];
  a.center_r = {fargs[0], fargs[1]};
  a.center_i = {fargs[2], fargs[3]};
  a.step_r = fargs[4];
  a.step_i = fargs[5];
  a.vx0 = fargs[6];
  a.vx1 = fargs[7];
  a.vy0 = fargs[8];
  a.vy1 = fargs[9];
  return a;
}

// c = centre (+) (k - 2^23) * step, as the classify pass draws it and the
// replay rebuilds it.
CB_HD df::F2 grid_sample(df::F2 center, float k, float step) {
  return df::add_f(center, df::grid_offset(k, step));
}

// A lane's registers: its df32 sampler state, its pending emission slot,
// its pass counters, and what its window hands a finished lane's boundary
// (the escape index, whether it escaped or closed a Brent cycle).
struct ExtLane {
  float kr, ki;
  df::F2 cr, ci, zr, zi;
  float sr, si;
  int it, sv, dead, vis;
  float p_kr, p_ki;
  int p_it;
  int n_drawn, n_cull, n_band, n_cyc, n_waste;
  int needed;
  bool esc, cyc;
};

CB_HD ExtLane load_ext_lane(const ClassifyExtArgs& a, int lane) {
  ExtLane l;
  l.kr = a.kr[lane];
  l.ki = a.ki[lane];
  l.cr = {a.crh[lane], a.crl[lane]};
  l.ci = {a.cih[lane], a.cil[lane]};
  l.zr = {a.zr[lane], a.zrl[lane]};
  l.zi = {a.zi[lane], a.zil[lane]};
  l.sr = a.sr[lane];
  l.si = a.si[lane];
  l.it = a.it[lane];
  l.sv = a.sv[lane];
  l.dead = a.dead[lane];
  l.vis = a.vis[lane];
  l.p_kr = 0.0f;
  l.p_ki = 0.0f;
  l.p_it = -1;
  l.n_drawn = l.n_cull = l.n_band = l.n_cyc = l.n_waste = 0;
  l.needed = 0;
  l.esc = l.cyc = false;
  return l;
}

// Writes the chunk's pending emission slot and clears it.
CB_HD void flush_ext_lane(const ClassifyExtArgs& a, ExtLane& l, int chunk,
                          int lane) {
  const size_t L = size_t(a.lanes);
  a.emit_c[(size_t(chunk) * 2) * L + lane] = l.p_kr;
  a.emit_c[(size_t(chunk) * 2 + 1) * L + lane] = l.p_ki;
  a.emit_it[size_t(chunk) * L + lane] = l.p_it;
  l.p_kr = fmul(l.p_kr, 0.0f);
  l.p_ki = fmul(l.p_ki, 0.0f);
  l.p_it = -1;
}

CB_HD void store_ext_lane(const ClassifyExtArgs& a, const ExtLane& l,
                          int lane) {
  const size_t L = size_t(a.lanes);
  a.kr[lane] = l.kr;
  a.ki[lane] = l.ki;
  a.crh[lane] = l.cr.hi;
  a.crl[lane] = l.cr.lo;
  a.cih[lane] = l.ci.hi;
  a.cil[lane] = l.ci.lo;
  a.zr[lane] = l.zr.hi;
  a.zrl[lane] = l.zr.lo;
  a.zi[lane] = l.zi.hi;
  a.zil[lane] = l.zi.lo;
  a.sr[lane] = l.sr;
  a.si[lane] = l.si;
  a.it[lane] = l.it;
  a.sv[lane] = l.sv;
  a.dead[lane] = l.dead;
  a.vis[lane] = l.vis;
  const int counts[kExtStats] = {l.n_drawn, l.n_cull, l.n_band, l.n_cyc,
                                 l.n_waste};
  for (int s = 0; s < kExtStats; ++s)
    a.stats[size_t(s) * L + lane] = counts[s];
}

// One window of a lane: U df32 updates (U = a.unroll when the template's U
// is 0) with survival-counter tracking, and the part of the boundary every
// lane takes. A lane that did not finish keeps the window's orbit, its
// counter moves on by U and the Brent point is saved on its schedule;
// every stat it could add is zero. Returns whether the lane finished
// (escaped, closed a cycle, reached the cap, or was dead): a finished lane
// then takes ext_finish, whose refill overwrites the orbit, the counter
// and the Brent point.
template <int FR, bool VISIT, int U>
CB_HD bool ext_window(const ClassifyExtArgs& a, ExtLane& l) {
  using df::F2;
  const int u = U > 0 ? U : a.unroll;
  F2 azr = l.zr, azi = l.zi;
  int nesc = 0;
  bool hit = false;
#pragma unroll
  for (int k = 0; k < u; ++k) {
    // `<= 4` so the NaNs an escaped lane coasts into count as escaped.
    nesc += df::complex_sqr_add<FR>(azr, azi, l.cr, l.ci) <= 4.0f;
    if (VISIT)
      hit |= (azr.hi >= a.vx0) & (azr.hi < a.vx1) & (azi.hi >= a.vy0) &
             (azi.hi < a.vy1);
  }
  if (VISIT) l.vis |= int(hit);
  const bool esc = nesc < u;
  // Brent compares hi parts only.
  const bool cyc = a.detect && azr.hi == l.sr && azi.hi == l.si && !esc;
  const int it_new = l.it + u;
  const bool fin = esc || cyc || it_new >= a.max_it || l.dead != 0;
  l.needed = l.it + nesc;
  l.esc = esc;
  l.cyc = cyc;
  const bool save = a.detect && it_new >= l.sv;
  l.sr = save ? azr.hi : l.sr;
  l.si = save ? azi.hi : l.si;
  l.sv = save ? l.sv * 2 : l.sv;
  l.zr = azr;
  l.zi = azi;
  l.it = it_new;
  return fin;
}

// A refill's new sample: grid indices from the Threefry words of (lane,
// gwin) (or from the bits tensor), c in df32, and whether the cull kills
// it.
struct ExtDraw {
  float kr, ki;
  df::F2 cr, ci;
  int cull;
};

template <int FR>
CB_HD ExtDraw ext_draw(const ClassifyExtArgs& a, int lane, int gwin) {
  uint32_t rb_r, rb_i;
  if (a.bits != nullptr) {
    const size_t base = size_t(gwin) * 2 * size_t(a.lanes) + lane;
    rb_r = a.bits[base];
    rb_i = a.bits[base + size_t(a.lanes)];
  } else {
    rb_r = uint32_t(lane);
    rb_i = uint32_t(gwin);
    threefry2x32(a.k0, a.k1, rb_r, rb_i);
  }
  ExtDraw d;
  // 24-bit grid indices: the top bits, exact in i32 and in f32.
  d.kr = float(int32_t(rb_r >> 8));
  d.ki = float(int32_t(rb_i >> 8));
  const float off_r = df::grid_offset(d.kr, a.step_r);
  const float off_i = df::grid_offset(d.ki, a.step_i);
  d.cr = df::add_f(a.center_r, off_r);
  d.ci = df::add_f(a.center_i, off_i);
  // The cull runs on the f32 approximation of c: its boundary blurs by
  // ~2^-24, where escape times exceed any practical cap.
  d.cull = Traits<FR>::use_cull &&
           culled(fadd(a.center_r.hi, off_r), fadd(a.center_i.hi, off_i));
  return d;
}

// The rest of a finished lane's boundary after ext_window of U updates:
// the band filter into the pending slot, the stats, and the refill with
// the draw of (lane, gwin). z starts at c (cudabrot.cu:323-324).
template <int FR, bool VISIT>
CB_HD void ext_finish(const ClassifyExtArgs& a, ExtLane& l, int lane,
                      int gwin, int u) {
  using T = Traits<FR>;
  const bool deadb = l.dead != 0;
  bool in_band;
  int band_it;
  if (T::interior) {
    const bool esc_in_cap = l.esc && l.needed < a.max_it;
    in_band = (l.cyc || l.it >= a.max_it) && !esc_in_cap && !deadb;
    band_it = a.max_it - 1;
  } else {
    in_band = l.esc && !deadb && l.needed >= a.min_it && l.needed < a.max_it;
    band_it = l.needed;
  }
  if (VISIT) in_band = in_band && l.vis != 0;
  l.p_it = in_band ? band_it : l.p_it;
  l.p_kr = in_band ? l.kr : l.p_kr;
  l.p_ki = in_band ? l.ki : l.p_ki;
  l.n_band += in_band;
  l.n_cyc += l.cyc && !deadb;
  l.n_waste += deadb ? u : (l.esc ? l.it - l.needed - 1 : 0);

  const ExtDraw d = ext_draw<FR>(a, lane, gwin);
  l.kr = d.kr;
  l.ki = d.ki;
  l.cr = d.cr;
  l.ci = d.ci;
  l.zr = d.cr;
  l.zi = d.ci;
  l.it = 0;
  l.sr = kExtBig;
  l.si = kExtBig;
  l.sv = kExtSave0;
  l.dead = d.cull;
  if (VISIT) l.vis = 0;
  l.n_drawn += 1;
  l.n_cull += d.cull;
}

struct ReplayExtArgs {
  const float *kr, *ki;   // (k,) grid indices of the kept emissions
  const int32_t* iters;   // (k,) escape index, -1 = unused slot
  int k;
  uint32_t* hist;
  df::F2 center_r, center_i;
  float step_r, step_i;
  df::CanvasQDf q;
};

// iargs: fractal, k, width, height, the resident warps (read by the
//        kernels' launchers), and the histogram's row window: its first
//        row and its rows ((0, height) for a whole canvas).
// fargs: centre (rh, rl, ih, il), step_r, step_i, canvas minimum (rh, rl,
//        ih, il), inverse pitches (re, im).
inline ReplayExtArgs replay_ext_args(const void* kr, const void* ki,
                                     const void* iters, void* hist,
                                     const int* iargs, const float* fargs) {
  ReplayExtArgs a;
  a.kr = static_cast<const float*>(kr);
  a.ki = static_cast<const float*>(ki);
  a.iters = static_cast<const int32_t*>(iters);
  a.k = iargs[1];
  a.hist = static_cast<uint32_t*>(hist);
  a.center_r = {fargs[0], fargs[1]};
  a.center_i = {fargs[2], fargs[3]};
  a.step_r = fargs[4];
  a.step_i = fargs[5];
  a.q.min_re = {fargs[6], fargs[7]};
  a.q.min_im = {fargs[8], fargs[9]};
  a.q.inv_d_re = fargs[10];
  a.q.inv_d_im = fargs[11];
  a.q.width = iargs[2];
  a.q.height = iargs[3];
  a.q.row_start = iargs[5];
  a.q.row_count = iargs[6];
  return a;
}

// Replays emission i, whose orbit records n + 1 points (n = its iters):
// c rebuilt from its grid indices, z starts at c, steps s = 0..n recorded
// including the escape point, each step's bin going to the sink
// (orbit.cuh: DepositSink adds it to a.hist, IdSink and CanvasIdSink
// write it into the id stream). Returns the on-canvas point count.
//
// The loop runs `steps` >= n + 1 times: a kernel runs each warp's lanes to
// its longest lane's length together, so the loop never diverges (a
// diverged warp spends issue slots switching to its finished lanes); the
// steps past n give the sink b = -1, which records nothing, and count
// nothing. It is pipelined by one step: point s is binned after step
// s + 1 is taken, so the binning (which the orbit never reads) and the
// next step's dependent df32 chain sit in one iteration and the compiler
// interleaves them. The points and their bins are those of the plain
// loop. WINDOW: df32.cuh bin_id_df's instantiation.
template <int FR, bool WINDOW, class Sink>
CB_HD uint32_t replay_ext_one(const ReplayExtArgs& a, int i, int n,
                              int steps, const Sink& sink) {
  const df::F2 cr = grid_sample(a.center_r, a.kr[i], a.step_r);
  const df::F2 ci = grid_sample(a.center_i, a.ki[i], a.step_i);
  df::F2 zr = cr, zi = ci;
  df::complex_sqr_add<FR>(zr, zi, cr, ci);
  uint32_t local = 0;
  for (int s = 0; s < steps; ++s) {
    const df::F2 pr = zr, pi = zi;
    df::complex_sqr_add<FR>(zr, zi, cr, ci);
    const int64_t bin = df::bin_id_df<WINDOW>(a.q, pr, pi);
    const int64_t b = s <= n ? bin : -1;
    sink(s, b);
    local += b >= 0;
  }
  return local;
}

}  // namespace cb
