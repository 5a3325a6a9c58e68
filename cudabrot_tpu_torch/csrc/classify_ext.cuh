// One lane of the extended-precision (df32) classify pass, and one
// emission of the df32 replay, as __host__ __device__ functions: the CUDA
// kernels (classify_ext.cu, deposit_ext.cu) call them with one thread per
// lane or emission, and host_harness.cpp calls them in a loop so a CPU
// build can be held bitwise against the plain PyTorch versions.
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

template <int FR, bool VISIT>
CB_HD void classify_ext_lane(const ClassifyExtArgs& a, int lane) {
  using T = Traits<FR>;
  using df::F2;
  const size_t L = size_t(a.lanes);
  const int U = a.unroll;

  float kr = a.kr[lane], ki = a.ki[lane];
  F2 cr{a.crh[lane], a.crl[lane]}, ci{a.cih[lane], a.cil[lane]};
  F2 zr{a.zr[lane], a.zrl[lane]}, zi{a.zi[lane], a.zil[lane]};
  float sr = a.sr[lane], si = a.si[lane];
  int it = a.it[lane], sv = a.sv[lane], dead = a.dead[lane];
  int vis = a.vis[lane];
  float p_kr = 0.0f, p_ki = 0.0f;
  int p_it = -1;
  int n_drawn = 0, n_cull = 0, n_band = 0, n_cyc = 0, n_waste = 0;

  for (int chunk = 0; chunk < a.chunks; ++chunk) {
    for (int w = 0; w < a.windows; ++w) {
      // --- inner window: U df32 updates, survival-counter tracking.
      // `<= 4` so the NaNs an escaped lane coasts into count as escaped.
      F2 azr = zr, azi = zi;
      int nesc = 0;
      bool hit = false;
      for (int k = 0; k < U; ++k) {
        const float mag2 = df::complex_sqr_add<FR>(azr, azi, cr, ci);
        nesc += mag2 <= 4.0f;
        if (VISIT)
          hit |= (azr.hi >= a.vx0) & (azr.hi < a.vx1) & (azi.hi >= a.vy0) &
                 (azi.hi < a.vy1);
      }
      if (VISIT) vis |= int(hit);
      const bool esc = nesc < U;
      const int needed = it + nesc;
      // Brent compares hi parts only.
      const bool cyc = a.detect && azr.hi == sr && azi.hi == si && !esc;

      // --- boundary: termination, band filter, Brent, refill, stats ---
      const int it_new = it + U;
      const bool deadb = dead != 0;
      const bool fin = esc || cyc || it_new >= a.max_it || deadb;
      bool in_band;
      if (T::interior) {
        const bool esc_in_cap = esc && needed < a.max_it;
        in_band = (cyc || it_new >= a.max_it) && !esc_in_cap && !deadb;
        if (VISIT) in_band = in_band && vis != 0;
        if (in_band) p_it = a.max_it - 1;
      } else {
        in_band = esc && !deadb && needed >= a.min_it && needed < a.max_it;
        if (VISIT) in_band = in_band && vis != 0;
        if (in_band) p_it = needed;
      }
      if (in_band) {
        p_kr = kr;
        p_ki = ki;
      }
      n_band += in_band;
      n_cyc += cyc && !deadb;
      if (deadb) n_waste += U;
      if (esc && !deadb) n_waste += it_new - needed - 1;

      if (fin) {
        uint32_t rb_r, rb_i;
        const int gwin = chunk * a.windows + w;
        if (a.bits != nullptr) {
          const size_t base = size_t(gwin) * 2 * L + lane;
          rb_r = a.bits[base];
          rb_i = a.bits[base + L];
        } else {
          rb_r = uint32_t(lane);
          rb_i = uint32_t(gwin);
          threefry2x32(a.k0, a.k1, rb_r, rb_i);
        }
        // 24-bit grid indices: the top bits, exact in i32 and in f32.
        kr = float(int32_t(rb_r >> 8));
        ki = float(int32_t(rb_i >> 8));
        const float off_r = df::grid_offset(kr, a.step_r);
        const float off_i = df::grid_offset(ki, a.step_i);
        cr = df::add_f(a.center_r, off_r);
        ci = df::add_f(a.center_i, off_i);
        // The cull runs on the f32 approximation of c: its boundary blurs
        // by ~2^-24, where escape times exceed any practical cap.
        const bool ncull =
            T::use_cull && culled(fadd(a.center_r.hi, off_r),
                                  fadd(a.center_i.hi, off_i));
        zr = cr;  // z starts at c (cudabrot.cu:323-324)
        zi = ci;
        it = 0;
        sr = kExtBig;
        si = kExtBig;
        sv = kExtSave0;
        dead = ncull;
        if (VISIT) vis = 0;
        n_drawn += 1;
        n_cull += ncull;
      } else {
        if (a.detect && it_new >= sv) {
          sr = azr.hi;
          si = azi.hi;
          sv = sv * 2;
        }
        zr = azr;
        zi = azi;
        it = it_new;
      }
    }
    // Flush this chunk's pending emission slot and clear it.
    a.emit_c[(size_t(chunk) * 2) * L + lane] = p_kr;
    a.emit_c[(size_t(chunk) * 2 + 1) * L + lane] = p_ki;
    a.emit_it[size_t(chunk) * L + lane] = p_it;
    p_kr = fmul(p_kr, 0.0f);
    p_ki = fmul(p_ki, 0.0f);
    p_it = -1;
  }

  a.kr[lane] = kr;
  a.ki[lane] = ki;
  a.crh[lane] = cr.hi;
  a.crl[lane] = cr.lo;
  a.cih[lane] = ci.hi;
  a.cil[lane] = ci.lo;
  a.zr[lane] = zr.hi;
  a.zrl[lane] = zr.lo;
  a.zi[lane] = zi.hi;
  a.zil[lane] = zi.lo;
  a.sr[lane] = sr;
  a.si[lane] = si;
  a.it[lane] = it;
  a.sv[lane] = sv;
  a.dead[lane] = dead;
  a.vis[lane] = vis;
  const int counts[kExtStats] = {n_drawn, n_cull, n_band, n_cyc, n_waste};
  for (int s = 0; s < kExtStats; ++s)
    a.stats[size_t(s) * L + lane] = counts[s];
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

// iargs: fractal, k, width, height (the kernels' launchers also read
//        iargs[4], the resident warps).
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
// loop.
template <int FR, class Sink>
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
    const int64_t bin = df::bin_id_df(a.q, pr, pi);
    const int64_t b = s <= n ? bin : -1;
    sink(s, b);
    local += b >= 0;
  }
  return local;
}

}  // namespace cb
