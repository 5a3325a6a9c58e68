// CPU build of the kernels' per-lane functions.
//
// The f32 classify lane functions (classify.cuh) in an emulation of the
// kernel's warps with their compacted refill and its slice queue's items,
// the fused f32 replay's orbit loop as the kernel's queue runs it
// (orbit.cuh replay_orbit), the df32 arithmetic (df32.cuh), the lane and
// emission functions of the classify_ext and replay_deposit_ext kernels
// (classify_ext.cuh), the
// Metropolis-Hastings lane functions and deposit (mh.cuh: classify_mh in an
// emulation of its warps with their compacted draws, classify_ext_mh,
// mh_deposit in an emulation of its warps' spread), the orbit loop of the
// replay kernels with its id sinks (orbit.cuh: replay_ids' staged tile in
// an emulation of its warps, and replay_ids_ext through classify_ext.cuh)
// the run-length deposit of the bigtiles kernel (bigtiles.cuh), the tile
// logic of the length sort (length_sort.cuh) and the per-thread sums of the
// pass counters (counters.cuh) are
// __host__ __device__; this file loops them over lanes on the CPU behind
// the same C interface as the CUDA launchers, so a machine without a GPU
// can hold them bitwise against the plain PyTorch versions. Build:
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC
//       -o libcb_host.so host_harness.cpp
//
// (-ffp-contract=off: every product and sum must round once, as
// __fmul_rn/__fadd_rn do on the device.) Nothing in the package loads it;
// tests/test_torch_df32.py builds it when g++ is present.
#include <algorithm>
#include <random>
#include <tuple>
#include <type_traits>
#include <vector>

#include "bigtiles.cuh"
#include "classify.cuh"
#include "classify_ext.cuh"
#include "counters.cuh"
#include "length_sort.cuh"
#include "mh.cuh"

using cb::df::F2;

namespace {

// One pass of an MH classify kernel (classify_mh.cu mh_pass) with S lanes
// per thread, its warps emulated in turn: each warp's 32 threads run their
// S lanes' windows (mh_window), mh_advance for the unfinished, the
// finished lanes queue their ids at the slots refill_slot gives them, the
// 2F boundary blocks are computed in passes of 32 (entry q: lane q / 2's
// block q % 2, as thread q takes entries q, q + 32, ...), and each
// finished lane resolves with its own four words (mh_resolve). SH places the
// reservoirs as the kernel's Build<Orbit>::shared does: 0 registers, 1 xb
// and p_b in columns of a shared array, 2 vb too; UC > 0 runs the window
// unrolled for U = UC, as the kernel's launcher does for U in {4, 8, 16,
// 32}.
template <int FR, int V, int S, int SH, int UC, class Orbit>
void mh_warps(const cb::mh::ClassifyMhArgs& a) {
  using CS = std::conditional_t<(SH >= 1), cb::mh::SharedSlots,
                                cb::mh::RegSlots<V>>;
  using VS = std::conditional_t<(SH >= 2), cb::mh::SharedSlots,
                                cb::mh::RegSlots<V>>;
  const int warps = (a.lanes + 32 * S - 1) / (32 * S);
  const int stride = 32 * S;
  std::vector<cb::mh::MhLane<V, Orbit, VS, CS>> L(32 * S);
  std::vector<int32_t> slots(3 * V * stride, -99);
  for (int t = 0; t < 32; ++t)
    for (int j = 0; j < S; ++j) {
      int32_t* col = slots.data() + j * 32 + t;
      if constexpr (SH >= 1) {
        L[t * S + j].ch.xb = {col, stride};
        L[t * S + j].ch.p_b = {col + V * stride, stride};
      }
      if constexpr (SH >= 2) L[t * S + j].vb = {col + 2 * V * stride, stride};
    }
  std::vector<int> q_lane(32 * S);
  std::vector<uint32_t> q_words(2 * 64 * S);
  for (int g = 0; g < warps; ++g) {
    auto lane = [&](int t, int j) { return (g * S + j) * 32 + t; };
    auto live = [&](int t, int j) { return lane(t, j) < a.lanes; };
    for (int t = 0; t < 32; ++t)
      for (int j = 0; j < S; ++j)
        cb::mh::load_mh_lane(a, live(t, j) ? lane(t, j) : 0, L[t * S + j]);
    for (int chunk = 0; chunk < a.chunks; ++chunk) {
      for (int w = 0; w < a.windows; ++w) {
        uint32_t mask[S] = {};
        bool fin[32][S];
        int F = 0;
        for (int t = 0; t < 32; ++t)
          for (int j = 0; j < S; ++j) {
            fin[t][j] = cb::mh::mh_window<FR, UC>(a, L[t * S + j]);
            if (!fin[t][j]) cb::mh::mh_advance(a, L[t * S + j], a.unroll);
            fin[t][j] = fin[t][j] && live(t, j);
            mask[j] |= uint32_t(fin[t][j]) << t;
          }
        for (int j = 0; j < S; ++j) F += cb::popc32(mask[j]);
        const int gwin = chunk * a.windows + w;
        for (int t = 0; t < 32; ++t)
          for (int j = 0; j < S; ++j)
            if (fin[t][j]) q_lane[cb::refill_slot<S>(mask, t, j)] = lane(t, j);
        for (int pass = 0; pass * 32 < 2 * F; ++pass)
          for (int t = 0; t < 32; ++t) {
            const int q = pass * 32 + t;
            if (q < 2 * F)
              cb::mh::mh_block(a, q_lane[q >> 1], gwin, q & 1, q_words[2 * q],
                               q_words[2 * q + 1]);
          }
        for (int t = 0; t < 32; ++t)
          for (int j = 0; j < S; ++j)
            if (fin[t][j]) {
              const uint32_t* m =
                  &q_words[4 * cb::refill_slot<S>(mask, t, j)];
              cb::mh::mh_resolve<FR>(a, L[t * S + j], m[0], m[1], m[2], m[3]);
            }
      }
      for (int t = 0; t < 32; ++t)
        for (int j = 0; j < S; ++j)
          if (live(t, j))
            cb::mh::flush_mh_lane(a, L[t * S + j], chunk, lane(t, j));
    }
    for (int t = 0; t < 32; ++t)
      for (int j = 0; j < S; ++j)
        if (live(t, j)) cb::mh::store_mh_lane(a, L[t * S + j], lane(t, j));
  }
}

// A build of an MH kernel as the emulation takes it: lanes per thread,
// reservoirs in shared memory, the window unrolled (at U = 4 only).
template <int S_, int SH_, int UC_>
struct MhBuild {
  static constexpr int S = S_, SH = SH_, UC = UC_;
};

// The builds each kernel's tests emulate: the f32 kernel's package build
// and the builds PR 7 measured against it, and the df32 kernel's.
using F32Builds = std::tuple<MhBuild<1, 1, 4>, MhBuild<2, 1, 0>,
                             MhBuild<1, 0, 0>, MhBuild<1, 2, 0>,
                             MhBuild<1, 1, 0>>;
using DfBuilds = std::tuple<MhBuild<1, 2, 4>, MhBuild<2, 2, 4>,
                            MhBuild<1, 0, 4>, MhBuild<1, 1, 4>,
                            MhBuild<1, 2, 0>>;

// mh_warps with the instantiation picked by build (one of Builds; unroll
// is the build's UC), reservoir width (one of Vs) and fractal; returns 1
// for an instantiation it lacks.
template <class Orbit, class Builds, int... Vs>
int mh_warps_pick(int fractal, int slots, int per_thread, int shared,
                  int unroll, const cb::mh::ClassifyMhArgs& a) {
  int rc = 1;
  auto run = [&](auto fr, auto v, auto build) {
    constexpr int FR = decltype(fr)::value, V = decltype(v)::value;
    using B = decltype(build);
    if (B::S != per_thread || B::SH != shared || B::UC != unroll) return;
    mh_warps<FR, V, B::S, B::SH, B::UC, Orbit>(a);
    rc = 0;
  };
  auto by_build = [&](auto fr, auto v) {
    std::apply([&](auto... b) { (run(fr, v, b), ...); }, Builds{});
  };
  auto by_v = [&](auto fr) {
    ((slots == Vs ? by_build(fr, std::integral_constant<int, Vs>()) : void()),
     ...);
  };
  switch (fractal) {
    case cb::kBuddhabrot:
      by_v(std::integral_constant<int, cb::kBuddhabrot>());
      break;
    case cb::kBurningShip:
      by_v(std::integral_constant<int, cb::kBurningShip>());
      break;
    case cb::kAntiBuddhabrot:
      by_v(std::integral_constant<int, cb::kAntiBuddhabrot>());
      break;
  }
  return rc;
}

// One df32 replay of emission i into the sink, for its own length (a
// kernel's warp runs its lanes for the longest one's); adds its on-canvas
// count to total. W: the binning's window instantiation.
template <int FR, bool W, class Sink>
void replay_ext_own(const cb::ReplayExtArgs& a, int i, const Sink& sink,
                    unsigned long long& total) {
  const int n = a.iters[i];
  if (n >= 0) total += cb::replay_ext_one<FR, W>(a, i, n, n + 1, sink);
}

template <int FR, class Sink>
void replay_ext_window(const cb::ReplayExtArgs& a, int i, const Sink& sink,
                       unsigned long long& total) {
  if (cb::df::is_window(a.q))
    replay_ext_own<FR, true>(a, i, sink, total);
  else
    replay_ext_own<FR, false>(a, i, sink, total);
}

// replay_ext_own with the instantiation picked by fractal and window, as
// deposit_ext.cu dispatch picks it.
template <class Sink>
int replay_ext_by_fractal(int fractal, const cb::ReplayExtArgs& a, int i,
                          const Sink& sink, unsigned long long& total) {
  switch (fractal) {
    case cb::kBuddhabrot:
      replay_ext_window<cb::kBuddhabrot>(a, i, sink, total);
      return 0;
    case cb::kBurningShip:
      replay_ext_window<cb::kBurningShip>(a, i, sink, total);
      return 0;
    case cb::kAntiBuddhabrot:
      replay_ext_window<cb::kAntiBuddhabrot>(a, i, sink, total);
      return 0;
  }
  return 1;
}

// Every emission of a df32 replay in order, emission i into sink_of(i);
// adds the on-canvas count to *hits.
template <class SinkOf>
int replay_ext_all(int fractal, const cb::ReplayExtArgs& a,
                   const SinkOf& sink_of, void* hits) {
  unsigned long long total = 0;
  for (int i = 0; i < a.k; ++i) {
    const int rc = replay_ext_by_fractal(fractal, a, i, sink_of(i), total);
    if (rc != 0) return rc;
  }
  *static_cast<unsigned long long*>(hits) += total;
  return 0;
}

// One item of the f32 classify kernel (classify.cu classify_slice): windows
// [w0, w1) of the pass for lane group g, its warp emulated with S lanes per
// thread: the 32 threads load their S lanes at w0, run each window (the
// finished pairs queue their lane ids at the slots refill_slot gives them,
// the queued draws are computed in passes of 32, as thread q takes slots
// q, q + 32, ..., and each finished lane takes its own slot's draw), flush
// at each chunk's end or hand the pending emission over in the chunk's slot
// where the slice ends inside it, and store their lanes at w1. The window
// loop runs at the runtime unroll (U = 0).
template <int FR, bool THIN, bool VISIT, int S>
void classify_slice(const cb::ClassifyArgs& a, int g, int w0, int w1) {
  std::vector<cb::Lane> L(32 * S);
  std::vector<int> q_lane(32 * S);
  std::vector<cb::Draw> q_draw(32 * S);
  auto lane = [&](int t, int j) { return (g * S + j) * 32 + t; };
  auto live = [&](int t, int j) { return lane(t, j) < a.lanes; };
  for (int t = 0; t < 32; ++t)
    for (int j = 0; j < S; ++j)
      L[t * S + j] = cb::load_lane(a, live(t, j) ? lane(t, j) : 0, w0);
  for (int chunk = w0 / a.windows; chunk * a.windows < w1; ++chunk) {
    const int c0 = chunk * a.windows;
    const int wz = std::min(w1 - c0, a.windows);
    for (int w = std::max(w0 - c0, 0); w < wz; ++w) {
      uint32_t mask[S] = {};
      bool fin[32][S];
      int F = 0;
      for (int t = 0; t < 32; ++t)
        for (int j = 0; j < S; ++j) {
          fin[t][j] = cb::lane_window<FR, THIN, VISIT, 0>(a, L[t * S + j])
                      && live(t, j);
          mask[j] |= uint32_t(fin[t][j]) << t;
        }
      for (int j = 0; j < S; ++j) F += cb::popc32(mask[j]);
      const int gwin = c0 + w;
      for (int t = 0; t < 32; ++t)
        for (int j = 0; j < S; ++j)
          if (fin[t][j]) q_lane[cb::refill_slot<S>(mask, t, j)] = lane(t, j);
      for (int pass = 0; pass * 32 < F; ++pass)
        for (int t = 0; t < 32; ++t) {
          const int q = pass * 32 + t;
          if (q < F) q_draw[q] = cb::draw_sample<FR>(a, q_lane[q], gwin);
        }
      for (int t = 0; t < 32; ++t)
        for (int j = 0; j < S; ++j)
          if (fin[t][j])
            cb::refill<VISIT>(L[t * S + j],
                              q_draw[cb::refill_slot<S>(mask, t, j)]);
    }
    for (int t = 0; t < 32; ++t)
      for (int j = 0; j < S; ++j)
        if (live(t, j)) cb::flush_lane(a, L[t * S + j], chunk, lane(t, j));
  }
  for (int t = 0; t < 32; ++t)
    for (int j = 0; j < S; ++j)
      if (live(t, j)) cb::store_lane(a, L[t * S + j], lane(t, j));
}

// One pass of the f32 classify kernel: its items (lane group, slice) in
// slice-major order, as the kernel's queue hands them out, the groups of
// each slice in an order shuffled by `order` (0: in turn), as the warps
// that take them may run in any order. The pass is cut as slice_plan cuts
// it, or, where `len` > 0, into slices of `len` windows (the cut of a
// longer pass, on a pass short enough for a test).
template <int FR, bool THIN, bool VISIT, int S>
void classify_warps(const cb::ClassifyArgs& a, uint32_t order, int len) {
  const int groups = (a.lanes + 32 * S - 1) / (32 * S);
  const int windows = a.chunks * a.windows;
  const cb::Slices sl = len > 0 ? cb::Slices{len, (windows + len - 1) / len}
                                : cb::slice_plan(a.chunks, a.windows);
  std::vector<int> perm(groups);
  std::mt19937 rng(order);
  for (int s = 0; s < sl.count; ++s) {
    for (int g = 0; g < groups; ++g) perm[g] = g;
    if (order != 0) std::shuffle(perm.begin(), perm.end(), rng);
    for (int g : perm)
      classify_slice<FR, THIN, VISIT, S>(
          a, g, s * sl.len, std::min((s + 1) * sl.len, windows));
  }
}

template <int FR, bool THIN, bool VISIT>
int classify_warps_by_s(int per_thread, uint32_t order, int len,
                        const cb::ClassifyArgs& a) {
  switch (per_thread) {
    case 1: classify_warps<FR, THIN, VISIT, 1>(a, order, len); return 0;
    case 2: classify_warps<FR, THIN, VISIT, 2>(a, order, len); return 0;
    case 4: classify_warps<FR, THIN, VISIT, 4>(a, order, len); return 0;
  }
  return 1;
}

template <int FR>
int classify_warps_by_variant(int thin, int visit, int per_thread,
                              uint32_t order, int len,
                              const cb::ClassifyArgs& a) {
  if (!thin)
    return visit ? 1
                 : classify_warps_by_s<FR, false, false>(per_thread, order,
                                                         len, a);
  return visit
             ? classify_warps_by_s<FR, true, true>(per_thread, order, len, a)
             : classify_warps_by_s<FR, true, false>(per_thread, order, len,
                                                    a);
}

// One pass of the df32 classify kernel (classify_ext.cu) with S lanes per
// thread, its warps emulated in turn: each warp's 32 threads run their S
// lanes' windows (ext_window, unrolled for U > 0, a run-time loop for
// U = 0); a warp with no finished live lane goes on to its next window, as
// the kernel's vote has it; otherwise each finished lane takes the rest of
// its boundary and its refill (ext_finish).
template <int FR, bool VISIT, int S, int U>
void classify_ext_warps(const cb::ClassifyExtArgs& a) {
  const int warps = (a.lanes + 32 * S - 1) / (32 * S);
  const int u = U > 0 ? U : a.unroll;
  std::vector<cb::ExtLane> L(32 * S);
  for (int g = 0; g < warps; ++g) {
    auto lane = [&](int t, int j) { return (g * S + j) * 32 + t; };
    auto live = [&](int t, int j) { return lane(t, j) < a.lanes; };
    for (int t = 0; t < 32; ++t)
      for (int j = 0; j < S; ++j)
        L[t * S + j] = cb::load_ext_lane(a, live(t, j) ? lane(t, j) : 0);
    for (int chunk = 0; chunk < a.chunks; ++chunk) {
      for (int w = 0; w < a.windows; ++w) {
        bool fin[32][S];
        bool any = false;
        for (int t = 0; t < 32; ++t)
          for (int j = 0; j < S; ++j) {
            fin[t][j] = cb::ext_window<FR, VISIT, U>(a, L[t * S + j]) &&
                        live(t, j);
            any = any || fin[t][j];
          }
        if (!any) continue;
        const int gwin = chunk * a.windows + w;
        for (int t = 0; t < 32; ++t)
          for (int j = 0; j < S; ++j)
            if (fin[t][j])
              cb::ext_finish<FR, VISIT>(a, L[t * S + j], lane(t, j), gwin, u);
      }
      for (int t = 0; t < 32; ++t)
        for (int j = 0; j < S; ++j)
          if (live(t, j))
            cb::flush_ext_lane(a, L[t * S + j], chunk, lane(t, j));
    }
    for (int t = 0; t < 32; ++t)
      for (int j = 0; j < S; ++j)
        if (live(t, j)) cb::store_ext_lane(a, L[t * S + j], lane(t, j));
  }
}

// classify_ext_warps with the instantiation picked by fractal, visit
// window, lanes per thread (1 or 2) and window (0: run-time loop; 1 or 4
// unrolled).
int classify_ext_warps_pick(int fractal, int visit, int per_thread, int unroll,
                            const cb::ClassifyExtArgs& a) {
  int rc = 1;
  auto by_u = [&](auto fr, auto vis, auto s) {
    constexpr int FR = decltype(fr)::value, S = decltype(s)::value;
    constexpr bool VISIT = decltype(vis)::value;
    switch (unroll) {
      case 0: classify_ext_warps<FR, VISIT, S, 0>(a); rc = 0; break;
      case 1: classify_ext_warps<FR, VISIT, S, 1>(a); rc = 0; break;
      case 4: classify_ext_warps<FR, VISIT, S, 4>(a); rc = 0; break;
    }
  };
  auto by_s = [&](auto fr, auto vis) {
    if (per_thread == 1) by_u(fr, vis, std::integral_constant<int, 1>());
    if (per_thread == 2) by_u(fr, vis, std::integral_constant<int, 2>());
  };
  auto by_visit = [&](auto fr) {
    if (visit) by_s(fr, std::true_type());
    else by_s(fr, std::false_type());
  };
  switch (fractal) {
    case cb::kBuddhabrot:
      by_visit(std::integral_constant<int, cb::kBuddhabrot>());
      break;
    case cb::kBurningShip:
      by_visit(std::integral_constant<int, cb::kBurningShip>());
      break;
    case cb::kAntiBuddhabrot:
      by_visit(std::integral_constant<int, cb::kAntiBuddhabrot>());
      break;
  }
  return rc;
}

}  // namespace

extern "C" {

// The interface of cb_classify, the kernel's warps emulated on the CPU
// with iargs[10] lanes per thread (the kernel's kLanesPerThread, 2), the
// groups of each slice in the order iargs[11] shuffles them (0: in turn),
// and slices of iargs[12] windows (0: slice_plan's); ptrs[14] and
// ptrs[15], the queue and the late counts, are not read.
int cbh_classify(void** ptrs, const int* iargs, const float* fargs,
                 uint32_t k0, uint32_t k1) {
  const cb::ClassifyArgs a = cb::classify_args(ptrs, iargs, fargs, k0, k1);
  const int thin = iargs[1], visit = iargs[2], per_thread = iargs[10];
  const uint32_t order = uint32_t(iargs[11]);
  const int len = iargs[12];
  switch (iargs[0]) {
    case cb::kBuddhabrot:
      return classify_warps_by_variant<cb::kBuddhabrot>(
          thin, visit, per_thread, order, len, a);
    case cb::kBurningShip:
      return classify_warps_by_variant<cb::kBurningShip>(
          thin, visit, per_thread, order, len, a);
    case cb::kAntiBuddhabrot:
      return classify_warps_by_variant<cb::kAntiBuddhabrot>(
          thin, visit, per_thread, order, len, a);
  }
  return 1;
}

// The kernel's cut of a pass into slices (classify.cuh slice_plan):
// out[0] windows a slice, out[1] slices a pass.
int cbh_slice_plan(int chunks, int windows, int* out) {
  const cb::Slices sl = cb::slice_plan(chunks, windows);
  out[0] = sl.len;
  out[1] = sl.count;
  return 0;
}

// refill_slot for every (thread, sub-lane) of one warp: masks holds S
// ballots; slots[j * 32 + t] gets the slot of finished pairs, -1 for the
// others.
int cbh_refill_slots(int per_thread, const uint32_t* masks, int* slots) {
  auto fill = [&](auto tag) {
    constexpr int S = decltype(tag)::value;
    uint32_t m[S];
    for (int j = 0; j < S; ++j) m[j] = masks[j];
    for (int j = 0; j < S; ++j)
      for (int t = 0; t < 32; ++t)
        slots[j * 32 + t] =
            (m[j] >> t) & 1u ? cb::refill_slot<S>(m, t, j) : -1;
    return 0;
  };
  switch (per_thread) {
    case 1: return fill(std::integral_constant<int, 1>());
    case 2: return fill(std::integral_constant<int, 2>());
    case 4: return fill(std::integral_constant<int, 4>());
  }
  return 1;
}

// The interface of cb_replay_deposit, the kernel's queue emulated on the
// CPU: groups of 32 emissions, each lane replayed for its group's longest
// orbit (orbit.cuh replay_orbit), a lane past the batch's end
// running the group's first emission with nothing recorded.
int cbh_replay_deposit(int fractal, const float* cr, const float* ci,
                       const int32_t* iters, int k, uint32_t* hist,
                       float min_re, float min_im, float d_re, float d_im,
                       int width, int height, int row_start, int row_count,
                       void* hits) {
  const cb::CanvasQ q{min_re, min_im, d_re,      d_im,
                      width,  height, row_start, row_count};
  const cb::DepositSink sink{hist};
  unsigned long long total = 0;
  for (int g = 0; g * 32 < k; ++g) {
    int steps = 0;
    for (int i = g * 32; i < g * 32 + 32 && i < k; ++i)
      steps = iters[i] + 1 > steps ? iters[i] + 1 : steps;
    if (steps <= 0) continue;
    for (int i = g * 32; i < g * 32 + 32; ++i) {
      const int e = i < k ? i : g * 32;
      const int n = i < k ? iters[i] : -1;
      switch (fractal) {
        case cb::kBuddhabrot:
          total += cb::replay_orbit<cb::kBuddhabrot>(cr[e], ci[e], n,
                                                           steps, q, sink);
          break;
        case cb::kBurningShip:
          total += cb::replay_orbit<cb::kBurningShip>(cr[e], ci[e], n,
                                                            steps, q, sink);
          break;
        case cb::kAntiBuddhabrot:
          total += cb::replay_orbit<cb::kAntiBuddhabrot>(
              cr[e], ci[e], n, steps, q, sink);
          break;
        default:
          return 1;
      }
    }
  }
  *static_cast<unsigned long long*>(hits) += total;
  return 0;
}

// Elementwise df32 functions over n values; outputs are (hi, lo) arrays.
void cbh_two_sum(const float* a, const float* b, int n, float* s, float* e) {
  for (int i = 0; i < n; ++i) {
    const F2 r = cb::df::two_sum(a[i], b[i]);
    s[i] = r.hi;
    e[i] = r.lo;
  }
}

void cbh_quick_two_sum(const float* a, const float* b, int n, float* s,
                       float* e) {
  for (int i = 0; i < n; ++i) {
    const F2 r = cb::df::quick_two_sum(a[i], b[i]);
    s[i] = r.hi;
    e[i] = r.lo;
  }
}

void cbh_split(const float* a, int n, float* hi, float* lo) {
  for (int i = 0; i < n; ++i) {
    const F2 r = cb::df::split(a[i]);
    hi[i] = r.hi;
    lo[i] = r.lo;
  }
}

void cbh_two_prod(const float* a, const float* b, int n, float* p, float* e) {
  for (int i = 0; i < n; ++i) {
    const F2 r = cb::df::two_prod(a[i], b[i]);
    p[i] = r.hi;
    e[i] = r.lo;
  }
}

void cbh_two_prod_sqr(const float* a, int n, float* p, float* e) {
  for (int i = 0; i < n; ++i) {
    const F2 r = cb::df::two_prod_sqr(a[i]);
    p[i] = r.hi;
    e[i] = r.lo;
  }
}

// op: 0 add, 1 sub, 2 mul over df pairs (ah, al) and (bh, bl).
void cbh_binary(int op, const float* ah, const float* al, const float* bh,
                const float* bl, int n, float* h, float* l) {
  for (int i = 0; i < n; ++i) {
    const F2 a{ah[i], al[i]}, b{bh[i], bl[i]};
    const F2 r = op == 0 ? cb::df::add(a, b)
                 : op == 1 ? cb::df::sub(a, b)
                           : cb::df::mul(a, b);
    h[i] = r.hi;
    l[i] = r.lo;
  }
}

// op: 0 sqr, 1 abs_ of a df pair; 2 add_f(a, bh).
void cbh_unary(int op, const float* ah, const float* al, const float* bh,
               int n, float* h, float* l) {
  for (int i = 0; i < n; ++i) {
    const F2 a{ah[i], al[i]};
    const F2 r = op == 0 ? cb::df::sqr(a)
                 : op == 1 ? cb::df::abs_(a)
                           : cb::df::add_f(a, bh[i]);
    h[i] = r.hi;
    l[i] = r.lo;
  }
}

// z and c as 4 arrays each (hi, lo, hi, lo); out: nzr, nzrl, nzi, nzil,
// mag2, 5 arrays of n.
void cbh_complex_sqr_add(int fold_abs, const float* const* z,
                         const float* const* c, int n, float* const* out) {
  for (int i = 0; i < n; ++i) {
    F2 zr{z[0][i], z[1][i]}, zi{z[2][i], z[3][i]};
    const F2 cr{c[0][i], c[1][i]}, ci{c[2][i], c[3][i]};
    out[4][i] = fold_abs
                    ? cb::df::complex_sqr_add<cb::kBurningShip>(zr, zi, cr, ci)
                    : cb::df::complex_sqr_add<cb::kBuddhabrot>(zr, zi, cr, ci);
    out[0][i] = zr.hi;
    out[1][i] = zr.lo;
    out[2][i] = zi.hi;
    out[3][i] = zi.lo;
  }
}

// The interface of cb_classify_ext, the kernel's warps emulated on the
// CPU: one lane a thread, the window a run-time loop.
int cbh_classify_ext(void** ptrs, const int* iargs, const float* fargs,
                     uint32_t k0, uint32_t k1) {
  const cb::ClassifyExtArgs a =
      cb::classify_ext_args(ptrs, iargs, fargs, k0, k1);
  return classify_ext_warps_pick(iargs[0], iargs[1], 1, 0, a);
}

// The same with iargs[9] lanes per thread, 1 or 2 (the kernel's
// kLanesPerThread is 1) and, where iargs[10] is set, the window
// unrolled at compile time for a.unroll (1 or 4, as the kernel's launcher
// picks it; the package unrolls 1, 2, 4, 8, 16 and 32).
int cbh_classify_ext_warps(void** ptrs, const int* iargs, const float* fargs,
                           uint32_t k0, uint32_t k1) {
  const cb::ClassifyExtArgs a =
      cb::classify_ext_args(ptrs, iargs, fargs, k0, k1);
  return classify_ext_warps_pick(iargs[0], iargs[1], iargs[9],
                                 iargs[10] ? a.unroll : 0, a);
}

// The interface of cb_replay_deposit_ext, emissions looped on the CPU.
int cbh_replay_deposit_ext(const void* kr, const void* ki, const void* iters,
                           void* hist, const int* iargs, const float* fargs,
                           void* hits) {
  const cb::ReplayExtArgs a =
      cb::replay_ext_args(kr, ki, iters, hist, iargs, fargs);
  return replay_ext_all(
      iargs[0], a, [&](int) { return cb::DepositSink{a.hist}; }, hits);
}

// The df32 id writer with a store per point (orbit.cuh IdSink): every slot
// of each orbit gets its bin id or the sentinel. Arguments as
// cb_replay_ids_ext.
int cbh_replay_ids_ext(const void* kr, const void* ki, const void* iters,
                       const void* off, void* ids, const int* iargs,
                       const float* fargs, void* hits) {
  const cb::ReplayExtArgs a =
      cb::replay_ext_args(kr, ki, iters, nullptr, iargs, fargs);
  const auto* po = static_cast<const long long*>(off);
  auto* pi = static_cast<int32_t*>(ids);
  const int32_t nbins = a.q.width * a.q.row_count;
  return replay_ext_all(
      iargs[0], a,
      [&](int i) { return cb::IdSink{pi + po[i], nbins, a.iters[i]}; },
      hits);
}

// The interface of cb_replay_ids_ext, emissions looped on the CPU: the
// kernel's on-canvas sink (orbit.cuh CanvasIdSink), so ids must hold the
// sentinel beforehand, as the kernel's wrapper fills it.
int cbh_replay_ids_ext_canvas(const void* kr, const void* ki,
                              const void* iters, const void* off, void* ids,
                              const int* iargs, const float* fargs,
                              void* hits) {
  const cb::ReplayExtArgs a =
      cb::replay_ext_args(kr, ki, iters, nullptr, iargs, fargs);
  const auto* po = static_cast<const long long*>(off);
  auto* pi = static_cast<int32_t*>(ids);
  return replay_ext_all(
      iargs[0], a, [&](int i) { return cb::CanvasIdSink{pi + po[i]}; },
      hits);
}

// The interface of cb_replay_ids (warps and the queue's arguments left
// out), the kernel's warps emulated on the CPU: groups of 32 emissions,
// each lane replayed for its group's longest orbit kTile steps at a time
// into its row of the warp's tile (orbit.cuh TileSink), the tile stored
// after each span row by row as the warp's 32 threads store it
// (store_tile_word). The tile starts filled with `poison`, as shared memory
// holds whatever it held, so a stale word that reached the stream would
// show.
int cbh_replay_ids(int fractal, const float* cr, const float* ci,
                   const int32_t* iters, const long long* off, int k,
                   int32_t* ids, float min_re, float min_im, float d_re,
                   float d_im, int width, int height, int row_start,
                   int row_count, int poison, void* hits) {
  const cb::CanvasQ q{min_re, min_im, d_re,      d_im,
                      width,  height, row_start, row_count};
  const int32_t nbins = width * row_count;
  std::vector<int32_t> tile(cb::kTile * cb::kTileStride, poison);
  unsigned long long total = 0;
  auto warps = [&](auto tag) {
    constexpr int FR = decltype(tag)::value;
    for (int g = 0; g * 32 < k; ++g) {
      cb::ReplayLane l[32];
      int n[32], steps = 0;
      int32_t* out[32];
      for (int x = 0; x < 32; ++x) {
        const int i = g * 32 + x, e = i < k ? i : g * 32;
        n[x] = i < k ? iters[i] : -1;
        out[x] = ids + off[e];
        l[x] = cb::replay_start<FR>(cr[e], ci[e]);
        steps = n[x] + 1 > steps ? n[x] + 1 : steps;
      }
      for (int t0 = 0; t0 < steps; t0 += cb::kTile) {
        const int t1 = t0 + cb::kTile < steps ? t0 + cb::kTile : steps;
        for (int x = 0; x < 32; ++x)
          total += cb::replay_span<FR>(
              l[x], n[x], t0, t1, q,
              cb::TileSink{tile.data() + x * cb::kTileStride, nbins});
        for (int r = 0; r < 32; ++r)
          for (int x = 0; x < 32; ++x)
            cb::store_tile_word(tile.data(), r, x, t0, n[r] + 1, out[r]);
      }
    }
    return 0;
  };
  switch (fractal) {
    case cb::kBuddhabrot:
      warps(std::integral_constant<int, cb::kBuddhabrot>());
      break;
    case cb::kBurningShip:
      warps(std::integral_constant<int, cb::kBurningShip>());
      break;
    case cb::kAntiBuddhabrot:
      warps(std::integral_constant<int, cb::kAntiBuddhabrot>());
      break;
    default:
      return 1;
  }
  *static_cast<unsigned long long*>(hits) += total;
  return 0;
}

// The interface of cb_bigtiles_deposit: each chunk copied into the padded
// layout, its threads' position ranges run in order, and the exclusive
// max-scan of their last run starts carried along as the kernel's block
// scan computes it.
int cbh_bigtiles_deposit(const int32_t* ids, long long n, int chunk,
                         uint32_t* hist, int nbins) {
  namespace bt = cb::bigtiles;
  if (chunk <= 0 || chunk > bt::kMaxChunk) return 1;
  std::vector<int32_t> s(bt::kSlots);
  const int per = (chunk + bt::kThreads - 1) / bt::kThreads;
  for (long long base = 0; base < n; base += chunk) {
    const int len = n - base < chunk ? int(n - base) : chunk;
    for (int j = 0; j < len; ++j) s[bt::slot(j)] = ids[base + j];
    int start = -1;
    for (int t = 0; t < bt::kThreads; ++t) {
      const int lo = t * per;
      const int hi = lo + per < len ? lo + per : len;
      bt::deposit_runs(s.data(), lo, hi, len, start, hist, nbins);
      const int last = bt::last_run_start(s.data(), lo, hi);
      if (last > start) start = last;
    }
  }
  return 0;
}

// The interface of cb_length_sort (any tile bits lb in [5, 14]), its three
// kernels in turn. A tile's warps append their valid keys to shared memory
// in whatever order their atomics land, here the tile's last warp first;
// the bitonic network runs its stages pair by pair. The offsets blocks
// take their tickets in order, each adding up its buckets' columns by the
// kernel's groups of tiles, its prefix the running sum of the blocks
// before it.
int cbh_length_sort(const void* emit_c, const void* emit_it, int n,
                    int width, int max_it, int nb, int lb, void* scratch,
                    void* out, void* n_valid) {
  namespace ls = cb::lsort;
  if (n <= 0 || width <= 0 || nb <= 0 || lb < 5 || lb > 14 ||
      (long long)nb >= (1ll << (32 - lb)))
    return 1;
  const ls::Layout l = ls::layout(n, nb, lb);
  const auto* c = static_cast<const uint32_t*>(emit_c);
  const auto* it = static_cast<const int32_t*>(emit_it);
  int32_t* w = static_cast<int32_t*>(scratch);
  int32_t* tile_n = w + l.tile_n;
  int32_t* off = w + l.off;
  auto* runs = reinterpret_cast<uint32_t*>(w + l.runs);
  auto* o = static_cast<uint32_t*>(out);
  auto* o_it = reinterpret_cast<int32_t*>(o + 2 * size_t(n));
  std::vector<uint32_t> s(size_t(1) << lb);
  for (int t = 0; t < l.tiles; ++t) {  // length_sort_tiles_kernel
    const int base = t << lb;
    const int len = std::min(1 << lb, n - base);
    int nt = 0;
    for (int k0 = (len - 1) / 32 * 32; k0 >= 0; k0 -= 32)
      for (int k = k0; k < std::min(k0 + 32, len); ++k)
        if (it[base + k] >= 0)
          s[nt++] = (uint32_t(ls::bucket(it[base + k], max_it, nb)) << lb) |
                    uint32_t(k);
    int p = 1;
    while (p < nt) p <<= 1;
    for (int i = nt; i < p; ++i) s[i] = ls::kPad;
    for (int k = 2; k <= p; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1)
        for (int i = 0; i < p / 2; ++i) ls::bitonic_pair(s.data(), k, j, i);
    for (int i = 0; i < nt; ++i) runs[base + i] = s[i];
    for (int b = 0; b < nb; ++b)
      off[size_t(t) * nb + b] = ls::bucket_count(s.data(), nt, b, lb);
    tile_n[t] = nt;
  }
  const int per = (l.tiles + ls::kScanRows - 1) / ls::kScanRows;
  int prefix = 0;
  for (int blk = 0; blk < l.blocks; ++blk) {  // length_sort_offsets_kernel
    int part[ls::kScanRows][ls::kScanCols] = {};
    for (int r = 0; r < ls::kScanRows; ++r)
      for (int ci = 0; ci < ls::kScanCols; ++ci) {
        const int b = blk * ls::kScanCols + ci;
        const int t0 = std::min(r * per, l.tiles);
        const int t1 = std::min(t0 + per, l.tiles);
        if (b < nb)
          for (int t = t0; t < t1; ++t) part[r][ci] += off[size_t(t) * nb + b];
      }
    int total[ls::kScanCols] = {}, agg = 0;
    for (int ci = 0; ci < ls::kScanCols; ++ci) {
      for (int r = 0; r < ls::kScanRows; ++r) total[ci] += part[r][ci];
      agg += total[ci];
    }
    for (int ci = 0, lower = 0; ci < ls::kScanCols; lower += total[ci++]) {
      const int b = blk * ls::kScanCols + ci;
      if (b >= nb) continue;
      int run = prefix + lower;
      for (int t = 0; t < l.tiles; ++t) {
        const size_t i = size_t(t) * nb + b;
        const int v = off[i];
        off[i] = run;
        run += v;
      }
    }
    prefix += agg;
  }
  *static_cast<long long*>(n_valid) = prefix;
  auto place = [&](int pos, uint32_t slot) {
    o[pos] = ls::emission_word(c, slot, width, 0);
    o[n + pos] = ls::emission_word(c, slot, width, 1);
    o_it[pos] = it[slot];
  };
  for (int t = 0; t < l.tiles; ++t) {  // length_sort_scatter_kernel
    const int base = t << lb;
    const int nt = tile_n[t];
    for (int i = 0; i < nt; ++i) s[i] = runs[base + i];
    for (int i = 0; i < nt; ++i)
      place(ls::destination(s.data(), nt, i, lb, off + size_t(t) * nb),
            uint32_t(base) + (s[i] & ((1u << lb) - 1)));
  }
  for (long long q = prefix; q < n; ++q) {
    o[q] = o[n + q] = 0;
    o_it[q] = -1;
  }
  return 0;
}

// The interface of cb_length_sort_words.
long long cbh_length_sort_words(int n, int nb, int lb) {
  return (long long)cb::lsort::layout(n, nb, lb).words;
}

// The interface of cb_classify_mh (ext = 0) and cb_classify_ext_mh
// (ext = 1), one lane a thread, at every reservoir width, all reservoirs
// in registers, the window a run-time loop.
int cbh_classify_mh(int ext, void** ptrs, const int* iargs,
                    const float* fargs, uint32_t k0, uint32_t k1) {
  const cb::mh::ClassifyMhArgs a =
      cb::mh::classify_mh_args(ext != 0, ptrs, iargs, fargs, k0, k1);
  using One = std::tuple<MhBuild<1, 0, 0>>;
  return ext ? mh_warps_pick<cb::mh::OrbitDf, One, 2, 4, 8, 16, 32>(
                   iargs[0], iargs[1], 1, 0, 0, a)
             : mh_warps_pick<cb::mh::OrbitF32, One, 2, 4, 8, 16, 32>(
                   iargs[0], iargs[1], 1, 0, 0, a);
}

// The interface of cb_classify_mh (ext = 0) and cb_classify_ext_mh
// (ext = 1), the kernel's warps emulated on the CPU in one of its builds:
// iargs[13] lanes per thread, iargs[14] reservoirs in shared memory,
// iargs[15] the window unrolled (the kernel's Build<Orbit>::S and
// Build<Orbit>::shared, and its launcher's unrolled U), at reservoir widths 2,
// 8 and 32 (the narrowest, the default, the widest); the unrolled window
// at U = 4. F32Builds and DfBuilds list the builds.
int cbh_classify_mh_warps(int ext, void** ptrs, const int* iargs,
                          const float* fargs, uint32_t k0, uint32_t k1) {
  const cb::mh::ClassifyMhArgs a =
      cb::mh::classify_mh_args(ext != 0, ptrs, iargs, fargs, k0, k1);
  const int unroll = iargs[15] ? a.unroll : 0;
  return ext ? mh_warps_pick<cb::mh::OrbitDf, DfBuilds, 2, 8, 32>(
                   iargs[0], iargs[1], iargs[13], iargs[14], unroll, a)
             : mh_warps_pick<cb::mh::OrbitF32, F32Builds, 2, 8, 32>(
                   iargs[0], iargs[1], iargs[13], iargs[14], unroll, a);
}

// The interface of cb_mh_deposit (without the grid and the stream), the
// kernel's warps emulated in turn: each group of 32 lanes of one chunk
// computes its slots' n and q (mh_slot), the inclusive scan of n numbers
// their (emission, k) pairs, and each round of 32 pairs finds its owners
// (pair_owner over the scan), computes the shares (mh_share) and adds
// them, lane by lane; the totals are summed per group.
int cbh_mh_deposit_warps(const void* bins, const void* gate, int gate_min,
                         const void* t, const void* rep, long long n,
                         int slots, int lanes, void* hist, int nbins,
                         void* deposits, void* mass) {
  if (n <= 0) return 0;
  if (slots <= 0 || lanes <= 0 || n % lanes != 0) return 1;
  const cb::mh::MhDepositArgs a{
      static_cast<const int32_t*>(bins), static_cast<const int32_t*>(t),
      static_cast<const int32_t*>(rep),  n, slots, lanes,
      static_cast<uint32_t*>(hist),      nbins,
      static_cast<const int32_t*>(gate), gate_min};
  const long long per_chunk = (lanes + 31) / 32;
  const long long groups = n / lanes * per_chunk;
  unsigned long long dep = 0, ms = 0;
  for (long long g = 0; g < groups; ++g) {
    const long long chunk = g / per_chunk, l0 = (g % per_chunk) * 32;
    uint32_t nn[32], qq[32], incl[32];
    for (int x = 0; x < 32; ++x) {
      nn[x] = qq[x] = 0;
      if (l0 + x < lanes)
        cb::mh::mh_slot(a, chunk * lanes + l0 + x, nn[x], qq[x]);
      dep += nn[x];
      ms += qq[x];
      incl[x] = nn[x] + (x > 0 ? incl[x - 1] : 0u);
    }
    const uint32_t total = incl[31];
    const int32_t* rows = a.bins + chunk * slots * (long long)lanes + l0;
    for (uint32_t p0 = 0; p0 < total; p0 += 32) {
      bool on[32];
      int32_t bin[32];
      uint32_t d[32];
      for (int x = 0; x < 32; ++x) {
        const uint32_t p = p0 + uint32_t(x);
        on[x] = p < total;
        if (!on[x]) continue;
        const int j = cb::mh::pair_owner(p, [&](int i) { return incl[i]; });
        const uint32_t k = p - (incl[j] - nn[j]);
        d[x] = cb::mh::mh_share(k, qq[j], nn[j]);
        bin[x] = rows[(long long)k * lanes + j];
        on[x] = d[x] != 0 && bin[x] >= 0 && bin[x] < nbins;
      }
      for (int x = 0; x < 32; ++x)
        if (on[x]) a.hist[bin[x]] += d[x];
    }
  }
  *static_cast<long long*>(deposits) += (long long)dep;
  *static_cast<long long*>(mass) += (long long)ms;
  return 0;
}

// orbit.cuh bin_id over n points in the row window (row_start,
// row_count): ids[i] = the local id, or -1.
void cbh_bin_id(const float* re, const float* im, int n, float min_re,
                float min_im, float d_re, float d_im, int width, int height,
                int row_start, int row_count, long long* ids) {
  const cb::CanvasQ q{min_re, min_im, d_re,      d_im,
                      width,  height, row_start, row_count};
  for (int i = 0; i < n; ++i) ids[i] = cb::bin_id(q, re[i], im[i]);
}

// df32.cuh bin_id_df's window instantiation over n df32 points: iargs
// width, height, row_start, row_count; fargs the canvas minimum (rh, rl,
// ih, il) and the inverse pitches (re, im).
void cbh_bin_id_df(const float* reh, const float* rel, const float* imh,
                   const float* iml, int n, const int* iargs,
                   const float* fargs, long long* ids) {
  cb::df::CanvasQDf q;
  q.min_re = {fargs[0], fargs[1]};
  q.min_im = {fargs[2], fargs[3]};
  q.inv_d_re = fargs[4];
  q.inv_d_im = fargs[5];
  q.width = iargs[0];
  q.height = iargs[1];
  q.row_start = iargs[2];
  q.row_count = iargs[3];
  for (int i = 0; i < n; ++i)
    ids[i] = cb::df::bin_id_df<true>(q, {reh[i], rel[i]}, {imh[i], iml[i]});
}

// The interface of cb_pass_counters, without the stream: every thread of
// the grid of `blocks` blocks sums its share (counters.cuh thread_sums),
// each block adds its threads' sums, and the blocks' adds land in the
// totals in the order of their atomics, here the last block's first.
int cbh_pass_counters(const void* stats, long long width, const void* iters,
                      long long n, const void* n_valid,
                      long long capacity, long long steps,
                      void* const* totals, int blocks) {
  namespace pc = cb::counters;
  if (width < 0 || n < 0 || blocks <= 0 || (n > 0 && iters == nullptr))
    return 1;
  const long long nv = *static_cast<const long long*>(n_valid);
  const long long k = pc::batch_bound(n, nv, capacity);
  const long long T = (long long)blocks * pc::kThreads;
  for (int b = blocks - 1; b >= 0; --b) {
    long long sum[pc::kRows + 1] = {}, s[pc::kRows + 1], add[pc::kTotals];
    for (int t = 0; t < pc::kThreads; ++t) {
      pc::thread_sums(static_cast<const int32_t*>(stats), width,
                      static_cast<const int32_t*>(iters), k,
                      (long long)b * pc::kThreads + t, T, s);
      for (int i = 0; i <= pc::kRows; ++i) sum[i] += s[i];
    }
    pc::block_adds(b, sum, nv, capacity, steps, add);
    for (int i = 0; i < pc::kTotals; ++i)
      *static_cast<unsigned long long*>(totals[i]) +=
          (unsigned long long)add[i];
  }
  return 0;
}

}  // extern "C"
