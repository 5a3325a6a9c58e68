// Extended-precision (df32) replay kernels for Hopper (sm_90a): the fused
// replay-deposit, and the id-stream replay of the bigtiles route.
//
// Replaces the df32 device replay of the TPU engine,
// cudabrot_tpu/engines/pallas_engine.py _blocked_replay_ext, together with
// the scatter it feeds (cudabrot_tpu/ops/binning.py _pallas_scatter_kernel
// through scatter_ids). Each kept emission is replayed by one thread: c is
// rebuilt from its 24-bit grid indices exactly as the classify pass drew
// it, z starts at c, iters + 1 df32 steps are taken and each new point is
// binned as points_to_bin_ids_df does (df32 offset from the canvas
// minimum, times the rounded inverse pitch). The fused kernel adds every
// on-canvas point to the histogram with atomicAdd; no id stream is
// materialized, and the TPU version's block and chunk geometry has no
// counterpart. The on-canvas count is summed per warp and added to one
// uint64.
//
// Bound. Operations: ~121 f32 operations per replayed point (94 for the
// df32 step, 27 for the df32 bin offset and quantization); built with
// -fmad=false, each is one issued instruction, so the card's unfused
// issue rate (128 lanes per clock per SM) is the floor. Bytes: 12 per
// emission plus the histogram. But an orbit is a serial chain of about 29
// dependent operations per step, one thread each: at the deep zoom the
// batch holds ~130,000 orbits of ~1,000 points, its longest ~20,000 steps,
// and the longest orbit's chain, not the operation rate, sets the time.
//
// Layout. The batch arrives sorted by descending orbit length, and the
// card's warps work through it as a queue: each resident warp takes the
// next group of 32 consecutive emissions (a warp of nearly equal orbits)
// from a global counter, replays it, and takes another. The launch puts
// REPLAY_EXT_WARPS_PER_SM warps on each SM in blocks of four (one per SM
// sub-partition, that is per warp scheduler), so the longest groups start
// first, each on a scheduler of its own, and the shorter groups fill the
// other warps as they free up: the longest orbit's chain runs with as few
// warps competing for its scheduler's issue slots as the launch allows.
//
// Integer adds commute and the arithmetic rounds once per operation, so
// any mapping of emissions to threads gives the histogram of
// ops/binning.replay_deposit_ext_plain, bitwise.
//
// cb_replay_ids_ext is the same queue and orbit loop (classify_ext.cuh
// replay_ext_one) with the on-canvas id sink (orbit.cuh CanvasIdSink):
// emission i writes the bin id of each on-canvas step s at off[i] + s of a
// flat int32 stream that the wrapper filled with the sentinel
// row_count * width beforehand (width * height for a whole canvas), so the
// stream equals, word for word, the one a store per point (orbit.cuh
// IdSink) writes, and the bigtiles route sorts and counts it
// (csrc/bigtiles.cu). At the deep zoom 99.3% of the points are off the
// canvas: they cost no store. Every slot is written at
// most once, so no atomics. It replaces the scan of pallas_engine.py
// _blocked_replay_ext that materializes the ids for the TPU's scatter.
// Bound: the same 121 operations per point, plus 4 bytes per id for the
// fill and 4 per on-canvas id.
#include <cuda_runtime.h>

#include <type_traits>

#include "classify_ext.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;  // one warp per SM sub-partition
constexpr int kBlock = 32 * kWarpsPerBlock;

// The queue: each warp takes the next group of 32 emissions until none is
// left; sink_of(i) is emission i's sink. The group index is broadcast from
// lane 0, so the loop's exit is warp-uniform and every lane reaches the
// warp sum. The lanes replay their orbits in step, for the group's longest
// orbit; a lane past the batch's end runs the group's first emission and
// records nothing (n = -1). W: the row window's instantiation of the
// binning (df32.cuh bin_id_df).
template <int FR, bool W, class SinkOf>
__device__ __forceinline__ void replay_queue(const cb::ReplayExtArgs& a,
                                             unsigned long long* next,
                                             unsigned long long* hits,
                                             const SinkOf& sink_of) {
  const int lane = threadIdx.x & 31;
  const unsigned long long groups = (unsigned long long)(a.k + 31) / 32;
  uint32_t local = 0;
  for (;;) {
    unsigned long long g = 0;
    if (lane == 0) g = atomicAdd(next, 1ull);
    g = __shfl_sync(0xffffffffu, g, 0);
    if (g >= groups) break;
    const int i = int(g) * 32 + lane;
    const int e = i < a.k ? i : int(g) * 32;
    const int n = i < a.k ? a.iters[i] : -1;
    const int steps = __reduce_max_sync(0xffffffffu, n) + 1;
    if (steps > 0)
      local += cb::replay_ext_one<FR, W>(a, e, n, steps, sink_of(e));
  }
  cb::warp_sum_add(hits, local);
}

template <int FR, bool W>
__global__ void __launch_bounds__(kBlock)
    replay_deposit_ext_kernel(cb::ReplayExtArgs a, unsigned long long* next,
                              unsigned long long* hits) {
  replay_queue<FR, W>(a, next, hits,
                      [&](int) { return cb::DepositSink{a.hist}; });
}

template <int FR, bool W>
__global__ void __launch_bounds__(kBlock)
    replay_ids_ext_kernel(cb::ReplayExtArgs a, const long long* off,
                          int32_t* ids, unsigned long long* next,
                          unsigned long long* hits) {
  replay_queue<FR, W>(a, next, hits,
                      [&](int i) { return cb::CanvasIdSink{ids + off[i]}; });
}

// Blocks of the launch: `warps` resident warps (iargs[4]), no more than
// the batch has groups of 32.
int blocks(const cb::ReplayExtArgs& a, int warps) {
  const int groups = (a.k + 31) / 32;
  const int w = warps < groups ? warps : groups;
  return (w + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

// Calls launch(fr, w) with the fractal's and the window's instantiation
// tags (std::integral_constant): w false for the whole canvas, true for a
// shard's row window (df32.cuh bin_id_df).
template <class Launch>
cudaError_t dispatch(const cb::ReplayExtArgs& a, int fractal,
                     const Launch& launch) {
  auto by_window = [&](auto fr) {
    return cb::df::is_window(a.q) ? launch(fr, std::true_type())
                                  : launch(fr, std::false_type());
  };
  switch (fractal) {
    case cb::kBuddhabrot:
      return by_window(std::integral_constant<int, cb::kBuddhabrot>());
    case cb::kBurningShip:
      return by_window(std::integral_constant<int, cb::kBurningShip>());
    case cb::kAntiBuddhabrot:
      return by_window(std::integral_constant<int, cb::kAntiBuddhabrot>());
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Arguments as classify_ext.cuh replay_ext_args documents them (iargs[4]:
// the resident warps to launch; iargs[5], iargs[6]: the histogram's row
// window, whose row_count * width cells hist holds). next: one zeroed
// uint64, the queue's counter; hits: one uint64 the kernel adds the count
// of points deposited into the histogram to. Returns the cudaError_t of the
// launch (0 = launched).
extern "C" int cb_replay_deposit_ext(const void* kr, const void* ki,
                                     const void* iters, void* hist,
                                     const int* iargs, const float* fargs,
                                     void* next, void* hits, void* stream) {
  const cb::ReplayExtArgs a =
      cb::replay_ext_args(kr, ki, iters, hist, iargs, fargs);
  if (a.k <= 0) return 0;
  if (iargs[4] <= 0 || a.q.row_count < 0) return int(cudaErrorInvalidValue);
  auto* pn = static_cast<unsigned long long*>(next);
  auto* ph = static_cast<unsigned long long*>(hits);
  auto s = static_cast<cudaStream_t>(stream);
  return int(dispatch(a, iargs[0], [&](auto fr, auto w) {
    replay_deposit_ext_kernel<decltype(fr)::value, decltype(w)::value>
        <<<blocks(a, iargs[4]), kBlock, 0, s>>>(a, pn, ph);
    return cudaGetLastError();
  }));
}

// The id-stream replay: arguments as cb_replay_deposit_ext (hist unused);
// off: (k,) int64 first slot of each emission; ids: the int32 stream,
// off[k-1] + iters[k-1] + 1 slots, filled with the sentinel
// row_count * width (the kernel writes only the window's ids). Returns the
// cudaError_t of the launch.
extern "C" int cb_replay_ids_ext(const void* kr, const void* ki,
                                 const void* iters, const void* off,
                                 void* ids, const int* iargs,
                                 const float* fargs, void* next, void* hits,
                                 void* stream) {
  const cb::ReplayExtArgs a =
      cb::replay_ext_args(kr, ki, iters, nullptr, iargs, fargs);
  if (a.k <= 0) return 0;
  if (iargs[4] <= 0 || a.q.row_count < 0) return int(cudaErrorInvalidValue);
  const auto* po = static_cast<const long long*>(off);
  auto* pi = static_cast<int32_t*>(ids);
  auto* pn = static_cast<unsigned long long*>(next);
  auto* ph = static_cast<unsigned long long*>(hits);
  auto s = static_cast<cudaStream_t>(stream);
  return int(dispatch(a, iargs[0], [&](auto fr, auto w) {
    replay_ids_ext_kernel<decltype(fr)::value, decltype(w)::value>
        <<<blocks(a, iargs[4]), kBlock, 0, s>>>(a, po, pi, pn, ph);
    return cudaGetLastError();
  }));
}
