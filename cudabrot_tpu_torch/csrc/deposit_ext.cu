// Extended-precision (df32) replay kernels for Hopper (sm_90a): the fused
// replay-deposit, and the id-stream replay of the bigtiles route.
//
// Replaces the df32 device replay of the TPU engine,
// cudabrot_tpu/engines/pallas_engine.py _blocked_replay_ext, together with
// the scatter it feeds (cudabrot_tpu/ops/binning.py _pallas_scatter_kernel
// through scatter_ids). One thread per kept emission rebuilds c from its
// 24-bit grid indices exactly as the classify pass drew it, starts z at c,
// takes iters + 1 df32 steps and bins each new point as
// points_to_bin_ids_df does (df32 offset from the canvas minimum, times
// the rounded inverse pitch), adding it to the histogram with atomicAdd.
// No id stream is materialized, and the TPU version's block and chunk
// geometry has no counterpart. The on-canvas count is summed per warp and
// added to one uint64.
//
// Bound. Operations: ~120 f32 operations per replayed point (94 for the
// df32 step, 26 for the df32 bin offset and quantization) against the
// card's f32 rate; bytes are 12 per emission plus the histogram. Like the
// f32 replay (deposit.cu), long orbits are serial chains, one thread each,
// and the df32 step's chain is about ten times longer: when few long
// orbits are kept, their latency, not the operation rate, sets the time.
// Emissions arrive sorted by descending orbit length, so a warp's lanes
// run orbits of nearly equal length.
//
// Integer adds commute and the arithmetic rounds once per operation, so
// the histogram equals ops/binning.replay_deposit_ext_plain bitwise.
//
// cb_replay_ids_ext is the same orbit loop (classify_ext.cuh replay_ext_one)
// with the id sink: emission i writes the bin id of each of its iters + 1
// steps, or the sentinel width * height off the canvas, at off[i] + s of a
// flat int32 stream, which the bigtiles route sorts and counts
// (csrc/bigtiles.cu). Every slot is written exactly once, so no atomics;
// its ids are the fused kernel's bins exactly. It replaces the scan of
// pallas_engine.py _blocked_replay_ext that materializes the ids for the
// TPU's scatter. Bound: the same 121 operations per point, plus 4 bytes
// written per id.
#include <cuda_runtime.h>

#include "classify_ext.cuh"

namespace {

constexpr int kBlock = 256;

template <int FR>
__global__ void __launch_bounds__(kBlock)
    replay_deposit_ext_kernel(cb::ReplayExtArgs a, unsigned long long* hits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t local =
      i < a.k ? cb::replay_ext_one<FR>(a, i, cb::DepositSink{a.hist}) : 0u;
  cb::warp_sum_add(hits, local);
}

template <int FR>
__global__ void __launch_bounds__(kBlock)
    replay_ids_ext_kernel(cb::ReplayExtArgs a, const long long* off,
                          int32_t* ids, unsigned long long* hits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int32_t nbins = a.q.width * a.q.height;
  const uint32_t local =
      i < a.k ? cb::replay_ext_one<FR>(a, i, cb::IdSink{ids + off[i], nbins})
              : 0u;
  cb::warp_sum_add(hits, local);
}

template <int FR>
cudaError_t launch(const cb::ReplayExtArgs& a, unsigned long long* hits,
                   cudaStream_t stream) {
  const int grid = (a.k + kBlock - 1) / kBlock;
  replay_deposit_ext_kernel<FR><<<grid, kBlock, 0, stream>>>(a, hits);
  return cudaGetLastError();
}

template <int FR>
cudaError_t launch_ids(const cb::ReplayExtArgs& a, const long long* off,
                       int32_t* ids, unsigned long long* hits,
                       cudaStream_t stream) {
  const int grid = (a.k + kBlock - 1) / kBlock;
  replay_ids_ext_kernel<FR><<<grid, kBlock, 0, stream>>>(a, off, ids, hits);
  return cudaGetLastError();
}

}  // namespace

// Arguments as classify_ext.cuh replay_ext_args documents them; hits is
// one uint64 the kernel adds the on-canvas point count to. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int cb_replay_deposit_ext(const void* kr, const void* ki,
                                     const void* iters, void* hist,
                                     const int* iargs, const float* fargs,
                                     void* hits, void* stream) {
  const cb::ReplayExtArgs a =
      cb::replay_ext_args(kr, ki, iters, hist, iargs, fargs);
  if (a.k <= 0) return 0;
  auto* ph = static_cast<unsigned long long*>(hits);
  auto s = static_cast<cudaStream_t>(stream);
  switch (iargs[0]) {
    case cb::kBuddhabrot: return int(launch<cb::kBuddhabrot>(a, ph, s));
    case cb::kBurningShip: return int(launch<cb::kBurningShip>(a, ph, s));
    case cb::kAntiBuddhabrot:
      return int(launch<cb::kAntiBuddhabrot>(a, ph, s));
  }
  return int(cudaErrorInvalidValue);
}

// The id-stream replay: arguments as cb_replay_deposit_ext (hist unused);
// off: (k,) int64 first slot of each emission; ids: the int32 stream,
// off[k-1] + iters[k-1] + 1 slots. hits: one uint64 the kernel adds the
// on-canvas point count to. Returns the cudaError_t of the launch.
extern "C" int cb_replay_ids_ext(const void* kr, const void* ki,
                                 const void* iters, const void* off,
                                 void* ids, const int* iargs,
                                 const float* fargs, void* hits,
                                 void* stream) {
  const cb::ReplayExtArgs a =
      cb::replay_ext_args(kr, ki, iters, nullptr, iargs, fargs);
  if (a.k <= 0) return 0;
  const auto* po = static_cast<const long long*>(off);
  auto* pi = static_cast<int32_t*>(ids);
  auto* ph = static_cast<unsigned long long*>(hits);
  auto s = static_cast<cudaStream_t>(stream);
  switch (iargs[0]) {
    case cb::kBuddhabrot:
      return int(launch_ids<cb::kBuddhabrot>(a, po, pi, ph, s));
    case cb::kBurningShip:
      return int(launch_ids<cb::kBurningShip>(a, po, pi, ph, s));
    case cb::kAntiBuddhabrot:
      return int(launch_ids<cb::kAntiBuddhabrot>(a, po, pi, ph, s));
  }
  return int(cudaErrorInvalidValue);
}
