// Histogram deposit kernels for Hopper (sm_90a).
//
// Replace the TPU deposit kernel cudabrot_tpu/ops/binning.py
// _pallas_scatter_kernel (called by _pallas_scatter_call, entry
// scatter_pallas) and, fused with it, the XLA replay loop that feeds it
// (engines/pallas_engine.py _batched_replay / _blocked_replay).
//
//  * cb_deposit_ids: the exact function of scatter_pallas — count a flat
//    int32 id stream into a uint32 histogram; ids outside [0, nbins) (the
//    sentinel nbins) are dropped. One global atomicAdd per id.
//  * cb_replay_deposit: what the render's main path runs. One thread per
//    compacted emission (c, iters): z starts at c, steps s = 0..iters are
//    recorded including the escape point, each on-canvas point binned
//    (points_to_bin_ids, strict rounding) and added with atomicAdd straight
//    into the global histogram. The TPU path materializes up to 2^27 ids
//    per pass (~512 MB) and streams them through its scatter; here no id
//    ever reaches device memory, and one kernel serves every band length.
//
// Bound. The deposit is a random read-modify-write per orbit point: the
// floor is the atomic throughput of the L2 (a 1000^2 uint32 histogram is
// 4 MB and stays in the 50 MB L2), not the bytes the function must move
// (its inputs are read once). The replay's f32 work is ~13 operations per
// point. Emissions arrive sorted by descending orbit length, so the lanes
// of a warp run orbits of nearly equal length. Integer adds commute, so
// the histogram equals the plain PyTorch versions (ops/binning.py)
// bitwise whatever the order of the atomics.
#include <cuda_runtime.h>

#include "orbit.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
    deposit_ids_kernel(const int32_t* ids, long long n, uint32_t* hist,
                       int32_t nbins) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t b = ids[i];
    if (b >= 0 && b < nbins) atomicAdd(hist + b, 1u);
  }
}

// Adds a per-thread count to *dst with one atomic per warp. Every thread
// of the warp must reach it (the kernel never returns early).
__device__ __forceinline__ void warp_sum_add(unsigned long long* dst,
                                             uint32_t v) {
#if defined(__CUDA_ARCH__)
  const uint32_t s = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && s != 0) atomicAdd(dst, (unsigned long long)s);
#else
  if (v != 0) atomicAdd(dst, (unsigned long long)v);
#endif
}

template <int FR>
__global__ void __launch_bounds__(kBlock)
    replay_deposit_kernel(const float* cr, const float* ci,
                          const int32_t* iters, int k, uint32_t* hist,
                          cb::CanvasQ q, unsigned long long* hits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t local = 0;
  const int n = i < k ? iters[i] : -1;
  if (n >= 0) {
    const float c_r = cr[i], c_i = ci[i];
    float zr = c_r, zi = c_i;  // z starts at c (cudabrot.cu:323-324)
    for (int s = 0; s <= n; ++s) {
      cb::step<FR>(zr, zi, c_r, c_i);
      const long long b = cb::bin_id(q, zr, zi);
      if (b >= 0) {
        atomicAdd(hist + b, 1u);
        ++local;
      }
    }
  }
  warp_sum_add(hits, local);
}

template <int FR>
cudaError_t launch_replay(const float* cr, const float* ci,
                          const int32_t* iters, int k, uint32_t* hist,
                          const cb::CanvasQ& q, unsigned long long* hits,
                          cudaStream_t stream) {
  const int grid = (k + kBlock - 1) / kBlock;
  replay_deposit_kernel<FR><<<grid, kBlock, 0, stream>>>(cr, ci, iters, k,
                                                          hist, q, hits);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = launched).
extern "C" int cb_deposit_ids(const void* ids, long long n, void* hist,
                              int nbins, void* stream) {
  if (n <= 0) return 0;
  long long grid = (n + kBlock - 1) / kBlock;
  if (grid > 132 * 64) grid = 132 * 64;  // grid-stride beyond this
  deposit_ids_kernel<<<int(grid), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), n, static_cast<uint32_t*>(hist),
      nbins);
  return int(cudaGetLastError());
}

// hits: one uint64 the kernel adds the on-canvas point count to.
extern "C" int cb_replay_deposit(int fractal, const void* cr, const void* ci,
                                 const void* iters, int k, void* hist,
                                 float min_re, float min_im, float d_re,
                                 float d_im, int width, int height,
                                 void* hits, void* stream) {
  if (k <= 0) return 0;
  const cb::CanvasQ q{min_re, min_im, d_re, d_im, width, height};
  const auto* pcr = static_cast<const float*>(cr);
  const auto* pci = static_cast<const float*>(ci);
  const auto* pit = static_cast<const int32_t*>(iters);
  auto* ph = static_cast<uint32_t*>(hist);
  auto* phits = static_cast<unsigned long long*>(hits);
  auto s = static_cast<cudaStream_t>(stream);
  switch (fractal) {
    case cb::kBuddhabrot:
      return int(launch_replay<cb::kBuddhabrot>(pcr, pci, pit, k, ph, q,
                                                 phits, s));
    case cb::kBurningShip:
      return int(launch_replay<cb::kBurningShip>(pcr, pci, pit, k, ph, q,
                                                  phits, s));
    case cb::kAntiBuddhabrot:
      return int(launch_replay<cb::kAntiBuddhabrot>(pcr, pci, pit, k, ph, q,
                                                     phits, s));
  }
  return int(cudaErrorInvalidValue);
}
