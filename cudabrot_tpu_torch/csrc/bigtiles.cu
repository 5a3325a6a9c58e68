// The bigtiles deposit for Hopper (sm_90a): a sorted int32 id stream
// counted into a uint32 histogram too large for the L2.
//
// Replaces the TPU kernels cudabrot_tpu/ops/binning.py _bigtiles_kernel
// and _bigtiles_mxu_kernel (called by _bigtiles_pass, entries
// scatter_bigtiles_padded and scatter_bigtiles). The function is theirs,
// hist[id] += count for every id below nbins, not their block structure:
// the TPU streams (8192, 128) histogram tiles through VMEM, picked per
// chunk by scalar prefetch (pass A the chunk's first tile, pass B its
// last, an XLA scatter for the middle-tile residue), and its MXU variant
// deposits through one-hot matrix products. On this card blocks run in no
// order and global atomics are the scatter hardware, so one block counts
// one chunk of `chunk` (<= 8192) sorted ids: the chunk is loaded into
// shared memory with coalesced reads, each of 256 threads takes
// consecutive positions, finds the ends of the runs of equal ids there
// (bigtiles.cuh), and adds each run's length with one global atomicAdd. A
// run that crosses a chunk boundary is added in two parts, exactly, since
// integer adds commute; any order of the stream gives the same histogram,
// and sorting is what makes it fast: duplicate points collapse into one
// atomic, and consecutive blocks touch increasing address ranges of a
// histogram that does not fit in the L2.
//
// Bound: bytes. Each id is read once (4 bytes) and each run reads and
// writes its histogram word once (8 bytes): 4 n + 8 runs over the HBM rate.
#include <cuda_runtime.h>

#include "bigtiles.cuh"

namespace {

namespace bt = cb::bigtiles;

__global__ void __launch_bounds__(bt::kThreads)
    bigtiles_deposit_kernel(const int32_t* __restrict__ ids, long long n,
                            int chunk, uint32_t* hist, int32_t nbins) {
  __shared__ int32_t s[bt::kSlots];
  __shared__ int warp_last[bt::kThreads / 32];
  const long long base = (long long)blockIdx.x * chunk;
  const int len = n - base < chunk ? int(n - base) : chunk;
  for (int j = threadIdx.x; j < len; j += bt::kThreads)
    s[bt::slot(j)] = ids[base + j];
  __syncthreads();

  const int per = (chunk + bt::kThreads - 1) / bt::kThreads;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < len ? lo + per : len;  // empty where lo >= len
  // Exclusive max-scan of the threads' last run starts: where the run
  // holding a thread's first position began.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = bt::last_run_start(s, lo, hi);
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d && v > incl) incl = v;
  }
  if (lane == 31) warp_last[warp] = incl;
  __syncthreads();
  int start = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) start = -1;
  for (int w = 0; w < warp; ++w)
    if (warp_last[w] > start) start = warp_last[w];
  bt::deposit_runs(s, lo, hi, len, start, hist, nbins);
}

}  // namespace

// ids: n int32, sorted ascending for speed (any order gives the same
// histogram); chunk: ids per block, 1..8192. Ids outside [0, nbins) are
// dropped. Returns the cudaError_t of the launch (0 = launched).
extern "C" int cb_bigtiles_deposit(const void* ids, long long n, int chunk,
                                   void* hist, int nbins, void* stream) {
  if (n <= 0) return 0;
  if (chunk <= 0 || chunk > bt::kMaxChunk) return int(cudaErrorInvalidValue);
  const long long grid = (n + chunk - 1) / chunk;
  bigtiles_deposit_kernel<<<unsigned(grid), bt::kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), n, chunk,
      static_cast<uint32_t*>(hist), nbins);
  return int(cudaGetLastError());
}
