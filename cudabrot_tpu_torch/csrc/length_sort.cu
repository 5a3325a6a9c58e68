// The length sort for Hopper (sm_90a): every valid emission of a pass,
// longest orbit first, equal lengths in slot order (length_sort.cuh).
//
// Replaces no TPU kernel. The JAX engine's _classify_and_compact keeps at
// most the replay capacity of a pass's emissions through two XLA argsorts
// (a random key, then the length); the port ran them as PyTorch's 64-bit
// radix sorts (engines/cuda_engine.py compact), which it keeps where the
// capacity can drop emissions. Where the capacity holds every slot the
// random key drops nothing and decides only the order of equal lengths,
// which no output reads, so a pass needs only this sort: a stable
// counting sort on the bucket d = max_it - 1 - iters, in three launches.
//
//   1. length_sort_tiles_kernel: a block per tile of 2^lb slots gathers
//      the tile's valid emissions as keys (d << lb) | slot-in-tile into
//      shared memory, sorts them (a bitonic network; the keys are unique,
//      so the order is stable by slot), writes the sorted keys and counts
//      each bucket in them. It also zeroes the next kernel's look-back
//      words.
//   2. length_sort_offsets_kernel: a block per 32 buckets turns the
//      tile-by-bucket counts into offsets (bucket-major exclusive prefix
//      sums, in place): the sum of each bucket over the tiles, then a
//      single-pass scan over the blocks with decoupled look-back (blocks
//      take their place by a ticket, so a block waits only on blocks
//      already running), then the prefixes over the tiles. The last
//      block writes the count of valid emissions.
//   3. length_sort_scatter_kernel: a block per tile places its valid
//      emissions, copying each one's three words to its bucket's offset
//      plus its rank in the bucket: each sorted key at its bucket's offset
//      plus its place among the bucket's keys. The blocks then write the
//      tail (iters -1, c words 0) up to the slot count.
//
// Bound: bytes. The escape indices are read once to sort and the kept
// emissions' three words once to place, the batch written once: 4 n + 12
// kept + 12 n bytes (n slots), over the HBM rate.
#include <cuda_runtime.h>

#include "length_sort.cuh"

namespace {

namespace ls = cb::lsort;

struct Args {
  const uint32_t* emit_c;  // (chunks, 2, width) words
  const int32_t* emit_it;  // n
  int n, width, max_it, nb, lb;
  ls::Layout l;
  unsigned long long* status;  // l.blocks
  unsigned int* ticket;
  int32_t* tile_n;  // l.tiles
  int32_t* off;     // l.tiles x nb
  uint32_t* runs;   // n
  uint32_t* out_cr;  // n
  uint32_t* out_ci;  // n
  int32_t* out_it;   // n
  long long* n_valid;
};

__global__ void __launch_bounds__(ls::kThreads)
    length_sort_tiles_kernel(Args a) {
  extern __shared__ uint32_t s[];
  __shared__ int count;
  const int t = blockIdx.x, lane = threadIdx.x & 31;
  const int base = t << a.lb;
  const int len = min(1 << a.lb, a.n - base);
  int32_t* row = a.off + size_t(t) * a.nb;
  for (int j = t * blockDim.x + threadIdx.x; j <= a.l.blocks;
       j += gridDim.x * blockDim.x) {
    if (j < a.l.blocks)
      a.status[j] = 0;
    else
      *a.ticket = 0;
  }
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  for (int k0 = 0; k0 < len; k0 += blockDim.x) {
    const int k = k0 + threadIdx.x;
    const int32_t it = k < len ? a.emit_it[base + k] : -1;
    const unsigned m = __ballot_sync(0xffffffffu, it >= 0);
    int at = 0;
    if (lane == 0 && m) at = atomicAdd(&count, __popc(m));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (it >= 0)
      s[at + __popc(m & ((1u << lane) - 1))] =
          (uint32_t(ls::bucket(it, a.max_it, a.nb)) << a.lb) | uint32_t(k);
  }
  __syncthreads();
  const int nt = count;
  int p = 1;
  while (p < nt) p <<= 1;
  for (int i = nt + threadIdx.x; i < p; i += blockDim.x) s[i] = ls::kPad;
  __syncthreads();
  for (int k = 2; k <= p; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += blockDim.x)
        ls::bitonic_pair(s, k, j, i);
      __syncthreads();
    }
  for (int i = threadIdx.x; i < nt; i += blockDim.x) a.runs[base + i] = s[i];
  for (int b = threadIdx.x; b < a.nb; b += blockDim.x)
    row[b] = ls::bucket_count(s, nt, b, a.lb);
  if (threadIdx.x == 0) a.tile_n[t] = nt;
}

// Block blk's exclusive prefix over the blocks before it, given its own
// aggregate: status words hold (1 << 32 | aggregate) once a block has
// summed its buckets and (2 << 32 | inclusive prefix) once it knows its
// prefix; a block adds aggregates backwards up to the first inclusive one.
__device__ int look_back(unsigned long long* status, int blk, int agg) {
  constexpr unsigned long long kAgg = 1ull << 32, kIncl = 2ull << 32;
  if (blk == 0) {
    atomicExch(status, kIncl | unsigned(agg));
    return 0;
  }
  atomicExch(status + blk, kAgg | unsigned(agg));
  const volatile unsigned long long* st = status;
  int excl = 0;
  for (int k = blk - 1; k >= 0;) {
    const unsigned long long w = st[k];
    if ((w >> 32) == 0) continue;
    excl += int(w & 0xffffffffu);
    if ((w >> 32) == 2) break;
    --k;
  }
  atomicExch(status + blk, kIncl | unsigned(excl + agg));
  return excl;
}

__global__ void __launch_bounds__(ls::kScanCols* ls::kScanRows)
    length_sort_offsets_kernel(Args a) {
  __shared__ int part[ls::kScanRows][ls::kScanCols];
  __shared__ int total[ls::kScanCols];
  __shared__ int blk, prefix;
  if (threadIdx.x == 0) blk = int(atomicAdd(a.ticket, 1u));
  __syncthreads();
  const int c = threadIdx.x % ls::kScanCols, r = threadIdx.x / ls::kScanCols;
  const int b = blk * ls::kScanCols + c;
  const int per = (a.l.tiles + ls::kScanRows - 1) / ls::kScanRows;
  const int t0 = min(r * per, a.l.tiles), t1 = min(t0 + per, a.l.tiles);
  int sum = 0;
  if (b < a.nb)
    for (int t = t0; t < t1; ++t) sum += a.off[size_t(t) * a.nb + b];
  part[r][c] = sum;
  __syncthreads();
  int before = 0, col = 0;
  for (int q = 0; q < ls::kScanRows; ++q) {
    before += q < r ? part[q][c] : 0;
    col += part[q][c];
  }
  if (r == 0) total[c] = col;
  __syncthreads();
  int lower = 0, agg = 0;
  for (int q = 0; q < ls::kScanCols; ++q) {
    lower += q < c ? total[q] : 0;
    agg += total[q];
  }
  if (threadIdx.x == 0) prefix = look_back(a.status, blk, agg);
  __syncthreads();
  if (b < a.nb) {
    int run = prefix + lower + before;
    for (int t = t0; t < t1; ++t) {
      const size_t i = size_t(t) * a.nb + b;
      const int v = a.off[i];
      a.off[i] = run;
      run += v;
    }
  }
  if (blk == int(gridDim.x) - 1 && threadIdx.x == 0)
    *a.n_valid = prefix + agg;
}

__device__ void place(const Args& a, int pos, uint32_t slot) {
  a.out_cr[pos] = ls::emission_word(a.emit_c, slot, a.width, 0);
  a.out_ci[pos] = ls::emission_word(a.emit_c, slot, a.width, 1);
  a.out_it[pos] = a.emit_it[slot];
}

__global__ void __launch_bounds__(ls::kThreads)
    length_sort_scatter_kernel(Args a) {
  extern __shared__ uint32_t s[];
  const int t = blockIdx.x;
  const int base = t << a.lb;
  const int32_t* row = a.off + size_t(t) * a.nb;
  const int nt = a.tile_n[t];
  for (int i = threadIdx.x; i < nt; i += blockDim.x) s[i] = a.runs[base + i];
  __syncthreads();
  const uint32_t mask = (1u << a.lb) - 1;
  for (int i = threadIdx.x; i < nt; i += blockDim.x)
    place(a, ls::destination(s, nt, i, a.lb, row),
          uint32_t(base) + (s[i] & mask));
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = *a.n_valid + (long long)t * blockDim.x + threadIdx.x;
       q < a.n; q += stride) {
    a.out_cr[q] = 0;
    a.out_ci[q] = 0;
    a.out_it[q] = -1;
  }
}

}  // namespace

// The int32 scratch words cb_length_sort takes.
extern "C" long long cb_length_sort_words(int n, int nb, int lb) {
  return (long long)ls::layout(n, nb, lb).words;
}

// emit_c: (chunks, 2, width) float32 words and emit_it: (chunks, width)
// int32, n = chunks * width slots (n < 2^31); nb = max_it - min_it >= 1
// buckets with nb < 2^(32 - lb); lb in [5, 14]. scratch:
// cb_length_sort_words(n, nb, lb) int32 words; out: 3 x n int32 words
// (cr, ci, iters); n_valid: one int64. Returns the cudaError_t of the
// three launches (0 = launched).
extern "C" int cb_length_sort(const void* emit_c, const void* emit_it, int n,
                              int width, int max_it, int nb, int lb,
                              void* scratch, void* out, void* n_valid,
                              void* stream) {
  if (n <= 0 || width <= 0 || nb <= 0 || lb < 5 || lb > 14 ||
      (long long)nb >= (1ll << (32 - lb)))
    return int(cudaErrorInvalidValue);
  Args a;
  a.emit_c = static_cast<const uint32_t*>(emit_c);
  a.emit_it = static_cast<const int32_t*>(emit_it);
  a.n = n;
  a.width = width;
  a.max_it = max_it;
  a.nb = nb;
  a.lb = lb;
  a.l = ls::layout(n, nb, lb);
  int32_t* w = static_cast<int32_t*>(scratch);
  a.status = reinterpret_cast<unsigned long long*>(w + a.l.status);
  a.ticket = reinterpret_cast<unsigned int*>(w + a.l.ticket);
  a.tile_n = w + a.l.tile_n;
  a.off = w + a.l.off;
  a.runs = reinterpret_cast<uint32_t*>(w + a.l.runs);
  uint32_t* o = static_cast<uint32_t*>(out);
  a.out_cr = o;
  a.out_ci = o + n;
  a.out_it = reinterpret_cast<int32_t*>(o + 2 * size_t(n));
  a.n_valid = static_cast<long long*>(n_valid);
  // Shared memory: a tile's keys.
  const size_t smem = sizeof(uint32_t) << lb;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {  // beyond the default, per kernel
    e = cudaFuncSetAttribute(length_sort_tiles_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(length_sort_scatter_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (e != cudaSuccess) return int(e);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  length_sort_tiles_kernel<<<a.l.tiles, ls::kThreads, smem, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  length_sort_offsets_kernel<<<a.l.blocks, ls::kScanCols * ls::kScanRows, 0,
                               st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  length_sort_scatter_kernel<<<a.l.tiles, ls::kThreads, smem, st>>>(a);
  return int(cudaGetLastError());
}
