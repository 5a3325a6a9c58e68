// Per-thread logic of the pass counters (pass_counters_kernel in
// classify.cu), as __host__ __device__ functions: the kernel's threads run
// them on their share of the inputs, and host_harness.cpp runs them for
// every thread of the grid in turn, so a CPU build can be held against the
// plain PyTorch version (ops/pass_counters.pass_counters_plain) bitwise.
//
// A pass adds to the render's int64 totals: the sums of classify's five
// int32 stat rows (samples, culled, in_band, cycles, wasted), the useful
// classify iterations (the pass's lane-steps less the wasted sum), the
// kept and dropped emissions (min(n_valid, capacity) and the rest) and the
// orbit points of the kept batch (iters + 1 over the slots with iters >=
// 0). Each thread sums its share of a row or of the batch into 64 bits;
// integer adds commute modulo 2^64, so any split of the sums gives the
// totals bit for bit.
//
// A thread's share of an int32 array of n elements, thread t of T: the
// elements before the first 16-byte boundary (head, at most 3) one each to
// threads 0..; then the whole 4-word vectors, v = t, t + T, ...; then the
// words past the last vector (tail, at most 3) one each to threads 0...
#pragma once

#include "orbit.cuh"

namespace cb {
namespace counters {

constexpr int kThreads = 512;  // threads of a block
constexpr int kRows = 5;       // classify's stat rows (ops/classify.py)
// The totals, in the order the launcher takes their pointers.
enum Total {
  kSamples, kCulled, kInBand, kCycles, kWasted, kIters, kEmitted, kDropped,
  kPoints, kTotals
};

#ifdef __CUDACC__
using Word4 = int4;
#else
struct alignas(16) Word4 {
  int32_t x, y, z, w;
};
#endif

// The batch slots counted: the kept prefix min(n_valid, capacity, n). Every
// batch the counters get holds its kept emissions there and -1 after them
// (the hybrid split's device batch adds -1 holes inside the prefix only).
CB_HD long long batch_bound(long long n, long long n_valid,
                            long long capacity) {
  long long k = n_valid < capacity ? n_valid : capacity;
  k = k < n ? k : n;
  return k > 0 ? k : 0;
}

// The kept emissions of a pass: n_valid clamped to the replay capacity.
CB_HD long long emitted(long long n_valid, long long capacity) {
  return n_valid < capacity ? n_valid : capacity;
}

struct Word {
  CB_HD long long operator()(int32_t v) const { return v; }
};

// A slot's orbit points: iters + 1 (an int32 add, as the plain version's)
// where iters >= 0, else 0.
struct Points {
  CB_HD long long operator()(int32_t it) const {
    return it >= 0 ? (long long)int32_t(uint32_t(it) + 1u) : 0;
  }
};

// Elements before the first 16-byte boundary of p (4-byte aligned), at
// most n.
CB_HD long long head_words(const int32_t* p, long long n) {
  const long long h = (long long)((16 - (uintptr_t(p) & 15)) & 15) >> 2;
  return h < n ? h : n;
}

// Thread t of T's share of f over the n int32 words at p.
template <class F>
CB_HD long long share_sum(const int32_t* p, long long n, long long t,
                          long long T, F f) {
  long long s = 0;
  const long long h = head_words(p, n);
  if (t < h) s += f(p[t]);
  const Word4* v = reinterpret_cast<const Word4*>(p + h);
  const long long nv = (n - h) >> 2;
#ifdef __CUDA_ARCH__
#pragma unroll 8
#endif
  for (long long i = t; i < nv; i += T) {
    const Word4 q = v[i];
    s += f(q.x) + f(q.y) + f(q.z) + f(q.w);
  }
  const long long r = h + (nv << 2);
  if (t < n - r) s += f(p[r + t]);
  return s;
}

// Thread t of T's sums: the five stat rows (width words each, row-major)
// into s[0..kRows), the batch's points over its first k slots into
// s[kRows].
CB_HD void thread_sums(const int32_t* stats, long long width,
                       const int32_t* iters, long long k, long long t,
                       long long T, long long* s) {
  for (int r = 0; r < kRows; ++r)
    s[r] = share_sum(stats + r * width, width, t, T, Word());
  s[kRows] = k > 0 ? share_sum(iters, k, t, T, Points()) : 0;
}

// What block b adds to each total from its threads' sums (sum[0..kRows]):
// the stat rows, the points, the wasted sum taken from the iterations, and
// from block 0 alone the pass's lane-steps and the kept and dropped
// emissions. add[kTotals].
CB_HD void block_adds(int b, const long long* sum, long long n_valid,
                      long long capacity, long long steps, long long* add) {
  for (int r = 0; r < kRows; ++r) add[r] = sum[r];
  add[kIters] = (b == 0 ? steps : 0) - sum[kWasted];
  const long long e = emitted(n_valid, capacity);
  add[kEmitted] = b == 0 ? e : 0;
  add[kDropped] = b == 0 ? n_valid - e : 0;
  add[kPoints] = sum[kRows];
}

}  // namespace counters
}  // namespace cb
