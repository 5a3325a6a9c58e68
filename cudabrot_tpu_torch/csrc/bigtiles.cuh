// Per-thread logic of the bigtiles deposit (bigtiles.cu), as
// __host__ __device__ functions: the kernel runs them on a chunk of the
// sorted id stream held in shared memory, and host_harness.cpp runs them in
// order over the same padded chunk so a CPU build can be held against the
// plain PyTorch version bitwise.
//
// A chunk of len sorted ids is split among kThreads threads, thread t
// taking the `per` consecutive positions [t * per, (t + 1) * per). A run of
// equal ids ends at position i when i is the chunk's last position or the
// next id differs; the thread holding that end adds the run's length to
// the id's histogram cell once. A run that starts in an earlier thread's
// positions gets its start from an exclusive max-scan of the threads' last
// run starts (position 0 always starts a run). Ids outside [0, nbins) -- the
// sentinel nbins that the sort carries to the end of the stream -- are
// dropped.
#pragma once

#include "orbit.cuh"

namespace cb {
namespace bigtiles {

constexpr int kThreads = 256;    // threads per block
constexpr int kMaxChunk = 8192;  // sorted ids per block, at most
// Shared-memory words of a padded chunk: one pad word per 32 ids.
constexpr int kSlots = kMaxChunk + kMaxChunk / 32;

// Shared-memory word of chunk position i. With per = 32, thread t reads
// its positions at words t * 33 + j: a different bank for every thread of
// a warp; the coalesced load writes consecutive words.
CB_HD int slot(int i) { return i + (i >> 5); }

// Position of the last run start in positions [lo, hi) of a padded chunk
// s, or -1 where none starts there.
CB_HD int last_run_start(const int32_t* s, int lo, int hi) {
  int last = -1;
  for (int i = lo; i < hi; ++i)
    if (i == 0 || s[slot(i)] != s[slot(i - 1)]) last = i;
  return last;
}

// Adds the length of every run that ends in positions [lo, hi) (hi <= len)
// to its id's cell. `start` is the position where the run holding lo
// began, used when lo does not start one.
CB_HD void deposit_runs(const int32_t* s, int lo, int hi, int len, int start,
                        uint32_t* hist, int32_t nbins) {
  for (int i = lo; i < hi; ++i) {
    const int32_t b = s[slot(i)];
    if (i == 0 || b != s[slot(i - 1)]) start = i;
    if ((i == len - 1 || b != s[slot(i + 1)]) && b >= 0 && b < nbins)
      deposit_add(hist + b, uint32_t(i - start + 1));
  }
}

}  // namespace bigtiles
}  // namespace cb
