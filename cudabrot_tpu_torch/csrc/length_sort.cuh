// Tile logic of the length sort (length_sort.cu), as __host__ __device__
// functions: the kernels run them on a tile held in shared memory, and
// host_harness.cpp runs them in order over the same tiles, so a CPU build
// can be held against the plain PyTorch version bitwise.
//
// The length sort keeps every valid emission of a pass (escape index >= 0)
// and orders them by descending orbit length, equal lengths in ascending
// slot order. An emission's bucket is d = max_it - 1 - iters, clamped to
// [0, nb) with nb = max_it - min_it: 0 for the longest orbit the band
// holds. Slots are cut into tiles of T = 2^lb. A tile's valid emissions
// become the keys (d << lb) | (slot - tile start), unique within the tile,
// so sorting the keys orders the tile by bucket and, within a bucket, by
// slot. A tile's emissions of bucket d go to
//
//   off[tile][d] + (rank of the key among the tile's keys of bucket d),
//
// where off[tile][d] counts the emissions of every bucket below d in all
// tiles and of bucket d in the tiles before: the exclusive prefix sum of
// the tile-by-bucket counts taken bucket-major.
#pragma once

#include "orbit.cuh"

namespace cb {
namespace lsort {

constexpr int kThreads = 512;    // threads of a tile block
constexpr int kScanCols = 32;    // buckets of an offsets block
constexpr int kScanRows = 32;    // tile groups of an offsets block
constexpr uint32_t kPad = 0xFFFFFFFFu;  // above every key

// The bucket of a valid escape index.
CB_HD int bucket(int32_t iters, int32_t max_it, int nb) {
  const int d = (max_it - 1) - iters;
  return d < 0 ? 0 : (d >= nb ? nb - 1 : d);
}

// One compare-exchange of the bitonic network's stage (k, j), on pair i of
// the P / 2 pairs: ascending where bit k of the lower position is clear.
CB_HD void bitonic_pair(uint32_t* s, int k, int j, int i) {
  const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
  const int hi = lo + j;
  const uint32_t a = s[lo], b = s[hi];
  if ((a > b) == ((lo & k) == 0)) {
    s[lo] = b;
    s[hi] = a;
  }
}

// The first of the n ascending keys s that is >= x (n where none is).
CB_HD int lower_bound(const uint32_t* s, int n, uint32_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Keys of bucket b among the n sorted keys of a tile.
CB_HD int bucket_count(const uint32_t* s, int n, int b, int lb) {
  return lower_bound(s, n, uint32_t(b + 1) << lb) -
         lower_bound(s, n, uint32_t(b) << lb);
}

// Where sorted key i of a tile goes: its bucket's offset in the tile's
// row of off, plus its rank among the tile's keys of that bucket.
CB_HD int destination(const uint32_t* s, int n, int i, int lb,
                      const int32_t* off_row) {
  const int b = int(s[i] >> lb);
  return off_row[b] + (i - lower_bound(s, n, uint32_t(b) << lb));
}

// The word of emission plane p (0 the real part, 1 the imaginary) of a
// slot: the emission buffers are (chunks, 2, width) words.
CB_HD uint32_t emission_word(const uint32_t* emit_c, uint32_t slot,
                             uint32_t width, int p) {
  const uint32_t chunk = slot / width;
  return emit_c[(size_t(chunk) * 2 + p) * width + (slot - chunk * width)];
}

// The scratch words of a sort of n slots into nb buckets with tiles of
// 2^lb slots, as the kernels lay them out: the offsets blocks' status
// words (two each) and ticket (two), each tile's key count, the tile-by-
// bucket counts (then offsets), and the tiles' sorted keys.
struct Layout {
  int tiles, blocks;
  size_t status, ticket, tile_n, off, runs, words;
};

CB_HD Layout layout(int n, int nb, int lb) {
  Layout l;
  l.tiles = int((size_t(n) + (size_t(1) << lb) - 1) >> lb);
  l.blocks = (nb + kScanCols - 1) / kScanCols;
  l.status = 0;
  l.ticket = 2 * size_t(l.blocks);
  l.tile_n = l.ticket + 2;
  l.off = l.tile_n + l.tiles;
  l.runs = l.off + size_t(l.tiles) * nb;
  l.words = l.runs + size_t(n);
  return l;
}

}  // namespace lsort
}  // namespace cb
