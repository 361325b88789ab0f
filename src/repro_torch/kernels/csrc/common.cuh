// Shared device code of the port's row kernels (ESC, SPA and BIN).
//
// A thread block (or, for short rows, a warp) owns one output row at a time
// and keeps the row's work in a workspace that starts with the row's
// product prefix (max_deg_a + 1 ints, 16-byte aligned); each kernel lays out
// the rest (ESC: keys and values to sort; SPA and BIN: a dense tile and its
// presence words, BIN also its binned pairs).  The workspace is dynamic
// shared memory when it fits the card's opt-in limit, else a slice of a
// global scratch buffer the wrapper allocates.  The same code addresses both
// through generic pointers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_SENTINEL 0x7fffffff
#define REPRO_FULL_MASK 0xffffffffu

// Every library exports these two next to its launcher: the message of a
// CUDA error code, and the card's opt-in dynamic shared memory per block.
#define REPRO_EXPORT_COMMON(name)                                            \
  extern "C" const char* name##_error_string(int e) {                        \
    return cudaGetErrorString(static_cast<cudaError_t>(e));                  \
  }                                                                          \
  extern "C" int name##_max_smem(int dev) {                                  \
    int v = 0;                                                               \
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,  \
                               dev) != cudaSuccess)                          \
      return -1;                                                             \
    return v;                                                                \
  }

__host__ __device__ inline long long repro_align16(long long x) {
  return (x + 15) & ~15LL;
}

__device__ inline int repro_next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Exclusive prefix sum of one int per thread across the block; *total gets
// the block-wide sum.  blockDim.x must be a multiple of 32.  Ends with a
// barrier, so it may be called again straight away.
__device__ inline int repro_block_exclusive_scan(int x, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(REPRO_FULL_MASK, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(REPRO_FULL_MASK, s, o);
      if (lane >= o) s += y;
    }
    if (lane < n_warps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int base = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[n_warps - 1];
  __syncthreads();
  return base + incl - x;
}

// Prefix of row r's intermediate products: prefix[j] = the products of A
// entries before j (each B row truncated to max_deg_b), prefix[deg] = n.  As
// in the JAX package, only the first max_deg_a entries of A's row and the
// first max_deg_b of each B row are read.  *start and *deg get the row's A
// slice (deg = 0 for a row id outside [0, m)), *flop Algorithm 1's count for
// the row: the sum of the (untruncated) lengths of the B rows it references.
// Returns n.  Ends with a barrier.
__device__ inline int repro_row_prefix(
    int r, const int* __restrict__ a_rpt, const int* __restrict__ a_col,
    const int* __restrict__ rownnz_b, int m, int k_rows, int max_deg_a,
    int max_deg_b, int* prefix, int* start_out, int* deg_out, int* flop) {
  __shared__ int s_n;
  int start = 0, deg = 0;
  if (r >= 0 && r < m) {
    start = a_rpt[r];
    deg = min(a_rpt[r + 1] - start, max_deg_a);
  }
  // every thread scans a contiguous chunk of A's row
  const int chunk = (deg + blockDim.x - 1) / blockDim.x;
  const int j0 = min(deg, static_cast<int>(threadIdx.x) * chunk);
  const int j1 = min(deg, j0 + chunk);
  int local = 0, local_flop = 0;
  for (int j = j0; j < j1; ++j) {
    const int k = a_col[start + j];
    const int db = (k >= 0 && k < k_rows) ? rownnz_b[k] : 0;
    local += min(db, max_deg_b);
    local_flop += db;
  }
  int n;
  int run = repro_block_exclusive_scan(local, &n);
  for (int j = j0; j < j1; ++j) {
    prefix[j] = run;
    const int k = a_col[start + j];
    const int db = (k >= 0 && k < k_rows) ? rownnz_b[k] : 0;
    run += min(db, max_deg_b);
  }
  int total_flop;
  repro_block_exclusive_scan(local_flop, &total_flop);
  if (threadIdx.x == 0) {
    prefix[deg] = n;
    s_n = n;
  }
  __syncthreads();
  *start_out = start;
  *deg_out = deg;
  *flop = total_flop;
  return s_n;
}

// Product p of the row (0 <= p < n): its B entry index, and in *j the A
// entry it comes from, the j with prefix[j] <= p < prefix[j+1], found by
// binary search on the prefix, so lanes stay busy whatever the B-row lengths.
__device__ inline int repro_product_entry(int p, int deg, const int* prefix,
                                          int start,
                                          const int* __restrict__ a_col,
                                          const int* __restrict__ b_rpt,
                                          int* j) {
  int lo = 0, hi = deg;  // invariant: prefix[lo] <= p < prefix[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (prefix[mid] <= p) lo = mid; else hi = mid;
  }
  *j = lo;
  return b_rpt[a_col[start + lo]] + (p - prefix[lo]);
}

// The row's product-column extent: *lo the smallest product column and *hi
// the largest, or REPRO_SENTINEL and -1 for a row without products.  B's rows
// are sorted ascending (validate_csr), so a B row's first and last read
// entries bound it: this costs the row's deg A entries, not a pass over its
// products.  *lo is the JAX package's extent_relative offset.  Ends with a
// barrier.
__device__ inline void repro_row_extent(int start, int deg,
                                        const int* __restrict__ a_col,
                                        const int* __restrict__ b_rpt,
                                        const int* __restrict__ b_col,
                                        const int* __restrict__ rownnz_b,
                                        int k_rows, int max_deg_b, int* lo,
                                        int* hi) {
  __shared__ int s_lo, s_hi;
  if (threadIdx.x == 0) {
    s_lo = REPRO_SENTINEL;
    s_hi = -1;
  }
  __syncthreads();
  int l = REPRO_SENTINEL, h = -1;
  for (int j = threadIdx.x; j < deg; j += blockDim.x) {
    const int k = a_col[start + j];
    const int len = (k >= 0 && k < k_rows) ? min(rownnz_b[k], max_deg_b) : 0;
    if (len > 0) {
      const int e = b_rpt[k];
      l = min(l, b_col[e]);
      h = max(h, b_col[e + len - 1]);
    }
  }
  if (h >= 0) {
    atomicMin(&s_lo, l);
    atomicMax(&s_hi, h);
  }
  __syncthreads();
  *lo = s_lo;
  *hi = s_hi;
  __syncthreads();  // the next row's call resets s_lo and s_hi
}

// Compact one dense accumulator tile: lane l (set when bit l&31 of
// pres[l>>5] is) goes, in ascending lane order, to output slot base + its
// rank among the set lanes, as column col0 + l with value acc[l], when that
// slot is below cap.  Returns the tile's count of set lanes (block-uniform),
// so a caller that walks tiles in column order keeps the true nnz past the
// capacity.  Ends with a barrier.
__device__ inline int repro_compact_tile(const float* acc,
                                         const unsigned* pres, int n_words,
                                         int base, int cap, int col0,
                                         int* __restrict__ out_col,
                                         float* __restrict__ out_val) {
  const int chunk = (n_words + blockDim.x - 1) / blockDim.x;
  const int w0 = min(n_words, static_cast<int>(threadIdx.x) * chunk);
  const int w1 = min(n_words, w0 + chunk);
  int local = 0;
  for (int w = w0; w < w1; ++w) local += __popc(pres[w]);
  int total;
  int slot = base + repro_block_exclusive_scan(local, &total);
  for (int w = w0; w < w1 && slot < cap; ++w) {
    unsigned bits = pres[w];
    while (bits && slot < cap) {
      const int l = (w << 5) + __ffs(bits) - 1;
      bits &= bits - 1;
      out_col[slot] = col0 + l;
      out_val[slot] = acc[l];
      ++slot;
    }
  }
  __syncthreads();
  return total;
}

// Sentinel and 0 in a row's slots [nnz, cap).
__device__ inline void repro_fill_tail(int nnz, int cap,
                                       int* __restrict__ out_col,
                                       float* __restrict__ out_val) {
  for (int s = min(nnz, cap) + threadIdx.x; s < cap; s += blockDim.x) {
    out_col[s] = REPRO_SENTINEL;
    out_val[s] = 0.0f;
  }
}

// A group of `size` consecutive lanes of one warp (a power of two, 32 at
// most) that works on one row together: `lane` is the thread's index in it
// and `mask` its lanes.  Every collective below takes the group; the
// default is the whole warp.
struct ReproGroup {
  int lane, size;
  unsigned mask;
};

__device__ inline ReproGroup repro_group(int size = 32) {
  const int lane = threadIdx.x & 31;
  return {lane & (size - 1), size,
          size == 32 ? REPRO_FULL_MASK
                     : ((1u << size) - 1u) << (lane & ~(size - 1))};
}

// Inclusive prefix sum of one int per lane across a group.
__device__ inline int repro_warp_inclusive_scan(int x,
                                                ReproGroup g = repro_group()) {
  for (int o = 1; o < g.size; o <<= 1) {
    const int y = __shfl_up_sync(g.mask, x, o, g.size);
    if (g.lane >= o) x += y;
  }
  return x;
}

// Exclusive prefix sum across a group; *total gets the group's sum.
__device__ inline int repro_warp_exclusive_scan(int x, int* total,
                                                ReproGroup g = repro_group()) {
  const int incl = repro_warp_inclusive_scan(x, g);
  *total = __shfl_sync(g.mask, incl, g.size - 1, g.size);
  return incl - x;
}

// One step of the sorting network on a group's keys: comparators t = lane,
// lane + size, ... below half, REPRO_SORT_ILP at a time with all their keys
// loaded before any is compared (a step's comparators touch disjoint pairs),
// so a lane keeps several shared-memory loads in flight.  flip: the step's
// pairs are (i, i ^ (2j - 1)) within blocks of 2j keys, else (i, i + j).
// VALS: vals follows the keys' permutation (else it is not read).
#define REPRO_SORT_ILP 4
template <bool VALS = true>
__device__ inline void repro_sort_step(int* keys, float* vals, int n,
                                       int half, int j, bool flip,
                                       ReproGroup g) {
  for (int t0 = g.lane; t0 < half; t0 += REPRO_SORT_ILP * g.size) {
    int i[REPRO_SORT_ILP], l[REPRO_SORT_ILP], ki[REPRO_SORT_ILP],
        kl[REPRO_SORT_ILP];
#pragma unroll
    for (int u = 0; u < REPRO_SORT_ILP; ++u) {
      const int t = t0 + u * g.size;
      const int o = t & (j - 1);
      i[u] = ((t - o) << 1) + o;
      l[u] = flip ? i[u] + 2 * (j - o) - 1 : i[u] + j;
      if (t >= half || l[u] >= n) l[u] = -1;
      if (l[u] >= 0) {
        ki[u] = keys[i[u]];
        kl[u] = keys[l[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < REPRO_SORT_ILP; ++u) {
      if (l[u] >= 0 && ki[u] > kl[u]) {
        keys[i[u]] = kl[u];
        keys[l[u]] = ki[u];
        if (VALS) {
          const float v = vals[i[u]];
          vals[i[u]] = vals[l[u]];
          vals[l[u]] = v;
        }
      }
    }
  }
}

// The bitonic network in its "flip" form over keys[0, n) for any n, by the
// group g (BLOCK: g is the whole block, and steps are separated by block
// barriers instead of syncs of the group's lanes).  Every comparator (i, l)
// has i < l and leaves the smaller key at i, so the positions [n,
// next_pow2(n)) stand for +inf and are never read or written, and the
// workspace holds exactly n keys.  Equal keys are never swapped: the output
// is a fixed function of the input.
template <bool VALS, bool BLOCK>
__device__ void repro_sort_network(int* keys, float* vals, int n,
                                   ReproGroup g) {
  const int n2 = repro_next_pow2(max(n, 1));
  const int half = n2 >> 1;
  for (int k = 2; k <= n2; k <<= 1) {
    if (BLOCK) __syncthreads(); else __syncwarp(g.mask);
    repro_sort_step<VALS>(keys, vals, n, half, k >> 1, true, g);
    for (int j = k >> 2; j > 0; j >>= 1) {
      if (BLOCK) __syncthreads(); else __syncwarp(g.mask);
      repro_sort_step<VALS>(keys, vals, n, half, j, false, g);
    }
  }
  if (BLOCK) __syncthreads(); else __syncwarp(g.mask);
}

// Ascending sort of keys[0, n) for any n by one group (by default a warp),
// carrying vals through the same permutation when VALS (the network of
// repro_sort_network).  Starts and ends with a sync of the group.
template <bool VALS = true>
__device__ void repro_warp_sort(int* keys, float* vals, int n,
                                ReproGroup g = repro_group()) {
  repro_sort_network<VALS, false>(keys, vals, n, g);
}

// The same sort by the whole block, every thread calling it: for rows too
// long for one warp.  Starts and ends with a block barrier.
template <bool VALS = true>
__device__ void repro_block_sort(int* keys, float* vals, int n) {
  repro_sort_network<VALS, true>(
      keys, vals, n,
      {static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x),
       REPRO_FULL_MASK});
}

// Distinct keys of sorted keys[0, n), to every lane of the warp.
__device__ inline int repro_warp_count_runs(const int* keys, int n) {
  int local = 0;
  for (int p = threadIdx.x & 31; p < n; p += 32)
    local += (p == 0 || keys[p] != keys[p - 1]) ? 1 : 0;
  return __reduce_add_sync(REPRO_FULL_MASK, local);
}

// Compress sorted keys[0, n) into a row's output slots, by one group (by
// default a warp): run s of equal keys, summed left to right (a fixed
// order), goes to slot base + s while that is below cap.  Returns the
// number of runs to every lane of the group.  Each lane owns a contiguous
// chunk of the pairs and sums the runs that start in it.
__device__ int repro_warp_emit_runs(const int* keys, const float* vals, int n,
                                    int base, int cap,
                                    int* __restrict__ col_row,
                                    float* __restrict__ val_row,
                                    ReproGroup g = repro_group()) {
  const int chunk = (n + g.size - 1) / g.size;
  const int p0 = min(n, g.lane * chunk);
  const int p1 = min(n, p0 + chunk);
  int local = 0;
  for (int p = p0; p < p1; ++p)
    local += (p == 0 || keys[p] != keys[p - 1]) ? 1 : 0;
  int runs;
  int slot = base + repro_warp_exclusive_scan(local, &runs, g);
  for (int p = p0; p < p1 && slot < cap; ++p) {
    if (p != 0 && keys[p] == keys[p - 1]) continue;
    float s = vals[p];
    for (int q = p + 1; q < n && keys[q] == keys[p]; ++q)
      s = __fadd_rn(s, vals[q]);
    col_row[slot] = keys[p];
    val_row[slot] = s;
    ++slot;
  }
  return runs;
}

// counts[0, len) -> their exclusive prefix sums in place, counts[len] = the
// total, which is returned to every thread.  Each thread scans a contiguous
// chunk.  Ends with a barrier.
__device__ inline int repro_block_offsets(int* counts, int len) {
  const int chunk = (len + blockDim.x - 1) / blockDim.x;
  const int b0 = min(len, static_cast<int>(threadIdx.x) * chunk);
  const int b1 = min(len, b0 + chunk);
  int local = 0;
  for (int b = b0; b < b1; ++b) local += counts[b];
  int total;
  int run = repro_block_exclusive_scan(local, &total);
  for (int b = b0; b < b1; ++b) {
    const int c = counts[b];
    counts[b] = run;
    run += c;
  }
  if (threadIdx.x == 0) counts[len] = total;
  __syncthreads();
  return total;
}

// Each of the row's deg A entries' B-row start (e0) and value (av), beside
// the prefix repro_row_prefix built, so a product's lookup
// (repro_product_at) reads shared memory only.  Ends with a barrier.
__device__ inline void repro_row_entries(int start, int deg,
                                         const int* __restrict__ a_col,
                                         const float* __restrict__ a_val,
                                         const int* __restrict__ b_rpt,
                                         int k_rows, int* e0, float* av) {
  for (int j = threadIdx.x; j < deg; j += blockDim.x) {
    const int k = a_col[start + j];
    e0[j] = (k >= 0 && k < k_rows) ? b_rpt[k] : 0;
    av[j] = a_val[start + j];
  }
  __syncthreads();
}

// Product p of the row: its B entry index, and in *a the A value it takes,
// by binary search on the prefix (prefix[lo] <= p < prefix[lo + 1]).
__device__ inline int repro_product_at(int p, int deg, const int* prefix,
                                       const int* e0, const float* av,
                                       float* a) {
  int lo = 0, hi = deg;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (prefix[mid] <= p) lo = mid; else hi = mid;
  }
  *a = av[lo];
  return e0[lo] + (p - prefix[lo]);
}

// Products a lane looks up and loads before its warp ranks them: a warp
// keeps REPRO_BATCH rounds of loads in flight.
#define REPRO_BATCH 4

// Stable partition of a row's n products (prefix, e0 and av built by
// repro_row_prefix and repro_row_entries) into bins by bin = (column - lo)
// >> sh; products in bins past `bins` are dropped.  The block's nw warps
// each take a contiguous slice of the products and count them per bin in
// their own row of hist (nw * bins ints) with __match_any_sync, no atomics;
// the counts scan into per-(bin, warp) cursors in (bin, warp) order; a
// second walk writes each product's (column, a_ik * b_kj) at its cursor plus
// its rank among its warp's lanes of the same bin.  So each bin holds its
// products in product order, whatever the timing: bin_start[b] is bin b's
// first pair and bin_start[bins] the products kept.  Ends with a barrier.
__device__ void repro_bin_partition(
    int n, int deg, const int* prefix, const int* e0, const float* av,
    const int* __restrict__ b_col, const float* __restrict__ b_val, int lo,
    int sh, int bins, int* hist, int* bin_start, int* pair_col,
    float* pair_val) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < nw * bins; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  int* my_hist = hist + w * bins;
  const int per = (n + nw - 1) / nw;
  const int p_lo = min(n, w * per), p_hi = min(n, p_lo + per);
  for (int p0 = p_lo; p0 < p_hi; p0 += 32 * REPRO_BATCH) {
    int key[REPRO_BATCH];
#pragma unroll
    for (int u = 0; u < REPRO_BATCH; ++u) {
      const int p = p0 + 32 * u + lane;
      key[u] = -1 - lane;                     // unique: counts nowhere
      if (p < p_hi) {
        float a;
        const int bin =
            (b_col[repro_product_at(p, deg, prefix, e0, av, &a)] - lo) >> sh;
        if (bin < bins) key[u] = bin;
      }
    }
#pragma unroll
    for (int u = 0; u < REPRO_BATCH; ++u) {
      const unsigned peers = __match_any_sync(REPRO_FULL_MASK, key[u]);
      if (key[u] >= 0 && lane == __ffs(peers) - 1)
        my_hist[key[u]] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
  // each bin's total, then the bins' starts, then the warps' cursors
  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    int run = 0;
    for (int v = 0; v < nw; ++v) {
      const int c = hist[v * bins + b];
      hist[v * bins + b] = run;
      run += c;
    }
    bin_start[b] = run;
  }
  __syncthreads();
  repro_block_offsets(bin_start, bins);
  for (int b = threadIdx.x; b < bins; b += blockDim.x)
    for (int v = 0; v < nw; ++v) hist[v * bins + b] += bin_start[b];
  __syncthreads();
  for (int p0 = p_lo; p0 < p_hi; p0 += 32 * REPRO_BATCH) {
    int key[REPRO_BATCH], c[REPRO_BATCH];
    float v[REPRO_BATCH];
#pragma unroll
    for (int u = 0; u < REPRO_BATCH; ++u) {
      const int p = p0 + 32 * u + lane;
      key[u] = -1 - lane;
      c[u] = 0;
      v[u] = 0.0f;
      if (p < p_hi) {
        float a;
        const int e = repro_product_at(p, deg, prefix, e0, av, &a);
        c[u] = b_col[e];
        if (((c[u] - lo) >> sh) < bins) {
          key[u] = (c[u] - lo) >> sh;
          v[u] = __fmul_rn(a, b_val[e]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < REPRO_BATCH; ++u) {
      const unsigned peers = __match_any_sync(REPRO_FULL_MASK, key[u]);
      if (key[u] >= 0) {
        const int pos = my_hist[key[u]] + __popc(peers & lt_mask);
        pair_col[pos] = c[u];
        pair_val[pos] = v[u];
      }
      __syncwarp();
      if (key[u] >= 0 && lane == __ffs(peers) - 1)
        my_hist[key[u]] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
}

// One warp reduces a bin's c pairs at pair_col/pair_val[s0, s0 + c), whose
// columns lie in [col0, col0 + 32 * tile_words), in its dense tile, 32
// pairs at a time in order (the lanes holding one column add their values in
// lane order, and the first of them adds the sum to the tile), then writes
// the bin's distinct columns, ascending, with their sums to the bin's first
// pair slots, clearing the tile as it goes.  Returns that count to every
// lane.
__device__ int repro_warp_bin_dense(int* pair_col, float* pair_val, int s0,
                                    int c, int col0, float* tile,
                                    unsigned* tile_pres, int tile_words) {
  const int lane = threadIdx.x & 31;
  for (int i0 = 0; i0 < c; i0 += 32) {
    const int i = i0 + lane;
    const int l = i < c ? pair_col[s0 + i] - col0 : -1 - lane;
    const unsigned peers = __match_any_sync(REPRO_FULL_MASK, l);
    if (i < c && lane == __ffs(peers) - 1) {
      float sum = pair_val[s0 + i];
      for (unsigned rest = peers & (peers - 1); rest; rest &= rest - 1)
        sum = __fadd_rn(sum, pair_val[s0 + i0 + __ffs(rest) - 1]);
      tile[l] = __fadd_rn(tile[l], sum);
      atomicOr(&tile_pres[l >> 5], 1u << (l & 31));
    }
    __syncwarp();
  }
  // compaction: lane L owns the tile's lanes [L * per, (L + 1) * per),
  // per = tile_words lanes (at most 32: tiles of at most 1,024 lanes)
  const int per = tile_words;
  const int first = lane * per;
  unsigned bits = per == 32 ? tile_pres[lane]
                            : (tile_pres[first >> 5] >> (first & 31)) &
                                  ((1u << per) - 1u);
  int d;
  int off = s0 + repro_warp_exclusive_scan(__popc(bits), &d);
  __syncwarp();
  if (lane * per % 32 == 0) tile_pres[first >> 5] = 0u;
  while (bits) {
    const int l = first + __ffs(bits) - 1;
    bits &= bits - 1;
    pair_col[off] = col0 + l;
    pair_val[off] = tile[l];
    tile[l] = 0.0f;
    ++off;
  }
  __syncwarp();
  return d;
}

// A lock over one global buffer shared by the blocks of a launch (the
// spill slice of rows past the launch's product bound): the whole block
// calls both; the holder is resident, so waiters always get it.
__device__ inline void repro_lock(int* lock) {
  if (threadIdx.x == 0) {
    while (atomicCAS(lock, 0, 1) != 0) __nanosleep(200);
    __threadfence();
  }
  __syncthreads();
}

__device__ inline void repro_unlock(int* lock) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicExch(lock, 0);
  }
}
