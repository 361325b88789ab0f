// Algorithm 2 on the SPA and BIN routes (bitmask symbolic) for sampled
// rows: per sampled row its distinct product columns z and its FLOP, in one
// kernel behind one launcher that serves three callers:
//
//   * every SPA and BIN sample of a binned prediction in one launch, each
//     at its own bucket's bounds (a per-sample table: row, deg_a, deg_b,
//     n_words, output slot), the FLOP of each written to its slot;
//   * one bucket's sampled rows at its bounds (the per-bucket entry).
//     Replaces: src/repro/kernels/accumulator.py::
//     fused_flop_symbolic_bitmask_pallas (_fused_bitmask_kernel);
//   * the sampled rows at the global bounds, with no FLOP output.
//     Replaces: src/repro/kernels/accumulator.py::bitmask_symbolic_pallas
//     (_bitmask_kernel).
//
// The exact-symbolic fallback of the re-planning loop (DESIGN.md §9) takes
// the first way over every row of an offending SPA or BIN bucket, not a
// sample, and asks for each row's own count: z_out, one int a row at its
// output slot, zeroed by the launcher and added to by each unit that counts
// part of the row (a block row's warps add their shares).  The mode is a
// template parameter (kRowCounts), so the prediction's instantiations
// carry no code of it: with z_out null the launcher runs those.
//
// Both TPU kernels (via _symbolic_call) OR every gathered product column's
// bit into n_words = ceil(min(span, ncols_b)/32) uint32 words addressed
// relative to the row's smallest product column, and popcount; a column
// whose relative lane falls past 32 * n_words is not counted.  z* is the
// sum of the rows' counts and f* the sum of their FLOP (the referenced B
// rows' untruncated lengths); both go to two totals by integer atomics, so
// they are exact in any order and no reduction runs after the kernel.
//
// What held the parent design back on the H100: a launch per SPA or BIN
// bucket, each with its own host work, and a block of up to 512 threads
// for every sampled row with three block barriers, however short the row.
// Design:
//   * Long rows take a block each: the table's first n_long rows (the host
//     put first those whose min(FLOP, deg_a * deg_b) passes BMS_WARP_MAX),
//     or at one pair of bounds every row, when deg_a * deg_b passes it.
//     The block builds the row's product prefix and B-row starts in a
//     table, so a product's column is one load after a search on chip;
//     each thread steps BMS_BATCH searches together, so their loads are in
//     flight at once.  The mask lies in shared memory, or in the block's
//     slice of global scratch where the words its bucket allows do not fit.
//     A row the block finds to have at most BMS_WARP_KEYS products is
//     counted by its first warp alone, by a match of its keys.
//   * Every other row takes a warp of a group block, up to BMS_WARPS rows
//     a block.  The warp counts the row's products, FLOP and column extent
//     from its A entries and each referenced B row's first and last entry
//     (B's rows are sorted) and keeps the row if it fits a warp: at most
//     BMS_WARP_KEYS products (a key a lane, one or two rounds, counted by a
//     match), or at most BMS_WARP_MAX products in an extent of at most
//     BMS_WARP_WORDS words (presence bits in registers for up to
//     BMS_REG_WORDS words, else in the warp's shared memory).  Otherwise
//     (more than BMS_WARP_KEYS A entries, or more products, or a wider
//     extent) the warp hands the row to its block, which counts it as a
//     long row once every warp is done.  A sort or a hash set of a wide
//     short row's keys measured 2-15 us a row on the H100; the block ~2.
//   * Which unit takes a row is decided by its own products, counted on
//     the card; at one pair of bounds the host sorts and reads back
//     nothing.
//   * Lanes take neighbouring products, whose columns mostly share a word
//     on banded and FEM rows: an extent of at most BMS_REG_WORDS words is
//     ORed in registers; a wider mask gets one atomicOr per run of lanes
//     with a common word.  An atomicOr's old value says which bits were
//     new, so a sparse mask is counted as its bits are set, with no pass
//     over its words.
//   * Warp sizes are compile-time constants, so no shuffle or sync carries
//     a lane mask known only at run time.
//
// Bound on the H100: bytes.  Every product column is read once from B
// (4 bytes each), plus A's row slice and B's row pointers and lengths; the
// masks stay on chip but for a bucket whose words pass shared memory
// (past ~1.8 M columns).
#include "common.cuh"

// _build.py reads these from here to size the launch
#define BMS_WARPS 16        // rows a group block takes, a warp each
#define BMS_THREADS (BMS_WARPS * 32)
#define BMS_WARP_MAX 256    // most products a warp takes
#define BMS_WARP_WORDS 512  // mask words a warp holds (16,384 columns)
#define BMS_WARP_KEYS 64    // most products a warp counts by match
#define BMS_REG_WORDS 8     // an extent of at most this many words is
                            // ORed in each lane's registers
#define BMS_BATCH 4         // product loads a lane keeps in flight
// a warp's shared memory: 32 staged product offsets and B-row starts, then
// its mask words or its keys
#define BMS_WARP_BYTES (256 + 4 * BMS_WARP_WORDS)

struct BmsRow {
  int r, da, db, nw, out;
};

// Sample ri: from the table when row_da is given, else at the launch's
// bounds and in place.
__device__ __forceinline__ BmsRow bms_row(int ri, const int* rows,
                                          const int* row_da,
                                          const int* row_db,
                                          const int* row_nw,
                                          const int* out_idx, int da, int db,
                                          int nw) {
  if (row_da) return {rows[ri], row_da[ri], row_db[ri], row_nw[ri],
                      out_idx[ri]};
  return {rows[ri], da, db, nw, ri};
}

// One lane's product at word w of the mask (w < 0: none) with bit `bit`;
// every lane of the warp calls it.  Where runs of lanes share a word, the
// lanes of each run OR their bits together (a segmented scan by doubling:
// a lane takes the bits of the lane o above it when their words are equal,
// so a run's first lane ends with the whole run's) and each run's first
// lane makes one atomicOr for it; otherwise each lane ORs its own bit.
// With kCount it returns, to the lane that ORed, the bits no earlier OR
// had set.
template <bool kCount>
__device__ __forceinline__ int bms_warp_or(unsigned* mask, int w,
                                           unsigned bit) {
  const int lane = threadIdx.x & 31;
  const int up = __shfl_up_sync(REPRO_FULL_MASK, w, 1);
  const bool head = w >= 0 && (lane == 0 || up != w);
  unsigned agg = bit;
  if (!__all_sync(REPRO_FULL_MASK, w < 0 || head)) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned ob = __shfl_down_sync(REPRO_FULL_MASK, agg, o);
      const int ow = __shfl_down_sync(REPRO_FULL_MASK, w, o);
      if (ow == w) agg |= ob;
    }
  }
  if (!head) return 0;
  if (kCount) return __popc(agg & ~atomicOr(&mask[w], agg));
  atomicOr(&mask[w], agg);
  return 0;
}

// Sets bit (rel & 31) of word rel >> 5 of a lane's BMS_REG_WORDS register
// words; the words stay in registers because every index is a constant.
__device__ __forceinline__ void bms_reg_or(unsigned (&reg)[BMS_REG_WORDS],
                                           int rel) {
  const int w = rel >> 5;
  const unsigned bit = 1u << (rel & 31);
#pragma unroll
  for (int t = 0; t < BMS_REG_WORDS; ++t)
    if (w == t) reg[t] |= bit;
}

// The distinct columns among a row's n <= BMS_WARP_KEYS keys, a key a
// lane in one or two rounds (k0 the first 32 keys, k1 the rest; a lane
// without a key holds a negative value of its own), that lie in the row's
// nw words from lo: a key counts where it is the first lane of its round
// to hold it and, in the second round, no lane of the first holds it.
// Every lane of the warp calls it and gets the count.
__device__ __forceinline__ int bms_match_count(int k0, int k1, int n, int lo,
                                               int nw) {
  const int lane = threadIdx.x & 31;
  const bool first0 =
      lane == __ffs(__match_any_sync(REPRO_FULL_MASK, k0)) - 1;
  bool first1 = lane == __ffs(__match_any_sync(REPRO_FULL_MASK, k1)) - 1;
  if (n > 32) {
#pragma unroll
    for (int s = 0; s < 32; ++s)
      if (__shfl_sync(REPRO_FULL_MASK, k0, s) == k1) first1 = false;
  }
  return __popc(__ballot_sync(REPRO_FULL_MASK,
                              lane < n && first0 && ((k0 - lo) >> 5) < nw)) +
         __popc(__ballot_sync(REPRO_FULL_MASK, 32 + lane < n && first1 &&
                                                   ((k1 - lo) >> 5) < nw));
}

// Every product of a short row by one warp: its deg A entries staged 32 at
// a time (each one's product offset and B-row start in s_off/s_e0), then
// each lane takes products 32 apart, BMS_BATCH loads in flight.  visit(p,
// column, ok) is called by every lane together (ok false where a lane has
// no product), so it may use the warp's collectives.
template <typename Visit>
__device__ __forceinline__ void bms_warp_walk(
    int start, int deg, int db, const int* __restrict__ a_col,
    const int* __restrict__ b_rpt, const int* __restrict__ b_col,
    const int* __restrict__ rownnz_b, int k_rows, int* s_off, int* s_e0,
    Visit visit) {
  const int lane = threadIdx.x & 31;
  int base = 0;   // the products of the chunks before this one
  for (int j0 = 0; j0 < deg; j0 += 32) {
    const int j = j0 + lane;
    int len = 0, e0 = 0;
    if (j < deg) {
      const int k = a_col[start + j];
      if (k >= 0 && k < k_rows) {
        len = min(rownnz_b[k], db);
        e0 = b_rpt[k];
      }
    }
    int total;
    const int off = repro_warp_exclusive_scan(len, &total);
    __syncwarp();   // the previous chunk is done with the staging
    s_off[lane] = off;
    s_e0[lane] = e0;
    __syncwarp();
    for (int p0 = 0; p0 < total; p0 += 32 * BMS_BATCH) {
      int c[BMS_BATCH];
#pragma unroll
      for (int u = 0; u < BMS_BATCH; ++u) {
        const int p = p0 + 32 * u + lane;
        c[u] = 0;
        if (p < total) {
          int l = 0, h = 32;   // s_off[l] <= p < s_off[h] (s_off[32]: total)
#pragma unroll
          for (int s = 0; s < 5; ++s) {
            const int mid = (l + h) >> 1;
            if (s_off[mid] <= p) l = mid; else h = mid;
          }
          c[u] = b_col[s_e0[l] + (p - s_off[l])];
        }
      }
#pragma unroll
      for (int u = 0; u < BMS_BATCH; ++u) {
        const int p = p0 + 32 * u + lane;
        visit(base + p, c[u], p < total);
      }
    }
    base += total;
  }
}

// A row by one warp (every lane calls it; s_off/s_e0 staging, region its
// keys or mask words), if the row fits a warp: returns false, having
// counted nothing, for a row its block is to count.
template <bool kRowCounts>
__device__ __forceinline__ bool bms_warp_row(
    BmsRow row, const int* __restrict__ a_rpt, const int* __restrict__ a_col,
    const int* __restrict__ b_rpt, const int* __restrict__ b_col,
    const int* __restrict__ rownnz_b, int m, int k_rows, int* s_off,
    int* s_e0, int* region, int* totals, int* flop_out, int* z_out) {
  const int lane = threadIdx.x & 31;
  int start = 0, deg = 0;
  if (row.r >= 0 && row.r < m) {
    start = a_rpt[row.r];
    deg = min(a_rpt[row.r + 1] - start, row.da);
  }
  // a row of more A entries than a warp takes keys is its block's; else
  // the row's products and FLOP (a lane takes entries lane and lane + 32),
  // and, for a row that fits a warp, its column extent [lo, hi] from the
  // first and last entry of each referenced B row (B's rows are sorted)
  if (deg > BMS_WARP_KEYS) return false;
  int len[2] = {0, 0}, e[2] = {0, 0}, flop = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    const int k = j < deg ? a_col[start + j] : -1;
    if (k >= 0 && k < k_rows) {
      const int full = rownnz_b[k];
      len[h] = min(full, row.db);
      e[h] = b_rpt[k];
      flop += full;
    }
  }
  const int n = __reduce_add_sync(REPRO_FULL_MASK, len[0] + len[1]);
  if (n > BMS_WARP_MAX) return false;
  flop = __reduce_add_sync(REPRO_FULL_MASK, flop);
  int lo = REPRO_SENTINEL, hi = -1;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (len[h] > 0) {
      lo = min(lo, b_col[e[h]]);
      hi = max(hi, b_col[e[h] + len[h] - 1]);
    }
  lo = __reduce_min_sync(REPRO_FULL_MASK, lo);
  hi = __reduce_max_sync(REPRO_FULL_MASK, hi);
  const int used = n ? min(row.nw, ((hi - lo) >> 5) + 1) : 0;
  if (n > BMS_WARP_KEYS && used > BMS_WARP_WORDS) return false;
  int z = 0;
  if (n > 0 && n <= BMS_WARP_KEYS) {
    // a key a lane, one or two rounds
    bms_warp_walk(start, deg, row.db, a_col, b_rpt, b_col, rownnz_b,
                  k_rows, s_off, s_e0, [&](int p, int c, bool ok) {
      if (ok) region[p] = c;
    });
    __syncwarp();
    z = bms_match_count(lane < n ? region[lane] : -1 - lane,
                        32 + lane < n ? region[32 + lane] : -33 - lane, n,
                        lo, row.nw);
    if (lane) z = 0;    // counted once, in the final sum
    __syncwarp();   // the next row rewrites the keys
  } else if (n > 0 && used <= BMS_REG_WORDS) {
    // a narrow extent: each lane ORs its products into register words,
    // and the warp ORs those together once
    unsigned reg[BMS_REG_WORDS] = {};
    bms_warp_walk(start, deg, row.db, a_col, b_rpt, b_col, rownnz_b,
                  k_rows, s_off, s_e0, [&](int, int c, bool ok) {
      if (ok && ((c - lo) >> 5) < used) bms_reg_or(reg, c - lo);
    });
#pragma unroll
    for (int t = 0; t < BMS_REG_WORDS; ++t)
      z += __popc(__reduce_or_sync(REPRO_FULL_MASK, reg[t]));
    if (lane) z = 0;    // counted once, in the final sum
  } else if (n > 0) {
    // presence bits in the warp's words, counted by a popcount pass when
    // the row has at least as many products as words, else as they are set
    unsigned* mask = reinterpret_cast<unsigned*>(region);
    for (int w = lane; w < used; w += 32) mask[w] = 0u;
    __syncwarp();
    const bool count = used > n;
    bms_warp_walk(start, deg, row.db, a_col, b_rpt, b_col, rownnz_b,
                  k_rows, s_off, s_e0, [&](int, int c, bool ok) {
      int w = -1 - lane;
      unsigned bit = 0u;
      if (ok && ((c - lo) >> 5) < used) {
        w = (c - lo) >> 5;
        bit = 1u << ((c - lo) & 31);
      }
      if (count) z += bms_warp_or<true>(mask, w, bit);
      else bms_warp_or<false>(mask, w, bit);
    });
    __syncwarp();
    if (!count)
      for (int w = lane; w < used; w += 32) z += __popc(mask[w]);
    __syncwarp();   // the next row clears the words
  }
  z = __reduce_add_sync(REPRO_FULL_MASK, z);
  if (lane == 0) {
    if (z) atomicAdd(&totals[0], z);
    if (flop) atomicAdd(&totals[1], flop);
    if (flop_out) flop_out[row.out] = flop;
    if (kRowCounts) z_out[row.out] = z;
  }
  return true;
}

// The columns of a long row's products p0 + 32u + lane (u < BMS_BATCH),
// -1 past its n products: product p's column is one load after finding its
// A entry, the last l < deg with prefix[l] <= p (B-row start e0[l]).  The
// BMS_BATCH searches step together from `top`, the largest power of two
// up to deg, so their shared-memory loads, and then their column loads,
// are in flight at once.
__device__ __forceinline__ void bms_block_gather(
    int p0, int n, int deg, int top, const int* prefix, const int* e0,
    const int* __restrict__ b_col, int (&c)[BMS_BATCH]) {
  const int lane = threadIdx.x & 31;
  int l[BMS_BATCH];
#pragma unroll
  for (int u = 0; u < BMS_BATCH; ++u) l[u] = 0;
  for (int step = top; step > 0; step >>= 1) {
#pragma unroll
    for (int u = 0; u < BMS_BATCH; ++u) {
      const int cand = l[u] + step;
      if (cand < deg && prefix[cand] <= p0 + 32 * u + lane) l[u] = cand;
    }
  }
#pragma unroll
  for (int u = 0; u < BMS_BATCH; ++u) {
    const int p = p0 + 32 * u + lane;
    c[u] = p < n ? b_col[e0[l[u]] + (p - prefix[l[u]])] : -1;
  }
}

// The OR pass of a long row over its n products by the whole block: each
// warp takes 32 * BMS_BATCH consecutive products at a time, so its lanes
// mostly hit neighbouring words.  Bits whose word is at or past `used` are
// dropped.  Returns the lane's count of new bits (with kCount).
template <bool kCount>
__device__ __forceinline__ int bms_block_or(int n, int deg, int top,
                                            const int* prefix,
                                            const int* e0,
                                            const int* __restrict__ b_col,
                                            int lo, int used,
                                            unsigned* mask) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int z = 0;
  for (int p0 = warp * 32 * BMS_BATCH; p0 < n;
       p0 += BMS_THREADS * BMS_BATCH) {
    int c[BMS_BATCH];
    bms_block_gather(p0, n, deg, top, prefix, e0, b_col, c);
#pragma unroll
    for (int u = 0; u < BMS_BATCH; ++u) {
      int w = -1 - lane;
      unsigned bit = 0u;
      if (c[u] >= 0 && ((c[u] - lo) >> 5) < used) {
        w = (c[u] - lo) >> 5;
        bit = 1u << ((c[u] - lo) & 31);
      }
      z += bms_warp_or<kCount>(mask, w, bit);
    }
  }
  return z;
}

// A long row's distinct columns in its mask of `used` words (shared memory
// with kShared, else the block's slice): an extent of at most
// BMS_REG_WORDS words in registers; else the mask cleared, ORed, and
// counted by a popcount pass where the row has at least as many products
// as words, by the ORs' old values where it has fewer.  Returns the
// thread's share.  Ends with no barrier.
template <bool kShared>
__device__ __forceinline__ int bms_block_count(int n, int deg,
                                               const int* prefix,
                                               const int* e0,
                                               const int* __restrict__ b_col,
                                               int lo, int used,
                                               unsigned* mask) {
  const int top = deg ? 1 << (31 - __clz(deg)) : 0;
  if (used <= BMS_REG_WORDS) {
    // register words in each lane, ORed across the warp, then into the
    // block's words in shared memory
    __shared__ unsigned s_reg[BMS_REG_WORDS];
    if (threadIdx.x < BMS_REG_WORDS) s_reg[threadIdx.x] = 0u;
    __syncthreads();
    unsigned reg[BMS_REG_WORDS] = {};
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int p0 = warp * 32 * BMS_BATCH; p0 < n;
         p0 += BMS_THREADS * BMS_BATCH) {
      int c[BMS_BATCH];
      bms_block_gather(p0, n, deg, top, prefix, e0, b_col, c);
#pragma unroll
      for (int u = 0; u < BMS_BATCH; ++u)
        if (c[u] >= 0 && ((c[u] - lo) >> 5) < used)
          bms_reg_or(reg, c[u] - lo);
    }
#pragma unroll
    for (int t = 0; t < BMS_REG_WORDS; ++t) {
      const unsigned v = __reduce_or_sync(REPRO_FULL_MASK, reg[t]);
      if (lane == t && v) atomicOr(&s_reg[t], v);
    }
    __syncthreads();
    return threadIdx.x < BMS_REG_WORDS ? __popc(s_reg[threadIdx.x]) : 0;
  }
  for (int w = threadIdx.x; w < used; w += BMS_THREADS) mask[w] = 0u;
  __syncthreads();
  if (used > n)
    return bms_block_or<true>(n, deg, top, prefix, e0, b_col, lo, used,
                              mask);
  bms_block_or<false>(n, deg, top, prefix, e0, b_col, lo, used, mask);
  __syncthreads();
  int z = 0;
  for (int w = threadIdx.x; w < used; w += BMS_THREADS)
    z += __popc(kShared ? mask[w] : __ldcg(&mask[w]));
  return z;
}

// The block's totals of a row from one value a thread: each thread's
// exclusive prefix of n_loc, and the sums of n_loc and flop_loc and the
// min and max of lo_loc and hi_loc.  One barrier.
__device__ __forceinline__ void bms_block_totals(int n_loc, int flop_loc,
                                                 int lo_loc, int hi_loc,
                                                 int* n_before, int* n,
                                                 int* flop, int* lo,
                                                 int* hi) {
  __shared__ int red[4][BMS_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = repro_warp_inclusive_scan(n_loc);
  const int wf = __reduce_add_sync(REPRO_FULL_MASK, flop_loc);
  const int wl = __reduce_min_sync(REPRO_FULL_MASK, lo_loc);
  const int wh = __reduce_max_sync(REPRO_FULL_MASK, hi_loc);
  if (lane == 31) red[0][warp] = incl;
  if (lane == 0) {
    red[1][warp] = wf;
    red[2][warp] = wl;
    red[3][warp] = wh;
  }
  __syncthreads();
  int before = 0, tn = 0, tf = 0, tl = REPRO_SENTINEL, th = -1;
#pragma unroll
  for (int v = 0; v < BMS_WARPS; ++v) {
    const int x = red[0][v];
    if (v < warp) before += x;
    tn += x;
    tf += red[1][v];
    tl = min(tl, red[2][v]);
    th = max(th, red[3][v]);
  }
  *n_before = before + incl - n_loc;
  *n = tn;
  *flop = tf;
  *lo = tl;
  *hi = th;
}

// One row by the whole block, every thread calling it.  The block's
// workspace: the table (product prefix, then each A entry's B-row start,
// table_deg_a + 1 entries each) and then the mask, in shared memory with
// kTableSmem (smem_words mask words there), else both in the block's
// slice; a row whose words pass smem_words ORs into the slice.  Ends with
// a barrier, so the next row may rewrite the workspace.
template <bool kTableSmem, bool kRowCounts>
__device__ __forceinline__ void bms_block_row(
    BmsRow row, int table_deg_a, const int* __restrict__ a_rpt,
    const int* __restrict__ a_col, const int* __restrict__ b_rpt,
    const int* __restrict__ b_col, const int* __restrict__ rownnz_b, int m,
    int k_rows, int smem_words, char* smem, char* slice, int* totals,
    int* flop_out, int* z_out) {
  const long long pre_bytes = repro_align16(4LL * (table_deg_a + 1));
  int* prefix = reinterpret_cast<int*>(kTableSmem ? smem : slice);
  int* e0 = prefix + pre_bytes / 4;
  int start = 0, deg = 0;
  if (row.r >= 0 && row.r < m) {
    start = a_rpt[row.r];
    deg = min(a_rpt[row.r + 1] - start, row.da);
  }
  // every thread takes a contiguous chunk of the row's A entries
  const int chunk = (deg + BMS_THREADS - 1) / BMS_THREADS;
  const int j0 = min(deg, static_cast<int>(threadIdx.x) * chunk);
  const int j1 = min(deg, j0 + chunk);
  int n_loc = 0, flop_loc = 0, lo_loc = REPRO_SENTINEL, hi_loc = -1;
  for (int j = j0; j < j1; ++j) {
    const int k = a_col[start + j];
    if (k >= 0 && k < k_rows) {
      const int full = rownnz_b[k];
      const int len = min(full, row.db);
      flop_loc += full;
      n_loc += len;
      if (len > 0) {
        const int e = b_rpt[k];
        lo_loc = min(lo_loc, b_col[e]);
        hi_loc = max(hi_loc, b_col[e + len - 1]);
      }
    }
  }
  int run, n, flop, lo, hi;
  bms_block_totals(n_loc, flop_loc, lo_loc, hi_loc, &run, &n, &flop, &lo,
                   &hi);
  for (int j = j0; j < j1; ++j) {
    const int k = a_col[start + j];
    const bool ok = k >= 0 && k < k_rows;
    prefix[j] = run;
    e0[j] = ok ? b_rpt[k] : 0;
    run += ok ? min(rownnz_b[k], row.db) : 0;
  }
  const int used = n ? min(row.nw, ((hi - lo) >> 5) + 1) : 0;
  if (n <= BMS_WARP_KEYS) {
    // a row a warp takes: the block's first warp counts its keys by match
    __syncthreads();   // the table is written
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int top = deg ? 1 << (31 - __clz(deg)) : 0;
      int c[BMS_BATCH];
      bms_block_gather(0, n, deg, top, prefix, e0, b_col, c);
      const int z = n ? bms_match_count(c[0] >= 0 ? c[0] : -1 - lane,
                                        c[1] >= 0 ? c[1] : -33 - lane, n,
                                        lo, row.nw)
                      : 0;
      if (threadIdx.x == 0) {
        if (z) atomicAdd(&totals[0], z);
        if (flop) atomicAdd(&totals[1], flop);
        if (flop_out) flop_out[row.out] = flop;
        if (kRowCounts) z_out[row.out] = z;
      }
    }
    __syncthreads();   // the next row rewrites the table
    return;
  }
  int z;
  if (kTableSmem && used <= smem_words)
    z = bms_block_count<true>(
        n, deg, prefix, e0, b_col, lo, used,
        reinterpret_cast<unsigned*>(smem + 2 * pre_bytes));
  else
    z = bms_block_count<false>(
        n, deg, prefix, e0, b_col, lo, used,
        reinterpret_cast<unsigned*>(slice + (kTableSmem ? 0
                                                        : 2 * pre_bytes)));
  z = __reduce_add_sync(REPRO_FULL_MASK, z);
  if ((threadIdx.x & 31) == 0 && z) {
    atomicAdd(&totals[0], z);
    if (kRowCounts) atomicAdd(&z_out[row.out], z);
  }
  if (threadIdx.x == 0) {
    if (flop) atomicAdd(&totals[1], flop);
    if (flop_out) flop_out[row.out] = flop;
  }
  __syncthreads();   // the next row rewrites the table and the mask
}

// rows, row_da, row_db, row_nw, out_idx: the samples (row_da null: every
// row at max_deg_a, max_deg_b and n_words, in place).  The first n_long
// are long rows, taken by the first long_blocks blocks, a row each,
// looping; the rest go in groups of warp_rows consecutive samples to the
// next group_blocks blocks, looping over the groups: a warp a row, then
// the whole block for each row its warp handed back.
template <bool kTableSmem, bool kRowCounts>
__device__ __forceinline__ void bms_blocks(
    const int* rows, const int* row_da, const int* row_db, const int* row_nw,
    const int* out_idx, int n_rows, int n_long, int long_blocks,
    int warp_rows, int group_blocks, int max_deg_a, int max_deg_b,
    int n_words, int table_deg_a, const int* __restrict__ a_rpt,
    const int* __restrict__ a_col, const int* __restrict__ b_rpt,
    const int* __restrict__ b_col, const int* __restrict__ rownnz_b, int m,
    int k_rows, int smem_words, char* smem, char* slice, int* totals,
    int* flop_out, int* z_out) {
  const auto row_of = [&](int ri) {
    return bms_row(ri, rows, row_da, row_db, row_nw, out_idx, max_deg_a,
                   max_deg_b, n_words);
  };
  const int b = blockIdx.x;
  if (b < long_blocks) {
    for (int ri = b; ri < n_long; ri += long_blocks)
      bms_block_row<kTableSmem, kRowCounts>(
          row_of(ri), table_deg_a, a_rpt, a_col, b_rpt, b_col, rownnz_b, m,
          k_rows, smem_words, smem, slice, totals, flop_out, z_out);
    return;
  }
  __shared__ int handed[BMS_WARPS];
  const int w = threadIdx.x >> 5;
  const int n_groups = (n_rows - n_long + warp_rows - 1) / warp_rows;
  char* region = smem + w * BMS_WARP_BYTES;
  for (int g = b - long_blocks; g < n_groups; g += group_blocks) {
    const int ri = n_long + g * warp_rows + w;
    bool kept = true;
    if (w < warp_rows && ri < n_rows)
      kept = bms_warp_row<kRowCounts>(
          row_of(ri), a_rpt, a_col, b_rpt, b_col, rownnz_b, m, k_rows,
          reinterpret_cast<int*>(region),
          reinterpret_cast<int*>(region) + 32,
          reinterpret_cast<int*>(region + 256), totals, flop_out, z_out);
    if ((threadIdx.x & 31) == 0) handed[w] = kept ? -1 : ri;
    __syncthreads();   // the warps are done with their regions
    for (int v = 0; v < warp_rows; ++v)
      if (handed[v] >= 0)
        bms_block_row<kTableSmem, kRowCounts>(
            row_of(handed[v]), table_deg_a, a_rpt, a_col, b_rpt, b_col,
            rownnz_b, m, k_rows, smem_words, smem, slice, totals, flop_out,
            z_out);
    __syncthreads();   // the next group rewrites `handed` and the regions
  }
}

// kMinBlocks: the blocks an SM must hold at once, which caps the registers
// a thread may take (64 for two, 40 for three); kRowCounts: the per-row
// count mode (z_out written)
template <int kMinBlocks, bool kRowCounts>
__global__ void __launch_bounds__(BMS_THREADS, kMinBlocks)
bitmask_symbolic_kernel(
    const int* __restrict__ rows, const int* __restrict__ row_da,
    const int* __restrict__ row_db, const int* __restrict__ row_nw,
    const int* __restrict__ out_idx, int n_rows, int n_long,
    int long_blocks, int warp_rows, int group_blocks, int max_deg_a,
    int max_deg_b, int n_words, int table_deg_a,
    const int* __restrict__ a_rpt, const int* __restrict__ a_col,
    const int* __restrict__ b_rpt, const int* __restrict__ b_col,
    const int* __restrict__ rownnz_b, int m, int k_rows, int smem_words,
    char* scratch, long long slice_bytes, int* __restrict__ totals,
    int* __restrict__ flop_out, int* __restrict__ z_out) {
  extern __shared__ __align__(16) char smem[];
  char* slice = scratch ? scratch + blockIdx.x * slice_bytes : nullptr;
  if (smem_words >= 0)
    bms_blocks<true, kRowCounts>(
        rows, row_da, row_db, row_nw, out_idx, n_rows, n_long, long_blocks,
        warp_rows, group_blocks, max_deg_a, max_deg_b, n_words, table_deg_a,
        a_rpt, a_col, b_rpt, b_col, rownnz_b, m, k_rows, smem_words, smem,
        slice, totals, flop_out, z_out);
  else
    bms_blocks<false, kRowCounts>(
        rows, row_da, row_db, row_nw, out_idx, n_rows, n_long, long_blocks,
        warp_rows, group_blocks, max_deg_a, max_deg_b, n_words, table_deg_a,
        a_rpt, a_col, b_rpt, b_col, rownnz_b, m, k_rows, smem_words, smem,
        slice, totals, flop_out, z_out);
}

// Shared memory above the 48 KB default needs the attribute: set once per
// device for every instantiation, to the card's opt-in limit less the
// kernel's static shared memory, so no later call sets it again; *sms gets
// the card's SM count.
template <int kMinBlocks, bool kRowCounts>
static cudaError_t bms_smem_attr_one(int limit) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(
      &attr, bitmask_symbolic_kernel<kMinBlocks, kRowCounts>);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      bitmask_symbolic_kernel<kMinBlocks, kRowCounts>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      limit - static_cast<int>(attr.sharedSizeBytes));
}

static cudaError_t bms_device_setup(int device, int* sms) {
  static int done[64], sm_count[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!done[device]) {
    int limit = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sm_count[device],
                                   cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = bms_smem_attr_one<2, false>(limit);
    if (err == cudaSuccess) err = bms_smem_attr_one<3, false>(limit);
    if (err == cudaSuccess) err = bms_smem_attr_one<2, true>(limit);
    if (err == cudaSuccess) err = bms_smem_attr_one<3, true>(limit);
    if (err != cudaSuccess) return err;
    done[device] = 1;
  }
  *sms = sm_count[device];
  return cudaSuccess;
}

// The samples and their blocks as bitmask_symbolic_kernel takes them;
// table_deg_a bounds every sample's deg_a (it sizes the block's table).
// totals (2 ints, zeroed here) gets z* and f*; flop_out (one int a sample,
// in the slots of out_idx, or null) each row's FLOP, and z_out (the same,
// zeroed here when not null) each row's distinct columns.  scratch: one slice
// of slice_bytes a block (null when no row needs one).
extern "C" int bitmask_symbolic_launch(
    const void* rows, const void* row_da, const void* row_db,
    const void* row_nw, const void* out_idx, int n_rows, int n_long,
    int long_blocks, int warp_rows, int group_blocks, int max_deg_a,
    int max_deg_b, int n_words, int table_deg_a, const void* a_rpt,
    const void* a_col, const void* b_rpt, const void* b_col,
    const void* rownnz_b, int m, int k_rows, int smem_words, void* scratch,
    long long slice_bytes, int smem_bytes, void* totals, void* flop_out,
    void* z_out, int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (warp_rows < 1 || warp_rows > BMS_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  err = bms_device_setup(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(totals, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (z_out) {
    err = cudaMemsetAsync(z_out, 0, static_cast<size_t>(n_rows) * sizeof(int),
                          s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = long_blocks + group_blocks;
  if (grid <= 0) return 0;
  // a grid that two blocks an SM would not hold at once runs the
  // instantiation that holds three, with fewer registers a thread
  const bool three = grid > 2 * sms;
  auto kernel = z_out ? (three ? bitmask_symbolic_kernel<3, true>
                               : bitmask_symbolic_kernel<2, true>)
                      : (three ? bitmask_symbolic_kernel<3, false>
                               : bitmask_symbolic_kernel<2, false>);
  kernel<<<grid, BMS_THREADS, smem_bytes, s>>>(
      static_cast<const int*>(rows), static_cast<const int*>(row_da),
      static_cast<const int*>(row_db), static_cast<const int*>(row_nw),
      static_cast<const int*>(out_idx), n_rows, n_long, long_blocks,
      warp_rows, group_blocks, max_deg_a, max_deg_b, n_words, table_deg_a,
      static_cast<const int*>(a_rpt), static_cast<const int*>(a_col),
      static_cast<const int*>(b_rpt), static_cast<const int*>(b_col),
      static_cast<const int*>(rownnz_b), m, k_rows, smem_words,
      static_cast<char*>(scratch), slice_bytes, static_cast<int*>(totals),
      static_cast<int*>(flop_out), static_cast<int*>(z_out));
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_COMMON(bitmask_symbolic)
