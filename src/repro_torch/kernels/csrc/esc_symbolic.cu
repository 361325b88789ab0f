// Fused Algorithm 1 + Algorithm 2 (ESC symbolic) over sampled rows: per
// sampled row, its distinct product columns z and its FLOP.
//
// Replaces: src/repro/kernels/spgemm_symbolic.py::fused_flop_symbolic_pallas
// (_fused_kernel), which gathers a (BS, next_pow2(DA*DB)) block at one
// bucket's degree bounds, bitonic-sorts it along lanes and counts strict
// ascents; the binned predictor calls it once per degree bucket.  Also
// replaces sampled_symbolic_pallas (_kernel), the same count at the global
// degree bounds whose f* counts the gathered products instead.
//
// One entry serves every way of calling it: one bucket's rows at its bounds
// (rows only), every sampled row of a binned prediction that falls in an
// ESC bucket, in one launch, each row at its own bucket's bounds (row_da,
// row_db) and writing to its own output slot (out_idx), or the global-pad
// predictor's sampled rows at one pair of bounds, each sized by its own
// FLOP (row_flop) without reordering them: every row then has a warp and a
// block, and whichever does not fit its bound returns at once, so the host
// sorts, reads back and uploads nothing.  As in the TPU kernels, a row
// reads at most DA entries of A and at most DB of each B row it
// references; its FLOP sums the referenced B rows' untruncated lengths.
// f* (totals[1]) sums the rows' FLOP, or with `gathered` their gathered
// products (each B row read to at most DB entries): the two agree when DB
// reaches B's widest row.
// The exact-symbolic fallback of the re-planning loop (DESIGN.md §9) takes
// the first way over every row of an offending ESC bucket, not a sample,
// and asks for each row's own count: z_out, one int a row written at its
// out_idx slot beside its FLOP.  The mode is a template parameter
// (kRowCounts), so the prediction's instantiation carries no code of it:
// with z_out null the launcher runs that one.
//
// What held the per-bucket launches back on the H100 was not the card: a
// prediction made 8 to 17 of them, each with its host work (an upload of the
// bucket's rows, a workspace sized by next_pow2(DA*DB), an attribute call)
// and a barrier-bound bitonic block for every row, however short.  Design:
// the wrapper sorts the rows, long ones first, by a bound on each row's
// products (its FLOP, or DA*DB without one), and sizes the workspaces from
// those bounds, not from a bucket's padded width.
//   * Short rows (bound <= the launch's warp_keys, at most SYM_WARP_MAX)
//     take one warp each, sixteen to a block: the warp walks the row's A
//     entries 32 at a time, stages their product offsets and B-row starts,
//     gathers the product columns into its own shared memory, sorts them
//     with the lane-group network of common.cuh (keys only, exactly n of
//     them) and counts the first key and the strict ascents.
//   * Long rows take a block each (the first long_blocks blocks, looping
//     when scratch cuts their number): the row's product prefix and its A
//     entries' B-row starts in a table, so a product's column is one load
//     after a binary search on chip, and a gather that keeps SYM_BATCH
//     loads in flight a thread.  Sorting n keys in one block is bound by
//     one SM's shared-memory bandwidth (n log^2 n comparator loads and
//     stores: on an H100 about 0.14 ms for a row of 15 K products), so a
//     long row whose column extent (from its B rows' first and last
//     columns) fits the keys' shared memory as a bitmask counts by
//     presence bits and a popcount instead, in O(n).  Any other long row
//     sorts with the same network as the warps, over the whole block, and
//     counts its run starts: in shared memory when its own products fit
//     smem_keys, else in the block's slice of global scratch (sized by the
//     largest bound that does not fit), where it counts by presence bits
//     instead when its extent fits the slice as a bitmask.  The global-pad
//     wrapper sizes the slice by B's columns, so that every long row counts
//     by bitmask and, past shared memory, the blocks count their rows side
//     by side.
//     The table sits in shared memory unless even it does not fit
//     (smem_keys < 0: no bitmask there, the slice holds table and keys).
// Each row writes its FLOP and adds its z and FLOP to the two totals with
// integer atomics, so z* and f* are exact in any order, with no reduction
// launched after the kernel.  A row whose products exceed the bound it was
// given (a caller's FLOP below the row's products) neither fits its warp's
// keys nor, on a long row, the block's: it counts by presence bits over its
// column extent in the launch's spill bitmask, one global word per 32 of B's
// columns, taken under a lock and left zeroed.  Such a row costs time, not
// the answer, and no row writes past a workspace.
//
// Bound on the H100: bytes.  Every product column is read once from B
// (4 bytes each) plus A's row slice and B's row pointers and lengths; the
// counting runs on chip for every row that fits shared memory.
#include "common.cuh"

// _build.py reads SYM_WARPS and SYM_WARP_MAX from here to size the launch
#define SYM_WARPS 16       // short rows a block takes, a warp each
#define SYM_THREADS (SYM_WARPS * 32)
#define SYM_WARP_MAX 256   // products a warp sorts on its own
#define SYM_BATCH 4        // product loads a thread keeps in flight

struct SymRow {
  int r, da, db, out;
};

__device__ inline SymRow sym_row(int ri, const int* rows, const int* row_da,
                                 const int* row_db, const int* out_idx,
                                 int max_deg_a, int max_deg_b) {
  return {rows[ri], row_da ? row_da[ri] : max_deg_a,
          row_db ? row_db[ri] : max_deg_b, out_idx ? out_idx[ri] : ri};
}

// Distinct columns of a row past its bound, by one warp: presence bits over
// the row's column extent in the spill bitmask (spill_words words, all zero
// on entry and on exit), under the launch's lock.
__device__ int sym_warp_spill(int start, int deg, int db_bound,
                              const int* __restrict__ a_col,
                              const int* __restrict__ b_rpt,
                              const int* __restrict__ b_col,
                              const int* __restrict__ rownnz_b, int k_rows,
                              int* lock, unsigned* spill, int spill_words) {
  const int lane = threadIdx.x & 31;
  int lo = REPRO_SENTINEL, hi = -1;   // B rows are sorted: first and last
  for (int j = lane; j < deg; j += 32) {
    const int k = a_col[start + j];
    const int len = (k >= 0 && k < k_rows) ? min(rownnz_b[k], db_bound) : 0;
    if (len > 0) {
      lo = min(lo, b_col[b_rpt[k]]);
      hi = max(hi, b_col[b_rpt[k] + len - 1]);
    }
  }
  lo = __reduce_min_sync(REPRO_FULL_MASK, lo);
  hi = __reduce_max_sync(REPRO_FULL_MASK, hi);
  if (hi < lo) return 0;
  const int words = min(((hi - lo) >> 5) + 1, spill_words);
  if (lane == 0) {
    while (atomicCAS(lock, 0, 1) != 0) __nanosleep(200);
    __threadfence();
  }
  __syncwarp();
  for (int j = 0; j < deg; ++j) {
    const int k = a_col[start + j];
    if (k < 0 || k >= k_rows) continue;
    const int len = min(rownnz_b[k], db_bound), e0 = b_rpt[k];
    for (int e = lane; e < len; e += 32) {
      const int w = (b_col[e0 + e] - lo) >> 5;
      if (w >= 0 && w < words)
        atomicOr(&spill[w], 1u << ((b_col[e0 + e] - lo) & 31));
    }
  }
  __syncwarp();
  int z = 0;
  for (int w = lane; w < words; w += 32) z += __popc(atomicExch(&spill[w], 0u));
  z = __reduce_add_sync(REPRO_FULL_MASK, z);
  if (lane == 0) {
    __threadfence();
    atomicExch(lock, 0);
  }
  return z;
}

// One short row by one warp: its keys in keys[0, warp_keys), the staging of
// 32 A entries in s_off/s_e0; a row past warp_keys counts in the spill.
template <bool kRowCounts>
__device__ void sym_warp_row(SymRow row, const int* __restrict__ a_rpt,
                             const int* __restrict__ a_col,
                             const int* __restrict__ b_rpt,
                             const int* __restrict__ b_col,
                             const int* __restrict__ rownnz_b, int m,
                             int k_rows, int warp_keys, int* s_off,
                             int* s_e0, int* keys, int* totals,
                             unsigned* spill, int spill_words, int gathered,
                             int* flop_out, int* z_out) {
  const int lane = threadIdx.x & 31;
  int start = 0, deg = 0;
  if (row.r >= 0 && row.r < m) {
    start = a_rpt[row.r];
    deg = min(a_rpt[row.r + 1] - start, row.da);
  }
  int n = 0, flop = 0;
  bool over = false;
  for (int j0 = 0; j0 < deg; j0 += 32) {
    const int j = j0 + lane;
    int len = 0, db = 0, e0 = 0;
    if (j < deg) {
      const int k = a_col[start + j];
      if (k >= 0 && k < k_rows) {
        db = rownnz_b[k];
        len = min(db, row.db);
        e0 = b_rpt[k];
      }
    }
    flop += __reduce_add_sync(REPRO_FULL_MASK, db);
    int total;
    const int off = repro_warp_exclusive_scan(len, &total);
    over = over || n + total > warp_keys;
    if (!over) {
      s_off[lane] = off;
      s_e0[lane] = e0;
      __syncwarp();
      for (int p = lane; p < total; p += 32) {
        int lo = 0, hi = 32;   // s_off[lo] <= p < s_off[hi] (: total)
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (s_off[mid] <= p) lo = mid; else hi = mid;
        }
        keys[n + p] = b_col[s_e0[lo] + (p - s_off[lo])];
      }
      __syncwarp();
    }
    n += total;
  }
  int z;
  if (!over) {
    repro_warp_sort<false>(keys, nullptr, n);
    z = repro_warp_count_runs(keys, n);
  } else {
    z = sym_warp_spill(start, deg, row.db, a_col, b_rpt, b_col, rownnz_b,
                       k_rows, &totals[2], spill, spill_words);
  }
  if (lane == 0) {
    atomicAdd(&totals[0], z);
    atomicAdd(&totals[1], gathered ? n : flop);
    flop_out[row.out] = flop;
    if (kRowCounts) z_out[row.out] = z;
  }
}

// The block's gather of a long row's n product columns: product p's column
// is one load after a binary search of the prefix table (prefix[lo] <= p <
// prefix[lo + 1], B-row start e0[lo]); a thread keeps SYM_BATCH loads in
// flight, then hands each (p, column) to place.  Ends with no barrier.
template <typename Place>
__device__ void sym_gather(int n, int deg, const int* prefix, const int* e0,
                           const int* __restrict__ b_col, Place place) {
  for (int p0 = threadIdx.x; p0 < n; p0 += SYM_BATCH * blockDim.x) {
    int e[SYM_BATCH];
#pragma unroll
    for (int u = 0; u < SYM_BATCH; ++u) {
      const int p = p0 + u * blockDim.x;
      e[u] = -1;
      if (p < n) {
        int lo = 0, hi = deg;
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (prefix[mid] <= p) lo = mid; else hi = mid;
        }
        e[u] = e0[lo] + (p - prefix[lo]);
      }
    }
    int c[SYM_BATCH];
#pragma unroll
    for (int u = 0; u < SYM_BATCH; ++u) c[u] = e[u] >= 0 ? b_col[e[u]] : 0;
#pragma unroll
    for (int u = 0; u < SYM_BATCH; ++u)
      if (e[u] >= 0) place(p0 + u * blockDim.x, c[u]);
  }
}

// A long row's distinct columns by presence bits over its column extent
// [lo, lo + 32 * words) in mask: the block's shared memory, or (kGlobal) its
// scratch slice, read back from L2 past the atomics.  Ends with no barrier.
template <bool kGlobal>
__device__ int sym_block_bitmask(unsigned* mask, int words, int lo, int n,
                                 int deg, const int* prefix, const int* e0,
                                 const int* __restrict__ b_col) {
  for (int w = threadIdx.x; w < words; w += blockDim.x) mask[w] = 0u;
  __syncthreads();
  sym_gather(n, deg, prefix, e0, b_col, [&](int, int c) {
    atomicOr(&mask[(c - lo) >> 5], 1u << ((c - lo) & 31));
  });
  __syncthreads();
  int local = 0;
  for (int w = threadIdx.x; w < words; w += blockDim.x)
    local += __popc(kGlobal ? __ldcg(&mask[w]) : mask[w]);
  int z;
  repro_block_exclusive_scan(local, &z);
  return z;
}

// With row_flop, row ri is long when min(row_flop[ri], DA*DB) passes the
// warp's keys (the same for every thread of a block).
__device__ inline bool sym_long(int ri, const int* row_flop, int max_deg_a,
                                int max_deg_b, int warp_keys) {
  const long long cap = static_cast<long long>(max_deg_a) * max_deg_b;
  return min(static_cast<long long>(row_flop[ri]), cap) > warp_keys;
}

// kRowCounts: the per-row count mode (z_out written)
template <bool kRowCounts>
__global__ void __launch_bounds__(SYM_THREADS) esc_symbolic_kernel(
    const int* __restrict__ rows, const int* __restrict__ row_da,
    const int* __restrict__ row_db, const int* __restrict__ out_idx,
    const int* __restrict__ row_flop,
    int n_rows, int n_long, int long_blocks, int max_deg_a, int max_deg_b,
    int max_deg_a_long, const int* __restrict__ a_rpt,
    const int* __restrict__ a_col, const int* __restrict__ b_rpt,
    const int* __restrict__ b_col, const int* __restrict__ rownnz_b, int m,
    int k_rows, int warp_keys, int smem_keys, char* scratch,
    long long slice_bytes, int* __restrict__ totals, int spill_words,
    int gathered, int* __restrict__ flop_out, int* __restrict__ z_out) {
  extern __shared__ __align__(16) char smem[];
  unsigned* spill = reinterpret_cast<unsigned*>(totals + 3);
  if (static_cast<int>(blockIdx.x) >= long_blocks) {
    // short rows, a warp each; this part has no block barrier.  With
    // row_flop every row has a warp here, which leaves a long one alone.
    const int w = threadIdx.x >> 5;
    const int ri = (row_flop ? 0 : n_long) +
                   (blockIdx.x - long_blocks) * SYM_WARPS + w;
    if (ri >= n_rows ||
        (row_flop && sym_long(ri, row_flop, max_deg_a, max_deg_b,
                              warp_keys)))
      return;
    char* region = smem + static_cast<long long>(w) *
                              (256 + repro_align16(4LL * warp_keys));
    int* s_off = reinterpret_cast<int*>(region);
    sym_warp_row<kRowCounts>(
        sym_row(ri, rows, row_da, row_db, out_idx, max_deg_a, max_deg_b),
        a_rpt, a_col, b_rpt, b_col, rownnz_b, m, k_rows, warp_keys, s_off,
        s_off + 32, reinterpret_cast<int*>(region + 256), totals, spill,
        spill_words, gathered, flop_out, z_out);
    return;
  }
  // long rows, a block each: the table (product prefix, then each A
  // entry's B-row start) and the keys
  const long long pre_bytes = repro_align16(4LL * (max_deg_a_long + 1));
  char* slice = scratch ? scratch + blockIdx.x * slice_bytes : nullptr;
  const bool table_in_smem = smem_keys >= 0;
  int* prefix = reinterpret_cast<int*>(table_in_smem ? smem : slice);
  int* e0 = prefix + pre_bytes / 4;
  int* keys_smem = reinterpret_cast<int*>(smem + 2 * pre_bytes);
  int* keys_slice = slice ? reinterpret_cast<int*>(
                                slice + (table_in_smem ? 0 : 2 * pre_bytes))
                          : nullptr;
  const long long slice_keys =
      slice ? (slice_bytes - (table_in_smem ? 0 : 2 * pre_bytes)) / 4 : 0;
  for (int ri = blockIdx.x; ri < n_long; ri += long_blocks) {
    if (row_flop && !sym_long(ri, row_flop, max_deg_a, max_deg_b, warp_keys))
      continue;   // a short row: its warp counts it
    const SymRow row = sym_row(ri, rows, row_da, row_db, out_idx, max_deg_a,
                               max_deg_b);
    int start, deg, flop;
    const int n = repro_row_prefix(row.r, a_rpt, a_col, rownnz_b, m, k_rows,
                                   min(row.da, max_deg_a_long), row.db,
                                   prefix, &start, &deg, &flop);
    for (int j = threadIdx.x; j < deg; j += blockDim.x) {
      const int k = a_col[start + j];
      e0[j] = (k >= 0 && k < k_rows) ? b_rpt[k] : 0;
    }
    __syncthreads();
    int lo, hi;
    repro_row_extent(start, deg, a_col, b_rpt, b_col, rownnz_b, k_rows,
                     row.db, &lo, &hi);
    const int words = n ? ((hi - lo) >> 5) + 1 : 0;
    int z;
    if (words <= smem_keys) {
      // the extent fits the keys' shared memory as a bitmask: count the
      // distinct columns by presence bits, no sort
      z = sym_block_bitmask<false>(reinterpret_cast<unsigned*>(keys_smem),
                                   words, lo, n, deg, prefix, e0, b_col);
    } else if (n > smem_keys && words <= slice_keys) {
      // the same in the block's scratch slice, when the keys would not fit
      // shared memory either
      z = sym_block_bitmask<true>(reinterpret_cast<unsigned*>(keys_slice),
                                  words, lo, n, deg, prefix, e0, b_col);
    } else if (n <= smem_keys || n <= slice_keys) {
      int* keys = n <= smem_keys ? keys_smem : keys_slice;
      sym_gather(n, deg, prefix, e0, b_col, [&](int p, int c) {
        keys[p] = c;
      });
      repro_block_sort<false>(keys, nullptr, n);
      int local = 0;
      for (int p = threadIdx.x; p < n; p += blockDim.x)
        local += (p == 0 || keys[p] != keys[p - 1]) ? 1 : 0;
      repro_block_exclusive_scan(local, &z);
    } else {
      // past the bound the launch was sized by: the spill bitmask
      const int sw = min(words, spill_words);
      repro_lock(&totals[2]);
      sym_gather(n, deg, prefix, e0, b_col, [&](int, int c) {
        const int w = (c - lo) >> 5;
        if (w >= 0 && w < sw) atomicOr(&spill[w], 1u << ((c - lo) & 31));
      });
      __syncthreads();
      int local = 0;
      for (int w = threadIdx.x; w < sw; w += blockDim.x)
        local += __popc(atomicExch(&spill[w], 0u));
      repro_block_exclusive_scan(local, &z);
      repro_unlock(&totals[2]);
    }
    if (threadIdx.x == 0) {
      atomicAdd(&totals[0], z);
      atomicAdd(&totals[1], gathered ? n : flop);
      flop_out[row.out] = flop;
      if (kRowCounts) z_out[row.out] = z;
    }
    __syncthreads();   // the next row rewrites the table and the keys
  }
}

// Shared memory above the 48 KB default needs the attribute: set once per
// device for both instantiations, to the card's opt-in limit less the
// kernel's static shared memory, so no later call sets it again.
template <bool kRowCounts>
static cudaError_t sym_smem_attr_one(int limit) {
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, esc_symbolic_kernel<kRowCounts>);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      esc_symbolic_kernel<kRowCounts>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      limit - static_cast<int>(attr.sharedSizeBytes));
}

static cudaError_t sym_smem_attr(int device) {
  static int done[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (done[device]) return cudaSuccess;
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = sym_smem_attr_one<false>(limit);
  if (err == cudaSuccess) err = sym_smem_attr_one<true>(limit);
  if (err == cudaSuccess) done[device] = 1;
  return err;
}

// rows (n_rows,), the first n_long of them long rows; row_da, row_db and
// out_idx may be null (then max_deg_a, max_deg_b and the row's own index).
// With row_flop (one int a row; row_da, row_db and out_idx null), n_long is
// n_rows or 0 and each row is long or short by its own FLOP.
// totals (3 + spill_words ints, zeroed here: z*, f*, the spill lock, then
// the spill bitmask of ceil(B's columns / 32) words) gets z* and f* (the
// gathered products with `gathered`, else the FLOP), flop_out one int per
// row and, where z_out is not null (the per-row count mode), z_out each
// row's distinct columns, both in the row's out_idx slot.
extern "C" int esc_symbolic_launch(
    const void* rows, const void* row_da, const void* row_db,
    const void* out_idx, const void* row_flop, int n_rows, int n_long,
    int long_blocks, int max_deg_a, int max_deg_b, int max_deg_a_long,
    const void* a_rpt, const void* a_col, const void* b_rpt, const void* b_col,
    const void* rownnz_b, int m, int k_rows, int warp_keys, int smem_keys,
    void* scratch, long long slice_bytes, int smem_bytes, void* totals,
    int spill_words, int gathered, void* flop_out, void* z_out, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sym_smem_attr(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(totals, 0, (3LL + spill_words) * sizeof(int),
                        static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int short_rows = row_flop ? n_rows : n_rows - n_long;
  const int short_blocks = (short_rows + SYM_WARPS - 1) / SYM_WARPS;
  const int grid = long_blocks + short_blocks;
  if (grid <= 0) return 0;
  auto kernel = z_out ? esc_symbolic_kernel<true> : esc_symbolic_kernel<false>;
  kernel<<<grid, SYM_THREADS, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), static_cast<const int*>(row_da),
      static_cast<const int*>(row_db), static_cast<const int*>(out_idx),
      static_cast<const int*>(row_flop), n_rows, n_long, long_blocks,
      max_deg_a, max_deg_b, max_deg_a_long,
      static_cast<const int*>(a_rpt), static_cast<const int*>(a_col),
      static_cast<const int*>(b_rpt), static_cast<const int*>(b_col),
      static_cast<const int*>(rownnz_b), m, k_rows, warp_keys, smem_keys,
      static_cast<char*>(scratch), slice_bytes, static_cast<int*>(totals),
      spill_words, gathered, static_cast<int*>(flop_out),
      static_cast<int*>(z_out));
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_COMMON(esc_symbolic)
