// BIN (propagation blocking) numeric phase for one bucket's rows,
// compaction fused in: the same outputs as the ESC kernel (ascending
// distinct columns and their value sums in the row's row_capacity slots,
// and the row's true nnz).
//
// Replaces: src/repro/kernels/accumulator.py::bin_numeric_pallas
// (_bin_numeric_kernel), which gathers each row block's products once,
// streams them into n_tiles bins of tile_n columns of an extent-relative
// (R, n_tiles*tile_n) window and reduces each bin densely, and the XLA-side
// src/repro/core/spgemm.py::compact_dense over that window.
//
// Bound on the H100: bytes.  The necessary traffic is A's and B's entries
// that the rows reference (8 bytes per product gathered) and the output
// slots.  What the first port lost to it: a pair buffer in global scratch
// sized by the bucket's degree bounds (which cut the hub bucket's grid to
// ~160 blocks), bins reduced one after another by the whole block, each
// non-empty bin paying a 256-lane tile clear, two barriers and a block scan
// for the few products it held, and a scatter through free atomic cursors,
// whose order (and so val's last bits) changed from run to run.
//
// Design: one block per row (blocks loop over the rows): 256 threads, or
// 1,024 when the call's bound passes 8,192 products.
//   1. The row's product prefix, its A entries' B-row starts and values (so
//      a product's lookup reads shared memory only), its column extent
//      [lo, hi] and the bins it reaches (bin = (column - lo) / tile_n; bins
//      past n_tiles are dropped, as the TPU kernel drops products past its
//      window).
//   2. Stable scatter (repro_bin_partition): each warp counts its
//      contiguous slice of the products per bin with __match_any_sync into
//      its own histogram row, the rows scan into per-(bin, warp) cursors,
//      and a second walk writes each pair at its cursor plus its rank in
//      its warp: each bin holds its products in product order, whatever the
//      timing.  The pairs sit in shared memory when the row's own fit there,
//      else in the block's scratch slice (sized by the call's product
//      bound), else in one spill slice taken under a lock.
//   3. Bins in parallel (repro_warp_bin_dense): warp v reduces bins v,
//      v + nw, ... in its own tile_n-lane tile, 32 pairs at a time in order
//      (lanes with one column add their values in lane order, the first of
//      them adds the sum to the tile), then compacts the tile, each lane a
//      slice of it, into the bin's first pair slots, clearing it.
//   4. A block scan over the bins' distinct counts gives each bin's first
//      output slot; the warps copy their bins' columns out: the row's first
//      row_capacity columns in ascending order, as ESC keeps them, and the
//      true nnz runs on past the capacity.
// The sums are thus taken in a fixed order, and val is bitwise the same
// from run to run.
#include "common.cuh"

__global__ void __launch_bounds__(1024) bin_numeric_kernel(
    const int* __restrict__ rows, int n_rows, const int* __restrict__ a_rpt,
    const int* __restrict__ a_col, const float* __restrict__ a_val,
    const int* __restrict__ b_rpt, const int* __restrict__ b_col,
    const float* __restrict__ b_val, const int* __restrict__ rownnz_b, int m,
    int k_rows, int max_deg_a, int max_deg_b, int tile_n, int n_bins,
    int row_capacity, int smem_pairs, char* scratch, long long slice_bytes,
    long long slice_pairs, char* spill, int* ctl, int* __restrict__ out_col,
    float* __restrict__ out_val, int* __restrict__ row_nnz) {
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int sh = __ffs(tile_n) - 1;          // tile_n: a power of two
  const int tile_words = tile_n >> 5;
  // shared memory: the warps' tiles, then the tables when they fit, then
  // the pairs; else the tables head the block's scratch slice.  The tables:
  // the row's product prefix, its A entries' B-row starts and values, the
  // bins' starts and the warps' bin counts
  float* tile = reinterpret_cast<float*>(smem) + w * (tile_n + tile_words);
  unsigned* tile_pres = reinterpret_cast<unsigned*>(tile + tile_n);
  const long long tiles_bytes = 4LL * nw * (tile_n + tile_words);
  const long long pre = repro_align16(4LL * (max_deg_a + 1));
  const long long starts_bytes = repro_align16(4LL * (n_bins + 1));
  const long long tables_bytes =
      3 * pre + starts_bytes + repro_align16(4LL * nw * n_bins);
  char* slice = scratch ? scratch + blockIdx.x * slice_bytes : nullptr;
  char* tables = smem_pairs >= 0 ? smem + tiles_bytes : slice;
  int* prefix = reinterpret_cast<int*>(tables);
  int* e0 = reinterpret_cast<int*>(tables + pre);
  float* av = reinterpret_cast<float*>(tables + 2 * pre);
  int* bin_start = reinterpret_cast<int*>(tables + 3 * pre);
  int* hist = reinterpret_cast<int*>(tables + 3 * pre + starts_bytes);
  for (int l = lane; l < tile_n; l += 32) tile[l] = 0.0f;
  for (int l = lane; l < tile_words; l += 32) tile_pres[l] = 0u;
  for (int ri = blockIdx.x; ri < n_rows; ri += gridDim.x) {
    // 1. the row's products, entries, extent and bins
    int start, deg, flop, lo, hi;
    const int n = repro_row_prefix(rows[ri], a_rpt, a_col, rownnz_b, m,
                                   k_rows, max_deg_a, max_deg_b, prefix,
                                   &start, &deg, &flop);
    repro_row_entries(start, deg, a_col, a_val, b_rpt, k_rows, e0, av);
    repro_row_extent(start, deg, a_col, b_rpt, b_col, rownnz_b, k_rows,
                     max_deg_b, &lo, &hi);
    const int bins = n ? min(n_bins, ((hi - lo) >> sh) + 1) : 0;
    char* pairs;
    long long cap_pairs;
    const bool spilled = n > smem_pairs && !(slice && n <= slice_pairs);
    if (n <= smem_pairs) {
      pairs = smem + tiles_bytes + tables_bytes;
      cap_pairs = smem_pairs;
    } else if (!spilled) {
      pairs = slice + (smem_pairs >= 0 ? 0 : tables_bytes);
      cap_pairs = slice_pairs;
    } else {
      repro_lock(&ctl[0]);
      pairs = spill;
      cap_pairs = n;
    }
    int* pair_col = reinterpret_cast<int*>(pairs);
    float* pair_val = reinterpret_cast<float*>(pairs + 4 * cap_pairs);
    // 2. stable scatter of the pairs into the bins
    repro_bin_partition(n, deg, prefix, e0, av, b_col, b_val, lo, sh, bins,
                        hist, bin_start, pair_col, pair_val);
    // 3. bins in parallel: each warp reduces its bins in its tile, leaving
    //    each bin's distinct columns, ascending, in its first pair slots;
    //    hist[b] gets the bin's count
    for (int b = w; b < bins; b += nw) {
      const int s0 = bin_start[b], c = bin_start[b + 1] - s0;
      const int d = c ? repro_warp_bin_dense(pair_col, pair_val, s0, c,
                                             lo + (b << sh), tile, tile_pres,
                                             tile_words)
                      : 0;
      if (lane == 0) hist[b] = d;
    }
    __syncthreads();
    // 4. each bin's first output slot, then the copy-out
    const int nnz = repro_block_offsets(hist, bins);
    int* col_row = out_col + static_cast<long long>(ri) * row_capacity;
    float* val_row = out_val + static_cast<long long>(ri) * row_capacity;
    for (int b = w; b < bins; b += nw) {
      const int o = hist[b], d = hist[b + 1] - o, s0 = bin_start[b];
      for (int i = lane; i < d && o + i < row_capacity; i += 32) {
        col_row[o + i] = pair_col[s0 + i];
        val_row[o + i] = pair_val[s0 + i];
      }
    }
    repro_fill_tail(nnz, row_capacity, col_row, val_row);
    if (tid == 0) {
      row_nnz[ri] = nnz;
      if (nnz > row_capacity) atomicAdd(&ctl[1], nnz - row_capacity);
    }
    if (spilled) repro_unlock(&ctl[0]);
    // keep the next row's tables and pairs off this row's
    __syncthreads();
  }
}

// ctl: two ints, zeroed here: the spill slice's lock and the entries
// dropped for capacity.
extern "C" int bin_numeric_launch(
    const void* rows, int n_rows, const void* a_rpt, const void* a_col,
    const void* a_val, const void* b_rpt, const void* b_col,
    const void* b_val, const void* rownnz_b, int m, int k_rows,
    int max_deg_a, int max_deg_b, int tile_n, int n_bins, int row_capacity,
    int smem_pairs, void* scratch, long long slice_bytes,
    long long slice_pairs, void* spill, void* ctl, int grid, int threads,
    int smem_bytes, void* out_col, void* out_val, void* row_nnz,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static int seen[64];
  err = cudaMemsetAsync(ctl, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64 || smem_bytes > seen[device]) {
    err = cudaFuncSetAttribute(bin_numeric_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= 0 && device < 64) seen[device] = smem_bytes;
  }
  bin_numeric_kernel<<<grid, threads, smem_bytes, s>>>(
      static_cast<const int*>(rows), n_rows, static_cast<const int*>(a_rpt),
      static_cast<const int*>(a_col), static_cast<const float*>(a_val),
      static_cast<const int*>(b_rpt), static_cast<const int*>(b_col),
      static_cast<const float*>(b_val), static_cast<const int*>(rownnz_b), m,
      k_rows, max_deg_a, max_deg_b, tile_n, n_bins, row_capacity,
      smem_pairs, static_cast<char*>(scratch), slice_bytes, slice_pairs,
      static_cast<char*>(spill), static_cast<int*>(ctl),
      static_cast<int*>(out_col), static_cast<float*>(out_val),
      static_cast<int*>(row_nnz));
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_COMMON(bin_numeric)
