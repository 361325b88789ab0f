// BIN (propagation blocking) numeric phase for one bucket's rows,
// compaction fused in: the same outputs as the SPA kernel (ascending
// distinct columns and their value sums in the row's row_capacity slots,
// and the row's true nnz).
//
// Replaces: src/repro/kernels/accumulator.py::bin_numeric_pallas
// (_bin_numeric_kernel), which gathers each row block's products once,
// streams them into n_tiles bins of tile_n columns of an extent-relative
// (R, n_tiles*tile_n) window and reduces each bin densely, and the XLA-side
// src/repro/core/spgemm.py::compact_dense over that window.
//
// Design: one thread block per output row, and propagation blocking proper,
// because a power-law hub row's window (131,072 lanes, 512 KB of floats on
// the R-MAT 80k product) fits no shared memory.  Per row:
//   1. count the products per bin into shared counters (bin = relative
//      column / tile_n, relative to the row's smallest product column lo);
//   2. exclusive-scan the counters into bin offsets;
//   3. scatter the (column within the bin, a_ik*b_kj) pairs in bin order
//      into the block's slice of a global scratch buffer (8 bytes a product);
//   4. for each non-empty bin, in column order, reduce its pairs into a
//      tile_n float tile and its presence words in shared memory
//      (atomicAdd / atomicOr);
//   5. compact the tile with a block scan into the row's next slots
//      (column lo + bin*tile_n + lane), the true nnz running on past the
//      capacity.
// Bins are compacted in column order, so the retained entries are the row's
// first row_capacity columns in ascending order, as ESC keeps them.
// Products past the window are dropped, as in the TPU kernel.
//
// Shared-memory float atomics add a bin's products in an order that changes
// from run to run, so val may differ in its last bits between runs (col,
// row_nnz and overflow do not).
//
// Bound on the H100: bytes.  The necessary traffic is A's and B's entries
// that the rows reference (8 bytes per product gathered) and the output
// slots; the scatter's pairs (8 bytes a product, written once and read
// once) are traffic the TPU kernel kept in VMEM and this one keeps in its
// scratch slice, mostly in the 50 MB L2.
#include "common.cuh"

__global__ void __launch_bounds__(1024) bin_numeric_kernel(
    const int* __restrict__ rows, int n_rows, const int* __restrict__ a_rpt,
    const int* __restrict__ a_col, const float* __restrict__ a_val,
    const int* __restrict__ b_rpt, const int* __restrict__ b_col,
    const float* __restrict__ b_val, const int* __restrict__ rownnz_b, int m,
    int k_rows, int max_deg_a, int max_deg_b, int tile_n, int n_bins,
    int row_capacity, char* scratch, long long slice_bytes,
    long long pair_stride, long long ws_off, int* __restrict__ out_col,
    float* __restrict__ out_val, int* __restrict__ row_nnz) {
  extern __shared__ __align__(16) char smem[];
  char* slice = scratch + blockIdx.x * slice_bytes;
  int* pair_rel = reinterpret_cast<int*>(slice);
  float* pair_val = reinterpret_cast<float*>(slice + 4 * pair_stride);
  char* ws = ws_off >= 0 ? slice + ws_off : smem;
  int* prefix = reinterpret_cast<int*>(ws);
  const long long bins_off = repro_align16(4LL * (max_deg_a + 1));
  int* bin_end = reinterpret_cast<int*>(ws + bins_off);
  float* acc = reinterpret_cast<float*>(
      ws + bins_off + repro_align16(4LL * n_bins));
  unsigned* pres = reinterpret_cast<unsigned*>(acc + tile_n);
  const int tile_words = tile_n >> 5;   // tile_n is a power of two >= 128
  for (int ri = blockIdx.x; ri < n_rows; ri += gridDim.x) {
    int start, deg, flop, lo, hi;
    const int n = repro_row_prefix(rows[ri], a_rpt, a_col, rownnz_b, m,
                                   k_rows, max_deg_a, max_deg_b, prefix,
                                   &start, &deg, &flop);
    repro_row_extent(start, deg, a_col, b_rpt, b_col, rownnz_b, k_rows,
                     max_deg_b, &lo, &hi);
    // the bins the row's extent reaches; the others hold nothing
    const int bins = n ? min(n_bins, (hi - lo) / tile_n + 1) : 0;
    // 1. products per bin
    for (int b = threadIdx.x; b < bins; b += blockDim.x) bin_end[b] = 0;
    __syncthreads();
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      int j;
      const int e = repro_product_entry(p, deg, prefix, start, a_col, b_rpt,
                                        &j);
      const int bin = (b_col[e] - lo) / tile_n;
      if (bin < bins) atomicAdd(&bin_end[bin], 1);
    }
    __syncthreads();
    // 2. bin offsets: each thread scans a contiguous chunk of the bins; the
    //    counters become cursors at each bin's start
    const int chunk = (bins + blockDim.x - 1) / blockDim.x;
    const int b0 = min(bins, static_cast<int>(threadIdx.x) * chunk);
    const int b1 = min(bins, b0 + chunk);
    int local = 0;
    for (int b = b0; b < b1; ++b) local += bin_end[b];
    int total;
    int run = repro_block_exclusive_scan(local, &total);
    for (int b = b0; b < b1; ++b) {
      const int c = bin_end[b];
      bin_end[b] = run;
      run += c;
    }
    __syncthreads();
    // 3. scatter the pairs in bin order; each cursor ends at its bin's end
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      int j;
      const int e = repro_product_entry(p, deg, prefix, start, a_col, b_rpt,
                                        &j);
      const int rel = b_col[e] - lo;
      const int bin = rel / tile_n;
      if (bin < bins) {
        const int pos = atomicAdd(&bin_end[bin], 1);
        pair_rel[pos] = rel - bin * tile_n;
        pair_val[pos] = __fmul_rn(a_val[start + j], b_val[e]);
      }
    }
    __syncthreads();
    // 4.-5. reduce each non-empty bin densely and compact it
    int* col_row = out_col + static_cast<long long>(ri) * row_capacity;
    float* val_row = out_val + static_cast<long long>(ri) * row_capacity;
    int nnz = 0;
    for (int b = 0; b < bins; ++b) {
      const int s = b ? bin_end[b - 1] : 0;
      const int t = bin_end[b];
      if (s == t) continue;                     // block-uniform
      for (int l = threadIdx.x; l < tile_n; l += blockDim.x) acc[l] = 0.0f;
      for (int w = threadIdx.x; w < tile_words; w += blockDim.x) pres[w] = 0u;
      __syncthreads();
      for (int i = s + threadIdx.x; i < t; i += blockDim.x) {
        const int l = pair_rel[i];
        atomicAdd(&acc[l], pair_val[i]);
        atomicOr(&pres[l >> 5], 1u << (l & 31));
      }
      __syncthreads();
      nnz += repro_compact_tile(acc, pres, tile_words, nnz, row_capacity,
                                lo + b * tile_n, col_row, val_row);
    }
    repro_fill_tail(nnz, row_capacity, col_row, val_row);
    if (threadIdx.x == 0) row_nnz[ri] = nnz;
    // keep the next row's prefix and pairs off this row's workspace
    __syncthreads();
  }
}

extern "C" int bin_numeric_launch(
    const void* rows, int n_rows, const void* a_rpt, const void* a_col,
    const void* a_val, const void* b_rpt, const void* b_col,
    const void* b_val, const void* rownnz_b, int m, int k_rows,
    int max_deg_a, int max_deg_b, int tile_n, int n_bins, int row_capacity,
    void* scratch, long long slice_bytes, long long pair_stride,
    long long ws_off, int grid, int threads, int smem_bytes, void* out_col,
    void* out_val, void* row_nnz, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bin_numeric_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  bin_numeric_kernel<<<grid, threads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), n_rows, static_cast<const int*>(a_rpt),
      static_cast<const int*>(a_col), static_cast<const float*>(a_val),
      static_cast<const int*>(b_rpt), static_cast<const int*>(b_col),
      static_cast<const float*>(b_val), static_cast<const int*>(rownnz_b), m,
      k_rows, max_deg_a, max_deg_b, tile_n, n_bins, row_capacity,
      static_cast<char*>(scratch), slice_bytes, pair_stride, ws_off,
      static_cast<int*>(out_col), static_cast<float*>(out_val),
      static_cast<int*>(row_nnz));
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_COMMON(bin_numeric)
