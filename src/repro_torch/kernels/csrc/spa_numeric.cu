// SPA (dense accumulator) numeric phase for one bucket's rows, compaction
// fused in: per output row, its distinct columns in ascending order and
// their value sums written straight into the row's row_capacity slots, plus
// the row's true nnz (which may exceed the capacity).
//
// Replaces: src/repro/kernels/accumulator.py::spa_numeric_pallas
// (_spa_numeric_kernel, _accumulate_tile), which one-hot-accumulates each
// row block's value products into dense column tiles of an extent-relative
// (R, n_tiles*tile_n) window with a presence mask beside them, and the
// XLA-side src/repro/core/spgemm.py::compact_dense that scatters that window
// into the capacity slots.
//
// Design: one thread block per output row.  The block finds the row's
// smallest product column lo (the extent_relative offset) and largest from
// the first and last entry of each referenced B row, then walks the window's
// tiles that the row's extent reaches, in column order.  For each it clears
// a tile_n float tile and its tile_n/32 presence words in shared memory,
// gathers the row's products again (as the TPU kernel does per tile),
// atomicAdd's each value product that falls in the tile and atomicOr's its
// presence bit, then compacts the tile with a block scan of the presence
// popcounts into the next slots (column lo + lane), so a sum that cancels to
// 0.0 stays an entry.  The true nnz runs on past the capacity.  The
// (R, n_tiles*tile_n) dense windows of the TPU kernel never reach device
// memory.  Products past the window are dropped, as in the TPU kernel.
//
// Shared-memory float atomics add a tile's products in an order that
// changes from run to run, so val may differ in its last bits between runs
// (col, row_nnz and overflow do not).
//
// Bound on the H100: bytes.  The necessary traffic is A's and B's entries
// that the rows reference (8 bytes per product gathered) and the output
// slots (8 bytes each); the tile (1 KB on a 256-column FEM extent, at most
// 66 KB for a forced 16384-lane tile) stays in shared memory.
#include "common.cuh"

__global__ void __launch_bounds__(1024) spa_numeric_kernel(
    const int* __restrict__ rows, int n_rows, const int* __restrict__ a_rpt,
    const int* __restrict__ a_col, const float* __restrict__ a_val,
    const int* __restrict__ b_rpt, const int* __restrict__ b_col,
    const float* __restrict__ b_val, const int* __restrict__ rownnz_b, int m,
    int k_rows, int max_deg_a, int max_deg_b, int tile_n, int n_tiles,
    int row_capacity, char* scratch, long long ws_bytes,
    int* __restrict__ out_col, float* __restrict__ out_val,
    int* __restrict__ row_nnz) {
  extern __shared__ __align__(16) char smem[];
  char* ws = scratch ? scratch + blockIdx.x * ws_bytes : smem;
  int* prefix = reinterpret_cast<int*>(ws);
  float* acc = reinterpret_cast<float*>(
      ws + repro_align16(4LL * (max_deg_a + 1)));
  unsigned* pres = reinterpret_cast<unsigned*>(acc + tile_n);
  const int tile_words = tile_n >> 5;   // tile_n is a power of two >= 128
  for (int ri = blockIdx.x; ri < n_rows; ri += gridDim.x) {
    int start, deg, flop, lo, hi;
    const int n = repro_row_prefix(rows[ri], a_rpt, a_col, rownnz_b, m,
                                   k_rows, max_deg_a, max_deg_b, prefix,
                                   &start, &deg, &flop);
    repro_row_extent(start, deg, a_col, b_rpt, b_col, rownnz_b, k_rows,
                     max_deg_b, &lo, &hi);
    // the tiles the row's extent reaches; the others hold nothing
    const int tiles = n ? min(n_tiles, (hi - lo) / tile_n + 1) : 0;
    int* col_row = out_col + static_cast<long long>(ri) * row_capacity;
    float* val_row = out_val + static_cast<long long>(ri) * row_capacity;
    int nnz = 0;
    for (int t = 0; t < tiles; ++t) {
      const int t0 = t * tile_n;
      for (int l = threadIdx.x; l < tile_n; l += blockDim.x) acc[l] = 0.0f;
      for (int w = threadIdx.x; w < tile_words; w += blockDim.x) pres[w] = 0u;
      __syncthreads();
      for (int p = threadIdx.x; p < n; p += blockDim.x) {
        int j;
        const int e = repro_product_entry(p, deg, prefix, start, a_col,
                                          b_rpt, &j);
        const int rel = b_col[e] - lo - t0;
        if (rel >= 0 && rel < tile_n) {
          atomicAdd(&acc[rel], __fmul_rn(a_val[start + j], b_val[e]));
          atomicOr(&pres[rel >> 5], 1u << (rel & 31));
        }
      }
      __syncthreads();
      nnz += repro_compact_tile(acc, pres, tile_words, nnz, row_capacity,
                                lo + t0, col_row, val_row);
    }
    repro_fill_tail(nnz, row_capacity, col_row, val_row);
    if (threadIdx.x == 0) row_nnz[ri] = nnz;
    // keep the next row's prefix off this row's workspace
    __syncthreads();
  }
}

extern "C" int spa_numeric_launch(
    const void* rows, int n_rows, const void* a_rpt, const void* a_col,
    const void* a_val, const void* b_rpt, const void* b_col,
    const void* b_val, const void* rownnz_b, int m, int k_rows,
    int max_deg_a, int max_deg_b, int tile_n, int n_tiles, int row_capacity,
    void* scratch, long long ws_bytes, int grid, int threads, int smem_bytes,
    void* out_col, void* out_val, void* row_nnz, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(spa_numeric_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  spa_numeric_kernel<<<grid, threads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), n_rows, static_cast<const int*>(a_rpt),
      static_cast<const int*>(a_col), static_cast<const float*>(a_val),
      static_cast<const int*>(b_rpt), static_cast<const int*>(b_col),
      static_cast<const float*>(b_val), static_cast<const int*>(rownnz_b), m,
      k_rows, max_deg_a, max_deg_b, tile_n, n_tiles, row_capacity,
      static_cast<char*>(scratch), ws_bytes, static_cast<int*>(out_col),
      static_cast<float*>(out_val), static_cast<int*>(row_nnz));
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_COMMON(spa_numeric)
