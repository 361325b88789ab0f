// ESC numeric phase for one bucket's rows, compaction fused into the
// epilogue: per output row, the sorted distinct columns and their value sums
// written straight into the row's row_capacity slots, plus the row's true
// nnz (which may exceed the capacity).
//
// Replaces: src/repro/kernels/spgemm_numeric.py::spgemm_numeric_pallas
// (_kernel) and the XLA-side compact() that scatters its uncompacted
// (R, next_pow2(DA*DB)) buffers into the capacity slots.
//
// Design: one thread block per output row.  The block gathers exactly the
// row's (column, a_ik*b_kj) pairs into its workspace, bitonic-sorts them by
// column, marks the first slot of each run of equal columns, numbers the
// runs with a block scan, and lets the thread that owns a run's first slot
// sum the run left to right and write it to slot (run number) when that is
// below the capacity.  Slots past the row's nnz get the sentinel and 0.
// The uncompacted buffers never reach device memory.
//
// Bound on the H100: bytes.  The necessary traffic is A's and B's entries
// that the rows reference (8 bytes per product gathered) and the output
// slots (8 bytes each); the sort stays in shared memory while
// next_pow2(DA*DB) pairs (8 bytes each) fit the 227 KB opt-in limit, and
// falls back to a global scratch slice for wider (hub) buckets.
#include "common.cuh"

__global__ void __launch_bounds__(1024) esc_numeric_kernel(
    const int* __restrict__ rows, int n_rows, const int* __restrict__ a_rpt,
    const int* __restrict__ a_col, const float* __restrict__ a_val,
    const int* __restrict__ b_rpt, const int* __restrict__ b_col,
    const float* __restrict__ b_val, const int* __restrict__ rownnz_b, int m,
    int k_rows, int max_deg_a, int max_deg_b, int f2, int row_capacity,
    char* scratch, long long ws_bytes, int* __restrict__ out_col,
    float* __restrict__ out_val, int* __restrict__ row_nnz) {
  extern __shared__ __align__(16) char smem[];
  char* ws = scratch ? scratch + blockIdx.x * ws_bytes : smem;
  int* prefix = reinterpret_cast<int*>(ws);
  const long long key_off = repro_align16(4LL * (max_deg_a + 1));
  int* keys = reinterpret_cast<int*>(ws + key_off);
  float* vals = reinterpret_cast<float*>(ws + key_off + 4LL * f2);
  for (int ri = blockIdx.x; ri < n_rows; ri += gridDim.x) {
    int flop;
    const int n = repro_gather_row<true>(
        rows[ri], a_rpt, a_col, a_val, b_rpt, b_col, b_val, rownnz_b, m,
        k_rows, max_deg_a, max_deg_b, prefix, keys, vals, &flop);
    repro_bitonic_sort<true>(keys, vals, repro_next_pow2(max(n, 1)));
    // each thread owns a contiguous chunk of the sorted pairs
    const int chunk = (n + blockDim.x - 1) / blockDim.x;
    const int p0 = min(n, static_cast<int>(threadIdx.x) * chunk);
    const int p1 = min(n, p0 + chunk);
    int local = 0;
    for (int p = p0; p < p1; ++p)
      local += (p == 0 || keys[p] != keys[p - 1]) ? 1 : 0;
    int nnz;
    int seg = repro_block_exclusive_scan(local, &nnz);
    int* col_row = out_col + static_cast<long long>(ri) * row_capacity;
    float* val_row = out_val + static_cast<long long>(ri) * row_capacity;
    for (int p = p0; p < p1; ++p) {
      if (p != 0 && keys[p] == keys[p - 1]) continue;
      if (seg < row_capacity) {
        float s = vals[p];
        for (int q = p + 1; q < n && keys[q] == keys[p]; ++q)
          s = __fadd_rn(s, vals[q]);
        col_row[seg] = keys[p];
        val_row[seg] = s;
      }
      ++seg;
    }
    for (int s = min(nnz, row_capacity) + threadIdx.x; s < row_capacity;
         s += blockDim.x) {
      col_row[s] = REPRO_SENTINEL;
      val_row[s] = 0.0f;
    }
    if (threadIdx.x == 0) row_nnz[ri] = nnz;
    // keep the next row's gather off this row's workspace
    __syncthreads();
  }
}

extern "C" int esc_numeric_launch(
    const void* rows, int n_rows, const void* a_rpt, const void* a_col,
    const void* a_val, const void* b_rpt, const void* b_col,
    const void* b_val, const void* rownnz_b, int m, int k_rows,
    int max_deg_a, int max_deg_b, int f2, int row_capacity, void* scratch,
    long long ws_bytes, int grid, int threads, int smem_bytes, void* out_col,
    void* out_val, void* row_nnz, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(esc_numeric_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  esc_numeric_kernel<<<grid, threads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), n_rows, static_cast<const int*>(a_rpt),
      static_cast<const int*>(a_col), static_cast<const float*>(a_val),
      static_cast<const int*>(b_rpt), static_cast<const int*>(b_col),
      static_cast<const float*>(b_val), static_cast<const int*>(rownnz_b), m,
      k_rows, max_deg_a, max_deg_b, f2, row_capacity,
      static_cast<char*>(scratch), ws_bytes, static_cast<int*>(out_col),
      static_cast<float*>(out_val), static_cast<int*>(row_nnz));
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_COMMON(esc_numeric)
