// Fused Algorithm 1 + Algorithm 2 on the SPA and BIN routes (bitmask
// symbolic) for one bucket's sampled rows: per sampled row, its distinct
// product columns z and its FLOP.
//
// Replaces: src/repro/kernels/accumulator.py::fused_flop_symbolic_bitmask_pallas
// (_fused_bitmask_kernel via _symbolic_call), which ORs every gathered
// product column's bit into ceil(min(span, ncols_b)/32) uint32 words
// addressed relative to the row's smallest product column, and popcounts.
//
// Design: one thread block per sampled row.  The block finds the row's
// smallest product column lo from the first entry of each referenced B row
// (B's rows are sorted, so that costs the row's A entries, not a pass over
// its products), clears the words the row's extent reaches, atomicOr's each
// product's bit into them (products found by binary search on the row's
// product prefix, as in the ESC kernels), and popcounts with a block scan.
// A product whose relative column falls past the n_words words is dropped,
// as in the TPU kernel.  Each row writes its own z and FLOP and the wrapper
// sums them, so z* and f* are exact and equal the ESC kernel's bit for bit:
// a distinct count does not depend on the order of anything.
//
// Bound on the H100: bytes.  Every product column is read once from B
// (4 bytes each), plus A's row slice and B's row pointers and lengths; the
// bitmask stays in shared memory (4-8 words on banded and FEM rows, 2,500 on
// the power-law BIN buckets), and only a column space past ~1.8 M columns
// would put it in a global scratch slice.
#include "common.cuh"

__global__ void __launch_bounds__(1024) bitmask_symbolic_kernel(
    const int* __restrict__ rows, int n_rows, const int* __restrict__ a_rpt,
    const int* __restrict__ a_col, const int* __restrict__ b_rpt,
    const int* __restrict__ b_col, const int* __restrict__ rownnz_b, int m,
    int k_rows, int max_deg_a, int max_deg_b, int n_words, char* scratch,
    long long ws_bytes, int* __restrict__ z_out, int* __restrict__ flop_out) {
  extern __shared__ __align__(16) char smem[];
  char* ws = scratch ? scratch + blockIdx.x * ws_bytes : smem;
  int* prefix = reinterpret_cast<int*>(ws);
  unsigned* mask = reinterpret_cast<unsigned*>(
      ws + repro_align16(4LL * (max_deg_a + 1)));
  for (int ri = blockIdx.x; ri < n_rows; ri += gridDim.x) {
    int start, deg, flop, lo, hi;
    const int n = repro_row_prefix(rows[ri], a_rpt, a_col, rownnz_b, m,
                                   k_rows, max_deg_a, max_deg_b, prefix,
                                   &start, &deg, &flop);
    repro_row_extent(start, deg, a_col, b_rpt, b_col, rownnz_b, k_rows,
                     max_deg_b, &lo, &hi);
    // the words the row's extent reaches; the others stay empty
    const int used = n ? min(n_words, ((hi - lo) >> 5) + 1) : 0;
    for (int w = threadIdx.x; w < used; w += blockDim.x) mask[w] = 0u;
    __syncthreads();
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      int j;
      const int e = repro_product_entry(p, deg, prefix, start, a_col, b_rpt,
                                        &j);
      const int rel = b_col[e] - lo;
      if ((rel >> 5) < used) atomicOr(&mask[rel >> 5], 1u << (rel & 31));
    }
    __syncthreads();
    int local = 0;
    for (int w = threadIdx.x; w < used; w += blockDim.x)
      local += __popc(mask[w]);
    int z;
    repro_block_exclusive_scan(local, &z);
    if (threadIdx.x == 0) {
      z_out[ri] = z;
      flop_out[ri] = flop;
    }
    // the scan's trailing barrier keeps the next row off this workspace
  }
}

extern "C" int bitmask_symbolic_launch(
    const void* rows, int n_rows, const void* a_rpt, const void* a_col,
    const void* b_rpt, const void* b_col, const void* rownnz_b, int m,
    int k_rows, int max_deg_a, int max_deg_b, int n_words, void* scratch,
    long long ws_bytes, int grid, int threads, int smem_bytes, void* z_out,
    void* flop_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bitmask_symbolic_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  bitmask_symbolic_kernel<<<grid, threads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), n_rows, static_cast<const int*>(a_rpt),
      static_cast<const int*>(a_col), static_cast<const int*>(b_rpt),
      static_cast<const int*>(b_col), static_cast<const int*>(rownnz_b), m,
      k_rows, max_deg_a, max_deg_b, n_words, static_cast<char*>(scratch),
      ws_bytes, static_cast<int*>(z_out), static_cast<int*>(flop_out));
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_COMMON(bitmask_symbolic)
