// Fused Algorithm 1 + Algorithm 2 (ESC symbolic) for one bucket's sampled
// rows: per sampled row, its product count f, its distinct product columns
// z and its FLOP.
//
// Replaces: src/repro/kernels/spgemm_symbolic.py::fused_flop_symbolic_pallas
// (_fused_kernel), which gathers a (BS, next_pow2(DA*DB)) block, bitonic-sorts
// it along lanes and counts strict ascents.
//
// Design: one thread block per sampled row.  The block gathers exactly the
// row's products (not the bucket's padded DA*DB lanes) into its workspace,
// bitonic-sorts next_pow2(n) keys and counts the first key plus the strict
// ascents.  Each row writes its own z and FLOP; the wrapper sums them, so no
// atomics decide the order of anything.
//
// Bound on the H100: bytes.  Every product column is read once from B
// (4 bytes each) plus A's row slice and B's row lengths; the sort runs in
// shared memory when next_pow2(DA*DB) keys fit the 227 KB opt-in limit, so
// the device traffic is the gather itself.  Wider buckets (power-law hubs)
// sort in a global scratch slice and pay its L2/HBM traffic per stage.
#include "common.cuh"

__global__ void __launch_bounds__(1024) esc_symbolic_kernel(
    const int* __restrict__ rows, int n_rows, const int* __restrict__ a_rpt,
    const int* __restrict__ a_col, const int* __restrict__ b_rpt,
    const int* __restrict__ b_col, const int* __restrict__ rownnz_b, int m,
    int k_rows, int max_deg_a, int max_deg_b, char* scratch,
    long long ws_bytes, int* __restrict__ z_out, int* __restrict__ flop_out) {
  extern __shared__ __align__(16) char smem[];
  char* ws = scratch ? scratch + blockIdx.x * ws_bytes : smem;
  int* prefix = reinterpret_cast<int*>(ws);
  int* keys = reinterpret_cast<int*>(
      ws + repro_align16(4LL * (max_deg_a + 1)));
  for (int ri = blockIdx.x; ri < n_rows; ri += gridDim.x) {
    int flop;
    const int n = repro_gather_row<false>(
        rows[ri], a_rpt, a_col, nullptr, b_rpt, b_col, nullptr, rownnz_b, m,
        k_rows, max_deg_a, max_deg_b, prefix, keys, nullptr, &flop);
    repro_bitonic_sort<false>(keys, nullptr, repro_next_pow2(max(n, 1)));
    int local = 0;
    for (int p = threadIdx.x; p < n; p += blockDim.x)
      local += (p == 0 || keys[p] != keys[p - 1]) ? 1 : 0;
    int z;
    repro_block_exclusive_scan(local, &z);
    if (threadIdx.x == 0) {
      z_out[ri] = z;
      flop_out[ri] = flop;
    }
    // the scan's trailing barrier keeps the next row off this workspace
  }
}

extern "C" int esc_symbolic_launch(
    const void* rows, int n_rows, const void* a_rpt, const void* a_col,
    const void* b_rpt, const void* b_col, const void* rownnz_b, int m,
    int k_rows, int max_deg_a, int max_deg_b, void* scratch,
    long long ws_bytes, int grid, int threads, int smem_bytes, void* z_out,
    void* flop_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(esc_symbolic_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  esc_symbolic_kernel<<<grid, threads, smem_bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), n_rows, static_cast<const int*>(a_rpt),
      static_cast<const int*>(a_col), static_cast<const int*>(b_rpt),
      static_cast<const int*>(b_col), static_cast<const int*>(rownnz_b), m,
      k_rows, max_deg_a, max_deg_b, static_cast<char*>(scratch), ws_bytes,
      static_cast<int*>(z_out), static_cast<int*>(flop_out));
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_COMMON(esc_symbolic)
