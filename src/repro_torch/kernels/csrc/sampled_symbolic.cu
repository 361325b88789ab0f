// Algorithm 2 (ESC symbolic) over the sampled rows at the global degree
// bounds: per sampled row, its gathered product count f and its distinct
// product columns z.
//
// Replaces: src/repro/kernels/spgemm_symbolic.py::sampled_symbolic_pallas
// (_kernel), which gathers a (BS, next_pow2(DA*DB)) block at the global
// bounds, bitonic-sorts it along lanes, counts strict ascents (z*) and counts
// the gathered products (f*: each B row read to at most DB entries, so f*
// is the truncated product count, not Algorithm 1's FLOP).
//
// Design: one thread block per sampled row, as esc_symbolic.cu, but without
// the FLOP output and with a workspace sized for the rows it is given rather
// than for the global pad.  At global bounds next_pow2(DA*DB) is 2^20 lanes
// on R-MAT's square while its widest row has 39,194 products: the wrapper
// sizes the workspace from the sampled rows' largest FLOP (a bound on their
// gathered products).  Each row's keys sort in shared memory when
// next_pow2(n) fits the smem_lanes the launch reserved there, and only
// wider rows sort in the block's global scratch slice.  The row's product
// prefix stays in shared memory unless even it does not fit (smem_lanes < 0;
// it then heads the scratch slice).  Each row writes its own z and f and the
// wrapper sums them, so z* equals the ESC kernel's bit for bit.
//
// Bound on the H100: bytes.  Every gathered product column is read once
// from B (4 bytes), plus A's row slice and B's row pointers and lengths; the
// sort is on-chip for every row that fits shared memory.
#include "common.cuh"

__global__ void __launch_bounds__(1024) sampled_symbolic_kernel(
    const int* __restrict__ rows, int n_rows, const int* __restrict__ a_rpt,
    const int* __restrict__ a_col, const int* __restrict__ b_rpt,
    const int* __restrict__ b_col, const int* __restrict__ rownnz_b, int m,
    int k_rows, int max_deg_a, int max_deg_b, int smem_lanes, char* scratch,
    long long slice_bytes, int* __restrict__ z_out, int* __restrict__ f_out) {
  extern __shared__ __align__(16) char smem[];
  const long long pre_bytes = repro_align16(4LL * (max_deg_a + 1));
  char* slice = scratch ? scratch + blockIdx.x * slice_bytes : nullptr;
  const bool pre_in_smem = smem_lanes >= 0;
  int* prefix = reinterpret_cast<int*>(pre_in_smem ? smem : slice);
  int* keys_smem = reinterpret_cast<int*>(smem + pre_bytes);
  int* keys_scratch = slice ? reinterpret_cast<int*>(
                                  slice + (pre_in_smem ? 0 : pre_bytes))
                            : nullptr;
  for (int ri = blockIdx.x; ri < n_rows; ri += gridDim.x) {
    int start, deg, flop;
    const int n = repro_row_prefix(rows[ri], a_rpt, a_col, rownnz_b, m,
                                   k_rows, max_deg_a, max_deg_b, prefix,
                                   &start, &deg, &flop);
    const int n2 = repro_next_pow2(max(n, 1));
    int* keys = n2 <= smem_lanes ? keys_smem : keys_scratch;
    repro_gather_products<false>(n, deg, prefix, start, a_col, nullptr,
                                 b_rpt, b_col, nullptr, keys, nullptr);
    repro_bitonic_sort<false>(keys, nullptr, n2);
    int local = 0;
    for (int p = threadIdx.x; p < n; p += blockDim.x)
      local += (p == 0 || keys[p] != keys[p - 1]) ? 1 : 0;
    int z;
    repro_block_exclusive_scan(local, &z);
    if (threadIdx.x == 0) {
      z_out[ri] = z;
      f_out[ri] = n;
    }
    // the scan's trailing barrier keeps the next row off this workspace
  }
}

extern "C" int sampled_symbolic_launch(
    const void* rows, int n_rows, const void* a_rpt, const void* a_col,
    const void* b_rpt, const void* b_col, const void* rownnz_b, int m,
    int k_rows, int max_deg_a, int max_deg_b, int smem_lanes, void* scratch,
    long long slice_bytes, int grid, int threads, int smem_bytes, void* z_out,
    void* f_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(sampled_symbolic_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  sampled_symbolic_kernel<<<grid, threads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), n_rows, static_cast<const int*>(a_rpt),
      static_cast<const int*>(a_col), static_cast<const int*>(b_rpt),
      static_cast<const int*>(b_col), static_cast<const int*>(rownnz_b), m,
      k_rows, max_deg_a, max_deg_b, smem_lanes, static_cast<char*>(scratch),
      slice_bytes, static_cast<int*>(z_out), static_cast<int*>(f_out));
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_COMMON(sampled_symbolic)
