// Algorithm 1, FLOP per output row, in two entries that share one body:
//
//   flop_rows_launch, for one bucket's row-id list:
//     flop[i] = sum over the first max_deg_a entries k of A[rows[i], :] of
//               nnz(B[k, :])
//     Replaces: src/repro/kernels/flop_per_row.py::flop_rows_pallas
//     (_rows_kernel), which gathers a (block_rows, max_deg_a) tile of A's
//     columns and lane-reduces B's row lengths.
//   flop_per_row_launch, for all M rows in order (rows[i] = i, no list):
//     Replaces: src/repro/kernels/flop_per_row.py::flop_per_row_pallas
//     (_kernel), which does the same over contiguous blocks of rows.
//
// Both read at most max_deg_a entries of each row, as the TPU kernels do: a
// row wider than that is undercounted there and here alike.
//
// Design: narrow rows (max_deg_a <= 16) take one thread per row, which
// loops over its A entries; wider ones take one warp per row, lanes
// striding over the entries and a shuffle reduction at the end.  Sums are
// int32, as in the JAX package.
//
// Bound on the H100: bytes.  Each row reads its two row pointers (and, from
// a list, its row id), its A column ids and one B row length per entry
// (8 bytes per entry) and writes 4 bytes; there is no reuse to exploit, so
// the design only keeps the reads of a warp on neighbouring addresses (the
// warp variant reads A's column ids of a row contiguously, the thread
// variant over all rows reads the row pointers contiguously).
#include "common.cuh"

__device__ inline int flop_row_entry(int j, int start, const int* a_col,
                                     const int* rownnz_b, int k_rows) {
  const int k = a_col[start + j];
  return (k >= 0 && k < k_rows) ? rownnz_b[k] : 0;
}

// LISTED: row i of the output is rows[i]; otherwise it is row i of A.
template <bool LISTED>
__global__ void flop_rows_thread_kernel(
    const int* __restrict__ rows, int n_rows, const int* __restrict__ a_rpt,
    const int* __restrict__ a_col, const int* __restrict__ rownnz_b, int m,
    int k_rows, int max_deg_a, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  const int r = LISTED ? rows[i] : i;
  int s = 0;
  if (r >= 0 && r < m) {
    const int start = a_rpt[r];
    const int deg = min(a_rpt[r + 1] - start, max_deg_a);
    for (int j = 0; j < deg; ++j)
      s += flop_row_entry(j, start, a_col, rownnz_b, k_rows);
  }
  out[i] = s;
}

template <bool LISTED>
__global__ void flop_rows_warp_kernel(
    const int* __restrict__ rows, int n_rows, const int* __restrict__ a_rpt,
    const int* __restrict__ a_col, const int* __restrict__ rownnz_b, int m,
    int k_rows, int max_deg_a, int* __restrict__ out) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n_rows) return;  // whole warps leave together
  const int r = LISTED ? rows[i] : i;
  int s = 0;
  if (r >= 0 && r < m) {
    const int start = a_rpt[r];
    const int deg = min(a_rpt[r + 1] - start, max_deg_a);
    for (int j = lane; j < deg; j += 32)
      s += flop_row_entry(j, start, a_col, rownnz_b, k_rows);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(REPRO_FULL_MASK, s, o);
  if (lane == 0) out[i] = s;
}

template <bool LISTED>
static int flop_rows_run(const void* rows, int n_rows, const void* a_rpt,
                         const void* a_col, const void* rownnz_b, int m,
                         int k_rows, int max_deg_a, void* out, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rows_p = static_cast<const int*>(rows);
  const int* rpt_p = static_cast<const int*>(a_rpt);
  const int* col_p = static_cast<const int*>(a_col);
  const int* nb_p = static_cast<const int*>(rownnz_b);
  int* out_p = static_cast<int*>(out);
  if (max_deg_a <= 16) {
    const int grid = (n_rows + threads - 1) / threads;
    flop_rows_thread_kernel<LISTED><<<grid, threads, 0, s>>>(
        rows_p, n_rows, rpt_p, col_p, nb_p, m, k_rows, max_deg_a, out_p);
  } else {
    const long long grid = (32LL * n_rows + threads - 1) / threads;
    flop_rows_warp_kernel<LISTED>
        <<<static_cast<unsigned>(grid), threads, 0, s>>>(
            rows_p, n_rows, rpt_p, col_p, nb_p, m, k_rows, max_deg_a, out_p);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flop_rows_launch(const void* rows, int n_rows,
                                const void* a_rpt, const void* a_col,
                                const void* rownnz_b, int m, int k_rows,
                                int max_deg_a, void* out, int device,
                                void* stream) {
  return flop_rows_run<true>(rows, n_rows, a_rpt, a_col, rownnz_b, m, k_rows,
                             max_deg_a, out, device, stream);
}

// out[i] for every row i < m of A.
extern "C" int flop_per_row_launch(const void* a_rpt, const void* a_col,
                                   const void* rownnz_b, int m, int k_rows,
                                   int max_deg_a, void* out, int device,
                                   void* stream) {
  return flop_rows_run<false>(nullptr, m, a_rpt, a_col, rownnz_b, m, k_rows,
                              max_deg_a, out, device, stream);
}

REPRO_EXPORT_COMMON(flop_rows)
