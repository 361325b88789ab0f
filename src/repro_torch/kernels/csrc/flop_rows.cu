// Algorithm 1, FLOP per output row, in three entries:
//
//   flop_rows_launch, for one bucket's row-id list:
//     flop[i] = sum over the first max_deg_a entries k of A[rows[i], :] of
//               nnz(B[k, :])
//     Replaces: src/repro/kernels/flop_per_row.py::flop_rows_pallas
//     (_rows_kernel), which gathers a (block_rows, max_deg_a) tile of A's
//     columns and lane-reduces B's row lengths.
//   flop_rows_buckets_launch, for all M rows of a binned plan in one launch:
//     row i reads at most deg_tab[row_bucket[i]] entries, its bucket's bound,
//     so the output is what flop_rows_pallas gives bucket by bucket, already
//     in row order (no concatenation, no inverse permutation).  The same
//     kernel body as flop_rows_launch.
//   flop_per_row_launch, for all M rows at one bound (rows[i] = i, no list):
//     Replaces: src/repro/kernels/flop_per_row.py::flop_per_row_pallas
//     (_kernel), which does the same over contiguous blocks of rows.  It
//     keeps two kernels of its own, a thread a row or a warp a row: on the
//     body the other two share, its device time on an H100 grew by 1-4%.
//
// Each reads at most its row's bound of A entries, as the TPU kernels do: a
// row wider than that is undercounted there and here alike.
//
// Design of the shared body: one launch has two parts.  The first
// `thread_blocks` blocks take one output row a thread, in order (`n` rows),
// and each thread loops over its row's A entries; it skips rows whose bound
// is past FLOP_NARROW, which the second part takes: one warp a row, lanes
// striding over the entries and a shuffle reduction at the end.  A binned
// plan lists the rows of its buckets whose bound is past FLOP_NARROW (the
// wrapper caches the list with the plan), so narrow and wide buckets run in
// the same launch, each on the unit the per-bucket launches gave it; one
// bucket's list runs in one of the two parts.  The bucket bounds sit in
// dynamic shared memory.  Sums are int32, as in the JAX package.
//
// Bound on the H100: bytes.  Each row reads its two row pointers (and its
// row id from a list, or its bucket id), its A column ids and one B row
// length per entry (8 bytes per entry) and writes 4 bytes; there is no reuse
// to exploit, so the design only keeps the reads of a warp on neighbouring
// addresses (the warp part reads a row's A column ids contiguously, the
// thread part reads the row pointers and bucket ids contiguously).
#include "common.cuh"

#define FLOP_THREADS 256
// flop_per_row.py reads FLOP_NARROW from here to list a plan's wide rows
#define FLOP_NARROW 16      // rows with a bound up to this take one thread
#define FLOP_TABLE 12288    // bucket bounds held in (dynamic) shared memory

__device__ inline int flop_row_entry(int j, int start, const int* a_col,
                                     const int* rownnz_b, int k_rows) {
  const int k = a_col[start + j];
  return (k >= 0 && k < k_rows) ? rownnz_b[k] : 0;
}

// TABLE: output row i is A's row i, its bound deg_tab[row_bucket[i]] (held
// in shared memory when the table has at most FLOP_TABLE buckets), and the
// warp part takes the output rows listed in wide.  Else output row i is A's
// row rows[i], every bound is max_deg_a, and the warp part takes rows 0 ..
// n_wide - 1.
template <bool TABLE>
__global__ void __launch_bounds__(FLOP_THREADS) flop_rows_kernel(
    const int* __restrict__ rows, int n, const int* __restrict__ row_bucket,
    const int* __restrict__ deg_tab, int n_tab, int max_deg_a,
    const int* __restrict__ wide, int n_wide, int thread_blocks,
    const int* __restrict__ a_rpt, const int* __restrict__ a_col,
    const int* __restrict__ rownnz_b, int m, int k_rows,
    int* __restrict__ out) {
  extern __shared__ int s_deg[];
  const bool tab_in_smem = TABLE && n_tab <= FLOP_TABLE;
  if (tab_in_smem) {
    for (int b = threadIdx.x; b < n_tab; b += blockDim.x)
      s_deg[b] = deg_tab[b];
    __syncthreads();
  }
  // the kernel has no barrier past this point
  auto bound_of = [&](int i) {
    if (!TABLE) return max_deg_a;
    const int b = row_bucket[i];
    return tab_in_smem ? s_deg[b] : deg_tab[b];
  };
  if (static_cast<int>(blockIdx.x) < thread_blocks) {
    const int i = blockIdx.x * FLOP_THREADS + threadIdx.x;
    if (i >= n) return;
    const int bound = bound_of(i);
    if (TABLE && bound > FLOP_NARROW) return;   // the warp part's row
    const int r = TABLE ? i : rows[i];
    int s = 0;
    if (r >= 0 && r < m) {
      const int start = a_rpt[r];
      const int deg = min(a_rpt[r + 1] - start, bound);
      for (int j = 0; j < deg; ++j)
        s += flop_row_entry(j, start, a_col, rownnz_b, k_rows);
    }
    out[i] = s;
    return;
  }
  const int w = (blockIdx.x - thread_blocks) * (FLOP_THREADS / 32) +
                (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= n_wide) return;  // whole warps leave together
  const int i = TABLE ? wide[w] : w;
  const int r = TABLE ? i : rows[i];
  int s = 0;
  if (r >= 0 && r < m) {
    const int start = a_rpt[r];
    const int deg = min(a_rpt[r + 1] - start, bound_of(i));
    for (int j = lane; j < deg; j += 32)
      s += flop_row_entry(j, start, a_col, rownnz_b, k_rows);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(REPRO_FULL_MASK, s, o);
  if (lane == 0) out[i] = s;
}

template <bool TABLE>
static int flop_rows_run(const void* rows, int n, const void* row_bucket,
                         const void* deg_tab, int n_tab, int max_deg_a,
                         const void* wide, int n_wide, int thread_blocks,
                         const void* a_rpt, const void* a_col,
                         const void* rownnz_b, int m, int k_rows, void* out,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long warp_blocks =
      (static_cast<long long>(n_wide) + FLOP_THREADS / 32 - 1) /
      (FLOP_THREADS / 32);
  const long long grid = thread_blocks + warp_blocks;
  if (grid <= 0) return 0;
  const int smem = TABLE && n_tab <= FLOP_TABLE ? 4 * n_tab : 0;
  flop_rows_kernel<TABLE>
      <<<static_cast<unsigned>(grid), FLOP_THREADS, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(rows), n,
          static_cast<const int*>(row_bucket),
          static_cast<const int*>(deg_tab), n_tab, max_deg_a,
          static_cast<const int*>(wide), n_wide, thread_blocks,
          static_cast<const int*>(a_rpt), static_cast<const int*>(a_col),
          static_cast<const int*>(rownnz_b), m, k_rows,
          static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// One bucket's list at its bound: a thread a row up to FLOP_NARROW, else a
// warp a row.
extern "C" int flop_rows_launch(const void* rows, int n_rows,
                                const void* a_rpt, const void* a_col,
                                const void* rownnz_b, int m, int k_rows,
                                int max_deg_a, void* out, int device,
                                void* stream) {
  const bool narrow = max_deg_a <= FLOP_NARROW;
  return flop_rows_run<false>(
      rows, n_rows, nullptr, nullptr, 0, max_deg_a, nullptr,
      narrow ? 0 : n_rows,
      narrow ? (n_rows + FLOP_THREADS - 1) / FLOP_THREADS : 0, a_rpt, a_col,
      rownnz_b, m, k_rows, out, device, stream);
}

// out[i] for every row i < n of a binned plan: row_bucket (n,) and the
// bucket bounds deg_tab (n_tab,); wide (n_wide,) the rows whose bound is
// past FLOP_NARROW, ascending.
extern "C" int flop_rows_buckets_launch(const void* row_bucket, int n,
                                        const void* deg_tab, int n_tab,
                                        const void* wide, int n_wide,
                                        const void* a_rpt, const void* a_col,
                                        const void* rownnz_b, int m,
                                        int k_rows, void* out, int device,
                                        void* stream) {
  return flop_rows_run<true>(
      nullptr, n, row_bucket, deg_tab, n_tab, 0, wide, n_wide,
      (n + FLOP_THREADS - 1) / FLOP_THREADS, a_rpt, a_col, rownnz_b, m,
      k_rows, out, device, stream);
}

// flop_per_row_launch's own kernels (kept off the shared body, see above):
// a thread or a warp a row, output row i is row i of A.
__global__ void flop_rows_thread_kernel(const int* __restrict__ a_rpt,
                                        const int* __restrict__ a_col,
                                        const int* __restrict__ rownnz_b,
                                        int m, int k_rows, int max_deg_a,
                                        int* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m) return;
  const int start = a_rpt[r];
  const int deg = min(a_rpt[r + 1] - start, max_deg_a);
  int s = 0;
  for (int j = 0; j < deg; ++j)
    s += flop_row_entry(j, start, a_col, rownnz_b, k_rows);
  out[r] = s;
}

__global__ void flop_rows_warp_kernel(const int* __restrict__ a_rpt,
                                      const int* __restrict__ a_col,
                                      const int* __restrict__ rownnz_b,
                                      int m, int k_rows, int max_deg_a,
                                      int* __restrict__ out) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= m) return;  // whole warps leave together
  const int start = a_rpt[r];
  const int deg = min(a_rpt[r + 1] - start, max_deg_a);
  int s = 0;
  for (int j = lane; j < deg; j += 32)
    s += flop_row_entry(j, start, a_col, rownnz_b, k_rows);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(REPRO_FULL_MASK, s, o);
  if (lane == 0) out[r] = s;
}

// out[i] for every row i < m of A.
extern "C" int flop_per_row_launch(const void* a_rpt, const void* a_col,
                                   const void* rownnz_b, int m, int k_rows,
                                   int max_deg_a, void* out, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rpt_p = static_cast<const int*>(a_rpt);
  const int* col_p = static_cast<const int*>(a_col);
  const int* nb_p = static_cast<const int*>(rownnz_b);
  int* out_p = static_cast<int*>(out);
  if (max_deg_a <= FLOP_NARROW) {
    const int grid = (m + threads - 1) / threads;
    flop_rows_thread_kernel<<<grid, threads, 0, s>>>(
        rpt_p, col_p, nb_p, m, k_rows, max_deg_a, out_p);
  } else {
    const long long grid = (32LL * m + threads - 1) / threads;
    flop_rows_warp_kernel<<<static_cast<unsigned>(grid), threads, 0, s>>>(
        rpt_p, col_p, nb_p, m, k_rows, max_deg_a, out_p);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_COMMON(flop_rows)
