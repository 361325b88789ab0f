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
//     (_kernel), which does the same over contiguous blocks of rows.  It has
//     a kernel of its own, flop_all_rows_kernel (design below).
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
//
// Design of flop_all_rows_kernel: a warp owns `rpw` consecutive rows, lane
// L row L.  rpw is a power of two up to 32, chosen in the launcher so that a
// warp reads about FLOP_ALL_ENTRIES entries on average and its rows hold at
// most FLOP_ALL_SPAN at the bound (a hub row does not hold up a warp of 31
// others).  The warp streams its rows' entries as one contiguous range,
// 32 a load, a batch of chunks at once and the next batch's column ids
// loading while this one gathers, so every entry is read once and
// coalesced whatever the rows' lengths; each chunk's B row lengths are
// prefix-summed across the warp, and row L adds the difference of that
// scan at its counted range's two ends (its first max_deg_a entries), so no
// lane looks up its row and no sum crosses a warp: no atomic, no zeroing
// pass, and each row's sum is written once, coalesced.  A row's entries
// past max_deg_a are skipped between batches (read only inside a batch).
// A warp whose counted entries run past FLOP_ALL_LONG (a quarter of that
// when the warps are too few to fill the card) loads FLOP_ALL_BATCH chunks
// a batch, any other two, which leaves the SM more warps: the choice is
// the warp's own, so a hub's warp goes long and its neighbours stay short.
// Sums are int32 (unsigned arithmetic, so they wrap as the JAX package's
// do).
#include "common.cuh"

#define FLOP_THREADS 256
// flop_per_row.py reads FLOP_NARROW from here to list a plan's wide rows
#define FLOP_NARROW 16      // rows with a bound up to this take one thread
#define FLOP_TABLE 12288    // bucket bounds held in (dynamic) shared memory
// flop_all_rows_kernel: the entries a warp aims at (its rows: this over the
// mean degree, 32 at most), the most its rows may hold at the bound, the
// chunks of 32 a lane loads at once on a long run, and the entries past
// which a warp's run counts as long
#define FLOP_ALL_ENTRIES 256
#define FLOP_ALL_SPAN 6400
#define FLOP_ALL_BATCH 8
#define FLOP_ALL_LONG 512

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

// flop_all_rows_kernel's stream over a warp's counted entries [c0, last):
// lane L's row counts [s, e); BATCH chunks of 32 entries are loaded at once
// and the next batch's column ids while this one gathers.  Returns lane
// L's sum.
template <int BATCH>
__device__ __forceinline__ unsigned flop_all_stream(
    int c0, int last, int s, int e, const int* __restrict__ a_col,
    const int* __restrict__ rownnz_b, int k_rows) {
  const int lane = threadIdx.x & 31;
  // the first counted entry at or past p (last when there is none)
  auto next_start = [&](int p) {
    return __reduce_min_sync(REPRO_FULL_MASK, e > p ? max(s, p) : last);
  };
  unsigned acc = 0;
  int k[BATCH];
#pragma unroll
  for (int b = 0; b < BATCH; ++b) {
    const int j = c0 + 32 * b + lane;
    k[b] = j < last ? a_col[j] : -1;
  }
  while (c0 < last) {
    const int c1 = next_start(c0 + 32 * BATCH);
    int k1[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int j = c1 + 32 * b + lane;
      k1[b] = j < last ? a_col[j] : -1;
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b)
      k[b] = (k[b] >= 0 && k[b] < k_rows) ? rownnz_b[k[b]] : 0;
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      // inclusive scan of the chunk's lengths; row L's share of the chunk
      // is the scan at its last counted entry less the scan before its first
      unsigned x = static_cast<unsigned>(k[b]);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(REPRO_FULL_MASK, x, o);
        if (lane >= o) x += y;
      }
      const int cb = c0 + 32 * b;
      const int lo = max(s - cb, 0), hi = min(e - cb, 32);
      const unsigned at_hi =
          __shfl_sync(REPRO_FULL_MASK, x, min(max(hi - 1, 0), 31));
      const unsigned at_lo =
          __shfl_sync(REPRO_FULL_MASK, x, min(max(lo - 1, 0), 31));
      if (lo < hi) acc += at_hi - (lo > 0 ? at_lo : 0u);
    }
    c0 = c1;
#pragma unroll
    for (int b = 0; b < BATCH; ++b) k[b] = k1[b];
  }
  return acc;
}

// flop_per_row_launch's kernel: warp w owns rows [w * rpw, w * rpw + rpw),
// lane L row w * rpw + L.  A warp whose counted entries run past long_run
// streams them FLOP_ALL_BATCH chunks at a time, any other two.
__global__ void __launch_bounds__(FLOP_THREADS) flop_all_rows_kernel(
    const int* __restrict__ a_rpt, const int* __restrict__ a_col,
    const int* __restrict__ rownnz_b, int m, int k_rows, int max_deg_a,
    int rpw, int long_run, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long r0 =
      ((static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) *
      rpw;
  if (r0 >= m) return;  // whole warps leave together
  const int n = static_cast<int>(min(static_cast<long long>(rpw), m - r0));
  // lane L < n: row r0 + L counts entries [s, e); the other lanes none
  int s = a_rpt[r0], e = s;
  if (lane < n) {
    s = a_rpt[r0 + lane];
    e = s + max(0, min(a_rpt[r0 + lane + 1] - s, max_deg_a));
  }
  const int last = __reduce_max_sync(REPRO_FULL_MASK, e);
  const int c0 = __reduce_min_sync(REPRO_FULL_MASK, e > s ? s : last);
  const unsigned acc =
      last - c0 > long_run
          ? flop_all_stream<FLOP_ALL_BATCH>(c0, last, s, e, a_col, rownnz_b,
                                            k_rows)
          : flop_all_stream<2>(c0, last, s, e, a_col, rownnz_b, k_rows);
  if (lane < n) out[r0 + lane] = static_cast<int>(acc);
}

// out[i] for every row i < m of A, whose col array holds n_entries entries
// (sets the rows a warp takes).
extern "C" int flop_per_row_launch(const void* a_rpt, const void* a_col,
                                   const void* rownnz_b, int m, int k_rows,
                                   int max_deg_a, long long n_entries,
                                   void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0) return 0;
  // rows a warp: the largest power of two up to 32 whose rows hold at most
  // FLOP_ALL_ENTRIES entries on average and FLOP_ALL_SPAN at the bound
  const long long per = static_cast<long long>(FLOP_ALL_ENTRIES) * m /
                        max(1LL, n_entries);
  int rpw = 1;
  while (rpw < 32 && 2LL * rpw <= per &&
         2LL * rpw * max_deg_a <= FLOP_ALL_SPAN)
    rpw <<= 1;
  const long long warps = (m + rpw - 1) / rpw;
  const long long grid = (32 * warps + FLOP_THREADS - 1) / FLOP_THREADS;
  // a warp's run counts as long past FLOP_ALL_LONG entries, or past a
  // quarter of that when the warps are too few to fill the card (more
  // loads in flight a warp then hide the latency the card cannot)
  int sms = 0, threads_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&threads_sm,
                               cudaDevAttrMaxThreadsPerMultiProcessor, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool few = warps < static_cast<long long>(sms) * (threads_sm / 32);
  flop_all_rows_kernel<<<static_cast<unsigned>(grid), FLOP_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a_rpt), static_cast<const int*>(a_col),
      static_cast<const int*>(rownnz_b), m, k_rows, max_deg_a, rpw,
      few ? FLOP_ALL_LONG / 4 : FLOP_ALL_LONG, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT_COMMON(flop_rows)
