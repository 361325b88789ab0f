// ESC numeric phase for one bucket's rows, compaction fused into the
// epilogue: per output row, the ascending distinct columns and their value
// sums written straight into the row's row_capacity slots, plus the row's
// true nnz (which may exceed the capacity).
//
// Replaces: src/repro/kernels/spgemm_numeric.py::spgemm_numeric_pallas
// (_kernel) and the XLA-side compact() that scatters its uncompacted
// (R, next_pow2(DA*DB)) buffers into the capacity slots.
//
// Bound on the H100: bytes.  The necessary traffic is A's and B's entries
// that the rows reference (8 bytes per product gathered) and the output
// slots (8 bytes each).  What the first port lost to it (measured by FLOP
// class, tools/numeric_splits.py): one block of up to 1,024 threads per row with a barrier
// at every stage of a bitonic sort over next_pow2(n) lanes, so a row of a
// few products paid a whole block; a workspace sized by the bucket's degree
// bounds, so hub buckets sorted every row in global scratch; and long rows
// sorted by one block's bitonic network, O(n log^2 n) passes over shared
// memory.
//
// Design: the unit of work follows each row's product count n, which the
// kernel computes itself; the wrapper sizes every workspace from a bound on
// the launched rows' n passed with the call, and holds exactly n pairs.
//   1. esc_numeric_warp_kernel: a group of lanes per row (4 to 32: two
//      products a lane up to a warp, so a warp holds up to eight short rows
//      in flight), 256 threads a block.  The group counts n; a row with
//      n <= warp_pairs (at most ESC_WARP_MAX) gathers its pairs into the
//      group's own shared memory (`group` A entries staged at a time, one
//      independent load a product), sorts them with the bitonic network in
//      its flip form (syncs of the group's lanes only) and sums its runs.
//      Longer rows go, with n, to one of two lists in global memory.
//   2. esc_numeric_block_kernel: persistent grids of blocks that pull the
//      listed rows: 256 threads for rows of up to mid_pairs products, and,
//      when the call's bound passes that, 1,024 threads for the longer
//      rows.  A row whose column extent is narrow (banded and FEM rows)
//      adds its products into dense per-warp partial rows over the extent,
//      each warp taking every nw-th A entry in order, then adds the
//      partials in warp order.  Any other row is partitioned stably
//      (repro_bin_partition) into column ranges: ranges of tile_n columns
//      when at most max_bins of them cover the extent, each reduced in a
//      warp's dense tile (repro_warp_bin_dense), which collapses a hub
//      column's many products in one pass; else ranges of about 32
//      products, each sorted by a warp.  A block scan over the ranges'
//      distinct counts places them in the slots.  The pairs sit in shared
//      memory when the row's own fit beside the tables, else in the block's
//      slice of global scratch (sized by the call's bound), else in one
//      spill slice of the degree bounds' pairs taken under a lock, so a
//      wrong bound costs time and never memory.  With a bound no larger than
//      warp_pairs no block kernel runs: a warp spills such a row itself.
// Every row's sums are taken in a fixed order (sorted runs left to right;
// dense partials and tiles in product order, then in warp order), so val is
// bitwise the same from run to run.
#include "common.cuh"

#define ESC_WARP_THREADS 256  // threads a block of the warp kernel
#define ESC_WARP_MAX 1024     // products a warp sorts on its own

// ctl, int32 [8 + 2 * n_rows], the first 8 zeroed by the launcher:
// [0, 1] the first list's length and next entry, [2] the spill lock, [3]
// the entries dropped for capacity, [4, 5] the second list's length and
// next entry; then the lists of (row index, products), the first from the
// front, the second from the back.
__device__ inline int* esc_list_entry(int* ctl, int list, int i, int n_rows) {
  return ctl + 8 + 2 * (list ? n_rows - 1 - i : i);
}

__device__ inline void esc_finish_row(int* ctl, int ri, int nnz, int cap,
                                      int* __restrict__ row_nnz) {
  row_nnz[ri] = nnz;
  if (nnz > cap) atomicAdd(&ctl[3], nnz - cap);
}

template <int group>
__global__ void __launch_bounds__(ESC_WARP_THREADS) esc_numeric_warp_kernel(
    const int* __restrict__ rows, int n_rows, const int* __restrict__ a_rpt,
    const int* __restrict__ a_col, const float* __restrict__ a_val,
    const int* __restrict__ b_rpt, const int* __restrict__ b_col,
    const float* __restrict__ b_val, const int* __restrict__ rownnz_b, int m,
    int k_rows, int max_deg_a, int max_deg_b, int row_capacity,
    int warp_pairs, int mid_pairs, char* spill, int* __restrict__ ctl,
    int* __restrict__ out_col, float* __restrict__ out_val,
    int* __restrict__ row_nnz) {
  extern __shared__ __align__(16) char smem[];
  const ReproGroup g = repro_group(group);
  const int gi = threadIdx.x / group;          // the group's row in the block
  const int ri = blockIdx.x * (ESC_WARP_THREADS / group) + gi;
  if (ri >= n_rows) return;           // this kernel has no block barrier
  char* region = smem + static_cast<long long>(gi) *
                            (12LL * group + 8LL * warp_pairs);
  int* s_off = reinterpret_cast<int*>(region);
  int* s_e0 = s_off + group;
  float* s_av = reinterpret_cast<float*>(s_e0 + group);
  int* keys = reinterpret_cast<int*>(region + 12LL * group);
  float* vals = reinterpret_cast<float*>(keys + warp_pairs);
  const int r = rows[ri];
  int start = 0, deg = 0;
  if (r >= 0 && r < m) {
    start = a_rpt[r];
    deg = min(a_rpt[r + 1] - start, max_deg_a);
  }
  // 1. the row's products
  int n = 0;
  for (int j0 = 0; j0 < deg; j0 += group) {
    const int j = j0 + g.lane;
    int len = 0;
    if (j < deg) {
      const int k = a_col[start + j];
      if (k >= 0 && k < k_rows) len = min(rownnz_b[k], max_deg_b);
    }
    n += __reduce_add_sync(g.mask, len);
  }
  // a row past warp_pairs goes to a block kernel's list, or, when the call
  // launches none (its bound says no row is that long), to the spill
  // slice, one group at a time
  const bool spilled = n > warp_pairs && mid_pairs < 0;
  if (n > warp_pairs && !spilled) {
    if (g.lane == 0) {
      const int list = n > mid_pairs;
      int* e = esc_list_entry(ctl, list, atomicAdd(&ctl[4 * list], 1),
                              n_rows);
      e[0] = ri;
      e[1] = n;
    }
    return;
  }
  if (spilled) {
    if (g.lane == 0)
      while (atomicCAS(&ctl[2], 0, 1) != 0) __nanosleep(200);
    __syncwarp(g.mask);
    __threadfence();
    keys = reinterpret_cast<int*>(spill);
    vals = reinterpret_cast<float*>(spill + 4LL * n);
  }
  // 2. gather: `group` A entries at a time are staged (offset of their
  //    first product, B row start, A value); each lane then takes products
  //    p, p + group, ... and finds its entry by binary search, so all loads
  //    of a round are independent
  int base = 0;
  for (int j0 = 0; j0 < deg; j0 += group) {
    const int j = j0 + g.lane;
    int len = 0, e0 = 0;
    float av = 0.0f;
    if (j < deg) {
      const int k = a_col[start + j];
      av = a_val[start + j];
      if (k >= 0 && k < k_rows) {
        len = min(rownnz_b[k], max_deg_b);
        e0 = b_rpt[k];
      }
    }
    int total;
    s_off[g.lane] = repro_warp_exclusive_scan(len, &total, g);
    s_e0[g.lane] = e0;
    s_av[g.lane] = av;
    __syncwarp(g.mask);
    for (int p = g.lane; p < total; p += group) {
      int lo = 0, hi = group;   // s_off[lo] <= p < s_off[hi] (: total)
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (s_off[mid] <= p) lo = mid; else hi = mid;
      }
      const int e = s_e0[lo] + (p - s_off[lo]);
      keys[base + p] = b_col[e];
      vals[base + p] = __fmul_rn(s_av[lo], b_val[e]);
    }
    __syncwarp(g.mask);
    base += total;
  }
  // 3. sort, 4. sum the runs into the capacity slots
  repro_warp_sort(keys, vals, n, g);
  int* col_row = out_col + static_cast<long long>(ri) * row_capacity;
  float* val_row = out_val + static_cast<long long>(ri) * row_capacity;
  const int nnz = repro_warp_emit_runs(keys, vals, n, 0, row_capacity,
                                       col_row, val_row, g);
  for (int s = min(nnz, row_capacity) + g.lane; s < row_capacity;
       s += group) {
    col_row[s] = REPRO_SENTINEL;
    val_row[s] = 0.0f;
  }
  if (g.lane == 0) esc_finish_row(ctl, ri, nnz, row_capacity, row_nnz);
  if (spilled) {
    __syncwarp(g.mask);
    __threadfence();
    if (g.lane == 0) atomicExch(&ctl[2], 0);
  }
}

__global__ void __launch_bounds__(1024) esc_numeric_block_kernel(
    int list, const int* __restrict__ rows, int n_rows,
    const int* __restrict__ a_rpt,
    const int* __restrict__ a_col, const float* __restrict__ a_val,
    const int* __restrict__ b_rpt, const int* __restrict__ b_col,
    const float* __restrict__ b_val, const int* __restrict__ rownnz_b, int m,
    int k_rows, int max_deg_a, int max_deg_b, int row_capacity,
    int tile_n, int max_bins, int smem_bytes, int smem_pairs, char* scratch,
    long long slice_bytes, long long slice_pairs, char* spill,
    int* __restrict__ ctl, int* __restrict__ out_col,
    float* __restrict__ out_val, int* __restrict__ row_nnz) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int s_ri, s_n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, w = tid >> 5, nw = nt >> 5;
  // shared memory: the warps' tiles, then the tables when they fit, then
  // the pairs; else the tables head the block's scratch slice.  The tables:
  // the row's product prefix, its A entries' B-row starts and values, the
  // column ranges' starts and the warps' counts of them
  float* tile = reinterpret_cast<float*>(smem) + w * (tile_n + (tile_n >> 5));
  unsigned* tile_pres = reinterpret_cast<unsigned*>(tile + tile_n);
  const long long tiles_bytes = 4LL * nw * (tile_n + (tile_n >> 5));
  const long long pre = repro_align16(4LL * (max_deg_a + 1));
  const long long starts_bytes = repro_align16(4LL * (max_bins + 1));
  const long long tables_bytes =
      3 * pre + starts_bytes + repro_align16(4LL * nw * max_bins);
  char* slice = scratch ? scratch + blockIdx.x * slice_bytes : nullptr;
  char* tables = smem_pairs >= 0 ? smem + tiles_bytes : slice;
  int* prefix = reinterpret_cast<int*>(tables);
  int* e0 = reinterpret_cast<int*>(tables + pre);
  float* av = reinterpret_cast<float*>(tables + 2 * pre);
  int* bin_start = reinterpret_cast<int*>(tables + 3 * pre);
  int* hist = reinterpret_cast<int*>(tables + 3 * pre + starts_bytes);
  for (int l = lane; l < tile_n; l += 32) tile[l] = 0.0f;
  for (int l = lane; l < (tile_n >> 5); l += 32) tile_pres[l] = 0u;
  for (;;) {
    if (tid == 0) {
      const int i = atomicAdd(&ctl[4 * list + 1], 1);
      const int* e = esc_list_entry(ctl, list, i, n_rows);
      s_ri = i < ctl[4 * list] ? e[0] : -1;
      s_n = i < ctl[4 * list] ? e[1] : 0;
    }
    __syncthreads();
    const int ri = s_ri, n = s_n;
    if (ri < 0) break;
    const int r = rows[ri];
    int start = 0, deg = 0;
    if (r >= 0 && r < m) {
      start = a_rpt[r];
      deg = min(a_rpt[r + 1] - start, max_deg_a);
    }
    int* col_row = out_col + static_cast<long long>(ri) * row_capacity;
    float* val_row = out_val + static_cast<long long>(ri) * row_capacity;
    int lo, hi;
    repro_row_extent(start, deg, a_col, b_rpt, b_col, rownnz_b, k_rows,
                     max_deg_b, &lo, &hi);
    const int span_p = (hi - lo + 32) & ~31;   // hi >= lo: the row has n > 0
    int nnz;
    if (tiles_bytes + 4LL * (nw + 1) * span_p <= smem_bytes &&
        static_cast<long long>(nw) * span_p <= 2LL * n) {
      // a narrow extent: dense partial rows, one a warp, over it
      float* acc = reinterpret_cast<float*>(smem + tiles_bytes);
      unsigned* pres = reinterpret_cast<unsigned*>(acc + nw * span_p);
      const int words = span_p >> 5;
      for (int i = tid; i < nw * span_p; i += nt) acc[i] = 0.0f;
      for (int i = tid; i < words; i += nt) pres[i] = 0u;
      __syncthreads();
      float* mine = acc + w * span_p;
      for (int j = w; j < deg; j += nw) {
        const int k = a_col[start + j];
        if (k < 0 || k >= k_rows) continue;
        const int len = min(rownnz_b[k], max_deg_b);
        const int eb = b_rpt[k];
        const float a = a_val[start + j];
        // one A entry's products have distinct columns: no lane collides
        for (int t = lane; t < len; t += 32) {
          const int c = b_col[eb + t] - lo;
          mine[c] = __fadd_rn(mine[c], __fmul_rn(a, b_val[eb + t]));
          atomicOr(&pres[c >> 5], 1u << (c & 31));
        }
        __syncwarp();
      }
      __syncthreads();
      for (int c = tid; c < span_p; c += nt) {
        float s = acc[c];
        for (int v = 1; v < nw; ++v) s = __fadd_rn(s, acc[v * span_p + c]);
        acc[c] = s;
      }
      __syncthreads();
      nnz = repro_compact_tile(acc, pres, words, 0, row_capacity, lo,
                               col_row, val_row);
    } else {
      // a stable partition of the pairs into at most max_bins column
      // ranges; each warp reduces its ranges in its dense tile when
      // ranges of tile_n columns cover the extent, else sorts ranges of
      // about 32 products; a block scan over the ranges' distinct counts
      // places them in the slots
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
        repro_lock(&ctl[2]);
        pairs = spill;
        cap_pairs = n;
      }
      int* keys = reinterpret_cast<int*>(pairs);
      float* vals = reinterpret_cast<float*>(pairs + 4 * cap_pairs);
      int start2, deg2, flop;
      repro_row_prefix(r, a_rpt, a_col, rownnz_b, m, k_rows, max_deg_a,
                       max_deg_b, prefix, &start2, &deg2, &flop);
      repro_row_entries(start, deg, a_col, a_val, b_rpt, k_rows, e0, av);
      int sh = 0;
      while ((1 << sh) < tile_n && (1 << sh) < span_p) ++sh;
      const bool dense = ((hi - lo) >> sh) < max_bins;
      if (!dense)
        while (((hi - lo) >> sh) + 1 > min(max_bins, max(1, n >> 5))) ++sh;
      const int bins = ((hi - lo) >> sh) + 1;
      repro_bin_partition(n, deg, prefix, e0, av, b_col, b_val, lo, sh, bins,
                          hist, bin_start, keys, vals);
      for (int b = w; b < bins; b += nw) {
        const int s0 = bin_start[b], c = bin_start[b + 1] - s0;
        int d = 0;
        if (c == 0) {
        } else if (dense) {
          d = repro_warp_bin_dense(keys, vals, s0, c, lo + (b << sh), tile,
                                   tile_pres, tile_n >> 5);
        } else {
          repro_warp_sort(keys + s0, vals + s0, c);
          d = repro_warp_count_runs(keys + s0, c);
        }
        if (lane == 0) hist[b] = d;
      }
      __syncthreads();
      nnz = repro_block_offsets(hist, bins);
      for (int b = w; b < bins; b += nw) {
        const int s0 = bin_start[b], o = hist[b];
        if (dense) {
          const int d = hist[b + 1] - o;
          for (int i = lane; i < d && o + i < row_capacity; i += 32) {
            col_row[o + i] = keys[s0 + i];
            val_row[o + i] = vals[s0 + i];
          }
        } else if (bin_start[b + 1] > s0) {
          repro_warp_emit_runs(keys + s0, vals + s0, bin_start[b + 1] - s0,
                               o, row_capacity, col_row, val_row);
        }
      }
      if (spilled) repro_unlock(&ctl[2]);
    }
    repro_fill_tail(nnz, row_capacity, col_row, val_row);
    if (tid == 0) esc_finish_row(ctl, ri, nnz, row_capacity, row_nnz);
    __syncthreads();   // the next row's pull rewrites s_ri and the workspace
  }
}

// Dynamic shared memory above the 48 KB default needs the attribute; it is
// set once per kernel, device and size (seen[] keeps the largest).
template <typename K>
static cudaError_t esc_smem_attr(K kernel, int device, int bytes, int* seen) {
  if (device >= 0 && device < 64 && bytes <= seen[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device >= 0 && device < 64) seen[device] = bytes;
  return err;
}

// The grid of one block-kernel launch: grid_cap blocks at most, cut to what
// the card holds resident at once, as the blocks pull their rows.
static cudaError_t esc_block_grid(int device, int threads, int smem_bytes,
                                  int grid_cap, int* grid) {
  static int sms[64];
  *grid = 1;
  if (grid_cap <= 1) return cudaSuccess;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSuccess;
  if (!sms[device])
    err = cudaDeviceGetAttribute(&sms[device],
                                 cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // the two launch shapes a device sees most, remembered
  static int seen[64][2][3];
  int per_sm = 0;
  for (int i = 0; i < 2; ++i)
    if (seen[device][i][0] == threads && seen[device][i][1] == smem_bytes)
      per_sm = seen[device][i][2];
  if (!per_sm) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, esc_numeric_block_kernel, threads, smem_bytes);
    if (err != cudaSuccess) return err;
    const int slot = threads > 256;
    seen[device][slot][0] = threads;
    seen[device][slot][1] = smem_bytes;
    seen[device][slot][2] = per_sm;
  }
  *grid = max(1, min(grid_cap, max(1, per_sm) * sms[device]));
  return err;
}

// One call: the eight ctl words are zeroed, the warp kernel runs every row,
// and the block kernel runs list 0 (threads_b, smem_b, grid_b) when
// grid_b > 0 and list 1 (threads_c, smem_c, grid_c) when grid_c > 0; rows
// with more than mid_pairs products go to list 1 only then, and with no
// block launch at all the warps take every row, those past warp_pairs in
// the spill slice.
extern "C" int esc_numeric_launch(
    const void* rows, int n_rows, const void* a_rpt, const void* a_col,
    const void* a_val, const void* b_rpt, const void* b_col,
    const void* b_val, const void* rownnz_b, int m, int k_rows,
    int max_deg_a, int max_deg_b, int row_capacity, int group,
    int warp_pairs, int mid_pairs, int threads_b, int grid_b, int tile_b, int bins_b,
    int smem_b, int pairs_b, int threads_c, int grid_c, int tile_c,
    int bins_c, int smem_c, int pairs_c, void* scratch,
    long long slice_bytes, long long slice_pairs, void* spill, void* ctl,
    void* out_col, void* out_val, void* row_nnz, int device, void* stream) {
  static int seen_a[4][64], seen_b[64];
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(ctl, 0, 8 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // each group's staging of `group` A entries (12 bytes each), then its
  // warp_pairs pairs
  const int rows_a = ESC_WARP_THREADS / group;
  const int smem_a = rows_a * (12 * group + 8 * warp_pairs);
  auto* warp_kernel = group == 4    ? esc_numeric_warp_kernel<4>
                      : group == 8  ? esc_numeric_warp_kernel<8>
                      : group == 16 ? esc_numeric_warp_kernel<16>
                                    : esc_numeric_warp_kernel<32>;
  err = esc_smem_attr(warp_kernel, device, smem_a,
                      seen_a[group == 4 ? 0 : group == 8 ? 1
                             : group == 16 ? 2 : 3]);
  if (err != cudaSuccess) return static_cast<int>(err);
  warp_kernel<<<(n_rows + rows_a - 1) / rows_a, ESC_WARP_THREADS, smem_a,
                s>>>(
      static_cast<const int*>(rows), n_rows, static_cast<const int*>(a_rpt),
      static_cast<const int*>(a_col), static_cast<const float*>(a_val),
      static_cast<const int*>(b_rpt), static_cast<const int*>(b_col),
      static_cast<const float*>(b_val), static_cast<const int*>(rownnz_b), m,
      k_rows, max_deg_a, max_deg_b, row_capacity, warp_pairs,
      grid_b <= 0 ? -1 : grid_c > 0 ? mid_pairs : 0x7fffffff,
      static_cast<char*>(spill), static_cast<int*>(ctl),
      static_cast<int*>(out_col), static_cast<float*>(out_val),
      static_cast<int*>(row_nnz));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int list = 0; list < 2; ++list) {
    const int threads = list ? threads_c : threads_b;
    const int smem = list ? smem_c : smem_b;
    if ((list ? grid_c : grid_b) <= 0) break;
    err = esc_smem_attr(esc_numeric_block_kernel, device, smem, seen_b);
    if (err != cudaSuccess) return static_cast<int>(err);
    int grid;
    err = esc_block_grid(device, threads, smem, list ? grid_c : grid_b,
                         &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    esc_numeric_block_kernel<<<grid, threads, smem, s>>>(
        list, static_cast<const int*>(rows), n_rows,
        static_cast<const int*>(a_rpt), static_cast<const int*>(a_col),
        static_cast<const float*>(a_val), static_cast<const int*>(b_rpt),
        static_cast<const int*>(b_col), static_cast<const float*>(b_val),
        static_cast<const int*>(rownnz_b), m, k_rows, max_deg_a, max_deg_b,
        row_capacity, list ? tile_c : tile_b, list ? bins_c : bins_b, smem,
        list ? pairs_c : pairs_b,
        static_cast<char*>(scratch), slice_bytes, slice_pairs,
        static_cast<char*>(spill), static_cast<int*>(ctl),
        static_cast<int*>(out_col), static_cast<float*>(out_val),
        static_cast<int*>(row_nnz));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

REPRO_EXPORT_COMMON(esc_numeric)
