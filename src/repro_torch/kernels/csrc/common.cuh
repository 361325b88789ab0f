// Shared device code of the port's row kernels (ESC, SPA and BIN).
//
// One thread block owns one output row at a time and keeps the row's work
// in a per-block workspace that starts with the row's product prefix
// (max_deg_a + 1 ints, 16-byte aligned); each kernel lays out the rest
// (ESC: keys and values to sort; SPA and BIN: a dense tile and its presence
// words).  The workspace is dynamic shared memory when it fits the card's
// opt-in limit, else a slice of a global scratch buffer the wrapper
// allocates.  The same code addresses both through generic pointers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_SENTINEL 0x7fffffff
#define REPRO_FULL_MASK 0xffffffffu

// Every library exports these two next to its launcher: the message of a
// CUDA error code, and the card's opt-in dynamic shared memory per block.
#define REPRO_EXPORT_COMMON(name)                                            \
  extern "C" const char* name##_error_string(int e) {                        \
    return cudaGetErrorString(static_cast<cudaError_t>(e));                  \
  }                                                                          \
  extern "C" int name##_max_smem(int dev) {                                  \
    int v = 0;                                                               \
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,  \
                               dev) != cudaSuccess)                          \
      return -1;                                                             \
    return v;                                                                \
  }

__host__ __device__ inline long long repro_align16(long long x) {
  return (x + 15) & ~15LL;
}

__device__ inline int repro_next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Exclusive prefix sum of one int per thread across the block; *total gets
// the block-wide sum.  blockDim.x must be a multiple of 32.  Ends with a
// barrier, so it may be called again straight away.
__device__ inline int repro_block_exclusive_scan(int x, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(REPRO_FULL_MASK, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(REPRO_FULL_MASK, s, o);
      if (lane >= o) s += y;
    }
    if (lane < n_warps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int base = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[n_warps - 1];
  __syncthreads();
  return base + incl - x;
}

// Prefix of row r's intermediate products: prefix[j] = the products of A
// entries before j (each B row truncated to max_deg_b), prefix[deg] = n.  As
// in the JAX package, only the first max_deg_a entries of A's row and the
// first max_deg_b of each B row are read.  *start and *deg get the row's A
// slice (deg = 0 for a row id outside [0, m)), *flop Algorithm 1's count for
// the row: the sum of the (untruncated) lengths of the B rows it references.
// Returns n.  Ends with a barrier.
__device__ inline int repro_row_prefix(
    int r, const int* __restrict__ a_rpt, const int* __restrict__ a_col,
    const int* __restrict__ rownnz_b, int m, int k_rows, int max_deg_a,
    int max_deg_b, int* prefix, int* start_out, int* deg_out, int* flop) {
  __shared__ int s_n;
  int start = 0, deg = 0;
  if (r >= 0 && r < m) {
    start = a_rpt[r];
    deg = min(a_rpt[r + 1] - start, max_deg_a);
  }
  // every thread scans a contiguous chunk of A's row
  const int chunk = (deg + blockDim.x - 1) / blockDim.x;
  const int j0 = min(deg, static_cast<int>(threadIdx.x) * chunk);
  const int j1 = min(deg, j0 + chunk);
  int local = 0, local_flop = 0;
  for (int j = j0; j < j1; ++j) {
    const int k = a_col[start + j];
    const int db = (k >= 0 && k < k_rows) ? rownnz_b[k] : 0;
    local += min(db, max_deg_b);
    local_flop += db;
  }
  int n;
  int run = repro_block_exclusive_scan(local, &n);
  for (int j = j0; j < j1; ++j) {
    prefix[j] = run;
    const int k = a_col[start + j];
    const int db = (k >= 0 && k < k_rows) ? rownnz_b[k] : 0;
    run += min(db, max_deg_b);
  }
  int total_flop;
  repro_block_exclusive_scan(local_flop, &total_flop);
  if (threadIdx.x == 0) {
    prefix[deg] = n;
    s_n = n;
  }
  __syncthreads();
  *start_out = start;
  *deg_out = deg;
  *flop = total_flop;
  return s_n;
}

// Product p of the row (0 <= p < n): its B entry index, and in *j the A
// entry it comes from, the j with prefix[j] <= p < prefix[j+1], found by
// binary search on the prefix, so lanes stay busy whatever the B-row lengths.
__device__ inline int repro_product_entry(int p, int deg, const int* prefix,
                                          int start,
                                          const int* __restrict__ a_col,
                                          const int* __restrict__ b_rpt,
                                          int* j) {
  int lo = 0, hi = deg;  // invariant: prefix[lo] <= p < prefix[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (prefix[mid] <= p) lo = mid; else hi = mid;
  }
  *j = lo;
  return b_rpt[a_col[start + lo]] + (p - prefix[lo]);
}

// Gather row r's intermediate products into keys[0, n) (and the value
// products into vals when VALS), pad keys to the next power of two with the
// sentinel, and return n.  *flop as repro_row_prefix.  Ends with a barrier.
template <bool VALS>
__device__ int repro_gather_row(
    int r, const int* __restrict__ a_rpt, const int* __restrict__ a_col,
    const float* __restrict__ a_val, const int* __restrict__ b_rpt,
    const int* __restrict__ b_col, const float* __restrict__ b_val,
    const int* __restrict__ rownnz_b, int m, int k_rows, int max_deg_a,
    int max_deg_b, int* prefix, int* keys, float* vals, int* flop) {
  int start, deg;
  const int n = repro_row_prefix(r, a_rpt, a_col, rownnz_b, m, k_rows,
                                 max_deg_a, max_deg_b, prefix, &start, &deg,
                                 flop);
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    int j;
    const int e = repro_product_entry(p, deg, prefix, start, a_col, b_rpt, &j);
    keys[p] = b_col[e];
    if (VALS) vals[p] = __fmul_rn(a_val[start + j], b_val[e]);
  }
  const int n2 = repro_next_pow2(max(n, 1));
  for (int p = n + threadIdx.x; p < n2; p += blockDim.x) {
    keys[p] = REPRO_SENTINEL;
    if (VALS) vals[p] = 0.0f;
  }
  __syncthreads();
  return n;
}

// The row's product-column extent: *lo the smallest product column and *hi
// the largest, or REPRO_SENTINEL and -1 for a row without products.  B's rows
// are sorted ascending (validate_csr), so a B row's first and last read
// entries bound it: this costs the row's deg A entries, not a pass over its
// products.  *lo is the JAX package's extent_relative offset.  Ends with a
// barrier.
__device__ inline void repro_row_extent(int start, int deg,
                                        const int* __restrict__ a_col,
                                        const int* __restrict__ b_rpt,
                                        const int* __restrict__ b_col,
                                        const int* __restrict__ rownnz_b,
                                        int k_rows, int max_deg_b, int* lo,
                                        int* hi) {
  __shared__ int s_lo, s_hi;
  if (threadIdx.x == 0) {
    s_lo = REPRO_SENTINEL;
    s_hi = -1;
  }
  __syncthreads();
  int l = REPRO_SENTINEL, h = -1;
  for (int j = threadIdx.x; j < deg; j += blockDim.x) {
    const int k = a_col[start + j];
    const int len = (k >= 0 && k < k_rows) ? min(rownnz_b[k], max_deg_b) : 0;
    if (len > 0) {
      const int e = b_rpt[k];
      l = min(l, b_col[e]);
      h = max(h, b_col[e + len - 1]);
    }
  }
  if (h >= 0) {
    atomicMin(&s_lo, l);
    atomicMax(&s_hi, h);
  }
  __syncthreads();
  *lo = s_lo;
  *hi = s_hi;
  __syncthreads();  // the next row's call resets s_lo and s_hi
}

// Compact one dense accumulator tile: lane l (set when bit l&31 of
// pres[l>>5] is) goes, in ascending lane order, to output slot base + its
// rank among the set lanes, as column col0 + l with value acc[l], when that
// slot is below cap.  Returns the tile's count of set lanes (block-uniform),
// so a caller that walks tiles in column order keeps the true nnz past the
// capacity.  Ends with a barrier.
__device__ inline int repro_compact_tile(const float* acc,
                                         const unsigned* pres, int n_words,
                                         int base, int cap, int col0,
                                         int* __restrict__ out_col,
                                         float* __restrict__ out_val) {
  const int chunk = (n_words + blockDim.x - 1) / blockDim.x;
  const int w0 = min(n_words, static_cast<int>(threadIdx.x) * chunk);
  const int w1 = min(n_words, w0 + chunk);
  int local = 0;
  for (int w = w0; w < w1; ++w) local += __popc(pres[w]);
  int total;
  int slot = base + repro_block_exclusive_scan(local, &total);
  for (int w = w0; w < w1 && slot < cap; ++w) {
    unsigned bits = pres[w];
    while (bits && slot < cap) {
      const int l = (w << 5) + __ffs(bits) - 1;
      bits &= bits - 1;
      out_col[slot] = col0 + l;
      out_val[slot] = acc[l];
      ++slot;
    }
  }
  __syncthreads();
  return total;
}

// Sentinel and 0 in a row's slots [nnz, cap).
__device__ inline void repro_fill_tail(int nnz, int cap,
                                       int* __restrict__ out_col,
                                       float* __restrict__ out_val) {
  for (int s = min(nnz, cap) + threadIdx.x; s < cap; s += blockDim.x) {
    out_col[s] = REPRO_SENTINEL;
    out_val[s] = 0.0f;
  }
}

// Block-cooperative bitonic sort of keys[0, n) ascending (n a power of two),
// carrying vals through the same permutation when VALS.  Ends with a barrier.
template <bool VALS>
__device__ void repro_bitonic_sort(int* keys, float* vals, int n) {
  const int half = n >> 1;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));  // bit j clear
        const int l = i + j;
        const bool up = (i & k) == 0;
        const int ki = keys[i], kl = keys[l];
        if ((ki > kl) == up) {
          keys[i] = kl;
          keys[l] = ki;
          if (VALS) {
            const float vi = vals[i];
            vals[i] = vals[l];
            vals[l] = vi;
          }
        }
      }
      __syncthreads();
    }
  }
}
