// Shared device code of the port's ESC kernels (symbolic and numeric).
//
// One thread block owns one output row at a time and keeps the row's work
// in a per-block workspace:
//
//   [prefix: max_deg_a + 1 ints][keys: f2 ints][vals: f2 floats (numeric)]
//
// The workspace is dynamic shared memory when it fits the card's opt-in
// limit, else a slice of a global scratch buffer the wrapper allocates.  The
// same code addresses both through generic pointers.
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

// Gather row r's intermediate products into keys[0, n) (and the value
// products into vals when VALS), pad keys to the next power of two with the
// sentinel, and return n.  As in the JAX package, only the first max_deg_a
// entries of A's row and the first max_deg_b of each B row are read.
// *flop gets Algorithm 1's count for the row: the sum of the (untruncated)
// lengths of the B rows it references.  Ends with a barrier.
template <bool VALS>
__device__ int repro_gather_row(
    int r, const int* __restrict__ a_rpt, const int* __restrict__ a_col,
    const float* __restrict__ a_val, const int* __restrict__ b_rpt,
    const int* __restrict__ b_col, const float* __restrict__ b_val,
    const int* __restrict__ rownnz_b, int m, int k_rows, int max_deg_a,
    int max_deg_b, int* prefix, int* keys, float* vals, int* flop) {
  __shared__ int s_n;
  int start = 0, deg = 0;
  if (r >= 0 && r < m) {
    start = a_rpt[r];
    deg = min(a_rpt[r + 1] - start, max_deg_a);
  }
  // 1. prefix[j] = products of A entries before j (each B row truncated to
  //    max_deg_b); every thread scans a contiguous chunk of A's row.
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
  n = s_n;
  // 2. product p belongs to the A entry j with prefix[j] <= p < prefix[j+1]
  for (int p = threadIdx.x; p < n; p += blockDim.x) {
    int lo = 0, hi = deg;  // invariant: prefix[lo] <= p < prefix[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (prefix[mid] <= p) lo = mid; else hi = mid;
    }
    const int e = b_rpt[a_col[start + lo]] + (p - prefix[lo]);
    keys[p] = b_col[e];
    if (VALS) vals[p] = __fmul_rn(a_val[start + lo], b_val[e]);
  }
  const int n2 = repro_next_pow2(max(n, 1));
  for (int p = n + threadIdx.x; p < n2; p += blockDim.x) {
    keys[p] = REPRO_SENTINEL;
    if (VALS) vals[p] = 0.0f;
  }
  *flop = total_flop;
  __syncthreads();
  return n;
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
