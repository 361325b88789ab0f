// Blocked GQA flash attention, forward only:
//
//   out[b, h, i, :] = sum_j softmax_j(q[b, h, i, :] . k[b, g, j, :] / sqrt(D))
//                     * v[b, g, j, :],   g = h / (Hq / Hkv),
//
// over the keys j <= i when causal (the top-left mask qpos >= kpos, for any
// Sq and Sk), over every key otherwise.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_single
// (_flash_kernel), which walks a (q block, k block) grid per (batch, head,
// group member) under a triple vmap and carries the online-softmax state
// (running max m, denominator l, fp32 accumulator) in VMEM scratch from one
// k block to the next.
//
// Design: one thread block of 256 threads per (query tile of 64 rows, q
// head, batch); blocks of the heads that share a kv head run next to each
// other, so their K/V reads hit L2.  The block keeps its Q tile in shared
// memory as fp32, transposed, and loops over key tiles of 64 (the TPU's
// sequential grid dimension), streaming K (transposed) and V through shared
// memory as fp32; causal key tiles wholly above the tile's last row are not
// visited, and the longest rows' tiles launch first.  Thread (ty, tx) of a
// 16 x 16 layout owns a 4 x 4 block of the score tile (rows 4ty.., keys
// 4tx..) and, for the same 4 rows, 4 output columns in each 64-column chunk
// of D (NJ = ceil(D / 64) chunks, a template parameter; D itself is a
// runtime value up to 256, any width).  Scores are the fp32 dot product
// times 1/sqrt(D), as in the TPU kernel; masked logits are -1e30 and masked
// probabilities are zeroed explicitly; a row's max and sum reduce over the
// 16 threads of a half warp by xor shuffles (bitwise equal in every lane).
// Each row's m, l and accumulator are rescaled by expf(m_prev - m_cur); the
// probabilities go back to shared memory (over the K tile) for the P.V
// product.  The finish is acc / max(l, 1e-30), stored in q's dtype.
//
// Bound on the H100: operations.  4 FLOP per (row, visible key, head-dim
// element) against 4 bytes per element of q, k, v and out in float32: at
// Sq = Sk = 4096, D = 128 over 800 FLOP a byte, above the card's float32
// ridge of 20.  This kernel runs its products as fp32 FMAs on the CUDA
// cores (67 TFLOP/s): it serves float32 at any head dim and 16-bit types at
// the widths the tensor-core kernel (flash_attention_sm90.cu: bfloat16 and
// float16 at D 64, 96 and 128) does not take.  Each query tile re-reads its
// K/V tiles from L2.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

#include "common.cuh"

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 256
// Row stride, in floats, of the transposed Q, K and P tiles: 16-byte
// aligned for float4 reads, and off a multiple of 32 banks.
#define FA_LD 68
#define FA_MAX_NJ 4
#define FA_NEG_INF (-1e30f)

__device__ inline float fa_load(const float* p) { return *p; }
__device__ inline float fa_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ inline float fa_load(const __half* p) { return __half2float(*p); }
__device__ inline void fa_store(float* p, float x) { *p = x; }
__device__ inline void fa_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ inline void fa_store(__half* p, float x) { *p = __float2half(x); }

// Shared-memory floats of one block: Q^T (D x FA_LD), K^T or P^T
// (max(D, FA_BK) x FA_LD) and V (FA_BK x 64 NJ).
static inline long long fa_smem_floats(int d, int nj) {
  return static_cast<long long>(d) * FA_LD +
         static_cast<long long>(d > FA_BK ? d : FA_BK) * FA_LD +
         static_cast<long long>(FA_BK) * 64 * nj;
}

template <typename T, int NJ>
__global__ void __launch_bounds__(FA_THREADS, 2) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int hq, int group, int sq, int sk, int d,
    float sm_scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                                    // [d][FA_LD]
  float* kt = qt + static_cast<long long>(d) * FA_LD;  // [>= d, 64][FA_LD]
  float* vs = kt + static_cast<long long>(d > FA_BK ? d : FA_BK) * FA_LD;
  constexpr int VW = 64 * NJ;                          // V row, zero past d
  const int tid = threadIdx.x;
  const int tx = tid & 15;   // the 16 threads of a row group: a half warp
  const int ty = tid >> 4;
  const int n_qt = (sq + FA_BQ - 1) / FA_BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * FA_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long q_base = (static_cast<long long>(b) * hq + h) * sq * d;
  const long long kv_base =
      (static_cast<long long>(b) * (hq / group) + h / group) * sk * d;

  for (int i = tid; i < FA_BQ * d; i += FA_THREADS) {
    const int r = i / d, c = i - r * d;
    qt[c * FA_LD + r] =
        q0 + r < sq ? fa_load(q + q_base + static_cast<long long>(q0 + r) * d
                              + c)
                    : 0.f;
  }
  float m[4], l[4], acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) acc[i][j] = 0.f;
  }

  const int n_kt_all = (sk + FA_BK - 1) / FA_BK;
  const int n_kt =
      causal ? min(n_kt_all, (q0 + FA_BQ - 1) / FA_BK + 1) : n_kt_all;
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * FA_BK;
    __syncthreads();  // the last tile's P and V reads are done
    for (int i = tid; i < FA_BK * d; i += FA_THREADS) {
      const int r = i / d, c = i - r * d;
      kt[c * FA_LD + r] =
          k0 + r < sk
              ? fa_load(k + kv_base + static_cast<long long>(k0 + r) * d + c)
              : 0.f;
    }
    for (int i = tid; i < FA_BK * VW; i += FA_THREADS) {
      const int r = i / VW, c = i - r * VW;
      vs[i] = (k0 + r < sk && c < d)
                  ? fa_load(v + kv_base + static_cast<long long>(k0 + r) * d
                            + c)
                  : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this thread's 4 x 4 block
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(qt + c * FA_LD
                                                         + 4 * ty);
      const float4 kb = *reinterpret_cast<const float4*>(kt + c * FA_LD
                                                         + 4 * tx);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax over the tile
    bool ok[4][4];
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
      float mx = FA_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tx + j;
        ok[i][j] = kpos < sk && (!causal || qpos >= kpos);
        s[i][j] = ok[i][j] ? s[i][j] * sm_scale : FA_NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(REPRO_FULL_MASK, mx, o));
      const float m_cur = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = ok[i][j] ? expf(s[i][j] - m_cur) : 0.f;
        sum += p[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(REPRO_FULL_MASK, sum, o);
      const float alpha = expf(m[i] - m_cur);
      l[i] = l[i] * alpha + sum;
      m[i] = m_cur;
#pragma unroll
      for (int j = 0; j < 4 * NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // every thread is done reading K^T
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(kt + (4 * tx + j) * FA_LD + 4 * ty) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    // acc += P V for this thread's 4 rows and 4 NJ columns
#pragma unroll 4
    for (int c = 0; c < FA_BK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(kt + c * FA_LD
                                                         + 4 * ty);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float4 vb = *reinterpret_cast<const float4*>(
            vs + c * VW + 64 * jj + 4 * tx);
        const float vv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][4 * jj + e] = fmaf(pv[i], vv[e], acc[i][4 * jj + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = out + q_base + static_cast<long long>(r) * d;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 64 * jj + 4 * tx + e;
        if (c < d) fa_store(row + c, acc[i][4 * jj + e] / denom);
      }
  }
}

template <typename T, int NJ>
static int flash_attention_run(const void* q, const void* k, const void* v,
                               void* out, int batch, int hq, int hkv, int sq,
                               int sk, int d, int causal, cudaStream_t s) {
  const int smem_bytes =
      static_cast<int>(sizeof(float) * fa_smem_floats(d, NJ));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 1/sqrt(D) in double, rounded once to float: JAX's Python-float scale
  const float sm_scale =
      static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const dim3 grid((sq + FA_BQ - 1) / FA_BQ, hq, batch);
  flash_attention_kernel<T, NJ><<<grid, FA_THREADS, smem_bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hq / hkv, sq, sk, d,
      sm_scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int flash_attention_dispatch(const void* q, const void* k,
                                    const void* v, void* out, int batch,
                                    int hq, int hkv, int sq, int sk, int d,
                                    int causal, cudaStream_t s) {
  switch ((d + 63) / 64) {
    case 1:
      return flash_attention_run<T, 1>(q, k, v, out, batch, hq, hkv, sq, sk,
                                       d, causal, s);
    case 2:
      return flash_attention_run<T, 2>(q, k, v, out, batch, hq, hkv, sq, sk,
                                       d, causal, s);
    case 3:
      return flash_attention_run<T, 3>(q, k, v, out, batch, hq, hkv, sq, sk,
                                       d, causal, s);
    case 4:
      return flash_attention_run<T, 4>(q, k, v, out, batch, hq, hkv, sq, sk,
                                       d, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Shared memory one block needs at head dim d, in bytes (-1 past the
// kernel's widest head dim, 64 * FA_MAX_NJ).
extern "C" long long flash_attention_smem_bytes(int d) {
  if (d <= 0 || d > 64 * FA_MAX_NJ) return -1;
  return static_cast<long long>(sizeof(float)) *
         fa_smem_floats(d, (d + 63) / 64);
}

// q (batch, hq, sq, d), k and v (batch, hkv, sk, d), out like q, all
// contiguous and of one dtype: 0 float32, 1 bfloat16, 2 float16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int batch, int hq, int hkv, int sq,
                                      int sk, int d, int causal, int device,
                                      void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || hq % hkv || sq <= 0 || sk <= 0 ||
      d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return flash_attention_dispatch<float>(q, k, v, out, batch, hq, hkv, sq,
                                             sk, d, causal, s);
    case 1:
      return flash_attention_dispatch<__nv_bfloat16>(q, k, v, out, batch, hq,
                                                     hkv, sq, sk, d, causal,
                                                     s);
    case 2:
      return flash_attention_dispatch<__half>(q, k, v, out, batch, hq, hkv,
                                              sq, sk, d, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

REPRO_EXPORT_COMMON(flash_attention)
