// Blocked GQA flash attention, forward only, on Hopper's tensor cores, for
// bfloat16 and float16 inputs at head dims D of 64, 96 and 128:
//
//   out[b, h, i, :] = sum_j softmax_j(q[b, h, i, :] . k[b, g, j, :] / sqrt(D))
//                     * v[b, g, j, :],   g = h / (Hq / Hkv),
//
// over the keys j <= i when causal (the top-left mask qpos >= kpos, for any
// Sq and Sk), over every key otherwise.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_single
// (_flash_kernel) for those dtypes and widths; flash_attention.cu keeps
// float32 and the other widths.
//
// Bound on the H100: operations.  4 FLOP per (row, visible key, head-dim
// element) against 2 bytes per element of q, k, v and out read or written
// once: at Sq = Sk = 4096, D = 128, causal, about 1,700 FLOP a byte, far
// above the card's bf16 ridge of ~295, so the floor is the tensor cores'
// 989 TFLOP/s.  Design, to keep the tensor cores fed:
//   * One block per (query tile of FA9_BM = 128 rows, q head, batch): two
//     warpgroups of 64 rows each, whose thread 0 also issues the TMA loads.
//     A consumer needs ~200 registers (S, P and O of its rows live at once
//     while its products run).  A separate producer warp or warpgroup cost
//     them that: an SM's four sub-partitions hold 16,384 registers each, so
//     with a ninth warp, or a twelve-warp block, ptxas caps every thread at
//     168 and spilled 208 bytes at D 128, and setmaxnreg did not lift the
//     cap (measured on an NVIDIA H100 80GB HBM3 at 700 W: 1.62 ms on G1
//     with 256 threads against 2.26-2.36 ms with 288 or 384).  The grid
//     runs q heads fastest, so the Hq / Hkv heads of one kv head run side
//     by side and share their K/V tiles in L2, and the longest causal tiles
//     launch first.
//   * TMA, with 3-D tensor maps (D, S, B*H) so that a box never crosses into
//     the next head and the ragged Sq / Sk edge fills with zeros: Q once,
//     then K and V tiles of FA9_BN = 128 keys through a ring of FA9_STAGES
//     stages, each with a full barrier for K, one for V and an empty one;
//     tile t + 1 is requested as tile t begins.
//     A row of D values is cut into slabs of 64 columns (128 bytes, the
//     128-byte swizzle) or, at D 96, of 32 columns (the 64-byte swizzle), so
//     D 96 is never padded to 128.  At D 128 Q and three stages take 224 KB.
//   * S = Q K^T by wgmma m64n128k16 from shared memory (both operands
//     K-major, descriptors with the tensor maps' swizzle): exact 16-bit
//     products summed in fp32, as JAX casts to fp32 before its product;
//     only the order of the sums differs.  The scale 1/sqrt(D) multiplies
//     the product, folded with log2(e) into one FMA before the exp2 of the
//     special-function unit.
//   * The online softmax in registers, fp32: a row's max and sum over the
//     four threads of a quad that share it in the accumulator layout.
//     Masked logits are -1e30 and masked probabilities are zeroed
//     explicitly; key tiles wholly above the tile's last row are skipped and
//     only the diagonal and ragged-edge tiles are masked.
//   * O += P V by wgmma with P from registers and V from shared memory as
//     loaded, (keys x D) being MN-major for this product (the transpose
//     bit).  P is rounded to q's 16-bit type for it: the one numeric
//     difference from JAX, which keeps P in fp32.  A consumer issues the
//     product of tile t - 1's P and V together with S of tile t, and
//     computes tile t's softmax while that product runs.
//   * The finish acc / max(l, 1e-30), stored in q's dtype; rows past Sq are
//     not stored.
#include <cuda.h>   // CUtensorMap and its enums; the driver is reached through
                    // cudaGetDriverEntryPoint, so nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "common.cuh"

// flash_attention.py reads FA9_BM and FA9_BN from here
#define FA9_BM 128        // query rows of a block: two consumers of 64
#define FA9_BN 128        // keys of a K/V tile
#define FA9_STAGES 3      // K/V stages in flight
#define FA9_THREADS 256   // two consumer warpgroups
#define FA9_NEG_INF (-1e30f)

static_assert(FA9_BM == FA9_BN, "Q, K and V share one tensor-map box");

#define FA9_IS_BF16(T) (std::is_same<T, __nv_bfloat16>::value)

// The wgmma instructions the kernel issues, TY "bf16" or "f16"; fp32
// accumulators d, scale_d a predicate (0: overwrite d).  SS: S (64 x 128) =
// A . B with A and B in shared memory (desc_a, desc_b), both K-major.  RS:
// O (64 x N) += A . B with A in registers (a: four packed pairs) and B in
// shared memory, MN-major (the transpose bit).
#define FA9_WGMMA_SS_N128(TY)                                                 \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
      "%56, %57, %58, %59, %60, %61, %62, %63}"                               \
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                   \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                   \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                   \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                   \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "l"(desc_a), "l"(desc_b), "r"(scale_d))

#define FA9_WGMMA_RS_N64(TY)                                                  \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31}"                               \
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),              \
        "r"(scale_d))

#define FA9_WGMMA_RS_N96(TY)                                                  \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n96k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
      "%40, %41, %42, %43, %44, %45, %46, %47}"                               \
      ", {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                   \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                   \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),              \
        "r"(scale_d))

#define FA9_WGMMA_RS_N128(TY)                                                 \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
      "%56, %57, %58, %59, %60, %61, %62, %63}"                               \
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                   \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                   \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                   \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                   \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),              \
        "r"(scale_d))

// Shapes of one (dtype, D) instance: slabs of SC columns, SB bytes a row
// (the swizzle span); a block's shared memory is Q, then per stage K and V,
// each slab of them 1024-byte aligned for the swizzle.
template <int D>
struct Fa9Shape {
  static constexpr int SC = D % 64 == 0 ? 64 : 32;
  static constexpr int SB = 2 * SC;
  static constexpr int NS = D / SC;
  static constexpr int Q_BYTES = FA9_BM * D * 2;
  static constexpr int KV_BYTES = FA9_BN * D * 2;   // one K or V tile
  static constexpr int SMEM = Q_BYTES + 2 * FA9_STAGES * KV_BYTES + 1024;
  static_assert(D % SC == 0 && (FA9_BN * SB) % 1024 == 0, "slab layout");
};

__device__ inline uint32_t fa9_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A block's shared-memory addresses: the tiles from base (Q, then per stage
// K and V), the barriers from bars (Q full, then per stage K full, V full
// and empty).
template <int D>
struct Fa9Smem {
  uint32_t base, bars;
  __device__ uint32_t q_full() const { return bars; }
  __device__ uint32_t k_full(int st) const { return bars + 8 * (1 + st); }
  __device__ uint32_t v_full(int st) const {
    return bars + 8 * (1 + FA9_STAGES + st);
  }
  __device__ uint32_t empty(int st) const {
    return bars + 8 * (1 + 2 * FA9_STAGES + st);
  }
  __device__ uint32_t k_tile(int st) const {
    return base + Fa9Shape<D>::Q_BYTES + 2 * st * Fa9Shape<D>::KV_BYTES;
  }
  __device__ uint32_t v_tile(int st) const {
    return k_tile(st) + Fa9Shape<D>::KV_BYTES;
  }
};

__device__ inline void fa9_bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ inline void fa9_bar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ inline void fa9_bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the phase of the given parity to complete.  A wait of seconds
// means an arrival that never comes: trap rather than hang the card.
__device__ inline void fa9_bar_wait(uint32_t bar, int parity) {
  const long long t0 = clock64();
  uint32_t done;
  do {
    if (clock64() - t0 > (1LL << 34)) asm volatile("trap;\n");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box (SC columns x 128 rows of one head) into shared memory at
// dst, completing on bar.
__device__ inline void fa9_tma_load(uint32_t dst, const CUtensorMap* map,
                                    uint32_t bar, int col, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(bh)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle of SB-byte rows (1: 128 bytes,
// 2: 64 bytes).
template <int SB>
__device__ inline uint64_t fa9_desc(uint32_t addr, uint32_t lbo,
                                    uint32_t sbo) {
  constexpr uint64_t swizzle = SB == 128 ? 1 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (swizzle << 62);
}

__device__ inline void fa9_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ inline void fa9_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup's wgmma are
// still running.
template <int N>
__device__ inline void fa9_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x, the special-function unit's approximation (about 2 ulp)
__device__ inline float fa9_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keep the compiler from touching registers that an asynchronous wgmma
// reads or writes before the wait that ends it.
template <int N>
__device__ inline void fa9_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ inline void fa9_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}


// S (64 x 128 fp32, the warpgroup's rows) = A (64 x 16, shared memory) . B
// (16 x 128, shared memory), both K-major; scale_d 0 overwrites d.
template <typename T>
__device__ inline void fa9_wgmma_ss(float (&d)[64], uint64_t desc_a,
                                    uint64_t desc_b, int scale_d) {
  if constexpr (FA9_IS_BF16(T)) {
    FA9_WGMMA_SS_N128("bf16");
  } else {
    FA9_WGMMA_SS_N128("f16");
  }
}

// O (64 x N fp32) += A (64 x 16, registers) . B (16 x N, shared memory,
// MN-major).
template <typename T, int N>
__device__ inline void fa9_wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                    uint64_t desc_b) {
  const int scale_d = 1;
  if constexpr (N == 64) {
    if constexpr (FA9_IS_BF16(T)) { FA9_WGMMA_RS_N64("bf16"); }
    else { FA9_WGMMA_RS_N64("f16"); }
  } else if constexpr (N == 96) {
    if constexpr (FA9_IS_BF16(T)) { FA9_WGMMA_RS_N96("bf16"); }
    else { FA9_WGMMA_RS_N96("f16"); }
  } else {
    if constexpr (FA9_IS_BF16(T)) { FA9_WGMMA_RS_N128("bf16"); }
    else { FA9_WGMMA_RS_N128("f16"); }
  }
}

// Two floats rounded to T and packed, the first in the low half.
template <typename T>
__device__ inline uint32_t fa9_pack(float lo, float hi) {
  uint32_t r;
  if constexpr (FA9_IS_BF16(T)) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    r = *reinterpret_cast<uint32_t*>(&v);
  }
  return r;
}

// Key tiles a query tile starting at q0 visits: all of them, or, when
// causal, those up to the one that holds its last row's diagonal.
__device__ inline int fa9_key_tiles(int q0, int sq, int sk, int causal) {
  const int all = (sk + FA9_BN - 1) / FA9_BN;
  if (!causal) return all;
  return min(all, (min(q0 + FA9_BM, sq) - 1) / FA9_BN + 1);
}

// A consumer warpgroup's work (cw 0 or 1, from the thread index): 64 rows
// of the query tile at q0 over n_kt key tiles, its output rows at out_q.
// Thread 0 also issues the loads: Q and tile 0 first, then tile t + 1 as
// tile t begins, into the stage that tile t - 2 freed (tile t - 1's is
// still read by the product that tile t issues).
template <typename T, int D, typename LoadQ, typename LoadTile>
__device__ __forceinline__ void fa9_consume(
    Fa9Smem<D> sm, int q0, int n_kt, int sq, int sk, int causal,
    float scale_log2, T* __restrict__ out_q, LoadQ load_q,
    LoadTile load_tile) {
  using S = Fa9Shape<D>;
  static_assert(FA9_STAGES >= 3,
                "the loads run one tile ahead of a pending product");
  const int tid = threadIdx.x;
  const auto prefetch = [&](int t) {
    if (tid == 0 && t + 1 < n_kt) load_tile(t + 1);
  };
  if (tid == 0) {
    load_q();
    load_tile(0);
  }

  // 64 rows; in the accumulator layout a thread holds rows row0 and row0 +
  // 8, columns 8 j + 2 (lane % 4) + {0, 1}.  Its loop overlaps the softmax
  // of key tile t with the product of tile t - 1's P and V: S_t and that
  // product are issued together, S_t is waited for first, and O is
  // rescaled once the product is done.
  const int cw = tid / 128;
  const int lane = tid & 31;
  const int row0 = 64 * cw + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int qpos[2] = {q0 + row0, q0 + row0 + 8};
  const int col = 2 * (lane & 3);
  const uint32_t q_rows = sm.base + 64 * cw * S::SB;
  float o[D / 2], s[64];
  uint32_t p[8][4];   // the last tile's P as the A operand, in q's type
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  // running max (of the scores times scale_log2) and this thread's share
  // of the running sum, per row
  float m[2] = {FA9_NEG_INF, FA9_NEG_INF}, l[2] = {0.f, 0.f};

  // S = Q K_t^T, issued; scale_d 0 on the first step overwrites s
  const auto issue_s = [&](int t) {
    const int st = t % FA9_STAGES;
    fa9_bar_wait(sm.k_full(st), (t / FA9_STAGES) & 1);
    fa9_fence(s);
    fa9_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // 16 columns of D: slab kk / (SC / 16), 32 bytes into its rows
      const uint32_t off = (kk / (S::SC / 16)) * FA9_BM * S::SB +
                           (kk % (S::SC / 16)) * 32;
      fa9_wgmma_ss<T>(s, fa9_desc<S::SB>(q_rows + off, 16, 8 * S::SB),
                      fa9_desc<S::SB>(sm.k_tile(st) + off, 16, 8 * S::SB),
                      kk > 0);
    }
    fa9_wgmma_commit();
  };
  // O += P V_t, issued: 16 keys of V a step, every slab of D at the
  // leading offset
  const auto issue_pv = [&](int t) {
    const int st = t % FA9_STAGES;
    fa9_bar_wait(sm.v_full(st), (t / FA9_STAGES) & 1);
    fa9_fence(o);
    fa9_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      fa9_wgmma_rs<T, D>(o, p[kk],
                         fa9_desc<S::SB>(sm.v_tile(st) + 16 * kk * S::SB,
                                         FA9_BN * S::SB, 8 * S::SB));
    fa9_wgmma_commit();
  };
  // the online softmax of S_t: masked logits (only on the diagonal and
  // ragged-edge tiles) -1e30, the rows' max over the four threads of a
  // quad, s becomes exp2(s * scale_log2 - m) with masked entries zeroed;
  // alpha gets each row's rescale factor and sum this thread's share of
  // the row sums
  const auto softmax = [&](int t, float (&alpha)[2], float (&sum)[2]) {
    const int k0 = t * FA9_BN;
    const bool edge = k0 + FA9_BN > sk || (causal && k0 + FA9_BN - 1 > q0);
    const auto masked = [&](int j, int i, int c) {
      const int key = k0 + 8 * j + col + c;
      return key >= sk || (causal && key > qpos[i]);
    };
    if (edge) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (masked(j, i, c)) s[4 * j + 2 * i + c] = FA9_NEG_INF;
    }
    float mx[2] = {FA9_NEG_INF, FA9_NEG_INF};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        mx[i] = fmaxf(mx[i], fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(REPRO_FULL_MASK, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(REPRO_FULL_MASK, mx[i], 2));
      const float m_cur = fmaxf(m[i], mx[i] * scale_log2);
      alpha[i] = fa9_exp2(m[i] - m_cur);
      m[i] = m_cur;
      sum[i] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float e = fa9_exp2(fmaf(s[4 * j + 2 * i + c], scale_log2, -m[i]));
          if (edge && masked(j, i, c)) e = 0.f;
          s[4 * j + 2 * i + c] = e;
          sum[i] += e;
        }
  };
  // rescale O and l by alpha, add the sums, and round P into the A
  // operand: keys 16 kk .. 16 kk + 15 are accumulator columns j = 2 kk and
  // 2 kk + 1, already in the operand's register order
  const auto fold = [&](const float (&alpha)[2], const float (&sum)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * j + 2 * i] *= alpha[i];
        o[4 * j + 2 * i + 1] *= alpha[i];
      }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kk][r] = fa9_pack<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  };
  // tile t's stage is free once its product with P is done
  const auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) fa9_bar_arrive(sm.empty(t % FA9_STAGES));
  };

  fa9_bar_wait(sm.q_full(), 0);
  float alpha[2], sum[2];
  prefetch(0);
  issue_s(0);
  fa9_wgmma_wait<0>();
  fa9_fence(s);
  softmax(0, alpha, sum);
  fold(alpha, sum);
  for (int t = 1; t < n_kt; ++t) {
    prefetch(t);
    issue_s(t);
    issue_pv(t - 1);
    fa9_wgmma_wait<1>();   // S_t is done; P_{t-1} V_{t-1} may still run
    fa9_fence(s);
    softmax(t, alpha, sum);
    fa9_wgmma_wait<0>();
    fa9_fence(o);
    fa9_fence(p);
    release(t - 1);
    fold(alpha, sum);
  }
  issue_pv(n_kt - 1);
  fa9_wgmma_wait<0>();
  fa9_fence(o);
  fa9_fence(p);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(REPRO_FULL_MASK, l[i], 1);
    l[i] += __shfl_xor_sync(REPRO_FULL_MASK, l[i], 2);
    if (qpos[i] >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = out_q + static_cast<long long>(qpos[i]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + col) =
          fa9_pack<T>(o[4 * j + 2 * i] / denom, o[4 * j + 2 * i + 1] / denom);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(FA9_THREADS, 1) fa9_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, T* __restrict__ out, int hq,
    int group, int sq, int sk, float scale_log2, int causal) {
  using S = Fa9Shape<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * FA9_STAGES];
  const Fa9Smem<D> sm{(fa9_smem(smem_raw) + 1023u) & ~1023u,
                      fa9_smem(bars)};
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 =
      ((sq + FA9_BM - 1) / FA9_BM - 1 - static_cast<int>(blockIdx.z)) *
      FA9_BM;
  const int n_kt = fa9_key_tiles(q0, sq, sk, causal);
  if (threadIdx.x == 0) {
    fa9_bar_init(sm.q_full(), 1);
    for (int st = 0; st < FA9_STAGES; ++st) {
      fa9_bar_init(sm.k_full(st), 1);
      fa9_bar_init(sm.v_full(st), 1);
      fa9_bar_init(sm.empty(st), 8);   // the consumers' warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the loads, by one consumer thread: Q, and K and V of tile t once its
  // stage is free
  const auto load_q = [&]() {
    fa9_bar_expect(sm.q_full(), S::Q_BYTES);
    for (int s = 0; s < S::NS; ++s)
      fa9_tma_load(sm.base + s * FA9_BM * S::SB, &q_map, sm.q_full(),
                   s * S::SC, q0, b * hq + h);
  };
  const int bh_kv = b * (hq / group) + h / group;
  const auto load_tile = [&](int t) {
    const int st = t % FA9_STAGES;
    if (t >= FA9_STAGES)
      fa9_bar_wait(sm.empty(st), (t / FA9_STAGES - 1) & 1);
    fa9_bar_expect(sm.k_full(st), S::KV_BYTES);
    for (int s = 0; s < S::NS; ++s)
      fa9_tma_load(sm.k_tile(st) + s * FA9_BN * S::SB, &k_map,
                   sm.k_full(st), s * S::SC, t * FA9_BN, bh_kv);
    fa9_bar_expect(sm.v_full(st), S::KV_BYTES);
    for (int s = 0; s < S::NS; ++s)
      fa9_tma_load(sm.v_tile(st) + s * FA9_BN * S::SB, &v_map,
                   sm.v_full(st), s * S::SC, t * FA9_BN, bh_kv);
  };

  fa9_consume<T, D>(sm, q0, n_kt, sq, sk, causal, scale_log2,
                    out + (static_cast<long long>(b) * hq + h) * sq * D,
                    load_q, load_tile);
}

typedef CUresult (*Fa9Encode)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime.
static Fa9Encode fa9_encoder() {
  static Fa9Encode fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<Fa9Encode>(p);
  }
  return fn;
}

// The tensor map of a contiguous (bh, s, d) tensor of 16-bit elements:
// boxes of sc columns x 128 rows of one head, swizzled at 2 sc bytes, zeros
// past s.
static int fa9_map(CUtensorMap* map, const void* ptr, int dtype, int d,
                   int s, long long bh, int sc) {
  const Fa9Encode encode = fa9_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(d) * 2 * s};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(sc), FA9_BN, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      3, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      sc == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int D>
static int fa9_run(const void* q, const void* k, const void* v, void* out,
                   int dtype, int batch, int hq, int hkv, int sq, int sk,
                   int causal, cudaStream_t stream) {
  using S = Fa9Shape<D>;
  CUtensorMap maps[3];
  int rc = fa9_map(&maps[0], q, dtype, D, sq,
                   static_cast<long long>(batch) * hq, S::SC);
  if (rc == 0)
    rc = fa9_map(&maps[1], k, dtype, D, sk,
                 static_cast<long long>(batch) * hkv, S::SC);
  if (rc == 0)
    rc = fa9_map(&maps[2], v, dtype, D, sk,
                 static_cast<long long>(batch) * hkv, S::SC);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      fa9_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 1/sqrt(D) and log2(e) in double, rounded once to float
  const float scale_log2 = static_cast<float>(
      1.0 / sqrt(static_cast<double>(D)) * 1.4426950408889634);
  const dim3 grid(hq, batch, (sq + FA9_BM - 1) / FA9_BM);
  fa9_kernel<T, D><<<grid, FA9_THREADS, S::SMEM, stream>>>(
      maps[0], maps[1], maps[2], static_cast<T*>(out), hq, hq / hkv, sq, sk,
      scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int fa9_dispatch(const void* q, const void* k, const void* v,
                        void* out, int dtype, int batch, int hq, int hkv,
                        int sq, int sk, int d, int causal, cudaStream_t s) {
  switch (d) {
    case 64:
      return fa9_run<T, 64>(q, k, v, out, dtype, batch, hq, hkv, sq, sk,
                            causal, s);
    case 96:
      return fa9_run<T, 96>(q, k, v, out, dtype, batch, hq, hkv, sq, sk,
                            causal, s);
    case 128:
      return fa9_run<T, 128>(q, k, v, out, dtype, batch, hq, hkv, sq, sk,
                             causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Shared memory one block needs at head dim d, in bytes (-1 for a width
// this kernel does not take).
extern "C" long long flash_attention_sm90_smem_bytes(int d) {
  switch (d) {
    case 64: return Fa9Shape<64>::SMEM;
    case 96: return Fa9Shape<96>::SMEM;
    case 128: return Fa9Shape<128>::SMEM;
    default: return -1;
  }
}

// q (batch, hq, sq, d), k and v (batch, hkv, sk, d), out like q, all
// contiguous, 16-byte aligned and of one dtype: 1 bfloat16, 2 float16;
// d 64, 96 or 128.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* out,
                                           int dtype, int batch, int hq,
                                           int hkv, int sq, int sk, int d,
                                           int causal, int device,
                                           void* stream) {
  if (batch <= 0 || batch > 65535 || hq <= 0 || hkv <= 0 || hq % hkv ||
      sq <= 0 || sk <= 0 || (sq + FA9_BM - 1) / FA9_BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return fa9_dispatch<__nv_bfloat16>(q, k, v, out, dtype, batch, hq, hkv,
                                         sq, sk, d, causal, s);
    case 2:
      return fa9_dispatch<__half>(q, k, v, out, dtype, batch, hq, hkv, sq,
                                  sk, d, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

REPRO_EXPORT_COMMON(flash_attention_sm90)
