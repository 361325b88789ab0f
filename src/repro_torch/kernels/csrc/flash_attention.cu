// Blocked GQA flash attention, forward only, on the tensor cores through
// mma.sync m16n8k8 TF32, for float32 at any head dim up to 256 and for
// bfloat16 and float16 at the head dims flash_attention_sm90.cu does not take
// (it takes D 64, 96 and 128):
//
//   out[b, h, i, :] = sum_j softmax_j(q[b, h, i, :] . k[b, g, j, :] / sqrt(D))
//                     * v[b, g, j, :],   g = h / (Hq / Hkv),
//
// over the keys j <= i when causal (the top-left mask qpos >= kpos, for any
// Sq and Sk), over every key otherwise.
//
// Replaces: src/repro/kernels/flash_attention.py:82 _flash_single
// (_flash_kernel), which walks a (q block, k block) grid per (batch, head,
// group member) and carries the online-softmax state (running max m,
// denominator l, fp32 accumulator) in VMEM scratch from one k block to the
// next.  Here a loop over key tiles inside the block takes the place of that
// sequential grid dimension.
//
// Bound on the H100: operations.  4 FLOP per (row, visible key, head-dim
// element); at Sq = Sk = 4096, D = 128, causal, some 850 FLOP per byte of
// q, k, v and out in float32.  The products run on the TF32 tensor cores
// (495 TFLOP/s dense) in the "3xTF32" split, so float32-accurate work costs
// three TF32 products: the floor is 3 * operations / 495 TFLOP/s for
// float32 (G2, (1, 40, 4096, 128): 1.041 ms, against 2.565 ms for the same
// products as fp32 FMAs on the CUDA cores at 67 TFLOP/s).
//
// The arithmetic.  A float32 operand x splits into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi), rna being cvt.rna.tf32.f32's rounding (fa_split);
// a product is lo*hi + hi*lo + hi*hi, the two small terms first, each an mma
// accumulating in fp32; lo*lo is dropped.  Raw fp32 bits never reach an mma
// (the unit would truncate them).  Passes by dtype (kPassS for S = Q K^T,
// kPassPV for O += P V):
//   float32:        3 and 3;
//   bf16 / float16: 1 and 2.  Both types are exact in TF32 (bf16 keeps 7
//                   mantissa bits, f16 10, TF32 10 and f16's exponent
//                   range), so S takes one pass of exact products; P is
//                   fp32 and splits into P_hi V + P_lo V.  P thus keeps
//                   float32 precision here, as in JAX's kernel (the sm90
//                   kernel rounds it to 16 bits).
//
// Tiles (FaTile): a warp owns 16 query rows.  K and V tiles of kBK keys
// stream raw through shared memory by cp.async (tile t + 1 loads while tile
// t is used).  The head-dim bucket DMAX (the least of 32, 64, 128, 256 at or
// above D) and the dtype pick one of two ways to feed the mmas:
//   * float32 at D <= 128, the split pass: 8 warps (128 query rows) a
//     block.  Once a raw tile has landed, the block splits each of its K
//     and V elements once into a fragment buffer laid out in the order the
//     mmas read it, hi and lo, two B operands a 16-byte read; Q's hi
//     fragments live in registers, its lo fragments in shared memory.  The
//     split costs four integer-heavy instructions an element, and every
//     non-mma instruction dispatched between mma.syncs slows the tensor
//     core (tools/mma_sync_bench.py), so splitting each element once a
//     block rather than once a warp is what pays.  One raw stage: the
//     next tile loads while the block computes on the split one.  kBK 64 at
//     D <= 64, 48 at D <= 128 (Q's lo, the raw tile and the fragments fill
//     210 KB).
//   * 16-bit inputs, and float32 past D 128, the direct loads: 4 warps (64
//     rows) a block, two blocks an SM up to D 128; each lane makes its K and
//     V operands from the raw tile at the fragment load (16-bit widened,
//     exact; float32 split), the same values the split pass stores, from
//     two raw stages.  Q's fragments sit in shared memory.  kBK 64 (16-bit)
//     up to D 128, 32 (16-bit) or 16 (float32) past it.
// Q is loaded and split (or widened) once per block: each lane keeps its
// own A fragments, one 16-byte shared-memory read per head-dim step and
// part, read back only by itself.  D is padded with zeros to a multiple of
// 32 in shared memory: both products run in 32-column chunks, exact in
// Q K^T and discarded in the output, so that in a chunk each pass keeps 4
// accumulators in flight.  Raw rows have strides of Dc + 8 elements (K) and
// Dc + 4 floats or Dc + 8 halves (V), off a multiple of 32 banks for the
// fragment reads.
//
// Fragments (g = lane / 4, t = lane % 4).  m16n8k8 tf32 reads A at (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4), B at (t, g), (t + 4, g), and
// writes C at (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).  The k
// index of an mma is a sum, so it may be permuted if A and B agree: every
// product here maps slot t to element 2t of its 8 and slot t + 4 to 2t + 1.
//   S:    Q's slots hold head-dim elements 2t and 2t + 1 of each step, and so
//         do K's (fa_k_raw: one 64-bit or 32-bit read of a pair).
//   P->A: the S accumulator of key step n holds P[g][8n + 2t], P[g][8n + 2t +
//         1], P[g + 8][8n + 2t], P[g + 8][8n + 2t + 1], which are A's slots
//         t, t + 4 of rows g and g + 8 under this mapping (accumulator
//         elements 0, 2, 1, 3 in A's order): P feeds P V from registers, no
//         shuffle and no trip through shared memory.  V's key rows are read
//         in the matching order (fa_v_raw): B's slot t is V[8n + 2t], slot
//         t + 4 is V[8n + 2t + 1].
//
// The softmax runs on the S accumulators in registers, fp32: scores times
// 1/sqrt(D) * log2(e) (1/sqrt(D) rounded once from double, as JAX's Python
// float), masked logits -1e30 and masked probabilities zeroed explicitly, a
// row's max over the 4 lanes of a quad by xor shuffles, exp2 on the
// special-function unit (ex2.approx), the accumulator rescaled only when a
// row's max moved.  Causal key tiles wholly above a warp's rows are not
// computed, and wholly above the block's last row not loaded; the longest
// causal query tiles launch first.  The finish is acc / max(l, 1e-30), stored in q's dtype.  No
// atomics: the same inputs give the same bits from launch to launch.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

#define FA_MAX_D 256
#define FA_NEG_INF (-1e30f)

template <typename T, int DMAX>
struct FaTile {
  static constexpr bool kF32 = sizeof(T) == 4;
  // float32 up to D 128 splits each K and V tile once for the block into
  // shared memory (the split pass); 16-bit inputs and float32 past D 128
  // make their K and V fragments at the fragment load
  static constexpr bool kStage = kF32 && DMAX <= 128;
  static constexpr int kWarps = kStage ? 8 : 4;
  static constexpr int kBQ = 16 * kWarps;
  // blocks an SM holds at once (their shared memory fits beside each other)
  static constexpr int kBlocks = !kStage && DMAX <= 128 ? 2 : 1;
  static constexpr int kBK = DMAX <= 64 ? 64 : DMAX <= 128 ? (kF32 ? 48 : 64)
                                                            : (kF32 ? 16 : 32);
  // raw K and V stages: with the split pass the next raw tile loads while
  // the block computes on the split one, so one stage does
  static constexpr int kRawStages = kStage ? 1 : 2;
  static constexpr int kPassS = kF32 ? 3 : 1;
  static constexpr int kPassPV = kF32 ? 3 : 2;
  // Q's A fragments: hi in registers with the split pass, else in shared
  // memory; uint4 fragments a lane keeps in shared memory per head-dim step
  // (float32: lo, and hi past D 128; 16-bit: the values)
  static constexpr bool kQRegs = kStage;
  static constexpr int kQSmem = kStage ? 1 : kF32 ? 2 : 1;
  // 16-byte chunks of a row at DMAX columns: a power of two, so the tile
  // loads map threads to (row, chunk) by shifts
  static constexpr int kChunks = DMAX * static_cast<int>(sizeof(T)) / 16;
};

// The head dim the products run over: D padded with zeros to a multiple
// of 32 (both products run in 32-column chunks), and the row strides of the
// raw K and V tiles, in elements (off a multiple of 32 banks for the
// fragment reads).
__host__ __device__ inline int fa_dc(int d) { return (d + 31) & ~31; }
__host__ __device__ inline int fa_ldk(int dc) { return dc + 8; }
__host__ __device__ inline int fa_ldv(int dc, bool f32) {
  return dc + (f32 ? 4 : 8);
}

// Shared memory of one block, in bytes: Q's fragments, the raw K and V
// stages and, with the split pass, one tile of split K and V fragments (hi
// and lo).
template <typename T, int DMAX>
static long long fa_smem_bytes(int d) {
  using C = FaTile<T, DMAX>;
  const int dc = fa_dc(d);
  const long long q = 16LL * C::kWarps * (DMAX / 8) * 32 * C::kQSmem;
  const long long raw = 1LL * C::kRawStages * sizeof(T) * C::kBK *
                        (fa_ldk(dc) + fa_ldv(dc, C::kF32));
  const long long frag = C::kStage ? 2LL * 4 * C::kBK * DMAX * 2 : 0;
  return q + raw + frag;
}

__device__ __forceinline__ float fa_float(float x) { return x; }
__device__ __forceinline__ float fa_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float fa_float(__half x) { return __half2float(x); }
__device__ __forceinline__ void fa_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void fa_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void fa_store(__half* p, float x) {
  *p = __float2half(x);
}
template <typename T>
__device__ __forceinline__ T fa_zero() {
  T z;
  fa_store(&z, 0.f);
  return z;
}

// Two neighbouring elements (an even index) as floats.
__device__ __forceinline__ float2 fa_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 fa_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 fa_pair(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// The 3xTF32 split of x: hi = rna_tf32(x), lo = rna_tf32(x - hi), rna being
// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero: half a TF32
// unit, 0x1000, added to the magnitude's bits, the low 13 bits dropped),
// written out in integer operations, which is what ptxas makes of
// cvt.rna.tf32.f32, without its test for inf and NaN (hi of inf is inf
// here too).  hi is exact, as x - hi needs; lo goes to the mma with its
// rounding increment added and its low 13 bits left for the tensor core to
// drop (a .tf32 operand is read from the register's top 19 bits), as ptxas
// itself emits cvt.rna.tf32.f32 feeding an mma.  Both are rna-rounded
// TF32 values, never raw fp32 bits truncated by the unit.
__device__ __forceinline__ void fa_split(float x, uint32_t& hi,
                                         uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// c += a b, m16n8k8, tf32 operands, fp32 accumulators
__device__ __forceinline__ void fa_mma(float (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (0 for x of -1e30)
__device__ __forceinline__ float fa_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void fa_cp_async16(void* dst, const void* src,
                                              int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void fa_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void fa_cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}


// The element-by-element load of fa_load_rows, for rows or pointers off 16
// bytes; out of line, so that the hot loop's code stays small.
template <typename T, int NTHR>
__device__ __noinline__ void fa_load_rows_scalar(T* dst, int ld, const T* src,
                                                 int row0, int n, int R,
                                                 int d, int cols) {
  for (int i = threadIdx.x; i < R * cols; i += NTHR) {
    const int r = i / cols, c = i - r * cols;
    dst[r * ld + c] = row0 + r < n && c < d
                          ? src[static_cast<long long>(row0 + r) * d + c]
                          : fa_zero<T>();
  }
}

// Rows [row0, row0 + R) of a (n, d) row-major matrix into shared memory
// rows of stride ld, cols columns each (cols a multiple of 8, at most
// DMAX): zeros past d and past row n.  With vec (rows and pointers 16-byte
// aligned), 16-byte cp.async chunks that zero-fill what lies outside, a
// thread per chunk column (CHUNKS a row at DMAX); otherwise element by
// element.
template <typename T, int NTHR, int CHUNKS>
__device__ __forceinline__ void fa_load_rows(T* dst, int ld, const T* src,
                                             int row0, int n, int R, int d,
                                             int cols, int vec) {
  static_assert((CHUNKS & (CHUNKS - 1)) == 0 && CHUNKS <= NTHR,
                "a power-of-two number of chunks a row, within the block");
  if (!vec) {
    fa_load_rows_scalar<T, NTHR>(dst, ld, src, row0, n, R, d, cols);
    return;
  }
  constexpr int E = 16 / sizeof(T);
  const int c = (threadIdx.x % CHUNKS) * E;
  if (c >= cols) return;
  for (int r = threadIdx.x / CHUNKS; r < R; r += NTHR / CHUNKS) {
    const bool ok = row0 + r < n && c < d;
    fa_cp_async16(dst + r * ld + c,
                  ok ? src + static_cast<long long>(row0 + r) * d + c : src,
                  ok ? 16 : 0);
  }
}

// A lane's B operands for two mma steps, from a raw tile (g = lane / 4,
// t = lane % 4), as floats: K's for key steps 2np and 2np + 1 of head-dim
// step kd (rows 16np + g and 16np + 8 + g, elements 8kd + 2t and 8kd + 2t
// + 1), V's for column steps 2ip and 2ip + 1 of key step n (rows 8n + 2t
// and 8n + 2t + 1, columns 16ip + g and 16ip + 8 + g).
template <typename T>
__device__ __forceinline__ void fa_k_raw(const T* kr, int ldk, int kd, int np,
                                         int g, int t, float (&x)[4]) {
  const T* r0 = kr + (16 * np + g) * ldk + 8 * kd + 2 * t;
  const float2 x0 = fa_pair(r0), x1 = fa_pair(r0 + 8 * ldk);
  x[0] = x0.x;
  x[1] = x0.y;
  x[2] = x1.x;
  x[3] = x1.y;
}
template <typename T>
__device__ __forceinline__ void fa_v_raw(const T* vr, int ldv, int n, int ip,
                                         int g, int t, float (&x)[4]) {
  const T* r0 = vr + (8 * n + 2 * t) * ldv + 16 * ip + g;
  x[0] = fa_float(r0[0]);
  x[1] = fa_float(r0[ldv]);
  x[2] = fa_float(r0[8]);
  x[3] = fa_float(r0[ldv + 8]);
}
// Four B operand values as TF32: split into hi and lo (float32), or widened
// (16-bit, exact; lo is then unused).
template <bool F32>
__device__ __forceinline__ void fa_frag(const float (&x)[4], uint4& hi,
                                        uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (F32) {
      fa_split(x[e], h[e], l[e]);
    } else {
      h[e] = __float_as_uint(x[e]);
      l[e] = 0u;
    }
  }
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(FaTile<T, DMAX>::kWarps * 32,
                                  FaTile<T, DMAX>::kBlocks)
    flash_attention_mma_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v, T* __restrict__ out,
                               int hq, int group, int sq, int sk, int d,
                               float scale_log2, int causal, int vec) {
  using C = FaTile<T, DMAX>;
  constexpr int NTHR = C::kWarps * 32;
  constexpr int BQ = C::kBQ;
  constexpr int BK = C::kBK;
  constexpr int NT = BK / 8;      // 8-key steps of a key tile
  constexpr int NP = NT / 2;      // pairs of them
  constexpr int NDT = DMAX / 8;   // 8-column steps of the widest head dim
  constexpr int NDP = NDT / 2;    // pairs of them
  static_assert(NT * 4 <= 32, "a lane's visible-key bits fit one word");
  extern __shared__ __align__(16) unsigned char fa_smem[];
  const int dc = fa_dc(d);        // columns the products run over
  const int ldk = fa_ldk(dc), ldv = fa_ldv(dc, C::kF32);
  // Q's fragments, one uint4 per (warp, head-dim step, part, lane)
  uint4* qs = reinterpret_cast<uint4*>(fa_smem);
  // the stages of raw K and V tiles, as loaded
  T* raw = reinterpret_cast<T*>(qs + C::kWarps * NDT * 32 * C::kQSmem);
  const int raw_elems = BK * (ldk + ldv);
  // with the split pass, one tile of K and V fragments, hi then lo, a
  // uint4 per lane holding two mma B operands (fa_k_raw, fa_v_raw): K's at
  // [(kd * NP + np) * 2 + part][lane], V's at [(n * NDP + ip) * 2 +
  // part][lane]
  uint4* kf = reinterpret_cast<uint4*>(raw + C::kRawStages * raw_elems);
  uint4* vf = kf + NDT * NP * 2 * 32;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long long q_base = (static_cast<long long>(b) * hq + h) * sq * d;
  const long long kv_base =
      (static_cast<long long>(b) * (hq / group) + h / group) * sk * d;
  const int n_kt_all = (sk + BK - 1) / BK;
  const int n_kt =
      causal ? min(n_kt_all, (min(q0 + BQ, sq) - 1) / BK + 1) : n_kt_all;
  const int qw0 = q0 + 16 * warp;  // the warp's first row

  fa_load_rows<T, NTHR, C::kChunks>(raw, ldk, k + kv_base, 0, sk, BK, d, dc,
                                    vec);
  fa_load_rows<T, NTHR, C::kChunks>(raw + BK * ldk, ldv, v + kv_base, 0, sk,
                                    BK, d, dc, vec);
  fa_cp_commit();
  // Q, split once per block: each lane loads the A fragments it will read
  // (rows g and g + 8 of its warp, head-dim elements 2t and 2t + 1 of each
  // step; zeros past D) and keeps them, split: hi in registers or shared
  // memory, lo in shared memory that only the lane itself reads back (so
  // with no barrier)
  uint32_t qr[C::kQRegs ? NDT : 1][4];
  uint4* qs_w = qs + warp * NDT * 32 * C::kQSmem + lane;
  {
    float x[NDT][4];
    const T* qa = q + q_base + static_cast<long long>(qw0 + g) * d;
    const T* qb = qa + 8LL * d;
    const bool ra = qw0 + g < sq, rb = qw0 + g + 8 < sq;
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      const int c = 8 * j + 2 * t;
      x[j][0] = ra && c < d ? fa_float(qa[c]) : 0.f;
      x[j][1] = rb && c < d ? fa_float(qb[c]) : 0.f;
      x[j][2] = ra && c + 1 < d ? fa_float(qa[c + 1]) : 0.f;
      x[j][3] = rb && c + 1 < d ? fa_float(qb[c + 1]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NDT; ++j) {
      uint4 hi, lo;
      fa_frag<C::kF32>(x[j], hi, lo);
      if constexpr (C::kQRegs) {
        qr[j][0] = hi.x;
        qr[j][1] = hi.y;
        qr[j][2] = hi.z;
        qr[j][3] = hi.w;
        qs_w[j * 32] = lo;
      } else {
        qs_w[j * C::kQSmem * 32] = hi;
        if constexpr (C::kF32) qs_w[(2 * j + 1) * 32] = lo;
      }
    }
  }

  float m[2] = {FA_NEG_INF, FA_NEG_INF};   // rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};                 // this lane's part of each sum
  float o[NDT][4];
#pragma unroll
  for (int i = 0; i < NDT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    fa_cp_wait_all();   // raw tile kt has landed ...
    __syncthreads();    // ... for every thread, and tile kt - 1 is done
    // the next raw tile: into the other stage now, or (split pass) into
    // the one stage once this tile is split
    const auto load_next = [&](T* dst) {
      if (kt + 1 < n_kt) {
        fa_load_rows<T, NTHR, C::kChunks>(dst, ldk, k + kv_base, k0 + BK, sk,
                                          BK, d, dc, vec);
        fa_load_rows<T, NTHR, C::kChunks>(dst + BK * ldk, ldv, v + kv_base,
                                          k0 + BK, sk, BK, d, dc, vec);
        fa_cp_commit();
      }
    };
    if constexpr (!C::kStage) load_next(raw + ((kt + 1) & 1) * raw_elems);
    const T* kr = raw + (C::kStage ? 0 : (kt & 1) * raw_elems);
    const T* vr = kr + BK * ldk;
    if constexpr (C::kStage) {
      // the split pass: every K and V element of the tile split once for
      // the block, into the order the mmas read
      for (int idx = threadIdx.x; idx < NDT * NP * 32; idx += NTHR) {
        const int ln = idx & 31, np = (idx >> 5) % NP, kd = (idx >> 5) / NP;
        if (8 * kd >= dc) break;
        float x[4];
        fa_k_raw(kr, ldk, kd, np, ln >> 2, ln & 3, x);
        uint4* dst = kf + (kd * NP + np) * 2 * 32 + ln;
        fa_frag<true>(x, dst[0], dst[32]);
      }
      for (int idx = threadIdx.x; idx < NT * NDP * 32; idx += NTHR) {
        const int ln = idx & 31, ip = (idx >> 5) % NDP, n = (idx >> 5) / NDP;
        if (16 * ip >= dc) continue;
        float x[4];
        fa_v_raw(vr, ldv, n, ip, ln >> 2, ln & 3, x);
        uint4* dst = vf + (n * NDP + ip) * 2 * 32 + ln;
        fa_frag<true>(x, dst[0], dst[32]);
      }
      __syncthreads();   // the tile's fragments are in place
      load_next(raw);
    }
    // a warp whose rows all lie past sq, or (causal) above the whole tile,
    // has nothing to add
    if (qw0 >= sq || (causal && k0 > qw0 + 15)) continue;

    // S = Q K^T, this warp's 16 rows by BK keys, in 32-column chunks of
    // the head dim; the passes of one head-dim step go over every key step
    // in turn, so NT accumulators are in flight
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < NDT; ++kd) {
      if (kd % 4 == 0 && 8 * kd >= dc) break;
      uint4 qh, ql;
      if constexpr (C::kQRegs) {
        qh = make_uint4(qr[kd][0], qr[kd][1], qr[kd][2], qr[kd][3]);
        ql = qs_w[kd * 32];
      } else {
        qh = qs_w[kd * C::kQSmem * 32];
        if constexpr (C::kF32) ql = qs_w[(2 * kd + 1) * 32];
      }
      const uint32_t a[4] = {qh.x, qh.y, qh.z, qh.w};
      uint4 kh[NP], kl[NP];
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        if constexpr (C::kStage) {
          kh[np] = kf[(kd * NP + np) * 2 * 32 + lane];
          kl[np] = kf[((kd * NP + np) * 2 + 1) * 32 + lane];
        } else {
          float x[4];
          fa_k_raw(kr, ldk, kd, np, g, t, x);
          fa_frag<C::kF32>(x, kh[np], kl[np]);
        }
      }
      if constexpr (C::kPassS == 3) {
        const uint32_t al[4] = {ql.x, ql.y, ql.z, ql.w};
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          fa_mma(s[2 * np], al, kh[np].x, kh[np].y);
          fa_mma(s[2 * np + 1], al, kh[np].z, kh[np].w);
        }
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          fa_mma(s[2 * np], a, kl[np].x, kl[np].y);
          fa_mma(s[2 * np + 1], a, kl[np].z, kl[np].w);
        }
      }
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        fa_mma(s[2 * np], a, kh[np].x, kh[np].y);
        fa_mma(s[2 * np + 1], a, kh[np].z, kh[np].w);
      }
    }

    // the online softmax on the accumulators: element e of key step n is
    // row g + 8 (e >> 1), key k0 + 8n + 2t + (e & 1).  Logits are the
    // products times scale_log2 (positive), so a row's max is taken over
    // the products and scaled once, and each probability is one FMA and an
    // exp2; a masked logit is -1e30 and its probability zeroed
    const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > qw0);
    uint32_t ok = 0xffffffffu;   // bit 4n + e: the key is visible
    float mx[2] = {FA_NEG_INF, FA_NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (edge) {
          const int kpos = k0 + 8 * n + 2 * t + (e & 1);
          const int qpos = qw0 + g + 8 * (e >> 1);
          if (kpos >= sk || (causal && qpos < kpos)) {
            ok &= ~(1u << (4 * n + e));
            s[n][e] = FA_NEG_INF;
          }
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(REPRO_FULL_MASK, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(REPRO_FULL_MASK, mx[r], 2));
      const float m_cur = fmaxf(m[r], mx[r] * scale_log2);
      alpha[r] = fa_exp2(m[r] - m_cur);
      m[r] = m_cur;
      l[r] *= alpha[r];
    }
    // P in P V's A order: slot t is key 2t of the step, slot t + 4 key
    // 2t + 1, so A = (P[g][2t], P[g + 8][2t], P[g][2t + 1], P[g + 8][2t +
    // 1]) = accumulator elements 0, 2, 1, 3
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float pa[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int src = (e >> 1) | ((e & 1) << 1);   // 0, 2, 1, 3
        const float x = fa_exp2(fmaf(s[n][src], scale_log2, -m[e & 1]));
        pa[e] = (ok >> (4 * n + src)) & 1u ? x : 0.f;
        l[e & 1] += pa[e];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = pa[e];
    }
    // (a row's max rarely moves once its first tiles are seen)
    if (__any_sync(REPRO_FULL_MASK, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < NDT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] *= alpha[e >> 1];
    }

    // O += P V, P split, then the head dim in 32-column chunks (V zero past
    // d): in a chunk each pass goes over its 4 column steps in turn, 4
    // accumulators in flight, for every key step
    uint32_t ph[NT][4], pl[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) fa_split(s[n][e], ph[n][e], pl[n][e]);
#pragma unroll
    for (int cc = 0; cc < NDT / 4; ++cc) {
      if (32 * cc >= dc) break;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint4 vh[2], vl[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int ip = 2 * cc + j;
          if constexpr (C::kStage) {
            vh[j] = vf[(n * NDP + ip) * 2 * 32 + lane];
            vl[j] = vf[((n * NDP + ip) * 2 + 1) * 32 + lane];
          } else {
            float x[4];
            fa_v_raw(vr, ldv, n, ip, g, t, x);
            fa_frag<C::kF32>(x, vh[j], vl[j]);
          }
        }
        const uint32_t bh[4][2] = {{vh[0].x, vh[0].y}, {vh[0].z, vh[0].w},
                                   {vh[1].x, vh[1].y}, {vh[1].z, vh[1].w}};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          fa_mma(o[4 * cc + i], pl[n], bh[i][0], bh[i][1]);
        if constexpr (C::kPassPV == 3) {
          const uint32_t bl[4][2] = {{vl[0].x, vl[0].y}, {vl[0].z, vl[0].w},
                                     {vl[1].x, vl[1].y}, {vl[1].z, vl[1].w}};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            fa_mma(o[4 * cc + i], ph[n], bl[i][0], bl[i][1]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          fa_mma(o[4 * cc + i], ph[n], bh[i][0], bh[i][1]);
      }
    }
  }

  // the finish: each row's sum over its quad, acc / max(l, 1e-30)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(REPRO_FULL_MASK, l[r], 1);
    l[r] += __shfl_xor_sync(REPRO_FULL_MASK, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < NDT; ++i) {
    if (8 * i >= d) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = qw0 + g + 8 * (e >> 1);
      const int col = 8 * i + 2 * t + (e & 1);
      if (row < sq && col < d)
        fa_store(out + q_base + static_cast<long long>(row) * d + col,
                 o[i][e] / l[e >> 1]);
    }
  }
}

template <typename T, int DMAX>
static int flash_attention_run(const void* q, const void* k, const void* v,
                               void* out, int batch, int hq, int hkv, int sq,
                               int sk, int d, int causal, cudaStream_t s) {
  using C = FaTile<T, DMAX>;
  const int smem_bytes = static_cast<int>(fa_smem_bytes<T, DMAX>(d));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 1/sqrt(D) in double, rounded once to float (JAX's Python-float scale),
  // then times log2(e) for exp2
  const float sm_scale =
      static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const float scale_log2 =
      static_cast<float>(static_cast<double>(sm_scale) * 1.4426950408889634);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const int vec = (static_cast<long long>(d) * sizeof(T)) % 16 == 0 &&
                  bits % 16 == 0;
  const dim3 grid((sq + C::kBQ - 1) / C::kBQ, hq, batch);
  flash_attention_mma_kernel<T, DMAX>
      <<<grid, C::kWarps * 32, smem_bytes, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), hq, hq / hkv, sq,
          sk, d, scale_log2, causal, vec);
  return static_cast<int>(cudaGetLastError());
}

// The head-dim bucket of d: 32, 64, 128 or 256 (0 past FA_MAX_D)
static inline int fa_dmax(int d) {
  return d <= 0 ? 0 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128
         : d <= FA_MAX_D ? 256 : 0;
}

template <typename T>
static int flash_attention_dispatch(const void* q, const void* k,
                                    const void* v, void* out, int batch,
                                    int hq, int hkv, int sq, int sk, int d,
                                    int causal, cudaStream_t s) {
  switch (fa_dmax(d)) {
    case 32:
      return flash_attention_run<T, 32>(q, k, v, out, batch, hq, hkv, sq, sk,
                                        d, causal, s);
    case 64:
      return flash_attention_run<T, 64>(q, k, v, out, batch, hq, hkv, sq, sk,
                                        d, causal, s);
    case 128:
      return flash_attention_run<T, 128>(q, k, v, out, batch, hq, hkv, sq,
                                         sk, d, causal, s);
    case 256:
      return flash_attention_run<T, 256>(q, k, v, out, batch, hq, hkv, sq,
                                         sk, d, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
static long long fa_smem_of(int d) {
  switch (fa_dmax(d)) {
    case 32: return fa_smem_bytes<T, 32>(d);
    case 64: return fa_smem_bytes<T, 64>(d);
    case 128: return fa_smem_bytes<T, 128>(d);
    case 256: return fa_smem_bytes<T, 256>(d);
    default: return -1;
  }
}

// Shared memory one block needs at head dim d and dtype code (0 float32, 1
// bfloat16, 2 float16), in bytes; -1 past FA_MAX_D or for another code.
extern "C" long long flash_attention_smem_bytes(int d, int dtype) {
  switch (dtype) {
    case 0: return fa_smem_of<float>(d);
    case 1: return fa_smem_of<__nv_bfloat16>(d);
    case 2: return fa_smem_of<__half>(d);
    default: return -1;
  }
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
