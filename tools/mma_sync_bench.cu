// Throughput of mma.sync m16n8k8 TF32 on one card, for the design of
// src/repro_torch/kernels/csrc/flash_attention.cu: every SM runs W warps,
// each issuing C independent chains of mmas (operands from registers), with
// A non-mma instructions (integer adds, logic ops and float adds, the mix
// of a 3xTF32 split) between consecutive mmas.  Prints one JSON line per
// (W, C, A): TFLOP/s of TF32 products.  Built and run by mma_sync_bench.py.
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

template <int CH, int ALU>
__global__ void mma_chains(float* out, int iters, uint32_t seed) {
  float acc[CH][4] = {};
  const uint32_t a[4] = {seed, seed ^ 1u, seed ^ 2u, seed ^ 3u};
  uint32_t x[CH][4];
  for (int c = 0; c < CH; ++c)
    for (int j = 0; j < 4; ++j) x[c][j] = seed * (c + 3 * j + 1);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const uint32_t b0 = x[c][0], b1 = x[c][1];
#pragma unroll
      for (int j = 0; j < ALU; ++j) {
        uint32_t& r = x[c][j & 3];
        if (j % 3 == 0)
          r = r + 0x1000u + it;
        else if (j % 3 == 1)
          r = (r & 0xffffe000u) | (it & 7);
        else
          r = __float_as_uint(__uint_as_float(r) - 1.5f);
      }
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
  for (int c = 0; c < CH; ++c)
    for (int e = 0; e < 4; ++e) s += acc[c][e] + __uint_as_float(x[c][e & 3]);
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int CH, int ALU>
static void run(int warps, float* out, int sms) {
  const int iters = 4096;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  mma_chains<CH, ALU><<<sms, warps * 32>>>(out, 16, 1);
  cudaEventRecord(e0);
  mma_chains<CH, ALU><<<sms, warps * 32>>>(out, iters, 1);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = 2048.0 * CH * iters * warps * sms;
  printf("{\"warps_per_sm\": %d, \"chains\": %d, \"alu_per_mma\": %d, "
         "\"ms\": %.6f, \"tflop_per_s\": %.3f}\n",
         warps, CH, ALU, ms, flop / ms * 1e-9);
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out = nullptr;
  cudaMalloc(&out, static_cast<size_t>(sms) * 1024 * sizeof(float));
  for (int w : {4, 8, 16, 32}) {
    run<1, 0>(w, out, sms);
    run<2, 0>(w, out, sms);
    run<4, 0>(w, out, sms);
    run<8, 0>(w, out, sms);
  }
  for (int w : {8, 12, 16}) {
    run<4, 2>(w, out, sms);
    run<4, 4>(w, out, sms);
    run<4, 6>(w, out, sms);
    run<4, 8>(w, out, sms);
  }
  cudaError_t err = cudaDeviceSynchronize();
  cudaFree(out);
  return err == cudaSuccess ? 0 : 1;
}
