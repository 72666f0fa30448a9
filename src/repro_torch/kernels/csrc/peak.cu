// Peak rates of the float32 routes the kernels can take on this card: the
// two tensor-core instructions with tf32 operands (wgmma.m64n128k8, A from
// registers and B from shared memory, as flash_attn_kernel issues it;
// mma.sync.m16n8k8, as ssd_scan_kernel issues it; three passes make one
// float32-accurate product) and float32 FMA on the CUDA cores.  Operands
// stay in registers or shared memory and accumulators are independent, so
// neither memory nor dependencies limit the rates.  A standalone program,
// not part of the kernel library: `python -m repro_torch.kernels._build
// --peaks` builds and runs it and prints one JSON object.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "common.cuh"

namespace {

constexpr int CHAINS = 8;
constexpr int ITERS = 4096;

__global__ void mma_tf32_loop(float* out) {
  float c[CHAINS][4] = {};
  const uint32_t a = threadIdx.x * 0x1000u, b = blockIdx.x * 0x2000u;
  for (int i = 0; i < ITERS; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a), "r"(a + 1), "r"(a + 2), "r"(a + 3), "r"(b), "r"(b + j));
  }
  float s = 0.f;
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void wgmma_tf32_loop(float* out) {
  __shared__ __align__(128) float b[8 * 128];  // B (8 x 128): 16 x 2 cores
  for (int i = threadIdx.x; i < 8 * 128; i += blockDim.x) b[i] = 1e-3f * i;
  fence_proxy_async();
  __syncthreads();
  float d[64] = {};
  const uint32_t a = threadIdx.x * 0x1000u;
  const uint64_t desc = wgmma_desc(b, 128, 256);
  for (int i = 0; i < ITERS / 8; ++i) {
    pin_regs(d);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 8; ++j) wgmma_tf32<128>(d, a, a + 1, a + 2, a + 3, desc);
    wgmma_commit();
    wgmma_wait();
    pin_regs(d);
  }
  float s = 0.f;
  for (int j = 0; j < 64; ++j) s += d[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void ffma_loop(float* out) {
  float c[CHAINS] = {};
  const float x = threadIdx.x * 1e-3f, y = 1.0001f;
  for (int i = 0; i < 8 * ITERS; ++i)
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) c[j] = fmaf(c[j], y, x);
  float s = 0.f;
  for (int j = 0; j < CHAINS; ++j) s += c[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <typename F>
float best_ms(F launch) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float best = 1e30f;
  for (int rep = 0; rep < 4; ++rep) {  // the first is the warm-up
    cudaEventRecord(e0);
    launch();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    if (rep > 0 && ms < best) best = ms;
  }
  return best;
}

}  // namespace

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int blocks = 4 * sms, threads = 128;  // 16 warps on every SM
  float* out;
  if (cudaMalloc(&out, sizeof(float) * blocks * threads) != cudaSuccess) return 1;
  const double warps = blocks * threads / 32.0;
  const float mma_ms = best_ms([&] { mma_tf32_loop<<<blocks, threads>>>(out); });
  const float wgmma_ms = best_ms([&] { wgmma_tf32_loop<<<2 * sms, 128>>>(out); });
  const float ffma_ms = best_ms([&] { ffma_loop<<<blocks, threads>>>(out); });
  if (cudaDeviceSynchronize() != cudaSuccess) return 1;
  const double mma_flop = warps * ITERS * CHAINS * 2.0 * 16 * 8 * 8;
  const double wgmma_flop = 2.0 * sms * (ITERS / 8) * 8 * 2.0 * 64 * 128 * 8;
  const double ffma_flop = blocks * threads * 8.0 * ITERS * CHAINS * 2.0;
  printf("{\"wgmma_tf32_tflop_s\": %.1f, \"mma_sync_tf32_tflop_s\": %.1f, "
         "\"ffma_f32_tflop_s\": %.1f}\n",
         wgmma_flop / wgmma_ms / 1e9, mma_flop / mma_ms / 1e9, ffma_flop / ffma_ms / 1e9);
  cudaFree(out);
  return 0;
}
