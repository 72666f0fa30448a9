// Float32 matrix product y = x w for NVIDIA Hopper (sm_90a), hand-written
// in CUDA C++: the served projections of layers.mm.
//
// Plain C interface, built with nvcc into the same shared library as
// attention.cu, scan.cu and moe.cu and bound with ctypes by
// repro_torch/kernels/_build.py; the wrapper is kernels/gemm.py.
//
// Replaces no TPU kernel: the JAX package leaves its products to XLA.  It
// replaces cuBLAS's float32 products, which run on the CUDA cores (67
// TFLOP/s of FMA at most) because TF32 stays off: one TF32 pass keeps 10
// of float32's 23 mantissa bits.  Here the products run on the tensor
// cores as 3xTF32 (common.cuh: each operand split into TF32 hi and lo
// halves, three passes), float32-accurate, as flash, the scans and the
// grouped expert kernel do.
//
// Bound on this card: operations.  A (T, K) x (K, N) product is 2 T K N
// operations against 4 (T K + K N + T N) bytes; at the served shapes (T =
// 384 to 1,536 tokens, K and N 1,024 to 16,768) that is 180 to 700
// operations a byte, past the ridge of 165 TFLOP/s over 3.35 TB/s (49), so
// the bound is 2 T K N / 165 TFLOP/s.
//
// Design.  The operands are swapped: each tile computes y^T = w^T x^T, so
// wgmma's 64-row A is 64 weight columns, taken from registers, and its B
// is the tokens, from shared memory.  wgmma reads TF32 B only K-major, and
// x (T, K) is K-major already; w (K, N) is not, but a register operand may
// come from any layout.  So only the activation tile is split into hi and
// lo in shared memory; the weights are split in registers as they are
// loaded, and no copy of a weight is ever made.
//   A block (384 threads, one an SM, persistent) is a producer warpgroup and
// two consumer warpgroups.  A tile is 128 weight columns (64 per consumer)
// by 128 tokens, 32 deep a stage.  The producer's thread 0 keeps a ring of
// four stages in flight by TMA (the weight tile as four 32 x 32 boxes, the
// activation tile as one 128 x 32 box, both with the 128-byte swizzle;
// zero-filled past T, K and N), under mbarriers; all 128 producer threads
// split each landed activation tile into TF32 hi and lo, in wgmma's
// canonical K-major layout, into a ring of two split stages.  Each consumer
// loads its A fragments from the swizzled weight tile (conflict-free 8-byte
// loads: fragment rows g, g + 8 are columns 2g, 2g + 1 and fragment k
// columns t, t + 4 are k = 2t, 2t + 1, the split activation tile holding its
// k in that order), splits them and runs 4 k-steps x 3 passes of
// wgmma.m64n128k8.
//   Accumulation: each stage's 12 products go to fresh accumulators, added
// to the running sums in float32 once a stage, as in moe.cu: the tensor
// cores' own accumulation truncates, which over a chain of 3 K / 8 products
// (3,072 at K = 8,192) drifts past float32's rounding.
//   Filling the card: the wrapper picks a split of K (1 to 8 parts) from the
// shape where the tiles alone would leave SMs idle (qwen's T = 384, N =
// 2,560 gives 60 tiles on 132 SMs; two parts give 120).  Each part writes
// its partial tile to a workspace and counts itself on the tile's counter
// (an integer atomic); the last to arrive reads the parts back in their
// order along K (each part's loads in flight at once) and adds them, writes
// the tile and resets the counter.
// One launch a product; no float atomics, so a call's result does not
// depend on which part arrives last.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int GM_BM = 128;                 // weight columns a tile: two consumers of 64
constexpr int GM_BT = 128;                 // tokens a tile
constexpr int GM_BK = 32;                  // depth a stage
constexpr int GM_RAW = 4;                  // stages of the TMA ring
constexpr int GM_SPLIT = 2;                // stages of the split ring
constexpr int GM_THREADS = 384;            // producer warpgroup + two consumer warpgroups
constexpr int GM_CONSUMERS = 256;
constexpr int GM_PRODUCER_REGS = 56;       // 56 x 128 + 224 x 256 = 168 x 384
constexpr int GM_CONSUMER_REGS = 224;
constexpr int GM_W_FLOATS = GM_BK * GM_BM;  // 16 KB: four 32 x 32 boxes
constexpr int GM_X_FLOATS = GM_BT * GM_BK;  // 16 KB: one 128 x 32 box
constexpr int GM_STAGE_BYTES = 4 * (GM_W_FLOATS + GM_X_FLOATS);
constexpr int GM_PART = GM_BM * GM_BT;     // floats of one partial tile
constexpr int GM_BARS = 2 * GM_RAW + 2 * GM_SPLIT;
constexpr size_t GM_SMEM = 1024 /* alignment slack */ + (size_t)GM_RAW * GM_STAGE_BYTES +
                           (size_t)GM_SPLIT * 2 * 4 * GM_X_FLOATS + 8 * GM_BARS + 16;

struct GemmArgs {
  float* y;         // (T, N)
  float* ws;        // (units, GM_PART) partial tiles, splits > 1 only
  int* counters;    // (tiles,) zero between calls
  int T, N;
  int t_tiles;      // tiles along T; tile = n_tile * t_tiles + t_tile
  int kiters;       // stages along K
  int splits, kps;  // parts of K and stages a part (the last may be shorter)
  int units;        // tiles x splits; unit = tile * splits + part
};

__device__ __forceinline__ int k_begin(const GemmArgs& a, int unit) {
  return (unit % a.splits) * a.kps;
}
__device__ __forceinline__ int k_end(const GemmArgs& a, int unit) {
  return min(a.kiters, k_begin(a, unit) + a.kps);
}

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle's
// pattern repeats every 1024 bytes):
//   raw[GM_RAW]:     weight tile [4 boxes][32 k][32 n], activation tile
//                    [128 tokens][32 k], both as TMA's 128-byte swizzle lays
//                    them (16-byte chunk c of row r at c ^ (r % 8))
//   split[GM_SPLIT]: hi, lo: [tokens / 8][8 core columns][8 tokens][4 k]:
//                    core column 2j holds k = 8j + 0, 2, 4, 6, column 2j + 1
//                    k = 8j + 1, 3, 5, 7 (wgmma's canonical K-major layout
//                    without swizzle: cores 128 bytes apart along k, 1024
//                    along the tokens)
//   barriers, and the last-arrival flag.
__global__ void __launch_bounds__(GM_THREADS, 1)
    dense_gemm_kernel(const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ CUtensorMap tm_x, const GemmArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* raw = reinterpret_cast<float*>(base);
  float* split = raw + GM_RAW * (GM_W_FLOATS + GM_X_FLOATS);
  uint64_t* bars = reinterpret_cast<uint64_t*>(split + GM_SPLIT * 2 * GM_X_FLOATS);
  uint64_t* full_r = bars;                  // a raw stage landed (TMA bytes)
  uint64_t* empty_r = bars + GM_RAW;        // its weight tile read by the 8 consumer warps
  uint64_t* full_p = bars + 2 * GM_RAW;     // a split stage written
  uint64_t* empty_p = full_p + GM_SPLIT;    // and read by the 8 consumer warps
  int* last_flag = reinterpret_cast<int*>(bars + GM_BARS);

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < GM_RAW; ++s) {
      mbar_init(full_r + s, 1);
      mbar_init(empty_r + s, 8);
    }
    for (int s = 0; s < GM_SPLIT; ++s) {
      mbar_init(full_p + s, 1);
      mbar_init(empty_p + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer: TMA (thread 0) and the activation split
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(GM_PRODUCER_REGS));
    int total = 0;  // stages this block runs
    for (int u = blockIdx.x; u < a.units; u += gridDim.x) total += k_end(a, u) - k_begin(a, u);

    int cur_unit = blockIdx.x, cur_k = k_begin(a, blockIdx.x), issued = 0;
    auto issue = [&]() {  // thread 0: the next stage into its raw slot
      const int s = issued % GM_RAW;
      if (issued >= GM_RAW) mbar_wait(empty_r + s, ((issued / GM_RAW) & 1) ^ 1);
      mbar_expect_tx(full_r + s, GM_STAGE_BYTES);
      const int tile = cur_unit / a.splits;
      const int n0 = (tile / a.t_tiles) * GM_BM, t0 = (tile % a.t_tiles) * GM_BT;
      const int k0 = cur_k * GM_BK;
      float* W = raw + s * (GM_W_FLOATS + GM_X_FLOATS);
#pragma unroll
      for (int b = 0; b < GM_BM / TMA_BOX; ++b)
        tma_load(W + b * GM_BK * TMA_BOX, &tm_w, full_r + s, n0 + b * TMA_BOX, k0);
      tma_load(W + GM_W_FLOATS, &tm_x, full_r + s, k0, t0);
      if (++cur_k == k_end(a, cur_unit)) {
        cur_unit += gridDim.x;
        if (cur_unit < a.units) cur_k = k_begin(a, cur_unit);
      }
      ++issued;
    };
    if (tid == 0)
      while (issued < GM_RAW && issued < total) issue();

    for (int it = 0; it < total; ++it) {
      const int s = it % GM_RAW, p = it % GM_SPLIT;
      mbar_wait(full_r + s, (it / GM_RAW) & 1);
      mbar_wait(empty_p + p, ((it / GM_SPLIT) & 1) ^ 1);
      const float* X = raw + s * (GM_W_FLOATS + GM_X_FLOATS) + GM_W_FLOATS;
      uint32_t* hi = reinterpret_cast<uint32_t*>(split + p * 2 * GM_X_FLOATS);
      uint32_t* lo = hi + GM_X_FLOATS;
      // group (token r, k block j): k = 8j .. 8j + 7 of token r; lanes take
      // consecutive tokens, so 8 lanes read 8 distinct swizzled chunks and
      // write one whole core matrix
#pragma unroll
      for (int q = 0; q < GM_BT * GM_BK / 8 / 128; ++q) {
        const int idx = tid + 128 * q, r = idx % GM_BT, j = idx / GM_BT, r8 = r & 7;
        const float4 v0 = *reinterpret_cast<const float4*>(X + r * GM_BK + (((2 * j) ^ r8) << 2));
        const float4 v1 =
            *reinterpret_cast<const float4*>(X + r * GM_BK + (((2 * j + 1) ^ r8) << 2));
        const Split e0 = split_tf32(v0.x), e2 = split_tf32(v0.z), e4 = split_tf32(v1.x),
                    e6 = split_tf32(v1.z);
        const Split o1 = split_tf32(v0.y), o3 = split_tf32(v0.w), o5 = split_tf32(v1.y),
                    o7 = split_tf32(v1.w);
        const int at = (r >> 3) * (GM_BK * 8) + (2 * j) * 32 + r8 * 4;
        *reinterpret_cast<uint4*>(hi + at) = make_uint4(e0.hi, e2.hi, e4.hi, e6.hi);
        *reinterpret_cast<uint4*>(hi + at + 32) = make_uint4(o1.hi, o3.hi, o5.hi, o7.hi);
        *reinterpret_cast<uint4*>(lo + at) = make_uint4(e0.lo, e2.lo, e4.lo, e6.lo);
        *reinterpret_cast<uint4*>(lo + at + 32) = make_uint4(o1.lo, o3.lo, o5.lo, o7.lo);
      }
      fence_proxy_async();       // the split stage is visible to wgmma
      bar_sync<1, 128>();        // every producer thread has split (and read raw stage s)
      if (tid == 0) {
        mbar_arrive(full_p + p);
        // refill the raw slot stage it - 1 used, once the consumers free it
        if (it >= 1 && issued < total) issue();
      }
    }
    return;
  }

  // ---------------- consumers: 64 weight columns x 128 tokens each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(GM_CONSUMER_REGS));
  const int c = wg - 1, ctid = tid - 128, w = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  // this thread's A fragments: rows g, g + 8 of warp w are weight columns
  // 64c + 16w + 2g, + 1 (an 8-byte pair); k columns t, t + 4 are k = 2t,
  // 2t + 1 of each k-step.  In the swizzled box (32 k x 32 n) of those
  // columns, row k's chunk cb sits at cb ^ (k % 8).
  const int box = 2 * c + (w >> 1), nb = 16 * (w & 1) + 2 * g, cb = nb >> 2;
  const int off_a = box * GM_BK * TMA_BOX + (2 * t) * TMA_BOX + ((cb ^ (2 * t)) << 2) + (nb & 3);
  const int off_b =
      box * GM_BK * TMA_BOX + (2 * t + 1) * TMA_BOX + ((cb ^ (2 * t + 1)) << 2) + (nb & 3);

  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  int it = 0;
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    const int kb = k_begin(a, u), ke = k_end(a, u);
    for (int kk = kb; kk < ke; ++kk, ++it) {
      const int s = it % GM_RAW, p = it % GM_SPLIT;
      mbar_wait(full_r + s, (it / GM_RAW) & 1);
      mbar_wait(full_p + p, (it / GM_SPLIT) & 1);
      const float* W = raw + s * (GM_W_FLOATS + GM_X_FLOATS);
      const float* hi = split + p * 2 * GM_X_FLOATS;
      Split af[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // k-step j: rows 8j + 2t and 8j + 2t + 1
        const float2 ra = *reinterpret_cast<const float2*>(W + off_a + 8 * j * TMA_BOX);
        const float2 rb = *reinterpret_cast<const float2*>(W + off_b + 8 * j * TMA_BOX);
        af[j][0] = split_tf32(ra.x);
        af[j][1] = split_tf32(ra.y);
        af[j][2] = split_tf32(rb.x);
        af[j][3] = split_tf32(rb.y);
      }
      pin_regs(part);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t bh = wgmma_desc(hi + 64 * j, 128, GM_BK * 32);
        const uint64_t bl = wgmma_desc(hi + GM_X_FLOATS + 64 * j, 128, GM_BK * 32);
        wgmma_tf32_d<128>(part, af[j][0].lo, af[j][1].lo, af[j][2].lo, af[j][3].lo, bh, j > 0);
        wgmma_tf32_d<128>(part, af[j][0].hi, af[j][1].hi, af[j][2].hi, af[j][3].hi, bl, 1);
        wgmma_tf32_d<128>(part, af[j][0].hi, af[j][1].hi, af[j][2].hi, af[j][3].hi, bh, 1);
      }
      wgmma_commit();
      wgmma_wait();
      pin_regs(part);
#pragma unroll
      for (int j = 0; j < 4; ++j) pin_regs(af[j]);
      if (lane == 0) {  // this warp is done with both stages
        mbar_arrive(empty_r + s);
        mbar_arrive(empty_p + p);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }

    // ---------------- epilogue
    const int tile = u / a.splits;
    if (a.splits > 1) {
      float4* slot = reinterpret_cast<float4*>(a.ws) + (size_t)u * (GM_PART / 4);
#pragma unroll
      for (int q = 0; q < 16; ++q)
        __stcg(slot + q * GM_CONSUMERS + ctid,
               make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]));
      __threadfence();
      bar_sync<2, GM_CONSUMERS>();
      if (ctid == 0) *last_flag = atomicAdd(a.counters + tile, 1) == a.splits - 1;
      bar_sync<2, GM_CONSUMERS>();
      if (!*last_flag) continue;
      __threadfence();
      // the parts in their order along K, each read back whole (this block's
      // own too: the same bits as its registers), its 16 loads a thread in
      // flight at once; one L2 round trip a part, not one a load
      const float4* parts = reinterpret_cast<const float4*>(a.ws) +
                            (size_t)tile * a.splits * (GM_PART / 4) + ctid;
      for (int sp = 0; sp < a.splits; ++sp) {
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const float4 v = __ldcg(parts + sp * (GM_PART / 4) + q * GM_CONSUMERS);
          part[4 * q] = v.x;
          part[4 * q + 1] = v.y;
          part[4 * q + 2] = v.z;
          part[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = sp == 0 ? part[i] : acc[i] + part[i];
      }
      if (ctid == 0) a.counters[tile] = 0;  // ready for the next call
    }
    // acc[4i + e]: weight column n + e / 2, token 8i + 2t + e % 2 (N is a
    // multiple of 4 and n even, so n < N keeps n + 1 < N)
    const int n = (tile / a.t_tiles) * GM_BM + 64 * c + 16 * w + 2 * g;
    const int tok = (tile % a.t_tiles) * GM_BT + 2 * t;
    if (n < a.N) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = tok + 8 * i;
        if (r < a.T)
          *reinterpret_cast<float2*>(a.y + (long long)r * a.N + n) =
              make_float2(acc[4 * i], acc[4 * i + 2]);
        if (r + 1 < a.T)
          *reinterpret_cast<float2*>(a.y + (long long)(r + 1) * a.N + n) =
              make_float2(acc[4 * i + 1], acc[4 * i + 3]);
      }
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface, float32, contiguous: x (T, K), w (K, N), y (T, N) on card
// dev (made current for the launch); K and N multiples of 4, base addresses
// 16-byte aligned.  A call's shape, plan (splits, stages a part, grid, from
// kernels/gemm.py::plan), scratch and stream come in one GemmCall that the
// wrapper keeps for each shape, so a launch converts four arguments: ws,
// (tiles x splits, 128 x 128) floats, and counters, (tiles,) ints, zero,
// when splits > 1.  Returns a cudaError_t (0 = launched);
// cudaErrorInvalidValue for a shape, an alignment or a plan the kernel does
// not take.
// ---------------------------------------------------------------------------

struct GemmCall {
  int dev, T, K, N, splits, kps, grid;
  float* ws;
  int* counters;
  void* stream;
};

extern "C" int repro_gemm(const GemmCall* c, const float* x, const float* w, float* y) {
  const int kiters = (c->K + GM_BK - 1) / GM_BK;
  if (c->T < 1 || c->K < 4 || c->N < 4 || c->K % 4 || c->N % 4 || c->splits < 1 || c->kps < 1 ||
      (c->splits - 1) * c->kps >= kiters || c->splits * c->kps < kiters || c->grid < 1 ||
      c->dev < 0 || c->dev >= 64 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 ||
      (c->splits > 1 && (c->ws == nullptr || c->counters == nullptr)))
    return cudaErrorInvalidValue;
  CUtensorMap tm_w, tm_x;
  if (!make_map(&tm_w, w, c->K, c->N, GM_BK) || !make_map(&tm_x, x, c->T, c->K, GM_BT))
    return cudaErrorInvalidValue;
  const int t_tiles = (c->T + GM_BT - 1) / GM_BT, n_tiles = (c->N + GM_BM - 1) / GM_BM;
  const GemmArgs a{y, c->ws, c->counters, c->T, c->N, t_tiles, kiters, c->splits, c->kps,
                   t_tiles * n_tiles * c->splits};
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != c->dev) err = cudaSetDevice(c->dev);
  if (err != cudaSuccess) return err;
  static bool smem_set[64] = {};  // the shared-memory limit raised, by card
  if (!smem_set[c->dev]) {
    err = cudaFuncSetAttribute(dense_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)GM_SMEM);
    smem_set[c->dev] = err == cudaSuccess;
  }
  if (err == cudaSuccess) {
    dense_gemm_kernel<<<c->grid < a.units ? c->grid : a.units, GM_THREADS, GM_SMEM,
                        static_cast<cudaStream_t>(c->stream)>>>(tm_w, tm_x, a);
    err = cudaGetLastError();
  }
  if (current != c->dev) cudaSetDevice(current);
  return err;
}
