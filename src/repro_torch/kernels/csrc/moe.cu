// Grouped expert products of a dropless MoE layer for NVIDIA Hopper
// (sm_90a), hand-written in CUDA C++.
//
// Plain C interface, built with nvcc into the same shared library as
// attention.cu and scan.cu and bound with ctypes by
// repro_torch/kernels/_build.py; the wrapper is kernels/moe_gemm.py.
//
// Replaces no TPU kernel.  The JAX package's MoE layer drops assignments
// past a capacity and runs its experts as einsums over fixed-size slots; a
// dropless layer (granite-4.0-h: 72 experts, top-10) computes every
// assignment to the experts this card holds, so each expert's number of
// rows is known only on the device, after the router's sort.  cuBLAS
// takes a product's shape from the host, which would cost a
// synchronisation a layer.  Here the rows come sorted by expert, held
// expert e owning rows offsets[e] .. offsets[e + 1] - 1, and each launch's
// grid is sized for the worst case (an expert takes at most one
// assignment a token, so T rows): a block whose tile lies past its
// expert's rows returns at once.  Three launches a layer:
//
//   moe_gemm_kernel<true>:  h_r = silu(x_tok(r) W_gate[e]) * (x_tok(r) W_up[e])
//                           (A gathered row by row from x through tok; the
//                           gate and up products share the A tile)
//   moe_gemm_kernel<false>: o_r = gate_r * (h_r W_down[e])
//   moe_combine_kernel:     y_t = sum_k o_pos(t,k), over the token's k in
//                           order, rows of no held expert skipped; no
//                           atomics, so a call is deterministic.
//
// Bound on this card: operations.  At granite-4.0-h-small's cell (24 x 64
// tokens, top-10 of 72, 18 experts held) about 3,840 rows a layer take
// 2 x 3,840 x 3 x 4096 x 768 = 72 GFLOP (0.44 ms at 165 TFLOP/s of
// 3xTF32) against 226 MB of held expert weights (0.07 ms at 3.35 TB/s).
// Design: 64 x 64 output tiles, 4 warps of 32 x 32 each, depth 32 a stage,
// two stages in flight by cp.async; the products on the tensor cores as
// 3xTF32 (mma.sync.m16n8k8, common.cuh), float32-accurate, as flash and
// the scans.  Row strides BK + 4 (A, = 4 mod 32) and BN + 8 (B, = 8 mod 32)
// make the fragment reads hit 32 distinct banks (A: bank 4g + t, B: bank
// 8t + g).  A first kernel, right and simple: no wgmma, no TMA, no
// persistent blocks; the last tile of each expert is ragged.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int MG_BM = 64;       // rows of a tile
constexpr int MG_BN = 64;       // columns of a tile
constexpr int MG_BK = 32;       // depth of a stage
constexpr int MG_WARPS = 4;     // 2 x 2 warps of 32 x 32
constexpr int MG_THREADS = 32 * MG_WARPS;
constexpr int MG_LA = MG_BK + 4;
constexpr int MG_LB = MG_BN + 8;
constexpr int MG_A_ELEMS = MG_BM * MG_LA;
constexpr int MG_B_ELEMS = MG_BK * MG_LB;
constexpr int MG_COMBINE_THREADS = 128;

struct MoeArgs {
  const float* a;        // GATED: x (T, Kd), rows gathered through tok; else h (rows, Kd)
  const int* tok;        // (rows,) the token of each sorted row (GATED)
  const int* offsets;    // (held + 1,) each held expert's first sorted row
  const float* w0;       // (held, Kd, N): W_gate (GATED) or W_down
  const float* w1;       // (held, Kd, N): W_up (GATED), else unused
  const float* gates;    // (rows,) the gate of each sorted row (not GATED)
  float* out;            // (rows, N): h (GATED) or o
  int Kd, N;
};

template <bool GATED>
constexpr size_t moe_smem_bytes() {
  return sizeof(float) * 2 * (MG_A_ELEMS + (GATED ? 2 : 1) * MG_B_ELEMS) + sizeof(int) * MG_BM;
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

template <bool GATED>
__global__ void __launch_bounds__(MG_THREADS) moe_gemm_kernel(MoeArgs a) {
  constexpr int NB = GATED ? 2 : 1;
  constexpr int STAGE = MG_A_ELEMS + NB * MG_B_ELEMS;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);          // [2][A | B0 | B1]
  int* src = reinterpret_cast<int*>(ring + 2 * STAGE);    // [BM] each row's source row

  const int e = blockIdx.z;
  const int lo = a.offsets[e], n_e = a.offsets[e + 1] - lo;
  const int m0 = blockIdx.y * MG_BM, n0 = blockIdx.x * MG_BN;
  if (m0 >= n_e) return;  // past this expert's rows: the grid is sized for the worst case
  const int valid = min(MG_BM, n_e - m0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  for (int r = tid; r < MG_BM; r += MG_THREADS) {
    const int row = lo + m0 + min(r, valid - 1);   // a ragged tile repeats its last row
    src[r] = GATED ? a.tok[row] : row;
  }
  __syncthreads();

  const float* w0 = a.w0 + (long long)e * a.Kd * a.N + n0;
  const float* w1 = GATED ? a.w1 + (long long)e * a.Kd * a.N + n0 : nullptr;
  auto load_stage = [&](int s, int k0) {
    float* A = ring + s * STAGE;
    for (int idx = tid; idx < MG_BM * (MG_BK / 4); idx += MG_THREADS) {
      const int r = idx / (MG_BK / 4), c = (idx % (MG_BK / 4)) * 4;
      cp_async4(A + r * MG_LA + c, a.a + (long long)src[r] * a.Kd + k0 + c, true);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float* B = A + MG_A_ELEMS + b * MG_B_ELEMS;
      const float* w = b ? w1 : w0;
      for (int idx = tid; idx < MG_BK * (MG_BN / 4); idx += MG_THREADS) {
        const int r = idx / (MG_BN / 4), c = (idx % (MG_BN / 4)) * 4;
        cp_async4(B + r * MG_LB + c, w + (long long)(k0 + r) * a.N + c, true);
      }
    }
  };

  // warp (wm, wn) owns rows 32 wm .. + 31 and columns 32 wn .. + 31: two
  // m16 tiles by four n8 tiles, one accumulator set per B matrix
  const int wm = 32 * (warp & 1), wn = 32 * (warp >> 1);
  float acc[NB][2][4][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[b][i][j][q] = 0.f;

  const int nk = a.Kd / MG_BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<0>();  // stage kt landed (this thread's copies)
    __syncthreads();     // everyone's; stage kt - 1 consumed by every warp
    if (kt + 1 < nk) load_stage((kt + 1) & 1, (kt + 1) * MG_BK);  // streams in while kt computes
    cp_async_commit();
    const float* A = ring + (kt & 1) * STAGE;
    // the stage's products go to fresh accumulators, added to the running
    // sums in float32 once a stage: the tensor cores' own accumulation
    // truncates, which over a chain of 3 x Kd / 8 products (1,536 at Kd =
    // 4096) drifts past float32's rounding
    float part[NB][2][4][4];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[b][i][j][q] = 0.f;
#pragma unroll
    for (int ks = 0; ks < MG_BK / 8; ++ks) {
      Split af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* ar = A + (wm + 16 * i + g) * MG_LA + 8 * ks + t;
        af[i][0] = split_tf32(ar[0]);
        af[i][1] = split_tf32(ar[8 * MG_LA]);
        af[i][2] = split_tf32(ar[4]);
        af[i][3] = split_tf32(ar[8 * MG_LA + 4]);
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float* B = A + MG_A_ELEMS + b * MG_B_ELEMS + (8 * ks + t) * MG_LB + wn + g;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const Split bf[2] = {split_tf32(B[8 * j]), split_tf32(B[4 * MG_LB + 8 * j])};
          mma3(part[b][0][j], af[0], bf);
          mma3(part[b][1][j], af[1], bf);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[b][i][j][q] += part[b][i][j][q];
  }
  cp_async_wait<0>();  // no copy outlives the block

  // epilogue: c0, c1 at row g, columns 2t, 2t + 1; c2, c3 at row g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm + 16 * i + g + 8 * half;
      if (r >= valid) continue;
      const int row = lo + m0 + r;
      const float scale = GATED ? 1.f : a.gates[row];
      float* orow = a.out + (long long)row * a.N + n0 + wn + 2 * t;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 v;
        if constexpr (GATED) {
          v.x = silu(acc[0][i][j][2 * half]) * acc[NB - 1][i][j][2 * half];
          v.y = silu(acc[0][i][j][2 * half + 1]) * acc[NB - 1][i][j][2 * half + 1];
        } else {
          v.x = scale * acc[0][i][j][2 * half];
          v.y = scale * acc[0][i][j][2 * half + 1];
        }
        *reinterpret_cast<float2*>(orow + 8 * j) = v;
      }
    }
}

// y[t, d..d+3] = sum over k of o[pos[t, k], d..d+3] for the rows of held
// experts (pos < offsets[held]), in k order.
__global__ void __launch_bounds__(MG_COMBINE_THREADS)
moe_combine_kernel(const float* o, const int* pos, const int* n_held, float* y, int K, int D) {
  const int t = blockIdx.y, d = 4 * (blockIdx.x * MG_COMBINE_THREADS + threadIdx.x);
  if (d >= D) return;
  const int n = *n_held;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < K; ++k) {
    const int p = pos[(long long)t * K + k];
    if (p >= n) continue;
    const float4 v = load4(o + (long long)p * D + d);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  *reinterpret_cast<float4*>(y + (long long)t * D + d) = acc;
}

template <bool GATED>
cudaError_t launch_gemm(const MoeArgs& a, int max_rows, int held, cudaStream_t stream) {
  constexpr size_t smem = moe_smem_bytes<GATED>();
  cudaError_t err = cudaFuncSetAttribute(moe_gemm_kernel<GATED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.N / MG_BN, (max_rows + MG_BM - 1) / MG_BM, held);
  moe_gemm_kernel<GATED><<<grid, MG_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface, float32.  x (T, D); tok, gates (T K,) sorted by expert;
// offsets (held + 1,); pos (T, K); w_gate, w_up (held, D, F); w_down (held,
// F, D), all contiguous; h (T K, F) and o (T K, D) scratch; y (T, D) out.
// Returns a cudaError_t (0 = launched); cudaErrorInvalidValue for widths
// that are not whole tiles.
// ---------------------------------------------------------------------------

extern "C" int repro_moe_experts(int T, int D, int F, int K, int held, const float* x,
                                 const int* tok, const int* offsets, const float* gates,
                                 const int* pos, const float* w_gate, const float* w_up,
                                 const float* w_down, float* h, float* o, float* y,
                                 void* stream) {
  if (T < 1 || K < 1 || held < 1 || D % MG_BN || D % MG_BK || F % MG_BN || F % MG_BK)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // an expert takes at most one assignment a token: T rows at most
  const MoeArgs up{x, tok, offsets, w_gate, w_up, nullptr, h, D, F};
  cudaError_t err = launch_gemm<true>(up, T, held, st);
  if (err != cudaSuccess) return err;
  const MoeArgs down{h, nullptr, offsets, w_down, nullptr, gates, o, F, D};
  err = launch_gemm<false>(down, T, held, st);
  if (err != cudaSuccess) return err;
  const dim3 grid((D / 4 + MG_COMBINE_THREADS - 1) / MG_COMBINE_THREADS, T);
  moe_combine_kernel<<<grid, MG_COMBINE_THREADS, 0, st>>>(o, pos, offsets + held, y, K, D);
  return cudaGetLastError();
}
