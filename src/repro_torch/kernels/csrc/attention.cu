// Attention kernels for NVIDIA Hopper (sm_90a), hand-written in CUDA C++.
//
// Plain C interface, built with nvcc into a shared library and bound with
// ctypes by repro_torch/kernels/_build.py.  Both kernels read float32 or
// bfloat16, compute in float32 and write the input's type.  Masked scores
// use the finite NEG_INF = -1e30 of the TPU kernels: a row whose first kv
// tile is fully masked accumulates exp(0) = 1 junk that alpha = exp(-1e30 -
// m) = 0 wipes at its first valid score.  Slots past the end of the
// sequence are -inf and weigh exactly 0.
//
// flash_attn_kernel replaces the Pallas kernel
//   src/repro/kernels/flash_attention.py::flash_attention (_attn_kernel).
//   Bound on this card: operations.  Causal prefill at B=4, S=512, H=32,
//   hd=128 is 8.6 GFLOP of products against 84 MB of traffic.  The products
//   run on the tensor cores as 3xTF32 (common.cuh: float32-accurate, three
//   TF32 passes), so the bound is 52 us at 495 / 3 = 165 TFLOP/s (129 us at
//   the CUDA cores' 67 TFLOP/s of float32 FMA).
//   Design: one warpgroup (4 warps) per (q tile of 64 rows, q head,
//   batch) runs wgmma.m64nNk8 (tf32): Q K^T with N = 32 keys, P V with N =
//   head_dim.  Q is pre-scaled by sm_scale and split into hi/lo once, as A
//   fragments in registers for the whole kv loop.  K and V tiles of 32 keys
//   come in by cp.async (rows past S zero-filled) into a raw buffer, the
//   next tile while this one computes; the warpgroup splits each tile once
//   into tf32 halves in wgmma's canonical K-major layout, V transposed
//   (wgmma takes tf32 B only K-major, and P V's k is the key).  The TPU's
//   sequential kv grid axis becomes a loop inside the block, bounded to the
//   kv tiles the causal / window mask can reach (the TPU grid visits every
//   tile); only tiles on an edge of the mask are masked.  Shared memory at
//   hd 128, float32: 4 split tiles x 32 x 128 floats + 2 raw tiles x 32 x
//   132 = 99,328 B, and 255 registers a thread: two blocks per SM.  The
//   online softmax stays in registers: a row of the accumulator lives in
//   one quad of 4 lanes, so its max takes 2 shuffles and its sum is reduced
//   once, at the end.  P V sums each k-step's keys in the order (2t, 2t+1)
//   for A columns (t, t+4), so the score accumulator is P's A fragment as
//   it stands (no shuffle, no trip through shared memory); the split V^T
//   holds its keys in that order.  q tiles are issued heaviest first so the
//   causal tail does not idle SMs.  Ragged S is masked here; the TPU kernel
//   asserted S % 128 == 0.  The G query heads of a kv head each stream and
//   split its K/V (from L2).
//
// decode_attn_kernel replaces the Pallas kernel
//   src/repro/kernels/decode_attention.py::decode_attention (_decode_kernel).
//   Bound on this card: bytes.  One query token reads the whole K/V cache
//   (2 * B * KV * S * hd * 4 bytes; 17 MB per layer for qwen3-4b at B=4,
//   S=524) and does 4 * H * S * hd operations on it, float32 FMA on the
//   CUDA cores.
//   Design (flash-decoding): B * KV blocks alone (32 for the slice) leave
//   most of the 132 SMs idle, so each (batch, kv head)'s cache is cut into
//   chunks of whole 64-slot tiles and one block runs per (kv head, batch,
//   chunk).  A block streams each K/V tile of its chunk once into shared
//   memory for the G = H / KV query heads that share it (the TPU grid
//   re-read it for every q head), keeps an online softmax per head, and
//   writes its unnormalised sum beside its running max and sum;
//   decode_attn_combine rescales the chunks to their common max and
//   divides.  K/V are read through element strides, so the engine passes
//   its heads-major cache (B, KV, S, hd) as a (B, S, KV, hd) view without
//   copying it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// Prefill: blockwise online-softmax attention on the tensor cores (wgmma)
// ---------------------------------------------------------------------------

constexpr int FA_BQ = 64;             // query rows per block: one warpgroup, 16 per warp
constexpr int FA_BK = 32;             // keys per kv tile
constexpr int FA_THREADS = 128;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, H, KV;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;  // elements
  int causal, window;  // window <= 0: no window
  float sm_scale;
};

// Shared memory: the current kv tile split into tf32 halves in wgmma's
// canonical layout (K hi, K lo: [BK][HD]; V^T hi, V^T lo: [HD][BK]; float32
// bits), then the raw K and V tiles the next copy lands in (rows of HD + 4
// in the input's type).  hd 128, float32: 4 * 32 * 128 * 4 + 2 * 32 * 132 *
// 4 = 99,328 B, two blocks per SM.
template <typename T, int HD>
__host__ __device__ constexpr size_t flash_smem_bytes() {
  return sizeof(float) * 4 * FA_BK * HD + sizeof(T) * 2 * FA_BK * (HD + 4);
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS) flash_attn_kernel(FlashArgs a) {
  constexpr int LDR = HD + 4;     // raw rows: the split pass's 16-byte reads hit distinct banks
  constexpr int KS = HD / 8;      // k-steps of the score product
  constexpr int NJ = FA_BK / 8;   // key chunks of a kv tile: score n-tiles, k-steps of P V
  constexpr int TS = FA_BK * HD;  // floats of one split tile
  static_assert(HD % 16 == 0 || HD == 80, "head_dim");

  extern __shared__ float4 smem4[];
  float* Khi = reinterpret_cast<float*>(smem4);
  float* Klo = Khi + TS;
  float* Vhi = Klo + TS;  // V^T
  float* Vlo = Vhi + TS;
  T* Kr = reinterpret_cast<T*>(Vlo + TS);  // [BK][LDR] raw K, then [BK][LDR] raw V
  T* Vr = Kr + FA_BK * LDR;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = qt * FA_BQ;
  const int r0 = q0 + 16 * warp;  // this warp's first query row

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // kv tiles any row of this q tile can see
  const int k_hi = a.causal ? min(a.S, q0 + FA_BQ) : a.S;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt_lo = k_lo / FA_BK, kt_hi = (k_hi + FA_BK - 1) / FA_BK;

  auto load_tile = [&](int kt) {
    copy_rows_async<FA_BK, HD, LDR, FA_THREADS>(Kr, kp, a.k_ss, kt * FA_BK, a.S);
    copy_rows_async<FA_BK, HD, LDR, FA_THREADS>(Vr, vp, a.v_ss, kt * FA_BK, a.S);
    cp_async_commit();
  };
  if (kt_lo < kt_hi) load_tile(kt_lo);

  // Q, pre-scaled by sm_scale and split into hi/lo once, as wgmma A
  // fragments in registers for the whole kv loop (rows past S are 0)
  Split qa[KS][4];
  {
    const int ra = r0 + g, rb = r0 + g + 8;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = 8 * ks + t;
      qa[ks][0] = split_tf32(ra < a.S ? to_f32(qp[ra * a.q_ss + c]) * a.sm_scale : 0.f);
      qa[ks][1] = split_tf32(rb < a.S ? to_f32(qp[rb * a.q_ss + c]) * a.sm_scale : 0.f);
      qa[ks][2] = split_tf32(ra < a.S ? to_f32(qp[ra * a.q_ss + c + 4]) * a.sm_scale : 0.f);
      qa[ks][3] = split_tf32(rb < a.S ? to_f32(qp[rb * a.q_ss + c + 4]) * a.sm_scale : 0.f);
    }
  }

  // rows g and g + 8 of each warp: running max, this lane's share of the
  // running sum (the quad's shares are added at the end), output columns
  // 8n + 2t, 8n + 2t + 1 (o[4n + e], wgmma's accumulator layout)
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    cp_async_wait<0>();  // this thread's copies of tile kt landed
    __syncthreads();     // everyone's; and the last tile's products are done

    // split the tile once for the warpgroup, into core matrices of 8 rows
    // x 16 bytes (rows 16 bytes apart, cores 128 bytes apart along k):
    // K as [key / 8][d / 4] cores, V^T as [d / 8][k-step, half] cores where
    // half 0 holds keys 8j + 0, 2, 4, 6 and half 1 keys 8j + 1, 3, 5, 7 (the
    // order the score accumulator hands P over in, see below)
    for (int idx = tid; idx < FA_BK * HD / 4; idx += FA_THREADS) {
      const int r8 = idx & 7, kb = (idx >> 3) % (HD / 4), nb = (idx >> 3) / (HD / 4);
      const float4 x = load4(Kr + (8 * nb + r8) * LDR + 4 * kb);
      const Split s0 = split_tf32(x.x), s1 = split_tf32(x.y), s2 = split_tf32(x.z),
                  s3 = split_tf32(x.w);
      const int at = nb * HD * 8 + kb * 32 + r8 * 4;
      *reinterpret_cast<uint4*>(Khi + at) = make_uint4(s0.hi, s1.hi, s2.hi, s3.hi);
      *reinterpret_cast<uint4*>(Klo + at) = make_uint4(s0.lo, s1.lo, s2.lo, s3.lo);
    }
    for (int idx = tid; idx < FA_BK * HD / 4; idx += FA_THREADS) {
      const int d8 = idx & 7, kb = (idx >> 3) % (FA_BK / 4), nb = (idx >> 3) / (FA_BK / 4);
      const T* vc = Vr + (8 * (kb >> 1) + (kb & 1)) * LDR + 8 * nb + d8;
      const Split s0 = split_tf32(to_f32(vc[0])), s1 = split_tf32(to_f32(vc[2 * LDR])),
                  s2 = split_tf32(to_f32(vc[4 * LDR])), s3 = split_tf32(to_f32(vc[6 * LDR]));
      const int at = nb * FA_BK * 8 + kb * 32 + d8 * 4;
      *reinterpret_cast<uint4*>(Vhi + at) = make_uint4(s0.hi, s1.hi, s2.hi, s3.hi);
      *reinterpret_cast<uint4*>(Vlo + at) = make_uint4(s0.lo, s1.lo, s2.lo, s3.lo);
    }
    fence_proxy_async();  // the split tile is visible to wgmma
    __syncthreads();      // and the raw tile is free
    if (kt + 1 < kt_hi) load_tile(kt + 1);  // streams in while this tile computes

    const int k0 = kt * FA_BK;
    // scores S = (Q sm_scale) K^T: 64 rows x FA_BK keys, K-major B
    float sc[NJ * 4];
#pragma unroll
    for (int i = 0; i < NJ * 4; ++i) sc[i] = 0.f;
    pin_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma3<FA_BK>(sc, qa[ks], wgmma_desc(Khi + 64 * ks, 128, HD * 32),
                    wgmma_desc(Klo + 64 * ks, 128, HD * 32));
    wgmma_commit();
    wgmma_wait();
    pin_regs(sc);

    // mask (only on a tile at an edge of the mask) and online softmax;
    // sc[4j + e] is row g, sc[4j + 2 + e] row g + 8, key k0 + 8 j + 2 t + e
    const bool edge = k0 + FA_BK > a.S || (a.causal && k0 + FA_BK - 1 > q0) ||
                      (a.window > 0 && k0 <= q0 + FA_BQ - 1 - a.window);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = r0 + g + 8 * r;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + 8 * j + 2 * t + e;
          float s = sc[4 * j + 2 * r + e];
          if (edge && kj >= a.S)
            s = -INFINITY;
          else if (edge && ((a.causal && kj > qi) || (a.window > 0 && kj <= qi - a.window)))
            s = NEG_INF;
          sc[4 * j + 2 * r + e] = s;
          rmax = fmaxf(rmax, s);
        }
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      const float m_new = fmaxf(m[r], rmax);
      alpha[r] = exp_fast(m[r] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp_fast(sc[4 * j + 2 * r + e] - m_new);
          sc[4 * j + 2 * r + e] = p;
          rsum += p;
        }
      l[r] = alpha[r] * l[r] + rsum;
      m[r] = m_new;
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[4 * n + 0] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
    }

    // o += P V.  A k-step's 8 keys are summed in the order (2t, 2t + 1) for
    // A columns (t, t + 4): the score accumulator is P's A fragment as it
    // stands, and V^T's cores hold the keys in that order.
    Split pa[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      pa[j][0] = split_tf32(sc[4 * j + 0]);
      pa[j][1] = split_tf32(sc[4 * j + 2]);
      pa[j][2] = split_tf32(sc[4 * j + 1]);
      pa[j][3] = split_tf32(sc[4 * j + 3]);
    }
    pin_regs(o);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      wgmma3<HD>(o, pa[j], wgmma_desc(Vhi + 64 * j, 128, FA_BK * 32),
                 wgmma_desc(Vlo + 64 * j, 128, FA_BK * 32));
    wgmma_commit();
    wgmma_wait();
    pin_regs(o);
#pragma unroll
    for (int j = 0; j < NJ; ++j) pin_regs(pa[j]);
  }

  T* op = static_cast<T*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int s = r0 + g + 8 * r;
    if (s >= a.S) continue;
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    T* orow = op + (((long long)b * a.S + s) * a.H + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      orow[8 * n] = from_f32<T>(o[4 * n + 2 * r] * inv);
      orow[8 * n + 1] = from_f32<T>(o[4 * n + 2 * r + 1] * inv);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_flash(const FlashArgs& a, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + FA_BQ - 1) / FA_BQ, a.H, a.B);
  flash_attn_kernel<T, HD><<<grid, FA_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(const FlashArgs& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_flash<T, 32>(a, stream);
    case 64: return launch_flash<T, 64>(a, stream);
    case 80: return launch_flash<T, 80>(a, stream);
    case 128: return launch_flash<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Decode: one query token per sequence against the KV cache
// ---------------------------------------------------------------------------

constexpr int DA_BK = 64;
constexpr int DA_THREADS = 256;
constexpr int DA_MAXG = 16;  // query heads per kv head

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;   // (B,)
  const int* kv_pos;  // (B, S), row stride kvp_sb
  void* o;            // (B, 1, H, hd), contiguous
  float* part_o;      // (B, KV, n_split, G, hd): each chunk's unnormalised sum
  float* part_ml;     // (B, KV, n_split, G, 2): each chunk's running max and sum
  int B, S, H, KV;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, kvp_sb;  // elements
  int window;  // <= 0: no window
  float sm_scale;
  int chunk;    // cache slots per chunk, a multiple of DA_BK
  int n_split;  // chunks per (batch, kv head) = gridDim.z
};

__host__ __device__ constexpr size_t decode_smem_bytes(int hd, int g) {
  return sizeof(float) * (size_t)(g * hd + DA_BK * (hd + 1) + DA_BK * hd + g * DA_BK + 3 * g) +
         sizeof(int) * DA_BK;
}

template <typename T, int HD>
__global__ void __launch_bounds__(DA_THREADS) decode_attn_kernel(DecodeArgs a) {
  constexpr int KS = HD + 1;  // padded K row: lanes on consecutive keys hit distinct banks
  constexpr int MAXE = (DA_MAXG * HD + DA_THREADS - 1) / DA_THREADS;
  constexpr int NWARPS = DA_THREADS / 32;
  static_assert(DA_BK == 64, "the softmax step gives each lane two keys");

  const int G = a.H / a.KV;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [G][HD], pre-scaled
  float* Ks = Qs + G * HD;                       // [BK][KS]
  float* Vs = Ks + DA_BK * KS;                   // [BK][HD]
  float* Ss = Vs + DA_BK * HD;                   // [G][BK] scores, then weights
  float* m_s = Ss + G * DA_BK;                   // [G] running max
  float* l_s = m_s + G;                          // [G] running sum
  float* al_s = l_s + G;                         // [G] rescale of this tile
  int* kp_s = reinterpret_cast<int*>(al_s + G);  // [BK] slot positions

  const int kvh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qpos = a.q_pos[b];
  const int s_lo = split * a.chunk, s_hi = min(a.S, s_lo + a.chunk);

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + (long long)kvh * G * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const int* kvpos = a.kv_pos + b * a.kvp_sb;

  for (int i = tid; i < G * HD; i += DA_THREADS) {
    const int g = i / HD, d = i % HD;
    Qs[i] = to_f32(qp[g * a.q_sh + d]) * a.sm_scale;
  }
  for (int g = tid; g < G; g += DA_THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  float acc[MAXE];
#pragma unroll
  for (int e = 0; e < MAXE; ++e) acc[e] = 0.f;

  for (int k0 = s_lo; k0 < s_hi; k0 += DA_BK) {
    __syncthreads();  // Q staged / previous tile consumed
    stage_rows<DA_BK, HD, KS, DA_THREADS>(Ks, kp, a.k_ss, k0, s_hi, 1.f);
    stage_rows<DA_BK, HD, HD, DA_THREADS>(Vs, vp, a.v_ss, k0, s_hi, 1.f);
    for (int r = tid; r < DA_BK; r += DA_THREADS)
      kp_s[r] = k0 + r < s_hi ? kvpos[k0 + r] : -1;
    __syncthreads();

    for (int i = tid; i < G * DA_BK; i += DA_THREADS) {
      const int g = i / DA_BK, j = i % DA_BK;
      float s;
      if (k0 + j >= s_hi) {
        s = -INFINITY;
      } else {
        const float* qrow = &Qs[g * HD];
        const float* krow = &Ks[j * KS];
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) dot = fmaf(qrow[d], krow[d], dot);
        const int pos = kp_s[j];
        const bool valid = pos >= 0 && pos <= qpos && (a.window <= 0 || pos > qpos - a.window);
        s = valid ? dot : NEG_INF;
      }
      Ss[i] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NWARPS) {
      const float s0 = Ss[g * DA_BK + lane], s1 = Ss[g * DA_BK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      Ss[g * DA_BK + lane] = p0;
      Ss[g * DA_BK + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = alpha * l_s[g] + sum;
        al_s[g] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int e = 0; e < MAXE; ++e) {
      const int idx = tid + e * DA_THREADS;
      if (idx < G * HD) {
        const int g = idx / HD, c = idx % HD;
        const float* prow = &Ss[g * DA_BK];
        float x = acc[e] * al_s[g];
#pragma unroll 8
        for (int j = 0; j < DA_BK; ++j) x = fmaf(prow[j], Vs[j * HD + c], x);
        acc[e] = x;
      }
    }
  }
  __syncthreads();

  // this chunk's partial result; a fully masked chunk keeps m = NEG_INF and
  // so weighs exp(NEG_INF - m) = 0 beside any chunk with a valid slot
  const long long row = ((long long)b * a.KV + kvh) * a.n_split + split;
  float* po = a.part_o + row * G * HD;
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    const int idx = tid + e * DA_THREADS;
    if (idx < G * HD) po[idx] = acc[e];
  }
  float* pml = a.part_ml + row * G * 2;
  for (int g = tid; g < G; g += DA_THREADS) {
    pml[2 * g] = m_s[g];
    pml[2 * g + 1] = l_s[g];
  }
}

// One block per (q head, batch), one thread per output element: rescale
// each chunk's sum to the largest chunk max and divide by the summed weight.
template <typename T>
__global__ void decode_attn_combine(DecodeArgs a) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x, hd = blockDim.x;
  const int G = a.H / a.KV, kvh = h / G, g = h % G;
  const long long row0 = ((long long)b * a.KV + kvh) * a.n_split;
  float m = NEG_INF;
  for (int s = 0; s < a.n_split; ++s) m = fmaxf(m, a.part_ml[((row0 + s) * G + g) * 2]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < a.n_split; ++s) {
    const float* ml = &a.part_ml[((row0 + s) * G + g) * 2];
    const float w = expf(ml[0] - m);
    l = fmaf(w, ml[1], l);
    acc = fmaf(w, a.part_o[((row0 + s) * G + g) * hd + d], acc);
  }
  T* op = static_cast<T*>(a.o) + ((long long)b * a.H + h) * hd;
  op[d] = from_f32<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T, int HD>
cudaError_t launch_decode(const DecodeArgs& a, cudaStream_t stream) {
  const int G = a.H / a.KV;
  const size_t smem = decode_smem_bytes(HD, G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)decode_smem_bytes(HD, DA_MAXG));
  if (err != cudaSuccess) return err;
  decode_attn_kernel<T, HD><<<dim3(a.KV, a.B, a.n_split), DA_THREADS, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_combine<T><<<dim3(a.H, a.B), HD, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_decode(const DecodeArgs& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_decode<T, 32>(a, stream);
    case 64: return launch_decode<T, 64>(a, stream);
    case 80: return launch_decode<T, 80>(a, stream);
    case 128: return launch_decode<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface.  dtype: 0 = float32, 1 = bfloat16.  Strides are in elements
// and multiples of 4, the last dimension is contiguous, and q/k/v start on
// a 4-element boundary.  Returns a cudaError_t (0 = launched);
// cudaErrorInvalidValue for a head_dim, dtype or query-group size that no
// kernel here is built for: these switches are the one list of them.
// ---------------------------------------------------------------------------

extern "C" int repro_flash_attention(int dtype, int hd, const void* q, const void* k,
                                     const void* v, void* o, int B, int S, int H, int KV,
                                     const long long* strides,  // q b,s,h  k b,s,h  v b,s,h
                                     int causal, int window, float sm_scale, void* stream) {
  FlashArgs a{q, k, v, o, B, S, H, KV,
              strides[0], strides[1], strides[2], strides[3], strides[4],
              strides[5], strides[6], strides[7], strides[8],
              causal, window, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_flash<float>(a, hd, st);
  if (dtype == 1) return dispatch_flash<__nv_bfloat16>(a, hd, st);
  return cudaErrorInvalidValue;
}

// work: float32 scratch of B * KV * max_split * (H / KV) * (hd + 2) elements.
// The cache is cut into at most max_split chunks of whole DA_BK-slot tiles.
extern "C" int repro_decode_attention(int dtype, int hd, const void* q, const void* k,
                                      const void* v, const int* q_pos, const int* kv_pos,
                                      void* o, float* work, int max_split,
                                      int B, int S, int H, int KV,
                                      const long long* strides,  // q b,h  k b,s,h  v b,s,h  kv_pos b
                                      int window, float sm_scale, void* stream) {
  if (S < 1 || max_split < 1 || H % KV != 0 || H / KV > DA_MAXG) return cudaErrorInvalidValue;
  const int per_split = (S + max_split - 1) / max_split;
  const int chunk = (per_split + DA_BK - 1) / DA_BK * DA_BK;
  const int n_split = (S + chunk - 1) / chunk;  // <= max_split, none empty
  float* part_ml = work + (long long)B * KV * n_split * (H / KV) * hd;
  DecodeArgs a{q, k, v, q_pos, kv_pos, o, work, part_ml, B, S, H, KV,
               strides[0], strides[1], strides[2], strides[3], strides[4],
               strides[5], strides[6], strides[7], strides[8],
               window, sm_scale, chunk, n_split};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_decode<float>(a, hd, st);
  if (dtype == 1) return dispatch_decode<__nv_bfloat16>(a, hd, st);
  return cudaErrorInvalidValue;
}
