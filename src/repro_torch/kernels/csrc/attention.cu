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
//   asserted S % 128 == 0.  Unlike the TPU kernel, a call with no mask may
//   take a kv length of its own, Skv (a prompt's cross-attention to an
//   encoder's frames): the kv loop, its zero-fill and the ragged-edge mask
//   run to Skv, the q tiles, the grid and the output to S.  The G query
//   heads of a kv head each stream and split its K/V (from L2).
//   V may be narrower than Q and K (HDV < HD): DeepSeek-V2's multi-head
//   latent attention scores over 128 + 64 rotated dims and averages 128-wide
//   values.  At HD 192 Q's split halves would take 192 registers a thread
//   beside the 64 of the accumulator, so that instantiation keeps them in
//   shared memory and wgmma reads A from there (222,208 B of shared memory
//   in float32, one block an SM); V is not padded to 192, which would add
//   half to P V.  The other widths keep Q in registers, as before.
//
// decode_attn_kernel replaces the Pallas kernel
//   src/repro/kernels/decode_attention.py::decode_attention (_decode_kernel).
//   Bound on this card: bytes.  One query token reads the whole K/V cache
//   (2 * B * KV * S * hd * 4 bytes; 17 MB per layer for qwen3-4b at B=4,
//   S=524: 5.2 us at 3.35 TB/s) and does 4 * H * S * hd operations on it,
//   about G / 2 per byte against the CUDA cores' ridge of 20, so no product
//   goes to the tensor cores.  What costs time is keeping the memory busy
//   from 32 (batch, kv head) pairs, and every instruction between a tile's
//   arrival and the next request.
//   Design (one launch, split-KV): the slots of each (batch, kv head) are
//   cut into C <= 8 equal chunks, one block each, and the C blocks run as
//   one thread-block cluster; C is picked on the host from the cluster room
//   the card reports (decode_attention.py::decode_split).  Inside a block
//   each warp works alone on 4 rows of every 32-slot step: it issues its
//   rows' K, V and positions by cp.async into its part of a ring of 2 to 4
//   stages (in the cache's type, converted at use), K and V as separate
//   groups so V's wait comes after the scores, and refills a stage as soon
//   as it has read it; no barrier of the block runs inside the kv loop.
//   Scores: the warp's lanes share each row (lane l holds 4 elements of the
//   row and of q), and a reduce-scatter of shuffles leaves each (row, head)
//   dot product in its own lanes; the G = H / KV query heads of a kv head
//   share each staged row (the TPU grid re-read it for every q head).  Each
//   warp keeps its own online softmax over its rows, starting from the
//   finite NEG_INF, and its own output sums in registers (P V: a lane per
//   4 output columns, each V row read once).  After the loop the block
//   combines its warps, and every block stores its (max, sum, sums) slice
//   by slice into the shared memory of the block of the cluster that owns
//   the slice (distributed shared memory); after one cluster.sync() each
//   block combines and writes its 1 / C of the outputs from its own shared
//   memory.  K/V are read through element strides, so the engine passes its
//   heads-major cache (B, KV, S, hd) as a (B, S, KV, hd) view without
//   copying it.
//   The partial variant (PARTIAL = true, repro_decode_attention_partial)
//   runs the same loop over one segment of a cache's slots, a rank's shard
//   of a cache sharded over its slots: it writes its normalised output in
//   float32 and the row's log-sum-exp, max + log(sum), beside it, NEG_INF
//   where the segment holds no valid slot, so that segments combine
//   (decode_attention.py::combine_partials) with nothing lost to the
//   cache's type and an empty segment's mean(V) weighing nothing.  The
//   served launch is the PARTIAL = false instantiation, unchanged.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

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
  int B, S, Skv, H, KV;  // Skv: kv length, == S unless unmasked (cross-attention)
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;  // elements
  int causal, window;  // window <= 0: no window; either needs Skv == S
  float sm_scale;
};

// Q's split halves live in shared memory (wgmma's A from a descriptor)
// where registers cannot hold them beside the accumulators: at q.k width
// 192 they would take 192 registers a thread.
template <int HD>
__host__ __device__ constexpr bool flash_q_in_smem() {
  return HD > 128;
}

// Shared memory: Q split into tf32 halves where flash_q_in_smem (Q hi, Q lo:
// [BQ][HD]), the current kv tile split likewise in wgmma's canonical layout
// (K hi, K lo: [BK][HD]; V^T hi, V^T lo: [HDV][BK]; float32 bits), then the
// raw K and V tiles the next copy lands in (rows of HD + 4 and HDV + 4 in
// the input's type).  hd 128, float32: 4 * 32 * 128 * 4 + 2 * 32 * 132 * 4
// = 99,328 B, two blocks per SM.  q.k width 192 and V width 128 (MLA),
// float32: 2 * 64 * 192 * 4 + 2 * 32 * 320 * 4 + 32 * (196 + 132) * 4 =
// 222,208 B, one block per SM.
template <typename T, int HD, int HDV>
__host__ __device__ constexpr size_t flash_smem_bytes() {
  return sizeof(float) * 2 * FA_BK * (HD + HDV) + sizeof(T) * FA_BK * (HD + 4 + HDV + 4) +
         (flash_q_in_smem<HD>() ? sizeof(float) * 2 * FA_BQ * HD : 0);
}

// HD: q and k's width; HDV: v's and the output's (MLA's 128 beside a q.k
// width of 192; every other model's equals HD).
template <typename T, int HD, int HDV = HD>
__global__ void __launch_bounds__(FA_THREADS) flash_attn_kernel(FlashArgs a) {
  constexpr int LDR = HD + 4;     // raw rows: the split pass's 16-byte reads hit distinct banks
  constexpr int LDV = HDV + 4;
  constexpr int KS = HD / 8;      // k-steps of the score product
  constexpr int NJ = FA_BK / 8;   // key chunks of a kv tile: score n-tiles, k-steps of P V
  constexpr int TS = FA_BK * HD;  // floats of one split K tile
  constexpr int TV = FA_BK * HDV; // floats of one split V tile
  constexpr bool QS = flash_q_in_smem<HD>();
  constexpr int TQ = QS ? FA_BQ * HD : 0;  // floats of one split Q tile
  static_assert(HD % 16 == 0 || HD == 80, "head_dim");
  static_assert(HDV % 16 == 0 || HDV == 80, "v width");

  extern __shared__ float4 smem4[];
  float* Qhi = reinterpret_cast<float*>(smem4);
  float* Qlo = Qhi + TQ;
  float* Khi = Qlo + TQ;
  float* Klo = Khi + TS;
  float* Vhi = Klo + TS;  // V^T
  float* Vlo = Vhi + TV;
  T* Kr = reinterpret_cast<T*>(Vlo + TV);  // [BK][LDR] raw K, then [BK][LDV] raw V
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
  const int k_hi = a.causal ? min(a.Skv, q0 + FA_BQ) : a.Skv;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt_lo = k_lo / FA_BK, kt_hi = (k_hi + FA_BK - 1) / FA_BK;

  auto load_tile = [&](int kt) {
    copy_rows_async<FA_BK, HD, LDR, FA_THREADS>(Kr, kp, a.k_ss, kt * FA_BK, a.Skv);
    copy_rows_async<FA_BK, HDV, LDV, FA_THREADS>(Vr, vp, a.v_ss, kt * FA_BK, a.Skv);
    cp_async_commit();
  };
  if (kt_lo < kt_hi) load_tile(kt_lo);

  // Q, pre-scaled by sm_scale and split into hi/lo once, as wgmma A
  // fragments in registers for the whole kv loop (rows past S are 0); or,
  // where flash_q_in_smem, into shared memory in the K tile's canonical
  // layout ([row / 8][d / 4] cores), which the first tile's fence and
  // barrier make visible to wgmma
  Split qa[QS ? 1 : KS][4];
  if constexpr (QS) {
    for (int idx = tid; idx < FA_BQ * HD / 4; idx += FA_THREADS) {
      const int r8 = idx & 7, kb = (idx >> 3) % (HD / 4), nb = (idx >> 3) / (HD / 4);
      const int r = q0 + 8 * nb + r8;
      const float4 x = r < a.S ? load4(qp + r * a.q_ss + 4 * kb) : make_float4(0.f, 0.f, 0.f, 0.f);
      const Split s0 = split_tf32(x.x * a.sm_scale), s1 = split_tf32(x.y * a.sm_scale),
                  s2 = split_tf32(x.z * a.sm_scale), s3 = split_tf32(x.w * a.sm_scale);
      const int at = nb * HD * 8 + kb * 32 + r8 * 4;
      *reinterpret_cast<uint4*>(Qhi + at) = make_uint4(s0.hi, s1.hi, s2.hi, s3.hi);
      *reinterpret_cast<uint4*>(Qlo + at) = make_uint4(s0.lo, s1.lo, s2.lo, s3.lo);
    }
  } else {
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
  float o[HDV / 2];
#pragma unroll
  for (int i = 0; i < HDV / 2; ++i) o[i] = 0.f;

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
    for (int idx = tid; idx < FA_BK * HDV / 4; idx += FA_THREADS) {
      const int d8 = idx & 7, kb = (idx >> 3) % (FA_BK / 4), nb = (idx >> 3) / (FA_BK / 4);
      const T* vc = Vr + (8 * (kb >> 1) + (kb & 1)) * LDV + 8 * nb + d8;
      const Split s0 = split_tf32(to_f32(vc[0])), s1 = split_tf32(to_f32(vc[2 * LDV])),
                  s2 = split_tf32(to_f32(vc[4 * LDV])), s3 = split_tf32(to_f32(vc[6 * LDV]));
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
    if constexpr (QS) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma3_ss<FA_BK>(sc, wgmma_desc(Qhi + 64 * ks, 128, HD * 32),
                         wgmma_desc(Qlo + 64 * ks, 128, HD * 32),
                         wgmma_desc(Khi + 64 * ks, 128, HD * 32),
                         wgmma_desc(Klo + 64 * ks, 128, HD * 32));
    } else {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma3<FA_BK>(sc, qa[ks], wgmma_desc(Khi + 64 * ks, 128, HD * 32),
                      wgmma_desc(Klo + 64 * ks, 128, HD * 32));
    }
    wgmma_commit();
    wgmma_wait();
    pin_regs(sc);

    // mask (only on a tile at an edge of the mask) and online softmax;
    // sc[4j + e] is row g, sc[4j + 2 + e] row g + 8, key k0 + 8 j + 2 t + e
    const bool edge = k0 + FA_BK > a.Skv || (a.causal && k0 + FA_BK - 1 > q0) ||
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
          if (edge && kj >= a.Skv)
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
      for (int n = 0; n < HDV / 8; ++n) {
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
      wgmma3<HDV>(o, pa[j], wgmma_desc(Vhi + 64 * j, 128, FA_BK * 32),
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
    T* orow = op + (((long long)b * a.S + s) * a.H + h) * HDV + 2 * t;
#pragma unroll
    for (int n = 0; n < HDV / 8; ++n) {
      orow[8 * n] = from_f32<T>(o[4 * n + 2 * r] * inv);
      orow[8 * n + 1] = from_f32<T>(o[4 * n + 2 * r + 1] * inv);
    }
  }
}

template <typename T, int HD, int HDV = HD>
cudaError_t launch_flash(const FlashArgs& a, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<T, HD, HDV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<T, HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + FA_BQ - 1) / FA_BQ, a.H, a.B);
  flash_attn_kernel<T, HD, HDV><<<grid, FA_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(const FlashArgs& a, int hd, int hdv, cudaStream_t stream) {
  if (hdv != hd)  // MLA (DeepSeek-V2): q.k over 128 + 64 rotated dims, v of 128
    return hd == 192 && hdv == 128 ? launch_flash<T, 192, 128>(a, stream)
                                   : cudaErrorInvalidValue;
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

constexpr int DA_TILE = 32;         // cache slots a block takes per step
constexpr int DA_ROWS = 4;          // of which each warp takes its own 4
constexpr int DA_THREADS = 256;
constexpr int DA_WARPS = DA_THREADS / 32;
constexpr int DA_MAXG = 16;         // query heads per kv head
constexpr int DA_MAX_CLUSTER = 8;   // blocks per (batch, kv head): the portable cluster size
constexpr int DA_RING_BYTES = 66 * 1024;  // the K/V ring's budget: three blocks an SM
static_assert(DA_ROWS * DA_WARPS == DA_TILE, "a step gives every warp its rows");

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;   // (B,)
  const int* kv_pos;  // (B, S), row stride kvp_sb
  void* o;            // (B, 1, H, hd), contiguous; float32 in the partial variant
  float* lse;         // (B, H), contiguous: the partial variant only
  int B, S, H, KV;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, kvp_sb;  // elements
  int window;  // <= 0: no window
  float sm_scale;
};

// Stages of the K/V ring: every warp's K and V rows of one step, in the
// cache's type, as many as fit in DA_RING_BYTES (2 to 4).
template <typename T, int HD>
struct DecodeRing {
  static constexpr int STEP = DA_WARPS * DA_ROWS * HD * (int)sizeof(T) * 2;
  static constexpr int FIT = DA_RING_BYTES / STEP;
  static constexpr int NST = FIT < 2 ? 2 : FIT > 4 ? 4 : FIT;
};

template <typename T, int HD>
__host__ __device__ constexpr size_t decode_ring_bytes(int g) {
  // after the kv loop the ring holds the warps' partial sums
  return (size_t)DecodeRing<T, HD>::NST * DecodeRing<T, HD>::STEP >
                 (size_t)DA_WARPS * g * HD * sizeof(float)
             ? (size_t)DecodeRing<T, HD>::NST * DecodeRing<T, HD>::STEP
             : (size_t)DA_WARPS * g * HD * sizeof(float);
}

template <typename T, int HD>
__host__ __device__ constexpr size_t decode_smem_bytes(int g) {
  return decode_ring_bytes<T, HD>(g) + sizeof(float4) * (size_t)(g * HD / 4 + DA_MAX_CLUSTER) +
         sizeof(float2) * (size_t)DA_MAX_CLUSTER * g + sizeof(T) * (size_t)g * HD +
         sizeof(int) * (size_t)DecodeRing<T, HD>::NST * DA_TILE +
         sizeof(float) * (size_t)DA_WARPS * g * (DA_ROWS + 3);
}

// One block per (kv head, batch, chunk); the chunks of one (batch, kv head)
// are the blocks of one thread-block cluster (along z).  Block z takes the
// slots [z S / C, (z + 1) S / C) of the cache (C = gridDim.z <= S: none is
// empty) in steps of DA_TILE, and warp w the rows [4 w, 4 w + 4) of each
// step.  GMAX (1, 4 or 16) bounds G = H / KV: the registers of the output
// sums scale with it.  GMAX <= 4 keeps three blocks an SM, but for hd 80
// at GMAX = 4, whose 80 registers would spill.  PARTIAL: write the output
// in float32 and the log-sum-exp (the partial variant).
template <typename T, int HD, int GMAX, bool PARTIAL>
__global__ void __launch_bounds__(DA_THREADS, GMAX == 16 ? 1 : GMAX == 4 && HD == 80 ? 2 : 3)
    decode_attn_kernel(DecodeArgs a) {
  constexpr int NST = DecodeRing<T, HD>::NST, C4 = HD / 4;
  // Scores: the warp's lanes share each of its rows (RPI rows side by side
  // where C4 divides 32), lane l holding chunk l % C4 of the row and of q,
  // and take GH heads a pass; a reduce-scatter of shuffles then leaves
  // every (row, head) dot product in DUP neighbouring lanes, the rows of a
  // head in lane bits 3 and 4.
  constexpr int GH = GMAX == 1 ? 1 : 4, NGM = GMAX / GH;
  constexpr int RPI = 32 % C4 == 0 ? 32 / C4 : 1, LPR = 32 / RPI, RPL = DA_ROWS / RPI;
  constexpr int NPART = RPL * GH, DUP = 8 / GH;
  static_assert(LPR == NPART * DUP, "a reduce-scatter over the lanes of a row");
  // P V: lane l sums chunk c = l % C4 of heads m HPW + l / C4 (m < MAXO);
  // HPW heads of C4 chunks side by side fill the warp where C4 divides 32
  constexpr int HPW = RPI, MAXO = (GMAX + HPW - 1) / HPW;
  constexpr int CPL = (DA_ROWS * C4 + 31) / 32;  // chunks of 4 a lane copies per K or V step
  constexpr int SROWS = 2 * DA_ROWS * HD;        // a warp's K and V rows of one stage
  static_assert(DA_ROWS == 4, "the rows of a head in lane bits 3 and 4");

  cg::cluster_group cluster = cg::this_cluster();
  const int G = a.H / a.KV, ng = (G + GH - 1) / GH;
  extern __shared__ float4 smem4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  T* ring = reinterpret_cast<T*>(base);            // [NST][WARPS][K rows, V rows]
  float4* red4 = reinterpret_cast<float4*>(base);  // [WARPS][G][HD / 4] after the kv loop
  float4* recv4 = reinterpret_cast<float4*>(base + decode_ring_bytes<T, HD>(G));
  //                       [C][per] the cluster's partial sums of this block's output chunks
  float2* recv_ml = reinterpret_cast<float2*>(recv4 + G * HD / 4 + DA_MAX_CLUSTER);
  //                       [C][G] the cluster's (max, sum) per head
  T* Qs = reinterpret_cast<T*>(recv_ml + DA_MAX_CLUSTER * G);        // [G][HD]
  int* kp_s = reinterpret_cast<int*>(Qs + G * HD);                   // [NST][WARPS][ROWS]
  float* p_s = reinterpret_cast<float*>(kp_s + NST * DA_TILE);       // [WARPS][G][ROWS] weights
  float* al_s = p_s + DA_WARPS * G * DA_ROWS;                        // [WARPS][G] rescales
  float* mw_s = al_s + DA_WARPS * G;                                 // [WARPS][G] warp maxima
  float* lw_s = mw_s + DA_WARPS * G;                                 // [WARPS][G] warp sums

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = (int)((long long)blockIdx.z * a.S / gridDim.z);
  const int hi = (int)((long long)(blockIdx.z + 1) * a.S / gridDim.z);
  const int steps = (hi - lo + DA_TILE - 1) / DA_TILE;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + (long long)kvh * G * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const int* kvpos = a.kv_pos + b * a.kvp_sb;

  // This lane's chunks of a step's K and V rows: row, offset in the stage,
  // and offsets in the cache, fixed for the whole loop.
  int crow[CPL], csm[CPL];
  long long ckg[CPL], cvg[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int idx = min(lane + 32 * i, DA_ROWS * C4 - 1), c = 4 * (idx % C4);
    crow[i] = lane + 32 * i < DA_ROWS * C4 ? idx / C4 : DA_ROWS;  // DA_ROWS: no chunk
    csm[i] = (idx / C4) * HD + c;
    ckg[i] = (idx / C4) * a.k_ss + c;
    cvg[i] = (idx / C4) * a.v_ss + c;
  }

  // The next step of this warp into the next stage of the ring: its K rows
  // and their positions as one group, its V rows as the next, so V's wait
  // can come after the scores.  Both groups are committed even past the
  // last step (empty), which keeps the waits' counts fixed.  Rows past the
  // block's slots are zero-filled.
  int next = 0, st_in = 0;
  auto issue = [&]() {
    const int r0 = lo + next * DA_TILE + warp * DA_ROWS;
    T* Kst = ring + (st_in * DA_WARPS + warp) * SROWS;
    const bool live = next < steps;
    if (live) {
      const T* kr = kp + (long long)r0 * a.k_ss;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const bool valid = r0 + crow[i] < hi;
        if (crow[i] < DA_ROWS) cp_async4(Kst + csm[i], valid ? kr + ckg[i] : kp, valid);
      }
      if (lane < DA_ROWS) {
        const bool valid = r0 + lane < hi;
        cp_async1(kp_s + (st_in * DA_WARPS + warp) * DA_ROWS + lane, valid ? kvpos + r0 + lane : kvpos,
                  valid);
      }
    }
    cp_async_commit();
    if (live) {
      const T* vr = vp + (long long)r0 * a.v_ss;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const bool valid = r0 + crow[i] < hi;
        if (crow[i] < DA_ROWS) cp_async4(Kst + DA_ROWS * HD + csm[i], valid ? vr + cvg[i] : vp, valid);
      }
    }
    cp_async_commit();
    ++next;
    st_in = st_in + 1 == NST ? 0 : st_in + 1;
  };

  // the first wave: q, then NST steps of every warp; only q waits for the block
  for (int i = tid; i < G * C4; i += DA_THREADS) {
    const int g = i / C4, c = (i % C4) * 4;
    cp_async4(Qs + g * HD + c, qp + g * a.q_sh + c, true);
  }
  cp_async_commit();
#pragma unroll
  for (int k = 0; k < NST; ++k) issue();
  const int qpos = a.q_pos[b];

  // This lane's chunk of K and q rows, and the (row, head) whose score it
  // holds after the reduce-scatter; it keeps that head's running max and
  // sum over the warp's rows (the warp's own online softmax).
  const bool kl = lane < RPI * C4;
  const int ck = 4 * (lane % C4), krow0 = lane / LPR;
  const int jr = ((lane % LPR) >> 3) * RPI + lane / LPR;  // a bijection on lane bits 3, 4
  const int gq = (lane >> (DUP == 2 ? 1 : 3)) & (GH - 1);
  const bool lead = (lane & (DUP - 1)) == 0;  // the first of the DUP lanes of a (row, head)
  float m_r[NGM], l_r[NGM];
#pragma unroll
  for (int n = 0; n < NGM; ++n) {
    m_r[n] = NEG_INF;  // finite: a fully masked stretch weighs exp(0) = 1 until
    l_r[n] = 0.f;      // a valid slot's alpha = exp(NEG_INF - m) = 0 wipes it
  }
  const int cpv = 4 * (lane % C4), gpv = lane / C4;
  const bool pv_lane = lane < HPW * C4;
  float4 acc[MAXO];
#pragma unroll
  for (int m = 0; m < MAXO; ++m) acc[m] = make_float4(0.f, 0.f, 0.f, 0.f);
  float* ps = p_s + warp * G * DA_ROWS;
  float* als = al_s + warp * G;
  cp_async_wait<2 * NST>();  // q
  __syncthreads();

  int st = 0;
  for (int k = 0; k < steps; ++k) {
    const T* Kst = ring + (st * DA_WARPS + warp) * SROWS;
    const T* Vst = Kst + DA_ROWS * HD;
    const int r0 = lo + k * DA_TILE + warp * DA_ROWS;
    cp_async_wait<2 * NST - 1>();  // this step's K rows and positions
    __syncwarp();

    float4 kk[RPL];
#pragma unroll
    for (int rr = 0; rr < RPL; ++rr)
      kk[rr] = kl ? load4(Kst + (rr * RPI + krow0) * HD + ck) : make_float4(0.f, 0.f, 0.f, 0.f);
    const int pos = kp_s[(st * DA_WARPS + warp) * DA_ROWS + jr];
    const bool in_block = r0 + jr < hi;
    const bool valid = pos >= 0 && pos <= qpos && (a.window <= 0 || pos > qpos - a.window);
#pragma unroll
    for (int n = 0; n < NGM; ++n) {
      if (n < ng) {
        float v[NPART];
#pragma unroll
        for (int gg = 0; gg < GH; ++gg) {
          const float4 qq = kl ? load4(Qs + min(n * GH + gg, G - 1) * HD + ck)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int rr = 0; rr < RPL; ++rr)
            v[rr * GH + gg] = qq.x * kk[rr].x + qq.y * kk[rr].y + qq.z * kk[rr].z + qq.w * kk[rr].w;
        }
        // reduce-scatter: at mask M the lanes with bit M keep the upper half
#pragma unroll
        for (int M = LPR / 2, cnt = NPART; M >= 1; M >>= 1) {
          if (cnt > 1) {
            const bool up = lane & M;
#pragma unroll
            for (int i = 0; i < NPART / 2; ++i) {
              if (i < cnt / 2) {
                const float send = up ? v[i] : v[i + cnt / 2];
                const float keep = up ? v[i + cnt / 2] : v[i];
                v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
              }
            }
            cnt >>= 1;
          } else {
            v[0] += __shfl_xor_sync(0xffffffffu, v[0], M);
          }
        }
        const int g = n * GH + gq;
        const float s = !in_block || g >= G ? -INFINITY : valid ? v[0] * a.sm_scale : NEG_INF;
        float mx = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m_r[n], mx);
        const float p = exp_fast(s - m_new);
        float sum = p + __shfl_xor_sync(0xffffffffu, p, 8);
        sum += __shfl_xor_sync(0xffffffffu, sum, 16);
        const float alpha = exp_fast(m_r[n] - m_new);
        l_r[n] = fmaf(alpha, l_r[n], sum);
        m_r[n] = m_new;
        if (g < G && lead) {
          ps[g * DA_ROWS + jr] = p;
          if (jr == 0) als[g] = alpha;
        }
      }
    }
    cp_async_wait<2 * NST - 2>();  // this step's V rows
    __syncwarp();

    // P V: each V row chunk is read once and used for the lane's heads
    if (pv_lane) {
      float4 vv[DA_ROWS];
#pragma unroll
      for (int r = 0; r < DA_ROWS; ++r) vv[r] = load4(Vst + r * HD + cpv);
#pragma unroll
      for (int m = 0; m < MAXO; ++m) {
        const int g = m * HPW + gpv;
        if (g < G) {
          const float al = als[g];
          const float4 p4 = *reinterpret_cast<const float4*>(ps + g * DA_ROWS);
          float4 x = acc[m];
          x.x *= al;
          x.y *= al;
          x.z *= al;
          x.w *= al;
          const float pr[DA_ROWS] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int r = 0; r < DA_ROWS; ++r) {
            x.x = fmaf(pr[r], vv[r].x, x.x);
            x.y = fmaf(pr[r], vv[r].y, x.y);
            x.z = fmaf(pr[r], vv[r].z, x.z);
            x.w = fmaf(pr[r], vv[r].w, x.w);
          }
          acc[m] = x;
        }
      }
    }
    __syncwarp();  // the stage and the weights are consumed
    issue();
    st = st + 1 == NST ? 0 : st + 1;
  }
  cp_async_wait<0>();  // only empty groups remain
  __syncthreads();     // every warp is done with the ring

  // The block's partial, the warps' (max, sum, output sums) combined, goes
  // straight to the block of the cluster that owns each output chunk
  // (distributed shared memory stores): block r owns chunks [r per, (r +
  // 1) per) and receives every block's (max, sum) per head.
#pragma unroll
  for (int m = 0; m < MAXO; ++m) {
    const int g = m * HPW + gpv;
    if (pv_lane && g < G) red4[(warp * G + g) * C4 + cpv / 4] = acc[m];
  }
#pragma unroll
  for (int n = 0; n < NGM; ++n) {
    const int g = n * GH + gq;
    if (n < ng && g < G && lead && jr == 0) {
      mw_s[warp * G + g] = m_r[n];
      lw_s[warp * G + g] = l_r[n];
    }
  }
  __syncthreads();
  const int C = gridDim.z, rank = blockIdx.z, per = (G * C4 + C - 1) / C;
  for (int o = tid; o < G * C4; o += DA_THREADS) {
    const int g = o / C4;
    float mw[DA_WARPS], mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) {
      mw[w] = mw_s[w * G + g];
      mx = fmaxf(mx, mw[w]);
    }
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < DA_WARPS; ++w) {
      const float e = exp_fast(mw[w] - mx);
      const float4 y = red4[w * G * C4 + o];
      x.x = fmaf(e, y.x, x.x);
      x.y = fmaf(e, y.y, x.y);
      x.z = fmaf(e, y.z, x.z);
      x.w = fmaf(e, y.w, x.w);
      l = fmaf(e, lw_s[w * G + g], l);
    }
    const int owner = o / per;
    *cluster.map_shared_rank(recv4 + rank * per + o - owner * per, owner) = x;
    if (o % C4 == 0) {
      for (int p = 0; p < C; ++p)
        *cluster.map_shared_rank(recv_ml + rank * G + g, p) = make_float2(mx, l);
    }
  }
  cluster.sync();  // every block's partial has reached its owners

  // The combine of this block's chunks, from its own shared memory: chunk
  // p weighs exp(m_p - max m); a fully masked chunk keeps m_p = NEG_INF, so
  // it weighs 0 beside any valid slot and 1 when no chunk has one (mean V).
  // No block reads another's shared memory from here on.
  T* op = static_cast<T*>(a.o) + ((long long)b * a.H + (long long)kvh * G) * HD;
  for (int o = rank * per + tid; o < min(G * C4, (rank + 1) * per); o += DA_THREADS) {
    const int g = o / C4;
    float mx = NEG_INF;
    for (int p = 0; p < C; ++p) mx = fmaxf(mx, recv_ml[p * G + g].x);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
    for (int p = 0; p < C; ++p) {
      const float2 ml = recv_ml[p * G + g];
      const float e = exp_fast(ml.x - mx);
      const float4 y = recv4[p * per + o - rank * per];
      x.x = fmaf(e, y.x, x.x);
      x.y = fmaf(e, y.y, x.y);
      x.z = fmaf(e, y.z, x.z);
      x.w = fmaf(e, y.w, x.w);
      l = fmaf(e, ml.y, l);
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    if constexpr (PARTIAL) {
      // a (row, head) with no valid slot keeps mx = NEG_INF: its lse is
      // NEG_INF, so its mean(V) weighs nothing beside another segment's
      float* dst = static_cast<float*>(a.o) + ((long long)b * a.H + (long long)kvh * G) * HD +
                   4 * o;
      *reinterpret_cast<float4*>(dst) = make_float4(x.x * inv, x.y * inv, x.z * inv, x.w * inv);
      if (o % C4 == 0)
        a.lse[(long long)b * a.H + kvh * G + g] = mx > NEG_INF ? mx + logf(l) : NEG_INF;
    } else {
      T* dst = op + 4 * o;
      dst[0] = from_f32<T>(x.x * inv);
      dst[1] = from_f32<T>(x.y * inv);
      dst[2] = from_f32<T>(x.z * inv);
      dst[3] = from_f32<T>(x.w * inv);
    }
  }
}

template <typename T, int HD, int GMAX, bool PARTIAL>
cudaError_t launch_decode_g(const DecodeArgs& a, int cluster, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(decode_attn_kernel<T, HD, GMAX, PARTIAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)decode_smem_bytes<T, HD>(GMAX));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.KV, a.B, cluster);
  cfg.blockDim = dim3(DA_THREADS);
  cfg.dynamicSmemBytes = decode_smem_bytes<T, HD>(a.H / a.KV);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_attn_kernel<T, HD, GMAX, PARTIAL>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int HD, bool PARTIAL>
cudaError_t launch_decode(const DecodeArgs& a, int cluster, cudaStream_t stream) {
  const int g = a.H / a.KV;
  return g == 1   ? launch_decode_g<T, HD, 1, PARTIAL>(a, cluster, stream)
         : g <= 4 ? launch_decode_g<T, HD, 4, PARTIAL>(a, cluster, stream)
                  : launch_decode_g<T, HD, DA_MAXG, PARTIAL>(a, cluster, stream);
}

template <typename T, bool PARTIAL>
cudaError_t dispatch_decode(const DecodeArgs& a, int hd, int cluster, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_decode<T, 32, PARTIAL>(a, cluster, stream);
    case 64: return launch_decode<T, 64, PARTIAL>(a, cluster, stream);
    case 80: return launch_decode<T, 80, PARTIAL>(a, cluster, stream);
    case 128: return launch_decode<T, 128, PARTIAL>(a, cluster, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool PARTIAL>
int decode_entry(int dtype, int hd, const void* q, const void* k, const void* v,
                 const int* q_pos, const int* kv_pos, void* o, float* lse, int cluster, int B,
                 int S, int H, int KV, const long long* strides, int window, float sm_scale,
                 void* stream) {
  if (S < 1 || KV < 1 || H % KV != 0 || H / KV > DA_MAXG) return cudaErrorInvalidValue;
  if (cluster < 1 || cluster > DA_MAX_CLUSTER || cluster > S) return cudaErrorInvalidValue;
  DecodeArgs a{q, k, v, q_pos, kv_pos, o, lse, B, S, H, KV,
               strides[0], strides[1], strides[2], strides[3], strides[4],
               strides[5], strides[6], strides[7], strides[8],
               window, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_decode<float, PARTIAL>(a, hd, cluster, st);
  if (dtype == 1) return dispatch_decode<__nv_bfloat16, PARTIAL>(a, hd, cluster, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface.  dtype: 0 = float32, 1 = bfloat16.  Strides are in elements
// and multiples of 4, the last dimension is contiguous, and q/k/v start on
// a 4-element boundary.  Returns a cudaError_t (0 = launched);
// cudaErrorInvalidValue for a head_dim, dtype or query-group size that no
// kernel here is built for: these switches are the one list of them.
// ---------------------------------------------------------------------------

// S: query rows; Skv: keys, != S only with causal = 0 and window = 0.
// hd: q's and k's width; hdv: v's and o's.
extern "C" int repro_flash_attention(int dtype, int hd, int hdv, const void* q, const void* k,
                                     const void* v, void* o, int B, int S, int Skv, int H,
                                     int KV,
                                     const long long* strides,  // q b,s,h  k b,s,h  v b,s,h
                                     int causal, int window, float sm_scale, void* stream) {
  if (Skv < 1 || (Skv != S && (causal || window > 0))) return cudaErrorInvalidValue;
  FlashArgs a{q, k, v, o, B, S, Skv, H, KV,
              strides[0], strides[1], strides[2], strides[3], strides[4],
              strides[5], strides[6], strides[7], strides[8],
              causal, window, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_flash<float>(a, hd, hdv, st);
  if (dtype == 1) return dispatch_flash<__nv_bfloat16>(a, hd, hdv, st);
  return cudaErrorInvalidValue;
}

// cluster: blocks per (batch, kv head), 1..DA_MAX_CLUSTER and at most S;
// they run as one thread-block cluster and combine their chunks in
// distributed shared memory (one launch).
extern "C" int repro_decode_attention(int dtype, int hd, const void* q, const void* k,
                                      const void* v, const int* q_pos, const int* kv_pos,
                                      void* o, int cluster, int B, int S, int H, int KV,
                                      const long long* strides,  // q b,h  k b,s,h  v b,s,h  kv_pos b
                                      int window, float sm_scale, void* stream) {
  return decode_entry<false>(dtype, hd, q, k, v, q_pos, kv_pos, o, nullptr, cluster, B, S, H,
                             KV, strides, window, sm_scale, stream);
}

// The partial variant: o (B, 1, H, hd) and lse (B, H) float32, contiguous;
// otherwise as repro_decode_attention.
extern "C" int repro_decode_attention_partial(int dtype, int hd, const void* q, const void* k,
                                              const void* v, const int* q_pos,
                                              const int* kv_pos, float* o, float* lse,
                                              int cluster, int B, int S, int H, int KV,
                                              const long long* strides, int window,
                                              float sm_scale, void* stream) {
  return decode_entry<true>(dtype, hd, q, k, v, q_pos, kv_pos, o, lse, cluster, B, S, H, KV,
                            strides, window, sm_scale, stream);
}

// room: clusters of `cluster` blocks the card holds at once when each SM
// takes at most one block (a footprint of over half an SM's shared memory),
// which decode_attention.py::decode_split plans the grid by.
extern "C" int repro_decode_cluster_room(int cluster, int* room) {
  if (cluster < 1 || cluster > DA_MAX_CLUSTER) return cudaErrorInvalidValue;
  int dev = 0, smem_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return err;
  const int one_per_sm = smem_sm / 2 + 1024;
  auto kernel = decode_attn_kernel<float, 128, 4, false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, one_per_sm);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, 1, cluster);
  cfg.blockDim = dim3(DA_THREADS);
  cfg.dynamicSmemBytes = one_per_sm;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(room, kernel, &cfg);
}
