// Recurrent scan kernels for NVIDIA Hopper (sm_90a), hand-written in CUDA C++.
//
// Plain C interface, built with nvcc into the same shared library as
// attention.cu and bound with ctypes by repro_torch/kernels/_build.py.
// Both kernels read float32 or bfloat16, compute in float32, write y in
// the input's type and the final state in float32.  Both take an initial state (the models' s0 / h0;
// the TPU kernels started from zero) and any S: the ragged last chunk is
// zero-padded in shared memory, which is exact (see each kernel).
//
// rwkv6_scan_kernel replaces the Pallas kernel
//   src/repro/kernels/rwkv6_scan.py::rwkv6_scan (_wkv_kernel):
//     y_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t.
//   Bound on this card: bytes.  At rwkv6-1.6b's prefill (B=4, S=512, H=32,
//   hd=64) the kernel moves 88 MB (r, k, v, logw read once, y and the
//   states once) in 26 us at 3.35 TB/s; the recurrence's least work, 1.6
//   GFLOP, takes 10 us at 165 TFLOP/s of 3xTF32 (24 at 67 of float32 FMA).
//   Design: chunks of Q = 32 steps, computed as the TPU kernel does with the
//   exact factorisation r_t.k_s exp(cum_{t-1} - cum_s) =
//   (r_t exp(cum_{t-1} - tot)) . (k_s exp(tot - cum_s)), which stays in
//   float32 range because logw >= -2 (LOGW_CLAMP in models/rwkv.py) gives
//   exponents of at most 2 Q = 64.  The chunk length is fixed: a longer one
//   overflows.  The read-out takes the same r_f = r exp(cum_{t-1} - tot)
//   against the decayed state exp(tot) S, which the state update needs
//   anyway: r_t exp(cum_{t-1}) S = r_f (exp(tot) S), each term bounded by
//   |r S|.  Padded steps past S take logw = 0 and r = k = v = 0 (the
//   copies zero-fill them), so they change neither the state nor any valid
//   output.  The TPU's sequential chunk grid axis becomes a loop inside the
//   block.  B * H = 128 (batch, head) pairs would leave SMs idle, and the
//   recurrence is independent per value column e (y[:, e] needs only
//   S[:, e] and v[:, e]), so each block of 4 warps owns 16 value columns of
//   one (batch, head): 512 blocks at that shape, each recomputing the
//   chunk's causal scores for its columns.
//   All four chunk products run on the tensor cores as 3xTF32
//   (mma.sync.m16n8k8, common.cuh), float32-accurate; per chunk and block,
//   in m16n8k8 steps at hd = 64 (hd = 32): the scores r_f k_f^T over the
//   causal tiles (rows 0-15 x keys 0-15, rows 16-31 x keys 0-31) 48 (24),
//   the read-out r_f (exp(tot) S) 32 (16), A V 12 (12) and the state update
//   k_f^T V 32 (16).  The scores go through shared memory, masked, with
//   r_t . (u o k_t) on the diagonal, as the A fragments of A V; since A V
//   is linear in A, rows 0-15 take their two key tiles as four half-hd
//   partial tiles, which balances the warps: warp w computes key tile w of
//   rows 16-31 and one half of hd of key tile w % 2 of rows 0-15 (12
//   k-steps each, in three independent accumulator chains), then rows 16
//   (w / 2) and columns 8 (w % 2) of y (12), then hd / 4 rows of the
//   state (8), which it keeps in registers across chunks and mirrors once
//   a chunk, decayed and split into tf32 halves, in shared memory for every
//   warp's read-out.  The next chunk's r, k and v slice stream in by
//   cp.async (two stages, in the input's type) while this one computes;
//   logw goes straight to the decay pass's registers a chunk ahead, since
//   two stages of it too would not fit four blocks an SM.  In the decay
//   pass warp w takes steps 8w .. 8w + 7 and each lane hd / 32 adjacent
//   key columns (8-byte accesses, no bank conflict); the warps' sums of
//   logw meet in shared memory for the cumulative decay; it writes r_f and
//   k_f in float32 (over the stage itself for float32 inputs) and sums the
//   diagonal over hd by a reduce-scatter of 9 shuffles.  exp_fast takes
//   the exponents <= 0 (tot - cum_s, tot); r_f's exponent, in [0, 64],
//   keeps expf.  Shared memory and registers a thread (ptxas), float32 /
//   bfloat16: hd = 64 55,680 / 53,120 B and 128 / 128; hd = 32 33,536 /
//   30,976 B and 127 / 128; no spills, no local memory.  The registers
//   (128 x 128 threads) allow four blocks (16 warps) per SM in every
//   instantiation, so the 512 blocks of rwkv6-1.6b's prefill run in one
//   wave on 132 SMs.  What sets the pace (phases timed with clock64 in a
//   copy of the kernel): the decay pass is the longest phase between
//   barriers, led by the issue of the next chunk's copies (each thread
//   issues nine at once, and a head's four blocks read the same r and k);
//   the product phases spend longer on operand loads and tf32 splits than
//   the tensor cores take for their products.
//
// ssd_scan_kernel replaces the Pallas kernel
//   src/repro/kernels/ssd_scan.py::ssd_scan (_ssd_kernel): Mamba2's SSD
//   with a scalar decay per head,
//     y = ((C B^T) o L) @ xdt + (C S0^T) e^cum,  S <- S0 e^cum_Q + xdt^T (B o w).
//   Bound on this card: bytes, with the products on the tensor cores.  At
//   zamba2-2.7b's prefill (B=4, S=512, H=80, hd=64, N=64) the recurrence's
//   least work is 2.7 GFLOP (16 us at 165 TFLOP/s, the 3xTF32 rate; 40 us
//   at 67 of float32 FMA) against 96 MB of traffic (29 us).  The chunked form does more: per chunk of Q steps, C B^T over
//   the causal tiles, ((C B^T) o L) x, C S^T and x^T (B o w).
//   Design: all four chunk products run on the tensor cores as 3xTF32
//   (mma.sync.m16n8k8, common.cuh), float32-accurate.  The recurrence is
//   independent per state row p (y[:, p] needs only x[:, p] and S[p, :]),
//   so a block owns 32 of the hd rows of one (batch, head): 640 blocks at
//   zamba2's shape instead of 320 blocks of 185 KB, one per SM, in 2.4
//   waves.  Each block recomputes the chunk's C B^T for its rows: the count
//   that decided it, per chunk of Q = 64 at hd = N = 64, in m16n8k8 steps
//   per (batch, head): C B^T over the causal tiles 160, and per 32 rows
//   C S^T 128, ((C B^T) o L) x 80 and x^T (B o w) 128, so two slices take
//   2 (160 + 128 + 80 + 128) = 992 against 832 for one block (+19 %), in
//   one launch and with no scratch in device memory.  The
//   state-passing split (chunk states in parallel, a sequential pass, then
//   the read-out) would write and read about 84 MB of chunk states against
//   96 MB of compulsory traffic.  Chunks of Q = 64 steps (exact for any Q:
//   every exponent taken is <= 0, since dA <= 0) keep two stages of x, B
//   and dA in flight by cp.async, so the next chunk loads while this one
//   computes; C, which only the warp that owns a row reads, goes from
//   global memory straight to that warp's registers, requested a chunk
//   ahead.  72 KB of shared memory at N = 64 in float32 and 159 registers
//   a thread: three blocks (12 warps) per SM.  Warp w owns the chunk's rows
//   16 w .. 16 w + 15, so a row's causal scores never leave the warp's
//   registers: they are decayed there and fed back as the A fragment of
//   ((C B^T) o L) x.  The state slice lives in registers across chunks
//   (each warp 16 rows x N/2 columns) and is mirrored in shared memory,
//   split once into tf32 halves, for every warp's read-out C S^T.  What
//   sets the pace is not the products but each warp's chain of other work
//   between them (splits, decays, address arithmetic), at 12 warps an SM.
//   mma.sync rather than wgmma: a wgmma version (products of 64 rows, B and
//   x^T split into shared memory) ran no faster, at 215 registers and 93 KB
//   a block, two blocks an SM.  B and C are read
//   through element strides: the model passes its group-form (B, S, N)
//   tensors expanded to (B, S, H, N) with a head stride of 0, no copy, and
//   the 80 heads of a sequence read the same rows from L2.  Padded steps
//   take dA = 0 and x = B = C = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// RWKV6 WKV
// ---------------------------------------------------------------------------

constexpr int RW_Q = 32;        // chunk length (fixed: see the note above)
constexpr int RW_E = 16;        // value columns per block
constexpr int RW_WARPS = 4;
constexpr int RW_THREADS = 32 * RW_WARPS;
constexpr int RW_STAGES = 2;    // chunks in flight (cp.async ring)
constexpr int RW_LV = RW_E + 4; // row stride of the value slice (and of the state mirror)
constexpr int RW_TILES = 8;     // stored (16-row, 8-key) score tiles of a chunk

struct RwkvArgs {
  const void* r;
  const void* k;
  const void* v;
  const void* w;        // log decay, <= 0 and >= -2
  const void* u;        // (H, hd), contiguous
  const float* s0;      // (B, H, hd, hd) contiguous, or nullptr for zeros
  void* y;              // (B, S, H, hd), contiguous
  float* s_fin;         // (B, H, hd, hd), contiguous
  int B, S, H;
  long long r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh;
};

// One stage: r and k [Q][HD + 4] and the block's v slice [Q][E + 4], in the
// input's type.  Then, for bfloat16 only, r_f and k_f [Q][HD + 4] in
// float32 (float32 inputs are overwritten in place); the scores as A
// fragments [8][32 lanes] float4; the state mirror [HD][E + 4] split into
// tf32 (hi, lo) pairs; exp(tot) [HD]; the diagonal [Q]; the warps' segment
// sums of logw [4][HD].  HD = 64, float32: 2 x 19,968 + 4,096 + 10,240 +
// 256 + 128 + 1,024 = 55,680 B (bfloat16 53,120), four blocks per SM.
template <int HD>
__host__ __device__ constexpr size_t rwkv_stage_elems() {
  return (size_t)RW_Q * (2 * (HD + 4) + RW_LV);
}
template <typename T, int HD>
constexpr size_t rwkv_smem_bytes() {
  return RW_STAGES * sizeof(T) * rwkv_stage_elems<HD>() +
         (sizeof(T) == 4 ? 0 : sizeof(float) * 2 * RW_Q * (HD + 4)) +
         sizeof(float4) * RW_TILES * 32 + sizeof(uint2) * HD * RW_LV +
         sizeof(float) * (HD + RW_Q + RW_WARPS * HD);
}

// N = 1 or 2 consecutive elements as float32 (one 4- or 8-byte access).
template <int N, typename T>
__device__ __forceinline__ void load_n(float (&o)[N], const T* p) {
  if constexpr (N == 1) {
    o[0] = to_f32(p[0]);
  } else if constexpr (sizeof(T) == sizeof(float)) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x, o[1] = x.y;
  } else {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = x.x, o[1] = x.y;
  }
}
template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&x)[N]) {
  if constexpr (N == 1) {
    p[0] = x[0];
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

// logw[t][d .. d + N - 1] for t = t_first .. t_first + STEPS - 1 into
// registers (0 past S).
template <int STEPS, int N, typename T>
__device__ __forceinline__ void load_logw(float (&lw)[STEPS][N], const T* wp, long long ss,
                                          int t_first, int S, int d) {
#pragma unroll
  for (int i = 0; i < STEPS; ++i) {
    if (t_first + i < S) {
      load_n<N>(lw[i], wp + (t_first + i) * ss + d);
    } else {
#pragma unroll
      for (int c = 0; c < N; ++c) lw[i][c] = 0.f;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(RW_THREADS, 4) rwkv6_scan_kernel(RwkvArgs a) {
  // Row stride HD + 4 (= 4 mod 32 in float32): the fragment reads below hit
  // 32 distinct banks whether a quad's lanes walk a row (columns t, rows g:
  // bank 4g + t) or rows 2t, 2t + 1 (bank 8t + g); the value slice and the
  // state mirror's 8-byte pairs likewise with stride E + 4.
  constexpr int LD = HD + 4;
  constexpr int CPT = HD / 32;            // key columns per lane in the decay pass
  constexpr int STEPS = RW_Q / RW_WARPS;  // steps per warp in the decay pass
  constexpr int NKD = HD / 8;             // k-steps over the head dimension
  constexpr int NS = HD / 32;             // state n-tiles per warp
  constexpr int STAGE = (int)rwkv_stage_elems<HD>();
  constexpr bool IN_PLACE = sizeof(T) == sizeof(float);
  static_assert(HD == 32 * CPT && (CPT == 1 || CPT == 2) && STEPS == 8, "head_dim");
  static_assert(RW_Q == 32 && RW_E == 16 && RW_WARPS == 4 && NS >= 1, "tiling");

  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);  // RW_STAGES x (r, k, v)
  float* work = reinterpret_cast<float*>(ring + RW_STAGES * STAGE);  // bf16: r_f, k_f
  float4* SF = reinterpret_cast<float4*>(work + (IN_PLACE ? 0 : 2 * RW_Q * LD));
  uint2* St = reinterpret_cast<uint2*>(SF + RW_TILES * 32);  // [HD][LV] exp(tot) S, split
  float* DT = reinterpret_cast<float*>(St + HD * RW_LV);      // [HD] exp(tot)
  float* DG = DT + HD;                                         // [Q] r_t . (u o k_t)
  float* SEGT = DG + RW_Q;                                     // [WARPS][HD] segment sums of logw

  const int e0 = blockIdx.x * RW_E, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const T* rp = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + e0;
  const T* wp = static_cast<const T*>(a.w) + b * a.w_sb + h * a.w_sh;
  const float* s0 = a.s0 ? a.s0 + ((long long)b * a.H + h) * HD * HD + e0 : nullptr;
  float* sf = a.s_fin + ((long long)b * a.H + h) * HD * HD + e0;
  const int n_chunks = (a.S + RW_Q - 1) / RW_Q;

  // rows past S are zero-filled: padded steps get r = k = v = 0 here and
  // logw = 0 below, so they change neither the state nor any valid output
  auto load_chunk = [&](int c) {
    T* X = ring + (c % RW_STAGES) * STAGE;
    const int t0 = c * RW_Q;
    copy_rows_async<RW_Q, HD, LD, RW_THREADS>(X, rp, a.r_ss, t0, a.S);
    copy_rows_async<RW_Q, HD, LD, RW_THREADS>(X + RW_Q * LD, kp, a.k_ss, t0, a.S);
    copy_rows_async<RW_Q, RW_E, RW_LV, RW_THREADS>(X + 2 * RW_Q * LD, vp, a.v_ss, t0, a.S);
  };
  load_chunk(0);
  cp_async_commit();

  // the decay pass: warp w takes steps t_lo .. t_lo + 7 of the chunk, lane
  // l key columns CPT l .. CPT l + CPT - 1; its logw goes from global memory
  // straight to registers, a chunk ahead (two stages of logw as well would
  // not fit four blocks an SM)
  const int dcol = CPT * lane, t_lo = STEPS * warp;
  float u[CPT];
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) u[cc] = to_f32(static_cast<const T*>(a.u)[h * HD + dcol + cc]);
  float lw[STEPS][CPT];
  load_logw(lw, wp, a.w_ss, t_lo, a.S, dcol);

  // the state S[d][e], e in this block's slice: warp w keeps rows
  // 16 sm + (g, g + 8), columns 8 (sn + i) + (2t, 2t + 1) in registers
  // across chunks (an m16n8 accumulator per n-tile), and mirrors exp(tot) S
  // into St once per chunk for every warp's read-out
  const int sm = warp * NS / 2, sn = warp * NS % 2;
  float sacc[NS][4];
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sacc[i][e] = s0 ? s0[(16 * sm + g + 8 * (e >> 1)) * HD + 8 * (sn + i) + 2 * t + (e & 1)] : 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<0>();  // chunk c landed (this thread's copies)
    __syncthreads();     // everyone's; chunk c - 1 consumed
    if (c + 1 < n_chunks) load_chunk(c + 1);  // streams in while chunk c computes
    cp_async_commit();

    T* X = ring + (c % RW_STAGES) * STAGE;
    const T* Vs = X + 2 * RW_Q * LD;
    float* RF = IN_PLACE ? reinterpret_cast<float*>(X) : work;  // [Q][LD] r exp(cum_prev - tot)
    float* KF = RF + RW_Q * LD;                                // [Q][LD] k exp(tot - cum)

    // decay pass: the cumulative log decay of each key column over the
    // chunk (the warps' segment sums through shared memory), the factorised
    // r and k (exact, in float32 range since logw >= -2 bounds cum_prev -
    // tot by 64), exp(tot), and the diagonal r_t . (u o k_t), reduced across
    // the warp's lanes, which hold all of hd
    {
      float run[CPT], tot[CPT], cp[CPT];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        run[cc] = 0.f;
#pragma unroll
        for (int i = 0; i < STEPS; ++i) run[cc] += lw[i][cc];
      }
      store_n<CPT>(SEGT + warp * HD + dcol, run);
      __syncthreads();
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) tot[cc] = cp[cc] = 0.f;
#pragma unroll
      for (int q = 0; q < RW_WARPS; ++q) {
        float x[CPT];
        load_n<CPT>(x, SEGT + q * HD + dcol);
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          tot[cc] += x[cc];
          cp[cc] += q < warp ? x[cc] : 0.f;  // cum_prev at the warp's first step
        }
      }
      float dg[STEPS];
#pragma unroll
      for (int i = 0; i < STEPS; ++i) {
        const int idx = (t_lo + i) * LD + dcol;
        float r[CPT], kk[CPT], rf[CPT], kf[CPT];
        load_n<CPT>(r, X + idx);
        load_n<CPT>(kk, X + RW_Q * LD + idx);
        dg[i] = 0.f;
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          dg[i] += r[cc] * u[cc] * kk[cc];
          rf[cc] = r[cc] * expf(cp[cc] - tot[cc]);                 // exponent in [0, 64]
          kf[cc] = kk[cc] * exp_fast(tot[cc] - (cp[cc] + lw[i][cc]));  // exponent <= 0
          cp[cc] += lw[i][cc];
        }
        store_n<CPT>(RF + idx, rf);
        store_n<CPT>(KF + idx, kf);
      }
      if (warp == 0) {
        float dt[CPT];
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) dt[cc] = exp_fast(tot[cc]);
        store_n<CPT>(DT + dcol, dt);
      }
      if (c + 1 < n_chunks) load_logw(lw, wp, a.w_ss, (c + 1) * RW_Q + t_lo, a.S, dcol);
      // reduce-scatter over the warp: each level halves the steps a lane
      // holds (the halves chosen by a bit mask, not by a conditional index,
      // which would put dg in local memory); lanes 4 j .. 4 j + 3 end with
      // step t_lo + j, summed over all of hd by the last two levels
#pragma unroll
      for (int half = STEPS / 2; half >= 1; half >>= 1) {
        const uint32_t up = 0u - (uint32_t)((lane & (4 * half)) != 0);
#pragma unroll
        for (int i = 0; i < half; ++i) {
          const uint32_t lo = __float_as_uint(dg[i]), hi = __float_as_uint(dg[i + half]);
          const float keep = __uint_as_float((lo & ~up) | (hi & up));
          const float send = __uint_as_float((hi & ~up) | (lo & up));
          dg[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4 * half);
        }
      }
      dg[0] += __shfl_xor_sync(0xffffffffu, dg[0], 2);
      dg[0] += __shfl_xor_sync(0xffffffffu, dg[0], 1);
      if ((lane & 3) == 0) DG[t_lo + (lane >> 2)] = dg[0];
    }
    __syncthreads();

    // scores A[t][s] = r_f[t] . k_f[s] for s < t, r_t . (u o k_t) for s = t,
    // 0 above, stored as the A fragments of A V (keys in the order (2t,
    // 2t + 1), as flash_attn_kernel hands P over).  Eight tiles, 12 k-steps
    // a warp at hd = 64: warp w takes key tile w of rows 16-31 over all of
    // hd, and one half of hd of key tile w % 2 of rows 0-15; A V is linear
    // in A, so the two halves stay apart (the diagonal in the first) and
    // rows 0-15 run A V over four tiles, as rows 16-31 do.  Three
    // accumulators keep three chains of products in flight.
    {
      constexpr int NH = NKD / 2;
      const int j0 = warp & 1, hk = warp >> 1;
      float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f}, s0t[4] = {0.f, 0.f, 0.f, 0.f};
      auto step = [&](float (&acc)[4], int row0, int key0, int ks) {
        const float* kr = KF + (key0 + g) * LD + 8 * ks + t;
        const float* rr = RF + (row0 + g) * LD + 8 * ks + t;
        const Split kf[2] = {split_tf32(kr[0]), split_tf32(kr[4])};
        const Split rf[4] = {split_tf32(rr[0]), split_tf32(rr[8 * LD]), split_tf32(rr[4]),
                             split_tf32(rr[8 * LD + 4])};
        mma3(acc, rf, kf);
      };
#pragma unroll
      for (int kk = 0; kk < NH; ++kk) {
        step(sa, 16, 8 * warp, kk);
        step(sb, 16, 8 * warp, kk + NH);
        step(s0t, 0, 8 * j0, hk * NH + kk);
      }
      float o1[4], o0[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), col = 2 * t + (e & 1);
        const int s1 = 8 * warp + col, tr1 = 16 + r, sk = 8 * j0 + col;
        const float dg1 = DG[tr1], dg0 = DG[r];
        o1[e] = s1 < tr1 ? sa[e] + sb[e] : (s1 == tr1 ? dg1 : 0.f);
        o0[e] = sk < r ? s0t[e] : (sk == r && hk == 0 ? dg0 : 0.f);
      }
      SF[warp * 32 + lane] = make_float4(o1[0], o1[2], o1[1], o1[3]);
      SF[(4 + 2 * j0 + hk) * 32 + lane] = make_float4(o0[0], o0[2], o0[1], o0[3]);
    }
    // the state decays by exp(tot) once a chunk; its mirror feeds the read-out
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 16 * sm + g + 8 * (e >> 1);
        sacc[i][e] *= DT[d];
        const Split sp = split_tf32(sacc[i][e]);
        St[d * RW_LV + 8 * (sn + i) + 2 * t + (e & 1)] = make_uint2(sp.hi, sp.lo);
      }
    __syncthreads();

    // y[t][e] = r_f[t] . (exp(tot) S)[:, e] + sum_{s <= t} A[t][s] v[s][e]:
    // warp w owns rows 16 (w / 2) .. + 15 and columns 8 (w % 2) .. + 7
    {
      const int m = warp >> 1, n = warp & 1;
      float yacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < NKD; ++ks) {
        const float* rr = RF + (16 * m + g) * LD + 8 * ks + t;
        const Split rf[4] = {split_tf32(rr[0]), split_tf32(rr[8 * LD]), split_tf32(rr[4]),
                             split_tf32(rr[8 * LD + 4])};
        const uint2 s0v = St[(8 * ks + t) * RW_LV + 8 * n + g];
        const uint2 s1v = St[(8 * ks + t + 4) * RW_LV + 8 * n + g];
        const Split sf2[2] = {{s0v.x, s0v.y}, {s1v.x, s1v.y}};
        mma3(yacc, rf, sf2);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = m ? q : q >> 1;  // rows 0-15: key tile 0's halves, then key tile 1's
        const float4 p = SF[(m ? q : 4 + q) * 32 + lane];
        const Split pa[4] = {split_tf32(p.x), split_tf32(p.y), split_tf32(p.z), split_tf32(p.w)};
        const T* v0 = Vs + (8 * j + 2 * t) * RW_LV + 8 * n + g;
        const Split vf[2] = {split_tf32(to_f32(v0[0])), split_tf32(to_f32(v0[RW_LV]))};
        mma3(yacc, pa, vf);
      }
      const int valid = min(RW_Q, a.S - c * RW_Q);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int tr = 16 * m + g + 8 * r;
        if (tr >= valid) continue;
        T* yrow = static_cast<T*>(a.y) + (((long long)b * a.S + c * RW_Q + tr) * a.H + h) * HD +
                  e0 + 8 * n + 2 * t;
        yrow[0] = from_f32<T>(yacc[2 * r]);
        yrow[1] = from_f32<T>(yacc[2 * r + 1]);
      }
    }

    // S[d][e] <- exp(tot_d) S[d][e] + sum_s k_f[s][d] v[s][e], steps of each
    // k-step in the order (2t, 2t + 1), as ssd_scan_kernel's x^T (B o w)
#pragma unroll
    for (int ks = 0; ks < RW_Q / 8; ++ks) {
      const float* ka = KF + (8 * ks + 2 * t) * LD + 16 * sm + g;
      const Split kf[4] = {split_tf32(ka[0]), split_tf32(ka[8]), split_tf32(ka[LD]),
                           split_tf32(ka[LD + 8])};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const T* v0 = Vs + (8 * ks + 2 * t) * RW_LV + 8 * (sn + i) + g;
        const Split vf[2] = {split_tf32(to_f32(v0[0])), split_tf32(to_f32(v0[RW_LV]))};
        mma3(sacc[i], kf, vf);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sf[(16 * sm + g + 8 * (e >> 1)) * HD + 8 * (sn + i) + 2 * t + (e & 1)] = sacc[i][e];
}

template <typename T, int HD>
cudaError_t launch_rwkv(const RwkvArgs& a, cudaStream_t stream) {
  constexpr size_t smem = rwkv_smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  rwkv6_scan_kernel<T, HD><<<dim3(HD / RW_E, a.H, a.B), RW_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rwkv(const RwkvArgs& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_rwkv<T, 32>(a, stream);
    case 64: return launch_rwkv<T, 64>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Mamba2 SSD on the tensor cores
// ---------------------------------------------------------------------------

constexpr int SSD_Q = 64;       // chunk length
constexpr int SSD_P = 32;       // state rows p (columns of y) per block
constexpr int SSD_WARPS = 4;    // warp w owns chunk rows 16 w .. 16 w + 15
constexpr int SSD_THREADS = 32 * SSD_WARPS;
constexpr int SSD_STAGES = 2;   // chunks in flight (cp.async ring)

struct SsdArgs {
  const void* x;        // xdt = x * dt
  const void* bm;
  const void* cm;
  const float* da;      // dA = dt * A <= 0
  const float* h0;      // (B, H, hd, N) contiguous, or nullptr for zeros
  void* y;              // (B, S, H, hd), contiguous
  float* h_fin;         // (B, H, hd, N), contiguous
  int B, S, H;
  long long x_sb, x_ss, x_sh, b_sb, b_ss, b_sh, c_sb, c_ss, c_sh, a_sb, a_ss, a_sh;
};

// One stage: x [Q][P + 4] and B [Q][N + 4] in the input's type, dA [Q];
// then the state slice [P][N + 4] split into tf32 (hi, lo) pairs and each
// warp's cumulative dA [Q] in float32.  C goes straight to registers.
// N = 64, float32: 2 x 26,880 + 17,408 + 1,024 = 72,192 B, three blocks
// per SM.
template <int N>
__host__ __device__ constexpr size_t ssd_stage_elems() {
  return (size_t)SSD_Q * ((SSD_P + 4) + (N + 4));
}
template <typename T, int N>
constexpr size_t ssd_smem_bytes() {
  return SSD_STAGES * (sizeof(T) * ssd_stage_elems<N>() + sizeof(float) * SSD_Q) +
         sizeof(uint2) * SSD_P * (N + 4) + sizeof(float) * SSD_WARPS * SSD_Q;
}

template <typename T, int HD, int N>
__global__ void __launch_bounds__(SSD_THREADS) ssd_scan_kernel(SsdArgs a) {
  // Row strides P + 4 and N + 4 (= 4 mod 8): the fragment reads below hit
  // 32 distinct banks for float32, whether a quad's lanes walk a row
  // (columns t, rows g: bank 4g + t) or rows 2t, 2t + 1 (bank 8t + g); the
  // state's 8-byte (hi, lo) pairs, rows g and columns t, fill a half-warp's
  // 16 slots since N + 4 = 4 mod 16.
  constexpr int LX = SSD_P + 4, LN = N + 4;
  constexpr int NK = N / 8;          // k-steps over the state size
  constexpr int NP = SSD_P / 8;      // n-tiles of y's columns
  constexpr int NQ = SSD_Q / 8;      // n-tiles of the chunk's steps
  constexpr int NS = NK / 2;         // state n-tiles per warp
  constexpr int STAGE = (int)ssd_stage_elems<N>();
  static_assert(HD % SSD_P == 0 && N % 16 == 0 && SSD_Q == 16 * SSD_WARPS, "shapes");

  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);  // SSD_STAGES x (x, B)
  float* DA = reinterpret_cast<float*>(ring + SSD_STAGES * STAGE);  // [STAGES][Q]
  // [P][LN] the state, split once per chunk for every warp's read-out
  uint2* St = reinterpret_cast<uint2*>(DA + SSD_STAGES * SSD_Q);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  float* CUM = reinterpret_cast<float*>(St + SSD_P * LN) + warp * SSD_Q;  // [Q] this warp's cumulative dA

  const int p0 = blockIdx.x * SSD_P, h = blockIdx.y, b = blockIdx.z;
  const T* xp = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh + p0;
  const T* bp = static_cast<const T*>(a.bm) + b * a.b_sb + h * a.b_sh;
  const T* cp = static_cast<const T*>(a.cm) + b * a.c_sb + h * a.c_sh;
  const float* ap = a.da + b * a.a_sb + h * a.a_sh;
  const float* h0 = a.h0 ? a.h0 + ((long long)b * a.H + h) * HD * N + (long long)p0 * N : nullptr;
  float* hf = a.h_fin + ((long long)b * a.H + h) * HD * N + (long long)p0 * N;
  const int n_chunks = (a.S + SSD_Q - 1) / SSD_Q;

  auto load_chunk = [&](int c) {
    T* X = ring + (c % SSD_STAGES) * STAGE;
    const int t0 = c * SSD_Q;
    copy_rows_async<SSD_Q, SSD_P, LX, SSD_THREADS>(X, xp, a.x_ss, t0, a.S);
    copy_rows_async<SSD_Q, N, LN, SSD_THREADS>(X + SSD_Q * LX, bp, a.b_ss, t0, a.S);
    for (int i = tid; i < SSD_Q; i += SSD_THREADS) {
      const bool valid = t0 + i < a.S;
      cp_async1(DA + (c % SSD_STAGES) * SSD_Q + i, valid ? ap + (t0 + i) * a.a_ss : ap, valid);
    }
  };
  load_chunk(0);
  cp_async_commit();

  // the state S[p][n], p in this block's slice: warp w keeps rows
  // 16 (w % 2) + (g, g + 8), columns 8 (NS (w / 2) + i) + (2t, 2t + 1) in
  // registers across chunks (an m16n8 accumulator per n-tile) and mirrors
  // the whole slice into St for the read-out
  const int sm = 16 * (warp & 1), sn = NS * (warp >> 1);
  float sacc[NS][4];
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = sm + g + 8 * (e >> 1), n = 8 * (sn + i) + 2 * t + (e & 1);
      sacc[i][e] = h0 ? h0[p * N + n] : 0.f;
      const Split sp = split_tf32(sacc[i][e]);
      St[p * LN + n] = make_uint2(sp.hi, sp.lo);
    }

  const int ta = 16 * warp + g, tb = ta + 8;  // this lane's chunk rows
  const int nj = 2 * (warp + 1);              // step n-tiles at or below the diagonal

  // C's rows ta and tb of a chunk, the A fragments of C B^T and C S^T, go
  // from global memory straight to registers (only this warp reads them):
  // a chunk's are requested as soon as the previous chunk's are used, and
  // land while the rest of that chunk computes
  float cr[NK][4];
  auto load_c = [&](int c) {
    const int ra = c * SSD_Q + ta, rb = ra + 8;
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      const int n = 8 * ks + t;
      cr[ks][0] = ra < a.S ? to_f32(cp[ra * a.c_ss + n]) : 0.f;
      cr[ks][1] = rb < a.S ? to_f32(cp[rb * a.c_ss + n]) : 0.f;
      cr[ks][2] = ra < a.S ? to_f32(cp[ra * a.c_ss + n + 4]) : 0.f;
      cr[ks][3] = rb < a.S ? to_f32(cp[rb * a.c_ss + n + 4]) : 0.f;
    }
  };
  load_c(0);
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<0>();  // chunk c landed (this thread's copies)
    __syncthreads();     // everyone's; St written; chunk c - 1 consumed
    if (c + 1 < n_chunks) load_chunk(c + 1);  // streams in while chunk c computes
    cp_async_commit();

    const T* X = ring + (c % SSD_STAGES) * STAGE;
    const T* Bs = X + SSD_Q * LX;
    {  // cumulative dA over the chunk, each warp its own copy (padded steps add 0)
      const float* da = DA + (c % SSD_STAGES) * SSD_Q;
      const float d0 = da[2 * lane], d1 = da[2 * lane + 1];
      float incl = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      CUM[2 * lane] = incl - d1;
      CUM[2 * lane + 1] = incl;
      __syncwarp();
    }
    const float cum_a = CUM[ta], cum_b = CUM[tb], cum_q = CUM[SSD_Q - 1];

    // scores C B^T for the warp's 16 rows and the step tiles at or below
    // its diagonal, and the read-out C S^T, sharing C's fragments
    float sc[NQ][4], yacc[NP][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NP; ++j) yacc[j][0] = yacc[j][1] = yacc[j][2] = yacc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      const Split cf[4] = {split_tf32(cr[ks][0]), split_tf32(cr[ks][1]), split_tf32(cr[ks][2]),
                           split_tf32(cr[ks][3])};
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        if (j >= nj) break;
        const T* br = Bs + (8 * j + g) * LN + 8 * ks + t;
        const Split bf[2] = {split_tf32(to_f32(br[0])), split_tf32(to_f32(br[4]))};
        mma3(sc[j], cf, bf);
      }
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const uint2* sr = St + (8 * j + g) * LN + 8 * ks + t;
        const uint2 s0 = sr[0], s1 = sr[4];
        const Split sf[2] = {{s0.x, s0.y}, {s1.x, s1.y}};
        mma3(yacc[j], cf, sf);
      }
    }
    if (c + 1 < n_chunks) load_c(c + 1);
    // y = e^cum_t (C S^T) + ((C B^T) o L) x, L[t][s] = e^(cum_t - cum_s) for s <= t
    const float ea = expf(cum_a), eb = expf(cum_b);
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      yacc[j][0] *= ea;
      yacc[j][1] *= ea;
      yacc[j][2] *= eb;
      yacc[j][3] *= eb;
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      if (j >= nj) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 8 * j + 2 * t + (e & 1), tt = e < 2 ? ta : tb;
        sc[j][e] = s <= tt ? sc[j][e] * expf((e < 2 ? cum_a : cum_b) - CUM[s]) : 0.f;
      }
      // steps of the k-step in the order (2t, 2t + 1), as in flash_attn_kernel:
      // the accumulator fragment is the A fragment
      const Split pa[4] = {split_tf32(sc[j][0]), split_tf32(sc[j][2]), split_tf32(sc[j][1]),
                           split_tf32(sc[j][3])};
      const T* x0 = X + (8 * j + 2 * t) * LX + g;
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        const Split xf[2] = {split_tf32(to_f32(x0[8 * n])), split_tf32(to_f32(x0[LX + 8 * n]))};
        mma3(yacc[n], pa, xf);
      }
    }
    const int valid = min(SSD_Q, a.S - c * SSD_Q);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int tt = r ? tb : ta;
      if (tt >= valid) continue;
      T* yrow = static_cast<T*>(a.y) + (((long long)b * a.S + c * SSD_Q + tt) * a.H + h) * HD +
                p0 + 2 * t;
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        yrow[8 * n] = from_f32<T>(yacc[n][2 * r]);
        yrow[8 * n + 1] = from_f32<T>(yacc[n][2 * r + 1]);
      }
    }

    // S[p][n] <- S[p][n] e^cum_Q + sum_s x[s][p] (B o w)[s][n], w_s =
    // e^(cum_Q - cum_s) folded into x's fragment; steps in the order
    // (2t, 2t + 1) as above
    const float dq = expf(cum_q);
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[i][e] *= dq;
#pragma unroll
    for (int ks = 0; ks < NQ; ++ks) {
      const int s0 = 8 * ks + 2 * t;
      const float w0 = expf(cum_q - CUM[s0]), w1 = expf(cum_q - CUM[s0 + 1]);
      const T* xa = X + s0 * LX + sm + g;
      const Split xf[4] = {split_tf32(to_f32(xa[0]) * w0), split_tf32(to_f32(xa[8]) * w0),
                           split_tf32(to_f32(xa[LX]) * w1), split_tf32(to_f32(xa[LX + 8]) * w1)};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const T* br = Bs + s0 * LN + 8 * (sn + i) + g;
        const Split bf[2] = {split_tf32(to_f32(br[0])), split_tf32(to_f32(br[LN]))};
        mma3(sacc[i], xf, bf);
      }
    }
    __syncthreads();  // every warp has read St for this chunk's read-out
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const Split sp = split_tf32(sacc[i][e]);
        St[(sm + g + 8 * (e >> 1)) * LN + 8 * (sn + i) + 2 * t + (e & 1)] = make_uint2(sp.hi, sp.lo);
      }
  }
  cp_async_wait<0>();  // no copy outlives the block
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      hf[(sm + g + 8 * (e >> 1)) * N + 8 * (sn + i) + 2 * t + (e & 1)] = sacc[i][e];
}

template <typename T, int HD, int N>
cudaError_t launch_ssd(const SsdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = ssd_smem_bytes<T, N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, HD, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T, HD, N><<<dim3(HD / SSD_P, a.H, a.B), SSD_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_ssd_n(const SsdArgs& a, int n, cudaStream_t stream) {
  switch (n) {
    case 16: return launch_ssd<T, HD, 16>(a, stream);
    case 32: return launch_ssd<T, HD, 32>(a, stream);
    case 64: return launch_ssd<T, HD, 64>(a, stream);
    // granite-4.0-h's state: heads of 64 only.  121,344 B of shared memory
    // in float32 (one block an SM) and C's 64 fragment registers a thread
    case 128:
      if constexpr (HD == 64) return launch_ssd<T, HD, 128>(a, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_ssd(const SsdArgs& a, int hd, int n, cudaStream_t stream) {
  switch (hd) {
    case 32: return dispatch_ssd_n<T, 32>(a, n, stream);
    case 64: return dispatch_ssd_n<T, 64>(a, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface.  dtype: 0 = float32, 1 = bfloat16.  Strides are in elements,
// the last dimension is contiguous, and the strides along the sequence are
// multiples of 4 with 4-element-aligned starts (4-element vector loads).
// Returns a cudaError_t (0 = launched); cudaErrorInvalidValue for a
// head_dim, state size or dtype that no kernel here is built for: these
// switches are the one list of them.
// ---------------------------------------------------------------------------

extern "C" int repro_rwkv6_scan(int dtype, int hd, const void* r, const void* k, const void* v,
                                const void* w, const void* u, const float* s0, void* y,
                                float* s_fin, int B, int S, int H,
                                const long long* strides,  // r, k, v, w: b,s,h each
                                void* stream) {
  if (S < 1) return cudaErrorInvalidValue;
  RwkvArgs a{r, k, v, w, u, s0, y, s_fin, B, S, H,
             strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
             strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_rwkv<float>(a, hd, st);
  if (dtype == 1) return dispatch_rwkv<__nv_bfloat16>(a, hd, st);
  return cudaErrorInvalidValue;
}

extern "C" int repro_ssd_scan(int dtype, int hd, int n, const void* x, const void* bm,
                              const void* cm, const float* da, const float* h0, void* y,
                              float* h_fin, int B, int S, int H,
                              const long long* strides,  // x, B, C, dA: b,s,h each
                              void* stream) {
  if (S < 1) return cudaErrorInvalidValue;
  SsdArgs a{x, bm, cm, da, h0, y, h_fin, B, S, H,
            strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
            strides[6], strides[7], strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_ssd<float>(a, hd, n, st);
  if (dtype == 1) return dispatch_ssd<__nv_bfloat16>(a, hd, n, st);
  return cudaErrorInvalidValue;
}
