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
//   Bound on this card: bytes, barely.  At rwkv6-1.6b's prefill (B=4, S=512,
//   H=32, hd=64) the kernel moves 88 MB (r, k, v, logw read once, y and the
//   states once) in 26 us at 3.35 TB/s, and the chunked form does 1.6 GFLOP,
//   24 us at 67 TFLOP/s of float32.
//   Design: chunks of Q = 32 steps, computed as the TPU kernel does with the
//   exact factorisation r_t.k_s exp(cum_{t-1} - cum_s) =
//   (r_t exp(cum_{t-1} - tot)) . (k_s exp(tot - cum_s)), which stays in
//   float32 range because logw >= -2 (LOGW_CLAMP in models/rwkv.py) gives
//   exponents of at most 2 Q = 64.  The chunk length is fixed: a longer one
//   overflows.  Padded steps past S take logw = 0 and r = k = v = 0, so they
//   change neither the state nor any valid output.  The TPU's sequential
//   chunk grid axis becomes a loop inside the block.  B * H = 128 (batch,
//   head) pairs would leave SMs idle, and the recurrence is independent per
//   value column e (y[:, e] needs only S[:, e] and v[:, e]), so each block
//   owns 16 value columns of one (batch, head): 512 blocks at that shape.
//   Its (hd, 16) state slice stays in shared memory for the whole sequence;
//   each block recomputes the chunk's (Q, Q) score matrix for its columns.
//   The three chunk products are register-tiled with 8- and 16-byte
//   shared-memory loads (scalar loads, two per FMA, made the first version
//   bound by load instructions), and the cumulative decay of each key
//   column is cut into 256 / hd segments joined by a shuffle scan.
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
constexpr int RW_THREADS = 256;

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

template <int HD>
constexpr size_t rwkv_smem_bytes() {
  return sizeof(float) * (size_t)(4 * RW_Q * (HD + 4) + RW_Q * RW_E + RW_Q * (RW_Q + 4) +
                                  HD * RW_E + 2 * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(RW_THREADS) rwkv6_scan_kernel(RwkvArgs a) {
  constexpr int LD = HD + 4;              // 16-byte aligned rows, conflict-free float4 reads
  constexpr int AS = RW_Q + 4;
  constexpr int SEG = RW_THREADS / HD;    // threads per key column in the decay scan
  constexpr int STEPS = RW_Q / SEG;       // steps per thread in the decay scan
  constexpr int SPT = HD * RW_E / RW_THREADS;  // state entries per thread
  static_assert(RW_THREADS % HD == 0 && 32 % SEG == 0 && RW_Q % SEG == 0, "head_dim");
  static_assert(RW_Q == 32 && RW_E == 16 && RW_THREADS == 256, "tiling");

  extern __shared__ float4 smem4[];
  float* R = reinterpret_cast<float*>(smem4);  // [Q][LD] r, then r exp(cum_prev - tot)
  float* K = R + RW_Q * LD;                     // [Q][LD] k, then k exp(tot - cum)
  float* W = K + RW_Q * LD;                     // [Q][LD] logw, then r exp(cum_prev)
  float* P = W + RW_Q * LD;                     // [Q][LD] r u k (the diagonal)
  float* V = P + RW_Q * LD;                     // [Q][E] this block's value columns
  float* A = V + RW_Q * RW_E;                   // [Q][AS] intra-chunk scores
  float* St = A + RW_Q * AS;                    // [HD][E] state slice
  float* U = St + HD * RW_E;                    // [HD] bonus u
  float* DT = U + HD;                           // [HD] exp(tot)

  const int e0 = blockIdx.x * RW_E, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* rp = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + e0;
  const T* wp = static_cast<const T*>(a.w) + b * a.w_sb + h * a.w_sh;
  const long long st_off = ((long long)b * a.H + h) * HD * HD;

  for (int i = tid; i < HD * RW_E; i += RW_THREADS) {
    const int d = i / RW_E, e = i % RW_E;
    St[i] = a.s0 ? a.s0[st_off + d * HD + e0 + e] : 0.f;
  }
  for (int d = tid; d < HD; d += RW_THREADS)
    U[d] = to_f32(static_cast<const T*>(a.u)[h * HD + d]);

  for (int t0 = 0; t0 < a.S; t0 += RW_Q) {
    const int valid = min(RW_Q, a.S - t0);
    __syncthreads();  // previous chunk consumed
    stage_rows<RW_Q, HD, LD, RW_THREADS>(R, rp, a.r_ss, t0, a.S, 1.f);
    stage_rows<RW_Q, HD, LD, RW_THREADS>(K, kp, a.k_ss, t0, a.S, 1.f);
    stage_rows<RW_Q, HD, LD, RW_THREADS>(W, wp, a.w_ss, t0, a.S, 1.f);
    if (tid < RW_Q * RW_E / 4) {
      const int t = tid / (RW_E / 4), c = (tid % (RW_E / 4)) * 4;
      const float4 x = t < valid ? load4(vp + (t0 + t) * a.v_ss + c)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(V + t * RW_E + c) = x;
    }
    __syncthreads();

    // per key column d, SEG threads of STEPS steps each: the cumulative log
    // decay over the chunk (a shuffle scan joins the segments), then the
    // factorised r and k, r exp(cum_prev) for the carried state, and r u k
    {
      const int d = tid / SEG, seg = tid % SEG, t_lo = seg * STEPS;
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < STEPS; ++k) run += W[(t_lo + k) * LD + d];
      float incl = run;
#pragma unroll
      for (int off = 1; off < SEG; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off, SEG);
        if (seg >= off) incl += o;
      }
      const float tot = __shfl_sync(0xffffffffu, incl, SEG - 1, SEG);
      float cp = incl - run;  // cum_prev at this segment's first step
      const float u = U[d];
#pragma unroll
      for (int k = 0; k < STEPS; ++k) {
        const int i = (t_lo + k) * LD + d;
        const float lw = W[i], r = R[i], kk = K[i];
        P[i] = r * u * kk;
        R[i] = r * expf(cp - tot);
        K[i] = kk * expf(tot - (cp + lw));
        W[i] = r * expf(cp);
        cp += lw;
      }
      if (seg == 0) DT[d] = expf(tot);
    }
    __syncthreads();

    // scores A[t][s] = r_f[t] . k_f[s] below the diagonal, 0 above it: a
    // 2x2 tile per thread (rows ty + 16 i, columns tx + 16 j); the first
    // warp puts r_t . (u k_t) on the diagonal
    {
      float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        float4 rv[2], kv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) rv[i] = *reinterpret_cast<const float4*>(&R[(ty + 16 * i) * LD + d]);
#pragma unroll
        for (int j = 0; j < 2; ++j) kv[j] = *reinterpret_cast<const float4*>(&K[(tx + 16 * j) * LD + d]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float x = acc[i][j];
            x = fmaf(rv[i].x, kv[j].x, x);
            x = fmaf(rv[i].y, kv[j].y, x);
            x = fmaf(rv[i].z, kv[j].z, x);
            x = fmaf(rv[i].w, kv[j].w, x);
            acc[i][j] = x;
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int t = ty + 16 * i, s = tx + 16 * j;
          if (s != t) A[t * AS + s] = s < t ? acc[i][j] : 0.f;
        }
      if (tid < RW_Q) {
        float dg = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) dg += P[tid * LD + d];
        A[tid * AS + tid] = dg;
      }
    }
    __syncthreads();

    // y[t][e] = sum_{s <= t} A[t][s] v[s][e] + sum_d r_t exp(cum_prev_t)[d] S[d][e];
    // row t = tid / 8, columns e, e + 1 with e = 2 (tid % 8)
    {
      const int t = tid >> 3, e = (tid & 7) * 2;
      float y0 = 0.f, y1 = 0.f;
      for (int s = 0; s <= t; s += 4) {
        const float4 av = *reinterpret_cast<const float4*>(&A[t * AS + s]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 vv = *reinterpret_cast<const float2*>(&V[(s + u) * RW_E + e]);
          const float c = comp(av, u);
          y0 = fmaf(c, vv.x, y0);
          y1 = fmaf(c, vv.y, y1);
        }
      }
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        const float4 wv = *reinterpret_cast<const float4*>(&W[t * LD + d]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 sv = *reinterpret_cast<const float2*>(&St[(d + u) * RW_E + e]);
          const float c = comp(wv, u);
          y0 = fmaf(c, sv.x, y0);
          y1 = fmaf(c, sv.y, y1);
        }
      }
      if (t < valid) {
        T* yrow = static_cast<T*>(a.y) + (((long long)b * a.S + t0 + t) * a.H + h) * HD + e0 + e;
        yrow[0] = from_f32<T>(y0);
        yrow[1] = from_f32<T>(y1);
      }
    }
    __syncthreads();

    // S[d][e] <- S[d][e] exp(tot_d) + sum_s k_f[s][d] v[s][e]; SPT
    // consecutive columns of one row d per thread
    {
      const int d = tid / (RW_E / SPT), e = (tid % (RW_E / SPT)) * SPT;
      float acc[SPT];
      const float dt = DT[d];
#pragma unroll
      for (int j = 0; j < SPT; ++j) acc[j] = St[d * RW_E + e + j] * dt;
#pragma unroll 8
      for (int s = 0; s < RW_Q; ++s) {
        const float kf = K[s * LD + d];
#pragma unroll
        for (int j = 0; j < SPT; ++j) acc[j] = fmaf(kf, V[s * RW_E + e + j], acc[j]);
      }
#pragma unroll
      for (int j = 0; j < SPT; ++j) St[d * RW_E + e + j] = acc[j];
    }
  }
  __syncthreads();
  for (int i = tid; i < HD * RW_E; i += RW_THREADS) {
    const int d = i / RW_E, e = i % RW_E;
    a.s_fin[st_off + d * HD + e0 + e] = St[i];
  }
}

template <typename T, int HD>
cudaError_t launch_rwkv(const RwkvArgs& a, cudaStream_t stream) {
  constexpr size_t smem = rwkv_smem_bytes<HD>();
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
