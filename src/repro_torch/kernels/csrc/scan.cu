// Recurrent scan kernels for NVIDIA Hopper (sm_90a), hand-written in CUDA C++.
//
// Plain C interface, built with nvcc into the same shared library as
// attention.cu and bound with ctypes by repro_torch/kernels/_build.py.
// Both kernels read float32 or bfloat16, compute in float32 on the CUDA
// cores (no tensor cores, no TF32), write y in the input's type and the
// final state in float32.  Both take an initial state (the models' s0 / h0;
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
//   Bound on this card: operations.  At zamba2-2.7b's prefill (B=4, S=512,
//   H=80, hd=64, N=64) the chunked form does 8.1 GFLOP, 120 us at 67
//   TFLOP/s, against 96 MB of traffic (29 us).
//   Design: one block of 256 threads per (batch, head) loops over chunks of
//   Q = 128 steps; x, B, C of a chunk, the (Q, Q) decayed score matrix and
//   the (hd, N) state all sit in shared memory (185 KB at hd = N = 64).
//   Every product is register-tiled: each thread computes an 8x8 block of
//   C B^T, an 8 x hd/16 block of y (its rows end at the causal edge, so it
//   stops there) and an hd/16 x N/16 block of the state.  Every exponent
//   taken is <= 0 (dA <= 0), so nothing overflows.  B and C are read
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
// Mamba2 SSD
// ---------------------------------------------------------------------------

constexpr int SSD_Q = 128;      // chunk length
constexpr int SSD_THREADS = 256;

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

template <int HD, int N>
constexpr size_t ssd_smem_bytes() {
  return sizeof(float) * (size_t)(SSD_Q * HD + 2 * SSD_Q * (N + 4) + SSD_Q * (SSD_Q + 1) +
                                  N * HD + SSD_Q + 8);
}

template <typename T, int HD, int N>
__global__ void __launch_bounds__(SSD_THREADS) ssd_scan_kernel(SsdArgs a) {
  constexpr int NS = N + 4;           // padded B / C rows, 16-byte aligned
  constexpr int SCS = SSD_Q + 1;      // padded score rows
  constexpr int PB = HD / 16;         // y columns per thread (contiguous)
  constexpr int SN = N / 16;          // state columns per thread (16 apart)
  static_assert(HD % 16 == 0 && N % 16 == 0 && SSD_Q == 128, "shapes");

  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // [Q][HD] xdt
  float* Bs = X + SSD_Q * HD;                   // [Q][NS] B, then B o w
  float* Cs = Bs + SSD_Q * NS;                  // [Q][NS] C
  float* Sc = Cs + SSD_Q * NS;                  // [Q][SCS] (C B^T) o L
  float* St = Sc + SSD_Q * SCS;                 // [N][HD] state, transposed
  float* CUM = St + N * HD;                     // [Q] cumulative dA
  float* WT = CUM + SSD_Q;                      // [4] warp totals of the scan

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, lane = tid & 31, warp = tid >> 5;
  const T* xp = static_cast<const T*>(a.x) + b * a.x_sb + h * a.x_sh;
  const T* bp = static_cast<const T*>(a.bm) + b * a.b_sb + h * a.b_sh;
  const T* cp = static_cast<const T*>(a.cm) + b * a.c_sb + h * a.c_sh;
  const float* ap = a.da + b * a.a_sb + h * a.a_sh;
  const long long st_off = ((long long)b * a.H + h) * HD * N;

  for (int i = tid; i < HD * N; i += SSD_THREADS) {
    const int p = i / N, n = i % N;
    St[n * HD + p] = a.h0 ? a.h0[st_off + i] : 0.f;
  }

  for (int t0 = 0; t0 < a.S; t0 += SSD_Q) {
    const int valid = min(SSD_Q, a.S - t0);
    __syncthreads();  // previous chunk consumed
    stage_rows<SSD_Q, HD, HD, SSD_THREADS>(X, xp, a.x_ss, t0, a.S, 1.f);
    stage_rows<SSD_Q, N, NS, SSD_THREADS>(Bs, bp, a.b_ss, t0, a.S, 1.f);
    stage_rows<SSD_Q, N, NS, SSD_THREADS>(Cs, cp, a.c_ss, t0, a.S, 1.f);
    // inclusive prefix sum of dA over the chunk (padded steps add 0)
    float cs = 0.f;
    if (tid < SSD_Q) {
      cs = tid < valid ? ap[(long long)(t0 + tid) * a.a_ss] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, cs, off);
        if (lane >= off) cs += o;
      }
      if (lane == 31) WT[warp] = cs;
    }
    __syncthreads();
    if (tid < SSD_Q) {
      for (int w = 0; w < warp; ++w) cs += WT[w];
      CUM[tid] = cs;
    }
    __syncthreads();

    // Sc[t][s] = (C_t . B_s) exp(cum_t - cum_s) for s <= t, else 0;
    // rows ty + 16 i, columns tx + 16 j
    {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 cv[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          cv[i] = *reinterpret_cast<const float4*>(&Cs[(ty + 16 * i) * NS + n]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          bv[j] = *reinterpret_cast<const float4*>(&Bs[(tx + 16 * j) * NS + n]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float s = acc[i][j];
            s = fmaf(cv[i].x, bv[j].x, s);
            s = fmaf(cv[i].y, bv[j].y, s);
            s = fmaf(cv[i].z, bv[j].z, s);
            s = fmaf(cv[i].w, bv[j].w, s);
            acc[i][j] = s;
          }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty + 16 * i;
        const float ct = CUM[t];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int s = tx + 16 * j;
          Sc[t * SCS + s] = s <= t ? acc[i][j] * expf(ct - CUM[s]) : 0.f;
        }
      }
    }
    __syncthreads();

    // B o w, w_s = exp(cum_Q - cum_s), for the state update below
    const float cq = CUM[SSD_Q - 1];
    for (int i = tid; i < SSD_Q * N; i += SSD_THREADS) {
      const int s = i / N, n = i % N;
      Bs[s * NS + n] *= expf(cq - CUM[s]);
    }
    // y[t][p] = exp(cum_t) (C_t . S[p]) + sum_{s <= t} Sc[t][s] x[s][p];
    // rows ty * 8 + i, columns tx * PB + j
    {
      float acc[8][PB];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < PB; ++j) acc[i][j] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; n += 4) {
        float4 cv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          cv[i] = *reinterpret_cast<const float4*>(&Cs[(ty * 8 + i) * NS + n]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* srow = &St[(n + u) * HD + tx * PB];
          float sv[PB];
#pragma unroll
          for (int j = 0; j < PB; ++j) sv[j] = srow[j];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float c = comp(cv[i], u);
#pragma unroll
            for (int j = 0; j < PB; ++j) acc[i][j] = fmaf(c, sv[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float dec = expf(CUM[ty * 8 + i]);
#pragma unroll
        for (int j = 0; j < PB; ++j) acc[i][j] *= dec;
      }
      const int s_end = (ty + 1) * 8;  // Sc is 0 past the diagonal
      for (int s = 0; s < s_end; ++s) {
        const float* xrow = &X[s * HD + tx * PB];
        float xv[PB];
#pragma unroll
        for (int j = 0; j < PB; ++j) xv[j] = xrow[j];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float sc = Sc[(ty * 8 + i) * SCS + s];
#pragma unroll
          for (int j = 0; j < PB; ++j) acc[i][j] = fmaf(sc, xv[j], acc[i][j]);
        }
      }
      T* yp = static_cast<T*>(a.y);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = ty * 8 + i;
        if (t < valid) {
          T* yrow = yp + (((long long)b * a.S + t0 + t) * a.H + h) * HD + tx * PB;
#pragma unroll
          for (int j = 0; j < PB; ++j) yrow[j] = from_f32<T>(acc[i][j]);
        }
      }
    }
    __syncthreads();

    // S[p][n] <- S[p][n] exp(cum_Q) + sum_s x[s][p] (B o w)[s][n];
    // p = tx + 16 i, n = ty + 16 j
    {
      const float dq = expf(cq);
      float acc[PB][SN];
#pragma unroll
      for (int i = 0; i < PB; ++i)
#pragma unroll
        for (int j = 0; j < SN; ++j) acc[i][j] = St[(ty + 16 * j) * HD + tx + 16 * i] * dq;
#pragma unroll 4
      for (int s = 0; s < SSD_Q; ++s) {
        float xv[PB], bv[SN];
#pragma unroll
        for (int i = 0; i < PB; ++i) xv[i] = X[s * HD + tx + 16 * i];
#pragma unroll
        for (int j = 0; j < SN; ++j) bv[j] = Bs[s * NS + ty + 16 * j];
#pragma unroll
        for (int i = 0; i < PB; ++i)
#pragma unroll
          for (int j = 0; j < SN; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < PB; ++i)
#pragma unroll
        for (int j = 0; j < SN; ++j) St[(ty + 16 * j) * HD + tx + 16 * i] = acc[i][j];
    }
  }
  __syncthreads();
  for (int i = tid; i < HD * N; i += SSD_THREADS) {
    const int p = i / N, n = i % N;
    a.h_fin[st_off + i] = St[n * HD + p];
  }
}

template <typename T, int HD, int N>
cudaError_t launch_ssd(const SsdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = ssd_smem_bytes<HD, N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, HD, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T, HD, N><<<dim3(a.H, a.B), SSD_THREADS, smem, stream>>>(a);
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
