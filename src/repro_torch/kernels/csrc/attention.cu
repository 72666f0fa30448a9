// Attention kernels for NVIDIA Hopper (sm_90a), hand-written in CUDA C++.
//
// Plain C interface, built with nvcc into a shared library and bound with
// ctypes by repro_torch/kernels/_build.py.  Both kernels compute in float32
// on the CUDA cores (no tensor cores, no TF32), read float32 or bfloat16,
// and write the input's type.  Masked scores use the finite NEG_INF = -1e30
// of the TPU kernels: a row whose first kv tile is fully masked accumulates
// exp(0) = 1 junk that alpha = exp(-1e30 - m) = 0 wipes at its first valid
// score.  Slots past the end of the sequence are -inf and weigh exactly 0.
//
// flash_attn_kernel replaces the Pallas kernel
//   src/repro/kernels/flash_attention.py::flash_attention (_attn_kernel).
//   Bound on this card: operations.  Causal prefill at B=4, S=512, H=32,
//   hd=128 is 4.3 GFLOP of float32 FMA work against 84 MB of traffic.
//   Design: one block of 256 threads per (q tile of 64 rows, q head, batch).
//   The TPU's sequential kv grid axis becomes a loop inside the block,
//   bounded to the kv tiles the causal / window mask can reach (the TPU grid
//   visits every tile).  The Q tile and each K/V tile are staged in shared
//   memory as float32 (each thread issues all its vector loads of a tile
//   before storing any); every thread owns a 4x4 block of the 64x64 score
//   tile, read with 16-byte loads from padded rows (no bank conflicts), and
//   4 rows x hd/16 columns of the f32 output accumulator in registers
//   (for hd = 80, zamba2's shared attention, five single columns 16 apart).
//   Row max and sum reduce over the 16 lanes holding a row with shuffles.
//   q tiles are issued heaviest first so the causal tail does not idle SMs.
//   Ragged S is masked here; the TPU kernel asserted S % 128 == 0.
//
// decode_attn_kernel replaces the Pallas kernel
//   src/repro/kernels/decode_attention.py::decode_attention (_decode_kernel).
//   Bound on this card: bytes.  One query token reads the whole K/V cache
//   (2 * B * KV * S * hd * 4 bytes; 17 MB per layer for qwen3-4b at B=4,
//   S=524) and does 4 * H * S * hd operations on it.
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
// Prefill: blockwise online-softmax attention
// ---------------------------------------------------------------------------

constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_THREADS = 256;

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

template <int HD>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * (size_t)(FA_BQ * (HD + 4) + FA_BK * (HD + 4) +
                                  FA_BK * HD + FA_BQ * (FA_BK + 4));
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS) flash_attn_kernel(FlashArgs a) {
  constexpr int QS = HD + 4;        // padded row stride of the Q and K tiles
  constexpr int PS = FA_BK + 4;     // padded row stride of the P tile
  constexpr int VEC = HD % 64 == 0 ? 4 : (HD % 32 == 0 ? 2 : 1);
  constexpr int NCH = HD / (16 * VEC);  // column chunks per thread
  static_assert(HD % 16 == 0, "head_dim must be a multiple of 16");

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][QS], pre-scaled
  float* Ks = Qs + FA_BQ * QS;                   // [BK][QS]
  float* Vs = Ks + FA_BK * QS;                   // [BK][HD]
  float* Ps = Vs + FA_BK * HD;                   // [BQ][PS]

  const int qt = gridDim.x - 1 - blockIdx.x;    // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = qt * FA_BQ;

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  stage_rows<FA_BQ, HD, QS, FA_THREADS>(Qs, qp, a.q_ss, q0, a.S, a.sm_scale);

  // kv tiles any row of this q tile can see
  const int k_hi = a.causal ? min(a.S, q0 + FA_BQ) : a.S;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int kt_lo = k_lo / FA_BK, kt_hi = (k_hi + FA_BK - 1) / FA_BK;

  float m[4], l[4], acc[4][NCH * VEC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH * VEC; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * FA_BK;
    __syncthreads();  // Q staged / previous K, V, P consumed
    stage_rows<FA_BK, HD, QS, FA_THREADS>(Ks, kp, a.k_ss, k0, a.S, 1.f);
    stage_rows<FA_BK, HD, HD, FA_THREADS>(Vs, vp, a.v_ss, k0, a.S, 1.f);
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * QS + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * QS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = sc[i][j];
          s = fmaf(qv[i].x, kv[j].x, s);
          s = fmaf(qv[i].y, kv[j].y, s);
          s = fmaf(qv[i].z, kv[j].z, s);
          s = fmaf(qv[i].w, kv[j].w, s);
          sc[i][j] = s;
        }
    }

    // mask + online softmax, one row at a time
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float rmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float s = sc[i][j];
        if (kj >= a.S)
          s = -INFINITY;
        else if ((a.causal && kj > qi) || (a.window > 0 && kj <= qi - a.window))
          s = NEG_INF;
        sc[i][j] = s;
        rmax = fmaxf(rmax, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sc[i][j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = alpha * l[i] + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NCH * VEC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty + 16 * i) * PS + tx + 16 * j] = sc[i][j];
    }
    __syncthreads();

    // acc += P @ V; thread columns: chunk n covers n*16*VEC + tx*VEC + [0, VEC)
#pragma unroll 2
    for (int kk = 0; kk < FA_BK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * PS + kk]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = &Vs[(kk + u) * HD];
        float vv[NCH * VEC];
#pragma unroll
        for (int n = 0; n < NCH; ++n) {
          const int col = n * 16 * VEC + tx * VEC;
          if constexpr (VEC == 4) {
            const float4 t = *reinterpret_cast<const float4*>(&vrow[col]);
            vv[n * 4 + 0] = t.x;
            vv[n * 4 + 1] = t.y;
            vv[n * 4 + 2] = t.z;
            vv[n * 4 + 3] = t.w;
          } else if constexpr (VEC == 2) {
            const float2 t = *reinterpret_cast<const float2*>(&vrow[col]);
            vv[n * 2 + 0] = t.x;
            vv[n * 2 + 1] = t.y;
          } else {
            vv[n] = vrow[col];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = comp(p4[i], u);
#pragma unroll
          for (int c = 0; c < NCH * VEC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

  T* op = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= a.S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = op + (((long long)b * a.S + s) * a.H + h) * HD;
#pragma unroll
    for (int n = 0; n < NCH; ++n)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        orow[n * 16 * VEC + tx * VEC + e] = from_f32<T>(acc[i][n * VEC + e] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch_flash(const FlashArgs& a, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<HD>();
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
