// Grouped expert products of a dropless MoE layer for NVIDIA Hopper
// (sm_90a), hand-written in CUDA C++.
//
// Plain C interface, built with nvcc into the same shared library as
// attention.cu, scan.cu and gemm.cu and bound with ctypes by
// repro_torch/kernels/_build.py; the wrapper is kernels/moe_gemm.py.
//
// Replaces no TPU kernel.  The JAX package's MoE layer drops assignments
// past a capacity and runs its experts as einsums over fixed-size slots; a
// dropless layer (granite-4.0-h: 72 experts, top-10; DeepSeek-V2-Lite: 64,
// top-6) computes every assignment to the experts this card holds, so each
// expert's number of rows is known only on the device, after the router's
// sort.  cuBLAS takes a product's shape from the host, which would cost a
// synchronisation a layer.  Here the rows come sorted by expert, held
// expert e owning rows offsets[e] .. offsets[e + 1] - 1, and each kernel
// builds its own list of work from the offsets, on the device.  Three
// launches a layer:
//
//   moe_gemm_kernel<true>:  h_r = silu(x_tok(r) W_gate[e]) * (x_tok(r) W_up[e])
//   moe_gemm_kernel<false>: o_r = gate_r * (h_r W_down[e])
//   moe_combine_kernel:     y_t = sum_k o_pos(t,k), over the token's k in
//                           order, rows of no held expert skipped
//
// What bounds it on this card.  Every held expert's weights are read once a
// call, against 2 x 3 x D x F operations for each of its rows.
//   DeepSeek-V2-Lite's cell (384 tokens, top-6 of 64, all held): about 36
// rows an expert, 18 operations a weight byte, under the ridge of 165
// TFLOP/s of 3xTF32 over 3.35 TB/s (49): bound by bytes, 2.21 GB of expert
// weights a layer (0.66 ms), 57.6 GB a pass of 26 layers.
//   granite-4.0-h-small's cell (1,536 tokens, top-10 of 72, 18 held): about
// 213 rows an expert, 3,840 a layer, 2 x 3,840 x 3 x 4096 x 768 = 72 GFLOP
// (0.44 ms) against 680 MB of held weights (0.20 ms): bound by operations.
//
// Design (gemm.cu's, with a list of experts' tiles for its tiles).  The
// operands are swapped: wgmma's 64-row A is 64 weight columns, loaded from
// the swizzled TMA tile into registers and split there into TF32 hi and lo
// (no copy of a weight is made); its B is a tile of BT = 48 of the
// expert's sorted rows, split once into hi and lo, K-major, by the
// producer.  A unit of work is one held expert's column slice (GATED: 64
// columns of h, whose gate and up columns share each warp's A rows, g the
// gate and g + 8 the up column, so every thread holds both for the SwiGLU
// epilogue; else 128 columns of o) for one tile of its rows, 32 deep a
// stage.  Every block (384 threads, one an SM, persistent) first builds the
// unit table from the offsets in shared memory (a held expert gives
// ceil(n_e / BT) tiles x the slices; an empty expert none), then takes
// units blockIdx.x, + gridDim.x, ...  An expert's tiles of one slice are consecutive units, so they run
// side by side and its second tile reads the weights from L2.  The host
// reads no count; nothing is reset between calls.
//   The producer warpgroup: one thread of warp 0 keeps a ring of weight
// stages in flight by TMA (16 KB each: four 32 x 32 boxes with the 128-byte
// swizzle, from tensor maps over (held D, F) and (held F, D)) under
// mbarriers; warps 1-3 copy the tile's rows by cp.async into a ring of four
// activation stages (the gate-and-up product gathers x's rows through tok:
// TMA cannot gather, and x sits in L2) and split each landed stage into a
// ring of split stages.  The two consumer warpgroups run 4 k-steps x 3
// passes of wgmma.m64nBTk8 a stage.
//   The token tile is 48 rows (wgmma's n): DeepSeek's 36 rows an expert
// take one tile, a padded product that stays near the weight stream;
// granite's 213 take five, whose weights after the first come from L2.
// Each consumer keeps two groups of fresh accumulators, so a stage's
// products run while the next stage's fragments load.  With 8 weight and 4
// split stages in flight, 48 rows beat 64 and 128 at both cells' shapes on
// an H100 (PERF.md): a wider tile adds split and product work a
// stage faster than it saves stages.
//   Numerics: 3xTF32 on both operands (common.cuh), float32-accurate; each
// stage's products go to fresh accumulators, added to the running sums in
// float32 once a stage (the tensor cores' own accumulation truncates, which
// over a chain of 3 Kd / 8 products drifts past float32's rounding).  No
// atomics: a call's output does not depend on the order its units run.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int MG_BK = 32;                          // depth a stage
constexpr int MG_BT = 48;                          // a unit's token tile (wgmma's n)
constexpr int MG_THREADS = 384;                    // producer + two consumer warpgroups
constexpr int MG_PRODUCER_REGS = 56;               // 56 x 128 + 224 x 256 = 168 x 384
constexpr int MG_CONSUMER_REGS = 224;
constexpr int MG_RX = 4;                           // stages of the activation ring
constexpr int MG_W_FLOATS = 4 * MG_BK * TMA_BOX;   // a weight stage: four 32 x 32 boxes, 16 KB
constexpr int MG_SPLITTERS = 96;                   // producer warps 1-3: the rows' copy and split
constexpr int MG_MAX_HELD = 1024;
constexpr int MG_COMBINE_THREADS = 128;

// The stages are quick and the bound is the weight stream: many weight
// stages in flight, the split well ahead.
constexpr int MG_RW = 8;                           // stages of the weight ring
constexpr int MG_SP = 4;                           // stages of the split ring

size_t moe_smem_bytes(int held) {
  return 1024 /* alignment slack */ +
         sizeof(float) *
             ((size_t)MG_RW * MG_W_FLOATS + (size_t)(MG_RX + 2 * MG_SP) * MG_BT * MG_BK) +
         8 * (2 * MG_RW + 2 * MG_SP) + sizeof(int) * 2 * (held + 1);
}

struct MoeArgs {
  const float* act;     // GATED: x (T, Kd), a tile's row r is x[tok[r]]; else h (rows, Kd)
  const int* tok;       // (rows,) the token of each sorted row (GATED)
  const int* offsets;   // (held + 1,) each held expert's first sorted row
  const float* gates;   // (rows,) the gate of each sorted row (not GATED)
  float* out;           // (rows, N): h (GATED) or o
  int Kd, N, held;
  int slices;           // column slices an expert: N / the columns of a unit
};

// One unit of work: held expert e's tile of rows row0 .. row0 + valid - 1
// (sorted rows), output columns n0 ...
struct Unit {
  int e, row0, valid, n0;
};

// Unit u of the table: cum[e] tiles come before expert e, and expert e's
// units are its slices x its tiles, the tiles of a slice consecutive.
template <int COLS>
__device__ __forceinline__ Unit unit_at(int u, const int* off, const int* cum, int held,
                                        int slices) {
  int e = 0, hi = held - 1;  // the last expert whose units start at or before u
  while (e < hi) {
    const int mid = (e + hi + 1) >> 1;
    if (slices * cum[mid] <= u)
      e = mid;
    else
      hi = mid - 1;
  }
  const int tiles = cum[e + 1] - cum[e], rem = u - slices * cum[e], m0 = (rem % tiles) * MG_BT;
  return {e, off[e] + m0, min(MG_BT, off[e + 1] - off[e] - m0), (rem / tiles) * COLS};
}

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle's
// pattern repeats every 1024 bytes):
//   wring[RW]:   a weight stage as TMA's 128-byte swizzle lays it: [4 boxes]
//                [32 k][32 columns] (16-byte chunk c of row k at c ^ (k % 8));
//                GATED: boxes 0, 1 W_gate's 64 columns, 2, 3 W_up's
//   xraw[MG_RX]: [BT rows][32 k], laid out with the same swizzle
//   split[SP]:   hi, lo: [BT / 8][8 core columns][8 rows][4 k], as in gemm.cu
//                (core column 2j holds k = 8j + 0, 2, 4, 6, 2j + 1 k = 8j + 1,
//                3, 5, 7)
//   barriers; off (held + 1,), the offsets; cum (held + 1,), the tiles
//   before each expert.
template <bool GATED>
__global__ void __launch_bounds__(MG_THREADS, 1)
    moe_gemm_kernel(const __grid_constant__ CUtensorMap tm0,
                    const __grid_constant__ CUtensorMap tm1, const MoeArgs a) {
  constexpr int RW = MG_RW, SP = MG_SP, BT = MG_BT;
  constexpr int X_FLOATS = BT * MG_BK;
  constexpr int COLS = GATED ? 64 : 128;   // output columns a unit
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* wring = reinterpret_cast<float*>(base);
  float* xraw = wring + RW * MG_W_FLOATS;
  float* split = xraw + MG_RX * X_FLOATS;
  uint64_t* bars = reinterpret_cast<uint64_t*>(split + SP * 2 * X_FLOATS);
  uint64_t* full_w = bars;            // a weight stage landed (TMA bytes)
  uint64_t* empty_w = bars + RW;      // and read by the 8 consumer warps
  uint64_t* full_p = bars + 2 * RW;   // a split stage written
  uint64_t* empty_p = full_p + SP;    // and read by the 8 consumer warps
  int* off = reinterpret_cast<int*>(empty_p + SP);
  int* cum = off + a.held + 1;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < RW; ++s) {
      mbar_init(full_w + s, 1);
      mbar_init(empty_w + s, 8);
    }
    for (int s = 0; s < SP; ++s) {
      mbar_init(full_p + s, 1);
      mbar_init(empty_p + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 32) {  // the unit table: a running sum of ceil(n_e / BT) over the experts
    int carry = 0;
    for (int e0 = 0; e0 < a.held; e0 += 32) {
      const int e = e0 + lane;
      int n = 0;
      if (e < a.held) {
        off[e] = a.offsets[e];
        n = (a.offsets[e + 1] - off[e] + BT - 1) / BT;
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, n, d);
        if (lane >= d) n += v;
      }
      if (e < a.held) cum[e + 1] = carry + n;
      carry += __shfl_sync(0xffffffffu, n, 31);
    }
    if (lane == 0) {
      cum[0] = 0;
      off[a.held] = a.offsets[a.held];
    }
  }
  __syncthreads();
  const int units = a.slices * cum[a.held], kiters = a.Kd / MG_BK;
  const int total =  // stages this block runs
      units > (int)blockIdx.x ? (units - blockIdx.x + gridDim.x - 1) / gridDim.x * kiters : 0;

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(MG_PRODUCER_REGS));
    if (tid < 32) {
      // ---------------- warp 0, one thread: the weight stream, RW stages ahead
      if (lane == 0) {
        int unit = blockIdx.x, k = 0, row = 0, n0 = 0;
        for (int i = 0; i < total; ++i) {
          const int s = i % RW;
          if (i >= RW) mbar_wait(empty_w + s, ((i / RW) & 1) ^ 1);
          if (k == 0) {
            const Unit u = unit_at<COLS>(unit, off, cum, a.held, a.slices);
            row = u.e * a.Kd;
            n0 = u.n0;
          }
          mbar_expect_tx(full_w + s, 4 * MG_W_FLOATS);
          float* W = wring + s * MG_W_FLOATS;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            tma_load(W + b * MG_BK * TMA_BOX, GATED && b >= 2 ? &tm1 : &tm0, full_w + s,
                     n0 + TMA_BOX * (GATED ? b & 1 : b), row + k * MG_BK);
          if (++k == kiters) {
            k = 0;
            unit += gridDim.x;
          }
        }
      }
      return;
    }

    // ---------------- warps 1-3: each tile's rows, copied and split
    // Thread p copies 16-byte chunk p % 8 of rows p / 8 + 12 q by cp.async
    // (the gate-and-up product gathers x's rows through tok: TMA cannot
    // gather, and x sits in L2) into the activation ring, MG_RX - 1 stages
    // ahead, then all split each landed stage into the split ring.
    static_assert(BT * 4 % MG_SPLITTERS == 0, "the splitters share a tile's chunks evenly");
    constexpr int Q = BT * 8 / MG_SPLITTERS;
    const int ptid = tid - 32, c8 = ptid & 7;
    int x_unit = blockIdx.x, x_k = 0, x_stage = 0;
    int src[Q];  // each such row's source row, -1 where none (zero-filled)
    auto copy_stage = [&]() {  // this thread's chunks of the next stage, one group
      if (x_stage < total) {
        if (x_k == 0) {
          const Unit u = unit_at<COLS>(x_unit, off, cum, a.held, a.slices);
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int r = (ptid >> 3) + 12 * q;
            src[q] = r < u.valid ? (GATED ? a.tok[u.row0 + r] : u.row0 + r) : -1;
          }
        }
        float* X = xraw + (x_stage % MG_RX) * X_FLOATS;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int r = (ptid >> 3) + 12 * q;
          const bool valid = src[q] >= 0;
          cp_async4(X + r * MG_BK + ((c8 ^ (r & 7)) << 2),
                    valid ? a.act + (long long)src[q] * a.Kd + x_k * MG_BK + 4 * c8 : a.act,
                    valid);
        }
        if (++x_k == kiters) {
          x_k = 0;
          x_unit += gridDim.x;
        }
      }
      cp_async_commit();
      ++x_stage;
    };

    for (int i = 0; i < MG_RX - 1; ++i) copy_stage();
    for (int it = 0; it < total; ++it) {
      copy_stage();                     // stage it + 3, into the slot stage it - 1 left
      cp_async_wait<MG_RX - 1>();       // this thread's copies of stage it landed
      bar_sync<1, MG_SPLITTERS>();      // and every splitter's
      const int p = it % SP;
      mbar_wait(empty_p + p, ((it / SP) & 1) ^ 1);
      const float* X = xraw + (it % MG_RX) * X_FLOATS;
      uint32_t* hi = reinterpret_cast<uint32_t*>(split + p * 2 * X_FLOATS);
      uint32_t* lo = hi + X_FLOATS;
      // group (row r, k block j): k = 8j .. 8j + 7 of row r; lanes take
      // consecutive rows, so 8 lanes read 8 distinct swizzled chunks and
      // write one whole core matrix
#pragma unroll
      for (int q = 0; q < BT * 4 / MG_SPLITTERS; ++q) {
        const int idx = ptid + MG_SPLITTERS * q;
        const int r = idx % BT, j = idx / BT, r8 = r & 7;
        const float4 v0 = *reinterpret_cast<const float4*>(X + r * MG_BK + (((2 * j) ^ r8) << 2));
        const float4 v1 =
            *reinterpret_cast<const float4*>(X + r * MG_BK + (((2 * j + 1) ^ r8) << 2));
        const Split e0 = split_tf32(v0.x), e2 = split_tf32(v0.z), e4 = split_tf32(v1.x),
                    e6 = split_tf32(v1.z);
        const Split o1 = split_tf32(v0.y), o3 = split_tf32(v0.w), o5 = split_tf32(v1.y),
                    o7 = split_tf32(v1.w);
        const int at = (r >> 3) * (MG_BK * 8) + (2 * j) * 32 + r8 * 4;
        *reinterpret_cast<uint4*>(hi + at) = make_uint4(e0.hi, e2.hi, e4.hi, e6.hi);
        *reinterpret_cast<uint4*>(hi + at + 32) = make_uint4(o1.hi, o3.hi, o5.hi, o7.hi);
        *reinterpret_cast<uint4*>(lo + at) = make_uint4(e0.lo, e2.lo, e4.lo, e6.lo);
        *reinterpret_cast<uint4*>(lo + at + 32) = make_uint4(o1.lo, o3.lo, o5.lo, o7.lo);
      }
      fence_proxy_async();          // the split stage is visible to wgmma
      bar_sync<1, MG_SPLITTERS>();  // every splitter has split (and read raw stage it)
      if (ptid == 0) mbar_arrive(full_p + p);
    }
    cp_async_wait<0>();  // no copy outlives the block (the groups past the last are empty)
    return;
  }

  // ---------------- consumers: 64 A rows (weight columns) x BT rows each
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(MG_CONSUMER_REGS));
  const int c = wg - 1, w = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  // This thread's A fragments, at k = 2t (off0) and 2t + 1 (off1) of the
  // stage's first k-step (k-step j: + 8j rows of 32).  In a swizzled box,
  // row k's chunk cb sits at cb ^ (k % 8).  GATED: rows g and g + 8 of warp
  // w are the gate and the up column of output column 32c + 8w + g (gate
  // box c, up box 2 + c), four 4-byte loads a k-step; else columns 64c + 16w
  // + 2g and + 1 (box 2c + w / 2), two 8-byte loads, as gemm.cu.
  const int cw = GATED ? 8 * w + g : 16 * (w & 1) + 2 * g, cb = cw >> 2;
  const int box = GATED ? c : 2 * c + (w >> 1);
  const int off0 = box * MG_BK * TMA_BOX + (2 * t) * TMA_BOX + ((cb ^ (2 * t)) << 2) + (cw & 3);
  const int off1 =
      box * MG_BK * TMA_BOX + (2 * t + 1) * TMA_BOX + ((cb ^ (2 * t + 1)) << 2) + (cw & 3);
  constexpr int UP = 2 * MG_BK * TMA_BOX;  // GATED: the up boxes after the gate boxes

  // Stage it: wait for its weights and its split rows, load and split this
  // thread's A fragments, and start its 4 k-steps x 3 passes into d (fresh:
  // the first pass ignores d's old values), one wgmma group.
  auto start_stage = [&](int it, Split (&af)[4][4], float (&d)[BT / 2]) {
    mbar_wait(full_w + it % RW, (it / RW) & 1);
    mbar_wait(full_p + it % SP, (it / SP) & 1);
    const float* W = wring + (it % RW) * MG_W_FLOATS;
    const float* hi = split + (it % SP) * 2 * X_FLOATS;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* Wj = W + 8 * j * TMA_BOX;
      if constexpr (GATED) {
        af[j][0] = split_tf32(Wj[off0]);
        af[j][1] = split_tf32(Wj[off0 + UP]);
        af[j][2] = split_tf32(Wj[off1]);
        af[j][3] = split_tf32(Wj[off1 + UP]);
      } else {
        const float2 ra = *reinterpret_cast<const float2*>(Wj + off0);
        const float2 rb = *reinterpret_cast<const float2*>(Wj + off1);
        af[j][0] = split_tf32(ra.x);
        af[j][1] = split_tf32(ra.y);
        af[j][2] = split_tf32(rb.x);
        af[j][3] = split_tf32(rb.y);
      }
    }
    pin_regs(d);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint64_t bh = wgmma_desc(hi + 64 * j, 128, MG_BK * 32);
      const uint64_t bl = wgmma_desc(hi + X_FLOATS + 64 * j, 128, MG_BK * 32);
      wgmma_tf32_d<BT>(d, af[j][0].lo, af[j][1].lo, af[j][2].lo, af[j][3].lo, bh, j > 0);
      wgmma_tf32_d<BT>(d, af[j][0].hi, af[j][1].hi, af[j][2].hi, af[j][3].hi, bl, 1);
      wgmma_tf32_d<BT>(d, af[j][0].hi, af[j][1].hi, af[j][2].hi, af[j][3].hi, bh, 1);
    }
    wgmma_commit();
  };
  // Stage it's group has completed (a wgmma wait came first): its products
  // join the running sums in float32, and the warp frees both its stages.
  // The tensor cores' own accumulation truncates, which over a chain of 3 Kd
  // / 8 products drifts past float32's rounding: hence a fresh d a stage.
  float acc[BT / 2];
  auto retire = [&](int it, Split (&af)[4][4], float (&d)[BT / 2]) {
    pin_regs(d);
#pragma unroll
    for (int j = 0; j < 4; ++j) pin_regs(af[j]);
    if (lane == 0) {
      mbar_arrive(empty_w + it % RW);
      mbar_arrive(empty_p + it % SP);
    }
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) acc[i] += d[i];
  };

  Split af0[4][4];
  float part0[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) part0[i] = 0.f;
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
    // two stages in flight: stage it + 1's loads overlap stage it's
    // products (kiters is even: Kd is a multiple of 64)
    Split af1[4][4];
    float part1[BT / 2];
    for (int kk = 0; kk < kiters; kk += 2, it += 2) {
      start_stage(it, af0, part0);
      if (kk > 0) {
        wgmma_wait_n<1>();
        retire(it - 1, af1, part1);
      }
      start_stage(it + 1, af1, part1);
      wgmma_wait_n<1>();
      retire(it, af0, part0);
    }
    wgmma_wait_n<0>();
    retire(it - 1, af1, part1);

    // ---------------- epilogue: acc[4i + e] is A row g + 8 (e / 2), tile
    // row 8i + 2t + e % 2
    const Unit un = unit_at<COLS>(u, off, cum, a.held, a.slices);
    if constexpr (GATED) {
      float* o = a.out + (long long)un.row0 * a.N + un.n0 + 32 * c + cw;
#pragma unroll
      for (int i = 0; i < BT / 8; ++i) {
        const int r = 8 * i + 2 * t;
        if (r < un.valid) o[(long long)r * a.N] = silu(acc[4 * i]) * acc[4 * i + 2];
        if (r + 1 < un.valid) o[(long long)(r + 1) * a.N] = silu(acc[4 * i + 1]) * acc[4 * i + 3];
      }
    } else {
      float* o = a.out + (long long)un.row0 * a.N + un.n0 + 64 * c + 16 * w + 2 * g;
#pragma unroll
      for (int i = 0; i < BT / 8; ++i) {
        const int r = 8 * i + 2 * t;
        if (r < un.valid) {
          const float s = a.gates[un.row0 + r];
          *reinterpret_cast<float2*>(o + (long long)r * a.N) =
              make_float2(s * acc[4 * i], s * acc[4 * i + 2]);
        }
        if (r + 1 < un.valid) {
          const float s = a.gates[un.row0 + r + 1];
          *reinterpret_cast<float2*>(o + (long long)(r + 1) * a.N) =
              make_float2(s * acc[4 * i + 1], s * acc[4 * i + 3]);
        }
      }
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
cudaError_t launch_gemm(const CUtensorMap& m0, const CUtensorMap& m1, const MoeArgs& a, int grid,
                        cudaStream_t stream) {
  const size_t smem = moe_smem_bytes(a.held);
  cudaError_t err = cudaFuncSetAttribute(moe_gemm_kernel<GATED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  moe_gemm_kernel<GATED><<<grid, MG_THREADS, smem, stream>>>(m0, m1, a);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface, float32.  x (T, D); tok, gates (T K,) sorted by expert;
// offsets (held + 1,); pos (T, K); w_gate, w_up (held, D, F); w_down (held,
// F, D), all contiguous, x and the weights on 16-byte boundaries; h (T K, F)
// and o (T K, D) scratch; y (T, D) out.  grid: the persistent blocks of
// each product (the card's SMs).
// Returns a cudaError_t (0 = launched); cudaErrorInvalidValue for a
// width (D a multiple of 128, F of 64), an alignment or a count of held
// experts (1 .. 1024) the kernel does not take.
// ---------------------------------------------------------------------------

extern "C" int repro_moe_experts(int T, int D, int F, int K, int held, int grid,
                                 const float* x, const int* tok, const int* offsets,
                                 const float* gates, const int* pos, const float* w_gate,
                                 const float* w_up, const float* w_down, float* h, float* o,
                                 float* y, void* stream) {
  if (T < 1 || K < 1 || held < 1 || held > MG_MAX_HELD || grid < 1 || D < 128 || D % 128 ||
      F < 64 || F % 64 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w_gate) |
       reinterpret_cast<uintptr_t>(w_up) | reinterpret_cast<uintptr_t>(w_down)) % 16)
    return cudaErrorInvalidValue;
  CUtensorMap maps[3];  // W_gate, W_up over (held D, F); W_down over (held F, D)
  if (!make_map(maps, w_gate, (long long)held * D, F, MG_BK) ||
      !make_map(maps + 1, w_up, (long long)held * D, F, MG_BK) ||
      !make_map(maps + 2, w_down, (long long)held * F, D, MG_BK))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MoeArgs up{x, tok, offsets, nullptr, h, D, F, held, F / 64};
  const MoeArgs down{h, nullptr, offsets, gates, o, F, D, held, D / 128};
  cudaError_t err = launch_gemm<true>(maps[0], maps[1], up, grid, st);
  if (err == cudaSuccess) err = launch_gemm<false>(maps[2], maps[2], down, grid, st);
  if (err != cudaSuccess) return err;
  const dim3 grid_c((D / 4 + MG_COMBINE_THREADS - 1) / MG_COMBINE_THREADS, T);
  moe_combine_kernel<<<grid_c, MG_COMBINE_THREADS, 0, st>>>(o, pos, offsets + held, y, K, D);
  return cudaGetLastError();
}
