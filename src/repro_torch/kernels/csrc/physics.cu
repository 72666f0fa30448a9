// The simulator's bulk latency-table build, in one launch per chunk:
// tables_kernel.
//
// Replaces the JAX package's jitted XLA program
// src/repro/serving/physics_jax.py::_tables_jit, the twin of
// physics.device_state_arrays (src/repro/serving/physics.py, the numpy
// oracle it mirrors) that the vec engine's _build_tables_bulk evaluates
// once per chunk of latency-table rows.  Each row holds n co-located
// entries; the steps are the reference's, in its order: the
// over-subscription shrink and thrash, the solo terms, cache utilisation
// and power, the two row sums, the power-cap frequency, the bandwidth-knee
// inflation and t_act.
//
// Design: rows never interact, so one thread computes one row with its n
// entries in float64 registers.  Blocks of 128 threads, ceil(R / 128) of
// them.  n is a runtime argument dispatched to a template instantiation for
// each width up to CAPACITY = 16 (the m = 1000 plan uses widths 1 and 2), so
// a row's arrays are held in registers; a wider n is refused.
//
// Bound: per element 8 float64 inputs and 4 outputs (96 B), plus 8 B of
// freq per row; about 40 float64 operations an element.  At a full
// _BULK_CHUNK (2^19 elements) that is 50.3 MB, 15.0 us at 3.35 TB/s, against
// 0.6 us of float64 work: the kernel is bound by bytes.  At the sizes a
// simulation builds (thousands of rows) the launch latency is the floor.
// Making it fast is left for later: the build is a small share of a
// simulation, whose pass recurrence runs on the host.
//
// Numerics, for results as close to numpy as the device allows:
//  * this file is compiled with --fmad=false (kernels/_build.py): nvcc would
//    otherwise fuse a*b + c into one rounding, which numpy never does;
//  * every add, multiply, divide, min and max is IEEE, in numpy's order, and
//    the products of Python floats numpy forms before they meet an array
//    (peak_flops * mxu_efficiency, ...) come formed from the host;
//  * the row sums follow numpy's pairwise summation;
//  * the two powers (excess ** FREQ_EXP, (total_bw / BW_KNEE) ** BW_EXP) are
//    CUDA's pow, within 2 ulp of glibc's: hence the reference's tolerance for
//    its JAX twin, rtol 1e-6 and atol 1e-9.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

// Packed input: SCALARS, then the (R, n) planes; the order is
// kernels/tables.py's SCALARS and PLANES.
enum Scalar {
  S_PCIE_BW, S_PEAK_EFF, S_HBM_BW, S_POWER_SCALE, S_IDLE_POWER, S_POWER_CAP,
  S_MAX_FREQ, S_ALPHA_F, S_FREQ_FLOOR, S_SCHED_SCALE, S_BW_KNEE, S_BW_EXP,
  S_FREQ_EXP, N_SCALARS
};
enum Plane { P_D_LOAD, P_D_FB, P_FLOPS_I, P_W_BYTES, P_A_BYTES, P_N_KERN, P_B, P_R, N_PLANES };
// Packed output: the (R, n) planes t_load, t_sched, t_act, t_feedback, then freq (R,).
enum Output { O_T_LOAD, O_T_SCHED, O_T_ACT, O_T_FEEDBACK, N_OUTPUTS };

constexpr int BLOCK = 128;

// numpy's pairwise_sum for n <= 128 (PW_BLOCKSIZE): a plain loop from 0
// below 8 elements, else eight running sums combined as a tree.
template <int N>
__device__ __forceinline__ double np_sum(const double (&a)[N]) {
  if constexpr (N < 8) {
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < N; ++i) s += a[i];
    return s;
  } else {
    static_assert(N <= 128, "numpy sums longer rows recursively");
    double r[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = a[j];
    int i = 8;
#pragma unroll
    for (; i < N - N % 8; i += 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) r[j] += a[i + j];
    }
    double s = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
#pragma unroll
    for (; i < N; ++i) s += a[i];
    return s;
  }
}

template <int N>
__global__ void __launch_bounds__(BLOCK)
tables_kernel(const double* __restrict__ in, double* __restrict__ out, int rows) {
  const int q = blockIdx.x * BLOCK + threadIdx.x;
  if (q >= rows) return;
  const double* s = in;
  const size_t rn = static_cast<size_t>(rows) * N;
  const size_t at = static_cast<size_t>(q) * N;
  auto plane = [&](int p, int c) { return in[N_SCALARS + p * rn + at + c]; };
  auto put = [&](int o, int c, double v) { out[o * rn + at + c] = v; };

  // over-subscription: shrink every share by the row's total, and thrash
  double r[N];
#pragma unroll
  for (int c = 0; c < N; ++c) r[c] = plane(P_R, c);
  const double total_r = np_sum<N>(r);
  const double shrink = fmax(1.0, total_r);
  const double thrash = 1.0 + 0.6 * fmax(0.0, total_r - 1.0);

  // solo terms, cache utilisation and power
  const double pcie_bw = s[S_PCIE_BW], hbm_bw = s[S_HBM_BW];
  double t_c[N], t_m[N], cache[N], power[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const double b = plane(P_B, c);
    put(O_T_LOAD, c, plane(P_D_LOAD, c) * b / pcie_bw);
    put(O_T_FEEDBACK, c, plane(P_D_FB, c) * b / pcie_bw);
    double flops = plane(P_FLOPS_I, c) * b;
    flops = flops * (1.0 + 0.004 * b);
    const double bytes = plane(P_W_BYTES, c) + plane(P_A_BYTES, c) * b;
    const double t_compute = flops / s[S_PEAK_EFF] * 1e3;
    const double t_mem = bytes / hbm_bw * 1e3;
    const double r_eff = fmax(r[c] / shrink, 1e-3);
    t_c[c] = t_compute / r_eff;
    t_m[c] = t_mem / r_eff;
    const double t_act_solo = fmax(t_c[c], t_m[c]) + 0.35 * fmin(t_c[c], t_m[c]) + 0.05;
    cache[c] = fmin(1.0, (bytes / (t_act_solo * 1e-3)) / hbm_bw);
    const double util = t_c[c] / t_act_solo;
    power[c] = s[S_POWER_SCALE] * r_eff * (0.35 + 0.65 * util);
    const double n_kern = plane(P_N_KERN, c);
    const double per_kernel = (0.002 + 5e-6 * n_kern) * s[S_SCHED_SCALE];
    put(O_T_SCHED, c, per_kernel * n_kern);
  }

  // the row sums, the power-cap frequency and the bandwidth-knee inflation
  const double total_bw = np_sum<N>(cache);
  const double device_power = s[S_IDLE_POWER] + np_sum<N>(power);
  const double power_cap = s[S_POWER_CAP], max_freq = s[S_MAX_FREQ];
  const double excess = fmax(device_power - power_cap, 0.0);
  out[N_OUTPUTS * rn + q] =
      device_power <= power_cap
          ? max_freq
          : fmax(max_freq + s[S_ALPHA_F] * pow(excess, s[S_FREQ_EXP]), s[S_FREQ_FLOOR]);
  const double infl = total_bw > s[S_BW_KNEE] ? pow(total_bw / s[S_BW_KNEE], s[S_BW_EXP]) : 1.0;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const double t_m_infl = t_m[c] * infl;
    put(O_T_ACT, c, (fmax(t_c[c], t_m_infl) + 0.35 * fmin(t_c[c], t_m_infl) + 0.05) * thrash);
  }
}

template <int N>
int launch(const double* in, double* out, int rows, cudaStream_t stream) {
  tables_kernel<N><<<(rows + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(in, out, rows);
  return cudaGetLastError();
}

}  // namespace

// in: the packed inputs (kernels/tables.py: pack layout); out: t_load,
// t_sched, t_act, t_feedback (rows, n), then freq (rows), all float64 on the
// device.  n from 1 to 16; any other width is refused.
extern "C" int repro_tables(const double* in, double* out, int rows, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1) return cudaErrorInvalidValue;
  switch (n) {
    case 1: return launch<1>(in, out, rows, st);
    case 2: return launch<2>(in, out, rows, st);
    case 3: return launch<3>(in, out, rows, st);
    case 4: return launch<4>(in, out, rows, st);
    case 5: return launch<5>(in, out, rows, st);
    case 6: return launch<6>(in, out, rows, st);
    case 7: return launch<7>(in, out, rows, st);
    case 8: return launch<8>(in, out, rows, st);
    case 9: return launch<9>(in, out, rows, st);
    case 10: return launch<10>(in, out, rows, st);
    case 11: return launch<11>(in, out, rows, st);
    case 12: return launch<12>(in, out, rows, st);
    case 13: return launch<13>(in, out, rows, st);
    case 14: return launch<14>(in, out, rows, st);
    case 15: return launch<15>(in, out, rows, st);
    case 16: return launch<16>(in, out, rows, st);
    default: return cudaErrorInvalidValue;
  }
}
