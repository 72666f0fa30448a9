// Algorithm 2 of iGniter for one newcomer against every open device, in one
// launch: alloc_all_kernel.
//
// Replaces the JAX package's jitted XLA program
// src/repro/core/perf_model_jax.py::_alloc_all_jit (a lax.while_loop over
// every device row), the accelerator half of VecCluster.alloc_all
// (src/repro/core/perf_model_vec.py, the numpy loop it mirrors).  Each
// iteration grants +r_unit to every resident and to the newcomer whose
// predicted t_inf (Eqs. 1-11 from the cached solo invariants) exceeds its
// budget by more than 1e-9; a row leaves the loop when it converges, or
// when its total passes R_MAX + 1e-9, and is then infeasible.
//
// Design: rows never interact (each reads only its own power and cache
// sums), so one thread runs one device row's whole loop in float64
// registers, the statements in the numpy loop's order.  Blocks of 128
// threads, ceil(d / 128) of them; N, the cluster's resident capacity, is a
// template parameter so a row's state is held in registers.
//
// Bound: a call moves its packed inputs (21 (d, N) planes, 3 (d,) rows and
// 24 scalars) and its outputs once: about 0.5 MB at d = 766, N = 4, some
// 0.15 us at 3.35 TB/s; the float64 work is a few hundred operations a
// row and iteration.  The launch latency (microseconds) and the longest
// row's chain of dependent divisions set the real floor.  Making it fast is
// left for later: the loop is a small share of a placement, whose packing
// and two copies run on the host.
//
// Numerics, for decisions and grid points identical to numpy:
//  * this file is compiled with --fmad=false (kernels/_build.py): nvcc
//    would otherwise fuse a*b + c into one rounding, which numpy never does;
//  * the grid snap np.round(x, 10) is rint(x * 1e10) / 1e10 with an IEEE
//    division (rint rounds half to even, as numpy does);
//  * row sums over the N columns follow numpy's pairwise summation, and
//    the grant deltas are accumulated column by column, in
//    np.subtract.at's order.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

// Packed input: SCALARS, then the (d, N) planes, then the (d,) rows; the
// order is kernels/grant_loop.py's SCALARS, PLANES and ROWS.
enum Scalar {
  S_K1, S_K2, S_K3, S_K4, S_K5, S_ALPHA_POWER, S_BETA_POWER, S_ALPHA_CACHEUTIL,
  S_BETA_CACHEUTIL, S_ALPHA_CACHE, S_N_KERNELS, S_BATCH, S_R_LOWER, S_BUDGET,
  S_T_LOAD, S_T_FEEDBACK, S_T_SCHK, S_IDLE_POWER, S_POWER_CAP, S_MAX_FREQ,
  S_ALPHA_F, S_ALPHA_SCH, S_BETA_SCH, S_R_UNIT, N_SCALARS
};
enum Plane {
  P_MASK, P_B, P_R, P_BUDGET, P_K_ACT, P_POWER, P_CACHE, P_T_SCHK, P_T_LOAD,
  P_T_FEEDBACK, P_K1, P_K2, P_K3, P_K4, P_K5, P_N_KERNELS, P_ALPHA_POWER,
  P_BETA_POWER, P_ALPHA_CACHEUTIL, P_BETA_CACHEUTIL, P_ALPHA_CACHE, N_PLANES
};
enum Row { W_N, W_POWER_SUM, W_CACHE_SUM, N_ROWS };

constexpr double R_MAX = 1.0;
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

// np.round(x, 10)
__device__ __forceinline__ double snap(double x) { return rint(x * 1e10) / 1e10; }

template <int N>
__global__ void __launch_bounds__(BLOCK)
alloc_all_kernel(const double* __restrict__ in, double* __restrict__ out, int d) {
  const int q = blockIdx.x * BLOCK + threadIdx.x;
  if (q >= d) return;
  const double* s = in;
  const size_t dn = static_cast<size_t>(d) * N;
  const double* row = in + N_SCALARS + static_cast<size_t>(q) * N;
  auto plane = [&](int p, int c) { return row[p * dn + c]; };
  const double* rows = in + N_SCALARS + N_PLANES * dn;

  // the newcomer's solo invariants at allocation rn (Eq. 11, power, cache)
  const double bn = s[S_BATCH];
  const double gamma_n = s[S_K1] * bn * bn + s[S_K2] * bn + s[S_K3];
  auto solo_new = [&](double rn, double& k_act, double& p, double& c) {
    k_act = gamma_n / (rn + s[S_K4]) + s[S_K5];
    const double ability = bn / k_act;
    p = s[S_ALPHA_POWER] * ability + s[S_BETA_POWER];
    c = s[S_ALPHA_CACHEUTIL] * ability + s[S_BETA_CACHEUTIL];
  };

  bool m[N];
  double rr[N], ka[N], pw[N], cu[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    m[c] = plane(P_MASK, c) != 0.0;
    rr[c] = plane(P_R, c);
    ka[c] = plane(P_K_ACT, c);
    pw[c] = plane(P_POWER, c);
    cu[c] = plane(P_CACHE, c);
  }
  const double r_lower = s[S_R_LOWER];
  double rn = r_lower, kan, pn, cn;
  solo_new(rn, kan, pn, cn);
  double p_sum = rows[W_POWER_SUM * d + q] + pn;
  double c_sum = rows[W_CACHE_SUM * d + q] + cn;
  const double n_co = rows[W_N * d + q] + 1.0;
  const double ds = n_co <= 1.0 ? 0.0 : s[S_ALPHA_SCH] * n_co + s[S_BETA_SCH];  // Eq. 6
  const double max_freq = s[S_MAX_FREQ], power_cap = s[S_POWER_CAP];
  const double freq_floor = 0.3 * max_freq;
  const double r_unit = s[S_R_UNIT];

  bool feasible = true;
  for (;;) {
    double held[N];
#pragma unroll
    for (int c = 0; c < N; ++c) held[c] = m[c] ? rr[c] : 0.0;
    if (np_sum<N>(held) + rn > R_MAX + 1e-9) {  // loop-top capacity check
      feasible = false;
      break;
    }
    const double p_dem = s[S_IDLE_POWER] + p_sum;                          // Eq. 10
    const double freq = p_dem <= power_cap                                 // Eq. 9
                            ? max_freq
                            : fmax(max_freq + s[S_ALPHA_F] * (p_dem - power_cap), freq_floor);
    const double slow = freq / max_freq;
    bool viol[N], any = false;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      const double other = c_sum - cu[c];
      const double t_act = ka[c] * (1.0 + plane(P_ALPHA_CACHE, c) * other);  // Eq. 8
      const double t_sch = plane(P_T_SCHK, c) + ds * plane(P_N_KERNELS, c);   // Eq. 5
      const double t_gpu = (t_sch + t_act) / slow;                           // Eq. 4
      const double t_inf = plane(P_T_LOAD, c) + t_gpu + plane(P_T_FEEDBACK, c);  // Eq. 1
      viol[c] = m[c] && t_inf > plane(P_BUDGET, c) + 1e-9;
      any = any || viol[c];
    }
    const double t_act_n = kan * (1.0 + s[S_ALPHA_CACHE] * (c_sum - cn));
    const double t_gpu_n = (s[S_T_SCHK] + ds * s[S_N_KERNELS] + t_act_n) / slow;
    const double t_inf_n = s[S_T_LOAD] + t_gpu_n + s[S_T_FEEDBACK];
    const bool viol_new = t_inf_n > s[S_BUDGET] + 1e-9;
    if (!any && !viol_new) break;                                          // converged

    // grants: +r_unit to every violator, residents first, column by column
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (!viol[c]) continue;
      rr[c] = snap(rr[c] + r_unit);
      const double b = plane(P_B, c);
      const double k_act = (plane(P_K1, c) * b * b + plane(P_K2, c) * b + plane(P_K3, c))
                               / (rr[c] + plane(P_K4, c)) + plane(P_K5, c);
      const double ability = b / k_act;
      const double p_new = plane(P_ALPHA_POWER, c) * ability + plane(P_BETA_POWER, c);
      const double c_new = plane(P_ALPHA_CACHEUTIL, c) * ability + plane(P_BETA_CACHEUTIL, c);
      p_sum = p_sum - (pw[c] - p_new);
      c_sum = c_sum - (cu[c] - c_new);
      ka[c] = k_act;
      pw[c] = p_new;
      cu[c] = c_new;
    }
    if (viol_new) {
      rn = snap(rn + r_unit);
      double k_act, p_new, c_new;
      solo_new(rn, k_act, p_new, c_new);
      p_sum = p_sum + (p_new - pn);
      c_sum = c_sum + (c_new - cn);
      kan = k_act;
      pn = p_new;
      cn = c_new;
    }
  }

  // Alg. 1 line 8: the extra resources the interference caused
  double grown[N];
#pragma unroll
  for (int c = 0; c < N; ++c) {
    grown[c] = m[c] ? fmax(0.0, rr[c] - plane(P_R, c)) : 0.0;
    out[static_cast<size_t>(q) * N + c] = rr[c];
  }
  const double r_inter = np_sum<N>(grown) + fmax(0.0, rn - r_lower);
  out[dn + q] = rn;
  out[dn + d + q] = feasible ? r_inter : INFINITY;
  out[dn + 2 * static_cast<size_t>(d) + q] = feasible ? 1.0 : 0.0;
}

template <int N>
int launch(const double* in, double* out, int d, cudaStream_t stream) {
  alloc_all_kernel<N><<<(d + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(in, out, d);
  return cudaGetLastError();
}

}  // namespace

// in: the packed inputs (kernels/grant_loop.py: pack layout); out: rr (d, n),
// then rn, r_inter and feasible (d each), all float64 on the device.
extern "C" int repro_alloc_all(const double* in, double* out, int d, int n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 1) return cudaErrorInvalidValue;
  switch (n) {
    case 1: return launch<1>(in, out, d, st);
    case 2: return launch<2>(in, out, d, st);
    case 4: return launch<4>(in, out, d, st);
    case 8: return launch<8>(in, out, d, st);
    case 16: return launch<16>(in, out, d, st);
    case 32: return launch<32>(in, out, d, st);
    default: return cudaErrorInvalidValue;
  }
}
