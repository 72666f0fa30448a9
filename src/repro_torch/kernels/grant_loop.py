"""Algorithm 2's grant loop on Hopper: wrapper of ``alloc_all_kernel``.

Replaces the JAX package's jitted XLA program
``repro.core.perf_model_jax._alloc_all_jit``, the ``lax.while_loop`` that
runs Alg. 2 for one newcomer against every open device: each iteration
grants +r_unit to every resident and newcomer whose predicted t_inf
exceeds its budget by more than 1e-9; a row leaves when it converges or
when its total passes R_MAX + 1e-9 (infeasible).

The inputs travel as ONE float64 tensor (the newcomer's and the
hardware's ``SCALARS``, then the (d, N) ``PLANES`` of the cluster's state,
then its (d,) ``ROWS``; `core.perf_model_torch.pack` fills it from a
``VecCluster``) and the outputs as one, so a call costs one copy to the
card and one back.  On a CUDA tensor ``alloc_all`` launches the CUDA kernel
in ``csrc/planner.cu`` (one thread per device row, float64); on a CPU
tensor it runs ``alloc_all_plain``, the same loop in float64 torch over
every row at once.  There is no other path.  Both keep numpy's float
operations and their order, so they land on the numpy loop's grid points.

``alloc_all.launches`` counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

R_MAX = 1.0

# The newcomer's coefficients, batch, lower bound, budget and static latency
# terms, then the hardware's scalars (the order of csrc/planner.cu's Scalar).
SCALARS = ("k1", "k2", "k3", "k4", "k5", "alpha_power", "beta_power",
           "alpha_cacheutil", "beta_cacheutil", "alpha_cache", "n_kernels",
           "batch", "r_lower", "budget", "t_load", "t_feedback", "t_schk",
           "idle_power", "power_cap", "max_freq", "alpha_f", "alpha_sch",
           "beta_sch", "r_unit")
# (d, N) planes: the residents' state, cached invariants and coefficients.
PLANES = ("mask", "b", "r", "budget_ms", "k_act", "power", "cache", "t_schk",
          "t_load", "t_feedback", "k1", "k2", "k3", "k4", "k5", "n_kernels",
          "alpha_power", "beta_power", "alpha_cacheutil", "beta_cacheutil",
          "alpha_cache")
# (d,) rows: resident count and the solo power and cache sums.
ROWS = ("n", "power_sum", "cache_sum")
KERNEL_N = (1, 2, 4, 8, 16, 32)      # resident capacities the kernel is built for


def pack_size(d: int, n: int) -> int:
    return len(SCALARS) + len(PLANES) * d * n + len(ROWS) * d


def out_size(d: int, n: int) -> int:
    return d * n + 3 * d


def unpack(packed: torch.Tensor, d: int, n: int):
    """Views of a packed input: ({scalar: float}, {plane: (d, n)}, {row: (d,)})."""
    ns, dn = len(SCALARS), d * n
    planes = packed[ns:ns + len(PLANES) * dn].view(len(PLANES), d, n)
    rows = packed[ns + len(PLANES) * dn:].view(len(ROWS), d)
    scal = dict(zip(SCALARS, packed[:ns].tolist()))
    return scal, dict(zip(PLANES, planes)), dict(zip(ROWS, rows))


def split_out(out, d: int, n: int):
    """(feasible (d,) bool, rr (d, n), rn (d,), r_inter (d,)) views of an
    output tensor or array."""
    dn = d * n
    rr = out[:dn].reshape(d, n)
    return out[dn + 2 * d:] != 0, rr, out[dn:dn + d], out[dn + d:dn + 2 * d]


def _validate(packed, d, n):
    if packed.dtype != torch.float64 or packed.dim() != 1:
        raise ValueError("alloc_all: the packed inputs are one float64 vector")
    if d < 1 or n < 1 or packed.numel() != pack_size(d, n):
        raise ValueError(f"alloc_all: {packed.numel()} values do not pack "
                         f"d = {d} rows of n = {n}")


def np_rowsum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of a (d, n) tensor in numpy's order (pairwise_sum: a plain
    loop from 0 below 8 columns, else eight running sums and a tree, and
    halves above 128), so the plain version matches numpy bit for bit."""
    n = x.shape[1]
    if n < 8:
        s = torch.zeros_like(x[:, 0])
        for i in range(n):
            s = s + x[:, i]
        return s
    if n > 128:
        h = n // 2
        h -= h % 8
        return np_rowsum(x[:, :h]) + np_rowsum(x[:, h:])
    r = [x[:, j] for j in range(8)]
    i = 8
    while i < n - n % 8:
        r = [r[j] + x[:, i + j] for j in range(8)]
        i += 8
    s = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    for k in range(i, n):
        s = s + x[:, k]
    return s


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b with an IEEE division on every device.  PyTorch's CUDA division
    by a CPU scalar multiplies by the scalar's reciprocal instead, one
    rounding more (``div_true_kernel_cuda``): the grid points and the
    frequency ratio then land an ulp off numpy's.  So b goes over as a
    0-dim tensor on a's device."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def _snap(x):
    """np.round(x, 10): rint(x * 1e10) / 1e10 with an IEEE division
    (torch.round rounds half to even, as numpy's rint)."""
    return true_div(torch.round(x * 1e10), 1e10)


def alloc_all_plain(packed: torch.Tensor, d: int, n: int) -> torch.Tensor:
    """The grant loop in float64 torch, statement for statement as
    ``_alloc_all_jit``: every row every iteration, while a row is active.
    Returns the packed output (see ``split_out``)."""
    s, p, w = unpack(packed, d, n)
    mask = p["mask"] != 0
    bn, r_lower = s["batch"], s["r_lower"]
    gamma_n = s["k1"] * bn * bn + s["k2"] * bn + s["k3"]

    def solo_new(rn):
        k_act = gamma_n / (rn + s["k4"]) + s["k5"]
        ability = bn / k_act
        return (k_act, s["alpha_power"] * ability + s["beta_power"],
                s["alpha_cacheutil"] * ability + s["beta_cacheutil"])

    rr, ka, pw, cu = (p[k].clone() for k in ("r", "k_act", "power", "cache"))
    rn = torch.full_like(w["n"], r_lower)
    kan, pn, cn = solo_new(rn)
    p_sum = w["power_sum"] + pn
    c_sum = w["cache_sum"] + cn
    n_co = w["n"] + 1.0
    ds = torch.where(n_co <= 1.0, 0.0, s["alpha_sch"] * n_co + s["beta_sch"])
    max_freq, cap = s["max_freq"], s["power_cap"]
    active = torch.ones(d, dtype=torch.bool, device=packed.device)
    feasible = torch.ones_like(active)
    while active.any():
        tot = np_rowsum(torch.where(mask, rr, 0.0)) + rn
        over = active & (tot > R_MAX + 1e-9)
        feasible = feasible & ~over
        act = active & ~over

        p_dem = s["idle_power"] + p_sum                              # Eq. 10
        freq = torch.where(p_dem <= cap, max_freq,                   # Eq. 9
                           torch.clamp(max_freq + s["alpha_f"] * (p_dem - cap),
                                       min=0.3 * max_freq))
        slow = true_div(freq, max_freq)
        other_res = c_sum[:, None] - cu
        t_act = ka * (1.0 + p["alpha_cache"] * other_res)
        t_sch = p["t_schk"] + ds[:, None] * p["n_kernels"]
        t_gpu = (t_sch + t_act) / slow[:, None]
        t_inf = p["t_load"] + t_gpu + p["t_feedback"]
        viol_res = mask & (t_inf > p["budget_ms"] + 1e-9) & act[:, None]

        t_act_n = kan * (1.0 + s["alpha_cache"] * (c_sum - cn))
        t_gpu_n = (s["t_schk"] + ds * s["n_kernels"] + t_act_n) / slow
        t_inf_n = s["t_load"] + t_gpu_n + s["t_feedback"]
        viol_new = (t_inf_n > s["budget"] + 1e-9) & act

        conv = act & ~viol_res.any(dim=1) & ~viol_new
        active = act & ~conv

        # grants: +r_unit to every violator on still-active rows; the sums
        # take the deltas column by column, in np.subtract.at's order
        grow = viol_res & active[:, None]
        rr = torch.where(grow, _snap(rr + s["r_unit"]), rr)
        k_act_g = ((p["k1"] * p["b"] * p["b"] + p["k2"] * p["b"] + p["k3"])
                   / (rr + p["k4"]) + p["k5"])
        ability = p["b"] / k_act_g
        p_g = p["alpha_power"] * ability + p["beta_power"]
        c_g = p["alpha_cacheutil"] * ability + p["beta_cacheutil"]
        for c in range(n):
            g = grow[:, c]
            p_sum = torch.where(g, p_sum - (pw[:, c] - p_g[:, c]), p_sum)
            c_sum = torch.where(g, c_sum - (cu[:, c] - c_g[:, c]), c_sum)
        ka = torch.where(grow, k_act_g, ka)
        pw = torch.where(grow, p_g, pw)
        cu = torch.where(grow, c_g, cu)

        grow_n = viol_new & active
        rn = torch.where(grow_n, _snap(rn + s["r_unit"]), rn)
        kan_g, pn_g, cn_g = solo_new(rn)
        p_sum = torch.where(grow_n, p_sum + (pn_g - pn), p_sum)
        c_sum = torch.where(grow_n, c_sum + (cn_g - cn), c_sum)
        kan = torch.where(grow_n, kan_g, kan)
        pn = torch.where(grow_n, pn_g, pn)
        cn = torch.where(grow_n, cn_g, cn)

    grown = torch.where(mask, torch.clamp(rr - p["r"], min=0.0), 0.0)
    r_inter = np_rowsum(grown) + torch.clamp(rn - r_lower, min=0.0)
    r_inter = torch.where(feasible, r_inter, math.inf)
    return torch.cat([rr.reshape(-1), rn, r_inter, feasible.to(torch.float64)])


def alloc_all(packed: torch.Tensor, d: int, n: int) -> torch.Tensor:
    """Alg. 2 for one newcomer against d device rows of n resident slots.
    ``packed``: the float64 inputs in SCALARS, PLANES, ROWS order, on the
    CPU or a card, with r_unit >= 1e-9 (`core.perf_model_torch.pack`
    checks it: the 1e-10 grid snap would swallow a finer grant and the
    loop would never end).  Returns the float64 outputs on the same device: rr (d, n),
    then rn, r_inter (+inf where infeasible) and feasible (1.0 / 0.0)."""
    _validate(packed, d, n)
    if packed.device.type == "cpu":
        return alloc_all_plain(packed, d, n)
    if packed.device.type != "cuda":
        raise ValueError(f"alloc_all: unsupported device {packed.device}")
    if n not in KERNEL_N:
        raise ValueError(f"alloc_all: no kernel for {n} resident slots "
                         f"(built for {KERNEL_N})")
    packed = packed.contiguous()
    lib = _build.load()
    out = torch.empty(out_size(d, n), dtype=torch.float64, device=packed.device)
    with torch.cuda.device(packed.device):
        err = lib.repro_alloc_all(packed.data_ptr(), out.data_ptr(), d, n,
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(err, "alloc_all")
    alloc_all.launches += 1
    return out


alloc_all.launches = 0
