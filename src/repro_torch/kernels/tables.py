"""The simulator's bulk latency-table build on Hopper: wrapper of ``tables_kernel``.

Replaces the JAX package's jitted XLA program
``repro.serving.physics_jax._tables_jit``, the twin of
``physics.device_state_arrays`` that the vec engine's
``_build_tables_bulk`` evaluates once per chunk: for ``R`` rows of ``n``
co-located entries, the over-subscription shrink and thrash, the solo
terms, cache utilisation and power, the two row sums, the power-cap
frequency and the bandwidth-knee inflation.  It returns the five
quantities a latency table stores: t_load, t_sched, t_act and t_feedback
as (R, n), freq as (R,).

The inputs travel as ONE float64 tensor (the hardware's and the width's
``SCALARS``, then the eight (R, n) ``PLANES``;
`repro_torch.serving.physics_torch.pack` fills it) and the outputs as one
(``OUTPUTS`` planes, then freq), so a chunk costs one copy to the card and
one back.  On a CUDA tensor ``tables`` launches the CUDA kernel in
``csrc/physics.cu`` (one thread per row, float64); on a CPU tensor it runs
``tables_plain``, the same steps in float64 torch over every row at once.
There is no other path.  Both keep numpy's float operations and their
order; the two powers are the device's ``pow``, not glibc's, so the
contract is the reference's for its JAX twin: rtol 1e-6, atol 1e-9.

``tables.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.grant_loop import np_rowsum, true_div

# The order of csrc/physics.cu's Scalar.  Products of Python floats that
# numpy's expressions form before they meet an array (peak_flops *
# mxu_efficiency, power_cap * ACTIVE_W_SCALE, 0.6 * max_freq, the width's
# dispatch factor) are formed on the host, as numpy forms them.
SCALARS = ("pcie_bw", "peak_eff", "hbm_bw", "power_scale", "idle_power",
           "power_cap", "max_freq", "alpha_f", "freq_floor", "sched_scale",
           "bw_knee", "bw_exp", "freq_exp")
# (R, n) input planes, the arguments of physics.device_state_arrays
PLANES = ("d_load", "d_fb", "flops_i", "w_bytes", "a_bytes", "n_kern", "b", "r")
# (R, n) output planes; freq (R,) follows them
OUTPUTS = ("t_load", "t_sched", "t_act", "t_feedback")
CAPACITY = 16        # the widest row the kernel is built for


def pack_size(rows: int, n: int) -> int:
    return len(SCALARS) + len(PLANES) * rows * n


def out_size(rows: int, n: int) -> int:
    return len(OUTPUTS) * rows * n + rows


def split_out(out, rows: int, n: int):
    """(t_load, t_sched, t_act, t_feedback) as (rows, n) and freq (rows,):
    views of an output tensor or array."""
    rn = rows * n
    planes = out[:len(OUTPUTS) * rn].reshape(len(OUTPUTS), rows, n)
    return (*planes, out[len(OUTPUTS) * rn:])


def _validate(packed, rows, n):
    if packed.dtype != torch.float64 or packed.dim() != 1:
        raise ValueError("tables: the packed inputs are one float64 vector")
    if rows < 1 or n < 1 or packed.numel() != pack_size(rows, n):
        raise ValueError(f"tables: {packed.numel()} values do not pack "
                         f"{rows} rows of n = {n}")


def tables_plain(packed: torch.Tensor, rows: int, n: int) -> torch.Tensor:
    """The table build in float64 torch, statement for statement as
    ``physics.device_state_arrays``, over every row at once.  Returns the
    packed output (see ``split_out``)."""
    s = dict(zip(SCALARS, packed[:len(SCALARS)].tolist()))
    p = dict(zip(PLANES, packed[len(SCALARS):].view(len(PLANES), rows, n)))
    b, r, n_kern = p["b"], p["r"], p["n_kern"]

    total_r = np_rowsum(r)
    shrink = torch.clamp(total_r, min=1.0)
    thrash = 1.0 + 0.6 * torch.clamp(total_r - 1.0, min=0.0)
    r = r / shrink[:, None]

    t_load = true_div(p["d_load"] * b, s["pcie_bw"])
    t_feedback = true_div(p["d_fb"] * b, s["pcie_bw"])
    flops = p["flops_i"] * b
    flops = flops * (1.0 + 0.004 * b)
    bytes_ = p["w_bytes"] + p["a_bytes"] * b
    t_compute = true_div(flops, s["peak_eff"]) * 1e3
    t_mem = true_div(bytes_, s["hbm_bw"]) * 1e3
    r_eff = torch.clamp(r, min=1e-3)
    t_c = t_compute / r_eff
    t_m = t_mem / r_eff
    t_act_solo = torch.maximum(t_c, t_m) + 0.35 * torch.minimum(t_c, t_m) + 0.05
    cache_util = torch.clamp(true_div(bytes_ / (t_act_solo * 1e-3), s["hbm_bw"]),
                             max=1.0)
    util = t_c / t_act_solo
    power = s["power_scale"] * r_eff * (0.35 + 0.65 * util)
    per_kernel = 0.002 + 5e-6 * n_kern

    total_bw = np_rowsum(cache_util)
    device_power = s["idle_power"] + np_rowsum(power)
    excess = torch.clamp(device_power - s["power_cap"], min=0.0)
    freq = torch.where(device_power <= s["power_cap"], s["max_freq"],
                       torch.clamp(s["max_freq"] + s["alpha_f"]
                                   * torch.pow(excess, s["freq_exp"]),
                                   min=s["freq_floor"]))

    per_kernel = per_kernel * s["sched_scale"]
    t_sched = per_kernel * n_kern
    infl = torch.where(total_bw > s["bw_knee"],
                       torch.pow(true_div(total_bw, s["bw_knee"]), s["bw_exp"]), 1.0)
    t_m_infl = t_m * infl[:, None]
    t_act = (torch.maximum(t_c, t_m_infl) + 0.35 * torch.minimum(t_c, t_m_infl)
             + 0.05) * thrash[:, None]
    return torch.cat([t_load.reshape(-1), t_sched.reshape(-1), t_act.reshape(-1),
                      t_feedback.reshape(-1), freq])


def tables(packed: torch.Tensor, rows: int, n: int) -> torch.Tensor:
    """The latency-table values of ``rows`` rows of ``n`` <= CAPACITY
    co-located entries.  ``packed``: the float64 inputs in SCALARS, PLANES order, on
    the CPU or a card.  Returns the float64 outputs on the same device:
    t_load, t_sched, t_act, t_feedback (rows, n), then freq (rows,)."""
    _validate(packed, rows, n)
    if n > CAPACITY:       # on every device, so the CPU runs what the card can
        raise ValueError(f"tables: co-location width n = {n} is above the "
                         f"kernel's capacity of {CAPACITY}")
    if packed.device.type == "cpu":
        return tables_plain(packed, rows, n)
    if packed.device.type != "cuda":
        raise ValueError(f"tables: unsupported device {packed.device}")
    packed = packed.contiguous()
    lib = _build.load()
    out = torch.empty(out_size(rows, n), dtype=torch.float64, device=packed.device)
    with torch.cuda.device(packed.device):
        err = lib.repro_tables(packed.data_ptr(), out.data_ptr(), rows, n,
                               torch.cuda.current_stream().cuda_stream)
    _build.check(err, "tables")
    tables.launches += 1
    return out


tables.launches = 0
