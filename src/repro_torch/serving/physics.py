"""Ground-truth co-location physics for the cluster simulator.

Deliberately *richer* than the iGniter analytical model (see DESIGN.md):

  * dispatch queueing is mildly super-linear in the co-location count and
    jittered per pass;
  * bandwidth contention saturates (power-law inflation of the memory
    portion once aggregate demand crosses a knee) instead of being linear
    in the summed neighbor utilization;
  * the frequency/power relation has a soft exponent and a floor, plus
    lognormal measurement noise.

The iGniter model (Eqs. 1-11) is fit *against* this physics from 11 solo
profiles — prediction error is therefore a real quantity, as on hardware.
Base per-model quantities (FLOPs, bytes, kernel counts, IO sizes) come
from the real architecture configs via `repro_torch.profiling.metrics`.

A verbatim copy of the JAX package's ``repro.serving.physics``, the
numpy oracle of the latency tables; `repro_torch.serving.physics_torch`
evaluates the same tables on the card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.types import HardwareSpec
from repro_torch.profiling.metrics import ServedModelDesc

BW_KNEE = 0.58        # aggregate bandwidth demand where contention kicks in
BW_EXP = 1.15         # saturation exponent
SCHED_COLOC_SLOPE = 0.65
SCHED_COLOC_EXP = 1.06
FREQ_EXP = 1.05
NOISE_SIGMA = 0.015
ACTIVE_W_SCALE = 1.35  # peak active draw = scale * power_cap (forces
                       # throttling under heavy co-location, cf. Fig. 7)


@dataclass(frozen=True)
class TrueState:
    """Ground-truth instantaneous state of one workload on a device."""
    t_load: float
    t_sched: float
    t_act: float          # after contention, before frequency scaling
    t_feedback: float
    t_gpu: float
    t_inf: float
    power: float          # this workload's draw [W]
    cache_util: float     # solo bandwidth demand fraction
    freq: float           # device frequency [MHz]
    device_power: float


def solo_terms(desc: ServedModelDesc, b: int, r: float, hw: HardwareSpec
               ) -> Tuple[float, float, float, float, float, float, float]:
    """(t_load, k_disp, t_compute, t_mem, power, cache_util, t_feedback)
    solo, no noise.

    Fractional allocation r is an MXU *time share*: both compute and HBM
    streams of this workload only progress during its share.
    """
    t_load = desc.d_load_mb * b / hw.pcie_bw                       # ms
    t_feedback = desc.d_feedback_mb * b / hw.pcie_bw
    flops = desc.flops_per_item * b
    # small super-linear term (attention/batch effects) to keep Eq.11's
    # quadratic honest-but-approximate
    flops *= (1.0 + 0.004 * b)
    bytes_ = desc.weight_bytes + desc.act_bytes_per_item * b
    t_compute = flops / (hw.peak_flops * hw.mxu_efficiency) * 1e3  # ms
    t_mem = bytes_ / hw.hbm_bw * 1e3
    r_eff = max(r, 1e-3)
    t_c = t_compute / r_eff
    t_m = t_mem / r_eff
    t_act = max(t_c, t_m) + 0.35 * min(t_c, t_m) + 0.05            # overlap-ish
    # bandwidth demand while active: bytes over active time
    cache_util = min(1.0, (bytes_ / (t_act * 1e-3)) / hw.hbm_bw)
    # power: active draw proportional to share * utilization
    util = t_c / t_act
    p = hw.power_cap * ACTIVE_W_SCALE * r_eff * (0.35 + 0.65 * util)
    per_kernel = 0.002 + 5e-6 * desc.n_kernels                     # ms/kernel solo
    return t_load, per_kernel, t_c, t_m, p, cache_util, t_feedback


def _pow_stable(x: np.ndarray, e: float) -> np.ndarray:
    """``x ** e`` with libm scalar rounding regardless of array size.

    numpy dispatches large float64 arrays to a SIMD pow whose last-bit
    rounding can differ from the scalar path; the simulator's bitwise
    table-vs-oracle parity requires ONE rounding behavior for every
    shape `device_state_batch` is called with.  The arrays involved are
    tiny (one value per device row), so the Python-level loop is noise.
    """
    x = np.asarray(x, dtype=np.float64)
    flat = np.atleast_1d(x).ravel()
    out = np.array([v ** e for v in flat.tolist()], dtype=np.float64)
    return out.reshape(x.shape)


@dataclass(frozen=True)
class BatchTrueState:
    """Struct-of-arrays `TrueState` over any leading shape.

    Per-workload arrays have shape ``(..., n)`` (n = co-located entries);
    per-device arrays (`freq`, `device_power`) have the leading shape
    ``(...)``.  Mirrors `repro_torch.core.perf_model_vec` style: the serving
    simulator evaluates a whole grid of candidate effective batch sizes
    in one call instead of one `device_state` call per serve event.
    """
    t_load: np.ndarray
    t_sched: np.ndarray
    t_act: np.ndarray          # after contention, before noise
    t_feedback: np.ndarray
    t_gpu: np.ndarray
    t_inf: np.ndarray
    power: np.ndarray
    cache_util: np.ndarray
    freq: np.ndarray           # (...)
    device_power: np.ndarray   # (...)


def device_state_batch(descs: Sequence[ServedModelDesc],
                       b: np.ndarray, r: np.ndarray,
                       hw: HardwareSpec) -> BatchTrueState:
    """Ground truth for a full co-location state, batched.

    ``descs`` lists the n co-located workloads; ``b`` and ``r`` are
    arrays broadcastable to ``(..., n)`` — e.g. a ``(K, n)`` grid whose
    rows vary one workload's batch while the peers stay fixed.  Noise is
    NOT applied here: callers sample multipliers on `t_act`/`t_sched`
    (see `simulator._noisy_t_inf`).  `device_state` is a thin wrapper
    over this function, so scalar and batched paths agree bitwise.
    """
    n = len(descs)
    # stacked per-desc constants, shape (n,) broadcasting against (..., n)
    d_load = np.array([d.d_load_mb for d in descs])
    d_fb = np.array([d.d_feedback_mb for d in descs])
    flops_i = np.array([d.flops_per_item for d in descs])
    w_bytes = np.array([d.weight_bytes for d in descs])
    a_bytes = np.array([d.act_bytes_per_item for d in descs])
    n_kern = np.array([float(d.n_kernels) for d in descs])
    return device_state_arrays(d_load, d_fb, flops_i, w_bytes, a_bytes,
                               n_kern, b, r, n, hw)


def device_state_arrays(d_load: np.ndarray, d_fb: np.ndarray,
                        flops_i: np.ndarray, w_bytes: np.ndarray,
                        a_bytes: np.ndarray, n_kern: np.ndarray,
                        b: np.ndarray, r: np.ndarray,
                        n_co: int, hw: HardwareSpec) -> BatchTrueState:
    """`device_state_batch` on pre-stacked per-entry constants.

    The per-desc constants may carry any shape broadcastable to
    ``(..., n_co)`` — in particular ``(R, n_co)`` rows drawn from
    DIFFERENT devices, which is what lets the simulator build every
    latency table of one co-location width in one call
    (`simulator._build_tables_bulk`).  ``n_co`` is the Python-int
    co-location count: every reduction here runs over a last axis of
    exactly that width, so a multi-device bulk call is bitwise-identical
    to the per-device calls it replaces (same summation grouping, and
    `_pow_stable` is shape-independent by construction).
    """
    n = int(n_co)
    b = np.asarray(b, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)
    b, r = np.broadcast_arrays(b, r)

    # over-subscription: if Sum r > 1 the scheduler time-slices everyone
    # down proportionally AND pays context-thrash overhead (the long-tail
    # SM contention of the paper's Sec. 2.3 GSLICE example)
    total_r = r.sum(axis=-1)
    shrink = np.maximum(1.0, total_r)
    thrash = 1.0 + 0.6 * np.maximum(0.0, total_r - 1.0)
    r = r / shrink[..., None]

    # solo terms (`solo_terms` on arrays)
    t_load = d_load * b / hw.pcie_bw                               # ms
    t_feedback = d_fb * b / hw.pcie_bw
    flops = flops_i * b
    flops = flops * (1.0 + 0.004 * b)
    bytes_ = w_bytes + a_bytes * b
    t_compute = flops / (hw.peak_flops * hw.mxu_efficiency) * 1e3  # ms
    t_mem = bytes_ / hw.hbm_bw * 1e3
    r_eff = np.maximum(r, 1e-3)
    t_c = t_compute / r_eff
    t_m = t_mem / r_eff
    t_act_solo = np.maximum(t_c, t_m) + 0.35 * np.minimum(t_c, t_m) + 0.05
    cache_util = np.minimum(1.0, (bytes_ / (t_act_solo * 1e-3)) / hw.hbm_bw)
    util = t_c / t_act_solo
    power = hw.power_cap * ACTIVE_W_SCALE * r_eff * (0.35 + 0.65 * util)
    per_kernel = 0.002 + 5e-6 * n_kern                             # ms/kernel

    total_bw = cache_util.sum(axis=-1)
    device_power = hw.idle_power + power.sum(axis=-1)
    excess = np.maximum(device_power - hw.power_cap, 0.0)
    freq = np.where(device_power <= hw.power_cap, hw.max_freq,
                    np.maximum(hw.max_freq
                               + hw.alpha_f * _pow_stable(excess, FREQ_EXP),
                               0.6 * hw.max_freq))
    slow = freq / hw.max_freq

    # dispatch: round-robin growth with co-location
    per_kernel = per_kernel * (1.0 + SCHED_COLOC_SLOPE *
                               max(0.0, (n - 1)) ** SCHED_COLOC_EXP)
    t_sched = per_kernel * n_kern * np.ones_like(b)
    # bandwidth contention: inflate the memory-bound portion
    infl = np.where(total_bw > BW_KNEE,
                    _pow_stable(total_bw / BW_KNEE, BW_EXP), 1.0)
    t_m_infl = t_m * infl[..., None]
    t_act = (np.maximum(t_c, t_m_infl) + 0.35 * np.minimum(t_c, t_m_infl)
             + 0.05) * thrash[..., None]
    t_gpu = (t_sched + t_act) / slow[..., None]
    t_inf = t_load + t_gpu + t_feedback
    return BatchTrueState(
        t_load=t_load * np.ones_like(b), t_sched=t_sched, t_act=t_act,
        t_feedback=t_feedback * np.ones_like(b), t_gpu=t_gpu, t_inf=t_inf,
        power=power, cache_util=cache_util, freq=freq,
        device_power=device_power)


def device_state(entries: Sequence[Tuple[ServedModelDesc, int, float]],
                 hw: HardwareSpec,
                 rng: Optional[np.random.Generator] = None
                 ) -> List[TrueState]:
    """Ground truth for a full co-location state.

    entries: (desc, batch, r) per workload on the device.  Thin wrapper
    over `device_state_batch` (one row); with ``rng``, lognormal noise is
    applied per entry in declaration order, preserving the historical
    draw sequence.
    """
    descs = [d for (d, _, _) in entries]
    b = np.array([float(bb) for (_, bb, _) in entries])
    r = np.array([float(rr) for (_, _, rr) in entries])
    st = device_state_batch(descs, b, r, hw)
    freq = float(st.freq)
    slow = freq / hw.max_freq
    device_power = float(st.device_power)
    out = []
    for i in range(len(entries)):
        t_act = float(st.t_act[i])
        t_sched = float(st.t_sched[i])
        if rng is not None:
            t_act *= float(rng.lognormal(0.0, NOISE_SIGMA))
            t_sched *= float(rng.lognormal(0.0, 2 * NOISE_SIGMA))
        t_load = float(st.t_load[i])
        t_fb = float(st.t_feedback[i])
        t_gpu = (t_sched + t_act) / slow
        out.append(TrueState(
            t_load=t_load, t_sched=t_sched, t_act=t_act, t_feedback=t_fb,
            t_gpu=t_gpu, t_inf=t_load + t_gpu + t_fb,
            power=float(st.power[i]), cache_util=float(st.cache_util[i]),
            freq=freq, device_power=device_power))
    return out
