"""Float64 torch twin of `physics.device_state_arrays` for bulk table builds.

`simulator._build_tables_bulk` batches every latency-table row of one
co-location width into a single ``(R, n)`` evaluation; with
``backend="torch"`` that evaluation runs here, on ``device``, instead of
numpy.  Only the five quantities a `_LatTable` stores are returned
(t_load, t_sched, t_act, t_feedback, freq).  This is the port's
counterpart of the JAX package's ``repro.serving.physics_jax``.

A call packs the chunk into one float64 buffer on the host (`pack`),
copies it to the device once, runs `repro_torch.kernels.tables.tables`
(the CUDA kernel ``tables_kernel`` on a card, its plain float64 torch
version on the CPU: one launch per chunk) and copies the results back
once.

Numerical contract — the reference's for its JAX twin: float64,
agreement with the numpy oracle to rtol=1e-6, atol=1e-9.  Every float
operation is numpy's, in numpy's order (no fused multiply-adds), but the
two powers are the device's ``pow``, not the libm loop of
`physics._pow_stable`.  The numpy backend stays the pinned bitwise
oracle.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.types import HardwareSpec
from repro_torch.device import resolve_device
from repro_torch.kernels import tables
from repro_torch.serving import physics


def scalars(n_co: int, hw: HardwareSpec) -> dict:
    """`tables.SCALARS` for width ``n_co`` on ``hw``, formed as numpy's
    expressions form them before they meet an array."""
    return {
        "pcie_bw": hw.pcie_bw, "peak_eff": hw.peak_flops * hw.mxu_efficiency,
        "hbm_bw": hw.hbm_bw, "power_scale": hw.power_cap * physics.ACTIVE_W_SCALE,
        "idle_power": hw.idle_power, "power_cap": hw.power_cap,
        "max_freq": hw.max_freq, "alpha_f": hw.alpha_f,
        "freq_floor": 0.6 * hw.max_freq,
        "sched_scale": (1.0 + physics.SCHED_COLOC_SLOPE
                        * max(0.0, (n_co - 1)) ** physics.SCHED_COLOC_EXP),
        "bw_knee": physics.BW_KNEE, "bw_exp": physics.BW_EXP,
        "freq_exp": physics.FREQ_EXP}


def pack(d_load, d_fb, flops_i, w_bytes, a_bytes, n_kern, b, r,
         n_co: int, hw: HardwareSpec) -> Tuple[np.ndarray, int]:
    """The chunk's inputs in one float64 buffer (`tables.SCALARS`, then
    the eight `tables.PLANES`, each broadcast to (R, n_co)) and R."""
    arrays = (d_load, d_fb, flops_i, w_bytes, a_bytes, n_kern, b, r)
    shape = np.broadcast_shapes(*(np.shape(a) for a in arrays))
    if not shape or shape[-1] != n_co:
        raise ValueError(f"inputs of shape {shape} are not rows of n_co = {n_co}")
    rows = int(np.prod(shape[:-1]))
    ns, npl = len(tables.SCALARS), len(tables.PLANES)
    buf = np.empty(tables.pack_size(rows, n_co))
    sc = scalars(n_co, hw)
    buf[:ns] = [sc[k] for k in tables.SCALARS]
    planes = buf[ns:].reshape(npl, rows, n_co)
    for i, a in enumerate(arrays):
        planes[i] = np.broadcast_to(a, shape).reshape(rows, n_co)
    return buf, rows


def _values(run, arrays, n_co: int, hw: HardwareSpec, device
            ) -> Tuple[np.ndarray, ...]:
    n = int(n_co)
    dev = resolve_device(device)
    buf, rows = pack(*arrays, n, hw)
    out = run(torch.from_numpy(buf).to(dev), rows, n).cpu().numpy()
    return tables.split_out(out, rows, n)


def table_values(d_load, d_fb, flops_i, w_bytes, a_bytes, n_kern, b, r,
                 n_co: int, hw: HardwareSpec, device=None
                 ) -> Tuple[np.ndarray, ...]:
    """Numpy in, numpy out: (t_load, t_sched, t_act, t_feedback) as
    (R, n_co) and freq (R,), evaluated on ``device`` (None -> cuda:0,
    raising without CUDA) by `tables.tables`, one launch on a card."""
    return _values(tables.tables, (d_load, d_fb, flops_i, w_bytes, a_bytes,
                                   n_kern, b, r), n_co, hw, device)


def table_values_plain(d_load, d_fb, flops_i, w_bytes, a_bytes, n_kern, b, r,
                       n_co: int, hw: HardwareSpec, device=None
                       ) -> Tuple[np.ndarray, ...]:
    """`table_values` through the plain float64 torch version on any
    ``device``: the kernel's yardstick on a card."""
    return _values(tables.tables_plain, (d_load, d_fb, flops_i, w_bytes,
                                         a_bytes, n_kern, b, r), n_co, hw, device)
