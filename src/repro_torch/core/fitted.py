"""The fitted planner contexts, carried across from the JAX package.

``FITTED`` holds what ``repro.core.experiments.fitted_context(hw_name)``
returns for "tpu-v5e" and "tpu-v4": the fitted ``HardwareSpec`` and the
four served models' ``WorkloadCoefficients``, as ``dataclasses.asdict``
gives them, with every float written so that ``repr`` round-trips it
exactly.  The reference fits them by profiling its simulated testbed;
until the port has that simulator, `fitted_context` returns this frozen
copy (``tests/test_torch_planner_data.py`` holds it equal to the
reference's output, field for field).  They describe the cluster being
planned, not the card that runs the planner.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.types import HardwareSpec, WorkloadCoefficients

FITTED = {
    "tpu-v5e": {
        "hardware": {
            "name": "tpu-v5e",
            "power_cap": 170.0,
            "max_freq": 940.0,
            "idle_power": 60.0,
            "pcie_bw": 10.0,
            "alpha_f": -1.4054899513425558,
            "alpha_sch": 0.0029161864320638017,
            "beta_sch": -0.0032584997905471423,
            "r_unit": 0.025,
            "price_per_hour": 1.2,
            "peak_flops": 197000000000000.0,
            "hbm_bw": 819000000000.0,
            "mxu_efficiency": 0.45,
        },
        "profiles": {
            "rwkv6-1.6b": {
                "model": "rwkv6-1.6b",
                "hardware": "tpu-v5e",
                "d_load": 0.000256,
                "d_feedback": 0.00015999999999999999,
                "n_kernels": 444,
                "k_sch": 0.004220000000000001,
                "k1": 0.009001381931557497,
                "k2": 1.8974276478415626,
                "k3": 2.304375299391064,
                "k4": 0.01,
                "k5": -0.8668119613923815,
                "alpha_power": 443.2107740424945,
                "beta_power": 8.440331557364605,
                "alpha_cacheutil": 0.016958255655851132,
                "beta_cacheutil": 0.17403100641894584,
                "alpha_cache": 0.018888219069217387,
            },
            "qwen1.5-4b": {
                "model": "qwen1.5-4b",
                "hardware": "tpu-v5e",
                "d_load": 0.000256,
                "d_feedback": 0.00015999999999999999,
                "n_kernels": 572,
                "k_sch": 0.004860000000000001,
                "k1": 0.022335803125982726,
                "k2": 4.572706393231794,
                "k3": 5.807259419555063,
                "k4": 0.01,
                "k5": -2.1010755525150238,
                "alpha_power": 1071.7132529238258,
                "beta_power": 8.764348588037867,
                "alpha_cacheutil": 0.03355774643968979,
                "beta_cacheutil": 0.17776035574062832,
                "alpha_cache": 0.0205916458765468,
            },
            "qwen2-vl-7b": {
                "model": "qwen2-vl-7b",
                "hardware": "tpu-v5e",
                "d_load": 0.6554880000000001,
                "d_feedback": 0.00015999999999999999,
                "n_kernels": 404,
                "k_sch": 0.004020000000000001,
                "k1": 0.03805799835877851,
                "k2": 4.0729543870583,
                "k3": 12.300933151469058,
                "k4": 0.01,
                "k5": -0.1578936670522203,
                "alpha_power": 1074.1006400896795,
                "beta_power": 14.479394686875725,
                "alpha_cacheutil": 0.3811378602975375,
                "beta_cacheutil": 0.22940166224483055,
                "alpha_cache": 0.06628798062567456,
            },
            "whisper-large-v3": {
                "model": "whisper-large-v3",
                "hardware": "tpu-v5e",
                "d_load": 0.768064,
                "d_feedback": 0.00015999999999999999,
                "n_kernels": 844,
                "k_sch": 0.006220000000000001,
                "k1": 0.017048418579128484,
                "k2": 4.815994391201185,
                "k3": 2.556107851569782,
                "k4": 0.01,
                "k5": -2.6318584625857637,
                "alpha_power": 1106.846190416112,
                "beta_power": 2.6186935968428133,
                "alpha_cacheutil": 0.09277382519257836,
                "beta_cacheutil": 0.08094407279805661,
                "alpha_cache": 0.0,
            },
        },
    },
    "tpu-v4": {
        "hardware": {
            "name": "tpu-v4",
            "power_cap": 260.0,
            "max_freq": 1050.0,
            "idle_power": 90.0,
            "pcie_bw": 16.0,
            "alpha_f": -1.1724306944826755,
            "alpha_sch": 0.0029161864320638017,
            "beta_sch": -0.0032584997905471423,
            "r_unit": 0.025,
            "price_per_hour": 3.22,
            "peak_flops": 275000000000000.0,
            "hbm_bw": 1228000000000.0,
            "mxu_efficiency": 0.5,
        },
        "profiles": {
            "rwkv6-1.6b": {
                "model": "rwkv6-1.6b",
                "hardware": "tpu-v4",
                "d_load": 0.000256,
                "d_feedback": 0.00015999999999999999,
                "n_kernels": 444,
                "k_sch": 0.004220000000000001,
                "k1": 0.005954536143475268,
                "k2": 1.2175097793052612,
                "k3": 1.548587376207361,
                "k4": 0.01,
                "k5": -0.5212487054793316,
                "alpha_power": 436.5882748894656,
                "beta_power": 13.432310904972573,
                "alpha_cacheutil": 0.011142469204268625,
                "beta_cacheutil": 0.17741397638830264,
                "alpha_cache": 0.01997670171994919,
            },
            "qwen1.5-4b": {
                "model": "qwen1.5-4b",
                "hardware": "tpu-v4",
                "d_load": 0.000256,
                "d_feedback": 0.00015999999999999999,
                "n_kernels": 572,
                "k_sch": 0.004860000000000001,
                "k1": 0.014778286537362425,
                "k2": 2.9335119741782476,
                "k3": 3.901460070090823,
                "k4": 0.01,
                "k5": -1.2872097084730445,
                "alpha_power": 1055.4388309197013,
                "beta_power": 13.926064113933029,
                "alpha_cacheutil": 0.023845403181653176,
                "beta_cacheutil": 0.18112911595053846,
                "alpha_cache": 0.021997081055732205,
            },
            "qwen2-vl-7b": {
                "model": "qwen2-vl-7b",
                "hardware": "tpu-v4",
                "d_load": 0.6554880000000001,
                "d_feedback": 0.00015999999999999999,
                "n_kernels": 404,
                "k_sch": 0.004020000000000001,
                "k1": 0.0254136779363476,
                "k2": 2.5907490503230903,
                "k3": 8.29069434226901,
                "k4": 0.01,
                "k5": -0.004920694227486653,
                "alpha_power": 1058.4905322374116,
                "beta_power": 22.564268976413558,
                "alpha_cacheutil": 0.27295179792057894,
                "beta_cacheutil": 0.23129965868577362,
                "alpha_cache": 0.06979329593541701,
            },
            "whisper-large-v3": {
                "model": "whisper-large-v3",
                "hardware": "tpu-v4",
                "d_load": 0.768064,
                "d_feedback": 0.00015999999999999999,
                "n_kernels": 844,
                "k_sch": 0.006220000000000001,
                "k1": 0.010990431359755862,
                "k2": 3.105091406585192,
                "k3": 1.6800444240805366,
                "k4": 0.01,
                "k5": -1.681240195968932,
                "alpha_power": 1091.7070376885554,
                "beta_power": 4.120894600344652,
                "alpha_cacheutil": 0.05697787779299423,
                "beta_cacheutil": 0.08404459856248798,
                "alpha_cache": 0.0,
            },
        },
    },
}


@dataclass(frozen=True)
class FittedContext:
    """A hardware type's fitted ``HardwareSpec`` and model profiles (the
    reference's ``FittedContext`` without its simulated testbed)."""
    hw: HardwareSpec
    profiles: Dict[str, WorkloadCoefficients]


def coefficients_from_dict(d: dict) -> WorkloadCoefficients:
    """``dataclasses.asdict`` of a ``WorkloadCoefficients`` -> the port's."""
    return WorkloadCoefficients(**d)


def hardware_from_dict(d: dict) -> HardwareSpec:
    """``dataclasses.asdict`` of a ``HardwareSpec`` -> the port's."""
    return HardwareSpec(**d)


def fitted_context(hw_name: str = "tpu-v5e") -> FittedContext:
    """The fitted context of ``hw_name`` ("tpu-v5e" or "tpu-v4")."""
    if hw_name not in FITTED:
        raise KeyError(f"no fitted context for {hw_name!r}; have {sorted(FITTED)}")
    entry = FITTED[hw_name]
    return FittedContext(
        hw=hardware_from_dict(entry["hardware"]),
        profiles={name: coefficients_from_dict(c)
                  for name, c in entry["profiles"].items()})
