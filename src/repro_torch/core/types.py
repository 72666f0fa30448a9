"""Core datatypes for the iGniter performance model and provisioner.

Faithful to the paper's notation (Table 2).  A copy of the JAX package's
``repro.core.types``; the planner backends are "numpy" and "torch", and
``PlannerConfig`` carries the torch backend's device.  ``HardwareSpec``
and ``V5E`` / ``V4`` describe the cluster being planned, not the card that
runs the planner.  Units:
  latency: milliseconds            rate: requests / second
  data sizes: megabytes            bandwidth: MB / ms  (== GB/s)
  power: watts                     frequency: MHz
  resources r: fraction of one accelerator in [0, 1], unit r_unit
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

if TYPE_CHECKING:                      # no runtime dependency: types.py
    from repro_torch.core.queueing import BudgetLike   # stays import-free


# Theorem 1 search ceiling for replica groups (k = 1..K_MAX).  Canonical
# home; `provisioner.K_MAX` re-exports it for backward compatibility.
K_MAX = 8


@dataclass(frozen=True)
class HardwareSpec:
    """Hardware-specific coefficients (paper Sec. 3.1: P, F, p_idle,
    B_pcie, alpha_f, alpha_sch, beta_sch) + pricing."""
    name: str
    power_cap: float          # P   [W]
    max_freq: float           # F   [MHz]
    idle_power: float         # p_idle [W]
    pcie_bw: float            # B_pcie [MB/ms == GB/s] host<->HBM DMA
    alpha_f: float            # MHz per excess W (negative)
    alpha_sch: float          # ms/kernel per co-located workload
    beta_sch: float           # ms/kernel intercept
    r_unit: float = 0.025     # allocation granularity (2.5%)
    price_per_hour: float = 3.06   # $/h per accelerator (p3.2xlarge analogue)
    # TPU-analogue physics used by the ground-truth simulator only:
    peak_flops: float = 197e12     # bf16 FLOP/s per chip (v5e)
    hbm_bw: float = 819e9          # bytes/s
    mxu_efficiency: float = 0.45   # achievable fraction of peak at serving bs

    @property
    def price_per_ms(self) -> float:
        return self.price_per_hour / 3_600_000.0


# TPU v5e chip as the accelerator unit (see DESIGN.md hardware adaptation).
V5E = HardwareSpec(
    name="tpu-v5e",
    power_cap=170.0, max_freq=940.0, idle_power=60.0,
    pcie_bw=10.0, alpha_f=-1.1, alpha_sch=0.0048, beta_sch=-0.009,
    r_unit=0.025, price_per_hour=1.20,
    peak_flops=197e12, hbm_bw=819e9, mxu_efficiency=0.45,
)

# A v4-like bigger/costlier chip for the heterogeneous experiment (Fig. 20).
V4 = HardwareSpec(
    name="tpu-v4",
    power_cap=260.0, max_freq=1050.0, idle_power=90.0,
    pcie_bw=16.0, alpha_f=-0.9, alpha_sch=0.0042, beta_sch=-0.008,
    r_unit=0.025, price_per_hour=3.22,
    peak_flops=275e12, hbm_bw=1228e9, mxu_efficiency=0.5,
)


@dataclass(frozen=True)
class WorkloadCoefficients:
    """Workload-specific coefficients (paper Sec. 3.1), one per
    (DNN model, hardware type).

    d_load/d_feedback: MB per request at b=1 (profiled once, Eq. 3)
    n_kernels: kernel count n_k (fused HLO computations on TPU)
    k_sch: solo per-kernel dispatch delay [ms]
    k1..k5: Eq. 11 solo active-time surface k_act(b, r)
    alpha/beta_power: p(b) = alpha_power * (b / k_act) + beta_power
    alpha/beta_cacheutil: c(b) = alpha_cacheutil * (b / k_act) + beta_cacheutil
    alpha_cache: sensitivity of active time to neighbors' cache util (Eq. 8)
    """
    model: str
    hardware: str
    d_load: float
    d_feedback: float
    n_kernels: int
    k_sch: float
    k1: float
    k2: float
    k3: float
    k4: float
    k5: float
    alpha_power: float
    beta_power: float
    alpha_cacheutil: float
    beta_cacheutil: float
    alpha_cache: float

    # -- solo characteristics (Sec. 3.1) ------------------------------------
    def k_act(self, b: float, r: float) -> float:
        """Solo GPU active time, Eq. 11."""
        return (self.k1 * b * b + self.k2 * b + self.k3) / (r + self.k4) + self.k5

    def power(self, b: float, r: float) -> float:
        """Solo power consumption p^i (linear in processing ability b/k_act)."""
        return self.alpha_power * (b / self.k_act(b, r)) + self.beta_power

    def cache_util(self, b: float, r: float) -> float:
        """Solo L2-cache(/HBM-bandwidth) utilization c^i."""
        return self.alpha_cacheutil * (b / self.k_act(b, r)) + self.beta_cacheutil

    def t_load(self, b: float, pcie_bw: float) -> float:
        return self.d_load * b / pcie_bw

    def t_feedback(self, b: float, pcie_bw: float) -> float:
        return self.d_feedback * b / pcie_bw


@dataclass(frozen=True)
class WorkloadSpec:
    """A DNN inference workload submitted to the iGniter portal.

    ``priority`` is the admission-control class (higher = more
    important; default 0).  The paper's planner never says "no", so
    priority is ignored by provisioning physics — it only orders the
    controller's queue-or-shed / brownout / preemption decisions when a
    device cap binds (docs/control-plane.md, Overload section).
    """
    name: str                 # e.g. "W3"
    model: str                # model key (profile lookup)
    slo_ms: float             # T_slo
    rate_rps: float           # R (request arrival rate == target throughput)
    priority: int = 0         # admission class (higher wins under a cap)


@dataclass
class Placement:
    """One workload's provisioning decision."""
    workload: WorkloadSpec
    gpu: int                  # device index
    r: float                  # allocated resource fraction
    batch: int                # configured batch size b_appr


@dataclass
class ProvisioningPlan:
    placements: List[Placement] = field(default_factory=list)
    n_gpus: int = 0
    hardware: Optional[HardwareSpec] = None

    def by_gpu(self) -> Dict[int, List[Placement]]:
        out: Dict[int, List[Placement]] = {}
        for pl in self.placements:
            out.setdefault(pl.gpu, []).append(pl)
        return out

    def cost_per_hour(self) -> float:
        assert self.hardware is not None
        return self.n_gpus * self.hardware.price_per_hour

    def total_allocated(self, gpu: int) -> float:
        return sum(pl.r for pl in self.placements if pl.gpu == gpu)

    def summary(self) -> str:
        lines = []
        for g, pls in sorted(self.by_gpu().items()):
            body = ", ".join(f"{pl.workload.name}({pl.r*100:.1f}%, b{pl.batch})"
                             for pl in pls)
            lines.append(f"GPU{g}: {body}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Planner configuration (the unified knob object; docs/provisioning.md)
# ---------------------------------------------------------------------------

_BACKENDS = ("numpy", "torch")
_ENGINES = ("vec", "scalar")
_BATCH_MODES = ("eq17", "joint")


@dataclass(frozen=True)
class PlannerConfig:
    """All provisioning knobs in one frozen, hashable object.

    Replaces the five parallel keywords (``engine=``, ``budget=``,
    ``batch=``, ``replicate=``, ``k_max=``) that used to be threaded
    through every planner entry point, and adds ``backend`` and its
    ``device``:

      backend    "torch" (float64 torch on ``device``, the Alg. 2 grant
                 loop as a CUDA kernel on a card; requires the vectorized
                 engine) | "numpy" (pinned oracle)
      device     torch backend only: None -> cuda:0, raising without
                 CUDA (`repro_torch.device.resolve_device`); "cpu" runs
                 the plain torch version when asked for by name
      engine     "vec" (batched Alg. 1/2) | "scalar" (reference oracle)
      budget     "queueing" | "half" | a `queueing.BudgetModel`
      batch      "eq17" (closed form) | "joint" (scan b, min r_lower)
      replicate  split solo-infeasible workloads into replica groups
      k_max      Theorem-1 replica search ceiling (k = 1..k_max)

    Every public entry point accepts ``config=``; the legacy keywords
    remain as deprecated shims resolved through `planner_config` (passing
    both is a TypeError).  The default runs on the card; every backend
    gives the numpy oracle's plans bit-for-bit.
    """
    backend: str = "torch"
    engine: str = "vec"
    budget: "BudgetLike" = "queueing"
    batch: str = "eq17"
    replicate: bool = False
    k_max: int = K_MAX
    device: Optional[str] = None

    def __post_init__(self) -> None:
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, "
                             f"got {self.backend!r}")
        if self.engine not in _ENGINES:
            raise ValueError(f"engine must be one of {_ENGINES}, "
                             f"got {self.engine!r}")
        if self.batch not in _BATCH_MODES:
            raise ValueError(f"batch must be one of {_BATCH_MODES}, "
                             f"got {self.batch!r}")
        if self.backend == "torch" and self.engine != "vec":
            raise ValueError("backend='torch' requires engine='vec'; the "
                             "scalar oracle runs with backend='numpy'")
        if self.backend == "numpy" and self.device is not None:
            raise ValueError("device= applies to backend='torch'; the numpy "
                             f"backend runs on the host (got {self.device!r})")
        if isinstance(self.budget, str) and self.budget not in ("half",
                                                                "queueing"):
            raise ValueError(f"budget string must be 'half' or 'queueing', "
                             f"got {self.budget!r}")
        if self.k_max < 1:
            raise ValueError(f"k_max must be >= 1, got {self.k_max}")

    def replace(self, **changes) -> "PlannerConfig":
        return dataclasses.replace(self, **changes)


def planner_config(config: Optional[PlannerConfig] = None,
                   base: Optional[PlannerConfig] = None,
                   **legacy) -> PlannerConfig:
    """Resolve ``config=`` against the deprecated per-knob keywords.

    Entry points declare their legacy keywords with ``None`` sentinels
    and forward them here: ``config=`` wins, but mixing it with any
    explicit legacy keyword is a TypeError (silently ignoring either
    would be worse).  ``base`` carries a call-site default that differs
    from `PlannerConfig()` (e.g. the controller's ``batch="joint"``).
    """
    given = {k: v for k, v in legacy.items() if v is not None}
    if config is not None:
        if given:
            raise TypeError(
                "pass either config=PlannerConfig(...) or the legacy "
                f"keywords, not both (got config= plus {sorted(given)})")
        return config
    cfg = base if base is not None else PlannerConfig()
    return dataclasses.replace(cfg, **given) if given else cfg
