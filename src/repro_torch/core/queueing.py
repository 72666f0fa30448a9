"""Queueing-aware SLO budget split (beyond the paper's fixed T_slo/2).

iGniter's Theorem 1 / Alg. 2 (Eqs. 14, 17, 18) give inference the entire
`T_slo / 2` service budget with zero tail slack: the provisioned point
puts every instance at utilization ~1 (batch service time ~= batch
accumulation time), so queueing waits explode under arrival bursts and
latency noise — the measured 5-predicted-vs-178-simulated violation gap
at m=1000 (see ROADMAP).  Clipper-style adaptive batching and SLO-aware
schedulers with explicit waiting-time models both put a queueing term in
the latency budget; this module does the same for the provisioner.

Model — greedy dynamic batching server (serve-all-waiting up to b_appr,
exactly what `serving/simulator.py` implements):

  * **batch-accumulation wait**: a batch of b spans an arrival window of
    (b - 1) / R_ms; a request waits (b - 1) / (2 R_ms) in expectation
    and up to (b - 1) / R_ms at the tail (the greedy server's in-flight
    pass residual is bounded by the same quantity at the provisioned
    point, where one pass accumulates the next batch).
  * **M/D/1-style utilization wait**: the batch processor is a single
    server with deterministic service t_inf and utilization
    rho = R_ms * t_inf / b.  Arrivals of FULL batches are b-fold
    aggregated Poisson (squared arrival CV = burstiness / b), so the
    Kingman/Pollaczek-Khinchine mean wait is
        W = burstiness * rho * t_inf / (2 b (1 - rho)),
    and the tail quantile follows the standard exponential-tail
    approximation W_q = W * -ln(1 - q).  rho >= 1 means the batch
    server cannot sustain the arrival rate: infinite wait.

Budget split: the inference budget B replaces T_slo / 2 as the Alg. 2
threshold.  B is the largest value satisfying

    B + t_queue_tail(b, R, t_inf = B) + slack <= T_slo

solved by fixed-iteration bisection (deterministic and engine-
independent: the scalar and vectorized provisioning engines consume the
exact same float).  Evaluating the tail at t_inf = B is conservative —
the realized service time is below its budget — and makes the split a
pure function of (T_slo, R, b).  B is capped at T_slo / 2 so a
queueing-aware allocation is NEVER looser than the paper's half split;
the cap binds only when the queueing terms are negligible.

`budget="half"` keeps the paper-faithful fixed split (`T_slo / 2`
bit-for-bit); `budget="queueing"` is the provisioner-wide default.

Online use (docs/control-plane.md): the control plane re-solves budgets
with `BudgetModel.with_burstiness(cv2)` — the measured arrival CV^2
clamped to [BURSTINESS_LO, BURSTINESS_HI] and additionally FLOORED at
the provisioned model's burstiness by the reconciler (the "burstiness
floor": a deterministic trace's cv2 ~ 0 must never loosen budgets
mid-drift, while a spike train's cv2 >> 1 tightens them).  Replica
groups need no special casing here: each replica's budget is solved at
its RATE SHARE, which is what makes splitting an infeasible workload
recover a feasible per-replica budget (docs/provisioning.md).

The full narrative — model, solver, and how the split closed the
5-predicted-vs-178-simulated violation gap — lives in
docs/provisioning.md ("The SLO budget split").

A verbatim copy of the JAX package's ``repro.core.queueing``: the budgets
that decide Alg. 2 grants are solved here, on the host, for every backend.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Union

import numpy as np

# Utilizations at/above this are treated as unstable (infinite wait).
RHO_MAX = 1.0 - 1e-9
# Bisection iterations: 60 halvings of a [0, T_slo] bracket put the
# budget within ~1e-15 * T_slo — far inside the engines' 1e-9 contract.
SOLVE_ITERS = 60


@dataclass(frozen=True)
class QueueingDelay:
    """Decomposed batch-formation/waiting delay for one workload."""
    t_acc_mean: float     # expected batch-accumulation wait  (b-1)/(2R)
    t_acc_tail: float     # worst-request accumulation wait   (b-1)/R
    rho: float            # batch-server utilization R_ms * t_inf / b
    t_util_mean: float    # mean M/D/1-style utilization wait
    t_util_tail: float    # quantile utilization wait
    expected: float       # t_acc_mean + t_util_mean
    tail: float           # t_acc_tail + t_util_tail


def t_queue(b: float, rate_rps: float, t_inf: float, *,
            quantile: float = 0.99,
            burstiness: float = 1.0) -> QueueingDelay:
    """Expected + tail batch-formation/waiting delay [ms].

    ``burstiness`` scales the squared coefficient of variation of the
    arrival process: 1.0 = Poisson, 0.0 = deterministic (zero-burst)
    arrivals, under which the utilization wait vanishes and b=1 queues
    not at all.  Monotonically nondecreasing in utilization (via t_inf,
    for fixed b and R) and in batch size at fixed utilization (t_inf
    scaled with b); at FIXED t_inf a larger batch can wait less near
    rho -> 1, where its capacity relief outweighs the extra
    accumulation.
    """
    r_ms = rate_rps / 1000.0
    if r_ms <= 0.0:          # no arrivals: nothing ever queues
        return QueueingDelay(t_acc_mean=0.0, t_acc_tail=0.0, rho=0.0,
                             t_util_mean=0.0, t_util_tail=0.0,
                             expected=0.0, tail=0.0)
    t_acc_mean = (b - 1.0) / (2.0 * r_ms)
    t_acc_tail = (b - 1.0) / r_ms
    rho = r_ms * t_inf / b
    if rho >= RHO_MAX:
        t_util_mean = t_util_tail = math.inf
    else:
        t_util_mean = burstiness * rho * t_inf / (2.0 * b * (1.0 - rho))
        t_util_tail = t_util_mean * -math.log1p(-quantile)
    return QueueingDelay(
        t_acc_mean=t_acc_mean, t_acc_tail=t_acc_tail, rho=rho,
        t_util_mean=t_util_mean, t_util_tail=t_util_tail,
        expected=t_acc_mean + t_util_mean, tail=t_acc_tail + t_util_tail)


def _tail_ms(b: float, r_ms: float, t_inf: float,
             quantile: float, burstiness: float) -> float:
    """Tail t_queue (scalar fast path of the bisection objective)."""
    if r_ms <= 0.0:          # no arrivals: nothing ever queues
        return 0.0
    rho = r_ms * t_inf / b
    if rho >= RHO_MAX:
        return math.inf
    w = burstiness * rho * t_inf / (2.0 * b * (1.0 - rho))
    return (b - 1.0) / r_ms + w * -math.log1p(-quantile)


@dataclass(frozen=True)
class BudgetModel:
    """SLO budget split policy handed through the provisioning stack.

    mode:       "queueing" (solved split) or "half" (paper's T_slo / 2)
    quantile:   tail quantile the queueing wait is budgeted at
    slack_frac: extra safety slack as a fraction of T_slo (absorbs the
                simulator's ~1.5% lognormal service-time noise at p99)
    burstiness: arrival-process squared-CV scale (1 = Poisson)
    """
    mode: str = "queueing"
    quantile: float = 0.99
    slack_frac: float = 0.02
    burstiness: float = 1.0

    # clamp range for online burstiness estimates (`with_burstiness`):
    # the floor keeps a near-deterministic estimate from zeroing the
    # utilization-wait term entirely, the ceiling keeps one pathological
    # window from blowing every budget to the T_slo/2 cap.
    BURSTINESS_LO = 0.25
    BURSTINESS_HI = 8.0

    def __post_init__(self):
        if self.mode not in ("half", "queueing"):
            raise ValueError(f"unknown budget mode {self.mode!r}")

    def with_burstiness(self, cv2: float) -> "BudgetModel":
        """A copy with the arrival-burstiness scale replaced by a
        (clamped) online CV^2 estimate — the control plane's hook for
        adapting the budget split to the measured arrival process."""
        return dataclasses.replace(
            self, burstiness=min(self.BURSTINESS_HI,
                                 max(self.BURSTINESS_LO, float(cv2))))

    def budget_ms(self, slo_ms: float, rate_rps: float, batch: int) -> float:
        """The inference-latency budget B replacing T_slo / 2."""
        if self.mode == "half":
            return slo_ms / 2.0
        return _solve_budget(self, float(slo_ms), float(rate_rps),
                             float(batch))

    def budget_ms_vec(self, slo_ms: np.ndarray, rate_rps: np.ndarray,
                      batch: np.ndarray) -> np.ndarray:
        """Batched budget evaluation — bitwise-identical to `budget_ms`
        per row (same bracket, iteration count and float operations;
        the quantile factor MUST come from `math.log1p`, whose last ulp
        differs from `np.log1p`'s, or the two paths drift 1e-14 apart
        and the bitwise plan-identity contracts break)."""
        slo = np.asarray(slo_ms, dtype=np.float64)
        if self.mode == "half":
            return slo / 2.0
        r_ms = np.asarray(rate_rps, dtype=np.float64) / 1000.0
        b = np.asarray(batch, dtype=np.float64)
        target = slo * (1.0 - self.slack_frac)
        qf = -math.log1p(-self.quantile)
        lo = np.zeros_like(slo)
        hi = slo.copy()
        # Loop constants hoisted (same float ops per iteration as the
        # scalar solver — `2.0 * b * (...)` associates left, so b2 is
        # the exact intermediate): this bisection runs on every
        # controller probe, where per-iteration numpy dispatch is the
        # dominant edit-overhead term.
        b2 = 2.0 * b
        no_arrivals = ~(r_ms > 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            acc = (b - 1.0) / r_ms
            for _ in range(SOLVE_ITERS):
                mid = 0.5 * (lo + hi)
                rho = r_ms * mid / b
                w = self.burstiness * rho * mid / (b2 * (1.0 - rho))
                tail = np.where(rho >= RHO_MAX, np.inf, acc + w * qf)
                tail = np.where(no_arrivals, 0.0, tail)
                ok = mid + tail <= target
                lo = np.where(ok, mid, lo)
                hi = np.where(ok, hi, mid)
        return np.minimum(lo, slo / 2.0)


@functools.lru_cache(maxsize=200_000)
def _solve_budget(bm: BudgetModel, slo_ms: float, rate_rps: float,
                  batch: float) -> float:
    """Scalar bisection for the budget split (cached: the provisioning
    hot loops re-evaluate the same (workload, batch) pairs constantly).
    Bitwise-identical to one row of `budget_ms_vec` — same bracket,
    iteration count and float operations."""
    r_ms = rate_rps / 1000.0
    target = slo_ms * (1.0 - bm.slack_frac)
    lo, hi = 0.0, slo_ms
    for _ in range(SOLVE_ITERS):
        mid = 0.5 * (lo + hi)
        if mid + _tail_ms(batch, r_ms, mid, bm.quantile,
                          bm.burstiness) <= target:
            lo = mid
        else:
            hi = mid
    return min(lo, slo_ms / 2.0)


# Shared singletons: `resolve` maps the string API (budget="half" /
# "queueing") onto them so identity-based caches stay warm.
HALF = BudgetModel(mode="half")
QUEUEING = BudgetModel(mode="queueing")

BudgetLike = Union[str, BudgetModel]


def resolve(budget: BudgetLike) -> BudgetModel:
    """Accept "half" / "queueing" / a BudgetModel instance."""
    if isinstance(budget, BudgetModel):
        return budget
    if budget == "half":
        return HALF
    if budget == "queueing":
        return QUEUEING
    raise ValueError(f"unknown budget {budget!r} "
                     "(expected 'half', 'queueing' or a BudgetModel)")
