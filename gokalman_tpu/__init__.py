"""gokalman_tpu — a state-estimation (Kalman filtering) framework for JAX.

A ground-up JAX/XLA/Pallas rebuild with the capabilities of
ChristopherRabotin/gokalman: vanilla/information/square-root linear
filters, SRIF and hybrid CKF/EKF nonlinear filters, batch least
squares, Van Loan discretization, noise models, Monte-Carlo ensembles,
chi-square (NEES/NIS) consistency tests, CSV export, and an orbital
dynamics module for the orbit-determination workloads — plus the
beyond-reference tier: UKF/SR-UKF (+cubature rule), EnKF/ETKF,
bootstrap and Rao-Blackwellized particle filters, IMM (linear and UKF
mode banks), Gaussian-sum filters (multimodal posteriors, Runnalls
mixture reduction), Huber-robust and gated updates, adaptive noise, RTS /
unscented / fixed-lag / parallel-in-time smoothers, steady-state
serving filters, filter-health diagnostics, and device-sharded
ensemble pipelines.

Design stance (see SURVEY.md §7): filters are pure functions
`step(model, state, inputs) -> (state, estimate)` over pytrees;
sequences run under `lax.scan`; ensembles run under `vmap`/`shard_map`
over a device mesh; the hot small-matrix algebra is fused by XLA with
Pallas kernels as the native tier.
"""

from . import (
    c2d,
    checkpoint,
    chisquare,
    diagnostics,
    dynamics,
    exporter,
    linalg,
    montecarlo,
    noise,
    od,
    ops,
    parallel,
    profiling,
    sysid,
    truth,
    types,
)
from .types import FilterType
from .filters import (
    adaptive,
    batch,
    enkf,
    gsf,
    hybrid,
    imm,
    information,
    particle,
    rbpf,
    schmidt,
    sqrt,
    srif,
    srukf,
    ukf,
    vanilla,
)

__version__ = "0.1.0"

__all__ = [
    "c2d",
    "chisquare",
    "diagnostics",
    "exporter",
    "linalg",
    "montecarlo",
    "noise",
    "truth",
    "dynamics",
    "od",
    "checkpoint",
    "profiling",
    "types",
    "FilterType",
    "ops",
    "parallel",
    "vanilla",
    "information",
    "sqrt",
    "srif",
    "hybrid",
    "batch",
    "ukf",
    "srukf",
    "adaptive",
    "enkf",
    "particle",
    "imm",
    "rbpf",
    "gsf",
    "schmidt",
    "sysid",
]
