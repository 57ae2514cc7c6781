"""Chi-square filter-consistency tests (NEES / NIS).

JAX rebuild of the reference's replay loop (reference:
chisquare.go:16-95): instead of resetting one mutable filter per run
and accumulating Go maps, every Monte-Carlo run is replayed through a
fresh functional filter under `vmap`, and NEES/NIS are batched
quadratic forms reduced with a single mean over the run axis.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from . import linalg  # noqa: F401  (re-exported for callers)
from .filters import vanilla
from .montecarlo import MonteCarloRuns
from .ops.ensemble import _covariance_path_sequential


def chi_square(
    model: vanilla.Model,
    state0: vanilla.State,
    runs: MonteCarloRuns,
    controls: Optional[jax.Array] = None,
    with_nees: bool = True,
    with_nis: bool = True,
):
    """Replay each MC run's measurements through the filter and compute
    per-step ensemble means of NEES and NIS.

    NEES_k = (x_true - x^+)^T (P^+)^{-1} (x_true - x^+)   (chisquare.go:46-59)
    NIS_k  = innov^T (H P^- H^T + R)^{-1} innov            (chisquare.go:61-77)

    Returns (nis_means [T], nees_means [T]) matching the reference's
    (NISmeans, NEESmeans) return order (chisquare.go:94).  Disabled
    outputs are None.
    """
    if not (with_nees or with_nis):
        raise ValueError("chi square requires either NEES or NIS or both")

    measurements = runs.estimates.measurement  # [S, T, p]
    truth_states = runs.estimates.state  # [S, T, n]
    steps = measurements.shape[1]

    # The linear covariance path (P^±, K, S) is measurement-independent,
    # so propagate it ONCE and share the per-step inverses across all S
    # runs — the reference re-runs the whole filter (and re-inverts the
    # same matrices) per run (chisquare.go:37-79); the fused tier
    # already exploits this (ops/ensemble.py:46-66).
    k_gains, s_inv, p_plus_inv = _covariance_path_sequential(
        model, state0.p, steps
    )

    f, g, h = model.f, model.g, model.h

    def state_replay(meas_seq):
        """Per-run state recursion with the shared gains: the state
        update of vanilla.step (vanilla.go:138-195) minus the
        covariance algebra."""

        def body(x, xs):
            y, k_gain, u = xs
            x_pred = f @ x
            if g is not None and u is not None:
                x_pred = x_pred + g @ u
            innov = y - h @ x_pred
            x_plus = x_pred + k_gain @ innov
            return x_plus, (x_plus, innov)

        _, (states, innovs) = jax.lax.scan(
            body, state0.x, (meas_seq, k_gains, controls)
        )
        return states, innovs

    states, innovs = jax.vmap(state_replay)(measurements)  # [S,T,n], [S,T,p]

    nees_means = None
    if with_nees:
        err = truth_states - states  # [S, T, n]
        nees = jnp.einsum("stn,tnm,stm->st", err, p_plus_inv, err)
        nees_means = jnp.mean(nees, axis=0)
    nis_means = None
    if with_nis:
        # Innovation covariance from the *predicted* covariance
        # (pure prediction: S = H P^- H^T + R, chisquare.go:66-71).
        nis = jnp.einsum("stp,tpq,stq->st", innovs, s_inv, innovs)
        nis_means = jnp.mean(nis, axis=0)
    return nis_means, nees_means
