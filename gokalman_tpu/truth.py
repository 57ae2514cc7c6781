"""Ground-truth comparator.

JAX rebuild of the reference's BatchGroundTruth (reference:
truth.go:10-70): turns absolute estimates into error traces
(est + offset - truth) while preserving the estimate's covariance, for
plotting/export.  Operates on whole stacked estimate pytrees at once
instead of per-step wrapper objects.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .filters.vanilla import Estimate


class BatchGroundTruth(NamedTuple):
    states: Optional[jax.Array]  # [T, n] or None
    measurements: Optional[jax.Array]  # [T, p] or None


def error(
    truth: BatchGroundTruth, k, est: Estimate, offset: Optional[jax.Array] = None
) -> Estimate:
    """ErrorWithOffset for a single step (reference: truth.go:21-60).

    k < 0 returns zero state/measurement with the estimate's covariance,
    mirroring the reference's shifted-feed convention.
    """
    try:  # normalize Python/NumPy integer indices; tracers raise
        k = int(k)
    except (TypeError, jax.errors.TracerIntegerConversionError):
        pass
    state = est.state
    if offset is not None:
        state = state + offset
    if truth.states is not None:
        state = state - truth.states[k]
    meas = est.measurement
    if truth.measurements is not None:
        meas = meas - truth.measurements[k]
    if isinstance(k, int):
        if k < 0:
            state = jnp.zeros_like(state)
            meas = jnp.zeros_like(meas)
    else:  # traced k: select zeros without data-dependent control flow
        neg = k < 0
        state = jnp.where(neg, jnp.zeros_like(state), state)
        meas = jnp.where(neg, jnp.zeros_like(meas), meas)
    return est._replace(state=state, measurement=meas)


def error_all(
    truth: BatchGroundTruth, ests: Estimate, offset: Optional[jax.Array] = None
) -> Estimate:
    """Vectorized error trace over a stacked [T, ...] estimate pytree."""
    state = ests.state
    if offset is not None:
        state = state + offset
    if truth.states is not None:
        state = state - truth.states
    meas = ests.measurement
    if truth.measurements is not None:
        meas = meas - truth.measurements
    return ests._replace(state=state, measurement=meas)
