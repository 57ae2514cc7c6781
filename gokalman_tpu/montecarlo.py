"""Monte-Carlo ensemble runner.

JAX rebuild of the reference's sequential MC loop (reference:
montecarlo.go:92-124): the per-sample `for` loop with `kf.Reset()`
between samples becomes a `vmap` over per-run PRNG keys — the ensemble
axis is the data-parallel axis, shardable across chips (see
parallel.mesh).  The per-step ensemble Mean/StdDev (montecarlo.go:18-59,
O(steps^2 * runs) as written in the reference because AsCSV recomputes
them per row) become single batched reductions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .filters import vanilla


class MonteCarloRuns(NamedTuple):
    """Stacked estimates with leading [runs, steps] axes (montecarlo.go:12-15)."""

    estimates: vanilla.Estimate  # leaves shaped [S, T, ...]
    runs: int
    steps: int

    def mean(self, step=None) -> jax.Array:
        """Ensemble mean of the state at `step`, or [T, n] for all steps.

        Reference: montecarlo.go:18-37.
        """
        states = self.estimates.state  # [S, T, n]
        m = jnp.mean(states, axis=0)
        return m if step is None else m[step]

    def stddev(self, step=None) -> jax.Array:
        """Ensemble sample stddev (ddof=1, matching gonum stat.StdDev).

        Reference: montecarlo.go:40-59.
        """
        states = self.estimates.state
        s = jnp.std(states, axis=0, ddof=1)
        return s if step is None else s[step]

    def as_csv(self, headers) -> list[str]:
        """One CSV blob per state component: columns are each run, then
        mean, then stddev; one row per step (montecarlo.go:62-89).

        At ensemble scale (100k runs) this is runs x steps float
        formatting per component — the native C++ formatter
        (gokalman_tpu.native) does it ~30x faster than Python string
        formatting, with byte-identical %f output; falls back to
        Python when the native tier is unavailable."""
        import numpy as np

        from . import native

        states = np.asarray(self.estimates.state)  # [S, T, n]
        means = np.asarray(self.mean())
        devs = np.asarray(self.stddev())
        out = []
        for i, header in enumerate(headers[: states.shape[2]]):
            hdr = (
                ",".join([f"{header}-{r}" for r in range(self.runs)])
                + f",{header}-mean,{header}-stddev"
            )
            matrix = np.concatenate(
                [states[:, :, i].T, means[:, i:i + 1], devs[:, i:i + 1]],
                axis=1,
            )  # [T, S+2]
            text = native.format_csv(matrix)
            if text is not None:
                out.append(hdr + "\n" + text.rstrip("\n"))
                continue
            lines = [hdr]
            for k in range(self.steps):
                lines.append(",".join(f"{v:f}" for v in matrix[k]))
            out.append("\n".join(lines))
        return out


def monte_carlo(
    model: vanilla.Model,
    state0: vanilla.State,
    samples: int,
    steps: int,
    key: jax.Array,
    controls: Optional[jax.Array] = None,
    init_spread: bool = False,
) -> MonteCarloRuns:
    """Run `samples` independent pure-predictor simulations.

    Each run re-starts from `state0` (the reference's kf.Reset(),
    montecarlo.go:116) with an independent noise stream derived from
    `key`.  The runs never interact, so this is a plain vmap; shard the
    leading axis with parallel.mesh for multi-chip ensembles.

    init_spread=True draws each run's initial state from
    N(state0.x, state0.p) — the reference robot example's per-run
    distmv draw (examples/robot/main.go:29-31).

    Reference: NewMonteCarloRuns montecarlo.go:92-119.  Note the
    reference *ignores* a single provided control vector and substitutes
    zeros (montecarlo.go:98-107); here pass controls=[T, m] to actually
    use controls, or None.
    """
    keys = jax.random.split(key, samples)
    chol_p0 = jnp.linalg.cholesky(state0.p) if init_spread else None

    def one_run(k):
        st = state0
        if init_spread:
            k0, k = jax.random.split(k)
            z = jax.random.normal(k0, state0.x.shape, dtype=state0.x.dtype)
            st = state0._replace(x=state0.x + chol_p0 @ z)
        _, ests = vanilla.run(
            model,
            st,
            controls=controls,
            key=k,
            steps=steps,
            prediction_only=True,
        )
        return ests

    ests = jax.vmap(one_run)(keys)
    return MonteCarloRuns(ests, samples, steps)
