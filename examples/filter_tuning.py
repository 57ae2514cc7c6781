"""Filter tuning and analysis workflow: from "my filter misbehaves" to
a calibrated, provably near-optimal design — the loop the reference
supports only by eyeballing chi-square plots (montecarlo.go +
chisquare.go), closed here with four tools:

1. `diagnostics.innovation_whiteness` catches the mistuned Q long
   before state error is visible;
2. `sysid.em_fit` fits Q and R from the data (closed-form EM, monotone
   likelihood — no step sizes to pick);
3. `diagnostics.pcrb` computes the posterior Cramér-Rao bound — the
   best ANY estimator could do — and shows the refit filter sits on it;
4. `schmidt` consider filter: when a measurement bias can't be
   estimated, carrying its covariance keeps the filter honest (the
   naive filter's NEES explodes, the consider filter's stays at n).

Run: JAX_PLATFORMS=cpu python examples/filter_tuning.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import gokalman_tpu as gk

DT = 0.1
T = 600


def make_truth(key, f, q, h, r):
    kx, kw, kv = jax.random.split(key, 3)
    x0 = jnp.array([0.0, 1.0])
    ws = jax.random.multivariate_normal(kw, jnp.zeros(2), q, (T,))
    vs = jax.random.multivariate_normal(kv, jnp.zeros(1), r, (T,))

    def step(x, inp):
        w, v = inp
        x = f @ x + w
        return x, (x, h @ x + v)

    _, (truth, ys) = jax.lax.scan(step, x0, (ws, vs))
    return truth, ys


def main():
    # True system: CV model with q=0.05, r=0.04.
    f, q_true, _ok = gk.c2d.van_loan(
        jnp.array([[0.0, 1.0], [0.0, 0.0]]), jnp.array([[0.0], [1.0]]),
        jnp.array([[0.05]]), DT)
    h = jnp.array([[1.0, 0.0]])
    r_true = jnp.array([[0.04]])
    truth, ys = make_truth(jax.random.PRNGKey(0), f, q_true, h, r_true)

    # ------------------------------------------------------------------
    # Step 1: the engineer's first guess is 20x off on both noises.
    q_guess, r_guess = q_true * 20.0, r_true / 20.0
    model, state = gk.vanilla.new(jnp.zeros(2), jnp.eye(2), f, None, h,
                                  gk.noise.noiseless(q_guess, r_guess))
    _, ests = gk.vanilla.run(model, state, ys)
    wr = gk.diagnostics.innovation_whiteness(ests.innovation, lags=10)
    print(f"[1] mistuned filter: innovation whiteness Q={float(wr.statistic):8.1f} "
          f"(threshold {wr.threshold:.1f}) -> white={bool(wr.passed)}")
    white = wr.passed
    assert not bool(white), "whiteness should catch a 20x mistune"

    # ------------------------------------------------------------------
    # Step 2: fit Q and R by EM from the same data.
    fit = gk.sysid.em_fit(model, state, ys, iters=40, fit=("q", "r"),
                          structure="full")
    q_fit, r_fit = fit.model.noise.q, fit.model.noise.r
    print(f"[2] EM refit: r={float(r_fit[0,0]):.4f} (true 0.04), "
          f"q[1,1]={float(q_fit[1,1]):.5f} (true {float(q_true[1,1]):.5f}), "
          f"loglik {float(fit.log_liks[0]):.1f} -> {float(fit.log_liks[-1]):.1f}")
    _, ests_fit = gk.vanilla.run(fit.model, fit.state, ys)
    wr2 = gk.diagnostics.innovation_whiteness(ests_fit.innovation, lags=10)
    print(f"    refit whiteness Q={float(wr2.statistic):6.1f} -> white={bool(wr2.passed)}")
    white2 = wr2.passed
    assert bool(white2)

    # ------------------------------------------------------------------
    # Step 3: is the refit filter near-optimal?  Compare its RMS to the
    # posterior Cramér-Rao bound (with the TRUE noises — the yardstick).
    phis = jnp.broadcast_to(f, (T, 2, 2))
    hs = jnp.broadcast_to(h, (T, 1, 2))
    _, bounds = gk.diagnostics.pcrb(phis, hs, q_true, r_true, jnp.eye(2))
    rms_pos = float(jnp.sqrt(jnp.mean((truth[:, 0] - ests_fit.state[:, 0]) ** 2)))
    bound_pos = float(jnp.sqrt(jnp.mean(bounds[:, 0, 0])))
    print(f"[3] refit position RMS {rms_pos:.4f} vs PCRB {bound_pos:.4f} "
          f"({rms_pos / bound_pos:.2f}x the bound)")
    assert rms_pos < 1.25 * bound_pos

    # ------------------------------------------------------------------
    # Step 4: now the sensor grows a constant bias (std 0.5) nobody can
    # estimate (one sensor, fully aliased with position).  Ignoring it
    # wrecks NEES; considering it keeps the filter honest.
    bias = 0.5  # a 1-sigma draw from the consider prior
    ys_biased = ys + bias
    _, e_naive = gk.vanilla.run(fit.model, fit.state, ys_biased)
    sm, ss = gk.schmidt.new(jnp.zeros(2), jnp.eye(2), f, h,
                            gk.noise.noiseless(q_true, r_true),
                            consider_cov=jnp.array([[0.25]]),
                            hc=jnp.array([[1.0]]))
    _, e_cons = gk.schmidt.run(sm, ss, ys_biased)

    def tail_nees(err, covs):
        v = jax.vmap(lambda e, p: e @ jnp.linalg.solve(p, e))(err, covs)
        return float(v[T // 2:].mean())

    nees_naive = tail_nees(truth - e_naive.state, e_naive.covariance)
    nees_cons = tail_nees(truth - e_cons.state, e_cons.covariance)
    infl = gk.schmidt.consider_inflation(sm, jax.tree.map(lambda a: a[-1], e_cons))
    print(f"[4] 1-sigma sensor bias: naive NEES {nees_naive:7.1f} (n=2 — "
          f"overconfident), consider NEES {nees_cons:.2f}; consider inflation "
          f"on pos var {float(infl[0,0]):.4f}")
    assert nees_naive > 10.0 * nees_cons and nees_cons < 6.0

    print("filter_tuning: ALL STEPS OK")


if __name__ == "__main__":
    main()
