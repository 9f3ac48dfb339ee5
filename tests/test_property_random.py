"""Randomized cross-path consistency sweep.

Every density route the dispatch tree can pick — the dense pattern-
grouped joint (the bit-parity oracle, reference
marginalizable_state_space_model.py:728-773 semantics), the O(T) Markov
suffix factorization, and the O(T) masked Kalman filter — must agree in
f64 on RANDOM shapes and RANDOM missingness regimes, including the
degenerate dims (d=1, l=1, C=1, T=2) where layout/padding bugs hide.
Fixed-shape equality tests live next to each op; this sweep guards the
shape envelope.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from multimodal_trajectory_modeling_tpu import ops
from multimodal_trajectory_modeling_tpu.models import em
from multimodal_trajectory_modeling_tpu.ops import markov


def _random_model(rng, C, d, l):
    def spd(k):
        M = rng.normal(size=(k, k))
        return M @ M.T / k + np.eye(k)

    m = rng.normal(size=(C, d))
    S = np.stack([spd(d) for _ in range(C)])
    A = rng.normal(scale=0.4, size=(C, d, d))
    G = np.stack([spd(d) for _ in range(C)])
    H = rng.normal(size=(C, d, l))
    L = np.stack([spd(l) for _ in range(C)])
    return em.MixtureParams(
        pi=jnp.ones(C) / C,
        m=jnp.asarray(m),
        S=jnp.asarray(S),
        A=jnp.asarray(A),
        G=jnp.asarray(G),
        H=jnp.asarray(H),
        L=jnp.asarray(L),
    )


def _dense_logliks(z, x, params):
    """Oracle: per-cluster dense joint moments + masked grouped logpdf."""
    T = z.shape[0]
    v = em.pack_joint(z, x)
    patterns, pid = ops.pattern_groups(np.asarray(v))
    patterns, pid = jnp.asarray(patterns), jnp.asarray(pid)
    rows = []
    for c in range(params.pi.shape[0]):
        mean = ops.joint_mean(T, params.m[c], params.A[c], params.H[c])
        cov = ops.joint_cov(
            T, params.S[c], params.A[c], params.G[c], params.H[c],
            params.L[c],
        )
        rows.append(
            ops.masked_mvn_logpdf_grouped(
                v, mean, cov, patterns, pid, method="solve"
            )
        )
    return np.asarray(jnp.stack(rows))


def _random_batch(rng, T, n, d, l, regime):
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    lens = None
    if regime == "suffix":
        lens = rng.integers(1, T + 1, size=n)
        tmask = np.arange(T)[:, None] < lens[None, :]
        z[~tmask] = np.nan
        x[~tmask] = np.nan
    elif regime == "interior":
        # whole time steps dropped mid-trajectory, first step kept
        drop = rng.random(size=(T, n)) < 0.3
        drop[0] = False
        z[drop] = np.nan
        x[drop] = np.nan
    elif regime == "unstructured":
        # independent per-coordinate dropout → pattern count ~ n (the
        # grouped dense path's worst case), plus a few all-NaN rows
        z[rng.random(size=z.shape) < 0.25] = np.nan
        x[rng.random(size=x.shape) < 0.25] = np.nan
        z[:, :2] = np.nan
        x[:, :2] = np.nan
    return z, x, lens


REGIMES = ("full", "suffix", "interior", "unstructured")


@pytest.mark.slow  # ~50 s for the 12-seed sweep; full-suite lane only
@pytest.mark.parametrize("seed", range(12))
def test_density_routes_agree_on_random_shapes(seed):
    rng = np.random.default_rng(1000 + seed)
    C = int(rng.integers(1, 5))
    T = int(rng.integers(2, 12))
    n = int(rng.integers(16, 160))
    d = int(rng.integers(1, 4))
    l = int(rng.integers(1, 4))
    regime = REGIMES[seed % len(REGIMES)]
    params = _random_model(rng, C, d, l)
    z, x, lens = _random_batch(rng, T, n, d, l, regime)

    dense = _dense_logliks(jnp.asarray(z), jnp.asarray(x), params)

    # the filter covers every regime (all-NaN rows pin to exactly 0.0)
    filt = np.asarray(
        em.masked_logliks_kalman(
            params, jnp.asarray(z), jnp.asarray(x)
        )
    )
    np.testing.assert_allclose(filt, dense, rtol=1e-8, atol=1e-8)
    if regime == "unstructured":
        assert np.all(filt[:, :2] == 0.0)

    if regime in ("full", "suffix"):
        L = (
            np.full(n, T, np.int64) if lens is None else lens
        ).astype(np.int32)
        W = markov.markov_cluster_weights(
            params.m, params.S, params.A, params.G, params.H, params.L
        )
        mk = np.asarray(
            markov.markov_suffix_logliks(
                jnp.asarray(z), jnp.asarray(x), jnp.asarray(L), W
            )
        )
        np.testing.assert_allclose(mk, dense, rtol=1e-8, atol=1e-8)


def test_masked_filter_f32_survives_unstable_tail():
    """f32 regression: an expansive transition overflows the (mu, P)
    recursion across a long fully-unobserved suffix; the filter's
    where-select masking must keep the observed prefix's (finite)
    likelihood from being poisoned (0·inf = NaN with mask-multiplies —
    797/2000 NaNs observed at T=300 before the fix).  Mixed f32 data +
    f64 params must also run (dtype-unified scan carry)."""
    from multimodal_trajectory_modeling_tpu.ops import kalman

    rng = np.random.default_rng(3)
    C, T, n, d, l = 4, 300, 64, 2, 2
    z = rng.normal(size=(T, n, d)).astype(np.float32)
    x = rng.normal(size=(T, n, l)).astype(np.float32)
    lens = rng.integers(1, 40, size=n)  # long unobserved tails
    tmask = np.arange(T)[:, None] < lens[None, :]
    z[~tmask] = np.nan
    x[~tmask] = np.nan
    params = _random_model(rng, C, d, l)  # A ~ N(0, 0.4²)·(d×d): often ρ>1
    f32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    ll32 = np.asarray(
        kalman.kalman_masked_logliks(
            jnp.asarray(z), jnp.asarray(x),
            f32.m, f32.S, f32.A, f32.G, f32.H, f32.L,
        )
    )
    assert np.all(np.isfinite(ll32))
    # f64 oracle on the same data
    ll64 = np.asarray(
        kalman.kalman_masked_logliks(
            jnp.asarray(z, jnp.float64), jnp.asarray(x, jnp.float64),
            params.m, params.S, params.A, params.G, params.H, params.L,
        )
    )
    np.testing.assert_allclose(ll32, ll64, rtol=2e-3, atol=2e-3)
    # mixed dtypes: f32 data with f64 params promotes cleanly
    mixed = np.asarray(
        kalman.kalman_masked_logliks(
            jnp.asarray(z), jnp.asarray(x),
            params.m, params.S, params.A, params.G, params.H, params.L,
        )
    )
    np.testing.assert_allclose(mixed, ll64, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", (0, 1))
def test_fast_training_routes_agree_on_random_shapes(seed):
    """train(fast=True) must pick a route that reproduces the default
    dense trainer exactly (f64) at random shapes/regimes — the mixture
    -level guarantee behind the dispatch tree."""
    from multimodal_trajectory_modeling_tpu.models import (
        MMLinGaussSS_marginalizable,
    )

    rng = np.random.default_rng(2000 + seed)
    T = int(rng.integers(4, 9))
    n = int(rng.integers(150, 300))
    d = int(rng.integers(1, 3))
    l = int(rng.integers(1, 3))
    regime = ("suffix", "interior")[seed % 2]
    z, x, _ = _random_batch(rng, T, n, d, l, regime)
    a = MMLinGaussSS_marginalizable(
        n_clusters=2, states=z, observations=x, random_seed=3, init="random"
    ).train(n_steps=25)
    b = MMLinGaussSS_marginalizable(
        n_clusters=2, states=z, observations=x, random_seed=3, init="random"
    ).train(n_steps=25, fast=True)
    np.testing.assert_array_equal(a.cluster_assignment, b.cluster_assignment)
    np.testing.assert_allclose(
        np.asarray(a.transition_matrices),
        np.asarray(b.transition_matrices),
        rtol=1e-9,
        atol=1e-11,
    )
