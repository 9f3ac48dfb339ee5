"""End-to-end tests of the jitted hard-EM engine: parameter recovery on
2-cluster synthetic data (reference self-test,
marginalizable_mixture_model.py:1920-2025) plus convergence/guard semantics.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multimodal_trajectory_modeling_tpu import ops
from multimodal_trajectory_modeling_tpu.models import em


def _make_mixture_data(seed=0, n=1000, T=12, d=2, l=3, C=2):
    rng = np.random.default_rng(seed)
    pis = np.array([0.4, 0.6])
    A = np.stack([rng.normal(scale=0.5, size=(d, d)) for _ in range(C)])
    G = np.stack([np.eye(d) / (c + 2.0) for c in range(C)])
    H = np.stack([rng.normal(size=(d, l)) for _ in range(C)])
    L = np.stack([(c + 1.0) * np.eye(l) for c in range(C)])
    m = np.stack([rng.normal(size=d) for _ in range(C)])
    S = np.stack([np.eye(d) / 4.0 for _ in range(C)])

    labels = rng.choice(C, size=n, p=pis)
    z = np.zeros((T, n, d))
    x = np.zeros((T, n, l))
    for c in range(C):
        idx = labels == c
        zc, xc = ops.sample_trajectories(
            jax.random.PRNGKey(100 + c),
            int(idx.sum()),
            T,
            *map(jnp.asarray, (m[c], S[c], A[c], G[c], H[c], L[c])),
        )
        z[:, idx], x[:, idx] = np.asarray(zc), np.asarray(xc)
    true = em.MixtureParams(
        *map(jnp.asarray, (pis, m, S, A, G, H, L))
    )
    return z, x, labels, true


def _packed(z, x):
    v = np.asarray(em.pack_joint(jnp.asarray(z), jnp.asarray(x)))
    patterns, pid = ops.pattern_groups(v)
    return jnp.asarray(v), jnp.asarray(patterns), jnp.asarray(pid)


def _random_init_params(rng, C, d, l):
    def spd(k):
        X = rng.normal(size=(k, k))
        return X @ X.T + np.eye(k)

    return em.MixtureParams(
        pi=jnp.ones(C) / C,
        m=jnp.asarray(rng.normal(size=(C, d))),
        S=jnp.asarray(np.stack([spd(d) for _ in range(C)])),
        A=jnp.asarray(rng.normal(size=(C, d, d))),
        G=jnp.asarray(np.stack([spd(d) for _ in range(C)])),
        H=jnp.asarray(rng.normal(size=(C, d, l))),
        L=jnp.asarray(np.stack([spd(l) for _ in range(C)])),
    )


def test_em_recovers_two_cluster_parameters():
    z, x, labels, true = _make_mixture_data()
    v, patterns, pid = _packed(z, x)
    rng = np.random.default_rng(1)
    C, d, l = 2, 2, 3
    params0 = _random_init_params(rng, C, d, l)
    assign0 = jnp.asarray(rng.integers(0, C, size=z.shape[1]))

    params, assign, iters, status = em.train_em(
        params0, assign0, jnp.asarray(z), jnp.asarray(x), v, patterns, pid,
        n_steps=100,
    )
    assert int(status) == em.STATUS_CONVERGED

    # match clusters by propensity ordering
    perm = np.argsort(np.asarray(params.pi))
    true_perm = np.argsort(np.asarray(true.pi))
    got_assign = np.asarray(assign)
    # assignments recover labels (up to permutation)
    relabel = {int(perm[k]): int(true_perm[k]) for k in range(C)}
    acc = np.mean([relabel[a] for a in got_assign] == labels)
    assert acc > 0.95

    np.testing.assert_allclose(
        np.sort(np.asarray(params.pi)), np.sort(np.asarray(true.pi)), rtol=0.1
    )
    for k in range(C):
        ci, ct = int(perm[k]), int(true_perm[k])
        np.testing.assert_allclose(
            np.asarray(params.A[ci]), np.asarray(true.A[ct]), atol=0.1
        )
        np.testing.assert_allclose(
            np.asarray(params.G[ci]), np.asarray(true.G[ct]), atol=0.2
        )
        np.testing.assert_allclose(
            np.asarray(params.H[ci]), np.asarray(true.H[ct]), atol=0.15
        )
        np.testing.assert_allclose(
            np.asarray(params.L[ci]), np.asarray(true.L[ct]), atol=0.3
        )


def test_em_objective_is_monotone():
    """EM should not decrease the complete-data log-likelihood Q."""
    z, x, _, _ = _make_mixture_data(seed=2, n=400, T=6)
    v, patterns, pid = _packed(z, x)
    rng = np.random.default_rng(3)
    params0 = _random_init_params(rng, 2, 2, 3)
    assign = jnp.asarray(rng.integers(0, 2, size=400))
    T = z.shape[0]

    params = em.mstep(jnp.asarray(z), jnp.asarray(x), assign, n_clusters=2)
    prev_q = -np.inf
    for _ in range(10):
        ll = em.estep_logliks(params, v, patterns, pid, T=T)
        new_assign = em.assignments_from_logliks(params.pi, ll)
        q = float(
            em.complete_data_loglik(params, v, patterns, pid, T=T)
        )
        assert q >= prev_q - 1e-6
        prev_q = q
        if int(jnp.sum(new_assign != assign)) == 0:
            break
        assign = new_assign
        params = em.mstep(jnp.asarray(z), jnp.asarray(x), assign, n_clusters=2)


def test_init_guard_aborts_without_training():
    z, x, _, _ = _make_mixture_data(seed=4, n=100, T=4)
    v, patterns, pid = _packed(z, x)
    rng = np.random.default_rng(5)
    params0 = _random_init_params(rng, 2, 2, 3)
    assign0 = jnp.asarray(np.r_[np.zeros(98, dtype=int), np.ones(2, dtype=int)])
    params, assign, iters, status = em.train_em(
        params0, assign0, jnp.asarray(z), jnp.asarray(x), v, patterns, pid
    )
    assert int(status) == em.STATUS_INIT_ABORT
    assert int(iters) == 0
    np.testing.assert_array_equal(np.asarray(params.A), np.asarray(params0.A))


def test_multistart_selects_best_and_handles_nan():
    z, x, labels, _ = _make_mixture_data(seed=6, n=300, T=6)
    v, patterns, pid = _packed(z, x)
    rng = np.random.default_rng(7)
    R, C, d, l = 4, 2, 2, 3
    params0 = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[_random_init_params(rng, C, d, l) for _ in range(R)],
    )
    assigns = [rng.integers(0, C, size=300) for _ in range(R - 1)]
    # last start trips the init guard → objective from random params
    assigns.append(np.r_[np.zeros(298, dtype=int), np.ones(2, dtype=int)])
    assign0 = jnp.asarray(np.stack(assigns))

    params, assign, iters, status, obj = em.train_em_multistart(
        params0, assign0, jnp.asarray(z), jnp.asarray(x), v, patterns, pid,
        n_steps=50,
    )
    obj = np.asarray(obj)
    status = np.asarray(status)
    assert status[-1] == em.STATUS_INIT_ABORT
    assert np.isfinite(obj[:3]).all()
    # trained starts beat the untrained one
    assert obj[:3].max() > obj[-1]


def test_model_loglik_matches_direct_sum():
    z, x, _, _ = _make_mixture_data(seed=8, n=200, T=5)
    v, patterns, pid = _packed(z, x)
    rng = np.random.default_rng(9)
    assign = jnp.asarray(rng.integers(0, 2, size=200))
    params = em.mstep(jnp.asarray(z), jnp.asarray(x), assign, n_clusters=2)
    T = z.shape[0]
    ll = np.asarray(em.estep_logliks(params, v, patterns, pid, T=T))
    pi = np.asarray(params.pi)
    want = np.sum(np.log(np.sum(pi[:, None] * np.exp(ll), axis=0)))
    got = float(em.model_loglik(params, v, patterns, pid, T=T))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_train_em_sorted_matches_train_em():
    """train(fast=True)'s dense route (train_em with per-pattern
    precomputed inverses) must reproduce the default train_em exactly in
    f64: same statuses, same assignments, same parameters."""
    z, x, labels, true = _make_mixture_data(seed=3, n=400, T=6)
    rng = np.random.default_rng(2)
    lens = rng.choice([3, 5, 6], size=400)
    tmask = np.arange(6)[:, None] < lens[None, :]
    z[~tmask] = np.nan
    x[~tmask] = np.nan
    v, patterns, pid = _packed(z, x)
    C, d, l = 2, 2, 3
    params0 = _random_init_params(rng, C, d, l)
    assign0 = jnp.asarray(rng.integers(0, C, size=400), jnp.int32)

    p_ref, a_ref, it_ref, st_ref = em.train_em(
        params0, assign0, jnp.asarray(z), jnp.asarray(x), v, patterns, pid,
        n_steps=50,
    )
    p_s, a_s, it_s, st_s = em.train_em(
        params0, assign0, jnp.asarray(z), jnp.asarray(x), v, patterns, pid,
        n_steps=50, method="inverse",
    )
    assert int(st_ref) == int(st_s)
    assert int(it_ref) == int(it_s)
    np.testing.assert_array_equal(np.asarray(a_ref), np.asarray(a_s))
    for fa, fb in zip(p_ref, p_s):
        np.testing.assert_allclose(
            np.asarray(fa), np.asarray(fb), rtol=1e-9, atol=1e-10
        )


def test_train_em_markov_matches_train_em():
    """The fused O(T) Markov EM path must reproduce train_em exactly in
    f64 on suffix-missing data: same statuses, assignments, parameters —
    no pattern sorting involved."""
    z, x, labels, true = _make_mixture_data(seed=3, n=400, T=6)
    rng = np.random.default_rng(2)
    lens = rng.choice([3, 5, 6], size=400)
    tmask = np.arange(6)[:, None] < lens[None, :]
    z[~tmask] = np.nan
    x[~tmask] = np.nan
    v, patterns, pid = _packed(z, x)
    C, d, l = 2, 2, 3
    params0 = _random_init_params(rng, C, d, l)
    assign0 = jnp.asarray(rng.integers(0, C, size=400), jnp.int32)

    p_ref, a_ref, it_ref, st_ref = em.train_em(
        params0, assign0, jnp.asarray(z), jnp.asarray(x), v, patterns, pid,
        n_steps=50,
    )
    p_m, a_m, it_m, st_m = em.train_em_markov(
        params0,
        assign0,
        jnp.asarray(z),
        jnp.asarray(x),
        jnp.asarray(lens, jnp.int32),
        n_steps=50,
    )
    assert int(st_ref) == int(st_m)
    assert int(it_ref) == int(it_m)
    np.testing.assert_array_equal(np.asarray(a_ref), np.asarray(a_m))
    for fa, fb in zip(p_ref, p_m):
        np.testing.assert_allclose(
            np.asarray(fa), np.asarray(fb), rtol=1e-9, atol=1e-10
        )


@pytest.mark.slow
def test_train_em_markov_grid_kernel_regime():
    """T=20 routes the canonical (long-T) Φ layout inside train_em_markov
    — the whole training loop must still reproduce train_em exactly in
    f64."""
    z, x, labels, true = _make_mixture_data(seed=5, n=220, T=20)
    rng = np.random.default_rng(7)
    lens = rng.choice([10, 16, 20], size=220)
    tmask = np.arange(20)[:, None] < lens[None, :]
    z[~tmask] = np.nan
    x[~tmask] = np.nan
    v, patterns, pid = _packed(z, x)
    C, d, l = 2, 2, 3
    params0 = _random_init_params(rng, C, d, l)
    assign0 = jnp.asarray(rng.integers(0, C, size=220), jnp.int32)

    p_ref, a_ref, it_ref, st_ref = em.train_em(
        params0, assign0, jnp.asarray(z), jnp.asarray(x), v, patterns, pid,
        n_steps=40,
    )
    p_m, a_m, it_m, st_m = em.train_em_markov(
        params0,
        assign0,
        jnp.asarray(z),
        jnp.asarray(x),
        jnp.asarray(lens, jnp.int32),
        n_steps=40,
    )
    assert int(st_ref) == int(st_m)
    assert int(it_ref) == int(it_m)
    np.testing.assert_array_equal(np.asarray(a_ref), np.asarray(a_m))
    for fa, fb in zip(p_ref, p_m):
        np.testing.assert_allclose(
            np.asarray(fa), np.asarray(fb), rtol=1e-9, atol=1e-10
        )


def test_train_em_masked_kalman_matches_train_em_interior():
    """The O(T) masked-filter trainer must reproduce train_em exactly in
    f64 under INTERIOR (random per-coordinate) missingness — same
    statuses, iteration counts, assignments and parameters.  This is the
    regime where the dense path's (T(d+l))² joint is the only reference
    oracle and stops being feasible at long T."""
    z, x, labels, true = _make_mixture_data(seed=11, n=300, T=6)
    rng = np.random.default_rng(4)
    z[rng.random(z.shape) < 0.15] = np.nan
    x[rng.random(x.shape) < 0.15] = np.nan
    v, patterns, pid = _packed(z, x)
    C, d, l = 2, 2, 3
    params0 = _random_init_params(rng, C, d, l)
    assign0 = jnp.asarray(rng.integers(0, C, size=300), jnp.int32)

    p_ref, a_ref, it_ref, st_ref = em.train_em(
        params0, assign0, jnp.asarray(z), jnp.asarray(x), v, patterns, pid,
        n_steps=50,
    )
    p_k, a_k, it_k, st_k = em.train_em_masked_kalman(
        params0, assign0, jnp.asarray(z), jnp.asarray(x), n_steps=50
    )
    assert int(st_ref) == int(st_k) == em.STATUS_CONVERGED
    assert int(it_ref) == int(it_k)
    np.testing.assert_array_equal(np.asarray(a_ref), np.asarray(a_k))
    for fa, fb in zip(p_ref, p_k):
        np.testing.assert_allclose(
            np.asarray(fa), np.asarray(fb), rtol=1e-9, atol=1e-10
        )


def test_train_em_masked_kalman_init_abort():
    """A near-empty initial assignment must return untouched with
    STATUS_INIT_ABORT, exactly like train_em."""
    z, x, labels, true = _make_mixture_data(seed=12, n=60, T=5)
    rng = np.random.default_rng(5)
    C, d, l = 2, 2, 3
    params0 = _random_init_params(rng, C, d, l)
    assign0 = jnp.asarray(np.r_[np.zeros(58), np.ones(2)], jnp.int32)
    p_k, a_k, it_k, st_k = em.train_em_masked_kalman(
        params0, assign0, jnp.asarray(z), jnp.asarray(x), n_steps=50
    )
    assert int(st_k) == em.STATUS_INIT_ABORT
    assert int(it_k) == 0
    for fa, fb in zip(p_k, params0):
        np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))


def test_complete_data_loglik_masked_kalman_matches_dense():
    """The filter-based complete-data objective must equal the dense
    pattern-grouped one under interior missingness (f64, fresh-E rule)."""
    z, x, labels, true = _make_mixture_data(seed=13, n=200, T=5)
    rng = np.random.default_rng(6)
    z[rng.random(z.shape) < 0.2] = np.nan
    x[rng.random(x.shape) < 0.2] = np.nan
    v, patterns, pid = _packed(z, x)
    params = _random_init_params(rng, 2, 2, 3)
    q_dense = float(
        em.complete_data_loglik(params, v, patterns, pid, T=z.shape[0])
    )
    q_filter = float(
        em.complete_data_loglik_masked_kalman(
            params, jnp.asarray(z), jnp.asarray(x)
        )
    )
    np.testing.assert_allclose(q_filter, q_dense, rtol=1e-10)


def test_train_em_masked_kalman_all_nan_instance():
    """An all-NaN instance contributes logpdf exactly 0 to every cluster
    (the reference's empty-marginal convention) — the filter trainer must
    still match train_em bit-for-bit with one present."""
    z, x, labels, true = _make_mixture_data(seed=14, n=150, T=5)
    rng = np.random.default_rng(8)
    z[rng.random(z.shape) < 0.1] = np.nan
    x[rng.random(x.shape) < 0.1] = np.nan
    z[:, 0], x[:, 0] = np.nan, np.nan  # one fully-missing instance
    v, patterns, pid = _packed(z, x)
    params0 = _random_init_params(rng, 2, 2, 3)
    assign0 = jnp.asarray(rng.integers(0, 2, size=150), jnp.int32)

    p_ref, a_ref, it_ref, st_ref = em.train_em(
        params0, assign0, jnp.asarray(z), jnp.asarray(x), v, patterns, pid,
        n_steps=40,
    )
    p_k, a_k, it_k, st_k = em.train_em_masked_kalman(
        params0, assign0, jnp.asarray(z), jnp.asarray(x), n_steps=40
    )
    assert (int(st_ref), int(it_ref)) == (int(st_k), int(it_k))
    np.testing.assert_array_equal(np.asarray(a_ref), np.asarray(a_k))
    for fa, fb in zip(p_ref, p_k):
        np.testing.assert_allclose(
            np.asarray(fa), np.asarray(fb), rtol=1e-9, atol=1e-10
        )
