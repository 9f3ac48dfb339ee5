"""The O(T) Markov-factorized joint log-density must equal the dense
joint-covariance path exactly (f64) for suffix missingness — including
length-1 rows — and must scale to T where the dense path cannot go."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from multimodal_trajectory_modeling_tpu import ops
from multimodal_trajectory_modeling_tpu.models import em
from multimodal_trajectory_modeling_tpu.ops import markov


def _mixture(seed, C, T, n, d, l, min_len=1):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    lens = rng.integers(min_len, T + 1, size=n)
    for Ln in np.unique(lens):
        z[Ln:, lens == Ln] = np.nan
        x[Ln:, lens == Ln] = np.nan
    m = rng.normal(size=(C, d))
    A = rng.normal(scale=0.3, size=(C, d, d))
    H = rng.normal(size=(C, d, l))

    def spd(k):
        M = rng.normal(size=(k, k))
        return M @ M.T / k + np.eye(k)

    S = np.stack([spd(d) for _ in range(C)])
    G = np.stack([spd(d) for _ in range(C)])
    L = np.stack([spd(l) for _ in range(C)])
    return (
        jnp.asarray(z),
        jnp.asarray(x),
        jnp.asarray(lens, jnp.int32),
        tuple(map(jnp.asarray, (m, S, A, G, H, L))),
    )


def _dense_logliks(z, x, params_t):
    """Oracle: per-cluster dense joint moments + masked grouped logpdf."""
    m, S, A, G, H, L = params_t
    T = z.shape[0]
    v = em.pack_joint(z, x)
    patterns, pid = ops.pattern_groups(np.asarray(v))
    patterns, pid = jnp.asarray(patterns), jnp.asarray(pid)
    C = m.shape[0]
    rows = []
    for c in range(C):
        mean = ops.joint_mean(T, m[c], A[c], H[c])
        cov = ops.joint_cov(T, S[c], A[c], G[c], H[c], L[c])
        rows.append(
            ops.masked_mvn_logpdf_grouped(
                v, mean, cov, patterns, pid, method="solve"
            )
        )
    return jnp.stack(rows)


def test_markov_equals_dense_suffix():
    z, x, lens, params_t = _mixture(0, C=3, T=7, n=240, d=2, l=3)
    W = markov.markov_cluster_weights(*params_t)
    got = np.asarray(markov.markov_suffix_logliks(z, x, lens, W))
    want = np.asarray(_dense_logliks(z, x, params_t))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_markov_length_one_rows():
    """len=1 rows: no transitions, one measurement, init only."""
    z, x, lens, params_t = _mixture(1, C=2, T=5, n=64, d=3, l=2, min_len=1)
    lens = lens.at[:8].set(1)
    z = z.at[1:, :8].set(jnp.nan)
    x = x.at[1:, :8].set(jnp.nan)
    W = markov.markov_cluster_weights(*params_t)
    got = np.asarray(markov.markov_suffix_logliks(z, x, lens, W))
    want = np.asarray(_dense_logliks(z, x, params_t))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_markov_long_T_exact_and_scaling():
    """T=96 (dense joint = 480² per cluster — near the practical dense
    ceiling): still exact; then T=2048 runs O(T) without materializing
    any T×T object (the dense path would need a 10240² joint)."""
    z, x, lens, params_t = _mixture(2, C=2, T=96, n=40, d=2, l=3, min_len=40)
    W = markov.markov_cluster_weights(*params_t)
    got = np.asarray(markov.markov_suffix_logliks(z, x, lens, W))
    want = np.asarray(_dense_logliks(z, x, params_t))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)

    T_big = 2048
    rng = np.random.default_rng(3)
    # stable chain so values stay finite at T=2048
    m, S, A, G, H, L = (np.asarray(p) for p in params_t)
    A = 0.4 * A / np.abs(np.linalg.eigvals(A)).max(axis=-1)[:, None, None]
    params_big = tuple(map(jnp.asarray, (m, S, A, G, H, L)))
    zb = np.zeros((T_big, 16, 2))
    zb[0] = rng.normal(size=(16, 2))
    for t in range(T_big - 1):
        zb[t + 1] = zb[t] @ np.asarray(A[0]) + 0.1 * rng.normal(size=(16, 2))
    xb = zb @ np.asarray(H[0]) + rng.normal(size=(T_big, 16, 3))
    lens_b = jnp.full((16,), T_big, jnp.int32)
    Wb = markov.markov_cluster_weights(*params_big)
    ll = markov.markov_suffix_logliks(
        jnp.asarray(zb), jnp.asarray(xb), lens_b, Wb
    )
    assert np.all(np.isfinite(np.asarray(ll)))


def test_suffix_mask_helpers():
    v = np.array([[1, 1, 1], [0, 1, 0], [1, 1, 0]], dtype=bool)
    assert not markov.is_suffix_mask(v)
    v2 = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0]], dtype=bool)
    assert markov.is_suffix_mask(v2)
    np.testing.assert_array_equal(
        np.asarray(markov.suffix_lengths(jnp.asarray(v2))), [3, 2, 1]
    )


def test_markov_assign_kernel_matches_logliks():
    """The Markov E step (``em.estep_assign_markov``) must equal
    argmax(log pi + markov logliks), counts and switches exactly."""
    from multimodal_trajectory_modeling_tpu.models import em

    rng = np.random.default_rng(5)
    C, T, n, d, l = 3, 6, 300, 2, 3
    z, x, lens, params_t = _mixture(4, C=C, T=T, n=n, d=d, l=l)
    m, S, A, G, H, L = params_t
    pi = jnp.asarray(rng.dirichlet(np.ones(C)))
    params = em.MixtureParams(pi=pi, m=m, S=S, A=A, G=G, H=H, L=L)

    W = markov.markov_cluster_weights(*params_t)
    ll = markov.markov_suffix_logliks(z, x, lens, W)
    want = np.argmax(np.log(np.asarray(pi))[:, None] + np.asarray(ll), axis=0)
    prev = jnp.asarray(rng.integers(0, C, size=n), jnp.int32)

    z_t = jnp.asarray(np.asarray(z).transpose(0, 2, 1).reshape(T * d, n))
    x_t = jnp.asarray(np.asarray(x).transpose(0, 2, 1).reshape(T * l, n))
    z_t = jnp.where(jnp.isfinite(z_t), z_t, jnp.nan)
    a, c, w = em.estep_assign_markov(params, z_t, x_t, lens, prev, T=T)
    np.testing.assert_array_equal(np.asarray(a), want)
    np.testing.assert_array_equal(
        np.asarray(c), np.bincount(want, minlength=C)
    )
    assert int(w) == int(np.sum(want != np.asarray(prev)))


def test_emstep_markov_xla_matches_pallas():
    """The Φ-pass EM step (``em.emstep_markov``) must equal the plain
    row-major reference step exactly in f64 (same assignments, counts,
    switches, params)."""
    from multimodal_trajectory_modeling_tpu.models import em

    rng = np.random.default_rng(6)
    C, T, n, d, l = 3, 6, 320, 2, 3
    z, x, lens, params_t = _mixture(7, C=C, T=T, n=n, d=d, l=l)
    m, S, A, G, H, L = params_t
    pi = jnp.asarray(rng.dirichlet(np.ones(C)))
    params = em.MixtureParams(pi=pi, m=m, S=S, A=A, G=G, H=H, L=L)
    prev = jnp.asarray(rng.integers(0, C, size=n), jnp.int32)

    z_t = jnp.asarray(np.asarray(z).transpose(0, 2, 1).reshape(T * d, n))
    x_t = jnp.asarray(np.asarray(x).transpose(0, 2, 1).reshape(T * l, n))
    p1, a1, c1, w1 = em.emstep_markov(params, z_t, x_t, lens, prev, T=T)
    p2, a2, c2, w2 = em.emstep_markov_xla(params, z, x, lens, prev)
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
    assert int(w1) == int(w2)
    for fa, fb in zip(p1, p2):
        np.testing.assert_allclose(
            np.asarray(fa), np.asarray(fb), rtol=1e-9, atol=1e-10
        )


def test_model_loglik_markov_matches_dense():
    from multimodal_trajectory_modeling_tpu.models import em

    rng = np.random.default_rng(8)
    C, T, n, d, l = 3, 6, 250, 2, 3
    z, x, lens, params_t = _mixture(9, C=C, T=T, n=n, d=d, l=l)
    m, S, A, G, H, L = params_t
    pi = jnp.asarray(rng.dirichlet(np.ones(C)))
    params = em.MixtureParams(pi=pi, m=m, S=S, A=A, G=G, H=H, L=L)
    v = em.pack_joint(z, x)
    patterns, pid = ops.pattern_groups(np.asarray(v))
    want = float(
        em.model_loglik(
            params, v, jnp.asarray(patterns), jnp.asarray(pid), T=T
        )
    )
    got = float(em.model_loglik_markov(params, z, x, lens))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_all_nan_rows_fail_suffix_gate():
    """A dataset containing an all-NaN instance (len 0) must NOT route
    the Markov path — the dense kernels give such rows logpdf 0.0 (the
    reference semantics); the gate returns None."""
    from multimodal_trajectory_modeling_tpu.models.mixture import (
        MMLinGaussSS_marginalizable,
    )

    T, d, l = 4, 2, 3
    # pattern rows: full, half, empty
    patterns = np.stack(
        [
            np.ones(T * (d + l), dtype=bool),
            np.concatenate(
                [
                    np.repeat(np.arange(T) < 2, d),
                    np.repeat(np.arange(T) < 2, l),
                ]
            ),
            np.zeros(T * (d + l), dtype=bool),
        ]
    )
    assert (
        MMLinGaussSS_marginalizable._suffix_pattern_lens(patterns, T, d, l)
        is None
    )
    # without the empty row the gate passes
    lens = MMLinGaussSS_marginalizable._suffix_pattern_lens(
        patterns[:2], T, d, l
    )
    np.testing.assert_array_equal(lens, [4, 2])


def test_train_em_markov_single_cluster():
    from multimodal_trajectory_modeling_tpu.models import em

    rng = np.random.default_rng(12)
    T, n, d, l = 5, 120, 2, 2
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    lens = np.full(n, T, dtype=np.int32)
    params0 = em.MixtureParams(
        pi=jnp.ones(1),
        m=jnp.asarray(rng.normal(size=(1, d))),
        S=jnp.asarray(np.eye(d)[None]),
        A=jnp.asarray(rng.normal(scale=0.3, size=(1, d, d))),
        G=jnp.asarray(np.eye(d)[None]),
        H=jnp.asarray(rng.normal(size=(1, d, l))),
        L=jnp.asarray(np.eye(l)[None]),
    )
    p, a, it, st = em.train_em_markov(
        params0,
        jnp.zeros(n, jnp.int32),
        jnp.asarray(z),
        jnp.asarray(x),
        jnp.asarray(lens),
        n_steps=10,
    )
    # single cluster: first E step changes nothing -> converged
    assert int(st) == em.STATUS_CONVERGED
    np.testing.assert_array_equal(np.asarray(a), np.zeros(n))
    assert np.all(np.isfinite(np.asarray(p.A)))


def test_markov_f32_long_T_accuracy():
    """f32 chain-rule accumulation at T=512 stays within ~1e-4 relative
    of f64 (documents the production-precision behavior at long T)."""
    T, n, d, l, C = 512, 32, 2, 3, 2
    rng = np.random.default_rng(13)
    _, _, _, params_t = _mixture(2, C=C, T=8, n=4, d=d, l=l)
    m, S, A, G, H, L = (np.asarray(p) for p in params_t)
    A = 0.4 * A / np.abs(np.linalg.eigvals(A)).max(axis=-1)[:, None, None]
    zb = np.zeros((T, n, d))
    zb[0] = rng.normal(size=(n, d))
    for t in range(T - 1):
        zb[t + 1] = zb[t] @ A[0] + 0.1 * rng.normal(size=(n, d))
    xb = zb @ H[0] + rng.normal(size=(T, n, l))
    lens = jnp.full((n,), T, jnp.int32)
    p64 = tuple(jnp.asarray(p, jnp.float64) for p in (m, S, A, G, H, L))
    p32 = tuple(jnp.asarray(p, jnp.float32) for p in (m, S, A, G, H, L))
    ll64 = np.asarray(
        markov.markov_suffix_logliks(
            jnp.asarray(zb), jnp.asarray(xb), lens,
            markov.markov_cluster_weights(*p64),
        )
    )
    ll32 = np.asarray(
        markov.markov_suffix_logliks(
            jnp.asarray(zb, jnp.float32),
            jnp.asarray(xb, jnp.float32),
            lens,
            markov.markov_cluster_weights(*p32),
        )
    )
    rel = np.max(np.abs(ll32 - ll64) / np.abs(ll64))
    assert rel < 1e-4, rel


def test_markov_em_fused_longT_matches_small_T_kernel():
    """The canonical (long-T) Φ layout must reproduce the compact layout
    exactly in f64: assign, counts, switches, g statistics, objective —
    in argmax and prev modes."""
    from multimodal_trajectory_modeling_tpu.ops import (
        markov as mops,
        markov_phi as pm,
    )

    rng = np.random.default_rng(21)
    C, T, n, d, l = 3, 6, 300, 2, 3
    z, x, lens, params_t = _mixture(22, C=C, T=T, n=n, d=d, l=l)
    pi = jnp.asarray(rng.dirichlet(np.ones(C)))
    Wg = mops.markov_em_weights(*params_t)
    Wg = Wg.at[:, -1].add(jnp.log(pi))
    prev = jnp.asarray(rng.integers(0, C, size=n), jnp.int32)
    z_t = jnp.asarray(np.asarray(z).transpose(0, 2, 1).reshape(T * d, n))
    x_t = jnp.asarray(np.asarray(x).transpose(0, 2, 1).reshape(T * l, n))
    u = pm.pack_markov_u(z_t, x_t, T=T, d=d, l=l, pad_to=128)
    phi_c = pm.markov_materialize_features(u, lens, T=T, d=d, l=l)
    phi_l = pm.markov_materialize_features_longT(
        z_t, x_t, lens, T=T, d=d, l=l
    )
    for mode in ("argmax", "prev"):
        a0, c0, w0, g0, o0 = pm.markov_em_from_features(
            phi_c, lens, prev, Wg, T=T, d=d, l=l, assign_mode=mode
        )
        a1, c1, w1, g1, o1 = pm.markov_em_from_features(
            phi_l, lens, prev, Wg, T=T, d=d, l=l, assign_mode=mode,
            layout="canonical",
        )
        np.testing.assert_array_equal(np.asarray(a0), np.asarray(a1))
        np.testing.assert_array_equal(np.asarray(c0), np.asarray(c1))
        assert int(w0) == int(w1)
        np.testing.assert_allclose(
            np.asarray(g1), np.asarray(g0), rtol=1e-9, atol=1e-9
        )
        np.testing.assert_allclose(float(o1), float(o0), rtol=1e-12)


def test_one_dispatch_fori_loop_matches_host_chained_steps():
    """The bench/production pattern — K fused EM iterations inside ONE
    jitted ``lax.fori_loop`` (the shape ``train_em_markov``'s while_loop
    compiles) — must produce the same trajectory as K host-chained
    ``emstep_markov`` calls: identical assignments, params to ~1 ulp
    (the whole-loop compilation fuses the tiny M-solve arithmetic
    differently than the per-step jits — observed 5.6e-17 on π)."""
    C, T, n, d, l = 3, 5, 200, 2, 2
    z, x, lens, params_t = _mixture(7, C=C, T=T, n=n, d=d, l=l, min_len=2)
    m, S, A, G, H, L = params_t
    rng = np.random.default_rng(7)
    pi = jnp.asarray(rng.dirichlet(np.ones(C)))
    params0 = em.MixtureParams(pi, m, S, A, G, H, L)
    z_t = jnp.asarray(np.asarray(z).transpose(0, 2, 1).reshape(T * d, n))
    x_t = jnp.asarray(np.asarray(x).transpose(0, 2, 1).reshape(T * l, n))
    u = em.pack_markov_batch(z_t, x_t, T=T, d=d, l=l)
    assign0 = jnp.asarray(rng.integers(0, C, size=n), jnp.int32)
    K = 4

    p_host, a_host = params0, assign0
    for _ in range(K):
        p_host, a_host, _c, _w = em.emstep_markov(
            p_host, z_t, x_t, lens, a_host, T=T, u=u
        )

    @jax.jit
    def run_k(params, assign, z_t, x_t, lens, u):
        def body(_i, st):
            p, a = st
            p2, a2, _c, _w = em.emstep_markov(
                p, z_t, x_t, lens, a, T=T, u=u
            )
            return (p2, a2)

        return jax.lax.fori_loop(0, K, body, (params, assign))

    p_loop, a_loop = run_k(params0, assign0, z_t, x_t, lens, u)
    np.testing.assert_array_equal(np.asarray(a_loop), np.asarray(a_host))
    for leaf_l, leaf_h in zip(
        jax.tree_util.tree_leaves(p_loop),
        jax.tree_util.tree_leaves(p_host),
    ):
        np.testing.assert_allclose(
            np.asarray(leaf_l), np.asarray(leaf_h), rtol=1e-12, atol=1e-14
        )


def _reference_phi_pass(feats, Wg, prev, mode):
    """Plain NumPy Φ pass over row-major canonical features (n, F)."""
    feats = np.asarray(feats)
    prev = np.asarray(prev)
    C = Wg.shape[0]
    scores = feats @ np.asarray(Wg).T  # (n, C)
    a = prev if mode == "prev" else np.argmax(scores, axis=1)
    onehot = (a[:, None] == np.arange(C)[None, :]).astype(feats.dtype)
    obj = 0.0 if mode == "prev" else float(np.sum(np.max(scores, axis=1)))
    return (
        a,
        onehot.sum(axis=0).astype(np.int64),
        int(np.sum(a != prev)),
        feats.T @ onehot,
        obj,
    )


def test_markov_em_from_features_matches_packed():
    """The compact-layout route (one-time Φ build via
    markov_materialize_features + per-iteration Φ pass) must reproduce a
    plain NumPy pass over the row-major canonical features in f64 — both
    argmax and prev modes, lane padding included: assignment/counts/
    switches exactly, statistics and objective to f64 reassociation."""
    from multimodal_trajectory_modeling_tpu.ops import (
        markov as mops,
        markov_phi as pm,
    )

    rng = np.random.default_rng(31)
    C, T, n, d, l = 3, 6, 300, 2, 3
    z, x, lens, params_t = _mixture(32, C=C, T=T, n=n, d=d, l=l)
    pi = jnp.asarray(rng.dirichlet(np.ones(C)))
    Wg = mops.markov_em_weights(*params_t)
    Wg = Wg.at[:, -1].add(jnp.log(pi))
    prev = jnp.asarray(rng.integers(0, C, size=n), jnp.int32)
    z_t = jnp.asarray(np.asarray(z).transpose(0, 2, 1).reshape(T * d, n))
    x_t = jnp.asarray(np.asarray(x).transpose(0, 2, 1).reshape(T * l, n))
    u = pm.pack_markov_u(z_t, x_t, T=T, d=d, l=l, pad_to=128)
    phi = pm.markov_materialize_features(u, lens, T=T, d=d, l=l)
    Fc_pad, uniq, pos = pm.markov_compact_spec(T, d, l)
    assert phi.shape == (Fc_pad, 384) and pos.shape[0] == Wg.shape[1]
    feats = mops.markov_em_features(z, x, lens)
    for mode in ("argmax", "prev"):
        a0, c0, w0, g0, o0 = _reference_phi_pass(feats, Wg, prev, mode)
        a1, c1, w1, g1, o1 = pm.markov_em_from_features(
            phi, lens, prev, Wg, T=T, d=d, l=l, assign_mode=mode,
        )
        np.testing.assert_array_equal(a0, np.asarray(a1))
        np.testing.assert_array_equal(c0, np.asarray(c1))
        assert w0 == int(w1)
        np.testing.assert_allclose(
            np.asarray(g1), g0, rtol=1e-12, atol=1e-12
        )
        np.testing.assert_allclose(float(o1), o0, rtol=1e-12)


def test_train_em_markov_precompute_matches():
    """train_em_markov (materialized Φ, one Φ pass per iteration) must
    produce the same trained parameters, assignment, iteration count and
    status as the dense-joint oracle train_em (f64)."""
    from multimodal_trajectory_modeling_tpu.models import em

    C, T, n, d, l = 3, 6, 400, 2, 3
    z, x, lens, params_t = _mixture(41, C=C, T=T, n=n, d=d, l=l)
    m, S, A, G, H, L = params_t
    params0 = em.MixtureParams(
        pi=jnp.ones(C) / C, m=m, S=S, A=A, G=G, H=H, L=L
    )
    rng = np.random.default_rng(42)
    assign0 = jnp.asarray(rng.integers(0, C, size=n), jnp.int32)
    v = em.pack_joint(z, x)
    patterns, pid = ops.pattern_groups(np.asarray(v))
    p0, a0, it0, st0 = em.train_em(
        params0, assign0, z, x, v, jnp.asarray(patterns),
        jnp.asarray(pid), n_steps=20,
    )
    p1, a1, it1, st1 = em.train_em_markov(
        params0, assign0, z, x, lens, n_steps=20
    )
    a0, a1 = np.asarray(a0), np.asarray(a1)
    it0, st0, it1, st1 = int(it0), int(st0), int(it1), int(st1)
    assert (it0, st0) == (it1, st1)
    np.testing.assert_array_equal(a0, a1)
    for leaf0, leaf1 in zip(jax.tree.leaves(p0), jax.tree.leaves(p1)):
        np.testing.assert_allclose(
            np.asarray(leaf1), np.asarray(leaf0), rtol=1e-9, atol=1e-12
        )


def test_suffix_logliks_markov_phi_route_matches_xla():
    """The suffix inference route (slice-pair formulation) must equal
    the canonical Φ contracted with the E weights exactly in f64 — and
    both equal the dense masked marginal (the slice-pair side is pinned
    against dense elsewhere)."""
    from multimodal_trajectory_modeling_tpu.ops import (
        markov as mops,
        markov_phi as pm,
    )

    C, T, n, d, l = 3, 24, 150, 2, 2
    z, x, lens, params_t = _mixture(7, C=C, T=T, n=n, d=d, l=l)
    m, S, A, G, H, L = params_t
    params = em.MixtureParams(
        pi=jnp.ones(C) / C, m=m, S=S, A=A, G=G, H=H, L=L
    )
    a = em.suffix_logliks_markov(params, z, x, lens)
    z_t = jnp.transpose(z, (0, 2, 1)).reshape(T * d, n)
    x_t = jnp.transpose(x, (0, 2, 1)).reshape(T * l, n)
    phi = pm.markov_materialize_features_longT(z_t, x_t, lens, T=T, d=d, l=l)
    Wg = mops.markov_em_weights(*params_t)
    b = Wg @ phi[: Wg.shape[1]]
    np.testing.assert_allclose(
        np.asarray(b), np.asarray(a), rtol=1e-12, atol=1e-12
    )


def test_markov_materialize_features_longT_matches_xla_features():
    """The long-T materializer must be the row-major feature builder
    (ops/markov.py:markov_em_features) transposed with zero row padding,
    and the canonical-layout Φ pass must reproduce the plain NumPy pass
    over those features (f64)."""
    from multimodal_trajectory_modeling_tpu.ops import (
        markov as mops,
        markov_phi as pm,
    )

    rng = np.random.default_rng(51)
    C, T, n, d, l = 3, 24, 260, 2, 3
    z, x, lens, params_t = _mixture(52, C=C, T=T, n=n, d=d, l=l)
    pi = jnp.asarray(rng.dirichlet(np.ones(C)))
    z_t = jnp.asarray(np.asarray(z).transpose(0, 2, 1).reshape(T * d, n))
    x_t = jnp.asarray(np.asarray(x).transpose(0, 2, 1).reshape(T * l, n))

    phi = pm.markov_materialize_features_longT(
        z_t, x_t, lens, T=T, d=d, l=l
    )
    feats = mops.markov_em_features(z, x, lens)  # (n, F)
    F = feats.shape[1]
    np.testing.assert_allclose(
        np.asarray(phi[:F, :n]).T, np.asarray(feats),
        rtol=1e-12, atol=1e-12,
    )
    assert np.all(np.asarray(phi[F:, :]) == 0.0)

    Wg = mops.markov_em_weights(*params_t)
    Wg = Wg.at[:, -1].add(jnp.log(pi))
    prev = jnp.asarray(rng.integers(0, C, size=n), jnp.int32)
    a0, c0, w0, g0, o0 = _reference_phi_pass(feats, Wg, prev, "argmax")
    a1, c1, w1, g1, o1 = pm.markov_em_from_features(
        phi, lens, prev, Wg, T=T, d=d, l=l, layout="canonical",
    )
    np.testing.assert_array_equal(a0, np.asarray(a1))
    np.testing.assert_array_equal(c0, np.asarray(c1))
    assert w0 == int(w1)
    np.testing.assert_allclose(np.asarray(g1), g0, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(float(o1), o0, rtol=1e-12)


def test_markov_materialize_features_longT_narrow_store():
    """The long-T materializer's narrow-store path must be bit-identical
    to casting the wide Φ — the bf16 Φ opt-in then behaves the same on
    the canonical route as on the compact route."""
    from multimodal_trajectory_modeling_tpu.ops import markov_phi as pm

    C, T, n, d, l = 2, 24, 260, 2, 3
    z, x, lens, _params_t = _mixture(71, C=C, T=T, n=n, d=d, l=l)
    z32 = jnp.asarray(np.asarray(z), jnp.float32)
    x32 = jnp.asarray(np.asarray(x), jnp.float32)
    z_t = jnp.transpose(z32, (0, 2, 1)).reshape(T * d, n)
    x_t = jnp.transpose(x32, (0, 2, 1)).reshape(T * l, n)

    wide = pm.markov_materialize_features_longT(
        z_t, x_t, lens, T=T, d=d, l=l
    )
    narrow = pm.markov_materialize_features_longT(
        z_t, x_t, lens, T=T, d=d, l=l, store_dtype=jnp.bfloat16,
    )
    assert narrow.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(narrow, np.float32),
        np.asarray(wide.astype(jnp.bfloat16), np.float32),
    )


def test_train_em_markov_longT_precompute_matches():
    """At T past the compact-layout gate, train_em_markov's canonical Φ
    route must reproduce the exact masked-filter trainer, which equals
    the dense marginal on suffix missingness (f64)."""
    from multimodal_trajectory_modeling_tpu.models import em

    C, T, n, d, l = 2, 80, 200, 3, 2  # T·s = 640 > 512 → longT route
    z, x, lens, params_t = _mixture(61, C=C, T=T, n=n, d=d, l=l, min_len=2)
    m, S, A, G, H, L = params_t
    params0 = em.MixtureParams(
        pi=jnp.ones(C) / C, m=m, S=S, A=A, G=G, H=H, L=L
    )
    rng = np.random.default_rng(62)
    assign0 = jnp.asarray(rng.integers(0, C, size=n), jnp.int32)
    assert not em.markov_packed_ok(T, d, l)
    p0, a0, it0, st0 = em.train_em_masked_kalman(
        params0, assign0, z, x, n_steps=8
    )
    p1, a1, it1, st1 = em.train_em_markov(
        params0, assign0, z, x, lens, n_steps=8
    )
    a0, a1 = np.asarray(a0), np.asarray(a1)
    it0, st0, it1, st1 = int(it0), int(st0), int(it1), int(st1)
    assert (it0, st0) == (it1, st1)
    np.testing.assert_array_equal(a0, a1)
    for leaf0, leaf1 in zip(jax.tree.leaves(p0), jax.tree.leaves(p1)):
        np.testing.assert_allclose(
            np.asarray(leaf1), np.asarray(leaf0), rtol=1e-9, atol=1e-12
        )


@pytest.mark.slow
def test_train_em_markov_multi_longT_matches_standalone():
    """Past the compact layout's T·s ≤ 512 gate the multi-restart trainer
    must route the canonical-layout materialized features and reproduce
    per-restart standalone train_em_markov runs exactly (f64)."""
    from multimodal_trajectory_modeling_tpu.models import em

    C, T, n, d, l = 2, 80, 160, 3, 2  # T·s = 640 > 512 → longT route
    z, x, lens, params_t = _mixture(71, C=C, T=T, n=n, d=d, l=l, min_len=2)
    rng = np.random.default_rng(72)
    R = 3

    def one_params(r):
        m, S, A, G, H, L = params_t
        jit_m = m + 0.2 * rng.normal(size=np.asarray(m).shape)
        return em.MixtureParams(
            pi=jnp.ones(C) / C, m=jnp.asarray(jit_m),
            S=S, A=A, G=G, H=H, L=L,
        )

    plist = [one_params(r) for r in range(R)]
    alist = [
        jnp.asarray(rng.integers(0, C, size=n), jnp.int32)
        for _ in range(R)
    ]
    pstack = jax.tree.map(lambda *xs: jnp.stack(xs), *plist)
    astack = jnp.stack(alist)
    pm, am, itm, stm = em.train_em_markov_multi(
        pstack, astack, z, x, lens, n_steps=6
    )
    for r in range(R):
        pr, ar, itr, str_ = em.train_em_markov(
            plist[r], alist[r], z, x, lens, n_steps=6
        )
        assert (int(itr), int(str_)) == (int(itm[r]), int(stm[r])), r
        np.testing.assert_array_equal(np.asarray(ar), np.asarray(am[r]))
        for lm, lr in zip(
            jax.tree.leaves(jax.tree.map(lambda a: a[r], pm)),
            jax.tree.leaves(pr),
        ):
            np.testing.assert_allclose(
                np.asarray(lm), np.asarray(lr), rtol=1e-9, atol=1e-12,
                err_msg=f"restart {r}",
            )


def test_train_em_markov_pool_longT_matches_standalone():
    """The slot-pool multistart at long T (canonical Φ window) must
    return per-candidate results identical to standalone runs (f64)."""
    from multimodal_trajectory_modeling_tpu.models import em

    C, T, n, d, l = 2, 80, 160, 3, 2
    z, x, lens, params_t = _mixture(81, C=C, T=T, n=n, d=d, l=l, min_len=2)
    rng = np.random.default_rng(82)
    n_cand = 3

    def one_params():
        m, S, A, G, H, L = params_t
        jit_m = m + 0.2 * rng.normal(size=np.asarray(m).shape)
        return em.MixtureParams(
            pi=jnp.ones(C) / C, m=jnp.asarray(jit_m),
            S=S, A=A, G=G, H=H, L=L,
        )

    plist = [one_params() for _ in range(n_cand)]
    alist = [
        rng.integers(0, C, size=n).astype(np.int32)
        for _ in range(n_cand)
    ]
    got = em.train_em_markov_pool(
        plist, alist, z, x, lens, R=2, n_steps=6, sync_every=2
    )
    assert len(got) == n_cand
    for i in range(n_cand):
        pr, ar, itr, str_ = em.train_em_markov(
            plist[i], jnp.asarray(alist[i]), z, x, lens, n_steps=6
        )
        pg, ag, ig, sg = got[i]
        assert (int(itr), int(str_)) == (int(ig), int(sg)), i
        np.testing.assert_array_equal(np.asarray(ar), np.asarray(ag))
        for lg, lr in zip(jax.tree.leaves(pg), jax.tree.leaves(pr)):
            np.testing.assert_allclose(
                np.asarray(lg), np.asarray(lr), rtol=1e-9, atol=1e-12,
                err_msg=f"cand {i}",
            )
