"""The O(T) Kalman-filter x-marginal must equal the dense observed
-moments masked-Gaussian path exactly (f64) for suffix missingness, and
scale to T where the dense (T·l)² covariance cannot go."""

import numpy as np
import pytest
import jax.numpy as jnp

from multimodal_trajectory_modeling_tpu import ops
from multimodal_trajectory_modeling_tpu.models import em
from multimodal_trajectory_modeling_tpu.ops import kalman

from tests.test_ops_markov import _mixture


def _dense_observed_logliks(x, params_t):
    m, S, A, G, H, L = params_t
    T = x.shape[0]
    vx = em.pack_observed(x)
    patterns, pid = ops.pattern_groups(np.asarray(vx))
    patterns, pid = jnp.asarray(patterns), jnp.asarray(pid)
    rows = []
    for c in range(m.shape[0]):
        mean = ops.observed_mean(T, m[c], A[c], H[c])
        cov = ops.observed_cov(T, S[c], A[c], G[c], H[c], L[c])
        rows.append(
            ops.masked_mvn_logpdf_grouped(
                vx, mean, cov, patterns, pid, method="solve"
            )
        )
    return jnp.stack(rows)


def test_kalman_equals_dense_observed():
    z, x, lens, params_t = _mixture(0, C=3, T=7, n=200, d=2, l=3)
    got = np.asarray(kalman.kalman_observed_logliks(x, lens, *params_t))
    want = np.asarray(_dense_observed_logliks(x, params_t))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_kalman_length_one_and_d_gt_l():
    z, x, lens, params_t = _mixture(1, C=2, T=5, n=64, d=4, l=2)
    lens = lens.at[:6].set(1)
    x = x.at[1:, :6].set(jnp.nan)
    got = np.asarray(kalman.kalman_observed_logliks(x, lens, *params_t))
    want = np.asarray(_dense_observed_logliks(x, params_t))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_kalman_long_T():
    """T=96: exact vs the (288)² dense observed covariance; T=2048 runs
    in O(T) (dense would need a 6144² matrix per cluster)."""
    z, x, lens, params_t = _mixture(2, C=2, T=96, n=24, d=2, l=3, min_len=30)
    got = np.asarray(kalman.kalman_observed_logliks(x, lens, *params_t))
    want = np.asarray(_dense_observed_logliks(x, params_t))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)

    T_big = 2048
    rng = np.random.default_rng(3)
    m, S, A, G, H, L = (np.asarray(p) for p in params_t)
    A = 0.4 * A / np.abs(np.linalg.eigvals(A)).max(axis=-1)[:, None, None]
    xb = jnp.asarray(rng.normal(size=(T_big, 8, 3)))
    lens_b = jnp.full((8,), T_big, jnp.int32)
    ll = kalman.kalman_observed_logliks(
        xb, lens_b, *map(jnp.asarray, (m, S, A, G, H, L))
    )
    assert np.all(np.isfinite(np.asarray(ll)))


def test_em_observed_logliks_kalman_wrapper():
    """The em-level wrapper must match the dense observed_logliks on
    MixtureParams input (f64, suffix missingness)."""
    from multimodal_trajectory_modeling_tpu.models import em

    rng = np.random.default_rng(30)
    z, x, lens, params_t = _mixture(31, C=3, T=6, n=150, d=2, l=3)
    m, S, A, G, H, L = params_t
    pi = jnp.asarray(rng.dirichlet(np.ones(3)))
    params = em.MixtureParams(pi=pi, m=m, S=S, A=A, G=G, H=H, L=L)
    got = np.asarray(em.observed_logliks_kalman(params, x, lens))
    vx = em.pack_observed(x)
    patterns, pid = ops.pattern_groups(np.asarray(vx))
    want = np.asarray(
        em.observed_logliks(
            params, vx, jnp.asarray(patterns), jnp.asarray(pid), T=6
        )
    )
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def _dense_masked_oracle(z, x, c_params):
    """Dense drop-rows/cols marginal via direct Cholesky on the joint."""
    import scipy.linalg as sla

    m, S, A, G, H, L = c_params
    T, n, _ = z.shape
    mean = np.asarray(ops.joint_mean(T, *map(jnp.asarray, (m, A, H))))
    cov = np.asarray(
        ops.joint_cov(T, *map(jnp.asarray, (S, A, G, H, L)))
    )
    v = np.concatenate(
        [
            z.transpose(1, 0, 2).reshape(n, -1),
            x.transpose(1, 0, 2).reshape(n, -1),
        ],
        axis=1,
    )
    out = np.zeros(n)
    for i in range(n):
        idx = np.flatnonzero(np.isfinite(v[i]))
        if idx.size == 0:
            continue
        sub = cov[np.ix_(idx, idx)]
        r = v[i, idx] - mean[idx]
        Lc = np.linalg.cholesky(sub)
        w = sla.solve_triangular(Lc, r, lower=True)
        out[i] = -0.5 * (
            2.0 * np.log(np.diag(Lc)).sum()
            + w @ w
            + idx.size * np.log(2.0 * np.pi)
        )
    return out


def test_masked_kalman_equals_dense_interior_missingness():
    """Arbitrary per-coordinate interior missingness: the O(T) partial-
    observation filter must reproduce the reference's dense drop-rows/cols
    marginal (marginalizable_state_space_model.py:741-773) exactly (f64),
    at T in {8, 64, 256}, including fully-missing rows -> 0.0."""
    rng = np.random.default_rng(7)
    d, l, C, n = 3, 2, 2, 16
    m = rng.normal(size=(C, d))
    A = rng.normal(scale=0.5, size=(C, d, d))
    A = 0.7 * A / np.abs(np.linalg.eigvals(A)).max(axis=-1)[:, None, None]
    H = rng.normal(size=(C, d, l))
    S = np.stack([np.eye(d) * 0.8] * C)
    G = np.stack([np.eye(d) * 0.5] * C)
    L = np.stack([np.eye(l) * 0.3 + 0.1] * C)
    for T in (8, 64, 256):
        z = rng.normal(size=(T, n, d))
        x = rng.normal(size=(T, n, l))
        z[rng.random(size=z.shape) < 0.4] = np.nan
        x[rng.random(size=x.shape) < 0.4] = np.nan
        z[:, 0] = np.nan
        x[:, 0] = np.nan  # fully-missing instance
        got = np.asarray(
            kalman.kalman_masked_logliks(
                *map(jnp.asarray, (z, x, m, S, A, G, H, L))
            )
        )
        assert got[0, 0] == 0.0 and got[1, 0] == 0.0
        for c in range(C):
            want = _dense_masked_oracle(
                z, x, (m[c], S[c], A[c], G[c], H[c], L[c])
            )
            np.testing.assert_allclose(got[c], want, rtol=1e-8, atol=1e-8)


def test_masked_kalman_subsumes_suffix_case():
    """On pure suffix missingness the masked filter equals the joint
    Markov factorization path (both exact)."""
    from multimodal_trajectory_modeling_tpu.ops import markov as mops

    z, x, lens, params_t = _mixture(11, C=3, T=7, n=120, d=2, l=3)
    got = np.asarray(
        kalman.kalman_masked_logliks(
            jnp.asarray(z), jnp.asarray(x), *params_t
        )
    )
    W = mops.markov_cluster_weights(*params_t)
    want = np.asarray(
        mops.markov_suffix_logliks(
            jnp.asarray(z), jnp.asarray(x), jnp.asarray(lens), W
        )
    )
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_observed_kalman_long_T_masked_route():
    """Past T=128 the em wrapper routes the scalarized masked filter
    (all-NaN state block) — must equal the suffix filter (f64)."""
    from multimodal_trajectory_modeling_tpu.models import em as em_mod

    rng = np.random.default_rng(2)
    C, T, n, d, l = 2, 150, 30, 2, 2
    m = jnp.asarray(rng.normal(size=(C, d)))
    A = rng.normal(scale=0.5, size=(C, d, d))
    A = jnp.asarray(
        0.6 * A / np.abs(np.linalg.eigvals(A)).max(axis=-1)[:, None, None]
    )
    H = jnp.asarray(rng.normal(size=(C, d, l)))
    S = jnp.asarray(np.stack([np.eye(d) * 0.7] * C))
    G = jnp.asarray(np.stack([np.eye(d) * 0.4] * C))
    L = jnp.asarray(np.stack([np.eye(l) * 0.5 + 0.1] * C))
    lens = rng.integers(1, T + 1, size=n).astype(np.int32)
    x = rng.normal(size=(T, n, l))
    x[np.arange(T)[:, None] >= lens[None, :]] = np.nan
    pi = jnp.asarray(rng.dirichlet(np.ones(C)))
    params = em_mod.MixtureParams(pi=pi, m=m, S=S, A=A, G=G, H=H, L=L)
    got = np.asarray(
        em_mod.observed_logliks_kalman(params, jnp.asarray(x), jnp.asarray(lens))
    )
    want = np.asarray(
        kalman.kalman_observed_logliks(
            jnp.asarray(x), jnp.asarray(lens), m, S, A, G, H, L
        )
    )
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_split_step_equals_combined_step():
    """The split-form step (condition on observed z, then update on
    observed x — the production algebra) must equal the combined
    (d+l)-dim observation step on random lane arrays under every mask
    regime: dense, partial, all-z-missing, all-x-missing, all-missing.
    Block-Cholesky identity → f64 agreement to roundoff."""
    rng = np.random.default_rng(23)
    d, l, n = 4, 3, 64
    for case in range(4):
        Hc = rng.normal(size=(d, l))
        Ac = rng.normal(scale=0.5, size=(d, d))
        Gc = rng.normal(size=(d, d))
        Gc = Gc @ Gc.T / d + np.eye(d)
        Lc = rng.normal(size=(l, l))
        Lc = Lc @ Lc.T / l + np.eye(l)
        P0 = rng.normal(size=(d, d))
        P0 = P0 @ P0.T / d + np.eye(d)
        mu = [jnp.asarray(rng.normal(size=n)) for _ in range(d)]
        P = [
            [jnp.asarray(np.full(n, P0[i, j])) for j in range(d)]
            for i in range(d)
        ]
        # perturb P per-lane, keeping symmetry + PD
        bump = rng.random(size=n) * 0.5
        P = [
            [
                P[i][j] + (bump if i == j else 0.0)
                for j in range(d)
            ]
            for i in range(d)
        ]
        z_t = [jnp.asarray(rng.normal(size=n)) for _ in range(d)]
        x_t = [jnp.asarray(rng.normal(size=n)) for _ in range(l)]
        oz = [
            jnp.asarray((rng.random(size=n) < 0.7).astype(np.float64))
            for _ in range(d)
        ]
        ox = [
            jnp.asarray((rng.random(size=n) < 0.7).astype(np.float64))
            for _ in range(l)
        ]
        if case == 1:  # all z missing
            oz = [jnp.zeros(n) for _ in range(d)]
        elif case == 2:  # all x missing
            ox = [jnp.zeros(n) for _ in range(l)]
        elif case == 3:  # everything missing
            oz = [jnp.zeros(n) for _ in range(d)]
            ox = [jnp.zeros(n) for _ in range(l)]
        Hs = [[Hc[i, b] for b in range(l)] for i in range(d)]
        As = [[Ac[i, j] for j in range(d)] for i in range(d)]
        Gs = [[Gc[i, j] for j in range(d)] for i in range(d)]
        Ls = [[Lc[a, b] for b in range(l)] for a in range(l)]
        mu1, P1, ll1 = kalman.masked_filter_step(
            mu, P, z_t, x_t, oz, ox, Hs, As, Gs, Ls, d, l
        )
        mu2, P2, ll2 = kalman.masked_filter_step_split(
            mu, P, z_t, x_t, oz, ox, Hs, As, Gs, Ls, d, l
        )
        np.testing.assert_allclose(
            np.asarray(ll2), np.asarray(ll1), rtol=1e-11, atol=1e-11
        )
        for i in range(d):
            np.testing.assert_allclose(
                np.asarray(mu2[i]), np.asarray(mu1[i]),
                rtol=1e-10, atol=1e-11,
            )
            for j in range(d):
                np.testing.assert_allclose(
                    np.asarray(P2[i][j]), np.asarray(P1[i][j]),
                    rtol=1e-10, atol=1e-11, err_msg=f"case {case}",
                )
        if case == 3:  # no observation: pure predict, ll contribution 0
            np.testing.assert_allclose(np.asarray(ll2), 0.0, atol=1e-13)


def _interior_problem(seed, C=2, T=8, n=400, d=3, l=2):
    import jax

    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l)) + 0.7 * np.repeat(z[:, :, :1], l, 2)
    z[:, n // 2 :] += 2.0
    z[rng.random(z.shape) < 0.12] = np.nan
    x[rng.random(x.shape) < 0.12] = np.nan

    def spd(k):
        M = rng.normal(size=(k, k))
        return M @ M.T / k + np.eye(k)

    def one_params():
        return em.MixtureParams(
            pi=jnp.ones(C) / C,
            m=jnp.asarray(rng.normal(size=(C, d))),
            S=jnp.asarray(np.stack([spd(d)] * C)),
            A=jnp.asarray(rng.normal(scale=0.3, size=(C, d, d))),
            G=jnp.asarray(np.stack([spd(d)] * C)),
            H=jnp.asarray(rng.normal(size=(C, d, l))),
            L=jnp.asarray(np.stack([spd(l)] * C)),
        )

    return jnp.asarray(z), jnp.asarray(x), one_params, rng


@pytest.mark.parametrize("sync_every", [3, 1])
def test_masked_kalman_pool_matches_standalone(sync_every):
    """The masked-filter slot pool (R·C parameter rows through one
    filter pass + one mstep_multi statistics read) must reproduce
    per-candidate standalone train_em_masked_kalman runs — refills,
    force_prev insertion and capped/converged statuses included (f64;
    multi-iteration windows and per-iteration host syncs)."""
    import jax

    zj, xj, one_params, rng = _interior_problem(3)
    C, n = 2, zj.shape[1]
    n_cand = 5
    plist = [one_params() for _ in range(n_cand)]
    alist = [
        rng.integers(0, C, size=n).astype(np.int32)
        for _ in range(n_cand)
    ]
    refs = [
        em.train_em_masked_kalman(
            plist[i], jnp.asarray(alist[i]), zj, xj,
            n_steps=12,
        )
        for i in range(n_cand)
    ]
    got = em.train_em_masked_kalman_pool(
        plist, alist, zj, xj, R=2, n_steps=12, sync_every=sync_every,
    )
    assert len(got) == n_cand
    for i, ((pr, ar, ir, sr), (pg, ag, ig, sg)) in enumerate(
        zip(refs, got)
    ):
        assert (int(ir), int(sr)) == (int(ig), int(sg)), i
        np.testing.assert_array_equal(
            np.asarray(ar), np.asarray(ag), err_msg=f"cand {i}"
        )
        for a, b in zip(jax.tree.leaves(pr), jax.tree.leaves(pg)):
            np.testing.assert_allclose(
                np.asarray(b), np.asarray(a), rtol=1e-10, atol=1e-12,
                err_msg=f"cand {i}",
            )


def test_mstep_multi_matches_mstep_rows():
    """Each restart row of mstep_multi equals a separate mstep call."""
    import jax

    zj, xj, _one, rng = _interior_problem(9)
    C, n = 3, zj.shape[1]
    R = 4
    assign = rng.integers(0, C, size=(R, n)).astype(np.int32)
    multi = em.mstep_multi(zj, xj, jnp.asarray(assign), n_clusters=C)
    for r in range(R):
        single = em.mstep(zj, xj, jnp.asarray(assign[r]), n_clusters=C)
        for a, b in zip(
            jax.tree.leaves(single),
            jax.tree.leaves(jax.tree.map(lambda q: q[r], multi)),
        ):
            np.testing.assert_allclose(
                np.asarray(b), np.asarray(a), rtol=1e-12, atol=1e-13
            )


def test_observed_logliks_short_rows_no_postlens_overflow():
    """A short row under an expansive closed-loop recursion must keep a
    FINITE log-lik: post-lens steps are masked BEFORE the add and the
    state freezes at lens, so the dead tail can't overflow into 0*inf
    = NaN (the row's true prefix marginal is finite)."""
    from multimodal_trajectory_modeling_tpu.ops import kalman as kops

    rng = np.random.default_rng(3)
    C, T, n, d, l = 2, 400, 16, 2, 2
    x = rng.normal(size=(T, n, l))
    lens = np.full(n, 3, np.int32)
    lens[: n // 2] = T  # half long, half length-3
    for i in range(n):
        x[lens[i]:, i] = np.nan
    m = rng.normal(size=(C, d))
    S = np.stack([np.eye(d)] * C)
    A = np.stack([10.0 * np.eye(d)] * C)  # wildly expansive dynamics
    G = np.stack([np.eye(d)] * C)
    H = rng.normal(size=(C, d, l))
    L = np.stack([np.eye(l)] * C)
    ll = kops.kalman_observed_logliks(
        jnp.asarray(x),
        jnp.asarray(lens),
        *map(jnp.asarray, (m, S, A, G, H, L)),
    )
    ll = np.asarray(ll)
    assert ll.shape == (C, n)
    # 10^(400-3) overflows f64 on the dead tail — the guard keeps every
    # row finite
    assert np.isfinite(ll).all(), ll
