"""The R-restart Markov EM path must equal R separate single-restart runs
exactly — same per-iteration outputs, same training trajectories, same
statuses/iteration counts — while reading the feature matrix Φ once
(ops/markov_phi.py:markov_em_from_features_multi)."""

import numpy as np
import jax
import jax.numpy as jnp

from multimodal_trajectory_modeling_tpu.models import em
from multimodal_trajectory_modeling_tpu.ops import markov as mops
from multimodal_trajectory_modeling_tpu.ops import markov_phi


def _mixture_batch(seed, C, T, n, d, l, min_len=2):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    lens = rng.integers(min_len, T + 1, size=n)
    for Ln in np.unique(lens):
        z[Ln:, lens == Ln] = np.nan
        x[Ln:, lens == Ln] = np.nan
    return jnp.asarray(z), jnp.asarray(x), jnp.asarray(lens, jnp.int32)


def _params_one(rng, C, d, l):
    def spd(k):
        M = rng.normal(size=(k, k))
        return M @ M.T / k + np.eye(k)

    return em.MixtureParams(
        pi=jnp.asarray(rng.dirichlet(np.ones(C))),
        m=jnp.asarray(rng.normal(size=(C, d))),
        S=jnp.asarray(np.stack([spd(d) for _ in range(C)])),
        A=jnp.asarray(rng.normal(scale=0.3, size=(C, d, d))),
        G=jnp.asarray(np.stack([spd(d) for _ in range(C)])),
        H=jnp.asarray(rng.normal(size=(C, d, l))),
        L=jnp.asarray(np.stack([spd(l) for _ in range(C)])),
    )


def _stack(params_list):
    return jax.tree.map(lambda *ps: jnp.stack(ps), *params_list)


def _phi(z, x, lens, T, d, l):
    n = z.shape[1]
    z_t = jnp.transpose(z, (0, 2, 1)).reshape(T * d, n)
    x_t = jnp.transpose(x, (0, 2, 1)).reshape(T * l, n)
    u = markov_phi.pack_markov_u(z_t, x_t, T=T, d=d, l=l, pad_to=128)
    return markov_phi.markov_materialize_features(u, lens, T=T, d=d, l=l)


def _weights(p):
    Wg = mops.markov_em_weights(p.m, p.S, p.A, p.G, p.H, p.L)
    return Wg.at[:, -1].add(jnp.log(p.pi))


def test_packed_multi_kernel_matches_single():
    """One R-restart Φ pass (R=4) must reproduce 4 single-restart passes
    exactly in f64: assignments, counts, switches, g statistics and
    objectives."""
    rng = np.random.default_rng(0)
    C, T, n, d, l, R = 3, 6, 300, 2, 3, 4
    z, x, lens = _mixture_batch(1, C, T, n, d, l)
    phi = _phi(z, x, lens, T, d, l)
    params = [_params_one(rng, C, d, l) for _ in range(R)]
    prev = jnp.asarray(rng.integers(0, C, size=(R, n)), jnp.int32)
    Wgs = [_weights(p) for p in params]
    a, c, w, g, o = markov_phi.markov_em_from_features_multi(
        phi, lens, prev, jnp.stack(Wgs), T=T, d=d, l=l
    )
    for r in range(R):
        a1, c1, w1, g1, o1 = markov_phi.markov_em_from_features(
            phi, lens, prev[r], Wgs[r], T=T, d=d, l=l
        )
        np.testing.assert_array_equal(np.asarray(a[r]), np.asarray(a1))
        np.testing.assert_array_equal(np.asarray(c[r]), np.asarray(c1))
        assert int(w[r]) == int(w1)
        np.testing.assert_allclose(
            np.asarray(g[r]), np.asarray(g1), rtol=1e-12, atol=1e-12
        )
        np.testing.assert_allclose(
            float(o[r]), float(o1), rtol=1e-12, atol=1e-12
        )


def test_packed_multi_kernel_prev_mode():
    """assign_mode='prev' (the initial M step) must honor each restart's
    own previous assignment."""
    rng = np.random.default_rng(2)
    C, T, n, d, l, R = 2, 5, 200, 3, 2, 3
    z, x, lens = _mixture_batch(3, C, T, n, d, l)
    phi = _phi(z, x, lens, T, d, l)
    params = [_params_one(rng, C, d, l) for _ in range(R)]
    prev = jnp.asarray(rng.integers(0, C, size=(R, n)), jnp.int32)
    Wgs = [_weights(p) for p in params]
    a, c, _w, g, _o = markov_phi.markov_em_from_features_multi(
        phi, lens, prev, jnp.stack(Wgs), T=T, d=d, l=l, assign_mode="prev"
    )
    for r in range(R):
        a1, c1, _w1, g1, _o1 = markov_phi.markov_em_from_features(
            phi, lens, prev[r], Wgs[r], T=T, d=d, l=l, assign_mode="prev"
        )
        np.testing.assert_array_equal(np.asarray(a[r]), np.asarray(a1))
        np.testing.assert_array_equal(np.asarray(c[r]), np.asarray(c1))
        np.testing.assert_allclose(
            np.asarray(g[r]), np.asarray(g1), rtol=1e-12, atol=1e-12
        )


def test_train_em_markov_multi_matches_sequential():
    """Full R-restart training must reproduce R sequential
    train_em_markov runs: parameters, assignments, iteration counts and
    statuses — including an init-abort restart (assignment with a
    too-small cluster) frozen at its initial state."""
    rng = np.random.default_rng(4)
    C, T, n, d, l, R = 2, 5, 240, 2, 2, 3
    z, x, lens = _mixture_batch(5, C, T, n, d, l)
    params = [_params_one(rng, C, d, l) for _ in range(R)]
    assigns = rng.integers(0, C, size=(R, n)).astype(np.int32)
    assigns[2, :] = 0
    assigns[2, :2] = 1  # cluster 1 has 2 ≤ min_members members → abort
    assigns_j = jnp.asarray(assigns)

    p_m, a_m, it_m, st_m = em.train_em_markov_multi(
        _stack(params), assigns_j, z, x, lens, n_steps=50
    )
    for r in range(R):
        p1, a1, it1, st1 = em.train_em_markov(
            params[r], assigns_j[r], z, x, lens, n_steps=50
        )
        assert int(st_m[r]) == int(st1), r
        assert int(it_m[r]) == int(it1), r
        np.testing.assert_array_equal(np.asarray(a_m[r]), np.asarray(a1))
        for fa, fb in zip(jax.tree.leaves(jax.tree.map(lambda q: q[r], p_m)),
                          jax.tree.leaves(p1)):
            np.testing.assert_allclose(
                np.asarray(fa), np.asarray(fb), rtol=1e-12, atol=1e-12
            )


def test_complete_data_loglik_markov_multi_matches_single():
    rng = np.random.default_rng(6)
    C, T, n, d, l, R = 3, 6, 180, 2, 3, 2
    z, x, lens = _mixture_batch(7, C, T, n, d, l)
    z_t = jnp.transpose(z, (0, 2, 1)).reshape(T * d, n)
    x_t = jnp.transpose(x, (0, 2, 1)).reshape(T * l, n)
    u = markov_phi.pack_markov_u(z_t, x_t, T=T, d=d, l=l)
    params = [_params_one(rng, C, d, l) for _ in range(R)]
    objs = em.complete_data_loglik_markov_multi(
        _stack(params), lens, u, T=T
    )
    for r in range(R):
        want = em.complete_data_loglik_markov(
            params[r], z_t, x_t, lens, T=T
        )
        np.testing.assert_allclose(
            float(objs[r]), float(want), rtol=1e-12, atol=1e-10
        )


def test_pool_matches_sequential_train():
    """The slot-pool multistart (R slots, refilled on termination) must
    return, for EVERY candidate, the same trained params, assignment,
    iteration count and status as a standalone ``train_em_markov`` run
    — in candidate order — including init-abort, n_steps-capped and
    converged candidates, with R small enough to force many refills."""
    rng = np.random.default_rng(3)
    C, T, n, d, l = 3, 6, 240, 2, 2
    z, x, lens = _mixture_batch(5, C, T, n, d, l)
    n_cand = 9
    params_list = [_params_one(rng, C, d, l) for _ in range(n_cand)]
    assign_list = [
        rng.integers(0, C, size=n).astype(np.int32) for _ in range(n_cand)
    ]
    # candidate 2: init abort (one cluster below the member floor)
    assign_list[2] = np.zeros(n, np.int32)
    assign_list[2][:2] = 1
    assign_list[2][2 : n - 2] = np.where(
        np.arange(n - 4) % 2 == 0, 0, 2
    ).astype(np.int32)

    want = []
    for p0, a0 in zip(params_list, assign_list):
        res = em.train_em_markov(
            p0, jnp.asarray(a0), z, x, lens, n_steps=5
        )
        want.append(res)

    got = em.train_em_markov_pool(
        params_list,
        assign_list,
        z,
        x,
        lens,
        R=3,
        n_steps=5,
    )

    assert len(got) == n_cand
    for i, ((pw, aw, iw, sw), (pg, ag, ig, sg)) in enumerate(
        zip(want, got)
    ):
        assert int(sw) == int(sg), (i, int(sw), int(sg))
        assert int(iw) == int(ig), (i, int(iw), int(ig))
        np.testing.assert_array_equal(
            np.asarray(aw), np.asarray(ag), err_msg=f"cand {i}"
        )
        for leaf_w, leaf_g in zip(
            jax.tree_util.tree_leaves(pw),
            jax.tree_util.tree_leaves(pg),
        ):
            np.testing.assert_allclose(
                np.asarray(leaf_g),
                np.asarray(leaf_w),
                rtol=1e-12,
                atol=1e-14,
                err_msg=f"cand {i}",
            )


def test_pool_edge_cases():
    """Pool edge cases: fewer candidates than slots (R clamps to
    n_cand), and a sweep where EVERY candidate trips the init-abort
    guard (no kernel pass should change anything; raw params and zero
    iterations come back, reference status 3)."""
    rng = np.random.default_rng(11)
    C, T, n, d, l = 3, 6, 200, 2, 2
    z, x, lens = _mixture_batch(13, C, T, n, d, l)

    # (a) n_cand=2 with R=32
    params_list = [_params_one(rng, C, d, l) for _ in range(2)]
    assign_list = [
        rng.integers(0, C, size=n).astype(np.int32) for _ in range(2)
    ]
    want = [
        em.train_em_markov(p, jnp.asarray(a), z, x, lens, n_steps=4)
        for p, a in zip(params_list, assign_list)
    ]
    got = em.train_em_markov_pool(
        params_list, assign_list, z, x, lens, R=32, n_steps=4
    )
    for (pw, aw, iw, sw), (pg, ag, ig, sg) in zip(want, got):
        assert (int(sw), int(iw)) == (int(sg), int(ig))
        np.testing.assert_array_equal(np.asarray(aw), np.asarray(ag))
        for lw, lg in zip(
            jax.tree_util.tree_leaves(pw), jax.tree_util.tree_leaves(pg)
        ):
            np.testing.assert_allclose(
                np.asarray(lg), np.asarray(lw), rtol=1e-12, atol=1e-14
            )

    # (b) every candidate init-aborts
    bad = np.zeros(n, np.int32)
    bad[0] = 1
    bad[1] = 2
    got = em.train_em_markov_pool(
        [params_list[0]] * 3, [bad] * 3, z, x, lens, R=2, n_steps=4
    )
    for pg, ag, ig, sg in got:
        assert int(sg) == int(em.STATUS_INIT_ABORT)
        assert int(ig) == 0
        np.testing.assert_array_equal(np.asarray(ag), bad)
        for lw, lg in zip(
            jax.tree_util.tree_leaves(params_list[0]),
            jax.tree_util.tree_leaves(pg),
        ):
            np.testing.assert_array_equal(np.asarray(lg), np.asarray(lw))


def test_from_features_multi_matches_packed_multi():
    """The R-restart Φ pass with a mixed force_prev mask must give forced
    restarts the prev-mode result (incoming assignment, zero switches,
    zero objective) and the others the argmax result — each equal to a
    single-restart pass in that mode (f64)."""
    rng = np.random.default_rng(11)
    C, T, n, d, l, R = 3, 6, 300, 2, 3, 4
    z, x, lens = _mixture_batch(12, C, T, n, d, l)
    phi = _phi(z, x, lens, T, d, l)
    params = [_params_one(rng, C, d, l) for _ in range(R)]
    prev = jnp.asarray(rng.integers(0, C, size=(R, n)), jnp.int32)
    Wg = jnp.stack([_weights(p) for p in params])
    force = jnp.asarray([0, 1, 0, 1], jnp.int32)
    a, c, w, g, o = markov_phi.markov_em_from_features_multi(
        phi, lens, prev, Wg, T=T, d=d, l=l, force_prev=force
    )
    for r in range(R):
        mode = "prev" if int(force[r]) else "argmax"
        a1, c1, w1, g1, o1 = markov_phi.markov_em_from_features(
            phi, lens, prev[r], Wg[r], T=T, d=d, l=l, assign_mode=mode
        )
        np.testing.assert_array_equal(np.asarray(a[r]), np.asarray(a1))
        np.testing.assert_array_equal(np.asarray(c[r]), np.asarray(c1))
        assert int(w[r]) == int(w1)
        np.testing.assert_allclose(
            np.asarray(g[r]), np.asarray(g1), rtol=1e-12, atol=1e-12
        )
        np.testing.assert_allclose(
            float(o[r]), float(o1), rtol=1e-12, atol=1e-12
        )
