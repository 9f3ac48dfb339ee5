"""The dense E step with per-pattern precomputed inverses
(``em.estep_logliks(method="inverse")``, the route of ``train(fast=True)``
for interior missingness) must agree with the triangular-solve and
default routes, ragged pattern segments and any row order included."""

import numpy as np
import jax.numpy as jnp

from multimodal_trajectory_modeling_tpu import ops
from multimodal_trajectory_modeling_tpu.models import em


def _problem(seed=0, n=700, T=4, d=2, l=3, C=3):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    lens = rng.choice([T // 2, T - 1, T], size=n)
    for Ln in np.unique(lens):
        z[Ln:, lens == Ln] = np.nan
        x[Ln:, lens == Ln] = np.nan
    v = np.asarray(em.pack_joint(jnp.asarray(z), jnp.asarray(x)))
    patterns, pid = ops.pattern_groups(v)
    params = em.MixtureParams(
        pi=jnp.asarray(rng.dirichlet(np.ones(C))),
        m=jnp.asarray(rng.normal(size=(C, d))),
        S=jnp.asarray(np.stack([np.eye(d) * 0.5] * C)),
        A=jnp.asarray(rng.normal(scale=0.4, size=(C, d, d))),
        G=jnp.asarray(np.stack([np.eye(d) * 0.3] * C)),
        H=jnp.asarray(rng.normal(size=(C, d, l))),
        L=jnp.asarray(np.stack([np.eye(l) * 0.4] * C)),
    )
    return params, jnp.asarray(v), jnp.asarray(patterns), np.asarray(pid), T


def _logliks(params, v, patterns, pid, T, method):
    return np.asarray(
        em.estep_logliks(
            params, v, patterns, jnp.asarray(pid), T=T, method=method
        )
    )


def test_fused_kernel_matches_grouped_xla():
    params, v, patterns, pid, T = _problem()
    want = _logliks(params, v, patterns, pid, T, "solve")
    got = _logliks(params, v, patterns, pid, T, "inverse")
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_fused_kernel_ragged_tail():
    """Pattern segments of uneven, non-power-of-two sizes must not leak
    into each other."""
    params, v, patterns, pid, T = _problem(seed=1, n=333)
    want = _logliks(params, v, patterns, pid, T, "solve")
    got = _logliks(params, v, patterns, pid, T, "inverse")
    assert got.shape == want.shape == (3, 333)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_assign_kernel_matches_logliks_argmax():
    """The E assignment and counts ``train_em`` derives from the
    ``"inverse"`` log-likelihoods must equal a NumPy argmax/bincount."""
    rng = np.random.default_rng(7)
    params, v, patterns, pid, T = _problem(seed=3, n=437)
    C = params.pi.shape[0]
    ll = _logliks(params, v, patterns, pid, T, "inverse")
    want_assign = np.argmax(
        np.log(np.asarray(params.pi))[:, None] + ll, axis=0
    )
    a = em.assignments_from_logliks(params.pi, jnp.asarray(ll))
    c = em.counts_from_assign(a, C)
    np.testing.assert_array_equal(np.asarray(a), want_assign)
    np.testing.assert_array_equal(
        np.asarray(c), np.bincount(want_assign, minlength=C)
    )
    prev = rng.integers(0, C, size=ll.shape[1])
    assert int(jnp.sum(a != jnp.asarray(prev))) == int(
        np.sum(want_assign != prev)
    )


def test_pattern_sorted_matches_unsorted():
    """A batch sorted by pattern (per-pattern inverses) must give the
    default route's values on the unsorted batch, permuted."""
    params, v, patterns, pid, T = _problem(seed=2, n=415)
    order = np.argsort(pid, kind="stable")
    got = _logliks(params, v[order], patterns, pid[order], T, "inverse")
    want = _logliks(params, v, patterns, pid, T, "auto")[:, order]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
