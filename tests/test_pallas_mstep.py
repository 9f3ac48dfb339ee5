"""The closed-form M step (``em.mstep``) must not depend on row order:
over the batch sorted by missingness pattern it must reproduce the M step
on the unsorted batch, ragged patterns and the ridge path included."""

import numpy as np
import jax.numpy as jnp

from multimodal_trajectory_modeling_tpu import ops
from multimodal_trajectory_modeling_tpu.models import em


def _problem(seed=0, n=500, T=5, d=3, l=2, C=4):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    lens = rng.choice([2, T - 1, T], size=n)
    for L in np.unique(lens):
        z[L:, lens == L] = np.nan
        x[L:, lens == L] = np.nan
    z[rng.random(size=z.shape) < 0.03] = np.nan
    assign = rng.integers(0, C, size=n)
    return jnp.asarray(z), jnp.asarray(x), jnp.asarray(assign), C


def _sorted_mstep(z, x, assign, C, **kw):
    v = em.pack_joint(z, x)
    _patterns, pid = ops.pattern_groups(np.asarray(v))
    order = jnp.asarray(np.argsort(pid, kind="stable"))
    return em.mstep(
        z[:, order], x[:, order], assign[order], n_clusters=C, **kw
    )


def test_pallas_mstep_matches_xla():
    z, x, assign, C = _problem()
    ref = em.mstep(z, x, assign, n_clusters=C, impl="xla")
    got = _sorted_mstep(z, x, assign, C)
    for name in ref._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)),
            np.asarray(getattr(ref, name)),
            rtol=1e-9,
            atol=1e-10,
            err_msg=name,
        )


def test_pallas_mstep_ragged_and_ridge():
    z, x, assign, C = _problem(seed=1, n=333)
    ref = em.mstep(
        z, x, assign, n_clusters=C, reg_mode="ridge", alpha=0.5, impl="xla"
    )
    got = _sorted_mstep(z, x, assign, C, reg_mode="ridge", alpha=0.5)
    for name in ref._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(got, name)),
            np.asarray(getattr(ref, name)),
            rtol=1e-9,
            atol=1e-10,
            err_msg=name,
        )
