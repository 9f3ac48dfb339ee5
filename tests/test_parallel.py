"""Multi-device tests on the virtual 8-device CPU mesh: both the
auto-partitioned and the explicit shard_map EM must reproduce the
single-device engine exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multimodal_trajectory_modeling_tpu import ops
from multimodal_trajectory_modeling_tpu.models import em
from multimodal_trajectory_modeling_tpu.parallel import mesh as mesh_lib
from multimodal_trajectory_modeling_tpu.parallel import sharded_em


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    C, T, n, d, l = 3, 6, 800, 2, 3  # n divisible by 8
    z = np.zeros((T, n, d))
    x = np.zeros((T, n, l))
    labels = rng.integers(0, C, size=n)
    for c in range(C):
        idx = labels == c
        A = rng.normal(scale=0.4, size=(d, d))
        H = rng.normal(size=(d, l))
        m = 2.0 * rng.normal(size=d)
        zc, xc = ops.sample_trajectories(
            jax.random.PRNGKey(c),
            int(idx.sum()),
            T,
            jnp.asarray(m),
            jnp.eye(d) / 4,
            jnp.asarray(A),
            jnp.eye(d) / 2,
            jnp.asarray(H),
            jnp.eye(l) / 3,
        )
        z[:, idx], x[:, idx] = np.asarray(zc), np.asarray(xc)
    # NaN-pad some trajectories
    lens = rng.choice([T // 2, T], size=n, p=[0.4, 0.6])
    for Ln in np.unique(lens):
        z[Ln:, lens == Ln] = np.nan
        x[Ln:, lens == Ln] = np.nan
    v = np.asarray(em.pack_joint(jnp.asarray(z), jnp.asarray(x)))
    patterns, pid = ops.pattern_groups(v)
    params0 = em.MixtureParams(
        pi=jnp.ones(C) / C,
        m=jnp.asarray(rng.normal(size=(C, d))),
        S=jnp.asarray(np.stack([np.eye(d)] * C)),
        A=jnp.asarray(rng.normal(size=(C, d, d))),
        G=jnp.asarray(np.stack([np.eye(d)] * C)),
        H=jnp.asarray(rng.normal(size=(C, d, l))),
        L=jnp.asarray(np.stack([np.eye(l)] * C)),
    )
    assign0 = jnp.asarray(rng.integers(0, C, size=n))
    return dict(
        z=jnp.asarray(z),
        x=jnp.asarray(x),
        v=jnp.asarray(v),
        patterns=jnp.asarray(patterns),
        pid=jnp.asarray(pid),
        params0=params0,
        assign0=assign0,
    )


def _single_device_result(p):
    return em.train_em(
        p["params0"], p["assign0"], p["z"], p["x"], p["v"], p["patterns"],
        p["pid"], n_steps=100,
    )


def test_eight_devices_present():
    assert len(jax.devices()) == 8


def test_auto_partitioned_matches_single_device(problem):
    ref_params, ref_assign, ref_iters, ref_status = _single_device_result(
        problem
    )
    mesh = mesh_lib.make_mesh()
    params, assign, iters, status = sharded_em.train_em_data_parallel(
        problem["params0"],
        problem["assign0"],
        problem["z"],
        problem["x"],
        problem["v"],
        problem["patterns"],
        problem["pid"],
        mesh=mesh,
        n_steps=100,
    )
    assert int(status) == int(ref_status)
    np.testing.assert_array_equal(np.asarray(assign), np.asarray(ref_assign))
    for a, b in zip(params, ref_params):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-9
        )


def test_shardmap_matches_single_device(problem):
    ref_params, ref_assign, ref_iters, ref_status = _single_device_result(
        problem
    )
    mesh = mesh_lib.make_mesh()
    params, assign, iters, status = sharded_em.train_em_shardmap(
        problem["params0"],
        problem["assign0"],
        problem["z"],
        problem["x"],
        problem["v"],
        problem["patterns"],
        problem["pid"],
        mesh=mesh,
        n_steps=100,
    )
    assert int(status) == int(ref_status)
    np.testing.assert_array_equal(np.asarray(assign), np.asarray(ref_assign))
    for a, b in zip(params, ref_params):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-8, atol=1e-8
        )


def test_multistart_2d_mesh_matches_1d_shardmap(problem):
    """Each restart row of a 2-D (restart, data) mesh must reproduce the
    1-D data-parallel shard_map result bit-for-bit."""
    from jax.sharding import Mesh

    rng = np.random.default_rng(21)
    R = 2
    C = 3
    n = problem["assign0"].shape[0]
    assigns = jnp.asarray(
        np.stack(
            [np.asarray(problem["assign0"])]
            + [rng.integers(0, C, size=n) for _ in range(R - 1)]
        ),
        jnp.int32,
    )

    devs = np.asarray(jax.devices())
    mesh2 = Mesh(devs.reshape(R, 4), ("restart", "data"))
    params_r, assign_r, iters_r, status_r = sharded_em.train_em_multistart_2d(
        problem["params0"],
        assigns,
        problem["z"],
        problem["x"],
        problem["v"],
        problem["patterns"],
        problem["pid"],
        mesh=mesh2,
        n_steps=100,
    )
    assert assign_r.shape == (R, n)

    mesh1 = Mesh(devs[:4], ("data",))
    for r in range(R):
        p1, a1, i1, s1 = sharded_em.train_em_shardmap(
            problem["params0"],
            assigns[r],
            problem["z"],
            problem["x"],
            problem["v"],
            problem["patterns"],
            problem["pid"],
            mesh=mesh1,
            n_steps=100,
        )
        assert int(status_r[r]) == int(s1)
        np.testing.assert_array_equal(
            np.asarray(assign_r[r]), np.asarray(a1)
        )
        for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t[r], params_r)),
                        jax.tree.leaves(p1)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_multistart_2d_seed_generated_restarts(problem):
    """1-D assign0 + n_restarts draws extra random starts; restart 0 must
    equal the caller's assignment path."""
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices())
    mesh2 = Mesh(devs.reshape(2, 4), ("restart", "data"))
    params_r, assign_r, iters_r, status_r = sharded_em.train_em_multistart_2d(
        problem["params0"],
        problem["assign0"].astype(jnp.int32),
        problem["z"],
        problem["x"],
        problem["v"],
        problem["patterns"],
        problem["pid"],
        mesh=mesh2,
        n_restarts=2,
        n_steps=50,
        seed=7,
    )
    mesh1 = Mesh(devs[:4], ("data",))
    p1, a1, i1, s1 = sharded_em.train_em_shardmap(
        problem["params0"],
        problem["assign0"].astype(jnp.int32),
        problem["z"],
        problem["x"],
        problem["v"],
        problem["patterns"],
        problem["pid"],
        mesh=mesh1,
        n_steps=50,
    )
    np.testing.assert_array_equal(np.asarray(assign_r[0]), np.asarray(a1))
    assert int(status_r[0]) == int(s1)


def test_restart_parallel_multistart_matches_unsharded(problem):
    """Sharding the restart axis across the mesh must not change results."""
    from jax.sharding import Mesh

    rng = np.random.default_rng(11)
    R, C, d, l = 8, 3, 2, 3
    n = problem["assign0"].shape[0]

    def one_params():
        return em.MixtureParams(
            pi=jnp.ones(C) / C,
            m=jnp.asarray(rng.normal(size=(C, d))),
            S=jnp.asarray(np.stack([np.eye(d)] * C)),
            A=jnp.asarray(rng.normal(size=(C, d, d))),
            G=jnp.asarray(np.stack([np.eye(d)] * C)),
            H=jnp.asarray(rng.normal(size=(C, d, l))),
            L=jnp.asarray(np.stack([np.eye(l)] * C)),
        )

    params0 = jax.tree.map(
        lambda *xs: jnp.stack(xs), *[one_params() for _ in range(R)]
    )
    assign0 = jnp.asarray(rng.integers(0, C, size=(R, n)))

    args = (
        params0,
        assign0,
        problem["z"],
        problem["x"],
        problem["v"],
        problem["patterns"],
        problem["pid"],
    )
    ref = em.train_em_multistart(*args, n_steps=30)
    mesh = Mesh(np.asarray(jax.devices()), ("start",))
    got = sharded_em.train_em_multistart_sharded(
        *args, mesh=mesh, n_steps=30
    )
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    np.testing.assert_allclose(
        np.asarray(got[4]), np.asarray(ref[4]), rtol=1e-9
    )


def test_markov_shardmap_matches_single_device(problem):
    """The data-parallel fused Markov EM (one (F, C)-stats psum + one
    switch psum per iteration) must reproduce the single-device
    train_em_markov exactly on the f64 test mesh."""
    z = np.asarray(problem["z"])
    lens = jnp.asarray(
        np.isfinite(z).all(axis=2).sum(axis=0).astype(np.int32)
    )
    ref = em.train_em_markov(
        problem["params0"],
        problem["assign0"],
        problem["z"],
        problem["x"],
        lens,
        n_steps=100,
    )
    mesh = mesh_lib.make_mesh()
    got = sharded_em.train_em_markov_shardmap(
        problem["params0"],
        problem["assign0"],
        problem["z"],
        problem["x"],
        lens,
        mesh=mesh,
        n_steps=100,
    )
    assert int(got[3]) == int(ref[3])
    assert int(got[2]) == int(ref[2])
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-8, atol=1e-8
        )

def test_markov_multi_shardmap_matches_unsharded(problem):
    """Data-parallel fused-MULTISTART Markov EM: R restart rows replicated,
    trajectories sharded; per-restart psum'd statistics must reproduce
    em.train_em_markov_multi exactly on the f64 test mesh."""
    from jax.sharding import Mesh

    rng = np.random.default_rng(21)
    R, C = 4, 3
    z = np.asarray(problem["z"])
    d, l = z.shape[-1], np.asarray(problem["x"]).shape[-1]
    n = z.shape[1]
    lens = jnp.asarray(
        np.isfinite(z).all(axis=2).sum(axis=0).astype(np.int32)
    )

    def one_params():
        return em.MixtureParams(
            pi=jnp.ones(C) / C,
            m=jnp.asarray(rng.normal(size=(C, d))),
            S=jnp.asarray(np.stack([np.eye(d)] * C)),
            A=jnp.asarray(rng.normal(scale=0.3, size=(C, d, d))),
            G=jnp.asarray(np.stack([np.eye(d)] * C)),
            H=jnp.asarray(rng.normal(size=(C, d, l))),
            L=jnp.asarray(np.stack([np.eye(l)] * C)),
        )

    params0 = jax.tree.map(
        lambda *xs: jnp.stack(xs), *[one_params() for _ in range(R)]
    )
    assign0 = jnp.asarray(
        rng.integers(0, C, size=(R, n)).astype(np.int32)
    )
    ref = em.train_em_markov_multi(
        params0, assign0, problem["z"], problem["x"], lens, n_steps=60
    )
    mesh = Mesh(np.asarray(jax.devices()), ("data",))
    got = sharded_em.train_em_markov_multi_shardmap(
        params0,
        assign0,
        problem["z"],
        problem["x"],
        lens,
        mesh=mesh,
        n_steps=60,
    )
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(ref[3]))
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(ref[2]))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-8, atol=1e-8
        )


def test_markov_pool_shardmap_matches_unsharded(problem):
    """The data-parallel slot-pool multistart (mesh=) must return, for
    every candidate, the same params/assignment/iters/status as the
    single-device pool — refills, per-slot freeze and force_prev
    semantics included (psum'd statistics are exact on the f64 mesh)."""
    from jax.sharding import Mesh

    rng = np.random.default_rng(31)
    C = 3
    z = np.asarray(problem["z"])
    d, l = z.shape[-1], np.asarray(problem["x"]).shape[-1]
    n = z.shape[1]
    lens = jnp.asarray(
        np.isfinite(z).all(axis=2).sum(axis=0).astype(np.int32)
    )

    def one_params():
        return em.MixtureParams(
            pi=jnp.ones(C) / C,
            m=jnp.asarray(rng.normal(size=(C, d))),
            S=jnp.asarray(np.stack([np.eye(d)] * C)),
            A=jnp.asarray(rng.normal(scale=0.3, size=(C, d, d))),
            G=jnp.asarray(np.stack([np.eye(d)] * C)),
            H=jnp.asarray(rng.normal(size=(C, d, l))),
            L=jnp.asarray(np.stack([np.eye(l)] * C)),
        )

    n_cand = 7
    params_list = [one_params() for _ in range(n_cand)]
    assign_list = [
        rng.integers(0, C, size=n).astype(np.int32)
        for _ in range(n_cand)
    ]
    kw = dict(R=3, n_steps=6, sync_every=2)
    ref = em.train_em_markov_pool(
        params_list, assign_list, problem["z"], problem["x"], lens, **kw
    )
    mesh = Mesh(np.asarray(jax.devices()), ("data",))
    got = em.train_em_markov_pool(
        params_list,
        assign_list,
        problem["z"],
        problem["x"],
        lens,
        mesh=mesh,
        **kw,
    )
    assert len(got) == n_cand
    for i, ((pw, aw, iw, sw), (pg, ag, ig, sg)) in enumerate(
        zip(ref, got)
    ):
        assert (int(sw), int(iw)) == (int(sg), int(ig)), i
        np.testing.assert_array_equal(
            np.asarray(aw), np.asarray(ag), err_msg=f"cand {i}"
        )
        for lw, lg in zip(
            jax.tree_util.tree_leaves(pw),
            jax.tree_util.tree_leaves(pg),
        ):
            np.testing.assert_allclose(
                np.asarray(lg),
                np.asarray(lw),
                rtol=1e-12,
                atol=1e-13,
                err_msg=f"cand {i}",
            )


@pytest.mark.slow
def test_mixture_multistart_multichip_matches_single(problem, monkeypatch):
    """MTM_MULTICHIP=1 routes the mixture's fast multistart pool over a
    data mesh; winner, assignments and objectives must equal the
    single-device pool run (f64 mesh — psums exact here)."""
    from multimodal_trajectory_modeling_tpu.models.mixture import (
        MMLinGaussSS_marginalizable,
    )

    z = np.asarray(problem["z"])
    x = np.asarray(problem["x"])

    def run(multichip):
        if multichip:
            monkeypatch.setenv("MTM_MULTICHIP", "1")
        else:
            monkeypatch.delenv("MTM_MULTICHIP", raising=False)
        np.random.seed(99)
        mdl, objs = MMLinGaussSS_marginalizable(
            n_clusters=3, states=z, observations=x, random_seed=5
        ).train_with_multiple_random_starts(
            n_starts=4,
            use_cache=False,
            fast=True,
            return_objectives=True,
        )
        return np.asarray(mdl.cluster_assignment), np.asarray(objs)

    a1, o1 = run(False)
    a2, o2 = run(True)
    np.testing.assert_array_equal(a2, a1)
    np.testing.assert_allclose(o2, o1, rtol=1e-12)


def test_masked_kalman_shardmap_matches_unsharded(problem):
    """The data-parallel masked-filter trainer must reproduce the
    single-device em.train_em_masked_kalman exactly (f64 mesh) under
    INTERIOR per-coordinate missingness."""
    from jax.sharding import Mesh

    rng = np.random.default_rng(41)
    C = 3
    z = np.asarray(problem["z"]).copy()
    x = np.asarray(problem["x"]).copy()
    d, l = z.shape[-1], x.shape[-1]
    n = z.shape[1]
    z[rng.random(z.shape) < 0.1] = np.nan
    x[rng.random(x.shape) < 0.1] = np.nan

    def spd(k):
        X = rng.normal(size=(k, k))
        return X @ X.T + np.eye(k)

    params0 = em.MixtureParams(
        pi=jnp.ones(C) / C,
        m=jnp.asarray(rng.normal(size=(C, d))),
        S=jnp.asarray(np.stack([spd(d) for _ in range(C)])),
        A=jnp.asarray(rng.normal(scale=0.3, size=(C, d, d))),
        G=jnp.asarray(np.stack([spd(d) for _ in range(C)])),
        H=jnp.asarray(rng.normal(size=(C, d, l))),
        L=jnp.asarray(np.stack([spd(l) for _ in range(C)])),
    )
    assign0 = jnp.asarray(rng.integers(0, C, size=n), jnp.int32)
    zj, xj = jnp.asarray(z), jnp.asarray(x)

    p_ref, a_ref, it_ref, st_ref = em.train_em_masked_kalman(
        params0, assign0, zj, xj, n_steps=25
    )
    mesh = Mesh(np.asarray(jax.devices()), ("data",))
    p_s, a_s, it_s, st_s = sharded_em.train_em_masked_kalman_shardmap(
        params0, assign0, zj, xj, mesh=mesh, n_steps=25
    )
    assert (int(st_ref), int(it_ref)) == (int(st_s), int(it_s))
    np.testing.assert_array_equal(np.asarray(a_ref), np.asarray(a_s))
    for fa, fb in zip(p_ref, p_s):
        np.testing.assert_allclose(
            np.asarray(fa), np.asarray(fb), rtol=1e-12, atol=1e-13
        )
    # a coarser mesh (2 shards) must take the identical trajectory
    mesh2 = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    p_p, a_p, it_p, st_p = sharded_em.train_em_markov_shardmap.__wrapped__(
        params0, assign0, zj, xj, mesh=mesh2, n_steps=25
    ) if False else sharded_em.train_em_masked_kalman_shardmap(
        params0, assign0, zj, xj, mesh=mesh2, n_steps=25
    )
    assert (int(st_ref), int(it_ref)) == (int(st_p), int(it_p))
    np.testing.assert_array_equal(np.asarray(a_ref), np.asarray(a_p))
    for fa, fb in zip(p_ref, p_p):
        np.testing.assert_allclose(
            np.asarray(fa), np.asarray(fb), rtol=1e-12, atol=1e-13
        )


@pytest.mark.slow
def test_mixture_multistart_multichip_with_refills(problem, monkeypatch):
    """MTM_MULTICHIP=1 with fewer pool slots than candidates: slot
    refills must ride the data mesh too, reproducing the single-device
    winner/objectives through the public multistart API."""
    from multimodal_trajectory_modeling_tpu.models.mixture import (
        MMLinGaussSS_marginalizable,
    )

    z = np.asarray(problem["z"])
    x = np.asarray(problem["x"])
    monkeypatch.setenv("MTM_MULTISTART_FUSE", "2")  # 5 starts → refills

    def run(multichip):
        if multichip:
            monkeypatch.setenv("MTM_MULTICHIP", "1")
        else:
            monkeypatch.delenv("MTM_MULTICHIP", raising=False)
        np.random.seed(77)
        mdl, objs = MMLinGaussSS_marginalizable(
            n_clusters=3, states=z, observations=x, random_seed=13
        ).train_with_multiple_random_starts(
            n_starts=5,
            use_cache=False,
            fast=True,
            return_objectives=True,
        )
        return np.asarray(mdl.cluster_assignment), np.asarray(objs)

    a1, o1 = run(False)
    a2, o2 = run(True)
    np.testing.assert_array_equal(a2, a1)
    np.testing.assert_allclose(o2, o1, rtol=1e-12)


def test_markov_shardmap_phi_routing_is_exact_noop(problem, monkeypatch):
    """The shard_map Markov trainer builds its wide Φ per shard (compact
    layout) and psums the per-shard statistics; that routing must leave
    the trajectory of the single-device trainer unchanged on the f64
    mesh: status, iterations and assignments equal, parameters to psum
    reassociation."""
    from jax.sharding import Mesh

    z = np.asarray(problem["z"])
    lens = jnp.asarray(
        np.isfinite(z).all(axis=2).sum(axis=0).astype(np.int32)
    )
    mesh = Mesh(np.asarray(jax.devices()), ("data",))
    args = (
        problem["params0"],
        problem["assign0"].astype(jnp.int32),
        problem["z"],
        problem["x"],
        lens,
    )

    monkeypatch.setenv("MTM_MARKOV_PHI", "wide")
    ref = em.train_em_markov(*args, n_steps=40)
    got = sharded_em.train_em_markov_shardmap(*args, mesh=mesh, n_steps=40)
    assert int(got[3]) == int(ref[3])
    assert int(got[2]) == int(ref[2])
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-8, atol=1e-8
        )


def test_markov_shardmap_i16_matches_single_device(problem, monkeypatch):
    """MTM_MARKOV_PHI=i16: the shard_map trainer quantizes each shard's
    Φ slice with GLOBAL (pmax-ed) per-row scales, so the stored int16
    payload — and hence the whole trajectory — must equal the
    single-device i16 trainer exactly on the f64 mesh."""
    from jax.sharding import Mesh

    z = np.asarray(problem["z"])
    lens = jnp.asarray(
        np.isfinite(z).all(axis=2).sum(axis=0).astype(np.int32)
    )
    mesh = Mesh(np.asarray(jax.devices()), ("data",))
    args = (
        problem["params0"],
        problem["assign0"].astype(jnp.int32),
        problem["z"],
        problem["x"],
        lens,
    )
    monkeypatch.setenv("MTM_MARKOV_PHI", "i16")
    ref = em.train_em_markov(*args, n_steps=60)
    got = sharded_em.train_em_markov_shardmap(*args, mesh=mesh, n_steps=60)
    assert int(got[3]) == int(ref[3])
    assert int(got[2]) == int(ref[2])
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-8, atol=1e-8
        )
    # and i16 is really on: the wide-mode result differs in the params
    monkeypatch.setenv("MTM_MARKOV_PHI", "wide")
    wide = sharded_em.train_em_markov_shardmap(*args, mesh=mesh, n_steps=60)
    assert any(
        not np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree.leaves(got[0]), jax.tree.leaves(wide[0]))
    )


def test_markov_pool_shardmap_i16_matches_unsharded(problem, monkeypatch):
    """MTM_MARKOV_PHI=i16 through the mesh-mode slot pool: the globally
    quantized Φ (host-level, scales over all lanes) rides the window's
    PhiQuant spec; every candidate must match the single-device i16
    pool exactly."""
    from jax.sharding import Mesh

    rng = np.random.default_rng(37)
    C = 3
    z = np.asarray(problem["z"])
    d, l = z.shape[-1], np.asarray(problem["x"]).shape[-1]
    n = z.shape[1]
    lens = jnp.asarray(
        np.isfinite(z).all(axis=2).sum(axis=0).astype(np.int32)
    )

    def one_params():
        return em.MixtureParams(
            pi=jnp.ones(C) / C,
            m=jnp.asarray(rng.normal(size=(C, d))),
            S=jnp.asarray(np.stack([np.eye(d)] * C)),
            A=jnp.asarray(rng.normal(scale=0.3, size=(C, d, d))),
            G=jnp.asarray(np.stack([np.eye(d)] * C)),
            H=jnp.asarray(rng.normal(size=(C, d, l))),
            L=jnp.asarray(np.stack([np.eye(l)] * C)),
        )

    n_cand = 5
    params_list = [one_params() for _ in range(n_cand)]
    assign_list = [
        rng.integers(0, C, size=n).astype(np.int32) for _ in range(n_cand)
    ]
    kw = dict(R=3, n_steps=6, sync_every=2)
    monkeypatch.setenv("MTM_MARKOV_PHI", "i16")
    ref = em.train_em_markov_pool(
        params_list, assign_list, problem["z"], problem["x"], lens, **kw
    )
    mesh = Mesh(np.asarray(jax.devices()), ("data",))
    got = em.train_em_markov_pool(
        params_list,
        assign_list,
        problem["z"],
        problem["x"],
        lens,
        mesh=mesh,
        **kw,
    )
    for i, ((pw, aw, iw, sw), (pg, ag, ig, sg)) in enumerate(zip(ref, got)):
        assert (int(sw), int(iw)) == (int(sg), int(ig)), i
        np.testing.assert_array_equal(
            np.asarray(aw), np.asarray(ag), err_msg=f"cand {i}"
        )
        for lw, lg in zip(
            jax.tree_util.tree_leaves(pw), jax.tree_util.tree_leaves(pg)
        ):
            np.testing.assert_allclose(
                np.asarray(lg),
                np.asarray(lw),
                rtol=1e-12,
                atol=1e-13,
                err_msg=f"cand {i}",
            )


def _longT_problem(seed, C=2, T=80, n=160, d=3, l=2):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    lens = rng.integers(2, T + 1, size=n)
    for Ln in np.unique(lens):
        z[Ln:, lens == Ln] = np.nan
        x[Ln:, lens == Ln] = np.nan

    def spd(k):
        M = rng.normal(size=(k, k))
        return M @ M.T / k + np.eye(k)

    params0 = em.MixtureParams(
        pi=jnp.ones(C) / C,
        m=jnp.asarray(rng.normal(size=(C, d))),
        S=jnp.asarray(np.stack([spd(d) for _ in range(C)])),
        A=jnp.asarray(rng.normal(scale=0.3, size=(C, d, d))),
        G=jnp.asarray(np.stack([spd(d) for _ in range(C)])),
        H=jnp.asarray(rng.normal(size=(C, d, l))),
        L=jnp.asarray(np.stack([spd(l) for _ in range(C)])),
    )
    assign0 = jnp.asarray(rng.integers(0, C, size=n), jnp.int32)
    return (
        jnp.asarray(z),
        jnp.asarray(x),
        jnp.asarray(lens, jnp.int32),
        params0,
        assign0,
    )


def test_markov_shardmap_longT_matches_single_device():
    """Past the packed kernel's T·s ≤ 512 gate the shard_map trainer
    must route the per-shard canonical Φ materialization (grid-over-T)
    and match the single-device longT trainer (f64 mesh)."""
    from jax.sharding import Mesh

    z, x, lens, params0, assign0 = _longT_problem(91)
    ref = em.train_em_markov(params0, assign0, z, x, lens, n_steps=6)
    mesh = Mesh(np.asarray(jax.devices()), ("data",))
    got = sharded_em.train_em_markov_shardmap(
        params0, assign0, z, x, lens, mesh=mesh, n_steps=6
    )
    assert (int(ref[3]), int(ref[2])) == (int(got[3]), int(got[2]))
    np.testing.assert_array_equal(np.asarray(ref[1]), np.asarray(got[1]))
    for a, b in zip(ref[0], got[0]):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=1e-9, atol=1e-12
        )


@pytest.mark.slow
def test_markov_pool_shardmap_longT_matches_unsharded():
    """The mesh-mode slot pool at long T (canonical Φ materialized once
    over the mesh, u never built) must equal the single-device pool."""
    from jax.sharding import Mesh

    z, x, lens, params0, _ = _longT_problem(92)
    rng = np.random.default_rng(93)
    C, n = 2, z.shape[1]
    n_cand = 3
    plist = [
        em.MixtureParams(
            pi=params0.pi,
            m=params0.m + 0.2 * rng.normal(size=np.asarray(params0.m).shape),
            S=params0.S, A=params0.A, G=params0.G,
            H=params0.H, L=params0.L,
        )
        for _ in range(n_cand)
    ]
    alist = [
        rng.integers(0, C, size=n).astype(np.int32)
        for _ in range(n_cand)
    ]
    kw = dict(R=2, n_steps=4, sync_every=2)
    ref = em.train_em_markov_pool(plist, alist, z, x, lens, **kw)
    mesh = Mesh(np.asarray(jax.devices()), ("data",))
    got = em.train_em_markov_pool(plist, alist, z, x, lens, mesh=mesh, **kw)
    for i, ((pw, aw, iw, sw), (pg, ag, ig, sg)) in enumerate(zip(ref, got)):
        assert (int(sw), int(iw)) == (int(sg), int(ig)), i
        np.testing.assert_array_equal(
            np.asarray(aw), np.asarray(ag), err_msg=f"cand {i}"
        )
        for lw, lg in zip(jax.tree.leaves(pw), jax.tree.leaves(pg)):
            np.testing.assert_allclose(
                np.asarray(lg), np.asarray(lw), rtol=1e-9, atol=1e-12,
                err_msg=f"cand {i}",
            )


@pytest.mark.slow
def test_markov_multi_shardmap_longT_matches_unsharded():
    """Data-parallel multi-restart trainer at long T: per-shard canonical
    Φ route must equal the single-device multi trainer (f64 mesh)."""
    from jax.sharding import Mesh

    z, x, lens, params0, assign0 = _longT_problem(94)
    rng = np.random.default_rng(95)
    C, n = 2, z.shape[1]
    R = 3
    pstack = jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[
            em.MixtureParams(
                pi=params0.pi,
                m=params0.m
                + 0.2 * rng.normal(size=np.asarray(params0.m).shape),
                S=params0.S, A=params0.A, G=params0.G,
                H=params0.H, L=params0.L,
            )
            for _ in range(R)
        ],
    )
    astack = jnp.asarray(
        rng.integers(0, C, size=(R, n)).astype(np.int32)
    )
    ref = em.train_em_markov_multi(pstack, astack, z, x, lens, n_steps=5)
    mesh = Mesh(np.asarray(jax.devices()), ("data",))
    got = sharded_em.train_em_markov_multi_shardmap(
        pstack, astack, z, x, lens, mesh=mesh, n_steps=5
    )
    np.testing.assert_array_equal(np.asarray(ref[3]), np.asarray(got[3]))
    np.testing.assert_array_equal(np.asarray(ref[2]), np.asarray(got[2]))
    np.testing.assert_array_equal(np.asarray(ref[1]), np.asarray(got[1]))
    for a, b in zip(ref[0], got[0]):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=1e-9, atol=1e-12
        )


def test_mixture_multistart_masked_filter_multichip(monkeypatch):
    """MTM_MULTICHIP=1 on the masked-filter multistart route: each
    sequential candidate trains data-parallel through
    train_em_masked_kalman_shardmap; winner/assignments/objectives must
    equal the single-device run (f64 mesh — psums exact here)."""
    from multimodal_trajectory_modeling_tpu.models.mixture import (
        MMLinGaussSS_marginalizable,
    )

    rng = np.random.default_rng(19)
    T, n, d, l = 8, 320, 3, 2  # n divisible by 8 devices
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l)) + 0.7 * np.repeat(
        z[:, :, :1], l, axis=2
    )
    z[:, n // 2 :, :] += 2.0
    z[rng.random(z.shape) < 0.15] = np.nan
    x[rng.random(x.shape) < 0.15] = np.nan

    def run(multichip):
        if multichip:
            monkeypatch.setenv("MTM_MULTICHIP", "1")
        else:
            monkeypatch.delenv("MTM_MULTICHIP", raising=False)
        np.random.seed(1357)
        return MMLinGaussSS_marginalizable(
            n_clusters=2, states=z, observations=x, init="random"
        ).train_with_multiple_random_starts(
            n_starts=3,
            n_steps=8,
            use_cache=False,
            fast=True,
            return_objectives=True,
        )

    mdl1, o1 = run(False)
    mdl2, o2 = run(True)
    np.testing.assert_allclose(o2, o1, rtol=1e-9)
    np.testing.assert_array_equal(
        mdl2.cluster_assignment, mdl1.cluster_assignment
    )


def test_bench_multichip_entry_runs_on_cpu_mesh(monkeypatch):
    """The MTM_BENCH_MULTICHIP=1 bench route (bench.bench_multidevice)
    must stay runnable: build a small batch with bench's own data
    builder (layout="tnd") and drive the full shard_map Markov trainer
    over whatever devices the test backend exposes.  Guards the
    driver-facing multichip bench flag against bit-rot — on multi-chip
    hardware this exact code path becomes the headline."""
    import bench

    monkeypatch.setenv("MTM_BENCH_MC_STEPS", "3")
    n = 512  # divisible by the 8 virtual devices; >16 rows per cluster
    b0, b1, _zb, _xb, _vb, patterns, pid = bench._make_data(
        n, layout="tnd"
    )
    rate, n_chips = bench.bench_multidevice(b0, b1, patterns, pid)
    assert n_chips == len(jax.devices())
    assert np.isfinite(rate) and rate >= 0.0
