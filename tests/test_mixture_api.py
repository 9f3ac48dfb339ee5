"""End-to-end tests of the public ``MMLinGaussSS_marginalizable`` class —
the reference's own self-test scenario (marginalizable_mixture_model.py:
1920-2103) scaled down: 2-cluster recovery, predictions, pickling, cache
Highlander, alpha-regularized and 1-D variants."""

import glob

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multimodal_trajectory_modeling_tpu import ops
from multimodal_trajectory_modeling_tpu.models import (
    MMLinGaussSS_marginalizable,
)
from multimodal_trajectory_modeling_tpu.models import mixture as mixture_mod


@pytest.fixture(scope="module")
def synth():
    rng = np.random.default_rng(42)
    C, T, n, d, l = 2, 20, 600, 2, 3
    pis = np.array([0.4, 0.6])
    A = np.stack([rng.normal(scale=0.5, size=(d, d)) for _ in range(C)])
    G = np.stack([np.eye(d) / (c + 2.0) for c in range(C)])
    H = np.stack([rng.normal(size=(d, l)) for _ in range(C)])
    L = np.stack([(c + 1.0) * np.eye(l) for c in range(C)])
    labels = rng.choice(C, size=n, p=pis)
    z = np.zeros((T, n, d))
    x = np.zeros((T, n, l))
    for c in range(C):
        idx = labels == c
        zc, xc = ops.sample_trajectories(
            jax.random.PRNGKey(c),
            int(idx.sum()),
            T,
            jnp.zeros(d),
            jnp.asarray(G[c]),
            jnp.asarray(A[c]),
            jnp.asarray(G[c]),
            jnp.asarray(H[c]),
            jnp.asarray(L[c]),
        )
        z[:, idx], x[:, idx] = np.asarray(zc), np.asarray(xc)
    return dict(z=z, x=x, labels=labels, pis=pis, A=A, G=G, H=H, L=L)


@pytest.fixture(scope="module")
def trained(synth):
    mdl = MMLinGaussSS_marginalizable(
        n_clusters=2, states=synth["z"], observations=synth["x"], init="kmeans"
    ).train_with_multiple_random_starts(n_starts=5, use_cache=False)
    return mdl


def test_recovers_parameters(synth, trained):
    mdl = trained
    np.testing.assert_allclose(
        np.sort(synth["pis"]), np.sort(mdl.cluster_propensities), rtol=1e-1
    )
    corr = dict(
        zip(
            np.argsort(synth["pis"]),
            np.argsort(mdl.cluster_propensities),
        )
    )
    for c_true, c_inf in corr.items():
        np.testing.assert_allclose(
            synth["A"][c_true],
            mdl.transition_matrices[c_inf],
            rtol=1e-1,
            atol=1e-1,
        )
        np.testing.assert_allclose(
            synth["G"][c_true], mdl.transition_covs[c_inf], rtol=1e-1, atol=2e-1
        )
        np.testing.assert_allclose(
            synth["H"][c_true],
            mdl.measurement_matrices[c_inf],
            rtol=1e-1,
            atol=1e-1,
        )
        np.testing.assert_allclose(
            synth["L"][c_true],
            mdl.measurement_covs[c_inf],
            rtol=1e-1,
            atol=2e-1,
        )


def test_one_step_ahead_predictions(synth, trained):
    z, x = synth["z"], synth["x"]
    z_pred, x_pred = trained.one_step_ahead_predictions(
        states=z[:-1], observations=x[:-1]
    )
    assert np.allclose((z_pred - z[-1]).squeeze().mean(axis=0), 0.0, atol=0.05)
    assert np.allclose((x_pred - x[-1]).squeeze().mean(axis=0), 0.0, atol=0.1)

    z_p0, x_p0 = trained.one_step_ahead_predictions_no_history(
        states=z[:-1], observations=x[:-1]
    )
    assert np.allclose((z_p0 - z[-1]).squeeze().mean(axis=0), 0.0, atol=0.05)
    assert np.allclose((x_p0 - x[-1]).squeeze().mean(axis=0), 0.0, atol=0.1)


def test_predictions_from_initial_data(synth, trained):
    """The single vmapped rollout must agree with a per-instance NumPy
    rollout of the assigned cluster's mean dynamics (reference
    mixture:943-995 semantics)."""
    mdl = trained
    z_pred, x_pred = mdl.predictions_from_initial_data()
    assignments = mdl.initial_full_data_cluster_assignment()

    T, n, _ = synth["z"].shape
    for i in [0, 1, n // 2, n - 1]:
        c = assignments[i]
        mu = mdl.states[0, i, :]
        for t in range(T):
            np.testing.assert_allclose(z_pred[t, i], mu, atol=1e-9)
            np.testing.assert_allclose(
                x_pred[t, i], mu @ mdl.measurement_matrices[c], atol=1e-9
            )
            mu = mu @ mdl.transition_matrices[c]
    assert np.array_equal(z_pred[0], mdl.states[0])


def test_conditional_logliks_match_scipy(synth, trained):
    """Cross-check the device E-step against a direct scipy evaluation of
    the same joint Gaussian."""
    import scipy.stats as sp_stats

    mdl = trained
    z, x = synth["z"][:, :50], synth["x"][:, :50]
    T = z.shape[0]
    c = 0
    mean = np.asarray(
        ops.joint_mean(
            T,
            jnp.asarray(mdl.init_state_means[c]),
            jnp.asarray(mdl.transition_matrices[c]),
            jnp.asarray(mdl.measurement_matrices[c]),
        )
    )
    cov = np.asarray(
        ops.joint_cov(
            T,
            jnp.asarray(mdl.init_state_covs[c]),
            jnp.asarray(mdl.transition_matrices[c]),
            jnp.asarray(mdl.transition_covs[c]),
            jnp.asarray(mdl.measurement_matrices[c]),
            jnp.asarray(mdl.measurement_covs[c]),
        )
    )
    n = z.shape[1]
    v = np.concatenate(
        [z.transpose(1, 0, 2).reshape(n, -1), x.transpose(1, 0, 2).reshape(n, -1)],
        axis=1,
    )
    want = sp_stats.multivariate_normal(
        mean=mean, cov=cov, allow_singular=True
    ).logpdf(v)
    got = mdl.conditional_log_likelihoods(c, states=z, observations=x)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-8)


@pytest.mark.slow
def test_model_selection_functions(synth, trained):
    aic = trained.aic()
    bic = trained.bic(
        states=synth["z"][:, :10], observations=synth["x"][:, :10]
    )
    assert np.isfinite(aic) and np.isfinite(bic)
    k = trained.n_free_params
    C, d, l = 2, 2, 3
    expect = (
        C  # propensities
        + C * d
        + C * d * d
        + C * d * l
        + C * (d * (d + 1) // 2) * 2
        + C * (l * (l + 1) // 2)
    )
    assert k == expect


@pytest.mark.slow
def test_propensities_over_time(synth, trained):
    pc_t = trained.cluster_propensities_over_time(
        states=synth["z"][:, :30], observations=synth["x"][:, :30]
    )
    assert pc_t.shape == (synth["z"].shape[0], 30, 2)
    assert np.allclose(pc_t.sum(axis=-1), 1.0)
    pc_obs = trained.observed_cluster_propensities_over_time(
        observations=synth["x"][:5, :30]
    )
    assert pc_obs.shape == (5, 30, 2)


def test_masked_input_tricks(synth, trained):
    """No-hidden (all-NaN states) and snapshot-masked variants must run and
    produce valid assignments — the inference paths used by the drivers."""
    z, x = synth["z"][:, :40], synth["x"][:, :40]
    a_full = trained.mle_cluster_assignment(states=z, observations=x)
    a_nohid = trained.mle_cluster_assignment(
        states=np.nan * z, observations=x
    )
    assert a_full.shape == a_nohid.shape == (40,)
    agree = np.mean(a_full == a_nohid)
    assert agree > 0.6  # informative but imperfect without hidden states


def test_pickle_roundtrip_and_highlander(synth, trained, tmp_path):
    mdl = trained
    mdl.to_pickle(save_location=str(tmp_path))
    files = glob.glob(str(tmp_path / f"mmm-{mdl.hex_hash}*"))
    assert len(files) == 1
    # again — eviction keeps exactly one
    mdl.to_pickle(save_location=str(tmp_path))
    files = glob.glob(str(tmp_path / f"mmm-{mdl.hex_hash}*"))
    assert len(files) == 1

    back = MMLinGaussSS_marginalizable.from_pickle(
        files[0],
        training_data={"states": synth["z"], "observations": synth["x"]},
    )
    assert back.hex_hash == mdl.hex_hash
    np.testing.assert_array_equal(
        back.cluster_assignment, mdl.cluster_assignment
    )
    for c in range(2):
        np.testing.assert_allclose(
            back.transition_matrices[c], mdl.transition_matrices[c]
        )
    np.testing.assert_allclose(
        back.model_log_likelihood(), mdl.model_log_likelihood(), rtol=1e-10
    )


def test_cache_probe_roundtrip(synth, trained, tmp_path, monkeypatch):
    """train_with_multiple_random_starts must reload a cached model."""
    monkeypatch.setattr(mixture_mod, "home_dir", str(tmp_path))
    mdl = trained
    mdl.to_pickle(save_location=str(tmp_path / "tmp"))
    again = MMLinGaussSS_marginalizable(
        n_clusters=2,
        states=synth["z"],
        observations=synth["x"],
        init="kmeans",
    ).train_with_multiple_random_starts(n_starts=3, use_cache=True)
    np.testing.assert_array_equal(
        again.cluster_assignment, mdl.cluster_assignment
    )


@pytest.mark.slow
def test_alpha_and_1d_variants(synth):
    z, x = synth["z"], synth["x"]
    mdl = MMLinGaussSS_marginalizable(
        n_clusters=2, states=z, observations=x, init="kmeans", alpha=0.1
    ).train_with_multiple_random_starts(n_starts=2, use_cache=False)
    assert np.isfinite(mdl.e_complete_data_log_lik())

    mdl1 = MMLinGaussSS_marginalizable(
        n_clusters=2,
        states=z[..., :1],
        observations=x[..., :1],
        init="kmeans",
        alpha=0.1,
    ).train_with_multiple_random_starts(n_starts=2, use_cache=False)
    assert np.isfinite(mdl1.e_complete_data_log_lik())


def test_regress_static_method(synth):
    z, x = synth["z"], synth["x"]
    labels = synth["labels"]
    H_est, L_est = MMLinGaussSS_marginalizable.regress(
        z[0, labels == 0], x[0, labels == 0]
    )
    np.testing.assert_allclose(H_est, synth["H"][0], atol=0.35)
    np.testing.assert_allclose(L_est, synth["L"][0], atol=0.35)


def test_rng_replication_of_constructor():
    """Constructor parameter draws must replicate the reference's global-RNG
    consumption order: identical seeds ⇒ identical parameter inits across
    two separately-seeded interpreters' call sequences."""
    z = np.random.default_rng(0).normal(size=(3, 20, 2))
    x = np.random.default_rng(1).normal(size=(3, 20, 2))

    np.random.seed(123)
    a = MMLinGaussSS_marginalizable(2, z, x, random_seed=7)
    np.random.seed(123)
    b = MMLinGaussSS_marginalizable(2, z, x, random_seed=7)
    for pa, pb in zip(a.init_state_means, b.init_state_means):
        np.testing.assert_array_equal(pa, pb)
    for pa, pb in zip(a.measurement_covs, b.measurement_covs):
        np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(a.cluster_assignment, b.cluster_assignment)
    assert a.hex_hash == b.hex_hash


@pytest.mark.slow
def test_train_fast_matches_default(synth):
    """train(fast=True) — the Markov Φ route for these suffix lengths —
    must equal train() exactly in f64."""
    rng = np.random.default_rng(9)
    z = synth["z"].copy()
    x = synth["x"].copy()
    T, n = z.shape[:2]
    lens = rng.choice([T // 2, T - 3, T], size=n)
    tmask = np.arange(T)[:, None] < lens[None, :]
    z[~tmask] = np.nan
    x[~tmask] = np.nan

    a = MMLinGaussSS_marginalizable(
        n_clusters=2, states=z, observations=x, random_seed=5, init="random"
    ).train(n_steps=40)
    b = MMLinGaussSS_marginalizable(
        n_clusters=2, states=z, observations=x, random_seed=5, init="random"
    ).train(n_steps=40, fast=True)
    np.testing.assert_array_equal(a.cluster_assignment, b.cluster_assignment)
    np.testing.assert_allclose(
        a.transition_matrices, b.transition_matrices, rtol=1e-9, atol=1e-10
    )
    np.testing.assert_allclose(
        a.measurement_matrices, b.measurement_matrices, rtol=1e-9, atol=1e-10
    )
    assert np.isclose(
        a.e_complete_data_log_lik(), b.e_complete_data_log_lik()
    )


@pytest.mark.slow
def test_verbose_multistart_transcript_and_same_winner(synth, capsys):
    """verbose=True must forward per-candidate Q prints (reference
    mixture:1444-1455 trains every candidate with verbose) and pick the
    same winner as the batched silent path."""
    quiet = MMLinGaussSS_marginalizable(
        n_clusters=2,
        states=synth["z"],
        observations=synth["x"],
        init="kmeans",
    ).train_with_multiple_random_starts(n_starts=2, use_cache=False)
    loud = MMLinGaussSS_marginalizable(
        n_clusters=2,
        states=synth["z"],
        observations=synth["x"],
        init="kmeans",
    ).train_with_multiple_random_starts(
        n_starts=2, use_cache=False, verbose=True
    )
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.strip()]
    # transcript shape: rounded Q floats interleaved with terminal lines
    n_q = sum(1 for ln in lines if ln.lstrip("-").replace(".", "").isdigit())
    n_done = sum(1 for ln in lines if ln.startswith("Optimisation completed"))
    n_empty = sum(1 for ln in lines if "near-empty" in ln)
    assert n_q > 0 and (n_done + n_empty) >= 1
    np.testing.assert_allclose(
        loud.e_complete_data_log_lik(),
        quiet.e_complete_data_log_lik(),
        rtol=1e-10,
    )
    np.testing.assert_array_equal(
        loud.cluster_assignment, quiet.cluster_assignment
    )


@pytest.mark.slow
def test_fast_multistart_matches_default(synth):
    """fast=True (the fast candidate loop) must replay
    the reference multistart protocol exactly in f64: same winner, same
    assignments, same objective as the vmapped default path."""
    np.random.seed(1234)
    slow = MMLinGaussSS_marginalizable(
        n_clusters=2,
        states=synth["z"],
        observations=synth["x"],
        init="kmeans",
    ).train_with_multiple_random_starts(
        n_starts=3, use_cache=False, fast=False, return_objectives=True
    )
    np.random.seed(1234)
    quick = MMLinGaussSS_marginalizable(
        n_clusters=2,
        states=synth["z"],
        observations=synth["x"],
        init="kmeans",
    ).train_with_multiple_random_starts(
        n_starts=3, use_cache=False, fast=True, return_objectives=True
    )
    mdl_s, obj_s = slow
    mdl_f, obj_f = quick
    np.testing.assert_allclose(obj_f, obj_s, rtol=1e-9)
    np.testing.assert_array_equal(
        mdl_f.cluster_assignment, mdl_s.cluster_assignment
    )
    np.testing.assert_allclose(
        mdl_f.e_complete_data_log_lik(),
        mdl_s.e_complete_data_log_lik(),
        rtol=1e-10,
    )


@pytest.mark.slow
def test_train_fast_interior_missingness_falls_back(synth):
    """Interior (non-suffix) missingness must fail the suffix gate and
    route the dense path with per-pattern inverses — still exactly equal
    to the default path in f64."""
    rng = np.random.default_rng(11)
    z = synth["z"].copy()
    x = synth["x"].copy()
    T, n = z.shape[:2]
    # punch an interior hole in 30% of rows: step T//2 missing entirely
    hole = rng.random(n) < 0.3
    z[T // 2, hole] = np.nan
    x[T // 2, hole] = np.nan
    mdl = MMLinGaussSS_marginalizable(
        n_clusters=2, states=z, observations=x, random_seed=5, init="random"
    )
    assert (
        mdl._suffix_pattern_lens(
            np.asarray(ops.pattern_groups(np.asarray(mdl._packed(None, None)[3]))[0]),
            T,
            z.shape[-1],
            x.shape[-1],
        )
        is None
    )
    a = MMLinGaussSS_marginalizable(
        n_clusters=2, states=z, observations=x, random_seed=5, init="random"
    ).train(n_steps=30)
    b = MMLinGaussSS_marginalizable(
        n_clusters=2, states=z, observations=x, random_seed=5, init="random"
    ).train(n_steps=30, fast=True)
    np.testing.assert_array_equal(a.cluster_assignment, b.cluster_assignment)
    assert np.isclose(
        a.e_complete_data_log_lik(), b.e_complete_data_log_lik()
    )


@pytest.mark.slow
def test_long_T_interior_missingness_routes_masked_filter():
    """Past the dense ceiling (T·(d+l) > 512) `_all_cluster_logliks` must
    route the exact O(T) partial-observation filter and still equal the
    dense drop-rows/cols marginal (f64)."""
    rng = np.random.default_rng(5)
    T, n, d, l = 130, 24, 1, 3
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    z[rng.random(size=z.shape) < 0.3] = np.nan
    x[rng.random(size=x.shape) < 0.3] = np.nan
    mdl = MMLinGaussSS_marginalizable(
        n_clusters=2, states=z, observations=x, random_seed=0, init="random"
    )
    got = mdl._all_cluster_logliks(T, None, None)
    from multimodal_trajectory_modeling_tpu.models import em as em_mod

    params = mdl._stacked_params()
    v = em_mod.pack_joint(jnp.asarray(z), jnp.asarray(x))
    patterns, pid = ops.pattern_groups(np.asarray(v))
    want = np.asarray(
        em_mod.estep_logliks(
            params, v, jnp.asarray(patterns), jnp.asarray(pid), T=T
        )
    )
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7)


def test_long_T_suffix_inference_routes_markov(monkeypatch):
    """At T(d+l) > 512 with pure-suffix missingness, inference
    (`_all_cluster_logliks`) routes the O(T) Markov factorization and
    must equal the masked-filter evaluation (both are exact O(T) routes;
    the spy pins which one was taken)."""
    from multimodal_trajectory_modeling_tpu.models import em

    calls = []
    real = em.suffix_logliks_markov

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(em, "suffix_logliks_markov", spy)

    rng = np.random.default_rng(23)
    T, n, d, l = 300, 50, 1, 1  # T(d+l) = 600 > 512
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l))
    lens = rng.integers(1, T + 1, size=n)
    tmask = np.arange(T)[:, None] < lens[None, :]
    z[~tmask] = np.nan
    x[~tmask] = np.nan
    mdl = MMLinGaussSS_marginalizable(
        n_clusters=2, states=z, observations=x, random_seed=7, init="random"
    )
    ll = mdl._all_cluster_logliks(T, None, None)
    assert calls, "long-T suffix inference did not route the Markov path"
    oracle = np.asarray(
        em.masked_logliks_kalman(
            mdl._stacked_params(),
            jnp.asarray(z),
            jnp.asarray(x),
        )
    )
    np.testing.assert_allclose(ll, oracle, rtol=1e-8, atol=1e-8)

    # interior missingness at the same T still takes the filter
    calls.clear()
    z2 = z.copy()
    z2[5, :10, 0] = np.nan
    mdl2 = MMLinGaussSS_marginalizable(
        n_clusters=2, states=z2, observations=x, random_seed=7, init="random"
    )
    mdl2._all_cluster_logliks(T, None, None)
    assert not calls


def test_long_T_observed_inference_routes_o_t_paths():
    """Past T·l > 512 the observed-only (x-marginal) inference routes
    the O(T) filters — the x-marginal Kalman pass for suffix lengths,
    the masked filter (all-NaN state block) for interior missingness —
    and must equal the dense observed-moments path (f64)."""
    from multimodal_trajectory_modeling_tpu.models import em

    rng = np.random.default_rng(31)
    T, n, d, l = 300, 40, 1, 2  # T·l = 600 > 512
    z = rng.normal(size=(T, n, d))
    for regime in ("suffix", "interior"):
        x = rng.normal(size=(T, n, l))
        if regime == "suffix":
            lens = rng.integers(1, T + 1, size=n)
            x[~(np.arange(T)[:, None] < lens[None, :])] = np.nan
        else:
            x[rng.random(size=x.shape) < 0.05] = np.nan
        mdl = MMLinGaussSS_marginalizable(
            n_clusters=2,
            states=z,
            observations=x,
            random_seed=11,
            init="random",
        )
        # the constructor's random transitions are often expansive —
        # the DENSE oracle's 600² observed covariance then overflows /
        # loses PSD, which is the very failure mode the O(T) route
        # removes; pin stable dynamics so the oracle itself is finite
        C = 2
        stable = em.MixtureParams(
            pi=jnp.ones(C) / C,
            m=jnp.asarray(rng.normal(size=(C, d))),
            S=jnp.stack([jnp.eye(d)] * C),
            A=jnp.asarray(rng.normal(scale=0.3, size=(C, d, d))),
            G=jnp.stack([jnp.eye(d)] * C),
            H=jnp.asarray(rng.normal(size=(C, d, l))),
            L=jnp.stack([jnp.eye(l)] * C),
        )
        mdl._set_params(stable)
        ll = mdl._all_observed_logliks(T, None)
        _T0, vx, patterns, pid = mdl._packed_observed(None, T)
        dense = np.asarray(
            em.observed_logliks(
                mdl._stacked_params(), vx, patterns, pid, T=T
            )
        )
        np.testing.assert_allclose(ll, dense, rtol=1e-7, atol=1e-7)


def test_train_fast_long_T_interior_missingness_routes_filter(monkeypatch):
    """At T(d+l) > 512 with interior missingness, train(fast=True) routes
    the exact O(T) masked-filter trainer (the dense joint would be
    (T(d+l))² per pattern with P ~ n patterns) and must converge to a
    model equal to calling em.train_em_masked_kalman directly.  A spy on
    the trainer pins the route itself (equality alone would also pass
    through the dense path, which agrees to ~1e-12 in f64)."""
    from multimodal_trajectory_modeling_tpu.models import em

    calls = []
    real_trainer = em.train_em_masked_kalman

    def spy(*args, **kwargs):
        calls.append(1)
        return real_trainer(*args, **kwargs)

    monkeypatch.setattr(em, "train_em_masked_kalman", spy)

    rng = np.random.default_rng(17)
    C, T, n, d, l = 2, 110, 48, 2, 3  # T(d+l) = 550 > 512
    centers = np.array([[-6.0, -6.0], [6.0, 6.0]])
    labels = np.arange(n) % C
    z = np.cumsum(rng.normal(0, 0.1, size=(T, n, d)), axis=0)
    z += centers[labels][None, :, :]
    x = z @ rng.normal(size=(d, l)) * 0.5 + rng.normal(0, 0.3, (T, n, l))
    z[rng.random(z.shape) < 0.1] = np.nan
    x[rng.random(x.shape) < 0.1] = np.nan

    # k-means init on the (well-separated) initial states, as the
    # reference drivers do; the captured assignment keeps the direct
    # trainer call bit-comparable
    mdl = MMLinGaussSS_marginalizable(
        n_clusters=C, states=z, observations=x, random_seed=3, init="kmeans"
    )
    init_assign = np.asarray(mdl.cluster_assignment).copy()
    params0 = mdl._stacked_params()
    trained = mdl.train(n_steps=30, fast=True)
    assert calls, "fast path did not route the masked-filter trainer"

    p_ref, a_ref, _it, st = real_trainer(
        params0,
        jnp.asarray(init_assign, jnp.int32),
        jnp.asarray(z),
        jnp.asarray(x),
        n_steps=30,
    )
    assert int(st) in (em.STATUS_CONVERGED, em.STATUS_RUNNING)
    np.testing.assert_array_equal(
        trained.cluster_assignment, np.asarray(a_ref)
    )
    np.testing.assert_allclose(
        trained.transition_matrices, np.asarray(p_ref.A), rtol=1e-12
    )
    # and the clusters it finds separate the construction labels
    acc = max(
        np.mean(trained.cluster_assignment == labels),
        np.mean(trained.cluster_assignment != labels),
    )
    assert acc > 0.95


def test_fast_multistart_unstructured_missingness_matches_default():
    """With > 256 distinct missingness patterns (unstructured NaNs),
    fast=True multistart routes the per-candidate masked-filter trainer;
    winner, assignments and per-candidate objectives must match the
    default (dense) multistart."""
    rng = np.random.default_rng(23)
    C, T, n, d, l = 2, 6, 500, 2, 3
    centers = np.array([[-4.0, -4.0], [4.0, 4.0]])
    labels = np.arange(n) % C
    z = np.cumsum(rng.normal(0, 0.2, (T, n, d)), 0) + centers[labels][None]
    x = z @ rng.normal(size=(d, l)) * 0.5 + rng.normal(0, 0.3, (T, n, l))
    z[rng.random(z.shape) < 0.12] = np.nan
    x[rng.random(x.shape) < 0.12] = np.nan

    def run(fast):
        np.random.seed(7)
        return MMLinGaussSS_marginalizable(
            n_clusters=C, states=z, observations=x, random_seed=11
        ).train_with_multiple_random_starts(
            n_starts=3, use_cache=False, fast=fast, return_objectives=True
        )

    m_def, o_def = run(False)
    m_f, o_f = run(True)
    np.testing.assert_allclose(
        np.asarray(o_f, float), np.asarray(o_def, float), rtol=1e-9
    )
    np.testing.assert_array_equal(
        m_f.cluster_assignment, m_def.cluster_assignment
    )


def test_single_cluster_trains_all_paths(synth):
    """n_clusters=1 (the first point of the model-selection sweep) must
    train under the default, suffix-Markov and dense fast paths and give
    identical single-cluster fits with finite criteria."""
    rng = np.random.default_rng(3)
    z = synth["z"][:, :200].copy()
    x = synth["x"][:, :200].copy()
    T, n = z.shape[:2]
    lens = rng.choice([T // 2, T], size=n)
    tmask = np.arange(T)[:, None] < lens[None, :]
    z[~tmask] = np.nan
    x[~tmask] = np.nan

    fits = {}
    for tag, kw in [("default", {}), ("fast", {"fast": True})]:
        mdl = MMLinGaussSS_marginalizable(
            n_clusters=1, states=z, observations=x, random_seed=2
        ).train(n_steps=20, **kw)
        assert set(np.asarray(mdl.cluster_assignment)) == {0}
        assert np.isfinite(mdl.aic()) and np.isfinite(mdl.bic())
        fits[tag] = np.asarray(mdl.transition_matrices)
    np.testing.assert_allclose(
        fits["fast"], fits["default"], rtol=1e-9, atol=1e-10
    )


@pytest.mark.slow
def test_fast_multistart_longT_pooled_matches_sequential(monkeypatch):
    """Long-T suffix data (past the packed kernel's T·s ≤ 512 gate):
    the pooled fast multistart (canonical-Φ slot pool + Φ-evaluated
    objectives) must reproduce the sequential per-candidate route —
    same winner, assignments, and objectives (f64)."""
    rng = np.random.default_rng(7)
    T, n, d, l = 80, 160, 3, 2  # T·s = 640 > 512
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l)) + 0.7 * np.repeat(
        z[:, :, :1], l, axis=2
    )
    z[:, n // 2 :, :] += 2.0
    lens = rng.integers(4, T + 1, size=n)
    for Ln in np.unique(lens):
        z[Ln:, lens == Ln] = np.nan
        x[Ln:, lens == Ln] = np.nan

    def run(fuse):
        monkeypatch.setenv("MTM_MULTISTART_FUSE", fuse)
        np.random.seed(4321)
        return MMLinGaussSS_marginalizable(
            n_clusters=2,
            states=z,
            observations=x,
            init="random",
        ).train_with_multiple_random_starts(
            n_starts=3,
            n_steps=8,
            use_cache=False,
            fast=True,
            return_objectives=True,
        )

    mdl_seq, obj_seq = run("1")  # r_fuse=1 → per-candidate trains
    mdl_pool, obj_pool = run("2")  # 3 candidates through 2 pool slots
    np.testing.assert_allclose(obj_pool, obj_seq, rtol=1e-9)
    np.testing.assert_array_equal(
        mdl_pool.cluster_assignment, mdl_seq.cluster_assignment
    )


def test_fast_multistart_masked_filter_pooled_matches_sequential(
    monkeypatch,
):
    """Unstructured (interior) missingness routed to the masked-filter
    trainer: the pooled fast multistart must reproduce the sequential
    per-candidate route — same winner, assignments, objectives (f64).
    The missingness is made unstructured enough to trip the > 256
    -patterns predicate at small T."""
    rng = np.random.default_rng(17)
    T, n, d, l = 8, 300, 3, 2
    z = rng.normal(size=(T, n, d))
    x = rng.normal(size=(T, n, l)) + 0.7 * np.repeat(
        z[:, :, :1], l, axis=2
    )
    z[:, n // 2 :, :] += 2.0
    z[rng.random(z.shape) < 0.15] = np.nan
    x[rng.random(x.shape) < 0.15] = np.nan

    def run(fuse, pool):
        monkeypatch.setenv("MTM_MULTISTART_FUSE", fuse)
        monkeypatch.setenv("MTM_MASKED_POOL", pool)
        np.random.seed(2468)
        return MMLinGaussSS_marginalizable(
            n_clusters=2,
            states=z,
            observations=x,
            init="random",
        ).train_with_multiple_random_starts(
            n_starts=3,
            n_steps=8,
            use_cache=False,
            fast=True,
            return_objectives=True,
        )

    mdl_seq, obj_seq = run("1", "0")
    mdl_pool, obj_pool = run("2", "1")  # MTM_MASKED_POOL opt-in
    np.testing.assert_allclose(obj_pool, obj_seq, rtol=1e-9)
    np.testing.assert_array_equal(
        mdl_pool.cluster_assignment, mdl_seq.cluster_assignment
    )
