"""Chip smoke test: drive the EM trainers once on one NVIDIA GPU.

    python chip_smoke.py            # every one-card phase, n = 1e6
    python chip_smoke.py --multi    # only the 4-card data-parallel phase

Phases, in order; each prints one line, and a failing phase exits
non-zero without printing the final ``ok`` line:

1. device      — JAX's first device is a GPU; the card's name and power
                 limit as ``nvidia-smi`` reports them.
2. main path   — ``MMLinGaussSS_marginalizable.train(fast=True)`` at
                 n = 1e6, T = 10, d = 5, l = 3, C = 16 (float32, lengths
                 5/8/10 with p = .3/.3/.4) from the true labels with 20% of
                 the rows reassigned at random; more than one EM iteration,
                 cluster recovery (permutation-aware) ≥ 0.95; then
                 ``train_with_multiple_random_starts`` over 8 candidates,
                 which must auto-select the Markov slot pool.
3. reference   — every Φ-route entry point at full width against the plain
                 f64 reference (``ops.markov.markov_em_features`` and
                 ``em.emstep_markov_xla``): Φ, statistics, counts,
                 assignments, objective, each with its stated tolerance.
4. wide range  — an unstandardized (|x| ~ 50) float32 fit at n = 1e5 must
                 not collapse and must match the float64 fit.
5. routes      — the dense route (per-pattern inverses) and the
                 masked-filter route of ``train(fast=True)`` agree with
                 ``train(fast=False)``.

``--multi`` runs only the data-parallel trainers on a 1-D ``("data",)`` mesh
over four cards against the single-card trainers, from perturbed labels so
that several iterations run.

The data are synthetic mixtures generated on the device from ``--seed``.
The last line of standard output is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

T, D, L_OBS, C = 10, 5, 3, 16
N_MAIN = 1_000_000
LENGTHS, LENGTH_P = (5, 8, 10), (0.3, 0.3, 0.4)

# Stated tolerances.  Φ: max over rows of max|Φ − ref| / max|ref| of the row.
# Statistics: max over (feature, cluster) of |g − g_ref| / Σ|Φ| over the
# cluster's rows — the summation's own error scale.  Objective: relative to
# Σ_i |max_c score|.  The int16 store adds one rounding of 1/65532 of each
# row's maximum.  With the products in TF32 instead of exact float32, the
# objective and wide-range checks fail (by 5-8× and 3.9× on an H100).
TOL = {
    "phi_wide": 1e-5,
    "phi_i16": 5e-5,
    "stats_wide": 1e-4,
    "stats_i16": 5e-4,
    "obj_wide": 1e-4,
    "obj_i16": 5e-4,
    "assign_agree": 0.999,
    "recovery": 0.95,
    "route_objective": 1e-4,
    "wide_range_params": 1e-2,
    "perturb": 0.2,
}


class PhaseFailed(Exception):
    pass


def _check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


@contextlib.contextmanager
def _phase(name):
    t0 = time.perf_counter()
    try:
        yield
    except Exception as err:
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s: "
              f"{type(err).__name__}: {err}", flush=True)
        raise


@contextlib.contextmanager
def _count_calls(module, name):
    """Record ``(kwargs, result)`` of each call a public entry point makes
    to ``module.name``."""
    calls = []
    orig = getattr(module, name)

    def counted(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append((kwargs, out))
        return out

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def _recovery(labels, assign, n_clusters):
    """Fraction of rows in the best one-to-one label↔cluster matching."""
    from scipy.optimize import linear_sum_assignment

    conf = np.zeros((n_clusters, n_clusters), np.int64)
    np.add.at(conf, (np.asarray(labels), np.asarray(assign)), 1)
    r, c = linear_sum_assignment(-conf)
    return conf[r, c].sum() / labels.size


def mixture_data(seed, n, n_clusters, *, mean_scale=3.0, drop=None):
    """A C-cluster LG-SSM mixture sampled on the device: ``(z (T, n, d),
    x (T, n, l), lens (n,), labels (n,))`` as NumPy float32/int arrays.

    Without ``drop`` the rows end after 5, 8 or 10 steps (suffix
    missingness).  ``drop`` maps a time step to the probability that the
    whole step is missing (interior missingness; lengths are then T)."""
    import jax
    import jax.numpy as jnp

    from multimodal_trajectory_modeling_tpu import ops

    rng = np.random.default_rng(seed)
    f32 = np.float32
    m = jnp.asarray(rng.normal(scale=mean_scale, size=(n_clusters, D)), f32)
    A = jnp.asarray(rng.normal(scale=0.4, size=(n_clusters, D, D)), f32)
    H = jnp.asarray(rng.normal(size=(n_clusters, D, L_OBS)), f32)
    nc = n // n_clusters
    p_drop = np.zeros(T, f32)
    for t, p in (drop or {}).items():
        p_drop[t] = p

    @jax.jit
    def build(key):
        kz, kl, kd = jax.random.split(key, 3)

        def one(k, mc, Ac, Hc):
            return ops.sample_trajectories(
                k, nc, T, mc, jnp.eye(D, dtype=f32) / 5, Ac,
                jnp.eye(D, dtype=f32) / 2, Hc, jnp.eye(L_OBS, dtype=f32) / 3,
            )

        z, x = jax.vmap(one)(jax.random.split(kz, n_clusters), m, A, H)
        z = jnp.moveaxis(z, 0, 1).reshape(T, nc * n_clusters, D)
        x = jnp.moveaxis(x, 0, 1).reshape(T, nc * n_clusters, L_OBS)
        rows = nc * n_clusters
        if drop:
            lens = jnp.full((rows,), T, jnp.int32)
            keep = jax.random.uniform(kd, (T, rows)) >= jnp.asarray(p_drop)[:, None]
        else:
            lens = jax.random.choice(
                kl, jnp.asarray(LENGTHS, jnp.int32), (rows,),
                p=jnp.asarray(LENGTH_P, f32),
            )
            keep = jnp.arange(T)[:, None] < lens[None, :]
        z = jnp.where(keep[:, :, None], z, jnp.nan)
        x = jnp.where(keep[:, :, None], x, jnp.nan)
        return z, x, lens

    z, x, lens = build(jax.random.PRNGKey(seed))
    labels = np.repeat(np.arange(n_clusters), nc)
    return np.asarray(z), np.asarray(x), np.asarray(lens), labels


def _perturb(labels, n_clusters, seed):
    """The labels with a ``TOL["perturb"]`` share of rows reassigned to
    random clusters: a warm start that still takes several EM steps."""
    rng = np.random.default_rng(seed)
    out = np.asarray(labels).copy()
    hit = rng.random(out.size) < TOL["perturb"]
    out[hit] = rng.integers(0, n_clusters, size=int(hit.sum()))
    return out


def _model(z, x, labels, n_clusters, seed):
    """The public model, warm-started from the given labels."""
    from multimodal_trajectory_modeling_tpu.models.mixture import (
        MMLinGaussSS_marginalizable,
    )

    np.random.seed(seed)
    mdl = MMLinGaussSS_marginalizable(
        n_clusters=n_clusters, states=z, observations=x, random_seed=seed
    )
    mdl.cluster_assignment = np.asarray(labels).copy()
    return mdl


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------


def phase_device(rehearse):
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not rehearse:
        raise PhaseFailed(
            f"JAX's first device is {dev.platform!r} ({dev.device_kind}); "
            "this smoke test needs a GPU"
        )
    smi = "nvidia-smi not available"
    if dev.platform == "gpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip()
    print(f"[device] {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
          f"jax {jax.__version__}", flush=True)
    print(smi, flush=True)
    return dev


def phase_main(seed, n, fast_multistart=None):
    from multimodal_trajectory_modeling_tpu.models import em

    z, x, lens, labels = mixture_data(seed, n, C)
    mdl = _model(z, x, _perturb(labels, C, seed), C, seed)
    with _count_calls(em, "train_em_markov") as calls:
        t0 = time.perf_counter()
        mdl.train(fast=True, n_steps=30)
        dt = time.perf_counter() - t0
    _check(len(calls) == 1, f"train(fast=True) took another route ({calls})")
    _check(mdl.last_trained is not None, "train stopped at the init guard")
    iters, status = int(calls[0][1][2]), int(calls[0][1][3])
    _check(iters > 1, f"train(fast=True) ran {iters} EM iteration(s)")
    _check(status in (em.STATUS_RUNNING, em.STATUS_CONVERGED),
           f"status {status}")
    q = mdl.e_complete_data_log_lik()
    counts = np.bincount(mdl.cluster_assignment, minlength=C)
    acc = _recovery(labels, mdl.cluster_assignment, C)
    _check(np.isfinite(q), f"objective {q}")
    _check(counts.min() > 3, f"near-empty cluster: counts {counts.tolist()}")
    _check(acc >= TOL["recovery"], f"recovery {acc:.4f}")
    print(f"[main path] train(fast=True) n={n:,} C={C} from labels with "
          f"{TOL['perturb']:.0%} reassigned: {iters} iterations, status "
          f"{status}, objective {q:.6e}, recovery {acc:.5f} "
          f"(>= {TOL['recovery']}), min count {counts.min()}, {dt:.1f} s "
          "incl. compile", flush=True)

    with _count_calls(em, "train_em_markov_pool") as calls:
        t0 = time.perf_counter()
        best, objs = mdl.train_with_multiple_random_starts(
            n_starts=7, n_steps=20, use_cache=False, return_objectives=True,
            kmeans_start=False, fast=fast_multistart,
        )
        dt = time.perf_counter() - t0
    _check(len(calls) == 1, "multistart did not auto-select the slot pool")
    pool_iters = [int(r[2]) for r in calls[0][1]]
    q_best = best.e_complete_data_log_lik()
    _check(len(objs) == 8 and np.isfinite(q_best), f"objectives {objs}")
    _check(np.isclose(q_best, np.nanmax(objs), rtol=1e-4),
           f"winner {q_best} is not the best objective {np.nanmax(objs)}")
    print(f"[main path] train_with_multiple_random_starts: 8 candidates "
          f"through the slot pool, iterations {pool_iters}, "
          f"{int(np.isfinite(objs).sum())} finite, best {q_best:.6e}, "
          f"{dt:.1f} s incl. compile", flush=True)
    params = em.MixtureParams(
        *[np.asarray(p, np.float64) for p in mdl._stacked_params()]
    )
    return z, x, lens, params


def _rel(err, scale):
    scale = np.asarray(scale)
    return float(np.max(np.where(scale > 0, np.abs(err) / np.where(
        scale > 0, scale, 1.0), np.abs(err))))


def phase_reference(z, x, lens, params, seed):
    """Every Φ-route entry point (f32 on the card) against the f64
    reference at full width."""
    import jax
    import jax.numpy as jnp

    from multimodal_trajectory_modeling_tpu.models import em
    from multimodal_trajectory_modeling_tpu.ops import markov as mops
    from multimodal_trajectory_modeling_tpu.ops import markov_phi as pm

    n = z.shape[1]
    R = 4
    rng = np.random.default_rng(seed + 1)
    plist = [params] + [
        params._replace(m=params.m + rng.normal(scale=0.3, size=params.m.shape))
        for _ in range(R - 1)
    ]
    Fc_pad, _uniq, pos = pm.markov_compact_spec(T, D, L_OBS)
    F = pos.shape[0]

    # --- f32 on the card: Φ in three forms, argmax passes
    f32 = jnp.float32
    zj, xj, lj = jnp.asarray(z, f32), jnp.asarray(x, f32), jnp.asarray(lens)
    z_t = jnp.transpose(zj, (0, 2, 1)).reshape(T * D, n)
    x_t = jnp.transpose(xj, (0, 2, 1)).reshape(T * L_OBS, n)
    u = em.pack_markov_batch(z_t, x_t, T=T, d=D, l=L_OBS)
    phis = {
        "compact wide": (pm.markov_materialize_features(
            u, lj, T=T, d=D, l=L_OBS), "compact", "wide"),
        "canonical wide": (pm.markov_materialize_features_longT(
            z_t, x_t, lj, T=T, d=D, l=L_OBS), "canonical", "wide"),
    }
    phis["compact i16"] = (
        pm.quantize_phi(phis["compact wide"][0]), "compact", "i16")
    del u
    Wg32 = jnp.stack([
        em._em_weights(em.MixtureParams(*[jnp.asarray(a, f32) for a in p]))
        for p in plist
    ])
    prev0 = jnp.zeros((n,), jnp.int32)
    argmax = {}
    for name, (phi, layout, _s) in phis.items():
        a, c, _w, _g, o = pm.markov_em_from_features(
            phi, lj, prev0, Wg32[0], T=T, d=D, l=L_OBS, layout=layout)
        argmax[name] = (np.asarray(a), np.asarray(c), float(o))
        a, c, _w, _g, o = pm.markov_em_from_features_multi(
            phi, lj, jnp.zeros((R, n), jnp.int32), Wg32, T=T, d=D, l=L_OBS,
            layout=layout)
        argmax[name + " multi"] = (np.asarray(a), np.asarray(c), np.asarray(o))

    # --- f64 reference
    with jax.enable_x64(True):
        f64 = jnp.float64
        z64, x64 = jnp.asarray(z, f64), jnp.asarray(x, f64)
        lens64 = jnp.asarray(lens, jnp.int32)
        feats = jax.jit(mops.markov_em_features)(z64, x64, lens64)  # (n, F)

        @jax.jit
        def ref_pass(feats, Wg):
            scores = jnp.matmul(feats, Wg.T, precision="highest")
            a = jnp.argmax(scores, axis=1).astype(jnp.int32)
            onehot = (a[:, None] == jnp.arange(C)[None, :]).astype(f64)
            g = jnp.matmul(feats.T, onehot, precision="highest")
            gabs = jnp.matmul(jnp.abs(feats).T, onehot, precision="highest")
            best = jnp.max(scores, axis=1)
            return a, g, gabs, jnp.sum(best), jnp.sum(jnp.abs(best))

        ref = []
        for p in plist:
            p64 = em.MixtureParams(*[jnp.asarray(a, f64) for a in p])
            _np, a_x, c_x, _w = em.emstep_markov_xla(
                p64, z64, x64, lens64, jnp.zeros((n,), jnp.int32))
            a, g, gabs, obj, obj_abs = ref_pass(feats, em._em_weights(p64))
            _check(np.array_equal(np.asarray(a), np.asarray(a_x)),
                   "reference assignment disagrees with emstep_markov_xla")
            ref.append(dict(a=np.asarray(a_x), c=np.asarray(c_x),
                            g=np.asarray(g), gabs=np.asarray(gabs),
                            obj=float(obj), obj_abs=float(obj_abs)))

        @jax.jit
        def phi_err(feats, phi, rows, scale):
            got = jnp.take(phi.astype(f64), rows, axis=0)[:, :n]
            if scale is not None:
                got = got * jnp.take(scale.astype(f64), rows)[:, None]
            want = feats.T
            return jnp.max(
                jnp.max(jnp.abs(got - want), axis=1)
                / jnp.maximum(jnp.max(jnp.abs(want), axis=1), 1e-300)
            )

        rows = {"compact": jnp.asarray(pos), "canonical": jnp.arange(F)}
        phi_errs = {}
        for name, (phi, layout, _s) in phis.items():
            if isinstance(phi, pm.PhiQuant):
                phi_errs[name] = float(
                    phi_err(feats, phi.q, rows[layout], phi.scale))
            else:
                phi_errs[name] = float(
                    phi_err(feats, phi, rows[layout], None))
        del feats, z64, x64

    # --- f32 on the card: statistics under the reference assignment
    prev_ref = jnp.asarray(np.stack([r["a"] for r in ref]))
    for name, (phi, layout, store) in phis.items():
        tol_phi = TOL["phi_" + store]
        _check(phi_errs[name] <= tol_phi,
               f"Φ {name}: error {phi_errs[name]:.3e} > {tol_phi:.0e}")
        _a, c, _w, g, _o = pm.markov_em_from_features(
            phi, lj, prev_ref[0], Wg32[0], T=T, d=D, l=L_OBS,
            assign_mode="prev", layout=layout)
        _am, cm, _wm, gm, _om = pm.markov_em_from_features_multi(
            phi, lj, prev_ref, Wg32, T=T, d=D, l=L_OBS, assign_mode="prev",
            layout=layout)
        stats_err = _rel(np.asarray(g, np.float64) - ref[0]["g"], ref[0]["gabs"])
        for r in range(R):
            stats_err = max(stats_err, _rel(
                np.asarray(gm[r], np.float64) - ref[r]["g"], ref[r]["gabs"]))
            _check(np.array_equal(np.asarray(cm[r]), ref[r]["c"]),
                   f"{name} multi: counts differ under the reference assignment")
        _check(np.array_equal(np.asarray(c), ref[0]["c"]),
               f"{name}: counts differ under the reference assignment")
        a1, _c1, o1 = argmax[name]
        am, _cm, om = argmax[name + " multi"]
        agree = min([np.mean(a1 == ref[0]["a"])]
                    + [np.mean(am[r] == ref[r]["a"]) for r in range(R)])
        obj_err = max([abs(o1 - ref[0]["obj"]) / ref[0]["obj_abs"]]
                      + [abs(om[r] - ref[r]["obj"]) / ref[r]["obj_abs"]
                         for r in range(R)])
        tol_s, tol_o = TOL["stats_" + store], TOL["obj_" + store]
        if store == "i16":
            # the storage rounding of a sum over n_c rows shrinks as
            # 1/sqrt(n_c): scale the full-width tolerance to this n
            tol_s *= max(1.0, (N_MAIN / n) ** 0.5)
        _check(stats_err <= tol_s, f"{name}: stats error {stats_err:.3e}")
        _check(agree >= TOL["assign_agree"], f"{name}: assignments {agree}")
        _check(obj_err <= tol_o, f"{name}: objective error {obj_err:.3e}")
        print(f"[reference] Φ {name} (n={n:,}, R=1 and R={R}): Φ err "
              f"{phi_errs[name]:.2e} (tol {tol_phi:.0e}); stats err "
              f"{stats_err:.2e} (tol {tol_s:.0e}); counts exact; assignments "
              f"agree {agree:.6f} (tol {TOL['assign_agree']}); objective err "
              f"{obj_err:.2e} (tol {tol_o:.0e}); float32 operands, products "
              f"at Precision.{pm._HI.name} vs float64",
              flush=True)


def phase_wide_range(seed, n):
    """Unstandardized |x| ~ 50 float32 fit vs the float64 fit."""
    import jax

    nclu = 4
    z, x, _lens, labels = mixture_data(seed + 2, n, nclu, mean_scale=15.0)
    xmax = float(np.nanmax(np.abs(x)))
    fits = {}
    for name, x64 in (("f32", False), ("f64", True)):
        with jax.enable_x64(x64):
            mdl = _model(z, x, labels, nclu, seed)
            mdl.train(fast=True, n_steps=30)
            fits[name] = mdl
    acc = {k: _recovery(labels, m.cluster_assignment, nclu)
           for k, m in fits.items()}
    counts = np.bincount(fits["f32"].cluster_assignment, minlength=nclu)
    err = 0.0
    for attr in ("transition_matrices", "transition_covs",
                 "measurement_matrices", "measurement_covs"):
        for a32, a64 in zip(getattr(fits["f32"], attr),
                            getattr(fits["f64"], attr)):
            err = max(err, np.linalg.norm(a32 - a64) / np.linalg.norm(a64))
    _check(acc["f32"] >= TOL["recovery"], f"f32 recovery {acc['f32']:.4f}")
    _check(counts.min() >= n // (4 * nclu), f"collapse: {counts.tolist()}")
    _check(err <= TOL["wide_range_params"], f"params vs f64: {err:.3e}")
    print(f"[wide range] n={n:,} C={nclu} max|x|={xmax:.1f}: f32 recovery "
          f"{acc['f32']:.5f} (f64 {acc['f64']:.5f}), min count {counts.min()}, "
          f"A/G/H/L rel. error vs f64 fit {err:.2e} "
          f"(tol {TOL['wide_range_params']:.0e})", flush=True)


def phase_routes(seed, n):
    """train(fast=True)'s dense route (``train_em`` with per-pattern
    inverses) and masked-filter route against the default dense trainer
    ``train_em``."""
    from multimodal_trajectory_modeling_tpu.models import em

    nclu = 8
    cases = (
        ("dense, per-pattern inverses", "train_em", "inverse",
         {2: 0.3, 5: 0.3, 7: 0.3}),
        ("masked filter", "train_em_masked_kalman", None,
         {t: 0.3 for t in range(1, T)}),
    )
    for k, (name, route, method, drop) in enumerate(cases):
        z, x, _lens, labels = mixture_data(seed + 3 + k, n, nclu, drop=drop)
        q = {}
        for fast in (True, False):
            mdl = _model(z, x, labels, nclu, seed)
            with _count_calls(em, route) as calls:
                mdl.train(fast=fast, n_steps=30)
            taken = [kw for kw, _out in calls if kw.get("method") == method]
            _check(len(taken) == int(fast), f"{name}: route calls {calls}")
            q[fast] = mdl.e_complete_data_log_lik()
            acc = _recovery(labels, mdl.cluster_assignment, nclu)
            _check(acc >= TOL["recovery"], f"{name} fast={fast}: {acc:.4f}")
        rel = abs(q[True] - q[False]) / abs(q[False])
        _check(rel <= TOL["route_objective"], f"{name}: objective rel {rel:.2e}")
        print(f"[routes] {name} (n={n:,}, C={nclu}): objective {q[True]:.6e} "
              f"vs train_em {q[False]:.6e}, rel {rel:.1e} "
              f"(tol {TOL['route_objective']:.0e}), recovery {acc:.5f}",
              flush=True)


def phase_multi(seed, n, n_cards):
    """Data-parallel trainers over a 1-D ("data",) mesh vs one card."""
    import jax
    import jax.numpy as jnp

    from multimodal_trajectory_modeling_tpu.models import em
    from multimodal_trajectory_modeling_tpu.parallel import sharded_em

    devs = jax.devices()
    _check(len(devs) >= n_cards, f"{len(devs)} devices, need {n_cards}")
    mesh = jax.sharding.Mesh(np.asarray(devs[:n_cards]), ("data",))
    z, x, lens, labels = mixture_data(seed, n, C)
    f32 = jnp.float32
    zj, xj, lj = jnp.asarray(z, f32), jnp.asarray(x, f32), jnp.asarray(lens)
    start = _perturb(labels, C, seed)
    mdl = _model(z, x, start, C, seed)
    p0 = mdl._stacked_params()
    a0 = jnp.asarray(start, jnp.int32)
    single = em.train_em_markov(p0, a0, zj, xj, lj, n_steps=30)
    multi = sharded_em.train_em_markov_shardmap(
        p0, a0, zj, xj, lj, mesh=mesh, n_steps=30)
    agree = float(np.mean(np.asarray(single[1]) == np.asarray(multi[1])))
    perr = max(
        float(np.max(np.abs(np.asarray(a) - np.asarray(b)))
              / max(float(np.max(np.abs(np.asarray(b)))), 1e-30))
        for a, b in zip(jax.tree.leaves(multi[0]), jax.tree.leaves(single[0]))
    )
    _check(int(single[3]) == int(multi[3]), f"status {single[3]} vs {multi[3]}")
    _check(min(int(single[2]), int(multi[2])) > 1,
           f"iterations {int(single[2])} (1 card), {int(multi[2])} (mesh)")
    _check(agree >= TOL["assign_agree"], f"shard_map assignments {agree}")
    _check(perr <= 1e-3, f"shard_map params rel {perr:.2e}")
    print(f"[multi] train_em_markov_shardmap on {n_cards} cards, n={n:,}: "
          f"status {int(multi[3])}, iters {int(multi[2])} (1 card: "
          f"{int(single[2])}), assignments agree {agree:.6f}, params rel "
          f"{perr:.2e}", flush=True)

    cands = [p0] * 2
    assigns = [start, _perturb(labels, C, seed + 5)]
    pool1 = em.train_em_markov_pool(cands, assigns, zj, xj, lj, R=2,
                                    n_steps=20)
    pool4 = em.train_em_markov_pool(cands, assigns, zj, xj, lj, R=2,
                                    n_steps=20, mesh=mesh)
    for i, (r1, r4) in enumerate(zip(pool1, pool4)):
        _check(int(r1[3]) == int(r4[3]), f"pool cand {i}: status differs")
        _check(min(int(r1[2]), int(r4[2])) > 1,
               f"pool cand {i}: iterations {int(r1[2])}, {int(r4[2])}")
        ag = float(np.mean(np.asarray(r1[1]) == np.asarray(r4[1])))
        _check(ag >= TOL["assign_agree"], f"pool cand {i}: agree {ag}")
    print(f"[multi] train_em_markov_pool mesh={n_cards} cards vs 1 card: "
          f"statuses {[int(r[3]) for r in pool4]} equal, iters "
          f"{[int(r[2]) for r in pool4]} vs {[int(r[2]) for r in pool1]}",
          flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card data-parallel phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase at a tiny size on any backend; "
                    "never prints the ok line")
    args = ap.parse_args(argv)

    import jax

    try:
        with _phase("device"):
            dev = phase_device(args.rehearse)
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        try:
            import multimodal_trajectory_modeling_tpu  # noqa: F401
        except ImportError as err:
            raise PhaseFailed(f"the package is not importable: {err}") from err
        small = args.rehearse
        if args.multi:
            with _phase("multi"):
                phase_multi(args.seed, 4_096 if small else N_MAIN, 4)
        else:
            with _phase("main path"):
                z, x, lens, params = phase_main(
                    args.seed, 4_096 if small else N_MAIN,
                    fast_multistart=True if small else None)
            with _phase("reference"):
                phase_reference(z, x, lens, params, args.seed)
            del z, x, lens
            with _phase("wide range"):
                phase_wide_range(args.seed, 4_000 if small else 100_000)
            with _phase("routes"):
                phase_routes(args.seed, 4_000 if small else 100_000)
    except PhaseFailed as err:
        print(f"FAILED: {err}", flush=True)
        return 1
    if args.rehearse:
        print("rehearsal finished (no result: not a chip run)", flush=True)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
