"""Trajectory-length scaling: fused O(T) Markov EM vs the dense-joint
kernels whose per-row cost grows with D² = (T(d+l))².

The reference's scaling wall in T is the (T(d+l))² joint covariance
(marginalizable_state_space_model.py joint-moment assembly): at T=512,
d=5, l=3 that is a 4096² matrix per (cluster, pattern).  The Markov
factorization (ops/markov.py) never builds it — per-iteration cost is
O(T·n·(d²+dl+l²)) — so EM stays fast and memory-flat as T grows.

A third column times the exact partial-observation Kalman filter
(`em.masked_logliks_kalman`) on the same batch with ~30% of coordinates
knocked out at INTERIOR positions — the arbitrary-missingness regime
where neither the suffix Markov factorization nor (past T≈64) the dense
joint applies.  One (C, n) log-likelihood evaluation is the unit (the
filter is the E-step's density engine there).

Prints one line per T with ms/EM-iteration for each path (dense skipped
once its joint moments exceed the device); run on the GPU.
"""

import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from multimodal_trajectory_modeling_tpu import config as mtm_config

mtm_config.enable_persistent_compilation_cache()

from multimodal_trajectory_modeling_tpu import ops
from multimodal_trajectory_modeling_tpu.models import em

N = int(os.environ.get("MTM_LONGT_N", 100_000))
D_H, D_O, C = 5, 3, 16
DENSE_T_MAX = 64  # (T(d+l))² joint per (cluster, pattern) beyond this
T_LIST = tuple(
    int(t)
    for t in os.environ.get("MTM_LONGT_TLIST", "10,32,64,128,256,512").split(
        ","
    )
)


def make(T, n):
    rng = np.random.default_rng(0)
    A = rng.normal(scale=0.2, size=(D_H, D_H))
    H = rng.normal(size=(D_H, D_O))
    m = rng.normal(size=D_H)
    lengths = (T // 2, T - 1, T)
    lens = rng.choice(lengths, size=n)
    pid = np.searchsorted(np.asarray(lengths), lens).astype(np.int32)
    patterns = np.stack(
        [
            np.concatenate(
                [
                    np.repeat(np.arange(T) < Ln, D_H),
                    np.repeat(np.arange(T) < Ln, D_O),
                ]
            )
            for Ln in lengths
        ]
    )

    @functools.partial(jax.jit, static_argnames=("n", "T"))
    def build(key, lens_dev, n, T):
        z, x = ops.sample_trajectories(
            key,
            n,
            T,
            jnp.asarray(m, jnp.float32),
            jnp.eye(D_H, dtype=jnp.float32) / 5,
            jnp.asarray(A, jnp.float32),
            jnp.eye(D_H, dtype=jnp.float32) / 2,
            jnp.asarray(H, jnp.float32),
            jnp.eye(D_O, dtype=jnp.float32) / 3,
        )
        tmask = jnp.arange(T)[:, None] < lens_dev[None, :]
        z = jnp.where(tmask[:, :, None], z, jnp.nan)
        x = jnp.where(tmask[:, :, None], x, jnp.nan)
        return z, x, em.pack_joint(z, x)

    z, x, v = build(jax.random.PRNGKey(0), jnp.asarray(lens), n, T)
    return z, x, v, jnp.asarray(patterns), pid, lens


def time_markov(z, x, lens, T, params, iters=10):
    n = z.shape[1]
    lj = jnp.asarray(lens.astype(np.int32))
    a = jnp.zeros((n,), jnp.int32)
    # emstep_markov without phi= builds Φ inside every call
    step = jax.jit(functools.partial(em.emstep_markov, T=T))
    ztp = jnp.transpose(z, (0, 2, 1)).reshape(T * D_H, n)
    xtp = jnp.transpose(x, (0, 2, 1)).reshape(T * D_O, n)
    args = (ztp, xtp, lj)
    p, a, _c, _w = step(params, *args, a)
    float(p.A[0, 0, 0])
    t0 = time.perf_counter()
    for _ in range(iters):
        p, a, _c, _w = step(params, *args, a)
    float(p.A[0, 0, 0])
    return (time.perf_counter() - t0) / iters * 1e3


def time_markov_phi(z, x, lens, T, params, iters=10):
    """(one-time feature materialization ms, ms per from-features EM
    iteration) — the production precompute route of train_em_markov:
    Φ's row count is T-independent, so the per-iteration cost stops
    growing with T entirely (the O(T) cost moves into the single
    materialization pass)."""
    from multimodal_trajectory_modeling_tpu.ops import markov_phi as pm

    n = z.shape[1]
    lj = jnp.asarray(lens.astype(np.int32))
    a = jnp.zeros((n,), jnp.int32)
    ztp = jnp.transpose(z, (0, 2, 1)).reshape(T * D_H, n)
    xtp = jnp.transpose(x, (0, 2, 1)).reshape(T * D_O, n)
    packed_ok = T * 8 * ((D_H + D_O + 7) // 8) <= 512
    if packed_ok:
        u = jax.jit(
            functools.partial(em.pack_markov_batch, T=T, d=D_H, l=D_O)
        )(ztp, xtp)
        mat = jax.jit(
            functools.partial(em.pack_markov_features, T=T, d=D_H, l=D_O)
        )
        args = (u, lj)
        layout = "compact"
    else:
        mat = jax.jit(
            functools.partial(
                pm.markov_materialize_features_longT, T=T, d=D_H, l=D_O
            )
        )
        args = (ztp, xtp, lj)
        layout = "canonical"
    phi = mat(*args)
    float(phi[0, 0])
    t0 = time.perf_counter()
    phi = mat(*args)
    float(phi[0, 0])
    mat_ms = (time.perf_counter() - t0) * 1e3

    step = jax.jit(
        functools.partial(em.emstep_markov, T=T, phi_layout=layout)
    )
    p, a, _c, _w = step(params, ztp, xtp, lj, a, phi=phi)
    float(p.A[0, 0, 0])
    t0 = time.perf_counter()
    for _ in range(iters):
        p, a, _c, _w = step(params, ztp, xtp, lj, a, phi=phi)
    float(p.A[0, 0, 0])
    return mat_ms, (time.perf_counter() - t0) / iters * 1e3


def time_kalman_masked(z, x, T, params, iters=10):
    """(ms per (C, n) masked-filter log-likelihood evaluation, ms per
    full EM iteration E+M) with ~30% interior per-coordinate
    missingness injected on top of the batch — the training regime
    neither the suffix-Markov kernel nor (past T≈64) the dense joint
    covers."""
    rng = np.random.default_rng(2)
    zm = np.asarray(z).copy()
    xm = np.asarray(x).copy()
    zm[rng.random(zm.shape) < 0.3] = np.nan
    xm[rng.random(xm.shape) < 0.3] = np.nan
    zj, xj = jnp.asarray(zm), jnp.asarray(xm)
    ll_fn = jax.jit(em.masked_logliks_kalman)
    ll = ll_fn(params, zj, xj)
    float(ll[0, 0])
    t0 = time.perf_counter()
    for _ in range(iters):
        ll = ll_fn(params, zj, xj)
    float(ll[0, 0])
    ll_ms = (time.perf_counter() - t0) / iters * 1e3

    @jax.jit
    def em_step(params, zj, xj):
        ll = em.masked_logliks_kalman(params, zj, xj)
        a = em.assignments_from_logliks(params.pi, ll)
        return em.mstep(zj, xj, a, n_clusters=C), a

    p2, a2 = em_step(params, zj, xj)
    float(p2.A[0, 0, 0])
    t0 = time.perf_counter()
    for _ in range(iters):
        p2, a2 = em_step(params, zj, xj)
    float(p2.A[0, 0, 0])
    em_ms = (time.perf_counter() - t0) / iters * 1e3
    return ll_ms, em_ms


def time_suffix_inference(z, x, lens, T, params, iters=50, reps=3):
    """ms per one-shot (C, n) suffix-missingness INFERENCE call on the
    routed path (`em.suffix_logliks_markov`: the XLA slice-pair
    formulation) —
    held-out scoring / held-out model selection is this call; compare
    against the masked-filter column (its exact arbitrary-missingness
    superset, ~26× slower at T=300 on suffix data).

    Min-of-``reps`` over ``iters`` pipelined calls, so that dispatch
    jitter does not land on the ms-scale readings."""
    lj = jnp.asarray(lens.astype(np.int32))
    ll = em.suffix_logliks_markov(params, z, x, lj)
    float(ll[0, 0])
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            ll = em.suffix_logliks_markov(params, z, x, lj)
        float(ll[0, 0])
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    return best


def time_dense(z, x, v, patterns, pid, T, params, iters=10):
    """ms per dense-joint EM iteration: the E step with per-pattern
    precomputed inverses (train(fast=True)'s dense route) plus the M
    step."""
    n = v.shape[0]
    pj = jnp.asarray(pid)

    @jax.jit
    def step(params, assign):
        ll = em.estep_logliks(params, v, patterns, pj, T=T, method="inverse")
        na = em.assignments_from_logliks(params.pi, ll)
        return em.mstep(z, x, na, n_clusters=C), na

    a = jnp.zeros((n,), jnp.int32)
    p, a = step(params, a)
    float(p.A[0, 0, 0])
    t0 = time.perf_counter()
    for _ in range(iters):
        p, a = step(params, a)
    float(p.A[0, 0, 0])
    return (time.perf_counter() - t0) / iters * 1e3


def main():
    rng = np.random.default_rng(1)
    rows = []
    for T in T_LIST:
        z, x, v, patterns, pid, lens = make(T, N)
        params = em.MixtureParams(
            pi=jnp.ones(C, jnp.float32) / C,
            m=jnp.asarray(rng.normal(size=(C, D_H)), jnp.float32),
            S=jnp.asarray(np.stack([np.eye(D_H)] * C), jnp.float32),
            A=jnp.asarray(
                rng.normal(scale=0.2, size=(C, D_H, D_H)), jnp.float32
            ),
            G=jnp.asarray(np.stack([np.eye(D_H)] * C), jnp.float32),
            H=jnp.asarray(rng.normal(size=(C, D_H, D_O)), jnp.float32),
            L=jnp.asarray(np.stack([np.eye(D_O)] * C), jnp.float32),
        )
        mk = time_markov(z, x, lens, T, params)
        mat_ms, mk_phi = time_markov_phi(z, x, lens, T, params)
        inf_ms = time_suffix_inference(z, x, lens, T, params)
        ka, ka_em = time_kalman_masked(z, x, T, params)
        if T <= DENSE_T_MAX:
            dn = time_dense(z, x, v, patterns, pid, T, params)
            print(
                f"T={T:4d}: markov {mk:8.2f} ms/iter"
                f"   phi {mk_phi:6.2f} ms/iter (+{mat_ms:.1f} once)"
                f"   infer {inf_ms:7.2f} ms"
                f"   dense {dn:8.2f} ms/iter"
                f"   ({dn/mk:.1f}x)   kalman-masked {ka:8.2f} ms/eval"
                f" {ka_em:8.2f} ms/EM-iter",
                flush=True,
            )
        else:
            dn = None
            print(
                f"T={T:4d}: markov {mk:8.2f} ms/iter"
                f"   phi {mk_phi:6.2f} ms/iter (+{mat_ms:.1f} once)"
                f"   infer {inf_ms:7.2f} ms"
                f"   dense —— "
                f"((T(d+l))² joint = {(T*(D_H+D_O))}² per (cluster, pattern))"
                f"   kalman-masked {ka:8.2f} ms/eval"
                f" {ka_em:8.2f} ms/EM-iter",
                flush=True,
            )
        rows.append({"T": T, "markov_ms": round(mk, 2),
                     "markov_phi_ms": round(mk_phi, 2),
                     "phi_materialize_ms": round(mat_ms, 2),
                     "suffix_infer_ms": round(inf_ms, 2),
                     "dense_ms": None if dn is None else round(dn, 2),
                     "kalman_masked_ms": round(ka, 2),
                     "kalman_em_ms": round(ka_em, 2)})
    print(json.dumps({"metric": "em_ms_per_iter_vs_T", "n": N, "rows": rows}))


if __name__ == "__main__":
    main()
