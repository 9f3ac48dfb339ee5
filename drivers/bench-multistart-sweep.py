"""Multistart sweep throughput at scale: 64 restarts x 1M trajectories.

Reference protocol: a sequential Python loop over restarts, each a full
EM training run (marginalizable_mixture_model.py:1368-1471).  The rebuild
offers two device schedules:

- ``fast`` — one compile, restarts replayed through the fused O(T)
  Markov EM loop (:func:`em.train_em_markov`; objectives via the same
  kernel's Σ-max-score output) — the path
  ``train_with_multiple_random_starts(fast=True)`` routes at large n;
- ``vmapped`` — :func:`em.train_em_multistart` batches restarts on the
  restart axis (the small-n default; at n=1e6 its XLA E/M steps dominate).

Data: a genuine 16-cluster linear-Gaussian mixture (stable per-cluster
dynamics) so EM iterations do real reassignment work; starts are
noisy-label inits (30% resampled) so no start hits the near-empty guard
at iteration one.  EM iteration caps keep wall time bounded; throughput
is reported as aggregate EM iterations/sec across the sweep.

Usage: python drivers/bench-multistart-sweep.py  (GPU)
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

N = int(os.environ.get("MTM_SWEEP_N", 1_000_000))
R = int(os.environ.get("MTM_SWEEP_STARTS", 64))
T, D_H, D_O, C = 10, 5, 3, 16
N_STEPS = 20
# the vmapped XLA path materializes a (batch, C, D, n) residual tensor —
# f32[8,16,80,1e6] = 40 GB at batch 8 — so batches stay small
VMAP_BATCH = 2
_LENGTHS = (T // 2, T - 2, T)


def make_mixture(n):
    """n trajectories drawn from C distinct stable LG-SSMs, NaN-padded to
    three lengths; returns sorted-by-pattern arrays + true labels."""
    rng = np.random.default_rng(0)
    per = n // C
    zs, xs = [], []
    key = jax.random.PRNGKey(0)
    for c in range(C):
        A = rng.normal(scale=0.15, size=(D_H, D_H)) + 0.35 * (
            2.0 * (c % 2) - 1.0
        ) * np.eye(D_H)
        H = rng.normal(size=(D_H, D_O))
        m = rng.normal(scale=2.0, size=D_H)
        z, x = ops.sample_trajectories(
            jax.random.fold_in(key, c),
            per,
            T,
            jnp.asarray(m, jnp.float32),
            jnp.eye(D_H, dtype=jnp.float32) / 5,
            jnp.asarray(A, jnp.float32),
            jnp.eye(D_H, dtype=jnp.float32) / 2,
            jnp.asarray(H, jnp.float32),
            jnp.eye(D_O, dtype=jnp.float32) / 3,
        )
        zs.append(z)
        xs.append(x)
    z = jnp.concatenate(zs, axis=1)
    x = jnp.concatenate(xs, axis=1)
    n = z.shape[1]
    labels = np.repeat(np.arange(C), per)

    lens = rng.choice(_LENGTHS, size=n, p=[0.3, 0.3, 0.4])
    pid = np.searchsorted(np.asarray(_LENGTHS), lens).astype(np.int32)
    patterns = np.stack(
        [
            np.concatenate(
                [
                    np.repeat(np.arange(T) < Ln, D_H),
                    np.repeat(np.arange(T) < Ln, D_O),
                ]
            )
            for Ln in _LENGTHS
        ]
    )
    tmask = jnp.arange(T)[:, None] < jnp.asarray(lens)[None, :]
    z = jnp.where(tmask[:, :, None], z, jnp.nan)
    x = jnp.where(tmask[:, :, None], x, jnp.nan)
    v = em.pack_joint(z, x)

    order = np.argsort(pid, kind="stable")
    sizes = tuple(int(s) for s in np.bincount(pid, minlength=len(_LENGTHS)))
    oj = jnp.asarray(order)
    return (
        z[:, oj],
        x[:, oj],
        v[oj],
        jnp.asarray(patterns),
        jnp.asarray(pid[order]),
        sizes,
        labels[order],
    )


def noisy_starts(labels, r, frac=0.6):
    """r per-start inits: true labels with `frac` resampled uniformly."""
    out = np.empty((r, labels.shape[0]), np.int32)
    for i in range(r):
        rng = np.random.default_rng(1000 + i)
        flip = rng.random(labels.shape[0]) < frac
        out[i] = np.where(
            flip, rng.integers(0, C, size=labels.shape[0]), labels
        )
    return out


def main():
    z, x, v, patterns, pid, sizes, labels = make_mixture(N)
    n = v.shape[0]
    starts = noisy_starts(labels, R)
    # params0 is only consulted on init-abort (the trainer runs its own
    # initial M-step from assign0) — a shared dummy keeps the loop lean
    params0 = em.mstep(z, x, jnp.asarray(starts[0]), n_clusters=C)

    # per-row lengths (suffix missingness by construction)
    plens = np.asarray(patterns[:, : T * D_H]).reshape(-1, T, D_H)
    plens = plens.all(-1).sum(-1)
    lens = jnp.asarray(np.repeat(plens, sizes).astype(np.int32))
    ztp = jax.jit(
        lambda a_: jnp.transpose(a_, (0, 2, 1)).reshape(T * D_H, -1)
    )(z)
    xtp = jax.jit(
        lambda a_: jnp.transpose(a_, (0, 2, 1)).reshape(T * D_O, -1)
    )(x)
    objective = jax.jit(
        functools.partial(em.complete_data_loglik_markov, T=T)
    )

    # --- fast path: sequential fused O(T) Markov EM loop, one compile -
    run = jax.jit(functools.partial(em.train_em_markov, n_steps=N_STEPS))
    # warm-up compile
    p, a, it, st = run(params0, jnp.asarray(starts[0]), z, x, lens)
    float(p.A[0, 0, 0])
    float(objective(p, ztp, xtp, lens))
    t0 = time.perf_counter()
    tot_iters, objs = 0, []
    for i in range(R):
        p, a, it, st = run(params0, jnp.asarray(starts[i]), z, x, lens)
        tot_iters += int(it)
        objs.append(float(objective(p, ztp, xtp, lens)))
    dt_fast = time.perf_counter() - t0
    finite = [o for o in objs if np.isfinite(o)]
    print(
        f"fast: {R} starts x n={n}: {dt_fast:.1f} s wall, "
        f"{tot_iters} EM iters -> {tot_iters/dt_fast:.1f} agg iters/s, "
        f"{len(finite)}/{R} finite objectives",
        flush=True,
    )

    # --- fused-multi path: R_FUSE restarts per kernel pass ------------
    # (one batch read + one parameter-independent feature build per
    # iteration amortized over the chunk; the score GEMM runs at C·R_FUSE
    # rows)
    R_FUSE = int(os.environ.get("MTM_MULTISTART_FUSE", "8"))
    u_pack = jax.jit(
        functools.partial(em.pack_markov_batch, T=T, d=D_H, l=D_O)
    )(ztp, xtp)
    run_multi = jax.jit(
        functools.partial(em.train_em_markov_multi, n_steps=N_STEPS)
    )
    obj_multi = jax.jit(
        functools.partial(em.complete_data_loglik_markov_multi, T=T)
    )
    pb8 = jax.tree.map(lambda *xs: jnp.stack(xs), *([params0] * R_FUSE))
    pm, am, im, sm = run_multi(
        pb8, jnp.asarray(starts[:R_FUSE]), z, x, lens, u=u_pack
    )
    float(pm.A[0, 0, 0, 0])
    float(obj_multi(pm, lens, u_pack)[0])  # warm-up compiles
    t0 = time.perf_counter()
    tot_iters_m, objs_m = 0, []
    for i0 in range(0, R, R_FUSE):
        pm, am, im, sm = run_multi(
            pb8, jnp.asarray(starts[i0 : i0 + R_FUSE]), z, x, lens,
            u=u_pack,
        )
        tot_iters_m += int(jnp.sum(im))
        objs_m.extend(np.asarray(obj_multi(pm, lens, u_pack)).tolist())
    dt_multi = time.perf_counter() - t0
    finite_m = [o for o in objs_m if np.isfinite(o)]
    print(
        f"fused-multi (R={R_FUSE}/pass): {R} starts x n={n}: "
        f"{dt_multi:.1f} s wall, {tot_iters_m} EM iters -> "
        f"{tot_iters_m/dt_multi:.1f} agg iters/s, "
        f"{len(finite_m)}/{R} finite objectives",
        flush=True,
    )

    # --- pool path: R_POOL slots, refill on termination ---------------
    # (the production multistart scheduler: no convergence-spread
    # idling, so the slot count can ride the kernel's large-R
    # efficiency — em.train_em_markov_pool)
    R_POOL = int(os.environ.get("MTM_MULTISTART_POOL", "32"))
    # warm the jitted K-iteration window (same static config + shapes as
    # the timed sweep — the other sections warm their compiles too)
    em.train_em_markov_pool(
        [params0] * min(R_POOL, R),
        [starts[i] for i in range(min(R_POOL, R))],
        z,
        x,
        lens,
        R=R_POOL,
        n_steps=N_STEPS,
        u=u_pack,
    )
    # warm the objective at the full-R stacked shape too — otherwise its
    # compile lands inside the timed region (the other sections warm
    # their objective calls at their exact timed shapes)
    pb_all = jax.tree.map(lambda *xs: jnp.stack(xs), *([params0] * R))
    float(obj_multi(pb_all, lens, u_pack)[0])
    t0 = time.perf_counter()
    pooled = em.train_em_markov_pool(
        [params0] * R,
        [starts[i] for i in range(R)],
        z,
        x,
        lens,
        R=R_POOL,
        n_steps=N_STEPS,
        u=u_pack,
    )
    pstack = jax.tree.map(
        lambda *ps: jnp.stack(ps), *[p for p, _a, _i, _s in pooled]
    )
    objs_p = np.asarray(obj_multi(pstack, lens, u_pack)).tolist()
    dt_pool = time.perf_counter() - t0
    tot_iters_p = sum(int(r[2]) for r in pooled)
    finite_p = [o for o in objs_p if np.isfinite(o)]
    print(
        f"pool (R={R_POOL} slots): {R} starts x n={n}: "
        f"{dt_pool:.1f} s wall, {tot_iters_p} EM iters -> "
        f"{tot_iters_p/dt_pool:.1f} agg iters/s, "
        f"{len(finite_p)}/{R} finite objectives",
        flush=True,
    )

    # --- vmapped path: one batch of VMAP_BATCH, extrapolated ----------
    pb = jax.tree.map(
        lambda *xs: jnp.stack(xs), *([params0] * VMAP_BATCH)
    )
    ab = jnp.asarray(starts[:VMAP_BATCH])
    pidb = pid
    pv, av, iv, sv, ov = em.train_em_multistart(
        pb, ab, z, x, v, patterns, pidb, n_steps=2
    )
    float(pv.A[0, 0, 0, 0])  # compile + sync
    t0 = time.perf_counter()
    pv, av, iv, sv, ov = em.train_em_multistart(
        pb, ab, z, x, v, patterns, pidb, n_steps=N_STEPS
    )
    float(pv.A[0, 0, 0, 0])
    dt_v = time.perf_counter() - t0
    it_v = int(jnp.sum(iv))
    rate_v = it_v / dt_v
    print(
        f"vmapped: {VMAP_BATCH} starts x n={n}: {dt_v:.1f} s wall, "
        f"{it_v} EM iters -> {rate_v:.1f} agg iters/s "
        f"(extrapolates to {R} starts at the same rate)",
        flush=True,
    )
    print(
        json.dumps(
            {
                "metric": "multistart_sweep_agg_em_iters_per_sec",
                "n": n,
                "starts": R,
                "fast_iters_per_sec": round(tot_iters / dt_fast, 2),
                "fused_multi_iters_per_sec": round(
                    tot_iters_m / dt_multi, 2
                ),
                "pool_iters_per_sec": round(tot_iters_p / dt_pool, 2),
                "vmapped_iters_per_sec": round(rate_v, 2),
                "speedup": round((tot_iters / dt_fast) / rate_v, 2),
                "fused_multi_vs_fast": round(
                    (tot_iters_m / dt_multi) / (tot_iters / dt_fast), 2
                ),
            }
        )
    )


if __name__ == "__main__":
    main()
