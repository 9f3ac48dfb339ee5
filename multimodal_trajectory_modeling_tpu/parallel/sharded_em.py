"""Data-parallel hard EM via ``shard_map`` with explicit XLA collectives.

Two equivalent routes to multi-chip EM:

1. **Auto-partitioned** (:func:`train_em_data_parallel`): device-put the
   batch with trajectory-axis shardings (parallel/mesh.py) and call the
   ordinary jitted ``em.train_em`` — XLA's SPMD partitioner turns the
   M-step einsum reductions and the switch/bincount scalars into
   all-reduces automatically.

2. **Explicit** (:func:`train_em_shardmap`): the same loop written inside a
   ``shard_map`` over the ``data`` axis, with every cross-device reduction
   spelled out as a ``lax.psum`` — per-cluster membership counts, switch
   counts, initial-state moment statistics and both regression
   sufficient-statistic blocks.  This is the reference implementation of
   the communication pattern (6 small psums per EM iteration, all additive)
   and the template for multi-slice DCN layering later.

Both produce identical results to the single-device engine (tested on a
virtual 8-device CPU mesh in tests/test_parallel.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from multimodal_trajectory_modeling_tpu.models import em
from multimodal_trajectory_modeling_tpu.ops import gaussian as gops
from multimodal_trajectory_modeling_tpu.ops import regression as rops
from multimodal_trajectory_modeling_tpu.parallel import mesh as mesh_lib

__all__ = [
    "train_em_data_parallel",
    "train_em_shardmap",
    "train_em_markov_shardmap",
    "train_em_masked_kalman_shardmap",
    "train_em_markov_multi_shardmap",
    "train_em_multistart_sharded",
    "train_em_multistart_2d",
]


def train_em_multistart_sharded(
    params0,
    assign0,
    z,
    x,
    v,
    patterns,
    pattern_id,
    *,
    mesh: Mesh,
    axis: str = "start",
    **train_kwargs,
):
    """Restart-parallel multi-start training: the leading restart axis of
    ``params0``/``assign0`` is sharded across the mesh; each device trains
    its own slice of the vmapped EM batch with zero communication (the
    embarrassingly-parallel axis of the multi-start protocol,
    reference mixture:1368-1471).  Data and patterns are replicated."""
    from jax.sharding import NamedSharding

    rep = NamedSharding(mesh, P())

    params0 = jax.tree.map(
        lambda a: jax.device_put(
            a, NamedSharding(mesh, P(axis, *([None] * (a.ndim - 1))))
        ),
        params0,
    )
    assign0 = jax.device_put(assign0, NamedSharding(mesh, P(axis, None)))
    z, x, v = (jax.device_put(a, rep) for a in (z, x, v))
    patterns = jax.device_put(patterns, rep)
    pattern_id = jax.device_put(pattern_id, rep)

    from multimodal_trajectory_modeling_tpu.models.em import (
        train_em_multistart,
    )

    return train_em_multistart(
        params0, assign0, z, x, v, patterns, pattern_id, **train_kwargs
    )


def train_em_data_parallel(
    params0,
    assign0,
    z,
    x,
    v,
    patterns,
    pattern_id,
    *,
    mesh: Mesh,
    **train_kwargs,
):
    """Route 1: shard the batch, replicate parameters, let XLA partition the
    jitted engine.  ``assign0`` is sharded with the batch."""
    z, x, v, patterns, pattern_id = mesh_lib.shard_trajectories(
        mesh, z, x, v, patterns, pattern_id
    )
    assign0 = jax.device_put(assign0, mesh_lib.data_sharding(mesh, 1, 0))
    params0 = jax.device_put(params0, mesh_lib.replicated(mesh))
    return em.train_em(
        params0, assign0, z, x, v, patterns, pattern_id, **train_kwargs
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "n_steps",
        "reg_mode",
        "alpha",
        "method",
        "min_members",
    ),
)
def train_em_shardmap(
    params0,
    assign0,
    z,
    x,
    v,
    patterns,
    pattern_id,
    *,
    mesh: Mesh,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    method: str = "auto",
    min_members: int = 3,
):
    """Route 2: the EM while-loop inside ``shard_map(..., axis='data')``.

    Per iteration the only communication is:
      - ``psum`` of per-cluster membership counts  (C,)
      - ``psum`` of the switch count               ()
      - ``psum`` of initial-moment statistics      (C,)+(C,d)+(C,d,d)
      - ``psum`` of transition regression stats    RegressionStats
      - ``psum`` of measurement regression stats   RegressionStats
    Everything else is local; the tiny per-cluster solves are computed
    redundantly on every device (cheaper than broadcasting).
    """
    C = params0.pi.shape[0]
    T = z.shape[0]
    axis = "data"

    shard_fn = _make_shard_em_loop(
        C=C,
        T=T,
        axis=axis,
        n_steps=n_steps,
        reg_mode=reg_mode,
        alpha=alpha,
        method=method,
        min_members=min_members,
    )

    shard_map = jax.shard_map

    param_spec = jax.tree.map(lambda _: P(), params0)
    return shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            param_spec,
            P(axis),
            P(None, axis, None),
            P(None, axis, None),
            P(axis, None),
            P(None, None),
            P(axis),
        ),
        out_specs=(param_spec, P(axis), P(), P()),
        check_vma=False,
    )(params0, assign0, z, x, v, patterns, pattern_id)


def _local_mstep_stats(z_l, x_l, assign_l, C):
    """Shard-local masked M-step sufficient statistics — all additive,
    so a ``psum`` of each leaf gives the global statistics exactly."""
    dtype = z_l.dtype
    W = jax.nn.one_hot(assign_l, C, dtype=dtype)
    counts = jnp.sum(W, axis=0)
    init_stats = rops.masked_moment_stats(z_l[0], W)
    tstats = rops.weighted_regression_stats_timebatched(
        z_l[:-1], z_l[1:], W
    )
    mstats = rops.weighted_regression_stats_timebatched(z_l, x_l, W)
    return counts, init_stats, tstats, mstats


def _params_from_global_stats(
    counts, init_stats, tstats, mstats, n_total, *, reg_mode, alpha
):
    """Per-cluster solves from the psum'd statistics — tiny, so every
    device computes them redundantly (cheaper than a broadcast)."""
    pi = counts / n_total
    m0, S0 = rops.mean_cov_from_stats(init_stats)
    A, G = rops.solve_regression(tstats, mode=reg_mode, alpha=alpha)
    H, L = rops.solve_regression(mstats, mode=reg_mode, alpha=alpha)
    return em.MixtureParams(pi, m0, S0, A, G, H, L)


def _make_shard_em_loop(
    *, C, T, axis, n_steps, reg_mode, alpha, method, min_members
):
    """Build the shard-local EM while-loop.  All cross-device reductions
    are ``psum`` over the named ``axis`` (the data axis of the mesh); the
    returned function is also vmappable over a leading restart axis, which
    is how the 2-D restart x data mesh reuses it."""

    def psum_tree(t):
        return jax.tree.map(lambda a: jax.lax.psum(a, axis), t)

    def local_mstep_stats(z_l, x_l, assign_l):
        return _local_mstep_stats(z_l, x_l, assign_l, C)

    def global_params_from_stats(counts, init_stats, tstats, mstats, n_total):
        return _params_from_global_stats(
            counts, init_stats, tstats, mstats, n_total,
            reg_mode=reg_mode, alpha=alpha,
        )

    def shard_fn(params0, assign0, z_l, x_l, v_l, patterns_r, pid_l):
        assign0 = assign0.astype(jnp.int32)
        n_total = jax.lax.psum(
            jnp.asarray(assign0.shape[0], z_l.dtype), axis
        )

        counts0 = jax.lax.psum(em.counts_from_assign(assign0, C), axis)
        init_abort = jnp.min(counts0) <= min_members

        stats = local_mstep_stats(z_l, x_l, assign0)
        counts, init_stats, tstats, mstats = psum_tree(stats)
        params_m = global_params_from_stats(
            counts, init_stats, tstats, mstats, n_total
        )
        params_start = jax.tree.map(
            lambda a, b: jnp.where(init_abort, a, b), params0, params_m
        )
        status0 = jnp.where(
            init_abort, em.STATUS_INIT_ABORT, em.STATUS_RUNNING
        )

        def cond(state):
            _, _, i, status = state
            return (status == em.STATUS_RUNNING) & (i < n_steps)

        def body(state):
            params, assign, i, status = state
            means, covs = em.cluster_joint_moments(params, T)
            ll = jax.vmap(
                lambda mu, cv: gops.masked_mvn_logpdf_grouped(
                    v_l, mu, cv, patterns_r, pid_l, method=method
                )
            )(means, covs)
            new_assign = em.assignments_from_logliks(params.pi, ll)
            switches = jax.lax.psum(
                jnp.sum(new_assign != assign), axis
            )
            counts = jax.lax.psum(
                em.counts_from_assign(new_assign, C), axis
            )
            converged = switches == 0
            empty = (~converged) & (jnp.min(counts) <= min_members)
            run_m = (~converged) & (~empty)
            stats = local_mstep_stats(z_l, x_l, new_assign)
            g_counts, g_init, g_t, g_m = psum_tree(stats)
            new_params = global_params_from_stats(
                g_counts, g_init, g_t, g_m, n_total
            )
            params_out = jax.tree.map(
                lambda a, b: jnp.where(run_m, a, b), new_params, params
            )
            status_out = jnp.where(
                converged,
                em.STATUS_CONVERGED,
                jnp.where(empty, em.STATUS_EMPTY_CLUSTER, em.STATUS_RUNNING),
            )
            return (params_out, new_assign, i + 1, status_out)

        params_f, assign_f, iters, status = jax.lax.while_loop(
            cond, body, (params_start, assign0, jnp.int32(0), status0)
        )
        return params_f, assign_f, iters, status

    return shard_fn


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "n_restarts",
        "n_steps",
        "reg_mode",
        "alpha",
        "method",
        "min_members",
        "seed",
    ),
)
def train_em_multistart_2d(
    params0,
    assign0,
    z,
    x,
    v,
    patterns,
    pattern_id,
    *,
    mesh: Mesh,
    n_restarts: int | None = None,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    method: str = "auto",
    min_members: int = 3,
    seed: int = 0,
):
    """Multistart EM on a 2-D ``(restart, data)`` mesh.

    Each row of the mesh owns one slice of the restart batch and runs the
    full data-parallel EM loop over its row's ``data`` axis — psums ride
    the fast axis inside a row, and the ``restart`` axis carries ZERO
    communication (the embarrassingly-parallel multistart axis of the
    reference protocol, marginalizable_mixture_model.py:1368-1471).  This
    is the single-controller layout for multi-host deployments: map
    ``data`` onto the devices of one host and ``restart`` across hosts,
    so the per-iteration reductions never cross the slow network.

    ``assign0`` may be stacked ``(R, n)`` (one initial hard assignment per
    restart — bit-compatible with running :func:`train_em_shardmap` per
    row) or ``(n,)``, in which case R-1 extra restarts are drawn uniformly
    from ``seed`` as in the reference's random-initialization protocol.

    Returns stacked per-restart ``(params, assign, iters, status)``; the
    host-side winner rule (first strictly greater objective) is applied by
    the caller exactly as in the 1-D multistart path.
    """
    C = params0.pi.shape[0]
    T = z.shape[0]

    if assign0.ndim == 1:
        if n_restarts is None:
            raise ValueError("n_restarts required when assign0 is 1-D")
        n = assign0.shape[0]
        keys = jax.random.split(jax.random.key(seed), n_restarts - 1)
        extra = jax.vmap(
            lambda k: jax.random.randint(k, (n,), 0, C, dtype=jnp.int32)
        )(keys)
        assign0 = jnp.concatenate(
            [assign0[None].astype(jnp.int32), extra], axis=0
        )
    R = assign0.shape[0]
    params_stacked = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (R,) + a.shape), params0
    )

    shard_fn = _make_shard_em_loop(
        C=C,
        T=T,
        axis="data",
        n_steps=n_steps,
        reg_mode=reg_mode,
        alpha=alpha,
        method=method,
        min_members=min_members,
    )

    def shard_fn_2d(params_l, assign_l, z_l, x_l, v_l, patterns_r, pid_l):
        # vmap over this device's local slice of the restart batch; all
        # psums inside resolve against the "data" mesh axis only.
        return jax.vmap(
            lambda p, a: shard_fn(p, a, z_l, x_l, v_l, patterns_r, pid_l)
        )(params_l, assign_l)

    param_spec_r = jax.tree.map(lambda _: P("restart"), params_stacked)
    return jax.shard_map(
        shard_fn_2d,
        mesh=mesh,
        in_specs=(
            param_spec_r,
            P("restart", "data"),
            P(None, "data", None),
            P(None, "data", None),
            P("data", None),
            P(None, None),
            P("data"),
        ),
        out_specs=(param_spec_r, P("restart", "data"), P("restart"), P("restart")),
        check_vma=False,
    )(params_stacked, assign0, z, x, v, patterns, pattern_id)


def _resolve_phi_store_str(dtype):
    """:func:`..models.em._resolve_phi_store`, normalized to the
    hashable ``"i16" | "bf16" | None`` the jitted shard_map impls take
    as a static argument.  HOST-level only (reads the environment)."""
    from multimodal_trajectory_modeling_tpu.models.em import (
        _resolve_phi_store,
    )

    store = _resolve_phi_store(dtype)
    if store is None or store == "i16":
        return store
    return "bf16"


def _quantize_phi_global(phi, axis):
    """Quantize a per-shard Φ slice with scales pmax-ed over the data
    axis — every shard uses the GLOBAL per-row max, so the stored int16
    payload is bit-identical to a single-device
    :func:`..ops.markov_phi.quantize_phi` of the full Φ."""
    from multimodal_trajectory_modeling_tpu.ops import markov_phi

    amax = jnp.max(jnp.abs(phi), axis=1)
    if axis is not None:
        amax = jax.lax.pmax(amax, axis)
    scale = markov_phi.phi_scale_from_absmax(amax, phi.dtype)
    return markov_phi.quantize_phi(phi, scale)


def _local_markov_route(
    z_tp, x_tp, lens_l, *, T, d, l, dtype, phi_store=None, axis=None
):
    """Per-shard Φ for the shard_map trainers: returns ``(phi, layout)``
    — the compact layout when :func:`..models.em.markov_packed_ok`, else
    the canonical long-T layout.

    ``phi_store`` (resolved by the HOST-level wrappers from
    ``MTM_MARKOV_PHI`` — a jitted body must never read the env) selects
    Φ storage exactly as in :func:`..models.em._markov_features`:
    ``"i16"`` quantizes per shard with GLOBAL (pmax over ``axis``)
    per-row scales so sharded storage ≡ single-device storage bit-for-
    bit; ``"bf16"`` narrows the materialized store; ``None`` keeps the
    compute dtype (wide)."""
    from multimodal_trajectory_modeling_tpu.models.em import (
        markov_packed_ok,
    )
    from multimodal_trajectory_modeling_tpu.ops import markov_phi

    store = jnp.bfloat16 if phi_store == "bf16" else None
    if markov_packed_ok(T, d, l):
        u = markov_phi.pack_markov_u(z_tp, x_tp, T=T, d=d, l=l)
        phi = markov_phi.markov_materialize_features(
            u, lens_l, T=T, d=d, l=l, dtype=dtype, store_dtype=store
        )
        layout = "compact"
    else:
        phi = markov_phi.markov_materialize_features_longT(
            z_tp, x_tp, lens_l, T=T, d=d, l=l, store_dtype=store
        )
        layout = "canonical"
    if phi_store == "i16":
        phi = _quantize_phi_global(phi, axis)
    return phi, layout


def train_em_markov_shardmap(
    params0,
    assign0,
    z,
    x,
    lens,
    *,
    mesh: Mesh,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
):
    """Data-parallel fused O(T) Markov EM — thin wrapper that resolves
    ``MTM_MARKOV_PHI`` at call time (never inside the trace) and
    forwards to the jitted impl with it as a static argument."""
    return _train_em_markov_shardmap_impl(
        params0,
        assign0,
        z,
        x,
        lens,
        mesh=mesh,
        n_steps=n_steps,
        reg_mode=reg_mode,
        alpha=alpha,
        min_members=min_members,
        phi_store=_resolve_phi_store_str(z.dtype),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "n_steps",
        "reg_mode",
        "alpha",
        "min_members",
        "phi_store",
    ),
)
def _train_em_markov_shardmap_impl(
    params0,
    assign0,
    z,
    x,
    lens,
    *,
    mesh: Mesh,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
    phi_store: str | None = None,
):
    """Data-parallel fused O(T) Markov EM (suffix missingness) inside
    ``shard_map``: each shard runs ONE Φ pass per iteration
    (ops/markov_phi.py) and the ONLY cross-device traffic is

      - ``psum`` of the per-cluster feature-statistics block ``(F, C)``
        (~9 KB at the benchmark config — it already contains the
        membership counts as its last row), and
      - ``psum`` of the switch count (one scalar).

    Bit-equal to the single-device :func:`..models.em.train_em_markov`
    up to psum reassociation (exact on the f64 test mesh)."""
    from multimodal_trajectory_modeling_tpu.models.em import (
        MixtureParams,
        STATUS_CONVERGED,
        STATUS_EMPTY_CLUSTER,
        STATUS_INIT_ABORT,
        STATUS_RUNNING,
        _unpack_markov_em_stats,
        counts_from_assign,
    )
    from multimodal_trajectory_modeling_tpu.models.em import _em_weights
    from multimodal_trajectory_modeling_tpu.ops import markov_phi

    C = params0.pi.shape[0]
    T, _, d = z.shape
    l = x.shape[-1]
    axis = "data"

    def shard_fn(params0, assign0, z_l, x_l, lens_l):
        assign0 = assign0.astype(jnp.int32)
        n_l = z_l.shape[1]
        z_tp = jnp.transpose(z_l, (0, 2, 1)).reshape(T * d, n_l)
        x_tp = jnp.transpose(x_l, (0, 2, 1)).reshape(T * l, n_l)
        # materialized features — iteration-invariant per shard,
        # hoisted out of the while_loop below
        phi_l, layout = _local_markov_route(
            z_tp, x_tp, lens_l, T=T, d=d, l=l, dtype=z_l.dtype,
            phi_store=phi_store, axis=axis,
        )
        n_total = jax.lax.psum(jnp.asarray(n_l, z_l.dtype), axis)

        def fused(params, prev, mode):
            a, c, w, g, _obj = markov_phi.markov_em_from_features(
                phi_l,
                lens_l,
                prev,
                _em_weights(params),
                T=T,
                d=d,
                l=l,
                assign_mode=mode,
                layout=layout,
            )
            g = jax.lax.psum(g, axis)
            w = jax.lax.psum(w, axis)
            c = jax.lax.psum(c, axis)
            tstats, mstats, istats = _unpack_markov_em_stats(g, d, l)
            pi = c.astype(z_l.dtype) / n_total
            m0, S0 = rops.mean_cov_from_stats(istats)
            A, G = rops.solve_regression(tstats, mode=reg_mode, alpha=alpha)
            H, L = rops.solve_regression(mstats, mode=reg_mode, alpha=alpha)
            return MixtureParams(pi, m0, S0, A, G, H, L), a, c, w

        counts0 = jax.lax.psum(counts_from_assign(assign0, C), axis)
        init_abort = jnp.min(counts0) <= min_members
        params_m, _, _, _ = fused(params0, assign0, "prev")
        params_start = jax.tree.map(
            lambda a, b: jnp.where(init_abort, a, b), params0, params_m
        )
        status0 = jnp.where(init_abort, STATUS_INIT_ABORT, STATUS_RUNNING)

        def cond(state):
            _, _, i, status = state
            return (status == STATUS_RUNNING) & (i < n_steps)

        def body(state):
            params, assign, i, status = state
            new_params, new_assign, counts, switches = fused(
                params, assign, "argmax"
            )
            converged = switches == 0
            empty = (~converged) & (jnp.min(counts) <= min_members)
            run_m = (~converged) & (~empty)
            params_out = jax.tree.map(
                lambda a, b: jnp.where(run_m, a, b), new_params, params
            )
            status_out = jnp.where(
                converged,
                STATUS_CONVERGED,
                jnp.where(empty, STATUS_EMPTY_CLUSTER, STATUS_RUNNING),
            )
            return (params_out, new_assign, i + 1, status_out)

        params_f, assign_f, iters, status = jax.lax.while_loop(
            cond, body, (params_start, assign0, jnp.int32(0), status0)
        )
        return params_f, assign_f, iters, status

    param_spec = jax.tree.map(lambda _: P(), params0)
    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            param_spec,
            P(axis),
            P(None, axis, None),
            P(None, axis, None),
            P(axis),
        ),
        out_specs=(param_spec, P(axis), P(), P()),
        check_vma=False,
    )(params0, assign0, z, x, lens)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "n_steps", "reg_mode", "alpha", "min_members"),
)
def train_em_masked_kalman_shardmap(
    params0,
    assign0,
    z,  # (T, n, d) ARBITRARY per-coordinate NaNs — n sharded over "data"
    x,  # (T, n, l)
    *,
    mesh: Mesh,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
):
    """Data-parallel O(T) EM under ARBITRARY missingness inside
    ``shard_map``: the exact partial-observation Kalman densities
    (ops/kalman.py) are embarrassingly parallel over instances, so per
    iteration the only cross-device traffic is the same additive block
    every dense-path iteration psums — membership counts, switch count,
    initial-moment statistics and the two masked regression-stats
    tuples.  Equal to the single-device
    :func:`..models.em.train_em_masked_kalman` up to psum reassociation
    (exact on the f64 test mesh)."""
    from multimodal_trajectory_modeling_tpu.ops import kalman

    C = params0.pi.shape[0]
    axis = "data"

    def psum_tree(t):
        return jax.tree.map(lambda a: jax.lax.psum(a, axis), t)

    def shard_fn(params0, assign0, z_l, x_l):
        assign0 = assign0.astype(jnp.int32)
        n_total = jax.lax.psum(
            jnp.asarray(assign0.shape[0], z_l.dtype), axis
        )

        def mstep_l(assign):
            counts, istats, tstats, mstats = psum_tree(
                _local_mstep_stats(z_l, x_l, assign, C)
            )
            return _params_from_global_stats(
                counts, istats, tstats, mstats, n_total,
                reg_mode=reg_mode, alpha=alpha,
            )

        counts0 = jax.lax.psum(em.counts_from_assign(assign0, C), axis)
        init_abort = jnp.min(counts0) <= min_members
        params_m = mstep_l(assign0)
        params_start = jax.tree.map(
            lambda a, b: jnp.where(init_abort, a, b), params0, params_m
        )
        status0 = jnp.where(
            init_abort, em.STATUS_INIT_ABORT, em.STATUS_RUNNING
        )

        def cond(state):
            _, _, i, status = state
            return (status == em.STATUS_RUNNING) & (i < n_steps)

        def body(state):
            params, assign, i, status = state
            ll = kalman.kalman_masked_logliks(
                z_l, x_l,
                params.m, params.S, params.A, params.G, params.H,
                params.L,
            )
            new_assign = em.assignments_from_logliks(params.pi, ll)
            switches = jax.lax.psum(jnp.sum(new_assign != assign), axis)
            counts = jax.lax.psum(
                em.counts_from_assign(new_assign, C), axis
            )
            # shared termination classifier — keeps this loop in exact
            # agreement with the single-device em.train_em_masked_kalman
            _conv, _empty, run_m, status_out = em._em_termination(
                switches, counts, em.STATUS_RUNNING,
                min_members=min_members,
            )
            new_params = mstep_l(new_assign)
            params_out = jax.tree.map(
                lambda a, b: jnp.where(run_m, a, b), new_params, params
            )
            return (params_out, new_assign, i + 1, status_out)

        params_f, assign_f, iters, status = jax.lax.while_loop(
            cond, body, (params_start, assign0, jnp.int32(0), status0)
        )
        return params_f, assign_f, iters, status

    param_spec = jax.tree.map(lambda _: P(), params0)
    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            param_spec,
            P(axis),
            P(None, axis, None),
            P(None, axis, None),
        ),
        out_specs=(param_spec, P(axis), P(), P()),
        check_vma=False,
    )(params0, assign0, z, x)


def train_em_markov_multi_shardmap(
    params0,  # leading R axis on every leaf — replicated
    assign0,  # (R, n) int32 — n sharded over "data"
    z,
    x,
    lens,
    *,
    mesh: Mesh,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
):
    """Data-parallel fused-multistart Markov EM — thin wrapper that
    resolves ``MTM_MARKOV_PHI`` at call time (never inside the trace)
    and forwards to the jitted impl with it static."""
    return _train_em_markov_multi_shardmap_impl(
        params0,
        assign0,
        z,
        x,
        lens,
        mesh=mesh,
        n_steps=n_steps,
        reg_mode=reg_mode,
        alpha=alpha,
        min_members=min_members,
        phi_store=_resolve_phi_store_str(z.dtype),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "n_steps",
        "reg_mode",
        "alpha",
        "min_members",
        "phi_store",
    ),
)
def _train_em_markov_multi_shardmap_impl(
    params0,  # leading R axis on every leaf — replicated
    assign0,  # (R, n) int32 — n sharded over "data"
    z,
    x,
    lens,
    *,
    mesh: Mesh,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
    phi_store: str | None = None,
):
    """Data-parallel FUSED-MULTISTART Markov EM: every device holds all R
    restart parameter rows (tiny) and its own trajectory shard; each
    iteration is ONE R-restart Φ pass per shard
    (ops/markov_phi.py:markov_em_from_features_multi — one Φ read
    amortized across the chunk) followed by psums of the
    per-restart statistics blocks ``g (R, F, C)``, membership counts
    ``(R, C)`` and switch counts ``(R,)``.  All devices cooperate on every
    restart — the complement of :func:`train_em_multistart_sharded`
    (restarts sharded, data replicated): use THIS when n is too large per
    device, THAT when restarts outnumber devices and data fits per chip.

    Per-restart status/convergence semantics equal
    :func:`..models.em.train_em_markov_multi` exactly (up to psum
    reassociation — exact on the f64 test mesh); the loop runs until every
    restart in the chunk is terminal.  Returns ``(params (R, ...), assign
    (R, n), iters (R,), status (R,))``.

    Reference protocol: mixture:1368-1471 (n_starts sequential ``train()``
    calls); communication is ~R·(F·C+C+1) floats per iteration.
    """
    from multimodal_trajectory_modeling_tpu.models.em import (
        STATUS_CONVERGED,
        STATUS_EMPTY_CLUSTER,
        STATUS_INIT_ABORT,
        STATUS_RUNNING,
        MixtureParams,
        _em_weights,
        _tree_select_rows,
        _unpack_markov_em_stats,
        counts_from_assign,
    )
    from multimodal_trajectory_modeling_tpu.ops import markov_phi

    R, C = params0.pi.shape
    T, _, d = z.shape
    l = x.shape[-1]
    axis = "data"

    def shard_fn(params0, assign0, z_l, x_l, lens_l):
        assign0 = assign0.astype(jnp.int32)
        n_l = z_l.shape[1]
        z_tp = jnp.transpose(z_l, (0, 2, 1)).reshape(T * d, n_l)
        x_tp = jnp.transpose(x_l, (0, 2, 1)).reshape(T * l, n_l)
        phi_l, layout = _local_markov_route(
            z_tp, x_tp, lens_l, T=T, d=d, l=l, dtype=z_l.dtype,
            phi_store=phi_store, axis=axis,
        )
        n_total = jax.lax.psum(jnp.asarray(n_l, z_l.dtype), axis)

        def fused(params, prev, mode):
            a, c, w, g, _obj = markov_phi.markov_em_from_features_multi(
                phi_l,
                lens_l,
                prev,
                jax.vmap(_em_weights)(params),
                T=T,
                d=d,
                l=l,
                assign_mode=mode,
                layout=layout,
            )
            g = jax.lax.psum(g, axis)
            w = jax.lax.psum(w, axis)
            c = jax.lax.psum(c, axis)

            def solve_one(g_r, c_r):
                tstats, mstats, istats = _unpack_markov_em_stats(g_r, d, l)
                pi = c_r.astype(z_l.dtype) / n_total
                m0, S0 = rops.mean_cov_from_stats(istats)
                A, G = rops.solve_regression(
                    tstats, mode=reg_mode, alpha=alpha
                )
                H, L = rops.solve_regression(
                    mstats, mode=reg_mode, alpha=alpha
                )
                return MixtureParams(pi, m0, S0, A, G, H, L)

            return jax.vmap(solve_one)(g, c), a, c, w

        counts0 = jax.lax.psum(
            jax.vmap(counts_from_assign, in_axes=(0, None))(assign0, C),
            axis,
        )
        init_abort = jnp.min(counts0, axis=1) <= min_members  # (R,)
        params_m, _, _, _ = fused(params0, assign0, "prev")
        params_start = _tree_select_rows(init_abort, params0, params_m)
        status0 = jnp.where(init_abort, STATUS_INIT_ABORT, STATUS_RUNNING)

        def cond(state):
            _, _, i, status, _ = state
            return jnp.any(status == STATUS_RUNNING) & (i < n_steps)

        def body(state):
            params, assign, i, status, iters = state
            new_params, new_assign, counts, switches = fused(
                params, assign, "argmax"
            )
            running = status == STATUS_RUNNING  # (R,)
            converged = running & (switches == 0)
            empty = (
                running
                & ~converged
                & (jnp.min(counts, axis=1) <= min_members)
            )
            run_m = running & ~converged & ~empty
            params_out = _tree_select_rows(run_m, new_params, params)
            assign_out = jnp.where(running[:, None], new_assign, assign)
            status_out = jnp.where(
                converged,
                STATUS_CONVERGED,
                jnp.where(empty, STATUS_EMPTY_CLUSTER, status),
            )
            return (
                params_out,
                assign_out,
                i + 1,
                status_out,
                iters + running.astype(jnp.int32),
            )

        params_f, assign_f, _i, status, iters = jax.lax.while_loop(
            cond,
            body,
            (
                params_start,
                assign0,
                jnp.int32(0),
                status0,
                jnp.zeros((R,), jnp.int32),
            ),
        )
        return params_f, assign_f, iters, status

    param_spec = jax.tree.map(lambda _: P(), params0)
    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            param_spec,
            P(None, axis),
            P(None, axis, None),
            P(None, axis, None),
            P(axis),
        ),
        out_specs=(param_spec, P(None, axis), P(), P()),
        check_vma=False,
    )(params0, assign0, z, x, lens)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh",
        "T",
        "d",
        "l",
        "n_true",
        "K",
        "n_steps",
        "reg_mode",
        "alpha",
        "min_members",
        "phi_layout",
    ),
)
def _pool_window_shardmap(
    params,  # stacked (R-leading) MixtureParams — replicated
    assigns,  # (R, n_pad) int32 — lanes sharded over "data"
    status,  # (R,) int32 — replicated
    iters,  # (R,) int32
    force,  # (R,) int32
    lens,  # (n_pad,) int32 — sharded (0 on pad lanes)
    phi,  # (F_pad, n_pad) materialized features — lanes sharded
    *,
    mesh: Mesh,
    T: int,
    d: int,
    l: int,
    n_true: int,
    K: int,
    n_steps: int,
    reg_mode: str,
    alpha: float,
    min_members: int,
    phi_layout: str = "compact",
):
    """Data-parallel :func:`..models.em._pool_window`: K fused
    multi-restart pool iterations in ONE dispatch with every lane-axis
    reduction an explicit ``psum`` — the per-restart statistics block
    ``g (R, F, C)``, membership counts ``(R, C)`` and switch counts
    ``(R,)`` per iteration, exactly the
    :func:`train_em_markov_multi_shardmap` communication pattern.  The
    per-slot freeze/insert semantics (force_prev, capped iteration
    counts) are replicated math on psummed scalars, so every shard
    agrees bit-for-bit."""
    from multimodal_trajectory_modeling_tpu.models.em import (
        MixtureParams,
        _em_weights,
        _pool_window_protocol,
        _unpack_markov_em_stats,
    )
    from multimodal_trajectory_modeling_tpu.ops import markov_phi

    axis = "data"

    def shard_fn(params, assigns_l, status, iters, force, lens_l, phi_l):
        # pad lanes must stay prev = -1 across passes: the Φ pass marks
        # its OWN invalid-lane outputs with C (not -1), and unlike the
        # single-device wrapper (which re-pads prev from a length-n
        # vector every call) this state array round-trips through the
        # pass — without the mask a pad lane would turn "valid" on
        # the second pass and poison counts/switches
        w_l = assigns_l.shape[1]
        lane0 = jax.lax.axis_index(axis) * w_l
        validlane = (lane0 + jnp.arange(w_l)) < n_true  # (w_l,)

        def emstep(params, prev, force_r):
            a, c, w, g, _obj = markov_phi.markov_em_from_features_multi(
                phi_l,
                lens_l,
                prev,
                jax.vmap(_em_weights)(params),
                T=T,
                d=d,
                l=l,
                assign_mode="argmax",
                force_prev=force_r,
                layout=phi_layout,
            )
            g = jax.lax.psum(g, axis)
            c = jax.lax.psum(c, axis)
            w = jax.lax.psum(w, axis)

            def solve_one(g_r, c_r):
                tstats, mstats, istats = _unpack_markov_em_stats(g_r, d, l)
                pi = c_r.astype(g_r.dtype) / n_true
                m0, S0 = rops.mean_cov_from_stats(istats)
                A, G = rops.solve_regression(
                    tstats, mode=reg_mode, alpha=alpha
                )
                H, L = rops.solve_regression(
                    mstats, mode=reg_mode, alpha=alpha
                )
                return MixtureParams(pi, m0, S0, A, G, H, L)

            return jax.vmap(solve_one)(g, c), a, c, w

        return _pool_window_protocol(
            emstep,
            K,
            (params, assigns_l, status, iters, force),
            n_steps=n_steps,
            min_members=min_members,
            assign_mask=validlane,
        )

    param_spec = jax.tree.map(lambda _: P(), params)
    if isinstance(phi, markov_phi.PhiQuant):
        # int16 payload lane-sharded; per-row scales replicated
        phi_spec = markov_phi.PhiQuant(P(None, "data"), P())
    else:
        phi_spec = P(None, "data")
    return jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            param_spec,
            P(None, "data"),
            P(),
            P(),
            P(),
            P("data"),
            phi_spec,
        ),
        out_specs=(param_spec, P(None, "data"), P(), P(), P()),
        check_vma=False,
    )(params, assigns, status, iters, force, lens, phi)


def pool_window_for_mesh(
    z,  # (T, n, d) NaN-suffix-padded
    x,  # (T, n, l)
    lens,  # (n,) int32
    *,
    mesh: Mesh,
    K: int,
    n_steps: int,
    reg_mode: str,
    alpha: float,
    min_members: int,
    u=None,
):
    """Prepare the data-parallel pool window for
    :func:`..models.em.train_em_markov_pool` ``mesh=`` mode: pad the
    lane axis to a multiple of 128 lanes per shard, materialize Φ
    sharded on lanes, and return ``(window, n_state)`` where
    ``window(stack, assigns, status, iters, force)`` runs
    :func:`_pool_window_shardmap` over the mesh and ``n_state`` is the
    padded lane count the host scheduler's state arrays must carry (pad
    lanes ride as ``prev = -1``, ignored by the Φ pass).  ``u`` reuses a
    packed batch (compact layout only)."""
    from multimodal_trajectory_modeling_tpu.models.em import (
        markov_packed_ok,
    )
    from multimodal_trajectory_modeling_tpu.ops import markov_phi

    T, n, d = z.shape
    l = x.shape[-1]
    D = int(mesh.shape["data"])
    quantum = 128 * D
    n_pad = ((n + quantum - 1) // quantum) * quantum
    lens_pad = jnp.concatenate(
        [
            jnp.asarray(lens, jnp.int32),
            jnp.zeros((n_pad - n,), jnp.int32),
        ]
    )
    phi_store = _resolve_phi_store_str(z.dtype)
    store = jnp.bfloat16 if phi_store == "bf16" else None

    def _pad_lanes(a_t):
        if a_t.shape[1] >= n_pad:
            return a_t[:, :n_pad]
        return jnp.concatenate(
            [a_t, jnp.zeros((a_t.shape[0], n_pad - a_t.shape[1]), a_t.dtype)],
            axis=1,
        )

    def _shard(fn, *args):
        return jax.shard_map(
            fn,
            mesh=mesh,
            in_specs=(P(None, "data"),) * (len(args) - 1) + (P("data"),),
            out_specs=P(None, "data"),
            check_vma=False,
        )(*args)

    if markov_packed_ok(T, d, l):
        if u is None:
            z_tp = jnp.transpose(z, (0, 2, 1)).reshape(T * d, n)
            x_tp = jnp.transpose(x, (0, 2, 1)).reshape(T * l, n)
            u = markov_phi.pack_markov_u(
                z_tp, x_tp, T=T, d=d, l=l, pad_to=n_pad
            )
        phi = _shard(
            lambda u_l, lens_l: markov_phi.markov_materialize_features(
                u_l, lens_l, T=T, d=d, l=l, dtype=u.dtype, store_dtype=store
            ),
            _pad_lanes(u),
            lens_pad,
        )
        phi_layout = "compact"
    else:
        z_tp = _pad_lanes(jnp.transpose(z, (0, 2, 1)).reshape(T * d, n))
        x_tp = _pad_lanes(jnp.transpose(x, (0, 2, 1)).reshape(T * l, n))
        phi = _shard(
            lambda zl, xl, ll: markov_phi.markov_materialize_features_longT(
                zl, xl, ll, T=T, d=d, l=l, store_dtype=store
            ),
            z_tp,
            x_tp,
            lens_pad,
        )
        phi_layout = "canonical"
    if phi_store == "i16":
        # quantize the GLOBAL Φ at host level (scales over all lanes ⇒
        # storage bit-identical to the single-device pool); the int16
        # payload stays lane-sharded through the window's phi_spec
        phi = markov_phi.quantize_phi(phi)

    def window(stack, assigns, status, iters, force):
        return _pool_window_shardmap(
            stack,
            assigns,
            status,
            iters,
            force,
            lens_pad,
            phi,
            mesh=mesh,
            T=T,
            d=d,
            l=l,
            n_true=n,
            K=K,
            n_steps=n_steps,
            reg_mode=reg_mode,
            alpha=alpha,
            min_members=min_members,
            phi_layout=phi_layout,
        )

    return window, n_pad
