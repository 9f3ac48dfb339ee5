"""The jitted hard-assignment EM engine for mixtures of marginalizable
linear-Gaussian state-space models.

Reference semantics (framework/marginalizable_mixture_model.py):

- E step (``mle_cluster_assignment`` :724-791, ``E_step`` :1235-1252):
  per-cluster joint log-likelihoods of every instance's stacked trajectory
  (NaN coordinates exactly marginalized), argmax of ``π_c · L_c``; the number
  of changed assignments drives convergence (0 switches ⇒ converged).
- M step (:1254-1308): per-cluster propensity = membership mean; initial
  moments from finite first-step states; transition and measurement models by
  (optionally ridge-regularized) least squares over stacked finite pairs;
  residual covariances mean-centered with ddof = 1.
- ``train`` (:1310-1366): abort before training if any cluster has ≤ 3
  members; M first, then E → (converged? / near-empty?) → M, up to n_steps.
- Objective (``e_complete_data_log_lik`` :579-624): hard-assignment complete
  data log-likelihood with a *fresh* E assignment.

Accelerator design: per-cluster Python lists become stacked ``(C, …)``
arrays in a :class:`MixtureParams` pytree; the per-instance numba loop
becomes the pattern-grouped masked Gaussian kernel; the M step is a handful
of einsums + tiny per-cluster solves; the training loop is a ``lax.while_loop``
whose state carries a status code replicating the reference's exact stop
conditions.  Everything vmaps over a leading *restart* axis for multi-start
training and shards over the trajectory axis for data parallelism.

Deviations from the reference (deliberate, documented):
- argmax and mixture log-likelihoods are computed in log space
  (``log π + ll`` / logsumexp) instead of ``π · exp(ll)`` — identical argmax
  and strictly better numerics except when every cluster underflows to 0,
  where the reference degenerates to argmax-of-zeros.
- degenerate M-step solves produce NaN parameters instead of raising; NaN
  objectives are never selected by the multi-start winner rule, replicating
  the reference's exception-swallowing restart protocol (:1439-1464).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multimodal_trajectory_modeling_tpu.ops import gaussian as gops
from multimodal_trajectory_modeling_tpu.ops import moments as mops
from multimodal_trajectory_modeling_tpu.ops import regression as rops

__all__ = [
    "MixtureParams",
    "STATUS_RUNNING",
    "STATUS_CONVERGED",
    "STATUS_EMPTY_CLUSTER",
    "STATUS_INIT_ABORT",
    "pack_joint",
    "pack_observed",
    "cluster_joint_moments",
    "cluster_observed_moments",
    "estep_logliks",
    "observed_logliks",
    "assignments_from_logliks",
    "mstep",
    "complete_data_loglik",
    "complete_data_loglik_markov",
    "complete_data_loglik_masked_kalman",
    "model_loglik",
    "model_loglik_markov",
    "suffix_logliks_markov",
    "observed_logliks_kalman",
    "masked_logliks_kalman",
    "train_em",
    "train_em_masked_kalman",
    "train_em_masked_kalman_pool",
    "train_em_markov",
    "train_em_markov_outofcore",
    "train_em_markov_multi",
    "train_em_markov_pool",
    "train_em_multistart",
    "pack_markov_batch",
    "pack_markov_features",
    "emstep_markov",
    "emstep_markov_multi",
    "emstep_masked_kalman_multi",
    "mstep_multi",
    "complete_data_loglik_markov_multi",
    "emstep_markov_xla",
    "estep_assign_markov",
]

STATUS_RUNNING = 0
STATUS_CONVERGED = 1
STATUS_EMPTY_CLUSTER = 2
STATUS_INIT_ABORT = 3


class MixtureParams(NamedTuple):
    """Stacked per-cluster parameters (leading axis C).

    Mirrors the reference's per-cluster lists
    (marginalizable_mixture_model.py:83-125): propensities π, initial state
    mean m / cov S, transition matrix A / cov G, measurement matrix H / cov L
    (row-vector convention ``z' = z A``, ``x = z H``).
    """

    pi: jax.Array  # (C,)
    m: jax.Array  # (C, d)
    S: jax.Array  # (C, d, d)
    A: jax.Array  # (C, d, d)
    G: jax.Array  # (C, d, d)
    H: jax.Array  # (C, d, l)
    L: jax.Array  # (C, l, l)

    @property
    def n_clusters(self) -> int:
        return self.pi.shape[0]


def pack_joint(z: jax.Array, x: jax.Array) -> jax.Array:
    """Stack ``(T,n,d)`` states and ``(T,n,l)`` observations into the joint
    layout ``[z_1..z_T, x_1..x_T]`` per instance → ``(n, T*(d+l))``.

    Matches the reference's ``np.hstack((*states, *observations))``
    (marginalizable_mixture_model.py:489-494)."""
    T, n, d = z.shape
    l = x.shape[-1]
    return jnp.concatenate(
        [
            jnp.transpose(z, (1, 0, 2)).reshape(n, T * d),
            jnp.transpose(x, (1, 0, 2)).reshape(n, T * l),
        ],
        axis=1,
    )


def pack_observed(x: jax.Array) -> jax.Array:
    """Stack observations only → ``(n, T*l)`` (observed-only inference)."""
    T, n, l = x.shape
    return jnp.transpose(x, (1, 0, 2)).reshape(n, T * l)


def cluster_joint_moments(
    params: MixtureParams, T: int
) -> tuple[jax.Array, jax.Array]:
    """Per-cluster joint (mean, cov): ``(C, D)``, ``(C, D, D)``."""
    means = jax.vmap(lambda m, A, H: mops.joint_mean(T, m, A, H))(
        params.m, params.A, params.H
    )
    covs = jax.vmap(lambda S, A, G, H, L: mops.joint_cov(T, S, A, G, H, L))(
        params.S, params.A, params.G, params.H, params.L
    )
    return means, covs


def cluster_observed_moments(
    params: MixtureParams, T: int
) -> tuple[jax.Array, jax.Array]:
    """Per-cluster observed-only (mean, cov) — hidden states marginalized."""
    means = jax.vmap(lambda m, A, H: mops.observed_mean(T, m, A, H))(
        params.m, params.A, params.H
    )
    covs = jax.vmap(
        lambda S, A, G, H, L: mops.observed_cov(T, S, A, G, H, L)
    )(params.S, params.A, params.G, params.H, params.L)
    return means, covs


@functools.partial(jax.jit, static_argnames=("T", "method"))
def estep_logliks(
    params: MixtureParams,
    v: jax.Array,
    patterns: jax.Array,
    pattern_id: jax.Array,
    *,
    T: int,
    method: str = "auto",
) -> jax.Array:
    """``(C, n)`` per-cluster conditional log-likelihoods of every instance.

    Reference: ``conditional_log_likelihoods_first_T0_steps``
    (marginalizable_mixture_model.py:439-494) — rebuild mm/CC per cluster,
    one masked-Gaussian kernel call over all instances.

    ``method`` selects the quadratic-form path of
    :func:`..ops.gaussian.masked_mvn_logpdf_grouped`: ``"solve"``
    (triangular solves), ``"inverse"`` (precomputed inverses, GEMMs),
    ``"bucketed"`` or ``"auto"``."""
    means, covs = cluster_joint_moments(params, T)
    return jax.vmap(
        lambda mu, cov: gops.masked_mvn_logpdf_grouped(
            v, mu, cov, patterns, pattern_id, method=method
        )
    )(means, covs)


@functools.partial(jax.jit, static_argnames=("T", "method"))
def observed_logliks(
    params: MixtureParams,
    vx: jax.Array,
    patterns: jax.Array,
    pattern_id: jax.Array,
    *,
    T: int,
    method: str = "auto",
) -> jax.Array:
    """``(C, n)`` observed-only conditional log-likelihoods (reference
    ``observed_condl_log_lik_first_T0_steps``, mixture:997-1048)."""
    means, covs = cluster_observed_moments(params, T)
    return jax.vmap(
        lambda mu, cov: gops.masked_mvn_logpdf_grouped(
            vx, mu, cov, patterns, pattern_id, method=method
        )
    )(means, covs)


def observed_logliks_kalman(
    params: MixtureParams,
    x: jax.Array,  # (T, n, l) NaN-suffix-padded observations
    lens: jax.Array,  # (n,) int32 observed prefix lengths
) -> jax.Array:
    """``(C, n)`` observation-marginal log-likelihoods via the O(T)
    Kalman filter (ops/kalman.py) — the long-T route for
    :func:`observed_logliks` under suffix missingness (f64-identical to
    the dense observed-moments path, tested).

    Past T = 128 the scalarized masked filter takes over with an all-NaN
    state block (observed-only is its z-fully-missing special case; its
    (n,)-leaf scan compiles in seconds where the suffix filter's
    large-carry scan does not)."""
    from multimodal_trajectory_modeling_tpu.ops import kalman

    T = x.shape[0]
    if T > 128:
        z_none = jnp.full(
            (T, x.shape[1], params.m.shape[1]), jnp.nan, x.dtype
        )
        return masked_logliks_kalman(params, z_none, x)
    return kalman.kalman_observed_logliks(
        x, lens, params.m, params.S, params.A, params.G, params.H, params.L
    )


@jax.jit
def masked_logliks_kalman(
    params: MixtureParams,
    z: jax.Array,  # (T, n, d) arbitrary per-coordinate NaNs
    x: jax.Array,  # (T, n, l)
) -> jax.Array:
    """``(C, n)`` joint log-likelihoods of the observed entries under
    ARBITRARY missingness via the O(T) partial-observation filter
    (ops/kalman.py:kalman_masked_logliks) — the long-T route for
    :func:`estep_logliks` when interior missingness rules out the Markov
    suffix factorization and T makes the dense (T(d+l))² joint
    infeasible.  Exact (equal to the dense marginalization in f64,
    tested; better-conditioned at long T)."""
    from multimodal_trajectory_modeling_tpu.ops import kalman

    return kalman.kalman_masked_logliks(
        z, x, params.m, params.S, params.A, params.G, params.H, params.L
    )


@jax.jit
def complete_data_loglik_masked_kalman(
    params: MixtureParams,
    z: jax.Array,  # (T, n, d) arbitrary per-coordinate NaNs
    x: jax.Array,  # (T, n, l)
) -> jax.Array:
    """Hard-assignment expected complete-data log-likelihood Q with a
    fresh E assignment, evaluated through the exact O(T) masked filter —
    the general-missingness analogue of :func:`complete_data_loglik`
    (reference ``e_complete_data_log_lik``, mixture:579-624)."""
    ll = masked_logliks_kalman(params, z, x)
    a = assignments_from_logliks(params.pi, ll)
    picked = jnp.take_along_axis(ll, a[None, :], axis=0)[0]
    return jnp.sum(jnp.log(params.pi)[a]) + jnp.sum(picked)


def assignments_from_logliks(pi: jax.Array, ll: jax.Array) -> jax.Array:
    """Hard MLE assignment ``argmax_c (log π_c + ll_c)`` → ``(n,)`` int32."""
    return jnp.argmax(jnp.log(pi)[:, None] + ll, axis=0).astype(jnp.int32)


def counts_from_assign(assign: jax.Array, n_clusters: int) -> jax.Array:
    """``bincount(assign, length=C)`` as a compare+sum — identical result,
    but lowers to a fused reduction instead of a scatter-add."""
    lanes = jnp.arange(n_clusters, dtype=assign.dtype)
    return jnp.sum(
        (assign[:, None] == lanes[None, :]).astype(jnp.int32), axis=0
    )


def _assign_counts_switches(pi, ll, prev_assign):
    assign = assignments_from_logliks(pi, ll)
    counts = counts_from_assign(assign, pi.shape[0])
    switches = jnp.sum(assign != prev_assign.astype(jnp.int32))
    return assign, counts, switches.astype(jnp.int32)


def estep_assign_markov(
    params: MixtureParams,
    z_t: jax.Array,  # (T·d, n) transposed latent batch
    x_t: jax.Array,  # (T·l, n) transposed observations
    lens: jax.Array,  # (n,) int32 per-row observed prefix lengths
    prev_assign: jax.Array,  # (n,) int32
    *,
    T: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """O(T) Markov-factorized E step for SUFFIX missingness:
    ``(assign, counts, switches)`` from
    :func:`..ops.markov.markov_suffix_logliks` — same assignments as the
    dense path up to f32 reassociation (exact in f64)."""
    d = params.m.shape[1]
    l = params.H.shape[2]
    n = z_t.shape[1]
    z = jnp.transpose(z_t.reshape(T, d, n), (0, 2, 1))
    x = jnp.transpose(x_t.reshape(T, l, n), (0, 2, 1))
    ll = _suffix_logliks_markov_xla(params, z, x, lens)
    return _assign_counts_switches(params.pi, ll, prev_assign)


def _unpack_markov_em_stats(g: jax.Array, d: int, l: int):
    """Split the Φ pass's per-cluster feature sums ``g (F, C)`` into
    the transition/measurement :class:`~..ops.regression.RegressionStats`
    and initial :class:`~..ops.regression.MomentStats` (the statistics
    :func:`mstep` accumulates, under suffix missingness)."""
    gT = g.T  # (C, F)
    C = gT.shape[0]
    dd = d * d
    o = 0

    def take(k):
        nonlocal o
        out = gT[:, o : o + k]
        o += k
        return out

    g1 = take(dd).reshape(C, d, d)  # Σ vm z⊗z
    g2 = take(dd).reshape(C, d, d)  # Σ vm⁺ z⊗z
    g3 = take(dd).reshape(C, d, d)  # Σ vm⁺ z⊗z_next
    g4 = take(l * l).reshape(C, l, l)  # Σ vm x⊗x
    g5 = take(d * l).reshape(C, d, l)  # Σ vm z⊗x
    g6 = take(dd).reshape(C, d, d)  # z0⊗z0
    g7 = take(d)  # Σ vm⁺ z
    g8 = take(d)  # Σ vm z
    g9 = take(l)  # Σ vm x
    g10 = take(d)  # z0
    g11 = take(1)[:, 0]  # Σ len
    g12 = take(1)[:, 0]  # row count
    tstats = rops.RegressionStats(
        xtx=g2, xty=g3, yty=g1 - g6, sx=g7, sy=g8 - g10, count=g11 - g12
    )
    mstats = rops.RegressionStats(
        xtx=g1, xty=g5, yty=g4, sx=g8, sy=g9, count=g11
    )
    istats = rops.MomentStats(count=g12, s=g10, ss=g6)
    return tstats, mstats, istats


def pack_markov_batch(
    z_t: jax.Array,  # (T·d, n) transposed latent batch
    x_t: jax.Array,  # (T·l, n) transposed observations
    *,
    T: int,
    d: int,
    l: int,
) -> jax.Array:
    """Pack the transposed batch for the compact Φ build
    (``[z_t; x_t; 0-pad]`` per step, NaN→0).  Iteration-invariant:
    build once per fit and pass to :func:`pack_markov_features`."""
    from multimodal_trajectory_modeling_tpu.ops import markov_phi

    return markov_phi.pack_markov_u(z_t, x_t, T=T, d=d, l=l)


def pack_markov_features(
    u: jax.Array,  # (T·s, n) packed batch (pack_markov_batch)
    lens: jax.Array,  # (n,) int32
    *,
    T: int,
    d: int,
    l: int,
    dtype=None,
    store_dtype=None,
) -> jax.Array:
    """Materialize the per-instance EM feature matrix Φ (Fc_pad, n_pad)
    from the packed batch — one O(T) pass per fit; afterwards every EM
    iteration reads Φ (:func:`emstep_markov` with ``phi=``).  Φ's row
    count is T-independent, so iteration cost decouples from trajectory
    length."""
    from multimodal_trajectory_modeling_tpu.ops import markov_phi

    return markov_phi.markov_materialize_features(
        u, lens, T=T, d=d, l=l, dtype=dtype, store_dtype=store_dtype
    )


def markov_packed_ok(T: int, d: int, l: int) -> bool:
    """Whether Φ takes the compact layout (T·s ≤ 512 with s the 8-row
    step block of the packed batch).  Past it the shift-product build's
    (T·s, n) products outgrow the slice-pair builder and the canonical
    layout (:func:`..ops.markov_phi.markov_materialize_features_longT`)
    takes over."""
    return T * 8 * ((d + l + 7) // 8) <= 512


def _resolve_phi_store(dtype):
    """Resolve the Φ storage mode from ``MTM_MARKOV_PHI`` for a batch of
    compute ``dtype`` — HOST-level only (reads the environment).

    Modes: ``i16`` (default for f32 compute) stores Φ int16-quantized
    with per-feature scales (:class:`..ops.markov_phi.PhiQuant` —
    half the per-iteration read of Φ, quantization folded exactly into
    the GEMM weights); ``bf16`` the narrow opt-in
    (``MTM_MARKOV_PHI_BF16=1`` still honored); ``wide`` (always the
    default off f32 — f64 parity trajectories stay bit-exact) stores the
    compute dtype.  Returns the ``phi_store`` value the feature routers
    accept: ``"i16"``, a dtype, or None."""
    import os as _os

    mode = _os.environ.get("MTM_MARKOV_PHI", "").lower()
    if not mode:
        mode = (
            "bf16"
            if _os.environ.get("MTM_MARKOV_PHI_BF16", "0") == "1"
            else "auto"
        )
    if mode == "auto":
        mode = "i16" if jnp.dtype(dtype) == jnp.float32 else "wide"
    if mode in ("wide", "f32", "f64", "off", "0"):
        return None
    if mode == "bf16":
        return jnp.bfloat16
    if mode == "i16":
        return "i16"
    raise ValueError(
        f"MTM_MARKOV_PHI={mode!r}: expected auto, i16, bf16 or wide"
    )


def _markov_features(
    z: jax.Array,  # (T, n, d) NaN-suffix-padded
    x: jax.Array,  # (T, n, l)
    lens: jax.Array,  # (n,) int32
    *,
    T: int,
    d: int,
    l: int,
    u: jax.Array = None,  # reuse a pre-packed batch if the caller has one
    phi_store="env",  # "env" → MTM_MARKOV_PHI; "i16"/dtype/None explicit
) -> tuple[jax.Array, jax.Array, str]:
    """The one Φ-building decision shared by every Markov EM trainer:
    returns ``(u, phi, phi_layout)`` for :func:`emstep_markov` /
    :func:`emstep_markov_multi`.

    - compact shapes (:func:`markov_packed_ok`): pack the batch (unless
      given) and materialize the compact-layout Φ;
    - long T: materialize the canonical-layout Φ; ``u`` is None.

    ``phi_store="env"`` resolves ``MTM_MARKOV_PHI`` HERE, at host level
    — callers that jit must resolve first and pass an explicit value (a
    jitted body would freeze the env into the trace).
    ``phi_store="i16"`` materializes wide then quantizes to
    :class:`..ops.markov_phi.PhiQuant` (the f32 default —
    :func:`_resolve_phi_store`)."""
    from multimodal_trajectory_modeling_tpu.ops import markov_phi

    if isinstance(phi_store, str) and phi_store == "env":
        phi_store = _resolve_phi_store(z.dtype)
    quantize = isinstance(phi_store, str) and phi_store == "i16"
    store = None if quantize else phi_store
    n = z.shape[1]
    if markov_packed_ok(T, d, l):
        if u is None:
            z_tp = jnp.transpose(z, (0, 2, 1)).reshape(T * d, n)
            x_tp = jnp.transpose(x, (0, 2, 1)).reshape(T * l, n)
            u = pack_markov_batch(z_tp, x_tp, T=T, d=d, l=l)
        phi = pack_markov_features(
            u, lens, T=T, d=d, l=l, dtype=z.dtype, store_dtype=store
        )
        layout = "compact"
    else:
        u = None
        z_tp = jnp.transpose(z, (0, 2, 1)).reshape(T * d, n)
        x_tp = jnp.transpose(x, (0, 2, 1)).reshape(T * l, n)
        phi = markov_phi.markov_materialize_features_longT(
            z_tp, x_tp, lens, T=T, d=d, l=l, store_dtype=store
        )
        layout = "canonical"
    if quantize:
        phi = markov_phi.quantize_phi(phi)
    return u, phi, layout


def _msolve_markov(g, counts, n, d, l, reg_mode, alpha):
    """Closed-form M step from the Φ pass's statistics ``g (F, C)``."""
    tstats, mstats, istats = _unpack_markov_em_stats(g, d, l)
    pi = counts.astype(g.dtype) / n
    m0, S0 = rops.mean_cov_from_stats(istats)
    A, G = rops.solve_regression(tstats, mode=reg_mode, alpha=alpha)
    H, L = rops.solve_regression(mstats, mode=reg_mode, alpha=alpha)
    return MixtureParams(pi, m0, S0, A, G, H, L)


def _em_weights(params: MixtureParams) -> jax.Array:
    """(C, F) E-score weights over the canonical features, log π folded
    into the constant column."""
    from multimodal_trajectory_modeling_tpu.ops import markov as mkops

    Wg = mkops.markov_em_weights(
        params.m, params.S, params.A, params.G, params.H, params.L
    )
    return Wg.at[:, -1].add(jnp.log(params.pi))


def emstep_markov(
    params: MixtureParams,
    z_t: jax.Array,  # (T·d, n) transposed latent batch
    x_t: jax.Array,  # (T·l, n) transposed observations
    lens: jax.Array,  # (n,) int32
    prev_assign: jax.Array,  # (n,) int32
    *,
    T: int,
    assign_mode: str = "argmax",
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    u: jax.Array = None,  # (T·s, n) packed batch (pack_markov_batch)
    phi: jax.Array = None,  # (Fc_pad, n_pad) features (pack_markov_features)
    phi_layout: str = "compact",
) -> tuple[MixtureParams, jax.Array, jax.Array, jax.Array]:
    """ONE EM iteration for suffix missingness: returns ``(new_params,
    assign, counts, switches)`` from one Φ pass
    (:func:`..ops.markov_phi.markov_em_from_features`) — the
    per-row Markov features feed both the E-score GEMM and the
    per-cluster M sufficient statistics.  ``assign_mode="prev"``
    performs the initial M step (statistics under ``prev_assign``, no
    E).  Equal to estep+mstep of the dense path in f64; f32 at
    reassociation noise.

    Pass ``phi`` (from :func:`pack_markov_features`, hoisted out of the
    EM loop) — without it the call materializes Φ itself (from ``u`` if
    given, else from ``z_t``/``x_t``), which costs about one extra
    iteration."""
    from multimodal_trajectory_modeling_tpu.ops import markov_phi

    d = params.m.shape[1]
    l = params.H.shape[2]
    n = lens.shape[0]
    if phi is None:
        if u is None and markov_packed_ok(T, d, l):
            u = pack_markov_batch(z_t, x_t, T=T, d=d, l=l)
        if u is not None:
            phi = pack_markov_features(u, lens, T=T, d=d, l=l, dtype=z_t.dtype)
            phi_layout = "compact"
        else:
            phi = markov_phi.markov_materialize_features_longT(
                z_t, x_t, lens, T=T, d=d, l=l
            )
            phi_layout = "canonical"
    Wg = _em_weights(params)
    assign, counts, switches, g, _obj = markov_phi.markov_em_from_features(
        phi,
        lens,
        prev_assign,
        Wg,
        T=T,
        d=d,
        l=l,
        assign_mode=assign_mode,
        layout=phi_layout,
    )
    new_params = _msolve_markov(g, counts, n, d, l, reg_mode, alpha)
    return new_params, assign, counts, switches

@functools.partial(jax.jit, static_argnames=("reg_mode", "alpha"))
def emstep_markov_xla(
    params: MixtureParams,
    z: jax.Array,  # (T, n, d) NaN-suffix-padded
    x: jax.Array,  # (T, n, l)
    lens: jax.Array,  # (n,) int32
    prev_assign: jax.Array,  # (n,) int32
    *,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
) -> tuple[MixtureParams, jax.Array, jax.Array, jax.Array]:
    """Plain reference EM iteration over the row-major canonical features
    (ops/markov.py:markov_em_features) — independent of the Φ layouts
    and the Φ pass of :func:`emstep_markov`, which tests and the chip
    smoke compare against it.  Identical math: E scores and per-cluster
    M statistics are both linear maps of the same (n, F) feature
    matrix."""
    from multimodal_trajectory_modeling_tpu.ops import markov as mops

    C = params.pi.shape[0]
    d = params.m.shape[1]
    l = params.H.shape[2]
    n = z.shape[1]
    feats = mops.markov_em_features(z, x, lens)  # (n, F)
    Wg = mops.markov_em_weights(
        params.m, params.S, params.A, params.G, params.H, params.L
    )
    Wg = Wg.at[:, -1].add(jnp.log(params.pi))
    with jax.default_matmul_precision("highest"):  # see ops.regression._HI
        scores = feats @ Wg.T  # (n, C)
    assign = jnp.argmax(scores, axis=1).astype(jnp.int32)
    switches = jnp.sum(assign != prev_assign.astype(jnp.int32))
    onehot = (
        assign[:, None] == jnp.arange(C, dtype=jnp.int32)[None, :]
    ).astype(z.dtype)
    counts = jnp.sum(onehot, axis=0).astype(jnp.int32)
    with jax.default_matmul_precision("highest"):
        g = feats.T @ onehot  # (F, C)
    new_params = _msolve_markov(g, counts, n, d, l, reg_mode, alpha)
    return new_params, assign, counts, switches


@functools.partial(
    jax.jit, static_argnames=("n_clusters", "reg_mode", "alpha", "impl")
)
def mstep(
    z: jax.Array,
    x: jax.Array,
    assign: jax.Array,
    *,
    n_clusters: int,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    impl: str = "xla",
) -> MixtureParams:
    """Closed-form M step for all clusters at once.

    Reference: ``M_step`` (marginalizable_mixture_model.py:1254-1308) —
    ``reg_mode="lstsq"`` replicates the bare SVD lstsq path,
    ``reg_mode="ridge"`` the sklearn-Ridge path used when ``alpha > 2·eps``.

    ``impl="xla"`` uses time-batched einsums; ``impl="gram"`` fuses each
    stat group into a single Gram-matrix einsum
    (ops/regression.py:weighted_regression_stats_gram; equal to "xla" up
    to f32 reassociation).  Identical results in f64.
    """
    dtype = z.dtype
    W = jax.nn.one_hot(assign, n_clusters, dtype=dtype)  # (n, C)
    stats_fn = (
        rops.weighted_regression_stats_gram
        if impl == "gram"
        else rops.weighted_regression_stats_timebatched
    )

    pi = jnp.mean(W, axis=0)
    m0, S0 = rops.masked_mean_and_cov(z[0], W)

    # transitions: all (z_t, z_{t+1}) pairs, any-NaN rows dropped per pair;
    # time axis contracted inside the einsums (no (T·n, C) weight tile)
    tstats = stats_fn(z[:-1], z[1:], W)
    A, G = rops.solve_regression(tstats, mode=reg_mode, alpha=alpha)

    # measurements: all (z_t, x_t) pairs over every time step
    mstats = stats_fn(z, x, W)
    H, L = rops.solve_regression(mstats, mode=reg_mode, alpha=alpha)

    return MixtureParams(pi, m0, S0, A, G, H, L)


def mstep_multi(
    z: jax.Array,
    x: jax.Array,
    assign: jax.Array,  # (R, n) int — one hard assignment per restart
    *,
    n_clusters: int,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
) -> MixtureParams:
    """Multi-restart :func:`mstep`: R independent hard assignments share
    ONE read of the batch — the per-restart one-hot memberships
    concatenate on the cluster axis ``(n, R·C)``, every masked
    sufficient-statistic einsum contracts them together, and the tiny
    solves run batched on the (R·C)-leading statistics.  Each restart's
    parameters equal a separate :func:`mstep` call (f64; f32 up to
    reassociation).  Rows assigned ``-1`` (idle pool lanes) contribute
    to no cluster."""
    R, n = assign.shape
    C = n_clusters
    dtype = z.dtype
    W = jax.nn.one_hot(assign, C, dtype=dtype)  # (R, n, C); -1 → zeros
    W = jnp.transpose(W, (1, 0, 2)).reshape(n, R * C)
    pi = jnp.mean(W, axis=0).reshape(R, C)
    m0, S0 = rops.masked_mean_and_cov(z[0], W)
    tstats = rops.weighted_regression_stats_timebatched(z[:-1], z[1:], W)
    A, G = rops.solve_regression(tstats, mode=reg_mode, alpha=alpha)
    mstats = rops.weighted_regression_stats_timebatched(z, x, W)
    H, L = rops.solve_regression(mstats, mode=reg_mode, alpha=alpha)

    def rsh(a):
        return a.reshape((R, C) + a.shape[1:])

    return MixtureParams(
        pi, rsh(m0), rsh(S0), rsh(A), rsh(G), rsh(H), rsh(L)
    )


@functools.partial(jax.jit, static_argnames=("T", "method"))
def complete_data_loglik(
    params: MixtureParams,
    v: jax.Array,
    patterns: jax.Array,
    pattern_id: jax.Array,
    *,
    T: int,
    method: str = "auto",
) -> jax.Array:
    """Hard-assignment expected complete-data log-likelihood Q with a fresh
    E assignment (reference ``e_complete_data_log_lik``, mixture:579-624)."""
    ll = estep_logliks(params, v, patterns, pattern_id, T=T, method=method)
    a = assignments_from_logliks(params.pi, ll)
    n = v.shape[0]
    picked = jnp.take_along_axis(ll, a[None, :], axis=0)[0]
    return jnp.sum(jnp.log(params.pi)[a]) + jnp.sum(picked)


@functools.partial(jax.jit, static_argnames=("T", "method"))
def model_loglik(
    params: MixtureParams,
    v: jax.Array,
    patterns: jax.Array,
    pattern_id: jax.Array,
    *,
    T: int,
    method: str = "auto",
) -> jax.Array:
    """Mixture marginal log-likelihood ``Σ_i log Σ_c π_c L_ci`` via logsumexp
    (reference ``model_log_likelihood``, mixture:626-666, which exponentiates
    directly; logsumexp is the numerically-stabilized equivalent)."""
    ll = estep_logliks(params, v, patterns, pattern_id, T=T, method=method)
    return jnp.sum(
        jax.scipy.special.logsumexp(jnp.log(params.pi)[:, None] + ll, axis=0)
    )


@functools.partial(jax.jit, static_argnames=("T",))
def complete_data_loglik_markov(
    params: MixtureParams,
    z_t: jax.Array,  # (T·d, n) transposed latent batch
    x_t: jax.Array,  # (T·l, n) transposed observations
    lens: jax.Array,  # (n,) int32
    *,
    T: int,
) -> jax.Array:
    """:func:`complete_data_loglik` through the Φ pass — its ``Σ_i
    max_c scores`` output IS the hard-assignment complete-data objective
    under a fresh E (reference ``e_complete_data_log_lik``,
    mixture:579-624).  Builds Φ with the same routing as the trainers,
    so sequential and pooled multistart sweeps rank candidates
    identically (wide storage: the objective is the selection key)."""
    d = params.m.shape[1]
    l = params.H.shape[2]
    n = z_t.shape[1]
    z = jnp.transpose(z_t.reshape(T, d, n), (0, 2, 1))
    x = jnp.transpose(x_t.reshape(T, l, n), (0, 2, 1))
    _u, phi, layout = _markov_features(
        z, x, lens, T=T, d=d, l=l, phi_store=None
    )
    from multimodal_trajectory_modeling_tpu.ops import markov_phi

    _a, _c, _w, _g, obj = markov_phi.markov_em_from_features(
        phi,
        lens,
        jnp.zeros((n,), jnp.int32),
        _em_weights(params),
        T=T,
        d=d,
        l=l,
        layout=layout,
    )
    return obj


@jax.jit
def _suffix_logliks_markov_xla(
    params: MixtureParams, z, x, lens
) -> jax.Array:
    from multimodal_trajectory_modeling_tpu.ops import markov as mops

    W = mops.markov_cluster_weights(
        params.m, params.S, params.A, params.G, params.H, params.L
    )
    return mops.markov_suffix_logliks(z, x, lens, W)


def suffix_logliks_markov(
    params: MixtureParams,
    z: jax.Array,  # (T, n, d) NaN-suffix-padded
    x: jax.Array,  # (T, n, l)
    lens: jax.Array,  # (n,) int32 observed prefix lengths (1..T)
) -> jax.Array:
    """``(C, n)`` joint log-likelihoods under PURE-SUFFIX missingness in
    O(T) via the Markov factorization — the long-T inference route when
    the per-row patterns are variable lengths (reference inference
    methods take the dense joint; its (T(d+l))² covariance is infeasible
    past T(d+l) ≈ 512).  Equals the dense masked marginal exactly
    (ops/markov.py contract, f64-tested); the factorized densities are
    GEMM-shaped instead of a sequential per-step recursion."""
    return _suffix_logliks_markov_xla(params, z, x, lens)


@jax.jit
def model_loglik_markov(
    params: MixtureParams,
    z: jax.Array,  # (T, n, d) NaN-suffix-padded
    x: jax.Array,  # (T, n, l)
    lens: jax.Array,  # (n,) int32
) -> jax.Array:
    """:func:`model_loglik` in O(T) via the Markov factorization — the
    scalable route for model selection (AIC/BIC sweeps over n_clusters)
    on long or large batches with suffix missingness; f64-identical to
    the dense path (ops/markov.py, tested)."""
    from multimodal_trajectory_modeling_tpu.ops import markov as mops

    W = mops.markov_cluster_weights(
        params.m, params.S, params.A, params.G, params.H, params.L
    )
    ll = mops.markov_suffix_logliks(z, x, lens, W)
    return jnp.sum(
        jax.scipy.special.logsumexp(jnp.log(params.pi)[:, None] + ll, axis=0)
    )


def _tree_select(pred, on_true, on_false):
    return jax.tree.map(
        lambda a, b: jnp.where(pred, a, b), on_true, on_false
    )


def _em_termination(switches, counts, status_else, *, min_members):
    """Per-step termination classification shared by EVERY trainer
    (scalar or per-restart (R,)-row operands alike): ``converged`` =
    zero assignment switches, ``empty`` = some cluster at/below the
    member floor (convergence wins the tie — the reference checks
    switches first, mixture:1341-1356), ``advance`` = take the new M
    params and keep running.  ``status`` nests CONVERGED over
    EMPTY_CLUSTER over ``status_else`` (the caller's keep-running
    value).  One definition keeps the trainer loops — dense, masked
    filter, Markov, multi-restart, pool window — in exact agreement."""
    converged = switches == 0
    empty = (~converged) & (jnp.min(counts, axis=-1) <= min_members)
    advance = (~converged) & (~empty)
    status = jnp.where(
        converged,
        STATUS_CONVERGED,
        jnp.where(empty, STATUS_EMPTY_CLUSTER, status_else),
    )
    return converged, empty, advance, status


@functools.partial(
    jax.jit,
    static_argnames=("n_steps", "reg_mode", "alpha", "method", "min_members"),
)
def train_em(
    params0: MixtureParams,
    assign0: jax.Array,
    z: jax.Array,
    x: jax.Array,
    v: jax.Array,
    patterns: jax.Array,
    pattern_id: jax.Array,
    *,
    n_steps: int = 1000,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    method: str = "auto",
    min_members: int = 3,
) -> tuple[MixtureParams, jax.Array, jax.Array, jax.Array]:
    """One full EM run; replicates ``train``
    (marginalizable_mixture_model.py:1310-1366) exactly:

    1. if ``min bincount(assign0) <= min_members`` → return untouched
       (status INIT_ABORT);
    2. M step from the initial assignment;
    3. loop ≤ n_steps: E; 0 switches → CONVERGED; near-empty → EMPTY
       (assignment updated, parameters stale — as in the reference break);
       else M.

    Returns ``(params, assign, n_iterations, status)``.  Pure and functional:
    vmap over a leading restart axis, shard the instance axis over a mesh.
    """
    T = z.shape[0]
    C = params0.pi.shape[0]
    assign0 = assign0.astype(jnp.int32)

    counts0 = counts_from_assign(assign0, C)
    init_abort = jnp.min(counts0) <= min_members

    params_m = mstep(
        z, x, assign0, n_clusters=C, reg_mode=reg_mode, alpha=alpha
    )
    params_start = _tree_select(init_abort, params0, params_m)
    status0 = jnp.where(init_abort, STATUS_INIT_ABORT, STATUS_RUNNING)

    def cond(state):
        _, _, i, status = state
        return (status == STATUS_RUNNING) & (i < n_steps)

    def body(state):
        params, assign, i, status = state
        ll = estep_logliks(
            params, v, patterns, pattern_id, T=T, method=method
        )
        new_assign = assignments_from_logliks(params.pi, ll)
        switches = jnp.sum(new_assign != assign)
        counts = counts_from_assign(new_assign, C)
        _conv, _empty, run_m, status_out = _em_termination(
            switches, counts, STATUS_RUNNING, min_members=min_members
        )
        new_params = mstep(
            z, x, new_assign, n_clusters=C, reg_mode=reg_mode, alpha=alpha
        )
        params_out = _tree_select(run_m, new_params, params)
        return (params_out, new_assign, i + 1, status_out)

    params_f, assign_f, iters, status = jax.lax.while_loop(
        cond, body, (params_start, assign0, jnp.int32(0), status0)
    )
    return params_f, assign_f, iters, status


@functools.partial(
    jax.jit,
    static_argnames=("n_steps", "reg_mode", "alpha", "min_members"),
)
def train_em_masked_kalman(
    params0: MixtureParams,
    assign0: jax.Array,
    z: jax.Array,  # (T, n, d) ARBITRARY per-coordinate NaNs
    x: jax.Array,  # (T, n, l)
    *,
    n_steps: int = 1000,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
) -> tuple[MixtureParams, jax.Array, jax.Array, jax.Array]:
    """One full EM run under ARBITRARY per-coordinate missingness with an
    O(T) E step — the long-T trainer for interior missingness, where the
    dense path's (T(d+ℓ))² joint covariance (reference
    marginalizable_state_space_model.py:741-773 semantics) is infeasible
    and the suffix-Markov factorization does not apply.

    E step: exact partial-observation Kalman densities
    (:func:`ops.kalman.kalman_masked_logliks` — equal to the dense
    drop-rows/cols marginal to ~1e-12 in f64).  M step: the same masked
    sufficient-statistics path every other trainer uses (:func:`mstep` —
    any-NaN row pairs dropped per factor, reference regress semantics).
    Status protocol, init-abort guard and stop conditions are identical
    to :func:`train_em` (reference mixture:1310-1366); on suffix-only
    missingness it reproduces ``train_em``'s trajectory exactly (the
    filter marginal equals the joint marginal).

    Returns ``(params, assign, n_iterations, status)``.
    """
    from multimodal_trajectory_modeling_tpu.ops import kalman

    C = params0.pi.shape[0]
    assign0 = assign0.astype(jnp.int32)

    counts0 = counts_from_assign(assign0, C)
    init_abort = jnp.min(counts0) <= min_members

    params_m = mstep(
        z, x, assign0, n_clusters=C, reg_mode=reg_mode, alpha=alpha
    )
    params_start = _tree_select(init_abort, params0, params_m)
    status0 = jnp.where(init_abort, STATUS_INIT_ABORT, STATUS_RUNNING)

    def cond(state):
        _, _, i, status = state
        return (status == STATUS_RUNNING) & (i < n_steps)

    def body(state):
        params, assign, i, status = state
        ll = kalman.kalman_masked_logliks(
            z, x,
            params.m, params.S, params.A, params.G, params.H,
            params.L,
        )
        new_assign = assignments_from_logliks(params.pi, ll)
        switches = jnp.sum(new_assign != assign)
        counts = counts_from_assign(new_assign, C)
        _conv, _empty, run_m, status_out = _em_termination(
            switches, counts, STATUS_RUNNING, min_members=min_members
        )
        new_params = mstep(
            z, x, new_assign, n_clusters=C, reg_mode=reg_mode, alpha=alpha
        )
        params_out = _tree_select(run_m, new_params, params)
        return (params_out, new_assign, i + 1, status_out)

    params_f, assign_f, iters, status = jax.lax.while_loop(
        cond, body, (params_start, assign0, jnp.int32(0), status0)
    )
    return params_f, assign_f, iters, status


def emstep_masked_kalman_multi(
    params: MixtureParams,  # leading R axis on every leaf
    z: jax.Array,  # (T, n, d) ARBITRARY per-coordinate NaNs — shared
    x: jax.Array,  # (T, n, l)
    prev: jax.Array,  # (R, n) int32
    *,
    force_prev: jax.Array = None,  # (R,) — per-slot prev mode
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
) -> tuple[MixtureParams, jax.Array, jax.Array, jax.Array]:
    """ONE masked-filter EM iteration for R independent restarts over
    the SAME batch: the R·C parameter rows run through the filter as one
    ``(R·C, n)`` density pass, and the M statistics for every restart
    contract in one read via :func:`mstep_multi`.  Each restart equals a
    separate :func:`train_em_masked_kalman` iteration (f64).
    ``force_prev`` rows take their initial M step (assignment kept at
    ``prev``)."""
    from multimodal_trajectory_modeling_tpu.ops import kalman

    R, C = params.pi.shape
    n = z.shape[1]

    def flat(a):
        return a.reshape((R * C,) + a.shape[2:])

    ll = kalman.kalman_masked_logliks(
        z,
        x,
        flat(params.m),
        flat(params.S),
        flat(params.A),
        flat(params.G),
        flat(params.H),
        flat(params.L),
    )
    ll = ll.reshape(R, C, n)
    e_assign = jax.vmap(assignments_from_logliks)(params.pi, ll)
    if force_prev is not None:
        new_assign = jnp.where((force_prev > 0)[:, None], prev, e_assign)
    else:
        new_assign = e_assign
    switches = jnp.sum(new_assign != prev, axis=1)
    counts = jax.vmap(counts_from_assign, in_axes=(0, None))(
        new_assign, C
    )
    new_params = mstep_multi(
        z, x, new_assign, n_clusters=C, reg_mode=reg_mode, alpha=alpha
    )
    return new_params, new_assign, counts, switches


@functools.partial(
    jax.jit,
    static_argnames=("K", "n_steps", "reg_mode", "alpha", "min_members"),
)
def _pool_window_masked_kalman(
    params,  # stacked (R-leading) MixtureParams
    assigns,  # (R, n) int32
    status,  # (R,) int32
    iters,  # (R,) int32
    force,  # (R,) int32 — 1 ⇒ slot's next pass is its initial M step
    z,  # (T, n, d)
    x,  # (T, n, l)
    *,
    K: int,
    n_steps: int,
    reg_mode: str,
    alpha: float,
    min_members: int,
):
    """K fused multi-restart masked-filter EM iterations in ONE
    dispatch — the :func:`_pool_window` protocol (per-slot freezing,
    force_prev insertion, capped counts) on the arbitrary-missingness
    trainer."""

    def emstep_fn(params, assigns, force):
        return emstep_masked_kalman_multi(
            params,
            z,
            x,
            assigns,
            force_prev=force,
            reg_mode=reg_mode,
            alpha=alpha,
        )

    return _pool_window_protocol(
        emstep_fn,
        K,
        (params, assigns, status, iters, force),
        n_steps=n_steps,
        min_members=min_members,
    )


def train_em_masked_kalman_pool(
    params_list,  # sequence of per-candidate MixtureParams
    assign_list,  # sequence of per-candidate (n,) int assignments
    z: jax.Array,  # (T, n, d) ARBITRARY per-coordinate NaNs — shared
    x: jax.Array,  # (T, n, l)
    *,
    R: int = 8,
    n_steps: int = 1000,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
    sync_every: int = 8,
) -> list:
    """Slot-pool multistart for ARBITRARY per-coordinate missingness —
    :func:`train_em_markov_pool`'s scheduler driving the masked-filter
    trainer: R slots share one filter density pass (R·C parameter rows)
    and one statistics read per iteration, with slots refilled the
    moment an occupant terminates.  Per-candidate results equal
    standalone :func:`train_em_masked_kalman` runs (f64), in candidate
    order.  Returns ``[(params, assign (n,), iters, status), ...]``."""
    n = z.shape[1]
    C = params_list[0].pi.shape[0]
    R = max(1, min(R, len(params_list)))
    K = max(1, int(sync_every))

    def window(stack, assigns, status, iters, force):
        return _pool_window_masked_kalman(
            stack,
            assigns,
            status,
            iters,
            force,
            z,
            x,
            K=K,
            n_steps=n_steps,
            reg_mode=reg_mode,
            alpha=float(alpha),
            min_members=min_members,
        )

    return _run_slot_pool(
        window,
        params_list,
        assign_list,
        R=R,
        C=C,
        n=n,
        n_state=n,
        n_steps=n_steps,
        min_members=min_members,
    )


def train_em_markov(
    params0: MixtureParams,
    assign0: jax.Array,
    z: jax.Array,  # (T, n, d) NaN-suffix-padded
    x: jax.Array,  # (T, n, l)
    lens: jax.Array,  # (n,) int32 observed prefix lengths
    *,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
) -> tuple[MixtureParams, jax.Array, jax.Array, jax.Array]:
    """:func:`train_em` for SUFFIX missingness via the Markov
    factorization: the per-instance feature matrix Φ is materialized once
    before the loop (:func:`_markov_features`), and each iteration is ONE
    Φ pass that computes the E assignment and the per-cluster M
    sufficient statistics (ops/markov_phi.py).  Per-row lengths carry
    the validity; O(T) in time like the whole :mod:`..ops.markov`
    family.  Same training trajectory and status semantics as
    :func:`train_em` (f64-identical; f32 up to reassociation).

    Φ storage (``MTM_MARKOV_PHI`` — :func:`_resolve_phi_store`) defaults
    to int16-quantized for f32 batches (half the per-iteration read of
    Φ; per-feature scales folded exactly into the GEMM weights, so the
    only approximation is the one storage rounding ≈ 1.5e-5 of each
    feature row's max) and to exact wide storage for f64 (parity
    trajectories stay bit-identical).  The env is resolved here at call
    time and enters the jitted impl as a static argument — never read
    inside a trace, so flipping it between calls takes effect (at the
    cost of one retrace)."""
    store = _resolve_phi_store(z.dtype)
    phi_mode = (
        "i16"
        if isinstance(store, str)
        else ("bf16" if store == jnp.bfloat16 else "wide")
    )
    return _train_em_markov_impl(
        params0,
        assign0,
        z,
        x,
        lens,
        n_steps=n_steps,
        reg_mode=reg_mode,
        alpha=alpha,
        min_members=min_members,
        phi_mode=phi_mode,
    )


_PHI_STORE = {"i16": "i16", "bf16": jnp.bfloat16, "wide": None}


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_steps",
        "reg_mode",
        "alpha",
        "min_members",
        "phi_mode",
    ),
)
def _train_em_markov_impl(
    params0: MixtureParams,
    assign0: jax.Array,
    z: jax.Array,
    x: jax.Array,
    lens: jax.Array,
    *,
    n_steps: int,
    reg_mode: str,
    alpha: float,
    min_members: int,
    phi_mode: str,
) -> tuple[MixtureParams, jax.Array, jax.Array, jax.Array]:
    """One XLA program for the whole fit: transposes, packing, Φ
    materialization and the EM while_loop trace together, so XLA
    liveness frees the packed batch once Φ exists."""
    T, n, d = z.shape
    l = x.shape[-1]
    C = params0.pi.shape[0]
    assign0 = assign0.astype(jnp.int32)

    _u, phi, phi_layout = _markov_features(
        z, x, lens, T=T, d=d, l=l, phi_store=_PHI_STORE[phi_mode]
    )

    counts0 = counts_from_assign(assign0, C)
    init_abort = jnp.min(counts0) <= min_members

    def _emstep(params, prev, mode):
        return emstep_markov(
            params,
            None,
            None,
            lens,
            prev,
            T=T,
            assign_mode=mode,
            reg_mode=reg_mode,
            alpha=alpha,
            phi=phi,
            phi_layout=phi_layout,
        )

    params_m, _, _, _ = _emstep(params0, assign0, "prev")
    params_start = _tree_select(init_abort, params0, params_m)
    status0 = jnp.where(init_abort, STATUS_INIT_ABORT, STATUS_RUNNING)

    def cond(state):
        _, _, i, status = state
        return (status == STATUS_RUNNING) & (i < n_steps)

    def body(state):
        params, assign, i, status = state
        new_params, new_assign, counts, switches = _emstep(
            params, assign, "argmax"
        )
        _conv, _empty, run_m, status_out = _em_termination(
            switches, counts, STATUS_RUNNING, min_members=min_members
        )
        params_out = _tree_select(run_m, new_params, params)
        return (params_out, new_assign, i + 1, status_out)

    params_f, assign_f, iters, status = jax.lax.while_loop(
        cond, body, (params_start, assign0, jnp.int32(0), status0)
    )
    return params_f, assign_f, iters, status


@functools.partial(jax.jit, static_argnames=("T", "d", "l", "store"))
def _ooc_featurize(z_c, x_c, lens_c, *, T, d, l, store):
    """Φ for ONE instance chunk — the packed batch and transposed
    intermediates are freed by XLA liveness inside this single program,
    so device residency peaks at the chunk's Φ plus its raw batch."""
    _, phi, _ = _markov_features(
        z_c, x_c, lens_c, T=T, d=d, l=l, phi_store=store
    )
    return phi


_ooc_weights = jax.jit(_em_weights)


@functools.partial(
    jax.jit,
    static_argnames=("T", "d", "l", "assign_mode", "layout"),
)
def _ooc_chunk_step(phi, lens_c, prev_c, Wg, *, T, d, l, assign_mode, layout):
    from multimodal_trajectory_modeling_tpu.ops import markov_phi

    return markov_phi.markov_em_from_features(
        phi,
        lens_c,
        prev_c,
        Wg,
        T=T,
        d=d,
        l=l,
        assign_mode=assign_mode,
        layout=layout,
    )


@functools.partial(
    jax.jit, static_argnames=("d", "l", "reg_mode", "alpha")
)
def _ooc_msolve(g, counts, n_total, *, d, l, reg_mode, alpha):
    return _msolve_markov(
        g, counts, n_total.astype(g.dtype), d, l, reg_mode, alpha
    )


def train_em_markov_outofcore(
    params0: MixtureParams,
    assign0,
    z,  # (T, n, d) HOST array, NaN-suffix-padded (numpy stays on host)
    x,  # (T, n, l) HOST array
    lens,  # (n,) int observed prefix lengths
    *,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
    chunk_cols: int = 1 << 20,
    phi_store="env",  # "env" → MTM_MARKOV_PHI (i16 default for f32)
):
    """:func:`train_em_markov` for batches whose feature matrix exceeds
    device HBM: Φ lives in HOST memory as per-chunk blocks and every EM
    iteration streams the chunks through the from-features kernel,
    accumulating the per-cluster sufficient statistics, membership
    counts, and switch totals across chunks before one M solve.

    Capacity model: device residency is ONE chunk's Φ (plus its raw
    batch during the one-time featurization), so n is bounded by host
    RAM, not HBM — the single-chip complement to the multi-device
    :func:`..parallel.sharded_em.train_em_markov_shardmap` (which
    shards the in-HBM batch over a mesh).  Throughput is bound by the
    host↔device link (each iteration re-ships every Φ chunk), not by
    HBM bandwidth — this path trades speed for capacity and the
    in-core trainer should be preferred whenever Φ fits.

    The statistics contract is identical to the in-core trainer (same
    kernels, same :func:`_em_termination` semantics; reference protocol
    marginalizable_mixture_model.py:1310-1366); only the cross-chunk
    summation ORDER differs, so trained parameters match in-core
    training to reassociation noise (f64 ≈ 1e-12 — tested) while
    assignments, iteration counts and status codes match exactly.

    Returns ``(params, assign (np.int32 (n,)), iters, status)``.
    """
    import numpy as np

    z = np.asarray(z)
    x = np.asarray(x)
    T, n, d = z.shape
    l = x.shape[-1]
    C = int(np.asarray(params0.pi).shape[0])
    dtype = jnp.asarray(z[:1, :1]).dtype
    if isinstance(phi_store, str) and phi_store == "env":
        phi_store = _resolve_phi_store(dtype)
    layout = "compact" if markov_packed_ok(T, d, l) else "canonical"
    lens_np = np.asarray(lens, np.int32)
    assign0_np = np.asarray(assign0, np.int32)
    bounds = [
        (s, min(s + int(chunk_cols), n))
        for s in range(0, n, int(chunk_cols))
    ]

    # one-time featurization pass: Φ chunks pulled to host, device
    # buffers dropped as soon as each chunk lands
    phi_chunks = []
    for s, e in bounds:
        phi_dev = _ooc_featurize(
            jnp.asarray(z[:, s:e], dtype),
            jnp.asarray(x[:, s:e], dtype),
            jnp.asarray(lens_np[s:e]),
            T=T,
            d=d,
            l=l,
            store=phi_store,
        )
        # device_get maps over pytrees — PhiQuant chunks (int16 payload
        # + scales) land on host exactly like plain Φ arrays do
        phi_chunks.append(jax.device_get(phi_dev))
        del phi_dev

    n_total = jnp.asarray(n, dtype)
    n_chunks = len(bounds)

    def _ship(i, prev_chunks):
        """Issue chunk i's host→device transfers (async — device_put
        returns immediately; the copies ride the DMA engine while the
        previous chunk's kernel computes)."""
        s, e = bounds[i]
        return (
            jax.device_put(phi_chunks[i]),
            jax.device_put(lens_np[s:e]),
            jax.device_put(np.asarray(prev_chunks[i], np.int32)),
        )

    def _pass(params, prev_chunks, mode):
        """One full EM pass over the chunks, software-pipelined: chunk
        i+1's H2D transfer is issued before chunk i's outputs are
        awaited, so per iteration the wall cost tends to
        max(transfer, compute) instead of their sum.  Device residency
        stays bounded at the DOUBLE buffer (two Φ chunks): the blocking
        assignment pull of chunk i−1 is the flow control.  Statistics
        accumulate on device in chunk order — the same summation order
        as the sequential form, so results are bit-identical."""
        Wg = _ooc_weights(params)
        g_tot = None
        counts_tot = None
        sw_tot = None
        assign_pending = [None] * n_chunks
        new_chunks = [None] * n_chunks
        shipped = _ship(0, prev_chunks)
        for i in range(n_chunks):
            phi_c, lens_c, prev_c = shipped
            if i + 1 < n_chunks:
                shipped = _ship(i + 1, prev_chunks)
            a, c, sw, g, _obj = _ooc_chunk_step(
                phi_c,
                lens_c,
                prev_c,
                Wg,
                T=T,
                d=d,
                l=l,
                assign_mode=mode,
                layout=layout,
            )
            del phi_c, lens_c, prev_c  # freed once the kernel consumes them
            assign_pending[i] = a
            g_tot = g if g_tot is None else g_tot + g
            counts_tot = c if counts_tot is None else counts_tot + c
            sw_tot = sw if sw_tot is None else sw_tot + sw
            if i >= 1:
                new_chunks[i - 1] = np.asarray(
                    assign_pending[i - 1], np.int32
                )
                assign_pending[i - 1] = None
        new_chunks[n_chunks - 1] = np.asarray(assign_pending[-1], np.int32)
        return new_chunks, counts_tot, int(np.asarray(sw_tot)), g_tot

    counts0 = np.bincount(assign0_np, minlength=C)
    if counts0.min() <= min_members:
        return params0, assign0_np, 0, STATUS_INIT_ABORT

    # initial M step under the provided assignment (reference :1319-1326)
    prev_chunks = [assign0_np[s:e] for s, e in bounds]
    _, counts_m, _, g_m = _pass(params0, prev_chunks, "prev")
    params = _ooc_msolve(
        g_m, counts_m, n_total, d=d, l=l, reg_mode=reg_mode, alpha=alpha
    )

    status = STATUS_RUNNING
    iters = 0
    for _ in range(n_steps):
        new_chunks, counts, switches, g = _pass(
            params, prev_chunks, "argmax"
        )
        iters += 1
        prev_chunks = new_chunks
        # host mirror of _em_termination (convergence wins the tie)
        converged = switches == 0
        empty = (not converged) and (
            int(np.asarray(counts).min()) <= min_members
        )
        if converged:
            status = STATUS_CONVERGED
            break
        if empty:
            status = STATUS_EMPTY_CLUSTER
            break
        params = _ooc_msolve(
            g, counts, n_total, d=d, l=l, reg_mode=reg_mode, alpha=alpha
        )

    return params, np.concatenate(prev_chunks), iters, status


def _tree_select_rows(pred_r, on_true, on_false):
    """Per-restart :func:`_tree_select`: ``pred_r`` is (R,) boolean and
    every leaf carries a leading R axis."""

    def sel(a, b):
        p = pred_r.reshape((-1,) + (1,) * (a.ndim - 1))
        return jnp.where(p, a, b)

    return jax.tree.map(sel, on_true, on_false)


def emstep_markov_multi(
    params: MixtureParams,  # leading R axis on every leaf
    lens: jax.Array,  # (n,) int32 — shared across restarts
    prev_assign: jax.Array,  # (R, n) int32
    u: jax.Array,  # (T·s, n) packed batch (pack_markov_batch) — or None
    *,
    T: int,
    assign_mode: str = "argmax",
    force_prev: jax.Array = None,  # (R,) — per-slot prev mode
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    phi: jax.Array = None,  # (Fc_pad, n_pad) features (pack_markov_features)
    phi_layout: str = "compact",
) -> tuple[MixtureParams, jax.Array, jax.Array, jax.Array, jax.Array]:
    """ONE EM iteration for R independent restarts over the SAME batch
    (:func:`..ops.markov_phi.markov_em_from_features_multi`): one read
    of Φ feeds R·C score rows and R·C statistics columns.  Returns
    ``(new_params, assign (R, n), counts (R, C), switches (R,),
    objectives (R,))``; each restart equals a separate
    :func:`emstep_markov` call up to reassociation of the GEMMs (exact
    in f64).  ``force_prev`` puts individual slots in prev mode for this
    pass (a pool-scheduler insertion's initial M step — see
    :func:`train_em_markov_pool`).  Pass the hoisted ``phi``
    (``phi_layout`` names its row order); without it Φ is materialized
    from the packed batch ``u`` on every call."""
    from multimodal_trajectory_modeling_tpu.ops import markov_phi

    d = params.m.shape[2]
    l = params.H.shape[3]
    n = lens.shape[0]
    if phi is None:
        phi = pack_markov_features(u, lens, T=T, d=d, l=l)
        phi_layout = "compact"
    Wg = jax.vmap(_em_weights)(params)  # (R, C, F)
    assign, counts, switches, g, obj = (
        markov_phi.markov_em_from_features_multi(
            phi,
            lens,
            prev_assign,
            Wg,
            T=T,
            d=d,
            l=l,
            assign_mode=assign_mode,
            force_prev=force_prev,
            layout=phi_layout,
        )
    )

    def solve_one(g_r, counts_r):
        return _msolve_markov(g_r, counts_r, n, d, l, reg_mode, alpha)

    new_params = jax.vmap(solve_one)(g, counts)
    return new_params, assign, counts, switches, obj


def train_em_markov_multi(
    params0: MixtureParams,  # leading R axis on every leaf
    assign0: jax.Array,  # (R, n) int32
    z: jax.Array,  # (T, n, d) NaN-suffix-padded — shared
    x: jax.Array,  # (T, n, l)
    lens: jax.Array,  # (n,) int32
    *,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
    u: jax.Array = None,  # (T·s, n) packed batch (pack_markov_batch)
) -> tuple[MixtureParams, jax.Array, jax.Array, jax.Array]:
    """:func:`train_em_markov` for R restarts at once — the multi-start
    production path.  Per-restart status/convergence semantics are
    identical to R separate runs (each restart's trajectory equals a
    standalone run up to GEMM reassociation, exactly in f64); the loop
    runs until EVERY restart is terminal (a converged restart's state is
    frozen while stragglers finish).  Returns ``(params, assign (R, n),
    iters (R,), status (R,))``.  Pass ``u`` to reuse one packed batch
    across chunked sweeps.

    Reference protocol: mixture:1368-1471 — training cost there is
    ``n_starts × train()``; here the batch stream and feature build
    amortize across simultaneous restarts."""
    T, n, d = z.shape
    l = x.shape[-1]
    R, C = params0.pi.shape
    assign0 = assign0.astype(jnp.int32)

    # shared Φ routing (host level — env resolved at call time)
    u, phi, phi_layout = _markov_features(z, x, lens, T=T, d=d, l=l, u=u)

    counts0 = jax.vmap(counts_from_assign, in_axes=(0, None))(assign0, C)
    init_abort = jnp.min(counts0, axis=1) <= min_members  # (R,)

    def _emstep(params, prev, mode):
        return emstep_markov_multi(
            params,
            lens,
            prev,
            u,
            T=T,
            assign_mode=mode,
            reg_mode=reg_mode,
            alpha=alpha,
            phi=phi,
            phi_layout=phi_layout,
        )

    params_m, _, _, _, _ = _emstep(params0, assign0, "prev")
    params_start = _tree_select_rows(init_abort, params0, params_m)
    status0 = jnp.where(init_abort, STATUS_INIT_ABORT, STATUS_RUNNING)

    def cond(state):
        _, _, i, status, _ = state
        return jnp.any(status == STATUS_RUNNING) & (i < n_steps)

    def body(state):
        params, assign, i, status, iters = state
        new_params, new_assign, counts, switches, _obj = _emstep(
            params, assign, "argmax"
        )
        running = status == STATUS_RUNNING  # (R,)
        _conv, _empty, adv_r, status_new = _em_termination(
            switches, counts, status, min_members=min_members
        )
        run_m = running & adv_r
        params_out = _tree_select_rows(run_m, new_params, params)
        assign_out = jnp.where(running[:, None], new_assign, assign)
        status_out = jnp.where(running, status_new, status)
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


def _pool_window_protocol(
    emstep_fn, K, state0, *, n_steps, min_members, assign_mask=None
):
    """The slot-pool window protocol shared by every engine: K
    iterations of ``emstep_fn(params, assigns, force) -> (new_params,
    new_assign, counts, switches)`` with per-slot freezing (terminal or
    capped slots idle), per-slot insertion (``force`` slots take their
    initial prev-M step on their first active pass, uncounted) and
    per-slot termination via :func:`_em_termination`.  Keeping the
    correctness-critical freeze/force/cap logic in ONE place guarantees
    the Markov, masked-filter and shard_map pools implement identical
    scheduling (pooled ≡ sequential is tested against this protocol for
    all of them).  ``assign_mask`` (an (n,) bool) additionally freezes
    invalid lanes of the assignment state — the shard_map window's pad
    lanes must stay -1 across passes."""

    def body(_k, state):
        params, assigns, status, iters, force = state
        new_params, new_assign, counts, switches = emstep_fn(
            params, assigns, force
        )
        fp = force > 0
        active = (status == STATUS_RUNNING) & (iters < n_steps)
        stepped = active & ~fp  # a counted argmax iteration
        _conv, _empty, adv_r, status_new = _em_termination(
            switches, counts, status, min_members=min_members
        )
        advance = stepped & adv_r
        take_new = (active & fp) | advance  # prev-M result or EM update
        params_out = _tree_select_rows(take_new, new_params, params)
        upd = (
            active[:, None]
            if assign_mask is None
            else active[:, None] & assign_mask[None, :]
        )
        assigns_out = jnp.where(upd, new_assign, assigns)
        status_out = jnp.where(stepped, status_new, status)
        iters_out = iters + stepped.astype(jnp.int32)
        force_out = jnp.where(active & fp, 0, force)
        return (params_out, assigns_out, status_out, iters_out, force_out)

    return jax.lax.fori_loop(0, K, body, state0)


@functools.partial(
    jax.jit,
    static_argnames=(
        "T",
        "K",
        "n_steps",
        "reg_mode",
        "alpha",
        "min_members",
        "phi_layout",
    ),
)
def _pool_window(
    params,  # stacked (R-leading) MixtureParams
    assigns,  # (R, n) int32
    status,  # (R,) int32
    iters,  # (R,) int32
    force,  # (R,) int32 — 1 ⇒ slot's next pass is its initial M step
    lens,  # (n,) int32
    u,  # (T·s, n) packed batch (None when phi carries the iterations)
    phi=None,  # (Fc_pad, n_pad) materialized features (optional)
    *,
    T: int,
    K: int,
    n_steps: int,
    reg_mode: str,
    alpha: float,
    min_members: int,
    phi_layout: str = "compact",
):
    """K fused multi-restart EM iterations in ONE dispatch, with
    per-slot freezing (terminal slots idle) and per-slot insertion
    (``force`` slots take their initial prev-M step on their first
    active pass, uncounted).  Module-level jit — traced/compiled once
    per static config, reused across every pool round and every fit."""

    def emstep_fn(params, assigns, force):
        new_params, new_assign, counts, switches, _obj = (
            emstep_markov_multi(
                params,
                lens,
                assigns,
                u,
                T=T,
                force_prev=force,
                reg_mode=reg_mode,
                alpha=alpha,
                phi=phi,
                phi_layout=phi_layout,
            )
        )
        return new_params, new_assign, counts, switches

    return _pool_window_protocol(
        emstep_fn,
        K,
        (params, assigns, status, iters, force),
        n_steps=n_steps,
        min_members=min_members,
    )


def _run_slot_pool(
    window,
    params_list,
    assign_list,
    *,
    R: int,
    C: int,
    n: int,
    n_state: int,
    n_steps: int,
    min_members: int,
) -> list:
    """Generic host scheduler for slot-pool multistart: R device slots,
    refilled the moment an occupant terminates; candidates that fail the
    init guard are recorded immediately (status 3, zero iterations).
    ``window(stack, assigns, status, iters, force)`` advances every slot
    K iterations on-device (per-slot freezing + force_prev insertion —
    see :func:`_pool_window` for the Markov instance).  Returns
    ``[(params, assign (n,), iters, status), ...]`` in candidate order.
    The engine-specific pools (:func:`train_em_markov_pool`,
    :func:`train_em_masked_kalman_pool`) build the window and delegate
    here."""
    import numpy as np

    n_cand = len(params_list)
    assert len(assign_list) == n_cand
    results = [None] * n_cand
    next_cand = 0

    def take_next():
        nonlocal next_cand
        while next_cand < n_cand:
            i = next_cand
            next_cand += 1
            a0 = np.asarray(assign_list[i]).astype(np.int32)
            cmin = np.bincount(a0, minlength=C).min()
            if cmin <= min_members:
                results[i] = (
                    params_list[i],
                    a0,
                    0,
                    int(STATUS_INIT_ABORT),
                )
                continue
            return i, a0
        return None

    slot_cand = [-1] * R  # candidate index, -1 = drained
    stack = jax.tree.map(
        lambda *ps: jnp.stack(ps), *([params_list[0]] * R)
    )
    assigns = jnp.full((R, n_state), -1, jnp.int32)  # pad lanes stay -1
    status = jnp.full((R,), STATUS_CONVERGED, jnp.int32)  # idle until fill
    iters = jnp.zeros((R,), jnp.int32)
    force = jnp.zeros((R,), jnp.int32)

    def refill(rows):
        """Insert the next candidates into ``rows`` — ONE batched
        device update per state array."""
        nonlocal stack, assigns, status, iters, force, slot_cand
        take_rows, take_params, take_assigns = [], [], []
        for r in rows:
            nxt = take_next()
            if nxt is None:
                slot_cand[r] = -1
                continue
            i, a0 = nxt
            slot_cand[r] = i
            take_rows.append(r)
            take_params.append(params_list[i])
            take_assigns.append(a0)
        if not take_rows:
            return
        rj = jnp.asarray(np.asarray(take_rows, np.int32))
        pstack = jax.tree.map(lambda *ps: jnp.stack(ps), *take_params)
        stack = jax.tree.map(
            lambda s, p: s.at[rj].set(p), stack, pstack
        )
        a_rows = np.stack(take_assigns)
        if n_state > n:  # mesh mode: pad lanes ride as -1 (kernel-ignored)
            a_rows = np.concatenate(
                [
                    a_rows,
                    np.full((len(take_rows), n_state - n), -1, np.int32),
                ],
                axis=1,
            )
        assigns = assigns.at[rj].set(jnp.asarray(a_rows))
        status = status.at[rj].set(STATUS_RUNNING)
        iters = iters.at[rj].set(0)
        force = force.at[rj].set(1)

    refill(list(range(R)))

    while any(c >= 0 for c in slot_cand):
        stack, assigns, status, iters, force = window(
            stack, assigns, status, iters, force
        )
        status_h = np.asarray(status)
        iters_h = np.asarray(iters)
        done_rows = []
        for r in range(R):
            if slot_cand[r] < 0:
                continue
            terminal = status_h[r] != STATUS_RUNNING
            capped = (
                status_h[r] == STATUS_RUNNING and iters_h[r] >= n_steps
            )
            if not (terminal or capped):
                continue
            results[slot_cand[r]] = (
                jax.tree.map(lambda q: q[r], stack),
                np.asarray(assigns[r, :n]),
                int(iters_h[r]),
                int(status_h[r]),
            )
            done_rows.append(r)
        if done_rows:
            refill(done_rows)

    return results


def train_em_markov_pool(
    params_list,  # sequence of per-candidate MixtureParams
    assign_list,  # sequence of per-candidate (n,) int assignments
    z: jax.Array,  # (T, n, d) NaN-suffix-padded — shared
    x: jax.Array,  # (T, n, l)
    lens: jax.Array,  # (n,) int32
    *,
    R: int = 32,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    min_members: int = 3,
    sync_every: int = 8,
    u: jax.Array = None,
    mesh=None,  # jax.sharding.Mesh with a "data" axis → data-parallel
) -> list:
    """Slot-pool multistart: train every candidate through R kernel
    slots, REFILLING a slot with the next candidate the moment its
    occupant terminates — unlike the fixed-chunk
    :func:`train_em_markov_multi`, no slot idles waiting for a chunk's
    slowest restart, so the convergence-spread waste that caps the
    useful chunk size disappears and R can ride the large-R
    efficiency of one shared Φ read (a fixed R=32 chunk wastes most of
    it on spread).

    A freshly inserted candidate takes its initial M step via the
    per-slot ``force_prev`` flag IN THE SAME dispatch as the other
    slots' argmax iterations — insertion costs zero extra kernel
    passes.  The host syncs only every ``sync_every`` iterations: a
    module-level jitted window (:func:`_pool_window`) runs K fused
    multi-iterations per dispatch with per-slot freezing, so a slot
    idles at most K−1 passes after terminating before its refill (vs
    the full chunk spread).  Each candidate's trajectory, iteration
    count and status are identical to a standalone
    :func:`train_em_markov` run (same per-row dot products; verified in
    f64), and results are returned in candidate order, so the
    first-strictly-greater winner rule is unaffected.  Returns
    ``[(params, assign (n,), iters, status), ...]`` per candidate.

    With ``mesh=`` (a ``jax.sharding.Mesh`` carrying a ``"data"`` axis)
    the window runs data-parallel over the mesh — every device holds
    all R slot parameter rows and its own trajectory shard, and each
    iteration psums the per-restart statistics blocks exactly like
    :func:`..parallel.sharded_em.train_em_markov_multi_shardmap`; the
    host scheduling (refills, candidate order, winner rule) is
    unchanged and results equal the single-device pool up to psum
    reassociation (exact on the f64 test mesh).

    Reference protocol: mixture:1368-1471 (n_starts sequential fits).
    """
    n_cand = len(params_list)
    T, n, d = z.shape
    l = x.shape[-1]
    C = params_list[0].pi.shape[0]
    R = max(1, min(R, n_cand))
    K = max(1, int(sync_every))

    if mesh is not None:
        from multimodal_trajectory_modeling_tpu.parallel import sharded_em

        window, n_state = sharded_em.pool_window_for_mesh(
            z,
            x,
            lens,
            mesh=mesh,
            K=K,
            n_steps=n_steps,
            reg_mode=reg_mode,
            alpha=float(alpha),
            min_members=min_members,
            u=u,
        )
    else:
        n_state = n
        lens_w = lens
        # materialize Φ once for the whole pool (the shared
        # _markov_features routing): every slot's iteration then reads Φ
        u_w, phi_w, phi_layout = _markov_features(
            z, x, lens, T=T, d=d, l=l, u=u
        )

        def window(stack, assigns, status, iters, force):
            return _pool_window(
                stack,
                assigns,
                status,
                iters,
                force,
                lens_w,
                u_w,
                phi_w,
                T=T,
                K=K,
                n_steps=n_steps,
                reg_mode=reg_mode,
                alpha=float(alpha),
                min_members=min_members,
                phi_layout=phi_layout,
            )

    return _run_slot_pool(
        window,
        params_list,
        assign_list,
        R=R,
        C=C,
        n=n,
        n_state=n_state,
        n_steps=n_steps,
        min_members=min_members,
    )


def complete_data_loglik_markov_multi(
    params: MixtureParams,  # leading R axis on every leaf
    lens: jax.Array,  # (n,) int32
    u: jax.Array,  # (T·s, n) packed batch — shared (None under phi)
    *,
    T: int,
    phi: jax.Array = None,  # (F_pad, n_pad) materialized features
    phi_layout: str = "compact",
) -> jax.Array:
    """Per-restart ``Σ_i max_c scores`` objectives (R,) in one Φ pass —
    the R-restart :func:`complete_data_loglik_markov`.  Pass ``phi``
    (+ ``phi_layout="canonical"`` from the long-T materializer) to
    evaluate from materialized features; otherwise the compact Φ is
    built from ``u`` (wide storage, like the single-restart
    objective)."""
    from multimodal_trajectory_modeling_tpu.ops import markov_phi

    d = params.m.shape[2]
    l = params.H.shape[3]
    R = params.pi.shape[0]
    n = lens.shape[0]
    if phi is None:
        phi = pack_markov_features(u, lens, T=T, d=d, l=l)
        phi_layout = "compact"
    _a, _c, _w, _g, obj = markov_phi.markov_em_from_features_multi(
        phi,
        lens,
        jnp.zeros((R, n), jnp.int32),
        jax.vmap(_em_weights)(params),
        T=T,
        d=d,
        l=l,
        layout=phi_layout,
    )
    return obj


@functools.partial(
    jax.jit,
    static_argnames=("n_steps", "reg_mode", "alpha", "method", "min_members"),
)
def train_em_multistart(
    params0: MixtureParams,
    assign0: jax.Array,
    z: jax.Array,
    x: jax.Array,
    v: jax.Array,
    patterns: jax.Array,
    pattern_id: jax.Array,
    *,
    n_steps: int = 100,
    reg_mode: str = "lstsq",
    alpha: float = 0.0,
    method: str = "auto",
    min_members: int = 3,
):
    """Vmapped multi-start training: ``params0`` / ``assign0`` carry a leading
    restart axis ``R``; every start trains in parallel on-device; returns the
    stacked results plus each start's complete-data objective ``(R,)``.

    Replaces the reference's sequential 1000-restart Python loop
    (mixture:1368-1471); winner selection stays on the host to replicate the
    first-strictly-greater rule.
    """
    T = z.shape[0]

    def one(p0, a0):
        params, assign, iters, status = train_em(
            p0,
            a0,
            z,
            x,
            v,
            patterns,
            pattern_id,
            n_steps=n_steps,
            reg_mode=reg_mode,
            alpha=alpha,
            method=method,
            min_members=min_members,
        )
        obj = complete_data_loglik(
            params, v, patterns, pattern_id, T=T, method=method
        )
        return params, assign, iters, status, obj

    return jax.vmap(one)(params0, assign0)
