"""Masked, weighted, batched linear-Gaussian regression for the M-step.

The reference M-step loops over clusters, stacks the (prev, next) state pairs
/ (state, observation) pairs of each cluster's members, drops any-NaN rows,
and runs either a bare SVD ``lstsq`` (marginalizable_mixture_model.py:1167-
1200), an eps-ridged normal-equation solve (util/util_state_space.py:33-61)
or sklearn Ridge (same:64-94; mixture:1202-1233).  The residual covariance is
always ``np.cov(Y - X @ A, rowvar=False)`` — i.e. *mean-centered* with ddof=1.

Accelerator design: all clusters at once.  A one-hot membership matrix ``W``
``(N, C)`` and a finite-row mask fold into weighted sufficient statistics
``X^T X, X^T Y, Y^T Y, ΣX, ΣY, count`` via einsums (GEMM work), then a tiny
per-cluster solve.  Three solve modes replicate the reference's three
regression flavours:

- ``mode="lstsq"``  — min-norm least squares via eigh-based PSD pseudo-inverse
  of X^T X (identical to ``np.linalg.lstsq(X, Y)`` through the identity
  ``X^+ = (X^T X)^+ X^T``, including rank-deficient X).
- ``mode="eps"``    — solve ``(X^T X + eps I) A = X^T Y`` (util.regress).
- ``mode="ridge"``  — same with user alpha (Ridge(fit_intercept=False)).

Under a data-sharded mesh the sufficient statistics are the only cross-device
communication: a single ``psum`` per statistic (inserted automatically by XLA
when the batch axis is sharded, or explicitly in parallel/sharded_em.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Exact f32 products: an accelerator's default f32 matmul may round its
# operands (TF32 on the GPU keeps ~10 mantissa bits, bf16 7).  The
# sufficient-statistics contractions subtract nearly-equal large moments
# (normal-equations cancellation), where such rounding produced
# INDEFINITE covariance estimates on wide-range data (measured: detL < 0
# at |x|~50, collapsing EM; see PARITY.md).  Every load-bearing
# contraction pins full f32 precision (a no-op on the CPU).
_HI = jax.lax.Precision.HIGHEST

__all__ = [
    "RegressionStats",
    "weighted_regression_stats",
    "solve_regression",
    "regress",
    "masked_mean_and_cov",
]


class RegressionStats(NamedTuple):
    """Weighted sufficient statistics, one leading cluster axis ``C``."""

    xtx: jax.Array  # (C, p, p)
    xty: jax.Array  # (C, p, q)
    yty: jax.Array  # (C, q, q)
    sx: jax.Array  # (C, p)
    sy: jax.Array  # (C, q)
    count: jax.Array  # (C,)


def weighted_regression_stats(
    X: jax.Array, Y: jax.Array, W: jax.Array
) -> RegressionStats:
    """Accumulate masked weighted sufficient statistics.

    Parameters
    ----------
    X : (N, p) inputs, may contain NaN.
    Y : (N, q) outputs, may contain NaN.
    W : (N, C) nonnegative weights (one-hot membership in hard EM).

    A row participates only if *every* coordinate of ``[X_row, Y_row]`` is
    finite — the reference's any-NaN row drop
    (marginalizable_mixture_model.py:1272-1296, util_state_space.py:55-56).
    """
    valid = jnp.isfinite(X).all(axis=-1) & jnp.isfinite(Y).all(axis=-1)
    Xc = jnp.where(jnp.isfinite(X), X, 0.0)
    Yc = jnp.where(jnp.isfinite(Y), Y, 0.0)
    Wv = W * valid[:, None].astype(W.dtype)  # (N, C)
    xtx = jnp.einsum("nc,ni,nj->cij", Wv, Xc, Xc, precision=_HI)
    xty = jnp.einsum("nc,ni,nj->cij", Wv, Xc, Yc, precision=_HI)
    yty = jnp.einsum("nc,ni,nj->cij", Wv, Yc, Yc, precision=_HI)
    sx = jnp.einsum("nc,ni->ci", Wv, Xc, precision=_HI)
    sy = jnp.einsum("nc,ni->ci", Wv, Yc, precision=_HI)
    count = jnp.sum(Wv, axis=0)
    return RegressionStats(xtx, xty, yty, sx, sy, count)


def weighted_regression_stats_timebatched(
    X: jax.Array, Y: jax.Array, W: jax.Array
) -> RegressionStats:
    """Time-batched variant: ``X (T', n, p)``, ``Y (T', n, q)`` pairs with a
    per-*instance* weight matrix ``W (n, C)`` applied at every time step.

    Contracting the time axis inside the einsums avoids materializing the
    ``(T'·n, C)`` tiled weight matrix (hundreds of MB at n=1e6) that the
    flat path would need — the dominant M-step memory traffic.
    """
    valid = (
        jnp.isfinite(X).all(axis=-1) & jnp.isfinite(Y).all(axis=-1)
    )  # (T', n)
    vf = valid.astype(W.dtype)
    Xm = jnp.where(jnp.isfinite(X), X, 0.0) * vf[:, :, None]
    Yc = jnp.where(jnp.isfinite(Y), Y, 0.0)
    Ym = Yc * vf[:, :, None]
    xtx = jnp.einsum("tni,tnj,nc->cij", Xm, Xm, W, precision=_HI)
    xty = jnp.einsum("tni,tnj,nc->cij", Xm, Yc, W, precision=_HI)
    yty = jnp.einsum("tni,tnj,nc->cij", Ym, Yc, W, precision=_HI)
    sx = jnp.einsum("tni,nc->ci", Xm, W, precision=_HI)
    sy = jnp.einsum("tni,nc->ci", Ym, W, precision=_HI)
    count = jnp.einsum("tn,nc->c", vf, W, precision=_HI)
    return RegressionStats(xtx, xty, yty, sx, sy, count)


def weighted_regression_stats_gram(
    X: jax.Array, Y: jax.Array, W: jax.Array
) -> RegressionStats:
    """Gram-matrix variant of
    :func:`weighted_regression_stats_timebatched` — same inputs, same
    statistics, ONE einsum per group instead of six.

    Builds the augmented row matrix ``U = [X_masked, Y_masked, valid]``
    ``(T', n, p+q+1)`` and contracts ``G = Σ_t Σ_n w_nc · U U^T`` in a
    single ``tnu,tnv,nc->cuv`` einsum whose ``(u, u)`` output blocks contain
    every statistic at once (X^TX, X^TY, Y^TY and — via the validity
    column — ΣX, ΣY, count).  The batch streams from device memory once
    per group instead of three times.

    Results match the six-einsum path exactly in f64 and to f32
    reassociation noise (~1e-5 relative) in f32; ``em.mstep`` keeps the
    six-einsum path as the default for bit-level reference parity and
    exposes this one as ``impl="gram"`` (used by bench.py).
    """
    valid = (
        jnp.isfinite(X).all(axis=-1) & jnp.isfinite(Y).all(axis=-1)
    )  # (T', n)
    vf = valid.astype(W.dtype)
    Xm = jnp.where(jnp.isfinite(X), X, 0.0) * vf[:, :, None]
    Ym = jnp.where(jnp.isfinite(Y), Y, 0.0) * vf[:, :, None]
    U = jnp.concatenate([Xm, Ym, vf[:, :, None]], axis=-1)  # (T', n, u)
    G = jnp.einsum("tnu,tnv,nc->cuv", U, U, W, precision=_HI)
    p = X.shape[-1]
    q = Y.shape[-1]
    return RegressionStats(
        xtx=G[:, :p, :p],
        xty=G[:, :p, p : p + q],
        yty=G[:, p : p + q, p : p + q],
        sx=G[:, -1, :p],
        sy=G[:, -1, p : p + q],
        count=G[:, -1, -1],
    )


def _psd_pinv_solve(M: jax.Array, B: jax.Array, rcond: float) -> jax.Array:
    """Solve ``M A = B`` for PSD ``M`` via eigh-based pseudo-inverse.

    For full-rank M this equals ``solve``; for singular M it returns the
    min-norm solution, matching ``np.linalg.lstsq``'s behaviour through
    ``X^+ = (X^T X)^+ X^T``.
    """
    w, U = jnp.linalg.eigh(M)
    cutoff = rcond * jnp.max(jnp.abs(w), axis=-1, keepdims=True)
    winv = jnp.where(w > cutoff, 1.0 / w, 0.0)
    with jax.default_matmul_precision("highest"):
        return U @ (winv[..., None] * (U.swapaxes(-1, -2) @ B))


def solve_regression(
    stats: RegressionStats,
    *,
    mode: str = "lstsq",
    alpha: float = 0.0,
    eps: float = 1e-6,
    rcond: float = 1e-14,
) -> tuple[jax.Array, jax.Array]:
    """Turn sufficient statistics into ``(A, S)`` per cluster.

    ``A`` is ``(C, p, q)``; ``S`` is the ddof-1 *mean-centered* residual
    covariance ``(C, q, q)``, replicating ``np.cov(Y - X A, rowvar=False)``.
    """
    xtx, xty, yty, sx, sy, count = stats
    p = xtx.shape[-1]
    eye = jnp.eye(p, dtype=xtx.dtype)
    if mode == "lstsq":
        A = _psd_pinv_solve(xtx, xty, rcond)
    elif mode == "eps":
        A = _psd_pinv_solve(xtx + eps * eye, xty, rcond)
    elif mode == "ridge":
        A = jnp.linalg.solve(xtx + alpha * eye, xty)
    elif mode == "chol":
        # eps-ridged normal equations via Cholesky — util.regress
        # (util_state_space.py:33-61) semantics through a fast
        # factorization (batched eigh of tiny matrices is latency-bound
        # on accelerators; cho_solve is cheap).
        # Requires X^T X + eps·I ≻ 0 — guaranteed for any non-degenerate
        # cluster; bench.py uses this mode.
        Lc = jnp.linalg.cholesky(xtx + eps * eye)
        A = jax.scipy.linalg.cho_solve((Lc, True), xty)
    else:  # pragma: no cover
        raise ValueError(f"unknown mode {mode!r}")

    At = A.swapaxes(-1, -2)
    # THE cancellation site of the whole M step: the residual Gram
    # `yty − AᵀXᵀY − YᵀXA + AᵀXᵀXA` subtracts moments ~10⁴× the result;
    # rounded (bf16 or TF32) products made this INDEFINITE on
    # wide-range data (detL̂ < 0, collapsing EM — PARITY.md round-5
    # finding).
    with jax.default_matmul_precision("highest"):
        rtr = yty - At @ xty - xty.swapaxes(-1, -2) @ A + At @ xtx @ A
    sr = sy - jnp.einsum("cp,cpq->cq", sx, A, precision=_HI)  # Σ residual
    n = count[:, None, None]
    centered = rtr - sr[:, :, None] * sr[:, None, :] / n
    S = centered / (n - 1.0)
    return A, S


def regress(
    X: jax.Array,
    Y: jax.Array,
    *,
    mode: str = "eps",
    alpha: float = 0.0,
    eps: float = 1e-6,
) -> tuple[jax.Array, jax.Array]:
    """Single-group convenience wrapper: MLE of ``Y|X ~ N(X A, S)`` with
    any-NaN rows dropped.  ``mode="eps"`` replicates ``util.regress``
    (util_state_space.py:33-61), ``mode="ridge"`` replicates
    ``util.regress_alpha`` (same:64-94), ``mode="lstsq"`` replicates the
    mixture-internal ``regress`` (marginalizable_mixture_model.py:1167-1200).
    """
    X = jnp.atleast_2d(X)
    Y = jnp.atleast_2d(Y)
    W = jnp.ones((X.shape[0], 1), dtype=X.dtype)
    stats = weighted_regression_stats(X, Y, W)
    A, S = solve_regression(stats, mode=mode, alpha=alpha, eps=eps)
    return A[0], S[0]


class MomentStats(NamedTuple):
    """Additive first/second-moment statistics per cluster (psum-able)."""

    count: jax.Array  # (C,)
    s: jax.Array  # (C, d)   Σ w z
    ss: jax.Array  # (C, d, d)  Σ w z z^T


def masked_moment_stats(Z: jax.Array, W: jax.Array) -> MomentStats:
    """Accumulate moments of rows of ``Z`` whose every coordinate is finite,
    weighted by ``W`` ``(N, C)``.  Additive across data shards — one ``psum``
    per field under a data-parallel mesh."""
    valid = jnp.isfinite(Z).all(axis=-1)
    Zc = jnp.where(jnp.isfinite(Z), Z, 0.0)
    Wv = W * valid[:, None].astype(W.dtype)
    count = jnp.sum(Wv, axis=0)
    s = jnp.einsum("nc,ni->ci", Wv, Zc, precision=_HI)
    ss = jnp.einsum("nc,ni,nj->cij", Wv, Zc, Zc, precision=_HI)
    return MomentStats(count, s, ss)


def mean_cov_from_stats(
    stats: MomentStats,
) -> tuple[jax.Array, jax.Array]:
    """Finalize :class:`MomentStats` into (mean, ddof-1 covariance),
    matching ``np.mean`` / ``np.cov(rowvar=False)`` over the kept rows
    (reference marginalizable_mixture_model.py:1267-1270)."""
    count, s, ss = stats
    mean = s / count[:, None]
    centered = ss - count[:, None, None] * (
        mean[:, :, None] * mean[:, None, :]
    )
    cov = centered / (count[:, None, None] - 1.0)
    return mean, cov


def masked_mean_and_cov(
    Z: jax.Array, W: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Per-cluster mean and ddof-1 covariance of fully-finite rows of ``Z``
    weighted by ``W`` ``(N, C)`` — convenience composition of
    :func:`masked_moment_stats` + :func:`mean_cov_from_stats`."""
    return mean_cov_from_stats(masked_moment_stats(Z, W))
