"""Masked (NaN-marginalizing) multivariate-normal log-densities.

This is the hot kernel of the whole framework: the E-step evaluates, for every
(cluster, instance) pair, the log-density of a Gaussian restricted to the
finite coordinates of that instance's stacked trajectory vector.  The
reference implements it as a per-row numba ``guvectorize`` loop doing
``det``/``solve`` on the masked submatrix
(framework/marginalizable_state_space_model.py:728-773).

Accelerator design — fixed shapes, no data-dependent gathers:

For a finite-mask ``f ∈ {0,1}^D`` define the identity-padded matrix

    Σ' = (f f^T) ⊙ Σ + diag(1 - f)

and the masked residual ``r = f ⊙ (x - μ)``.  Σ' is block-diagonal between
kept and dropped coordinates, with identity on the dropped block, so

    logdet Σ'          == logdet Σ_sub          (dropped dims contribute 0)
    r^T Σ'^{-1} r      == r_sub^T Σ_sub^{-1} r_sub
    k = Σ_i f_i        == dimension of the kept sub-block

which reproduces the reference's masked-submatrix algebra exactly, including
the degenerate all-masked row (k = 0 → log-density 0, matching numba's
``det`` of an empty matrix = 1).

Two evaluation strategies:

- :func:`masked_mvn_logpdf` — fully general: one factorization per row
  (vmapped, chunkable).  Used as the correctness oracle.
- :func:`masked_mvn_logpdf_grouped` — the production path: missingness
  patterns are constant across EM iterations, so rows are grouped by pattern;
  one Cholesky per (pattern) and either a batched triangular solve or a
  precomputed inverse turned into a single GEMM per pattern.
"""

from __future__ import annotations

import math

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
import numpy as np

__all__ = [
    "masked_identity_pad",
    "masked_mvn_logpdf",
    "masked_mvn_logpdf_grouped",
    "mvn_logpdf",
    "pattern_groups",
]

_LOG_2PI = math.log(2.0 * math.pi)


def masked_identity_pad(cov: jax.Array, f: jax.Array) -> jax.Array:
    """``(f f^T) ⊙ Σ + diag(1-f)`` for a float 0/1 mask ``f`` of shape (D,)."""
    D = cov.shape[-1]
    return cov * (f[..., :, None] * f[..., None, :]) + jnp.eye(
        D, dtype=cov.dtype
    ) * (1.0 - f[..., None, :])


def _row_logpdf_chol(x_row, finite_row, mean, cov):
    f = finite_row.astype(cov.dtype)
    r = jnp.where(finite_row, x_row - mean, 0.0)
    covm = masked_identity_pad(cov, f)
    Lc = jnp.linalg.cholesky(covm)
    y = jax.scipy.linalg.solve_triangular(Lc, r, lower=True)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(Lc)))
    k = jnp.sum(f)
    with jax.default_matmul_precision("highest"):
        return -0.5 * (k * _LOG_2PI + logdet + y @ y)


def _row_logpdf_lu(x_row, finite_row, mean, cov):
    # Closest to the reference numba kernel's det+solve semantics
    # (marginalizable_state_space_model.py:768-773): an indefinite submatrix
    # with negative determinant yields NaN, a singular one -inf/NaN.
    f = finite_row.astype(cov.dtype)
    r = jnp.where(finite_row, x_row - mean, 0.0)
    covm = masked_identity_pad(cov, f)
    sign, logabsdet = jnp.linalg.slogdet(covm)
    logdet = jnp.where(sign > 0, logabsdet, jnp.nan)
    with jax.default_matmul_precision("highest"):
        q = r @ jnp.linalg.solve(covm, r)
    k = jnp.sum(f)
    return -0.5 * (k * _LOG_2PI + logdet + q)


def masked_mvn_logpdf(
    x: jax.Array,
    mean: jax.Array,
    cov: jax.Array,
    *,
    method: str = "lu",
) -> jax.Array:
    """Per-row Gaussian log-density with non-finite coordinates marginalized.

    Parameters
    ----------
    x
        ``(n, D)`` matrix of observations (rows may contain NaN/inf).
    mean
        ``(D,)`` mean vector.
    cov
        ``(D, D)`` covariance.
    method
        ``"lu"`` (det/solve — reference semantics incl. indefinite inputs) or
        ``"cholesky"`` (SPD-only, faster).

    Returns
    -------
    ``(n,)`` vector of log-densities; a fully non-finite row gives 0.0.

    Reference: ``multivariate_normal_log_likelihood``
    (marginalizable_state_space_model.py:728-773) and the scipy slow path
    ``marginalizable_gaussian_log_prob`` (same file:908-943).
    """
    x = jnp.atleast_2d(x)
    finite = jnp.isfinite(x)
    row = _row_logpdf_lu if method == "lu" else _row_logpdf_chol
    return jax.vmap(row, in_axes=(0, 0, None, None))(x, finite, mean, cov)


def mvn_logpdf(x: jax.Array, mean: jax.Array, cov: jax.Array) -> jax.Array:
    """Dense (no-missing-data) Gaussian log-density: one Cholesky, batched
    triangular solve over all rows.  Fast path when the data are complete."""
    x = jnp.atleast_2d(x)
    D = x.shape[-1]
    Lc = jnp.linalg.cholesky(cov)
    r = x - mean
    y = jax.scipy.linalg.solve_triangular(Lc, r.T, lower=True)  # (D, n)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(Lc)))
    return -0.5 * (D * _LOG_2PI + logdet + jnp.sum(y * y, axis=0))


def pattern_groups(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side helper: group rows of ``x`` by missingness pattern.

    Missingness masks are fixed for the lifetime of a training run, so this
    runs once per dataset.  Returns ``(patterns, pattern_id)`` with
    ``patterns`` a ``(P, D)`` bool array of unique finite-masks and
    ``pattern_id`` an ``(n,)`` int32 index such that
    ``patterns[pattern_id[i]] == isfinite(x[i])``.
    """
    x = np.atleast_2d(np.asarray(x))
    finite = np.isfinite(x)
    patterns, pattern_id = np.unique(finite, axis=0, return_inverse=True)
    return patterns.astype(bool), pattern_id.astype(np.int32).reshape(-1)


def masked_mvn_logpdf_grouped(
    x: jax.Array,
    mean: jax.Array,
    cov: jax.Array,
    patterns: jax.Array,
    pattern_id: jax.Array,
    *,
    method: str = "auto",
) -> jax.Array:
    """Pattern-grouped masked Gaussian log-density (production E-step path).

    One identity-padded Cholesky per pattern; per-row work is O(D^2):

    - ``method="solve"``: batched triangular solve against each pattern's
      factor, then per-row selection of its own pattern (exact, stable).
    - ``method="inverse"``: precompute ``Σ'^{-1}`` per pattern and evaluate
      the quadratic form as ``rowsum((r @ Σ'^{-1}) ⊙ r)`` — a pure GEMM,
      the speed-of-light path for large n.
    - ``method="bucketed"``: per-pattern inverses, but each row contracts
      only against *its own* pattern's inverse (a chunked gather), so work
      is O(P·D³ + n·D²) instead of the solve/inverse paths' O(n·P·D²) —
      the right path for unstructured missingness where P grows with n.
      Matches the reference's per-row sub-block evaluation cost model
      (marginalizable_state_space_model.py:747-773).
    - ``method="auto"``: ``"solve"`` while ``P ≤ max(8, D)`` (bit-identical
      to the parity path in that regime), ``"bucketed"`` beyond it.  The
      dispatch is on static shapes, so it is jit-stable.

    All methods are algebraically identical to the reference's
    masked-submatrix evaluation; rows whose finite-mask is not represented
    in ``patterns`` are undefined (callers build patterns from the same
    data).
    """
    x = jnp.atleast_2d(x)
    n, D = x.shape
    P = patterns.shape[0]
    if method == "auto":
        method = "solve" if P <= max(8, D) else "bucketed"
    f = patterns.astype(cov.dtype)  # (P, D)
    k = jnp.sum(f, axis=-1)  # (P,)
    covm = jax.vmap(lambda fp: masked_identity_pad(cov, fp))(f)  # (P, D, D)
    Lc = jnp.linalg.cholesky(covm)
    logdet = 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(Lc, axis1=-2, axis2=-1)), axis=-1
    )  # (P,)

    finite = jnp.isfinite(x)
    r = jnp.where(finite, x - mean, 0.0)  # (n, D)

    if method == "bucketed":
        eye = jnp.eye(D, dtype=cov.dtype)
        inv = jax.vmap(
            lambda Lp: jax.scipy.linalg.cho_solve((Lp, True), eye)
        )(Lc)  # (P, D, D)
        B = min(4096, n)  # chunk rows to bound the (B, D, D) gather
        pad = (-n) % B
        r_c = jnp.pad(r, ((0, pad), (0, 0))).reshape(-1, B, D)
        id_c = jnp.pad(pattern_id, (0, pad)).reshape(-1, B)

        def _chunk(args):
            rc, pc = args
            return jnp.einsum("nd,nde,ne->n", rc, inv[pc], rc, precision=_HI)

        q = jax.lax.map(_chunk, (r_c, id_c)).reshape(-1)[:n]
    elif method == "inverse":
        eye = jnp.eye(D, dtype=cov.dtype)
        inv = jax.vmap(
            lambda Lp: jax.scipy.linalg.cho_solve((Lp, True), eye)
        )(Lc)  # (P, D, D)
        q_all = jnp.einsum("nd,pde,ne->np", r, inv, r, precision=_HI)  # GEMMs
        q = jnp.take_along_axis(q_all, pattern_id[:, None], axis=1)[:, 0]
    else:
        y_all = jax.vmap(
            lambda Lp: jax.scipy.linalg.solve_triangular(Lp, r.T, lower=True)
        )(Lc)  # (P, D, n)
        q_all = jnp.sum(y_all * y_all, axis=1)  # (P, n)
        q = jnp.take_along_axis(q_all, pattern_id[None, :], axis=0)[0]

    return -0.5 * (k[pattern_id] * _LOG_2PI + logdet[pattern_id] + q)
