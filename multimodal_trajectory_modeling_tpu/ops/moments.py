"""Closed-form joint moments of a linear-Gaussian state-space model.

The latent process Z_1..Z_T in R^d follows ``Z_t | Z_{t-1} ~ N(Z_{t-1} A, G)``
with ``Z_1 ~ N(m, S)``; observations X_1..X_T in R^l follow
``X_t | Z_t ~ N(Z_t H, L)`` (row-vector convention, matching the reference,
framework/marginalizable_state_space_model.py:4-21).  The joint
``(Z_1..Z_T, X_1..X_T)`` is multivariate normal; this module builds its mean
vector and covariance matrix with static shapes so everything jits and vmaps
over a leading cluster axis.

Reference parity targets (semantics, not implementation):
- ``mmZ`` / ``mmX`` / ``mm``  ← marginalizable_state_space_model.py:294-364
- ``CZZ`` / ``_CZX`` / ``CXX`` / ``CC`` ← same file:32-291 (numba recursions
  ``_CZZii``/``_CZZij``/``_CXXij`` become a single ``lax.scan`` variance chain
  plus a scanned A-power chain, assembled as one block tensor).

Layout of the stacked joint vector: ``[z_1, .., z_T, x_1, .., x_T]`` — all
latent steps first, then all observed steps, matching the reference's
``np.hstack((*states, *observations))`` convention
(marginalizable_mixture_model.py:489-494).
"""

from __future__ import annotations

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
    "latent_means",
    "joint_mean",
    "observed_mean",
    "latent_cov_blocks",
    "latent_cov",
    "observed_cov",
    "joint_cov",
    "joint_moments",
    "observed_moments",
]


def latent_means(T: int, m: jax.Array, A: jax.Array) -> jax.Array:
    """Means of the latent chain: ``E[Z_t] = m A^{t-1}`` for t = 1..T.

    Returns a ``(T, d)`` array.  Computed by scanning ``mu <- mu @ A`` rather
    than repeated ``matrix_power`` (reference mmZ,
    marginalizable_state_space_model.py:294-314).
    """
    m = jnp.atleast_1d(m)

    def step(mu, _):
        return mu @ A, mu

    _, mus = jax.lax.scan(step, m, None, length=T)
    return mus


def observed_mean(T: int, m: jax.Array, A: jax.Array, H: jax.Array) -> jax.Array:
    """Stacked mean of the observed process, ``(T*l,)``  (reference mmX)."""
    return (latent_means(T, m, A) @ H).reshape(-1)


def joint_mean(T: int, m: jax.Array, A: jax.Array, H: jax.Array) -> jax.Array:
    """Stacked mean of ``(Z_1..Z_T, X_1..X_T)``, shape ``(T*(d+l),)``.

    Reference: ``mm`` (marginalizable_state_space_model.py:342-364).
    """
    mus = latent_means(T, m, A)
    return jnp.concatenate([mus.reshape(-1), (mus @ H).reshape(-1)])


def _variance_chain(T: int, S: jax.Array, A: jax.Array, G: jax.Array) -> jax.Array:
    """``Var(Z_t)`` for t = 1..T via the recursion ``V_{t+1} = G + A^T V_t A``.

    Reference: the recursive numba kernel ``_CZZii``
    (marginalizable_state_space_model.py:32-64), unrolled as a scan.
    """

    def step(V, _):
        return G + A.T @ V @ A, V

    _, Vs = jax.lax.scan(step, S, None, length=T)
    return Vs  # (T, d, d)


def latent_cov_blocks(
    T: int, S: jax.Array, A: jax.Array, G: jax.Array
) -> jax.Array:
    """Block tensor ``B[i, j] = Cov(Z_{i+1}, Z_{j+1})`` of shape ``(T, T, d, d)``.

    ``Cov(Z_i, Z_j) = Var(Z_i) A^{j-i}`` for j >= i (reference ``_CZZij``,
    marginalizable_state_space_model.py:67-105).  All T variance blocks are
    scanned once, then a second scan multiplies the whole stack by ``A``
    repeatedly, producing every required power-lag in T steps; the
    (T, T) block grid is assembled as ONE vectorized gather
    ``B[i, j] = Gk[|j-i|, min(i, j)]`` (transposed below the diagonal)
    rather than a T² Python loop (65k eager dispatches at T=256 cost
    ~16 s on CPU; the gather is milliseconds and jit-friendly).
    """
    Vs = _variance_chain(T, S, A, G)

    def step(C, _):
        return C @ A, C

    _, Gk = jax.lax.scan(step, Vs, None, length=T)  # Gk[k, i] = Var(Z_i) A^k
    ii, jj = jnp.meshgrid(jnp.arange(T), jnp.arange(T), indexing="ij")
    B = Gk[jnp.abs(jj - ii), jnp.minimum(ii, jj)]  # (T, T, d, d)
    lower = (jj < ii)[:, :, None, None]
    return jnp.where(lower, jnp.swapaxes(B, -1, -2), B)


def _blocks_to_matrix(B: jax.Array) -> jax.Array:
    """(T, T, p, q) block tensor → (T*p, T*q) matrix."""
    T1, T2, p, q = B.shape
    return B.transpose(0, 2, 1, 3).reshape(T1 * p, T2 * q)


def latent_cov(T: int, S: jax.Array, A: jax.Array, G: jax.Array) -> jax.Array:
    """Full ``(T*d, T*d)`` covariance of the latent chain (reference CZZ)."""
    return _blocks_to_matrix(latent_cov_blocks(T, S, A, G))


def observed_cov(
    T: int,
    S: jax.Array,
    A: jax.Array,
    G: jax.Array,
    H: jax.Array,
    L: jax.Array,
) -> jax.Array:
    """Full ``(T*l, T*l)`` covariance of the observed process (reference CXX).

    ``Cov(X_i, X_j) = H^T Cov(Z_i, Z_j) H + δ_ij L``
    (marginalizable_state_space_model.py:169-256).
    """
    B = latent_cov_blocks(T, S, A, G)
    core = jnp.einsum("ka,ijkl,lb->ijab", H, B, H, precision=_HI)
    core = core + jnp.eye(T, dtype=B.dtype)[:, :, None, None] * L
    return _blocks_to_matrix(core)


def joint_cov(
    T: int,
    S: jax.Array,
    A: jax.Array,
    G: jax.Array,
    H: jax.Array,
    L: jax.Array,
) -> jax.Array:
    """Full ``(T*(d+l), T*(d+l))`` covariance of ``(Z_1..Z_T, X_1..X_T)``.

    Reference ``CC`` (marginalizable_state_space_model.py:259-291); blocks are
    computed once and reused for the ZZ / ZX / XX quadrants.
    """
    S, A, G, H, L = map(jnp.atleast_2d, (S, A, G, H, L))
    B = latent_cov_blocks(T, S, A, G)
    CZZ = _blocks_to_matrix(B)
    CZX = _blocks_to_matrix(jnp.einsum("ijab,bl->ijal", B, H, precision=_HI))
    XXb = jnp.einsum("ka,ijkl,lb->ijab", H, B, H, precision=_HI)
    XXb = XXb + jnp.eye(T, dtype=B.dtype)[:, :, None, None] * L
    CXX = _blocks_to_matrix(XXb)
    top = jnp.concatenate([CZZ, CZX], axis=1)
    bot = jnp.concatenate([CZX.T, CXX], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def joint_moments(
    T: int,
    m: jax.Array,
    S: jax.Array,
    A: jax.Array,
    G: jax.Array,
    H: jax.Array,
    L: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """(mean, cov) of the stacked joint vector — one call per (cluster, T)."""
    return joint_mean(T, m, A, H), joint_cov(T, S, A, G, H, L)


def observed_moments(
    T: int,
    m: jax.Array,
    S: jax.Array,
    A: jax.Array,
    G: jax.Array,
    H: jax.Array,
    L: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """(mean, cov) of the stacked observed vector (hidden states marginalized
    out analytically) — backs the observed-only inference family
    (marginalizable_mixture_model.py:997-1165)."""
    return observed_mean(T, m, A, H), observed_cov(T, S, A, G, H, L)
