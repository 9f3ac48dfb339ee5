"""Function-level L0 API of the marginalizable state-space kernel layer.

NumPy-in / NumPy-out re-exports of the device kernels under the reference's
module-level names and signatures (framework/marginalizable_state_space_model
.py), so code written against the reference's ``statespace`` module runs
against the JAX implementation unchanged.  Greek-letter parameter
names (Γ, Λ) are kept for keyword-call compatibility.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from multimodal_trajectory_modeling_tpu import ops

__all__ = [
    "mmZ",
    "mmX",
    "mm",
    "CZZ",
    "CZX",
    "CXX",
    "CC",
    "full_log_prob",
    "composite_log_prob",
    "hidden_log_prob",
    "composite_hidden_log_prob",
    "observed_log_prob",
    "full_marginalizable_log_prob",
    "multivariate_normal_log_likelihood",
    "marginalizable_gaussian_log_prob",
    "sample_trajectory",
    "sample_nonlinear_nongaussian_trajectory",
]


def _dt():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _j(a):
    return jnp.asarray(np.asarray(a, dtype=float), _dt())


def mmZ(T: int, m, A) -> np.ndarray:
    """Stacked latent mean (reference statespace:294-314)."""
    A = np.atleast_2d(A)
    m = np.atleast_1d(m)
    return np.asarray(ops.latent_means(T, _j(m), _j(A))).ravel()


def mmX(T: int, m, A, H) -> np.ndarray:
    """Stacked observed mean (reference statespace:317-339)."""
    A, H = map(np.atleast_2d, (A, H))
    m = np.atleast_1d(m)
    return np.asarray(ops.observed_mean(T, _j(m), _j(A), _j(H)))


def mm(T: int, m, A, H) -> np.ndarray:
    """Stacked joint mean (reference statespace:342-364)."""
    A, H = map(np.atleast_2d, (A, H))
    m = np.atleast_1d(m)
    return np.asarray(ops.joint_mean(T, _j(m), _j(A), _j(H)))


def CZZ(T: int, S, A, Γ) -> np.ndarray:
    """Latent-chain covariance (reference statespace:108-133)."""
    S, A, Γ = map(np.atleast_2d, (S, A, Γ))
    return np.asarray(ops.latent_cov(T, _j(S), _j(A), _j(Γ)))


def CZX(T: int, S, A, Γ, H) -> np.ndarray:
    """Latent-observed cross covariance (reference ``_CZX``,
    statespace:136-166)."""
    S, A, Γ, H = map(np.atleast_2d, (S, A, Γ, H))
    blocks = ops.latent_cov_blocks(T, _j(S), _j(A), _j(Γ))
    czx = jnp.einsum("ijab,bl->ijal", blocks, _j(H))
    Tn, _, d, l = czx.shape
    return np.asarray(czx.transpose(0, 2, 1, 3).reshape(Tn * d, Tn * l))


def CXX(T: int, S, A, Γ, H, Λ) -> np.ndarray:
    """Observed-process covariance (reference statespace:225-256)."""
    S, A, Γ, H, Λ = map(np.atleast_2d, (S, A, Γ, H, Λ))
    return np.asarray(
        ops.observed_cov(T, _j(S), _j(A), _j(Γ), _j(H), _j(Λ))
    )


def CC(T: int, S, A, Γ, H, Λ) -> np.ndarray:
    """Full joint covariance (reference statespace:259-291)."""
    S, A, Γ, H, Λ = map(np.atleast_2d, (S, A, Γ, H, Λ))
    return np.asarray(ops.joint_cov(T, _j(S), _j(A), _j(Γ), _j(H), _j(Λ)))


def _pack(z, x):
    z, x = map(np.atleast_3d, (z, x))
    n = z.shape[1]
    return np.concatenate(
        [
            z.transpose(1, 0, 2).reshape(n, -1),
            x.transpose(1, 0, 2).reshape(n, -1),
        ],
        axis=1,
    )


def full_log_prob(z, x, T, m, S, A, Γ, H, Λ) -> np.ndarray:
    """Joint log-pdf via analytic moments (reference statespace:367-426)."""
    v = _pack(z, x)
    return np.asarray(
        ops.mvn_logpdf(_j(v), _j(mm(T, m, A, H)), _j(CC(T, S, A, Γ, H, Λ)))
    )


def composite_log_prob(z, x, T, m, S, A, Γ, H, Λ) -> np.ndarray:
    """Joint log-pdf via the generative factorization (reference
    statespace:429-496)."""
    z, x = map(np.atleast_3d, (z, x))
    S, A, Γ, H, Λ = map(np.atleast_2d, (S, A, Γ, H, Λ))
    m = np.atleast_1d(m)
    lp = np.asarray(ops.mvn_logpdf(_j(z[0]), _j(m), _j(S)))
    zero_d = np.zeros(A.shape[0])
    zero_l = np.zeros(Λ.shape[0])
    for t in range(T - 1):
        lp = lp + np.asarray(
            ops.mvn_logpdf(_j(z[t + 1] - z[t] @ A), _j(zero_d), _j(Γ))
        )
    for t in range(T):
        lp = lp + np.asarray(
            ops.mvn_logpdf(_j(x[t] - z[t] @ H), _j(zero_l), _j(Λ))
        )
    return lp


def hidden_log_prob(z, T, m, S, A, Γ) -> np.ndarray:
    """Latent-chain log-pdf via analytic moments (reference
    statespace:499-540)."""
    z = np.atleast_3d(z)
    n = z.shape[1]
    v = z.transpose(1, 0, 2).reshape(n, -1)
    return np.asarray(
        ops.masked_mvn_logpdf(_j(v), _j(mmZ(T, m, A)), _j(CZZ(T, S, A, Γ)))
    )


def composite_hidden_log_prob(z, T, m, S, A, Γ) -> np.ndarray:
    """Latent-chain log-pdf via factorization (reference statespace:543-594).
    """
    z = np.atleast_3d(z)
    S, A, Γ = map(np.atleast_2d, (S, A, Γ))
    m = np.atleast_1d(m)
    lp = np.asarray(ops.mvn_logpdf(_j(z[0]), _j(m), _j(S)))
    zero_d = np.zeros(A.shape[0])
    for t in range(T - 1):
        lp = lp + np.asarray(
            ops.mvn_logpdf(_j(z[t + 1] - z[t] @ A), _j(zero_d), _j(Γ))
        )
    return lp


def observed_log_prob(x, T, m, S, A, Γ, H, Λ) -> np.ndarray:
    """Observed-process log-pdf, hidden states marginalized analytically
    (reference statespace:597-651)."""
    x = np.atleast_3d(x)
    n = x.shape[1]
    v = x.transpose(1, 0, 2).reshape(n, -1)
    return np.asarray(
        ops.masked_mvn_logpdf(
            _j(v), _j(mmX(T, m, A, H)), _j(CXX(T, S, A, Γ, H, Λ))
        )
    )


def full_marginalizable_log_prob(z, x, T, m, S, A, Γ, H, Λ) -> np.ndarray:
    """Joint log-pdf with per-instance exact marginalization of non-finite
    coordinates (reference statespace:654-725)."""
    v = _pack(z, x)
    patterns, pid = ops.pattern_groups(v)
    return np.asarray(
        ops.masked_mvn_logpdf_grouped(
            _j(v),
            _j(mm(T, m, A, H)),
            _j(CC(T, S, A, Γ, H, Λ)),
            jnp.asarray(patterns),
            jnp.asarray(pid),
        )
    )


def multivariate_normal_log_likelihood(x, μ, Σ, p=None) -> np.ndarray:
    """The reference hot kernel (statespace:728-773): per-row masked Gaussian
    log-likelihood.  ``p`` (the guvectorize output buffer) is accepted for
    signature compatibility; it is filled and returned."""
    x = np.atleast_2d(np.asarray(x, dtype=float))
    Σ = np.atleast_2d(Σ)
    μ = np.atleast_1d(μ)
    patterns, pid = ops.pattern_groups(x)
    out = np.asarray(
        ops.masked_mvn_logpdf_grouped(
            _j(x), _j(μ), _j(Σ), jnp.asarray(patterns), jnp.asarray(pid)
        ),
        dtype=float,
    )
    if p is not None:
        np.asarray(p)[...] = out
    return out


def marginalizable_gaussian_log_prob(x, μ=None, Σ=None) -> np.ndarray:
    """Masked Gaussian log-pdf with identity/zero defaults (reference
    statespace:908-943)."""
    x = np.atleast_2d(np.asarray(x, dtype=float))
    d = x.shape[1]
    μ = np.zeros(d) if μ is None else np.atleast_1d(μ)
    Σ = np.eye(d) if Σ is None else np.atleast_2d(Σ)
    return np.asarray(
        ops.masked_mvn_logpdf(_j(x), _j(μ), _j(Σ)), dtype=float
    )


def sample_trajectory(
    n: int,
    T: int,
    m,
    S,
    A,
    Γ,
    H,
    Λ,
    rng: np.random.Generator = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side LG-SSM sampler matching the reference's signature
    (statespace:776-836); uses a NumPy Generator for reproducibility."""
    if rng is None:
        rng = np.random.default_rng(42)
    S, A, Γ, H, Λ = map(np.atleast_2d, (S, A, Γ, H, Λ))
    m = np.atleast_1d(m)
    d, l = A.shape[0], H.shape[1]
    z = np.zeros((T, n, d))
    x = np.zeros((T, n, l))
    z[0] = rng.multivariate_normal(m, S, size=n)
    x[0] = z[0] @ H + rng.multivariate_normal(np.zeros(l), Λ, size=n)
    for t in range(T - 1):
        z[t + 1] = z[t] @ A + rng.multivariate_normal(np.zeros(d), Γ, size=n)
        x[t + 1] = z[t + 1] @ H + rng.multivariate_normal(
            np.zeros(l), Λ, size=n
        )
    return z, x


def sample_nonlinear_nongaussian_trajectory(
    n: int,
    dz: int,
    dx: int,
    T: int,
    m,
    f,
    Γ,
    h,
    Λ,
    rng: np.random.Generator = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side nonlinear/non-Gaussian sampler (reference
    statespace:839-905): ``m``/``Γ``/``Λ`` are callables (size, rng) →
    samples, ``f``/``h`` map single latent vectors."""
    if rng is None:
        rng = np.random.default_rng(42)
    z = np.zeros((T, n, dz))
    x = np.zeros((T, n, dx))
    z[0] = m(n, rng)
    x[0] = np.apply_along_axis(h, -1, z[0]) + Λ(n, rng)
    for t in range(T - 1):
        z[t + 1] = np.apply_along_axis(f, -1, z[t]) + Γ(n, rng)
        x[t + 1] = np.apply_along_axis(h, -1, z[t + 1]) + Λ(n, rng)
    return z, x
