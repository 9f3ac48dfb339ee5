"""Exact O(T) joint log-density for LG-SSM clusters via the Markov
factorization — the long-T path.

The cluster density the mixture E-step evaluates is the joint Gaussian of
``(z_{1:T}, x_{1:T})`` under

    z_1 ~ N(m, S),  z_{t+1} | z_t ~ N(z_t A, G),  x_t | z_t ~ N(z_t H, L)

(row-vector convention, matching :mod:`.samplers` / :mod:`.moments`).  The
reference materializes the ``(T(d+l))²`` joint covariance and evaluates a
dense masked quadratic form (marginalizable_state_space_model.py:268-370,
728-773) — O(T²) memory and O(T³) factor cost, the reference's scaling
wall in T.  For SUFFIX-ONLY missingness (per-row observed prefix length
``len_i``, the variable-length-trajectory case: every adapter dataset and
the synthetic benches) the chain rule factorizes the same density exactly:

    log p = log N(z_1; m, S)
          + Σ_{t<len-1} log N(z_{t+1}; z_t A, G)
          + Σ_{t<len}   log N(x_t; z_t H, L)

so the per-row cost is O(T·(d²+dl+l²)) with NO T×T matrices — exact (not
approximate) and equal to the dense path to floating-point reassociation.

GEMM formulation: expanding every quadratic form turns the whole sum into
ONE GEMM.  Per row accumulate masked Kronecker features over time —

    Φ1  = Σ_t  vm_t   · z_t ⊗ z_t          (d²)
    Φ0  =              z_0 ⊗ z_0           (d²)
    Φ2  = Σ_t  vm_{t+1} · z_t ⊗ z_t        (d²)
    Φc  = Σ_t  vm_{t+1} · z_t ⊗ z_{t+1}    (d²)
    Φx  = Σ_t  vm_t   · x_t ⊗ x_t          (l²)
    Φxz = Σ_t  vm_t   · z_t ⊗ x_t          (d·l)
    z_0, len, 1                             (d + 2)

(vm_t = [t < len]; for a suffix pattern the transition-pair validity
vm_t·vm_{t+1} equals vm_{t+1}, which is what makes the fold exact) — and
contract against a stacked per-cluster weight matrix ``W (F, C)`` built
from Cholesky inverses of S, G, L:

    scores (n, C) = [Φ1 Φ0 Φ2 Φc Φx Φxz z_0 len 1] @ W

with weights  Φ1: −½(H L⁻¹ Hᵀ + G⁻¹);  Φ0: −½(S⁻¹ − G⁻¹);
Φ2: −½(A G⁻¹ Aᵀ);  Φc: +A G⁻¹;  Φx: −½L⁻¹;  Φxz: +H L⁻¹;
z_0: S⁻¹ m;  len: −½((d+l)·log 2π + log|G| + log|L|);
1: −½(log|S| − log|G| + m S⁻¹ mᵀ).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

_LOG_2PI = math.log(2.0 * math.pi)


def _chol_inv_logdet(M: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Batched (C, k, k) -> (inverse, logdet) via Cholesky."""
    Lc = jnp.linalg.cholesky(M)
    k = M.shape[-1]
    eye = jnp.eye(k, dtype=M.dtype)
    inv = jax.vmap(lambda Lp: jax.scipy.linalg.cho_solve((Lp, True), eye))(
        Lc
    )
    logdet = 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(Lc, axis1=-2, axis2=-1)), axis=-1
    )
    return inv, logdet


def markov_cluster_weights_grouped(
    m: jax.Array,  # (C, d)
    S: jax.Array,  # (C, d, d)
    A: jax.Array,  # (C, d, d)
    G: jax.Array,  # (C, d, d)
    H: jax.Array,  # (C, d, l)
    L: jax.Array,  # (C, l, l)
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Per-mask-group feature weights:

    - ``W1 (C, d²+l²+dl)`` against per-step vm_t features [z⊗z, x⊗x, z⊗x]
    - ``W2 (C, 2d²)`` against vm_{t+1} features [z_t⊗z_t, z_t⊗z_{t+1}]
    - ``W3 (C, d²+d+2)`` against the end features [z_0⊗z_0, z_0, len, 1]

    (:func:`markov_cluster_weights` and :func:`markov_em_weights`
    concatenate them into one weight matrix).
    """
    C, d = m.shape
    l = H.shape[-1]
    Sinv, ldS = _chol_inv_logdet(S)
    Ginv, ldG = _chol_inv_logdet(G)
    Linv, ldL = _chol_inv_logdet(L)

    # full f32 precision: these products BECOME the E-score coefficients
    # — bf16-rounded weights put systematic 2⁻⁹ errors on every score
    # regardless of GEMM precision downstream (PARITY.md round-5)
    hi = jax.lax.Precision.HIGHEST
    HLH = jnp.einsum(
        "cda,cab,ceb->cde", H, Linv, H, precision=hi
    )  # H L⁻¹ Hᵀ (C, d, d)
    AGA = jnp.einsum("cda,cab,ceb->cde", A, Ginv, A, precision=hi)
    AG = jnp.einsum("cda,cab->cdb", A, Ginv, precision=hi)  # A G⁻¹
    HL = jnp.einsum("cda,cab->cdb", H, Linv, precision=hi)  # H L⁻¹
    Sm = jnp.einsum("cab,cb->ca", Sinv, m, precision=hi)  # S⁻¹ m (C, d)
    mSm = jnp.einsum("ca,ca->c", m, Sm, precision=hi)

    W1 = jnp.concatenate(
        [
            -0.5 * (HLH + Ginv).reshape(C, d * d),
            -0.5 * Linv.reshape(C, l * l),
            HL.reshape(C, d * l),
        ],
        axis=1,
    )
    W2 = jnp.concatenate(
        [-0.5 * AGA.reshape(C, d * d), AG.reshape(C, d * d)], axis=1
    )
    w_len = (-0.5 * ((d + l) * _LOG_2PI + ldG + ldL))[:, None]
    w_one = (-0.5 * (ldS - ldG + mSm))[:, None]
    W3 = jnp.concatenate(
        [-0.5 * (Sinv - Ginv).reshape(C, d * d), Sm, w_len, w_one], axis=1
    )
    return W1, W2, W3


def markov_cluster_weights(
    m: jax.Array,  # (C, d)
    S: jax.Array,  # (C, d, d)
    A: jax.Array,  # (C, d, d)
    G: jax.Array,  # (C, d, d)
    H: jax.Array,  # (C, d, l)
    L: jax.Array,  # (C, l, l)
) -> jax.Array:
    """Stacked feature weights ``W (F, C)``, F = 4d² + l² + dl + d + 2.

    Feature order matches :func:`markov_suffix_logliks`' accumulation:
    [Φ1, Φ0, Φ2, Φc, Φx, Φxz, z_0, len, 1].
    """
    C, d = m.shape
    l = H.shape[-1]
    W1, W2, W3 = markov_cluster_weights_grouped(m, S, A, G, H, L)
    dd = d * d
    w_phi1 = W1[:, :dd]
    w_phix = W1[:, dd : dd + l * l]
    w_phixz = W1[:, dd + l * l :]
    w_phi2 = W2[:, :dd]
    w_phic = W2[:, dd:]
    w_phi0 = W3[:, :dd]
    rest = W3[:, dd:]  # [Sm, len, 1]
    return jnp.concatenate(
        [w_phi1, w_phi0, w_phi2, w_phic, w_phix, w_phixz, rest], axis=1
    ).T  # (F, C)


@functools.partial(jax.jit, static_argnames=())
def markov_suffix_logliks(
    z: jax.Array,  # (T, n, d) NaN beyond each row's length
    x: jax.Array,  # (T, n, l) NaN beyond each row's length
    lens: jax.Array,  # (n,) int32 observed prefix lengths (1..T)
    W: jax.Array,  # (F, C) from markov_cluster_weights
) -> jax.Array:
    """``(C, n)`` joint log-densities, O(T) time and memory.

    Exactly the dense masked-Gaussian values
    (:func:`..ops.gaussian.masked_mvn_logpdf_grouped` on the assembled
    joint moments) whenever each row's missingness is a pure suffix; rows
    with interior missingness are OUT OF CONTRACT — use the dense path.
    """
    T, n, d = z.shape
    l = x.shape[-1]
    dtype = z.dtype
    zm = jnp.where(jnp.isfinite(z), z, 0.0)
    xm = jnp.where(jnp.isfinite(x), x, 0.0)
    tgrid = jnp.arange(T, dtype=lens.dtype)
    vm_next = (tgrid[:, None] + 1 < lens[None, :]).astype(dtype)  # (T, n)
    zm_vmn = zm * vm_next[:, :, None]

    # slice-pair formulation: every Kronecker-sum feature is
    # Σ_t A[:, :, a] ⊙ B[:, :, b] reduced over t — (T, n) operands keep
    # the batch on the lane axis (a "tnd,tne->nde" einsum lane-pads the
    # tiny trailing dims ~25× and a lax.scan of outer products compiles
    # slowly; this compiles in seconds)
    def pair(a, b):  # Σ_t a_t ⊗ b_t per row → (n, p·q)
        return jnp.stack(
            [
                jnp.sum(a[:, :, i] * b[:, :, j], axis=0)
                for i in range(a.shape[2])
                for j in range(b.shape[2])
            ],
            axis=1,
        )

    z0 = zm[0]
    feats = jnp.concatenate(
        [
            pair(zm, zm),  # Φ1
            (z0[:, :, None] * z0[:, None, :]).reshape(n, -1),  # Φ0
            pair(zm_vmn, zm),  # Φ2
            pair(zm[:-1], zm[1:]),  # Φc
            pair(xm, xm),  # Φx
            pair(zm, xm),  # Φxz
            z0,
            lens.astype(dtype)[:, None],
            jnp.ones((n, 1), dtype),
        ],
        axis=1,
    )  # (n, F)
    with jax.default_matmul_precision("highest"):  # see regression._HI
        return (feats @ W).T  # (C, n)


def suffix_lengths(valid_t: jax.Array) -> jax.Array:
    """Per-row prefix length from a (T, n) validity mask; asserts nothing —
    callers guarantee suffix structure (see :func:`is_suffix_mask`)."""
    return jnp.sum(valid_t.astype(jnp.int32), axis=0)


def is_suffix_mask(valid_t) -> bool:
    """True iff every column of the (T, n) validity mask is a contiguous
    prefix of True — the contract for the O(T) factorized path."""
    import numpy as np

    v = np.asarray(valid_t, dtype=bool)
    lens = v.sum(axis=0)
    expect = np.arange(v.shape[0])[:, None] < lens[None, :]
    return bool(np.array_equal(v, expect))


def markov_em_feature_dim(d: int, l: int) -> int:
    """F for the fused EM feature vector g (see markov_phi kernel):
    [g1 zzΣ, g2 zzΣ·vm⁺, g3 z⊗znΣ, g4 xxΣ, g5 zxΣ, g6 zz0, g7 Σvm⁺z,
    g8 Σz, g9 Σx, g10 z0, g11 len, g12 1]."""
    return 4 * d * d + l * l + d * l + 2 * d + l + d + 2


def markov_em_weights(
    m: jax.Array,
    S: jax.Array,
    A: jax.Array,
    G: jax.Array,
    H: jax.Array,
    L: jax.Array,
) -> jax.Array:
    """E-score weights over the fused EM feature vector: ``(C, F)`` with
    zeros on the M-only linear-sum slots (g7, g8, g9)."""
    C, d = m.shape
    l = H.shape[-1]
    W1, W2, W3 = markov_cluster_weights_grouped(m, S, A, G, H, L)
    dd = d * d
    zeros = jnp.zeros((C, 2 * d + l), W1.dtype)
    return jnp.concatenate(
        [
            W1[:, :dd],  # g1
            W2[:, :dd],  # g2
            W2[:, dd:],  # g3
            W1[:, dd : dd + l * l],  # g4
            W1[:, dd + l * l :],  # g5
            W3[:, :dd],  # g6
            zeros,  # g7, g8, g9
            W3[:, dd : dd + d],  # g10 (S⁻¹m)
            W3[:, dd + d : dd + d + 1],  # g11 (len)
            W3[:, dd + d + 1 :],  # g12 (const)
        ],
        axis=1,
    )


def markov_em_features(
    z: jax.Array,  # (T, n, d) NaN beyond each row's length
    x: jax.Array,  # (T, n, l)
    lens: jax.Array,  # (n,) int32
) -> jax.Array:
    """Per-row fused-EM feature matrix ``(n, F)`` in the g-layout of
    :func:`markov_em_weights` — the plain reference features, and (transposed)
    the canonical-layout Φ of any T.

    Formulated as (T, n) slice-pair products reduced over t (batch on
    the lane axis): a ``lax.scan`` of outer products compiles slowly, and
    a ``"tnd,tne->nde"`` einsum lane-pads the tiny trailing dims ~25×.
    NaN→0 sanitization makes most validity masks implicit (zeroed steps
    contribute nothing); only the g2/g7 vm_{t+1}-masked z_t terms need
    the explicit shifted mask."""
    T, n, d = z.shape
    l = x.shape[-1]
    dtype = z.dtype
    zm = jnp.where(jnp.isfinite(z), z, 0.0)
    xm = jnp.where(jnp.isfinite(x), x, 0.0)
    tgrid = jnp.arange(T, dtype=lens.dtype)
    vm_next = (tgrid[:, None] + 1 < lens[None, :]).astype(dtype)  # (T, n)
    zm_vmn = zm * vm_next[:, :, None]

    def pair(a, b):  # Σ_t a_t ⊗ b_t per row → (n, p·q)
        return jnp.stack(
            [
                jnp.sum(a[:, :, i] * b[:, :, j], axis=0)
                for i in range(a.shape[2])
                for j in range(b.shape[2])
            ],
            axis=1,
        )

    g1 = pair(zm, zm)
    g2 = pair(zm_vmn, zm)
    g3 = pair(zm[:-1], zm[1:])
    g4 = pair(xm, xm)
    g5 = pair(zm, xm)
    g7 = jnp.sum(zm_vmn, axis=0)
    g8 = jnp.sum(zm, axis=0)
    g9 = jnp.sum(xm, axis=0)
    z0 = zm[0]
    zz0 = (z0[:, :, None] * z0[:, None, :]).reshape(n, -1)
    return jnp.concatenate(
        [
            g1,
            g2,
            g3,
            g4,
            g5,
            zz0,
            g7,
            g8,
            g9,
            z0,
            lens.astype(dtype)[:, None],
            jnp.ones((n, 1), dtype),
        ],
        axis=1,
    )
