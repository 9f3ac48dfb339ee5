"""O(T) Kalman-filter marginal log-likelihood of the OBSERVATIONS —
the long-T path for x-only inference.

The x-marginal of the LG-SSM is a hidden-Markov Gaussian: unlike the
joint (z, x) density (which factorizes directly, :mod:`.markov`), it
requires integrating the latent chain — the classic Kalman prediction
-error decomposition

    log p(x_{1:len}) = Σ_t log N(x_t; μ_t H, H' P_t H + L)

with the predictive moments (μ_t, P_t) updated by the filter recursions.
The reference evaluates this by materializing the (T·l)² observed
covariance and a masked dense quadratic form (observed moments ``mmX`` /
``CXX``: marginalizable_state_space_model.py:186-257, consumed by
``observed_condl_log_lik_first_T0_steps``,
marginalizable_mixture_model.py:997-1048, through the numba hot loop
:728-773) — O(T²) memory; the filter is O(T) and exact.

Accelerator shape: the covariance-side recursion (P_t, innovation inverses,
gains) is DATA-INDEPENDENT — one ``lax.scan`` over T of (d, d) algebra
per cluster.  The per-row work is then only the mean/innovation chain:
a second scan over T whose carry is the (n, d) predictive-mean batch and
whose per-step ops are small GEMMs — O(T·n·(d² + dl)) total, no T×T
matrices, suffix-masked per row via the length vector.

Row-vector convention (matching :mod:`.samplers`):
``z_{t+1} = z_t A + w (w ~ N(0, G))``, ``x_t = z_t H + v (v ~ N(0, L))``,
``z_1 ~ N(m, S)``; equivalently column-form transition ``F = Aᵀ``,
observation ``Hᵀ``.  Update: ``μ⁺ = μ + e Kᵀ`` with gain
``K = P H S⁻¹``; ``P⁺ = P − K Hᵀ P``; predict ``P' = Aᵀ P⁺ A + G``
(symmetrized each step against f32 drift).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

_LOG_2PI = math.log(2.0 * math.pi)

__all__ = [
    "kalman_observed_logliks",
    "kalman_filter_covs",
    "kalman_masked_logliks",
]


def kalman_filter_covs(
    S: jax.Array,  # (d, d) initial state cov
    A: jax.Array,  # (d, d) row-form transition
    G: jax.Array,  # (d, d) transition cov
    H: jax.Array,  # (d, l) row-form observation map
    L: jax.Array,  # (l, l) observation cov
    T: int,
):
    """Data-independent filter quantities, stacked over time:
    ``(K (T, d, l), Sinv (T, l, l), logdet (T,))`` — gains, innovation
    inverses and log-determinants for t = 1..T."""

    def step(P, _):
        # full f32 matmul precision: the covariance recursion compounds
        # over T and P_post subtracts near-equal terms (see
        # ops.regression._HI / PARITY.md round-5 finding)
        with jax.default_matmul_precision("highest"):
            Sin = H.T @ P @ H + L  # (l, l) innovation cov
            Lc = jnp.linalg.cholesky(Sin)
            Sinv = jax.scipy.linalg.cho_solve(
                (Lc, True), jnp.eye(L.shape[0], dtype=P.dtype)
            )
            logdet = 2.0 * jnp.sum(jnp.log(jnp.diag(Lc)))
            K = P @ H @ Sinv  # (d, l)
            P_post = P - K @ H.T @ P
            P_next = A.T @ P_post @ A + G
            P_next = 0.5 * (P_next + P_next.T)
        return P_next, (K, Sinv, logdet)

    _, (K, Sinv, logdet) = jax.lax.scan(step, S, None, length=T)
    return K, Sinv, logdet


@jax.jit
def kalman_observed_logliks(
    x: jax.Array,  # (T, n, l) NaN beyond each row's length
    lens: jax.Array,  # (n,) int32 observed prefix lengths
    m: jax.Array,  # (C, d)
    S: jax.Array,  # (C, d, d)
    A: jax.Array,  # (C, d, d)
    G: jax.Array,  # (C, d, d)
    H: jax.Array,  # (C, d, l)
    L: jax.Array,  # (C, l, l)
) -> jax.Array:
    """``(C, n)`` marginal log-densities ``log p(x_{1:len_i})`` per
    cluster — exactly the dense observed-moments masked-Gaussian values
    for suffix missingness, in O(T) time and memory."""
    T, n, l = x.shape
    dtype = jnp.result_type(x.dtype, m.dtype)  # see kalman_masked_logliks
    x = x.astype(dtype)
    m, S, A, G, H, L = (
        arr.astype(dtype) for arr in (m, S, A, G, H, L)
    )
    xm = jnp.where(jnp.isfinite(x), x, 0.0)
    tgrid = jnp.arange(T, dtype=lens.dtype)
    vm = (tgrid[:, None] < lens[None, :]).astype(dtype)  # (T, n)

    def one_cluster(mc, Sc, Ac, Gc, Hc, Lc):
        K, Sinv, logdet = kalman_filter_covs(Sc, Ac, Gc, Hc, Lc, T)

        def step(carry, inp):
            mu, ll = carry  # (n, d), (n,)
            x_t, vm_t, K_t, Sinv_t, logdet_t = inp
            with jax.default_matmul_precision("highest"):
                e = x_t - mu @ Hc  # (n, l) innovation
            quad = jnp.einsum(
                "nl,lk,nk->n", e, Sinv_t, e,
                precision=jax.lax.Precision.HIGHEST,
            )
            # mask BEFORE adding: vm_t * quad would be 0*inf = NaN if an
            # expansive closed-loop recursion overflows mu on steps past
            # a short row's lens (the row's true prefix marginal is
            # still finite)
            ll = ll + jnp.where(
                vm_t > 0,
                (-0.5) * (l * _LOG_2PI + logdet_t + quad),
                0.0,
            )
            with jax.default_matmul_precision("highest"):
                mu_post = mu + e @ K_t.T
                # freeze the state past lens too — stops the post-lens
                # recursion from overflowing in the first place (the
                # masked steps contribute nothing either way)
                mu_next = jnp.where(
                    vm_t[:, None] > 0, mu_post @ Ac, mu
                )
            return (mu_next, ll), None

        mu0 = jnp.broadcast_to(mc[None, :], (n, mc.shape[0]))
        carry = (mu0, jnp.zeros((n,), dtype))
        (_, ll), _ = jax.lax.scan(step, carry, (xm, vm, K, Sinv, logdet))
        return ll

    return jax.vmap(one_cluster)(m, S, A, G, H, L)


def _list_chol(Smat, D):
    """Unrolled Cholesky of a D×D matrix held as nested lists of (n,)
    vectors — every op is a full-width elementwise op.  (XLA's batched
    ``linalg.cholesky`` on (n, D, D) arrays puts the D×D block on the
    tile's sublane×lane axes, wasting ~97% of each tile at D≈5 —
    measured 15.6 s vs ~ms for one T=64 filter pass at n=1e5.)

    Returns ``(L, invd)`` with ``invd[j] = 1/L[j][j]`` computed via one
    ``rsqrt`` per column (``L[j][j] = s·rsqrt(s)``) so the triangular
    solves below are division-free — the unrolled step algebra spends
    ~50 divides/step otherwise, each many times the cost of a
    multiply."""
    L = [[None] * D for _ in range(D)]
    invd = [None] * D
    for j in range(D):
        s = Smat[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        inv = jax.lax.rsqrt(s)
        L[j][j] = s * inv
        invd[j] = inv
        for i in range(j + 1, D):
            t = Smat[i][j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv
    return L, invd


def _fwd_solve(L, invd, b, D):
    """Solve ``L w = b`` (lower, unrolled; lists of lane vectors)."""
    w = []
    for i in range(D):
        t = b[i]
        for k in range(i):
            t = t - L[i][k] * w[k]
        w.append(t * invd[i])
    return w


def _bwd_solve(L, invd, y, D):
    """Solve ``Lᵀ x = y`` (unrolled)."""
    x = [None] * D
    for i in reversed(range(D)):
        t = y[i]
        for k in range(i + 1, D):
            t = t - L[k][i] * x[k]
        x[i] = t * invd[i]
    return x


def _tri_pack(P, d):
    """Nested full d×d list → row-major lower-triangle list (len
    d(d+1)/2)."""
    return [P[i][j] for i in range(d) for j in range(i + 1)]


def _tri_unpack(tri, d):
    """Lower-triangle list → nested full d×d list with the upper
    triangle ALIASED to the lower (same traced values, zero extra ops
    or storage — symmetry by construction)."""
    P = [[None] * d for _ in range(d)]
    k = 0
    for i in range(d):
        for j in range(i + 1):
            P[i][j] = tri[k]
            P[j][i] = tri[k]
            k += 1
    return P


def masked_filter_step(
    mu, P, z_t, x_t, oz_t, ox_t, Hs, As, Gs, Ls, d: int, l: int
):
    """One partial-observation filter step on generic LANE ARRAYS.

    The channel containers are plain Python lists — ``mu`` (d entries),
    ``P`` (d×d nested), ``z_t``/``oz_t`` (d), ``x_t``/``ox_t`` (l) — whose
    elements are identically-shaped arrays (``(n,)`` vectors in
    :func:`kalman_masked_logliks`).  Model parameters ``Hs/As/Gs/Ls``
    are nested Python lists of SCALARS (traced array scalars), so the
    unrolled algebra is independent of the array layout.

    Missing coordinates (``o* == 0``) are decoupled by zeroing the
    corresponding innovation rows/cols and planting unit dummy variances;
    only observed coordinates contribute to the 2π term.  Returns
    ``(mu_next, P_next, ll_delta)``.

    Masked entries are zeroed with ``where``-selects rather than
    mask-multiplies: bit-identical when the state is finite (the masks
    are exact 0/1), but ``0 · inf`` is NaN — an expansive transition can
    overflow the (mu, P) recursion across a long fully-unobserved tail
    in f32, and the selects keep the overflow from poisoning the
    (finite) likelihood of the observed prefix.  An overflow inside an
    interior gap that is *followed* by observations is a genuine
    representational limit either way (the density is astronomically
    peaked there).
    """
    D = d + l

    def msk(o, v):
        return jnp.where(o > 0, v, jnp.zeros_like(v))

    def msk2(oa, ob, v):
        return jnp.where((oa > 0) & (ob > 0), v, jnp.zeros_like(v))

    ozr, oxr = list(oz_t), list(ox_t)
    # PH (d×l), HPH (l×l) from the current P
    PH = [
        [sum(P[i][k] * Hs[k][b] for k in range(d)) for b in range(l)]
        for i in range(d)
    ]
    HPH = [
        [sum(Hs[k][a] * PH[k][b] for k in range(d)) for b in range(l)]
        for a in range(l)
    ]
    # innovation covariance Σ (D×D) with unit dummies
    Sig = [[None] * D for _ in range(D)]
    for a_ in range(d):
        for b_ in range(d):
            Sig[a_][b_] = msk2(ozr[a_], ozr[b_], P[a_][b_])
        Sig[a_][a_] = Sig[a_][a_] + (1.0 - ozr[a_])
    for a_ in range(d):
        for b_ in range(l):
            v = msk2(ozr[a_], oxr[b_], PH[a_][b_])
            Sig[a_][d + b_] = v
            Sig[d + b_][a_] = v
    for a_ in range(l):
        for b_ in range(l):
            Sig[d + a_][d + b_] = msk2(
                oxr[a_], oxr[b_], HPH[a_][b_] + Ls[a_][b_]
            )
        Sig[d + a_][d + a_] = Sig[d + a_][d + a_] + (1.0 - oxr[a_])

    # innovation (masked coords -> 0 exactly)
    mux = [sum(mu[i] * Hs[i][b] for i in range(d)) for b in range(l)]
    e = [msk(ozr[a_], z_t[a_] - mu[a_]) for a_ in range(d)] + [
        msk(oxr[b_], x_t[b_] - mux[b_]) for b_ in range(l)
    ]

    Lch, invd = _list_chol(Sig, D)
    w = _fwd_solve(Lch, invd, e, D)
    logdet = sum(jnp.log(Lch[i][i]) for i in range(D)) * 2.0
    quad = sum(wi * wi for wi in w)
    nobs = sum(ozr) + sum(oxr)
    ll_delta = -0.5 * (logdet + quad + nobs * _LOG_2PI)

    # gain K = P M Σ⁻¹ (d×D); PM = [P·diag(oz), PH·diag(ox)]
    PM = [
        [msk(ozr[a_], P[i][a_]) for a_ in range(d)]
        + [msk(oxr[b_], PH[i][b_]) for b_ in range(l)]
        for i in range(d)
    ]
    K = []
    for i in range(d):
        yi = _fwd_solve(Lch, invd, PM[i], D)
        K.append(_bwd_solve(Lch, invd, yi, D))
    mu_post = [
        mu[i] + sum(e[a_] * K[i][a_] for a_ in range(D)) for i in range(d)
    ]
    P_post = [
        [
            P[i][j] - sum(K[i][a_] * PM[j][a_] for a_ in range(D))
            for j in range(d)
        ]
        for i in range(d)
    ]
    # predict (row convention: z' = z A + w)
    mu_next = [
        sum(mu_post[i] * As[i][j] for i in range(d)) for j in range(d)
    ]
    AP = [
        [sum(As[k][i] * P_post[k][j] for k in range(d)) for j in range(d)]
        for i in range(d)
    ]
    P_next = [
        [
            sum(AP[i][k] * As[k][j] for k in range(d)) + Gs[i][j]
            for j in range(d)
        ]
        for i in range(d)
    ]
    P_next = [
        [0.5 * (P_next[i][j] + P_next[j][i]) for j in range(d)]
        for i in range(d)
    ]
    return mu_next, P_next, ll_delta


def _masked_gauss_update(mu, P, e_raw, Sig_raw, PM_raw, o, q, d):
    """Condition the state ``(mu, P)`` on one masked q-dim observation
    block, entirely on generic lane arrays (see
    :func:`masked_filter_step` for the container convention).

    ``e_raw`` (q) is the unmasked innovation, ``Sig_raw`` (q×q, only the
    lower triangle is read) its unmasked covariance, ``PM_raw`` (d×q)
    the unmasked state↔observation cross-covariance, ``o`` (q) the 0/1
    observation masks.  Masked coordinates are decoupled by the
    unit-dummy trick (zero rows/cols via ``where``-selects, unit
    diagonal, excluded from the 2π count) — exactly the dropped-
    coordinate Gaussian marginal.

    The gain is applied in Cholesky-factored form: with
    ``Σ = L Lᵀ``, ``U_i = L⁻¹ (PM row i)`` and ``w = L⁻¹ e`` give
    ``μ⁺ = μ + Uᵀw`` and ``P⁺ = P − UᵀU`` — no backward solves, and the
    posterior covariance is computed on the lower triangle only (the
    upper is aliased), which is both cheaper than the explicit-gain
    form and exactly symmetric by construction.

    Returns ``(mu_c, P_c, ll_delta)`` with ``P_c`` lower-aliased.
    """

    def msk(oa, v):
        return jnp.where(oa > 0, v, jnp.zeros_like(v))

    def msk2(oa, ob, v):
        return jnp.where((oa > 0) & (ob > 0), v, jnp.zeros_like(v))

    Sig = [[None] * q for _ in range(q)]
    for a in range(q):
        for b in range(a):
            Sig[a][b] = msk2(o[a], o[b], Sig_raw[a][b])
        Sig[a][a] = msk(o[a], Sig_raw[a][a]) + (1.0 - o[a])
    Lch, invd = _list_chol(Sig, q)
    e = [msk(o[a], e_raw[a]) for a in range(q)]
    w = _fwd_solve(Lch, invd, e, q)
    quad = sum(wi * wi for wi in w)
    logdet = 2.0 * sum(jnp.log(Lch[a][a]) for a in range(q))
    nobs = sum(o)
    ll_delta = -0.5 * (logdet + quad + nobs * _LOG_2PI)

    U = [
        _fwd_solve(
            Lch, invd, [msk(o[a], PM_raw[i][a]) for a in range(q)], q
        )
        for i in range(d)
    ]
    mu_c = [
        mu[i] + sum(w[a] * U[i][a] for a in range(q)) for i in range(d)
    ]
    P_c = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            v = P[i][j] - sum(U[i][a] * U[j][a] for a in range(q))
            P_c[i][j] = v
            P_c[j][i] = v
    return mu_c, P_c, ll_delta


def _seq_z_conditioning(mu, P, z_t, oz_t, d: int):
    """Condition the state ``(mu, P)`` on the OBSERVED z coordinates by
    sequential scalar conditioning — one coordinate at a time, exact
    chain rule ``p(z_{o1}) · p(z_{o2} | z_{o1}) · …`` on the running
    moments.  Because each observed coordinate is a NOISELESS scalar
    observation of the state itself, the per-coordinate update needs no
    Cholesky and no triangular solves:

        s   = P[a][a]            (predictive variance of z_a)
        k_i = P[i][a] / s        (scalar gain column)
        μ  += k · (z_a − μ_a);   P −= k kᵀ s   (rank-1 downdate)
        ll += −½ (log s + e²/s + log 2π)       (if observed)

    — ~200 lane-ops at d=5 vs ~315 for the joint masked-Cholesky form
    (:func:`_masked_gauss_update` with q=d), identical in exact
    arithmetic (the joint form's L factor IS this recursion).

    Masking/robustness: gains and innovations are ``where``-selected to
    exact 0 on unobserved coordinates (an unobserved coordinate's update
    is a structural no-op), and the P row is pre-selected so an
    overflowed (inf) state entry on a masked lane cannot poison the
    finite prefix via ``0 · inf`` (same contract as
    :func:`masked_filter_step`).  ``P`` may be lower-aliased; the
    returned ``P_c`` is lower-aliased.  Returns ``(mu_c, P_c, ll_z)``.
    """
    ll = None
    mu = list(mu)
    P = [[P[i][j] for j in range(d)] for i in range(d)]
    for a in range(d):
        o = oz_t[a]
        obs = o > 0
        pa = [
            jnp.where(obs, P[a][j], jnp.zeros_like(P[a][j]))
            for j in range(d)
        ]
        s = P[a][a]
        ri = jax.lax.rsqrt(s)  # division-free reciprocal (cf. _list_chol)
        inv = jnp.where(obs, ri * ri, jnp.zeros_like(s))
        e = jnp.where(obs, z_t[a] - mu[a], jnp.zeros_like(s))
        g = e * inv
        term = jnp.where(
            obs, jnp.log(s) + e * g + _LOG_2PI, jnp.zeros_like(s)
        )
        ll = term if ll is None else ll + term
        k = [pa[i] * inv for i in range(d)]
        for i in range(d):
            mu[i] = mu[i] + k[i] * e
        for i in range(d):
            for j in range(i + 1):
                v = P[i][j] - k[i] * pa[j]
                P[i][j] = v
                P[j][i] = v
    return mu, P, -0.5 * ll


def masked_filter_step_split(
    mu, P, z_t, x_t, oz_t, ox_t, Hs, As, Gs, Ls, d: int, l: int
):
    """Split-form masked filter step — the production replacement for
    :func:`masked_filter_step`'s combined (d+ℓ)-dim observation.

    Exact chain-rule factorization of the same per-step density:
    ``p(z_obs, x_obs | past) = p(z_obs | past) · p(x_obs | z_obs,
    past)`` — first condition the state on the observed z coordinates
    (sequential scalar conditioning, :func:`_seq_z_conditioning` — the
    z block's observation map is the identity, so no factorization is
    needed at all), then update on the observed x coordinates against
    the CONDITIONED moments (innovation covariance = masked HᵀP_cH + Λ,
    jointly via chol(ℓ) — the x noise Λ is correlated, so the x block
    keeps the masked-Cholesky form).  Block-Cholesky identity: the
    combined form's D×D factorization factors the z-block first and the
    x-block against its Schur complement, so logdet/quad split exactly
    into these two masked sub-problems.

    Same masking/robustness semantics as the combined step
    (``where``-selects, unit dummies on the x block, observed-coord 2π
    count) at ~2× fewer lane ops: the z block costs rank-1 downdates
    instead of chol(d) + d triangular solves, the factored U-form
    eliminates all backward solves, every covariance update touches the
    lower triangle only, and the predict step exploits symmetry (no
    0.5·(X+Xᵀ) resymmetrization — P stays exactly symmetric by
    aliasing).

    ``P`` may be lower-aliased (see :func:`_tri_unpack`); ``P_next`` is
    returned lower-aliased.  Reference semantics: the dense
    drop-rows/cols marginalization of
    marginalizable_state_space_model.py:741-773.
    """
    # phase 1: condition on observed z (observation map = identity)
    mu_c, P_c, ll_z = _seq_z_conditioning(mu, P, z_t, oz_t, d)

    # phase 2: update on observed x against the conditioned moments
    PH = [
        [sum(P_c[i][k] * Hs[k][b] for k in range(d)) for b in range(l)]
        for i in range(d)
    ]
    SigX = [[None] * l for _ in range(l)]
    for a in range(l):
        for b in range(a + 1):
            SigX[a][b] = (
                sum(Hs[k][a] * PH[k][b] for k in range(d)) + Ls[a][b]
            )
    mux = [sum(mu_c[i] * Hs[i][b] for i in range(d)) for b in range(l)]
    ex = [x_t[b] - mux[b] for b in range(l)]
    mu_p, P_p, ll_x = _masked_gauss_update(
        mu_c, P_c, ex, SigX, PH, ox_t, l, d
    )

    # predict (row convention: z' = z A + w); P_next symmetric by
    # construction — lower triangle only
    mu_next = [
        sum(mu_p[i] * As[i][j] for i in range(d)) for j in range(d)
    ]
    AP = [
        [sum(As[k][i] * P_p[k][j] for k in range(d)) for j in range(d)]
        for i in range(d)
    ]
    P_next = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            v = sum(AP[i][k] * As[k][j] for k in range(d)) + Gs[i][j]
            P_next[i][j] = v
            P_next[j][i] = v
    return mu_next, P_next, ll_z + ll_x


@jax.jit
def kalman_masked_logliks(
    z: jax.Array,  # (T, n, d) with arbitrary per-coordinate NaNs
    x: jax.Array,  # (T, n, l)
    m: jax.Array,  # (C, d)
    S: jax.Array,  # (C, d, d)
    A: jax.Array,  # (C, d, d)
    G: jax.Array,  # (C, d, d)
    H: jax.Array,  # (C, d, l)
    L: jax.Array,  # (C, l, l)
) -> jax.Array:
    """``(C, n)`` exact log-density of the OBSERVED entries of
    ``(z_{1:T}, x_{1:T})`` under ARBITRARY per-coordinate missingness —
    the O(T) chain-rule equivalent of the reference's dense
    drop-rows/cols marginalization
    (marginalizable_state_space_model.py:741-773), which builds the
    (T(d+l))² joint and is quadratic in T.

    Per step the combined observation vector is ``y_t = [z_t, x_t]``
    with map ``M = [I_d, H]`` and noise ``R = blockdiag(0, L)`` (state
    coordinates are noiseless observations of themselves).  Missing
    coordinates are decoupled by the standard masking trick — zero the
    corresponding columns of ``M`` and rows/cols of ``R``, plant a unit
    dummy variance, and count only observed coordinates in the 2π term —
    which reproduces the dropped-coordinate marginal exactly.  Unlike the
    suffix filter above, the innovation covariance is row-dependent, so
    the covariance recursion runs per (cluster, row).

    Accelerator shape: the small-matrix algebra is fully SCALARIZED —
    the state mean/covariance, gains, and the innovation Cholesky live
    as nested lists of (n,) vectors, so every operation is a full-width
    elementwise op and the per-row D×D factorizations cost O(D³)
    instance-parallel flops with no tile waste.

    Rows with no finite entry at all return exactly 0.0 (the reference's
    empty-marginal convention).  Requires a nonsingular step-wise
    innovation (positive-definite S on observed z-coords at t=1; the
    dense path's ``allow_singular`` escape hatch covers the degenerate
    corner).
    """
    T, n, d = z.shape
    l = x.shape[-1]
    D = d + l
    # one compute dtype for data AND parameters: a mixed call (f32 data,
    # f64 params under x64) would otherwise promote the scan carry
    # mid-step and fail the carry-type check
    dtype = jnp.result_type(z.dtype, m.dtype)
    z = z.astype(dtype)
    x = x.astype(dtype)
    m, S, A, G, H, L = (
        arr.astype(dtype) for arr in (m, S, A, G, H, L)
    )

    zc = jnp.where(jnp.isfinite(z), z, 0.0).transpose(0, 2, 1)  # (T, d, n)
    xc = jnp.where(jnp.isfinite(x), x, 0.0).transpose(0, 2, 1)  # (T, l, n)
    oz = jnp.isfinite(z).astype(dtype).transpose(0, 2, 1)
    ox = jnp.isfinite(x).astype(dtype).transpose(0, 2, 1)

    def one_cluster(mc, Sc, Ac, Gc, Hc, Lc):
        Hs = [[Hc[i, b] for b in range(l)] for i in range(d)]
        As = [[Ac[i, j] for j in range(d)] for i in range(d)]
        Gs = [[Gc[i, j] for j in range(d)] for i in range(d)]
        Ls = [[Lc[a, b] for b in range(l)] for a in range(l)]

        def step(carry, inp):
            mu, Ptri, ll = carry  # mu: d of (n,); Ptri: d(d+1)/2 of (n,)
            z_t, x_t, oz_t, ox_t = inp  # (d, n)/(l, n) slabs
            mu_next, P_next, dll = masked_filter_step_split(
                mu, _tri_unpack(Ptri, d),
                z_t, x_t, oz_t, ox_t, Hs, As, Gs, Ls, d, l,
            )
            return (mu_next, _tri_pack(P_next, d), ll + dll), None

        ones_n = jnp.ones((n,), dtype)
        mu0 = [mc[i] * ones_n for i in range(d)]
        P0 = [
            Sc[i, j] * ones_n for i in range(d) for j in range(i + 1)
        ]
        carry = (mu0, P0, jnp.zeros((n,), dtype))
        (_, _, ll), _ = jax.lax.scan(step, carry, (zc, xc, oz, ox))
        return ll

    return jax.vmap(one_cluster)(m, S, A, G, H, L)
