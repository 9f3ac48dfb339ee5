"""Materialized Markov EM features Φ and the per-iteration Φ pass.

Under suffix missingness every E score and every M sufficient statistic
of the Markov-factorized mixture (:mod:`.markov`) is a linear map of one
per-instance feature vector, and that vector does not depend on the
parameters.  So the trainers build the feature matrix Φ (features ×
instances) once per fit and every EM iteration is one pass over Φ:

    scores (C, n) = W (C, F) @ Φ (F, n)          → argmax, counts, switches
    stats  (F, C) = Φ (F, n) @ onehot(assign)ᵀ   → the closed-form M step

Both contractions run at exact float32 precision (``Precision.HIGHEST``:
no TF32 or bf16 products).  The statistics subtract nearly equal large
moments (normal-equations cancellation); reduced-precision products made
covariance estimates indefinite on wide-range data and collapsed EM
(PARITY.md "round-5 finding").

Two Φ row layouts exist:

- ``"compact"`` (:func:`markov_materialize_features`): the rows of the
  shift-product accumulator of :func:`markov_packed_spec` that some
  canonical feature references — T-independent, ~25% fewer rows than
  the canonical layout;
- ``"canonical"`` (:func:`markov_materialize_features_longT`): the
  g-layout of :func:`..markov.markov_em_weights`, built by the scan-free
  slice-pair builder for any T.

Φ may be stored int16-quantized (:class:`PhiQuant`); the pass converts
the payload to the compute dtype before its exact dots and folds the
per-row scales into the weights.

Reference semantics: the same per-row densities as the numba hot loop
(marginalizable_state_space_model.py:728-773) evaluated through the chain
rule instead of the dense joint covariance.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST

__all__ = [
    "PhiQuant",
    "dequantize_phi",
    "markov_compact_spec",
    "markov_em_from_features",
    "markov_em_from_features_multi",
    "markov_materialize_features",
    "markov_materialize_features_longT",
    "markov_packed_spec",
    "pack_markov_u",
    "phi_scale_from_absmax",
    "quantize_phi",
]


class PhiQuant(NamedTuple):
    """Symmetrically int16-quantized feature matrix Φ.

    ``phi ≈ scale[:, None] · q`` with one scale per feature ROW, chosen
    so the row's max-magnitude entry lands on ±32766.  Quantization
    error is uniform-ABSOLUTE per row (≤ scale/2 ≈ 1.5e-5 · row max) —
    ~30× tighter than bfloat16's relative 2⁻⁹ on the T-reduced
    shift-product features, whose per-row spread is small next to their
    magnitude — at the same 2 bytes/entry, so the per-iteration read of
    Φ halves vs f32.

    Consumers never build the dequantized (F, n) matrix: the Φ pass
    folds ``scale`` into the score weight columns (``wc·diag(scale)``)
    and un-folds it from the (F, C) statistics (``g = scale[:, None] ·
    g̃``) — exact linear algebra at (F, C) size, so the only
    approximation anywhere is the one storage rounding.  A NamedTuple
    (= pytree): passes through ``jit``/``while_loop`` boundaries
    wherever a plain Φ array does.
    """

    q: jax.Array  # (F_pad, n_pad) int16
    scale: jax.Array  # (F_pad,) compute dtype


def phi_scale_from_absmax(amax: jax.Array, dtype) -> jax.Array:
    """Per-row quantization scale from per-row max |Φ|.  Split out so
    data-parallel shards can ``lax.pmax`` their local absmax first and
    quantize with the GLOBAL scale — making sharded i16 storage
    bit-identical to the single-device :func:`quantize_phi`."""
    scale = jnp.where(amax > 0.0, amax, 1.0) * (1.0 / 32766.0)
    return scale.astype(dtype)


@jax.jit
def quantize_phi(phi: jax.Array, scale: jax.Array | None = None) -> PhiQuant:
    """Quantize a materialized Φ (rows = features, lanes = instances)
    to :class:`PhiQuant`.  One elementwise pass per fit.  All-zero rows
    (layout padding) get scale 1 so the reconstruction stays exact.
    Pass ``scale`` to override the per-row scales (shard_map callers use
    :func:`phi_scale_from_absmax` on a pmax-ed absmax)."""
    if scale is None:
        scale = phi_scale_from_absmax(jnp.max(jnp.abs(phi), axis=1), phi.dtype)
    q = jnp.round(phi * (1.0 / scale)[:, None]).astype(jnp.int16)
    return PhiQuant(q, scale.astype(phi.dtype))


def dequantize_phi(pq: PhiQuant) -> jax.Array:
    """Reconstruct the (rounded) wide Φ — test/diagnostic helper; the
    Φ pass folds ``scale`` into the weights instead."""
    return pq.scale[:, None] * pq.q.astype(pq.scale.dtype)


def markov_packed_spec(T: int, d: int, l: int):
    """Shift-product accumulator layout behind the compact Φ.

    Each per-t block of the batch is laid out on ``s = 8·ceil((d+l)/8)``
    rows (``[z_t; x_t; 0-pad]``), so a row shift by ``k`` pairs every
    row with its ``+k`` neighbour — intra-step products for ``k < d+l``
    and (t, t+1) transition products for ``k ≥ s-d+1`` — and the sum
    over t of each product array is a reduction over whole blocks.
    Every canonical feature is then one row of the stacked accumulator
    ``ACC`` (Facc, n):

    - ``A_k``  (per shift k in ``ks``):  Σ_t u[st+r]·u[st+r+k]
    - ``B_k``  (k < d):  same with the vm_{t+1} mask (g2)
    - ``F0_k`` (k < d):  t=0-only products (g6)
    - ``AID`` Σ_t u_t (g8/g9), ``AVM`` Σ_t vm_{t+1}·u_t (g7),
      ``U0`` = u_0 (g10), ``EXTRA`` = [len, 1, 0…]

    Returns ``(s, ks, Facc, rows)`` with ``rows[f]`` the ACC row holding
    canonical feature ``f`` (the g-layout of
    :func:`..markov.markov_em_weights`).  Duplicate canonical rows —
    e.g. the symmetric (i,j)/(j,i) pairs — share one ACC slot.
    """
    import numpy as np

    s = 8 * ((d + l + 7) // 8)
    ks = sorted(set(range(d + l)) | set(range(s - d + 1, s + d)))
    kpos = {k: i for i, k in enumerate(ks)}

    def A(k, r):
        return kpos[k] * s + r

    base_B = len(ks) * s
    base_F0 = base_B + d * s
    base_AID = base_F0 + d * s
    base_AVM = base_AID + s
    base_U0 = base_AVM + s
    base_EX = base_U0 + s
    Facc = base_EX + s

    rows = []
    pairs_d = [(i, j) for i in range(d) for j in range(d)]
    rows += [A(abs(i - j), min(i, j)) for i, j in pairs_d]  # g1
    rows += [base_B + abs(i - j) * s + min(i, j) for i, j in pairs_d]  # g2
    rows += [A(s + j - i, i) for i, j in pairs_d]  # g3
    rows += [
        A(abs(a - b), d + min(a, b))
        for a in range(l)
        for b in range(l)
    ]  # g4
    rows += [A(d + a - i, i) for i in range(d) for a in range(l)]  # g5
    rows += [base_F0 + abs(i - j) * s + min(i, j) for i, j in pairs_d]  # g6
    rows += [base_AVM + i for i in range(d)]  # g7
    rows += [base_AID + i for i in range(d)]  # g8
    rows += [base_AID + d + a for a in range(l)]  # g9
    rows += [base_U0 + i for i in range(d)]  # g10
    rows += [base_EX + 0, base_EX + 1]  # len, const
    return s, tuple(ks), Facc, np.asarray(rows, np.int64)


def pack_markov_u(
    z_t: jax.Array,  # (T·d, n) transposed latent batch (NaN-padded)
    x_t: jax.Array,  # (T·l, n)
    *,
    T: int,
    d: int,
    l: int,
    pad_to: int = 8192,
) -> jax.Array:
    """Interleave the batch per time step as ``[z_t; x_t; 0-pad]`` on
    ``s`` rows, NaN→0 sanitized, with the instance axis padded with
    zeros to a multiple of ``pad_to`` — the input of
    :func:`markov_materialize_features`.  Pad lanes become Φ columns
    that the Φ pass ignores (their incoming assignment is -1)."""
    s = 8 * ((d + l + 7) // 8)
    n = z_t.shape[1]
    z3 = z_t.reshape(T, d, n)
    x3 = x_t.reshape(T, l, n)
    z3 = jnp.where(jnp.isfinite(z3), z3, 0.0)
    x3 = jnp.where(jnp.isfinite(x3), x3, 0.0)
    parts = [z3, x3]
    if s > d + l:
        parts.append(jnp.zeros((T, s - d - l, n), z_t.dtype))
    u = jnp.concatenate(parts, axis=1).reshape(T * s, n)
    pad = (-n) % pad_to
    if pad:
        u = jnp.concatenate([u, jnp.zeros((T * s, pad), u.dtype)], axis=1)
    return u


def _packed_acc_build(u, lens, *, T: int, d: int, s: int, ks: tuple):
    """The (Facc, n) per-instance accumulator of :func:`markov_packed_spec`
    from the packed batch ``u`` (T·s, n) and per-instance lengths."""
    dtype = u.dtype
    Bn = u.shape[1]

    def shifted(k):
        if k == 0:
            return u
        return jnp.concatenate(
            [u[k:, :], jnp.zeros((k, Bn), dtype)], axis=0
        )

    def treduce(p):  # Σ over t of the per-t (s, n) blocks
        return jnp.sum(p.reshape(T, s, Bn), axis=0)

    def sblock_shift(a, k):  # (s, n) block shifted up by k, 0-fill
        if k == 0:
            return a
        return jnp.concatenate(
            [a[k:, :], jnp.zeros((k, Bn), dtype)], axis=0
        )

    # row s·t+r belongs to step t; the vm_{t+1}-masked statistics are
    # recovered algebraically from the unmasked sums minus the LAST
    # valid step's contribution (the only step where vm_{t+1} = 0 but
    # the data is nonzero)
    rowt = jax.lax.broadcasted_iota(jnp.int32, (T * s, Bn), 0) // s
    last_mask = (rowt + 1 == lens[None, :]).astype(dtype)
    ulast = treduce(u * last_mask)  # (s, n) last-step block

    a_groups = {k: treduce(u * shifted(k)) for k in ks}
    groups = [a_groups[k] for k in ks]  # A_k
    groups += [
        a_groups[k] - ulast * sblock_shift(ulast, k) for k in range(d)
    ]  # B_k = A_k − last-step products (intra rows)
    u0 = u[:s, :]
    groups += [u0 * u[k : k + s, :] for k in range(d)]  # F0_k
    aid = treduce(u)
    groups.append(aid)  # AID
    groups.append(aid - ulast)  # AVM = Σ vm_{t+1} u_t
    groups.append(u0)  # U0
    r_ex = jax.lax.broadcasted_iota(jnp.int32, (s, Bn), 0)
    extra = jnp.where(
        r_ex == 0,
        lens.astype(dtype)[None, :],
        jnp.where(r_ex == 1, jnp.ones((), dtype), jnp.zeros((), dtype)),
    )
    groups.append(extra)  # EXTRA: [len, 1, 0…]
    return jnp.concatenate(groups, axis=0)  # (Facc, n)


def markov_compact_spec(T: int, d: int, l: int):
    """Compact layout for MATERIALIZED per-instance features.

    The accumulator ``ACC`` of :func:`markov_packed_spec` is
    parameter-INDEPENDENT and its row count ``Facc`` does not grow with
    ``T``.  Only the rows that some canonical feature references ever
    carry weight; the rest exist purely as shift-layout padding.  This
    spec names that referenced subset, in ascending ACC order:

    - ``uniq``: the referenced ACC rows (``Fc`` of them),
    - ``pos``:  canonical feature ``f`` → its row in the compact layout,
    - ``Fc_pad``: ``Fc`` rounded up to a multiple of 8 rows.

    Dropping the never-referenced rows changes no arithmetic: their fold
    weights are exact zeros.
    """
    import numpy as np

    _s, _ks, _Facc, rows = markov_packed_spec(T, d, l)
    uniq = np.unique(rows)  # ascending — preserves ACC summation order
    Fc = int(uniq.shape[0])
    Fc_pad = 8 * ((Fc + 7) // 8)
    pos = np.searchsorted(uniq, rows).astype(np.int64)
    return Fc_pad, uniq, pos


def _feature_layout(T: int, d: int, l: int, layout: str):
    """(padded row count, canonical-feature→row map) for a Φ layout."""
    import numpy as np

    if layout == "compact":
        Fc_pad, _uniq, pos = markov_compact_spec(T, d, l)
        return Fc_pad, pos
    assert layout == "canonical", layout
    F = 4 * d * d + l * l + d * l + 2 * d + l + d + 2
    return 8 * ((F + 7) // 8), np.arange(F, dtype=np.int64)


def markov_materialize_features(
    u: jax.Array,  # (T·s, n_pad) from pack_markov_u
    lens: jax.Array,  # (n,) int32, n ≤ n_pad
    *,
    T: int,
    d: int,
    l: int,
    dtype=None,
    store_dtype=None,
) -> jax.Array:
    """Materialize the compact-layout features Φ (Fc_pad, n_pad).

    One O(T) elementwise pass over the packed batch: the shift-product
    accumulator of :func:`markov_packed_spec` over every instance, then
    a row gather of the referenced rows (:func:`markov_compact_spec`).
    Φ's row count is T-independent, so EM iterations driven from Φ
    (:func:`markov_em_from_features`) cost the same at any T.  Build
    once per fit, outside the EM loop.

    ``store_dtype`` (default: compute ``dtype``) stores Φ narrower —
    ``bfloat16`` halves the per-iteration read at a documented accuracy
    cost: scores AND M sufficient statistics then carry ~3-digit
    feature precision (opt-in only; the int16 :class:`PhiQuant` store is
    the accurate narrow format)."""
    s, ks, _Facc, _rows = markov_packed_spec(T, d, l)
    Fc_pad, uniq, _pos = markov_compact_spec(T, d, l)
    if dtype is None:
        dtype = jnp.float32 if u.dtype == jnp.bfloat16 else u.dtype
    if store_dtype is None:
        store_dtype = dtype
    Ts, n_pad = u.shape
    assert Ts == T * s, (Ts, T, s)
    n = lens.shape[0]
    lens = lens.astype(jnp.int32)
    if n_pad > n:
        lens = jnp.concatenate([lens, jnp.zeros((n_pad - n,), jnp.int32)])
    acc = _packed_acc_build(u.astype(dtype), lens, T=T, d=d, s=s, ks=ks)
    phi = jnp.take(acc, jnp.asarray(uniq), axis=0)
    if Fc_pad > phi.shape[0]:
        phi = jnp.concatenate(
            [phi, jnp.zeros((Fc_pad - phi.shape[0], n_pad), dtype)], axis=0
        )
    return phi.astype(store_dtype)


def markov_materialize_features_longT(
    z_t: jax.Array,  # (T·d, n) transposed latent batch (NaN-padded)
    x_t: jax.Array,  # (T·l, n)
    lens: jax.Array,  # (n,) int32
    *,
    T: int,
    d: int,
    l: int,
    store_dtype=None,
) -> jax.Array:
    """Materialize canonical-layout features Φ (F_pad, n) for ARBITRARY
    T — :func:`..markov.markov_em_features`, transposed and row-padded.
    With ``layout="canonical"`` :func:`markov_em_from_features` then
    runs EM iterations whose cost does not grow with T at all (Φ's row
    count is the T-independent canonical feature count).

    ``store_dtype`` narrower than the compute dtype (the bf16 opt-in,
    same trade-off as :func:`markov_materialize_features`) casts the
    wide Φ once."""
    from multimodal_trajectory_modeling_tpu.ops import markov as mops

    F_pad, _pos = _feature_layout(T, d, l, "canonical")
    Td, n = z_t.shape
    assert Td == T * d and x_t.shape == (T * l, n)
    dtype = z_t.dtype
    z = jnp.transpose(z_t.reshape(T, d, n), (0, 2, 1))
    x = jnp.transpose(x_t.reshape(T, l, n), (0, 2, 1))
    phi = mops.markov_em_features(z, x, lens).T  # (F, n)
    if F_pad > phi.shape[0]:
        phi = jnp.concatenate(
            [phi, jnp.zeros((F_pad - phi.shape[0], n), dtype)], axis=0
        )
    return phi.astype(dtype if store_dtype is None else store_dtype)


def _phi_pass(phi, wc, prev, force, assign_mode):
    """The Φ pass for R restarts at once.

    ``phi`` (Fp, N) in any storage dtype; ``wc`` (R, C, Fp) folded
    E-score weights in the compute dtype; ``prev`` (R, N) incoming
    assignments with -1 on lanes that take no part (padding);
    ``force`` (R,) or None — rows whose incoming assignment is kept
    verbatim this pass (a pool slot's initial M step).  Returns
    ``(assign (R, N), counts (R, C), switches (R,), stats (R, Fp, C),
    objective (R,))``; invalid lanes come back as assignment ``C``."""
    R, C, _Fp = wc.shape
    dtype = wc.dtype
    phif = phi.astype(dtype)
    valid = prev >= 0
    if assign_mode == "prev":
        na = prev
        switches = jnp.zeros((R,), jnp.int32)
        obj = jnp.zeros((R,), dtype)
    else:
        scores = jnp.einsum("rcf,fn->rcn", wc, phif, precision=_HI)
        na = jnp.argmax(scores, axis=1).astype(jnp.int32)  # first max
        scored = valid
        if force is not None:
            fp = (force > 0)[:, None]
            na = jnp.where(fp, prev, na)
            scored = valid & ~fp
        switches = jnp.sum((na != prev) & valid, axis=1).astype(jnp.int32)
        best = jnp.max(scores, axis=1)
        obj = jnp.sum(jnp.where(scored, best, 0.0), axis=1)
    lanes = jnp.arange(C, dtype=jnp.int32)[None, :, None]
    onehot = (na[:, None, :] == lanes) & valid[:, None, :]
    counts = jnp.sum(onehot, axis=2, dtype=jnp.int32)
    stats = jnp.einsum(
        "fn,rcn->rfc", phif, onehot.astype(dtype), precision=_HI
    )
    assign = jnp.where(valid, na, C)
    return assign, counts, switches, stats, obj


def _fold_weights(phi, Wg, T, d, l, layout):
    """Split a :class:`PhiQuant`, map canonical weights ``Wg`` (R, C, F)
    onto Φ's rows and fold in the quantization scales.  Returns
    ``(payload, wc (R, C, Fp), pos, scale | None)``."""
    scale = None
    if isinstance(phi, PhiQuant):
        phi, scale = phi.q, phi.scale
    Fp, pos = _feature_layout(T, d, l, layout)
    assert phi.shape[0] == Fp, (phi.shape, Fp)
    pos_j = jnp.asarray(pos)
    R, C, _F = Wg.shape
    wc = jnp.zeros((R, C, Fp), Wg.dtype).at[:, :, pos_j].add(Wg)
    if scale is not None:
        wc = wc * scale.astype(wc.dtype)
    return phi, wc, pos_j, scale


def _unfold_stats(stats, pos_j, scale):
    """(R, Fp, C) Φ-row statistics → (R, F, C) canonical statistics."""
    g = jnp.take(stats, pos_j, axis=1)
    if scale is not None:
        g = g * jnp.take(scale, pos_j)[None, :, None].astype(g.dtype)
    return g


def _pad_prev(prev, n_pad):
    n = prev.shape[-1]
    prev = prev.astype(jnp.int32)
    if n_pad > n:
        pad = jnp.full(prev.shape[:-1] + (n_pad - n,), -1, jnp.int32)
        prev = jnp.concatenate([prev, pad], axis=-1)
    return prev


def markov_em_from_features(
    phi: jax.Array,  # (F_pad, n_pad) features, or a PhiQuant
    lens: jax.Array,  # (n,) int32 — true batch size carrier
    prev_assign: jax.Array,  # (n,) int32
    Wg: jax.Array,  # (C, F) canonical weights (+ log π folded)
    *,
    T: int,
    d: int,
    l: int,
    assign_mode: str = "argmax",
    layout: str = "compact",
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """One EM iteration's Φ pass: ``(assign (n,), counts (C,), switches
    (), g (F, C), objective ())``.

    E assignment (first-max argmax of ``Wg·Φ``), membership counts,
    changed-assignment count, the per-cluster summed canonical features
    ``g`` that the closed-form M step reads, and the complete-data
    objective of the INCOMING parameters under a fresh E (``Σ_i max_c
    scores`` — the reference's ``e_complete_data_log_lik``).
    ``assign_mode="prev"`` reduces statistics under ``prev_assign``
    without an E step (the initial M step; objective 0).

    ``layout`` names Φ's row order: ``"compact"``
    (:func:`markov_materialize_features`) or ``"canonical"``
    (:func:`markov_materialize_features_longT`).  ``phi`` may be a
    :class:`PhiQuant`.  Iteration cost is T-independent."""
    n = lens.shape[0]
    payload, wc, pos_j, scale = _fold_weights(phi, Wg[None], T, d, l, layout)
    prev = _pad_prev(prev_assign[None], payload.shape[1])
    a, c, w, stats, obj = _phi_pass(payload, wc, prev, None, assign_mode)
    g = _unfold_stats(stats, pos_j, scale)
    return a[0, :n], c[0], w[0], g[0], obj[0]


def markov_em_from_features_multi(
    phi: jax.Array,  # (F_pad, n_pad) features, or a PhiQuant
    lens: jax.Array,  # (n,) int32 — true batch size carrier
    prev_assign: jax.Array,  # (R, n) int32
    Wg: jax.Array,  # (R, C, F) canonical weights (+ log π folded)
    *,
    T: int,
    d: int,
    l: int,
    assign_mode: str = "argmax",
    force_prev: jax.Array = None,  # (R,) int32/bool
    layout: str = "compact",
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """R-restart :func:`markov_em_from_features`: one read of Φ feeds
    R·C score rows and R·C statistics columns.  Returns ``(assign (R,
    n), counts (R, C), switches (R,), g (R, F, C), objectives (R,))``.

    ``force_prev`` marks restarts that keep their incoming assignment
    this pass (a pool slot's initial M step, run in the same pass as the
    other slots' E steps); their switch count and objective are 0."""
    n = lens.shape[0]
    R = Wg.shape[0]
    assert prev_assign.shape[0] == R, (prev_assign.shape, R)
    payload, wc, pos_j, scale = _fold_weights(phi, Wg, T, d, l, layout)
    prev = _pad_prev(prev_assign, payload.shape[1])
    a, c, w, stats, obj = _phi_pass(payload, wc, prev, force_prev, assign_mode)
    g = _unfold_stats(stats, pos_j, scale)
    return a[:, :n], c, w, g, obj
