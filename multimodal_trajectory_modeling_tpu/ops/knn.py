"""Batched k-nearest-neighbor regression on the device.

Replaces sklearn's ``KNeighborsRegressor`` + ``GridSearchCV`` in the
extended framework (reference framework_extended/state_space_model_knn.py:
61-97): pairwise squared distances are one GEMM, neighbor selection is
``jax.lax.top_k``, and the k-fold grid search evaluates every (fold, k) pair
with the same deterministic contiguous folds as sklearn's non-shuffled
``KFold``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "KNNRegressor",
    "knn_predict",
    "knn_predict_streaming",
    "grid_search_knn",
]

# past this many training rows the dense (B, m) distance tile is replaced by
# a streaming scan over train blocks with a running top-k merge
_STREAM_TRAIN_THRESHOLD = 32_768


@functools.partial(jax.jit, static_argnames=("k", "query_chunk"))
def knn_predict(
    train_x: jax.Array,
    train_y: jax.Array,
    query: jax.Array,
    *,
    k: int,
    query_chunk: int = 4096,
) -> jax.Array:
    """Mean of the ``k`` nearest training targets for each query row.

    Euclidean metric; distances via the ``||q||² − 2 q·x + ||x||²``
    expansion so the inner product is one GEMM.  Queries are processed in
    chunks to bound the (chunk × m) distance matrix in memory.
    """
    m = train_x.shape[0]
    k = min(k, m)
    x_sq = jnp.sum(train_x * train_x, axis=1)  # (m,)

    def chunk_pred(q):
        d2 = (
            jnp.sum(q * q, axis=1, keepdims=True)
            - 2.0 * q @ train_x.T
            + x_sq[None, :]
        )  # (B, m)
        _, idx = jax.lax.top_k(-d2, k)  # (B, k)
        return jnp.mean(train_y[idx], axis=1)  # (B, q_dim)

    n = query.shape[0]
    if n <= query_chunk:
        return chunk_pred(query)
    pad = (-n) % query_chunk
    qp = jnp.concatenate([query, jnp.zeros((pad, query.shape[1]), query.dtype)])
    blocks = qp.reshape(-1, query_chunk, query.shape[1])
    out = jax.lax.map(chunk_pred, blocks)
    return out.reshape(-1, train_y.shape[1])[:n]


@functools.partial(
    jax.jit, static_argnames=("k", "query_chunk", "train_chunk")
)
def knn_predict_streaming(
    train_x: jax.Array,
    train_y: jax.Array,
    query: jax.Array,
    *,
    k: int,
    query_chunk: int = 1024,
    train_chunk: int = 8192,
) -> jax.Array:
    """:func:`knn_predict` at train-set sizes where a (B, m) distance tile
    does not fit: ``lax.scan`` over train blocks carrying a running top-k.

    Per query chunk the live state is the (B, train_chunk) block distances
    plus the (B, k) best-so-far heap — memory O(B·(k + train_chunk))
    independent of m, so n_train scales to millions of rows (SURVEY §7
    step 6; the reference's sklearn path materializes (B, m),
    framework_extended/state_space_model_knn.py:61-97).  Each block's
    candidates are merged with the carry via one concatenated ``top_k``;
    ties on exact-equal distances resolve to the lower train index, same as
    the dense kernel, because earlier blocks precede later ones in the
    concatenation and observed ``lax.top_k`` behavior keeps the first of
    equal values (this is not a formal cross-backend contract, so the
    dense≡streaming tie equivalence is locked in by the parity tests in
    ``tests/test_knn.py`` rather than assumed).
    """
    m, dim = train_x.shape
    k = min(k, m)
    kb = min(k, train_chunk)
    pad_m = (-m) % train_chunk
    xp = jnp.concatenate(
        [train_x, jnp.zeros((pad_m, dim), train_x.dtype)]
    )
    x_sq = jnp.sum(xp * xp, axis=1)
    valid = jnp.arange(m + pad_m) < m
    blocks_x = xp.reshape(-1, train_chunk, dim)
    blocks_sq = x_sq.reshape(-1, train_chunk)
    blocks_valid = valid.reshape(-1, train_chunk)
    base_idx = jnp.arange(0, m + pad_m, train_chunk, dtype=jnp.int32)

    def chunk_pred(q):
        bsz = q.shape[0]
        q_sq = jnp.sum(q * q, axis=1, keepdims=True)

        def body(carry, blk):
            best_neg, best_idx = carry
            bx, bsq, bval, b0 = blk
            d2 = q_sq - 2.0 * q @ bx.T + bsq[None, :]
            neg = jnp.where(bval[None, :], -d2, -jnp.inf)
            vals, idx = jax.lax.top_k(neg, kb)
            cat_vals = jnp.concatenate([best_neg, vals], axis=1)
            cat_idx = jnp.concatenate(
                [best_idx, (idx + b0).astype(jnp.int32)], axis=1
            )
            nv, sel = jax.lax.top_k(cat_vals, k)
            ni = jnp.take_along_axis(cat_idx, sel, axis=1)
            return (nv, ni), None

        init = (
            jnp.full((bsz, k), -jnp.inf, q.dtype),
            jnp.zeros((bsz, k), jnp.int32),
        )
        (_, idx), _ = jax.lax.scan(
            body, init, (blocks_x, blocks_sq, blocks_valid, base_idx)
        )
        return jnp.mean(train_y[idx], axis=1)

    n = query.shape[0]
    if n <= query_chunk:
        return chunk_pred(query)
    pad = (-n) % query_chunk
    qp = jnp.concatenate(
        [query, jnp.zeros((pad, query.shape[1]), query.dtype)]
    )
    q_blocks = qp.reshape(-1, query_chunk, query.shape[1])
    out = jax.lax.map(chunk_pred, q_blocks)
    return out.reshape(-1, train_y.shape[1])[:n]


def _sqdist_np(train_x, query):
    return (
        np.sum(query * query, axis=1, keepdims=True)
        - 2.0 * query @ train_x.T
        + np.sum(train_x * train_x, axis=1)[None, :]
    )


def _knn_predict_np(train_x, train_y, query, k):
    """Host path: argpartition top-k.  Used below a work threshold — inside
    the generic-mixture EM the train-set shape changes every M step, and
    re-jitting the device kernel per shape both costs compiles and grows
    the compile cache without bound (observed OOM in the nonlinear driver).
    """
    k = min(k, train_x.shape[0])
    d2 = _sqdist_np(train_x, query)
    idx = np.argpartition(d2, k - 1, axis=1)[:, :k]
    return train_y[idx].mean(axis=1)


def _knn_predict_np_multi_k(train_x, train_y, query, ks):
    """One distance matrix + one ordered top-k(max) shared by every k in
    the grid — the k-fold grid search evaluates |grid| models per fold for
    the price of one."""
    kmax = min(max(ks), train_x.shape[0])
    d2 = _sqdist_np(train_x, query)
    part = np.argpartition(d2, kmax - 1, axis=1)[:, :kmax]
    order = np.take_along_axis(d2, part, axis=1).argsort(axis=1)
    nearest = np.take_along_axis(part, order, axis=1)  # (n, kmax) sorted
    out = {}
    for k in ks:
        kk = min(k, kmax)
        out[k] = train_y[nearest[:, :kk]].mean(axis=1)
    return out


# below this (train × query) work size the host path wins (no compile)
_DEVICE_WORK_THRESHOLD = 5_000_000


class KNNRegressor:
    """sklearn-compatible surface (``fit`` / ``predict``) over
    :func:`knn_predict`; picklable via plain arrays.  Small problems take a
    compile-free host path; large ones the device kernel."""

    def __init__(self, n_neighbors: int = 5):
        self.n_neighbors = int(n_neighbors)
        self._x = None
        self._y = None

    def fit(self, X: np.ndarray, y: np.ndarray):
        X = np.atleast_2d(np.asarray(X, dtype=float))
        y = np.asarray(y, dtype=float)
        if y.ndim == 1:
            y = y[:, None]
        self._x, self._y = X, y
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, dtype=float))
        if self._x.shape[0] * X.shape[0] < _DEVICE_WORK_THRESHOLD:
            return _knn_predict_np(self._x, self._y, X, self.n_neighbors)
        kernel = (
            knn_predict_streaming
            if self._x.shape[0] > _STREAM_TRAIN_THRESHOLD
            else knn_predict
        )
        out = np.asarray(
            kernel(
                jnp.asarray(self._x),
                jnp.asarray(self._y),
                jnp.asarray(X),
                k=self.n_neighbors,
            )
        )
        return out

    def __getstate__(self):
        return {
            "n_neighbors": self.n_neighbors,
            "_x": self._x,
            "_y": self._y,
        }

    def __setstate__(self, state):
        self.__dict__.update(state)


def _kfold_bounds(n: int, n_folds: int) -> list[tuple[int, int]]:
    """sklearn ``KFold(shuffle=False)`` contiguous fold boundaries."""
    sizes = np.full(n_folds, n // n_folds, dtype=int)
    sizes[: n % n_folds] += 1
    stops = np.cumsum(sizes)
    starts = stops - sizes
    return list(zip(starts.tolist(), stops.tolist()))


def grid_search_knn(
    X: np.ndarray,
    Y: np.ndarray,
    k_grid: list[int],
    n_folds: int = 3,
) -> int:
    """Pick ``k`` by k-fold CV on negative MSE (first-best on ties),
    replicating ``GridSearchCV(KNeighborsRegressor, cv=n_folds,
    scoring="neg_mean_squared_error")`` with deterministic contiguous folds.
    All (fold × k) fits/predictions run on device.
    """
    X = np.atleast_2d(np.asarray(X, dtype=float))
    Y = np.asarray(Y, dtype=float)
    if Y.ndim == 1:
        Y = Y[:, None]
    n = X.shape[0]
    folds = _kfold_bounds(n, n_folds)
    scores = np.zeros((len(k_grid), n_folds))
    small = n * n < _DEVICE_WORK_THRESHOLD
    Xj, Yj = (X, Y) if small else (jnp.asarray(X), jnp.asarray(Y))
    for f, (lo, hi) in enumerate(folds):
        mask = np.zeros(n, dtype=bool)
        mask[lo:hi] = True
        tr_x, tr_y = Xj[~mask], Yj[~mask]
        va_x, va_y = Xj[mask], Yj[mask]
        if small:
            preds = _knn_predict_np_multi_k(tr_x, tr_y, va_x, k_grid)
            for ki, k in enumerate(k_grid):
                scores[ki, f] = -float(np.mean((preds[k] - va_y) ** 2))
        else:
            kernel = (
                knn_predict_streaming
                if tr_x.shape[0] > _STREAM_TRAIN_THRESHOLD
                else knn_predict
            )
            for ki, k in enumerate(k_grid):
                pred = kernel(tr_x, tr_y, va_x, k=k)
                scores[ki, f] = -float(jnp.mean((pred - va_y) ** 2))
    mean_scores = scores.mean(axis=1)
    return int(k_grid[int(np.argmax(mean_scores))])
