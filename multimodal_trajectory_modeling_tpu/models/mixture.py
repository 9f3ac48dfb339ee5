"""``MMLinGaussSS_marginalizable`` — the public mixture-model class.

API-compatible re-implementation of the reference's centerpiece
(framework/marginalizable_mixture_model.py:39-1916): a probabilistic mixture
of linear-Gaussian state-space models trained by hard-assignment EM on
``T × n × dim`` trajectory tensors with NaN-marked missing data.

The class is a thin host shell: parameters live as per-cluster lists of
float64 NumPy arrays (for pickle/cache compatibility with the reference
contract) and are stacked into a :class:`~..models.em.MixtureParams` pytree
whenever device work happens.  All numerics — E-step log-likelihoods, M-step
regressions, the full training loop, and the vmapped multi-start protocol —
run jitted on the accelerator (models/em.py).

Replicated host behaviors (bit-level where feasible):
- constructor RNG split: parameter inits consume the *global* NumPy RNG;
  cluster assignments use ``np.random.default_rng(random_seed)``
  (reference :83-168);
- k-means / k-means-all / random initialisation strategies (:131-168),
  with sklearn KMeans(k-means++) on the host (scikit-learn is needed
  only when a k-means init is asked for);
- md5 content hash of the training data + n_clusters (+ alpha)
  (:177-188) and the ``tmp/mmm-<hash>-<ts>.p.gz`` gzip-pickle cache with
  "there can only be one" eviction (:227-319);
- the multi-start protocol: cached model, else kmeans-seeded start
  (seed 0) plus ``n_starts`` random starts (seeds 100+i), winner by
  strictly-greater expected complete-data log-likelihood, failures
  (non-finite objectives) never selected (:1368-1471).
"""

from __future__ import annotations

import datetime
import glob
import gzip
import hashlib
import os
import pickle
import string

import jax
import jax.numpy as jnp
import numpy as np
import scipy.stats as sp_stats

from multimodal_trajectory_modeling_tpu import config, native, ops
from multimodal_trajectory_modeling_tpu.models import em
from multimodal_trajectory_modeling_tpu.utils import state_space as util

np_eps = np.finfo(float).eps

# repo root (…/multimodal_trajectory_modeling_tpu/models/ → two up)
home_dir = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

_CLUSTER_COLORS = util.CLUSTER_COLORS


def _compute_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _kmeans_cls():
    """scikit-learn's KMeans — the reference's k-means seeding, imported
    only when a k-means init is asked for."""
    try:
        from sklearn.cluster import KMeans
    except ImportError as err:
        raise ImportError(
            "init='kmeans' needs scikit-learn (the reference's k-means "
            "seeding); install the package's [reference] extra, or pass "
            "kmeans_start=False to train_with_multiple_random_starts"
        ) from err
    return KMeans


class MMLinGaussSS_marginalizable:
    """Mixture of linear-Gaussian state-space models with exact NaN
    marginalization, trained by hard-assignment EM on the accelerator."""

    def __init__(
        self,
        n_clusters: int,
        states: np.ndarray,
        observations: np.ndarray,
        random_seed: int = 42,
        init: str = "random",
        alpha: float = 0.0,
    ):
        states, observations = map(np.atleast_3d, (states, observations))
        self.n_clusters = int(n_clusters)
        self.states = np.array(states, dtype=float)
        self.observations = np.array(observations, dtype=float)

        self.n_timesteps, self.n_data, self.d_states = self.states.shape
        self.d_observations = self.observations.shape[-1]

        C, d, l = self.n_clusters, self.d_states, self.d_observations

        self.cluster_propensities = np.ones(C) / C
        # parameter inits intentionally consume the *global* NumPy RNG in the
        # same draw order as the reference (mixture:83-125)
        self.init_state_means = [np.random.normal(size=[d]) for _ in range(C)]
        draws = [np.random.normal(size=[d, d]) for _ in range(C)]
        self.init_state_covs = [x @ x.T + np.eye(d) for x in draws]
        self.transition_matrices = [
            np.random.normal(size=[d, d]) for _ in range(C)
        ]
        draws = [np.random.normal(size=[d, d]) for _ in range(C)]
        self.transition_covs = [x @ x.T + np.eye(d) for x in draws]
        self.measurement_matrices = [
            np.random.normal(size=[d, l]) for _ in range(C)
        ]
        draws = [np.random.normal(size=[l, l]) for _ in range(C)]
        self.measurement_covs = [x @ x.T + np.eye(l) for x in draws]

        self.random_seed = random_seed
        self.rng = np.random.default_rng(seed=self.random_seed)
        self.init = init
        self.alpha = alpha if alpha > 2 * np_eps else 0
        if self.init in ("k-means", "kmeans"):
            first_finite_t = np.argmax(
                np.isfinite(self.states).all(axis=2), axis=0
            ).ravel()
            first_state = np.stack(
                [
                    self.states[first_finite_t[i], i, :]
                    for i in range(self.n_data)
                ]
            )
            first_state = np.where(
                np.isfinite(first_state),
                first_state,
                np.nanmean(first_state, axis=0, keepdims=True),
            )
            # n_init=10 pins the reference environment's behavior
            # (scikit-learn 1.3.x default; >=1.4 switched to 'auto' = 1 run,
            # which changes the kmeans-seeded baseline and hence which
            # multistart candidate wins on some folds)
            self.cluster_assignment = _kmeans_cls()(
                n_clusters=C,
                init="k-means++",
                n_init=10,
                random_state=self.random_seed,
            ).fit_predict(first_state)
        elif self.init in ("kmeans-all", "k-means-all"):
            flat = np.stack(
                [self.states[:, i, :].ravel() for i in range(self.n_data)]
            )
            self.cluster_assignment = _kmeans_cls()(
                n_clusters=C,
                init="k-means++",
                n_init=10,
                random_state=self.random_seed,
            ).fit_predict(flat)
        else:
            self.cluster_assignment = self.rng.integers(
                low=0, high=C, size=self.n_data
            )

        self._correspondence = dict(zip(range(C), string.ascii_uppercase))
        self.inverse_correspondence = {
            v: k for k, v in self._correspondence.items()
        }

        self.hex_hash = hashlib.md5(
            self.states.tobytes()
            + self.observations.tobytes()
            + str(self.n_clusters).encode("utf-8")
            + (
                np.format_float_positional(self.alpha, unique=True).encode(
                    "utf-8"
                )
                if self.alpha > 2 * np_eps
                else b""
            )
        ).hexdigest()
        self.time_stamp = (
            datetime.datetime.now(datetime.timezone.utc)
            .replace(microsecond=0)
            .astimezone()
            .isoformat()
        )
        self.last_trained = None

        self._device_cache: dict = {}

    # ------------------------------------------------------------------
    # device plumbing
    # ------------------------------------------------------------------

    def _stacked_params(self) -> em.MixtureParams:
        dt = _compute_dtype()
        return em.MixtureParams(
            pi=jnp.asarray(self.cluster_propensities, dt),
            m=jnp.asarray(np.stack(self.init_state_means), dt),
            S=jnp.asarray(np.stack(self.init_state_covs), dt),
            A=jnp.asarray(np.stack(self.transition_matrices), dt),
            G=jnp.asarray(np.stack(self.transition_covs), dt),
            H=jnp.asarray(np.stack(self.measurement_matrices), dt),
            L=jnp.asarray(np.stack(self.measurement_covs), dt),
        )

    def _set_params(self, params: em.MixtureParams) -> None:
        self.cluster_propensities = np.asarray(params.pi, dtype=float)
        self.init_state_means = list(np.asarray(params.m, dtype=float))
        self.init_state_covs = list(np.asarray(params.S, dtype=float))
        self.transition_matrices = list(np.asarray(params.A, dtype=float))
        self.transition_covs = list(np.asarray(params.G, dtype=float))
        self.measurement_matrices = list(np.asarray(params.H, dtype=float))
        self.measurement_covs = list(np.asarray(params.L, dtype=float))

    def _needs_masked_filter_route(self, T, n_patterns) -> bool:
        """True when the dense (T(d+l))² joint is infeasible and the fast
        paths must train/score through the exact O(T) partial-observation
        filter instead: long trajectories (joint dimension > 512) or
        unstructured missingness (pattern count past the grouped-logpdf
        regime).  Single source of truth for train(fast=True) AND the
        fast multistart (they must pick the same kernel or the winner's
        objective and the final retrain would diverge)."""
        return (
            T * (self.d_states + self.d_observations) > 512
            or n_patterns > 256
        )

    @staticmethod
    def _suffix_pattern_lens(patterns, T, d, l):
        """If every missingness pattern is a pure time-suffix (a length
        prefix of observed steps, z and x in lockstep), return the per
        -pattern lengths ``(P,) int32``; else ``None``.  Gates the O(T)
        fused Markov EM path (ops/markov.py contract)."""
        P = np.asarray(patterns, dtype=bool)
        zv = P[:, : T * d].reshape(-1, T, d)
        xv = P[:, T * d :].reshape(-1, T, l)
        z_all, z_any = zv.all(-1), zv.any(-1)
        x_all, x_any = xv.all(-1), xv.any(-1)
        if not (
            np.array_equal(z_all, z_any)
            and np.array_equal(x_all, x_any)
            and np.array_equal(z_all, x_all)
        ):
            return None  # partially-observed time steps or z/x mismatch
        lens = z_all.sum(axis=1)
        expect = np.arange(T)[None, :] < lens[:, None]
        if not np.array_equal(z_all, expect) or lens.min() < 1:
            return None  # interior gaps
        return lens.astype(np.int32)

    @staticmethod
    def _suffix_instance_lens(z_np, x_np):
        """Per-INSTANCE twin of :meth:`_suffix_pattern_lens`, computed
        straight from the (T, n, ·) NaN masks — same gate semantics
        (lockstep z/x steps, no partial steps, no interior gaps) without
        materializing the packed joint or grouping patterns.  Returns
        ``(n,) int32`` lengths or ``None``."""
        fin_z = np.isfinite(z_np)  # (T, n, d)
        fin_x = np.isfinite(x_np)  # (T, n, l)
        z_all, z_any = fin_z.all(-1), fin_z.any(-1)
        x_all, x_any = fin_x.all(-1), fin_x.any(-1)
        if not (
            np.array_equal(z_all, z_any)
            and np.array_equal(x_all, x_any)
            and np.array_equal(z_all, x_all)
        ):
            return None  # partially-observed time steps or z/x mismatch
        lens = z_all.sum(axis=0)  # (n,)
        T = fin_z.shape[0]
        expect = np.arange(T)[:, None] < lens[None, :]
        if not np.array_equal(z_all, expect) or lens.min() < 1:
            return None  # interior gaps
        return lens.astype(np.int32)

    def _packed(self, states, observations, T0=None):
        """Pack (prefix of) a dataset into (v, patterns, pattern_id) device
        arrays; cached for the training data."""
        own = states is None
        if own:
            states, observations = self.states, self.observations
        T0 = states.shape[0] if T0 is None else min(T0, states.shape[0])
        key = ("joint", T0) if own else None
        if own and key in self._device_cache:
            return self._device_cache[key]
        dt = _compute_dtype()
        z = np.atleast_3d(states)[:T0].astype(float)
        x = np.atleast_3d(observations)[:T0].astype(float)
        v_np = native.pack_joint(z, x)
        patterns, pid = native.pattern_groups(v_np)
        out = (
            T0,
            jnp.asarray(z, dt),
            jnp.asarray(x, dt),
            jnp.asarray(v_np, dt),
            jnp.asarray(patterns),
            jnp.asarray(pid),
        )
        if own:
            self._device_cache[key] = out
        return out

    def _packed_observed(self, observations, T0=None):
        own = observations is None
        if own:
            observations = self.observations
        T0 = observations.shape[0] if T0 is None else min(T0, observations.shape[0])
        key = ("obs", T0) if own else None
        if own and key in self._device_cache:
            return self._device_cache[key]
        dt = _compute_dtype()
        x = np.atleast_3d(observations)[:T0].astype(float)
        vx_np = x.transpose(1, 0, 2).reshape(x.shape[1], -1)
        patterns, pid = ops.pattern_groups(vx_np)
        out = (
            T0,
            jnp.asarray(vx_np, dt),
            jnp.asarray(patterns),
            jnp.asarray(pid),
        )
        if own:
            self._device_cache[key] = out
        return out

    # ------------------------------------------------------------------
    # model-complexity / bookkeeping properties
    # ------------------------------------------------------------------

    @property
    def n_free_params(self) -> int:
        """Free-parameter count: means/matrices fully, covariances by upper
        triangle (reference mixture:198-214)."""
        full = sum(
            x.size
            for x in [self.cluster_propensities]
            + self.init_state_means
            + self.transition_matrices
            + self.measurement_matrices
        )
        tri = sum(
            len(np.triu_indices_from(np.atleast_2d(x))[0])
            for x in self.init_state_covs
            + self.transition_covs
            + self.measurement_covs
        )
        return full + tri

    @property
    def correspondence(self) -> dict[int, str]:
        return self._correspondence

    @correspondence.setter
    def correspondence(self, corr: dict[int, str]) -> None:
        self._correspondence = corr
        self.inverse_correspondence = {
            v: k for k, v in self._correspondence.items()
        }

    # ------------------------------------------------------------------
    # persistence: content-addressed gzip-pickle cache
    # ------------------------------------------------------------------

    def to_pickle(
        self,
        save_location: str | os.PathLike = None,
        there_can_only_be_one: bool = True,
        include_training_data: bool = False,
    ):
        """Reference cache contract (mixture:227-280): gzip pickle named
        ``mmm-<hash>-<utc stamp>.p.gz``; optionally evict same-hash files."""
        if save_location is None:
            save_location = os.path.join(home_dir, "tmp")
        os.makedirs(save_location, exist_ok=True)
        ts = datetime.datetime.now(datetime.timezone.utc).strftime(
            "%Y%m%dT%H%MZ"
        )
        if there_can_only_be_one:
            for f in glob.glob(
                os.path.join(save_location, f"mmm-{self.hex_hash}*")
            ):
                os.remove(f)
        payload = {
            "n_clusters": self.n_clusters,
            "cluster_propensities": self.cluster_propensities,
            "init_state_means": self.init_state_means,
            "init_state_covs": self.init_state_covs,
            "transition_matrices": self.transition_matrices,
            "transition_covs": self.transition_covs,
            "measurement_matrices": self.measurement_matrices,
            "measurement_covs": self.measurement_covs,
            "random_seed": self.random_seed,
            "rng": self.rng,
            "init": self.init,
            "alpha": self.alpha,
            "cluster_assignment": self.cluster_assignment,
            "correspondence": self.correspondence,
            "inverse_correspondence": self.inverse_correspondence,
            "hex_hash": self.hex_hash,
            "time_stamp": self.time_stamp,
            "last_trained": self.last_trained,
        }
        if include_training_data:
            payload |= {
                "states": self.states,
                "observations": self.observations,
            }
        with gzip.open(
            os.path.join(save_location, f"mmm-{self.hex_hash}-{ts}.p.gz"),
            "wb",
        ) as f:
            pickle.dump(payload, f)

    @staticmethod
    def from_pickle(file: str | os.PathLike, training_data: dict = None):
        opener = gzip.open if os.path.splitext(file)[-1] == ".gz" else open
        with opener(file, "rb") as f:
            d = pickle.load(f)
        src = training_data if training_data is not None else d
        mdl = MMLinGaussSS_marginalizable(
            n_clusters=d["n_clusters"],
            states=src["states"],
            observations=src["observations"],
            random_seed=d["random_seed"],
            init=d["init"],
            alpha=d.get("alpha", 0),
        )
        mdl.cluster_propensities = d["cluster_propensities"]
        mdl.init_state_means = d["init_state_means"]
        mdl.init_state_covs = d["init_state_covs"]
        mdl.transition_matrices = d["transition_matrices"]
        mdl.transition_covs = d["transition_covs"]
        mdl.measurement_matrices = d["measurement_matrices"]
        mdl.measurement_covs = d["measurement_covs"]
        mdl.rng = d["rng"]
        mdl.cluster_assignment = d["cluster_assignment"]
        mdl.correspondence = d["correspondence"]
        mdl.inverse_correspondence = d["inverse_correspondence"]
        mdl.time_stamp = d["time_stamp"]
        mdl.last_trained = d["last_trained"]
        return mdl

    # ------------------------------------------------------------------
    # likelihood family
    # ------------------------------------------------------------------

    def conditional_log_likelihoods_first_T0_steps(
        self, c: int, T0: int, *, states=None, observations=None
    ) -> np.ndarray:
        """Per-instance joint log-likelihood under cluster ``c`` restricted
        to time steps 1..T0 (reference mixture:439-494)."""
        assert 1 <= T0 <= self.n_timesteps
        ll = self._all_cluster_logliks(T0, states, observations)
        return ll[c]

    def conditional_log_likelihoods(
        self, c: int, *, states=None, observations=None
    ) -> np.ndarray:
        return self.conditional_log_likelihoods_first_T0_steps(
            c, self.n_timesteps, states=states, observations=observations
        )

    def _all_cluster_logliks(self, T0, states, observations) -> np.ndarray:
        """(C, n) log-likelihood matrix; one fused device call.

        Long trajectories route through the O(T) partial-observation
        filter (exact for arbitrary missingness) instead of the dense
        (T(d+l))² joint, which is quadratic in T and numerically
        degrading past dimension ≈ 512."""
        _T0, _z, _x, v, patterns, pid = self._packed(states, observations, T0)
        if _T0 * (self.d_states + self.d_observations) > 512:
            # long T: pure-suffix patterns (variable lengths) take the
            # O(T) Markov factorization (GEMM-shaped; ~6-100× the
            # filter at T=512); anything else the exact O(T) filter
            plens = self._suffix_pattern_lens(
                patterns, _T0, self.d_states, self.d_observations
            )
            if plens is not None:
                ll = em.suffix_logliks_markov(
                    self._stacked_params(),
                    _z,
                    _x,
                    jnp.asarray(plens[np.asarray(pid)]),
                )
            else:
                ll = em.masked_logliks_kalman(
                    self._stacked_params(), _z, _x
                )
        else:
            ll = em.estep_logliks(
                self._stacked_params(), v, patterns, pid, T=_T0
            )
        return np.asarray(ll, dtype=float)

    @staticmethod
    def _suffix_pattern_lens_x(patterns, T, l):
        """x-only twin of :meth:`_suffix_pattern_lens`: per-pattern
        prefix lengths for (P, T·l) observation patterns, or ``None``
        when any pattern has partially-observed steps or interior gaps
        (all-missing rows included — the masked filter handles those
        with its exact 0.0 convention)."""
        P = np.asarray(patterns, dtype=bool).reshape(-1, T, l)
        x_all, x_any = P.all(-1), P.any(-1)
        if not np.array_equal(x_all, x_any):
            return None
        lens = x_all.sum(axis=1)
        expect = np.arange(T)[None, :] < lens[:, None]
        if not np.array_equal(x_all, expect) or lens.min() < 1:
            return None
        return lens.astype(np.int32)

    def _all_observed_logliks(self, T0, observations) -> np.ndarray:
        _T0, vx, patterns, pid = self._packed_observed(observations, T0)
        if _T0 * self.d_observations > 512:
            # long T: the dense observed joint is (T·l)² per pattern —
            # route the O(T) filters (suffix lengths: the x-marginal
            # Kalman pass; anything else: the masked filter with an
            # all-NaN state block)
            x3 = jnp.transpose(
                vx.reshape(-1, _T0, self.d_observations), (1, 0, 2)
            )
            plens = self._suffix_pattern_lens_x(
                patterns, _T0, self.d_observations
            )
            if plens is not None:
                ll = em.observed_logliks_kalman(
                    self._stacked_params(),
                    x3,
                    jnp.asarray(plens[np.asarray(pid)]),
                )
            else:
                z_none = jnp.full(
                    (_T0, x3.shape[1], self.d_states), jnp.nan, x3.dtype
                )
                ll = em.masked_logliks_kalman(
                    self._stacked_params(), z_none, x3
                )
            return np.asarray(ll, dtype=float)
        ll = em.observed_logliks(
            self._stacked_params(), vx, patterns, pid, T=_T0
        )
        return np.asarray(ll, dtype=float)

    def cluster_propensities_over_time(
        self, *, states=None, observations=None
    ) -> np.ndarray:
        """(T, n, C) posterior membership using only the first t+1 steps
        (reference mixture:532-577)."""
        _T = min(
            self.n_timesteps,
            (self.states if states is None else states).shape[0],
        )
        probs = []
        for t in range(_T):
            ll = self._all_cluster_logliks(t + 1, states, observations)
            logits = np.log(self.cluster_propensities)[:, None] + ll
            probs.append(_softmax_cols(logits).T)  # (n, C)
        pc_t = np.stack(probs, axis=0)
        assert np.all(pc_t >= 0.0) and np.allclose(np.sum(pc_t, axis=-1), 1.0)
        return pc_t

    def e_complete_data_log_lik(
        self, *, states=None, observations=None
    ) -> float:
        """Hard-assignment expected complete-data log-likelihood Q with a
        fresh E assignment (reference mixture:579-624)."""
        ll = self._all_cluster_logliks(self.n_timesteps, states, observations)
        a = np.argmax(np.log(self.cluster_propensities)[:, None] + ll, axis=0)
        return float(
            np.sum(np.log(self.cluster_propensities[a]))
            + np.sum(ll[a, np.arange(ll.shape[1])])
        )

    def model_log_likelihood(
        self, *, states=None, observations=None
    ) -> float:
        """Marginal mixture log-likelihood Σ_i log Σ_c π_c L_ci (reference
        mixture:626-666; computed with logsumexp)."""
        ll = self._all_cluster_logliks(self.n_timesteps, states, observations)
        logits = np.log(self.cluster_propensities)[:, None] + ll
        return float(np.sum(_logsumexp_cols(logits)))

    def aic(self, states=None, observations=None) -> float:
        return (
            -2
            * self.model_log_likelihood(
                states=states, observations=observations
            )
            + 2 * self.n_free_params
        )

    def bic(self, states=None, observations=None) -> float:
        n = self.n_data if states is None else states.shape[1]
        return (
            -2
            * self.model_log_likelihood(
                states=states, observations=observations
            )
            + np.log(n) * self.n_free_params
        )

    # ------------------------------------------------------------------
    # assignment / prediction family
    # ------------------------------------------------------------------

    def mle_cluster_assignment(
        self,
        *,
        return_probs: bool = False,
        return_prenormalized_log_probs: bool = False,
        states=None,
        observations=None,
    ):
        """Hard MLE assignment (argmax of log π_c + ll_c); optionally the
        normalized posterior and/or prenormalized log-probs
        (reference mixture:724-791)."""
        ll = self._all_cluster_logliks(self.n_timesteps, states, observations)
        prenorm = np.log(self.cluster_propensities)[:, None] + ll
        assignments = np.argmax(prenorm, axis=0)
        if not (return_probs or return_prenormalized_log_probs):
            return assignments
        probs = _softmax_cols(prenorm)
        if not return_prenormalized_log_probs:
            return assignments, probs
        return assignments, probs, prenorm

    def cluster_assignment_index(
        self, *, cluster: str = "A", states=None, observations=None
    ) -> np.ndarray:
        """Prenormalized log-odds of membership in ``cluster`` — the
        model-derived 'health index' (reference mixture:793-806)."""
        return self.mle_cluster_assignment(
            states=states,
            observations=observations,
            return_probs=True,
            return_prenormalized_log_probs=True,
        )[-1][self.inverse_correspondence[cluster]]

    def _mix_one_step_predictions(self, states, assignment_probs):
        last = states[-1]
        nz = np.zeros((1, *states.shape[1:]))
        nx = np.zeros((1, last.shape[0], self.d_observations))
        for c in range(self.n_clusters):
            zc = last @ self.transition_matrices[c]
            xc = zc @ self.measurement_matrices[c]
            w = assignment_probs[c][:, None]
            nz += w * zc
            nx += w * xc
        return nz, nx

    def one_step_ahead_predictions(self, *, states, observations):
        """Posterior-weighted one-step-ahead forecasts (reference
        mixture:808-850)."""
        probs = self.mle_cluster_assignment(
            states=states, observations=observations, return_probs=True
        )[1]
        assert probs.shape == (self.n_clusters, states[-1].shape[0])
        return self._mix_one_step_predictions(states, probs)

    def one_step_ahead_predictions_no_history(self, *, states, observations):
        """Same but clusters assigned from the final snapshot only
        (reference mixture:852-907)."""
        z_nh = np.full_like(states, np.nan)
        z_nh[-1] = states[-1]
        x_nh = np.full_like(observations, np.nan)
        x_nh[-1] = observations[-1]
        probs = self.mle_cluster_assignment(
            states=z_nh, observations=x_nh, return_probs=True
        )[1]
        assert probs.shape == (self.n_clusters, states[-1].shape[0])
        return self._mix_one_step_predictions(states, probs)

    def initial_full_data_cluster_assignment(
        self, *, states=None, observations=None
    ) -> np.ndarray:
        """Assignment from the first time step only (reference
        mixture:909-941)."""
        ll = self._all_cluster_logliks(1, states, observations)
        return np.argmax(
            np.log(self.cluster_propensities)[:, None] + ll, axis=0
        )

    def predictions_from_initial_data(
        self, *, states=None, observations=None
    ):
        """Roll the assigned cluster's mean dynamics forward from each
        instance's own initial state (reference mixture:943-995; note the
        reference reads initial states from the *training* data regardless of
        overrides — reproduced faithfully)."""
        assignments = self.initial_full_data_cluster_assignment(
            states=states, observations=observations
        )
        pred_z = np.zeros_like(self.states if states is None else states)
        pred_x = np.zeros_like(
            self.observations if observations is None else observations
        )
        Tz, Tx = pred_z.shape[0], pred_x.shape[0]
        # one vmapped mean-dynamics rollout over instances (the per-instance
        # transition matrix is gathered from the assigned cluster) instead of
        # the reference's per-instance Python loop (reference mixture:976-990)
        z0s = jnp.asarray(self.states[0])  # (n, l)
        A_by_instance = jnp.asarray(np.stack(self.transition_matrices))[
            jnp.asarray(assignments)
        ]
        chains = np.asarray(
            jax.vmap(lambda z0, A: ops.latent_means(Tz, z0, A))(
                z0s, A_by_instance
            )
        )  # (n, Tz, l)
        assert np.array_equal(chains[:, 0, :], self.states[0])
        pred_z[:] = chains.transpose(1, 0, 2)[:Tz]
        H_by_instance = np.stack(self.measurement_matrices)[assignments]
        pred_x[:] = np.einsum(
            "ntl,nld->tnd", chains[:, :Tx, :], H_by_instance
        )
        return pred_z, pred_x

    # ------------------------------------------------------------------
    # observed-only family (hidden states marginalized analytically)
    # ------------------------------------------------------------------

    def observed_condl_log_lik_first_T0_steps(
        self, c: int, T0: int, *, observations=None
    ) -> np.ndarray:
        """p(x|c) with all hidden states marginalized (reference
        mixture:997-1048)."""
        assert 1 <= T0 <= self.n_timesteps
        return self._all_observed_logliks(T0, observations)[c]

    def observed_conditional_log_likelihoods(
        self, c: int, observations=None
    ) -> np.ndarray:
        return self.observed_condl_log_lik_first_T0_steps(
            c, self.n_timesteps, observations=observations
        )

    def observed_cluster_propensities_over_time(
        self, observations=None
    ) -> np.ndarray:
        """(T, n, C) posterior membership from observations alone
        (reference mixture:1077-1123)."""
        _T = (
            self.observations.shape[0]
            if observations is None
            else observations.shape[0]
        )
        probs = []
        for t in range(_T):
            ll = self._all_observed_logliks(t + 1, observations)
            logits = np.log(self.cluster_propensities)[:, None] + ll
            probs.append(_softmax_cols(logits).T)
        pc_t = np.stack(probs, axis=0)
        assert np.all(pc_t >= 0.0) and np.allclose(np.sum(pc_t, axis=-1), 1.0)
        return pc_t

    def observations_mle_cluster_assignment(
        self, *, return_probs: bool = False, observations=None
    ):
        """Hard assignment from observations alone (reference
        mixture:1125-1165)."""
        ll = self._all_observed_logliks(self.n_timesteps, observations)
        prenorm = np.log(self.cluster_propensities)[:, None] + ll
        assignments = np.argmax(prenorm, axis=0)
        if return_probs:
            return assignments, _softmax_cols(prenorm)
        return assignments

    # ------------------------------------------------------------------
    # static regression helpers (API parity; reference mixture:1167-1233)
    # ------------------------------------------------------------------

    @staticmethod
    def regress(input_exogenous, output_endogenous):
        A, S = ops.regress(
            jnp.asarray(np.atleast_2d(input_exogenous), _compute_dtype()),
            jnp.asarray(np.atleast_2d(output_endogenous), _compute_dtype()),
            mode="lstsq",
        )
        return np.asarray(A, float), np.asarray(S, float)

    @staticmethod
    def regress_alpha(input_exogenous, output_endogenous, alpha):
        A, S = ops.regress(
            jnp.asarray(np.atleast_2d(input_exogenous), _compute_dtype()),
            jnp.asarray(np.atleast_2d(output_endogenous), _compute_dtype()),
            mode="ridge",
            alpha=alpha,
        )
        return np.asarray(A, float), np.asarray(S, float)

    # ------------------------------------------------------------------
    # EM steps + training
    # ------------------------------------------------------------------

    def E_step(self) -> int:
        """One E step; returns the number of changed assignments
        (reference mixture:1235-1252)."""
        new_assignment = self.mle_cluster_assignment()
        n_switches = int(
            np.sum(np.not_equal(self.cluster_assignment, new_assignment))
        )
        self.cluster_assignment = new_assignment
        return n_switches

    def M_step(self) -> None:
        """One M step from the current assignment (reference
        mixture:1254-1308) — all clusters in one fused device call."""
        _T0, z, x, _v, _p, _pid = self._packed(None, None)
        params = em.mstep(
            z,
            x,
            jnp.asarray(self.cluster_assignment),
            n_clusters=self.n_clusters,
            reg_mode="ridge" if self.alpha > 2 * np_eps else "lstsq",
            alpha=float(self.alpha),
        )
        self._set_params(params)

    def train(
        self, *, verbose: bool = False, n_steps: int = 1000, fast: bool = False
    ):
        """EM to convergence (0 switches) or ``n_steps``, with the
        near-empty-cluster guards (reference mixture:1310-1366).

        The whole loop runs jitted on-device; with ``verbose`` the loop is
        stepped from the host instead, printing the rounded objective after
        every M step exactly like the reference and recording an
        :class:`~..utils.trace.EMTrace` in ``self.last_trace``.

        ``fast=True`` routes the production paths: suffix-only
        missingness (variable trajectory lengths) takes the O(T) Markov
        EM (:func:`em.train_em_markov` — one pass over the materialized
        features per iteration, no pattern sort); interior missingness
        at long T (T(d+l) > 512) or unstructured missingness (> 256
        patterns) takes the exact O(T) partial-observation filter
        trainer (:func:`em.train_em_masked_kalman`); any other
        missingness takes the dense-joint trainer with per-pattern
        precomputed inverses (:func:`em.train_em`, ``method="inverse"``).
        Both are f64-identical to the default path, f32 up to
        reassociation; leave ``False`` for bit-level reference parity on
        the CPU-x64 path.  ``verbose=True`` takes the host-stepped loop
        and ignores ``fast``."""
        if verbose:
            return self._train_verbose(n_steps=n_steps)
        reg_mode = "ridge" if self.alpha > 2 * np_eps else "lstsq"
        if fast and os.environ.get("MTM_MARKOV_OOC") == "1":
            ooc = self._train_markov_outofcore(
                n_steps=n_steps, reg_mode=reg_mode
            )
            if ooc is not None:
                return ooc
        _T0, z, x, v, patterns, pid = self._packed(None, None)
        if fast:
            pid_np = np.asarray(pid)
            plens = self._suffix_pattern_lens(
                patterns, z.shape[0], z.shape[-1], x.shape[-1]
            )
            if plens is not None:
                # suffix missingness → O(T) Markov EM (one Φ pass per
                # iteration, no sort; f64-identical, tested)
                params, assign, iters, status = em.train_em_markov(
                    self._stacked_params(),
                    jnp.asarray(self.cluster_assignment),
                    z,
                    x,
                    jnp.asarray(plens[pid_np]),
                    n_steps=n_steps,
                    reg_mode=reg_mode,
                    alpha=float(self.alpha),
                )
            elif self._needs_masked_filter_route(
                z.shape[0], patterns.shape[0]
            ):
                # interior missingness at long T (or unstructured
                # missingness with P ~ n patterns): the dense (T(d+l))²
                # joint is infeasible — train through the exact O(T)
                # partial-observation filter (same status protocol;
                # equal to the dense path in f64, tested)
                params, assign, iters, status = em.train_em_masked_kalman(
                    self._stacked_params(),
                    jnp.asarray(self.cluster_assignment),
                    z,
                    x,
                    n_steps=n_steps,
                    reg_mode=reg_mode,
                    alpha=float(self.alpha),
                )
            else:
                params, assign, iters, status = em.train_em(
                    self._stacked_params(),
                    jnp.asarray(self.cluster_assignment),
                    z,
                    x,
                    v,
                    patterns,
                    pid,
                    n_steps=n_steps,
                    reg_mode=reg_mode,
                    alpha=float(self.alpha),
                    method="inverse",
                )
        else:
            params, assign, iters, status = em.train_em(
                self._stacked_params(),
                jnp.asarray(self.cluster_assignment),
                z,
                x,
                v,
                patterns,
                pid,
                n_steps=n_steps,
                reg_mode=reg_mode,
                alpha=float(self.alpha),
            )
        status = int(status)
        if status == em.STATUS_INIT_ABORT:
            # reference returns before stamping last_trained (mixture:1328-1336)
            return self
        self._set_params(params)
        self.cluster_assignment = np.asarray(assign)
        self.last_trained = (
            datetime.datetime.now(datetime.timezone.utc)
            .replace(microsecond=0)
            .astimezone()
            .isoformat()
        )
        return self

    def _train_markov_outofcore(self, *, n_steps: int, reg_mode: str):
        """``MTM_MARKOV_OOC=1`` route for :meth:`train`'s fast path:
        suffix-missingness EM with the feature matrix streamed from HOST
        memory (:func:`em.train_em_markov_outofcore`) so device residency
        never exceeds one chunk — for batches whose Φ (or packed batch)
        would not fit HBM.  The batch is packed and pattern-gated on the
        host only (no device copies are cached); returns ``None`` when
        the missingness is not pure-suffix so :meth:`train` falls through
        to its in-core routes.  ``MTM_MARKOV_OOC_CHUNK`` sets the chunk
        width (instances per streamed block, default 2²⁰)."""
        dt = _compute_dtype()
        z_np = np.atleast_3d(self.states).astype(float)
        x_np = np.atleast_3d(self.observations).astype(float)
        T = z_np.shape[0]
        # per-instance suffix gate straight off the NaN masks — building
        # the packed (n, T(d+l)) f64 joint just to group patterns would
        # transiently double host memory on the one path whose reason to
        # exist is host-RAM-bounded capacity
        ilens = self._suffix_instance_lens(z_np, x_np)
        if ilens is None:
            return None
        chunk = int(os.environ.get("MTM_MARKOV_OOC_CHUNK", str(1 << 20)))
        params, assign, iters, status = em.train_em_markov_outofcore(
            self._stacked_params(),
            np.asarray(self.cluster_assignment, np.int32),
            z_np.astype(np.dtype(dt), copy=False),
            x_np.astype(np.dtype(dt), copy=False),
            ilens,
            n_steps=n_steps,
            reg_mode=reg_mode,
            alpha=float(self.alpha),
            chunk_cols=chunk,
        )
        if int(status) == em.STATUS_INIT_ABORT:
            return self  # reference returns before stamping (mixture:1328-1336)
        self._set_params(params)
        self.cluster_assignment = np.asarray(assign)
        self.last_trained = (
            datetime.datetime.now(datetime.timezone.utc)
            .replace(microsecond=0)
            .astimezone()
            .isoformat()
        )
        return self

    def _train_verbose(self, *, n_steps: int):
        """Host-stepped EM with the reference's exact verbose prints
        (rounded Q after every M step, mixture:1337-1359) and an EMTrace."""
        import time as _time

        from multimodal_trajectory_modeling_tpu.utils.trace import EMTrace

        trace = EMTrace()
        self.last_trace = trace
        counts = np.bincount(
            self.cluster_assignment, minlength=self.n_clusters
        )
        if np.min(counts) <= 3:
            print("Encountered near-empty cluster.")
            return self
        t0 = _time.perf_counter()
        self.M_step()
        q = self.e_complete_data_log_lik()
        print(np.round(q, 3))
        trace.record(0, q, -1, _time.perf_counter() - t0)
        for i in range(n_steps):
            t0 = _time.perf_counter()
            n_switches = self.E_step()
            if n_switches == 0:
                print(f"Optimisation completed in {i} steps.")
                break
            counts = np.bincount(
                self.cluster_assignment, minlength=self.n_clusters
            )
            if np.min(counts) <= 3:
                print("Encountered near-empty cluster.")
                break
            self.M_step()
            q = self.e_complete_data_log_lik()
            print(np.round(q, 3))
            trace.record(i + 1, q, n_switches, _time.perf_counter() - t0)
        self.last_trained = (
            datetime.datetime.now(datetime.timezone.utc)
            .replace(microsecond=0)
            .astimezone()
            .isoformat()
        )
        return self

    def train_with_multiple_random_starts(
        self,
        *,
        n_starts: int = 10,
        verbose: bool = False,
        n_steps: int = 100,
        return_objectives: bool = False,
        use_cache: bool = True,
        starts_per_batch: int = 256,
        fast: bool = None,
        kmeans_start: bool = True,
    ):
        """Reference multi-start protocol (mixture:1368-1471), with the
        restart loop replaced by vmapped on-device batches.

        Candidate order and RNG replication: one kmeans-initialized start
        (seed 0), then ``n_starts`` random starts (seeds 100+i); parameter
        inits consume the global NumPy RNG in constructor order; the winner
        is the first candidate whose objective is strictly greater than all
        previous ones; non-finite objectives never win; if no candidate is
        finite, raises ``Exception("training failed")``.

        ``fast`` routes the candidates through the trainers
        :meth:`train` takes with ``fast=True`` (suffix missingness: the
        Markov slot pool :func:`em.train_em_markov_pool`); ``None``
        auto-selects it at large n (n ≥ 200k) on an accelerator
        (:func:`..config.backend_route`).  The winner rule, objective
        definition and RNG streams are identical either way; candidate
        end-states can differ from the vmapped path only by f32
        reassociation.

        ``kmeans_start=False`` seeds the first candidate (seed 0)
        randomly instead of by k-means — a deployment without
        scikit-learn; the reference protocol is the default.
        """
        if bool(use_cache):
            try:
                pfile = sorted(
                    glob.glob(
                        os.path.join(home_dir, "tmp", f"mmm-{self.hex_hash}*")
                    ),
                    key=os.path.getmtime,
                ).pop()
                best_mdl = MMLinGaussSS_marginalizable.from_pickle(
                    pfile,
                    training_data={
                        "states": self.states,
                        "observations": self.observations,
                    },
                )
                assert self.hex_hash == best_mdl.hex_hash
                if verbose:
                    print(f"Loaded model {best_mdl.last_trained=} from cache.")
                return best_mdl
            except IndexError:
                if verbose:
                    print("No model found in cache.")
            except Exception as err:  # noqa: BLE001 — cache is best-effort
                if verbose:
                    print(f"Issue loading cached model -- encountered {err}")

        candidates = [
            MMLinGaussSS_marginalizable(
                n_clusters=self.n_clusters,
                states=self.states,
                observations=self.observations,
                random_seed=0,
                init="kmeans" if kmeans_start else "random",
                alpha=self.alpha,
            )
        ]
        for i in range(n_starts):
            candidates.append(
                MMLinGaussSS_marginalizable(
                    n_clusters=self.n_clusters,
                    states=self.states,
                    observations=self.observations,
                    random_seed=100 + i,
                    alpha=self.alpha,
                )
            )

        if verbose:
            # the reference forwards verbosity into every candidate's
            # train() (mixture:1444-1455); the vmapped batch below cannot
            # print per-candidate Q sequences, so verbose multistart runs
            # the candidates host-stepped, reproducing the transcript
            # exactly (constructor RNG draws happened above, in reference
            # order; training consumes no global randomness, so the
            # sequential replay is stream-equivalent)
            best_mdl = candidates[0]
            try:
                best_mdl = best_mdl.train(verbose=True, n_steps=n_steps)
            except Exception:  # noqa: BLE001 — degenerate start, keep going
                pass
            objective_list = [best_mdl.e_complete_data_log_lik()]
            for cand in candidates[1:]:
                try:
                    mdl = cand.train(verbose=True, n_steps=n_steps)
                    objective_list.append(mdl.e_complete_data_log_lik())
                    if (
                        mdl.e_complete_data_log_lik()
                        > best_mdl.e_complete_data_log_lik()
                    ):
                        best_mdl = mdl
                except Exception:  # noqa: BLE001
                    pass
            if not np.isfinite(best_mdl.e_complete_data_log_lik()):
                raise Exception("training failed")
            if use_cache:
                best_mdl.to_pickle()
            if return_objectives:
                return best_mdl, np.array(objective_list)
            return best_mdl

        _T0, z, x, v, patterns, pid = self._packed(None, None)
        reg_mode = "ridge" if self.alpha > 2 * np_eps else "lstsq"
        if fast is None:
            fast = (
                v.shape[0] >= 200_000 and config.backend_route() == "gpu"
            )
        results_params, results_assign, objectives = [], [], []
        if fast:
            pid_np = np.asarray(pid)
            plens = self._suffix_pattern_lens(
                patterns, z.shape[0], z.shape[-1], x.shape[-1]
            )
            if plens is not None:
                # suffix missingness → O(T) Markov EM through the
                # R-slot POOL scheduler (em.train_em_markov_pool): one
                # read of the shared Φ per pass serves R
                # simultaneous candidates, and a slot is refilled the
                # moment its occupant terminates (a fresh candidate's
                # initial M step rides the same dispatch via the
                # per-slot force_prev flag) — no convergence-spread
                # waste, so R can ride the large-R efficiency.
                # Per-candidate trajectories are identical to standalone
                # runs and results come back in candidate order, so the
                # first-strictly-greater winner rule is unchanged.
                lens = jnp.asarray(plens[pid_np])
                T0_, d_n, l_n = z.shape[0], z.shape[-1], x.shape[-1]
                z_tp = jnp.transpose(z, (0, 2, 1)).reshape(
                    T0_ * d_n, -1
                )
                x_tp = jnp.transpose(x, (0, 2, 1)).reshape(
                    T0_ * l_n, -1
                )
                packed_ok_ = em.markov_packed_ok(T0_, d_n, l_n)
                r_fuse = int(os.environ.get("MTM_MULTISTART_FUSE", "32"))
                if r_fuse > 1 and len(candidates) > 1:
                    if packed_ok_:
                        u_pack = em.pack_markov_batch(
                            z_tp, x_tp, T=T0_, d=d_n, l=l_n
                        )
                        phi_obj, obj_layout = None, "compact"
                    else:
                        # long T: the pool trains from the canonical
                        # features (the packed batch is never built);
                        # candidate objectives evaluate from one shared
                        # canonical Φ
                        from multimodal_trajectory_modeling_tpu.ops import (
                            markov_phi,
                        )

                        u_pack = None
                        phi_obj = (
                            markov_phi.markov_materialize_features_longT(
                                z_tp,
                                x_tp,
                                lens,
                                T=T0_,
                                d=d_n,
                                l=l_n,
                            )
                        )
                        obj_layout = "canonical"
                    # with >1 attached device and MTM_MULTICHIP=1 the
                    # pool window runs data-parallel over a 1-D mesh
                    # (per-restart stats psums; host scheduling and the
                    # winner rule are unchanged)
                    pool_mesh = None
                    if (
                        os.environ.get("MTM_MULTICHIP") == "1"
                        and len(jax.devices()) > 1
                    ):
                        pool_mesh = jax.sharding.Mesh(
                            np.asarray(jax.devices()), ("data",)
                        )
                    pooled = em.train_em_markov_pool(
                        [c._stacked_params() for c in candidates],
                        [
                            np.asarray(c.cluster_assignment)
                            for c in candidates
                        ],
                        z,
                        x,
                        lens,
                        R=r_fuse,
                        n_steps=n_steps,
                        reg_mode=reg_mode,
                        alpha=float(self.alpha),
                        u=u_pack,  # mesh mode re-pads to the shard quantum
                        mesh=pool_mesh,
                    )
                    # objectives (Σ max scores = e_complete_data_log_lik
                    # under a fresh E) in R-sized batches
                    for i0 in range(0, len(pooled), r_fuse):
                        grp = pooled[i0 : i0 + r_fuse]
                        params_st = jax.tree.map(
                            lambda *ps: jnp.stack(ps),
                            *[p for p, _a, _it, _st in grp],
                        )
                        objs = em.complete_data_loglik_markov_multi(
                            params_st,
                            lens,
                            u_pack,
                            T=T0_,
                            phi=phi_obj,
                            phi_layout=obj_layout,
                        )
                        for (p, a, _it, _st), o in zip(grp, objs):
                            results_params.append(p)
                            results_assign.append(np.asarray(a))
                            objectives.append(float(o))
                else:
                    for cand in candidates:
                        params_c, assign_c, _it, _st = (
                            em.train_em_markov(
                                cand._stacked_params(),
                                jnp.asarray(cand.cluster_assignment),
                                z,
                                x,
                                lens,
                                n_steps=n_steps,
                                reg_mode=reg_mode,
                                alpha=float(self.alpha),
                            )
                        )
                        obj = float(
                            em.complete_data_loglik_markov(
                                params_c, z_tp, x_tp, lens, T=T0_
                            )
                        )
                        results_params.append(params_c)
                        results_assign.append(np.asarray(assign_c))
                        objectives.append(obj)
            elif self._needs_masked_filter_route(
                z.shape[0], patterns.shape[0]
            ):
                # interior missingness at long T / unstructured
                # missingness: exact O(T) masked-filter trainer (same
                # route train(fast=True) takes, by the shared
                # predicate); the complete-data objective re-evaluates
                # the filter densities under a fresh E.  Candidates run
                # SEQUENTIALLY by default: the scalarized filter is
                # compute-bound and linear in clusters, so the R-slot
                # pool has no shared work to amortize — unlike the
                # Markov route, whose Φ read the pool shares.
                # MTM_MASKED_POOL=1 opts into the pool
                # (identical results, tested).
                r_fuse = int(os.environ.get("MTM_MULTISTART_FUSE", "32"))
                use_pool = (
                    os.environ.get("MTM_MASKED_POOL", "0") == "1"
                    and r_fuse > 1
                    and len(candidates) > 1
                )
                if use_pool:
                    pooled = em.train_em_masked_kalman_pool(
                        [c._stacked_params() for c in candidates],
                        [
                            np.asarray(c.cluster_assignment)
                            for c in candidates
                        ],
                        z,
                        x,
                        R=r_fuse,
                        n_steps=n_steps,
                        reg_mode=reg_mode,
                        alpha=float(self.alpha),
                    )
                    for params_c, assign_c, _it, _st in pooled:
                        obj = float(
                            em.complete_data_loglik_masked_kalman(
                                params_c, z, x
                            )
                        )
                        results_params.append(params_c)
                        results_assign.append(np.asarray(assign_c))
                        objectives.append(obj)
                else:
                    # with MTM_MULTICHIP=1 each candidate's fit runs
                    # data-parallel over the mesh (filter densities are
                    # per-instance; per-iteration psums of the masked
                    # statistics — sharded_em.train_em_masked_kalman_
                    # shardmap, bit-equal up to psum reassociation)
                    pool_mesh = None
                    if (
                        os.environ.get("MTM_MULTICHIP") == "1"
                        and len(jax.devices()) > 1
                        # equal shards required: the masked shardmap
                        # trainer has no pad-lane protocol (an all-NaN
                        # pad row would still vote in counts/switches)
                        and z.shape[1] % len(jax.devices()) == 0
                    ):
                        pool_mesh = jax.sharding.Mesh(
                            np.asarray(jax.devices()), ("data",)
                        )
                    for cand in candidates:
                        if pool_mesh is not None:
                            from multimodal_trajectory_modeling_tpu.parallel import (  # noqa: E501
                                sharded_em,
                            )

                            params_c, assign_c, _it, _st = (
                                sharded_em.train_em_masked_kalman_shardmap(
                                    cand._stacked_params(),
                                    jnp.asarray(
                                        cand.cluster_assignment
                                    ),
                                    z,
                                    x,
                                    mesh=pool_mesh,
                                    n_steps=n_steps,
                                    reg_mode=reg_mode,
                                    alpha=float(self.alpha),
                                )
                            )
                        else:
                            params_c, assign_c, _it, _st = (
                                em.train_em_masked_kalman(
                                    cand._stacked_params(),
                                    jnp.asarray(
                                        cand.cluster_assignment
                                    ),
                                    z,
                                    x,
                                    n_steps=n_steps,
                                    reg_mode=reg_mode,
                                    alpha=float(self.alpha),
                                )
                            )
                        obj = float(
                            em.complete_data_loglik_masked_kalman(
                                params_c, z, x
                            )
                        )
                        results_params.append(params_c)
                        results_assign.append(np.asarray(assign_c))
                        objectives.append(obj)
            else:
                for cand in candidates:
                    params_c, assign_c, _iters, _status = em.train_em(
                        cand._stacked_params(),
                        jnp.asarray(cand.cluster_assignment),
                        z,
                        x,
                        v,
                        patterns,
                        pid,
                        n_steps=n_steps,
                        reg_mode=reg_mode,
                        alpha=float(self.alpha),
                        method="inverse",
                    )
                    obj = float(
                        em.complete_data_loglik(
                            params_c, v, patterns, pid, T=z.shape[0]
                        )
                    )
                    results_params.append(params_c)
                    results_assign.append(np.asarray(assign_c))
                    objectives.append(obj)
        if not fast:
            # memory model for the vmapped dense path: each restart's
            # E/M materializes an (n, D, C)-scale weighted-stats tensor
            # (D = T(d+l)); the observed blow-up is ≈ 4·n·D·C bytes per
            # restart (f32; ~5 GB each at n = 1M, D=80, C=16).  Clamp the batch to a ~6 GB
            # budget; the sequential fused route (`fast`) remains the
            # production path at scale.
            D_joint = z.shape[0] * (z.shape[-1] + x.shape[-1])
            per_restart = 4 * z.shape[1] * D_joint * self.n_clusters
            mem_cap = max(1, int(6e9 // max(per_restart, 1)))
            starts_per_batch = min(starts_per_batch, mem_cap)
        batch_ranges = (
            [] if fast else range(0, len(candidates), starts_per_batch)
        )
        for lo in batch_ranges:
            batch = candidates[lo : lo + starts_per_batch]
            params0 = jax.tree.map(
                lambda *xs: jnp.stack(xs),
                *[c._stacked_params() for c in batch],
            )
            assign0 = jnp.asarray(
                np.stack([c.cluster_assignment for c in batch])
            )
            params_b, assign_b, _iters, status_b, obj_b = (
                em.train_em_multistart(
                    params0,
                    assign0,
                    z,
                    x,
                    v,
                    patterns,
                    pid,
                    n_steps=n_steps,
                    reg_mode=reg_mode,
                    alpha=float(self.alpha),
                )
            )
            obj_np = np.asarray(obj_b, dtype=float)
            for k in range(len(batch)):
                results_params.append(
                    jax.tree.map(lambda a, k=k: a[k], params_b)
                )
                results_assign.append(np.asarray(assign_b[k]))
                # init-guard-aborted starts carry their (random) constructor
                # parameters, so obj is the untrained objective — exactly the
                # value the reference's selection loop would see
                objectives.append(obj_np[k])

        objectives = np.asarray(objectives)
        best_i = 0
        for i in range(1, len(candidates)):
            if objectives[i] > objectives[best_i]:
                best_i = i
        if not np.isfinite(objectives[best_i]):
            raise Exception("training failed")

        best_mdl = candidates[best_i]
        # init-guard-aborted candidates keep their constructor parameters,
        # matching the reference's untrained-return (mixture:1328-1336)
        st = np.asarray(results_assign[best_i])
        best_mdl._set_params(results_params[best_i])
        best_mdl.cluster_assignment = st
        best_mdl.last_trained = (
            datetime.datetime.now(datetime.timezone.utc)
            .replace(microsecond=0)
            .astimezone()
            .isoformat()
        )
        if verbose:
            print(f"Best start: {best_i} with objective {objectives[best_i]}")
        if use_cache:
            best_mdl.to_pickle()
        if return_objectives:
            return best_mdl, objectives
        return best_mdl

    # ------------------------------------------------------------------
    # reporting / plotting
    # ------------------------------------------------------------------

    def print_model(self, *, verbose: bool = False, line_len: int = 79):
        """Pretty-print parameters per lettered cluster (reference
        mixture:321-373)."""
        print(
            "MixtureModelLinearGaussianStateSpace |".ljust(line_len, "=") + "\n"
        )
        for s in string.ascii_uppercase[: self.n_clusters]:
            c = self.inverse_correspondence[s]
            print(f"Cluster {s} |".ljust(line_len, "-"))
            print(f"Cluster propensity:\n {self.cluster_propensities[c]:.3f}")
            print(
                f"Initial state mean:\n "
                f"{np.round(self.init_state_means[c], 3)}"
            )
            if verbose:
                print(
                    f"Initial state cov:\n "
                    f"{np.round(self.init_state_covs[c], 3)}"
                )
            print(
                f"State transition coeffs:\n "
                f"{np.round(self.transition_matrices[c], 3)}"
            )
            if verbose:
                print(
                    f"Transition cov:\n {np.round(self.transition_covs[c], 3)}"
                )
            print(
                f"Measurement coeffs:\n "
                f"{np.round(self.measurement_matrices[c], 3)}"
            )
            if verbose:
                print(
                    f"Measurement cov:\n "
                    f"{np.round(self.measurement_covs[c], 3)}"
                )
        print(f"{self.last_trained=}")
        print(f"{self.hex_hash=}")
        print("=" * line_len)

    def print_tests(
        self,
        *,
        test_1: bool = False,
        test_01: bool = False,
        test_obs: bool = False,
    ) -> None:
        """Per-cluster OLS diagnostics of the transition/measurement models
        (reference mixture:375-437 uses statsmodels; this prints an
        equivalent scipy-based OLS summary: coefficients, t stats, p values,
        R², plus the optional hypothesis t-tests)."""
        for s in string.ascii_uppercase[: self.n_clusters]:
            c = self.inverse_correspondence[s]
            mask = self.cluster_assignment == c
            Zp = np.vstack(list(self.states[:-1, mask, :]))
            Zn = np.vstack(list(self.states[1:, mask, :]))
            keep = np.isfinite(np.column_stack([Zp, Zn])).all(axis=1)
            Zp, Zn = Zp[keep], Zn[keep]
            for i in range(self.d_states):
                print(f" Cluster {s} -- State {i} ".center(78, "-"))
                _print_ols_summary(Zp, Zn[:, i])
                if test_1:
                    _print_t_test(Zp, Zn[:, i], {i: 1.0})
                if test_01:
                    other = 0 if i + 1 == 2 else 1
                    _print_t_test(Zp, Zn[:, i], {other: 0.0, i: 1.0})
            if test_obs:
                Xs = np.vstack(list(self.observations[:, mask, :]))
                Zs = np.vstack(list(self.states[:, mask, :]))
                keep = np.isfinite(np.column_stack([Xs, Zs])).all(axis=1)
                Xs, Zs = Xs[keep], Zs[keep]
                for j in range(self.d_observations):
                    print(f" Cluster {s} -- Observation {j} ")
                    _print_ols_summary(Zs, Xs[:, j])

    def superimpose_model_on_plot(self, ax, std_param):
        """Contour the initial-state Gaussians on an existing 2-D axis
        (reference mixture:1675-1704)."""
        for i, s in enumerate(string.ascii_uppercase[: self.n_clusters]):
            c = self.inverse_correspondence[s]
            me, co = util.unstandardize_mean_and_cov(
                self.init_state_means[c],
                self.init_state_covs[c],
                params=std_param,
            )
            xv, yv = np.meshgrid(
                np.linspace(*ax.get_xlim(), num=1000),
                np.linspace(*ax.get_ylim(), num=1000),
            )
            zv = sp_stats.multivariate_normal(mean=me, cov=co).pdf(
                np.dstack((xv, yv))
            )
            ax.contour(
                xv,
                yv,
                zv,
                colors=_CLUSTER_COLORS[i],
                linewidths=np.flip(1.5 ** -np.arange(10)),
            )

    def get_initial_means_and_stds(self, std_param=None):
        """{cluster letter: {"μ": …, "σ": …}} of initial (z, x) features
        (reference mixture:1706-1735)."""
        out = {}
        for j in range(self.n_clusters):
            mz = self.init_state_means[j]
            cz = self.init_state_covs[j]
            H = self.measurement_matrices[j]
            mx = mz @ H
            cx = self.measurement_covs[j] + H.T @ cz @ H
            if std_param is not None:
                mz, cz = util.unstandardize_mean_and_cov(
                    mz, cz, params=std_param
                )
            mzx = np.concatenate([mz, mx])
            var = np.concatenate(
                [np.diag(np.atleast_2d(cz)), np.diag(np.atleast_2d(cx))]
            )
            out[self.correspondence[j]] = {"μ": mzx, "σ": np.sqrt(var)}
        return out

    def get_initial_diffs_means_and_stds(self, std_param=None):
        """Same for first differences (step 2 minus step 1; reference
        mixture:1737-1794)."""
        d, l = self.d_states, self.d_observations
        coeff = np.block(
            [
                [-np.eye(d), np.eye(d), np.zeros((d, 2 * l))],
                [np.zeros((l, 2 * d)), -np.eye(l), np.eye(l)],
            ]
        )
        out = {}
        for j in range(self.n_clusters):
            mean2 = np.asarray(
                ops.joint_mean(
                    2,
                    jnp.asarray(self.init_state_means[j]),
                    jnp.asarray(self.transition_matrices[j]),
                    jnp.asarray(self.measurement_matrices[j]),
                )
            )
            cov2 = np.asarray(
                ops.joint_cov(
                    2,
                    jnp.asarray(self.init_state_covs[j]),
                    jnp.asarray(self.transition_matrices[j]),
                    jnp.asarray(self.transition_covs[j]),
                    jnp.asarray(self.measurement_matrices[j]),
                    jnp.asarray(self.measurement_covs[j]),
                )
            )
            mu = coeff @ mean2
            cc = coeff @ cov2 @ coeff.T
            if std_param is not None:
                mu[:d], cc[:d, :d] = util.unstandardize_mean_and_cov_diffs(
                    mu[:d], cc[:d, :d], params=std_param
                )
            out[self.correspondence[j]] = {
                "μ": mu,
                "σ": np.sqrt(np.diag(np.atleast_2d(cc))),
            }
        return out

    def plot_cluster_propensity_evolution(
        self,
        savename: str,
        *,
        title: str = "Cluster Assignment Probability (using observed only) \n"
        "vs. Number of Time steps",
        observations=None,
    ) -> None:
        """Mean ± sem of membership probability in the finally-assigned
        cluster over time, observed data only (reference mixture:1473-1571).
        """
        self._plot_propensity_evolution(
            savename,
            title,
            self.observed_cluster_propensities_over_time(
                observations=observations
            ),
            self.observations_mle_cluster_assignment(
                observations=observations
            ),
            (
                self.observations.shape[0]
                if observations is None
                else observations.shape[0]
            ),
        )

    def plot_overall_cluster_propensity_evolution(
        self,
        savename: str,
        *,
        title: str = "Cluster Assignment Probability\n"
        "vs. Number of Time steps",
        observations=None,
        states=None,
    ) -> None:
        """Same using both hidden and observed data (reference
        mixture:1573-1673)."""
        if observations is None:
            observations = self.observations
            states = self.states
        self._plot_propensity_evolution(
            savename,
            title,
            self.cluster_propensities_over_time(
                states=states, observations=observations
            ),
            self.mle_cluster_assignment(
                states=states, observations=observations
            ),
            observations.shape[0],
        )

    def _plot_propensity_evolution(
        self, savename, title, propensities_over_time, final_assignments, _T0
    ) -> None:
        assert final_assignments.shape[0] == propensities_over_time.shape[1]
        chosen = np.stack(
            [
                propensities_over_time[:, i, final_assignments[i]]
                for i in range(propensities_over_time.shape[1])
            ]
        )
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.spines["right"].set_visible(False)
        ax.spines["top"].set_visible(False)
        for i, s in enumerate(string.ascii_uppercase[: self.n_clusters]):
            sel = final_assignments == self.inverse_correspondence[s]
            ax.errorbar(
                x=np.arange(_T0) + 0.025 * (i - int(self.n_clusters / 2)),
                y=np.nanmean(chosen[sel], axis=0).T,
                yerr=sp_stats.sem(chosen[sel], axis=0).T,
                color=_CLUSTER_COLORS[i],
                linestyle="solid",
                label=f"cluster {s}",
                capsize=5,
            )
        handles, labels = ax.get_legend_handles_labels()
        uniq = dict(zip(labels, handles))
        ax.legend(uniq.values(), uniq.keys(), fontsize="large")
        plt.xticks(
            ticks=range(self.n_timesteps),
            labels=range(1, self.n_timesteps + 1),
        )
        plt.title(title)
        ax.set_xlabel("Time steps")
        ax.set_ylabel("Probability")
        plt.savefig(savename, transparent=True)

    @staticmethod
    def plot_matrix(
        mat,
        *,
        show_colorbar: bool = False,
        show_labels: bool = True,
        xticks: list = None,
        xlabel: str = None,
        yticks: list = None,
        ylabel: str = None,
        title: str = None,
        fmt_str: str = "{:.2f}",
        figsize: tuple = (6.4, 4.8),
        savename=None,
        show: bool = False,
    ):
        """Annotated matshow of a parameter matrix (reference
        mixture:1796-1852)."""
        mat = np.atleast_2d(mat)
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(layout="constrained", figsize=figsize)
        im = ax.matshow(mat, cmap="cividis")
        if show_colorbar:
            ax.figure.colorbar(im, ax=ax)
        if xticks:
            ax.set_xticks(np.arange(len(xticks)), labels=xticks)
            plt.setp(
                ax.get_xticklabels(),
                rotation=-30,
                ha="right",
                rotation_mode="anchor",
            )
        if yticks is not None:
            ax.set_yticks(np.arange(len(yticks)), labels=yticks)
        if title is not None:
            plt.title(title)
        if xlabel is not None:
            plt.xlabel(xlabel)
        if ylabel is not None:
            plt.ylabel(ylabel)
        if show_labels:
            mid = np.mean(im.get_clim())
            for (i, j), val in np.ndenumerate(mat):
                ax.text(
                    j,
                    i,
                    fmt_str.format(val),
                    ha="center",
                    va="center",
                    c="black" if val > mid else "white",
                )
        plt.tick_params(bottom=False)
        if mat.shape[0] == 1:
            plt.tick_params(left=False, labelleft=False, bottom=False)
        if savename is not None:
            plt.savefig(savename, transparent=True)
        if show:
            plt.show()

    @staticmethod
    def ponder():
        import webbrowser

        webbrowser.open_new_tab("https://doi.org/10.1017/prm.2023.96")

    def generate_model_plots(self, folder, **kwargs):
        """One annotated-matrix PDF per parameter per cluster (reference
        mixture:1860-1916)."""
        sub = os.path.join(folder, f"{self.hex_hash}-{self.n_clusters}cl")
        os.makedirs(sub, exist_ok=True)
        order = np.argsort(
            np.array(
                [self.correspondence[i] for i in range(self.n_clusters)]
            )
        )
        self.plot_matrix(
            self.cluster_propensities[order],
            savename=os.path.join(sub, f"{self.hex_hash}-propensities.pdf"),
            title="Overall cluster propensities",
            **kwargs,
        )
        for c in range(self.n_clusters):
            for param in (
                "init_state_means",
                "init_state_covs",
                "transition_matrices",
                "transition_covs",
                "measurement_matrices",
                "measurement_covs",
            ):
                self.plot_matrix(
                    getattr(self, param)[c],
                    savename=os.path.join(
                        sub,
                        "{hh}-{par}-{cl}.pdf".format(
                            hh=self.hex_hash,
                            par=param,
                            cl=self.correspondence[c],
                        ),
                    ),
                    title="Cluster {c} {param}".format(
                        c=self.correspondence[c],
                        param=param[:-1]
                        .replace("_", " ")
                        .replace("matrice", "matrix"),
                    ),
                    **kwargs,
                )


# --------------------------------------------------------------------------
# small host helpers
# --------------------------------------------------------------------------


def _softmax_cols(logits: np.ndarray) -> np.ndarray:
    """Column-wise softmax of a (C, n) matrix of log-probabilities."""
    z = logits - np.max(logits, axis=0, keepdims=True)
    e = np.exp(z)
    return e / np.sum(e, axis=0, keepdims=True)


def _logsumexp_cols(logits: np.ndarray) -> np.ndarray:
    mx = np.max(logits, axis=0)
    return mx + np.log(np.sum(np.exp(logits - mx[None, :]), axis=0))


def _print_ols_summary(X: np.ndarray, y: np.ndarray) -> None:
    """Minimal OLS summary (coefficients, std errors, t, p, R²) — a
    scipy-based stand-in for statsmodels' ``OLS(...).fit().summary()``."""
    n, p = X.shape
    beta, *_ = np.linalg.lstsq(X, y, rcond=None)
    resid = y - X @ beta
    dof = n - p
    sigma2 = resid @ resid / dof
    XtX_inv = np.linalg.pinv(X.T @ X)
    se = np.sqrt(np.diag(XtX_inv) * sigma2)
    tvals = beta / se
    pvals = 2 * sp_stats.t.sf(np.abs(tvals), dof)
    ss_tot = np.sum((y - y.mean()) ** 2)
    r2 = 1 - resid @ resid / ss_tot if ss_tot > 0 else np.nan
    print(f"OLS  n={n}  dof={dof}  R²={r2:.4f}  sigma²={sigma2:.4f}")
    for i in range(p):
        print(
            f"  x{i + 1}: coef={beta[i]: .4f}  se={se[i]:.4f}  "
            f"t={tvals[i]: .3f}  p={pvals[i]:.4g}"
        )


def _print_t_test(
    X: np.ndarray, y: np.ndarray, hypotheses: dict[int, float]
) -> None:
    """Joint t-tests of ``beta[k] == value`` for each (k, value) pair."""
    n, p = X.shape
    beta, *_ = np.linalg.lstsq(X, y, rcond=None)
    resid = y - X @ beta
    dof = n - p
    sigma2 = resid @ resid / dof
    XtX_inv = np.linalg.pinv(X.T @ X)
    desc = ", ".join(f"x{k + 1}={v}" for k, v in hypotheses.items())
    print(f"testing {desc}")
    for k, v in hypotheses.items():
        se = np.sqrt(XtX_inv[k, k] * sigma2)
        t = (beta[k] - v) / se
        pv = 2 * sp_stats.t.sf(np.abs(t), dof)
        print(f"  x{k + 1}: t={t:.3f}  p={pv:.4g}  dof={dof}")
    print(f"dof={dof}")
