"""Host-side state-space utilities: regression MLE wrappers, data
transforms, NaN-shape tooling, weighted moments and the plotting suite.

Functionally equivalent to the reference's ``util/util_state_space.py``
(cited per function); array math that can benefit from the accelerator is
delegated to :mod:`multimodal_trajectory_modeling_tpu.ops`.
"""

from __future__ import annotations

import datetime
import itertools
import re
import string

import jax.numpy as jnp
import numpy as np
import scipy.stats as sp_stats

from multimodal_trajectory_modeling_tpu import ops


def _pyplot():
    """matplotlib's pyplot with this module's style — imported on first
    plot, so the numeric utilities need no matplotlib."""
    import matplotlib.pyplot as plt

    plt.rcParams["figure.autolayout"] = True
    plt.rcParams["legend.loc"] = "upper right"
    plt.rcParams["font.family"] = "serif"
    return plt

CLUSTER_COLORS = (
    "#0072CE",
    "#E87722",
    "#64A70B",
    "#93328E",
    "#A81538",
    "#4E5B31",
)
_MARKERS = ("o", "v", "^", "s", "+", "x")
_LINESTYLES = (
    "solid", "dotted", "dashed", "dashdot",
    "densely dashdotted", "loosely dashdotted",
)


# --------------------------------------------------------------------------
# regression MLE (reference util_state_space.py:33-94)
# --------------------------------------------------------------------------


def regress(X: np.ndarray, Y: np.ndarray, eps: float = 1e-6):
    """MLE of ``Y|X ~ N(X A, S)`` with any-NaN rows dropped; solves the
    eps-ridged normal equations (reference util_state_space.py:33-61)."""
    A, S = ops.regress(jnp.asarray(X), jnp.asarray(Y), mode="eps", eps=eps)
    return np.asarray(A), np.asarray(S)


def regress_alpha(X: np.ndarray, Y: np.ndarray, alpha: float):
    """Ridge variant, matching sklearn ``Ridge(fit_intercept=False)``
    (reference util_state_space.py:64-94)."""
    A, S = ops.regress(jnp.asarray(X), jnp.asarray(Y), mode="ridge", alpha=alpha)
    return np.asarray(A), np.asarray(S)


# --------------------------------------------------------------------------
# shape / NaN tooling (reference util_state_space.py:97-441, 1049-1130)
# --------------------------------------------------------------------------


def nancat(arr1: np.ndarray, arr2: np.ndarray) -> np.ndarray:
    """Concatenate two ``T × n × dim`` arrays along the instance axis,
    NaN-padding the shorter one in time (reference :97-139)."""
    assert arr2.shape[2:] == arr1.shape[2:]
    T = max(arr1.shape[0], arr2.shape[0])

    def pad(a):
        if a.shape[0] == T:
            return a
        fill = np.full((T - a.shape[0], *a.shape[1:]), np.nan)
        return np.concatenate([a, fill], axis=0)

    return np.concatenate([pad(arr1), pad(arr2)], axis=1)


def standardize(arr, *, params=None, return_params: bool = False):
    """Scale per-feature to [0.1, 1] over the (time, instance) axes
    (reference :142-178)."""
    if params is None:
        lo = np.nanmin(arr, axis=(0, 1), keepdims=True)
        hi = np.nanmax(arr, axis=(0, 1), keepdims=True)
    else:
        lo, hi = params["arr_mn"], params["arr_mx"]
    # op order matches the reference exactly (util_state_space.py:174) so
    # standardized bytes — and hence the md5 model-cache keys — are
    # bit-identical (verified: 3-cluster ADNI hash 49cb9120d3a1…, the hash
    # hardcoded in the reference's MACC transfer driver)
    out = 0.9 * np.divide(arr - lo, hi - lo) + 0.1
    if return_params:
        return out, {"arr_mn": lo, "arr_mx": hi}
    return out


def unstandardize(arr, params):
    """Inverse of :func:`standardize` (reference :181-209)."""
    out = (params["arr_mx"] - params["arr_mn"]) / 0.9 * (arr - 0.1) + params[
        "arr_mn"
    ]
    assert np.allclose(standardize(out, params=params), arr)
    return out


def unstandardize_mean_and_cov(mean, cov, params):
    """Push Gaussian moments through the inverse standardization
    (reference :212-240)."""
    mean_u = unstandardize(mean.reshape((1, 1, -1)), params=params).reshape(
        mean.shape
    )
    J = np.diag(((params["arr_mx"] - params["arr_mn"]) / 0.9).ravel())
    return mean_u, J @ cov @ J.T


def unstandardize_mean_and_cov_diffs(mean_diff, cov_diff, params):
    """Same for *differences* (no offset term; reference :243-268)."""
    J = np.diag(((params["arr_mx"] - params["arr_mn"]) / 0.9).ravel())
    return J @ mean_diff, J @ cov_diff @ J.T


def normalize(
    arr, eps=np.finfo(float).eps, *, params=None, return_params=False
):
    """Z-score per feature over (time, instance) axes (reference :271-310)."""
    if params is None:
        mu = np.nanmean(arr, axis=(0, 1), keepdims=True)
        sd = np.nanstd(arr, axis=(0, 1), keepdims=True) + eps
    else:
        mu, sd = params["arr_mean"], params["arr_std"]
    out = (arr - mu) / sd
    if return_params:
        return out, {"arr_mean": mu, "arr_std": sd}
    return out


def unnormalize(arr, params):
    """Inverse of :func:`normalize` (reference :313-339)."""
    out = params["arr_std"] * arr + params["arr_mean"]
    assert np.allclose(normalize(out, params=params), arr)
    return out


def take_finite_along_axis(arr: np.ndarray, axis: int = 0) -> np.ndarray:
    """Keep only the slices along ``axis`` that are entirely finite
    (reference :342-381)."""
    others = tuple(a for a in range(arr.ndim) if a != axis)
    keep = np.isfinite(arr).all(axis=others)
    shape = list(arr.shape)
    shape[axis] = -1
    return np.take(arr, np.flatnonzero(keep), axis).reshape(shape)


def mask_all_but_time_i(arr: np.ndarray, i: int) -> np.ndarray:
    """NaN everything except time step ``i`` (reference :384-405)."""
    out = np.full_like(arr, np.nan)
    out[i] = arr[i]
    return out


def mask_all_but_time_i_vect(arr: np.ndarray, i: np.ndarray) -> np.ndarray:
    """Per-instance version: keep time ``i[j]`` for instance j
    (reference :408-414)."""
    assert len(i) == arr.shape[1]
    out = np.full_like(arr, np.nan)
    cols = np.arange(arr.shape[1])
    out[np.asarray(i), cols] = arr[np.asarray(i), cols]
    return out


def parcellate_arrays(*args):
    """Widen each array into per-time-step single-visit snapshots along the
    instance axis (reference :417-440)."""
    return (
        np.concatenate(
            [mask_all_but_time_i(a, t) for t in range(a.shape[0])], axis=1
        )
        for a in args
    )


def get_finite_length(arr: np.ndarray) -> np.ndarray:
    """Length of the fully-finite prefix of each trajectory
    (reference :1049-1076)."""
    fin = np.isfinite(arr).all(axis=-1)  # (T, n)
    return np.where(fin.all(axis=0), fin.shape[0], np.argmin(fin, axis=0))


def take_final_finite(arr: np.ndarray) -> np.ndarray:
    """Last fully-finite snapshot of each trajectory (reference :1079-1105)."""
    last = get_finite_length(arr) - 1
    assert np.all(last >= 0)
    return arr[last, np.arange(arr.shape[1])]


def add_constant_where_finite(arr: np.ndarray) -> np.ndarray:
    """Append a 1.0 column wherever any feature is finite, NaN elsewhere
    (reference :1108-1130)."""
    const = np.where(np.isfinite(arr).any(axis=-1)[..., None], 1.0, np.nan)
    return np.concatenate([arr, const], axis=-1)


def weighted_mean_and_covariance(values: np.ndarray, weights: np.ndarray):
    """NaN-aware weighted mean/covariance per time step, with per-cell
    finite-count denominators (reference :443-491)."""
    assert (np.asarray(weights) >= 0).all()
    vals = np.nan_to_num(values)
    fin = np.isfinite(values).astype(float)
    num = np.einsum("tnd,n->td", vals, weights)
    den = np.einsum("tnd,n->td", fin, weights)
    mean = num / den
    centered = values - mean[:, None, :]
    cfin = np.isfinite(centered).astype(float)
    cnum = np.einsum(
        "tnd,n,tne->tde", np.nan_to_num(centered), weights, np.nan_to_num(centered)
    )
    cden = np.einsum("tnd,n,tne->tde", cfin, weights, cfin)
    return mean, cnum / cden


# --------------------------------------------------------------------------
# misc (reference :1133-1151)
# --------------------------------------------------------------------------


def today_str() -> str:
    return datetime.datetime.now(tz=datetime.timezone.utc).strftime("%Y-%m-%d")


def slugify(s: str) -> str:
    underscored = re.sub("[^0-9a-zA-Z_]", "_", s.lower())
    return re.sub("_+", "_", underscored).strip(" _")


def tidy_labels(n_list: list[str], truncate_after: int = 42) -> list[str]:
    return [n.replace("_", " ")[:truncate_after] for n in n_list]


# --------------------------------------------------------------------------
# group statistics (reference :987-1046)
# --------------------------------------------------------------------------


def summarize_metric_vs_cluster(
    metric: np.ndarray, cluster_assignment: np.ndarray,
    names: list = None, cluster_ordering=None,
) -> None:
    """Print per-cluster means and pairwise two-sided t-test p-values."""
    import pandas as pd
    n_clusters = len(set(cluster_assignment))
    ordered = cluster_ordering or string.ascii_uppercase[:n_clusters]
    assert len(cluster_assignment) == metric.shape[0]
    if names is not None:
        assert len(names) == metric.shape[1]
    groups = {a: metric[cluster_assignment == a] for a in ordered}

    means = {a: np.nanmean(g, axis=0) for a, g in groups.items()}
    mean_tbl = pd.DataFrame(means, index=[f"{nm}_mean" for nm in names]).T
    print(mean_tbl.rename_axis("cluster"))

    pvals = {
        f"{a}_vs_{b}": sp_stats.ttest_ind(
            groups[a], groups[b], nan_policy="omit", alternative="two-sided"
        ).pvalue
        for a, b in itertools.combinations(groups, 2)
    }
    pval_tbl = pd.DataFrame(pvals, index=[f"{nm}_pval" for nm in names]).T
    print(pval_tbl.rename_axis("comparison"))


# --------------------------------------------------------------------------
# plotting suite (reference :494-985, 1154-1307)
# --------------------------------------------------------------------------


def _despine(ax):
    ax.spines["right"].set_visible(False)
    ax.spines["top"].set_visible(False)


def _new_axes(**subplots_kwargs):
    """One despined axes, the house style for every figure here."""
    plt = _pyplot()
    fig, ax = plt.subplots(**subplots_kwargs)
    _despine(ax)
    return fig, ax


def _legend_dedup(ax):
    """label -> handle with repeated labels collapsed (one legend entry per
    cluster even when a cluster drew many artists)."""
    handles, labels = ax.get_legend_handles_labels()
    return dict(zip(labels, handles))


def plot_metric_vs_clusters_over_time(
    metric: np.ndarray, assignments: np.ndarray, metric_name: str, *,
    savename, title: str, xticks=None, xlabel: str = "Time steps",
    xlim=None, ylim=None, legend_loc=None, legend_anchor=(1.5, 1),
    colors=CLUSTER_COLORS, show: bool = False,
) -> None:
    """Mean ± 1 s.e.m. of a metric per cluster over time (reference
    :494-580)."""
    plt = _pyplot()
    n_steps = metric.shape[0]
    assert len(assignments) == metric.shape[1]
    n_clusters = len(set(assignments))
    fig, ax = _new_axes()
    for i, c in enumerate(string.ascii_uppercase[:n_clusters]):
        grp = metric[:, assignments == c]
        jittered = np.arange(n_steps) + 0.025 * (i - n_clusters // 2)
        ax.errorbar(
            x=xticks if xticks is not None else jittered,
            y=np.nanmean(grp, axis=1).T,
            yerr=sp_stats.sem(grp, axis=1, nan_policy="omit").T,
            color=colors[i], linestyle=_LINESTYLES[i],
            label=f"cluster {c}", capsize=5,
        )
    uniq = _legend_dedup(ax)
    ax.legend(
        uniq.values(), uniq.keys(), fontsize="large",
        loc=legend_loc if legend_loc is not None else plt.rcParams["legend.loc"],
        bbox_to_anchor=legend_anchor,
    )
    tick_pos = xticks if xticks is not None else range(n_steps)
    tick_lab = xticks if xticks is not None else range(1, n_steps + 1)
    ax.set_xticks(tick_pos, labels=tick_lab)
    if title:
        ax.set_title(title, fontsize="large")
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    ax.set_xlabel(xlabel, fontsize="large")
    ax.set_ylabel(metric_name, fontsize="large")
    fig.savefig(savename, bbox_inches="tight", transparent=True)
    if show:
        plt.show()


def _normal_pdf(pts, mu, sd):
    return np.exp(-0.5 * np.square((pts - mu) / sd)) / (
        sd * np.sqrt(2.0 * np.pi)
    )


def histograms_by_cluster(
    *, savename="", title: str = "Histograms by cluster", metrics=None,
    metric_names=None, clusters=None, cluster_ordering=None,
    show: bool = False, nrows: int = 2, ncols: int = 3, nbins: int = 20,
    density: bool = True, verbose: bool = False, mean_overlay: bool = True,
    normal_overlay: bool = False, μσ_overlay=None, tighten=True,
    colors=CLUSTER_COLORS, alpha: float = 0.5,
) -> None:
    """Grid of overlapping per-cluster histograms, optionally with Gaussian
    overlays from model moments (reference :583-746)."""
    plt = _pyplot()
    c_labels = cluster_ordering or sorted(np.unique(clusters).tolist())
    fig, axs = plt.subplots(nrows, ncols, layout="constrained")
    panels = np.atleast_2d(axs).reshape(nrows, ncols).ravel()
    for spare in panels[len(metric_names):]:
        fig.delaxes(spare)
    for m_num, ax in enumerate(panels[: len(metric_names)]):
        for k, lbl in enumerate(c_labels):
            vals = metrics[clusters == lbl, m_num]
            if vals.size == 0:
                continue
            label = f"cluster {lbl}"
            if verbose:
                label = "cluster {c} (μ={mu},σ={sd})".format(
                    c=lbl,
                    mu=np.round(np.nanmean(vals), 2),
                    sd=np.round(np.nanstd(vals), 2),
                )
            ax.hist(
                x=vals, label=label, bins=nbins, color=colors[k],
                alpha=alpha, density=density,
            )
            if mean_overlay:
                ax.axvline(np.nanmean(vals), color=colors[k])
            if normal_overlay:
                pts = np.linspace(*ax.get_xlim(), 1000)
                curve = _normal_pdf(pts, np.nanmean(vals), np.nanstd(vals))
                ax.plot(pts, curve, color=colors[k])
            if μσ_overlay is not None:
                pts = np.linspace(*ax.get_xlim(), 1000)
                mu = μσ_overlay[lbl]["μ"][m_num]
                sd = μσ_overlay[lbl]["σ"][m_num]
                ax.plot(pts, _normal_pdf(pts, mu, sd), color=colors[k])
            ax.set_title(metric_names[m_num], fontsize="large")
            _despine(ax)
            if verbose:
                ax.legend(fontsize="large")
    if not verbose and len(c_labels) > 1:
        uniq = _legend_dedup(panels[0])
        fig.legend(
            uniq.values(), uniq.keys(), fontsize="large",
            loc="upper right", bbox_to_anchor=(1.3, 1.0),
        )
    if tighten:
        plt.tight_layout()
    if title:
        fig.suptitle(title, size=30)
    if savename:
        fig.savefig(savename, bbox_inches="tight", transparent=True)
    if show:
        plt.show()


def histogram(
    metrics=None, *, savename="", show: bool = False, title=None,
    density: bool = True, nbins: int = 25, figsize=(6.4, 4.8),
) -> None:
    """Single histogram (reference :749-795)."""
    fig, ax = _new_axes(layout="constrained", figsize=figsize)
    ax.hist(
        x=np.ravel(metrics), bins=nbins, color=CLUSTER_COLORS[0],
        alpha=1.0, density=density,
    )
    if title is not None:
        ax.set_title(title)
    if savename:
        fig.savefig(savename, transparent=True)
    if show:
        fig.show()


def pies_by_cluster(
    *, savename="", title: str = "", categories=None, category_ordering=None,
    category_legend_names=None, clusters=None, cluster_ordering=None,
    show: bool = False, nrows=None, ncols=None, slice_colors=None,
    legend_anchor=(0.0, 0.0), fig_length=None, fig_width=None,
    halo_colors=None,
) -> None:
    """Per-cluster pie charts of category composition (reference :798-925)."""
    plt = _pyplot()
    cluster_labels = cluster_ordering or sorted(np.unique(clusters).tolist())
    category_labels = category_ordering or sorted(np.unique(categories).tolist())
    nrows = nrows or len(cluster_labels)
    ncols = ncols or 1
    if slice_colors is None:
        cmap = plt.colormaps["cividis"].colors
        picks = np.linspace(0, len(cmap) - 1, len(category_labels)).astype(int)
        slice_colors = np.flipud(np.array(cmap)[picks]).tolist()
    fig, axs = plt.subplots(nrows, ncols, layout="constrained")
    panels = np.asarray(axs).reshape(nrows, ncols)
    patches = None
    for m_num, cluster in enumerate(cluster_labels[: nrows * ncols]):
        ax = panels[m_num // ncols, m_num % ncols]
        members = clusters == cluster
        sizes = [(members & (categories == cat)).sum() for cat in category_labels]
        patches, _ = ax.pie(sizes, colors=slice_colors)
        if halo_colors is not None:
            ring = plt.Circle(
                (0, 0), 1.0, color=halo_colors[m_num],
                linewidth=1.5, fill=False,
            )
            ax.add_patch(ring)
        ax.set_title(cluster)
    legend_names = category_labels
    if category_legend_names is not None:
        legend_names = [category_legend_names[c] for c in category_labels]
    panels[0, 0].legend(
        patches, legend_names,
        loc="upper right", bbox_to_anchor=legend_anchor,
    )
    width, height = fig_width, fig_length
    if fig_length is None or fig_width is None:
        width, height = ncols, nrows + 1
    fig.set_size_inches(width, height, forward=True)
    if title:
        fig.suptitle(title, size=30)
    if savename:
        fig.savefig(savename, bbox_inches="tight", transparent=True)
    if show:
        plt.show()


def pie(
    assignments, *, savename=None, title: str = "", cluster_ordering=None,
    show: bool = False, legend_anchor=(1.2, 1.0), colors=CLUSTER_COLORS,
):
    """Single pie of cluster prevalences (reference :928-984)."""
    plt = _pyplot()
    labels = cluster_ordering or sorted(np.unique(assignments).tolist())
    assert set(labels) == set(assignments)
    fig, ax = plt.subplots(layout="constrained")
    sizes = [(assignments == lbl).sum() for lbl in labels]
    patches, _ = ax.pie(
        sizes, colors=list(colors), explode=[0.03] * len(labels)
    )
    ax.legend(
        patches, labels, loc="upper right",
        bbox_to_anchor=legend_anchor,
    )
    if title is not None:
        ax.set_title(title, fontsize="large")
    if savename is not None:
        fig.savefig(savename, bbox_inches="tight", transparent=True)
    if show:
        plt.show()


def _gaussian_density_grid(mean, cov, gx, gy) -> np.ndarray:
    """Evaluate a 2-D Gaussian pdf on the meshgrid (gx, gy) directly from the
    closed form (inverse of a 2×2 is analytic), vectorized over the grid."""
    (a, b), (c, d) = np.asarray(cov, dtype=float)
    det = a * d - b * c
    dx, dy = gx - mean[0], gy - mean[1]
    quad = (d * dx * dx - (b + c) * dx * dy + a * dy * dy) / det
    return np.exp(-0.5 * quad) / (2.0 * np.pi * np.sqrt(det))


def _hpd_threshold(density: np.ndarray, mass: float) -> float:
    """Density level whose superlevel set holds `mass` of the grid's total
    probability: sort cell densities descending, walk the cumulative mass
    until it first reaches the target.  Deterministic replacement for the
    reference's Nelder-Mead threshold search (util_state_space.py:1266-1276);
    both answer "which contour of the *windowed* density encloses 68%"."""
    flat = np.sort(density, axis=None)[::-1]
    cdf = np.cumsum(flat)
    k = int(np.searchsorted(cdf, mass * cdf[-1]))
    return float(flat[min(k, flat.size - 1)])


def _weighted_trajectory_stats(values, weights, column, soft, stop):
    """Per-timestep weighted mean/cov of `values` under one cluster's
    responsibility column, cut at `stop` steps when requested."""
    w = (
        weights[:, column]
        if soft
        else (weights.argmax(axis=1) == column).astype(float)
    )
    mean_t, cov_t = weighted_mean_and_covariance(values, w)
    return (mean_t, cov_t) if stop is None else (mean_t[:stop], cov_t[:stop])


def plot_weighted_means_2d_trajectories(
    weights: np.ndarray, values: np.ndarray, colors: list, saveloc, *,
    xlabel: str = "β-amyloid", ylabel: str = "Gray matter density",
    xlim=(-50.0, 230.0), ylim=(-0.275, 0.025), arrow_width: float = 0.6,
    soft_assignment: bool = True, cov_alpha: float = 0.05,
    conf_thresh: float = 0.68, truncate_after: list = None,
    grid_resolution: int = 1000,
) -> None:
    """Posterior-weighted mean 2-D trajectories, one arrow chain + scatter
    markers per cluster, each timestep shaded with the numeric
    ``conf_thresh`` HPD region of its weighted Gaussian summary.

    Renders the same figure as the reference's helper
    (util_state_space.py:1154-1307); the HPD level here comes from the
    sorted-density CDF of the windowed grid (see :func:`_hpd_threshold`)
    rather than an optimizer, and the per-cell densities from the closed-form
    2-D Gaussian.
    """
    plt = _pyplot()
    fig, ax = _new_axes()
    ax.set(xlim=xlim, ylim=ylim)

    gx, gy = np.meshgrid(
        np.linspace(*xlim, num=grid_resolution),
        np.linspace(*ylim, num=grid_resolution),
    )
    cuts = truncate_after or [None] * weights.shape[1]

    for i, cut in enumerate(cuts[: weights.shape[1]]):
        mean_t, cov_t = _weighted_trajectory_stats(
            values, weights, i, soft_assignment, cut
        )
        step = np.diff(mean_t, axis=0)
        ax.quiver(
            mean_t[:-1, 0], mean_t[:-1, 1], step[:, 0], step[:, 1],
            color=colors[i], linestyle="solid", alpha=1.0,
            units="xy", angles="xy", scale_units="xy", scale=1,
            width=arrow_width, headwidth=2, headlength=2, headaxislength=1,
        )
        ax.scatter(
            mean_t[:, 0], mean_t[:, 1], c=colors[i], marker=_MARKERS[i],
            label=f"cluster {string.ascii_uppercase[i]}", s=4,
        )
        for m, v in zip(mean_t, cov_t):
            density = _gaussian_density_grid(m, v, gx, gy)
            ax.contourf(
                gx, gy, density, colors=CLUSTER_COLORS[i], alpha=cov_alpha,
                levels=[_hpd_threshold(density, conf_thresh), np.inf],
            )

    uniq = _legend_dedup(ax)
    ax.legend(
        uniq.values(), uniq.keys(), fontsize="large",
        bbox_to_anchor=(1.3, 1), markerscale=3,
    )
    ax.set_xlabel(xlabel, fontsize="large")
    ax.set_ylabel(ylabel, fontsize="large")
    plt.tight_layout()
    fig.savefig(saveloc, bbox_inches="tight", transparent=True)
