#!/usr/bin/env python3
"""Model-selection sweep: fit the LG-SSM mixture for 1..7 clusters on ADNI
and plot elbow curves of Q / AIC / BIC.

Behavioral equivalent of the reference driver (model-selection.py:26-104):
standardized hidden states, alpha=1.0, 1000 random starts per cluster count
with the content-addressed cache, figures into ``figures/``.
"""

import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import jax

from multimodal_trajectory_modeling_tpu import config as mtm_config

# Parity mode: the reference computes in float64, so the ADNI-scale drivers
# run on CPU x64 by default (set MTM_DEVICE=gpu for float32 on the GPU).
if os.environ.get("MTM_DEVICE", "cpu") == "cpu":
    mtm_config.use_cpu_x64()
mtm_config.enable_persistent_compilation_cache()

import matplotlib.pyplot as plt

from multimodal_trajectory_modeling_tpu.models import (
    MMLinGaussSS_marginalizable,
)
from multimodal_trajectory_modeling_tpu.utils import adni as data_adni
from multimodal_trajectory_modeling_tpu.utils import state_space as util

plt.rcParams.update(
    {
        "figure.autolayout": True,
        "legend.loc": "upper right",
        "font.family": "serif",
    }
)

ALPHA = 1.0
CLUSTER_COUNTS = range(1, 8)
N_STARTS = int(os.environ.get("MTM_N_RESTARTS", "1000"))

# y-axis label → model criterion method, one elbow figure each
CRITERIA = {
    "Expected complete data log likelihood": "e_complete_data_log_lik",
    "AIC": "aic",
    "BIC": "bic",
}


def _fit_sweep(z, x):
    """One multistart-trained mixture per cluster count, cache-backed."""
    fitted = []
    for k in CLUSTER_COUNTS:
        mix = MMLinGaussSS_marginalizable(
            n_clusters=k,
            states=z,
            observations=x,
            init="k-means",
            alpha=ALPHA,
        )
        fitted.append(
            mix.train_with_multiple_random_starts(
                n_starts=N_STARTS, use_cache=True
            )
        )
    return fitted


def _elbow_figure(values, ylabel, out_pdf):
    """Open-spine elbow plot of a criterion over the cluster counts."""
    fig, ax = plt.subplots()
    for side in ("right", "top"):
        ax.spines[side].set_visible(False)
    ax.plot(
        CLUSTER_COUNTS, values, "o-", color="#0072CE", linestyle="solid"
    )
    plt.xticks(ticks=CLUSTER_COUNTS, labels=CLUSTER_COUNTS)
    ax.set_xlabel("Number of clusters")
    ax.set_ylabel(ylabel)
    plt.tight_layout()
    plt.savefig(out_pdf, bbox_inches="tight", transparent=True)
    plt.close(fig)


def main():
    z_raw, x, *_ = data_adni.get_trajectories()
    z, _std = util.standardize(z_raw, return_params=True)

    models = _fit_sweep(z, x)

    os.makedirs("figures", exist_ok=True)
    for label, attr in CRITERIA.items():
        values = [
            getattr(m, attr)(states=z, observations=x) for m in models
        ]
        _elbow_figure(
            values,
            label,
            os.path.join("figures", f"ADNI_elbow_plot_{attr.upper()}.pdf"),
        )
        print(f"{label}: {[round(float(vv), 1) for vv in values]}")

    for m in models:
        m.to_pickle()


if __name__ == "__main__":
    main()
