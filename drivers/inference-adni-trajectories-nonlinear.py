#!/usr/bin/env python3
"""Nonlinear component-model comparison on ADNI: kNN mixture, hybrid
(linear transition + kNN measurement) mixture, and the linear-Gaussian
mixture, for 3 and 4 clusters.

Behavioral equivalent of the reference driver
(inference-adni-trajectories-nonlinear.py:23-111); expected reference
outputs in its trailing docstring (:114-170) are the parity targets.
The three model families run through one spec-driven report loop; the
printed transcript (headers, outcome tables, ``<var>.hex_hash=`` lines)
is unchanged.
"""

import os
import sys
import textwrap

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

from multimodal_trajectory_modeling_tpu.models import (
    MMLinGaussSS_marginalizable,
)
from multimodal_trajectory_modeling_tpu.models.hybrid import StateSpaceHybrid
from multimodal_trajectory_modeling_tpu.models.knn_model import StateSpaceKNN
from multimodal_trajectory_modeling_tpu.models.ssm_mixture import (
    StateSpaceMixtureModel,
)
from multimodal_trajectory_modeling_tpu.utils import adni as data
from multimodal_trajectory_modeling_tpu.utils import state_space as util

ALPHA = 1.0
CLUSTER_COUNTS = [3, 4]
N_RESTARTS = int(os.environ.get("MTM_N_RESTARTS", "1000"))
N_JOBS = int(os.environ.get("MTM_N_JOBS", "1"))

KNN_GRID = [5, 10, 15]


def _fit_knn(k, z, x):
    return StateSpaceMixtureModel(
        n_clusters=k,
        data=(z, x),
        component_model=StateSpaceKNN,
        component_model_hyperparams={"n_neighbors": KNN_GRID},
    ).fit(n_restarts=N_RESTARTS, n_jobs=N_JOBS)


def _fit_hybrid(k, z, x):
    return StateSpaceMixtureModel(
        n_clusters=k,
        data=(z, x),
        component_model=StateSpaceHybrid,
        component_model_hyperparams={
            "n_neighbors": KNN_GRID,
            "alpha": ALPHA,
        },
    ).fit(n_restarts=N_RESTARTS, n_jobs=N_JOBS)


def _fit_lg(k, z, x):
    mdl = MMLinGaussSS_marginalizable(
        n_clusters=k,
        states=z,
        observations=x,
        random_seed=0,
        init="kmeans",
        alpha=ALPHA,
    ).train_with_multiple_random_starts(n_starts=N_RESTARTS)
    return mdl


# (transcript variable name, header lines, fit fn, figure stem,
#  re-pickle after correspondence relabeling?)
FAMILIES = [
    (
        "best_mdl_knn",
        ["Mixture of k-NN-based State Space models"],
        _fit_knn,
        "knn",
        False,
    ),
    (
        "best_mdl_hybrid",
        [
            "Mixture of state space models with linear transition model and",
            "k-NN-based measurement model",
        ],
        _fit_hybrid,
        "hybrid",
        False,
    ),
    (
        "best_mdl_lg0",
        ["Mixture of linear Gaussian State Space models"],
        _fit_lg,
        "lg",
        True,
    ),
]


def _report(varname, mdl, k, stem, diagnoses, z_unstd, repickle):
    """Correspondence-relabel, outcome table, 2-D figure, hash line."""
    data.set_model_correspondence(mdl, diagnoses)
    if repickle:
        mdl.to_pickle()  # persist the relabeling in the cache
    data.generate_outcome_table(mdl, diagnoses)
    data.plot_2d_trajectories(
        mdl,
        savename=os.path.join("figures", f"r7_adni_{stem}{k}cluster.pdf"),
        title="",
        states=z_unstd,
        xlabel="β-amyloid burden (centiloid)",
    )
    print(f"{varname}.hex_hash={mdl.hex_hash!r}")


def main():
    (z_raw, x, d, ids, time, mmse, approx_age) = data.get_trajectories(
        return_mmse=True, return_approx_age=True
    )
    z, std_param = util.standardize(z_raw, return_params=True)
    os.makedirs("figures", exist_ok=True)

    for k in CLUSTER_COUNTS:
        print(f"|n_clusters={k}|".upper().center(79, "="))
        first = True
        for varname, header, fit, stem, repickle in FAMILIES:
            if not first:
                print("-" * 79)
            first = False
            for j, line in enumerate(header):
                print(line.ljust(79, "-") if j == len(header) - 1 else line)
            mdl = fit(k, z, x)
            _report(varname, mdl, k, stem, d, z_raw, repickle)

    print("\n".join(textwrap.wrap(f"{std_param=}")))


if __name__ == "__main__":
    main()
