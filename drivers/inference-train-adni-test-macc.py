#!/usr/bin/env python3
"""ADNI→MACC transfer experiment.

Protocol (reference inference-train-adni-test-macc.py:32-302): load the
cached 3-cluster ADNI fit, standardize MACC hidden states with the ADNI
training parameters, assign each MACC participant a cluster under three
input variants — full trajectories, cognitive-only (states masked), and
final-visit snapshot — then report cluster prevalences, cluster×diagnosis
χ² tests, pies, metric-trajectory figures, the visit-wise age-adjusted
MMSE table for the LME stage, and demographic summaries.

The MACC npz is not shipped (patient privacy, reference README.md:138-140)
— the driver exits cleanly when the data are absent.
"""

import glob
import os
import string
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from multimodal_trajectory_modeling_tpu import config as mtm_config

# Parity mode: the reference computes in float64, so the ADNI-scale drivers
# run on CPU x64 by default (set MTM_DEVICE=gpu for float32 on the GPU).
if os.environ.get("MTM_DEVICE", "cpu") == "cpu":
    mtm_config.use_cpu_x64()
mtm_config.enable_persistent_compilation_cache()

import numpy as np
import pandas as pd
import scipy.stats as sp_stats

from multimodal_trajectory_modeling_tpu.models import (
    MMLinGaussSS_marginalizable,
)
from multimodal_trajectory_modeling_tpu.utils import adni as data_adni
from multimodal_trajectory_modeling_tpu.utils import macc as data_macc
from multimodal_trajectory_modeling_tpu.utils import post_hoc as util_ph
from multimodal_trajectory_modeling_tpu.utils import state_space as util

N_CLUSTERS = 3
# content hash of the winning ADNI 3-cluster fit (reference driver :29)
ADNI_FIT_HASH = os.environ.get(
    "MTM_MACC_HEX_HASH", "49cb9120d3a1713763a0bdbdb97779bb"
)
# variant key → column name used in printed/saved tables
VARIANT_LABELS = {
    "all": "trajectories",
    "moca_only": "cognitive_only",
    "snapshot": "single_assessment",
}
FIGURES = "figures"
META = "figure-metadata-macc"


def load_adni_model(ztrain, xtrain):
    """Most recent cached fit with the pinned content hash."""
    candidates = sorted(
        glob.glob(os.path.join("tmp", f"mmm-{ADNI_FIT_HASH}*")),
        key=os.path.getmtime,
    )
    return MMLinGaussSS_marginalizable.from_pickle(
        candidates[-1],
        training_data={"states": ztrain, "observations": xtrain},
    )


def assign_variants(mdl, ztest, xtest, lengths) -> dict[str, np.ndarray]:
    """Letter assignments under the three input-masking variants."""
    last_visit = lengths - 1
    variant_inputs = {
        "all": (ztest, xtest),
        "moca_only": (np.nan * ztest, xtest),
        "snapshot": (
            util.mask_all_but_time_i_vect(ztest, last_visit),
            util.mask_all_but_time_i_vect(xtest, last_visit),
        ),
    }
    out = {}
    for key, (z, x) in variant_inputs.items():
        raw = mdl.mle_cluster_assignment(states=z, observations=x)
        out[key] = np.array([mdl.correspondence[c] for c in raw])
    return out


def diagnosis_crosstab(assignments, diagnoses, normalize="index"):
    tab = pd.crosstab(
        pd.Series(assignments, name="cluster"),
        pd.Series(diagnoses, name="diagnosis"),
        normalize=normalize,
    )
    return tab[data_macc.diagnosis_list]


def report_prevalences(variants: dict, diagnoses: np.ndarray):
    """Stacked per-variant outcome shares → CSV; prevalence table → stdout."""
    shares = pd.concat(
        [diagnosis_crosstab(a, diagnoses).stack() for a in variants.values()],
        axis=1,
    )
    shares.columns = list(VARIANT_LABELS.values())
    shares.to_csv(
        os.path.join(META, "counts_by_cluster_and_outcome_macc.csv")
    )

    prevalence = pd.concat(
        [
            pd.Series(a).value_counts(normalize=True)[
                list(string.ascii_uppercase[:N_CLUSTERS])
            ]
            for a in variants.values()
        ],
        axis=1,
    )
    prevalence.columns = list(VARIANT_LABELS.values())
    print(prevalence)


def report_chi2(key: str, assignments, diagnoses):
    counts = pd.crosstab(
        pd.Series(assignments, name="cluster"),
        pd.Series(diagnoses, name="diagnosis"),
    )[data_macc.diagnosis_list].values
    stat, pval, dof, _ = sp_stats.chi2_contingency(counts)
    print(
        f"Pearson's χ^2 contingency test for {key}: "
        f"stat={stat:.2f}, pval={pval:.2E}, dof={dof}"
    )


def emit_variant_figures(key, assignments, diagnoses, metrics_by_name):
    """Pies (cluster- and diagnosis-keyed) + per-metric trajectory plots."""
    anchor = (2.25 - 0.4 * int(N_CLUSTERS == 3), 1)
    width = 4.0 + 0.5 * int(N_CLUSTERS == 3)

    util.pie(
        assignments=assignments,
        savename=os.path.join(
            FIGURES, f"MACC_{N_CLUSTERS}_overall_pie_{key}.pdf"
        ),
        colors=data_macc.cluster_colors,
    )
    util.pie(
        assignments=diagnoses,
        savename=os.path.join(
            FIGURES, f"MACC_{N_CLUSTERS}_overall_pie_{key}_dx.pdf"
        ),
        colors=data_macc.diagnosis_colors,
        cluster_ordering=data_macc.diagnosis_list,
    )
    util.pies_by_cluster(
        savename=os.path.join(
            FIGURES, f"MACC_{N_CLUSTERS}_pie_charts_{key}.pdf"
        ),
        categories=diagnoses,
        category_ordering=data_macc.diagnosis_list,
        category_legend_names={
            "NCI": "CN",
            "CIND": "mild MCI",
            "VCIND": "moderate MCI",
            "AD": "AD",
        },
        clusters=assignments,
        legend_anchor=anchor,
        fig_length=6.0,
        fig_width=width,
        halo_colors=data_macc.cluster_colors,
        slice_colors=data_macc.diagnosis_colors,
    )
    util.pies_by_cluster(
        savename=os.path.join(
            FIGURES, f"MACC_{N_CLUSTERS}_pie_charts_{key}_dx.pdf"
        ),
        categories=assignments,
        clusters=diagnoses,
        cluster_ordering=data_macc.diagnosis_list,
        halo_colors=data_macc.diagnosis_colors,
        slice_colors=data_macc.cluster_colors,
        legend_anchor=anchor,
        fig_length=6.0,
        fig_width=width,
    )
    for name, metric in metrics_by_name.items():
        util.plot_metric_vs_clusters_over_time(
            metric=metric.squeeze(),
            assignments=assignments,
            metric_name=name,
            savename=os.path.join(
                FIGURES,
                f"MACC_trajectories_{util.slugify(name)}"
                f"_all{N_CLUSTERS}c_{key}.pdf",
            ),
            title="",
            xticks=np.array([0, 2, 4]),
            xlabel="Years from baseline",
            legend_loc="upper right",
        )


def visitwise_mmse_table(
    ids, clusters, index_values, metrics_by_key, ages
) -> pd.DataFrame:
    """One row per (participant, visit) with the cluster/health-index of the
    participant broadcast over visits — the frame the MACC LME stage reads.
    MACC visits are biennial, hence ``time_in_years = 2 t``."""
    n = ids.ravel().size
    T = next(iter(metrics_by_key.values())).shape[0]
    age_steps = np.vstack([np.zeros_like(ages[:1]), np.diff(ages, axis=0)])

    columns = {
        "cluster": np.repeat(clusters.ravel(), T),
        "health_index": np.repeat(np.asarray(index_values).ravel(), T),
    }
    # per-visit series: (T, n) → participant-major, visit-minor
    for key, series in metrics_by_key.items():
        columns[key] = np.asarray(series).reshape(T, n).T.ravel()
    columns["age"] = ages.reshape(T, n).T.ravel()
    columns["time_in_years"] = np.tile(2 * np.arange(T), n)
    columns["age_diff"] = age_steps.reshape(T, n).T.ravel()

    frame = pd.DataFrame(columns, index=np.repeat(ids.ravel(), T))
    return frame.loc[~frame.mmse.isna()].reset_index()


def main():
    if not data_macc.data_available():
        print(
            "MACC trajectories are not shipped (patient privacy); "
            "skipping the ADNI→MACC transfer experiment."
        )
        return

    pd.options.display.width = 79
    pd.options.display.max_columns = 1000
    pd.options.display.max_colwidth = 79
    pd.options.display.float_format = "{:,.3f}".format
    for d in (FIGURES, META, os.path.join("posthoc", "results")):
        os.makedirs(d, exist_ok=True)

    # ADNI training inputs fix the standardization applied to MACC states
    ztrain_raw, xtrain, *_ = data_adni.get_trajectories()
    ztrain, std_param = util.standardize(ztrain_raw, return_params=True)
    (
        ztest_raw,
        xtest,
        dtest,
        mmse_cdr_stack,
        lengths,
        ids,
        ages,
    ) = data_macc.get_data()
    ztest = util.standardize(ztest_raw, params=std_param)
    final_dx = data_macc.get_final_diagnoses(dtest).ravel()
    demographics = data_macc.get_demographics(ids)

    mdl = load_adni_model(ztrain, xtrain)
    variants = assign_variants(mdl, ztest, xtest, lengths)
    health_index = mdl.cluster_assignment_index(
        states=ztest, observations=xtest
    )

    mmse, cdrsum, cdrglobal = map(
        np.squeeze, np.split(mmse_cdr_stack, 3, axis=-1)
    )

    report_prevalences(variants, final_dx)
    for key, assignments in variants.items():
        report_chi2(key, assignments, final_dx)
        emit_variant_figures(
            key,
            assignments,
            final_dx,
            {"MMSE": mmse, "CDR (sum)": cdrsum, "CDR (global)": cdrglobal},
        )

    util.histograms_by_cluster(
        metrics=health_index.reshape(-1, 1),
        clusters=variants["all"],
        savename=os.path.join(
            FIGURES, f"MACC_{N_CLUSTERS}c_index_by_cluster.pdf"
        ),
        nbins=30,
        nrows=1,
        ncols=1,
        metric_names=[""],
        mean_overlay=False,
        density=True,
        title="",
        tighten=False,
    )

    table = visitwise_mmse_table(
        ids,
        variants["all"],
        health_index,
        {"mmse": mmse, "cdrsum": cdrsum, "cdrglobal": cdrglobal},
        ages,
    )
    table.assign(
        mmse_age_adjusted=lambda df: util_ph.regressed_out_effect_cv(
            df.mmse.values.reshape(-1, 1), df.age.values.reshape(-1, 1)
        )
    ).to_csv(
        os.path.join(
            "posthoc", "results", "mmse_by_cluster_over_time_macc.csv"
        ),
        index=None,
    )

    # column-normalized view of the row-normalized contingency table
    shares = diagnosis_crosstab(variants["all"], final_dx)
    print(shares.div(shares.sum(axis=0), axis=1))

    print(
        demographics.assign(cluster=variants["all"], age=ages[0])
        .groupby("cluster")
        .agg("mean")[["age", "is_female", "edu_yrs", "apoe4_pos"]]
    )


if __name__ == "__main__":
    main()
