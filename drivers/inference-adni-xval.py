#!/usr/bin/env python3
"""10-fold cross-validated inference on ADNI with label harmonization
across folds.

Behavioral equivalent of the reference driver (inference-adni-xval.py:
28-524): per fold — standardize hidden states on train, fit the 4-cluster
LG-SSM mixture (1000 starts, cached), relabel clusters by AD rate, score the
held-out fold under the full / snapshot / no-hidden / initial-visit input
variants, fit the supervised SSM classifier, fit a t=0 GaussianMixture
baseline, and write the results CSVs + posterior CSVs + per-fold train
tables used by the collate driver and the post-hoc stage.  The fold body
is decomposed into helpers here; every emitted artifact is byte-identical
to the previous in-line structure.
"""

import gzip
import os
import pickle
import string
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

import numpy as np
import pandas as pd
import sklearn.mixture as skl_mix
import sklearn.model_selection as skl_mdl_sel
import tqdm as tq

from multimodal_trajectory_modeling_tpu.models import (
    MMLinGaussSS_marginalizable,
)
from multimodal_trajectory_modeling_tpu.models.classifier import (
    StateSpaceModelClassifier,
)
from multimodal_trajectory_modeling_tpu.models.linear_gaussian import (
    StateSpaceLinearGaussian,
)
from multimodal_trajectory_modeling_tpu.utils import adni as data
from multimodal_trajectory_modeling_tpu.utils import state_space as ssu

N_SPLITS = 10
N_CLUSTERS = 4
ALPHA = 1.0
N_STARTS = int(os.environ.get("MTM_N_RESTARTS", "1000"))

CLUSTER_LETTERS = string.ascii_uppercase[:N_CLUSTERS]


def _letters(mdl, assignments):
    """Integer cluster ids → harmonized letters via the correspondence."""
    return np.array([mdl.correspondence[c] for c in assignments])


def _ordered_cluster_indices(mdl):
    """Integer cluster ids in A, B, C, ... letter order."""
    return [mdl.inverse_correspondence[s] for s in CLUSTER_LETTERS]


def _empty_results_frame(ids, time, d):
    """(id, time)-indexed frame holding every per-visit prediction column."""
    idx = pd.MultiIndex.from_arrays(
        [np.vstack(list(ids)).flatten(), np.vstack(list(time)).flatten()],
        names=["id", "time"],
    )
    cols = [
        "split",
        "our_cluster",
        "our_cluster_snapshots",
        "our_cluster_snapshots_no_hidden",
        "our_cluster_no_hidden",
    ]
    frame = pd.DataFrame(index=idx, columns=cols)
    return frame.assign(diagnosis=np.vstack(list(d)).flatten())


def _standardized_split(mtrain, mtest, z_dim):
    """Standardize the hidden block on train stats; apply to test."""
    tr, te = mtrain.copy(), mtest.copy()
    tr[:, :, :z_dim], std_params = ssu.standardize(
        tr[:, :, :z_dim], return_params=True
    )
    te[:, :, :z_dim] = ssu.standardize(te[:, :, :z_dim], params=std_params)
    return tr, te


def _fit_fold_mixture(mtrain_ours, z_dim, dtrain):
    """Multistart-fit the fold's mixture and harmonize its labels."""
    mdl = MMLinGaussSS_marginalizable(
        n_clusters=N_CLUSTERS,
        states=mtrain_ours[:, :, :z_dim],
        observations=mtrain_ours[:, :, z_dim:],
        init="k-means",
        alpha=ALPHA,
    ).train_with_multiple_random_starts(n_starts=N_STARTS, use_cache=True)
    data.set_model_correspondence(mdl, dtrain)
    mdl.to_pickle()
    return mdl


def _heldout_variants(mdl, mtest_ours, z_dim):
    """Score the held-out fold under every input-degradation variant the
    collate stage tabulates (reference xval:150-265): full trajectories,
    per-visit snapshots, observation-only, and initial-visit-only."""
    zt, xt = mtest_ours[:, :, :z_dim], mtest_ours[:, :, z_dim:]
    out = {}

    assignments, probs, prenorm = mdl.mle_cluster_assignment(
        states=zt,
        observations=xt,
        return_probs=True,
        return_prenormalized_log_probs=True,
    )
    order = _ordered_cluster_indices(mdl)
    out["our_cluster"] = _letters(mdl, assignments)
    out["prob_c_all"] = prenorm[assignments, np.arange(assignments.size)]
    out["posterior"] = probs[order].T
    out["our_index"] = mdl.cluster_assignment_index(
        states=zt, observations=xt
    )

    _, probs0 = mdl.mle_cluster_assignment(
        states=ssu.mask_all_but_time_i(zt, 0),
        observations=ssu.mask_all_but_time_i(xt, 0),
        return_probs=True,
    )
    out["init_posterior"] = probs0[order].T

    z_parc, x_parc = ssu.parcellate_arrays(zt, xt)
    out["our_cluster_snapshots"] = _letters(
        mdl, mdl.mle_cluster_assignment(states=z_parc, observations=x_parc)
    )
    out["our_index_snapshots"] = mdl.cluster_assignment_index(
        states=z_parc, observations=x_parc
    )
    out["our_cluster_snapshots_no_hidden"] = _letters(
        mdl,
        mdl.mle_cluster_assignment(
            states=np.nan * np.ones_like(z_parc), observations=x_parc
        ),
    )

    z_blank = np.full_like(zt, np.nan)
    out["our_cluster_no_hidden"] = _letters(
        mdl, mdl.mle_cluster_assignment(states=z_blank, observations=xt)
    )
    out["our_index_no_hidden"] = mdl.cluster_assignment_index(
        states=z_blank, observations=xt
    )
    out["our_index_no_hidden_init"] = mdl.cluster_assignment_index(
        states=ssu.mask_all_but_time_i(z_blank, 0),
        observations=ssu.mask_all_but_time_i(xt, 0),
    )
    return out


def _gmm_baseline(ztrain, xtrain, ztest, xtest, dtrain):
    """t=0 GaussianMixture baseline with AD-rate label harmonization
    (reference xval:272-318)."""
    gmm = skl_mix.GaussianMixture(
        n_components=N_CLUSTERS,
        covariance_type="full",
        max_iter=1000,
        init_params="kmeans",
        random_state=42,
    )
    t0_train = np.concatenate([ztrain, xtrain], axis=-1)[0]
    t0_test = np.concatenate([ztest, xtest], axis=-1)[0]
    raw_train = gmm.fit_predict(t0_train)

    finals = data.get_final_diagnoses(dtrain)
    ad_rate = [
        np.mean(finals[raw_train == c] == "AD") for c in range(N_CLUSTERS)
    ]
    relabel = dict(zip(np.argsort(ad_rate), string.ascii_uppercase))

    train_preds = np.array([relabel[p] for p in raw_train])
    test_preds = np.array([relabel[p] for p in gmm.predict(t0_test)])
    letter_order = sorted(relabel.keys(), key=relabel.__getitem__)
    test_proba = gmm.predict_proba(t0_test)[:, letter_order]
    return train_preds, test_preds, test_proba


def _fold_train_table(idtrain, timetrain, dtrain, ctrain, gmm_train_preds):
    """Per-fold training table consumed by the collate driver."""
    tbl = pd.DataFrame(
        data={
            "idx": idtrain.ravel(),
            "time": timetrain.ravel(),
            "diagnosis": dtrain.ravel(),
        }
    ).set_index("idx")
    ours = dict(zip(idtrain[0].ravel(), ctrain.ravel()))
    tbl["our_cluster"] = tbl.index.to_series().map(ours)
    gmm = dict(zip(idtrain[0].ravel(), gmm_train_preds.ravel()))
    tbl["gmm_init"] = tbl.index.to_series().map(gmm)
    return tbl


def _write_artifacts(
    df_results, df_posterior, df_init_post, df_gmm, dict_training_results
):
    os.makedirs("results", exist_ok=True)
    os.makedirs(os.path.join("posthoc", "results"), exist_ok=True)

    stem = f"ADNI_r7_xval{N_SPLITS}_{N_CLUSTERS}clusters"
    df_results.astype({"split": int}).to_csv(
        os.path.join("results", f"{stem}_results.csv")
    )
    posthoc_dir = os.path.join("posthoc", "results")
    for frame, tag in [
        (df_posterior, "mtm_post"),
        (df_init_post, "mtm_init_post"),
        (df_gmm, "gmm_init_post"),
    ]:
        frame.to_csv(
            os.path.join(posthoc_dir, f"{stem}_{tag}.csv"), index_label="id"
        )
    with gzip.open(
        os.path.join("results", f"{stem}_results.p.gz"), "wb"
    ) as f:
        pickle.dump(dict_training_results, f)


def main():
    z, x, d, ids, time = data.get_trajectories()
    z_dim = z.shape[-1]
    markers = np.concatenate([z, x], axis=-1)

    df_results = _empty_results_frame(ids, time, d)
    post_cols = ["prob_" + s for s in CLUSTER_LETTERS]
    df_posterior = pd.DataFrame(index=ids[0].ravel(), columns=post_cols)
    df_init_post = df_posterior.copy()
    df_gmm = pd.DataFrame(index=ids[0].ravel(), columns=post_cols)
    dict_training_results = dict()

    splitter = skl_mdl_sel.KFold(
        n_splits=N_SPLITS, shuffle=True, random_state=42
    )
    folds = tq.tqdm(
        enumerate(splitter.split(ids[0].ravel())),
        total=N_SPLITS,
        desc="folds",
        position=1,
    )
    for i_split, (train_mask, test_mask) in folds:
        dtrain, idtrain, timetrain, mtrain, ztrain, xtrain = (
            a[:, train_mask] for a in (d, ids, time, markers, z, x)
        )
        dtest, idtest, timetest, mtest, ztest, xtest = (
            a[:, test_mask] for a in (d, ids, time, markers, z, x)
        )

        heldout_ids = idtest.ravel().tolist()
        df_results.loc[
            lambda df: df.index.get_level_values("id").isin(heldout_ids),
            "split",
        ] = i_split

        mtrain_ours, mtest_ours = _standardized_split(mtrain, mtest, z_dim)
        best_mdl = _fit_fold_mixture(mtrain_ours, z_dim, dtrain)
        ctrain = _letters(best_mdl, best_mdl.mle_cluster_assignment())

        fold = _heldout_variants(best_mdl, mtest_ours, z_dim)
        df_posterior.loc[idtest[0].ravel()] = fold["posterior"]
        df_init_post.loc[idtest[0].ravel()] = fold["init_posterior"]

        clssfr = StateSpaceModelClassifier(
            component_model=StateSpaceLinearGaussian
        ).fit(
            data=(mtrain_ours[:, :, :z_dim], mtrain_ours[:, :, z_dim:]),
            labels=data.get_final_diagnoses(dtrain),
        )
        fold["supervised_classifier_predictions"] = clssfr.predict(
            data=(mtest_ours[:, :, :z_dim], mtest_ours[:, :, z_dim:])
        )

        gmm_train_preds, gmm_test_preds, gmm_proba = _gmm_baseline(
            ztrain, xtrain, ztest, xtest, dtrain
        )
        fold["gmm_init_predictions"] = gmm_test_preds
        df_gmm.loc[idtest[0].ravel()] = gmm_proba

        # scatter the per-instance variants into the (id, time) frame
        test_rows = df_results.split == i_split

        def put(col, values):
            lookup = dict(zip(idtest[0].ravel(), np.ravel(values)))
            df_results.loc[test_rows, col] = (
                df_results.loc[test_rows]
                .index.get_level_values("id")
                .to_series()
                .map(lookup)
                .values
            )

        for col in (
            "our_cluster",
            "prob_c_all",
            "our_index",
            "our_cluster_no_hidden",
            "our_index_no_hidden",
            "our_index_no_hidden_init",
            "supervised_classifier_predictions",
            "gmm_init_predictions",
        ):
            put(col, fold[col])

        # snapshot variants index by (id, visit time) directly
        snap_index = list(
            zip(
                np.tile(idtest.ravel(), np.max(timetest) + 1),
                np.ravel(timetest),
            )
        )
        for col in (
            "our_cluster_snapshots",
            "our_index_snapshots",
            "our_cluster_snapshots_no_hidden",
        ):
            df_results.loc[snap_index, col] = fold[col]

        dict_training_results |= {
            i_split: _fold_train_table(
                idtrain, timetrain, dtrain, ctrain, gmm_train_preds
            )
        }

    _write_artifacts(
        df_results, df_posterior, df_init_post, df_gmm, dict_training_results
    )


if __name__ == "__main__":
    main()
