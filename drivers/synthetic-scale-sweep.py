#!/usr/bin/env python3
"""Synthetic scale sweep on the accelerator: batched EM over n_clusters on
1M trajectories (BASELINE.json config #5, the model-selection sweep over
n_c with batched EM).

For each cluster count, trains hard-EM to convergence (bounded steps) on
the same 1M-trajectory synthetic batch (T=10, d=5, l=3, NaN-padded to three
lengths) and reports per-iteration throughput, iterations to convergence
and the complete-data objective — the model-selection curve at a scale
~1750× the ADNI study.

Run on the GPU (default platform); float32.
"""

import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np

import jax
import jax.numpy as jnp

from multimodal_trajectory_modeling_tpu import config as mtm_config

mtm_config.enable_persistent_compilation_cache()

import bench  # reuse the on-device data generator
from multimodal_trajectory_modeling_tpu.models import em

N = int(os.environ.get("MTM_SWEEP_N", "1000000"))
CLUSTER_GRID = (2, 4, 8, 16)
MAX_STEPS = 50


def main():
    # bench._make_data no longer materializes the full joint-packed v
    # (the Markov headline path never reads it) — this sweep runs the
    # dense train_em, so pack v here
    z, x, _zb, _xb, _vb, patterns, pid = bench._make_data(
        N, layout="tnd"
    )
    v = jax.jit(em.pack_joint)(z, x)
    rng = np.random.default_rng(0)
    n = v.shape[0]
    results = []
    for C in CLUSTER_GRID:
        params0 = em.MixtureParams(
            pi=jnp.ones(C, jnp.float32) / C,
            m=jnp.asarray(rng.normal(size=(C, bench.D_H)), jnp.float32),
            S=jnp.asarray(np.stack([np.eye(bench.D_H)] * C), jnp.float32),
            A=jnp.asarray(
                rng.normal(scale=0.3, size=(C, bench.D_H, bench.D_H)),
                jnp.float32,
            ),
            G=jnp.asarray(np.stack([np.eye(bench.D_H)] * C), jnp.float32),
            H=jnp.asarray(
                rng.normal(size=(C, bench.D_H, bench.D_O)), jnp.float32
            ),
            L=jnp.asarray(np.stack([np.eye(bench.D_O)] * C), jnp.float32),
        )
        assign0 = jnp.asarray(rng.integers(0, C, size=n), jnp.int32)
        t0 = time.perf_counter()
        params, assign, iters, status = em.train_em(
            params0,
            assign0,
            z,
            x,
            v,
            patterns,
            pid,
            n_steps=MAX_STEPS,
            method="inverse",
        )
        q = em.complete_data_loglik(
            params, v, patterns, pid, T=bench.T, method="inverse"
        )
        q = float(q)  # host pull = hard sync
        wall = time.perf_counter() - t0
        it = int(iters)
        results.append(
            {
                "n_clusters": C,
                "iterations": it,
                "status": int(status),
                "wall_s": round(wall, 2),
                "iters_per_sec": round(it / wall, 3) if wall > 0 else None,
                "complete_data_loglik": q,
            }
        )
        print(json.dumps(results[-1]), flush=True)
    print(json.dumps({"sweep": results}))


if __name__ == "__main__":
    main()
