#!/usr/bin/env python3
"""Masked-filter E pass: steady-state runtime of the exact O(T)
partial-observation filter (``ops.kalman.kalman_masked_logliks``).

Iterations are CHAINED inside one jitted fori_loop (a data dependency
threads each evaluation into the next call's parameters, so XLA can
neither hoist nor overlap them); the completion barrier is a device→host
scalar pull.  The first dispatch's wall time (compile included) is
reported beside the steady-state time.

Usage:
    python drivers/bench-masked-kalman.py [--n 100000] [--T 10]
        [--C 16] [--d 5] [--l 3] [--miss 0.3] [--iters 20] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--T", type=int, default=10)
    ap.add_argument("--C", type=int, default=16)
    ap.add_argument("--d", type=int, default=5)
    ap.add_argument("--l", type=int, default=3)
    ap.add_argument("--miss", type=float, default=0.3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    from multimodal_trajectory_modeling_tpu import config

    if args.cpu:
        config.use_cpu_x64()
    config.enable_persistent_compilation_cache()

    import jax
    import jax.numpy as jnp

    from multimodal_trajectory_modeling_tpu.ops import kalman

    dev = jax.devices()[0]
    print(f"# device: {dev.platform} {getattr(dev, 'device_kind', '?')}")

    n, T, C, d, l = args.n, args.T, args.C, args.d, args.l
    rng = np.random.default_rng(0)
    z = rng.normal(size=(T, n, d)).astype(np.float32)
    x = rng.normal(size=(T, n, l)).astype(np.float32)
    z[rng.random(size=z.shape) < args.miss] = np.nan
    x[rng.random(size=x.shape) < args.miss] = np.nan
    m = rng.normal(size=(C, d)).astype(np.float32)
    A = (rng.normal(scale=0.3, size=(C, d, d))).astype(np.float32)
    H = rng.normal(size=(C, d, l)).astype(np.float32)

    def spd(k, scale):
        M = rng.normal(size=(C, k, k))
        return (M @ M.transpose(0, 2, 1) / k
                + scale * np.eye(k)).astype(np.float32)

    S, G, L = spd(d, 0.8), spd(d, 0.5), spd(l, 0.4)
    params = tuple(map(jnp.asarray, (m, S, A, G, H, L)))
    zj, xj = jnp.asarray(z), jnp.asarray(x)

    def timed_chain(run_one, data, label):
        """run_one(eps_scalar, *data) -> (C, n?) lls; iterations chained
        via eps feedback.  ``data`` passed as jit ARGUMENTS (big
        closed-over device arrays would become program constants)."""
        K = args.iters

        @jax.jit
        def chain(eps, *dat):
            def body(i, acc):
                ll = run_one(acc * 0.0, *dat)
                return ll[0, 0] * 0.0 + acc
            return jax.lax.fori_loop(0, K, body, eps)

        t0 = time.perf_counter()
        out = chain(jnp.asarray(0.0, jnp.float32), *data)
        float(out)  # barrier: device->host pull
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        float(chain(jnp.asarray(0.0, jnp.float32), *data))
        t_steady = time.perf_counter() - t0
        per_it = t_steady / K * 1e3
        print(
            f"{label:32s} first(+compile) {t_first:8.2f} s   "
            f"steady {per_it:8.3f} ms/eval   ({K} chained)"
        )
        return {"label": label, "compile_s": t_first, "ms": per_it}

    def run_xla(eps, _z, _x):
        p = (params[0] + eps,) + params[1:]
        return kalman.kalman_masked_logliks(_z, _x, *p)

    results = [timed_chain(run_xla, (zj, xj), "masked filter")]

    print(json.dumps({
        "n": n, "T": T, "C": C, "d": d, "l": l, "miss": args.miss,
        "results": results,
    }))


if __name__ == "__main__":
    main()
