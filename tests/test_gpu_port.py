"""The GPU port's contracts that the CPU can check.

- the backend policy (``config.backend_route``) per platform string;
- the compile cache honours ``JAX_COMPILATION_CACHE_DIR``;
- the main path imports and trains without the reference extra
  (pandas, matplotlib, scikit-learn, seaborn, tqdm);
- a float32 fit of unstandardized wide-range data does not collapse and
  matches the float64 fit (the exact-product guard);
- ``chip_smoke.py`` refuses to report a result without a GPU;
- ``bench.py`` takes a peak only for a known card at the table's power
  limit.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from multimodal_trajectory_modeling_tpu import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env_extra=None, cwd=REPO, timeout=300):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        cwd=cwd,
        capture_output=True,
        text=True,
        timeout=timeout,
    )


@pytest.mark.parametrize(
    "platform, route",
    [("gpu", "gpu"), ("cpu", "cpu"), ("rocm", None), ("METAL", None)],
)
def test_backend_route_per_platform(platform, route):
    if route is None:
        with pytest.raises(RuntimeError, match="no route"):
            config.backend_route(platform)
    else:
        assert config.backend_route(platform) == route


def test_backend_route_default_is_this_backend():
    assert config.backend_route() == "cpu"


@pytest.mark.parametrize("env_dir", [True, False])
def test_compilation_cache_dir(tmp_path, env_dir):
    code = (
        "import jax\n"
        "from multimodal_trajectory_modeling_tpu import config\n"
        "print(config.enable_persistent_compilation_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_dir else {}
    out = _run(code, extra)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.split()
    want = (
        str(tmp_path) if env_dir else os.path.join(REPO, "tmp", "jax_cache")
    )
    assert lines == [want, want]


_BLOCKED = ("pandas", "matplotlib", "sklearn", "seaborn", "tqdm")


def test_main_path_needs_no_reference_extra():
    code = f"""
import sys
import importlib.abc


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {_BLOCKED!r}:
            raise ImportError(f"blocked: {{name}}")
        return None


sys.meta_path.insert(0, Block())
import numpy as np
import multimodal_trajectory_modeling_tpu as mtm
from multimodal_trajectory_modeling_tpu.models import em
from multimodal_trajectory_modeling_tpu.models.mixture import (
    MMLinGaussSS_marginalizable,
)

rng = np.random.default_rng(0)
T, n, d, l = 5, 120, 2, 3
z = rng.normal(size=(T, n, d))
x = rng.normal(size=(T, n, l))
lens = rng.choice([3, 5], size=n)
z[np.arange(T)[:, None] >= lens[None, :]] = np.nan
x[np.arange(T)[:, None] >= lens[None, :]] = np.nan
mdl = MMLinGaussSS_marginalizable(n_clusters=2, states=z, observations=x)
mdl.train(fast=True, n_steps=5)
best = mdl.train_with_multiple_random_starts(
    n_starts=2, n_steps=3, use_cache=False, fast=True, kmeans_start=False
)
assert np.isfinite(best.e_complete_data_log_lik())
print("loaded:", sorted(m for m in sys.modules if m.split(".")[0] in
      {_BLOCKED!r}))
"""
    out = _run(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("loaded: []")


def _wide_range_data(seed=0, n_per=1500, C=3, T=8, d=5, l=3):
    """Unstandardized LG-SSM mixture, |x| reaching ~50."""
    from multimodal_trajectory_modeling_tpu import ops

    rng = np.random.default_rng(seed)
    zs, xs = [], []
    for c in range(C):
        A = rng.normal(scale=0.4, size=(d, d))
        H = rng.normal(size=(d, l))
        m = rng.normal(scale=15.0, size=d)
        z, x = ops.sample_trajectories(
            jax.random.PRNGKey(seed * 100 + c), n_per, T,
            jnp.asarray(m), jnp.eye(d) / 5, jnp.asarray(A), jnp.eye(d) / 2,
            jnp.asarray(H), jnp.eye(l) / 3,
        )
        zs.append(np.asarray(z, np.float64))
        xs.append(np.asarray(x, np.float64))
    z, x = np.concatenate(zs, axis=1), np.concatenate(xs, axis=1)
    lens = rng.choice([T // 2, T - 1, T], size=z.shape[1])
    gone = np.arange(T)[:, None] >= lens[None, :]
    z[gone] = np.nan
    x[gone] = np.nan
    labels = np.repeat(np.arange(C), n_per)
    return z, x, labels


def test_wide_range_f32_fit_does_not_collapse():
    """The exact-product guard: float32 statistics of unstandardized data
    (|x| ~ 50) keep the covariance estimates definite — the fit recovers
    the clusters and matches the float64 fit."""
    from multimodal_trajectory_modeling_tpu.models.mixture import (
        MMLinGaussSS_marginalizable,
    )

    z, x, labels = _wide_range_data()
    assert np.nanmax(np.abs(x)) > 40.0
    C = labels.max() + 1
    fits = {}
    for x64 in (False, True):
        with jax.enable_x64(x64):
            np.random.seed(0)
            mdl = MMLinGaussSS_marginalizable(
                n_clusters=C, states=z, observations=x
            )
            mdl.cluster_assignment = labels.copy()
            mdl.train(fast=True, n_steps=20)
            fits[x64] = mdl
    assign = fits[False].cluster_assignment
    np.testing.assert_array_equal(np.bincount(assign, minlength=C),
                                  np.bincount(labels, minlength=C))
    np.testing.assert_array_equal(assign, fits[True].cluster_assignment)
    for attr in ("transition_matrices", "transition_covs",
                 "measurement_matrices", "measurement_covs"):
        for a32, a64 in zip(getattr(fits[False], attr),
                            getattr(fits[True], attr)):
            assert np.all(np.isfinite(a32))
            rel = np.linalg.norm(a32 - a64) / np.linalg.norm(a64)
            assert rel < 1e-2, (attr, rel)
    for cov in fits[False].transition_covs + fits[False].measurement_covs:
        assert np.linalg.eigvalsh(cov).min() > 0.0


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """On the CPU — and in a directory holding only the script — the
    smoke test exits non-zero and prints no result."""
    cwd = REPO
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize(
    "card, want",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W", "67.0"),
        ("NVIDIA H100 80GB HBM3, 400.00 W", "ValueError"),
        ("NVIDIA A100-SXM4-80GB, 400.00 W", "KeyError"),
    ],
)
def test_bench_peaks_need_known_card_at_its_power_limit(card, want):
    code = f"""
import bench
card = {card!r}
try:
    print(bench.device_peaks(card.split(",")[0],
                             bench.power_limit_w(card))["f32_tflops"])
except (KeyError, ValueError) as err:
    print(type(err).__name__)
"""
    out = _run(code, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == want
