"""Runtime configuration helpers: the backend policy and the compile cache."""

from __future__ import annotations

import os

import jax

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX platform name → the route the program takes on it.  "gpu" runs the
# trainers' accelerator defaults (e.g. the fast multistart route); "cpu"
# is the host backend the tests and the f64 parity mode run on.
_ROUTES = {"gpu": "gpu", "cpu": "cpu"}


def backend_route(platform: str | None = None) -> str:
    """The one backend policy: ``"gpu"`` or ``"cpu"`` for ``platform``
    (default: the platform of ``jax.devices()[0]``).  A platform the
    program has no route for raises instead of falling back."""
    if platform is None:
        platform = jax.devices()[0].platform
    try:
        return _ROUTES[platform]
    except KeyError:
        raise RuntimeError(
            f"no route for JAX platform {platform!r}; supported: "
            f"{sorted(_ROUTES)}"
        ) from None


def compilation_cache_dir() -> str:
    """Where the persistent compilation cache lives:
    ``$JAX_COMPILATION_CACHE_DIR`` when set, else the fixed in-checkout
    ``tmp/jax_cache`` (a fixed path, so the cache is found again)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO_ROOT, "tmp", "jax_cache"
    )


def enable_persistent_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache at
    :func:`compilation_cache_dir` so the drivers' shape-specialized
    programs compile once per machine instead of once per process.
    Returns the directory."""
    path = compilation_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


def use_cpu_x64() -> None:
    """Parity mode: run on CPU with float64."""
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
