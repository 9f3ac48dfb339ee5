"""Test configuration.

Tests run on a virtual 8-device CPU mesh with float64 enabled so numerical
parity against NumPy/SciPy oracles is exact; the same code paths run in
float32 on the GPU (see chip_smoke.py / bench.py).

Note: jax may already be imported before conftest executes, so platform
selection goes through ``jax.config`` (env vars can be too late); XLA_FLAGS
is still read lazily at CPU-backend initialization, so the virtual device
count works from here.
"""

import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the suite is compile-bound (hundreds of
# small x64 CPU executables, re-paid every run AND after each
# clear_caches below).  A disk cache turns those into millisecond loads
# from the second run on.  JAX_COMPILATION_CACHE_DIR, when set, is used
# as it is; otherwise a fixed in-checkout directory.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _cache_dir = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "tmp",
        "xla-test-cache",
    )
    os.makedirs(_cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables after each test module.

    Root cause of the crash this guards against (pinned 2026-08-19 with
    a /proc maps sampler — see tools/segfault_repro.py): every live
    XLA:CPU executable keeps its JIT code pages mmapped, and one pytest
    process holding every executable (x64, 8 virtual devices) grows its
    mapping count to the kernel's ``vm.max_map_count`` (default 65 530)
    after ~130 tests; the next mmap — usually inside persistent-cache
    executable deserialization — fails and jaxlib segfaults (measured:
    crash at 64 971 maps; with ``sysctl -w vm.max_map_count=262144``
    the same no-clearing run completes).  Dropping the caches between
    modules unmaps the code regions and keeps the process ~10⁴ maps
    from the limit, at the cost of some recompilation (cheap now that
    the persistent disk cache above serves the re-compiles).
    ``MTM_TEST_KEEP_CACHES=1`` disables the clearing — used with the
    sampler to demonstrate the crash."""
    yield
    if os.environ.get("MTM_TEST_KEEP_CACHES", "0") != "1":
        jax.clear_caches()
