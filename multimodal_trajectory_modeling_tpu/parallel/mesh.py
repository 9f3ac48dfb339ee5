"""Device-mesh helpers for data-parallel and restart-parallel training.

The natural parallel axes of this model family (SURVEY §2.4):

- ``data``  — trajectories: the E step is embarrassingly parallel, the M
  step reduces additive sufficient statistics (one ``psum`` per statistic,
  NCCL all-reduces over NVLink on the GPU);
- ``start`` — independent EM restarts of the multi-start protocol: zero
  communication, perfect scaling.

The cluster (C ≤ ~16) and time (T ≤ ~10) axes stay local/vmapped — tensor
or pipeline parallelism would add communication for no win at these sizes,
so they are deliberately out of scope (documented, not forgotten).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "data_sharding", "replicated", "shard_trajectories"]


def make_mesh(
    n_devices: int = None, axis_names: tuple[str, ...] = ("data",)
) -> Mesh:
    """1-D (or reshaped n-D) mesh over the available devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    shape = (len(devs),) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("pass a 1-axis name list or reshape yourself")
    return Mesh(np.asarray(devs).reshape(shape), axis_names)


def data_sharding(mesh: Mesh, rank: int, data_axis: int, name: str = "data"):
    """NamedSharding placing axis ``data_axis`` of a rank-``rank`` array on
    the ``name`` mesh axis, everything else replicated."""
    spec = [None] * rank
    spec[data_axis] = name
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())


def shard_trajectories(mesh: Mesh, z, x, v, patterns, pattern_id):
    """Device-put the packed training set with trajectory-axis sharding:
    ``z``/``x`` are (T, n, d) → shard axis 1; ``v`` (n, D) and
    ``pattern_id`` (n,) → shard axis 0; ``patterns`` replicated."""
    return (
        jax.device_put(z, data_sharding(mesh, 3, 1)),
        jax.device_put(x, data_sharding(mesh, 3, 1)),
        jax.device_put(v, data_sharding(mesh, 2, 0)),
        jax.device_put(patterns, replicated(mesh)),
        jax.device_put(pattern_id, data_sharding(mesh, 1, 0)),
    )
