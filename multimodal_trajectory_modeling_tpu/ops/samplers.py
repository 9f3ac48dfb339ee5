"""Trajectory samplers — the synthetic-data fixtures of the framework.

JAX-native forward simulation of a linear-Gaussian SSM (and an arbitrary
nonlinear/non-Gaussian SSM), mirroring the reference samplers
(framework/marginalizable_state_space_model.py:776-905) but generating whole
batches on device with ``jax.random``; shapes follow the repo-wide
``T × n × dim`` convention.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["sample_trajectories", "sample_nonlinear_trajectories"]


def _chol(M: jax.Array) -> jax.Array:
    return jnp.linalg.cholesky(jnp.atleast_2d(M))


@functools.partial(jax.jit, static_argnames=("n", "T"))
def sample_trajectories(
    key: jax.Array,
    n: int,
    T: int,
    m: jax.Array,
    S: jax.Array,
    A: jax.Array,
    G: jax.Array,
    H: jax.Array,
    L: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Draw ``n`` trajectories of length ``T`` from the LG-SSM, fully jitted
    (eager per-op dispatch is slow on accelerators).

    Returns ``(z, x)`` with shapes ``(T, n, d)`` and ``(T, n, l)``.
    Reference: ``sample_trajectory``
    (marginalizable_state_space_model.py:776-836).
    """
    m = jnp.atleast_1d(m)
    S, A, G, H, L = map(jnp.atleast_2d, (S, A, G, H, L))
    d, l = A.shape[0], H.shape[1]
    kz0, kg, kl = jax.random.split(key, 3)
    cS, cG, cL = _chol(S), _chol(G), _chol(L)

    z0 = m + jax.random.normal(kz0, (n, d), dtype=cS.dtype) @ cS.T
    eps_g = jax.random.normal(kg, (T - 1, n, d), dtype=cG.dtype) @ cG.T
    eps_l = jax.random.normal(kl, (T, n, l), dtype=cL.dtype) @ cL.T

    def step(z_prev, eps):
        z_next = z_prev @ A + eps
        return z_next, z_next

    _, z_rest = jax.lax.scan(step, z0, eps_g)
    z = jnp.concatenate([z0[None], z_rest], axis=0)
    x = z @ H + eps_l
    return z, x


def sample_nonlinear_trajectories(
    key: jax.Array,
    n: int,
    dz: int,
    dx: int,
    T: int,
    m: Callable[[jax.Array, int], jax.Array],
    f: Callable[[jax.Array], jax.Array],
    G: Callable[[jax.Array, int], jax.Array],
    h: Callable[[jax.Array], jax.Array],
    L: Callable[[jax.Array, int], jax.Array],
) -> tuple[jax.Array, jax.Array]:
    """Forward-simulate an arbitrary (nonlinear, non-Gaussian) SSM.

    ``m(key, n)`` samples the initial latent batch; ``f``/``h`` map latent
    batches; ``G(key, n)``/``L(key, n)`` sample transition/measurement noise
    batches.  Reference: ``sample_nonlinear_nongaussian_trajectory``
    (marginalizable_state_space_model.py:839-905).
    """
    keys = jax.random.split(key, 2 * T)
    z0 = m(keys[0], n)
    x0 = h(z0) + L(keys[1], n)
    zs, xs = [z0], [x0]
    for t in range(T - 1):
        zt = f(zs[-1]) + G(keys[2 + 2 * t], n)
        xt = h(zt) + L(keys[3 + 2 * t], n)
        zs.append(zt)
        xs.append(xt)
    return jnp.stack(zs), jnp.stack(xs)
