"""multimodal_trajectory_modeling_tpu — unsupervised multimodal trajectory
modeling on the GPU.

A ground-up JAX/XLA re-design of the capabilities of
`burkh4rt/Multimodal-Trajectory-Modeling` (mixtures of marginalizable
linear-Gaussian state-space models trained by hard-assignment EM, plus the
extended component-model framework, dataset adapters, experiment drivers and
post-hoc statistics).

Layering (bottom → top), mirroring the reference's layer map but built
for an accelerator:

- ``ops``      — pure-JAX kernels: closed-form joint moments of an LG-SSM,
                 masked (NaN-marginalizing) Gaussian log-densities, masked
                 batched least squares, samplers, a batched kNN regressor,
                 and the Markov feature matrix Φ with its EM pass.
- ``models``   — the jitted hard-EM engine over stacked per-cluster parameter
                 pytrees; the ``MMLinGaussSS_marginalizable`` API shell; the
                 extended framework (``StateSpaceModel`` ABC, linear-Gaussian
                 / kNN / hybrid components, generic mixture, classifier).
- ``parallel`` — ``jax.sharding`` meshes: data-parallel EM over trajectories
                 (E-step sharded over the batch axis, M-step sufficient
                 statistics reduced with ``psum``), and
                 restart-parallel multi-start training.
- ``utils``    — NaN-shape tooling, standardize/normalize transforms,
                 weighted moments, plotting, post-hoc CV helpers, and the
                 ADNI / MACC dataset adapters.

Data convention (identical to the reference, README.md:32-40): 3-tensors of
shape ``T × n_data × dim`` (time × instance × feature); variable-length
trajectories are padded with ``np.nan``; missing entries are handled by exact
Gaussian marginalization.
"""

__version__ = "0.1.0"

from multimodal_trajectory_modeling_tpu import ops, models, utils  # noqa: F401
