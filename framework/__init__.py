"""Compatibility layer: the reference's ``framework`` import path, backed by
the JAX implementation in ``multimodal_trajectory_modeling_tpu``."""
