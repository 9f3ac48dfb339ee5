"""Host-side utilities: NaN-shape tooling, transforms, plotting, adapters,
survival/LME statistics, tracing and checkpointing.

Submodules load on first attribute access: several of them need pandas,
matplotlib or scikit-learn, which the training path does not."""

import importlib

_SUBMODULES = ("lme", "post_hoc", "state_space", "survival", "trace")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
