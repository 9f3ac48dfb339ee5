"""Model layer: the jitted hard-EM engine and the public model classes.

``em`` and :class:`MMLinGaussSS_marginalizable` load eagerly; the extended
framework (which subclasses scikit-learn estimators) loads on first
attribute access."""

import importlib

from multimodal_trajectory_modeling_tpu.models import em  # noqa: F401
from multimodal_trajectory_modeling_tpu.models.mixture import (  # noqa: F401
    MMLinGaussSS_marginalizable,
)

_LAZY = {
    "statespace_api": ("statespace_api", None),
    "StateSpaceModelClassifier": ("classifier", "StateSpaceModelClassifier"),
    "StateSpaceHybrid": ("hybrid", "StateSpaceHybrid"),
    "StateSpaceKNN": ("knn_model", "StateSpaceKNN"),
    "StateSpaceLinearGaussian": (
        "linear_gaussian",
        "StateSpaceLinearGaussian",
    ),
    "StateSpaceMixtureModel": ("ssm_mixture", "StateSpaceMixtureModel"),
    "StateSpaceModel": ("state_space_model", "StateSpaceModel"),
}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    module, attr = _LAZY[name]
    mod = importlib.import_module(f"{__name__}.{module}")
    return mod if attr is None else getattr(mod, attr)
