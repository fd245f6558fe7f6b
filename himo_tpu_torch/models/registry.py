"""Method-name registry mapping CLI names to estimators
(port of ``himo_tpu/models/registry.py``): the feed-forward networks and
the runtime-optimisation estimators ``nsfp``, ``fastnsf`` and
``fastnsf10``; ``icp_flow`` is not ported yet."""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register_estimator(name: str):
    def wrap(factory: Callable):
        _REGISTRY[name] = factory
        return factory

    return wrap


def get_estimator(name: str, **overrides):
    """Instantiate an estimator by name; ``overrides`` feed its factory."""
    _load_builtin_estimators()
    if name not in _REGISTRY:
        raise KeyError(f"Unknown estimator {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**overrides)


def _load_builtin_estimators():
    # Imported lazily so registry imports stay light.
    import himo_tpu_torch.models.nsfp  # noqa: F401
    import himo_tpu_torch.models.fastnsf  # noqa: F401
    import himo_tpu_torch.models.feedforward  # noqa: F401


def available_estimators():
    _load_builtin_estimators()
    return sorted(_REGISTRY)
