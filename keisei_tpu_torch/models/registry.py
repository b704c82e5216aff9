"""Model registry (counterpart of keisei_tpu/models/registry.py).

Only `se_resnet` is ported; the other architecture names stay valid in
configs and raise "not yet ported" when built.
"""

from __future__ import annotations

from dataclasses import fields

from .se_resnet import SEResNetModel, SEResNetParams

# name -> (contract, obs_channels); params classes exist for ported names only
_CONTRACTS = {"mlp": "scalar", "resnet": "scalar", "transformer": "scalar",
              "se_resnet": "katago"}
_PORTED = {"se_resnet": (SEResNetModel, SEResNetParams)}

VALID_ARCHITECTURES = frozenset(_CONTRACTS)


def _check(architecture: str) -> None:
    if architecture not in _CONTRACTS:
        raise ValueError(
            f"unknown architecture {architecture!r}; valid: {sorted(_CONTRACTS)}")


def _ported(architecture: str):
    _check(architecture)
    if architecture not in _PORTED:
        raise NotImplementedError(
            f"architecture {architecture!r} is not yet ported to keisei_tpu_torch "
            f"(ported: {sorted(_PORTED)})")
    return _PORTED[architecture]


def get_model_contract(architecture: str) -> str:
    _check(architecture)
    return _CONTRACTS[architecture]


def validate_model_params(architecture: str, params: dict) -> None:
    """Reject unknown keys; the params dataclass validates values."""
    params_cls = _ported(architecture)[1]
    valid = {f.name for f in fields(params_cls)}
    unknown = set(params) - valid
    if unknown:
        raise ValueError(f"unknown model params for {architecture!r}: {sorted(unknown)} "
                         f"(valid: {sorted(valid)})")


def build_model(architecture: str, params: dict | None = None):
    """(nn.Module, params_cfg) for an architecture name, on the CPU."""
    model_cls, params_cls = _ported(architecture)
    params = dict(params or {})
    validate_model_params(architecture, params)
    cfg = params_cls(**params)
    return model_cls(cfg), cfg
