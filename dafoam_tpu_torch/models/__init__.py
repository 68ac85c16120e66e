"""Turbulence models ported so far, and the run-time registry."""

from dafoam_tpu_torch.models.base import Laminar, TurbulenceModel
from dafoam_tpu_torch.models.spalart_allmaras import (SpalartAllmaras,
                                                       SpalartAllmarasFv3)

_TURB_REGISTRY = {
    "None": Laminar,
    "laminar": Laminar,
    "SpalartAllmaras": SpalartAllmaras,
    "SpalartAllmarasFv3": SpalartAllmarasFv3,
}
# models of dafoam_tpu that the port does not have yet (ROADMAP.md P7)
_NOT_PORTED = ("kOmegaSST", "kOmegaSSTLM", "kEpsilon", "kOmega")


def turbulence_model_class(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"turbulence model {name!r} is not ported yet "
            "(ROADMAP.md queue 1, P7)")
    try:
        return _TURB_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown turbulence model {name!r}; have "
                       f"{list(_TURB_REGISTRY)}") from None


def make_turbulence_model(name: str, *args, **kw):
    """Run-time turbulence model selection (reference
    DATurbulenceModel::New)."""
    return turbulence_model_class(name)(*args, **kw)


__all__ = ["TurbulenceModel", "Laminar", "SpalartAllmaras",
           "SpalartAllmarasFv3", "make_turbulence_model",
           "turbulence_model_class"]
