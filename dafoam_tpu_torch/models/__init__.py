"""Turbulence models and the run-time registry (port of
``dafoam_tpu.models``)."""

from dafoam_tpu_torch.models.base import Laminar, TurbulenceModel
from dafoam_tpu_torch.models.komega_sst import KOmegaSST
from dafoam_tpu_torch.models.komega_sst_lm import KOmegaSSTLM
from dafoam_tpu_torch.models.ktwoeq import KEpsilon, KOmega
from dafoam_tpu_torch.models.spalart_allmaras import (SpalartAllmaras,
                                                       SpalartAllmarasFv3)

_TURB_REGISTRY = {
    "None": Laminar,
    "laminar": Laminar,
    "SpalartAllmaras": SpalartAllmaras,
    "SpalartAllmarasFv3": SpalartAllmarasFv3,
    "kOmegaSST": KOmegaSST,
    "kOmegaSSTLM": KOmegaSSTLM,
    "kEpsilon": KEpsilon,
    "kOmega": KOmega,
}


def turbulence_model_class(name: str):
    try:
        return _TURB_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown turbulence model {name!r}; have "
                       f"{list(_TURB_REGISTRY)}") from None


def make_turbulence_model(name: str, *args, **kw):
    """Run-time turbulence model selection (reference
    DATurbulenceModel::New)."""
    return turbulence_model_class(name)(*args, **kw)


def register_turbulence_model(name, cls):
    """Make ``cls`` selectable as ``name`` (the turbulenceModel option) by
    ``make_turbulence_model`` and ``turbulence_model_class``."""
    _TURB_REGISTRY[name] = cls


__all__ = ["TurbulenceModel", "Laminar", "SpalartAllmaras",
           "SpalartAllmarasFv3", "KOmegaSST", "KOmegaSSTLM", "KEpsilon",
           "KOmega", "make_turbulence_model", "register_turbulence_model",
           "turbulence_model_class"]
