"""Layered option dictionary — the framework's single config source of truth.

Mirrors the reference's ``DAOPTION`` (dafoam/pyDAFoam.py:39-661): class
attributes define name + default + type; user dicts are merged with type
checking. The C++ mirror (``DAOption``/``pyDict2OFDict``) is unnecessary here
because the whole framework is one process.

The option surface and defaults are those of ``dafoam_tpu.option``, so one
option dict drives both packages. Options that belong to slices the port
has not reached yet are accepted here and rejected by the code that would
read them.
"""

from __future__ import annotations

import copy
from typing import Any


_DEFAULTS: dict[str, Any] = {
    # ---- basic (reference pyDAFoam.py:44-137) --------------------------
    "solverName": "DASimpleFoam",
    "primalMinResTol": 1.0e-8,
    "primalMinResTolDiff": 1.0e2,
    "primalMinIters": 1,
    "primalMaxIters": 10000,
    "useAD": {"mode": "reverse", "dvName": "None", "seedIndex": -9999},
    # step-averaged states for LCO-ish primals (reference pyDAFoam.py:486
    # useMeanStates + DASolver::meanStatesToStates, DASolver.C:4210). The
    # running mean is accumulated inside the primal while_loop over the
    # last meanStateStart fraction of iterations; phi keeps its final
    # value (the reference averages vol*/model states only).
    "useMeanStates": False,
    "meanStateStart": 0.5,
    # ---- physics ---------------------------------------------------------
    "transportProperties": {"nu": 1.5e-5, "DT": 4.0e-5, "Pr": 0.7, "Prt": 0.85},
    "turbulenceModel": "None",  # None | SpalartAllmaras | kOmegaSST | ...
    "primalBC": {},             # {"U0": {"variable","patches","value"}, ...}
    "boundaryConditions": {},   # {field: {patch: {"type":..., "value":...}}}
    "initialFields": {},        # {field: value}
    "primalVarBounds": {
        "UMax": 1000.0, "UMin": -1000.0, "pMax": 500000.0, "pMin": 20000.0,
        "p_rghMax": 500000.0, "p_rghMin": 20000.0, "eMax": 500000.0,
        "eMin": 100000.0, "TMax": 1000.0, "TMin": 100.0, "hMax": 500000.0,
        "hMin": 100000.0, "DMax": 1e16, "DMin": -1e16, "rhoMax": 5.0,
        "rhoMin": 0.2, "nuTildaMax": 1e16, "nuTildaMin": 1e-16,
        "kMax": 1e16, "kMin": 1e-16, "omegaMax": 1e16, "omegaMin": 1e-16,
        "epsilonMax": 1e16, "epsilonMin": 1e-16,
    },
    # ---- discretization --------------------------------------------------
    "divSchemes": {},            # {"div(phi,U)": "linear"|"upwind"|"linearUpwind"}
    "laplacianSchemes": {"default": "corrected"},
    "relaxationFactors": {"fields": {"p": 0.3}, "equations": {"U": 0.7}},
    "simple": {"consistent": False, "momentumPredictor": True,
               "nNonOrthogonalCorrectors": 0},
    "useConstrainHbyA": True,
    # ---- adjoint ----------------------------------------------------------
    "normalizeStates": {},
    "normalizeResiduals": ["URes", "pRes", "phiRes", "TRes", "nuTildaRes",
                           "kRes", "omegaRes", "epsilonRes"],
    "adjStateOrdering": "state",
    "adjEqnOption": {
        "globalPCIters": 0, "asmOverlap": 1, "pcFillLevel": 1,
        "jacMatReOrdering": "rcm", "gmresMaxIters": 2000,
        "gmresRestart": 300, "gmresRelTol": 1.0e-6, "gmresAbsTol": 1.0e-14,
        "gmresTolDiff": 1.0e2, "useNonZeroInitGuess": False,
        # deflated (recycled) restarts: keep this many approximate
        # smallest-direction vectors across GMRES restart cycles
        # (GMRES-E/GCRO-DR class; breaks the restart stall on fixed-point
        # step maps whose dG has eigenvalues near 1 — linalg/krylov.gmres)
        "gmresDeflate": 0,
        # none | segregated (block PC, inner Krylov sweeps) | lineJacobi
        # (exact per-field line-implicit solves) | coupledLine (line
        # solves + block-GS sweeps through the full transposed Jacobian)
        "pcType": "segregated",
        "pcInnerIters": 15,
        "pcADISweeps": 1,
        "pcCoupledSweeps": 2,
        # fixedPoint mode controls (reference pyDAFoam.py:540-543);
        # fpAcceleration "gmres" solves (I - dG^T) psibar = dJdW with
        # FGMRES (fast), "richardson" does plain sweeps (reference-parity
        # runFPAdj behaviour, converges at the primal's own rate)
        "fpMaxIters": 1000,
        "fpRelTol": 1e-6,
        "fpRelaxation": 1.0,
        "fpMinResTolDiff": 1.0e2,
        "fpAcceleration": "gmres",
        # step-map inner solves: "fixed" = scan smoothers, exactly
        # transposed by plain AD (fast; totals exact at a converged
        # primal); "implicit" = custom_linear_solve with tight transpose
        # solves (certification-grade at any primal residual, ~10x cost)
        "fpInnerMode": "fixed",
        "fpInnerScale": 1.0,
        # "fixed"-mode smoother: "linear" = defect-correction Chebyshev
        # (pressure) / damped Jacobi (momentum, turbulence) with static
        # coefficients — AD transpose finite even at the f32 noise floor,
        # dot-product-free (halo-local on a sharded mesh); "line" =
        # defect-correction with exact ADI line solves (pressure only;
        # linalg/lines.py); "mg" = defect-correction with geometric
        # multigrid V-cycles (pressure only; grid-independent step-map
        # contraction at bench scale — linalg/mg.py); "krylov" =
        # frozen-on-convergence CG/BiCGStab step scans (stronger per-step
        # contraction; f64-safe only)
        "fpInnerSmoother": "linear",
        # solve the fp-adjoint GMRES in normalized adjoint variables
        # (similarity transform by normalizeStates scales — reference
        # normalizeGradientVec semantics, DASolver.C:2356); exact, and
        # lowers the f32 residual floor by balancing matvec noise
        "fpNormalize": True,
        # rematerialize the step map inside each fp-GMRES transpose
        # product instead of storing its residual tape
        "fpRemat": False,
        # step-map FIELD-relaxation overrides (adjoint linearization
        # only): field relaxation is an explicit blend that never enters
        # a residual, so any factor here keeps the primal's W* an exact
        # fixed point and totals invariant, while shrinking rho(dG)
        # (solvers/base.py _fp_step_fn). Equation (implicit) relaxation
        # canNOT be overridden — it changes rAU and shifts the map's
        # fixed point (base.py raises on fpRelaxEquations). Empty dict =
        # use the primal's relaxationFactors.
        "fpRelaxFields": {},
        "dynAdjustTol": True,
    },
    "adjPCLag": 10000,
    "adjEqnSolMethod": "Krylov",  # Krylov | fixedPoint
    "transonicPCOption": -1,
    # ---- unsteady ----------------------------------------------------------
    "unsteadyAdjoint": {
        # mode "hybrid" = time-spectral / harmonic balance (reference
        # pyDAFoam.py:398-409 declares it with nTimeInstances/
        # periodicity; solvers/time_spectral.py implements it)
        "mode": "None", "PCMatPrecomputeInterval": 100,
        "PCMatUpdateInterval": 1, "readZeroFields": True,
        "additionalOutput": [], "reduceIO": True,
        "nTimeInstances": 3, "periodicity": 1.0,
    },
    "ddtScheme": "steadyState",   # steadyState | Euler | backward
    "deltaT": 1.0,
    "endTime": 1.0,
    # ---- dynamic mesh (DAPimpleDyMFoam) ------------------------------------
    "dynamicMesh": {"active": False, "motionType": "translation",
                    "amplitude": 0.0, "frequency": 1.0,
                    "direction": [0.0, 1.0, 0.0], "movingPatches": []},
    # ---- objectives ----------------------------------------------------------
    "function": {},
    "inputInfo": {},
    "outputInfo": {},
    "fvSource": {},
    "MRF": {"active": False},
    "regressionModel": {"active": False},
    # ---- primal loop control (reference DASolver.C:156-316; option dict
    # shape matches pyDAFoam.py:91) -----------------------------------------
    "primalFuncStdTol": {"stdTol": -1.0, "slopeTol": -1.0,
                         "funcNames": [], "nStepsFrac": 0.2},
    "printInterval": 100,
    "printToScreen": False,
    # ---- mesh quality (reference DACheckMesh.H:61-70) -------------------------
    "checkMeshThreshold": {
        "maxAspectRatio": 1000.0, "maxNonOrth": 70.0, "maxSkewness": 4.0,
        "maxIncorrectlyOrientedFaces": 0,
    },
    # ---- linear solvers for the primal (segregated equation solves) ----------
    "primalLinearSolver": {
        "pMaxIters": 500, "pRelTol": 0.01, "uMaxIters": 100, "uRelTol": 0.1,
        "turbMaxIters": 100, "turbRelTol": 0.1, "pAbsTol": 1e-20,
        # pressure preconditioner: "jacobi" (diag), "line" (exact ADI
        # line solves on the dense-DIA layout; linalg/lines.py), or "mg"
        # (geometric Galerkin multigrid on the grid-form layout — the
        # GAMG-class grid-independent strength the reference's pEqn gets
        # from OpenFOAM GAMG; linalg/mg.py). "line"/"mg" switch the
        # pressure Krylov to BiCGStab (both PCs are nonsymmetric).
        "pPC": "jacobi",
    },
    # ---- parallel -----------------------------------------------------------
    "decomposeParDict": {"method": "scotch", "nProcessors": 1},
    "wallDistanceMethod": "meshWaveFrozen",
    # internal-face layout: "auto" = dense offset-major DIA on a CUDA
    # device (all cell<->face movement becomes shifts), canonical
    # owner-sorted order on the CPU; "diaDense" forces it, "canonical"
    # disables it.
    "meshFaceLayout": "auto",
    # ---- misc -----------------------------------------------------------
    "dtype": "auto",  # unread by the port: make_solver takes dtype=
    "seed": 0,
    "writeMinorIterations": False,
    "debug": False,
}


def _merge(base: dict, upd: dict, path: str = "") -> dict:
    out = dict(base)
    for k, v in upd.items():
        if k in base and isinstance(base[k], dict) and isinstance(v, dict):
            out[k] = _merge(base[k], v, path + k + ".")
        else:
            if k in base and base[k] is not None and v is not None:
                tb, tv = type(base[k]), type(v)
                ok = tb is tv or ({tb, tv} <= {int, float, bool})
                if not ok and not isinstance(base[k], (list, dict)):
                    raise TypeError(
                        f"option {path+k}: expected {tb.__name__}, got {tv.__name__}")
            out[k] = copy.deepcopy(v)
    return out


class DAOption:
    """Validated option store. ``opt["a.b.c"]`` digs into nested dicts."""

    def __init__(self, options: dict | None = None):
        # deepcopy the defaults: _merge shallow-copies untouched branches,
        # and a later option.set("a.b", v) on one instance must never
        # mutate the module-level _DEFAULTS shared by every solver
        self._opts = _merge(copy.deepcopy(_DEFAULTS), options or {})

    def __getitem__(self, key: str) -> Any:
        node: Any = self._opts
        for part in key.split("."):
            node = node[part]
        return node

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def set(self, key: str, value: Any) -> None:
        parts = key.split(".")
        node = self._opts
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    @property
    def all(self) -> dict:
        return self._opts

    def __repr__(self) -> str:  # pragma: no cover
        import pprint
        return "DAOption(\n" + pprint.pformat(self._opts) + "\n)"
