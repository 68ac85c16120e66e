"""Typed, differentiable design-variable injection (DAInput family).

Port of ``dafoam_tpu.inputs``. Each of the ten ``inputInfo`` types maps a
FLAT design tensor into leaves of the solver's ``inputs`` dict; because
the dict is the differentiation boundary, dJ/d(flat tensor) falls out of
the same backward pass that produces dJ/d(inputs).

``apply`` is pure: it returns a new inputs dict and never writes into a
tensor it was given, so a design tensor that requires grad stays on the
autograd graph (JAX's ``.at[].set`` becomes a ``torch.stack`` of the
components).

Config schema mirrors the reference ``inputInfo`` option:
  {"aero_vol_coords": {"type": "volCoord", "components": ["solver"]},
   "patchV":          {"type": "patchVelocity", "patches": ["far"],
                       "flowAxis": "x", "normalAxis": "y"},
   "beta":            {"type": "field", "fieldName": "betaFI"},
   "parameters":      {"type": "regressionPar", "modelName": "m1"}, ...}
"""

from __future__ import annotations

import math

import torch

_AXIS = {"x": 0, "y": 1, "z": 2}


def _copy_bc(inputs):
    return {k: dict(v) for k, v in inputs["bc"].items()}


class InputRegistry:
    def __init__(self, solver, input_info: dict):
        self.solver = solver
        self.info = input_info

    def size(self, name: str) -> int:
        cfg = self.info[name]
        t = cfg["type"]
        topo = self.solver.topo
        if t == "volCoord":
            return topo.n_points * 3
        if t == "patchVelocity":
            return 2                      # [UMag, AoA_deg] (serial)
        if t == "patchVar":
            return len(cfg.get("components", [0]))
        if t == "field":
            return topo.n_cells * (3 if cfg.get("fieldType") == "vector" else 1)
        if t == "regressionPar":
            return self.solver.regression_n_params(cfg["modelName"])
        if t == "fvSourcePar":
            return len(self.solver.option["fvSource"][cfg["fvSourceName"]]
                       .get("parameters", []))
        if t == "stateVar":
            return self.solver.layout.n_states
        if t == "patchField":
            n = sum(topo.patch(p).size for p in cfg["patches"])
            return n * (3 if cfg.get("fieldType") == "vector" else 1)
        if t == "fieldUnsteady":
            return topo.n_cells * cfg.get("nSteps", 1)
        raise NotImplementedError(t)

    def distributed(self, name: str) -> bool:
        """Serial (replicated scalar DVs) vs distributed (mesh-sized), the
        reference's serial-vs-distributed input distinction
        (DASolver.C:1790-1820)."""
        return self.info[name]["type"] in ("volCoord", "field")

    def apply(self, name: str, inputs: dict, arr: torch.Tensor) -> dict:
        """Pure: returns a NEW inputs dict with the DV injected."""
        cfg = self.info[name]
        t = cfg["type"]
        out = dict(inputs)
        if t == "volCoord":
            out["points"] = arr.reshape(self.solver.topo.n_points, 3)
        elif t == "patchVelocity":
            umag, aoa_deg = arr[0], arr[1]
            a = aoa_deg * math.pi / 180.0
            comps = [arr.new_zeros(()) for _ in range(3)]
            comps[_AXIS[cfg.get("flowAxis", "x")]] = umag * torch.cos(a)
            comps[_AXIS[cfg.get("normalAxis", "y")]] = umag * torch.sin(a)
            vec = torch.stack(comps)
            bc = _copy_bc(inputs)
            for p in cfg["patches"]:
                bc.setdefault("U", {})
                bc["U"][p] = vec
            out["bc"] = bc
            aoa = dict(inputs.get("aoa", {}))
            aoa["patchVelocity"] = arr
            out["aoa"] = aoa
        elif t == "patchVar":
            var = cfg["varName"]
            bc = _copy_bc(inputs)
            bc.setdefault(var, {})
            for p in cfg["patches"]:
                if cfg.get("varType", "scalar") == "scalar":
                    bc[var][p] = arr[0]
                else:
                    base = bc[var].get(p)
                    base = arr.new_zeros(3) if base is None else \
                        torch.as_tensor(base, dtype=arr.dtype,
                                        device=arr.device)
                    comps = list(base.unbind())
                    for i, c in enumerate(cfg.get("components", [0, 1, 2])):
                        comps[c] = arr[i]
                    bc[var][p] = torch.stack(comps)
            out["bc"] = bc
        elif t == "field":
            params = dict(inputs["params"])
            fname = cfg["fieldName"]
            if cfg.get("fieldType") == "vector":
                params[fname] = arr.reshape(-1, 3)
            else:
                params[fname] = arr
            out["params"] = params
        elif t == "regressionPar":
            params = dict(inputs["params"])
            reg = dict(params.get("regressionPar", {}))
            reg[cfg["modelName"]] = arr
            params["regressionPar"] = reg
            out["params"] = params
        elif t == "fvSourcePar":
            params = dict(inputs["params"])
            fv = dict(params.get("fvSourcePar", {}))
            fv[cfg["fvSourceName"]] = arr
            params["fvSourcePar"] = fv
            out["params"] = params
        elif t == "stateVar":
            # direct state override (unsteady field inversion): carried as
            # an input leaf the solver can splice in (reference
            # DAInputStateVar)
            out["stateVar"] = arr
        elif t == "patchField":
            var = cfg["fieldName"]
            bc = _copy_bc(inputs)
            bc.setdefault(var, {})
            off = 0
            vec = cfg.get("fieldType") == "vector"
            for pname in cfg["patches"]:
                n = self.solver.topo.patch(pname).size
                if vec:
                    bc[var][pname] = arr[off:off + 3 * n].reshape(n, 3)
                    off += 3 * n
                else:
                    bc[var][pname] = arr[off:off + n]
                    off += n
            out["bc"] = bc
        elif t == "fieldUnsteady":
            params = dict(inputs["params"])
            params[cfg["fieldName"] + "Unsteady"] = arr.reshape(
                cfg.get("nSteps", 1), -1)
            out["params"] = params
        else:
            raise NotImplementedError(t)
        return out

    def apply_all(self, inputs: dict, dvs: dict) -> dict:
        s = self.solver
        for name, arr in dvs.items():
            inputs = self.apply(name, inputs, torch.as_tensor(
                arr, dtype=s.dtype, device=s.device))
        return inputs
