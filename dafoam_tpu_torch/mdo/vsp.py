"""VSP geometry-volume OpenMDAO component — reference ``DAFoamVSPVolume``
(dafoam/mphys/mphys_dafoam.py:1821-1980).

Computes the volume of a parametric geometry as an explicit component
with finite-difference partials. Geometry backends:

- ``openvsp`` when installed (the reference's backend: update the named
  ``comp:group:var`` parameters, slice with the mass-properties tool);
- any user callable ``volume_fn({var: value}) -> float`` — the native
  path, since OpenVSP is an external CAD dependency this framework does
  not require.

Semantics preserved from the reference: one scalar input per entry of
``vsp_vars``; ``scaled`` divides by the volume at the initial design
point (captured on first compute); FD step is absolute unless
``relativeStep``; reverse-mode ``compute_jacvec_product`` re-uses the
baseline volume from the last ``compute``.

A copy of ``dafoam_tpu.mdo.vsp`` (numpy only) bound to the port's shim.
"""

from __future__ import annotations

import numpy as np

try:  # pragma: no cover - optional dependency
    import openmdao.api as om
except Exception:
    from dafoam_tpu_torch.mdo import om_shim as om


class DAFoamVSPVolume(om.ExplicitComponent):
    def initialize(self):
        self.options.declare("vsp_file", default=None, recordable=False)
        self.options.declare("vsp_vars", recordable=False)
        self.options.declare("vsp_comp_names", default=None,
                             recordable=False)
        self.options.declare("slice_dir", default="z", recordable=False)
        self.options.declare("n_slices", default=10, recordable=False)
        self.options.declare("output_name", default="volume",
                             recordable=False)
        self.options.declare("step", default=1e-4, recordable=False)
        self.options.declare("relativeStep", default=False,
                             recordable=False)
        self.options.declare("scaled", default=True, recordable=False)
        # native backend: volume_fn({var: value}) -> float
        self.options.declare("volume_fn", default=None, recordable=False)

    def setup(self):
        self._vol_ref = None
        self._vol_baseline = None
        self._backend = None
        for v in self.options["vsp_vars"]:
            self.add_input(v, val=0.0)
        self.add_output(self.options["output_name"], val=1.0)

    # -- geometry backend -------------------------------------------------
    def _volume(self, values: dict) -> float:
        fn = self.options["volume_fn"]
        if fn is not None:
            return float(fn(values))
        return self._vsp_volume(values)

    def _vsp_volume(self, values: dict) -> float:
        """OpenVSP mass-properties slicing (reference
        mphys_dafoam.py:1900-1960). Requires the openvsp python API."""
        try:
            import openvsp as vsp
        except Exception as e:  # pragma: no cover - external CAD tool
            raise ImportError(
                "DAFoamVSPVolume needs either the `volume_fn` option or "
                "the openvsp python package") from e
        if self._backend is None:
            vsp.ClearVSPModel()
            vsp.ReadVSPFile(self.options["vsp_file"])
            parms = {}
            for key in self.options["vsp_vars"]:
                comp, group, var = key.split(":")
                gid = vsp.FindGeomsWithName(comp)[0]
                parms[key] = vsp.FindParm(gid, var, group)
            self._backend = (vsp, parms)
        vsp, parms = self._backend
        for key, val in values.items():
            vsp.SetParmVal(parms[key], float(val))
        vsp.Update()
        comp_names = self.options["vsp_comp_names"]
        set_index = 0
        if comp_names:
            for name in comp_names:
                for gid in vsp.FindGeomsWithName(name):
                    vsp.SetSetFlag(gid, 3, True)
            set_index = 3
        axis = {"x": vsp.X_DIR, "y": vsp.Y_DIR, "z": vsp.Z_DIR}[
            self.options["slice_dir"]]
        vsp.ComputeMassProps(set_index, self.options["n_slices"], axis)
        vol = vsp.GetTotalVolume() if hasattr(vsp, "GetTotalVolume") else \
            float(vsp.GetDoubleResults(
                vsp.FindLatestResultsID("Mass_Properties"),
                "Total_Volume")[0])
        return float(vol)

    # -- OM interface -------------------------------------------------------
    def compute(self, inputs, outputs):
        values = {v: float(np.atleast_1d(inputs[v])[0])
                  for v in self.options["vsp_vars"]}
        vol = self._volume(values)
        self._vol_baseline = (values, vol)
        if self._vol_ref is None:
            self._vol_ref = vol
        out = vol / self._vol_ref if self.options["scaled"] else vol
        outputs[self.options["output_name"]] = out

    def compute_jacvec_product(self, inputs, d_inputs, d_outputs, mode):
        out_name = self.options["output_name"]
        if mode != "rev" or out_name not in d_outputs:
            return
        values = {v: float(np.atleast_1d(inputs[v])[0])
                  for v in self.options["vsp_vars"]}
        if self._vol_baseline and self._vol_baseline[0] == values:
            vol0 = self._vol_baseline[1]
        else:
            vol0 = self._volume(values)
            self._vol_baseline = (values, vol0)
        ref = self._vol_ref if (self.options["scaled"]
                                and self._vol_ref) else 1.0
        seed = float(np.atleast_1d(d_outputs[out_name])[0])
        step0 = float(self.options["step"])
        for v in self.options["vsp_vars"]:
            if v not in d_inputs:
                continue
            h = step0 * abs(values[v]) if (self.options["relativeStep"]
                                           and values[v] != 0.0) else step0
            pert = dict(values)
            pert[v] = values[v] + h
            dvdx = (self._volume(pert) - vol0) / h / ref
            d_inputs[v] += dvdx * seed
