"""Minimal OpenMDAO-compatible kernel (contract shim).

A copy of ``dafoam_tpu.mdo.om_shim`` (numpy only), kept in the port so
that it imports nothing of ``dafoam_tpu``.

The reference's MPhys layer is a set of OpenMDAO components
(dafoam/mphys/mphys_dafoam.py). Where openmdao is not installed, the
components in dafoam_tpu_torch.mdo.mphys are written against the small API
subset they actually use — declared options, add_input/add_output,
compute / compute_jacvec_product, solve_nonlinear / apply_nonlinear /
linearize / apply_linear / solve_linear — and this module provides a
faithful stand-in implementation of that subset, including a ``Problem``
with ``run_model`` and adjoint ``compute_totals`` that exercises the full
OpenMDAO reverse-sweep cycle (the unified-derivative assembly
dJ/dx = pJ/px - psi^T pR/px with psi from the implicit component's
solve_linear). When the real openmdao is installed, dafoam_tpu_torch.mdo.mphys
binds to it instead and this module is unused.

Scope limits (enough for the reference's aero/aerothermal topologies):
acyclic models, promotes=["*"] or explicit connect(), scalar or 1-D float
variables.
"""

from __future__ import annotations

import numpy as np


class AnalysisError(Exception):
    """Raised on primal/adjoint failure; optimizers backtrack on it."""


class OpenMDAOWarning(UserWarning):
    pass


def issue_warning(msg, prefix="", stacklevel=2, category=UserWarning):
    import warnings

    warnings.warn(msg, category, stacklevel=stacklevel)


class OptionsDictionary(dict):
    def declare(self, name, default=None, recordable=True, types=None,
                desc=""):
        self.setdefault(name, default)


class _Comm:
    rank = 0
    size = 1

    def allreduce(self, x, op=None):
        return x


class _Vec:
    """Dict-of-arrays with OpenMDAO vector semantics (in-place +=)."""

    def __init__(self, names):
        self._d = {n: None for n in names}

    def __contains__(self, k):
        return k in self._d

    def __getitem__(self, k):
        return self._d[k]

    def __setitem__(self, k, v):
        v = np.atleast_1d(np.asarray(v, dtype=float))
        cur = self._d.get(k)
        if cur is not None and cur.shape == v.shape:
            cur[...] = v
        else:
            self._d[k] = v.copy()

    def keys(self):
        return self._d.keys()

    def items(self):
        return self._d.items()

    def get(self, k, default=None):
        v = self._d.get(k)
        return default if v is None else v


class _System:
    """Base for components and groups."""

    def __init__(self, **kwargs):
        self.options = OptionsDictionary()
        self.comm = _Comm()
        self.name = ""
        self.initialize()
        for k, v in kwargs.items():
            self.options[k] = v

    def initialize(self):
        pass

    def setup(self):
        pass


class _Component(_System):
    def __init__(self, **kwargs):
        self._in_meta = {}
        self._out_meta = {}
        super().__init__(**kwargs)

    def add_input(self, name, val=1.0, shape=None, distributed=False,
                  shape_by_conn=False, tags=None, units=None,
                  src_indices=None):
        self._in_meta[name] = {
            "val": np.atleast_1d(np.asarray(val, dtype=float)),
            "shape": shape, "shape_by_conn": shape_by_conn}

    def add_output(self, name, val=1.0, shape=None, distributed=False,
                   shape_by_conn=False, tags=None, units=None, lower=None,
                   upper=None):
        v = np.atleast_1d(np.asarray(val, dtype=float))
        if shape is not None and v.size == 1:
            v = np.full(int(np.prod(shape)), float(v[0]))
        self._out_meta[name] = {"val": v, "shape": shape}


class ExplicitComponent(_Component):
    def compute(self, inputs, outputs):
        pass

    def compute_jacvec_product(self, inputs, d_inputs, d_outputs, mode):
        pass


class ImplicitComponent(_Component):
    def solve_nonlinear(self, inputs, outputs):
        raise NotImplementedError

    def apply_nonlinear(self, inputs, outputs, residuals):
        pass

    def linearize(self, inputs, outputs, residuals):
        pass

    def apply_linear(self, inputs, outputs, d_inputs, d_outputs,
                     d_residuals, mode):
        pass

    def solve_linear(self, d_outputs, d_residuals, mode):
        pass


class IndepVarComp(ExplicitComponent):
    def __init__(self, name=None, val=1.0, **kwargs):
        super().__init__(**kwargs)
        if name is not None:
            self.add_output(name, val=val)


class Group(_System):
    def __init__(self, **kwargs):
        self._subs = []          # (name, system, promotes)
        self._connects = []      # (src_path, tgt_path)
        super().__init__(**kwargs)

    def add_subsystem(self, name, system, promotes=None, promotes_inputs=None,
                      promotes_outputs=None):
        system.name = name
        self._subs.append((name, system,
                           promotes or promotes_inputs or promotes_outputs))
        return system

    def connect(self, src, tgt):
        self._connects.append((src, tgt))


class Problem:
    """Flat executor: topological order = add order (build scripts add
    components in execution order, as the reference's do)."""

    def __init__(self, model=None):
        self.model = model if model is not None else Group()

    # -- setup ---------------------------------------------------------
    def setup(self, mode="rev"):
        self._comps = []         # [(path, comp)] flattened, in order
        self._promoted = {}      # promoted/abs name -> (path, var, io)
        self._flat = []
        self._flatten(self.model, "", None)
        for path, comp, promo in self._flat:
            comp.setup()
            self._register_vars(path, comp, promo)
        # collect connections from all groups
        self._conn = {}          # (tgt_path, in_name) -> (src_path, out_name)
        self._collect_connects(self.model, "")
        self._resolve_promoted_connections()
        self._values = {}        # (path, out_name) -> np.ndarray
        for path, comp in self._comps:
            for out, meta in comp._out_meta.items():
                self._values[(path, out)] = meta["val"].copy()
        # shape_by_conn resolution + input default values
        self._in_values = {}
        for path, comp in self._comps:
            for iname, meta in comp._in_meta.items():
                src = self._conn.get((path, iname))
                if src is not None and src in self._values:
                    self._in_values[(path, iname)] = self._values[src].copy()
                else:
                    self._in_values[(path, iname)] = meta["val"].copy()
        return self

    def _flatten(self, group, prefix, promotes):
        group.setup()
        for name, sub, promo in list(group._subs):
            path = f"{prefix}{name}"
            if isinstance(sub, Group):
                self._flatten(sub, path + ".", promo)
            else:
                sub._path = path
                self._comps.append((path, sub))
                self._flat.append((path, sub, promo))

    def _register_vars(self, path, comp, promo):
        star = promo is not None and ("*" in promo)
        for out in comp._out_meta:
            self._promoted[f"{path}.{out}"] = (path, out, "out")
            if star or (promo and out in promo):
                self._promoted.setdefault(out, (path, out, "out"))
        for inp in comp._in_meta:
            self._promoted[f"{path}.{inp}"] = (path, inp, "in")
            if star or (promo and inp in promo):
                self._promoted.setdefault("__in__" + inp, []).append(
                    (path, inp))

    def _collect_connects(self, group, prefix):
        for src, tgt in group._connects:
            s = self._lookup(prefix + src) or self._lookup(src)
            t_path, t_var, _ = (self._lookup(prefix + tgt)
                                or self._lookup(tgt))
            self._conn[(t_path, t_var)] = (s[0], s[1])
        for name, sub, _ in group._subs:
            if isinstance(sub, Group):
                self._collect_connects(sub, f"{prefix}{name}.")

    def _resolve_promoted_connections(self):
        """promotes=['*']: inputs auto-connect to the same-named promoted
        output."""
        for key, val in list(self._promoted.items()):
            if key.startswith("__in__"):
                out_key = key[6:]
                src = self._promoted.get(out_key)
                if src and src[2] == "out":
                    for (p, i) in val:
                        self._conn.setdefault((p, i), (src[0], src[1]))

    def _lookup(self, name):
        v = self._promoted.get(name)
        if v and not isinstance(v, list):
            return v
        ins = self._promoted.get("__in__" + name)
        if ins:
            p, i = ins[0]
            return (p, i, "in")
        return None

    # -- value access ----------------------------------------------------
    def __getitem__(self, name):
        path, var, io = self._lookup(name)
        if io == "out":
            return self._values[(path, var)]
        return self._in_values[(path, var)]

    def __setitem__(self, name, val):
        path, var, io = self._lookup(name)
        v = np.atleast_1d(np.asarray(val, dtype=float))
        if io == "out":
            self._values[(path, var)] = v.copy()
        else:
            self._in_values[(path, var)] = v.copy()

    def get_val(self, name, **kwargs):
        return self[name]

    def set_val(self, name, val, indices=None, **kwargs):
        if indices is None:
            self[name] = val
            return
        cur = np.array(self[name], dtype=float)
        cur[indices] = val
        self[name] = cur

    # -- execution -------------------------------------------------------
    def _gather_inputs(self, path, comp):
        vec = _Vec(comp._in_meta.keys())
        for iname in comp._in_meta:
            src = self._conn.get((path, iname))
            if src is not None and src in self._values:
                vec[iname] = self._values[src]
            else:
                vec[iname] = self._in_values[(path, iname)]
        return vec

    def run_model(self):
        for path, comp in self._comps:
            ins = self._gather_inputs(path, comp)
            outs = _Vec(comp._out_meta.keys())
            for out in comp._out_meta:
                outs[out] = self._values[(path, out)]
            if isinstance(comp, ImplicitComponent):
                comp.solve_nonlinear(ins, outs)
            elif isinstance(comp, IndepVarComp):
                pass
            else:
                comp.compute(ins, outs)
            for out in comp._out_meta:
                self._values[(path, out)] = np.atleast_1d(
                    np.asarray(outs[out], dtype=float))
            # refresh stored input copies (diagnostics)
            for iname in comp._in_meta:
                self._in_values[(path, iname)] = np.atleast_1d(
                    np.asarray(ins[iname], dtype=float))

    # -- adjoint totals ----------------------------------------------------
    def compute_totals(self, of, wrt, return_format="dict"):
        """Reverse (adjoint) sweep, one pass per ``of``:

        explicit comps propagate xbar += (pF/px)^T ybar via
        compute_jacvec_product; implicit comps solve
        (pR/pW)^T psi = Wbar (solve_linear), then subtract
        (pR/px)^T psi (apply_linear) — the OpenMDAO unified derivative
        equation specialized to an acyclic model.
        """
        of = [of] if isinstance(of, str) else list(of)
        wrt = [wrt] if isinstance(wrt, str) else list(wrt)
        totals = {}
        for f in of:
            f_path, f_var, _ = self._lookup(f)
            bar = {k: np.zeros_like(v) for k, v in self._values.items()}
            bar[(f_path, f_var)] = np.ones_like(bar[(f_path, f_var)])
            in_bar = {}   # gradient w.r.t. unconnected inputs
            for path, comp in reversed(self._comps):
                outs_bar = {o: bar[(path, o)] for o in comp._out_meta}
                if not any(np.any(v != 0.0) for v in outs_bar.values()):
                    continue
                ins = self._gather_inputs(path, comp)
                d_inputs = _Vec(comp._in_meta.keys())
                for i in comp._in_meta:
                    d_inputs[i] = np.zeros_like(ins[i])
                if isinstance(comp, ImplicitComponent):
                    outs = _Vec(comp._out_meta.keys())
                    for o in comp._out_meta:
                        outs[o] = self._values[(path, o)]
                    comp.linearize(ins, outs, None)
                    d_outputs = _Vec(comp._out_meta.keys())
                    for o in comp._out_meta:
                        d_outputs[o] = outs_bar[o]
                    d_res = _Vec(comp._out_meta.keys())
                    for o in comp._out_meta:
                        d_res[o] = np.zeros_like(outs_bar[o])
                    comp.solve_linear(d_outputs, d_res, "rev")
                    d_out2 = _Vec(comp._out_meta.keys())
                    for o in comp._out_meta:
                        d_out2[o] = np.zeros_like(outs_bar[o])
                    comp.apply_linear(ins, outs, d_inputs, d_out2, d_res,
                                      "rev")
                    sign = -1.0
                elif isinstance(comp, IndepVarComp):
                    continue
                else:
                    d_outputs = _Vec(comp._out_meta.keys())
                    for o in comp._out_meta:
                        d_outputs[o] = outs_bar[o]
                    comp.compute_jacvec_product(ins, d_inputs, d_outputs,
                                                "rev")
                    sign = 1.0
                for iname in comp._in_meta:
                    g = sign * d_inputs[iname]
                    src = self._conn.get((path, iname))
                    if src is not None and src in bar:
                        bar[src] = bar[src] + g
                    else:
                        key = (path, iname)
                        in_bar[key] = in_bar.get(key, 0.0) + g
            for x in wrt:
                x_path, x_var, io = self._lookup(x)
                if io == "out":
                    totals[(f, x)] = bar[(x_path, x_var)].copy()
                else:
                    totals[(f, x)] = np.asarray(
                        in_bar.get((x_path, x_var), 0.0)).copy()
        return totals
