"""DASimpleFoam's passive T field, fvSource, MRF and regression models, and
DATopoChtFoam's porosity, in dafoam_tpu_torch against dafoam_tpu (CPU,
f64), on test_torch_turb.py's 16x8 SA channel (Spalding walls) with
pinned Krylov trip counts:

- "sources": DASimpleFoam with a T field, an actuator-disk fvSource, an
  MRF zone (a cylinder, omega 2) and a neural-network regression model on
  the SA production;
- "topo": DATopoChtFoam (T field required) with a random alphaPorosity
  field and a radial-basis-function regression model.

For each: 10 SIMPLE iterations, every state at rel 1e-10; the normalized
residuals and one vjp with respect to the state and to every input (the
points, the BC values, the disk parameters, omega, the regression
parameters, alphaPorosity) at a perturbed state, rel 1e-12 (the vjp as
one vector; each input leaf at 1e-10 of its own scale). The two cases
combine the features so that dafoam_tpu compiles two primals, not six.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafoam_tpu_torch import convert
from dafoam_tpu_torch.ops import dia_kernels as dk
from dafoam_tpu_torch.utils import tree
from test_torch_cases import assert_close, to_numpy
from test_torch_scalar_heat_solid import perturbed
from test_torch_turb import ITERS, channel_options, solvers

torch.set_num_threads(1)
F64 = torch.float64
CENTRE = [0.5, 0.05, 0.005]


def _t_field(opts):
    fv = {"type": "fixedValue"}
    opts["boundaryConditions"]["T"] = {
        "xmin": dict(fv, value=300.0), "xmax": {"type": "zeroGradient"},
        "ymin": dict(fv, value=350.0), "ymax": dict(fv, value=340.0)}
    opts["initialFields"]["T"] = 300.0
    opts["normalizeStates"]["T"] = 300.0
    opts["relaxationFactors"]["equations"]["T"] = 0.7
    opts["transportProperties"].update(Pr=0.7, Prt=0.85)
    return opts


def sources_case():
    opts = _t_field(channel_options("SpalartAllmaras"))
    opts["fvSource"] = {"disk": {"type": "actuatorDisk", "smoothness": 0.1,
                                 "parameters": CENTRE + [
                                     1.0, 0.0, 0.0, 0.005, 0.04, 0.15,
                                     1e-4]}}
    opts["MRF"] = {"active": True, "origin": [0.5, 0.05, 0.0],
                   "axis": [0.0, 0.0, 1.0], "omega": 2.0,
                   "cellZone": {"type": "cylinder", "origin": [0.5, 0.05,
                                                               0.0],
                                "axis": [0.0, 0.0, 1.0], "radius": 0.03}}
    names = ["VoS", "chiSA", "PoD"]
    opts["regressionModel"] = {
        "active": True,
        "nn": {"modelType": "neuralNetwork", "inputNames": names,
               "hiddenLayerNeurons": [4], "activationFunction": "tanh",
               "outputShift": 1.0, "inputScale": 0.5}}
    n_par = (3 * 4 + 4) + (4 + 1)
    rng = np.random.default_rng(21)
    extra = {"fvSourcePar": {"disk": np.asarray(
                 opts["fvSource"]["disk"]["parameters"])},
             "MRF": {"omega": np.asarray(2.0)},
             "regressionPar": {"nn": 0.1 * rng.standard_normal(n_par)}}
    return opts, extra


def topo_case():
    opts = _t_field(channel_options("SpalartAllmaras",
                                    solverName="DATopoChtFoam"))
    opts["regressionModel"] = {
        "active": True,
        "rbf": {"modelType": "radialBasisFunction",
                "inputNames": ["VoS", "chiSA"], "nRBFs": 3,
                "outputShift": 1.0, "outputUpperBound": 3.0}}
    rng = np.random.default_rng(22)
    theta = np.concatenate([rng.uniform(0.0, 2.0, 6),
                            rng.uniform(0.8, 1.5, 6),
                            0.05 * rng.standard_normal(3)])
    extra = {"alphaPorosity": rng.uniform(0.0, 5.0, 16 * 8),
             "regressionPar": {"rbf": theta}}
    return opts, extra


CASES = {"sources": sources_case, "topo": topo_case}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    opts, extra = CASES[request.param]()
    js, ts = solvers(opts)
    jin = js.make_inputs()
    for k, v in extra.items():
        jin["params"][k] = jax.tree_util.tree_map(jnp.asarray, v)
    tin = convert.inputs_from_numpy(to_numpy(jin), "cpu", F64)
    st0 = to_numpy(js.init_state())
    jst, jinfo = js.run_primal(st0, jin)
    dk.reset_counts()
    ts.solve_stats.clear()
    tst, tinfo = ts.run_primal(convert.state_from_numpy(st0, "cpu", F64),
                               tin)
    counts = dict(dk.COUNTS)
    return request.param, js, ts, jin, tin, to_numpy(jst), jinfo, tst, \
        tinfo, counts


def test_iterations(runs):
    name, js, ts, jin, tin, jst, jinfo, tst, tinfo, counts = runs
    assert int(jinfo.iters) == tinfo.iters == ITERS
    assert set(tst) == {"U", "p", "phi", "nuTilda", "T"}
    for k in jst:
        assert_close(tst[k], jst[k], 1e-10, f"{name} {k}")
    assert ts.solve_stats["T"][0] == ITERS
    for model, theta in tin["params"]["regressionPar"].items():
        assert ts.regression_n_params(model) \
            == js.regression_n_params(model) == theta.numel()
    assert counts["dia_matvec_plain"] > 0
    assert counts["dia_matvec_multi_plain"] > 0
    # the T field changed, and the sources moved the flow
    assert float(tst["T"].max()) > 300.5


def test_residuals_and_vjp(runs):
    name, js, ts, jin, tin, jst, _, _, _, _ = runs
    st = perturbed(jst)
    rng = np.random.default_rng(13)
    v = {k: rng.standard_normal(a.shape) for k, a in st.items()}

    @jax.jit
    def jfun(w, x, vv):
        r, f_vjp = jax.vjp(js._norm_residuals, w, x)
        return r, f_vjp(vv)

    rj, (gwj, gxj) = jfun({k: jnp.asarray(a) for k, a in st.items()}, jin,
                          {k: jnp.asarray(a) for k, a in v.items()})
    wt = {k: torch.tensor(a).requires_grad_() for k, a in st.items()}
    xt = tree.tmap(lambda a: a.detach().clone().requires_grad_(), tin)
    rt = ts._norm_residuals(wt, xt)
    keys = sorted(rt)
    leaves = [wt[k] for k in keys] + tree.leaves(xt)
    grads = torch.autograd.grad(
        sum((rt[k] * torch.as_tensor(v[k])).sum() for k in keys), leaves,
        allow_unused=True)
    for k in keys:
        assert_close(rt[k], np.asarray(rj[k]), 1e-12, f"{name} R[{k}]")
    want = [np.asarray(gwj[k]) for k in keys] + \
        [np.asarray(a) for a in jax.tree_util.tree_leaves(gxj)]
    assert len(want) == len(leaves)
    got = [torch.zeros_like(x) if g is None else g
           for x, g in zip(leaves, grads)]
    assert_close(torch.cat([g.reshape(-1) for g in got]),
                 np.concatenate([w.reshape(-1) for w in want]), 1e-12,
                 f"{name} vjp")
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, 1e-10, f"{name} vjp leaf {i}")


def test_inputs_round_trip(runs):
    """convert carries the nested input leaves (MRF, regressionPar,
    fvSourcePar, alphaPorosity, parametric values) both ways."""
    name, js, ts, jin, tin, *_ = runs
    back = convert.inputs_to_numpy(tin)
    jl = jax.tree_util.tree_leaves_with_path(to_numpy(jin))
    assert len(jl) == len(tree.leaves(tin))
    for path, a in jl:
        b = back
        for k in path:
            b = b[k.key]
        np.testing.assert_array_equal(b, a, err_msg=f"{name} {path}")
