"""The turbulence models inside a DAPimpleFoam time step: every model's
``correct`` with the implicit time term (``dt=``/``old=``, the way
``dafoam_tpu/solvers/pimple.py:171-176`` passes them) in
dafoam_tpu_torch against dafoam_tpu (CPU, f64), on
tests/test_torch_turb.py's 16x8 channel.

Per model: one BDF2 time step (so the model sees dt/1.5 and the blended
old state (4 W1 - W2)/3) from a 2%-perturbed start, 2 outer correctors,
every inner solve pinned at its full budget (test_torch_turb.PINNED),
every state at rel 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafoam_tpu_torch import convert
from test_torch_cases import assert_close, to_numpy
from test_torch_turb import PINNED, channel_options, solvers

torch.set_num_threads(1)
MODELS = ("SpalartAllmaras", "kOmegaSST", "kOmegaSSTLM", "kEpsilon",
          "kOmega")


@pytest.mark.parametrize("model", MODELS)
def test_turbulent_bdf2_step(model):
    opts = channel_options(model, solverName="DAPimpleFoam",
                           ddtScheme="backward", deltaT=0.01, endTime=0.02,
                           pimple={"nOuterCorrectors": 2, "nCorrectors": 2},
                           primalLinearSolver=dict(PINNED))
    js, ts = solvers(opts)
    assert ts.ddt_order == 2 and ts.turb.model_states
    jin = js.make_inputs()
    tin = convert.inputs_from_numpy(to_numpy(jin), "cpu", torch.float64)
    rng = np.random.default_rng(31)
    W2 = to_numpy(js.init_state())
    W1 = {k: a * (1.0 + 0.02 * rng.standard_normal(a.shape))
          for k, a in W2.items()}
    geom_j = js.geometry(jin)
    jst = to_numpy(jax.jit(lambda a, b: js._step(
        a, jin, geom_j, state_oldold=b, t=jnp.asarray(2 * js.dt)))(
            {k: jnp.asarray(v) for k, v in W1.items()},
            {k: jnp.asarray(v) for k, v in W2.items()}))
    with torch.no_grad():
        tst = ts._step(convert.state_from_numpy(W1, "cpu", torch.float64),
                       tin, ts.geometry(tin),
                       state_oldold=convert.state_from_numpy(
                           W2, "cpu", torch.float64), t=2 * ts.dt)
    for k in ts.turb.model_states:
        assert ts.solve_stats[k][0] == 2
    for k, a in jst.items():
        assert_close(tst[k], a, 1e-10, f"{model} {k}")
