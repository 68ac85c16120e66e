"""``adjStateOrdering: cell`` (the reference's pyDAFoam.py:608 option) in
dafoam_tpu_torch against dafoam_tpu (CPU, f64):

- StateLayout(ordering="cell") packs and unpacks exactly as dafoam_tpu's,
  on tests/test_parity_utils.py's small layout and on the 32x12 NACA0012
  SA state (U, p, nuTilda, phi); ``offsets`` is None under it, and an
  unknown ordering raises ValueError in both packages;
- one residual-form adjoint solve on that case (20 SIMPLE iterations of
  the port, carried across; segregated PC, 30 FGMRES iterations pinned by
  a zero relative tolerance) under the cell ordering equals the port's
  under the state ordering and dafoam_tpu's at 1e-10 (dafoam_tpu's solve
  runs jitted, ``run_adjoint``: op by op it compiles each primitive and
  takes twice as long).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafoam_tpu_torch import convert
from dafoam_tpu_torch.states import StateInfo, StateLayout
from test_torch_cases import (assert_close, jax_solver, naca_options,
                              to_numpy, torch_solver)

torch.set_num_threads(1)
F64 = torch.float64
SA_INFO = dict(vol_vector=("U",), vol_scalar=("p",), model=("nuTilda",),
               surface_scalar=("phi",))
PINNED = {"gmresRelTol": 0.0, "gmresAbsTol": 0.0, "gmresRestart": 30,
          "gmresMaxIters": 30, "pcType": "segregated"}


def layouts(nc, nf):
    from dafoam_tpu.states import StateInfo as JInfo
    from dafoam_tpu.states import StateLayout as JLayout
    return (JLayout(JInfo(**SA_INFO), nc, nf, ordering="cell"),
            StateLayout(StateInfo(**SA_INFO), nc, nf, ordering="cell"))


def random_state(nc, nf, seed):
    rng = np.random.default_rng(seed)
    return {"U": rng.standard_normal((nc, 3)), "p": rng.standard_normal(nc),
            "nuTilda": rng.standard_normal(nc), "phi": rng.standard_normal(nf)}


@pytest.mark.parametrize("shape", ["parity_utils", "naca_sa"])
def test_cell_ordering_matches_jax(shape):
    if shape == "parity_utils":
        nc, nf = 3, 4
        st = {"U": np.arange(9.0).reshape(3, 3), "p": np.arange(3.0) * 10,
              "nuTilda": np.arange(3.0) * 100,
              "phi": np.arange(4.0) * 1000}
    else:
        s = torch_solver(naca_options("canonical"))
        nc, nf = s.topo.n_cells, s.topo.n_faces
        st = random_state(nc, nf, 3)
        assert s.layout.n_states == 5 * nc + nf
    jl, tl = layouts(nc, nf)
    assert tl.offsets is None and jl.offsets is None
    assert tl.cell_comps == jl.cell_comps == 5
    vj = np.asarray(jl.pack({k: jnp.asarray(a) for k, a in st.items()}))
    vt = tl.pack(convert.state_from_numpy(st, "cpu", F64))
    np.testing.assert_array_equal(vt.numpy(), vj)
    back_t = tl.unpack(vt)
    back_j = jl.unpack(jnp.asarray(vj))
    for k, a in st.items():
        np.testing.assert_array_equal(back_t[k].numpy(), a)
        np.testing.assert_array_equal(back_t[k].numpy(),
                                      np.asarray(back_j[k]))
    if shape == "parity_utils":
        # cell 0: U0x U0y U0z p0 nuTilda0, then cell 1 ...; phi block last
        np.testing.assert_array_equal(
            vt.numpy(), [0, 1, 2, 0, 0, 3, 4, 5, 10, 100, 6, 7, 8, 20, 200,
                         0, 1000, 2000, 3000])


def test_unknown_ordering_raises():
    from dafoam_tpu.states import StateInfo as JInfo
    from dafoam_tpu.states import StateLayout as JLayout
    with pytest.raises(ValueError):
        JLayout(JInfo(**SA_INFO), 3, 4, ordering="face")
    with pytest.raises(ValueError):
        StateLayout(StateInfo(**SA_INFO), 3, 4, ordering="face")
    # the state ordering keeps its offsets
    assert StateLayout(StateInfo(**SA_INFO), 3, 4).offsets["phi"] == 15


def test_adjoint_under_cell_ordering():
    opts = naca_options("canonical", primalMaxIters=20, primalMinIters=20,
                        adjEqnOption=PINNED)
    base = torch_solver(opts)
    x = base.make_inputs()
    w, _ = base.run_primal(base.init_state(), x)
    psis = {}
    for order in ("state", "cell"):
        s = torch_solver(dict(opts, adjStateOrdering=order))
        assert s.layout.ordering == order
        psi, info = s.solve_adjoint(w, x, "CD")
        assert info.iters == 30
        psis[order] = psi
    js = jax_solver(dict(opts, adjStateOrdering="cell"))
    jin = js.make_inputs()
    wj = {k: jnp.asarray(v) for k, v in convert.state_to_numpy(w).items()}
    psij, infoj = js.run_adjoint("CD", wj, jin)
    assert int(infoj.iters) == 30
    psij = to_numpy(psij)
    for k in psij:
        assert_close(psis["cell"][k], psis["state"][k].numpy(), 1e-10,
                     f"cell vs state {k}")
        assert_close(psis["cell"][k], psij[k], 1e-10, f"cell vs jax {k}")
