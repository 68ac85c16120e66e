"""K3 (the reverse rule of the banded DIA matvec) and the autograd Functions
of dafoam_tpu_torch against dafoam_tpu.

On the CPU the port's K3 wrappers run their plain torch versions. They are
held against ``jax.vjp`` of ``pallas_kernels.dia_matvec_ad`` /
``dia_matvec_multi_ad`` (the Pallas custom-vjp rules, in interpret mode as
tests/test_pallas_kernels.py runs them) on the O-mesh band layout and on
ragged n; then ``DiaMatvec``/``DiaMatvecMulti`` through ``matvec_fn`` on the
assembled momentum matrix (per-component diagonal, a case JAX's multi rule
never sees) against ``jax.vjp``/``jax.jvp`` of
``fvmatrix.matvec_fn(pallas=False)``'s cell-major closure, and by
``torch.autograd.gradcheck`` in both AD modes.

Bar: 1e-12 (norm-relative) in f64 — the same products summed in another
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafoam_tpu.ops import fvmatrix as jfvx
from dafoam_tpu.ops import pallas_kernels as pk
from dafoam_tpu_torch.ops import dia_kernels as dk
from dafoam_tpu_torch.ops import fvmatrix as tfvx
from test_torch_cases import assert_close
from test_torch_dia import _assembled

torch.set_num_threads(1)

BAR = 1e-12
# (offsets, n): the 32x12 O-mesh bands (+-1, +-(L-1), +-L with L = 32) at
# the mesh's n and ragged, a wider O-mesh-like set, a single band
CASES = [((-32, -31, -1, 1, 31, 32), 384), ((-32, -31, -1, 1, 31, 32), 389),
         ((-65, -64, -1, 1, 64, 65), 700), ((2,), 97)]


def _operands(offsets, n, comps=None, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal(n) + 5.0
    c = rng.standard_normal((len(offsets), n))
    shape = (n,) if comps is None else (comps, n)
    x = rng.standard_normal(shape)
    ct = rng.standard_normal(shape)
    return d, c, x, ct


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("offsets,n", CASES)
def test_k3_scalar_plain_matches_pallas_vjp(offsets, n):
    d, c, x, ct = _operands(offsets, n)
    _, vjp = jax.vjp(lambda dd, cc, xx: pk.dia_matvec_ad(
        dd, cc, offsets, xx, interpret=True), *map(jnp.asarray, (d, c, x)))
    d_bar, c_bar, x_bar = vjp(jnp.asarray(ct))
    td, tc, tx, tct = _t(d, c, x, ct)
    assert_close(dk.dia_matvec_t(td, tc, offsets, tct), x_bar, BAR, "x_bar")
    got_d, got_c = dk.dia_cotangent(tct, tx, offsets)
    assert_close(got_d, d_bar, BAR, "diag_bar")
    assert_close(got_c, c_bar, BAR, "coef_bar")


@pytest.mark.parametrize("offsets,n", CASES)
def test_k3_multi_plain_matches_pallas_vjp(offsets, n):
    d, c, x, ct = _operands(offsets, n, comps=3, seed=1)
    _, vjp = jax.vjp(lambda dd, cc, xx: pk.dia_matvec_multi_ad(
        dd, cc, offsets, xx, interpret=True), *map(jnp.asarray, (d, c, x)))
    d_bar, c_bar, x_bar = vjp(jnp.asarray(ct))
    td, tc, tx, tct = _t(d, c, x, ct)
    assert_close(dk.dia_matvec_multi_t(td, tc, offsets, tct), x_bar, BAR,
                 "x_bar")
    got_d, got_c = dk.dia_cotangent_multi(tct, tx, offsets,
                                          per_component=False)
    assert_close(got_d, d_bar, BAR, "diag_bar (shared)")
    assert_close(got_c, c_bar, BAR, "coef_bar")


def test_k3_takes_a_transposed_cotangent():
    """A cotangent that arrives as a transposed view is made contiguous
    before the checks."""
    offsets, n = (-32, -31, -1, 1, 31, 32), 384
    d, c, x, ct = _operands(offsets, n, comps=3, seed=2)
    td, tc, tx = _t(d, c, x)
    ct_view = torch.from_numpy(np.ascontiguousarray(ct.T)).t()
    assert not ct_view.is_contiguous()
    want = dk.dia_matvec_multi_t_plain(td, tc, offsets,
                                       ct_view.contiguous())
    assert_close(dk.dia_matvec_multi_t(td, tc, offsets, ct_view), want, 0.0)


# ---------------------------------------------------------------------------
# the Functions through matvec_fn, on the assembled momentum matrix
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def momentum():
    topo_j, topo_t, mats, _ = _assembled("diaDense")
    m = mats["U"]
    assert m.diag.ndim == 2           # per-component (nc, 3) diagonal
    rng = np.random.default_rng(5)
    nc = topo_j.n_cells
    x = rng.standard_normal((nc, 3))
    ct = rng.standard_normal((nc, 3))
    tang = [rng.standard_normal(np.shape(a)) for a in m[:3]] + \
        [rng.standard_normal((nc, 3))]
    return topo_j, topo_t, m, x, ct, tang


def _jax_closure(topo_j, src):
    def f(diag, lower, upper, x):
        m = jfvx.FvMatrix(diag, lower, upper, src)
        return jfvx.matvec_fn(m, topo_j, pallas=False)(x)
    return f


def _torch_closure(topo_t, src):
    def f(diag, lower, upper, x):
        m = tfvx.FvMatrix(diag, lower, upper, src)
        # component-major through DiaMatvecMulti with a (3, nc) diagonal
        return tfvx.matvec_fn(m, topo_t, component_major=True)(x.t()).t()
    return f


def test_per_component_multi_rule_matches_jax_vjp(momentum):
    topo_j, topo_t, m, x, ct, _ = momentum
    prim = [m.diag, m.lower, m.upper, x]
    _, vjp = jax.vjp(_jax_closure(topo_j, jnp.asarray(m.source)),
                     *map(jnp.asarray, prim))
    want = vjp(jnp.asarray(ct))
    tp = [t.requires_grad_(True) for t in _t(*prim)]
    y = _torch_closure(topo_t, torch.from_numpy(m.source))(*tp)
    n0 = {k: dk.COUNTS[k] for k in ("dia_matvec_multi_t_plain",
                                    "dia_cotangent_multi_plain")}
    got = torch.autograd.grad(y, tp, torch.from_numpy(ct))
    for k, v in n0.items():
        assert dk.COUNTS[k] == v + 1, k
    for name, g, w in zip(("diag", "lower", "upper", "x"), got, want):
        assert_close(g, w, BAR, name)


def test_jvp_matches_jax_jvp(momentum):
    topo_j, topo_t, m, x, _, tang = momentum
    prim = [m.diag, m.lower, m.upper, x]
    _, want = jax.jvp(_jax_closure(topo_j, jnp.asarray(m.source)),
                      tuple(map(jnp.asarray, prim)),
                      tuple(map(jnp.asarray, tang)))
    import torch.autograd.forward_ad as fwAD
    n0 = dk.COUNTS["dia_matvec_multi_plain"]
    with fwAD.dual_level():
        duals = [fwAD.make_dual(p, t) for p, t in zip(_t(*prim), _t(*tang))]
        y = _torch_closure(topo_t, torch.from_numpy(m.source))(*duals)
        got = fwAD.unpack_dual(y).tangent
    # forward plus A xdot and Adot x: three K2 calls
    assert dk.COUNTS["dia_matvec_multi_plain"] == n0 + 3
    assert_close(got, want, BAR, "tangent")


# ---------------------------------------------------------------------------
# gradcheck, dispatch and graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["scalar", "multi shared", "multi per-comp",
                                  "no offsets"])
def test_functions_gradcheck_both_modes(kind):
    offsets = () if kind == "no offsets" else (-5, -4, -1, 1, 4, 5)
    n = 23
    comps = None if kind in ("scalar", "no offsets") else 3
    d, c, x, _ = _operands(offsets, n, comps=comps, seed=7)
    if kind == "multi per-comp":
        d = np.random.default_rng(8).standard_normal((3, n))
    fn = dk.DiaMatvec if comps is None else dk.DiaMatvecMulti
    td, tc, tx = _t(d, c, x)
    if offsets:
        assert torch.autograd.gradcheck(
            lambda dd, cc, xx: fn.apply(dd, cc, xx, offsets),
            [t.requires_grad_(True) for t in (td, tc, tx)],
            check_forward_ad=True)
    else:   # gradcheck cannot perturb a (0, n) coefficient array
        assert torch.autograd.gradcheck(
            lambda dd, xx: fn.apply(dd, tc, xx, offsets),
            [t.requires_grad_(True) for t in (td, tx)],
            check_forward_ad=True)


def test_backward_runs_k3_and_keeps_the_graph():
    """The Functions' CPU backward takes the K3 plain versions (and no K1
    autograd), and the output of a grad-requiring input has a grad_fn."""
    offsets, n = (-32, -31, -1, 1, 31, 32), 384
    d, c, x, ct = _operands(offsets, n)
    td, tc, tx = (t.requires_grad_(True) for t in _t(d, c, x))
    before = dict(dk.COUNTS)
    y = dk.DiaMatvec.apply(td, tc, tx, offsets)
    assert y.requires_grad and y.grad_fn is not None
    y.backward(torch.from_numpy(ct))
    diff = {k: dk.COUNTS[k] - before[k] for k in dk.COUNTS}
    assert diff == dict(dict.fromkeys(dk.COUNTS, 0), dia_matvec_plain=1,
                        dia_matvec_t_plain=1, dia_cotangent_plain=1), diff
    # only x needs a gradient: K3a alone
    before = dict(dk.COUNTS)
    tx2 = torch.from_numpy(x).requires_grad_(True)
    y2 = dk.DiaMatvec.apply(torch.from_numpy(d), torch.from_numpy(c), tx2,
                            offsets)
    assert y2.requires_grad
    y2.backward(torch.from_numpy(ct))
    assert dk.COUNTS["dia_matvec_t_plain"] == before["dia_matvec_t_plain"] + 1
    assert dk.COUNTS["dia_cotangent_plain"] == before["dia_cotangent_plain"]
