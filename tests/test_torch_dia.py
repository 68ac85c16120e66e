"""K1/K2 (banded DIA matvec) of dafoam_tpu_torch against dafoam_tpu.

On the CPU the port's wrappers run their plain torch versions; these are
held against ``pallas_kernels.dia_matvec_reference`` and the Pallas kernels
in interpret mode, then the port's ``matvec_fn`` against
``dafoam_tpu.ops.fvmatrix.matvec_fn(pallas=False)`` on the assembled p, U
and nuTilda matrices of the 32x12 NACA0012 case in both face layouts, and
one inner solve of each at the bench's Krylov tolerances (same iteration
count, iterate and ``converged`` as dafoam_tpu).

Bars: 1e-13 (norm-relative) in f64, 1e-6 in f32 — the same arithmetic in
another summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafoam_tpu.ops import fvmatrix as jfvx
from dafoam_tpu.ops import pallas_kernels as pk
from dafoam_tpu_torch.ops import dia_kernels as dk
from dafoam_tpu_torch.ops import fvmatrix as tfvx
from test_torch_cases import (LAYOUTS, assert_close, naca_options,
                              omesh_jax, torch_solver)

torch.set_num_threads(1)

OFFSET_SETS = [(1, 64, 65), (-1, 1), (2,), (),
               (-65, -64, -1, 1, 64, 65), (1, 513),
               (-32, -31, -1, 1, 31, 32)]      # the 32x12 O-mesh bands
BARS = {np.float64: 1e-13, np.float32: 1e-6}


def _operands(offsets, dtype, n=700, comps=None, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal(n).astype(dtype)
    c = rng.standard_normal((len(offsets), n)).astype(dtype)
    shape = (n,) if comps is None else (comps, n)
    x = rng.standard_normal(shape).astype(dtype)
    return d, c, x


def _pallas_coef(c, n):
    # the Pallas kernels index a (max(K, 1), n) coefficient block
    return c if c.shape[0] else np.zeros((1, n), c.dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("offsets", OFFSET_SETS)
def test_k1_plain_matches_pallas(offsets, dtype):
    d, c, x = _operands(offsets, dtype)
    n0 = dk.COUNTS["dia_matvec_plain"]
    y = dk.dia_matvec(torch.from_numpy(d), torch.from_numpy(c), offsets,
                      torch.from_numpy(x))
    assert dk.COUNTS["dia_matvec_plain"] == n0 + 1
    assert y.dtype == torch.from_numpy(x).dtype
    cp = jnp.asarray(_pallas_coef(c, x.shape[0]))
    ref = pk.dia_matvec_reference(jnp.asarray(d), cp, offsets, jnp.asarray(x))
    assert_close(y, ref, BARS[dtype], "reference")
    pal = pk.dia_matvec(jnp.asarray(d), cp, offsets, jnp.asarray(x),
                        interpret=True)
    assert_close(y, pal, BARS[dtype], "pallas interpret")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("offsets", OFFSET_SETS)
def test_k2_plain_matches_pallas(offsets, dtype):
    d, c, x = _operands(offsets, dtype, comps=3, seed=1)
    n0 = dk.COUNTS["dia_matvec_multi_plain"]
    y = dk.dia_matvec_multi(torch.from_numpy(d), torch.from_numpy(c),
                            offsets, torch.from_numpy(x))
    assert dk.COUNTS["dia_matvec_multi_plain"] == n0 + 1
    cp = jnp.asarray(_pallas_coef(c, x.shape[1]))
    ref = jnp.stack([pk.dia_matvec_reference(jnp.asarray(d), cp, offsets,
                                             jnp.asarray(x[q]))
                     for q in range(3)])
    assert_close(y, ref, BARS[dtype], "reference")
    pal = pk.dia_matvec_multi(jnp.asarray(d), cp, offsets, jnp.asarray(x),
                              interpret=True)
    assert_close(y, pal, BARS[dtype], "pallas interpret")


def test_k2_per_component_diag_and_c1():
    """K2 with a (C, n) diagonal equals K1 per component; C=1 too."""
    offsets = (-32, -31, -1, 1, 31, 32)
    d, c, x = _operands(offsets, np.float64, comps=3, seed=2)
    dq = np.random.default_rng(3).standard_normal((3, d.size))
    y = dk.dia_matvec_multi(torch.from_numpy(dq), torch.from_numpy(c),
                            offsets, torch.from_numpy(x))
    for q in range(3):
        ref = pk.dia_matvec_reference(jnp.asarray(dq[q]), jnp.asarray(c),
                                      offsets, jnp.asarray(x[q]))
        assert_close(y[q], ref, 1e-13, f"component {q}")
    y1 = dk.dia_matvec_multi(torch.from_numpy(d), torch.from_numpy(c),
                             offsets, torch.from_numpy(x[:1]))
    assert_close(y1[0], pk.dia_matvec_reference(
        jnp.asarray(d), jnp.asarray(c), offsets, jnp.asarray(x[0])), 1e-13)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    if torch.cuda.is_available():
        pytest.skip("the checks are reached only for CUDA tensors")
    d = torch.zeros(4)
    # a CPU tensor runs the plain version; a non-CPU, non-CUDA one raises
    with pytest.raises(ValueError):
        dk.dia_matvec(d.to("meta"), torch.zeros(1, 4, device="meta"), (1,),
                      torch.zeros(4, device="meta"))


# ---------------------------------------------------------------------------
# matvec_fn on the assembled matrices of the NACA0012 case
# ---------------------------------------------------------------------------

def _assembled(layout):
    """The case's U (relaxed), p and nuTilda (relaxed) matrices at a
    perturbed initial state, as numpy, with each package's topology and the
    state. The port assembles them (assembly parity is test_torch_ops' and
    test_torch_simple's business); both packages then apply the same
    numbers."""
    from dafoam_tpu.mesh.topology import to_dia_dense
    s = torch_solver(naca_options(layout))
    st = s.init_state()
    rng = np.random.default_rng(7)
    st = dict(st, U=st["U"] + 0.05 * torch.from_numpy(
        rng.standard_normal(tuple(st["U"].shape))),
        nuTilda=st["nuTilda"] * (1.0 + 0.2 * torch.from_numpy(
            rng.random(tuple(st["nuTilda"].shape)))))
    eqs = s.equations(st, s.make_inputs())
    mats = {k: jfvx.FvMatrix(*(a.numpy() for a in m)) for k, m in eqs.items()}
    topo_j = omesh_jax()[1]
    if layout == "diaDense":
        topo_j = to_dia_dense(topo_j)
    return topo_j, s.topo, mats, {k: v.numpy() for k, v in st.items()}


@pytest.fixture(scope="module", params=LAYOUTS)
def assembled(request):
    return _assembled(request.param)


def _tmat(m):
    return tfvx.FvMatrix(*(torch.from_numpy(np.array(a)) for a in m))


@pytest.mark.parametrize("field", ["p", "nuTilda"])
def test_matvec_fn_scalar(assembled, field):
    topo_j, topo_t, mats, _ = assembled
    m = mats[field]
    x = np.random.default_rng(11).standard_normal(topo_j.n_cells)
    want = jfvx.matvec_fn(m, topo_j, pallas=False)(jnp.asarray(x))
    n0 = dk.COUNTS["dia_matvec_plain"]
    got = tfvx.matvec_fn(_tmat(m), topo_t)(torch.from_numpy(x))
    assert dk.COUNTS["dia_matvec_plain"] == n0 + 1
    assert_close(got, want, 1e-13, field)


def test_matvec_fn_momentum_component_major(assembled):
    topo_j, topo_t, mats, _ = assembled
    m = mats["U"]
    assert m.diag.ndim == 2           # boundary folding leaves (nc, 3)
    x = np.random.default_rng(12).standard_normal((topo_j.n_cells, 3))
    mt = _tmat(m)
    n0 = dk.COUNTS["dia_matvec_multi_plain"]
    got = tfvx.matvec_fn(mt, topo_t, component_major=True)(
        torch.from_numpy(x.T.copy()))
    assert dk.COUNTS["dia_matvec_multi_plain"] == n0 + 1
    # the JAX solve of this matrix is cell-major (its diag is a vector)
    want = jfvx.matvec_fn(m, topo_j, pallas=False)(jnp.asarray(x))
    assert_close(got.T, want, 1e-13, "U per-component diag")
    # shared scalar diagonal: JAX's component-major closure
    m1 = m._replace(diag=m.diag[:, 0])
    want1 = jfvx.matvec_fn(m1, topo_j, pallas=False, component_major=True)(
        jnp.asarray(x.T))
    got1 = tfvx.matvec_fn(mt._replace(diag=mt.diag[:, 0].contiguous()),
                          topo_t, component_major=True)(
        torch.from_numpy(x.T.copy()))
    assert_close(got1, want1, 1e-13, "U shared diag")


# ---------------------------------------------------------------------------
# one inner solve per equation at the bench's tolerances
# ---------------------------------------------------------------------------

# (field, symmetric, rel_tol, max_iters): bench.py's primalLinearSolver;
# on this mesh each stops on its tolerance, so the last case caps p below
# its 18 iterations to take the other exit, as p does at 512x512
BENCH_SOLVES = [("p", True, 0.05, 50), ("U", False, 0.1, 20),
                ("nuTilda", False, 0.1, 20), ("p", True, 0.05, 10)]


@pytest.mark.parametrize("field,symmetric,rel_tol,max_iters", BENCH_SOLVES)
def test_solve_exits_with_jax_at_bench_tolerances(assembled, field, symmetric,
                                                  rel_tol, max_iters):
    """fvsolve.solve as the SIMPLE step calls it (correction form, Jacobi;
    U component-major through K2) against dafoam_tpu's solve, and its inner
    SolveInfo against dafoam_tpu's Krylov solver on the same correction
    system: the tolerance exit ||r|| > max(rel_tol ||r0||, abs_tol) must
    stop both after the same number of iterations, with the same iterate
    and the same ``converged``."""
    import jax
    from dafoam_tpu.linalg import fvsolve as jfs
    from dafoam_tpu.linalg import krylov as jk
    from dafoam_tpu.utils.precision import guard_tiny
    from dafoam_tpu_torch.linalg import fvsolve as tfs
    topo_j, topo_t, mats, st = assembled
    m, psi0 = mats[field], st[field]

    def jrun(m, psi0):
        x, _ = jfs.solve(m, psi0, topo_j, symmetric=symmetric,
                         rel_tol=rel_tol, max_iters=max_iters)
        mv = jfvx.matvec_fn(m, topo_j, pallas=False)
        d = m.diag if m.diag.ndim == psi0.ndim else m.diag[..., None]
        dinv = 1.0 / jnp.where(jnp.abs(d) > guard_tiny(d.dtype), d, 1.0)
        solver = jk.cg if symmetric else jk.bicgstab
        _, info = solver(mv, m.source - mv(psi0), precond=lambda r: dinv * r,
                         rel_tol=rel_tol, max_iters=max_iters)
        return x, info

    xj, ij = jax.jit(jrun)(m, jnp.asarray(psi0))
    xt, it = tfs.solve(_tmat(m), torch.from_numpy(psi0), topo_t,
                       symmetric=symmetric, rel_tol=rel_tol,
                       max_iters=max_iters)
    assert it.iters == int(ij.iters) > 0, (it.iters, int(ij.iters))
    assert it.converged == bool(ij.converged)
    assert_close(xt, np.asarray(xj), 1e-10, field)
    assert abs(it.resid - float(ij.resid)) <= 1e-10 * float(ij.resid0)
