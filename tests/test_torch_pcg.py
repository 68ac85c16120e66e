"""The device PCG (``krylov.dia_pcg``, ``ops/pcg_kernels.py``) against
``krylov.cg``.

On the CPU, on negative definite pressure-like 5-point matrices (64x32
cells, anisotropic, a grounded outlet column) in float32 and float64:
each exit of cg's rule (the cap, convergence inside a block, the abs_tol
exit, a zero right-hand side, a NaN from the start and a NaN that
appears in the first iteration) gives cg's SolveInfo and cg's x bit for
bit at the CPU's block of one iteration, and again with a block of
several iterations forced, whose masked iterations must change nothing.
A dispatch case checks which ``fvsolve`` inputs take the device PCG.

On the card (marker ``chip``; run there without the JAX conftest:
``python -m pytest tests/test_torch_pcg.py -m chip --noconftest``) the
kernels against their plain versions at 917,504 cells, the launches per
iteration and the host reads per 50-iteration solve.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke as cs
from chip_smoke import pressure_matrix
from dafoam_tpu_torch.linalg import krylov
from dafoam_tpu_torch.ops import dia_kernels as dk
from dafoam_tpu_torch.ops import pcg_kernels as pk
from dafoam_tpu_torch.utils import timing

DTYPES = {"f32": torch.float32, "f64": torch.float64}
INT = {torch.float32: torch.int32, torch.float64: torch.int64}
BLOCK = 3


def _case(name, dtype):
    """(matrix, b, rel_tol, abs_tol, max_iters) of one exit case."""
    d, c, o, dinv = pressure_matrix(64, 32, dtype)
    rng = np.random.default_rng(1)
    b = torch.as_tensor(rng.standard_normal(d.shape[0]), dtype=dtype)
    tols = {"cap": (0.0, 1e-50, 13), "mid_block": (0.05, 1e-50, 500),
            "abs_tol": (0.0, 2.0, 500), "zero_rhs": (1e-6, 1e-50, 50),
            "nan_rhs": (1e-6, 1e-50, 50), "nan_precond": (1e-6, 1e-50, 50)}
    if name == "zero_rhs":
        b = torch.zeros_like(b)
    elif name == "nan_rhs":
        b[17] = float("nan")
    elif name == "nan_precond":              # r0 finite, r NaN after one
        dinv = dinv.clone()
        dinv[40] = float("nan")
    return (d, c, o, dinv), b, *tols[name]


def _bits(x):
    return x.view(INT[x.dtype])


def _same(a, b):
    return a == b or (math.isnan(a) and math.isnan(b))


def _cg(mat, b, rel_tol, abs_tol, max_iters):
    d, c, o, dinv = mat
    return krylov.cg(lambda v: dk.dia_matvec(d, c, o, v), b,
                     precond=lambda r: dinv * r, rel_tol=rel_tol,
                     abs_tol=abs_tol, max_iters=max_iters)


CASES = ["cap", "mid_block", "abs_tol", "zero_rhs", "nan_rhs", "nan_precond"]
EXPECT = {"cap": (13, False), "zero_rhs": (0, True), "nan_rhs": (0, False),
          "nan_precond": (1, False)}


@pytest.mark.parametrize("block", [1, BLOCK])
@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_dia_pcg_is_cg(dt, name, block, monkeypatch):
    monkeypatch.setitem(krylov.PCG_BLOCK, "cpu", block)
    dtype = DTYPES[dt]
    mat, b, rel_tol, abs_tol, max_iters = _case(name, dtype)
    xc, ic = _cg(mat, b, rel_tol, abs_tol, max_iters)
    pk.reset_counts()
    krylov.reset_counts()
    with timing.recording() as rec:
        xp, ip = krylov.dia_pcg(*mat, b, rel_tol=rel_tol, abs_tol=abs_tol,
                                max_iters=max_iters)
    assert ip.iters == ic.iters and ip.converged == ic.converged
    assert _same(ip.resid0, ic.resid0) and _same(ip.resid, ic.resid)
    assert torch.equal(_bits(xp), _bits(xc))
    if name in EXPECT:
        assert (ic.iters, ic.converged) == EXPECT[name]
    else:
        assert ic.converged and 0 < ic.iters < max_iters
    if name == "mid_block" and block > 1:
        assert ic.iters % block != 0            # the exit inside a block
    if name == "abs_tol":
        assert ic.resid <= abs_tol < ic.resid0
    # one read per block; the iterations after the exit are masked
    blocks = max(1, -(-ic.iters // block))
    assert rec.aggregate()["sync.krylov.rn"]["count"] == blocks
    assert krylov.COUNTS["pcg_masked_iters"] == blocks * block - ic.iters
    assert krylov.COUNTS["pcg_iters"] == ic.iters
    assert krylov.COUNTS["pcg_solves"] == 1
    assert pk.COUNTS["pcg_dot_plain"] == blocks * block


def _box(layout, nx=8, ny=4):
    from dafoam_tpu_torch.mesh import box_hex_mesh
    from dafoam_tpu_torch.mesh.topology import to_dia_dense
    pts, topo = box_hex_mesh(nx, ny, 1, (0.1, 0.1, 0.01),
                             kinds={"zmin": "empty", "zmax": "empty"})
    if layout == "relabelled":
        from dafoam_tpu_torch.parallel import reorder_for_partitions
        topo, _ = reorder_for_partitions(topo, pts, 8)
    return to_dia_dense(topo) if layout == "dense" else topo


def _spd_matrix(topo, comps=None, seed=0):
    """A symmetric negative definite LDU matrix on ``topo``."""
    from dafoam_tpu_torch.ops.fvmatrix import FvMatrix
    rng = np.random.default_rng(seed)
    nc, ni = topo.n_cells, topo.n_internal
    w = rng.uniform(0.5, 2.0, ni)
    if topo.dia_dense() is not None:
        w = w * topo.dia_dense()[1].ravel()     # degenerate slots carry 0
    own = topo.owner[:ni].astype(np.int64)
    nei = topo.neighbour.astype(np.int64)
    diag = -(np.bincount(own, w, nc) + np.bincount(nei, w, nc)) - 0.5
    src = rng.standard_normal(nc if comps is None else (nc, comps))
    if comps is not None:
        diag = np.repeat(diag[:, None], comps, axis=1)
    return FvMatrix(*(torch.as_tensor(a) for a in (diag, w, w, src)))


DISPATCH = {  # case: (layout, symmetric, pc, vector field, expected solver)
    "dense": ("dense", True, "jacobi", False, "pcg"),
    "canonical": ("canonical", True, "jacobi", False, "pcg"),
    "float32": ("dense", True, "jacobi", False, "pcg"),
    "asymmetric": ("dense", False, "jacobi", False, None),
    "line": ("dense", True, "line", False, None),
    "mg": ("dense", True, "mg", False, None),
    "component_major": ("dense", True, "jacobi", True, "cg"),
    "halo": ("canonical", True, "jacobi", False, "cg"),
    "non_banded": ("relabelled", True, "jacobi", False, "cg"),
}


@pytest.mark.parametrize("case", list(DISPATCH))
def test_dispatch(case):
    """Which solves take the device PCG, which keep krylov.cg, and which
    go to BiCGStab (None)."""
    from dafoam_tpu_torch.linalg import fvsolve
    from dafoam_tpu_torch.parallel import halo
    layout, symmetric, pc, vector, want = DISPATCH[case]
    topo = _box(layout, *((64, 64) if case == "non_banded" else ()))
    assert (topo.dia() is None) == (case == "non_banded")
    m = _spd_matrix(topo, comps=3 if vector else None)
    if case == "float32":
        m = m._replace(**{k: v.float() for k, v in m._asdict().items()})
    psi0 = torch.zeros_like(m.source)
    if case == "halo":
        halo.activate(topo, 4, device="cpu")
    krylov.reset_counts()
    try:
        x, info = fvsolve.solve(m, psi0, topo, symmetric=symmetric,
                                rel_tol=1e-6, max_iters=500, pc=pc)
    finally:
        halo.deactivate(topo)
    assert info.converged and torch.isfinite(x).all()
    got = {"pcg": krylov.COUNTS["pcg_solves"],
           "cg": krylov.COUNTS["cg_solves"]}
    assert got == {k: int(k == want) for k in got}, got


def test_transpose_solve_takes_the_device_pcg():
    """The implicit rule's transpose solve of a symmetric Jacobi solve
    goes through the plan's solver: the device PCG, to rel 1e-10."""
    from dafoam_tpu_torch.linalg import fvsolve
    topo = _box("dense")
    m = _spd_matrix(topo)
    src = m.source.clone().requires_grad_(True)
    krylov.reset_counts()
    x, _ = fvsolve.solve(m._replace(source=src), torch.zeros_like(src), topo,
                         symmetric=True, rel_tol=0.05, max_iters=50)
    (g,) = torch.autograd.grad(x.sum(), src)
    assert krylov.COUNTS["pcg_solves"] == 2
    assert krylov.COUNTS["cg_solves"] == 0
    # A is symmetric: A g = 1 to the transpose solve's tolerance
    from dafoam_tpu_torch.ops.fvmatrix import matvec
    res = matvec(m, g, topo) - 1.0
    assert torch.linalg.norm(res) <= 1e-9 * math.sqrt(topo.n_cells)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("dt", list(DTYPES))
def test_kernels_equal_their_plain_versions(cuda, dt):
    """chip_smoke.py's phase 3c at the benchmark's 917,504 cells: three CG
    iterations, each kernel from the plain version's state, vectors bit
    for bit and scalars at chip_smoke.PCG_REL (sums in another order);
    masked iterations write nothing; a sum repeats to the bit."""
    dtype = DTYPES[dt]
    mat = pressure_matrix(*cs.PCG_BENCH, dtype, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    b = torch.randn(mat[0].shape[0], generator=g, device=cuda).to(dtype)
    err = cs.pcg_compare(torch, dk, pk, mat, b, dt)
    assert err <= cs.PCG_REL[str(dtype).replace("torch.", "")]


@pytest.mark.chip
def test_launches_and_reads_per_solve(cuda):
    """A 50-iteration solve at 917,504 cells: cg's iterations, one K1 and
    four launches per enqueued iteration, ceil(50 / block) host reads."""
    mat = pressure_matrix(*cs.PCG_BENCH, torch.float32, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(8)
    b = torch.randn(mat[0].shape[0], generator=g, device=cuda)
    cs.pcg_solve_check(torch, cs.Kernels(dk, pk, krylov), pk, krylov, mat, b)
