"""dafoam_tpu_torch.parallel (P12) against dafoam_tpu.parallel.

- (a) RCB partition ids, the relabelling permutation, the reordered
  topology and cut_statistics exactly equal to dafoam_tpu's: the 16x16
  box into 8 parts, the 32x12 O-mesh into 4. dafoam_tpu's cell centres
  come from its compute_geometry under jax.jit (jax_geometry_jitted), its
  RCB and relabelling from its numpy functions;
- (b) every HaloPlan field equal to dafoam_tpu's build_halo_plan's;
- (c) the local transport's y against dafoam_tpu's single-device
  fvmatrix.matvec at 1e-13, its vjp (all four inputs) and jvp against
  jax.vjp / jax.jvp at 1e-12, scalar and (nc, 3) operands (with an (nc,
  3) or a shared (nc,) diagonal);
- (d) four gloo ranks (separate processes that import only torch and the
  port, a file:// rendezvous with a timeout of its own, the cases handed
  over in a pickle; started with the module, so that they run while the
  other tests do, and waited for by the last two tests of the file): each
  rank's y, vjp and jvp against (c)'s local transport at 1e-13, a CUDA
  operand with the gloo group refused; then a 5-iteration fixed-work
  primal and a 10-sweep fixed-point adjoint with the totals on the
  ranks, equal to the local route at 1e-10 and bit-identical across
  ranks;
- (e) shard_solver on golden cavity_simple (100 cells into 4 parts,
  canonical layout), both adjoint routes: against
  tests/golden/values.json at the golden bars and against the port's
  unsharded run of the reordered mesh at 1e-10 (points 1e-8); under the
  route no DIA product runs. The case fixes p at a reference cell that
  the relabelling moves, which shifts p by a constant only, so U, J and
  the totals are held, not p;
- (f) shard_solver refuses a dense-DIA topology and n_cells % n_parts !=
  0, and pPC "line"/"mg" raise under the route; file_group's scope;
- relabelled boxes with 34 and 58 bands run their unsharded products
  banded through the DIA kernels (they take 64, as dafoam_tpu's
  topo.dia()); one with 74 runs them face-based and its vector solves
  cell-major.

dafoam_tpu's own 8-device shard_map path is not run here
(tests/test_sharding.py runs it).
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

# JAX and the shared cases are imported where they are used: the gloo
# ranks import this module, and they need only torch and the port

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KINDS = {"zmin": "empty", "zmax": "empty", "xmin": "wall", "xmax": "wall",
         "ymin": "wall", "ymax": "wall"}
CASES = {"box16x16-8": 8, "omesh32x12-4": 4}
OPERANDS = ("scalar", "vector", "shared_diag")
N_RANKS = 4
RANK_TIMEOUT = 120.0         # seconds for the ranks' whole run


def _mesh(case, lib):
    from test_torch_cases import omesh_jax, omesh_torch
    if case.startswith("omesh"):
        return omesh_jax() if lib == "jax" else omesh_torch()
    if lib == "jax":
        from dafoam_tpu.mesh import box_hex_mesh
    else:
        from dafoam_tpu_torch.mesh import box_hex_mesh
    return box_hex_mesh(16, 16, 1, (0.1, 0.1, 0.01), kinds=KINDS)


@pytest.fixture(scope="module")
def reordered():
    """Per case: dafoam_tpu's (cc, part, perm, topology) and the port's
    (part, perm, topology)."""
    import jax.numpy as jnp
    from dafoam_tpu.mesh import geometry
    from dafoam_tpu.mesh.topology import apply_cell_permutation
    from dafoam_tpu.parallel.partition import partition_cells
    from dafoam_tpu_torch.parallel import partition
    from test_torch_cases import jax_geometry_jitted

    out = {}
    for case, n in CASES.items():
        pj, tj = _mesh(case, "jax")
        with jax_geometry_jitted():
            cc = np.asarray(geometry.compute_geometry(jnp.asarray(pj), tj).cc)
        part_j = partition_cells(cc, n)
        perm_j = np.argsort(part_j, kind="stable").astype(np.int64)
        pt, tt = _mesh(case, "torch")
        part_t = partition.partition_cells(partition.cell_centres(tt, pt), n)
        t2, perm_t = partition.reorder_for_partitions(tt, pt, n)
        out[case] = {"n": n, "topo_j": tj, "part_j": part_j, "perm_j": perm_j,
                     "topo2_j": apply_cell_permutation(tj, perm_j),
                     "topo_t": tt, "part_t": part_t, "perm_t": perm_t,
                     "topo2_t": t2}
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_partition_equals_dafoam_tpu(reordered, case):
    from dafoam_tpu.parallel.partition import cut_statistics as jcut
    from dafoam_tpu_torch.parallel.partition import cut_statistics
    r = reordered[case]
    assert r["part_t"].dtype == r["part_j"].dtype
    assert np.array_equal(r["part_t"], r["part_j"])
    assert np.ptp(np.bincount(r["part_t"])) == 0          # equal parts
    assert r["perm_t"].dtype == r["perm_j"].dtype
    assert np.array_equal(r["perm_t"], r["perm_j"])
    a, b = r["topo2_t"], r["topo2_j"]
    for name in ("n_cells", "n_points", "n_internal"):
        assert getattr(a, name) == getattr(b, name), name
    for name in ("face_verts", "face_nverts", "owner", "neighbour"):
        x, y = getattr(a, name), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert [(p.name, p.start, p.size, p.kind) for p in a.patches] == \
        [(p.name, p.start, p.size, p.kind) for p in b.patches]
    blocks = np.arange(a.n_cells) // (a.n_cells // r["n"])
    for got, want in ((cut_statistics(r["topo_t"], r["part_t"]),
                       jcut(r["topo_j"], r["part_j"])),
                      (cut_statistics(a, blocks), jcut(b, blocks))):
        assert got == want
    assert cut_statistics(a, blocks)["cut_fraction"] < 0.25


@pytest.mark.parametrize("case", list(CASES))
def test_halo_plan_equals_dafoam_tpu(reordered, case):
    from dafoam_tpu.parallel.halo import build_halo_plan as jplan
    from dafoam_tpu_torch.parallel.halo import build_halo_plan
    r = reordered[case]
    got = build_halo_plan(r["topo2_t"], r["n"])
    want = jplan(r["topo2_j"], r["n"])
    assert got._fields == want._fields
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, tuple) and b and isinstance(b[0], np.ndarray):
            assert len(a) == len(b), name
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y), name
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        else:
            assert a == b and type(a) is type(b), name
    assert got.cut_faces > 0 and len(got.dists) > 1


# ---------------------------------------------------------------------------
# the product: local transport (c) and gloo ranks (d)
# ---------------------------------------------------------------------------

def product_inputs(topo, operand, seed=7):
    """(diag, lower, upper, x, cotangent, four tangents) as float64 numpy
    arrays: scalar operands, (nc, 3) x with an (nc, 3) diagonal, or (nc,
    3) x with a shared (nc,) diagonal."""
    rng = np.random.default_rng(seed)
    nc, ni = topo.n_cells, topo.n_internal
    cell = (nc,) if operand == "scalar" else (nc, 3)
    dg = (nc, 3) if operand == "vector" else (nc,)
    return (rng.normal(size=dg) + 5.0, rng.normal(size=ni),
            rng.normal(size=ni), rng.normal(size=cell), rng.normal(size=cell),
            rng.normal(size=dg), rng.normal(size=ni), rng.normal(size=ni),
            rng.normal(size=cell))


def torch_products(hm, arrays):
    """[y, vjp of (diag, lower, upper, x), jvp] of one HaloMatvec."""
    import torch.autograd.forward_ad as fwAD
    d, lo, up, x, ct, *tang = (torch.as_tensor(a) for a in arrays)
    prim = [t.clone().requires_grad_(True) for t in (d, lo, up, x)]
    y = hm(*prim)
    grads = torch.autograd.grad(y, prim, ct)
    with fwAD.dual_level():
        duals = [fwAD.make_dual(p, t) for p, t in zip((d, lo, up, x), tang)]
        jt = fwAD.unpack_dual(hm(*duals)).tangent
    return [t.detach().numpy() for t in (y, *grads, jt)]


def jax_products(topo, operand_arrays):
    """The same products of dafoam_tpu's single-device fvmatrix.matvec,
    for each operand set, under one jax.jit."""
    import jax
    import jax.numpy as jnp
    from dafoam_tpu.ops import fvmatrix as fvx

    def mv(d, lo, up, x):
        return fvx.matvec(fvx.FvMatrix(d, lo, up, jnp.zeros(d.shape)), x,
                          topo)

    def products(d, lo, up, x, ct, td, tl, tu, tx):
        y, f = jax.vjp(mv, d, lo, up, x)
        _, jt = jax.jvp(mv, (d, lo, up, x), (td, tl, tu, tx))
        return (y, *f(ct), jt)

    run = jax.jit(lambda sets: [products(*a) for a in sets])
    out = run([[jnp.asarray(a) for a in arrays]
               for arrays in operand_arrays])
    return [[np.asarray(a) for a in o] for o in out]


def local_products(topo, n, operand):
    from dafoam_tpu_torch.parallel.halo import HaloMatvec
    hm = HaloMatvec(topo, n, device="cpu")
    out = torch_products(hm, product_inputs(topo, operand))
    assert hm.calls == 2
    return out


PRODUCT_NAMES = ("y", "dbar", "lbar", "ubar", "xbar", "jvp")


@pytest.fixture(scope="module")
def jax_side(reordered):
    """dafoam_tpu's products per case and operand kind."""
    out = {}
    for case, r in reordered.items():
        sets = [product_inputs(r["topo2_t"], op) for op in OPERANDS]
        out[case] = dict(zip(OPERANDS, jax_products(r["topo2_j"], sets)))
    return out


@pytest.mark.parametrize("operand", OPERANDS)
@pytest.mark.parametrize("case", list(CASES))
def test_local_halo_matvec_matches_dafoam_tpu(reordered, jax_side, case,
                                              operand):
    r = reordered[case]
    got = local_products(r["topo2_t"], r["n"], operand)
    for name, a, b in zip(PRODUCT_NAMES, got, jax_side[case][operand]):
        tol = 1e-13 if name == "y" else 1e-12
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)


@pytest.fixture(scope="module")
def cavity4():
    """Golden cavity_simple's box, relabelled into 4 RCB parts: (points,
    topology), shared by (d), (e) and (f); each solver takes a copy of
    the topology object, so no route leaks into another test."""
    from dafoam_tpu_torch.parallel import reorder_for_partitions
    from test_torch_options import cavity_box
    pts, topo = cavity_box("torch")
    return pts, reorder_for_partitions(topo, pts, 4)[0]


def fixed_work_options():
    """The cavity's fixed-work run: 5 SIMPLE outers and 10 Richardson
    sweeps of the fixed-point adjoint, every inner solve a fixed
    smoother (fvsolve.fixed_inner)."""
    from test_torch_options import cavity_options
    return cavity_options(
        meshFaceLayout="canonical", primalMinResTol=0.0, primalMaxIters=5,
        primalLinearSolver={"pMaxIters": 10, "uMaxIters": 2},
        adjEqnSolMethod="fixedPoint",
        adjEqnOption={"fpAcceleration": "richardson", "fpRelTol": 1e-30,
                      "fpMaxIters": 10, "fpInnerScale": 0.5})


def fixed_work_run(case, group=None):
    """(U, J, psibar U, dJ/dnu, dJ/dpoints) of the fixed-work cavity run
    on the halo route: local transport, or this rank's of ``group``.
    ``case`` is (points, topology, options)."""
    from dafoam_tpu_torch.linalg import fvsolve
    from dafoam_tpu_torch.parallel import halo, shard_solver
    from dafoam_tpu_torch.solvers import make_solver
    pts, topo, opts = case
    s = make_solver(opts, dataclasses.replace(topo), pts, device="cpu",
                    dtype=torch.float64)
    hm = shard_solver(s, N_RANKS, group=group)
    try:
        x = s.make_inputs()
        with fvsolve.fixed_inner(1.0):
            w, _ = s.run_primal(s.init_state(), x)
        J = s.run_function("lidForce", w, x)
        psi, _ = s.solve_adjoint(w, x, "lidForce")
        tot = s.total_derivative(w, x, "lidForce", psi)
    finally:
        halo.deactivate(s.topo)
    assert hm.calls > 0
    return [t.detach() for t in (w["U"], J.reshape(1), psi["U"],
                                 tot["params"]["nu"].reshape(1),
                                 tot["points"])]


FIXED_WORK_NAMES = ("U", "J", "psibar_U", "dJdnu", "dJdpoints")


def rank_main(rank, rdzv, out):
    """One gloo rank of test (d): the products of the 4-part O-mesh, the
    refusal of a CUDA operand, the fixed-work cavity run, on the cases
    the parent wrote to ``out``/cases.pkl; results to
    ``out``/rank<r>.npz."""
    from dafoam_tpu_torch.parallel.halo import HaloMatvec, assert_replicated
    from dafoam_tpu_torch.parallel.shard import file_group
    torch.set_num_threads(1)
    with open(os.path.join(out, "cases.pkl"), "rb") as fh:
        topo2, cavity = pickle.load(fh)
    with file_group(rdzv, rank, N_RANKS, "cpu", timeout_s=60.0) as group:
        res = {}
        for operand in OPERANDS:
            hm = HaloMatvec(topo2, N_RANKS, device="cpu", group=group)
            vals = torch_products(hm, product_inputs(topo2, operand))
            res.update({f"{operand}_{k}": v
                        for k, v in zip(PRODUCT_NAMES, vals)})
        try:
            HaloMatvec(topo2, N_RANKS, device="cuda", group=group)
            res["cuda_refused"] = np.array(False)
        except ValueError:
            res["cuda_refused"] = np.array(True)
        vals = fixed_work_run(cavity, group)
        assert_replicated(vals, group, "fixed-work result")
        res.update({f"fw_{k}": v.numpy()
                    for k, v in zip(FIXED_WORK_NAMES, vals)})
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)


# ---------------------------------------------------------------------------
# shard_solver on golden cavity_simple (e) and its refusals (f)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cavity_routes(cavity4):
    """The reordered golden cavity's primal on the unsharded route and on
    the halo route (4 parts), each solver on a topology object of its
    own; the halo route stays active until the module ends."""
    from dafoam_tpu_torch.ops import dia_kernels as dk
    from dafoam_tpu_torch.parallel import halo, shard_solver
    from dafoam_tpu_torch.solvers import make_solver
    from test_torch_options import cavity_options
    pts, topo = cavity4
    runs = {}
    for route in ("unsharded", "halo"):
        t = dataclasses.replace(topo)
        s = make_solver(cavity_options(meshFaceLayout="canonical"), t, pts,
                        device="cpu", dtype=torch.float64)
        hm = shard_solver(s, 4) if route == "halo" else None
        x = s.make_inputs()
        dk.reset_counts()
        w, info = s.run_primal(s.init_state(), x)
        assert info.converged and not info.failed, (route, info)
        runs[route] = {"s": s, "x": x, "w": w, "hm": hm,
                       "dia": sum(dk.COUNTS.values())}
    yield runs
    halo.deactivate(runs["halo"]["s"].topo)


@pytest.mark.parametrize("method", ["Krylov", "fixedPoint"])
def test_shard_solver_cavity_golden(cavity_routes, method):
    from dafoam_tpu_torch.ops import dia_kernels as dk
    with open(os.path.join(REPO, "tests", "golden", "values.json")) as fh:
        golden = json.load(fh)["cavity_simple"]
    got = {}
    for route, run in cavity_routes.items():
        s, x, w = run["s"], run["x"], run["w"]
        s.option.set("adjEqnSolMethod", method)
        dk.reset_counts()
        calls0 = run["hm"].calls if run["hm"] else 0
        psi, ai = s.run_adjoint("lidForce", w, x)
        assert ai.converged, (route, method, ai)
        tot = s.run_totals("lidForce", w, x, psi)
        dia = sum(dk.COUNTS.values())
        if route == "halo":
            # every LDU product of the primal, the adjoint, its PC and the
            # totals went through the halo route: no DIA product ran
            assert run["dia"] == 0 and dia == 0
            assert run["hm"].calls > calls0 > 0
        else:
            assert run["dia"] > 0 and dia > 0    # the banded products
        got[route] = {
            "U": w["U"], "points": tot["points"],
            "lidForce": float(s.run_function("lidForce", w, x)),
            "dLidForce_dnu": float(tot["params"]["nu"]),
            "dLidForce_dUlid_x": float(tot["bc"]["U"]["ymax"][0]),
            "dLidForce_dpoints_norm": float(torch.linalg.norm(
                tot["points"]))}
    halo_r, ref = got["halo"], got["unsharded"]
    for key, val in golden.items():
        bar = 1e-8 if key == "lidForce" else 1e-6
        assert abs(halo_r[key] - val) <= bar * abs(val), \
            (method, key, halo_r[key], val)
        assert halo_r[key] == pytest.approx(ref[key], rel=1e-10, abs=1e-14), \
            (method, key)
    np.testing.assert_allclose(halo_r["U"].numpy(), ref["U"].numpy(),
                               atol=1e-10)
    np.testing.assert_allclose(halo_r["points"].numpy(),
                               ref["points"].numpy(), rtol=1e-8, atol=1e-12)


def test_shard_solver_refusals(cavity4):
    from dafoam_tpu_torch.linalg import fvsolve
    from dafoam_tpu_torch.ops.fvmatrix import FvMatrix
    from dafoam_tpu_torch.parallel import halo, shard_solver
    from dafoam_tpu_torch.solvers import make_solver
    from test_torch_options import cavity_options
    pts, topo = cavity4
    dense = make_solver(cavity_options(meshFaceLayout="diaDense"),
                        dataclasses.replace(topo), pts,
                        device="cpu", dtype=torch.float64)
    assert dense.topo.dia_dense() is not None
    with pytest.raises(ValueError, match="canonical"):
        shard_solver(dense, 4)
    s = make_solver(cavity_options(meshFaceLayout="canonical"),
                    dataclasses.replace(topo), pts, device="cpu",
                    dtype=torch.float64)
    with pytest.raises(ValueError, match="multiple"):
        shard_solver(s, 3)
    assert halo.active(s.topo) is None
    hm = shard_solver(s, 4)
    try:
        assert halo.active(s.topo) is hm and shard_solver(s, 4) is hm
        nc, ni = s.topo.n_cells, s.topo.n_internal
        m = FvMatrix(torch.full((nc,), 4.0, dtype=torch.float64),
                     -torch.ones(ni, dtype=torch.float64),
                     -torch.ones(ni, dtype=torch.float64),
                     torch.ones(nc, dtype=torch.float64))
        x0 = torch.zeros(nc, dtype=torch.float64)
        for pc in ("line", "mg"):
            with pytest.raises(ValueError, match="halo route"):
                fvsolve.solve(m, x0, s.topo, symmetric=True, pc=pc)
        _, info = fvsolve.solve(m, x0, s.topo, symmetric=True)
        assert info.converged
    finally:
        halo.deactivate(s.topo)
    assert halo.active(s.topo) is None


def test_file_group_scope(tmp_path):
    """file_group takes gloo for a CPU device, leaves the deterministic
    mode as it found it (it turns it on only for NCCL) and destroys the
    group at exit, also when the body raises."""
    import torch.distributed as dist
    from dafoam_tpu_torch.parallel.shard import file_group
    was = torch.are_deterministic_algorithms_enabled()
    with pytest.raises(KeyError):
        with file_group(str(tmp_path / "rdzv"), 0, 1, "cpu",
                        timeout_s=30.0) as group:
            assert dist.get_backend(group) == "gloo"
            assert dist.get_world_size(group) == 1
            assert torch.are_deterministic_algorithms_enabled() == was
            raise KeyError("body")
    assert not dist.is_initialized()
    assert torch.are_deterministic_algorithms_enabled() == was


@pytest.mark.parametrize("n,bands", [(24, 34), (48, 58), (64, 74)])
def test_relabelled_mesh_beyond_the_kernels_bands(n, bands):
    """A relabelled box has more bands than a structured one: up to 64,
    where topo.dia() (as dafoam_tpu's) stops giving a band layout, the
    products run banded through the DIA kernels, beyond it face-based; a
    vector solve then stays cell-major."""
    from dafoam_tpu_torch.linalg import fvsolve
    from dafoam_tpu_torch.mesh import box_hex_mesh
    from dafoam_tpu_torch.ops import dia_kernels as dk
    from dafoam_tpu_torch.ops import fvmatrix as fvx
    from dafoam_tpu_torch.parallel import reorder_for_partitions
    pts, topo = box_hex_mesh(n, n, 1, (0.1, 0.1, 0.01), kinds=KINDS)
    topo, _ = reorder_for_partitions(topo, pts, 8)
    own = topo.owner[:topo.n_internal].astype(np.int64)
    assert np.unique(np.concatenate([topo.neighbour - own,
                                     own - topo.neighbour])).size == bands
    banded = bands <= dk.MAX_OFFSETS
    assert (topo.dia() is not None) == banded
    assert fvx.banded(topo) == banded
    nc, ni = topo.n_cells, topo.n_internal
    rng = np.random.default_rng(3)
    m = fvx.FvMatrix(*(torch.as_tensor(a) for a in (
        rng.normal(size=(nc, 3)) + 8.0, rng.normal(size=ni),
        rng.normal(size=ni), rng.normal(size=(nc, 3)))))
    x = torch.as_tensor(rng.normal(size=nc))
    ms = m._replace(diag=m.diag[:, 0], source=m.source[:, 0])
    dk.reset_counts()
    y = fvx.matvec_fn(ms, topo)(x)
    assert (dk.COUNTS["dia_matvec_plain"] == 1) == banded
    np.testing.assert_allclose(y.numpy(), fvx.matvec(ms, x, topo).numpy(),
                               rtol=1e-13, atol=1e-13)
    u, info = fvsolve.solve(m, torch.zeros(nc, 3, dtype=torch.float64),
                            topo, rel_tol=1e-12)
    assert info.converged
    assert (dk.COUNTS["dia_matvec_multi_plain"] > 0) == banded
    np.testing.assert_allclose(fvx.matvec(m, u, topo).numpy(),
                               m.source.numpy(), atol=1e-10)


# ---------------------------------------------------------------------------
# the gloo ranks of (d): started with the module, waited for last
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def gloo_launch(request, tmp_path_factory, cavity4):
    """Start the N_RANKS gloo ranks (one process each) when the module
    starts, so that they run while (a)-(c), (e) and (f) do; gloo_ranks
    waits for them. Nothing starts when no test of (d) was selected.
    Yields (directory, processes, reordered O-mesh, cavity case)."""
    if not any("gloo_ranks" in item.fixturenames
               for item in request.session.items
               if getattr(item, "module", None) is request.module):
        yield None
        return
    from dafoam_tpu_torch.parallel.partition import reorder_for_partitions
    from test_torch_cases import omesh_torch
    tmp = tmp_path_factory.mktemp("gloo")
    pts, topo = omesh_torch()
    topo2, _ = reorder_for_partitions(topo, pts, N_RANKS)
    cavity = (*cavity4, fixed_work_options())
    with open(tmp / "cases.pkl", "wb") as fh:
        pickle.dump((topo2, cavity), fh)
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]; "
            "import test_torch_parallel as t; "
            "t.rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])"
            ).format(os.path.join(REPO, "tests"), REPO)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    try:
        for r in range(N_RANKS):
            with open(tmp / f"rank{r}.log", "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code, str(r), str(tmp / "rdzv"),
                     str(tmp)], env=env, stdout=log,
                    stderr=subprocess.STDOUT))
        yield tmp, procs, topo2, cavity
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def gloo_ranks(gloo_launch):
    """The local references, computed here, and the ranks' results: every
    rank must exit 0 within RANK_TIMEOUT seconds of this wait. Yields
    (rank results, local references)."""
    tmp, procs, topo2, cavity = gloo_launch
    ref = {op: local_products(topo2, N_RANKS, op) for op in OPERANDS}
    ref["fixed_work"] = [t.numpy() for t in fixed_work_run(cavity)]
    for p in procs:
        p.wait(timeout=RANK_TIMEOUT)
    for r, p in enumerate(procs):
        assert p.returncode == 0, \
            f"rank {r} exited {p.returncode}:\n" + \
            (tmp / f"rank{r}.log").read_text(errors="replace")
    yield [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N_RANKS)], ref


def test_gloo_ranks_match_local_transport(gloo_ranks):
    ranks, ref = gloo_ranks
    for r, res in enumerate(ranks):
        assert bool(res["cuda_refused"]), f"rank {r} took a CUDA operand"
        for operand in OPERANDS:
            for name, want in zip(PRODUCT_NAMES, ref[operand]):
                np.testing.assert_allclose(
                    res[f"{operand}_{name}"], want, rtol=1e-13, atol=1e-13,
                    err_msg=f"rank {r} {operand} {name}")


def test_gloo_fixed_work_primal_adjoint(gloo_ranks):
    ranks, ref = gloo_ranks
    for r, res in enumerate(ranks):
        for name, want in zip(FIXED_WORK_NAMES, ref["fixed_work"]):
            np.testing.assert_allclose(res[f"fw_{name}"], want, rtol=1e-10,
                                       atol=1e-10 * np.abs(want).max(),
                                       err_msg=f"rank {r} {name}")
