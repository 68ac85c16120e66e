"""The boundary conditions, fvc and fvm operators of dafoam_tpu_torch
against dafoam_tpu (CPU, f64): values and one vjp each at rel 1e-12.

- every BC type of ``dafoam_tpu.ops.bc`` at rank 0 and, where it has one,
  rank 1, with its values (and the time t of the time-dependent types)
  as inputs, on the 10x10 box and the 32x12 NACA0012 O-mesh;
- fvc div, average_to_faces, cell_sum and reconstruct;
- fvm div with the linear and linearUpwind schemes, div_flux and ddt
  (Euler and backward), on both face layouts.

The vjp is with respect to the geometry (dafoam_tpu's, in both packages),
the field, the face flux and the BC values; the cotangents are random (numpy, one seed). The vjp is
held as one vector at rel 1e-12 and each input's part at 1e-10 of its own
scale. dafoam_tpu's side is one jitted function per case (op by op, it
would compile each primitive at each new shape).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafoam_tpu_torch.utils import tree
from test_torch_cases import LAYOUTS, assert_close

torch.set_num_threads(1)
F64 = torch.float64
MESHES = ("box", "omesh")


def mesh(lib, name, layout="canonical"):
    if lib == "jax":
        from dafoam_tpu.mesh import box_hex_mesh
        from dafoam_tpu.mesh.airfoil import omesh_naca0012
        from dafoam_tpu.mesh.topology import to_dia_dense
    else:
        from dafoam_tpu_torch.mesh import box_hex_mesh
        from dafoam_tpu_torch.mesh.airfoil import omesh_naca0012
        from dafoam_tpu_torch.mesh.topology import to_dia_dense
    if name == "box":
        pts, topo = box_hex_mesh(10, 10, 1, (1.0, 1.0, 0.1),
                                 kinds={"zmin": "empty", "zmax": "empty"})
    else:
        pts, topo = omesh_naca0012(n_wrap=32, n_radial=12, radius=15.0,
                                   first_cell=4e-3)
    if layout == "diaDense":
        topo = to_dia_dense(topo)
    return np.asarray(pts), topo


class Lib:
    """One package's modules under common names."""

    def __init__(self, lib):
        if lib == "jax":
            from dafoam_tpu.mesh.geometry import MeshGeometry
            from dafoam_tpu.ops import bc, fvc, fvm
        else:
            from dafoam_tpu_torch.mesh.geometry import MeshGeometry
            from dafoam_tpu_torch.ops import bc, fvc, fvm
        self.bc, self.fvc, self.fvm = bc, fvc, fvm
        self.const = jnp.asarray if lib == "jax" else torch.as_tensor
        self._geom = MeshGeometry

    def geometry(self, g):
        return self._geom(**g)


@functools.lru_cache(maxsize=None)
def geometry(name, layout):
    """dafoam_tpu's geometry of the mesh as a dict of numpy arrays."""
    from dafoam_tpu.mesh.geometry import compute_geometry
    pts, topo = mesh("jax", name, layout)
    g = jax.jit(lambda p: compute_geometry(p, topo))(jnp.asarray(pts))
    return {k: np.asarray(v) for k, v in g._asdict().items()}


def compare(fn, name, layout, inputs, seed=11, rel=1e-12):
    """fn(lib, topo, geom, **inputs) -> tuple of arrays, in both packages:
    the outputs and one vjp with respect to every float leaf of ``inputs``
    (a dict of numpy arrays / nested dicts) and of the geometry, at rel
    ``rel``."""
    _, tj = mesh("jax", name, layout)
    _, tt = mesh("torch", name, layout)
    inputs = dict(inputs, geom=geometry(name, layout))
    jl, tl = Lib("jax"), Lib("torch")

    def jf(x):
        return tuple(fn(jl, tj, **x))

    jx = jax.tree_util.tree_map(jnp.asarray, inputs)
    rng = np.random.default_rng(seed)
    cts = tuple(rng.standard_normal(o.shape)
                for o in jax.eval_shape(jf, jx))

    @jax.jit
    def value_and_vjp(x, ct):
        outs, f_vjp = jax.vjp(jf, x)
        return outs, f_vjp(ct)[0]

    outs, jgrad = value_and_vjp(jx, tuple(jnp.asarray(c) for c in cts))

    tx = tree.tmap(lambda a: torch.tensor(np.asarray(a), dtype=F64)
                   .requires_grad_(), inputs)
    touts = tuple(fn(tl, tt, **tx))
    assert len(touts) == len(outs)
    for i, (o, w) in enumerate(zip(touts, outs)):
        assert_close(o.detach(), np.asarray(w), rel, f"{name} out {i}")
    live = [(o, torch.as_tensor(c)) for o, c in zip(touts, cts)
            if o.requires_grad]
    leaves = tree.leaves(tx)
    if live:
        gs = torch.autograd.grad(sum((o * c).sum() for o, c in live),
                                 leaves, allow_unused=True)
    else:
        gs = [None] * len(leaves)
    jleaves = [np.asarray(w).reshape(-1)
               for w in jax.tree_util.tree_leaves(jgrad)]
    assert len(jleaves) == len(leaves)
    got = [(torch.zeros_like(x) if g is None else g).reshape(-1)
           for x, g in zip(leaves, gs)]
    # the vjp as one vector at rel; each input's part at 100 rel of its
    # own scale (a reduction onto a BC parameter may cancel to 1e-3 of
    # its terms, and then rounding alone is ~1e-12 of the part)
    assert_close(torch.cat(got), np.concatenate(jleaves), rel,
                 f"{name} vjp")
    for i, (g, w) in enumerate(zip(got, jleaves)):
        assert_close(g, w, 100 * rel, f"{name} vjp leaf {i}")


# ---------------------------------------------------------------------------
# boundary conditions
# ---------------------------------------------------------------------------

BC_TYPES = [
    ("zeroGradient", 0), ("extrapolated", 1), ("fixedValue", 0),
    ("fixedValue", 1), ("noSlip", 1), ("calculated", 0),
    ("fixedGradient", 0), ("fixedGradient", 1), ("mixed", 0), ("mixed", 1),
    ("inletOutlet", 0), ("inletOutlet", 1), ("symmetry", 0),
    ("symmetry", 1), ("slip", 0), ("slip", 1), ("multiFreqScalar", 0),
    ("multiFreqVector", 1), ("varyingVelocity", 1),
    ("varyingVelocityInletOutlet", 1), ("homTemp", 0),
    ("wallHeatFluxTransfer", 0), ("fixedWallHeatFlux", 0)]


def bc_case(btype, rank, topo, rng):
    """(spec, values) with ``btype`` on every non-empty patch; random
    per-face values, parametric parameters as value dicts."""
    spec, vals = {}, {}
    for p in topo.patches:
        if p.kind == "empty":
            spec[p.name] = {"type": "empty"}
            continue
        n = p.size
        shape = (n, 3) if rank == 1 else (n,)
        s = {"type": btype}
        if btype in ("fixedValue", "noSlip", "calculated", "fixedGradient",
                     "inletOutlet"):
            vals[p.name] = rng.standard_normal(shape)
        elif btype == "mixed":
            vals[p.name] = {"refValue": rng.standard_normal(shape),
                            "refGrad": rng.standard_normal(shape),
                            "valueFraction": rng.uniform(0.1, 0.9, shape)}
        elif btype in ("multiFreqScalar", "multiFreqVector"):
            ref = rng.standard_normal(3) if rank == 1 \
                else rng.standard_normal()
            vals[p.name] = {"refValue": ref,
                            "amplitudes": rng.uniform(0.1, 1.0, 2),
                            "frequencies": rng.uniform(0.5, 2.0, 2),
                            "phases": rng.uniform(0.0, 1.0, 2)}
            if btype == "multiFreqVector":
                s.update(component=1, endTime=1.0)
        elif btype.startswith("varyingVelocity"):
            s.update(flowComponent=0, normalComponent=1)
            vals[p.name] = {"U0": 2.0, "URate": 0.5, "alpha0": 0.1,
                            "alphaRate": 0.2}
        elif btype == "homTemp":
            vals[p.name] = {"kS": 2.0, "kF": 0.5, "solidThickness": 0.01,
                            "baseTemperature": rng.uniform(300, 400, n)}
        elif btype == "wallHeatFluxTransfer":
            vals[p.name] = {"h": rng.uniform(1.0, 10.0, n),
                            "Ta": rng.uniform(280, 320, n), "kappa": 0.5}
        elif btype == "fixedWallHeatFlux":
            vals[p.name] = {"heatFlux": rng.standard_normal(n),
                            "alphaCpEff": rng.uniform(0.5, 2.0, n)}
        spec[p.name] = s
    return spec, vals


@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("btype,rank", BC_TYPES,
                         ids=[f"{t}-{r}" for t, r in BC_TYPES])
def test_bc_coeffs(btype, rank, name):
    _, topo = mesh("jax", name)
    rng = np.random.default_rng(3)
    spec, vals = bc_case(btype, rank, topo, rng)
    nc, nb = topo.n_cells, topo.n_boundary
    psi = rng.standard_normal((nc, 3) if rank == 1 else (nc,))
    phi_b = rng.standard_normal(nb)

    def fn(L, topo, geom, psi, vals, t):
        geom = L.geometry(geom)
        b = L.bc.coeffs(spec, vals, topo, geom, psi, rank=rank,
                        phi_b=L.const(phi_b), t=t)
        return (b.vc, b.vb, b.gc, b.gb, b.active,
                L.bc.boundary_value(b, psi, topo),
                L.bc.boundary_sngrad(b, psi, topo))

    compare(fn, name, "canonical",
            {"psi": psi, "vals": vals, "t": np.asarray(0.3)})


# ---------------------------------------------------------------------------
# fvc
# ---------------------------------------------------------------------------

def _fields(topo, rng):
    nc, nf, nb = topo.n_cells, topo.n_faces, topo.n_boundary
    return {"s": rng.standard_normal(nc), "v": rng.standard_normal((nc, 3)),
            "s_b": rng.standard_normal(nb),
            "v_b": rng.standard_normal((nb, 3)),
            "phi": rng.standard_normal(nf)}


FVC_OPS = ("div_scalar", "div_vector", "average_to_faces", "cell_sum",
           "reconstruct")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("op", FVC_OPS)
def test_fvc(op, name, layout):
    _, topo = mesh("jax", name, layout)
    f = _fields(topo, np.random.default_rng(4))

    def fn(L, topo, geom, s, v, s_b, v_b, phi):
        geom = L.geometry(geom)
        if op == "div_scalar":
            return (L.fvc.div(geom, topo, phi, s, s_b),)
        if op == "div_vector":
            return (L.fvc.div(geom, topo, phi, v, v_b),)
        if op == "average_to_faces":
            return (L.fvc.average_to_faces(geom, topo, s, s_b),
                    L.fvc.average_to_faces(geom, topo, v, v_b))
        if op == "cell_sum":
            return (L.fvc.cell_sum(geom, s),)
        return (L.fvc.reconstruct(geom, topo, phi),)

    compare(fn, name, layout, f)


# ---------------------------------------------------------------------------
# fvm
# ---------------------------------------------------------------------------

def _spec(topo, rank):
    """fixedValue / inletOutlet / zeroGradient over the non-empty
    patches (the first three of them, cycling)."""
    kinds = ("fixedValue", "inletOutlet", "zeroGradient")
    spec, vals, i = {}, {}, 0
    rng = np.random.default_rng(8)
    for p in topo.patches:
        if p.kind == "empty":
            spec[p.name] = {"type": "empty"}
            continue
        spec[p.name] = {"type": kinds[i % 3]}
        vals[p.name] = rng.standard_normal((p.size, 3) if rank else p.size)
        i += 1
    return spec, vals


# (operator, scheme, rank); div_flux is the scalar (pressure) flux
FVM_OPS = [(op, scheme, rank) for op, scheme in (
    ("div", "linear"), ("div", "linearUpwind"),
    ("div_bounded", "linearUpwind"), ("ddt", "Euler"), ("ddt", "backward"))
    for rank in (0, 1)] + [("div_flux", "upwind", 0), ("div_flux", "linear", 0)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", MESHES)
@pytest.mark.parametrize("op,scheme,rank", FVM_OPS,
                         ids=[f"{o}-{s}-{r}" for o, s, r in FVM_OPS])
def test_fvm(op, scheme, rank, name, layout):
    _, topo = mesh("jax", name, layout)
    rng = np.random.default_rng(6)
    f = _fields(topo, rng)
    spec, vals = _spec(topo, rank)
    key = "v" if rank else "s"
    inputs = {"psi": f[key], "phi": f["phi"], "vals": vals,
              "old": rng.standard_normal(f[key].shape),
              "oldold": rng.standard_normal(f[key].shape)}

    def fn(L, topo, geom, psi, phi, vals, old, oldold):
        geom = L.geometry(geom)
        b = L.bc.coeffs(spec, vals, topo, geom, psi, rank=rank,
                        phi_b=phi[topo.n_internal:])
        if op == "ddt":
            return tuple(L.fvm.ddt(geom, topo, psi, old, 0.1, oldold,
                                   scheme=scheme))
        if op == "div_flux":
            return (L.fvm.div_flux(geom, topo, phi, psi, b, scheme=scheme),)
        return tuple(L.fvm.div(geom, topo, phi, psi, b, scheme=scheme,
                               bounded=op == "div_bounded"))

    compare(fn, name, layout, inputs)
