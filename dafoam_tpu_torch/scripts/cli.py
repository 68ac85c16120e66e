"""Command-line inspectors and geometry tools of dafoam_tpu_torch.

Port of ``dafoam_tpu.scripts.cli``, DAFoam's dafoam/scripts:
dafoam_matdiff/vecdiff/matgetvalues/vecgetvalues (PETSc binary debugging)
become checkpoint-npz diff/get; dafoam_plot3d2tecplot / plot3dtransform /
stltransform become plot3d/stl readers and affine transforms.

Usage:  python -m dafoam_tpu_torch.scripts.cli <tool> [args...]
        (or the ``dafoam_tpu_torch`` console script)
Tools:  ckdiff ckget meshinfo surfvtk plot3dtransform plot3d2tecplot
        stltransform probe fieldrmse

The tools that compute mesh geometry (meshinfo, probe) take ``--device``
(default ``cuda``; ``cpu`` on request) and raise when the device asked
for is a CUDA one and none is present.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


# ---------------------------------------------------------------------------
def _device_arg(ap):
    ap.add_argument("--device", default="cuda",
                    help="device of the geometry computation (default "
                         "cuda; cpu on request)")


def _geometry(pts, topo, device):
    """The mesh geometry in float64 on ``device``; a CUDA device that is
    not present raises (there is no fallback to the CPU)."""
    import torch
    from dafoam_tpu_torch.mesh.geometry import compute_geometry

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is present "
                           "(pass --device cpu to run on the CPU)")
    with torch.no_grad():
        return compute_geometry(
            torch.as_tensor(pts, dtype=torch.float64, device=dev), topo)


def ckdiff(argv):
    """Diff two checkpoint archives (reference dafoam_matdiff/vecdiff)."""
    ap = argparse.ArgumentParser(prog="ckdiff")
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rtol", type=float, default=1e-12)
    ns = ap.parse_args(argv)
    za, zb = np.load(ns.a), np.load(ns.b)
    keys = sorted(set(za.files) | set(zb.files))
    worst = 0.0
    for k in keys:
        if k == "__meta__":
            continue
        if k not in za.files or k not in zb.files:
            print(f"{k}: only in one file")
            continue
        d = np.abs(za[k] - zb[k]).max() if za[k].shape == zb[k].shape \
            else np.inf
        ref = max(np.abs(za[k]).max(), 1e-36)
        print(f"{k}: maxAbsDiff={d:.6e} rel={d/ref:.6e}")
        worst = max(worst, d / ref)
    return 0 if worst <= ns.rtol else 1


def ckget(argv):
    ap = argparse.ArgumentParser(prog="ckget")
    ap.add_argument("file")
    ap.add_argument("key")
    ap.add_argument("--index", type=int, default=None)
    ns = ap.parse_args(argv)
    z = np.load(ns.file)
    a = z[ns.key]
    if ns.index is not None:
        print(a.reshape(-1)[ns.index])
    else:
        print(a)
    return 0


def meshinfo(argv):
    ap = argparse.ArgumentParser(prog="meshinfo")
    ap.add_argument("case", help="OpenFOAM case dir with constant/polyMesh")
    _device_arg(ap)
    ns = ap.parse_args(argv)
    from dafoam_tpu_torch.mesh.check import check_mesh
    from dafoam_tpu_torch.mesh.polymesh import read_polymesh

    pts, topo = read_polymesh(ns.case)
    geom = _geometry(pts, topo, ns.device)
    print(f"cells={topo.n_cells} faces={topo.n_faces} "
          f"internal={topo.n_internal} points={topo.n_points}")
    for p in topo.patches:
        print(f"  patch {p.name}: {p.size} faces ({p.kind})")
    ok, rep = check_mesh(geom, topo, {"maxAspectRatio": 1000.0,
                                      "maxNonOrth": 70.0, "maxSkewness": 4.0,
                                      "maxIncorrectlyOrientedFaces": 0})
    print("quality:", rep, "OK" if ok else "EXCEEDS THRESHOLDS")
    return 0


def surfvtk(argv):
    ap = argparse.ArgumentParser(prog="surfvtk")
    ap.add_argument("checkpoint")
    ap.add_argument("case")
    ap.add_argument("out")
    ap.add_argument("--patches", nargs="+", required=True)
    ns = ap.parse_args(argv)
    from dafoam_tpu_torch.mesh.polymesh import read_polymesh
    from dafoam_tpu_torch.utils.vtkio import write_surface_vtk

    pts, topo = read_polymesh(ns.case)
    write_surface_vtk(ns.out, pts, topo, ns.patches)
    print("wrote", ns.out)
    return 0


# ---------------------------------------------------------------------------
def read_plot3d(path):
    """Multi-block ASCII plot3d (.xyz) -> list of (ni,nj,nk,3) arrays."""
    with open(path) as fh:
        vals = np.array(fh.read().split(), dtype=np.float64)
    nb = int(vals[0])
    dims = vals[1:1 + 3 * nb].astype(int).reshape(nb, 3)
    out = []
    off = 1 + 3 * nb
    for b in range(nb):
        ni, nj, nk = dims[b]
        n = ni * nj * nk
        blk = vals[off:off + 3 * n].reshape(3, nk, nj, ni)
        out.append(np.transpose(blk, (3, 2, 1, 0)))
        off += 3 * n
    return out


def write_plot3d(path, blocks):
    with open(path, "w") as fh:
        fh.write(f"{len(blocks)}\n")
        for b in blocks:
            ni, nj, nk, _ = b.shape
            fh.write(f"{ni} {nj} {nk}\n")
        for b in blocks:
            arr = np.transpose(b, (3, 2, 1, 0)).reshape(-1)
            fh.write("\n".join("%.12g" % v for v in arr) + "\n")


def _affine(ns, pts):
    pts = pts * ns.scale
    if ns.rotate:
        deg = float(ns.rotate[1])
        ax = {"x": 0, "y": 1, "z": 2}[ns.rotate[0]]
        c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
        i, j = [a for a in range(3) if a != ax]
        R = np.eye(3)
        R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
        pts = pts @ R.T
    return pts + np.asarray(ns.translate)


def plot3dtransform(argv):
    """Scale/translate/rotate a plot3d file (reference
    dafoam_plot3dtransform)."""
    ap = argparse.ArgumentParser(prog="plot3dtransform")
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--translate", type=float, nargs=3,
                    default=[0.0, 0.0, 0.0])
    ap.add_argument("--rotate", nargs=2, default=None,
                    metavar=("AXIS", "DEG"))
    ns = ap.parse_args(argv)
    blocks = [
        _affine(ns, b.reshape(-1, 3)).reshape(b.shape)
        for b in read_plot3d(ns.infile)]
    write_plot3d(ns.outfile, blocks)
    print("wrote", ns.outfile)
    return 0


def plot3d2tecplot(argv):
    """Convert a plot3d grid to a Tecplot structured-zone ASCII file
    (DAFoam's dafoam_plot3d2tecplot script)."""
    ap = argparse.ArgumentParser(prog="plot3d2tecplot")
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ns = ap.parse_args(argv)
    blocks = read_plot3d(ns.infile)
    with open(ns.outfile, "w") as fh:
        fh.write('TITLE = "%s"\n' % ns.infile)
        fh.write('VARIABLES = "X" "Y" "Z"\n')
        for bi, b in enumerate(blocks):
            ni, nj, nk, _ = b.shape
            fh.write(f'ZONE T="BLOCK{bi}" I={ni} J={nj} K={nk} '
                     f'DATAPACKING=POINT\n')
            arr = np.transpose(b, (2, 1, 0, 3)).reshape(-1, 3)
            for p in arr:
                fh.write("%.12g %.12g %.12g\n" % (p[0], p[1], p[2]))
    print("wrote", ns.outfile)
    return 0


def stltransform(argv):
    """Scale/translate/rotate an ASCII STL (reference dafoam_stltransform)."""
    ap = argparse.ArgumentParser(prog="stltransform")
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--translate", type=float, nargs=3,
                    default=[0.0, 0.0, 0.0])
    ap.add_argument("--rotate", nargs=2, default=None,
                    metavar=("AXIS", "DEG"))
    ns = ap.parse_args(argv)
    out = []
    with open(ns.infile) as fh:
        lines = fh.readlines()
    for line in lines:
        t = line.split()
        if t[:1] == ["vertex"]:
            p = _affine(ns, np.array([[float(t[1]), float(t[2]),
                                       float(t[3])]]))[0]
            out.append(f"      vertex {p[0]:.9g} {p[1]:.9g} {p[2]:.9g}\n")
        else:
            out.append(line)
    with open(ns.outfile, "w") as fh:
        fh.writelines(out)
    print("wrote", ns.outfile)
    return 0


def probe(argv):
    """Probe-point time series from a history checkpoint (reference
    getProbeTimeSeries)."""
    ap = argparse.ArgumentParser(prog="probe")
    ap.add_argument("case", help="OpenFOAM case dir with constant/polyMesh")
    ap.add_argument("ckpt", help="npz checkpoint with state/<var> history "
                                 "stacked on axis 0")
    ap.add_argument("var")
    ap.add_argument("--coords", type=float, nargs=3, required=True)
    ap.add_argument("--out", default=None)
    _device_arg(ap)
    ns = ap.parse_args(argv)
    from dafoam_tpu_torch.mesh.polymesh import read_polymesh
    from dafoam_tpu_torch.utils.prepost import probe_time_series

    pts, topo = read_polymesh(ns.case)
    geom = _geometry(pts, topo, ns.device)
    z = np.load(ns.ckpt)
    hist = z[f"state/{ns.var}"]
    series = probe_time_series(hist, geom.cc, ns.coords)
    txt = "\n".join(" ".join("%.12g" % x for x in np.atleast_1d(row))
                    for row in series)
    if ns.out:
        with open(ns.out, "w") as fh:
            fh.write(txt + "\n")
        print("wrote", ns.out)
    else:
        print(txt)
    return 0


def fieldrmse(argv):
    """Per-step RMSE between two history checkpoints (reference
    getFieldRMSETimeSeries)."""
    ap = argparse.ArgumentParser(prog="fieldrmse")
    ap.add_argument("ckpt_a")
    ap.add_argument("ckpt_b")
    ap.add_argument("var")
    ns = ap.parse_args(argv)
    from dafoam_tpu_torch.utils.prepost import field_rmse_time_series
    za, zb = np.load(ns.ckpt_a), np.load(ns.ckpt_b)
    for v in field_rmse_time_series(za[f"state/{ns.var}"],
                                    zb[f"state/{ns.var}"]):
        print("%.12g" % v)
    return 0


_TOOLS = {"ckdiff": ckdiff, "ckget": ckget, "meshinfo": meshinfo,
          "surfvtk": surfvtk, "plot3dtransform": plot3dtransform,
          "plot3d2tecplot": plot3d2tecplot,
          "stltransform": stltransform, "probe": probe,
          "fieldrmse": fieldrmse}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in _TOOLS:
        print(__doc__)
        print("tools:", ", ".join(_TOOLS))
        return 2
    return _TOOLS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
