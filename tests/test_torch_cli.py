"""dafoam_tpu_torch's command-line tools against dafoam_tpu's (CPU):

every tool through ``main([...])`` beside the same call of
``dafoam_tpu.scripts.cli.main``:

- ckdiff, ckget, fieldrmse, probe and meshinfo print the same lines and
  return the same codes (meshinfo and probe with ``--device cpu``; with
  the default ``--device cuda`` they raise where no CUDA device is);
- plot3dtransform, plot3d2tecplot and stltransform write the same bytes;
  surfvtk the same VTK but for the title line, which names the package;
- ``main([])`` and an unknown tool return 2, also through ``python -m``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_cases import REPO

torch.set_num_threads(1)
FIXTURE = os.path.join(REPO, "tests", "fixtures", "ofcase")


def run_both(capsys, argv, argv_jax=None):
    """(port rc, port stdout), (dafoam_tpu rc, its stdout)."""
    from dafoam_tpu.scripts import cli as jcli
    from dafoam_tpu_torch.scripts import cli
    capsys.readouterr()
    rc = cli.main(argv)
    out = capsys.readouterr().out
    jrc = jcli.main(argv if argv_jax is None else argv_jax)
    return (rc, out), (jrc, capsys.readouterr().out)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A written 8x4 channel case, two history checkpoints, a plot3d grid
    and an ASCII STL."""
    from dafoam_tpu_torch.mesh import box_hex_mesh
    from dafoam_tpu_torch.mesh.polymesh import write_polymesh
    from dafoam_tpu_torch.utils.checkpoint import save_checkpoint
    d = tmp_path_factory.mktemp("cli")
    pts, topo = box_hex_mesh(8, 4, 1, (2.0, 1.0, 0.1),
                             kinds={"zmin": "empty", "zmax": "empty",
                                    "ymin": "wall", "ymax": "wall"})
    write_polymesh(str(d / "case"), pts, topo)
    rng = np.random.default_rng(9)
    hist = {"T": rng.standard_normal((5, topo.n_cells)),
            "U": rng.standard_normal((5, topo.n_cells, 3))}
    save_checkpoint(str(d / "a.npz"), hist, meta={"run": "a"})
    save_checkpoint(str(d / "b.npz"),
                    {k: v + 1e-3 * rng.standard_normal(v.shape)
                     for k, v in hist.items()})
    save_checkpoint(str(d / "a2.npz"), {k: torch.as_tensor(v)
                                        for k, v in hist.items()})
    with open(d / "grid.xyz", "w") as fh:
        dims = [(3, 2, 2), (2, 4, 1)]
        fh.write(f"{len(dims)}\n" + "".join(f"{i} {j} {k}\n"
                                            for i, j, k in dims))
        for i, j, k in dims:
            fh.write(" ".join("%.15g" % v for v in
                              rng.standard_normal(3 * i * j * k)) + "\n")
    with open(d / "part.stl", "w") as fh:
        fh.write("solid part\n")
        for _ in range(3):
            fh.write("  facet normal 0 0 1\n    outer loop\n")
            for p in rng.standard_normal((3, 3)):
                fh.write("      vertex %.9g %.9g %.9g\n" % tuple(p))
            fh.write("    endloop\n  endfacet\n")
        fh.write("endsolid part\n")
    return d


def test_ckdiff_ckget_fieldrmse(capsys, files):
    a, b, a2 = (str(files / n) for n in ("a.npz", "b.npz", "a2.npz"))
    for argv in (["ckdiff", a, b], ["ckdiff", a, a2],
                 ["ckdiff", a, b, "--rtol", "1.0"],
                 ["ckget", a, "state/U", "--index", "7"],
                 ["ckget", b, "state/T"],
                 ["fieldrmse", a, b, "T"], ["fieldrmse", a, b, "U"]):
        got, want = run_both(capsys, argv)
        assert got == want, argv
        assert got[1]
    assert run_both(capsys, ["ckdiff", a, b])[0][0] == 1
    assert run_both(capsys, ["ckdiff", a, a2])[0][0] == 0


def test_meshinfo_and_probe(capsys, files, tmp_path):
    case = str(files / "case")
    for c in (case, FIXTURE):
        got, want = run_both(capsys, ["meshinfo", c, "--device", "cpu"],
                             ["meshinfo", c])
        assert got == want, c
    assert got[1].startswith("cells=2 faces=10 internal=1 points=9")
    argv = ["probe", case, str(files / "a.npz"), "U", "--coords", "0.3",
            "0.6", "0.05"]
    got, want = run_both(capsys, argv + ["--device", "cpu"], argv)
    assert got == want and len(got[1].splitlines()) == 5
    got, want = run_both(
        capsys, argv + ["--device", "cpu", "--out", str(tmp_path / "t")],
        argv + ["--out", str(tmp_path / "j")])
    assert got[0] == want[0] == 0
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    if not torch.cuda.is_available():
        from dafoam_tpu_torch.scripts import cli
        for tool in (["meshinfo", case], argv):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cli.main(tool)


@pytest.mark.parametrize("tool,extra", [
    ("plot3dtransform", ["--scale", "2.5", "--translate", "1", "-2", "0.5",
                         "--rotate", "z", "30"]),
    ("plot3dtransform", ["--rotate", "x", "-45"]),
    ("plot3d2tecplot", []),
    ("stltransform", ["--scale", "0.001", "--rotate", "y", "90",
                      "--translate", "0", "0", "3"]),
])
def test_geometry_files_byte_identical(capsys, files, tmp_path, tool, extra):
    src = str(files / ("part.stl" if tool == "stltransform" else "grid.xyz"))
    (rc, _), (jrc, _) = run_both(
        capsys, [tool, src, str(tmp_path / "t")] + extra,
        [tool, src, str(tmp_path / "j")] + extra)
    assert rc == jrc == 0
    assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    assert (tmp_path / "t").stat().st_size > 100


def test_surfvtk(capsys, files, tmp_path):
    case, ck = str(files / "case"), str(files / "a.npz")
    (rc, _), (jrc, _) = run_both(
        capsys, ["surfvtk", ck, case, str(tmp_path / "t.vtk"), "--patches",
                 "ymin", "xmax"],
        ["surfvtk", ck, case, str(tmp_path / "j.vtk"), "--patches", "ymin",
         "xmax"])
    assert rc == jrc == 0
    t, j = ((tmp_path / n).read_text().splitlines()
            for n in ("t.vtk", "j.vtk"))
    assert t[:1] + t[2:] == j[:1] + j[2:] and len(t) > 20


def test_main_usage(capsys):
    from dafoam_tpu_torch.scripts import cli
    assert cli.main([]) == 2
    assert cli.main(["nosuchtool"]) == 2
    out = capsys.readouterr().out
    assert "dafoam_tpu_torch.scripts.cli" in out and "fieldrmse" in out
    r = subprocess.run([sys.executable, "-m", "dafoam_tpu_torch.scripts.cli"],
                       cwd=REPO, capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 2 and "tools:" in r.stdout, r.stderr
