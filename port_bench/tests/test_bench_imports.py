"""What the harness and the reference load: never JAX or the JAX package
(top-level names compared whole: ``dafoam_tpu_torch`` is not
``dafoam_tpu``), and the reference nothing of the program."""

import ast
import json
import os
import subprocess
import sys

from port_bench.run import FORBIDDEN, forbidden_modules
from port_bench.run import main as run_main

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _loaded_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport json, sys\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m "
                          "in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_whole_name_comparison():
    sys.modules.setdefault("dafoam_tpu_torch_probe_module", sys)
    assert "dafoam_tpu_torch" not in FORBIDDEN
    assert all(m.split(".")[0] in FORBIDDEN for m in forbidden_modules())
    del sys.modules["dafoam_tpu_torch_probe_module"]


def test_a_run_loads_no_jax():
    top = _loaded_after(
        "from port_bench import run\n"
        "r = run.run('sa_primal_1m', 3, 0.0, True, device='cpu', "
        "size=(16, 8))\nassert r['attempted'] == 1\n"
        "import port_bench.control")
    assert "dafoam_tpu_torch" in top
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded_after(
        "from port_bench import meshgen\n"
        "from port_bench.control import control_run\n"
        "import port_bench.case, port_bench.spec\n"
        "checks, _ = control_run('sa_primal_1m', 3, device='cpu', "
        "size=(16, 8))\n"
        "assert set(checks) == {'start_gap', 'state_gap', 'cd_gap'}\n")
    assert not top & ({"dafoam_tpu_torch"} | set(FORBIDDEN)), top


def test_no_reference_file_imports_the_program():
    bad = []
    for root, _, files in os.walk(os.path.join(HERE, "reference")):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(root, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                bad += [(f, n) for n in names if n.split(".")[0] in
                        ("dafoam_tpu_torch",) + FORBIDDEN]
    assert not bad, bad


def test_no_result_without_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        return
    assert run_main(["--workload", "sa_primal_1m", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 3
    assert capsys.readouterr().out == ""
