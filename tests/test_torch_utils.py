"""dafoam_tpu_torch's utils.checkpoint and utils.timing against
dafoam_tpu's (CPU):

- a checkpoint written by either package loads in the other, with equal
  arrays (dtype and values), the same nesting and the same meta; the
  port writes tensors as numpy and loads numpy, which
  ``convert.state_from_numpy`` carries back to a device bit for bit;
- ``rename_solution`` snapshots latest.npz; a '/' in a key raises;
- ``Timer`` accumulates per phase and reports longest first, as the
  reference's; ``block_on`` takes a result or a callable; ``trace`` writes
  a Chrome trace;
- the package's lazy top-level conveniences.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _tree():
    rng = np.random.default_rng(3)
    state = {"U": rng.standard_normal((6, 3)), "p": rng.standard_normal(6),
             "phi": rng.standard_normal(17).astype(np.float32)}
    inputs = {"points": rng.standard_normal((12, 3)),
              "bc": {"U": {"inlet": np.array([1.0, 0.0, 0.0]),
                           "outlet": {"pInf": np.array(2.5)}}},
              "params": {"nu": np.array(1e-3), "aoa": np.array(3.0)}}
    return state, inputs, {"iteration": 4, "CD": 0.0125, "tag": "x"}


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    else:
        assert isinstance(got, np.ndarray)
        assert got.dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, np.asarray(want))


def test_checkpoint_cross_loads(tmp_path):
    from dafoam_tpu.utils import checkpoint as jck
    from dafoam_tpu_torch.convert import inputs_from_numpy, state_from_numpy
    from dafoam_tpu_torch.utils import checkpoint as tck
    state, inputs, meta = _tree()

    # dafoam_tpu writes, the port loads
    jck.save_checkpoint(str(tmp_path / "j.npz"), state, inputs, meta)
    s, x, m = tck.load_checkpoint(str(tmp_path / "j.npz"))
    _assert_tree_equal(s, state)
    _assert_tree_equal(x, inputs)
    assert m == meta

    # the port writes tensors, dafoam_tpu loads
    st = {k: torch.as_tensor(v) for k, v in state.items()}
    xt = inputs_from_numpy(inputs, "cpu", torch.float64)
    tck.save_checkpoint(str(tmp_path / "sub" / "t.npz"), st, xt, meta)
    s, x, m = jck.load_checkpoint(str(tmp_path / "sub" / "t.npz"))
    _assert_tree_equal(s, state)
    _assert_tree_equal(x, inputs)
    assert m == meta
    with np.load(tmp_path / "j.npz") as zj, \
            np.load(tmp_path / "sub" / "t.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        assert json.loads(bytes(zt["__meta__"].tobytes())) == meta

    # back on a device: bit for bit
    s, _, _ = tck.load_checkpoint(str(tmp_path / "sub" / "t.npz"))
    back = state_from_numpy(s, "cpu", torch.float64)
    for k in state:
        assert torch.equal(back[k], torch.as_tensor(state[k],
                                                    dtype=torch.float64))

    # no inputs, no meta
    tck.save_checkpoint(str(tmp_path / "bare.npz"), st)
    assert jck.load_checkpoint(str(tmp_path / "bare.npz"))[1:] == \
        (None, None)
    assert tck.load_checkpoint(str(tmp_path / "bare.npz"))[1:] == \
        (None, None)


def test_checkpoint_slash_key_and_rename(tmp_path):
    from dafoam_tpu.utils import checkpoint as jck
    from dafoam_tpu_torch.utils import checkpoint as tck
    for mod in (jck, tck):
        with pytest.raises(ValueError, match="must not contain '/'"):
            mod.save_checkpoint(str(tmp_path / "bad.npz"),
                                {"a/b": torch.zeros(2).numpy()})
    assert not (tmp_path / "bad.npz").exists()
    assert tck.rename_solution(str(tmp_path), 3) == \
        jck.rename_solution(str(tmp_path), 3)
    assert not (tmp_path / "solution_0003.npz").exists()
    tck.save_checkpoint(str(tmp_path / "latest.npz"), {"p": torch.ones(4)})
    dst = tck.rename_solution(str(tmp_path), 12)
    assert os.path.basename(dst) == "solution_0012.npz"
    assert (tmp_path / "solution_0012.npz").read_bytes() == \
        (tmp_path / "latest.npz").read_bytes()


def test_timer_matches_reference(tmp_path):
    from dafoam_tpu.utils.timing import Timer as JTimer
    from dafoam_tpu_torch.utils import timing
    plan = [("primal", 0.03), ("adjoint", 0.05), ("io", 0.0),
            ("primal", 0.03)]
    reports = []
    for timer in (JTimer(), timing.Timer()):
        for name, dt in plan:
            with timer.phase(name):
                time.sleep(dt)
        reports.append(timer.report())
    for rep in reports:
        assert list(rep) == ["primal", "adjoint", "io"]
        assert rep["primal"] >= 0.06 and rep["adjoint"] >= 0.05
        assert rep["io"] < rep["adjoint"]
    t = timing.Timer()
    x = torch.arange(5.0)
    with t.phase("value", block_on=x):
        y = x * 2
    with t.phase("callable", block_on=lambda: {"y": [y]}):
        y = y + 1
    assert set(t.report()) == {"value", "callable"}
    assert timing.block_until_ready({"a": (x, [y])})["a"][0] is x
    with timing.trace(str(tmp_path / "tr")) as logdir:
        torch.ones(3).sum()
    with open(os.path.join(logdir, "trace.json")) as fh:
        assert "traceEvents" in json.load(fh)


def test_lazy_conveniences():
    import dafoam_tpu_torch
    from dafoam_tpu_torch.mesh import box_hex_mesh
    from dafoam_tpu_torch.mesh.polymesh import read_polymesh
    from dafoam_tpu_torch.solvers import make_solver
    assert dafoam_tpu_torch.make_solver is make_solver
    assert dafoam_tpu_torch.box_hex_mesh is box_hex_mesh
    assert dafoam_tpu_torch.read_polymesh is read_polymesh
    with pytest.raises(AttributeError):
        dafoam_tpu_torch.not_a_name
