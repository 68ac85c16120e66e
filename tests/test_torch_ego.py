"""EGO, OptFuncs and DAFoamVSPVolume of dafoam_tpu_torch against
dafoam_tpu (CPU, f64):

- the GP of tests/test_ego_fvsource.py (25 points of sin(2 x0) + x1^2):
  the NLL's value and gradient at a fixed theta at 1e-12 against the
  reference's formula over dafoam_tpu's kernel; predict (mean and sigma)
  and the expected improvement with its gradient at that theta at 1e-12;
  the fitted GP (L-BFGS-B's paths differ in the last bits, and the fitted
  noise leaves the Gram matrix ill-conditioned): its NLL within 1e-4 of
  dafoam_tpu's and its mean at 1e-4, within 0.15 of the function;
- ego_minimize on tests/test_ego_fvsource.py's quadratic: the initial
  sample identical to dafoam_tpu's (same default_rng), the minimum found
  (fun < 0.02, |x0 - 0.3| < 0.2, at most 16 calls) and within 0.1 of
  dafoam_tpu's optimum;
- OptFuncs.findFeasibleDesign and DAFoamVSPVolume with a callable volume
  on the port's OpenMDAO shim (tests/test_parity_utils.py's cases).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cases import assert_close

torch.set_num_threads(1)


def gp_data():
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, (25, 2))
    y = np.sin(2 * X[:, 0]) + X[:, 1] ** 2
    Xq = rng.uniform(-0.8, 0.8, (10, 2))
    return X, y, Xq


def jax_nll(X, y, theta, noise=1e-10):
    """dafoam_tpu.mdo.ego.GP.fit's nll (a closure there) over its kernel."""
    from dafoam_tpu.mdo.ego import _kernel

    X, y = jnp.asarray(X), jnp.asarray(y)
    yn = (y - y.mean()) / (y.std() + 1e-12)
    n, d = X.shape
    K = _kernel(X, X, theta[:d], theta[d]) \
        + (noise + jnp.exp(theta[d + 1])) * jnp.eye(n)
    L = jnp.linalg.cholesky(K)
    a = jax.scipy.linalg.cho_solve((L, True), yn)
    return 0.5 * yn @ a + jnp.sum(jnp.log(jnp.diag(L)))


THETA = np.array([-0.3, 0.2, 0.1, -5.0])


def jax_gp_at(X, y, theta):
    """dafoam_tpu's GP conditioned at theta (the tail of its fit)."""
    from dafoam_tpu.mdo.ego import GP, _kernel

    gp = GP()
    X, y = jnp.asarray(X), jnp.asarray(y)
    gp.ymean, gp.ystd = float(y.mean()), float(y.std() + 1e-12)
    gp.X, gp.yn = X, (y - gp.ymean) / gp.ystd
    theta = jnp.asarray(theta)
    n, d = X.shape
    K = _kernel(X, X, theta[:d], theta[d]) \
        + (gp.noise + jnp.exp(theta[d + 1])) * jnp.eye(n)
    gp.params, gp.L = theta, jnp.linalg.cholesky(K)
    gp.alpha = jax.scipy.linalg.cho_solve((gp.L, True), gp.yn)
    return gp


@pytest.fixture(scope="module")
def jax_gp():
    from dafoam_tpu.mdo.ego import GP

    X, y, _ = gp_data()
    return GP().fit(X, y)


def test_gp_nll_predict_ei(jax_gp):
    from dafoam_tpu.mdo.ego import expected_improvement as jei
    from dafoam_tpu_torch.mdo.ego import GP, _neg_ei_and_grad

    X, y, Xq = gp_data()
    gp = GP(device="cpu").set_data(X, y)
    v, g = gp.nll_and_grad(THETA)
    jv, jg = jax.value_and_grad(lambda t: jax_nll(X, y, t))(
        jnp.asarray(THETA))
    assert abs(v - float(jv)) <= 1e-12 * abs(float(jv))
    assert_close(g, jg, 1e-12, "nll gradient")

    # predict and EI at the fixed theta
    gp.condition(THETA)
    jgp = jax_gp_at(X, y, THETA)
    mu, sig = gp.predict(Xq)
    jmu, jsig = jgp.predict(jnp.asarray(Xq))
    assert_close(mu, jmu, 1e-12, "mean")
    assert_close(sig, jsig, 1e-12, "sigma")
    f_best = float(y.max())           # EI of order 0.1-1: no cancellation
    for x in Xq[:4]:
        val, grad = _neg_ei_and_grad(gp, f_best, x)

        def jneg(xx):
            return -jei(*jgp.predict(xx[None]), f_best)[0]

        jval, jgrad = jax.value_and_grad(jneg)(jnp.asarray(x))
        assert abs(val - float(jval)) <= 1e-12 * max(abs(float(jval)),
                                                     1e-300)
        assert_close(grad, jgrad, 1e-12, "EI gradient")

    # the fitted hyperparameters: L-BFGS-B's path differs in the last bits,
    # and the fitted noise leaves the Gram matrix ill-conditioned
    fit = GP(device="cpu").fit(X, y)
    nll_fit, _ = fit.nll_and_grad(fit.params.numpy())
    nll_jax = float(jax_nll(X, y, jax_gp.params))
    assert abs(nll_fit - nll_jax) <= 1e-4 * abs(nll_jax), (nll_fit, nll_jax)
    fmu = fit.predict(Xq)[0]
    assert_close(fmu, jax_gp.predict(jnp.asarray(Xq))[0], 1e-4,
                 "fitted mean")
    assert np.abs(fmu.numpy() - (np.sin(2 * Xq[:, 0]) + Xq[:, 1] ** 2)) \
        .max() < 0.15


def test_ego_minimize():
    from dafoam_tpu.mdo.ego import ego_minimize as jego
    from dafoam_tpu_torch.mdo.ego import ego_minimize

    calls = []

    def f(x):
        calls.append(1)
        return float((x[0] - 0.3) ** 2 + (x[1] + 0.2) ** 2)

    res = ego_minimize(f, [(-1, 1), (-1, 1)], n_init=6, n_iter=10, seed=1,
                       device="cpu")
    assert res["fun"] < 0.02, res["fun"]
    assert abs(res["x"][0] - 0.3) < 0.2
    assert len(calls) <= 16
    want = jego(f, [(-1, 1), (-1, 1)], n_init=6, n_iter=10, seed=1)
    np.testing.assert_array_equal(res["X"][:6], want["X"][:6])
    np.testing.assert_array_equal(res["y"][:6], want["y"][:6])
    assert np.abs(res["x"] - want["x"]).max() < 0.1, (res["x"], want["x"])


class _Quad:
    """con0 = x0^2 + x1, con1 = x0 - x1 (invertible toy 'CFD'), built on
    the port's shim."""

    def __new__(cls):
        from dafoam_tpu_torch.mdo import om_shim as om

        class Quad(om.ExplicitComponent):
            def setup(self):
                self.add_input("x0", val=0.0)
                self.add_input("x1", val=0.0)
                self.add_output("con0", val=0.0)
                self.add_output("con1", val=0.0)

            def compute(self, inputs, outputs):
                x0, x1 = float(inputs["x0"][0]), float(inputs["x1"][0])
                outputs["con0"] = x0 * x0 + x1
                outputs["con1"] = x0 - x1

        return Quad()


def test_find_feasible_design():
    from dafoam_tpu_torch.mdo import om_shim as om
    from dafoam_tpu_torch.mdo.optfuncs import OptFuncs

    model = om.Group()
    ivc = om.IndepVarComp()
    ivc.add_output("x0", val=1.0)
    ivc.add_output("x1", val=1.0)
    model.add_subsystem("dvs", ivc, promotes=["*"])
    model.add_subsystem("quad", _Quad(), promotes=["*"])
    prob = om.Problem(model)
    prob.setup()
    ok, norm, _ = OptFuncs({}, prob).findFeasibleDesign(
        ["con0", "con1"], ["x0", "x1"], targets=[5.0, 1.0], maxIter=20,
        tol=1e-8)
    assert ok and norm < 1e-8
    x0 = float(prob.get_val("x0")[0])
    x1 = float(prob.get_val("x1")[0])
    assert abs(x0 * x0 + x1 - 5.0) < 1e-6
    assert abs(x0 - x1 - 1.0) < 1e-6


def test_vsp_volume_component():
    from dafoam_tpu_torch.mdo.vsp import DAFoamVSPVolume

    def vol_fn(vals):
        return (1.0 + vals["W:a"]) * (2.0 + vals["W:b"]) * 3.0

    comp = DAFoamVSPVolume(vsp_vars=["W:a", "W:b"], output_name="vol",
                           volume_fn=vol_fn, scaled=True, step=1e-6)
    comp.setup()
    ins = {"W:a": np.array([0.5]), "W:b": np.array([0.25])}
    outs = {"vol": np.array([0.0])}
    comp.compute(ins, outs)
    assert abs(float(np.atleast_1d(outs["vol"])[0]) - 1.0) < 1e-12
    d_in = {"W:a": np.array([0.0]), "W:b": np.array([0.0])}
    comp.compute_jacvec_product(ins, d_in, {"vol": np.array([1.0])}, "rev")
    vref = vol_fn({"W:a": 0.5, "W:b": 0.25})
    np.testing.assert_allclose(d_in["W:a"], [(2.0 + 0.25) * 3.0 / vref],
                               rtol=1e-4)
    np.testing.assert_allclose(d_in["W:b"], [(1.0 + 0.5) * 3.0 / vref],
                               rtol=1e-4)


def test_mdo_modules_load_no_jax():
    """Importing every P10 module of the port (and its examples) loads
    neither jax nor dafoam_tpu nor the kernel library."""
    import os
    import subprocess
    import sys

    from test_torch_cases import REPO

    code = (
        "import sys; before = set(sys.modules)\n"
        "import dafoam_tpu_torch.inputs, dafoam_tpu_torch.outputs\n"
        "import dafoam_tpu_torch.mesh.check, dafoam_tpu_torch.utils.vtkio\n"
        "import dafoam_tpu_torch.mdo.mphys, dafoam_tpu_torch.mdo.ego\n"
        "import dafoam_tpu_torch.mdo.optimize, dafoam_tpu_torch.mdo.vsp\n"
        "import dafoam_tpu_torch.mdo.optfuncs, dafoam_tpu_torch.coupling\n"
        "import dafoam_tpu_torch.examples.naca0012_drag_opt\n"
        "import dafoam_tpu_torch.examples.field_inversion_sa\n"
        "import dafoam_tpu_torch.examples.cht_heated_plate\n"
        "import dafoam_tpu_torch.examples.fsi_flexible_wall\n"
        "from dafoam_tpu_torch.ops import dia_kernels\n"
        "new = set(sys.modules) - before\n"
        "assert not [m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dafoam_tpu')], 'jax imported'\n"
        "assert not dia_kernels.is_loaded(), 'kernel library loaded'\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, \
        out.stdout + out.stderr
