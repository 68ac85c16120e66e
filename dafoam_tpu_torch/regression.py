"""In-solver ML models for field inversion / data-driven turbulence (port
of ``dafoam_tpu.regression``, the reference's DARegression).

A per-cell model beta = f(features(W); theta) is evaluated inside the
residual, with theta an adjoint input under
``inputs["params"]["regressionPar"][model name]``; autograd gives
d(residual)/d(theta). Input features follow the reference's set: VoS,
PoD, chiSA, pGradStream, PSoSS, SCurv, UOrth, KoU2.

``external_model`` runs a host model registered with
``register_external_model`` (the reference's externalTensorFlow
callbacks) inside a ``torch.autograd.Function``: its forward and its
reverse product run on numpy copies of the device tensors, a
device-to-host copy each way per call. That is acceptable because no
main path of the port runs an external model.
"""

from __future__ import annotations

import numpy as np
import torch

from dafoam_tpu_torch.ops.core import clip, maximum


# ---------------------------------------------------------------------------
# feature library (each: state/aux -> (nc,) tensor)
# ---------------------------------------------------------------------------

def _vorticity_mag(gradU):
    skew = 0.5 * (gradU - torch.swapaxes(gradU, -1, -2))
    return torch.sqrt(2.0 * maximum((skew * skew).sum(dim=(-2, -1)), 1e-36))


def _strain_mag(gradU):
    sym = 0.5 * (gradU + torch.swapaxes(gradU, -1, -2))
    return torch.sqrt(2.0 * maximum((sym * sym).sum(dim=(-2, -1)), 1e-36))


def _dot(a, b):
    return (a * b).sum(dim=-1)


def compute_features(names, ctx):
    """ctx: dict with U, gradU, p, gradp, nuTilda, nut, nu, wall_dist, k.
    Returns the (nc, F) feature matrix."""
    feats = []
    gradU = ctx["gradU"]
    for n in names:
        if n == "VoS":            # vorticity / strain
            feats.append(_vorticity_mag(gradU) / _strain_mag(gradU))
        elif n == "PoD":          # production / destruction surrogate
            nut = ctx.get("nut", ctx.get("nuTilda"))
            d = maximum(ctx["wall_dist"], 1e-12)
            feats.append(nut * _strain_mag(gradU) * d ** 2
                         / maximum(nut, 1e-16) ** 2)
        elif n == "chiSA":
            feats.append(ctx["nuTilda"] / ctx["nu"])
        elif n == "pGradStream":  # streamwise pressure-gradient alignment
            U, gp = ctx["U"], ctx["gradp"]
            den = torch.sqrt(_dot(U, U) * _dot(gp, gp)) + 1e-16
            feats.append(_dot(U, gp) / den)
        elif n == "PSoSS":        # pressure-strain vs shear-strain surrogate
            gpn = torch.linalg.norm(ctx["gradp"], dim=-1)
            feats.append(gpn / (gpn + _strain_mag(gradU) ** 2 + 1e-16))
        elif n == "SCurv":        # streamline curvature surrogate
            U = ctx["U"]
            magU = torch.linalg.norm(U, dim=-1) + 1e-16
            dUdU = (U[:, :, None] * gradU).sum(dim=1)
            feats.append(torch.linalg.norm(torch.linalg.cross(U, dUdU),
                                           dim=-1) / magU ** 3)
        elif n == "UOrth":        # velocity / wall-normal orthogonality proxy
            U = ctx["U"]
            magU = torch.linalg.norm(U, dim=-1) + 1e-16
            dUdU = (U[:, :, None] * gradU).sum(dim=1)
            feats.append(torch.abs(_dot(U, dUdU))
                         / (magU * torch.linalg.norm(dUdU, dim=-1) + 1e-16))
        elif n == "KoU2":         # tke / U^2 (zero for SA-only runs)
            k = ctx.get("k")
            if k is None:
                k = torch.zeros_like(ctx["nu"] * ctx["wall_dist"])
            feats.append(k / (_dot(ctx["U"], ctx["U"]) + 1e-16))
        else:
            raise NotImplementedError(f"regression feature {n!r}")
    return torch.stack(feats, dim=-1)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def _act(name):
    if name == "sigmoid":
        return lambda x: 1.0 / (1.0 + torch.exp(-x))
    if name == "tanh":
        return torch.tanh
    if name == "relu":
        return lambda x: maximum(x, 0.0)
    if name == "leakyRelu":
        return lambda x: torch.where(x > 0, x, 0.01 * x)
    raise NotImplementedError(name)


def nn_sizes(hidden, n_features, n_out=1):
    """Flat parameter count of a dense net (the reference's flat
    `regressionPar` vector)."""
    sizes = [n_features] + list(hidden) + [n_out]
    return sum(sizes[i] * sizes[i + 1] + sizes[i + 1]
               for i in range(len(sizes) - 1))


def neural_network(theta, features, hidden, activation="sigmoid",
                   out_shift=1.0):
    """Dense feed-forward net over per-cell features -> beta (nc,);
    theta is the flat (P,) parameter vector."""
    act = _act(activation)
    sizes = [features.shape[-1]] + list(hidden) + [1]
    x = features
    off = 0
    for i in range(len(sizes) - 1):
        nin, nout = sizes[i], sizes[i + 1]
        W = theta[off:off + nin * nout].reshape(nin, nout)
        off += nin * nout
        b = theta[off:off + nout]
        off += nout
        x = x @ W + b
        if i < len(sizes) - 2:
            x = act(x)
    return x[..., 0] + out_shift


def radial_basis_function(theta, features, n_rbf, out_shift=1.0):
    """RBF model: theta = [centers (n_rbf,F), widths (n_rbf,F), weights]."""
    F = features.shape[-1]
    c = theta[:n_rbf * F].reshape(n_rbf, F)
    w = theta[n_rbf * F:2 * n_rbf * F].reshape(n_rbf, F)
    a = theta[2 * n_rbf * F:2 * n_rbf * F + n_rbf]
    r2 = ((features[:, None, :] - c[None]) / (w[None] ** 2 + 1e-12)) ** 2
    return torch.exp(-r2.sum(dim=-1)) @ a + out_shift


# ---------------------------------------------------------------------------
# external user models (reference DARegression externalTensorFlow)
# ---------------------------------------------------------------------------

_EXTERNAL_MODELS: dict = {}


def register_external_model(name: str, compute, vjp):
    """Register a host-side model.

    compute(theta, features) -> beta        (numpy arrays, shapes
                                             (P,), (nc,F) -> (nc,))
    vjp(theta, features, beta_bar) -> (theta_bar, features_bar), the
        reverse product of the external framework (reference
        betaJacVecProd).
    """
    _EXTERNAL_MODELS[name] = (compute, vjp)


def _host(t):
    return t.detach().cpu().numpy()


class _ExternalModel(torch.autograd.Function):
    """beta = f_ext(theta, features) with the registered host vjp as its
    backward; each call copies its operands to the host and back."""

    @staticmethod
    def forward(theta, features, name):
        compute, _ = _EXTERNAL_MODELS[name]
        beta = np.asarray(compute(_host(theta), _host(features)))
        return torch.as_tensor(beta.reshape(features.shape[0]),
                               dtype=features.dtype, device=features.device)

    @staticmethod
    def setup_context(ctx, inputs, output):
        theta, features, name = inputs
        ctx.name = name
        ctx.save_for_backward(theta, features)

    @staticmethod
    def backward(ctx, bar):
        theta, features = ctx.saved_tensors
        _, vjp = _EXTERNAL_MODELS[ctx.name]
        tb, xb = vjp(_host(theta), _host(features), _host(bar))
        return (torch.as_tensor(np.asarray(tb).reshape(theta.shape),
                                dtype=theta.dtype, device=theta.device),
                torch.as_tensor(np.asarray(xb).reshape(features.shape),
                                dtype=features.dtype,
                                device=features.device),
                None)


def external_model(name, theta, features):
    """beta = f_ext(theta, features) with the exact external adjoint."""
    if name not in _EXTERNAL_MODELS:
        raise KeyError(f"no external regression model {name!r} registered")
    return _ExternalModel.apply(theta, features, name)


def evaluate(cfg: dict, theta, feature_ctx):
    """One regression model config -> the beta field (nc,)."""
    feats = compute_features(cfg["inputNames"], feature_ctx)
    # feature scaling (reference inputShift/inputScale)
    like = feature_ctx["U"]
    shift = torch.as_tensor(cfg.get("inputShift", 0.0), dtype=like.dtype,
                            device=like.device)
    scale = torch.as_tensor(cfg.get("inputScale", 1.0), dtype=like.dtype,
                            device=like.device)
    feats = (feats + shift) * scale
    mtype = cfg.get("modelType", "neuralNetwork")
    if mtype == "neuralNetwork":
        beta = neural_network(theta, feats, cfg["hiddenLayerNeurons"],
                              cfg.get("activationFunction", "sigmoid"),
                              cfg.get("outputShift", 1.0))
    elif mtype == "radialBasisFunction":
        beta = radial_basis_function(theta, feats, cfg["nRBFs"],
                                     cfg.get("outputShift", 1.0))
    elif mtype in ("externalModel", "externalTensorFlow"):
        beta = external_model(cfg["externalModelName"], theta, feats)
    else:
        raise NotImplementedError(mtype)
    return clip(beta * cfg.get("outputScale", 1.0),
                cfg.get("outputLowerBound", -1e16),
                cfg.get("outputUpperBound", 1e16))
