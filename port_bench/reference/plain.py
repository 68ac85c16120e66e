"""The plain reference: one steady incompressible SIMPLE iteration with the
Spalart-Allmaras model on an unstructured finite-volume mesh, written from
the finite-volume formulas in plain torch (face lists, ``index_add``),
cell-major, in the precision it is given (float64 for the check).

It is independent of the program: it takes the benchmark's mesh arrays
(points, faces, owner, neighbour, patches) and the configuration's
options, and imports nothing of the program. What it computes:

- geometry as OpenFOAM defines it: face centres and areas by triangles
  about the mean vertex, cell centres and volumes by pyramids about the
  mean face centre, linear weights from the face-normal distances,
  delta coefficients 1/|d|, the non-orthogonal ones 1/max(n.d, 0.05|d|)
  and the correction vectors n - d/max(n.d, 0.05|d|);
- the wall distance: the exact distance from each cell centre to the
  nearest wall face, in the plane of the extruded 2-D mesh;
- boundary conditions fixedValue, zeroGradient, inletOutlet (fixed on
  inflow faces, zero gradient where the flux leaves) and empty;
- the momentum equation: bounded upwind convection (the convection matrix
  minus div(phi) times the field), -laplacian(nuEff, U) with the limited
  non-orthogonal correction (limiter 0.5), the explicit
  -div(nuEff dev2(grad(U)^T)), under-relaxed as OpenFOAM's
  fvMatrix::relax (diagonal dominance restored, then divided by alpha);
- SIMPLE: the momentum predictor against -grad(p), HbyA = H/A with the
  velocity of fixed-value patches on the boundary (constrainHbyA), the
  pressure equation laplacian(1/A, p) = div(phiHbyA), the flux
  phiHbyA - the pressure equation's flux, explicit pressure relaxation,
  the momentum corrector U = HbyA - grad(p)/A;
- Spalart-Allmaras (OpenFOAM's coefficients, sigma 0.66666, Cs 0.3, no
  ft2): bounded upwind convection, diffusion (nu + nuTilda)/sigma,
  Cb2/sigma |grad nuTilda|^2 and Cb1 Stilda nuTilda as sources, the
  destruction Cw1 fw nuTilda/d^2 implicit, relaxed, clipped to
  [1e-16, 1e16]; nut = nuTilda fv1, zero on walls;
- each inner solve in correction form x = x0 + A^-1 (b - A x0): Jacobi
  preconditioned CG for the pressure, Jacobi preconditioned BiCGStab (one
  solve over all components of U) for the others, from zero, to the
  configured tolerance relative to the norm of b - A x0 or the configured
  iteration cap; BiCGStab hands back its best iterate;
- the force on a set of wall patches, pressure plus viscous
  -nuEff (grad U + grad U^T) . Sf with the wall-normal derivative of the
  boundary condition, and its component along a direction.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SIGMA = 0.66666
KAPPA = 0.41
CB1 = 0.1355
CB2 = 0.622
CW1 = CB1 / KAPPA ** 2 + (1.0 + CB2) / SIGMA
CW2 = 0.3
CW3 = 2.0
CV1 = 7.1
CS = 0.3
LIMIT = 0.5               # laplacian's limited non-orthogonal correction
NUT_MIN, NUT_MAX = 1e-16, 1e16


class Mat:
    """An implicit equation sum_f a_f x_nb + diag x = source, integrated
    over each cell: ``upper`` is the neighbour's coefficient in the owner's
    row, ``lower`` the owner's coefficient in the neighbour's row."""

    def __init__(self, diag, lower, upper, source):
        self.diag, self.lower, self.upper, self.source = \
            diag, lower, upper, source


class Case:
    """Mesh, geometry, boundary conditions and options of one case."""

    def __init__(self, mesh, opts, *, device, dtype=torch.float64):
        self.device, self.dtype = torch.device(device), dtype
        self.opts = opts
        self.nc = int(mesh["n_cells"])
        own = np.asarray(mesh["owner"], dtype=np.int64)
        nei = np.asarray(mesh["neighbour"], dtype=np.int64)
        self.ni = nei.shape[0]
        self.nb = own.shape[0] - self.ni
        self.patches = [(n, k, s - self.ni, z) for n, k, s, z
                        in mesh["patches"]]
        g = _geometry(np.asarray(mesh["points"], dtype=np.float64),
                      np.asarray(mesh["faces"], dtype=np.int64), own, nei,
                      self.nc)
        t = self._t
        self.own = torch.as_tensor(own[:self.ni], device=self.device)
        self.nei = torch.as_tensor(nei, device=self.device)
        self.own_b = torch.as_tensor(own[self.ni:], device=self.device)
        for k, v in g.items():
            setattr(self, k, t(v))
        self.wall_dist = t(_wall_distance(g["cc"], mesh, self.patches,
                                          self.device))
        wall = np.zeros(self.nb)
        active = np.ones(self.nb)
        for name, kind, s, z in self.patches:
            if kind == "wall":
                wall[s:s + z] = 1.0
            if kind == "empty":
                active[s:s + z] = 0.0
        self.wall = t(wall)
        self.active = t(active)
        bcs = opts["boundaryConditions"]
        fixed = np.zeros(self.nb)
        for name, kind, s, z in self.patches:
            typ = bcs["U"].get(name, {}).get("type", "zeroGradient")
            if kind == "empty" or typ == "fixedValue":
                fixed[s:s + z] = 1.0
        self.fixed_U = t(fixed)
        self.nu = float(opts["transportProperties"]["nu"])

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    # -- face and cell sums ----------------------------------------------
    def to_cells(self, own_vals, nei_vals=None, b_vals=None):
        """Per cell: the owner values of internal faces, the neighbour
        values and the boundary values, each summed into its cell."""
        ref = own_vals if own_vals is not None else b_vals
        out = ref.new_zeros((self.nc,) + tuple(ref.shape[1:]))
        if own_vals is not None:
            out.index_add_(0, self.own, own_vals)
        if nei_vals is not None:
            out.index_add_(0, self.nei, nei_vals)
        if b_vals is not None:
            out.index_add_(0, self.own_b, b_vals)
        return out

    def surface_sum(self, f_int, f_b):
        """sum over a cell's faces of the outward value (owner +,
        neighbour -)."""
        return self.to_cells(f_int, -f_int, f_b)

    def interp(self, x):
        """Linear interpolation to the internal faces."""
        w = self.w.reshape((-1,) + (1,) * (x.ndim - 1))
        return w * x[self.own] + (1.0 - w) * x[self.nei]

    def grad(self, x, x_b):
        """Gauss gradient: (1/V) sum_f Sf (x) x_f; (nc, 3) for a scalar,
        (nc, 3, 3) with [c, i, j] = d x_j / d x_i for a vector."""
        xf = self.interp(x)
        sf, sfb = self.sf[:self.ni], self.sf[self.ni:]
        if x.ndim == 1:
            g = self.surface_sum(sf * xf[:, None], sfb * x_b[:, None])
            return g / self.vol[:, None]
        g = self.surface_sum(sf[:, :, None] * xf[:, None, :],
                             sfb[:, :, None] * x_b[:, None, :])
        return g / self.vol[:, None, None]

    def flux(self, u, u_b):
        ui = self.interp(u)
        return torch.cat([(self.sf[:self.ni] * ui).sum(-1),
                          (self.sf[self.ni:] * u_b).sum(-1)])

    # -- boundary conditions ---------------------------------------------
    def bc(self, field, phi, vector):
        """(vc, vb, gc, gb): boundary value vc x_own + vb, boundary normal
        gradient gc x_own + gb, per boundary face."""
        spec = self.opts["boundaryConditions"][field]
        shape = (self.nb, 3) if vector else (self.nb,)
        vc, vb, gc, gb = (torch.zeros(shape, dtype=self.dtype,
                                      device=self.device) for _ in range(4))
        dc = self.dc_b[:, None] if vector else self.dc_b
        phib = phi[self.ni:]
        for name, kind, s, z in self.patches:
            sl = slice(s, s + z)
            if kind == "empty":
                continue
            typ = spec.get(name, {}).get("type", "zeroGradient")
            if typ == "zeroGradient":
                vc[sl] = 1.0
                continue
            val = torch.as_tensor(spec[name].get("value", 0.0),
                                  dtype=self.dtype, device=self.device)
            val = torch.broadcast_to(val, shape[1:])
            if typ == "fixedValue":
                fixed = torch.ones((z,), dtype=torch.bool,
                                   device=self.device)
            elif typ == "inletOutlet":
                fixed = phib[sl] < 0.0
            else:
                raise NotImplementedError(f"boundary condition {typ!r}")
            fx = fixed[:, None] if vector else fixed
            vc[sl] = torch.where(fx, 0.0, 1.0)
            vb[sl] = torch.where(fx, val, 0.0)
            gc[sl] = torch.where(fx, -dc[sl], 0.0)
            gb[sl] = torch.where(fx, dc[sl] * val, 0.0)
        return vc, vb, gc, gb

    def bvalue(self, bco, x):
        return bco[0] * x[self.own_b] + bco[1]

    def bsngrad(self, bco, x):
        return bco[2] * x[self.own_b] + bco[3]

    # -- implicit operators ------------------------------------------------
    def matvec(self, m, x):
        d = m.diag
        y = d * x
        up = m.upper.reshape((-1,) + (1,) * (x.ndim - 1))
        lo = m.lower.reshape((-1,) + (1,) * (x.ndim - 1))
        y = y + self.to_cells(up * x[self.nei], lo * x[self.own])
        return y

    def offdiag(self, m, x):
        up = m.upper.reshape((-1,) + (1,) * (x.ndim - 1))
        lo = m.lower.reshape((-1,) + (1,) * (x.ndim - 1))
        return self.to_cells(up * x[self.nei], lo * x[self.own])

    def div_upwind(self, phi, x, bco):
        """Bounded upwind convection: div(phi, x) - div(phi) x."""
        vec = x.ndim == 2
        fi = phi[:self.ni]
        up = fi >= 0.0
        d_own = torch.where(up, fi, 0.0)
        upper = torch.where(up, 0.0, fi)
        lower = -d_own
        diag = self.to_cells(d_own, -upper)
        pb = phi[self.ni:] * self.active
        divphi = self.surface_sum(fi, pb)
        diag = diag - divphi
        if vec:
            diag = diag[:, None].expand(-1, 3).clone()
            src = torch.zeros_like(x)
            diag.index_add_(0, self.own_b, pb[:, None] * bco[0])
            src.index_add_(0, self.own_b, -pb[:, None] * bco[1])
        else:
            src = torch.zeros_like(x)
            diag.index_add_(0, self.own_b, pb * bco[0])
            src.index_add_(0, self.own_b, -pb * bco[1])
        return Mat(diag, lower, upper, src)

    def _nonorth(self, x, grad_x):
        """The limited explicit non-orthogonal part k . (grad x)_f on the
        internal faces."""
        gf = self.interp(grad_x)
        k = self.corr[:self.ni]
        if x.ndim == 1:
            c = (k * gf).sum(-1)
            orth = self.nodc[:self.ni] * (x[self.nei] - x[self.own])
            mc, mo = torch.abs(c), torch.abs(orth)
        else:
            c = (k[:, :, None] * gf).sum(1)
            orth = self.nodc[:self.ni, None] * (x[self.nei] - x[self.own])
            mc = torch.sqrt(torch.clamp_min((c * c).sum(-1), 1e-36))
            mo = torch.sqrt(torch.clamp_min((orth * orth).sum(-1), 1e-36))
        lam = torch.clamp_max(LIMIT * mo / torch.clamp_min(
            (1.0 - LIMIT) * mc, 1e-30), 1.0)
        return lam.reshape((-1,) + (1,) * (x.ndim - 1)) * c

    def laplacian(self, gamma_f, gamma_b, x, bco, grad_x=None):
        """laplacian(gamma, x), Gauss linear with the limited correction."""
        vec = x.ndim == 2
        coef = gamma_f * self.magsf[:self.ni] * self.nodc[:self.ni]
        diag = -self.to_cells(coef, coef)
        if vec:
            diag = diag[:, None].expand(-1, 3).clone()
        if grad_x is None:
            grad_x = self.grad(x, self.bvalue(bco, x))
        cf = (gamma_f * self.magsf[:self.ni]).reshape(
            (-1,) + (1,) * (x.ndim - 1)) * self._nonorth(x, grad_x)
        src = -self.surface_sum(cf, None)
        gb = gamma_b * self.magsf[self.ni:] * self.active
        gb = gb[:, None] if vec else gb
        diag.index_add_(0, self.own_b, gb * bco[2])
        src.index_add_(0, self.own_b, -gb * bco[3])
        return Mat(diag, coef, coef.clone(), src)

    def laplacian_flux(self, gamma_f, gamma_b, x, bco):
        """The face flux of laplacian(gamma, x) at x (scalar x)."""
        coef = gamma_f * self.magsf[:self.ni] * self.nodc[:self.ni]
        g = self.grad(x, self.bvalue(bco, x))
        fi = coef * (x[self.nei] - x[self.own]) \
            + gamma_f * self.magsf[:self.ni] * self._nonorth(x, g)
        fb = gamma_b * self.magsf[self.ni:] * self.active \
            * self.bsngrad(bco, x)
        return torch.cat([fi, fb])

    def relax(self, m, x, alpha):
        off = self.to_cells(torch.abs(m.upper), torch.abs(m.lower))
        d0 = m.diag
        if d0.ndim == 2:
            off = off[:, None]
        mag = torch.maximum(torch.abs(d0), off)
        dnew = torch.where(d0 >= 0.0, mag, -mag) / alpha
        return Mat(dnew, m.lower, m.upper, m.source + (dnew - d0) * x)

    # -- inner solves --------------------------------------------------------
    def solve(self, m, x0, rhs, symmetric, rel_tol, max_iters):
        """x0 + the inner solve of A delta = b - A x0 (b = source + rhs)."""
        b = m.source if rhs is None else m.source + rhs
        r = b - self.matvec(m, x0)
        d = m.diag
        dinv = 1.0 / torch.where(torch.abs(d) > torch.finfo(d.dtype).tiny,
                                 d, 1.0)
        if x0.ndim == 2 and d.ndim == 1:
            dinv = dinv[:, None]
        mv = lambda v: self.matvec(m, v)  # noqa: E731
        step = _cg if symmetric else _bicgstab
        delta, iters = step(mv, r, dinv, rel_tol, max_iters)
        return x0 + delta, iters

    # -- the model -----------------------------------------------------------
    def nut(self, nt):
        chi3 = (nt / self.nu) ** 3
        return nt * chi3 / (chi3 + CV1 ** 3)

    def nut_b(self, nt):
        return self.nut(nt)[self.own_b] * (1.0 - self.wall)

    def sa_matrix(self, nt, phi, grad_u, bco):
        nu = self.nu
        nt_b = self.bvalue(bco, nt)
        deff = (nu + nt) / SIGMA
        deff_b = (nu + nt_b) / SIGMA
        m = self.div_upwind(phi, nt, bco)
        lap = self.laplacian(self.interp(deff), deff_b, nt, bco)
        gn = self.grad(nt, nt_b)
        cross = CB2 / SIGMA * (gn * gn).sum(-1)
        d = torch.clamp_min(self.wall_dist, 1e-12)
        chi = nt / nu
        fv1 = chi ** 3 / (chi ** 3 + CV1 ** 3)
        fv2 = 1.0 - chi / (1.0 + chi * fv1)
        skew = 0.5 * (grad_u - grad_u.transpose(-1, -2))
        omega = math.sqrt(2.0) * torch.sqrt(
            torch.clamp_min((skew * skew).sum((-2, -1)), 1e-36))
        ikd2 = 1.0 / (KAPPA ** 2 * d ** 2)
        stilda = torch.maximum(omega + fv2 * nt * ikd2, CS * omega)
        r = torch.clamp_max(nt / torch.clamp_min(stilda, 1e-16) * ikd2, 10.0)
        g = r + CW2 * (r ** 6 - r)
        fw = g * ((1.0 + CW3 ** 6) / (g ** 6 + CW3 ** 6)) ** (1.0 / 6.0)
        src = m.source - lap.source + (cross + CB1 * stilda * nt) * self.vol
        diag = m.diag - lap.diag + CW1 * fw * nt / d ** 2 * self.vol
        return Mat(diag, m.lower - lap.lower, m.upper - lap.upper, src)

    def ueqn(self, u, nt, phi, ubc):
        """The relaxed momentum matrix (without the pressure gradient)."""
        nu = self.nu
        grad_u = self.grad(u, self.bvalue(ubc, u))
        nueff = self.nut(nt) + nu
        nueff_b = self.nut_b(nt) + nu
        conv = self.div_upwind(phi, u, ubc)
        lap = self.laplacian(self.interp(nueff), nueff_b, u, ubc,
                             grad_x=grad_u)
        # explicit -div(nuEff dev2(grad(U)^T)), boundary gradient with the
        # condition's normal derivative
        gb = self.grad_b(u, grad_u, ubc)
        t_c = nueff[:, None, None] * _dev2_t(grad_u)
        t_b = nueff_b[:, None, None] * _dev2_t(gb)
        tf = self.interp(t_c)
        fi = (self.sf[:self.ni, :, None] * tf).sum(1)
        fb = (self.sf[self.ni:, :, None] * t_b).sum(1)
        expl = self.surface_sum(fi, fb)
        m = Mat(conv.diag - lap.diag, conv.lower - lap.lower,
                conv.upper - lap.upper, conv.source - lap.source + expl)
        alpha = self.opts["relaxationFactors"]["equations"]["U"]
        return self.relax(m, u, alpha)

    def grad_b(self, u, grad_u, ubc):
        """grad(U) on the boundary faces: the owner's with its normal part
        replaced by the condition's normal derivative."""
        n = self.sf[self.ni:] / torch.clamp_min(self.magsf[self.ni:],
                                                1e-36)[:, None]
        g_own = grad_u[self.own_b]
        ng = (n[:, :, None] * g_own).sum(1)
        return g_own + n[:, :, None] * (self.bsngrad(ubc, u) - ng)[:, None, :]

    # -- SIMPLE --------------------------------------------------------------
    def init_state(self):
        ini = self.opts["initialFields"]
        u = torch.broadcast_to(self._t(ini["U"]), (self.nc, 3)).clone()
        p = torch.full((self.nc,), float(ini["p"]), dtype=self.dtype,
                       device=self.device)
        nt = torch.full((self.nc,), float(ini["nuTilda"]), dtype=self.dtype,
                        device=self.device)
        zero = torch.zeros((self.ni + self.nb,), dtype=self.dtype,
                           device=self.device)
        ubc = self.bc("U", zero, True)
        return {"U": u, "p": p, "nuTilda": nt,
                "phi": self.flux(u, self.bvalue(ubc, u))}

    def step(self, st):
        """One SIMPLE iteration; returns the new state."""
        opts = self.opts
        lin = opts["primalLinearSolver"]
        u, p, phi, nt = st["U"], st["p"], st["phi"], st["nuTilda"]
        ubc = self.bc("U", phi, True)
        pbc = self.bc("p", phi, False)
        m = self.ueqn(u, nt, phi, ubc)
        gradp = self.grad(p, self.bvalue(pbc, p))
        u_pred, _ = self.solve(m, u, -gradp * self.vol[:, None], False,
                               lin["uRelTol"], lin["uMaxIters"])

        rau = 1.0 / (m.diag.mean(-1) / self.vol)
        h = (m.source - self.offdiag(m, u_pred)
             - (m.diag - m.diag.mean(-1, keepdim=True)) * u_pred) \
            / self.vol[:, None]
        hbya = rau[:, None] * h
        hbya_b = torch.where(self.fixed_U[:, None] > 0.5,
                             self.bvalue(ubc, u_pred), hbya[self.own_b])
        phi_h = self.flux(hbya, hbya_b)
        rau_f, rau_b = self.interp(rau), rau[self.own_b]
        pm = self.laplacian(rau_f, rau_b, p, pbc)
        pm.source = pm.source + self.surface_sum(phi_h[:self.ni],
                                                 phi_h[self.ni:])
        p_new, _ = self.solve(pm, p, None, True, lin["pRelTol"],
                              lin["pMaxIters"])
        phi_new = phi_h - self.laplacian_flux(rau_f, rau_b, p_new, pbc)
        alpha_p = opts["relaxationFactors"]["fields"]["p"]
        p_rel = p + alpha_p * (p_new - p)
        gradp2 = self.grad(p_rel, self.bvalue(pbc, p_rel))
        u_new = hbya - rau[:, None] * gradp2

        grad_u = self.grad(u_new, self.bvalue(ubc, u_new))
        tbc = self.bc("nuTilda", phi_new, False)
        mt = self.relax(self.sa_matrix(nt, phi_new, grad_u, tbc), nt,
                        opts["relaxationFactors"]["equations"]["nuTilda"])
        nt_new, _ = self.solve(mt, nt, None, False, lin["turbRelTol"],
                               lin["turbMaxIters"])
        nt_new = torch.clamp(nt_new, NUT_MIN, NUT_MAX)
        return {"U": u_new, "p": p_rel, "nuTilda": nt_new, "phi": phi_new}

    def force(self, st, patches, direction, scale=1.0):
        """The component along ``direction`` of the pressure and viscous
        force on ``patches``."""
        u, p, phi, nt = st["U"], st["p"], st["phi"], st["nuTilda"]
        ubc = self.bc("U", phi, True)
        pbc = self.bc("p", phi, False)
        grad_u = self.grad(u, self.bvalue(ubc, u))
        gb = self.grad_b(u, grad_u, ubc)
        nueff_b = self.nut_b(nt) + self.nu
        sf = self.sf[self.ni:]
        tau = gb + gb.transpose(-1, -2)
        f = sf * self.bvalue(pbc, p)[:, None] \
            - nueff_b[:, None] * (tau * sf[:, :, None]).sum(1)
        mask = torch.zeros((self.nb,), dtype=self.dtype, device=self.device)
        for name, kind, s, z in self.patches:
            if name in patches:
                mask[s:s + z] = 1.0
        return float(((f * mask[:, None]).sum(0)
                      * self._t(direction)).sum()) * scale


def _dev2_t(g):
    """dev2(A) = A - (2/3) tr(A) I of A = g^T, per cell or face."""
    gt = g.transpose(-1, -2)
    tr = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(3, dtype=g.dtype, device=g.device)
    return gt - (2.0 / 3.0) * tr[..., None, None] * eye


def _dot(a, b):
    return torch.sum(a * b)


def _cg(mv, r0, dinv, rel_tol, max_iters):
    """Jacobi preconditioned CG for A x = r0 from x = 0."""
    x = torch.zeros_like(r0)
    r = r0
    z = dinv * r
    p = z
    rz = _dot(r, z)
    tol = rel_tol * float(torch.linalg.vector_norm(r))
    rn = float(torch.linalg.vector_norm(r))
    it = 0
    while it < max_iters and rn > tol:
        ap = mv(p)
        alpha = rz / _dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = dinv * r
        rz_new = _dot(r, z)
        p = rz_new / rz * p + z
        rz = rz_new
        it += 1
        rn = float(torch.linalg.vector_norm(r))
    return x, it


def _bicgstab(mv, r0, dinv, rel_tol, max_iters):
    """Jacobi preconditioned BiCGStab for A x = r0 from x = 0, restarted
    with rhat = r when rhat and r have become orthogonal; returns the
    iterate of the smallest residual."""
    x = torch.zeros_like(r0)
    r = r0
    rn = float(torch.linalg.vector_norm(r))
    tol = rel_tol * rn
    best, best_rn = x, rn
    rhat = r
    p = v = torch.zeros_like(r0)
    rho = alpha = omega = None
    it = 0
    while it < max_iters and math.isfinite(rn) and rn > tol:
        rho_new = _dot(rhat, r)
        rr = _dot(r, r)
        if rho is None or abs(float(rho_new)) < 1e-12 * float(rr):
            rhat, rho_new = r, rr
            p = r
        else:
            beta = (rho_new / rho) * (alpha / omega)
            p = r + beta * (p - omega * v)
        ph = dinv * p
        v = mv(ph)
        alpha = rho_new / _dot(rhat, v)
        s = r - alpha * v
        sh = dinv * s
        t = mv(sh)
        omega = _dot(t, s) / _dot(t, t)
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rho = rho_new
        rn = float(torch.linalg.vector_norm(r))
        it += 1
        if rn < best_rn:
            best, best_rn = x, rn
    if not math.isfinite(rn) or best_rn < rn:
        x = best
    return x, it


def _geometry(pts, faces, own, nei, nc):
    """OpenFOAM's face, cell and interpolation geometry in float64 numpy."""
    ni = nei.shape[0]
    P = pts[faces]                                   # (nf, 4, 3)
    c_est = P.mean(1)
    nxt = np.roll(P, -1, axis=1)
    tsf = 0.5 * np.cross(nxt - P, c_est[:, None, :] - P)
    tc = (P + nxt + c_est[:, None, :]) / 3.0
    ta = np.linalg.norm(tsf, axis=-1)
    sf = tsf.sum(1)
    cf = (tc * ta[..., None]).sum(1) / ta.sum(1)[:, None]
    magsf = np.linalg.norm(sf, axis=-1)
    nfc = np.bincount(own, minlength=nc) + np.bincount(nei, minlength=nc)
    cest = np.zeros((nc, 3))
    for k in range(3):
        cest[:, k] = np.bincount(own, cf[:, k], nc) \
            + np.bincount(nei, cf[:ni, k], nc)
    cest /= nfc[:, None]
    pv_o = np.einsum("ij,ij->i", sf, cf - cest[own]) / 3.0
    pv_n = -np.einsum("ij,ij->i", sf[:ni], cf[:ni] - cest[nei]) / 3.0
    pc_o = 0.75 * cf + 0.25 * cest[own]
    pc_n = 0.75 * cf[:ni] + 0.25 * cest[nei]
    vol = np.bincount(own, pv_o, nc) + np.bincount(nei, pv_n, nc)
    cc = np.zeros((nc, 3))
    for k in range(3):
        cc[:, k] = np.bincount(own, pc_o[:, k] * pv_o, nc) \
            + np.bincount(nei, pc_n[:, k] * pv_n, nc)
    cc /= vol[:, None]
    n = sf / magsf[:, None]
    co, cn = cc[own[:ni]], cc[nei]
    so = np.einsum("ij,ij->i", n[:ni], cf[:ni] - co)
    sn = np.einsum("ij,ij->i", n[:ni], cn - cf[:ni])
    d = cn - co
    dist = np.linalg.norm(d, axis=-1)
    nodc = 1.0 / np.maximum(np.einsum("ij,ij->i", n[:ni], d), 0.05 * dist)
    corr = n[:ni] - nodc[:, None] * d
    db = cf[ni:] - cc[own[ni:]]
    nodc_b = 1.0 / np.maximum(np.einsum("ij,ij->i", n[ni:], db),
                              0.05 * np.linalg.norm(db, axis=-1))
    return {"sf": sf, "magsf": magsf, "cc": cc, "vol": vol,
            "w": sn / (so + sn), "nodc": nodc, "corr": corr,
            "dc_b": nodc_b}


def _wall_distance(cc, mesh, patches, device):
    """Distance from each cell centre to the nearest wall face, in the
    x-y plane (the mesh is one cell deep in z): each wall face is the
    segment between its two vertices at the lowest z."""
    pts = np.asarray(mesh["points"], dtype=np.float64)
    faces = np.asarray(mesh["faces"], dtype=np.int64)
    ni = np.asarray(mesh["neighbour"]).shape[0]
    segs = []
    for name, kind, s, z in patches:
        if kind != "wall":
            continue
        fv = faces[ni + s:ni + s + z]
        zs = pts[fv][:, :, 2]
        low = np.argsort(zs, axis=1, kind="stable")[:, :2]
        segs.append(np.take_along_axis(fv, low, axis=1))
    seg = np.concatenate(segs)
    a = torch.as_tensor(pts[seg[:, 0], :2], device=device)
    b = torch.as_tensor(pts[seg[:, 1], :2], device=device)
    ab = b - a
    ab2 = (ab * ab).sum(-1)
    c = torch.as_tensor(cc[:, :2], device=device)
    out = torch.empty(c.shape[0], dtype=torch.float64, device=device)
    for i in range(0, c.shape[0], 8192):
        q = c[i:i + 8192, None, :] - a[None]
        t = torch.clamp((q * ab[None]).sum(-1) / ab2[None], 0.0, 1.0)
        e = q - t[..., None] * ab[None]
        out[i:i + 8192] = torch.sqrt((e * e).sum(-1).min(1).values)
    return out.cpu().numpy()
