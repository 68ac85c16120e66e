#!/usr/bin/env python3
"""Smoke run of dafoam_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases (any failure raises, so the exit code is nonzero; the 512x512
case is set up once, before phase 3, and reused by phases 5, 5b, 6 and 6b):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; fails when torch sees no CUDA device;
2. build: compiles the DIA kernels (dafoam_tpu_torch/csrc/dia_matvec.cu)
   with nvcc for sm_90a and reports the seconds and the ptxas summary;
3. kernel vs plain: K1 and K2 against their plain torch versions, float32
   and float64, on the band layout and coefficients of the first p,
   nuTilda and U matrices of the 512x512 NACA0012 case and on edge shapes;
   bars 1e-6 (f32) and 1e-13 (f64) relative to max|plain|; the times at
   262,144 cells come after phase 6b (below);
3b. the same for K3 (K3a dia_matvec_t/_multi_t, K3b dia_cotangent/_multi),
   shared and per-component diagonals; then the autograd Functions' vjp
   and jvp on the card against autograd of the plain banded matvec, and a
   gradient through them keeps its grad_fn;
4. golden: the 32x12 NACA0012 SA primal (f64, canonical layout, to
   primalMinResTol 1e-10) through the kernels; CD must match
   tests/golden/values.json naca_sa.CD at 1e-8, and both kernels must have
   been launched, their plain versions not;
4b. golden adjoint: the same case on the dense-DIA layout with the
   fixed-point adjoint (mg step-map smoother, fpRelTol 1e-10); dCD/dnu and
   ||dCD/dpoints|| must meet naca_sa at the CPU test's bars, with every K3
   kernel launched and no plain version run;
4c. golden residual form: from 4b's converged state, the residual-form
   (Krylov) adjoint with golden naca_sa's adjEqnOption (FGMRES restart
   400 to rel 1e-9, segregated PC) and its totals, at the same bars; the
   PC's transposed products must have launched K3a, no plain version;
4d. golden implicit: the fixed-point totals of 4b with fpInnerMode
   "implicit" (every inner solve differentiated by fvsolve's implicit
   rule: tight transpose solves through K3a, the matrix cotangent through
   K3b), at the same bars;
5. full width: the 512x512 bench case (f32, dense-DIA layout) for 300 SIMPLE
   iterations (one BENCH_ITERS chunk); the state must stay finite and
   valid, the max residual must fall, CD must be finite, and the kernel
   launch counts must be positive with the plain counts at zero;
5b. line PC: PC_ITERS SIMPLE iterations from phase 5's state with pPC
   "line" (ADI line solves, BiCGStab); p iterations per solve against
   Jacobi-CG's cap of 50;
6. full-width adjoint: from phase 5's state, one solve_adjoint call with
   bench.py's adjEqnOption (one 120-iteration restart cycle, deflation 16,
   mg smoother, fpRelaxFields p 0.7, normalized), then one
   total_derivative; prints ms per (I - dG^T) product, resid0 -> resid,
   launches per product and peak device memory; psibar and the totals must
   be finite, resid < resid0, every kernel launched and no plain version;
6b. full-width residual form: from phase 5's state, one 60-iteration
   FGMRES cycle of the residual-form adjoint with pcType "segregated" and
   one with "coupledLine", each followed by total_derivative; prints the
   ms to build the PC, ms per preconditioned iteration, resid0 -> resid,
   peak device memory and launches per iteration; psi and the totals must
   be finite, K3a launched and no plain version;
4e. golden cavity: the laminar lid-driven cavity of
   tests/test_golden.py:_case_cavity_simple (10x10 box, an all-Neumann
   pressure: adjustPhi and a reference cell) on the dense-DIA layout in
   f64: primal, the default residual-form adjoint and the totals; lidForce
   at 1e-8, dLidForce/dnu, dLidForce/dU_lid,x and ||dLidForce/dpoints|| at
   1e-6 against tests/golden/values.json; K1, K2 and K3a launched, no
   plain version;
5c. multigrid PC: PC_ITERS SIMPLE iterations from phase 5's state with
   pPC "mg" (one V-cycle per BiCGStab preconditioning); p iterations per
   solve against Jacobi-CG's cap and phase 5b's line PC, ms per
   iteration;
6c. fpRemat: 20 fixed-point GMRES iterations from phase 5's state with and
   without adjEqnOption.fpRemat; ms per product and peak device memory of
   each; psibar must agree at rel 1e-5;
6d. "krylov" step-map smoother: one 30-iteration fixed-point cycle with
   fpInnerSmoother "krylov"; resid0 -> resid and ms per product;
7. kernel times at 262,144 cells: device time per call (profiler) of each
   kernel, its plain version and the one-call library equivalent
   (torch.mv on a CSR copy of the matrix, cuSPARSE), back to back (CUDA
   events), and the bound. They run last, after phase 8b, so that no
   profiler session precedes the main path's timings;
8. kOmegaSST at full width: the 512x512 case with turbulenceModel
   kOmegaSST (k and omega farfield inletOutlet at 1.5 (0.05 |U_inf|)^2 and
   k_inf / (3 nu), wall k 1e-10 and omega 10 * 6 nu / (beta1 d1^2), d1 the
   smallest first-cell wall distance), 300 SIMPLE iterations (finite,
   valid, max_res falls, CD finite), then one 120-iteration fixed-point
   adjoint cycle with bench.py's adjEqnOption and the totals (finite);
   K1/K2 in the primal and every K3 kernel in the adjoint, no plain call;
8b. 20 SIMPLE iterations at 512x512 for each of kEpsilon, kOmega,
   kOmegaSSTLM and Spalart-Allmaras with Spalding wall functions: finite,
   K1/K2 launched, no plain call;
4f. golden scalar_transport (tests/test_golden.py:_case_scalar_transport,
   8x6 box, DAScalarTransportFoam, segregated PC), 4g. golden
   heat_radiation (_case_heat_radiation, 10x6 box, DAHeatTransferFoam
   with P1 radiation, no PC) and 4h. golden rho_channel
   (tests/test_rho_simple.py:channel, 16x8 DARhoSimpleFoam, segregated
   PC), each in f64 on the dense layout: objectives at 1e-8 and totals at
   1e-6 against tests/golden/values.json; K1 and K3a (4f), K1 (4g), K1,
   K2 and K3a (4h) launched, no plain version; they run after 4e;
9. compressible full width: DARhoSimpleFoam + Spalart-Allmaras on the
   512x512 O-mesh (f32, dense) at Mach 0.5 (T 300 K, p 101325 Pa) and
   Re_c 1000, with relaxationFactors.fields.rho RHO_RELAX: ITERS SIMPLE
   iterations (finite, valid, max_res falls, CD finite; ms per
   iteration, the rho and Mach ranges), then one 60-iteration FGMRES
   cycle of the residual-form adjoint (segregated PC) and the totals
   (finite; ms per iteration, resid0 -> resid, peak memory, launches per
   iteration); K1/K2 in the primal, K3a and K3a-multi in the adjoint;
9b. 20 DARhoSimpleCFoam (transonic SIMPLEC) iterations from phase 9's
   state without the subsonic warm start: the p equation is non-symmetric
   and must go to BiCGStab through K1; then one vjp of the normalized
   residuals (finite). Phases 9 and 9b run after 8b;
4i. golden pimple_unsteady (tests/test_golden.py:_case_pimple_unsteady,
   the 8x8 cavity of tests/test_pimple_unsteady.py: 5 Euler steps of
   DAPimpleFoam and the reverse sweep, segregated PC) in f64 on the dense
   layout, after 4h: lidF_avg at 1e-8 and dlidF/dnu, ||dlidF/dpoints|| at
   1e-6, each times max(1, |golden|) as tests/test_golden.py holds them;
   the sweep's residuals under 1e-9; K1, K2 and K3a launched, no plain
   version;
10. DAHisaFoam at full width, after 9b: tests/test_hisa.py's transonic
   bump channel at 1024x256 (262,144 cells; inviscid AUSMPlusUp, inlet
   Mach 0.675) in f32 on the dense layout: HISA_LF laxFriedrichs and
   HISA_AUSM AUSMPlusUp pseudo-transient Newton iterations (GMRES capped
   at HISA_INNER per Newton step), whose max Mach must exceed 0.675; then
   one HISA_ADJ-iteration adjoint FGMRES cycle for CDp with the
   transposed 5x5 block PC and the totals (finite); prints ms per PTC
   iteration, GMRES iterations per Newton step, res/res0, the CFL, the
   Mach range, the largest |I - D D^-1| of the block inverse and peak
   memory; no DIA kernel and no plain version runs;
11. DAPimpleFoam at full width: the 512x512 lid-driven cavity at Re 1000
   (0.1 m box, nu 1e-4) in f32 on the dense layout, PIMPLE_STEPS Euler
   steps at a lid Courant number of 0.51 (4 outer, 2 pressure correctors,
   timeOp average), then the in-memory reverse sweep and the checkpointed
   one (seg_len PIMPLE_SEG), each step's FGMRES capped at PIMPLE_GMRES
   (segregated PC); the two sweeps' totals must agree at rel 1e-4; K1/K2
   in the primal, K3a in the sweeps, no plain version;
11b. DARhoPimpleFoam: RHO_PIMPLE_STEPS steps of phase 9's case (deltaT
   RHO_PIMPLE_DT) from phase 9's state: finite and valid, K1/K2 launched,
   no plain version;
12. DAPimpleDyMFoam: the plunging NACA0012 on phase 5's O-mesh with its
   SA options, from phase 5's state (f32, dense): the SCL residual of
   step 1's mesh flux, DYM_STEPS ALE steps (deltaT DYM_DT) and the
   in-memory reverse sweep of the cycle-averaged CD, FGMRES capped at
   UNSTEADY_GMRES per step (segregated PC); finite, K1/K2 in the primal,
   K3a in the sweep, no plain version;
13. DAIrkPimpleFoam: IRK_STEPS Radau IIA steps (4 sweeps) of phase 11's
   cavity and the in-memory sweep with the two-stage segregated PC; as 12;
14. DAInterFoam: the dam break of tests/test_interfoam.py at INTER_NX x
   INTER_NY, INTER_STEPS steps of INTER_DT: alpha in [-1e-5, 1 + 1e-5],
   the water volume kept to rel 1e-5, the centre of mass moving right and
   down; then the in-memory sweep (two-phase segregated PC); K1 in the
   primal (no predictor solve), K3a in the sweep;
15. time-spectral DAScalarTransportFoam ("hybrid"): the 1.0 x 0.6 box at
   FULL x FULL with 5 instances, TS_SWEEPS block Gauss-Seidel sweeps
   (residual must fall), one TS_GMRES-iteration FGMRES cycle with the
   lineJacobi PC and the totals (finite); K1 and K3a, no plain version.
   Phase 15 runs before 14;
16. shape optimization: the workflow of
   dafoam_tpu_torch/examples/naca0012_drag_opt.py on phase 5's case and
   state: an 8x4x2 FFD box (12 y-displacement DVs), ShapeOptProblem's
   eval_all(0), grad(0) and SHAPE_MAXITER SLSQP iterations within
   +-SHAPE_BOUND, each primal cut at SHAPE_ITERS iterations (converged at
   max_res SHAPE_TOL), each adjoint one 120-iteration fixed-point cycle;
   CD and the gradient finite, grad(0) equal to the hand chain B^T
   dCD/dpoints at rel 1e-4, every K1/K2/K3 kernel launched, none plain;
17. MPhys: tests/test_mphys.py's aero model (DAFoamMesh, the wing points
   as x_aero, DAFoamWarper's IDWarp over every volume point,
   DAFoamSolver, DAFoamFunctions) on the port's OpenMDAO shim, on phase
   5's case warm-started from its state: run_model and
   compute_totals(CD, x_aero); the totals finite, nonzero and equal to the
   direct route (total_derivative at the same psibar through the warper's
   vjp) at rel 1e-4, one residual graph recorded; every kernel launched,
   none plain;
18. coupling: the heated plate of tests/test_cht.py (CHT) and the flexible
   wall of tests/test_fsi.py (FSI) with a CPL_NX x CPL_NY fluid channel
   (f32, dense): CPL_OUTER block Gauss-Seidel iterations, then one
   CPL_GMRES-iteration coupled-adjoint GMRES cycle; finite states and
   totals, K1/K2 in the primal, no plain version anywhere (the coupled
   residual forms A x face by face: no DIA kernel in the adjoint);
19. IO and utilities, after 18, on phase 5's case: the generated O-mesh
   (525,312 points) written by write_polymesh through phase 5's dense
   topology (the writer emits the canonical one) and read back by
   read_polymesh, equal to the generated mesh array for array, every
   ASCII file parsed by the native parser (native.COUNTS); the CLI's
   meshinfo on the card; phase 5's state and inputs through
   save_checkpoint / load_checkpoint bit for bit, and ckdiff of two copies
   returning 0; a solver made from the mesh read from disk (dense layout,
   the same topology as phase 5's), IO_ITERS SIMPLE iterations from the
   loaded state against phase 5's solver from the same state (rel
   IO_REL; bit-identity reported), one IO_ADJ-iteration fixed-point cycle
   and the CD totals (finite); calc_force_per_s on the wing (traction x
   |Sf| summed along x equal to CD at rel IO_REL, with its VTK),
   probe_time_series equal to the indexed cell; dense_drdwt (raw and
   normalized) of tests/test_jacdump.py's case in f64 on the card against
   the vjp at JAC_REL, and write_jacobians refusing 512x512; the port's
   Timer (block_on) times each step; K1/K2 in the primal, K3a and K3b in
   the adjoint and totals, no plain version;
20. the halo route (dafoam_tpu_torch.parallel), after 19:
   tests/test_sharding.py's cavity on a FULL x FULL box (262,144 cells)
   reordered into SHARD_PARTS RCB parts, canonical layout on both
   routes: the plan's build time, cut and exchange volume; in f64,
   SHARD_ITERS fixed-work SIMPLE outers (fvsolve.fixed_inner, smoother
   budgets SHARD_P_SWEEPS / SHARD_U_SWEEPS), SHARD_FP Richardson sweeps of
   the fixed-point adjoint and the lidF totals on the unsharded route and
   on the local halo route, held at tests/test_sharding.py's bars (U atol
   1e-11, J abs 1e-12 or rel 1e-10, dJ/dnu rel 1e-10, dJ/dpoints 1e-10 of
   the largest entry), no DIA product on the halo route; one f64 halo
   product and its vjp on phase 5's O-mesh in SHARD_PARTS parts against
   the unsharded product; in f32 on both routes the us per LDU product,
   ms per SIMPLE iteration, ms per fixed-point adjoint product and device
   kernels per SIMPLE iteration; a SHARD_BANDED x SHARD_BANDED box in
   SHARD_PARTS parts (58 bands, inside the DIA kernels' 64): every kernel
   against its plain version at its offsets, and a short fixed-work run
   whose unsharded products launch every DIA kernel at those offsets,
   against the halo route; the distributed transport on a 1-rank
   NCCL group (no halo traffic: a wiring check) against the local one
   and, where the call has two or more cards, min(4, count) spawned NCCL
   ranks, each held against the local transport and bit-identical to the
   others.

``--profile`` adds a torch.profiler table of one more SIMPLE iteration, of
one (I - dG^T) product, of one residual-form iteration (a residual vjp
and one segregated PC application), of one SIMPLE iteration with the
multigrid pressure PC, of one compressible SIMPLE iteration (phase
9's case), of one AUSMPlusUp PTC iteration (phase 10's), of one PIMPLE
time step and of one reverse step (phase 11's). The last line of
standard output is one JSON object with "ok" and the device; the line
before it repeats the card's name and power limit, and the one before
that lists every kernel with its launches on the full-width paths
(phases 5, 5b, 5c, 6, 6b, 6c, 6d, 8, 8b, 9, 9b, 10, 11, 11b and 12-20,
each counted from zero; "launches_by_path" splits them, phase 19's as
"io_primal" and "io_adjoint", phase 20's f64 runs as "shard" (the halo
route), "shard_reference" (the unsharded route) and "shard_banded" (the
unsharded route of the 58-band relabelled box)),
its error against the plain version, its times and its bound. The script
prints its total wall seconds before those lines.
"""

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
FULL = 512            # O-mesh cells per direction of the full-width case
ITERS = 300           # SIMPLE iterations of the full-width run
PC_ITERS = 10         # SIMPLE iterations of phases 5b and 5c
REL = {"float32": 1e-6, "float64": 1e-13}
NU = 1e-3
UINF = [1.0, 0.0, 0.0]
KERNELS = {
    "dia_matvec": {
        "replaces": "dafoam_tpu/ops/pallas_kernels.py:66 (dia_matvec), "
                    ":97 (dia_matvec_tiled)"},
    "dia_matvec_multi": {
        "replaces": "dafoam_tpu/ops/pallas_kernels.py:176 (dia_matvec_multi),"
                    " :221 (dia_matvec_multi_tiled)"},
    "dia_matvec_t": {
        "replaces": "dafoam_tpu/ops/pallas_kernels.py:400-413 "
                    "(_dia_ad_factory bwd, x_bar via dia_matvec at :406; "
                    "dia_matvec_ad :419)"},
    "dia_matvec_multi_t": {
        "replaces": "dafoam_tpu/ops/pallas_kernels.py:324-338 "
                    "(_dia_multi_ad_factory bwd, x_bar via "
                    "dia_matvec_multi_any at :330; dia_matvec_multi_ad :344)"},
    "dia_cotangent": {
        "replaces": "dafoam_tpu/ops/pallas_kernels.py:408-412 "
                    "(_dia_ad_factory bwd, diag_bar and coef_bar)"},
    "dia_cotangent_multi": {
        "replaces": "dafoam_tpu/ops/pallas_kernels.py:332-337 "
                    "(_dia_multi_ad_factory bwd, diag_bar and coef_bar)"},
}
PRIMAL_KERNELS = ("dia_matvec", "dia_matvec_multi")
ADJOINT_KERNELS = tuple(KERNELS)
# NVIDIA H100 SXM data sheet: HBM3 3.35 TB/s, FP32 (non-tensor) 67 TFLOP/s,
# both at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 34e12
# golden-case bars of tests/test_torch_adjoint.py
BAR_DNU = 1e-6
BAR_DPOINTS = 3.6e-6


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def naca_options(**over):
    opts = {
        "solverName": "DASimpleFoam",
        "turbulenceModel": "SpalartAllmaras",
        "transportProperties": {"nu": NU},
        "boundaryConditions": {
            "U": {"far": {"type": "inletOutlet", "value": UINF},
                  "wing": {"type": "fixedValue", "value": [0.0, 0.0, 0.0]}},
            "p": {"far": {"type": "fixedValue", "value": 0.0},
                  "wing": {"type": "zeroGradient"}},
            "nuTilda": {"far": {"type": "inletOutlet", "value": 3 * NU},
                        "wing": {"type": "fixedValue", "value": 0.0}},
        },
        "initialFields": {"U": UINF, "p": 0.0, "nuTilda": 3 * NU},
        "function": {"CD": {"type": "force", "patches": ["wing"],
                            "directionMode": "fixedDirection",
                            "direction": [1.0, 0.0, 0.0], "scale": 1.0}},
    }
    opts.update(over)
    return opts


def bench_options():
    """bench.py's flagship case, primal options (bench.py:93-142)."""
    return naca_options(
        primalMinResTol=0.0, primalMinIters=ITERS, primalMaxIters=ITERS,
        primalLinearSolver={"pMaxIters": 50, "pRelTol": 0.05,
                            "uMaxIters": 20, "uRelTol": 0.1,
                            "turbMaxIters": 20, "turbRelTol": 0.1},
        relaxationFactors={"fields": {"p": 0.2},
                           "equations": {"U": 0.5, "nuTilda": 0.5}},
        meshFaceLayout="diaDense")


def bench_adjoint_options():
    """bench.py's flagship case with its fixed-point adjoint options
    (bench.py:143-194), one restart cycle per solve_adjoint call."""
    return dict(bench_options(), adjEqnSolMethod="fixedPoint",
                adjEqnOption={"fpRelTol": 0.3e-6, "fpMaxIters": 120,
                              "fpInnerScale": 0.4, "fpInnerSmoother": "mg",
                              "fpRelaxFields": {"p": 0.7},
                              "fpAcceleration": "gmres", "gmresRestart": 120,
                              "gmresDeflate": 16, "gmresAbsTol": 1e-30,
                              "pcType": "none"},
                normalizeStates={"U": 1.0, "p": 0.5, "phi": 1.0,
                                 "nuTilda": 3 * NU})


def golden_options(layout="canonical"):
    """tests/test_golden.py:_case_naca_sa, primal options."""
    return naca_options(
        primalMinResTol=1e-10, primalMaxIters=1500,
        relaxationFactors={"fields": {"p": 0.2},
                           "equations": {"U": 0.5, "nuTilda": 0.5}},
        primalLinearSolver={"pMaxIters": 200, "pRelTol": 0.02,
                            "uMaxIters": 50, "uRelTol": 0.05,
                            "turbMaxIters": 50, "turbRelTol": 0.05},
        meshFaceLayout=layout)


def golden_adjoint_options():
    """tests/test_torch_adjoint.py:fp_options: the golden case on the
    dense-DIA layout with the fixed-point adjoint."""
    return dict(golden_options("diaDense"), adjEqnSolMethod="fixedPoint",
                adjEqnOption={"fpRelTol": 1e-10, "fpMaxIters": 2000,
                              "fpInnerScale": 0.4, "fpInnerSmoother": "mg",
                              "fpRelaxFields": {"p": 0.7},
                              "fpAcceleration": "gmres", "gmresRestart": 120,
                              "gmresDeflate": 16, "gmresAbsTol": 1e-30,
                              "pcType": "none"},
                normalizeStates={"U": 1.0, "p": 0.5, "phi": 1.0,
                                 "nuTilda": 3 * NU})


# tests/test_golden.py:_case_naca_sa's residual-form adjoint options
GOLDEN_KRYLOV = {"gmresRelTol": 1e-9, "gmresRestart": 400,
                 "gmresMaxIters": 3000, "pcType": "segregated"}


def golden_residual_options():
    """The golden case on the dense-DIA layout with its own residual-form
    (Krylov, the default adjEqnSolMethod) adjoint options."""
    return dict(golden_options("diaDense"),
                adjEqnOption=dict(GOLDEN_KRYLOV),
                normalizeStates={"U": 1.0, "p": 0.5, "phi": 1.0,
                                 "nuTilda": 3 * NU})


def golden_implicit_options():
    """Phase 4b's options with every inner solve differentiated by the
    implicit rule."""
    opts = golden_adjoint_options()
    opts["adjEqnOption"]["fpInnerMode"] = "implicit"
    return opts


def cavity_options():
    """tests/test_golden.py:_case_cavity_simple on the dense-DIA layout."""
    zero = [0.0, 0.0, 0.0]
    return {
        "solverName": "DASimpleFoam", "turbulenceModel": "None",
        "transportProperties": {"nu": 0.01},
        "boundaryConditions": {
            "U": {"ymax": {"type": "fixedValue", "value": [1.0, 0.0, 0.0]},
                  "ymin": {"type": "fixedValue", "value": zero},
                  "xmin": {"type": "fixedValue", "value": zero},
                  "xmax": {"type": "fixedValue", "value": zero}},
            "p": {n: {"type": "zeroGradient"}
                  for n in ("xmin", "xmax", "ymin", "ymax")}},
        "initialFields": {"U": zero, "p": 0.0},
        "primalMinResTol": 1e-11, "primalMaxIters": 500,
        "relaxationFactors": {"fields": {"p": 0.3},
                              "equations": {"U": 0.7}},
        "function": {"lidForce": {"type": "force", "patches": ["ymax"],
                                  "directionMode": "fixedDirection",
                                  "direction": [1.0, 0.0, 0.0],
                                  "scale": 1.0}},
        "adjEqnOption": {"gmresRelTol": 1e-10, "gmresRestart": 150,
                         "gmresMaxIters": 3000},
        "normalizeStates": {"U": 1.0, "p": 0.5, "phi": 1.0},
        "meshFaceLayout": "diaDense"}


def scalar_transport_options():
    """tests/test_golden.py:_case_scalar_transport on the dense layout."""
    u = [1.0, 0.2, 0.0]
    return {
        "solverName": "DAScalarTransportFoam", "ddtScheme": "steadyState",
        "transportProperties": {"DT": 0.05},
        "boundaryConditions": {
            "T": {"xmin": {"type": "fixedValue", "value": 1.0},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "fixedValue", "value": 0.0},
                  "ymax": {"type": "zeroGradient"}},
            "U": {"xmin": {"type": "fixedValue", "value": u},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "fixedValue", "value": u},
                  "ymax": {"type": "zeroGradient"}}},
        "initialFields": {"T": 0.0},
        "function": {"TMean": {"type": "patchMean", "patches": ["xmax"],
                               "varName": "T", "scale": 1.0}},
        "normalizeStates": {"T": 1.0},
        "adjEqnOption": {"gmresRelTol": 1e-12, "gmresRestart": 60},
        "meshFaceLayout": "diaDense"}


def heat_radiation_options():
    """tests/test_golden.py:_case_heat_radiation on the dense layout."""
    return {
        "solverName": "DAHeatTransferFoam",
        "transportProperties": {"kappa": 10.0},
        "boundaryConditions": {
            "T": {"xmin": {"type": "fixedValue", "value": 1000.0},
                  "xmax": {"type": "fixedValue", "value": 400.0},
                  "ymin": {"type": "zeroGradient"},
                  "ymax": {"type": "zeroGradient"}},
            "G": {k: {"type": "zeroGradient"}
                  for k in ("xmin", "xmax", "ymin", "ymax")}},
        "initialFields": {"T": 700.0, "G": 4.0 * 5.67e-8 * 700.0 ** 4},
        "primalMinResTol": 1e-7, "primalMaxIters": 200,
        "function": {"Tm": {"type": "variableVolSum", "varName": "T",
                            "scale": 1.0, "divByTotalVol": 1}},
        "normalizeStates": {"T": 700.0, "G": 5e4},
        "adjEqnOption": {"gmresRelTol": 1e-10, "gmresRestart": 200,
                         "gmresMaxIters": 1500, "pcType": "none"},
        "meshFaceLayout": "diaDense"}


def rho_channel_options():
    """tests/test_rho_simple.py:channel (golden rho_channel), dense."""
    uin, zero = [50.0, 0.0, 0.0], [0.0, 0.0, 0.0]
    zg = {"type": "zeroGradient"}

    def fv(v):
        return {"type": "fixedValue", "value": v}

    return {
        "solverName": "DARhoSimpleFoam", "turbulenceModel": "None",
        "transportProperties": {"mu": 1.8e-5, "Cp": 1004.5, "R": 287.0,
                                "Pr": 0.7},
        "boundaryConditions": {
            "U": {"xmin": fv(uin), "xmax": zg, "ymin": fv(zero),
                  "ymax": fv(zero)},
            "p": {"xmin": zg, "xmax": fv(101325.0), "ymin": zg, "ymax": zg},
            "T": {"xmin": fv(300.0), "xmax": zg, "ymin": fv(350.0),
                  "ymax": fv(350.0)}},
        "initialFields": {"U": uin, "p": 101325.0, "T": 300.0},
        "primalMinResTol": 5e-9, "primalMaxIters": 1000,
        "primalVarBounds": {"UMin": -1000.0, "UMax": 1000.0,
                            "pMin": 20000.0, "pMax": 500000.0,
                            "TMin": 100.0, "TMax": 1000.0},
        "relaxationFactors": {"fields": {"p": 0.3},
                              "equations": {"U": 0.7, "T": 0.7}},
        "function": {
            "Tout": {"type": "patchMean", "patches": ["xmax"],
                     "varName": "T", "scale": 1.0},
            "mdot": {"type": "massFlowRate", "patches": ["xmax"],
                     "scale": 1.0}},
        "adjEqnOption": {"gmresRelTol": 1e-10, "gmresRestart": 300,
                         "gmresMaxIters": 3000, "pcType": "segregated"},
        "normalizeStates": {"U": 50.0, "p": 101325.0, "T": 300.0,
                            "phi": 1.0},
        "meshFaceLayout": "diaDense"}


# the compressible full-width case (phase 9): Mach 0.5 at the flagship's
# Reynolds number on the unit chord
T_INF, P_INF, R_GAS, GAMMA = 300.0, 101325.0, 287.0, 1.4
U_INF = 0.5 * math.sqrt(GAMMA * R_GAS * T_INF)
RHO_INF = P_INF / (R_GAS * T_INF)
MU_INF = RHO_INF * U_INF * 1.0 / 1000.0
NU_INF = MU_INF / RHO_INF
# relaxationFactors.fields.rho: without it (and at 0.5, 0.1) the CPU
# rehearsal of this case diverges (64x64 to 512x512); see PERF.md
RHO_RELAX = 0.005


def rho_options(**over):
    """DARhoSimpleFoam + SA on the flagship O-mesh at Mach 0.5, Re_c 1000,
    with bench_options()'s inner solves and ITERS SIMPLE iterations."""
    u = [U_INF, 0.0, 0.0]
    opts = {
        "solverName": "DARhoSimpleFoam",
        "turbulenceModel": "SpalartAllmaras",
        "transportProperties": {"mu": MU_INF, "nu": NU_INF, "Cp": 1004.5,
                                "R": R_GAS, "Pr": 0.7, "Prt": 0.9},
        "boundaryConditions": {
            "U": {"far": {"type": "inletOutlet", "value": u},
                  "wing": {"type": "fixedValue", "value": [0.0, 0.0, 0.0]}},
            "p": {"far": {"type": "fixedValue", "value": P_INF},
                  "wing": {"type": "zeroGradient"}},
            "T": {"far": {"type": "inletOutlet", "value": T_INF},
                  "wing": {"type": "zeroGradient"}},
            "nuTilda": {"far": {"type": "inletOutlet", "value": 3 * NU_INF},
                        "wing": {"type": "fixedValue", "value": 0.0}}},
        "initialFields": {"U": u, "p": P_INF, "T": T_INF,
                          "nuTilda": 3 * NU_INF},
        "primalVarBounds": {"UMin": -1000.0, "UMax": 1000.0,
                            "pMin": 20000.0, "pMax": 500000.0,
                            "TMin": 100.0, "TMax": 1000.0},
        "primalMinResTol": 0.0, "primalMinIters": ITERS,
        "primalMaxIters": ITERS,
        "primalLinearSolver": dict(bench_options()["primalLinearSolver"]),
        "relaxationFactors": {"fields": {"p": 0.2, "rho": RHO_RELAX},
                              "equations": {"U": 0.5, "T": 0.5,
                                            "nuTilda": 0.5}},
        "function": {"CD": {"type": "force", "patches": ["wing"],
                            "directionMode": "fixedDirection",
                            "direction": [1.0, 0.0, 0.0], "scale": 1.0}},
        "adjEqnOption": {"pcType": "segregated", "gmresRestart": 60,
                         "gmresMaxIters": 60, "gmresRelTol": 1e-12,
                         "gmresAbsTol": 1e-30, "gmresDeflate": 0},
        "normalizeStates": {"U": U_INF, "p": P_INF, "T": T_INF, "phi": 1.0,
                            "nuTilda": 3 * NU_INF},
        "meshFaceLayout": "diaDense"}
    opts.update(over)
    return opts


def pimple_cavity_options(n=8, **over):
    """tests/test_pimple_unsteady.py:cavity_unsteady's options (the golden
    pimple_unsteady), on the dense layout, with the segregated PC of
    tests/test_torch_pimple.py (unpreconditioned, the dense layout's
    reverse sweep stops at its 1000-iteration cap)."""
    zero = [0.0, 0.0, 0.0]
    opts = {
        "solverName": "DAPimpleFoam",
        "turbulenceModel": "None",
        "transportProperties": {"nu": 0.01},
        "deltaT": 0.02, "endTime": 0.1,
        "pimple": {"nOuterCorrectors": 12, "nCorrectors": 2},
        "boundaryConditions": {
            "U": {"ymax": {"type": "fixedValue", "value": [1.0, 0.0, 0.0]},
                  "ymin": {"type": "fixedValue", "value": zero},
                  "xmin": {"type": "fixedValue", "value": zero},
                  "xmax": {"type": "fixedValue", "value": zero}},
            "p": {k: {"type": "zeroGradient"}
                  for k in ("xmin", "xmax", "ymin", "ymax")}},
        "initialFields": {"U": zero, "p": 0.0},
        "primalLinearSolver": {"pMaxIters": 400, "pRelTol": 1e-12,
                               "uMaxIters": 200, "uRelTol": 1e-12},
        "function": {
            "lidF": {"type": "force", "patches": ["ymax"],
                     "directionMode": "fixedDirection",
                     "direction": [1.0, 0.0, 0.0], "scale": 1.0,
                     "timeOp": "average", "timeOpFracStart": 0.4}},
        "adjEqnOption": {"gmresRelTol": 1e-11, "gmresRestart": 200,
                         "gmresMaxIters": 1000, "pcType": "segregated"},
        "normalizeStates": {"U": 1.0, "p": 0.5, "phi": 1.0},
        "meshFaceLayout": "diaDense"}
    opts.update(over)
    return opts


# the full-width unsteady cavity (phase 11): a 0.1 m box at 512x512, lid
# 1 m/s, nu 1e-4 (Re 1000), deltaT 1e-4 (lid Courant number 0.51), 20
# Euler steps of 4 outer and 2 pressure correctors; the reverse sweeps
# cap each step's FGMRES at PIMPLE_GMRES iterations. At a lid Courant
# number of 2.05 (deltaT 4e-4) the p solves' 100-iteration cap leaves too
# much continuity error for 4 outer correctors: the state turns NaN by
# step 7 (f32, on the card and on the CPU), and with a 400-iteration cap
# the lid force flips sign from step to step
PIMPLE_STEPS = 10
PIMPLE_DT = 1e-4
PIMPLE_GMRES = 20
PIMPLE_SEG = 5


def pimple_full_options():
    return pimple_cavity_options(
        transportProperties={"nu": 1e-4}, deltaT=PIMPLE_DT,
        endTime=PIMPLE_STEPS * PIMPLE_DT,
        pimple={"nOuterCorrectors": 4, "nCorrectors": 2},
        primalLinearSolver={"pMaxIters": 100, "pRelTol": 1e-6,
                            "uMaxIters": 20, "uRelTol": 1e-6},
        adjEqnOption={"gmresRelTol": 1e-12, "gmresAbsTol": 1e-30,
                      "gmresRestart": PIMPLE_GMRES,
                      "gmresMaxIters": PIMPLE_GMRES,
                      "pcType": "segregated"})


# the transonic bump (phase 10): tests/test_hisa.py:make_hisa's options on
# its channel at 1024x256, f32; HISA_LF laxFriedrichs then HISA_AUSM
# AUSMPlusUp PTC iterations, each full GMRES capped at HISA_INNER
HISA_NX, HISA_NY = 1024, 256
HISA_MACH, HISA_T, HISA_P = 0.675, 300.0, 1.0e5
HISA_UIN = HISA_MACH * math.sqrt(GAMMA * R_GAS * HISA_T)
HISA_LF = 8
HISA_AUSM = 6
HISA_INNER = 80
HISA_ADJ = 60


def bump_channel(box, nx, ny):
    """tests/test_hisa.py:bump_channel: [0,3]x[0,1] with a Gaussian bump
    of height 0.06 on the lower wall."""
    pts, topo = box(nx, ny, 1, (3.0, 1.0, 0.05),
                    kinds={"zmin": "empty", "zmax": "empty", "ymin": "wall",
                           "ymax": "wall"})
    import numpy
    pts = numpy.array(pts)
    x, y = pts[:, 0], pts[:, 1]
    pts[:, 1] = y + 0.06 * numpy.exp(-((x - 1.5) / 0.4) ** 2) * (1.0 - y)
    return pts, topo


def hisa_options():
    uin = [HISA_UIN, 0.0, 0.0]
    return {
        "solverName": "DAHisaFoam",
        "turbulenceModel": "None",
        "hisa": {"inviscid": True, "fluxScheme": "AUSMPlusUp", "cfl": 5.0,
                 "cflMax": 1e4, "innerIters": HISA_INNER,
                 "stage1MaxIters": HISA_LF},
        "transportProperties": {"R": R_GAS, "gamma": GAMMA},
        "boundaryConditions": {
            "U": {"xmin": {"type": "fixedValue", "value": uin},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "slip"}, "ymax": {"type": "slip"}},
            "p": {"xmin": {"type": "zeroGradient"},
                  "xmax": {"type": "fixedValue", "value": HISA_P},
                  "ymin": {"type": "zeroGradient"},
                  "ymax": {"type": "zeroGradient"}},
            "T": {"xmin": {"type": "fixedValue", "value": HISA_T},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "zeroGradient"},
                  "ymax": {"type": "zeroGradient"}}},
        "initialFields": {"U": uin, "p": HISA_P, "T": HISA_T},
        "primalMinResTol": 1e-7,
        "primalMinIters": HISA_AUSM, "primalMaxIters": HISA_AUSM,
        "function": {
            "CDp": {"type": "force", "patches": ["ymin"],
                    "directionMode": "fixedDirection",
                    "direction": [1.0, 0.0, 0.0], "scale": 1.0}},
        "adjEqnOption": {"gmresRelTol": 1e-12, "gmresRestart": HISA_ADJ,
                         "gmresMaxIters": HISA_ADJ, "gmresAbsTol": 1e-30,
                         "pcType": "blockJacobian", "pcInnerIters": 12},
        "normalizeStates": {"U": 240.0, "p": 1e5, "T": 300.0},
        "primalVarBounds": {"pMin": 1e3, "TMin": 50.0},
        "meshFaceLayout": "diaDense"}


# phase 11b: DARhoPimpleFoam on phase 9's case, RHO_PIMPLE_STEPS steps
RHO_PIMPLE_STEPS = 5
RHO_PIMPLE_DT = 1e-4

# the plunging NACA0012 (phase 12): phase 5's 512x512 O-mesh and SA options
# as DAPimpleDyMFoam, the whole mesh in rigid translation along y with
# amplitude DYM_AMP chords at DYM_FREQ Hz (reduced frequency pi f c/U =
# pi, peak plunge speed 0.063 U), DYM_STEPS ALE steps of 4 outer and 2
# pressure correctors from phase 5's state; each reverse step's FGMRES
# capped at UNSTEADY_GMRES (segregated PC). deltaT: the PIMPLE steps on
# this O-mesh turn NaN within 10 steps (with or without motion, and so
# does DAPimpleFoam) at 1e-3 from 128x128 up, at 1e-4 from 256x256 up (the
# card at 512x512 too) and at 5e-5 at 256x256 (CPU rehearsals, f32, from
# a 60-iteration SIMPLE state); 1e-5 held at 256x256 and 5e-6 at 512x512.
# One period per 100 steps at such a deltaT would plunge at >6 U (it
# diverged at 128x128 and 1e-4), so the frequency is fixed instead
DYM_STEPS = 5
DYM_DT = 5e-6
DYM_AMP = 0.01
DYM_FREQ = 1.0
UNSTEADY_GMRES = 20
# phase 13: DAIrkPimpleFoam on phase 11's cavity, IRK_STEPS Radau steps of
# maxSweeps 4 and 2 pressure correctors per stage solve
IRK_STEPS = 5
# phase 14: tests/test_interfoam.py's dam break (0.6 x 0.4 m, water at
# x < 0.2, y < 0.2) at INTER_NX x INTER_NY, deltaT INTER_DT (Courant ~0.2
# at the collapse speed sqrt(2 g 0.2) ~ 2 m/s), INTER_STEPS steps of 3
# outer and 2 correctors, the p_rgh solves capped at INTER_PITERS Jacobi-CG
# iterations. The explicit alpha update is bounded only as far as phi is
# divergence-free: with a cap of 100 alpha reached 1 + 1.1e-4 by step 20
# on the card (1 + 1.0e-4 by step 4 in the CPU rehearsal at this size,
# f32), with 1000 it stays within 1 + 5.6e-6 over the 20 steps on the CPU
# (with ADI line PCs and a cap of 100, 1 + 2.6e-6 by step 4, ~4x the cost)
INTER_NX, INTER_NY = 640, 410
INTER_DT = 1e-4
INTER_STEPS = 12
INTER_PITERS = 1000
# phase 15: tests/test_time_spectral.py:_case's box at 512x512 with N = 5
# instances, the block Gauss-Seidel primal capped at TS_SWEEPS sweeps
# (BiCGStab to rel 1e-3, at most 100 iterations per instance solve), one
# TS_GMRES-iteration residual-form FGMRES cycle with the lineJacobi PC. The
# segregated PC's 15 BiCGStab sweeps per instance block turned the first
# FGMRES iteration NaN in the CPU rehearsal at 128x128 (f32)
TS_SWEEPS = 30
TS_GMRES = 60


def unsteady_adjoint():
    return {"gmresRelTol": 1e-12, "gmresAbsTol": 1e-30,
            "gmresRestart": UNSTEADY_GMRES, "gmresMaxIters": UNSTEADY_GMRES,
            "pcType": "segregated"}


def dym_options():
    func = naca_options()["function"]["CD"]
    return naca_options(
        solverName="DAPimpleDyMFoam", deltaT=DYM_DT,
        endTime=DYM_STEPS * DYM_DT,
        pimple={"nOuterCorrectors": 4, "nCorrectors": 2},
        primalLinearSolver={"pMaxIters": 100, "pRelTol": 1e-6,
                            "uMaxIters": 20, "uRelTol": 1e-6,
                            "turbMaxIters": 20, "turbRelTol": 1e-6},
        dynamicMesh={"active": True, "motionType": "translation",
                     "amplitude": DYM_AMP,
                     "frequency": DYM_FREQ,
                     "direction": [0.0, 1.0, 0.0],
                     "movingPatches": ["wing"]},
        function={"CD": dict(func, timeOp="average",
                             timeOpFracStart=0.0)},
        adjEqnOption=unsteady_adjoint(),
        normalizeStates={"U": 1.0, "p": 0.5, "phi": 1.0, "nuTilda": 3 * NU},
        meshFaceLayout="diaDense")


def irk_options():
    return pimple_cavity_options(
        solverName="DAIrkPimpleFoam", transportProperties={"nu": 1e-4},
        deltaT=PIMPLE_DT, endTime=IRK_STEPS * PIMPLE_DT,
        pimple={"nOuterCorrectors": 1, "nCorrectors": 2},
        irk={"maxSweeps": 4},
        primalLinearSolver={"pMaxIters": 100, "pRelTol": 1e-6,
                            "uMaxIters": 20, "uRelTol": 1e-6},
        adjEqnOption=unsteady_adjoint())


def inter_options():
    zero = [0.0, 0.0, 0.0]
    walls = {"type": "zeroGradient"}
    return {
        "solverName": "DAInterFoam",
        "transportProperties": {"rho1": 1000.0, "rho2": 1.0, "nu1": 1e-6,
                                "nu2": 1.48e-5, "cAlpha": 1.0},
        "g": [0.0, -9.81, 0.0],
        "deltaT": INTER_DT, "endTime": INTER_STEPS * INTER_DT,
        "pimple": {"nOuterCorrectors": 3, "nCorrectors": 2},
        "boundaryConditions": {
            "U": {"xmin": {"type": "fixedValue", "value": zero},
                  "xmax": {"type": "fixedValue", "value": zero},
                  "ymin": {"type": "fixedValue", "value": zero},
                  "ymax": dict(walls)},
            "p_rgh": {"xmin": dict(walls), "xmax": dict(walls),
                      "ymin": dict(walls),
                      "ymax": {"type": "fixedValue", "value": 0.0}},
            "alpha": {"xmin": dict(walls), "xmax": dict(walls),
                      "ymin": dict(walls),
                      "ymax": {"type": "fixedValue", "value": 0.0}}},
        "initialFields": {"U": zero, "p_rgh": 0.0, "alpha": 0.0},
        "primalLinearSolver": {"pMaxIters": INTER_PITERS, "pRelTol": 1e-6,
                               "uMaxIters": 20, "uRelTol": 1e-6},
        "function": {"pRight": {"type": "patchMean", "patches": ["xmax"],
                                "varName": "p_rgh", "scale": 1.0,
                                "timeOp": "average"}},
        "adjEqnOption": unsteady_adjoint(),
        "normalizeStates": {"U": 1.0, "p_rgh": 100.0, "phi": 1.0,
                            "alpha": 1.0},
        "normalizeResiduals": ["URes", "p_rghRes", "phiRes", "alphaRes"],
        "meshFaceLayout": "diaDense"}


def ts_options():
    period = 2.0
    return {
        "solverName": "DAScalarTransportFoam",
        "unsteadyAdjoint": {"mode": "hybrid", "nTimeInstances": 5,
                            "periodicity": period},
        "transportProperties": {"DT": 0.05},
        "boundaryConditions": {
            "T": {"xmin": {"type": "multiFreqScalar", "refValue": 1.0,
                           "amplitudes": [0.6],
                           "frequencies": [1.0 / period], "phases": [0.0]},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "zeroGradient"},
                  "ymax": {"type": "zeroGradient"}}},
        "initialFields": {"T": 1.0},
        "primalMinResTol": 0.0, "primalMaxIters": TS_SWEEPS,
        "primalLinearSolver": {"turbRelTol": 1e-3, "turbMaxIters": 100},
        "function": {"TMean": {"type": "variableVolSum", "varName": "T",
                               "scale": 1.0, "timeOp": "max",
                               "timeOpMaxMode": "KS", "coeffKS": 50.0}},
        "adjEqnOption": {"gmresRelTol": 1e-12, "gmresAbsTol": 1e-30,
                         "gmresRestart": TS_GMRES,
                         "gmresMaxIters": TS_GMRES, "pcType": "lineJacobi"},
        "normalizeStates": {"T": 1.0},
        "meshFaceLayout": "diaDense"}


KINF = 1.5 * (0.05 * 1.0) ** 2      # 5% turbulence intensity at |U_inf| 1
WINF = KINF / (3.0 * NU)             # nut_inf = 3 nu, as nuTilda_inf = 3 nu
BETA1 = 0.075


def turb_options(model, d1, adjoint=False):
    """The full-width case with ``model``: farfield inletOutlet at the
    farfield values, initial fields there, bench.py's solver options
    (and, with ``adjoint``, its fixed-point adjoint options)."""
    opts = bench_adjoint_options() if adjoint else bench_options()
    opts["turbulenceModel"] = model
    bcs = opts["boundaryConditions"]
    init = opts["initialFields"]
    norm = dict(opts.get("normalizeStates", {}))
    w_wall = 10.0 * 6.0 * NU / (BETA1 * d1 ** 2)     # Menter

    def field(name, far, wing):
        bcs[name] = {"far": {"type": "inletOutlet", "value": far},
                     "wing": wing}
        init[name] = far
        norm[name] = far

    def fixed(v):
        return {"type": "fixedValue", "value": v}

    if model == "SpalartAllmaras":
        bcs["nuTilda"]["wing"] = {"type": "zeroGradient"}
        bcs["nut"] = {"wing": {"type": "nutUSpaldingWallFunction"}}
    else:
        del bcs["nuTilda"], init["nuTilda"]
        norm.pop("nuTilda", None)
        field("k", KINF, fixed(1e-10))
        if model == "kEpsilon":
            field("epsilon", 0.09 * KINF * WINF, fixed(0.09 * KINF * w_wall))
        else:
            field("omega", WINF, fixed(w_wall))
        if model == "kOmegaSSTLM":
            field("ReThetat", 120.0, {"type": "zeroGradient"})
            field("gammaInt", 1.0, {"type": "zeroGradient"})
    if adjoint:
        opts["normalizeStates"] = norm
    return opts


@contextlib.contextmanager
def overridden(option, **items):
    """Set top-level options of a solver for the duration of a block."""
    old = {k: option[k] for k in items}
    for k, v in items.items():
        option.set(k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            option.set(k, v)


def say(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices "
        f"{torch.cuda.device_count()} using {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build(dk):
    t0 = time.perf_counter()
    path = dk.build()
    dk._library()
    dt = time.perf_counter() - t0
    regs = [ln.strip() for ln in dk.build_log().splitlines()
            if "registers" in ln or "spill" in ln]
    say(f"[build] {path.name} ready in {dt:.2f} s")
    for ln in regs:
        say(f"[build] {ln}")


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def cuda_ms(torch, fn, reps=15, inner=40):
    """Median milliseconds of one call, from CUDA events over ``inner``
    back-to-back calls, after a warm-up."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _kernel_events(prof):
    return [e for e in prof.events() if "CUDA" in str(e.device_type)]


def _event_us(e):
    return e.device_time_total      # a kernel event: its own duration


def device_us(torch, fn, calls=20, tries=3):
    """Microseconds of device time per call (sum of the kernels one call
    launches), from torch.profiler. A session that records no kernel (the
    tracing drops one now and then: a K3b time once read 0.0) is run
    again; none in ``tries`` sessions fails the phase."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = _kernel_events(prof)
        if events:
            return sum(_event_us(e) for e in events) / calls
    raise SmokeFailure("the profiler recorded no kernel")


def _max_err(torch, got, ref, label):
    """(max abs err, max |ref|) over one tensor or a tuple of them; checks
    finiteness and the relative bar of the dtype."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = scale = 0.0
    for g, r in zip(got, ref):
        check(bool(torch.isfinite(g).all()), f"{label}: non-finite output")
        if g.numel():
            err = max(err, float((g - r).abs().max()))
            scale = max(scale, float(r.abs().max()))
    dt = str(ref[0].dtype).replace("torch.", "")
    check(err <= REL[dt] * max(scale, 1e-300),
          f"{label} {dt}: max err {err:.3e} > {REL[dt]} x {scale:.3e}")
    return err, scale


def kernel_calls(dk, name, diag, coef, offsets, x, ct):
    """(kernel, plain) zero-argument calls of one wrapper on one operand
    set: K1/K2 apply A to x, K3a applies A^T to ct, K3b forms the
    cotangents of (ct, x) with the diagonal's layout."""
    per_comp = diag.ndim == 2
    args = {"dia_matvec": (diag, coef, offsets, x),
            "dia_matvec_multi": (diag, coef, offsets, x),
            "dia_matvec_t": (diag, coef, offsets, ct),
            "dia_matvec_multi_t": (diag, coef, offsets, ct),
            "dia_cotangent": (ct, x, offsets),
            "dia_cotangent_multi": (ct, x, offsets, per_comp)}[name]
    kern, plain = getattr(dk, name), getattr(dk, name + "_plain")
    return (lambda: kern(*args)), (lambda: plain(*args))


def compare(torch, dk, name, diag, coef, offsets, x, ct, stats, label):
    kern, plain = kernel_calls(dk, name, diag, coef, offsets, x, ct)
    y = kern()
    torch.cuda.synchronize()
    err, scale = _max_err(torch, y, plain(), f"{label} {name}")
    st = stats.setdefault(name, {"max_abs_err": 0.0})
    st["max_abs_err"] = max(st["max_abs_err"], err)
    return err, scale


def bound(name, diag, offsets, x):
    """(bound_ms, bound_by) of one call: every input read once and every
    output written once over the HBM rate, against the flops over the
    peak of the dtype (H100 SXM data sheet); the larger decides."""
    n = x.shape[-1]
    c = x.shape[0] if x.ndim == 2 else 1
    k = len(offsets)
    nd = diag.numel()
    if name in ("dia_matvec", "dia_matvec_multi", "dia_matvec_t",
                "dia_matvec_multi_t"):
        elems = nd + k * n + 2 * c * n          # d, c, x (ct) in; y out
        flops = c * n * (2 * k + 1)
    else:                                       # K3b: ct, x in; dbar, cbar out
        elems = 2 * c * n + nd + k * n
        flops = (c * n if nd == c * n else (2 * c - 1) * n) \
            + k * n * (2 * c - 1)
    byte_s = elems * x.element_size() / HBM_BYTES_PER_S
    peak = FP32_FLOP_PER_S if x.element_size() == 4 else FP64_FLOP_PER_S
    op_s = flops / peak
    return max(byte_s, op_s) * 1e3, "bytes" if byte_s >= op_s else \
        "operations"


def csr_matrix(torch, diag, coef, offsets, transpose=False):
    """A (or A^T) as one sparse CSR matrix: block diagonal over the
    components of a (C, n) diagonal. The library yardstick only."""
    n = coef.shape[1]
    dev = coef.device
    comps = diag.shape[0] if diag.ndim == 2 else 1
    idx = torch.arange(n, device=dev)
    rows, cols, vals = [], [], []
    for q in range(comps):
        base = q * n
        rows.append(idx + base)
        cols.append(idx + base)
        vals.append(diag[q] if diag.ndim == 2 else diag)
        for k, o in enumerate(offsets):
            j = idx + o
            m = (j >= 0) & (j < n)
            rows.append(idx[m] + base)
            cols.append(j[m] + base)
            vals.append(coef[k][m])
    r, c = torch.cat(rows), torch.cat(cols)
    if transpose:
        r, c = c, r
    coo = torch.sparse_coo_tensor(torch.stack([r, c]), torch.cat(vals),
                                  (comps * n, comps * n)).coalesce()
    return coo.to_sparse_csr()


def library_call(torch, name, diag, coef, offsets, x, ct):
    """The one PyTorch call computing the same function (cuSPARSE SpMV on
    a CSR copy), or None for K3b (no single-call equivalent)."""
    if name in ("dia_cotangent", "dia_cotangent_multi"):
        return None
    transpose = name.endswith("_t")
    vec = ct if transpose else x
    if x.ndim == 2 and diag.ndim == 1:
        diag = diag.expand(x.shape[0], -1)
    A = csr_matrix(torch, diag, coef, offsets, transpose)
    flat = vec.reshape(-1)
    return lambda: torch.mv(A, flat)


def time_kernel(torch, dk, name, diag, coef, offsets, x, ct, stats, label):
    """Device time per call of the kernel, its plain version and the
    library call (profiler), the kernel back to back (CUDA events), and
    the bound; stored in stats for float32."""
    kern, plain = kernel_calls(dk, name, diag, coef, offsets, x, ct)
    lib = library_call(torch, name, diag, coef, offsets, x, ct)
    if lib is not None:
        want = kern()
        _max_err(torch, lib().reshape(want.shape), want,
                 f"{label} {name} library call")
    kus = device_us(torch, kern)
    pus = device_us(torch, plain)
    lus = device_us(torch, lib) if lib is not None else None
    b2b = cuda_ms(torch, kern)
    bms, by = bound(name, diag, offsets, x)
    say(f"[kernels] time {name} {label} {x.dtype}: device {kus:.2f} us, "
        f"plain {pus:.2f} us, library "
        f"{'none' if lus is None else f'{lus:.2f} us'}, bound {bms * 1e3:.2f}"
        f" us ({by}); back to back {b2b * 1e3:.1f} us (CUDA events)")
    if x.dtype == torch.float32:
        stats[name].update(ms=kus / 1e3, plain_ms=pus / 1e3,
                           library_ms=None if lus is None else lus / 1e3,
                           bound_ms=bms, bound_by=by, back_to_back_ms=b2b)


FORWARD = ("dia_matvec", "dia_matvec_multi")
REVERSE = ("dia_matvec_t", "dia_matvec_multi_t", "dia_cotangent",
           "dia_cotangent_multi")


def _real_operands(torch, fvx, solver):
    """Band layouts and coefficients of the first p, nuTilda and U matrices
    of the case, with random x and ct (seeded on the device)."""
    dev = solver.device
    eqs = solver.equations(solver.init_state(), solver.make_inputs())
    gen = torch.Generator(device=dev).manual_seed(0)
    nc = solver.topo.n_cells
    real = []
    for field in ("p", "nuTilda", "U"):
        m = eqs[field]
        offsets, coef = fvx.dia_bands(m, solver.topo)
        if field == "U":
            diag = m.diag.t().contiguous()          # (3, nc) per component
            shape = (3, nc)
        else:
            diag = m.diag.contiguous()
            shape = (nc,)
        x = torch.randn(shape, generator=gen, device=dev)
        ct = torch.randn(shape, generator=gen, device=dev)
        real.append((field, offsets, diag, coef.contiguous(), x, ct))
    return real


def _edge_shapes(torch, dev):
    """Ragged n, offsets wider than a block, none, n past the grid cap
    (grid-stride), 64 distinct nonzero offsets (the kernels' most), n = 1
    and 3."""
    rng = torch.Generator(device="cpu").manual_seed(1)
    wide = tuple(sorted(int(v) - 3000 if v < 3000 else int(v) - 2999
                        for v in torch.randperm(6000, generator=rng)[:64]))
    return [(1037, (-33, -1, 1, 33)), (20011, (-5000, -300, 1, 300, 5000)),
            (4097, ()), (2_100_000, (-1024, -1, 1, 1024)), (9001, wide),
            (1, (-1, 1)), (3, (5,))]


def phase_kernels(torch, dk, fvx, solver, stats, names, tag):
    """Kernels ``names`` (scalar and _multi forms) against their plain
    versions on the case's matrices and the edge shapes, f32 and f64,
    shared and per-component diagonals; then their times."""
    dev = solver.device
    gen = torch.Generator(device=dev).manual_seed(2)
    real = _real_operands(torch, fvx, solver)
    say(f"[{tag}] {FULL}x{FULL} bands: offsets {real[0][1]}, n = "
        f"{solver.topo.n_cells}")
    scalar = [nm for nm in names if not nm.endswith(("multi", "multi_t"))]
    multi = [nm for nm in names if nm not in scalar]
    for dtype in (torch.float32, torch.float64):
        for field, offsets, diag, coef, x, ct in real:
            d, c, xx, cc = (t.to(dtype) for t in (diag, coef, x, ct))
            for nm in (multi if field == "U" else scalar):
                err, scale = compare(torch, dk, nm, d, c, offsets, xx, cc,
                                     stats, f"{field} matrix")
                say(f"[{tag}] {nm} {field} {dtype}: max abs err {err:.3e} "
                    f"(max |y| {scale:.3e})")
        # the momentum matrix with a shared scalar diagonal
        _, offsets, diag, coef, x, ct = real[2]
        for nm in multi:
            compare(torch, dk, nm, diag[0].to(dtype).contiguous(),
                    coef.to(dtype), offsets, x.to(dtype), ct.to(dtype),
                    stats, "U shared diag")

    for dtype in (torch.float32, torch.float64):
        for n, offsets in _edge_shapes(torch, dev):
            def rnd(*shape):
                return torch.randn(shape, generator=gen,
                                   device=dev).to(dtype)
            d, c, x, ct = rnd(n), rnd(len(offsets), n), rnd(n), rnd(n)
            for nm in scalar:
                compare(torch, dk, nm, d, c, offsets, x, ct, stats,
                        f"n={n} K={len(offsets)}")
            for comps in (1, 2, 3, 4):
                xc, cc, dc = rnd(comps, n), rnd(comps, n), rnd(comps, n)
                for nm in multi:
                    compare(torch, dk, nm, d, c, offsets, xc, cc, stats,
                            f"C={comps} n={n}")
                    compare(torch, dk, nm, dc, c, offsets, xc, cc, stats,
                            f"C={comps} n={n} per-comp diag")
    say(f"[{tag}] edge shapes pass ({len(_edge_shapes(torch, dev))} shapes x"
        " C in 1,2,3,4 x shared/per-component diagonal x f32/f64)")
    return real


def phase_kernel_times(torch, dk, real, stats):
    """Times of every kernel at 262,144 cells: p for the scalar forms, U
    for the multi forms. Runs after the main path, so that no profiler
    session precedes the timed SIMPLE iterations and adjoint products."""
    for dtype in (torch.float32, torch.float64):
        for field, offsets, diag, coef, x, ct in (real[0], real[2]):
            d, c, xx, cc = (t.to(dtype) for t in (diag, coef, x, ct))
            for nm in KERNELS:
                if nm.endswith(("multi", "multi_t")) == (field == "U"):
                    time_kernel(torch, dk, nm, d, c, offsets, xx, cc, stats,
                                field)


def phase_functions(torch, dk, real):
    """DiaMatvec/DiaMatvecMulti on the card: output keeps its grad_fn; vjp
    and jvp against autograd of the plain banded matvec, f64."""
    import torch.autograd.forward_ad as fwAD
    for field, offsets, diag, coef, x, ct in real:
        fn = dk.DiaMatvecMulti if field == "U" else dk.DiaMatvec
        d, c, xx, cc = (t.double() for t in (diag, coef, x, ct))
        prim = [t.clone().requires_grad_(True) for t in (d, c, xx)]
        y = fn.apply(*prim, offsets)
        check(y.requires_grad and y.grad_fn is not None,
              f"{field}: a gradient through the kernel lost its grad_fn")
        got = torch.autograd.grad(y, prim, cc)
        ref_in = [t.clone().requires_grad_(True) for t in (d, c, xx)]
        want = torch.autograd.grad(dk._banded(*ref_in[:2], offsets,
                                              ref_in[2]), ref_in, cc)
        err, _ = _max_err(torch, tuple(got), tuple(want), f"{field} vjp")
        tang = [torch.randn_like(t) for t in (d, c, xx)]
        with fwAD.dual_level():
            duals = [fwAD.make_dual(p, t) for p, t in zip((d, c, xx), tang)]
            jt = fwAD.unpack_dual(fn.apply(*duals, offsets)).tangent
            duals = [fwAD.make_dual(p, t) for p, t in zip((d, c, xx), tang)]
            jr = fwAD.unpack_dual(dk._banded(duals[0], duals[1], offsets,
                                             duals[2])).tangent
        err2, _ = _max_err(torch, jt, jr, f"{field} jvp")
        say(f"[functions] {fn.__name__} {field} f64 on the card: vjp max err "
            f"{err:.3e}, jvp max err {err2:.3e} against autograd of the "
            "plain banded matvec; output has a grad_fn")


# ---------------------------------------------------------------------------
# phase 4-5
# ---------------------------------------------------------------------------

def check_counts(counts, phase, names=PRIMAL_KERNELS):
    for name in names:
        check(counts[name] > 0, f"{phase}: {name} was not launched")
    for name in KERNELS:
        check(counts[name + "_plain"] == 0, f"{phase}: {name}_plain ran")


def phase_golden(torch, dk, make_solver, omesh):
    with open(os.path.join(HERE, "tests", "golden", "values.json")) as fh:
        want = json.load(fh)["naca_sa"]["CD"]
    pts, topo = omesh(n_wrap=32, n_radial=12, radius=15.0, first_cell=4e-3)
    s = make_solver(golden_options(), topo, pts, device=DEVICE,
                    dtype=torch.float64)
    check(s.topo.dia_dense() is None, "golden must run the canonical layout")
    inputs = s.make_inputs()
    st0 = s.init_state()
    dk.reset_counts()
    t0 = time.perf_counter()
    state, info = s.run_primal(st0, inputs)
    dt = time.perf_counter() - t0
    counts = dict(dk.COUNTS)
    cd = float(s.run_function("CD", state, inputs))
    rel = abs(cd - want) / abs(want)
    say(f"[golden] 32x12 f64 canonical: {info.iters} iters, max_res "
        f"{info.max_res:.3e}, converged {info.converged}, {dt:.1f} s; CD "
        f"{cd!r} vs golden {want!r} (rel {rel:.2e}); launch counts {counts}")
    check(info.converged and not info.failed, f"golden primal: {info}")
    check(rel <= 1e-8, f"golden CD off by {rel:.2e}")
    check_counts(counts, "golden")


def phase_golden_adjoint(torch, dk, make_solver, omesh):
    """Phase 4b: the golden case's fixed-point adjoint and totals."""
    with open(os.path.join(HERE, "tests", "golden", "values.json")) as fh:
        want = json.load(fh)["naca_sa"]
    pts, topo = omesh(n_wrap=32, n_radial=12, radius=15.0, first_cell=4e-3)
    s = make_solver(golden_adjoint_options(), topo, pts, device=DEVICE,
                    dtype=torch.float64)
    check(s.topo.dia_dense() is not None, "golden adjoint runs dense-DIA")
    inputs = s.make_inputs()
    state, info = s.run_primal(s.init_state(), inputs)
    check(info.converged and not info.failed, f"golden primal: {info}")
    dk.reset_counts()
    t0 = time.perf_counter()
    psibar, ainfo = s.solve_adjoint(state, inputs, "CD")
    tot = s.total_derivative(state, inputs, "CD", psibar)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(dk.COUNTS)
    dnu = float(tot["params"]["nu"])
    dpts = float(torch.linalg.norm(tot["points"]))
    rnu = abs(dnu - want["dCD_dnu"]) / abs(want["dCD_dnu"])
    rpts = abs(dpts - want["dCD_dpoints_norm"]) / want["dCD_dpoints_norm"]
    say(f"[golden-adjoint] 32x12 f64 dense: primal {info.iters} iters; "
        f"adjoint {ainfo.iters} GMRES iters, resid {ainfo.resid0:.3e} -> "
        f"{ainfo.resid:.3e}, {dt:.1f} s with totals; dCD/dnu {dnu!r} (rel "
        f"{rnu:.2e}), ||dCD/dpoints|| {dpts!r} (rel {rpts:.2e}); launch "
        f"counts {counts}")
    check(ainfo.converged, f"golden adjoint did not converge: {ainfo}")
    check(rnu <= BAR_DNU, f"dCD/dnu off golden by {rnu:.2e}")
    check(rpts <= BAR_DPOINTS, f"||dCD/dpoints|| off golden by {rpts:.2e}")
    check_counts(counts, "golden adjoint", ADJOINT_KERNELS)
    return state, want


def _golden_totals(torch, tot, want):
    dnu = float(tot["params"]["nu"])
    dpts = float(torch.linalg.norm(tot["points"]))
    return (dnu, dpts, abs(dnu - want["dCD_dnu"]) / abs(want["dCD_dnu"]),
            abs(dpts - want["dCD_dpoints_norm"]) / want["dCD_dpoints_norm"])


def _golden_solve(torch, dk, make_solver, omesh, opts, state):
    """solve_adjoint + total_derivative of the golden case with ``opts``
    from a converged state: (info, totals, seconds, launch counts)."""
    pts, topo = omesh(n_wrap=32, n_radial=12, radius=15.0, first_cell=4e-3)
    s = make_solver(opts, topo, pts, device=DEVICE, dtype=torch.float64)
    inputs = s.make_inputs()
    dk.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psi, ainfo = s.solve_adjoint(state, inputs, "CD")
    tot = s.total_derivative(state, inputs, "CD", psi)
    torch.cuda.synchronize()
    return ainfo, tot, time.perf_counter() - t0, dict(dk.COUNTS)


def phase_golden_residual(torch, dk, make_solver, omesh, state, want):
    """Phase 4c: the golden case by the residual-form (Krylov) route."""
    ainfo, tot, dt, counts = _golden_solve(
        torch, dk, make_solver, omesh, golden_residual_options(), state)
    dnu, dpts, rnu, rpts = _golden_totals(torch, tot, want)
    say(f"[golden-residual] 32x12 f64 dense, FGMRES restart 400, segregated "
        f"PC: {ainfo.iters} iters, resid {ainfo.resid0:.3e} -> "
        f"{ainfo.resid:.3e}, {dt:.1f} s with totals; dCD/dnu {dnu!r} (rel "
        f"{rnu:.2e}), ||dCD/dpoints|| {dpts!r} (rel {rpts:.2e}); launch "
        f"counts {counts}")
    check(ainfo.converged, f"golden residual adjoint: {ainfo}")
    check(rnu <= BAR_DNU, f"residual dCD/dnu off golden by {rnu:.2e}")
    check(rpts <= BAR_DPOINTS,
          f"residual ||dCD/dpoints|| off golden by {rpts:.2e}")
    check_counts(counts, "golden residual", ("dia_matvec_t",
                                             "dia_matvec_multi_t"))


def phase_golden_implicit(torch, dk, make_solver, omesh, state, want):
    """Phase 4d: the fixed-point totals with fpInnerMode implicit."""
    ainfo, tot, dt, counts = _golden_solve(
        torch, dk, make_solver, omesh, golden_implicit_options(), state)
    dnu, dpts, rnu, rpts = _golden_totals(torch, tot, want)
    say(f"[golden-implicit] 32x12 f64 dense, fpInnerMode implicit: "
        f"{ainfo.iters} GMRES iters, resid {ainfo.resid0:.3e} -> "
        f"{ainfo.resid:.3e}, {dt:.1f} s with totals; dCD/dnu {dnu!r} (rel "
        f"{rnu:.2e}), ||dCD/dpoints|| {dpts!r} (rel {rpts:.2e}); transpose "
        f"solves and cotangents: K3a {counts['dia_matvec_t']} + "
        f"{counts['dia_matvec_multi_t']}, K3b {counts['dia_cotangent']} + "
        f"{counts['dia_cotangent_multi']}; launch counts {counts}")
    check(ainfo.converged, f"golden implicit adjoint: {ainfo}")
    check(rnu <= BAR_DNU, f"implicit dCD/dnu off golden by {rnu:.2e}")
    check(rpts <= BAR_DPOINTS,
          f"implicit ||dCD/dpoints|| off golden by {rpts:.2e}")
    check_counts(counts, "golden implicit", ADJOINT_KERNELS)


def phase_golden_cavity(torch, dk, make_solver, box):
    """Phase 4e: golden cavity_simple on the card (f64, dense layout)."""
    with open(os.path.join(HERE, "tests", "golden", "values.json")) as fh:
        want = json.load(fh)["cavity_simple"]
    pts, topo = box(10, 10, 1, (0.1, 0.1, 0.01),
                    kinds={"zmin": "empty", "zmax": "empty", "xmin": "wall",
                           "xmax": "wall", "ymin": "wall", "ymax": "wall"})
    s = make_solver(cavity_options(), topo, pts, device=DEVICE,
                    dtype=torch.float64)
    check(s.topo.dia_dense() is not None, "cavity runs dense-DIA")
    x = s.make_inputs()
    dk.reset_counts()
    t0 = time.perf_counter()
    w, info = s.run_primal(s.init_state(), x)
    lid = float(s.run_function("lidForce", w, x))
    psi, ainfo = s.run_adjoint("lidForce", w, x)
    tot = s.run_totals("lidForce", w, x, psi)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(dk.COUNTS)
    got = {"lidForce": lid, "dLidForce_dnu": float(tot["params"]["nu"]),
           "dLidForce_dUlid_x": float(tot["bc"]["U"]["ymax"][0]),
           "dLidForce_dpoints_norm": float(torch.linalg.norm(tot["points"]))}
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
    say(f"[cavity] 10x10 f64 dense: primal {info.iters} iters (max_res "
        f"{info.max_res:.3e}); adjoint {ainfo.iters} FGMRES iters, resid "
        f"{ainfo.resid0:.3e} -> {ainfo.resid:.3e}; {dt:.1f} s in all; "
        + ", ".join(f"{k} {got[k]!r} (rel {rel[k]:.2e})" for k in want)
        + f"; launch counts {counts}")
    check(info.converged and not info.failed, f"cavity primal: {info}")
    check(ainfo.converged, f"cavity adjoint: {ainfo}")
    for k, r in rel.items():
        check(r <= (1e-8 if k == "lidForce" else 1e-6),
              f"cavity {k} off golden by {r:.2e}")
    check_counts(counts, "golden cavity",
                 PRIMAL_KERNELS + ("dia_matvec_t", "dia_matvec_multi_t"))


def _golden_want(name):
    with open(os.path.join(HERE, "tests", "golden", "values.json")) as fh:
        return json.load(fh)[name]


def _hold_golden(tag, got, want, floor=0.0):
    """Objectives at rel 1e-8, totals (keys d...) at 1e-6, each times
    max(floor, |golden|) (floor 1: tests/test_golden.py's bar); a
    summary."""
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
    for k, r in rel.items():
        bar = 1e-6 if k.startswith("d") else 1e-8
        check(abs(got[k] - want[k]) <= bar * max(floor, abs(want[k])),
              f"{tag} {k} off golden by {r:.2e}")
    return ", ".join(f"{k} {got[k]!r} (rel {rel[k]:.2e})" for k in want)


def _golden_run(torch, dk, s, x, func):
    """Primal, objective(s), adjoint and totals of a golden case from
    zero counts: (state, info, adjoint info, totals, seconds, counts)."""
    dk.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, info = s.run_primal(s.init_state(), x)
    psi, ainfo = s.run_adjoint(func, w, x)
    tot = s.run_totals(func, w, x, psi)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(info.converged and not info.failed, f"{func} primal: {info}")
    check(ainfo.converged, f"{func} adjoint: {ainfo}")
    return w, info, ainfo, tot, dt, dict(dk.COUNTS)


def phase_golden_scalar(torch, dk, make_solver, box):
    """Phase 4f: golden scalar_transport (8x6 box, f64, dense layout)."""
    pts, topo = box(8, 6, 1, (1.0, 1.0, 0.1),
                    kinds={"zmin": "empty", "zmax": "empty"})
    s = make_solver(scalar_transport_options(), topo, pts, device=DEVICE,
                    dtype=torch.float64)
    check(s.topo.dia_dense() is not None, "scalar_transport runs dense")
    x = s.make_inputs()
    x["params"]["U"] = torch.tensor([1.0, 0.2, 0.0], dtype=torch.float64,
                                    device=s.device).repeat(s.topo.n_cells,
                                                            1)
    w, info, ainfo, tot, dt, counts = _golden_run(torch, dk, s, x, "TMean")
    got = {"TMean": float(s.run_function("TMean", w, x)),
           "dTMean_dDT": float(tot["params"]["DT"]),
           "dTMean_dTin": float(tot["bc"]["T"]["xmin"]),
           "dTMean_dpoints_norm": float(torch.linalg.norm(tot["points"]))}
    msg = _hold_golden("scalar_transport", got,
                       _golden_want("scalar_transport"))
    say(f"[scalar] 8x6 f64 dense: primal {info.iters} Picard iterations; "
        f"adjoint {ainfo.iters} FGMRES iters (segregated PC), resid "
        f"{ainfo.resid0:.3e} -> {ainfo.resid:.3e}; {dt:.1f} s in all; {msg}"
        f"; launch counts {counts}")
    check_counts(counts, "golden scalar_transport",
                 ("dia_matvec", "dia_matvec_t"))
    return counts


def phase_golden_heat(torch, dk, make_solver, box):
    """Phase 4g: golden heat_radiation (10x6 box, conduction + P1
    radiation, the coupled T-G system, no PC; f64, dense layout)."""
    pts, topo = box(10, 6, 1, (1.0, 0.5, 0.05),
                    kinds={"zmin": "empty", "zmax": "empty"})
    s = make_solver(heat_radiation_options(), topo, pts, device=DEVICE,
                    dtype=torch.float64)
    check(s.topo.dia_dense() is not None, "heat_radiation runs dense")
    x = s.make_inputs()
    x["params"]["radiationAbsorptivity"] = torch.tensor(
        0.5, dtype=torch.float64, device=s.device)
    w, info, ainfo, tot, dt, counts = _golden_run(torch, dk, s, x, "Tm")
    got = {"Tm": float(s.run_function("Tm", w, x)),
           "dTm_dAbsorptivity": float(
               tot["params"]["radiationAbsorptivity"]),
           "dTm_dkappa": float(tot["params"]["kappa"])}
    msg = _hold_golden("heat_radiation", got, _golden_want("heat_radiation"))
    say(f"[heat] 10x6 f64 dense: primal {info.iters} iterations (T CG, G "
        f"BiCGStab); adjoint {ainfo.iters} GMRES iters, resid "
        f"{ainfo.resid0:.3e} -> {ainfo.resid:.3e}; {dt:.1f} s in all; {msg}"
        f"; launch counts {counts}")
    check_counts(counts, "golden heat_radiation", ("dia_matvec",))
    return counts


def phase_golden_rho(torch, dk, make_solver, box):
    """Phase 4h: golden rho_channel (16x8 compressible heated channel,
    segregated PC; f64, dense layout)."""
    pts, topo = box(16, 8, 1, (1.0, 0.1, 0.01),
                    kinds={"zmin": "empty", "zmax": "empty",
                           "ymin": "wall", "ymax": "wall"})
    s = make_solver(rho_channel_options(), topo, pts, device=DEVICE,
                    dtype=torch.float64)
    check(s.topo.dia_dense() is not None, "rho_channel runs dense")
    x = s.make_inputs()
    w, info, ainfo, tot, dt, counts = _golden_run(torch, dk, s, x, "Tout")
    got = {"Tout": float(s.run_function("Tout", w, x)),
           "mdot": float(s.run_function("mdot", w, x)),
           "dTout_dTwall": float(tot["bc"]["T"]["ymin"]),
           "dTout_dpoints_norm": float(torch.linalg.norm(tot["points"]))}
    msg = _hold_golden("rho_channel", got, _golden_want("rho_channel"))
    say(f"[rho-golden] 16x8 f64 dense: primal {info.iters} SIMPLE "
        f"iterations (max_res {info.max_res:.3e}); adjoint {ainfo.iters} "
        f"FGMRES iters, resid {ainfo.resid0:.3e} -> {ainfo.resid:.3e}; "
        f"{dt:.1f} s in all; {msg}; launch counts {counts}")
    check_counts(counts, "golden rho_channel",
                 PRIMAL_KERNELS + ("dia_matvec_t", "dia_matvec_multi_t"))
    return counts


def setup_full(torch, make_solver, omesh):
    t0 = time.perf_counter()
    pts, topo = omesh(n_wrap=FULL, n_radial=FULL, radius=15.0,
                      first_cell=4e-3)
    s = make_solver(bench_adjoint_options(), topo, pts, device=DEVICE,
                    dtype=torch.float32)
    inputs = s.make_inputs()
    st0 = s.init_state()
    torch.cuda.synchronize()
    say(f"[full] {FULL}x{FULL} set-up (mesh, dense layout, geometry, wall "
        f"distance) {time.perf_counter() - t0:.1f} s; {s.topo.n_cells} "
        f"cells, offsets {s.topo.dia_dense()[0]}")
    return s, inputs, st0


def run_full(torch, dk, s, inputs, st0):
    """The main path: ITERS SIMPLE iterations in one run_primal call. One
    step from the same state, before the counts are reset, gives the first
    iteration's residual."""
    with torch.no_grad():
        res1 = float(s.primal_step(st0, inputs)[1])
    dk.reset_counts()
    s.solve_stats.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, info = s.run_primal(st0, inputs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(dk.COUNTS)
    cd = float(s.run_function("CD", st, inputs))
    return st, res1, info, dt, counts, cd


def phase_profile(torch, s, inputs, st):
    from torch.profiler import ProfilerActivity, profile
    s.option.set("primalMinIters", 1)
    s.option.set("primalMaxIters", 1)
    s.run_primal(st, inputs)                 # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run_primal(st, inputs)                 # unprofiled wall time
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s.run_primal(st, inputs)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    key = "self_device_time_total" \
        if hasattr(ka[0], "self_device_time_total") else "self_cuda_time_total"
    say("[profile] one SIMPLE iteration, top 10 by device time:")
    say(ka.table(sort_by=key, row_limit=10, max_name_column_width=48))
    kernels = _kernel_events(prof)
    dia = [e for e in kernels if "dia_matvec" in e.name]
    syncs = sum(1 for e in prof.events()
                if e.name == "aten::_local_scalar_dense")
    busy_ms = sum(_event_us(e) for e in kernels) / 1e3
    say(f"[profile] {len(kernels)} device kernels ({len(dia)} DIA matvecs, "
        f"{sum(_event_us(e) for e in dia) / 1e3:.3f} ms), host syncs "
        f"(item/bool reads) {syncs}, device busy {busy_ms:.2f} ms of "
        f"{wall * 1e3:.2f} ms wall")


def phase_adjoint(torch, dk, adjsolver, s, inputs, st, tag="adjoint"):
    """Phase 6 (and 8's adjoint), the adjoint's main path: one
    solve_adjoint call (one restart cycle) and one total_derivative from
    the 300-iteration state. Returns the launch counts of the solve."""
    restart = s.option["adjEqnOption"]["gmresRestart"]
    state = {k: v.detach() for k, v in st.items()}
    dk.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psibar, ainfo = s.solve_adjoint(state, inputs, "CD")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(dk.COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2**20
    # products: the initial residual, one true residual per restart cycle
    # and one per Arnoldi step
    products = ainfo.iters + math.ceil(ainfo.iters / restart) + 1
    per = {k: counts[k] / products for k in REVERSE}
    say(f"[{tag}] {FULL}x{FULL} f32 fixed-point adjoint: {ainfo.iters} "
        f"GMRES iters ({products} (I - dG^T) products) in {dt:.2f} s = "
        f"{dt / products * 1e3:.1f} ms per product; resid0 "
        f"{ainfo.resid0:.6e} -> resid {ainfo.resid:.6e}; peak device "
        f"memory {peak:.0f} MiB")
    say(f"[{tag}] K3 launches per product: " + ", ".join(
        f"{k} {v:.2f}" for k, v in per.items()) + f"; forward K1 "
        f"{counts['dia_matvec']}, K2 {counts['dia_matvec_multi']} (one "
        "recorded step map)")
    say(f"[{tag}] launch counts {counts}")

    # one product alone, on the recorded graph
    step = s._fp_step_fn()
    _, f_vjp = adjsolver.vjp(lambda w: step(w, inputs)[0], state)
    f_vjp(psibar)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        f_vjp(psibar)
    torch.cuda.synchronize()
    one = (time.perf_counter() - t0) / 5
    say(f"[{tag}] one dG^T v product alone: {one * 1e3:.1f} ms (host "
        "clock, mean of 5)")

    t0 = time.perf_counter()
    tot = s.total_derivative(state, inputs, "CD", psibar)
    torch.cuda.synchronize()
    dnu = float(tot["params"]["nu"])
    dpts = float(torch.linalg.norm(tot["points"]))
    say(f"[{tag}] total_derivative {time.perf_counter() - t0:.2f} s: "
        f"dCD/dnu {dnu!r}, ||dCD/dpoints|| {dpts!r}")
    check(all(bool(torch.isfinite(v).all()) for v in psibar.values()),
          "psibar is not finite")
    check(math.isfinite(dnu) and math.isfinite(dpts), "totals not finite")
    check(ainfo.resid < ainfo.resid0,
          f"adjoint residual did not fall: {ainfo}")
    check_counts(counts, f"full-width {tag}", ADJOINT_KERNELS)
    return counts, f_vjp, psibar


def phase_pc_primal(torch, dk, s, inputs, st, pc, tag, line_p=None):
    """Phases 5b/5c: PC_ITERS SIMPLE iterations from phase 5's state with
    the line (5b) or multigrid (5c) preconditioner on the pressure.
    Returns the launch counts and the BiCGStab iterations per p solve."""
    iters = PC_ITERS
    lin = dict(s.option["primalLinearSolver"], pPC=pc)
    s.solve_stats.clear()
    with overridden(s.option, primalLinearSolver=lin, primalMinIters=iters,
                    primalMaxIters=iters):
        dk.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st2, info = s.run_primal(st, inputs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(dk.COUNTS)
    per = {k: v[1] / v[0] for k, v in s.solve_stats.items()}
    line = "" if line_p is None else \
        f", the line PC's {line_p:.2f} in phase 5b"
    say(f"[{tag}] {FULL}x{FULL} f32, pPC {pc}: {iters} SIMPLE iterations in "
        f"{dt:.2f} s = {dt / iters * 1e3:.2f} ms/iter; max_res "
        f"{info.max_res:.4e}; Krylov iterations per solve: "
        + ", ".join(f"{k} {v:.2f}" for k, v in per.items())
        + f" (p against Jacobi-CG's cap of "
        f"{s.option['primalLinearSolver']['pMaxIters']}{line}); launch "
        f"counts {counts}")
    check(info.iters == iters and s.states_valid(st2) and not info.failed,
          f"{pc}-PC primal: {info}")
    check_counts(counts, f"{pc}-PC primal")
    return counts, per["p"]


def _fp_cycle(torch, dk, s, inputs, state, **adj):
    """One solve_adjoint call of the fixed-point adjoint with adjEqnOption
    items overridden: (psibar, info, seconds, products, peak MiB,
    counts)."""
    opt = dict(s.option["adjEqnOption"], **adj)
    with overridden(s.option, adjEqnOption=opt):
        dk.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        psibar, ainfo = s.solve_adjoint(state, inputs, "CD")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    products = ainfo.iters + math.ceil(ainfo.iters / opt["gmresRestart"]) \
        + 1
    return (psibar, ainfo, dt, products,
            torch.cuda.max_memory_allocated() / 2**20, dict(dk.COUNTS))


def phase_remat(torch, dk, s, inputs, st):
    """Phase 6c: 20 fixed-point GMRES iterations with and without fpRemat.
    Returns the launch counts of the fpRemat run."""
    state = {k: v.detach() for k, v in st.items()}
    out = {}
    for remat in (False, True):
        psibar, ainfo, dt, products, peak, counts = _fp_cycle(
            torch, dk, s, inputs, state, fpRemat=remat, fpMaxIters=20,
            gmresRestart=20)
        say(f"[remat] {FULL}x{FULL} f32 fpRemat {remat}: {ainfo.iters} GMRES"
            f" iters, {products} products in {dt:.2f} s = "
            f"{dt / products * 1e3:.1f} ms per product; resid "
            f"{ainfo.resid0:.6e} -> {ainfo.resid:.6e}; peak device memory "
            f"{peak:.0f} MiB; launch counts {counts}")
        check(all(bool(torch.isfinite(v).all()) for v in psibar.values()),
              f"fpRemat {remat}: psibar is not finite")
        check_counts(counts, f"fpRemat {remat}", ADJOINT_KERNELS)
        out[remat] = (psibar, counts)
    a, b = out[True][0], out[False][0]
    rel = max(float((a[k] - b[k]).abs().max())
              / max(float(b[k].abs().max()), 1e-30) for k in b)
    say(f"[remat] psibar with and without fpRemat: max rel difference "
        f"{rel:.3e} (bar 1e-5)")
    check(rel <= 1e-5, f"fpRemat psibar differs by {rel:.3e}")
    return out[True][1]


def phase_krylov_smoother(torch, dk, s, inputs, st):
    """Phase 6d: one 30-iteration fixed-point cycle with the "krylov"
    step-map smoother. Returns the launch counts."""
    state = {k: v.detach() for k, v in st.items()}
    psibar, ainfo, dt, products, peak, counts = _fp_cycle(
        torch, dk, s, inputs, state, fpInnerSmoother="krylov",
        fpMaxIters=30, gmresRestart=30)
    say(f"[krylov] {FULL}x{FULL} f32 fpInnerSmoother krylov: {ainfo.iters} "
        f"GMRES iters, {products} products in {dt:.2f} s = "
        f"{dt / products * 1e3:.1f} ms per product; resid "
        f"{ainfo.resid0:.6e} -> {ainfo.resid:.6e}; peak device memory "
        f"{peak:.0f} MiB; launch counts {counts}")
    check(all(bool(torch.isfinite(v).all()) for v in psibar.values()),
          "krylov smoother: psibar is not finite")
    check(math.isfinite(ainfo.resid), f"krylov smoother: {ainfo}")
    check_counts(counts, "krylov smoother", ADJOINT_KERNELS)
    return counts


def phase_turb_full(torch, dk, adjsolver, make_solver, s0):
    """Phase 8: kOmegaSST at full width, primal then fixed-point adjoint.
    Returns (primal counts, adjoint counts)."""
    d1 = float(s0.wall_dist.min())
    t0 = time.perf_counter()
    s = make_solver(turb_options("kOmegaSST", d1, adjoint=True), s0.topo,
                    s0.points.cpu().numpy(), device=DEVICE,
                    dtype=torch.float32)
    inputs = s.make_inputs()
    st0 = s.init_state()
    torch.cuda.synchronize()
    say(f"[sst] set-up {time.perf_counter() - t0:.1f} s; d1 {d1:.4e}, wall "
        f"omega {10.0 * 6.0 * NU / (BETA1 * d1 ** 2):.4e}")
    st, res1, info, dt, counts, cd = run_full(torch, dk, s, inputs, st0)
    per = {k: v[1] / ITERS for k, v in s.solve_stats.items()}
    say(f"[sst] {FULL}x{FULL} f32 kOmegaSST: {ITERS} SIMPLE iterations in "
        f"{dt:.2f} s = {dt / ITERS * 1e3:.2f} ms/iter; max_res first "
        f"{res1:.4e} final {info.max_res:.4e}; CD {cd!r}; Krylov "
        "iterations per SIMPLE iteration: "
        + ", ".join(f"{k} {v:.2f}" for k, v in per.items())
        + f"; k in [{float(st['k'].min()):.3e}, {float(st['k'].max()):.3e}]"
        f", omega in [{float(st['omega'].min()):.3e}, "
        f"{float(st['omega'].max()):.3e}]; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    say(f"[sst] launch counts {counts}")
    check(info.iters == ITERS, "kOmegaSST iteration count")
    check(s.states_valid(st), "kOmegaSST state is not finite/valid")
    check(not info.failed, f"kOmegaSST primal failed: {info}")
    check(info.max_res < res1,
          f"kOmegaSST max_res did not fall: {res1} -> {info.max_res}")
    check(math.isfinite(cd), f"kOmegaSST CD not finite: {cd}")
    check_counts(counts, "kOmegaSST full width")
    adj_counts, _, _ = phase_adjoint(torch, dk, adjsolver, s, inputs, st,
                                     tag="sst-adjoint")
    return counts, adj_counts


def phase_turb_models(torch, dk, make_solver, s0):
    """Phase 8b: 20 SIMPLE iterations at full width per model. Returns
    {model: launch counts}."""
    d1 = float(s0.wall_dist.min())
    iters = 20
    out = {}
    for model in ("kEpsilon", "kOmega", "kOmegaSSTLM", "SpalartAllmaras"):
        opts = turb_options(model, d1)
        opts.update(primalMinIters=iters, primalMaxIters=iters)
        t0 = time.perf_counter()
        s = make_solver(opts, s0.topo, s0.points.cpu().numpy(),
                        device=DEVICE, dtype=torch.float32)
        inputs = s.make_inputs()
        st0 = s.init_state()
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        dk.reset_counts()
        s.solve_stats.clear()
        t0 = time.perf_counter()
        st, info = s.run_primal(st0, inputs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(dk.COUNTS)
        cd = float(s.run_function("CD", st, inputs))
        name = model + (" + Spalding" if model == "SpalartAllmaras" else "")
        say(f"[models] {FULL}x{FULL} f32 {name}: set-up {setup:.1f} s; "
            f"{iters} SIMPLE iterations in {dt:.2f} s = "
            f"{dt / iters * 1e3:.2f} ms/iter; max_res {info.max_res:.4e}; "
            f"CD {cd!r}; Krylov iterations per solve: "
            + ", ".join(f"{k} {v[1] / v[0]:.2f}"
                        for k, v in s.solve_stats.items())
            + f"; launch counts {counts}")
        check(info.iters == iters and s.states_valid(st) and not info.failed,
              f"{name} primal: {info}")
        check(math.isfinite(cd), f"{name} CD not finite: {cd}")
        check_counts(counts, f"{name} full width")
        out[model] = counts
    return out


def phase_residual_full(torch, dk, s, inputs, st):
    """Phase 6b: one 60-iteration FGMRES cycle of the residual-form adjoint
    per pcType from phase 5's state, each followed by the totals. Returns
    {pcType: launch counts of the solve}."""
    state = {k: v.detach() for k, v in st.items()}
    out = {}
    for pc_type in ("segregated", "coupledLine"):
        adj = dict(s.option["adjEqnOption"], pcType=pc_type,
                   gmresRestart=60, gmresMaxIters=60, gmresDeflate=0)
        with overridden(s.option, adjEqnSolMethod="Krylov",
                        adjEqnOption=adj):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pc = s.make_adjoint_pc(state, inputs)
            torch.cuda.synchronize()
            build_ms = (time.perf_counter() - t0) * 1e3
            dk.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            psi, ainfo = s.solve_adjoint(state, inputs, "CD", precond=pc)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = dict(dk.COUNTS)
            peak = torch.cuda.max_memory_allocated() / 2**20
            t0 = time.perf_counter()
            tot = s.total_derivative(state, inputs, "CD", psi)
            torch.cuda.synchronize()
            tt = time.perf_counter() - t0
        n = max(ainfo.iters, 1)
        dnu = float(tot["params"]["nu"])
        dpts = float(torch.linalg.norm(tot["points"]))
        say(f"[residual] {FULL}x{FULL} f32 {pc_type}: PC built in "
            f"{build_ms:.1f} ms; {ainfo.iters} FGMRES iters in {dt:.2f} s = "
            f"{dt / n * 1e3:.1f} ms per preconditioned iteration (dJ/dW and "
            f"the residual graph's recording included); resid0 "
            f"{ainfo.resid0:.6e} -> resid {ainfo.resid:.6e}; peak device "
            f"memory {peak:.0f} MiB; total_derivative {tt:.2f} s: dCD/dnu "
            f"{dnu!r}, ||dCD/dpoints|| {dpts!r}")
        say(f"[residual] {pc_type} launches per iteration: " + ", ".join(
            f"{k} {counts[k] / n:.2f}" for k in KERNELS)
            + f"; launch counts {counts}")
        check(all(bool(torch.isfinite(v).all()) for v in psi.values()),
              f"{pc_type}: psi is not finite")
        check(math.isfinite(dnu) and math.isfinite(dpts),
              f"{pc_type}: totals not finite")
        check(ainfo.iters == 60, f"{pc_type}: {ainfo}")
        check_counts(counts, f"full-width residual {pc_type}",
                     ("dia_matvec_t", "dia_matvec_multi_t"))
        out[pc_type] = counts
    return out


def phase_rho_full(torch, dk, make_solver, s0):
    """Phase 9: DARhoSimpleFoam + SA on the 512x512 O-mesh (f32, dense),
    ITERS SIMPLE iterations, then one 60-iteration residual-form FGMRES
    cycle (segregated PC) and the totals. Returns (solver, inputs, state,
    primal counts, adjoint counts)."""
    t0 = time.perf_counter()
    s = make_solver(rho_options(), s0.topo, s0.points.cpu().numpy(),
                    device=DEVICE, dtype=torch.float32)
    inputs = s.make_inputs()
    st0 = s.init_state()
    torch.cuda.synchronize()
    say(f"[rho] {FULL}x{FULL} DARhoSimpleFoam + SA, Mach 0.5 (U_inf "
        f"{U_INF:.4f} m/s), Re_c 1000 (mu {MU_INF:.6f} Pa s), rho "
        f"relaxation {RHO_RELAX}: set-up {time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        res1 = float(s._one_iter(st0, inputs, s.geometry(inputs),
                                 s.rho_of(st0, inputs), False)[2])
    dk.reset_counts()
    s.solve_stats.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, info = s.run_primal(st0, inputs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(dk.COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2**20
    cd = float(s.run_function("CD", st, inputs))
    with torch.no_grad():
        rho = s.rho_of(st, inputs)
        mach = torch.linalg.norm(st["U"], dim=-1) \
            / torch.sqrt(GAMMA * R_GAS * st["T"])
    per = {k: v[1] / ITERS for k, v in s.solve_stats.items()}
    say(f"[rho] {ITERS} SIMPLE iterations in {dt:.2f} s = "
        f"{dt / ITERS * 1e3:.2f} ms/iter; max_res first {res1:.4e} final "
        f"{info.max_res:.4e}; CD {cd!r} N/m; rho in "
        f"[{float(rho.min()):.4f}, {float(rho.max()):.4f}], Mach in "
        f"[{float(mach.min()):.4f}, {float(mach.max()):.4f}], T in "
        f"[{float(st['T'].min()):.2f}, {float(st['T'].max()):.2f}]; Krylov "
        "iterations per SIMPLE iteration: "
        + ", ".join(f"{k} {v:.2f}" for k, v in per.items())
        + f"; peak device memory {peak:.0f} MiB")
    say(f"[rho] launch counts {counts}")
    check(info.iters == ITERS, "compressible iteration count")
    check(s.states_valid(st), "compressible state is not finite/valid")
    check(not info.failed, f"compressible primal failed: {info}")
    check(info.max_res < res1,
          f"compressible max_res did not fall: {res1} -> {info.max_res}")
    check(math.isfinite(cd), f"compressible CD not finite: {cd}")
    check_counts(counts, "compressible full width")

    state = {k: v.detach() for k, v in st.items()}
    dk.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psi, ainfo = s.solve_adjoint(state, inputs, "CD")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    adj = dict(dk.COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2**20
    t0 = time.perf_counter()
    tot = s.total_derivative(state, inputs, "CD", psi)
    torch.cuda.synchronize()
    tt = time.perf_counter() - t0
    n = max(ainfo.iters, 1)
    dmu = float(tot["params"]["mu"])
    dpts = float(torch.linalg.norm(tot["points"]))
    dtin = float(tot["bc"]["T"]["far"])
    say(f"[rho-adjoint] {ainfo.iters} FGMRES iters (segregated PC, restart "
        f"60) in {dt:.2f} s = {dt / n * 1e3:.1f} ms per preconditioned "
        f"iteration (dJ/dW, the PC build and the residual graph's "
        f"recording included); resid0 {ainfo.resid0:.6e} -> resid "
        f"{ainfo.resid:.6e}; peak device memory {peak:.0f} MiB; "
        f"total_derivative {tt:.2f} s: dCD/dmu {dmu!r}, dCD/dT_far "
        f"{dtin!r}, ||dCD/dpoints|| {dpts!r}")
    say("[rho-adjoint] launches per iteration: " + ", ".join(
        f"{k} {adj[k] / n:.2f}" for k in KERNELS) + f"; launch counts {adj}")
    check(all(bool(torch.isfinite(v).all()) for v in psi.values()),
          "compressible psi is not finite")
    check(all(math.isfinite(v) for v in (dmu, dpts, dtin)),
          "compressible totals not finite")
    check(ainfo.iters == 60, f"compressible adjoint: {ainfo}")
    check_counts(adj, "compressible adjoint",
                 ("dia_matvec_t", "dia_matvec_multi_t"))
    return s, inputs, st, counts, adj


def phase_rho_transonic(torch, dk, adjsolver, make_solver, s9, st9):
    """Phase 9b: 20 DARhoSimpleCFoam iterations from phase 9's state (no
    subsonic warm start): the p equation is non-symmetric and goes to
    BiCGStab; then one vjp of the normalized residuals. Returns the
    primal's counts."""
    iters = 20
    s = make_solver(rho_options(solverName="DARhoSimpleCFoam",
                                transonicInitMaxIters=0,
                                primalMinIters=iters, primalMaxIters=iters),
                    s9.topo, s9.points.cpu().numpy(), device=DEVICE,
                    dtype=torch.float32)
    inputs = s.make_inputs()
    dk.reset_counts()
    s.solve_stats.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, info = s.run_primal(st9, inputs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(dk.COUNTS)
    cd = float(s.run_function("CD", st, inputs))
    per = {k: v[1] / v[0] for k, v in s.solve_stats.items()}
    say(f"[rhoC] {FULL}x{FULL} f32 DARhoSimpleCFoam: {iters} SIMPLE "
        f"iterations in {dt:.2f} s = {dt / iters * 1e3:.2f} ms/iter; max_res "
        f"{info.max_res:.4e}; CD {cd!r}; p solved as symmetric: "
        f"{s.last_p_symmetric} ({s.solve_stats['p'][0]} BiCGStab solves); "
        "Krylov iterations per solve: "
        + ", ".join(f"{k} {v:.2f}" for k, v in per.items())
        + f"; launch counts {counts}")
    check(info.iters == iters and s.states_valid(st) and not info.failed,
          f"transonic primal: {info}")
    check(s.last_p_symmetric is False and s.solve_stats["p"][0] == iters,
          "the transonic p equation was not solved as non-symmetric")
    check(math.isfinite(cd), f"transonic CD not finite: {cd}")
    check_counts(counts, "transonic primal")

    state = {k: v.detach() for k, v in st.items()}
    gen = torch.Generator(device=s.device).manual_seed(5)
    v = {k: torch.randn(t.shape, generator=gen, device=s.device,
                        dtype=t.dtype) for k, t in state.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, f_vjp = adjsolver.vjp(lambda w: s._norm_residuals(w, inputs), state)
    g = f_vjp(v)
    torch.cuda.synchronize()
    say(f"[rhoC] one vjp of the normalized residuals (recording "
        f"included): {(time.perf_counter() - t0) * 1e3:.1f} ms; |vjp| max "
        + ", ".join(f"{k} {float(t.abs().max()):.3e}" for k, t in g.items()))
    check(all(bool(torch.isfinite(t).all()) for t in g.values()),
          "transonic residual vjp is not finite")
    return counts


def phase_golden_pimple(torch, dk, make_solver, box):
    """Phase 4i: golden pimple_unsteady (8x8 cavity, 5 Euler steps, timeOp
    average; f64, dense layout): the history, lidF_avg and the reverse
    sweep's totals against tests/golden/values.json with
    tests/test_golden.py's bars (rel 1e-8 / 1e-6 x max(1, |golden|))."""
    pts, topo = box(8, 8, 1, (0.1, 0.1, 0.01),
                    kinds={"zmin": "empty", "zmax": "empty", "xmin": "wall",
                           "xmax": "wall", "ymin": "wall", "ymax": "wall"})
    s = make_solver(pimple_cavity_options(), topo, pts, device=DEVICE,
                    dtype=torch.float64)
    check(s.topo.dia_dense() is not None, "pimple golden runs dense")
    x = s.make_inputs()
    dk.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        _, hist = s.solve_primal_history(s.init_state(), x)
        J, _ = s.eval_function_history("lidF", hist, x)
    tot, resids = s.solve_unsteady_adjoint(hist, x, "lidF")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(dk.COUNTS)
    got = {"lidF_avg": float(J), "dlidF_dnu": float(tot["params"]["nu"]),
           "dlidF_dpoints_norm": float(torch.linalg.norm(tot["points"]))}
    msg = _hold_golden("pimple_unsteady", got,
                       _golden_want("pimple_unsteady"), floor=1.0)
    adj = s.solve_stats["adjoint"]
    say(f"[pimple-golden] 8x8 f64 dense: {s.n_steps} steps x "
        f"{s.n_outer} outer correctors (U {s.solve_stats['U'][1]} and p "
        f"{s.solve_stats['p'][1]} Krylov iterations); reverse sweep "
        f"{adj[1]} FGMRES iterations over {adj[0]} steps (segregated PC), "
        f"resids max {float(resids.max()):.3e}; {dt:.1f} s in all; {msg}; "
        f"launch counts {counts}")
    check(float(resids.max()) < 1e-9,
          f"pimple golden sweep resids {resids.tolist()}")
    check_counts(counts, "golden pimple_unsteady",
                 PRIMAL_KERNELS + ("dia_matvec_t", "dia_matvec_multi_t"))
    return counts


def phase_hisa_full(torch, dk, make_solver, box):
    """Phase 10: DAHisaFoam on the 1024x256 transonic bump (f32, dense):
    HISA_LF laxFriedrichs and HISA_AUSM AUSMPlusUp PTC iterations, then
    one HISA_ADJ-iteration adjoint FGMRES cycle for CDp with the
    transposed block PC, and the totals. No banded matvec runs here.
    Returns (primal counts, adjoint counts)."""
    t0 = time.perf_counter()
    pts, topo = bump_channel(box, HISA_NX, HISA_NY)
    s = make_solver(hisa_options(), topo, pts, device=DEVICE,
                    dtype=torch.float32)
    check(s.topo.dia_dense() is not None, "the bump runs dense")
    x = s.make_inputs()
    st0 = s.init_state()
    geom = s.geometry(x)
    torch.cuda.synchronize()
    say(f"[hisa] {HISA_NX}x{HISA_NY} bump channel, Mach {HISA_MACH} "
        f"(U_in {HISA_UIN:.4f} m/s), inviscid AUSMPlusUp: set-up "
        f"{time.perf_counter() - t0:.1f} s; {s.topo.n_cells} cells")

    def block_inverse_error(state, cfl):
        """max over cells of max|I - D D^-1| of the block PC's diagonal."""
        with torch.no_grad():
            D = s._block_jac(state, x, geom, s._inv_dtau(state, x, geom,
                                                          cfl))[2]
            eye = torch.eye(5, dtype=D.dtype, device=D.device)
            return float((eye - D @ torch.linalg.inv(D)).abs().max())

    err0 = block_inverse_error(st0, 5.0)
    dk.reset_counts()
    s.solve_stats.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, info = s.run_primal(st0, x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(dk.COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2**20
    n_ptc, n_gmres = s.solve_stats["ptc_gmres"]
    with torch.no_grad():
        mach = torch.linalg.norm(st["U"], dim=-1) \
            / torch.sqrt(GAMMA * R_GAS * st["T"])
    err1 = block_inverse_error(st, s.last_cfl)
    say(f"[hisa] {info.iters} PTC iterations ({HISA_LF} laxFriedrichs, "
        f"{HISA_AUSM} AUSMPlusUp) in {dt:.2f} s = {dt / n_ptc * 1e3:.1f} ms "
        f"per PTC iteration; res / res0 {info.max_res:.4e}; final CFL "
        f"{s.last_cfl:.4g}; GMRES {n_gmres / n_ptc:.1f} iterations per "
        f"Newton step (cap {HISA_INNER}); Mach in [{float(mach.min()):.4f},"
        f" {float(mach.max()):.4f}]; p in [{float(st['p'].min()):.1f}, "
        f"{float(st['p'].max()):.1f}]; largest |I - D D^-1| of the 5x5 "
        f"block inverse {err0:.3e} (start, CFL 5), {err1:.3e} (end); peak "
        f"device memory {peak:.0f} MiB")
    check(info.iters == HISA_LF + HISA_AUSM, f"hisa iterations: {info}")
    check(s.states_valid(st), "hisa state is not finite/valid")
    check(float(mach.max()) > HISA_MACH,
          f"no acceleration over the bump: max Mach {float(mach.max())}")
    check(sum(counts.values()) == 0, f"hisa primal launched {counts}")

    state = {k: v.detach() for k, v in st.items()}
    dk.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psi, ainfo = s.solve_adjoint(state, x, "CDp")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    t0 = time.perf_counter()
    tot = s.total_derivative(state, x, "CDp", psi)
    torch.cuda.synchronize()
    tt = time.perf_counter() - t0
    adj = dict(dk.COUNTS)
    n = max(ainfo.iters, 1)
    duin = float(tot["bc"]["U"]["xmin"][0])
    dpts = float(torch.linalg.norm(tot["points"]))
    say(f"[hisa-adjoint] {ainfo.iters} FGMRES iterations (transposed "
        f"block PC, 12 sweeps) in {dt:.2f} s = {dt / n * 1e3:.1f} ms per "
        f"iteration (the PC build and the residual graph's recording "
        f"included); resid0 {ainfo.resid0:.6e} -> resid {ainfo.resid:.6e};"
        f" peak device memory {peak:.0f} MiB; total_derivative {tt:.2f} s:"
        f" dCDp/dU_in {duin!r}, ||dCDp/dpoints|| {dpts!r}")
    check(all(bool(torch.isfinite(v).all()) for v in psi.values()),
          "hisa psi is not finite")
    check(math.isfinite(duin) and math.isfinite(dpts),
          "hisa totals not finite")
    check(ainfo.iters == HISA_ADJ, f"hisa adjoint: {ainfo}")
    check(sum(adj.values()) == 0, f"hisa adjoint launched {adj}")
    return counts, adj, (s, x, state)


def phase_pimple_full(torch, dk, make_solver, box):
    """Phase 11: DAPimpleFoam on the 512x512 cavity at Re 1000 (f32,
    dense), PIMPLE_STEPS Euler steps, then the in-memory reverse sweep
    and the checkpointed one (seg_len PIMPLE_SEG) from the same inputs;
    their totals must agree at rel 1e-4. Returns the launch counts of
    (primal, in-memory sweep, checkpointed sweep) and (solver, inputs, the
    history's last two states) for --profile."""
    from dafoam_tpu_torch.utils import tree
    t0 = time.perf_counter()
    pts, topo = box(FULL, FULL, 1, (0.1, 0.1, 0.01),
                    kinds={"zmin": "empty", "zmax": "empty", "xmin": "wall",
                           "xmax": "wall", "ymin": "wall", "ymax": "wall"})
    s = make_solver(pimple_full_options(), topo, pts, device=DEVICE,
                    dtype=torch.float32)
    x = s.make_inputs()
    st0 = s.init_state()
    torch.cuda.synchronize()
    say(f"[pimple] {FULL}x{FULL} cavity, Re 1000, deltaT {PIMPLE_DT} (lid "
        f"Courant {PIMPLE_DT * FULL / 0.1:.2f}): set-up "
        f"{time.perf_counter() - t0:.1f} s; {s.topo.n_cells} cells")
    dk.reset_counts()
    s.solve_stats.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        _, hist = s.solve_primal_history(st0, x)
        J, vals = s.eval_function_history("lidF", hist, x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(dk.COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2**20
    per = {k: v[1] / v[0] for k, v in s.solve_stats.items()}
    stT = {k: v[-1] for k, v in hist.items()}
    say(f"[pimple] {s.n_steps} steps in {dt:.2f} s = "
        f"{dt / s.n_steps * 1e3:.1f} ms per time step; lidF per step "
        f"{vals.tolist()}, average {float(J)!r}; Krylov iterations per "
        "solve: " + ", ".join(f"{k} {v:.2f}" for k, v in per.items())
        + f"; max |U| {float(stT['U'].norm(dim=-1).max()):.4f}; peak "
        f"device memory {peak:.0f} MiB; launch counts {counts}")
    check(s.states_valid(stT), "pimple state is not finite/valid")
    check(all(math.isfinite(v) for v in vals.tolist()), "lidF not finite")
    check_counts(counts, "pimple primal")
    tail = {k: v[-2:].clone() for k, v in hist.items()}

    out = [counts]
    totals = []
    for tag in ("in-memory", "checkpointed"):
        s.solve_stats.clear()
        dk.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if tag == "in-memory":
            tot, resids = s.solve_unsteady_adjoint(hist, x, "lidF")
        else:
            del hist
            tot, resids, _ = s.solve_unsteady_adjoint_checkpointed(
                st0, x, "lidF", seg_len=PIMPLE_SEG)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = dict(dk.COUNTS)
        peak = torch.cuda.max_memory_allocated() / 2**20
        adj = s.solve_stats["adjoint"]
        say(f"[pimple-adjoint] {tag} sweep: {dt:.2f} s = "
            f"{dt / s.n_steps * 1e3:.1f} ms per reverse step"
            + (" (the segments' recomputed steps included)"
               if tag != "in-memory" else "")
            + f"; {adj[1] / adj[0]:.1f} FGMRES iterations per reverse step "
            f"(segregated PC, cap {PIMPLE_GMRES}); resids "
            f"[{float(resids.min()):.3e}, {float(resids.max()):.3e}]; "
            f"dlidF/dnu {float(tot['params']['nu'])!r}, ||dlidF/dpoints|| "
            f"{float(torch.linalg.norm(tot['points']))!r}; peak device "
            f"memory {peak:.0f} MiB; launch counts {c}")
        flat = torch.cat([a.reshape(-1) for a in tree.leaves(tot)])
        check(bool(torch.isfinite(flat).all()),
              f"pimple {tag} totals not finite")
        check_counts(c, f"pimple {tag} sweep",
                     ("dia_matvec_t", "dia_matvec_multi_t"))
        totals.append(flat)
        out.append(c)
    rel = float((totals[0] - totals[1]).abs().max()
                / totals[0].abs().max())
    say(f"[pimple-adjoint] in-memory vs checkpointed totals: max rel "
        f"{rel:.3e}")
    check(rel <= 1e-4, f"the two sweeps disagree: rel {rel:.3e}")
    return out, (s, x, tail)


def phase_rho_pimple(torch, dk, make_solver, s9, st9):
    """Phase 11b: DARhoPimpleFoam on phase 9's 512x512 O-mesh case (its
    options plus deltaT RHO_PIMPLE_DT), RHO_PIMPLE_STEPS steps from phase
    9's state. Returns the launch counts."""
    s = make_solver(rho_options(solverName="DARhoPimpleFoam",
                                deltaT=RHO_PIMPLE_DT,
                                endTime=RHO_PIMPLE_STEPS * RHO_PIMPLE_DT),
                    s9.topo, s9.points.cpu().numpy(), device=DEVICE,
                    dtype=torch.float32)
    x = s.make_inputs()
    dk.reset_counts()
    s.solve_stats.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        st, hist = s.solve_primal_history(st9, x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(dk.COUNTS)
    cd = float(s.run_function("CD", st, x))
    per = {k: v[1] / v[0] for k, v in s.solve_stats.items()}
    with torch.no_grad():
        rho = s.rho_of(st, x)
    say(f"[rho-pimple] {FULL}x{FULL} f32 DARhoPimpleFoam: "
        f"{s.n_steps} steps (deltaT {RHO_PIMPLE_DT}, {s.n_outer} outer x "
        f"{s.n_corr} pressure correctors) in {dt:.2f} s = "
        f"{dt / s.n_steps * 1e3:.1f} ms per step; CD {cd!r}; rho in "
        f"[{float(rho.min()):.4f}, {float(rho.max()):.4f}]; Krylov "
        "iterations per solve: " + ", ".join(f"{k} {v:.2f}"
                                             for k, v in per.items())
        + f"; launch counts {counts}")
    check(hist["U"].shape[0] == RHO_PIMPLE_STEPS + 1, "rho pimple history")
    check(s.states_valid(st), "rho pimple state is not finite/valid")
    check(math.isfinite(cd), f"rho pimple CD not finite: {cd}")
    check_counts(counts, "rho pimple primal")
    return counts


def _unsteady_run(torch, dk, s, x, st0, func, tag):
    """The primal history from ``st0`` and the per-step values of
    ``func`` (no_grad), timed. Returns (history, J, values, counts,
    seconds, peak MiB)."""
    dk.reset_counts()
    s.solve_stats.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        _, hist = s.solve_primal_history(st0, x)
        J, vals = s.eval_function_history(func, hist, x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(dk.COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2**20
    per = {k: v[1] / v[0] for k, v in s.solve_stats.items()}
    stT = {k: v[-1] for k, v in hist.items()}
    say(f"[{tag}] {s.n_steps} steps in {dt:.2f} s = "
        f"{dt / s.n_steps * 1e3:.1f} ms per time step; {func} per step "
        f"{vals.tolist()}, timeOp {float(J)!r}; Krylov iterations per "
        "solve: " + ", ".join(f"{k} {v:.2f}" for k, v in per.items())
        + f"; peak device memory {peak:.0f} MiB; launch counts {counts}")
    check(s.states_valid(stT), f"{tag} state is not finite/valid")
    check(all(math.isfinite(v) for v in vals.tolist()),
          f"{tag}: {func} not finite")
    return hist, float(J), vals, counts


def _unsteady_sweep(torch, dk, s, x, hist, func, tag, param):
    """The in-memory reverse sweep, timed; checks finite totals and K3a.
    Returns (totals, counts)."""
    from dafoam_tpu_torch.utils import tree
    s.solve_stats.clear()
    dk.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tot, resids = s.solve_unsteady_adjoint(hist, x, func)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c = dict(dk.COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2**20
    adj = s.solve_stats["adjoint"]
    say(f"[{tag}-adjoint] in-memory sweep: {dt:.2f} s = "
        f"{dt / s.n_steps * 1e3:.1f} ms per reverse step; "
        f"{adj[1] / adj[0]:.1f} FGMRES iterations per reverse step "
        f"(segregated PC, cap {UNSTEADY_GMRES}); resids "
        f"[{float(resids.min()):.3e}, {float(resids.max()):.3e}]; "
        f"d{func}/d{param} {float(tot['params'][param])!r}; peak device "
        f"memory {peak:.0f} MiB; launch counts {c}")
    flat = torch.cat([a.reshape(-1) for a in tree.leaves(tot)])
    check(bool(torch.isfinite(flat).all()), f"{tag} totals not finite")
    check_counts(c, f"{tag} sweep", ("dia_matvec_t", "dia_matvec_multi_t"))
    return tot, c


def phase_dym_full(torch, dk, make_solver, s5, st5):
    """Phase 12: DAPimpleDyMFoam, the plunging NACA0012 on phase 5's
    512x512 O-mesh (f32, dense) from phase 5's state: the SCL residual of
    step 1's mesh flux, DYM_STEPS ALE steps and the in-memory reverse
    sweep for the cycle-averaged CD. Returns (primal, sweep) counts."""
    t0 = time.perf_counter()
    s = make_solver(dym_options(), s5.topo, s5.points.cpu().numpy(),
                    device=DEVICE, dtype=torch.float32)
    x = s.make_inputs()
    with torch.no_grad():
        scl = s.scl_residual(s.points_at(x, 0.0), s.points_at(x, s.dt),
                             s.dt)
        x64 = dict(x, points=x["points"].double(),
                   params=dict(x["params"],
                               dyMeshAmp=x["params"]["dyMeshAmp"].double()))
        scl64 = s.scl_residual(s.points_at(x64, 0.0),
                               s.points_at(x64, s.dt), s.dt)
    torch.cuda.synchronize()
    say(f"[dym] {FULL}x{FULL} plunging NACA0012, amplitude {DYM_AMP} "
        f"chord, {DYM_FREQ:g} Hz, deltaT {DYM_DT}: set-up "
        f"{time.perf_counter() - t0:.1f} s; SCL residual of step 1 "
        f"(max over cells |sum mesh_phi| / sum |mesh_phi|) {scl:.3e} in "
        f"f32, {scl64:.3e} with the points in f64")
    check(math.isfinite(scl) and scl64 < 1e-6, f"SCL residual {scl64}")
    hist, _, _, counts = _unsteady_run(torch, dk, s, x, st5, "CD", "dym")
    check_counts(counts, "dym primal")
    tot, c = _unsteady_sweep(torch, dk, s, x, hist, "CD", "dym",
                             "dyMeshAmp")
    return counts, c


def phase_irk_full(torch, dk, make_solver, box):
    """Phase 13: DAIrkPimpleFoam on phase 11's 512x512 cavity (f32, dense):
    IRK_STEPS Radau IIA steps and the in-memory reverse sweep with the
    two-stage segregated PC. Returns (primal, sweep) counts."""
    pts, topo = box(FULL, FULL, 1, (0.1, 0.1, 0.01),
                    kinds={"zmin": "empty", "zmax": "empty", "xmin": "wall",
                           "xmax": "wall", "ymin": "wall", "ymax": "wall"})
    s = make_solver(irk_options(), topo, pts, device=DEVICE,
                    dtype=torch.float32)
    x = s.make_inputs()
    say(f"[irk] {FULL}x{FULL} cavity, Re 1000, deltaT {PIMPLE_DT}, "
        f"{s.max_sweeps} sweeps x {s.n_corr} pressure correctors; state "
        f"{sorted(s.state_info.names())}, {s.layout.n_states} unknowns")
    hist, _, _, counts = _unsteady_run(torch, dk, s, x, s.init_state(),
                                       "lidF", "irk")
    check_counts(counts, "irk primal")
    _, c = _unsteady_sweep(torch, dk, s, x, hist, "lidF", "irk", "nu")
    return counts, c


def phase_inter_full(torch, dk, make_solver, box):
    """Phase 14: DAInterFoam, the dam break at INTER_NX x INTER_NY (f32,
    dense): INTER_STEPS steps, alpha bounded and the water volume kept at
    f32 rounding, the water's centre of mass moving right and down; then
    the in-memory reverse sweep with the two-phase PC. Returns (primal,
    sweep) counts."""
    pts, topo = box(INTER_NX, INTER_NY, 1, (0.6, 0.4, 0.02),
                    kinds={"zmin": "empty", "zmax": "empty", "xmin": "wall",
                           "xmax": "wall", "ymin": "wall"})
    s = make_solver(inter_options(), topo, pts, device=DEVICE,
                    dtype=torch.float32)
    x = s.make_inputs()
    geom = s.geometry(x)
    cc = geom.cc.double()
    st0 = s.init_state()
    st0["alpha"] = ((cc[:, 0] < 0.2) & (cc[:, 1] < 0.2)).to(torch.float32)
    say(f"[inter] {INTER_NX}x{INTER_NY} dam break ({s.topo.n_cells} "
        f"cells), deltaT {INTER_DT}, {s.n_outer} outer x {s.n_corr} "
        "correctors")
    hist, _, _, counts = _unsteady_run(torch, dk, s, x, st0, "pRight",
                                       "inter")
    check_counts(counts, "inter primal", ("dia_matvec",))
    a = hist["alpha"].double()
    vol = geom.vol.double()
    m = (a * vol).sum(dim=1)
    com = (a * vol) @ cc[:, :2] / m[:, None]
    drift = float((m / m[0] - 1.0).abs().max())
    say(f"[inter] alpha in [{float(a.min())!r}, {float(a.max())!r}]; "
        f"water volume drift {drift:.3e}; centre of mass "
        f"{com[0].tolist()} -> {com[-1].tolist()}")
    check(float(a.min()) >= -1e-5 and float(a.max()) <= 1.0 + 1e-5,
          "alpha left [-1e-5, 1 + 1e-5]")
    check(drift <= 1e-5, f"water volume drift {drift}")
    check(float(com[-1, 0]) > float(com[0, 0])
          and float(com[-1, 1]) < float(com[0, 1]),
          "the water column did not move right and down")
    _, c = _unsteady_sweep(torch, dk, s, x, hist, "pRight", "inter", "rho1")
    return counts, c


def phase_ts_full(torch, dk, make_solver, box):
    """Phase 15: the time-spectral scalar transport on the 1.0 x 0.6 box at
    FULL x FULL with 5 instances (f32, dense): TS_SWEEPS block
    Gauss-Seidel sweeps, one TS_GMRES-iteration residual-form FGMRES cycle
    (lineJacobi PC: per-instance line solves, transposed products through
    K3a) and the totals. Returns (primal, adjoint) counts."""
    from dafoam_tpu_torch.utils import tree
    pts, topo = box(FULL, FULL, 1, (1.0, 0.6, 0.1),
                    kinds={"zmin": "empty", "zmax": "empty"})
    s = make_solver(ts_options(), topo, pts, device=DEVICE,
                    dtype=torch.float32)
    x = s.make_inputs()
    x["params"]["U"] = s._tensor([0.4, 0.0, 0.0]).expand(
        s.topo.n_cells, 3).contiguous()
    st0 = s.init_state()
    with torch.no_grad():
        res0 = float(torch.stack([v.abs().max() for v in
                                  s.residuals(st0, x).values()]).max())
    dk.reset_counts()
    s.solve_stats.clear()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, info = s.run_primal(st0, x)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(dk.COUNTS)
    J = float(s.run_function("TMean", st, x))
    per = s.solve_stats["T"]
    say(f"[ts] {FULL}x{FULL} box, {s.n_inst} instances "
        f"({s.layout.n_states} unknowns): {info.iters} sweeps in {dt:.2f} s"
        f" = {dt / info.iters * 1e3:.1f} ms per sweep, "
        f"{per[1] / per[0]:.2f} BiCGStab iterations per instance solve; "
        f"residual {res0:.4e} -> {info.max_res:.4e}; TMean {J!r}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**20:.0f} "
        f"MiB; launch counts {counts}")
    check(not info.failed and s.states_valid(st), "ts state not valid")
    check(info.max_res < res0, "ts residual did not fall")
    check(math.isfinite(J), "TMean not finite")
    check_counts(counts, "ts primal", ("dia_matvec",))
    dk.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psi, ai = s.solve_adjoint(st, x, "TMean")
    tot = s.total_derivative(st, x, "TMean", psi)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c = dict(dk.COUNTS)
    amp = float(tot["bc"]["T"]["xmin"]["amplitudes"][0])
    say(f"[ts-adjoint] {ai.iters} FGMRES iterations + totals in {dt:.2f} s"
        f" = {dt / max(ai.iters, 1) * 1e3:.1f} ms per iteration; resid "
        f"{float(ai.resid0):.4e} -> {float(ai.resid):.4e}; "
        f"dTMean/d(amplitude) {amp!r}, dTMean/dDT "
        f"{float(tot['params']['DT'])!r}; launch counts {c}")
    flat = torch.cat([a.reshape(-1) for a in tree.leaves(tot)])
    check(bool(torch.isfinite(flat).all()), "ts totals not finite")
    check_counts(c, "ts adjoint", ("dia_matvec_t",))
    return counts, c


# ---------------------------------------------------------------------------
# phases 16-18: the MDO and coupling layer at full width
# ---------------------------------------------------------------------------

# phase 16: examples/naca0012_drag_opt.py's workflow on phase 5's case. Each
# evaluation's primal is cut at SHAPE_ITERS SIMPLE iterations and counts
# as converged at max_res SHAPE_TOL (phase 5 leaves 4.1e-3-4.5e-3; the
# SLSQP steps of the first call raised the first iteration's max_res to
# 1.6e-2 at most): a primal that misses it is re-run from init_state()
# (ShapeOptProblem's restart rule); each gradient's adjoint is one
# fpMaxIters = 120 cycle (bench options)
SHAPE_TOL = 1e-2
SHAPE_ITERS = 60
# phase 17's mesh gate: mesh/airfoil.py's O-mesh has non-orthogonality
# 82.0 deg and skewness 16.6 at the trailing edge at 512x512 (75.6 / 2.0
# at 64x64; dafoam_tpu's check reports the same), past checkMeshThreshold's
# defaults of 70 / 4: the case sets its own, as DAFoam cases do
O_MESH_THRESHOLD = {"maxAspectRatio": 1000.0, "maxNonOrth": 85.0,
                    "maxSkewness": 20.0, "maxIncorrectlyOrientedFaces": 0}
SHAPE_BOUND = 0.03
SHAPE_MAXITER = 1
# phase 18: tests/test_cht.py's heated plate and tests/test_fsi.py's
# flexible wall with the fluid channel at CPL_NX x CPL_NY (the solid at
# half the height), f32: CPL_OUTER block Gauss-Seidel iterations of
# CPL_SIMPLE SIMPLE (bench's inner-solve caps) and CPL_PICARD solid
# Picard iterations, then one CPL_GMRES-iteration unpreconditioned GMRES
# cycle of the coupled adjoint
CPL_NX, CPL_NY = 1024, 256
CPL_OUTER = 3
CPL_SIMPLE = 20
CPL_PICARD = 3
CPL_GMRES = 60
CPL_LINEAR = {"pMaxIters": 50, "pRelTol": 0.05, "uMaxIters": 20,
              "uRelTol": 0.1, "turbMaxIters": 20, "turbRelTol": 0.1}
# the heat-transfer primal's own loop repeats its linear solve (Jacobi-CG
# to rel 1e-14, at most 10,000 iterations) until the residual meets
# primalMinResTol, at most 100 times; in f32 the slab's residual stalls at
# ~4 (CPU rehearsal, 64x8), so a tolerance no residual misses makes it one
# solve per outer iteration
CPL_HEAT_TOL = 1e30


@contextlib.contextmanager
def wrapped(obj, name, wrap):
    """Shadow the method ``name`` of one object for the duration of a
    block: ``wrap(method)`` returns the stand-in."""
    setattr(obj, name, wrap(getattr(obj, name)))
    try:
        yield
    finally:
        delattr(obj, name)


def _timed(torch, log):
    """A wrapper factory that appends each call's seconds (after a device
    sync) and result to ``log``."""
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            log.append((time.perf_counter() - t0, out))
            return out
        return run
    return wrap


def phase_shape_opt(torch, dk, s, st):
    """Phase 16: ShapeOptProblem on phase 5's 512x512 case with the
    example's FFD (8x4x2 control points, y-displacements of the 6x2
    xy-interior ones: 12 DVs) warm-started from phase 5's state:
    eval_all(0), grad(0), then SLSQP for SHAPE_MAXITER iterations within
    +-SHAPE_BOUND. grad(0) must equal the hand chain: FFD's B^T applied to
    the captured dCD/dpoints, reduced to the 12 DVs. Returns the counts."""
    import numpy as np
    from dafoam_tpu_torch.examples.naca0012_drag_opt import make_geo_fn
    from dafoam_tpu_torch.mdo import FFDBox
    from dafoam_tpu_torch.mdo.optimize import ShapeOptProblem

    t0 = time.perf_counter()
    ffd = FFDBox(s.points.cpu().numpy(), nx=8, ny=4, nz=2,
                 bounds=([-0.1, -0.2, -1.0], [1.1, 0.2, 1.1]),
                 device=DEVICE, dtype=torch.float32)
    torch.cuda.synchronize()
    t_ffd = time.perf_counter() - t0
    geo_fn, n_dv = make_geo_fn(ffd, s.points)
    say(f"[shape-opt] FFD 8x4x2 over {ffd._B.shape[0]} points "
        f"({int(ffd.inside.sum())} inside): built in {t_ffd:.2f} s, "
        f"operator {ffd._B.numel() * ffd._B.element_size() / 2**20:.1f} "
        f"MiB on the card; {n_dv} DVs")
    prims, evals, grads, tots = [], [], [], []
    with overridden(s.option, primalMinResTol=SHAPE_TOL, primalMinIters=1,
                    primalMaxIters=SHAPE_ITERS), \
            wrapped(s, "run_primal", _timed(torch, prims)), \
            wrapped(s, "run_totals", _timed(torch, tots)):
        prob = ShapeOptProblem(s, geo_fn, "CD")
        prob._state = {k: v.detach() for k, v in st.items()}
        with wrapped(prob, "eval_all", _timed(torch, evals)), \
                wrapped(prob, "grad", _timed(torch, grads)):
            dk.reset_counts()
            torch.cuda.reset_peak_memory_stats()
            dv0 = np.zeros(n_dv)
            funcs, state, inputs = prob.eval_all(dv0)
            g0 = prob.grad(dv0, "CD", state, inputs)
            t0 = time.perf_counter()
            res = prob.run(dv0, bounds=[(-SHAPE_BOUND, SHAPE_BOUND)] * n_dv,
                           maxiter=SHAPE_MAXITER)
            t_run = time.perf_counter() - t0
            counts = dict(dk.COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2**20
    cds = [h["CD"] for h in prob.history]
    restarts = len(prims) - len(evals)
    say(f"[shape-opt] {len(evals)} evaluations ({len(prob.history) - 1} "
        f"by SLSQP), {len(grads)} gradients, {restarts} primal restarts "
        f"from init_state(); s per evaluation "
        f"{[round(t, 2) for t, _ in evals]}, per gradient "
        f"{[round(t, 2) for t, _ in grads]}; SLSQP {t_run:.1f} s, "
        f"{res.nit} iterations, status {res.status} ({res.message})")
    say(f"[shape-opt] primal runs (iterations, max_res, converged): "
        f"{[(i.iters, round(i.max_res, 5), i.converged) for _, (_, i) in prims]}")
    say(f"[shape-opt] CD per evaluation {cds}; ||dCD/dDV|| at 0 "
        f"{float(np.linalg.norm(g0))!r}; SLSQP end CD {res.fun!r}; peak "
        f"device memory {peak:.0f} MiB")
    say(f"[shape-opt] launch counts {counts}")
    # the hand chain: B^T dCD/dpoints, reduced to the DVs
    gcp = (ffd._B.T @ tots[0][1]["points"]).reshape(8, 4, 2, 3)
    hand = gcp[1:7, 1:3, :, 1].sum(dim=2).reshape(-1).double().cpu().numpy()
    err = float(np.abs(g0 - hand).max() / np.abs(hand).max())
    say(f"[shape-opt] grad(0) against the hand chain: rel {err:.3e}")
    check(all(math.isfinite(c) for c in cds), f"CD not finite: {cds}")
    check(np.isfinite(g0).all() and np.abs(g0).max() > 0,
          "dCD/dDV not finite or zero")
    check(err <= 1e-4, f"grad against the hand chain: rel {err}")
    check_counts(counts, "shape-opt", ADJOINT_KERNELS)
    return counts


def phase_mphys(torch, dk, s, st):
    """Phase 17: tests/test_mphys.py's aero model on phase 5's case on the
    port's OpenMDAO shim: DAFoamMesh -> x_aero (the wing points) ->
    DAFoamWarper (IDWarp over every volume point, the far field fixed) ->
    DAFoamSolver (warm-started from phase 5's state) -> DAFoamFunctions.
    run_model, then compute_totals(CD, x_aero) through solve_linear (one
    capped fixed-point cycle). The totals must equal the direct route,
    total_derivative at the same psibar through the warper's vjp. Returns
    the counts."""
    import tracemalloc

    import numpy as np
    from dafoam_tpu_torch.mdo import mphys
    from dafoam_tpu_torch.mdo import om_shim as om
    from dafoam_tpu_torch.mesh.check import check_mesh
    from dafoam_tpu_torch.outputs import patch_point_ids

    s.option.set("designSurfaces", ["wing"])
    vol = {"aero_vol_coords": {"type": "volCoord",
                               "components": ["solver", "function"]}}
    with overridden(s.option, primalMinResTol=SHAPE_TOL, primalMinIters=1,
                    primalMaxIters=SHAPE_ITERS, inputInfo=vol,
                    checkMeshThreshold=O_MESH_THRESHOLD):
        ok, rep = check_mesh(s.geometry(s.make_inputs()), s.topo,
                             s.option["checkMeshThreshold"])
        say(f"[mphys] checkMesh {rep} -> {'ok' if ok else 'FAILS'}")
        model = om.Group()
        model.add_subsystem("mesh", mphys.DAFoamMesh(solver=s),
                            promotes=["*"])
        ivc = om.IndepVarComp()
        pids = patch_point_ids(s.topo, ["wing"])
        ivc.add_output("x_aero", val=s.points.cpu().numpy()[pids].ravel())
        model.add_subsystem("dvs", ivc, promotes=["*"])
        comps = {"deformer": mphys.DAFoamWarper(solver=s),
                 "solver": mphys.DAFoamSolver(solver=s),
                 "functions": mphys.DAFoamFunctions(solver=s)}
        for name, comp in comps.items():
            model.add_subsystem(name, comp, promotes=["*"])
        tracemalloc.start()
        t0 = time.perf_counter()
        prob = om.Problem(model).setup()
        t_setup = time.perf_counter() - t0
        host_peak = tracemalloc.get_traced_memory()[1] / 2**20
        tracemalloc.stop()
        warper = comps["deformer"]
        say(f"[mphys] Problem.setup {t_setup:.1f} s (IDWarp over "
            f"{warper.warp._npts} points, {len(warper.surf_ids)} wing "
            f"points, k 20; host peak {host_peak:.0f} MiB traced)")
        xs = torch.as_tensor(np.asarray(prob["x_aero"]), device=DEVICE,
                             dtype=torch.float32)
        with torch.no_grad():
            warp_ms = cuda_ms(torch, lambda: warper.warp_flat(xs), reps=5,
                              inner=10)
        comps["solver"]._state = {k: v.detach() for k, v in st.items()}
        dk.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        prob.run_model()
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        cd = float(np.asarray(prob["CD"]).ravel()[0])
        t0 = time.perf_counter()
        tot = prob.compute_totals(of="CD", wrt="x_aero")[("CD", "x_aero")]
        torch.cuda.synchronize()
        t_tot = time.perf_counter() - t0
        counts = dict(dk.COUNTS)
        peak = torch.cuda.max_memory_allocated() / 2**20
        ai = comps["solver"].last_adjoint_info
        info = comps["solver"].last_info
        say(f"[mphys] warp {warp_ms:.3f} ms on the card; run_model "
            f"{t_run:.2f} s ({info.iters} SIMPLE iterations, max_res "
            f"{info.max_res:.3e}), CD {cd!r}; compute_totals {t_tot:.2f} s "
            f"(fixed-point cycle: {ai.iters} iterations, resid0 "
            f"{ai.resid0:.3e} -> {ai.resid:.3e}; residual graphs recorded "
            f"{comps['solver'].n_graphs}); peak device memory {peak:.0f} MiB")
        say(f"[mphys] launch counts {counts}")
        # the direct route: total_derivative at the same psibar, through
        # the warper's vjp
        sol = comps["solver"]
        psi = s.layout.unpack(torch.as_tensor(
            sol._psi_packed, device=DEVICE, dtype=torch.float32))
        tp = s.total_derivative(sol._state, sol._tree_cache, "CD",
                                psi)["points"]
        xr = xs.clone().requires_grad_(True)
        with torch.enable_grad():
            v = warper.warp_flat(xr)
        (direct,) = torch.autograd.grad(v, xr, tp.reshape(-1))
        direct = direct.double().cpu().numpy()
        err = float(np.abs(tot - direct).max() / np.abs(direct).max())
        say(f"[mphys] ||dCD/dx_aero|| {float(np.linalg.norm(tot))!r}; "
            f"against the direct route: rel {err:.3e}")
    check(np.isfinite(tot).all() and np.abs(tot).max() > 0,
          "MPhys totals not finite or zero")
    check(err <= 1e-4, f"MPhys totals against the direct route: rel {err}")
    check(comps["solver"].n_graphs == 1, "residual graph recorded twice")
    check_counts(counts, "mphys", ADJOINT_KERNELS)
    return counts


def _coupled(torch, dk, cpl, tag, side, func, diag, param, reach):
    """Phase 18's drive of one coupling: CPL_OUTER block Gauss-Seidel
    iterations, then one CPL_GMRES-iteration coupled-adjoint cycle, whose
    psi is held to GMRES's residual by one more product. ``param``: the
    path of a solid-side total to print; ``reach``: (side, path) of a
    total that one cycle reaches, checked nonzero. Returns (primal counts,
    adjoint counts)."""
    f, s = cpl.fluid, cpl.solid
    inf, ins = f.make_inputs(), s.make_inputs()
    sf, ss = f.init_state(), s.init_state()
    dk.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(CPL_OUTER):
        t0 = time.perf_counter()
        sf, ss, (info_f, info_s) = cpl.solve_primal(sf, ss, inf, ins,
                                                    n_outer=1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        say(f"[{tag}] outer {len(times)}: {times[-1]:.2f} s, fluid max_res "
            f"{info_f.max_res:.3e}, solid {info_s.iters} iterations max_res "
            f"{info_s.max_res:.3e}, {diag[0]} "
            f"{float(diag[1](sf, ss, inf, ins))!r}")
    counts = dict(dk.COUNTS)
    check(f.states_valid(sf) and s.states_valid(ss), f"{tag}: state invalid")
    check_counts(counts, f"{tag} primal")
    dk.reset_counts()
    t0 = time.perf_counter()
    tf, ts, ai, psi = cpl.solve_adjoint(sf, ss, inf, ins, side, func,
                                        restart=CPL_GMRES, rel_tol=1e-9,
                                        max_iters=CPL_GMRES,
                                        return_psi=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    adj = dict(dk.COUNTS)
    true = _coupled_true_resid(torch, cpl, {"fluid": sf, "solid": ss}, inf,
                               ins, side, func, psi)
    tots = {"fluid": tf, "solid": ts}
    vals = {}
    for sd, path in (("solid", param), reach):
        node = tots[sd]
        for k in path:
            node = node[k]
        vals[path] = float(node)
    say(f"[{tag}] coupled adjoint: {ai.iters} GMRES iterations in {dt:.2f} "
        f"s, resid0 {ai.resid0:.6e} -> {ai.resid:.6e} (true {true:.6e}); "
        + "; ".join(f"d{func}/d{'.'.join(p)} {v!r}" for p, v in vals.items())
        + f"; ||d{func}/dpoints_fluid|| "
        f"{float(torch.linalg.norm(tf['points']))!r}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    say(f"[{tag}] launch counts primal {counts} adjoint {adj}")
    check(all(math.isfinite(v) for v in vals.values()),
          f"{tag}: totals not finite")
    check(vals[reach[1]] != 0.0,
          f"{tag}: d{func}/d{'.'.join(reach[1])} is 0 after one cycle")
    check(all(bool(torch.isfinite(v).all()) for v in tf.values()
              if isinstance(v, torch.Tensor)), f"{tag}: fluid totals")
    # psi's true residual confirms GMRES's Arnoldi estimate. In f32 they
    # part by 5e-5 of the estimate (CHT) and 2.6e-2 (FSI, whose products
    # run through the warped mesh's geometry) on the H100
    check(abs(true - ai.resid) <= 0.05 * ai.resid,
          f"{tag}: true residual {true} against GMRES's {ai.resid}")
    # the residual form's R(W) forms A x face by face, not through the
    # banded matvec: no DIA kernel is due here, and none may run plain
    check_counts(adj, f"{tag} adjoint", ())
    return counts, adj


def _coupled_true_resid(torch, cpl, W, inf, ins, side, func, psi):
    """|S (dR/dW^T psi - dJ/dW)|, the coupled adjoint's residual in the
    normalizeStates metric its GMRES runs in, by one more product."""
    from dafoam_tpu_torch.adjoint.solver import _grad, _requiring_grad, vjp
    from dafoam_tpu_torch.coupling.cht import _scale_tree, state_scales
    from dafoam_tpu_torch.linalg.krylov import tnorm
    from dafoam_tpu_torch.utils import tree

    scales = state_scales(cpl.fluid, cpl.solid, inf, ins)
    w = _requiring_grad(W)
    with torch.enable_grad():
        J = cpl.eval_function(w, inf, ins, side, func)
    b = _scale_tree(_grad(J, w), scales)
    _, f_vjp = vjp(lambda ww: cpl.residuals(ww, inf, ins), W)
    res = tree.tmap(torch.sub, _scale_tree(f_vjp(psi), scales), b)
    return float(tnorm(res))


def phase_coupling_full(torch, dk):
    """Phase 18: CHT (the heated plate, DASimpleFoam with T over
    DAHeatTransferFoam) and FSI (the flexible wall, DASimpleFoam over
    DASolidDisplacementFoam, IDWarp of the fluid mesh) with the fluid
    channel at CPL_NX x CPL_NY (f32, dense). Returns the four counts."""
    from dafoam_tpu_torch.coupling import CHTCoupling
    from dafoam_tpu_torch.examples import cht_heated_plate as ex
    from dafoam_tpu_torch.examples import fsi_flexible_wall as fsi_ex

    f32 = torch.float32
    fluid_over = {"primalMinResTol": 0.0, "primalMaxIters": CPL_SIMPLE,
                  "primalLinearSolver": dict(CPL_LINEAR)}
    t0 = time.perf_counter()
    fluid, solid = ex.build(DEVICE, f32, nx=CPL_NX, ny_fluid=CPL_NY,
                            ny_solid=CPL_NY // 2, fluid_over=fluid_over,
                            solid_over={"primalMinResTol": CPL_HEAT_TOL})
    cht = CHTCoupling(fluid, solid, "ymin", "ymax")
    say(f"[cht] {CPL_NX}x{CPL_NY} channel ({fluid.topo.n_cells} cells) over "
        f"a {CPL_NX}x{CPL_NY // 2} slab: set-up "
        f"{time.perf_counter() - t0:.1f} s")
    cht_counts = _coupled(torch, dk, cht, "cht", "fluid", "Tout",
                          ("interface T mismatch", cht.interface_mismatch),
                          ("bc", "T", "ymin"), ("fluid", ("params", "nu")))
    del cht, fluid, solid

    t0 = time.perf_counter()
    fsi = fsi_ex.build(DEVICE, f32, nx=CPL_NX, ny_fluid=CPL_NY,
                       ny_solid=CPL_NY // 2, fluid_over=fluid_over,
                       solid_over={"primalMinResTol": 0.0,
                                   "primalMaxIters": CPL_PICARD})
    torch.cuda.synchronize()
    say(f"[fsi] {CPL_NX}x{CPL_NY} channel over a {CPL_NX}x{CPL_NY // 2} "
        f"plate: set-up (meshes, IDWarp over {fsi.warp._npts} points, "
        f"{len(fsi.surf_ids)} interface points, k 12) "
        f"{time.perf_counter() - t0:.1f} s")
    fsi_counts = _coupled(
        torch, dk, fsi, "fsi", "fluid", "drag",
        ("interface displacement", lambda sf, ss, inf, ins:
         fsi.interface_displacement(ss, ins)), ("params", "E"),
        ("solid", ("params", "E")))
    return cht_counts + fsi_counts


# ---------------------------------------------------------------------------
# phase 19: IO and utilities at full width
# ---------------------------------------------------------------------------

IO_ITERS = 20         # SIMPLE iterations of each solver in phase 19
IO_ADJ = 30           # fixed-point GMRES iterations of phase 19's cycle
IO_REL = 1e-5         # the two solvers' states; traction x |Sf| against CD
JAC_REL = 1e-12       # the dense dRdWT times v against the vjp (f64)


def jacdump_options():
    """tests/test_jacdump.py:make_case, the 5x4 scalar-transport case."""
    return {
        "solverName": "DAScalarTransportFoam",
        "ddtScheme": "steadyState",
        "transportProperties": {"DT": 0.05},
        "boundaryConditions": {
            "T": {"xmin": {"type": "fixedValue", "value": 1.0},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "fixedValue", "value": 0.0},
                  "ymax": {"type": "zeroGradient"}},
            "U": {"xmin": {"type": "fixedValue", "value": [1.0, 0.2, 0.0]},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "fixedValue", "value": [1.0, 0.2, 0.0]},
                  "ymax": {"type": "zeroGradient"}},
        },
        "initialFields": {"T": 0.0},
        "function": {"TMean": {"type": "patchMean", "patches": ["xmax"],
                               "varName": "T", "scale": 1.0}},
        "normalizeStates": {"T": 1.0},
    }


def _mib(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path)) / 2**20


def _cli(cli, argv):
    """(return code, standard output) of one CLI call."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-300)


def _io_mesh(omesh, s, tmp, timer):
    """Phase 19's mesh round trip: (points, topology) read from disk."""
    import numpy as np
    from dafoam_tpu_torch import native
    from dafoam_tpu_torch.mesh.polymesh import read_polymesh, write_polymesh
    from dafoam_tpu_torch.mesh.topology import from_dia_dense
    from dafoam_tpu_torch.scripts import cli

    with timer.phase("generate"):
        pts, topo = omesh(n_wrap=FULL, n_radial=FULL, radius=15.0,
                          first_cell=4e-3)
    case = os.path.join(tmp, "naca0012")
    # phase 5's dense-DIA topology: the writer emits the canonical one
    with timer.phase("write_polymesh"):
        pm = write_polymesh(case, pts, s.topo)
    t_write = timer.report()["write_polymesh"]
    native.reset_counts()
    t0 = time.perf_counter()
    with timer.phase("read_polymesh"):
        pts2, topo2 = read_polymesh(case)
    t_read = time.perf_counter() - t0
    counts = dict(native.COUNTS)
    say(f"[io] {FULL}x{FULL} O-mesh, {topo.n_points} points, "
        f"{topo.n_faces} faces: write_polymesh {t_write:.2f} s "
        f"({_mib(pm):.1f} MiB of ASCII), read_polymesh {t_read:.2f} s "
        f"({_mib(pm) / t_read:.0f} MiB/s); parsed by {counts}")
    check(np.array_equal(pts2, pts) and pts2.dtype == pts.dtype,
          "read-back points differ from the generated mesh")
    canonical = from_dia_dense(s.topo)
    for name in ("face_verts", "face_nverts", "owner", "neighbour"):
        b = getattr(topo, name)
        for label, t in (("read-back", topo2), ("phase 5's", canonical)):
            a = getattr(t, name)
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  f"{label} {name} differs from the generated mesh")
    check([(p.name, p.start, p.size, p.kind) for p in topo2.patches]
          == [(p.name, p.start, p.size, p.kind) for p in topo.patches]
          and (topo2.n_cells, topo2.n_internal)
          == (topo.n_cells, topo.n_internal), "read-back patches differ")
    check(counts == {"labels": 2, "points": 1, "faces": 1,
                     "labels_numpy": 0, "points_numpy": 0,
                     "faces_numpy": 0},
          f"the native parser did not parse every file: {counts}")

    with timer.phase("meshinfo"):
        rc, out = _cli(cli, ["meshinfo", case, "--device", DEVICE])
    head = out.splitlines()[0]
    say(f"[io] meshinfo on {DEVICE} (rc {rc}): {head}; "
        f"{out.splitlines()[-1]}")
    check(rc == 0 and head == f"cells={topo.n_cells} faces={topo.n_faces} "
          f"internal={topo.n_internal} points={topo.n_points}",
          f"meshinfo: {out}")
    return pts2, topo2


def _io_checkpoint(inputs, st, tmp, timer):
    """Phase 19's checkpoints: the loaded state (numpy)."""
    import numpy as np
    from dafoam_tpu_torch.scripts import cli
    from dafoam_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                   save_checkpoint)

    a, b = (os.path.join(tmp, n) for n in ("a.npz", "b.npz"))
    meta = {"case": f"naca0012 {FULL}x{FULL}", "iterations": ITERS}
    with timer.phase("save_checkpoint"):
        save_checkpoint(a, st, inputs, meta)
    with timer.phase("load_checkpoint"):
        state, x, m = load_checkpoint(a)
    save_checkpoint(b, st, inputs, meta)
    for k, v in st.items():
        v = v.detach().cpu().numpy()
        check(state[k].dtype == v.dtype and np.array_equal(state[k], v),
              f"checkpoint state {k} differs")
    check(np.array_equal(x["points"], inputs["points"].cpu().numpy())
          and float(x["params"]["nu"]) == float(inputs["params"]["nu"])
          and m == meta, "checkpoint inputs or meta differ")
    rc, out = _cli(cli, ["ckdiff", a, b])
    say(f"[io] checkpoint {os.path.getsize(a) / 2**20:.1f} MiB "
        f"(npz, compressed): {len(out.splitlines())} arrays, ckdiff rc {rc}")
    check(rc == 0, f"ckdiff of two copies: {out}")
    return state


def _io_jacdump(torch, make_solver, box, timer):
    """Phase 19's Jacobian dump: tests/test_jacdump.py's case in f64."""
    import numpy as np
    from dafoam_tpu_torch.adjoint.solver import vjp
    from dafoam_tpu_torch.utils.jacdump import dense_drdwt

    f64 = torch.float64
    pts, topo = box(5, 4, 1, (1.0, 1.0, 0.1),
                    kinds={"zmin": "empty", "zmax": "empty"})
    js = make_solver(jacdump_options(), topo, pts, device=DEVICE, dtype=f64)
    x = js.make_inputs()
    x["params"]["U"] = torch.tensor([1.0, 0.2, 0.0], dtype=f64,
                                    device=DEVICE).repeat(topo.n_cells, 1)
    rng = np.random.default_rng(2)
    st = {"T": torch.as_tensor(rng.random(topo.n_cells), dtype=f64,
                               device=DEVICE)}
    lay = js.layout
    v = torch.as_tensor(rng.standard_normal(topo.n_cells), dtype=f64,
                        device=DEVICE)
    sv = lay.pack({k: torch.broadcast_to(w, st[k].shape) for k, w in
                   js.state_scales(js.geometry(x)).items()})
    errs = []
    with timer.phase("dense_drdwt"):
        for fn, normalized, sc in ((js.residuals, False, None),
                                   (js._norm_residuals, True, sv)):
            J = dense_drdwt(js, st, x, normalized=normalized)
            _, f_vjp = vjp(lambda w: lay.pack(fn(lay.unpack(w), x)),
                           lay.pack(st))
            want = f_vjp(v if sc is None else v / sc)
            if sc is not None:
                want = want * sc
            got = torch.as_tensor(J @ v.cpu().numpy(), device=DEVICE)
            errs.append(_rel_err(got, want))
    say(f"[io] dense_drdwt on {DEVICE} ({js.topo.n_cells} cells, f64, "
        f"dense layout {js.topo.dia_dense() is not None}): raw and "
        f"normalized J^T v against the vjp, rel err {errs[0]:.3e}, "
        f"{errs[1]:.3e}")
    check(max(errs) <= JAC_REL, f"dense_drdwt against the vjp: {errs}")


def phase_io_full(torch, dk, make_solver, omesh, box, s, inputs, st):
    """Phase 19: the 512x512 case written to an OpenFOAM case, read back,
    checkpointed, solved from disk (SIMPLE, one fixed-point adjoint cycle,
    the totals) against phase 5's solver, post-processed, and the
    Jacobian dump. Returns the primal's and the adjoint's counts."""
    import shutil
    import tempfile

    import numpy as np

    from dafoam_tpu_torch.convert import state_from_numpy
    from dafoam_tpu_torch.utils import prepost
    from dafoam_tpu_torch.utils.jacdump import write_jacobians
    from dafoam_tpu_torch.utils.timing import Timer

    f32 = torch.float32
    timer = Timer()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dafoam_io_")
    try:
        pts, topo = _io_mesh(omesh, s, tmp, timer)
        state_np = _io_checkpoint(inputs, st, tmp, timer)

        with timer.phase("make_solver", block_on=lambda: s19.points):
            s19 = make_solver(bench_adjoint_options(), topo, pts,
                              device=DEVICE, dtype=f32)
        check(s19.topo.dia_dense() is not None
              and s19.topo.dia_dense()[0] == s.topo.dia_dense()[0],
              "the solver built from disk is not on phase 5's dense layout")
        check(all(np.array_equal(getattr(s19.topo, k), getattr(s.topo, k))
                  for k in ("face_verts", "owner", "neighbour"))
              and torch.equal(s19.points, s.points),
              "the solver built from disk has another mesh than phase 5's")
        x19 = s19.make_inputs()
        st_load = state_from_numpy(state_np, DEVICE, f32)

        runs = {}
        for tag, solver, x in (("phase5", s, inputs), ("disk", s19, x19)):
            with overridden(solver.option, primalMinIters=IO_ITERS,
                            primalMaxIters=IO_ITERS):
                dk.reset_counts()
                with timer.phase(f"simple_{tag}",
                                 block_on=lambda: runs[tag][0]):
                    runs[tag] = solver.run_primal(st_load, x)
                runs[tag] += (dict(dk.COUNTS),)
        (st5, info5, _), (st19, info19, io_counts) = (runs["phase5"],
                                                      runs["disk"])
        errs = {k: _rel_err(st19[k], st5[k]) for k in st19}
        same = all(torch.equal(st19[k], st5[k]) for k in st19)
        rep = timer.report()
        say(f"[io] {IO_ITERS} SIMPLE iterations from the loaded state: from "
            f"disk {rep['simple_disk']:.2f} s, max_res {info19.max_res:.4e}; "
            f"phase 5's solver {rep['simple_phase5']:.2f} s, max_res "
            f"{info5.max_res:.4e}; state rel diff "
            + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
            + f"; bit-identical {same}; launch counts {io_counts}")
        check(info19.iters == IO_ITERS and not info19.failed
              and s19.states_valid(st19), f"primal from disk: {info19}")
        check(max(errs.values()) <= IO_REL,
              f"the solver from disk and phase 5's disagree: {errs}")
        check_counts(io_counts, "io primal")

        state = {k: v.detach() for k, v in st19.items()}
        opt = dict(s19.option["adjEqnOption"], fpMaxIters=IO_ADJ,
                   gmresRestart=IO_ADJ)
        with overridden(s19.option, adjEqnOption=opt):
            dk.reset_counts()
            with timer.phase("solve_adjoint", block_on=lambda: psibar):
                psibar, ainfo = s19.solve_adjoint(state, x19, "CD")
            with timer.phase("total_derivative", block_on=lambda: tot):
                tot = s19.total_derivative(state, x19, "CD", psibar)
            adj_counts = dict(dk.COUNTS)
        dnu = float(tot["params"]["nu"])
        dpts = float(torch.linalg.norm(tot["points"]))
        rep = timer.report()
        say(f"[io] fixed-point adjoint from disk: {ainfo.iters} GMRES iters "
            f"in {rep['solve_adjoint']:.2f} s, resid {ainfo.resid0:.6e} -> "
            f"{ainfo.resid:.6e}; total_derivative "
            f"{rep['total_derivative']:.2f} s: dCD/dnu {dnu!r}, "
            f"||dCD/dpoints|| {dpts!r}; launch counts {adj_counts}")
        check(all(bool(torch.isfinite(v).all()) for v in psibar.values())
              and math.isfinite(dnu) and math.isfinite(dpts),
              "io adjoint: psibar or the totals are not finite")
        check_counts(adj_counts, "io adjoint", ADJOINT_KERNELS)

        with timer.phase("calc_force_per_s"):
            vtk = os.path.join(tmp, "wing.vtk")
            fps = prepost.calc_force_per_s(s19, st19, x19, ["wing"],
                                           vtk_path=vtk)
        ni = s19.topo.n_internal
        mags = s19.geometry(x19).magsf[ni:].double().cpu().numpy()
        fx = float((fps[:, 0] * mags).sum())
        cd = float(s19.run_function("CD", st19, x19))
        wing = s19.topo.patch("wing")
        say(f"[io] calc_force_per_s: {fps.shape} tractions, wing traction "
            f"x |Sf| summed along x {fx!r} against CD {cd!r} (rel "
            f"{abs(fx - cd) / abs(cd):.3e}); VTK "
            f"{os.path.getsize(vtk) / 2**10:.0f} KiB, {wing.size} faces")
        check(fps.shape == (s19.topo.n_boundary, 3)
              and abs(fx - cd) <= IO_REL * abs(cd),
              f"calc_force_per_s: {fx} against CD {cd}")
        with timer.phase("probe_time_series"):
            hist = torch.stack([st_load["p"], st19["p"]])
            cc = s19.geometry(x19).cc
            cell = topo.n_cells // 3
            series = prepost.probe_time_series(hist, cc,
                                               cc[cell].cpu().numpy())
        check(np.array_equal(series, hist[:, cell].cpu().numpy()),
              f"probe_time_series: {series} at cell {cell}")

        _io_jacdump(torch, make_solver, box, timer)
        try:
            write_jacobians(os.path.join(tmp, "jac.npz"), s19, st19, x19)
            refused = ""
        except ValueError as e:
            refused = str(e)
        say(f"[io] write_jacobians at {FULL}x{FULL}: {refused}")
        check("dense_limit" in refused,
              f"write_jacobians did not refuse {FULL}x{FULL}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("[io] timer: " + ", ".join(f"{k} {v:.2f} s"
                                   for k, v in timer.report().items())
        + f"; phase 19 {time.perf_counter() - t_phase:.1f} s")
    return io_counts, adj_counts


# ---------------------------------------------------------------------------
# phase 20: the halo route (dafoam_tpu_torch.parallel)
# ---------------------------------------------------------------------------

SHARD_PARTS = 8       # RCB partitions of phase 20's meshes
SHARD_ITERS = 50      # fixed-work SIMPLE outers of the f64 parity run
SHARD_FP = 30         # Richardson sweeps of its fixed-point adjoint
SHARD_P_SWEEPS = 100  # fixed-work smoother sweeps per p solve (default 500)
SHARD_U_SWEEPS = 20   # and per U solve (default 100)
SHARD_TIME_ITERS = 5  # f32 SIMPLE iterations timed on each route
SHARD_RANK_ITERS = 5  # fixed-work SIMPLE outers on the NCCL ranks
SHARD_RANK_FP = 3     # and their fixed-point sweeps
SHARD_TIMEOUT = 300   # seconds for the spawned NCCL ranks
SHARD_BANDED = 48     # box whose SHARD_PARTS-part relabelling has 58 bands
SHARD_WALLS = {"zmin": "empty", "zmax": "empty", "xmin": "wall",
               "xmax": "wall", "ymin": "wall", "ymax": "wall"}


def shard_options(**over):
    """tests/test_sharding.py:cavity_case's options, canonical layout."""
    zero = [0.0, 0.0, 0.0]
    opts = {
        "solverName": "DASimpleFoam", "turbulenceModel": "None",
        "transportProperties": {"nu": 0.01},
        "boundaryConditions": {
            "U": {"ymax": {"type": "fixedValue", "value": [1.0, 0.0, 0.0]},
                  "ymin": {"type": "fixedValue", "value": zero},
                  "xmin": {"type": "fixedValue", "value": zero},
                  "xmax": {"type": "fixedValue", "value": zero}},
            "p": {k: {"type": "zeroGradient"}
                  for k in ("xmin", "xmax", "ymin", "ymax")}},
        "initialFields": {"U": zero, "p": 0.0},
        "primalMinResTol": 1e-10, "primalMaxIters": 400,
        "relaxationFactors": {"fields": {"p": 0.3}, "equations": {"U": 0.7}},
        "function": {"lidF": {"type": "force", "patches": ["ymax"],
                              "directionMode": "fixedDirection",
                              "direction": [1.0, 0.0, 0.0], "scale": 1.0}},
        "normalizeStates": {"U": 1.0, "p": 0.5, "phi": 1.0},
        "meshFaceLayout": "canonical",
    }
    opts.update(over)
    return opts


def shard_fixed_options(iters=SHARD_ITERS, sweeps=SHARD_FP):
    """tests/test_sharding.py:test_halo_parity_100k_cells's fixed work:
    ``iters`` SIMPLE outers, ``sweeps`` Richardson sweeps of the
    fixed-point adjoint (fpRelTol 1e-30, fpInnerScale 0.5); run them under
    fvsolve.fixed_inner(1.0). The smoother budgets are SHARD_P_SWEEPS and
    SHARD_U_SWEEPS, not the defaults' 500 and 100, to keep the phase
    inside its time."""
    return shard_options(
        primalMinResTol=0.0, primalMaxIters=iters,
        primalLinearSolver={"pMaxIters": SHARD_P_SWEEPS,
                            "uMaxIters": SHARD_U_SWEEPS},
        adjEqnSolMethod="fixedPoint",
        adjEqnOption={"fpAcceleration": "richardson", "fpRelTol": 1e-30,
                      "fpMaxIters": sweeps, "fpInnerScale": 0.5})


def shard_box(box, parts):
    """Phase 20's FULL x FULL cavity box, reordered into ``parts`` RCB
    partitions: (points, topology, reorder seconds)."""
    from dafoam_tpu_torch.parallel import reorder_for_partitions
    pts, topo = box(FULL, FULL, 1, (0.1, 0.1, 0.01), kinds=SHARD_WALLS)
    t0 = time.perf_counter()
    topo2, _ = reorder_for_partitions(topo, pts, parts)
    return pts, topo2, time.perf_counter() - t0


def fixed_work(torch, dk, make_solver, pts, topo, dtype, device=None,
               group=None, parts=None, iters=SHARD_ITERS, sweeps=SHARD_FP):
    """The fixed-work primal, fixed-point adjoint and lidF totals on one
    route: unsharded (parts None) or the halo route (local transport, or
    this rank's of ``group``). The solver gets a topology object of its
    own, so no other solver shares its route."""
    import dataclasses
    from dafoam_tpu_torch.linalg import fvsolve
    from dafoam_tpu_torch.parallel import halo, shard_solver
    s = make_solver(shard_fixed_options(iters, sweeps),
                    dataclasses.replace(topo), pts, device=device or DEVICE,
                    dtype=dtype)
    hm = None if parts is None else shard_solver(s, parts, group=group)
    try:
        x = s.make_inputs()
        dk.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with fvsolve.fixed_inner(1.0):
            st, _ = s.run_primal(s.init_state(), x)
        J = float(s.run_function("lidF", st, x))
        psi, _ = s.solve_adjoint(st, x, "lidF")
        tot = s.total_derivative(st, x, "lidF", psi)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        if hm is not None:
            halo.deactivate(s.topo)
    return {"U": st["U"].detach(), "J": J, "psi": psi["U"].detach(),
            "nu": tot["params"]["nu"].detach(),
            "points": tot["points"].detach(), "s": dt,
            "counts": dict(dk.COUNTS), "products": hm.calls if hm else 0}


def fixed_work_errors(got, want):
    """Phase 20's parity bars (tests/test_sharding.py:
    test_halo_parity_100k_cells): {quantity: (error, bar)}."""
    def absmax(t):
        return float(t.abs().max())
    dj = abs(got["J"] - want["J"])
    scale = max(1.0, absmax(want["points"]))
    return {"U": (absmax(got["U"] - want["U"]), 1e-11),
            "J": (dj, max(1e-12, 1e-10 * abs(want["J"]))),
            "dJdnu": (absmax(got["nu"] - want["nu"]),
                      1e-14 + 1e-10 * absmax(want["nu"])),
            "dJdpoints": (absmax(got["points"] - want["points"]),
                          1e-10 * scale + 1e-10 * absmax(want["points"]))}


def shard_banded(torch, dk, make_solver, box, stats):
    """A relabelled mesh inside the DIA kernels' band range: the
    SHARD_BANDED box in SHARD_PARTS RCB parts has 58 bands (33-64, which
    the kernels take since topo.dia() gives a band layout up to 64). Every
    kernel against its plain version at its offsets (f32 and f64, C = 3
    with a shared diagonal for the multi forms); then the short fixed-work
    run on the unsharded route, whose products are the DIA kernels at
    those offsets, against the halo route (face-based). Returns the
    unsharded run's launch counts."""
    from dafoam_tpu_torch.parallel import reorder_for_partitions
    pts, topo = box(SHARD_BANDED, SHARD_BANDED, 1, (0.1, 0.1, 0.01),
                    kinds=SHARD_WALLS)
    topo, _ = reorder_for_partitions(topo, pts, SHARD_PARTS)
    dia = topo.dia()
    check(dia is not None and 32 < len(dia[0]) <= dk.MAX_OFFSETS,
          f"the relabelled {SHARD_BANDED}x{SHARD_BANDED} box is not banded "
          "within 33-64 offsets")
    offsets = tuple(int(o) for o in dia[0])
    n = topo.n_cells
    gen = torch.Generator(device=DEVICE).manual_seed(19)
    errs = {}
    for dtype in (torch.float32, torch.float64):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=DEVICE,
                               dtype=dtype)
        d, c = rnd(n), rnd(len(offsets), n)
        for nm in KERNELS:
            multi = nm.endswith(("multi", "multi_t"))
            x, ct = (rnd(3, n), rnd(3, n)) if multi else (rnd(n), rnd(n))
            err, scale = compare(torch, dk, nm, d, c, offsets, x, ct, stats,
                                 f"{len(offsets)}-band relabelled box")
            errs[nm] = max(errs.get(nm, 0.0), err / max(scale, 1e-300))
    kw = dict(iters=3, sweeps=2)
    want = fixed_work(torch, dk, make_solver, pts, topo, torch.float64, **kw)
    got = fixed_work(torch, dk, make_solver, pts, topo, torch.float64,
                     parts=SHARD_PARTS, **kw)
    fw = fixed_work_errors(got, want)
    say(f"[shard] {SHARD_BANDED}x{SHARD_BANDED} box in {SHARD_PARTS} RCB "
        f"parts ({n} cells, {len(offsets)} bands): each kernel against its "
        "plain version, largest relative error over f32 and f64: "
        + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + "; 3 fixed-work outers + 2 sweeps + totals in f64, unsharded "
        f"(DIA kernels, launches {want['counts']}) against the halo route: "
        + ", ".join(f"{k} {e:.3e}" for k, (e, _) in fw.items()))
    for k, (e, bar) in fw.items():
        check(e <= bar, f"{len(offsets)}-band box fixed-work {k}: {e} > "
              f"{bar}")
    cnt = want["counts"]
    check(all(cnt[k] > 0 for k in KERNELS)
          and not any(cnt[k + "_plain"] for k in KERNELS),
          f"the {len(offsets)}-band run did not launch every kernel: {cnt}")
    return cnt


def halo_vs_plain(torch, hm, topo, dev, seed, dtype):
    """(y, vjp) relative errors of one HaloMatvec product against
    autograd of the unsharded face-based product on the same inputs."""
    import numpy as np
    from dafoam_tpu_torch.ops import fvmatrix as fvx
    rng = np.random.default_rng(seed)
    nc, ni = topo.n_cells, topo.n_internal
    d, lo, up, x, ct = (torch.as_tensor(a, dtype=dtype, device=dev) for a in
                        (rng.normal(size=nc) + 5.0, rng.normal(size=ni),
                         rng.normal(size=ni), rng.normal(size=nc),
                         rng.normal(size=nc)))
    prim = [t.clone().requires_grad_(True) for t in (d, lo, up, x)]
    y = hm(*prim)
    g = torch.autograd.grad(y, prim, ct)
    ref = [t.clone().requires_grad_(True) for t in (d, lo, up, x)]
    yr = fvx.matvec(fvx.FvMatrix(ref[0], ref[1], ref[2], d), ref[3], topo)
    gr = torch.autograd.grad(yr, ref, ct)
    y, yr = y.detach(), yr.detach()
    rel = lambda a, b: float((a - b).abs().max()) / max(  # noqa: E731
        float(b.abs().max()), 1e-300)
    return rel(y, yr), max(rel(a, b) for a, b in zip(g, gr))


def _shard_rank(rank, world, rdzv, out, setting):
    """One NCCL rank of phase 20's multi-card branch (a spawned process on
    card ``rank``): HaloMatvec(group) against the local transport, then
    the short fixed-work run on the distributed route against the local
    route, the ranks' results bit-identical. ``setting`` carries the
    parent's DEVICE and FULL. Writes out/rank<r>.json."""
    global DEVICE, FULL
    DEVICE, FULL = setting
    import torch
    sys.path.insert(0, HERE)
    from dafoam_tpu_torch.mesh import box_hex_mesh
    from dafoam_tpu_torch.ops import dia_kernels as dk
    from dafoam_tpu_torch.parallel.halo import HaloMatvec, assert_replicated
    from dafoam_tpu_torch.parallel.shard import file_group
    from dafoam_tpu_torch.solvers import make_solver
    if DEVICE == "cpu":
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    res = {"rank": rank}
    # the local references run in the group's deterministic mode too
    with file_group(rdzv, rank, world, dev, SHARD_TIMEOUT) as group:
        pts, topo, _ = shard_box(box_hex_mesh, world)
        f64 = torch.float64
        hm = HaloMatvec(topo, world, device=dev, group=group)
        res["y"], res["vjp"] = halo_vs_plain(torch, hm, topo, dev, 11, f64)
        loc = HaloMatvec(topo, world, device=dev)
        ry, rg = halo_vs_plain(torch, loc, topo, dev, 11, f64)
        res["local_y"], res["local_vjp"] = ry, rg
        kw = dict(iters=SHARD_RANK_ITERS, sweeps=SHARD_RANK_FP, parts=world,
                  device=dev)
        want = fixed_work(torch, dk, make_solver, pts, topo, f64, **kw)
        got = fixed_work(torch, dk, make_solver, pts, topo, f64,
                         group=group, **kw)
        assert_replicated([got[k] for k in ("U", "psi", "nu", "points")],
                          group, "fixed-work result")
        res["fixed_work"] = {k: list(v) for k, v in
                             fixed_work_errors(got, want).items()}
        res["products"], res["s"] = got["products"], got["s"]
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)


def shard_nccl(torch, make_solver, dk, pts, topo):
    """Phase 20's distributed transport on the card: a 1-rank NCCL group
    in this process (HaloMatvec(group) with P = 1 against the unsharded
    product, and a short fixed-work run through shard_solver(group)
    against the local route, both inside the group's context, so both
    under the deterministic algorithms that file_group turns on for an
    NCCL group); on two or more cards, min(4, count) spawned NCCL
    ranks."""
    import multiprocessing
    import shutil
    import tempfile
    from dafoam_tpu_torch.parallel.halo import HaloMatvec
    from dafoam_tpu_torch.parallel.shard import file_group

    tmp = tempfile.mkdtemp(prefix="dafoam_shard_")
    try:
        with file_group(os.path.join(tmp, "rdzv1"), 0, 1, DEVICE,
                        SHARD_TIMEOUT) as group:
            hm = HaloMatvec(topo, 1, device=DEVICE, group=group)
            ey, eg = halo_vs_plain(torch, hm, topo, DEVICE, 13,
                                   torch.float64)
            kw = dict(iters=3, sweeps=2, parts=1)
            want = fixed_work(torch, dk, make_solver, pts, topo,
                              torch.float64, **kw)
            got = fixed_work(torch, dk, make_solver, pts, topo,
                             torch.float64, group=group, **kw)
        errs = fixed_work_errors(got, want)
        say(f"[shard] NCCL, 1 rank on this card: HaloMatvec(group) with "
            f"P = 1 against the unsharded product, y rel {ey:.3e}, vjp rel "
            f"{eg:.3e}; 3 fixed-work SIMPLE outers + 2 sweeps + totals "
            f"through shard_solver(group), {got['products']} products, "
            "against the local route (both with deterministic algorithms): "
            + ", ".join(f"{k} {e:.3e}" for k, (e, _) in errs.items())
            + ". P = 1 has no cut face: this moves no halo traffic, it "
            "only shows the NCCL transport wired together on CUDA "
            "(all-gather, all-reduce, autograd)")
        check(ey <= REL["float64"] and eg <= 1e-12,
              f"1-rank NCCL halo matvec: y {ey}, vjp {eg}")
        for k, (e, bar) in errs.items():
            check(e <= bar, f"1-rank NCCL fixed-work {k}: {e} > {bar}")

        n = torch.cuda.device_count()
        if n < 2:
            say("[shard] NCCL ranks across cards: not run (one card); the "
                "halo exchange between NCCL ranks runs only in a call "
                "with two or more cards")
            return
        world = min(4, n)
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_shard_rank,
                             args=(r, world, os.path.join(tmp, "rdzv"), tmp,
                                   (DEVICE, FULL)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.time() + SHARD_TIMEOUT
        for p in procs:
            p.join(max(1.0, deadline - time.time()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        check(codes == [0] * world, f"NCCL ranks exited {codes}")
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                res = json.load(fh)
            say(f"[shard] NCCL rank {r} of {world} (card {r}): "
                f"HaloMatvec(group) y rel {res['y']:.3e}, vjp rel "
                f"{res['vjp']:.3e} (local transport {res['local_y']:.3e}, "
                f"{res['local_vjp']:.3e}); {SHARD_RANK_ITERS} fixed-work "
                f"outers + {SHARD_RANK_FP} sweeps + totals in "
                f"{res['s']:.2f} s, {res['products']} products, against "
                "the local route: " + ", ".join(
                    f"{k} {e:.3e}" for k, (e, _) in
                    res["fixed_work"].items())
                + "; results bit-identical across ranks")
            check(max(res["y"], res["local_y"]) <= REL["float64"]
                  and max(res["vjp"], res["local_vjp"]) <= 1e-12,
                  f"NCCL rank {r}: {res}")
            for k, (e, bar) in res["fixed_work"].items():
                check(e <= bar, f"NCCL rank {r} fixed-work {k}: {e} > {bar}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def shard_timing(torch, dk, adjsolver, make_solver, pts, topo):
    """Phase 20's f32 times on both routes: ms per product (the halo
    product against the unsharded one on the same operands), per SIMPLE
    iteration and per fixed-point adjoint product, and, last, the device
    kernels of one SIMPLE iteration (profiler)."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from dafoam_tpu_torch.ops import fvmatrix as fvx
    from dafoam_tpu_torch.parallel import halo, shard_solver
    f32 = torch.float32
    runs = {}
    for route in ("unsharded", "halo"):
        opts = shard_options(primalMinIters=SHARD_TIME_ITERS,
                             primalMaxIters=SHARD_TIME_ITERS,
                             primalMinResTol=0.0,
                             adjEqnSolMethod="fixedPoint")
        s = make_solver(opts, dataclasses.replace(topo), pts, device=DEVICE,
                        dtype=f32)
        hm = shard_solver(s, SHARD_PARTS) if route == "halo" else None
        x = s.make_inputs()
        st0 = s.init_state()
        with overridden(s.option, primalMinIters=1, primalMaxIters=1):
            s.run_primal(st0, x)                             # warm
        s.solve_stats.clear()
        dk.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, info = s.run_primal(st0, x)
        torch.cuda.synchronize()
        it_ms = (time.perf_counter() - t0) / SHARD_TIME_ITERS * 1e3
        counts = dict(dk.COUNTS)
        kry = {k: v[1] / SHARD_TIME_ITERS for k, v in s.solve_stats.items()}
        nc, ni = s.topo.n_cells, s.topo.n_internal
        gen = torch.Generator(device=DEVICE).manual_seed(17)
        d, lo, up, xx = (torch.rand(k, generator=gen, device=DEVICE,
                                    dtype=f32) + c
                         for k, c in ((nc, 4.0), (ni, -1.0), (ni, -1.0),
                                      (nc, 0.0)))
        mv = fvx.matvec_fn(fvx.FvMatrix(d, lo, up, xx), s.topo)
        mv_ms = cuda_ms(torch, lambda: mv(xx))
        state = {k: v.detach() for k, v in st.items()}
        step = s._fp_step_fn()
        _, f_vjp = adjsolver.vjp(lambda w: step(w, x)[0], state)
        f_vjp(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            f_vjp(state)
        torch.cuda.synchronize()
        adj_ms = (time.perf_counter() - t0) / 2 * 1e3
        runs[route] = {"s": s, "x": x, "st": st, "hm": hm, "iter_ms": it_ms,
                       "krylov": kry, "mv_ms": mv_ms, "adj_ms": adj_ms,
                       "counts": counts}
    for route, r in runs.items():
        s = r["s"]
        with overridden(s.option, primalMinIters=1, primalMaxIters=1):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                s.run_primal(r["st"], r["x"])
                torch.cuda.synchronize()
        r["kernels"] = len(_kernel_events(prof))
        if r["hm"] is not None:
            halo.deactivate(s.topo)
    return runs


def phase_shard_full(torch, dk, adjsolver, make_solver, box, omesh_pts,
                     omesh_topo, stats):
    """Phase 20: the halo route at FULL x FULL (262,144 cells) in
    SHARD_PARTS RCB partitions; ``omesh_pts``, ``omesh_topo`` are phase
    5's O-mesh (canonical topology). Returns the launch counts of the f64
    fixed-work run on the halo route ("shard"), on the unsharded route
    ("shard_reference") and on the unsharded route of the 58-band
    relabelled box ("shard_banded")."""
    import numpy as np
    from dafoam_tpu_torch.parallel.halo import (HaloMatvec, build_halo_plan,
                                                exchanged_values)
    from dafoam_tpu_torch.parallel.partition import (cut_statistics,
                                                     reorder_for_partitions)
    t_phase = time.perf_counter()
    f64 = torch.float64
    pts, topo, t_reorder = shard_box(box, SHARD_PARTS)
    t0 = time.perf_counter()
    plan = build_halo_plan(topo, SHARD_PARTS)
    t_plan = time.perf_counter() - t0
    cut = cut_statistics(topo, np.arange(topo.n_cells) // plan.ncl)
    own = topo.owner[:topo.n_internal].astype(np.int64)
    bands = np.unique(np.concatenate([topo.neighbour - own,
                                      own - topo.neighbour])).size
    say(f"[shard] {FULL}x{FULL} cavity box ({topo.n_cells} cells) in "
        f"{SHARD_PARTS} RCB parts: reorder {t_reorder:.2f} s, halo plan "
        f"{t_plan:.3f} s; {bands} bands after the relabelling (the DIA "
        f"kernels take {dk.MAX_OFFSETS}); cut faces {plan.cut_faces} "
        f"({cut['cut_fraction']:.4f} of {topo.n_internal}), distances "
        f"{plan.dists}, per product {exchanged_values(plan)} values "
        f"exchanged ({exchanged_values(plan) * 4} B f32 scalar, "
        f"{exchanged_values(plan, 3) * 4} B f32 (nc, 3)), entries per "
        f"partition {plan.row.shape[1]}")
    check(cut["n_cut_faces"] == plan.cut_faces and plan.cut_faces > 0,
          "cut statistics disagree with the plan")

    want = fixed_work(torch, dk, make_solver, pts, topo, f64)
    got = fixed_work(torch, dk, make_solver, pts, topo, f64,
                     parts=SHARD_PARTS)
    errs = fixed_work_errors(got, want)
    say(f"[shard] f64 fixed work ({SHARD_ITERS} SIMPLE outers under "
        f"fixed_inner(1.0), {SHARD_FP} Richardson sweeps, lidF totals): "
        f"unsharded {want['s']:.2f} s, halo route {got['s']:.2f} s "
        f"({got['products']} halo products); J {got['J']!r} against "
        f"{want['J']!r}; " + ", ".join(f"{k} err {e:.3e} (bar {b:.1e})"
                                       for k, (e, b) in errs.items()))
    say(f"[shard] launch counts: halo route {got['counts']}; unsharded "
        f"{want['counts']}")
    for k, (e, bar) in errs.items():
        check(e <= bar, f"halo route f64 {k}: err {e} > {bar}")
    check(got["products"] > 0 and not any(got["counts"].values()),
          "the halo route ran a DIA product")

    t0 = time.perf_counter()
    to2, _ = reorder_for_partitions(omesh_topo, omesh_pts, SHARD_PARTS)
    t1 = time.perf_counter()
    hm = HaloMatvec(to2, SHARD_PARTS, device=DEVICE)
    t2 = time.perf_counter()
    ey, eg = halo_vs_plain(torch, hm, to2, DEVICE, 7, f64)
    say(f"[shard] {FULL}x{FULL} NACA0012 O-mesh in {SHARD_PARTS} parts: "
        f"reorder {t1 - t0:.2f} s, plan + tables {t2 - t1:.3f} s, cut faces "
        f"{hm.plan.cut_faces}, distances {hm.plan.dists}; one f64 halo "
        f"product against the unsharded one: y rel {ey:.3e}, vjp rel "
        f"{eg:.3e}")
    check(ey <= REL["float64"] and eg <= 1e-12,
          f"O-mesh halo product: y {ey}, vjp {eg}")

    runs = shard_timing(torch, dk, adjsolver, make_solver, pts, topo)
    for route, r in runs.items():
        say(f"[shard] f32 {route}: {r['mv_ms'] * 1e3:.1f} us per LDU product"
            f" (CUDA events), {r['iter_ms']:.2f} ms per SIMPLE iteration "
            f"(mean of {SHARD_TIME_ITERS}; Krylov iterations per SIMPLE "
            "iteration " + ", ".join(f"{k} {v:.1f}"
                                     for k, v in r["krylov"].items())
            + f"), {r['adj_ms']:.2f} ms per fixed-point adjoint product "
            f"(mean of 2), {r['kernels']} device kernels per SIMPLE "
            f"iteration (profiler); launch counts {r['counts']}")
    check(not any(runs["halo"]["counts"].values()),
          "the f32 halo route ran a DIA product")

    banded = shard_banded(torch, dk, make_solver, box, stats)
    shard_nccl(torch, make_solver, dk, pts, topo)
    say(f"[shard] phase 20 {time.perf_counter() - t_phase:.1f} s")
    return got["counts"], want["counts"], banded


def profile_unsteady(torch, hisa_run, pimple_run):
    """--profile: one AUSMPlusUp PTC iteration of phase 10 (its initial
    residual included), one PIMPLE time step and one reverse step of
    phase 11."""
    from dafoam_tpu_torch.adjoint.unsteady import at, unsteady_adjoint_totals
    hs, hx, hst = hisa_run
    h = dict(hs.option["hisa"], sequenceFlux=False)
    with overridden(hs.option, hisa=h, primalMinIters=1, primalMaxIters=1):
        profile_call(torch, f"one AUSMPlusUp PTC iteration ({HISA_NX}x"
                     f"{HISA_NY} bump, GMRES cap {HISA_INNER})",
                     lambda: hs.run_primal(hst, hx))
    ps, px, tail = pimple_run
    geom = ps.geometry(px)
    W = at(tail, 1)

    def step():
        with torch.no_grad():
            ps._step(W, px, geom, t=ps.dt)

    profile_call(torch, f"one PIMPLE time step ({FULL}x{FULL} cavity)", step)
    kw = ps._sweep_kw(px, "lidF", torch.zeros(1, dtype=ps.dtype,
                                               device=ps.device))
    profile_call(torch, f"one reverse step ({FULL}x{FULL} cavity, FGMRES "
                 f"cap {PIMPLE_GMRES}, segregated PC)",
                 lambda: unsteady_adjoint_totals(
                     ps.residuals_unsteady,
                     lambda w, x, n: ps.eval_function("lidF", w, x),
                     tail, **kw))


def profile_call(torch, label, fn):
    """One call of ``fn`` under the profiler: top kernels by device time,
    DIA kernels, host syncs and the device's busy share of the call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    key = "self_device_time_total" \
        if hasattr(ka[0], "self_device_time_total") else "self_cuda_time_total"
    say(f"[profile] {label}, top 10 by device time:")
    say(ka.table(sort_by=key, row_limit=10, max_name_column_width=48))
    kernels = _kernel_events(prof)
    dia = [e for e in kernels if "dia_" in e.name]
    syncs = sum(1 for e in prof.events()
                if e.name == "aten::_local_scalar_dense")
    busy_ms = sum(_event_us(e) for e in kernels) / 1e3
    say(f"[profile] {label}: {len(kernels)} device kernels ({len(dia)} DIA "
        f"kernels, {sum(_event_us(e) for e in dia) / 1e3:.3f} ms), host "
        f"syncs {syncs}, device busy {busy_ms:.2f} ms of {wall * 1e3:.2f} ms"
        " wall")


def residual_iteration(torch, adjsolver, s, inputs, st):
    """The work of one residual-form FGMRES iteration at full width, as a
    zero-argument call: one residual vjp on the recorded graph and one
    application of the segregated PC."""
    state = {k: v.detach() for k, v in st.items()}
    adj = dict(s.option["adjEqnOption"], pcType="segregated")
    with overridden(s.option, adjEqnSolMethod="Krylov", adjEqnOption=adj):
        pc = s.make_adjoint_pc(state, inputs)
    _, f_vjp = adjsolver.vjp(lambda w: s._norm_residuals(w, inputs), state)
    gen = torch.Generator(device=s.device).manual_seed(3)
    v = {k: torch.randn(t.shape, generator=gen, device=s.device,
                        dtype=t.dtype) for k, t in state.items()}
    return lambda: pc(f_vjp(v))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one SIMPLE iteration (Jacobi and mg "
                         "pressure PC), one adjoint product, one "
                         "residual-form iteration and one compressible "
                         "SIMPLE iteration at 512x512")
    args = ap.parse_args()

    t_start = time.perf_counter()
    import torch
    card = phase_device(torch)

    sys.path.insert(0, HERE)
    from dafoam_tpu_torch.adjoint import solver as adjsolver
    from dafoam_tpu_torch.mesh import box_hex_mesh
    from dafoam_tpu_torch.mesh.airfoil import omesh_naca0012
    from dafoam_tpu_torch.mesh.topology import from_dia_dense
    from dafoam_tpu_torch.ops import dia_kernels as dk
    from dafoam_tpu_torch.ops import fvmatrix as fvx
    from dafoam_tpu_torch.solvers import make_solver

    phase_build(dk)
    stats = {}
    s, inputs, st0 = setup_full(torch, make_solver, omesh_naca0012)
    real = phase_kernels(torch, dk, fvx, s, stats, FORWARD, "kernels")
    phase_kernels(torch, dk, fvx, s, stats, REVERSE, "k3")
    phase_functions(torch, dk, real)
    phase_golden(torch, dk, make_solver, omesh_naca0012)
    gstate, gwant = phase_golden_adjoint(torch, dk, make_solver,
                                         omesh_naca0012)
    phase_golden_residual(torch, dk, make_solver, omesh_naca0012, gstate,
                          gwant)
    phase_golden_implicit(torch, dk, make_solver, omesh_naca0012, gstate,
                          gwant)
    phase_golden_cavity(torch, dk, make_solver, box_hex_mesh)
    phase_golden_scalar(torch, dk, make_solver, box_hex_mesh)
    phase_golden_heat(torch, dk, make_solver, box_hex_mesh)
    phase_golden_rho(torch, dk, make_solver, box_hex_mesh)
    phase_golden_pimple(torch, dk, make_solver, box_hex_mesh)

    st, res1, info, dt, counts, cd = run_full(torch, dk, s, inputs, st0)
    per = {k: v[1] / ITERS for k, v in s.solve_stats.items()}
    say(f"[full] {ITERS} SIMPLE iterations in {dt:.2f} s = "
        f"{dt / ITERS * 1e3:.2f} ms/iter; max_res first "
        f"{res1:.4e} final {info.max_res:.4e}; CD {cd!r}")
    say(f"[full] Krylov iterations per SIMPLE iteration: "
        + ", ".join(f"{k} {v:.2f}" for k, v in per.items())
        + f"; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    say(f"[full] launch counts {counts}")
    check(info.iters == ITERS, "iteration count")
    check(s.states_valid(st), "state is not finite/valid")
    check(not info.failed, f"primal failed: {info}")
    check(info.max_res < res1,
          f"max_res did not fall: {res1} -> {info.max_res}")
    check(math.isfinite(cd), f"CD not finite: {cd}")
    check_counts(counts, "full width")

    line_counts, line_p = phase_pc_primal(torch, dk, s, inputs, st, "line",
                                          "line")
    mg_counts, _ = phase_pc_primal(torch, dk, s, inputs, st, "mg", "mg",
                                   line_p=line_p)
    adj_counts, f_vjp, psibar = phase_adjoint(torch, dk, adjsolver, s,
                                              inputs, st)
    res_counts = phase_residual_full(torch, dk, s, inputs, st)
    remat_counts = phase_remat(torch, dk, s, inputs, st)
    krylov_counts = phase_krylov_smoother(torch, dk, s, inputs, st)
    sst_counts, sst_adj_counts = phase_turb_full(torch, dk, adjsolver,
                                                 make_solver, s)
    model_counts = phase_turb_models(torch, dk, make_solver, s)
    s9, inputs9, st9, rho_counts, rho_adj_counts = phase_rho_full(
        torch, dk, make_solver, s)
    rhoc_counts = phase_rho_transonic(torch, dk, adjsolver, make_solver,
                                      s9, st9)
    hisa_counts, hisa_adj_counts, hisa_run = phase_hisa_full(
        torch, dk, make_solver, box_hex_mesh)
    (pimple_counts, pimple_adj_counts, pimple_ck_counts), pimple_run = \
        phase_pimple_full(torch, dk, make_solver, box_hex_mesh)
    rho_pimple_counts = phase_rho_pimple(torch, dk, make_solver, s9, st9)
    dym_counts, dym_adj_counts = phase_dym_full(torch, dk, make_solver, s,
                                                st)
    irk_counts, irk_adj_counts = phase_irk_full(torch, dk, make_solver,
                                                box_hex_mesh)
    ts_counts, ts_adj_counts = phase_ts_full(torch, dk, make_solver,
                                             box_hex_mesh)
    inter_counts, inter_adj_counts = phase_inter_full(torch, dk,
                                                      make_solver,
                                                      box_hex_mesh)
    shape_counts = phase_shape_opt(torch, dk, s, st)
    mphys_counts = phase_mphys(torch, dk, s, st)
    cpl_counts = phase_coupling_full(torch, dk)
    io_counts, io_adj_counts = phase_io_full(torch, dk, make_solver,
                                             omesh_naca0012, box_hex_mesh,
                                             s, inputs, st)
    shard_counts, shard_ref_counts, shard_banded_counts = phase_shard_full(
        torch, dk, adjsolver, make_solver, box_hex_mesh,
        s.points.double().cpu().numpy(), from_dia_dense(s.topo), stats)
    phase_kernel_times(torch, dk, real, stats)

    if args.profile:
        phase_profile(torch, s, inputs, st)
        profile_call(torch, "one dG^T v product", lambda: f_vjp(psibar))
        profile_call(torch, "one residual-form iteration (residual vjp + "
                     "segregated PC)",
                     residual_iteration(torch, adjsolver, s, inputs, st))
        lin = dict(s.option["primalLinearSolver"], pPC="mg")
        with overridden(s.option, primalLinearSolver=lin):
            profile_call(torch, "one SIMPLE iteration with pPC mg",
                         lambda: s.run_primal(st, inputs))
        with overridden(s9.option, primalMinIters=1, primalMaxIters=1):
            profile_call(torch, "one compressible SIMPLE iteration "
                         "(DARhoSimpleFoam + SA)",
                         lambda: s9.run_primal(st9, inputs9))
        profile_unsteady(torch, hisa_run, pimple_run)

    paths = {"primal": counts, "primal_line_pc": line_counts,
             "primal_mg_pc": mg_counts,
             "fixed_point_adjoint": adj_counts,
             **{f"residual_adjoint_{k}": v for k, v in res_counts.items()},
             "fixed_point_adjoint_fpRemat": remat_counts,
             "fixed_point_adjoint_krylov_smoother": krylov_counts,
             "kOmegaSST_primal": sst_counts,
             "kOmegaSST_fixed_point_adjoint": sst_adj_counts,
             **{f"{k}_primal": v for k, v in model_counts.items()},
             "rho_primal": rho_counts,
             "rho_residual_adjoint_segregated": rho_adj_counts,
             "rhoC_primal": rhoc_counts,
             "hisa_primal": hisa_counts, "hisa_adjoint": hisa_adj_counts,
             "pimple_primal": pimple_counts,
             "pimple_adjoint": pimple_adj_counts,
             "pimple_adjoint_checkpointed": pimple_ck_counts,
             "rho_pimple_primal": rho_pimple_counts,
             "dym_primal": dym_counts, "dym_adjoint": dym_adj_counts,
             "irk_primal": irk_counts, "irk_adjoint": irk_adj_counts,
             "inter_primal": inter_counts,
             "inter_adjoint": inter_adj_counts,
             "time_spectral_primal": ts_counts,
             "time_spectral_adjoint": ts_adj_counts,
             "shape_opt": shape_counts, "mphys": mphys_counts,
             **dict(zip(("cht_primal", "cht_adjoint", "fsi_primal",
                         "fsi_adjoint"), cpl_counts)),
             "io_primal": io_counts, "io_adjoint": io_adj_counts,
             "shard": shard_counts, "shard_reference": shard_ref_counts,
             "shard_banded": shard_banded_counts}
    rows = []
    for name, meta in KERNELS.items():
        st_k = stats[name]
        by_path = {p: c[name] for p, c in paths.items()}
        rows.append({"name": name, "route": "cuda",
                     "source": "dafoam_tpu_torch/csrc/dia_matvec.cu",
                     "replaces": meta["replaces"],
                     "launches": sum(by_path.values()),
                     "launches_by_path": by_path,
                     "max_abs_err": st_k["max_abs_err"],
                     "ms": st_k["ms"], "plain_ms": st_k["plain_ms"],
                     "bound_ms": st_k["bound_ms"],
                     "bound_by": st_k["bound_by"],
                     "library_ms": st_k["library_ms"]})
    say(f"[total] {time.perf_counter() - t_start:.1f} s wall for the "
        "whole script")
    say(json.dumps({"kernels": rows}))
    say(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
