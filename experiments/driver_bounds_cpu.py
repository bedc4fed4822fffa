#!/usr/bin/env python3
"""The CPU runs that ``chip_smoke.py``'s free_space_path and
diffusion_path gates are derived from, at sizes a CPU runs.

    python experiments/driver_bounds_cpu.py [free_space|diffusion ...]

free_space: ``make_free_space`` over ``build_rectangle(n^3, box 16)``
in float32 (IGF kernel), the Gaussian charge of tests/test_free_space.py
on the top level, five solves (the first ``new_rhs=True``): the max
error against erf(r/sigma)/(4 pi r) per solve, at n = 64 and 128.

diffusion: ``diffusion_solve_vcoeff``, order 2, dt 0.01, on
``PoissonSolver(3, (n,)*3, 16 or 8, operator="vhelmholtz")`` in float32
with Neumann-0 walls, eps 1 + 0.5 cos(2 pi x) and phi0 = solution + 2
(diffusion_path's set-up), three steps to a target no step misses
(1e30, so each step is one FMG): the mass drift (summed in float64)
after each step, then six more V-cycles on the last step's system and
the largest of the last three residuals (diffusion_path's
``measured_floor``), at n = 32, 64 and 128.

Prints one JSON line per run.  PyTorch on the CPU only; a few minutes.
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import octree_mg_tpu_torch as pkg  # noqa: E402
from octree_mg_tpu_torch.solve import diffusion as dfm  # noqa: E402
from octree_mg_tpu_torch.solve import free_space as fsm  # noqa: E402


def free_space(n, n_solves=5):
    dsz = np.full(3, n)
    sv = pkg.make_solver(pkg.build_rectangle(3, dsz, 16, 1.0 / dsz,
                                             np.zeros(3)),
                         pkg.MGConfig(operator="laplacian",
                                      dtype=torch.float32, device="cpu"))
    fs = fsm.make_free_space(sv)
    state = sv.allocate()
    top = sv.levels[-1]
    sv.set_interior(state, top, "rhs", cs._field(sv, top, cs.fs_rhs, "cpu"))
    sol = cs._field(sv, top, cs.fs_solution, "cpu")
    errs, res = [], []
    for i in range(n_solves):
        state, r = fs.solve(state, new_rhs=(i == 0))
        res.append(float(r))
        phi = sv.interior(state, top, "phi")
        errs.append(float((phi.double() - sol).abs().max()))
    return {"free_space": n, "fft_lvl": fs.fft_lvl, "max_err": errs,
            "residuals": res}


def diffusion(n, n_steps=3, dt=0.01):
    ps = pkg.PoissonSolver(3, (n,) * 3, 16 if n >= 64 else 8,
                           operator="vhelmholtz", dtype=torch.float32,
                           device="cpu")
    sv = ps.solver
    ps.set_neumann(0.0)
    state = ps._ensure_state()
    top = sv.levels[-1]
    sv.set_coefficient(state, cs._field(sv, top, lambda x, y, z: 1.0 + 0.5
                                        * torch.cos(2 * np.pi * x), "cpu"))
    sv.prepare_coefficient(state)
    sv.set_interior(state, top, "phi", cs._field(sv, top, cs.diffusion_phi0,
                                                 "cpu"))
    mass0 = float(sv.interior(state, top, "phi").double().sum())
    drift, res = [], []
    for _ in range(n_steps):
        state, r = dfm.diffusion_solve_vcoeff(sv, state, dt, order=2,
                                              max_res=1e30)
        res.append(r)
        mass = float(sv.interior(state, top, "phi").double().sum())
        drift.append((mass - mass0) / mass0)
    lam = sv._lam(2.0 / dt)
    floor = []
    for _ in range(6):
        state, r = sv.fas_vcycle(state, lam=lam)
        floor.append(float(r))
    return {"diffusion": n, "step_residuals": res, "mass_drift_rel": drift,
            "floor_vcycles": floor, "measured_floor": max(floor[-3:])}


def main(argv):
    what = argv or ["free_space", "diffusion"]
    if "free_space" in what:
        for n in (64, 128):
            print(json.dumps(free_space(n)), flush=True)
    if "diffusion" in what:
        for n in (32, 64, 128):
            print(json.dumps(diffusion(n)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
