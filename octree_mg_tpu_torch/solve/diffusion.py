"""Implicit diffusion solves via Helmholtz multigrid.

The port of the JAX package's ``solve/diffusion.py`` (the reference's
``m_diffusion.f90``): backward-Euler (order 1) and the 2nd-order scheme
for d(phi)/dt = div(D grad(phi)), for constant D (``diffusion_solve``
:19-60), cell-centred variable D in the coefficient field
(``diffusion_solve_vcoeff`` :66-108) and anisotropic D, one field per
direction (``diffusion_solve_acoeff`` :115-157).

Each solve runs one FMG cycle plus up to ``max_its`` V-cycles until the
residual target is met (:47-59), reading the residual on the host once
per cycle.  The drivers take the boxed ``MGSolver`` or any dense solver
(``DenseMGSolver`` and its subclasses: the dense-patch AMR solver and
the dense forest); the state is updated in place and returned.
"""
from __future__ import annotations

from typing import Tuple

from ..core.constants import IPHI, IRHS
from .multigrid import MGSolver


class DiffusionDivergenceError(RuntimeError):
    """Raised when the V-cycle loop fails to converge (the reference's
    ``error stop "diffusion_solve: no convergence"``)."""


def set_rhs_from_phi(solver: MGSolver, state, f1, f2):
    """rhs = f1*phi + f2*rhs on leaves of levels >= 1
    (set_rhs, m_diffusion.f90:159-173).  Dense solvers write whole
    patches on every level: leaf cells get the diffusion rhs (coarse
    AMR patches carry leaves outside the finer footprint), and
    non-leaf cells are overwritten by the FAS tau correction before
    they are read (update_coarse, m_multigrid.f90:347-384)."""
    from .dense import DenseMGSolver
    if isinstance(solver, DenseMGSolver):
        for lvl in solver.levels:
            new = (f1 * solver.interior(state, lvl, "phi")
                   + f2 * solver.interior(state, lvl, "rhs"))
            state = solver.set_interior(state, lvl, "rhs", new)
        return state
    isl = (slice(1, -1),) * solver.ndim
    dmaps = solver._to_device()
    for lvl in [l for l in solver.levels if l >= 1]:
        if len(solver.maps[lvl].leaf_locs) == 0:
            continue
        cc = state["cc"][lvl]
        leaves = dmaps[lvl]["leaf_locs"]
        new_vals = (f1 * cc[IPHI][(leaves,) + isl]
                    + f2 * cc[IRHS][(leaves,) + isl])
        cc[IRHS][(leaves,) + isl] = new_vals
    return state


def _solve_common(solver: MGSolver, state, lam, max_res: float,
                  max_its: int) -> Tuple[dict, float]:
    state, res = solver.fas_fmg(state, lam=lam, have_guess=True)
    for _ in range(max_its):
        if float(res) <= max_res:
            return state, float(res)
        state, res = solver.fas_vcycle(state, lam=lam)
    if float(res) > max_res:
        raise DiffusionDivergenceError(
            f"diffusion_solve: no convergence (residual {float(res)} > "
            f"{max_res}); did you specify boundary conditions correctly?")
    return state, float(res)


def diffusion_solve(solver: MGSolver, state, dt: float,
                    diffusion_coeff: float, order: int = 2,
                    max_res: float = 1e-10,
                    max_its: int = 10) -> Tuple[dict, float]:
    """Constant-coefficient implicit diffusion (m_diffusion.f90:19-60).

    ``solver`` must be configured with operator="helmholtz".  The solution
    at time t is read from phi and replaced by the solution at t+dt.
    """
    if solver.cfg.operator != "helmholtz":
        raise ValueError("diffusion_solve requires a helmholtz solver")
    return _diffusion_generic(solver, state, dt * diffusion_coeff, order,
                              max_res, max_its)


def diffusion_solve_vcoeff(solver: MGSolver, state, dt: float,
                           order: int = 2, max_res: float = 1e-10,
                           max_its: int = 10) -> Tuple[dict, float]:
    """Variable-coefficient implicit diffusion with D in the coefficient
    field (m_diffusion.f90:66-108).  D must be present on all levels
    (``solver.prepare_coefficient``)."""
    if solver.cfg.operator != "vhelmholtz":
        raise ValueError("diffusion_solve_vcoeff requires vhelmholtz")
    return _diffusion_generic(solver, state, dt, order, max_res, max_its)


def diffusion_solve_acoeff(solver: MGSolver, state, dt: float,
                           order: int = 2, max_res: float = 1e-10,
                           max_its: int = 10) -> Tuple[dict, float]:
    """Anisotropic implicit diffusion with D_d in coefficient field d
    (m_diffusion.f90:115-157)."""
    if solver.cfg.operator != "ahelmholtz":
        raise ValueError("diffusion_solve_acoeff requires ahelmholtz")
    return _diffusion_generic(solver, state, dt, order, max_res, max_its)


def _diffusion_generic(solver, state, dtD, order, max_res, max_its):
    from .dense import DenseMGSolver

    def apply_to_rhs(st):
        if isinstance(solver, DenseMGSolver):
            return solver.apply_operator(st, lam=0.0, out_key="rhs")
        return solver.apply_operator(st, lam=0.0, i_out=IRHS)

    if order == 1:
        lam = 1.0 / dtD
        state = set_rhs_from_phi(solver, state, -1.0 / dtD, 0.0)
    elif order == 2:
        state = apply_to_rhs(state)
        lam = 2.0 / dtD
        state = set_rhs_from_phi(solver, state, -2.0 / dtD, -1.0)
    else:
        raise ValueError("diffusion solve order should be 1 or 2")
    return _solve_common(solver, state, lam, max_res, max_its)
