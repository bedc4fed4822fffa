"""High-level Poisson/Helmholtz solver model.

Convenience front end over the solvers ``make_solver`` picks, covering
the reference's test program workflows (tests/test_uniform_grid.f90,
test_refinement.f90) as a library API: build tree -> set BCs -> set rhs
-> solve to tolerance.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.constants import IPHI, IRHS, BCType
from ..core.tree import Tree, build_rectangle
from ..solve.dense import make_solver
from ..solve.multigrid import MGConfig, MGSolver


class PoissonSolver:
    """Solve A(phi) = rhs on a uniform rectangular grid, or on a tree
    passed as ``tree``, with the solver ``make_solver`` picks.

    For a dense solver ``solve``/``phi`` return the assembled global
    interior array [Z, Y, X] ([Y, X] in 2D; a 2D AMR solver's top patch)
    — on a forest the top level's canvas, whose
    cells outside ``solver.footprint_mask(top)`` are garbage, and
    ``solve``'s residual is the max-norm over the footprint cells.  For
    the boxed solver (``MGSolver``: 1D, Jacobi, fully periodic sparse
    trees, ...) they return the top level's ghost-padded per-box plane
    [n_boxes, (nc+2)^D].  The solver runs on ``device`` ("cuda" unless
    told otherwise) through the hand-written kernels.

    Example::

        ps = PoissonSolver(ndim=3, domain_size=(256,)*3, box_size=16,
                           dtype=torch.float32)
        ps.set_dirichlet(0.0)
        ps.set_rhs(rhs_fn=lambda x: ...)
        phi, info = ps.solve()
    """

    def __init__(self, ndim: int, domain_size: Sequence[int], box_size: int,
                 dr: Optional[Sequence[float]] = None,
                 r_min: Optional[Sequence[float]] = None,
                 periodic: bool | Sequence[bool] = False,
                 operator: str = "laplacian", geometry: str = "cartesian",
                 dtype: torch.dtype = torch.float64,
                 tree: Optional[Tree] = None, device: str = "cuda",
                 **cfg_kwargs):
        domain_size = np.asarray(domain_size, np.int64)
        if dr is None:
            dr = 1.0 / domain_size
        if r_min is None:
            r_min = np.zeros(ndim)
        if isinstance(periodic, bool):
            periodic = [periodic] * ndim
        if tree is None:
            tree = build_rectangle(ndim, domain_size, box_size, dr, r_min,
                                   periodic)
        self.tree = tree
        self.solver = make_solver(tree, MGConfig(operator=operator,
                                                 geometry=geometry,
                                                 dtype=dtype, device=device,
                                                 **cfg_kwargs))
        self.dense = not isinstance(self.solver, MGSolver)
        self.state = None
        self._refined = None   # (bc_values, RefinedPoisson) of solve_refined

    # -- BCs ------------------------------------------------------------
    def _set_bc(self, *args, **kwargs):
        self.solver.set_bc(*args, **kwargs)
        self._refined = None
        if self.state is not None:
            # the state's boundary planes were evaluated at allocation
            sv = self.solver
            for lvl in sv.levels:
                self.state["bc"][lvl] = (sv._eval_bc_planes(lvl)
                                         if self.dense
                                         else sv._eval_bc_values(lvl))

    def set_dirichlet(self, value=0.0, fn: Optional[Callable] = None):
        self._set_bc(IPHI, BCType.DIRICHLET, value=value, fn=fn)

    def set_neumann(self, value=0.0, fn: Optional[Callable] = None):
        self._set_bc(IPHI, BCType.NEUMANN, value=value, fn=fn)

    def set_continuous(self):
        self._set_bc(IPHI, BCType.CONTINUOUS)

    # -- problem data ---------------------------------------------------
    def _ensure_state(self):
        if self.state is None:
            self.state = self.solver.allocate()
        return self.state

    def set_rhs(self, rhs_fn: Optional[Callable] = None,
                arrays: Optional[dict] = None):
        """rhs from a coordinate function x[...,D]->f (evaluated on every
        level) or explicit per-level arrays (numpy arrays or tensors):
        the interior [Z, Y, X] for a dense solver, the per-box interiors
        [n_boxes, (nc,)*D] for the boxed solver."""
        state = self._ensure_state()
        sv = self.solver
        if not self.dense:
            isl = (slice(None),) + (slice(1, -1),) * sv.ndim
            for lvl in sv.levels:
                if arrays is not None and lvl in arrays:
                    vals = arrays[lvl]
                elif rhs_fn is not None:
                    vals = np.asarray(rhs_fn(sv.cell_centers(lvl)[isl]))
                else:
                    continue
                state["cc"][lvl][IRHS][isl] = torch.as_tensor(
                    vals, dtype=sv.cfg.dtype, device=sv.device)
            return
        for lvl in sv.levels:
            if arrays is not None and lvl in arrays:
                vals = arrays[lvl]
            elif rhs_fn is not None:
                vals = np.asarray(rhs_fn(sv.cell_centers(lvl)))
            else:
                continue
            sv.set_interior(state, lvl, "rhs", vals)

    # -- solve ----------------------------------------------------------
    def solve(self, lam: float = 0.0, rtol: float = 1e-8,
              atol: float = 0.0, max_cycles: int = 50,
              use_fmg: bool = True) -> Tuple[torch.Tensor, dict]:
        """Cycle until the residual drops below max(rtol*initial, atol).

        The first cycle is a zero-guess FMG, every later one continues
        from the current phi.  Each cycle reads its residual back to the
        host (one device synchronization per cycle; the boxed solver's
        coarse loop reads one more per coarse iteration).  Returns
        (top-level phi, info dict): the interior [Z, Y, X] of a dense
        solver, the ghost-padded per-box plane of the boxed solver.
        """
        state = self._ensure_state()
        sv = self.solver
        history = []
        res0 = None
        for it in range(max_cycles):
            if use_fmg:
                state, res = sv.fas_fmg(state, lam=lam, have_guess=(it > 0))
            else:
                state, res = sv.fas_vcycle(state, lam=lam)
            r = float(res)
            history.append(r)
            if res0 is None:
                res0 = max(r, 1e-300)
            if r < max(rtol * res0, atol):
                break
        self.state = state
        info = {"residuals": history, "cycles": len(history)}
        top = sv.levels[-1]
        if not self.dense:
            return state["cc"][top][IPHI], info
        return sv.interior(state, top, "phi"), info

    def phi(self, lvl: Optional[int] = None) -> np.ndarray:
        lvl = self.solver.levels[-1] if lvl is None else lvl
        if not self.dense:
            return self.state["cc"][lvl][IPHI].cpu().numpy()
        return self.solver.interior(self.state, lvl, "phi").cpu().numpy()

    # -- f64-class solve with float32 kernels ------------------------------
    def solve_refined(self, rhs, n_outer: int = 8, rtol: float = 0.0,
                      bc_values: Optional[Sequence[float]] = None
                      ) -> Tuple[np.ndarray, dict]:
        """Iteratively refined solve to the f64 accuracy class with
        float32 kernels and float32 fields (solve/refine.RefinedPoisson,
        or RefinedPoisson2D for a dense 2D solver, as the JAX package
        picks; the reference is float64 throughout,
        m_data_structures.f90:8).

        ``rhs``: a float64 interior array [Z, Y, X] ([Y, X] in 2D; split
        into an exact float32 pair), or an (rhs_hi, rhs_lo) float32 pair.
        Requires ``dtype=torch.float32`` and the df32 gate (power-of-two
        1/dx^2, constant-coefficient laplacian —
        ``octree_mg_tpu_torch.df32_ok`` / ``df32_ok_2d``; a 2D AMR
        solver's refinement faces fail the 2D gate, as in the JAX
        package).  Inhomogeneous boundary values go through
        ``bc_values`` (2*ndim face constants); the solver's own BCs must
        be set with value 0 (the inner loop solves the homogeneous error
        equation).  Returns (phi as float64 numpy, info with the
        f64-class outer-residual history).

        The refinement instance and its buffers are kept between calls
        with the same ``bc_values``."""
        from ..ops.df32 import split_f64
        from ..solve.dense2d import Dense2DMGSolver
        from ..solve.refine import RefinedPoisson, RefinedPoisson2D
        if not self.dense:
            raise ValueError("solve_refined requires a dense fast path")
        state = self._ensure_state()
        if isinstance(rhs, tuple):
            rhs_hi, rhs_lo = rhs
        else:
            rhs_hi, rhs_lo = split_f64(np.asarray(rhs, np.float64))
        key = None if bc_values is None else tuple(float(v) for v in bc_values)
        if self._refined is None or self._refined[0] != key:
            cls = (RefinedPoisson2D
                   if isinstance(self.solver, Dense2DMGSolver)
                   else RefinedPoisson)
            self._refined = (key, cls(self.solver, bc_values=bc_values))
        rp = self._refined[1]
        xhi, xlo, norms, state = rp.solve(state, rhs_hi, rhs_lo,
                                          n_outer=n_outer, rtol=rtol)
        self.state = state
        phi = xhi.double().add_(xlo).cpu().numpy()
        return phi, {"residuals": norms, "cycles": len(norms) - 1}
