"""f64-class iterative refinement around the float32 dense solver.

The Fortran reference solves in float64 end to end
(m_data_structures.f90:8); a float32 FMG reaches its residual floor at
~1e-6 relative.  This module recovers the f64 accuracy class with
float32 kernels and float32 memory:

    x = 0 (double-float pair)
    repeat:  r = rhs - A(x)      exact double-float residual (ops/df32)
             solve A e = r       one zero-guess float32 FMG
             x += e              double-float accumulation

Because A is linear and the FMG contracts the residual by a constant
factor per cycle, the true (f64-class) residual keeps contracting at
that rate far past the float32 floor.

Gating: ``ops.df32.df32_ok`` (power-of-two 1/dx^2, constant-coefficient
laplacian or helmholtz — lam rides an exact TwoProduct — and exact BC
coefficient classes), or for the variable-coefficient operators
``ops.df32.df32_vcoeff_ok``: their residual is evaluated in double-float
pair arithmetic (``residual_df32_vcoeff``, plain PyTorch ops, ~2^-47
relative) from the float64 coefficient fields split into float32 pairs,
and the hi parts are installed on the inner solver.

``ShardedRefinedPoisson`` refines over the z-slab solver
(``ShardedDenseMGSolver``): the same outer loop on the slab layout, the
halos of x_hi and x_lo exchanged before the double-float residual runs
slab by slab with each slab's z gates, its norm a max over the slabs.
Constant coefficients only, as in the JAX package.  The single-canvas
dense forest refines through ``RefinedForestPoisson``
(solve/refine_forest.py), which ``solve_refined`` picks for it; a
multi-canvas forest is refused, as in the JAX package.

``RefinedPoisson2D`` refines the uniform dense 2D solver
(``Dense2DMGSolver``): the same loop on unpadded [Y, X] fields with the
2D double-float residual (``ops.df32.residual_df32_2d``), its step eager
torch ops.  The 2D dense-patch AMR solver, which the JAX package rebuilds
as a 2D forest for this, and the 2D forests wait for ROADMAP A10b.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..ops import dense_kernels as dk
from ..ops.df32 import (_cb_pairs, accumulate_df32_, df32_ok, df32_ok_2d,
                        df32_vcoeff_ok, residual_df32_2d,
                        residual_df32_dense, residual_df32_vcoeff,
                        split_f64, split_lam)
from .dense import DenseMGSolver, _ISL


class Df32GateError(ValueError, AssertionError):
    """A solver outside the double-float residual's gates (``df32_ok``,
    ``df32_vcoeff_ok``).  The JAX package asserts these gates, so this
    is an ``AssertionError`` as there, and a ``ValueError`` as the other
    refusals of this module (a dense-patch AMR solver meets it: its top
    level's refinement faces are plane-valued)."""


class RefinedPoisson:
    """Iteratively refined solve on the dense solver's top level.

    The instance owns the double-float solution pair, the padded
    right-hand-side pair and the accumulation's scratch (seven padded
    float32 fields); they are allocated once and reused across ``solve``
    calls.  The solver's state is updated in place, as everywhere in
    this package.

    lam: Helmholtz lam (lap(phi) - lam*phi = f, m_helmholtz.f90) — the
    residual's +lam*x term rides an exact Dekker TwoProduct with lam
    split on the host into a double-float pair (ops.df32.split_lam), so
    Helmholtz solves reach the same f64 accuracy class as Poisson.
    Requires a helmholtz-family solver (helmholtz, vhelmholtz,
    ahelmholtz) when lam != 0 (the inner FMG must smooth with the same
    lam).

    nch: the JAX package's z-chunk count of its whole-array residual;
    unused here (the kernel needs no chunking and the chunked plain form
    is still to be ported), kept for signature parity.

    eps: the float64 coefficient fields of a variable-coefficient
    solver, n_eps interior arrays [Z, Y, X] (numpy, or float64 tensors on
    any device); required for such a solver and refused for a
    constant-coefficient one.  They are split into float32 pairs for the
    outer residual; ``solve`` installs the hi parts on the inner solver
    (``set_coefficient`` + ``prepare_coefficient``) so that the inner FMG
    preconditions with the outer operator.
    """

    def __init__(self, solver: DenseMGSolver, nch: Optional[int] = None,
                 bc_values: Optional[List[float]] = None,
                 lam: float = 0.0, eps=None):
        from .dense_forest import DenseForestMGSolver
        if isinstance(solver, DenseForestMGSolver):
            raise NotImplementedError(
                "RefinedPoisson refines a single top level; a forest "
                "solver refines through RefinedForestPoisson "
                "(solve/refine_forest.py; solve_refined picks it)")
        self.solver = solver
        self.lam = float(lam)
        self.lam_pair = split_lam(lam)
        if self.lam != 0.0 and solver.cfg.operator not in (
                "helmholtz", "vhelmholtz", "ahelmholtz"):
            raise ValueError("lam != 0 needs a helmholtz-family "
                             "inner solver (got %r)" % solver.cfg.operator)
        top = solver.levels[-1]
        self.top = top
        cfg = solver._kcfgs[top]
        if cfg.dtype != torch.float32:
            raise ValueError("RefinedPoisson refines a float32 inner "
                             "solver (build with MGConfig(dtype="
                             "torch.float32)); got %s" % cfg.dtype)
        self.n_eps = int(cfg.n_eps)
        if self.n_eps:
            # variable-coefficient operators: double-float pair
            # arithmetic (~2^-47 relative — f64-class but not error-free)
            if not df32_vcoeff_ok(cfg):
                raise Df32GateError("rhs/operator outside the df32 vcoeff "
                                 "gate (ops.df32.df32_vcoeff_ok)")
            if eps is None:
                raise ValueError(
                    "variable-coefficient refinement needs the float64 "
                    "coefficient fields: eps=[interior float64 array] * "
                    "n_eps (split into double-float pairs here; the hi "
                    "parts are installed on the inner solver)")
            if len(eps) != self.n_eps:
                raise ValueError(f"eps: {len(eps)} fields given, operator "
                                 f"{solver.cfg.operator!r} has "
                                 f"{self.n_eps}")
        else:
            if not df32_ok(cfg):
                raise Df32GateError("rhs/operator outside the df32 gate "
                                 "(ops.df32.df32_ok)")
            if eps is not None:
                raise ValueError("eps= given for a constant-coefficient "
                                 "solver (operator %r)"
                                 % solver.cfg.operator)
        # Refinement solves the error equation, which is HOMOGENEOUS:
        # the inner FMG must carry b = 0 on every face (else each outer
        # pass re-adds the boundary offset and the loop stalls at the
        # inhomogeneity).  The TRUE boundary values enter through the
        # outer residual only (bc_values -> the c0*b pairs of ops.df32).
        for nb in range(6):
            if cfg.periodic[nb // 2]:
                continue
            if float(cfg.b_const[nb]) != 0.0:
                raise ValueError(
                    "inner solver must have homogeneous (b=0) BCs; set "
                    "the boundary value to 0 on the solver and pass the "
                    "true values via bc_values= (face %d has b=%r)"
                    % (nb, cfg.b_const[nb]))
        self.cbs = _cb_pairs(cfg, bc_values)
        self.cfg = cfg
        X, Y, Z = (int(v) for v in solver.dims[top])
        self.shape = (Z, Y, X)
        self.nch = nch
        self.pshape = dk.padded_shape(solver.dims[top])
        self._buffers = None
        self._graph = None      # the captured outer (fmg_mode="fused")
        self._warm = False
        #: (eps_hi, eps_lo) padded float32 pairs of the coefficients,
        #: periodic pads synced once (residual_df32_vcoeff reads them)
        self._eps_pairs = tuple(
            tuple(dk.sync_pads(cfg, self.pad(h)) for h in split_f64(a))
            for a in (eps if self.n_eps else ()))

    # -- buffers ---------------------------------------------------------
    def _alloc(self):
        if self._buffers is None:
            self._buffers = [
                torch.zeros(self.pshape, dtype=torch.float32,
                            device=self.solver.device) for _ in range(7)]
        (self.x_hi, self.x_lo, self.rhs_hi, self.rhs_lo,
         *self._scratch) = self._buffers

    def pad(self, v, out=None):
        """Interior values [Z, Y, X] in a padded float32 field (``out``,
        or a new zero-padded one) on the solver's device."""
        if out is None:
            out = torch.zeros(self.pshape, dtype=torch.float32,
                              device=self.solver.device)
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        out[_ISL] = v.to(out.device, torch.float32)
        return out

    # -- one outer iteration ---------------------------------------------
    def _residual_norm(self, state):
        """r = rhs - A(x) into the inner solver's top-level rhs, as it
        is (garbage pads); returns max |r| over the interior as a 0-dim
        tensor on the device, not read back here."""
        solver, top = self.solver, self.top
        if self.n_eps:
            # plain PyTorch ops, like the JAX package's plain XLA: they
            # read the periodic z/y pads of x on every device (the
            # kernels below read wrapped indices instead)
            dk.sync_pads(self.cfg, self.x_hi)
            dk.sync_pads(self.cfg, self.x_lo)
            r = state["rhs"][top]
            r.copy_(residual_df32_vcoeff(
                self.cfg, self.x_hi, self.x_lo, self.rhs_hi, self.rhs_lo,
                self._eps_pairs, cbs=self.cbs, lam_pair=self.lam_pair))
        else:
            solver._sync_pads(self.x_hi, top)
            solver._sync_pads(self.x_lo, top)
            r = residual_df32_dense(self.cfg, self.x_hi, self.x_lo,
                                    self.rhs_hi, self.rhs_lo, cbs=self.cbs,
                                    lam_pair=self.lam_pair,
                                    out=state["rhs"][top])
        return torch.linalg.vector_norm(r[_ISL], float("inf"))

    def _outer(self, state):
        """Exact residual, zero-guess inner FMG on it, double-float
        accumulation of the correction.  Returns the residual norm."""
        solver = self.solver
        mx = self._residual_norm(state)
        solver._fmg(state, solver._lam(self.lam), have_guess=False,
                    need_res=False)
        accumulate_df32_(self.x_hi, self.x_lo, state["phi"][self.top],
                         self._scratch)
        return mx

    def _run_outer(self, state):
        """One outer: eager launches, or — with
        ``MGConfig.fmg_mode="fused"`` on the card — one replay of the
        CUDA graph captured at the second call (the first runs eagerly
        and warms every lazily built piece)."""
        solver = self.solver
        if not solver._graphs_on(state):
            return self._outer(state)
        if self._graph is not None and self._graph.matches(solver, state):
            return self._graph.replay().clone()
        if not self._warm:
            self._warm = True
            return self._outer(state)
        self._graph = solver._capture(state, lambda: self._outer(state))
        return self._graph.replay().clone()

    # -- the loop --------------------------------------------------------
    @torch.no_grad()
    def prepare(self, state, rhs_hi, rhs_lo):
        """Set-up of a solve: the rhs pair padded in, x zeroed, and for
        a variable-coefficient solver the hi parts of the coefficients
        installed on the inner solver (the inner FMG preconditions with
        them; their coarse chain and the probed coarse matrix are
        rebuilt from them)."""
        solver = self.solver
        self._alloc()
        self.pad(rhs_hi, out=self.rhs_hi)
        self.pad(rhs_lo, out=self.rhs_lo)
        if self.n_eps:
            for i, (e_hi, _) in enumerate(self._eps_pairs):
                solver.set_coefficient(state, e_hi[_ISL], i)
            solver.prepare_coefficient(state)
        solver._ensure_direct(state)
        self.x_hi.zero_()
        self.x_lo.zero_()

    @torch.no_grad()
    def solve(self, state, rhs_hi, rhs_lo, n_outer: int = 8,
              rtol: float = 0.0):
        """rhs_hi/rhs_lo: interior [Z, Y, X] float32 pair
        (``ops.df32.split_f64`` converts a float64 rhs).  Returns
        (x_hi, x_lo interior views of the instance's buffers,
        residual-max history, state).  :meth:`prepare`, then
        :meth:`iterate`."""
        self.prepare(state, rhs_hi, rhs_lo)
        return self.iterate(state, n_outer, rtol)

    @torch.no_grad()
    def iterate(self, state, n_outer: int = 8, rtol: float = 0.0):
        """The outer loop of a prepared solve; returns what ``solve``
        returns.

        The loop is [residual, FMG, accumulate] x n_outer and a closing
        residual: the JAX package's [accumulate, residual, FMG] loop
        with its first, empty accumulation dropped.  With ``rtol == 0``
        no value is read back inside the loop: the norms stay 0-dim
        device tensors until the end, and the host runs ahead of the
        card.  With ``rtol > 0`` each outer reads its norm and the loop
        ends at the first one at or below ``rtol * norms[0]``."""
        norms_dev: List[torch.Tensor] = []
        for _ in range(n_outer):
            norms_dev.append(self._run_outer(state))
            if rtol and float(norms_dev[-1]) <= rtol * float(norms_dev[0]):
                break
        norms_dev.append(self._residual_norm(state))
        norms = [float(m) for m in torch.stack(norms_dev).cpu()]
        x_hi, x_lo = self._interior(self.x_hi), self._interior(self.x_lo)
        return x_hi, x_lo, norms, state

    def _interior(self, a):
        """The interior [Z, Y, X] of one of the instance's padded fields."""
        return a[_ISL]


class ShardedRefinedPoisson(RefinedPoisson):
    """Iterative refinement over :class:`ShardedDenseMGSolver` (the JAX
    package's ``ShardedRefinedPoisson``): the instance's fields take the
    solver's top-level layout (slab-stacked when that level is sharded);
    each outer accumulates, exchanges the z halos (and syncs the y pads
    on the CPU) of x_hi and x_lo, runs the double-float residual slab by
    slab with the slab's z gates, takes the max over the slabs and
    writes the rhs; the inner FMG is the slab solver's own.  Constant
    coefficients only: the variable-coefficient refined solve is outside
    the sharded refined gate, in both packages."""

    def __init__(self, solver, bc_values: Optional[List[float]] = None,
                 lam: float = 0.0):
        from .dense_shard import ShardedDenseMGSolver
        if not isinstance(solver, ShardedDenseMGSolver):
            raise TypeError("ShardedRefinedPoisson refines a "
                            "ShardedDenseMGSolver")
        if solver.n_eps:
            raise ValueError(
                "ShardedRefinedPoisson: constant coefficients only (the "
                "variable-coefficient refined solve is outside the sharded "
                "refined gate, as in the JAX package)")
        super().__init__(solver, bc_values=bc_values, lam=lam)
        self.sharded_top = solver.sharded[self.top]
        self.pshape = solver._field_shape(self.top)

    def pad(self, v, out=None):
        if not self.sharded_top:
            return super().pad(v, out)
        if out is None:
            out = torch.zeros(self.pshape, dtype=torch.float32,
                              device=self.solver.device)
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        Z, Y, X = self.shape
        K = self.solver.K
        out[(slice(None),) + _ISL] = v.to(out.device, torch.float32).reshape(
            K, Z // K, Y, X)
        return out

    def _interior(self, a):
        if not self.sharded_top:
            return a[_ISL]
        return a[(slice(None),) + _ISL].reshape(self.shape)

    def _residual_norm(self, state):
        if not self.sharded_top:
            return super()._residual_norm(state)
        solver, top = self.solver, self.top
        solver._sync_pads(self.x_hi, top)
        solver._sync_pads(self.x_lo, top)
        r = state["rhs"][top]
        for i, s in enumerate(solver.comm.shards):
            residual_df32_dense(self.cfg, self.x_hi[i], self.x_lo[i],
                                self.rhs_hi[i], self.rhs_lo[i], cbs=self.cbs,
                                lam_pair=self.lam_pair, out=r[i],
                                z_gates=solver._gates(top, s))
        per_slab = r[(slice(None),) + _ISL].abs().amax(dim=(1, 2, 3))
        return solver.comm.max(per_slab)


class RefinedPoisson2D:
    """Iterative refinement on the dense 2D [Y, X] path (the JAX
    package's ``RefinedPoisson2D``): the outer loop of
    :class:`RefinedPoisson` with the 2D double-float residual, each step
    (accumulate, residual, its max) eager torch ops on the solver's
    device; the inner FMG is the solver's own ``fas_fmg`` (a CUDA graph
    with ``fmg_mode="fused"``).

    The instance owns the double-float solution pair, the right-hand-side
    pair, the first (zero) correction and the accumulation's scratch
    (eight float32 [Y, X] fields), allocated once and reused across
    ``solve`` calls; the solver's state is updated in place.  Its gates
    raise as the JAX package's do: ``ValueError`` for lam without a
    helmholtz solver, a float64 solver and inhomogeneous inner BCs, and
    :class:`Df32GateError` (an ``AssertionError``) outside
    ``df32_ok_2d``, which refuses every refinement face (a 2D dense-patch
    AMR solver's top level)."""

    def __init__(self, solver, bc_values: Optional[List[float]] = None,
                 lam: float = 0.0):
        from .dense2d import Dense2DMGSolver
        if not isinstance(solver, Dense2DMGSolver):
            raise AssertionError(f"RefinedPoisson2D refines a "
                                 f"Dense2DMGSolver, got "
                                 f"{type(solver).__name__}")
        self.solver = solver
        self.lam = float(lam)
        self.lam_pair = split_lam(lam)
        if self.lam != 0.0 and solver.cfg.operator != "helmholtz":
            raise ValueError("lam != 0 needs an operator='helmholtz' "
                             "inner solver (got %r)" % solver.cfg.operator)
        top = solver.levels[-1]
        self.top = top
        cfg = solver._kcfgs[top]
        if cfg.dtype != torch.float32:
            raise ValueError("RefinedPoisson2D refines an f32 inner "
                             "solver; got %s" % cfg.dtype)
        if not df32_ok_2d(cfg):
            raise Df32GateError("rhs/operator outside the 2D df32 gate")
        for nb in range(4):
            if cfg.periodic[nb // 2]:
                continue
            if float(cfg.b_const[nb]) != 0.0:
                raise ValueError(
                    "inner solver must have homogeneous (b=0) BCs; pass "
                    "the true values via bc_values= (face %d has b=%r)"
                    % (nb, cfg.b_const[nb]))
        self.cbs = _cb_pairs(cfg, bc_values)
        self.cfg = cfg
        self.shape = self.pshape = (cfg.Y, cfg.X)
        self._buffers = None

    def _alloc(self):
        if self._buffers is None:
            self._buffers = [
                torch.zeros(self.pshape, dtype=torch.float32,
                            device=self.solver.device) for _ in range(8)]
        (self.x_hi, self.x_lo, self.rhs_hi, self.rhs_lo, self._e0,
         *self._scratch) = self._buffers

    def _step(self, state, e32):
        """Accumulate the correction, then the exact residual into the
        inner solver's top-level rhs; returns max |r| as a 0-dim tensor
        on the device."""
        accumulate_df32_(self.x_hi, self.x_lo, e32, self._scratch)
        r = residual_df32_2d(self.cfg, self.x_hi, self.x_lo, self.rhs_hi,
                             self.rhs_lo, cbs=self.cbs,
                             lam_pair=self.lam_pair,
                             out=state["rhs"][self.top])
        return r.abs().amax()

    @torch.no_grad()
    def solve(self, state, rhs_hi, rhs_lo, n_outer: int = 8,
              rtol: float = 0.0):
        """rhs_hi/rhs_lo: the [Y, X] float32 pair (``ops.df32.split_f64``
        splits a float64 rhs).  Returns (x_hi, x_lo, residual-max
        history, state); x_hi and x_lo are the instance's buffers.  With
        ``rtol == 0`` nothing is read back inside the loop; with ``rtol >
        0`` each outer reads its norm and the loop ends at the first one
        at or below ``rtol * norms[0]``."""
        solver, top = self.solver, self.top
        self._alloc()
        for buf, v in ((self.rhs_hi, rhs_hi), (self.rhs_lo, rhs_lo)):
            if not isinstance(v, torch.Tensor):
                v = torch.as_tensor(np.asarray(v))
            buf.copy_(v.to(buf.device, torch.float32))
        for buf in (self.x_hi, self.x_lo, self._e0):
            buf.zero_()
        e32 = self._e0
        norms_dev: List[torch.Tensor] = []
        for i in range(n_outer + 1):
            mx = self._step(state, e32)
            norms_dev.append(mx)
            if i == n_outer:
                break
            if rtol and float(mx) <= rtol * float(norms_dev[0]):
                break
            state, _ = solver.fas_fmg(state, lam=self.lam, need_res=False)
            e32 = state["phi"][top]
        norms = [float(m) for m in torch.stack(norms_dev).cpu()]
        return self.x_hi, self.x_lo, norms, state


def solve_refined(solver, state, rhs_hi, rhs_lo, n_outer: int = 8,
                  rtol: float = 0.0, nch: Optional[int] = None,
                  bc_values: Optional[List[float]] = None,
                  lam: float = 0.0, eps=None):
    """One-shot convenience wrapper that picks the refinement class by
    solver type, as the JAX package's does: a multi-canvas forest raises
    (the JAX package's text), a single-canvas forest takes
    :class:`RefinedForestPoisson` (rhs_hi/rhs_lo are then {lvl: interior}
    dicts, the solution {lvl: (x_hi, x_lo)}, eps per level), the z-slab
    solver :class:`ShardedRefinedPoisson` (bc_values and lam only, as
    there), the uniform dense 2D solver :class:`RefinedPoisson2D`
    (bc_values and lam), the uniform 3D dense solver and the dense-patch
    AMR solver :class:`RefinedPoisson` (which refuses the AMR solver's top
    level with :class:`Df32GateError`, its refinement faces being
    plane-valued, as the JAX package's asserts do).  The 2D dense-patch
    AMR solver (which the JAX package rebuilds as a 2D forest) and
    anything else raise, naming ROADMAP A10b.  lam != 0 = f64-class
    Helmholtz (a helmholtz-family inner solver); eps = the float64
    coefficient fields of a variable-coefficient solver."""
    from .dense2d import Dense2DMGSolver
    from .dense_amr2d import Dense2DAMRMGSolver
    from .dense_forest import DenseForestMGSolver
    from .dense_multiforest import DenseMultiForestMGSolver
    from .dense_shard import ShardedDenseMGSolver
    from .refine_forest import MULTI_CANVAS_REFUSAL, RefinedForestPoisson
    if isinstance(solver, DenseMultiForestMGSolver):
        raise NotImplementedError(MULTI_CANVAS_REFUSAL)
    if isinstance(solver, DenseForestMGSolver):
        return RefinedForestPoisson(solver, bc_values=bc_values, lam=lam,
                                    eps=eps).solve(state, rhs_hi, rhs_lo,
                                                   n_outer=n_outer,
                                                   rtol=rtol)
    if isinstance(solver, ShardedDenseMGSolver):
        return ShardedRefinedPoisson(solver, bc_values=bc_values,
                                     lam=lam).solve(state, rhs_hi, rhs_lo,
                                                    n_outer=n_outer,
                                                    rtol=rtol)
    if isinstance(solver, Dense2DAMRMGSolver):
        raise NotImplementedError(
            "solve_refined: the JAX package refines a 2D dense-patch AMR "
            "solver by rebuilding it as a 2D dense forest "
            "(RefinedForest2DPoisson), which waits for ROADMAP A10b")
    if isinstance(solver, Dense2DMGSolver):
        return RefinedPoisson2D(solver, bc_values=bc_values,
                                lam=lam).solve(state, rhs_hi, rhs_lo,
                                               n_outer=n_outer, rtol=rtol)
    if not isinstance(solver, DenseMGSolver):
        raise NotImplementedError(
            f"solve_refined: no refinement class for "
            f"{type(solver).__name__}; the 2D forests' refinement waits "
            f"for ROADMAP A10b")
    return RefinedPoisson(solver, nch=nch, bc_values=bc_values, lam=lam,
                          eps=eps).solve(state, rhs_hi, rhs_lo,
                                         n_outer=n_outer, rtol=rtol)
