"""f64-class iterative refinement on forest trees.

The uniform driver (solve/refine.py) recovers the reference's float64
accuracy class (m_data_structures.f90:8) around the float32 dense
solver.  This module (the port of the JAX package's
``solve/refine_forest.py``) extends it to the single-canvas dense forest:
the outer residual is evaluated in double-float over EVERY level of the
composite discretization, refinement-boundary ghosts included:

    x = 0 (double-float pair per level)
    repeat:
      x_l += e_l                              df accumulation
      x_coarse(image) = restrict(x_fine)      df-exact 8-cell average
      r_l = rhs_l - A_l(x)                    df-exact per level, with
                                              rb ghosts interpolated
                                              from the COARSE x pair
      solve A e = r                           zero-guess float32 forest
                                              FMG

Exactness: every ghost coefficient of the reference's scheme is a sum of
powers of two — bc_to_gc's (2, -1, 0) / (+-dr, 1, 0) / (0, 2, -1)
(m_ghost_cells.f90:682-698), sides_rb's 0.5 / 0.75 / -0.25 (:769-861,
0.75 = 0.5 + 0.25), the strip interpolation's +-0.125 (:557-576) and full
weighting's 1/8 — so the whole composite residual rides error-free
transformations (TwoSum chains, exact power-of-two products, lam*x via
Dekker's TwoProduct).  The fixed point is the reference's converged
state: leaf residuals -> 0 with the non-leaf coarse cells equal to the
restriction of the fine solution (update_coarse,
m_multigrid.f90:369-383).  The variable-coefficient operators ride
double-float PAIR arithmetic (~2^-47 relative, float64-class though not
error-free: ``ops.df32``'s pair operations) with the float64 coefficient
fields given per level.

The outer step is eager PyTorch on the solver's device: each TwoSum and
Veltkamp step is an operation of its own, in the JAX package's order, so
no multiply-add contraction can eat an error term (not for
``torch.compile``).  The JAX package's even-index selector matmuls (a
TPU workaround for slow stride-2 slicing) are plain stride-2 slices here:
a 0/1 selector matmul is exact, so the values are the same.

Gate: a float32 inner solver, power-of-two 1/dx^2 (equal per dimension
for the constant-coefficient operators), exact BC coefficient classes,
constant homogeneous boundary values on the inner solver (the true
values go through ``bc_values``), not fully periodic.  Not here: the
relaxed ``"pair"`` inner ghost cadence (a measured-negative knob of the
JAX package), the GSPMD placement (ROADMAP A13b), multi-canvas forests
(refused, as in the JAX package) and the 2D driver (ROADMAP A10b).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.df32 import (_OK_C, _is_pow2, accumulate_df32, df_add, df_div,
                        df_mul, df_scale_pow2, df_sub, fast_two_sum,
                        interp_rb_strip_df, split_f64, split_lam, two_prod,
                        two_sum)
from .dense import _ISL
from .dense_forest import DenseForestMGSolver

_INNER = (slice(1, -1),) * 3

#: the JAX package's refusal of refinement on a multi-canvas forest
#: (octree_mg_tpu/solve/refine.py:547-550)
MULTI_CANVAS_REFUSAL = (
    "iterative refinement does not support multi-canvas "
    "(sparse) forest solvers; build a single-canvas forest "
    "solver (DenseForestMGSolver) or use the f32 path")


class RefinedForestPoisson:
    """Iterative refinement over a :class:`DenseForestMGSolver`.

    ``solve`` takes per-level interior rhs pairs and returns per-level
    interior (x_hi, x_lo) pairs (leaf cells meaningful), the leaf
    residual-max history and the inner state.

    eps: for a variable-coefficient solver, ``{lvl: [interior float64
    canvas] * n_eps}`` (numpy, or float64 tensors on any device): the
    per-level coefficients of the composite operator, split into float32
    pairs here; ``solve`` installs their hi parts on the inner solver.
    """

    def __init__(self, solver: DenseForestMGSolver,
                 bc_values: Optional[List[float]] = None,
                 lam: float = 0.0, inner_ghost_refresh: str = "half",
                 eps=None):
        from .dense_multiforest import DenseMultiForestMGSolver
        if isinstance(solver, DenseMultiForestMGSolver):
            raise NotImplementedError(MULTI_CANVAS_REFUSAL)
        if not isinstance(solver, DenseForestMGSolver):
            raise TypeError(f"RefinedForestPoisson refines a "
                            f"DenseForestMGSolver, got "
                            f"{type(solver).__name__}")
        if inner_ghost_refresh == "pair":
            raise NotImplementedError(
                "inner_ghost_refresh='pair' is a measured-negative knob of "
                "the JAX package and is not ported (ROADMAP: do not port "
                "the measured-negative knobs); use 'half'")
        if inner_ghost_refresh != "half":
            raise ValueError(f"inner_ghost_refresh must be 'half', got "
                             f"{inner_ghost_refresh!r}")
        self.inner_ghost_refresh = inner_ghost_refresh
        self.s = solver
        if solver.cfg.dtype != torch.float32:
            raise ValueError("refines an f32 inner solver; got %s"
                             % solver.cfg.dtype)
        self.n_eps = int(solver.n_eps)
        if self.n_eps and eps is None:
            raise ValueError(
                "variable-coefficient forest refinement needs the f64 "
                "coefficient fields: eps={lvl: [interior f64 canvas] * "
                "n_eps} (per level; the hi parts are installed on the "
                "inner solver)")
        if not self.n_eps and eps is not None:
            raise ValueError("eps= given for a constant-coeff solver")
        if solver.subtract_mean:
            raise ValueError("fully-periodic (subtract-mean) trees are "
                             "outside the refined gate")
        self.lam = float(lam)
        self.lam_pair = split_lam(lam)
        if self.lam != 0.0 and solver.cfg.operator not in (
                "helmholtz", "vhelmholtz", "ahelmholtz"):
            raise ValueError("lam != 0 needs a helmholtz-family solver")
        dev = solver.device
        #: per-level (c0*b)_hi/lo pairs for the physical faces; the inner
        #: solver must be HOMOGENEOUS (nonzero inner b would re-add the
        #: boundary offset every outer)
        self.cbs: Dict[int, List] = {}
        for lvl in solver.levels:
            cfg = solver._kcfgs[lvl]
            if self.n_eps:
                # per-dim power of two (the 2*idr2 coefficient scale
                # stays exact; dims need not be equal)
                if not all(_is_pow2(v) for v in cfg.idr2):
                    raise ValueError("1/dx^2 must be powers of two "
                                     "(lvl %d: %r)" % (lvl, cfg.idr2))
            elif len(set(cfg.idr2)) != 1 or not _is_pow2(cfg.idr2[0]):
                raise ValueError("1/dx^2 must be an equal power of two "
                                 "per level (lvl %d: %r)"
                                 % (lvl, cfg.idr2))
            bc = solver._bc_static(lvl)
            row = []
            for nb in range(6):
                if bc[nb] is None:
                    row.append((0.0, 0.0))
                    continue
                c0, c1, c2 = bc[nb]
                if c1 not in _OK_C or c2 not in _OK_C:
                    raise ValueError("BC coefficient class outside the "
                                     "exact set (face %d)" % nb)
                spec = solver.bc_spec[nb]
                if spec["fn"] is not None:
                    raise ValueError("constant boundary values only")
                if float(spec["value"]) != 0.0:
                    raise ValueError(
                        "inner solver must be homogeneous (b=0); pass "
                        "true values via bc_values= (face %d)" % nb)
                bv = 0.0 if bc_values is None else float(bc_values[nb])
                hi, lo = split_f64(np.float64(c0) * np.float64(bv))
                row.append((float(hi), float(lo)))
            self.cbs[lvl] = row
        #: leaf masks [Z, Y, X] (footprint minus the finer image), built
        #: on the host and kept on the solver's device
        self.leaf_mask: Dict[int, torch.Tensor] = {}
        n_leaf = 0
        for lvl in solver.levels:
            m = solver.footprint_mask(lvl).copy()
            if lvl + 1 in solver.levels:
                for clo, chi in solver._image_rects(lvl + 1):
                    m[int(clo[2]):int(chi[2]), int(clo[1]):int(chi[1]),
                      int(clo[0]):int(chi[0])] = False
            n_leaf += int(m.sum())
            self.leaf_mask[lvl] = torch.as_tensor(m, device=dev)
        self.n_leaf_cells = n_leaf
        #: {"eps{i}": {lvl: (hi, lo) padded canvas pair}}: the variable
        #: coefficients of the composite operator, fixed across outers
        #: (the per-level values are authoritative)
        self._eps_df: Dict[str, Dict] = {}
        for i in range(self.n_eps):
            per = {}
            for lvl in solver.levels:
                e = eps[lvl][i]
                if isinstance(e, torch.Tensor):
                    e = e.detach().cpu().numpy()
                hi, lo = split_f64(np.asarray(e, np.float64))
                shape = solver._pshape(solver.dims[lvl])
                pair = []
                for part in (hi, lo):
                    a = torch.zeros(shape, dtype=torch.float32, device=dev)
                    a[_ISL] = torch.as_tensor(part).to(dev)
                    pair.append(a)
                per[lvl] = tuple(pair)
            self._eps_df[f"eps{i}"] = per

    # ------------------------------------------------------------------
    # double-float ghost synthesis per segment
    # ------------------------------------------------------------------
    def _ghost_df(self, lvl, seg, xh, xl, bdf, i, is_eps=False):
        """(g_hi, g_lo) pair for one ghost segment, expanded to its 3D
        rect shape: the float32 path's coefficient arithmetic
        (_ring_values / _face_planes) with every sum a TwoSum and every
        product an exact power-of-two multiply; synthesis errors fold
        into the lo channel (~2^-48 class).

        is_eps: coefficient-field semantics — physical faces take the
        Neumann-zero copy (ghost = own value, m_vlaplacian.f90:25-28);
        rb faces and wraps behave like phi."""
        sv = self.s
        d = seg.nb // 2
        ax = 2 - d
        if seg.kind == "wrap":
            lo = seg.lo.copy()
            hi = seg.hi.copy()
            lo[d] = seg.src
            hi[d] = seg.src + 1
            sl = sv._cansl(lo, hi)
            return xh[sl], xl[sl]
        x1h, x2h = sv._seg_x12(xh, seg)
        x1l, x2l = sv._seg_x12(xl, seg)
        if is_eps and seg.kind != "rb":
            # physical face: exact copy of the boundary cell pair
            return (1.0 * x1h).unsqueeze(ax), (1.0 * x1l).unsqueeze(ax)
        if seg.kind == "rb":
            bh, bl = bdf[i]
            # 0.5*b + 0.75*x1 - 0.25*x2 with 0.75 = 0.5 + 0.25
            g, e1 = two_sum(0.5 * bh, 0.5 * x1h)
            g, e2 = two_sum(g, 0.25 * x1h)
            g, e3 = two_sum(g, -(0.25 * x2h))
            gl = (0.5 * bl + (0.5 * x1l + 0.25 * x1l) - 0.25 * x2l) \
                + ((e1 + e2) + e3)
        else:  # phys: c0*b + c1*x1 + c2*x2, b constant (pre-split)
            c0, c1, c2 = sv._bc_static(lvl)[seg.nb]
            cbh, cbl = self.cbs[lvl][seg.nb]
            g, ge = two_sum(c1 * x1h, cbh)
            gl = c1 * x1l + cbl
            if c2 != 0.0:
                g, e2 = two_sum(g, c2 * x2h)
                ge = ge + e2
                gl = gl + c2 * x2l
            gl = gl + ge
        return g.unsqueeze(ax), gl.unsqueeze(ax)

    def _ext_df(self, X, lvl, memo, prefer=None, tag="phi"):
        """[Z+2, Y+2, X+2] double-float canvas with ALL ghosts
        materialized (the df rendering of DenseForestMGSolver._ext).
        ``prefer``: the axis whose ring segments write last at conflicted
        concave-corner cells.  ``tag``: "phi" or a coefficient field
        ("eps{i}": Neumann-zero phys ghosts, the same rb/wrap handling).
        Memoized in ``memo`` for one outer step."""
        key = ("ext", tag, lvl, prefer)
        if key in memo:
            return memo[key]
        sv = self.s
        xh, xl = X[lvl]
        X_, Y_, Z_ = sv.dims[lvl]
        bdf = self._bdf(X, lvl, memo, tag)
        is_eps = tag != "phi"
        eh = xh.new_zeros((Z_ + 2, Y_ + 2, X_ + 2))
        el = xh.new_zeros((Z_ + 2, Y_ + 2, X_ + 2))
        eh[_INNER] = xh[_ISL]
        el[_INNER] = xl[_ISL]
        items = list(enumerate(sv.segs[lvl]))
        if prefer is not None:
            items.sort(key=lambda t: (t[1].sink == "ring"
                                      and t[1].nb // 2 == prefer))
        for i, seg in items:
            gh, gl = self._ghost_df(lvl, seg, xh, xl, bdf, i, is_eps)
            sl = tuple(slice(1 + int(seg.lo[dd]), 1 + int(seg.hi[dd]))
                       for dd in (2, 1, 0))
            eh[sl] = gh
            el[sl] = gl
        memo[key] = (eh, el)
        return memo[key]

    def _bdf(self, X, lvl, memo, tag="phi"):
        """{seg index: (b_hi, b_lo)} coarse-interpolation planes of the
        rb segments of lvl (the df rendering of _rb_cache, with the same
        per-axis strip-end patching at conflicted coarse levels)."""
        key = ("bdf", tag, lvl)
        if key in memo:
            return memo[key]
        sv = self.s
        if not any(s.kind == "rb" for s in sv.segs[lvl]):
            memo[key] = {}
            return memo[key]
        need = sv.conflicts.get(lvl - 1) is not None
        if need:
            ext_ax = {a: self._ext_df(X, lvl - 1, memo, prefer=a, tag=tag)
                      for a in range(3)}
            exth, extl = ext_ax[0]
        else:
            exth, extl = self._ext_df(X, lvl - 1, memo, tag=tag)
        off_c = sv.offsets[lvl - 1]
        off_f = sv.offsets[lvl]
        out = {}
        for i, seg in enumerate(sv.segs[lvl]):
            if seg.kind != "rb":
                continue
            d = seg.nb // 2
            sl: List = [0, 0, 0]
            sl[2 - d] = seg.cg - int(off_c[d]) + 1
            for dd in range(3):
                if dd == d:
                    continue
                c0 = (int(off_f[dd]) + int(seg.lo[dd])) // 2 \
                    - int(off_c[dd])
                c1 = (int(off_f[dd]) + int(seg.hi[dd])) // 2 \
                    - int(off_c[dd])
                sl[2 - dd] = slice(c0, c1 + 2)
            sl = tuple(sl)
            th, tl = exth[sl], extl[sl]
            if need:
                t_lo, t_hi = [dd for dd in range(3) if dd != d]
                hh, hl = ext_ax[t_hi]
                lh, ll = ext_ax[t_lo]
                th, tl = th.clone(), tl.clone()
                th[0, :], th[-1, :] = hh[sl][0, :], hh[sl][-1, :]
                tl[0, :], tl[-1, :] = hl[sl][0, :], hl[sl][-1, :]
                th[:, 0], th[:, -1] = lh[sl][:, 0], lh[sl][:, -1]
                tl[:, 0], tl[:, -1] = ll[sl][:, 0], ll[sl][:, -1]
            bh, bl = interp_rb_strip_df(th[None], tl[None], 3)
            out[i] = (bh[0], bl[0])
        memo[key] = out
        return memo[key]

    # ------------------------------------------------------------------
    # double-float residual per level
    # ------------------------------------------------------------------
    def _residual_df(self, X, RHSh, RHSl, lvl, memo):
        """r_hi ~= rhs - A(x) on the canvas interior [Z, Y, X], df-exact
        at footprint cells.  Neighbour reads are shifted slices of the
        materialized df ext pair (all ghosts in place); conflicted levels
        use per-axis exts, so direction-d reads see d-axis ghosts
        (per-box ghost storage semantics)."""
        sv = self.s
        cfg = sv._kcfgs[lvl]
        idr2 = cfg.idr2[0]
        xh, xl = X[lvl]
        if sv.conflicts.get(lvl) is None:
            e0 = self._ext_df(X, lvl, memo)
            exts = [e0, e0, e0]
        else:
            exts = [self._ext_df(X, lvl, memo, prefer=a) for a in range(3)]

        if self.n_eps:
            return self._residual_df_vcoeff(X, RHSh, RHSl, lvl, memo, cfg,
                                            exts)

        ch = xh[_ISL]
        cl = xl[_ISL]
        s = RHSh[lvl][_ISL]
        comp = torch.zeros_like(ch)
        alo = torch.zeros_like(ch)
        for d in range(3):
            eh, el = exts[d]
            vlo_h = _shifted(eh, d, -1)
            vhi_h = _shifted(eh, d, +1)
            vlo_l = _shifted(el, d, -1)
            vhi_l = _shifted(el, d, +1)
            sd, ed = two_sum(vlo_h, vhi_h)
            s, e = two_sum(s, -(idr2 * sd))
            comp = comp + (e - idr2 * ed)
            alo = alo + idr2 * (vlo_l + vhi_l)
        s, e = two_sum(s, (4.0 * idr2) * ch)
        comp = comp + e
        s, e = two_sum(s, (2.0 * idr2) * ch)
        comp = comp + e
        comp = comp + RHSl[lvl][_ISL] - (alo - (6.0 * idr2) * cl)
        if self.lam_pair is not None:
            lam_h, lam_l = self.lam_pair
            p, pe = two_prod(ch, lam_h)
            s, e = two_sum(s, p)
            comp = comp + (e + pe) + (lam_h * cl + lam_l * ch)
        r_hi, _ = two_sum(s, comp)
        return r_hi

    def _residual_df_vcoeff(self, X, RHSh, RHSl, lvl, memo, cfg, exts):
        """The variable-coefficient composite residual in double-float
        PAIR arithmetic (~2^-47 relative; ops.df32's pair operations):

            r = rhs - sum_d sum_side c*(v - x) + lam*x,
            c = 2*e0*e_nbr/(e0 + e_nbr) * idr2[d]

        — the harmonic-mean form of the stencil (m_vlaplacian.f90:
        84-128, m_ahelmholtz.f90:69-162), with phi AND eps neighbour
        reads from materialized df ext pairs (eps rb ghosts ride the same
        coarse-strip interpolation as phi; physical faces the
        Neumann-zero copy).  Interior [Z, Y, X]."""
        sv = self.s
        xh, xl = X[lvl]
        x = (xh[_ISL], xl[_ISL])
        acc = (RHSh[lvl][_ISL], RHSl[lvl][_ISL])
        exts_e = []
        for i in range(self.n_eps):
            tag = f"eps{i}"
            F = self._eps_df[tag]  # all levels: _bdf recurses coarser
            if sv.conflicts.get(lvl) is None:
                e0 = self._ext_df(F, lvl, memo, tag=tag)
                exts_e.append([e0, e0, e0])
            else:
                exts_e.append([self._ext_df(F, lvl, memo, prefer=a, tag=tag)
                               for a in range(3)])
        for d in range(3):
            ph_, pl_ = exts[d]
            eeh, eel = exts_e[0 if self.n_eps == 1 else d][d]
            e0 = (eeh[_INNER], eel[_INNER])
            for step in (-1, +1):
                v = (_shifted(ph_, d, step), _shifted(pl_, d, step))
                enb = (_shifted(eeh, d, step), _shifted(eel, d, step))
                c = df_div(df_mul(e0, enb), df_add(e0, enb))
                c = df_scale_pow2(c, 2.0 * cfg.idr2[d])
                acc = df_sub(acc, df_mul(c, df_sub(v, x)))
        if self.lam_pair is not None:
            acc = df_add(acc, df_mul(x, self.lam_pair))
        return acc[0]

    # ------------------------------------------------------------------
    # double-float restriction (exact 8-cell average)
    # ------------------------------------------------------------------
    @staticmethod
    def _restrict_pair(h, l):
        """[Z, Y, X] pair -> [Z/2, Y/2, X/2] pair: the full-weighting mean
        of 8 with the pair sums as TwoSums (errors fold into lo) and the
        1/8 scale exact.  Each axis sums the even cell with its odd
        neighbour: the values the JAX package takes at the even indices
        of its roll + TwoSum."""
        for axis in (0, 1, 2):
            ev = (slice(None),) * axis + (slice(0, None, 2),)
            od = (slice(None),) * axis + (slice(1, None, 2),)
            hs, e = two_sum(h[ev], h[od])
            l = l[ev] + l[od] + e
            h = hs
        return fast_two_sum(0.125 * h, 0.125 * l)

    def _restrict_into_df(self, X, lvl):
        """Write restrict(x_fine) into the coarse image rectangles, in
        place on the coarse pair — the composite discretization's
        non-leaf coarse values (update_coarse, m_multigrid.f90:369-383)."""
        sv = self.s
        fh, fl = X[lvl]
        ah, al = self._restrict_pair(fh[_ISL], fl[_ISL])
        ch, cl = X[lvl - 1]
        for (lo, hi), (clo, chi) in zip(sv.geom[lvl].rects,
                                        sv._image_rects(lvl)):
            win = (slice(int(lo[2]) // 2, int(hi[2]) // 2),
                   slice(int(lo[1]) // 2, int(hi[1]) // 2),
                   slice(int(lo[0]) // 2, int(hi[0]) // 2))
            sl = sv._cansl(clo, chi)
            ch[sl] = ah[win]
            cl[sl] = al[win]
        return X

    # ------------------------------------------------------------------
    # the outer step
    # ------------------------------------------------------------------
    def _jit_step(self, X, E, RHSh, RHSl):
        """Accumulate the corrections E into X, restrict X down, and
        evaluate the df residuals: (X, {lvl: r_hi interior}, leaf max
        |r| as a 0-dim tensor).  Eager (the JAX package jits it)."""
        sv = self.s
        X = dict(X)
        for lvl in sv.levels:
            xh, xl = X[lvl]
            X[lvl] = accumulate_df32(xh, xl, E[lvl])
        for lvl in reversed(sv.levels[1:]):
            X = self._restrict_into_df(X, lvl)
        memo = {}
        R = {}
        norm = sv._zero_scalar()
        for lvl in sv.levels:
            r = self._residual_df(X, RHSh, RHSl, lvl, memo)
            R[lvl] = r
            norm = torch.maximum(norm, torch.where(
                self.leaf_mask[lvl], r.abs(), 0.0).max())
        return X, R, norm

    def _jit_outer(self, X, state, RHSh, RHSl):
        """One whole outer iteration: the step above with the inner
        state's phi as the corrections, its residuals written into the
        inner rhs, then the inner zero-guess forest FMG.  Returns (X,
        state, leaf max |r|); reads nothing back to the host."""
        sv = self.s
        E = {lvl: state["phi"][lvl] for lvl in sv.levels}
        X, R, norm = self._jit_step(X, E, RHSh, RHSl)
        for lvl in sv.levels:
            state["rhs"][lvl][_ISL] = R[lvl]
        state, _ = sv._fmg(state, sv._lam(self.lam), have_guess=False,
                           need_res=False)
        return X, state, norm

    @torch.no_grad()
    def solve(self, state, rhs_hi: Dict, rhs_lo: Dict, n_outer: int = 8,
              rtol: float = 0.0):
        """rhs_hi/rhs_lo: {lvl: interior [Z, Y, X] float32} pairs
        (``ops.df32.split_f64`` converts float64 fields; leaf cells are
        what matters).  Returns ({lvl: (x_hi, x_lo) interior}, leaf
        residual-max history, inner state).  The inner state is updated
        in place.  With ``rtol`` 0 no outer reads the device; otherwise
        each outer reads its norm to test ``norm <= rtol * norms[0]``."""
        sv = self.s
        dev = sv.device
        if self.n_eps:
            # install the coefficient hi parts on the inner solver (all
            # levels explicit: the per-level eps are authoritative); the
            # coarse matrix and the coefficient memos depend on them
            for i in range(self.n_eps):
                tag = f"eps{i}"
                for lvl in sv.levels:
                    state = sv.set_interior(
                        state, lvl, tag, self._eps_df[tag][lvl][0][_ISL])
            sv._direct = None
            sv._drop_eps_memos()
        X = {}
        RHSh, RHSl = {}, {}
        for lvl in sv.levels:
            shape = sv._pshape(sv.dims[lvl])
            X[lvl] = (torch.zeros(shape, dtype=torch.float32, device=dev),
                      torch.zeros(shape, dtype=torch.float32, device=dev))
            for out, src in ((RHSh, rhs_hi), (RHSl, rhs_lo)):
                a = torch.zeros(shape, dtype=torch.float32, device=dev)
                a[_ISL] = torch.as_tensor(src[lvl]).to(dev, torch.float32)
                out[lvl] = a
        norms_dev: List = []
        sv._ensure_direct(state)
        # the first accumulation must be a no-op: zero the inner phi
        for lvl in sv.levels:
            state["phi"][lvl].zero_()
        for _ in range(n_outer):
            X, state, mx = self._jit_outer(X, state, RHSh, RHSl)
            norms_dev.append(mx)
            if rtol and float(mx) <= rtol * float(norms_dev[0]):
                break
        # closing norm: accumulate the last correction, residuals only
        E = {lvl: state["phi"][lvl] for lvl in sv.levels}
        X, R, mx = self._jit_step(X, E, RHSh, RHSl)
        for lvl in sv.levels:
            state["rhs"][lvl][_ISL] = R[lvl]
        norms_dev.append(mx)
        norms = [float(m) for m in torch.stack(norms_dev).cpu()]
        out = {lvl: (X[lvl][0][_ISL], X[lvl][1][_ISL]) for lvl in sv.levels}
        return out, norms, state


def _shifted(arr, d, step):
    """The interior-sized window of an ext canvas shifted by ``step``
    along dimension d (array axis 2 - d)."""
    sl = [slice(1, -1)] * 3
    sl[2 - d] = slice(1 + step, arr.shape[2 - d] - 1 + step)
    return arr[tuple(sl)]
