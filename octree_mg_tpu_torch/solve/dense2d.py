"""Dense-level FAS multigrid solver for uniform 2D trees.

The JAX package's ``Dense2DMGSolver`` (its solve/dense2d.py): each level
is one dense ``[Y, X]`` tensor with no pads, the GSRB pair, operator and
residual run as whole-array masked expressions with inline BC-ghost
synthesis (ops/dense2d.py), and the cycle drivers (FAS V-cycle and FMG,
the tau correction, the direct or smoothed coarse solve,
m_multigrid.f90:84-243) are the 3D dense solver's, inherited.  The 2D
cylindrical (r, z) laplacian (m_laplacian.f90:197-271) rides on per-column
radial face weights.

No hand-written kernel runs here: the JAX package leaves the 2D path to
XLA, and this package runs the same expressions as eager torch ops on
every device (no counter of ``ops.dense_kernels`` moves).  The fused
down-leg and transfer kernels of the 3D solver are off; restriction is
strided pair sums in the order of the JAX package's 0/1 matmuls,
prolongation the bilinear 1/2, 1/4, 1/4 weights (m_prolong.f90:159-240).

Each phase is the boxed ``MGSolver``'s arithmetic per cell in the same
order (tests/test_torch_dense2d.py holds them bitwise in float64).

Gating: 2D laplacian/helmholtz/vlaplacian/vhelmholtz/ahelmholtz with
GSRB on uniform trees, cartesian, or cylindrical with the laplacian, as
the boxed dispatch; anything else goes to the boxed solver.  The JAX
package's GSPMD y-slab placement (``shard_state``) waits for ROADMAP
A13b.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.tree import Tree
from ..ops import dense2d as d2
from .dense import _OP_N_EPS, DenseMGSolver
from .multigrid import MGConfig


def dense2d_supported(tree: Tree, cfg: MGConfig) -> bool:
    """Whether the dense 2D fast path covers this configuration."""
    geom_ok = (cfg.geometry == "cartesian"
               or (cfg.geometry == "cylindrical"
                   and cfg.operator == "laplacian"))
    return (tree.ndim == 2
            and tree.highest_lvl == 1          # uniform, no AMR
            and cfg.operator in _OP_N_EPS
            and geom_ok
            and cfg.smoother in ("gsrb", "gs"))


class Dense2DMGSolver(DenseMGSolver):
    """FAS multigrid on dense uniform 2D levels.

    State:
        {"phi": {lvl: [Y, X]}, "rhs": {...}, "iold": {...}, "ires": {...},
         "eps0".."eps{n_eps-1}": {...}, "bc": {lvl: [4 boundary-value
         vectors]}}
    (x faces [Y], y faces [X], periodic faces [1]) on ``config.device``
    in ``config.dtype``, updated in place.
    """

    _supported = staticmethod(dense2d_supported)
    _RING_PADS = (0, 0)

    def __init__(self, tree: Tree, config: Optional[MGConfig] = None):
        super().__init__(tree, config)
        # no pads in 2D: the arrays are the interiors
        self._isl = (slice(None), slice(None))

    # ------------------------------------------------------------------
    # geometry
    # ------------------------------------------------------------------
    def _pshape(self, dims):
        return (int(dims[1]), int(dims[0]))

    def _bc_plane_shape(self, lvl, nb):
        if self.periodic[nb // 2]:
            return (1,)
        return self._kcfgs[lvl].plane_shape(nb)

    def _kcfg(self, lvl: int) -> d2.Dense2DConfig:
        idr2 = tuple(float(x) for x in 1.0 / self.tree.dr[lvl] ** 2)
        bc = self._bc_static(lvl)
        bc_full = [c if c is not None else (0.0, 0.0, 0.0) for c in bc]
        b_const = [float(spec["value"]) if spec["fn"] is None else None
                   for spec in self.bc_spec]
        cyl_w = (self._cyl_weights(lvl)
                 if self.cfg.geometry == "cylindrical" else None)
        return d2.Dense2DConfig(
            dims=self.dims[lvl], idr2=idr2, bc=bc_full,
            periodic=self.periodic, dtype=self.cfg.dtype,
            b_const=b_const, n_eps=self.n_eps, cyl_w=cyl_w)

    def _cyl_offset(self, lvl: int) -> float:
        """Global radial index of the level's first column."""
        return 0.0

    def _cyl_weights(self, lvl: int):
        """Radial face weights w_lo = r_face(i)/r_center(i), w_hi =
        r_face(i+1)/r_center(i) as [1, X] rows (box_clpl,
        m_laplacian.f90:209-212), in numpy float64, then cast to the
        working dtype on the solver's device."""
        t = self.tree
        X = self.dims[lvl][0]
        dr0 = float(t.dr[lvl][0])
        rmin = float(t.r_min[0])
        i = np.arange(1, X + 1) + self._cyl_offset(lvl)
        r_face = rmin + dr0 * (i - 1)
        r_face_hi = rmin + dr0 * i
        r_inv = 1.0 / (rmin + dr0 * (i - 0.5))
        return tuple(torch.as_tensor(w[None, :]).to(self.device,
                                                      self.cfg.dtype)
                     for w in (r_face * r_inv, r_face_hi * r_inv))

    def _eval_bc_planes(self, lvl: int) -> List[torch.Tensor]:
        """Boundary-value vectors b per direction: x faces vary along y
        ([Y]), y faces along x ([X]) (mg_phi_bc_store analogue)."""
        t = self.tree
        X, Y = self.dims[lvl]
        dr, r0 = t.dr[lvl], t.r_min
        dt, dev = self.cfg.dtype, self.device
        cx = r0[0] + (np.arange(X) + 0.5) * dr[0]
        cy = r0[1] + (np.arange(Y) + 0.5) * dr[1]
        hi = [r0[d] + self.dims[lvl][d] * dr[d] for d in range(2)]
        out = []
        for nbd in range(4):
            d = nbd // 2
            if self.periodic[d]:
                out.append(torch.zeros((1,), dtype=dt, device=dev))
                continue
            spec = self.bc_spec[nbd]
            if d == 0:
                coords = np.zeros((Y, 2))
                coords[:, 0] = r0[0] if nbd % 2 == 0 else hi[0]
                coords[:, 1] = cy
            else:
                coords = np.zeros((X, 2))
                coords[:, 1] = r0[1] if nbd % 2 == 0 else hi[1]
                coords[:, 0] = cx
            if spec["fn"] is not None:
                vals = np.asarray(spec["fn"](coords))
            else:
                vals = np.full(coords.shape[0], spec["value"])
            out.append(torch.as_tensor(
                np.ascontiguousarray(vals, np.float64)).to(dev, dt))
        return out

    def cell_centers(self, lvl: int) -> np.ndarray:
        """Interior cell-centre coordinates [Y, X, 2] (host-side)."""
        t = self.tree
        X, Y = self.dims[lvl]
        dr = t.dr[lvl]
        out = np.zeros((Y, X, 2))
        out[..., 0] = (t.r_min[0] + (np.arange(X) + 0.5) * dr[0])[None, :]
        out[..., 1] = (t.r_min[1] + (np.arange(Y) + 0.5) * dr[1])[:, None]
        return out

    # ------------------------------------------------------------------
    # building blocks (no pads: rolls wrap exactly)
    # ------------------------------------------------------------------
    def _sync_pads(self, arr, lvl):
        return arr

    def _smooth(self, state, lvl, n_cycle, lam):
        cfg = self._kcfgs[lvl]
        phi = state["phi"][lvl]
        rhs = state["rhs"][lvl]
        bp = self._planes(state, lvl)
        eps = self._eps(state, lvl)
        epl = self._eps_planes(state, lvl)
        for _ in range(n_cycle):
            # boxed substep n updates 1-based parity n%2, i.e. 0-based
            # (n%2 + ndim) % 2; substeps n=1,2 with ndim=2 -> red parity
            # 1 (the opposite colour of the 3D dense path)
            phi = d2.pair_sweep_2d(cfg, phi, rhs, lam, bp, red_parity=1,
                                   eps=eps, eps_planes=epl)
        state["phi"][lvl] = phi
        return state

    def _residual(self, state, lvl, lam):
        state["ires"][lvl] = d2.stencil_apply_2d(
            self._kcfgs[lvl], state["phi"][lvl], state["rhs"][lvl], lam,
            self._planes(state, lvl), residual=True,
            eps=self._eps(state, lvl),
            eps_planes=self._eps_planes(state, lvl))
        return state

    def _apply_op(self, state, lvl, lam):
        return d2.stencil_apply_2d(
            self._kcfgs[lvl], state["phi"][lvl], state["rhs"][lvl], lam,
            self._planes(state, lvl), residual=False,
            eps=self._eps(state, lvl),
            eps_planes=self._eps_planes(state, lvl))

    def _kernel_apply(self, cfg, phi, rhs, lam, bplanes, eps):
        return d2.stencil_apply_2d(cfg, phi, rhs, lam, bplanes,
                                   residual=False, eps=eps)

    def _fused_transfer_ok(self, state, lvl):
        """No fused transfer in 2D (the JAX package's fused_down_ok is
        False on every 2D config)."""
        return False

    # ------------------------------------------------------------------
    # transfers
    # ------------------------------------------------------------------
    def _restrict_into(self, state, lvl, key):
        """Full-weighting restriction lvl -> lvl-1 (m_restrict.f90:
        183-194) into the coarse field, in place."""
        d2.restrict_2d(state[key][lvl], out=state[key][lvl - 1])
        return state

    def _correct_children(self, state, lvl_c, lam):
        """phi_fine += prolong(phi_c - iold_c) (correct_children,
        m_multigrid.f90:387-402), in place on phi_fine."""
        corr = self._corr_with_ring(state, lvl_c)
        state["phi"][lvl_c + 1].add_(self._prolong_rect(corr))
        return state

    def _corr_with_ring(self, state, lvl):
        """(phi - iold) with a one-cell ring [Y+2, X+2] that reproduces
        the boxed corr ghosts bitwise: ghost(phi) - ghost(iold) with the
        bc_to_gc formula per face (the c0*b terms cancel only in exact
        arithmetic, so both are evaluated), or the periodic wrap of the
        difference."""
        X, Y = self.dims[lvl]
        phi = state["phi"][lvl]
        iold = state["iold"][lvl]
        bp = state["bc"][lvl]
        corr = self._zeros((Y + 2, X + 2))
        corr[1:-1, 1:-1] = phi - iold
        bc = self._bc_static(lvl)

        def synth(nbd, x1, x2, bvec):
            c0, c1, c2 = bc[nbd]
            g = c0 * bvec + c1 * x1
            if c2 != 0.0:
                g = g + c2 * x2
            return g

        for nbd in range(4):
            d = nbd // 2
            lowside = nbd % 2 == 0
            ax = 1 - d
            n_d = (X, Y)[d]

            def pick(a, idx):
                return a[:, idx] if ax == 1 else a[idx]

            if self.periodic[d]:
                idx = n_d - 1 if lowside else 0
                ring = pick(phi, idx) - pick(iold, idx)
            else:
                i1 = 0 if lowside else n_d - 1
                i2 = 1 if lowside else n_d - 2
                ring = (synth(nbd, pick(phi, i1), pick(phi, i2), bp[nbd])
                        - synth(nbd, pick(iold, i1), pick(iold, i2),
                                bp[nbd]))
            sl: List = [slice(1, -1)] * 2
            sl[ax] = 0 if lowside else -1
            corr[tuple(sl)] = ring
        return corr

    def _prolong_rect(self, sub):
        """Bilinear prolongation [Yc+2, Xc+2] -> [2Yc, 2Xc]
        (mg_prolong_sparse 2D weights 1/2, 1/4, 1/4; the JAX package's
        order: 0.5*centre, then + 0.25*neighbour along x, then y)."""
        ctr = sub[1:-1, 1:-1]

        def shifted(d, s):
            sl = [slice(1, -1)] * 2
            ax = 1 - d
            sl[ax] = slice(1 + s, sub.shape[ax] - 1 + s)
            return sub[tuple(sl)]

        f0 = 0.5 * ctr
        lo = [0.25 * shifted(d, -1) for d in range(2)]
        hi = [0.25 * shifted(d, +1) for d in range(2)]
        vals = {0: f0}
        for d in range(2):
            new = {}
            for key, a in vals.items():
                new[key] = a + lo[d]
                new[key | (1 << d)] = a + hi[d]
            vals = new
        Yc, Xc = ctr.shape
        out = torch.empty((2 * Yc, 2 * Xc), dtype=sub.dtype,
                          device=sub.device)
        for bits, v in vals.items():
            out[(bits >> 1) & 1::2, bits & 1::2] = v
        return out

    # ------------------------------------------------------------------
    # coarse solve: always probed through the runtime operator (constant
    # coefficients, coefficient fields and cylindrical alike)
    # ------------------------------------------------------------------
    def _ensure_direct(self, state=None):
        if self.coarse_solver != "direct" or self._direct is not None:
            return
        if state is None:
            return  # the public entry points pass the state
        self._direct = self._build_direct_probe(state) or "unavailable"

    # ------------------------------------------------------------------
    # multi-device placement
    # ------------------------------------------------------------------
    def shard_state(self, state, mesh, min_local: int = 16):
        """The JAX package's GSPMD y-slab placement; not ported."""
        raise NotImplementedError(
            "Dense2DMGSolver.shard_state: the y-slab placement over a "
            "device mesh waits for ROADMAP A13b")
