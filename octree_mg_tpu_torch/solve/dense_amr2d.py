"""Dense-patch AMR FAS multigrid in 2D: one dense array per level.

The JAX package's ``Dense2DAMRMGSolver`` (its solve/dense_amr2d.py), the
2D counterpart of :class:`DenseAMRMGSolver` on quadtree AMR trees: each
rectangular refinement level is one dense ``[Y, X]`` patch driven by the
uniform 2D machinery (ops/dense2d.py, solve/dense2d.py).  The
reference's refinement-boundary ghost (sides_rb, m_ghost_cells.f90:
769-861)

    ghost = 0.5*interp + 0.75*x1 - 0.25*x2

is the physical-BC formula with (c0, c1, c2) = (0.5, 0.75, -0.25) and b
the coarse-side interpolated strip (box_gc_for_fine_neighbor, +-0.125
transverse gradients, m_ghost_cells.f90:500-577): a patch face that
borders coarser cells is a BC face whose b vector is computed from the
coarse patch whenever an operation needs it (``_planes``), from that
face's coarse strip alone.  FAS transfer acts on the fine patch's
footprint region of the coarse patch (update_coarse on parents,
m_multigrid.f90:347-384); levels whose footprint covers the whole coarse
level take the uniform solver's transfers.

Variable-coefficient operators and the 2D cylindrical laplacian ride
too: coefficient fields take the same two-stage ghosts at refinement
faces (``eps_bc``), and the radial face weights know the patch offset.

Gating (``dense_amr2d_supported``): 2D, the five operators (cylindrical:
laplacian only), GSRB, non-periodic, every level's boxes forming a full
rectangle with the refinement strips inside the coarse patch.  Plain
torch ops on every device, as the JAX package leaves the 2D path to XLA.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core.tree import Tree
from ..ops import dense2d as d2
from ..ops.ghost import interp_rb_strip
from .dense_amr import RB_COEFFS, _patch_geometry, _rb_strips_inside
from .dense2d import Dense2DMGSolver
from .multigrid import MGConfig


def dense_amr2d_supported(tree: Tree, cfg: MGConfig) -> bool:
    """Whether the 2D dense-patch AMR path covers this configuration."""
    geom_ok = (cfg.geometry == "cartesian"
               or (cfg.geometry == "cylindrical"
                   and cfg.operator == "laplacian"))
    if not (tree.ndim == 2
            and tree.highest_lvl > 1
            and cfg.operator in ("laplacian", "helmholtz", "vlaplacian",
                                 "vhelmholtz", "ahelmholtz")
            and geom_ok
            and cfg.smoother in ("gsrb", "gs")
            and not any(tree.periodic)):
        return False
    geom = _patch_geometry(tree)
    if geom is None:
        return False
    return _rb_strips_inside(tree, geom)


class Dense2DAMRMGSolver(Dense2DMGSolver):
    """FAS multigrid on dense rectangular 2D AMR patches.

    The state is the uniform 2D solver's, one patch [Y, X] per level in
    global offsets ``offsets[lvl]``; the boundary vectors of refinement
    faces are zero placeholders that ``_planes`` replaces by the coarse
    interpolation whenever an operation reads them."""

    _supported = staticmethod(dense_amr2d_supported)

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def _build_levels(self):
        t = self.tree
        geom = _patch_geometry(t)
        all_lvls = list(range(t.lowest_lvl, t.highest_lvl + 1))
        self.dims = {lvl: tuple(int(v) for v in geom["dims"][lvl])
                     for lvl in all_lvls}
        self.offsets = {lvl: geom["offsets"][lvl] for lvl in all_lvls}
        self.regions = geom["regions"]
        if self.coarse_solver == "direct":
            # the direct level must be a whole-domain uniform level
            direct = None
            for lvl in all_lvls:
                if (lvl <= 1 and int(np.prod(self.dims[lvl]))
                        <= self.DIRECT_MAX_CELLS):
                    direct = lvl
            if direct is None:
                direct = all_lvls[0]
            self.levels = [lvl for lvl in all_lvls if lvl >= direct]
        else:
            self.levels = all_lvls
        # face kinds: "phys" on the physical domain boundary, else "rb"
        self.face_kind: Dict[int, List[str]] = {}
        for lvl in self.levels:
            kinds = []
            for nb in range(4):
                d = nb // 2
                if nb % 2 == 0:
                    flush = self.offsets[lvl][d] == 0
                else:
                    flush = (self.offsets[lvl][d] + self.dims[lvl][d]
                             == t.domain_size_lvl[lvl][d])
                kinds.append("phys" if flush else "rb")
            self.face_kind[lvl] = kinds

    def _whole_region(self, lvl: int) -> bool:
        """Whether lvl's footprint covers all of lvl-1."""
        if lvl not in self.regions:
            return True
        r0, r1 = self.regions[lvl]
        return bool(np.all(r0 == 0)
                    and np.all(r1 == np.asarray(self.dims[lvl - 1])))

    def _region(self, lvl: int):
        """Slices of lvl's footprint region in lvl-1's [Y, X] patch."""
        r0, r1 = self.regions[lvl]
        return (slice(int(r0[1]), int(r1[1])), slice(int(r0[0]), int(r1[0])))

    def _kcfg(self, lvl: int) -> d2.Dense2DConfig:
        """Refinement faces take RB_COEFFS with a vector-valued b; with
        coefficient fields such a level also carries eps_bc."""
        idr2 = tuple(float(x) for x in 1.0 / self.tree.dr[lvl] ** 2)
        bc_phys = self._bc_static(lvl)
        kinds = self.face_kind[lvl]
        bc_full, b_const = [], []
        for nb in range(4):
            if kinds[nb] == "rb":
                bc_full.append(RB_COEFFS)
                b_const.append(None)   # vector-valued: coarse interp
            else:
                c = bc_phys[nb]
                bc_full.append(c if c is not None else (0.0, 0.0, 0.0))
                spec = self.bc_spec[nb]
                b_const.append(float(spec["value"])
                               if spec["fn"] is None else None)
        eps_bc = None
        if self.n_eps and "rb" in kinds:
            # coefficient-field ghosts: Neumann-zero at physical faces,
            # sides_rb with the coarse-interp vector at refinement faces
            # (m_ghost_cells.f90:131-175, 769-861)
            eps_bc = [RB_COEFFS if k == "rb" else (0.0, 1.0, 0.0)
                      for k in kinds]
        cyl_w = (self._cyl_weights(lvl)
                 if self.cfg.geometry == "cylindrical" else None)
        return d2.Dense2DConfig(
            dims=self.dims[lvl], idr2=idr2, bc=bc_full,
            periodic=self.periodic, dtype=self.cfg.dtype, b_const=b_const,
            n_eps=self.n_eps, eps_bc=eps_bc, cyl_w=cyl_w)

    def _cyl_offset(self, lvl: int) -> float:
        """The patch's first column sits at global radial index
        ``offsets[lvl][0]``."""
        return float(self.offsets[lvl][0])

    def cell_centers(self, lvl: int) -> np.ndarray:
        """Patch interior cell centres [Y, X, 2] in global coordinates."""
        t = self.tree
        X, Y = self.dims[lvl]
        dr, off = t.dr[lvl], self.offsets[lvl]
        out = np.zeros((Y, X, 2))
        out[..., 0] = (t.r_min[0] + (off[0] + np.arange(X) + 0.5)
                       * dr[0])[None, :]
        out[..., 1] = (t.r_min[1] + (off[1] + np.arange(Y) + 0.5)
                       * dr[1])[:, None]
        return out

    def _eval_bc_planes(self, lvl: int) -> List[torch.Tensor]:
        """Physical boundary vectors at the patch's faces (offset-aware);
        refinement faces get zero placeholders, never read (``_planes``
        replaces them)."""
        t = self.tree
        X, Y = self.dims[lvl]
        dr, r0g, off = t.dr[lvl], t.r_min, self.offsets[lvl]
        dt, dev = self.cfg.dtype, self.device
        cx = r0g[0] + (off[0] + np.arange(X) + 0.5) * dr[0]
        cy = r0g[1] + (off[1] + np.arange(Y) + 0.5) * dr[1]
        lo_face = [r0g[d] + off[d] * dr[d] for d in range(2)]
        hi_face = [r0g[d] + (off[d] + self.dims[lvl][d]) * dr[d]
                   for d in range(2)]
        out = []
        for nbd in range(4):
            d = nbd // 2
            n_t = Y if d == 0 else X
            if self.face_kind[lvl][nbd] == "rb":
                out.append(torch.zeros((n_t,), dtype=dt, device=dev))
                continue
            coords = np.zeros((n_t, 2))
            if d == 0:
                coords[:, 0] = lo_face[0] if nbd % 2 == 0 else hi_face[0]
                coords[:, 1] = cy
            else:
                coords[:, 1] = lo_face[1] if nbd % 2 == 0 else hi_face[1]
                coords[:, 0] = cx
            spec = self.bc_spec[nbd]
            if spec["fn"] is not None:
                vals = np.asarray(spec["fn"](coords))
            else:
                vals = np.full(n_t, spec["value"])
            out.append(torch.as_tensor(
                np.ascontiguousarray(vals, np.float64)).to(dev, dt))
        return out

    def _ring_bc(self, lvl, key="phi"):
        """Ghost-ring coefficients: refinement faces take the sides_rb
        combination, physical faces the bc_to_gc formula (coefficient
        fields: Neumann-zero, ghost = own value)."""
        phys = super()._ring_bc(lvl, key)
        return [RB_COEFFS if self.face_kind[lvl][nb] == "rb" else phys[nb]
                for nb in range(4)]

    def _eps_planes(self, state, lvl):
        """Coefficient-field boundary vectors: the coarse-interp vector
        at refinement faces, None (Neumann-zero synthesis, never read) at
        physical faces."""
        kinds = self.face_kind[lvl]
        if not self.n_eps or "rb" not in kinds:
            return None
        out = []
        for i in range(self.n_eps):
            planes = self._planes(state, lvl, key=f"eps{i}")
            out.append([planes[nb] if kinds[nb] == "rb" else None
                        for nb in range(4)])
        return out

    # ------------------------------------------------------------------
    # refinement-boundary ghost vectors
    # ------------------------------------------------------------------
    def _planes(self, state, lvl, key="phi"):
        """BC vectors with refinement faces replaced by the coarse-side
        strip interpolation of ``key``'s coarse field
        (box_gc_for_fine_neighbor, m_ghost_cells.f90:500-577; the 2D form
        keeps mid +- 0.125*grad, :545-555).  Each face's coarse strip
        spans the region +-1 cell across (``r0[td] .. r1[td] + 2`` of the
        ringed coarse patch) at one layer along the face normal: the
        coarse level's ``_var_with_ring`` over that window alone, whose
        ring values are read only where the strip reaches past the coarse
        interior (domain-flush transverse edges)."""
        kinds = self.face_kind[lvl]
        if "rb" not in kinds:
            return state["bc"][lvl]
        planes = list(state["bc"][lvl])
        r0, r1 = self.regions[lvl]
        for nb in range(4):
            if kinds[nb] != "rb":
                continue
            d = nb // 2
            ax = 1 - d          # array axis of the face normal
            td = 1 - d          # the transverse dim (array axis d)
            lo, hi = [0, 0], [0, 0]
            lo[ax] = int(r0[d]) if nb % 2 == 0 else int(r1[d]) + 1
            hi[ax] = lo[ax] + 1
            lo[d], hi[d] = int(r0[td]), int(r1[td]) + 2
            tmp = self._var_with_ring(state, lvl - 1, key, lo, hi)
            planes[nb] = interp_rb_strip(tmp.reshape(1, -1), 2)[0]
        return planes

    # ------------------------------------------------------------------
    # region-aware FAS transfer
    # ------------------------------------------------------------------
    def _restrict_into(self, state, lvl, key):
        """Full-weighting restriction of the fine patch into its
        footprint region of the coarse patch, in place (restrict_onto on
        parents, m_restrict.f90:165-214)."""
        if self._whole_region(lvl):
            return super()._restrict_into(state, lvl, key)
        d2.restrict_2d(state[key][lvl],
                       out=state[key][lvl - 1][self._region(lvl)])
        return state

    def _finish_coarse_rhs(self, state, lvl, lam):
        """rhs_c = A(phi_c) + restrict(res) on the footprint region only
        (parents, m_multigrid.f90:369-383); iold_c = phi_c."""
        if self._whole_region(lvl):
            return super()._finish_coarse_rhs(state, lvl, lam)
        a_phi = self._apply_op(state, lvl - 1, lam)
        reg = self._region(lvl)
        torch.add(a_phi[reg], state["ires"][lvl - 1][reg],
                  out=state["rhs"][lvl - 1][reg])
        return self._save_iold(state, lvl - 1)

    def _correct_children(self, state, lvl_c, lam):
        """phi_fine += prolong(phi_c - iold_c) from the footprint region
        plus its one-cell ring (correct_children, m_multigrid.f90:
        387-402; the ring: coarse (phi - iold) neighbours, or the
        physical synthesis difference at domain-flush faces)."""
        lvl = lvl_c + 1
        if self._whole_region(lvl):
            return super()._correct_children(state, lvl_c, lam)
        r0, r1 = self.regions[lvl]
        ext = r1 - r0
        phi_c = state["phi"][lvl_c]
        iold_c = state["iold"][lvl_c]
        reg = self._region(lvl)
        sub = self._zeros((int(ext[1]) + 2, int(ext[0]) + 2))
        sub[1:-1, 1:-1] = phi_c[reg] - iold_c[reg]
        bc = self._bc_static(lvl_c)
        bp = state["bc"][lvl_c]
        dims_c = self.dims[lvl_c]

        def pick(a, d, idx):
            """Row/column of dim d at coarse-patch cell idx, windowed to
            the region's transverse range."""
            td = 1 - d
            sl: List = [slice(None)] * 2
            sl[1 - d] = idx
            sl[1 - td] = slice(int(r0[td]), int(r1[td]))
            return a[tuple(sl)]

        for nb in range(4):
            d = nb // 2
            lowside = nb % 2 == 0
            if lowside:
                inside = int(r0[d]) > 0
                layer = int(r0[d]) - 1
            else:
                inside = int(r1[d]) < dims_c[d]
                layer = int(r1[d])
            if inside:
                ring = pick(phi_c, d, layer) - pick(iold_c, d, layer)
            else:
                # region flush with the coarse patch face, physical by the
                # gate: ghost(phi) - ghost(iold)
                edge = 0 if lowside else dims_c[d] - 1
                edge2 = 1 if lowside else dims_c[d] - 2
                td = 1 - d
                bpl = bp[nb][int(r0[td]):int(r1[td])]
                c0, c1, c2 = bc[nb]
                gp = c0 * bpl + c1 * pick(phi_c, d, edge)
                gi = c0 * bpl + c1 * pick(iold_c, d, edge)
                if c2 != 0.0:
                    gp = gp + c2 * pick(phi_c, d, edge2)
                    gi = gi + c2 * pick(iold_c, d, edge2)
                ring = gp - gi
            sl: List = [slice(1, -1)] * 2
            sl[1 - d] = 0 if lowside else -1
            sub[tuple(sl)] = ring
        state["phi"][lvl].add_(self._prolong_rect(sub))
        return state
