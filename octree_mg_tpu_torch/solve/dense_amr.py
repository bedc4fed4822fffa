"""Dense-patch AMR FAS multigrid: one dense array per refinement level.

The JAX package's ``DenseAMRMGSolver`` (its solve/dense_amr.py): on a
tree whose every level's boxes tile a rectangle (the reference's own AMR
test tree, tests/test_refinement.f90:191-247), each level is one dense
padded patch and the uniform dense machinery of solve/dense.py runs on
it — the pair, apply, down-leg, residual-restriction, restriction and
prolongation kernels of ops/dense_kernels.

The refinement-boundary ghost (sides_rb, m_ghost_cells.f90:769-861)

    ghost = 0.5*interp + 0.75*x1 - 0.25*x2

is the physical-BC formula ghost = c0*b + c1*x1 + c2*x2 with (c0, c1,
c2) = (0.5, 0.75, -0.25) and b the coarse-side interpolated plane
(box_gc_for_fine_neighbor, +-0.125 transverse gradients), so a patch face
that borders coarser cells is a plane-valued BC face whose b plane is
computed from the coarse patch before each smoothing call (``_planes``).
The plane is constant across the half-sweeps of one call: the coarse
level does not change while the fine one is smoothed.

FAS transfer touches the overlap region only (the fine patch's footprint
in the coarse patch, update_coarse on parents, m_multigrid.f90:347-384):
the restriction kernel's output lands in the region, the tau-corrected
coarse right-hand side is written there, and the up-leg prolongs
(phi_c - iold_c) from the region plus a one-cell ring through the
prolongation kernel's corr_ready mode (the ring: coarse (phi - iold)
neighbours, or the physical-BC synthesis difference where the region is
flush with the domain).  Levels whose footprint covers all of the coarse
level (the uniform chain below the patches) take the base solver's
whole-level transfers, fused down-leg and residual-restriction included.

Variable-coefficient operators ride too: the coefficient fields' ghosts
at refinement faces follow the same scheme (coarse interpolation and the
sides_rb combination), as per-face coefficient synthesis with plane-valued
b (``DenseStencilConfig(eps_bc=...)``).  Those levels run the plain
PyTorch versions on every device, as the JAX package runs its jnp path
for them (``ops.dense_kernels.plain_route_counts``).

Gating (``dense_amr_supported``): 3D cartesian, the five operators, GSRB,
non-periodic, every level's boxes forming a full rectangle, each fine
patch strictly inside its coarse patch except where flush with the
physical domain.  ``make_solver`` sends such trees here, as the JAX
package does; the dense forest takes the other 2:1 octrees.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.tree import Tree
from ..ops import dense_kernels as dk
from ..ops.ghost import interp_rb_strip
from .dense import _ISL, DenseMGSolver
from .multigrid import MGConfig

#: refinement-boundary ghost combination (sides_rb,
#: m_ghost_cells.f90:769-861): ghost = 0.5*interp + 0.75*x1 - 0.25*x2
RB_COEFFS = (0.5, 0.75, -0.25)


def _patch_geometry(tree: Tree) -> Optional[Dict]:
    """Per-level rectangular patch geometry, or None if any level's
    boxes do not tile a rectangle."""
    lvls = list(range(tree.lowest_lvl, tree.highest_lvl + 1))
    offsets: Dict[int, np.ndarray] = {}
    dims: Dict[int, np.ndarray] = {}
    for lvl in lvls:
        ids = tree.lvls[lvl].ids
        if len(ids) == 0:
            return None
        nc = tree.box_size_lvl[lvl]
        ix = tree.ix[ids] - 1  # [n, ndim] 0-based (x, y(, z))
        lo = ix.min(axis=0)
        hi = ix.max(axis=0) + 1
        if len(ids) != int(np.prod(hi - lo)):
            return None
        if len(np.unique(ix, axis=0)) != len(ids):
            return None
        offsets[lvl] = lo * nc
        dims[lvl] = (hi - lo) * nc
    regions: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for lvl in lvls[1:]:
        r0 = offsets[lvl] // 2 - offsets[lvl - 1]
        r1 = (offsets[lvl] + dims[lvl]) // 2 - offsets[lvl - 1]
        if np.any(r0 < 0) or np.any(r1 > dims[lvl - 1]):
            return None
        regions[lvl] = (r0, r1)
    return {"offsets": offsets, "dims": dims, "regions": regions}


def _rb_strips_inside(tree: Tree, geom: Dict) -> bool:
    """Each refinement face needs its coarse strip (region +-1 ring)
    inside the coarse patch; a region face may touch the coarse patch
    edge only where both are flush with the physical domain."""
    for lvl in range(tree.lowest_lvl + 1, tree.highest_lvl + 1):
        r0, r1 = geom["regions"][lvl]
        dims_c = geom["dims"][lvl - 1]
        off_c = geom["offsets"][lvl - 1]
        dom_c = tree.domain_size_lvl[lvl - 1]
        for d in range(tree.ndim):
            lo_flush_dom = off_c[d] + r0[d] == 0
            hi_flush_dom = off_c[d] + r1[d] == dom_c[d]
            if r0[d] == 0 and not lo_flush_dom:
                return False
            if r1[d] == dims_c[d] and not hi_flush_dom:
                return False
    return True


def dense_amr_supported(tree: Tree, cfg: MGConfig) -> bool:
    """Whether the dense-patch AMR path covers this configuration (3D
    cartesian GSRB, the five operators, non-periodic, rectangular patches
    nested with their coarse strips inside)."""
    if not (tree.ndim == 3
            and tree.highest_lvl > 1
            and cfg.operator in ("laplacian", "helmholtz", "vlaplacian",
                                 "vhelmholtz", "ahelmholtz")
            and cfg.geometry == "cartesian"
            and cfg.smoother in ("gsrb", "gs")
            and not any(tree.periodic)):
        return False
    geom = _patch_geometry(tree)
    if geom is None:
        return False
    return _rb_strips_inside(tree, geom)


class DenseAMRMGSolver(DenseMGSolver):
    """FAS multigrid on dense rectangular AMR patches.

    The state is the base solver's, one padded patch per level; the
    boundary planes of a refinement face are placeholders (zeros) that
    the cycle never reads: ``_planes`` computes that face's plane from
    the coarse patch whenever a kernel needs it."""

    _supported = staticmethod(dense_amr_supported)

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
        # face kinds: "phys" where the patch face lies on the physical
        # domain boundary, else "rb" (borders coarser cells)
        self.face_kind: Dict[int, List[str]] = {}
        for lvl in self.levels:
            kinds = []
            for nb in range(6):
                d = nb // 2
                if nb % 2 == 0:
                    flush = self.offsets[lvl][d] == 0
                else:
                    flush = (self.offsets[lvl][d] + self.dims[lvl][d]
                             == t.domain_size_lvl[lvl][d])
                kinds.append("phys" if flush else "rb")
            self.face_kind[lvl] = kinds

    def _whole_region(self, lvl: int) -> bool:
        """Whether lvl's footprint covers all of lvl-1 (the uniform
        chain): then the base solver's whole-level transfers apply."""
        if lvl not in self.regions:
            return True
        r0, r1 = self.regions[lvl]
        return bool(np.all(r0 == 0)
                    and np.all(r1 == np.asarray(self.dims[lvl - 1])))

    def _region_pad(self, lvl: int):
        """Slices of lvl's footprint region in lvl-1's padded fields."""
        r0, r1 = self.regions[lvl]
        return (slice(dk.PZ + int(r0[2]), dk.PZ + int(r1[2])),
                slice(dk.PY + int(r0[1]), dk.PY + int(r1[1])),
                slice(int(r0[0]), int(r1[0])))

    def _kcfg(self, lvl: int) -> dk.DenseStencilConfig:
        """Refinement faces take RB_COEFFS with a plane-valued b; with
        coefficient fields such a level also carries eps_bc."""
        idr2 = tuple(float(x) for x in 1.0 / self.tree.dr[lvl] ** 2)
        bc_phys = self._bc_static(lvl)
        kinds = self.face_kind[lvl]
        bc_full, b_const = [], []
        for nb in range(6):
            if kinds[nb] == "rb":
                bc_full.append(RB_COEFFS)
                b_const.append(None)   # plane-valued: coarse interp
            else:
                c = bc_phys[nb]
                bc_full.append(c if c is not None else (0.0, 0.0, 0.0))
                spec = self.bc_spec[nb]
                b_const.append(float(spec["value"])
                               if spec["fn"] is None else None)
        eps_bc = None
        if self.n_eps and "rb" in kinds:
            # coefficient-field ghosts: Neumann-zero at physical faces
            # (ghost = own value, m_vlaplacian.f90:25-28), sides_rb with
            # the coarse-interp plane at refinement faces — the two-stage
            # scheme of any variable (m_ghost_cells.f90:131-175, 769-861)
            eps_bc = [RB_COEFFS if k == "rb" else (0.0, 1.0, 0.0)
                      for k in kinds]
        return dk.DenseStencilConfig(
            dims=self.dims[lvl], idr2=idr2, bc=bc_full,
            periodic=self.periodic, dtype=self.cfg.dtype, b_const=b_const,
            n_eps=self.n_eps, eps_bc=eps_bc)

    def _face_coords(self, lvl: int):
        """Cell-centre coordinate vectors (x, y, z) of the patch and the
        global positions of its low and high faces."""
        t = self.tree
        dr, off = t.dr[lvl], self.offsets[lvl]
        cs = [t.r_min[d] + (off[d] + np.arange(self.dims[lvl][d]) + 0.5)
              * dr[d] for d in range(3)]
        lo = [t.r_min[d] + off[d] * dr[d] for d in range(3)]
        hi = [t.r_min[d] + (off[d] + self.dims[lvl][d]) * dr[d]
              for d in range(3)]
        return cs, lo, hi

    def cell_centers(self, lvl: int) -> np.ndarray:
        """Patch interior cell centres [Z, Y, X, 3] in global
        coordinates (host-side)."""
        (cx, cy, cz), _, _ = self._face_coords(lvl)
        X, Y, Z = self.dims[lvl]
        out = np.zeros((Z, Y, X, 3))
        out[..., 0] = cx[None, None, :]
        out[..., 1] = cy[None, :, None]
        out[..., 2] = cz[:, None, None]
        return out

    def _eval_bc_planes(self, lvl: int) -> List[torch.Tensor]:
        """Physical boundary planes at the patch's faces (offset-aware);
        refinement faces get zero placeholders of the plane shape, never
        read (``_planes`` replaces them)."""
        X, Y, Z = self.dims[lvl]
        (cx, cy, cz), lo_face, hi_face = self._face_coords(lvl)
        dt, dev = self.cfg.dtype, self.device
        out = []
        for nbd in range(6):
            d = nbd // 2
            pad = (((dk.PZ, dk.PZ), (dk.PY, dk.PY)), ((dk.PZ, dk.PZ), (0, 0)),
                   ((dk.PY, dk.PY), (0, 0)))[d]
            shape = ((Z, Y), (Z, X), (Y, X))[d]
            if self.face_kind[lvl][nbd] == "rb":
                pshape = tuple(s + p[0] + p[1] for s, p in zip(shape, pad))
                out.append(torch.zeros(pshape, dtype=dt, device=dev))
                continue
            coords = np.zeros(shape + (3,))
            coords[..., d] = lo_face[d] if nbd % 2 == 0 else hi_face[d]
            if d == 0:
                coords[..., 1] = cy[None, :]
                coords[..., 2] = cz[:, None]
            elif d == 1:
                coords[..., 0] = cx[None, :]
                coords[..., 2] = cz[:, None]
            else:
                coords[..., 0] = cx[None, :]
                coords[..., 1] = cy[:, None]
            spec = self.bc_spec[nbd]
            if spec["fn"] is not None:
                vals = np.asarray(spec["fn"](coords))
            else:
                vals = np.full(shape, spec["value"])
            vals = np.pad(vals, pad)
            out.append(torch.as_tensor(
                np.ascontiguousarray(vals, np.float64)).to(dev, dt))
        return out

    def _ring_bc(self, lvl, key="phi"):
        """Ghost-ring coefficients: refinement faces take the sides_rb
        combination, physical faces the bc_to_gc formula (coefficient
        fields: Neumann-zero, ghost = own value)."""
        phys = super()._ring_bc(lvl, key)
        return [RB_COEFFS if self.face_kind[lvl][nb] == "rb" else phys[nb]
                for nb in range(6)]

    def _eps_planes(self, state, lvl):
        """Coefficient-field boundary planes: the coarse-interp plane at
        refinement faces (the interpolation of phi's), None (never read:
        Neumann-zero synthesis) at physical faces."""
        kinds = self.face_kind[lvl]
        if not self.n_eps or "rb" not in kinds:
            return None
        out = []
        for i in range(self.n_eps):
            planes = self._planes(state, lvl, key=f"eps{i}")
            out.append([planes[nb] if kinds[nb] == "rb" else None
                        for nb in range(6)])
        return out

    # ------------------------------------------------------------------
    # refinement-boundary ghost planes
    # ------------------------------------------------------------------
    def _planes(self, state, lvl, key="phi"):
        """The boundary planes with each refinement face replaced by the
        coarse-side interpolation of ``key``'s coarse field
        (box_gc_for_fine_neighbor: strip + +-0.125 transverse gradients,
        m_ghost_cells.f90:500-577), padded into the kernels' plane
        layout.  Each face's coarse strip (the region +-1 cell) is the
        coarse level's ``_var_with_ring`` over that strip alone: its ring
        values (synthesized, never the pads) are read only where the
        strip reaches past the coarse interior, at domain-flush
        transverse edges."""
        kinds = self.face_kind[lvl]
        if "rb" not in kinds:
            return state["bc"][lvl]
        planes = list(state["bc"][lvl])
        r0, r1 = self.regions[lvl]
        cfg = self._kcfgs[lvl]
        for nb in range(6):
            if kinds[nb] != "rb":
                continue
            d = nb // 2
            ax = 2 - d
            lo, hi = [0] * 3, [0] * 3
            lo[ax] = int(r0[d]) if nb % 2 == 0 else int(r1[d]) + 1
            hi[ax] = lo[ax] + 1
            for dd in range(3):
                if dd != d:
                    lo[2 - dd], hi[2 - dd] = int(r0[dd]), int(r1[dd]) + 2
            strip = self._var_with_ring(state, lvl - 1, key, lo, hi)
            gc = interp_rb_strip(strip.squeeze(ax)[None], 3)[0]
            p = torch.zeros(cfg.plane_shape(nb), dtype=gc.dtype,
                            device=gc.device)
            if d == 0:
                p[dk.PZ:-dk.PZ, dk.PY:-dk.PY] = gc
            elif d == 1:
                p[dk.PZ:-dk.PZ, :] = gc
            else:
                p[dk.PY:-dk.PY, :] = gc
            planes[nb] = p
        return planes

    # ------------------------------------------------------------------
    # region-aware FAS transfer
    # ------------------------------------------------------------------
    def _fused_transfer_ok(self, state, lvl):
        return (self._whole_region(lvl)
                and super()._fused_transfer_ok(state, lvl))

    def _restrict_into(self, state, lvl, key):
        """Full-weighting restriction of the fine patch (the restriction
        kernel) into its footprint region of the coarse patch, in place
        (restrict_onto on parents, m_restrict.f90:165-214)."""
        if self._whole_region(lvl):
            return super()._restrict_into(state, lvl, key)
        avg = dk.restrict_dense(self._kcfgs[lvl], state[key][lvl])[_ISL]
        state[key][lvl - 1][self._region_pad(lvl)] = avg
        return state

    def _finish_coarse_rhs(self, state, lvl, lam):
        """rhs_c = A(phi_c) + restrict(res) on the footprint region only
        (parents, m_multigrid.f90:369-383); iold_c = phi_c."""
        if self._whole_region(lvl):
            return super()._finish_coarse_rhs(state, lvl, lam)
        a_phi = self._apply_op(state, lvl - 1, lam)
        reg = self._region_pad(lvl)
        torch.add(a_phi[reg], state["ires"][lvl - 1][reg],
                  out=state["rhs"][lvl - 1][reg])
        return self._save_iold(state, lvl - 1)

    def _correct_children(self, state, lvl_c, lam):
        """phi_fine += prolong(phi_c - iold_c) from the footprint region
        plus its one-cell ring (correct_children, m_multigrid.f90:
        387-402), through the prolongation kernel's corr_ready mode; the
        ring reproduces the boxed corr ghosts: plain coarse (phi - iold)
        neighbours, or the physical-BC synthesis difference at
        domain-flush faces."""
        lvl = lvl_c + 1
        if self._whole_region(lvl):
            return super()._correct_children(state, lvl_c, lam)
        r0, r1 = self.regions[lvl]
        ext = r1 - r0
        phi_c = state["phi"][lvl_c]
        iold_c = state["iold"][lvl_c]
        reg = self._region_pad(lvl)
        sub = self._zeros((int(ext[2]) + 2, int(ext[1]) + 2,
                           int(ext[0]) + 2))
        sub[1:-1, 1:-1, 1:-1] = phi_c[reg] - iold_c[reg]
        bc = self._bc_static(lvl_c)
        bp = state["bc"][lvl_c]
        dims_c = self.dims[lvl_c]
        pads = (0, dk.PY, dk.PZ)  # pad per dim d (x, y, z)

        def pick(a, d, idx):
            """Plane of dim d at patch-local cell idx, windowed to the
            region's transverse ranges."""
            sl: List = [slice(None)] * 3
            sl[2 - d] = idx + pads[d]
            for dd in range(3):
                if dd != d:
                    sl[2 - dd] = slice(int(r0[dd]) + pads[dd],
                                       int(r1[dd]) + pads[dd])
            return a[tuple(sl)]

        for nb in range(6):
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
                # region flush with the coarse patch face — physical by
                # the gate: ghost(phi) - ghost(iold)
                edge = 0 if lowside else dims_c[d] - 1
                edge2 = 1 if lowside else dims_c[d] - 2
                c0, c1, c2 = bc[nb]
                # transverse window of the boundary plane (x faces [ZP,
                # YP], y faces [ZP, X], z faces [YP, X])
                tdims = [dd for dd in range(3) if dd != d]
                psl = tuple(slice(int(r0[dd]) + pads[dd],
                                  int(r1[dd]) + pads[dd])
                            for dd in reversed(tdims))
                bpl = bp[nb][psl]
                gp = c0 * bpl + c1 * pick(phi_c, d, edge)
                gi = c0 * bpl + c1 * pick(iold_c, d, edge)
                if c2 != 0.0:
                    gp = gp + c2 * pick(phi_c, d, edge2)
                    gi = gi + c2 * pick(iold_c, d, edge2)
                ring = gp - gi
            sl: List = [slice(1, -1)] * 3
            sl[2 - d] = 0 if lowside else -1
            sub[tuple(sl)] = ring
        self._prolong_add(sub, state["phi"][lvl])
        return state
