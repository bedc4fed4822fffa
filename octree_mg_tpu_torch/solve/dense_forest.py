"""Dense-forest FAS multigrid: arbitrary 2:1-balanced 3D octrees on dense
level canvases.

The reference runs any 2:1-balanced octree; its ghost machinery handles
same-level, refinement-boundary and physical faces per box
(m_ghost_cells.f90:131-285, 769-861).  This solver (the port of the JAX
package's ``solve/dense_forest.py``) stores each refinement level as ONE
padded array over the bounding box of its leaf footprint (the canvas):

* Cells outside the footprint are garbage by contract: they start at
  zero, evolve under the smoother and are fenced off from real cells by
  the ghosts, which are rewritten before every read.  Compare footprint
  cells only, selected with ``torch.where`` (never by multiplying with a
  mask: NaN * 0 is NaN).
* The footprint is decomposed on the host into a few boxes; transfers
  and reductions touch only those.
* Ghost values — refinement-boundary (sides_rb: 0.5*interp + 0.75*x1 -
  0.25*x2), physical (bc_to_gc: c0*b + c1*x1 + c2*x2) and periodic wraps
  — are grouped into rectangular segments of one-cell-thick ghost
  layers.

Two smoothing paths, as in the JAX package:

* **fused canvas** (``_smooth_seg``, default): each layer's ghost
  coefficients go into a [4, T1, T2] plane (c0*b, c1, c2, mask) and the
  stencil kernels synthesize every ghost at read time
  (``pair_sweep_dense``/``stencil_apply_dense`` with ``segs``), so a
  GSRB pair needs no refresh and two pairs run in one pass.  Levels with
  a periodic wrap segment do not take it (their sources are not next to
  the reader), nor do levels with more than ``dk.MAX_SEGS`` layers.
* **sequential** (``_smooth``): ring ghosts inside the canvas are written
  into a copy of it and the six face planes are assembled, then ONE
  half-sweep runs (``half_sweep_dense``); repeated per half-sweep, the
  reference's refill cadence (smooth_boxes, m_multigrid.f90:404-424).
  Concave corners where two axes claim one ghost cell are recomputed by
  fix-up passes with the same per-cell expression.

The gates of the JAX package that are TPU mechanics are dropped: the
128-lane / 8-sublane alignment of ``use_kernel``, ``tz % 8``, the 24 MB
VMEM budget of the segment planes and ``_prolong_add``'s alignment test.
On the card every level launches the kernels; on the CPU their plain
versions run.

State is updated in place, as in DenseMGSolver.  The memo of coarse-side
builds (rb strips, segment planes) is keyed on the dependencies' object
identity AND their version counter (``Tensor._version``): an in-place
write (a PyTorch in-place operation, or a kernel writing through
``data_ptr()``, whose wrapper bumps the counter) invalidates it.
Tensors made under ``torch.inference_mode()`` carry no version counter:
a build with such a dependency is not memoized (same results, more
host work).

Variable-coefficient operators (vlaplacian, vhelmholtz, ahelmholtz):
the coefficient fields ride the same ring and face-plane ghost synthesis
(Neumann-zero physical ghosts = own value, m_vlaplacian.f90:25-28;
sides_rb refinement faces and periodic wraps as for phi), assembled once
per level visit and memoized on the coefficient canvases' versions.
Their configs carry identity ``eps_bc``, so the half-sweep and the apply
take the plain route on every device (``dk.plain_route_counts``), as the
JAX package runs its jnp path for them; the segment smoother is off for
them (the JAX package's gate), and the concave-corner fix-ups recompute
the harmonic-mean expressions with direction-correct coefficient ghosts.

Not here: the multi-device GSPMD placement (ROADMAP A13), the relaxed
``"pair"`` ghost cadence (a measured-negative knob of the JAX package)
and CUDA graphs (``fmg_mode="fused"`` raises).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.constants import NO_BOX
from ..core.tree import Tree
from ..ops import dense_kernels as dk
from ..ops.ghost import interp_rb_strip
from .dense import _ISL, DenseMGSolver
from .dense_amr import RB_COEFFS
from .multigrid import MGConfig


# ---------------------------------------------------------------------------
# host-side geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Seg:
    """One rectangular ghost segment of a level canvas.

    lo/hi: half-open cell rectangle in canvas-local coords (x, y, z);
    along the face-normal dim d=nb//2 it is one cell thick (the ghost
    layer).  sink "ring" = inside the canvas, "face" = one of the six
    face planes.  kind "phys" (bc_to_gc), "rb" (sides_rb w/ coarse
    interp), "wrap" (periodic same-level copy).  For "wrap", src is the
    normal cell index of the source layer; for "rb", cg is the GLOBAL
    coarse normal cell index of the interp strip layer."""

    nb: int
    kind: str
    sink: str
    lo: np.ndarray
    hi: np.ndarray
    src: int = 0
    cg: int = 0


def _mask_rects_2d(mask: np.ndarray) -> List[Tuple[int, int, int, int]]:
    """Greedy decomposition of a 2D boolean mask into rectangles
    (a0, a1, b0, b1), half-open."""
    m = mask.copy()
    out = []
    A, B = m.shape
    for a in range(A):
        b = 0
        while b < B:
            if not m[a, b]:
                b += 1
                continue
            b1 = b
            while b1 + 1 < B and m[a, b1 + 1]:
                b1 += 1
            a1 = a
            while a1 + 1 < A and m[a1 + 1, b:b1 + 1].all():
                a1 += 1
            out.append((a, a1 + 1, b, b1 + 1))
            m[a:a1 + 1, b:b1 + 1] = False
            b = b1 + 1
    return out


def _greedy_rects_3d(occ: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Greedy decomposition of a 3D boolean occupancy [BX, BY, BZ] into
    boxes ((x0,y0,z0), (x1,y1,z1)), half-open."""
    m = occ.copy()
    out = []
    while m.any():
        x, y, z = np.argwhere(m)[0]
        x1 = x
        while x1 + 1 < m.shape[0] and m[x1 + 1, y, z]:
            x1 += 1
        y1 = y
        while y1 + 1 < m.shape[1] and m[x:x1 + 1, y1 + 1, z].all():
            y1 += 1
        z1 = z
        while z1 + 1 < m.shape[2] and m[x:x1 + 1, y:y1 + 1, z1 + 1].all():
            z1 += 1
        out.append((np.array([x, y, z]), np.array([x1 + 1, y1 + 1, z1 + 1])))
        m[x:x1 + 1, y:y1 + 1, z:z1 + 1] = False
    return out


def _dep_sig(t: torch.Tensor):
    """What a memo entry remembers of one dependency: a weak reference
    (object identity without keeping the tensor alive) and its version
    counter, which every in-place write moves."""
    return weakref.ref(t), t._version


def _sig_matches(sig, t: torch.Tensor) -> bool:
    ref, version = sig
    return ref() is t and t._version == version


def _dep_memo(obj, name, lvlkey, deps, build):
    """Memo of the coarse-side builds of one phase (rb strips, segment
    planes): ``build`` is a function of the dependency tensors (coarser
    canvases and the boundary planes) and of static geometry.  An entry
    is reused while every dependency is the same object at the same
    version.  Saves the repeated coarse-side assembly between the
    consumers of one level visit (smooth, residual and transfers read
    the same coarse canvases).  An inference tensor has no version
    counter, so nothing could tell its writes: a build that depends on
    one is returned unmemoized."""
    if any(t.is_inference() for t in deps):
        return build()
    memo = obj.__dict__.setdefault(name, {})
    lst = memo.setdefault(lvlkey, [])
    for sigs, r in lst:
        if len(sigs) == len(deps) and all(
                _sig_matches(s, t) for s, t in zip(sigs, deps)):
            return r
    r = build()
    lst.append(([_dep_sig(t) for t in deps], r))
    if len(lst) > 4:
        lst.pop(0)
    return r


class _LevelGeom:
    """Canvas geometry of one refinement level."""

    def __init__(self, tree: Tree, lvl: int, ids=None):
        """ids: a subset of the level's boxes (one connected component,
        for the multi-canvas gate); all of them by default."""
        self.lvl = lvl
        self.nc = nc = tree.box_size_lvl[lvl]
        ids = tree.lvls[lvl].ids if ids is None else np.asarray(ids)
        self.ids = ids
        ix = tree.ix[ids] - 1                     # [n, 3] 0-based box coords
        self.box_lo = ix.min(axis=0)              # canvas origin, box units
        box_hi = ix.max(axis=0) + 1
        self.B = box_hi - self.box_lo             # canvas extent, box units
        self.off = self.box_lo * nc               # cell offset (x, y, z)
        self.dims = tuple(int(v) for v in self.B * nc)
        self.dom_box = tree.domain_size_lvl[lvl] // nc
        self.dom_cells = np.asarray(tree.domain_size_lvl[lvl])
        occ = np.zeros(tuple(self.B), dtype=bool)
        loc = ix - self.box_lo
        occ[loc[:, 0], loc[:, 1], loc[:, 2]] = True
        self.occ = occ
        self.full = bool(occ.all() and np.all(self.B == self.dom_box))
        # footprint rectangles in canvas-local cells
        self.rects = [(lo * nc, hi * nc) for lo, hi in _greedy_rects_3d(occ)]
        self.n_cells = int(occ.sum()) * nc ** 3

    def build_segments(self, periodic) -> List[_Seg]:
        """Classify and merge the footprint's ghost faces."""
        segs: List[_Seg] = []
        nc = self.nc
        occ = self.occ
        B = self.B
        dom = self.dom_box
        for nb in range(6):
            d = nb // 2
            sgn = -1 if nb % 2 == 0 else +1
            # grouped masks keyed by (kind, normal box layer, src/cg)
            groups: Dict[Tuple, np.ndarray] = {}
            tdims = [dd for dd in range(3) if dd != d]
            for p in np.argwhere(occ):
                q = p.copy()
                q[d] += sgn
                qg = q + self.box_lo              # global box coords
                inside_canvas = 0 <= q[d] < B[d]
                if inside_canvas and occ[tuple(q)]:
                    continue                      # direct same-level neighbor
                if 0 <= qg[d] < dom[d]:
                    kind, aux = "rb", 0
                elif periodic[d]:
                    qw = qg.copy()
                    qw[d] %= dom[d]
                    ql = qw - self.box_lo
                    if (0 <= ql[d] < B[d]) and occ[tuple(ql)]:
                        kind, aux = "wrap", 0
                    else:
                        kind, aux = "rb", 0
                else:
                    kind, aux = "phys", 0
                key = (kind, int(q[d]), aux)
                tshape = tuple(int(B[dd]) for dd in tdims)
                groups.setdefault(key, np.zeros(tshape, dtype=bool))[
                    tuple(int(p[dd]) for dd in tdims)] = True
            for (kind, qd, aux), mask in groups.items():
                inside = 0 <= qd < B[d]
                if inside:
                    sink = "ring"
                    # ghost layer: the q-box cell adjacent to p's face
                    g = qd * nc + (nc - 1 if sgn < 0 else 0)
                else:
                    sink = "face"
                    g = -1 if sgn < 0 else self.dims[d]
                g_glob = self.off[d] + g
                src = cg = 0
                if kind == "wrap":
                    src = int((g_glob % self.dom_cells[d]) - self.off[d])
                if kind == "rb":
                    cg = int((g_glob % self.dom_cells[d]) // 2) \
                        if periodic[d] else g_glob // 2
                for a0, a1, b0, b1 in _mask_rects_2d(mask):
                    lo = np.zeros(3, np.int64)
                    hi = np.zeros(3, np.int64)
                    lo[d], hi[d] = g, g + 1
                    lo[tdims[0]], hi[tdims[0]] = a0 * nc, a1 * nc
                    lo[tdims[1]], hi[tdims[1]] = b0 * nc, b1 * nc
                    segs.append(_Seg(nb=nb, kind=kind, sink=sink,
                                     lo=lo, hi=hi, src=src, cg=cg))
        return segs


@dataclasses.dataclass
class _Fix:
    """One fix-up rectangle of footprint cells whose bulk-pass result
    used a clobbered (conflicted) ring ghost: the smoother/operator is
    recomputed on these cells with direction-correct ghost values — the
    same per-cell expression as the bulk pass, so results are bitwise
    what the bulk would produce with per-box ghost storage (the
    reference's layout, m_ghost_cells.f90:232-285)."""

    lo: np.ndarray
    hi: np.ndarray
    upd0: np.ndarray          # parity-0 update mask [z, y, x]
    dirs: List[Dict]          # per dd 0..5: neighbor source plan


def _build_conflict_plan(segs: List[_Seg], dims) -> Optional[List[_Fix]]:
    """Host-side plan of concave-corner ghost conflicts for one level.

    Ring segments of different axes can claim the same garbage cell;
    the canvas keeps only the last write.  For every pairwise overlap,
    both segments' served footprint cells (the overlap shifted one cell
    toward the footprint) are re-listed for fix-up with all six
    neighbor values assembled from the correct sources."""
    ring = [(i, s) for i, s in enumerate(segs) if s.sink == "ring"]
    rects = set()
    for a in range(len(ring)):
        for b in range(a + 1, len(ring)):
            si, sj = ring[a][1], ring[b][1]
            lo = np.maximum(si.lo, sj.lo)
            hi = np.minimum(si.hi, sj.hi)
            if not np.all(lo < hi):
                continue
            for s in (si, sj):
                d = s.nb // 2
                sgn = -1 if s.nb % 2 == 0 else 1
                rlo, rhi = lo.copy(), hi.copy()
                rlo[d] -= sgn
                rhi[d] -= sgn
                rects.add((tuple(rlo), tuple(rhi)))
    if not rects:
        return None
    plan = []
    for rlo_t, rhi_t in sorted(rects):
        rlo = np.array(rlo_t, np.int64)
        rhi = np.array(rhi_t, np.int64)
        gz = np.arange(rlo[2], rhi[2]).reshape(-1, 1, 1)
        gy = np.arange(rlo[1], rhi[1]).reshape(1, -1, 1)
        gx = np.arange(rlo[0], rhi[0]).reshape(1, 1, -1)
        upd0 = ((gy + gx) % 2 == gz % 2)  # red parity 0 (3D dense path)
        dirs = []
        for dd in range(6):
            d = dd // 2
            step = -1 if dd % 2 == 0 else 1
            nlo, nhi = rlo.copy(), rhi.copy()
            nlo[d] += step
            nhi[d] += step
            # clip the (at most one) out-of-canvas layer to face planes
            out_side = None
            ilo, ihi = nlo.copy(), nhi.copy()
            if nlo[d] < 0:
                out_side = "lo"
                ilo[d] = 0
            if nhi[d] > dims[d]:
                out_side = "hi"
                ihi[d] = dims[d]
            overlays = []
            for i, s in ring:
                if s.nb != dd:
                    continue
                olo = np.maximum(ilo, s.lo)
                ohi = np.minimum(ihi, s.hi)
                if np.all(olo < ohi):
                    overlays.append((i, olo, ohi))
            dirs.append({"nlo": nlo, "nhi": nhi, "ilo": ilo, "ihi": ihi,
                         "out_side": out_side, "overlays": overlays})
        plan.append(_Fix(lo=rlo, hi=rhi, upd0=upd0, dirs=dirs))
    return plan


def _forest_balanced(tree: Tree) -> bool:
    """2:1 balance: every missing same-level neighbor must have a coarse
    one (the reference ghost scheme handles one-level jumps only)."""
    for lvl in range(tree.lowest_lvl + 1, tree.highest_lvl + 1):
        for b in tree.lvls[lvl].ids:
            for nb in range(2 * tree.ndim):
                if tree.neighbors[int(b), nb] == NO_BOX:
                    p = int(tree.parent[int(b)])
                    if tree.neighbors[p, nb] <= NO_BOX:
                        return False
    return True


def dense_forest_supported(tree: Tree, cfg: MGConfig,
                           min_fill: float = 0.2) -> bool:
    """Whether the JAX package's dense-forest path covers this
    configuration (the five operators)."""
    if not (tree.ndim == 3
            and tree.highest_lvl > 1
            and cfg.operator in ("laplacian", "helmholtz", "vlaplacian",
                                 "vhelmholtz", "ahelmholtz")
            and cfg.geometry == "cartesian"
            and cfg.smoother in ("gsrb", "gs")):
        return False
    if not _forest_balanced(tree):
        return False
    for lvl in range(tree.lowest_lvl, tree.highest_lvl + 1):
        if len(tree.lvls[lvl].ids) == 0:
            return False
        g = _LevelGeom(tree, lvl)
        if g.n_cells < min_fill * int(np.prod(g.dims)):
            return False
    return True


# ---------------------------------------------------------------------------
# solver
# ---------------------------------------------------------------------------

class DenseForestMGSolver(DenseMGSolver):
    """FAS multigrid on dense level canvases over arbitrary forests
    (the five operators).

    ``seg_fused`` (default True) selects the fused-canvas smoother on
    every level it covers; False runs the sequential half-sweep path
    everywhere (tests hold the two against each other)."""

    _supported = staticmethod(dense_forest_supported)
    seg_fused = True

    def __init__(self, tree: Tree, config: Optional[MGConfig] = None):
        cfg = config or MGConfig()
        if cfg.fmg_mode == "fused":
            raise NotImplementedError(
                "dense forest: fmg_mode='fused' (CUDA graphs) is not "
                "supported; the forest's ghost memo is keyed on eager "
                "tensor versions (use fmg_mode='split')")
        super().__init__(tree, cfg)

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def _build_levels(self):
        t = self.tree
        all_lvls = list(range(t.lowest_lvl, t.highest_lvl + 1))
        self.geom: Dict[int, _LevelGeom] = {
            lvl: _LevelGeom(t, lvl) for lvl in all_lvls}
        self.dims = {lvl: self.geom[lvl].dims for lvl in all_lvls}
        self.offsets = {lvl: self.geom[lvl].off for lvl in all_lvls}
        if self.coarse_solver == "direct":
            direct = None
            for lvl in all_lvls:
                if (self.geom[lvl].full
                        and int(np.prod(self.dims[lvl]))
                        <= self.DIRECT_MAX_CELLS):
                    direct = lvl
            if direct is None:
                direct = all_lvls[0]
            self.levels = [l for l in all_lvls if l >= direct]
        else:
            self.levels = all_lvls
        per = tuple(bool(p) for p in t.periodic)
        self.segs: Dict[int, List[_Seg]] = {
            lvl: self.geom[lvl].build_segments(per)
            for lvl in self.levels}
        #: concave-corner ghost-conflict fix-up plans (None = conflict
        #: free: rectangular footprints, isolated patches, full levels)
        self.conflicts: Dict[int, Optional[List[_Fix]]] = {
            lvl: _build_conflict_plan(self.segs[lvl], self.dims[lvl])
            for lvl in self.levels}

    def _a0_zero(self) -> bool:
        """Forest rendering of DenseMGSolver._a0_zero: the kernels see
        identity-coefficient planes, but ghost(0) is 0 whenever the
        PHYSICAL boundary values are 0 — rb ghosts of the zero field
        interpolate the zero coarse strip, wraps copy 0."""
        for spec in self.bc_spec:
            if spec["fn"] is not None or float(spec["value"]) != 0.0:
                return False
        return True

    def _kcfg(self, lvl: int) -> dk.DenseStencilConfig:
        """Every face is a precomputed ghost plane with identity
        coefficients: the plane carries the already-synthesized ghost
        values (phys/rb/wrap per segment), refreshed between half-sweeps
        by the driver.  Coefficient fields are pre-synthesized the same
        way: identity ``eps_bc`` faces consume the assembled coefficient
        planes (the plain route on every device)."""
        idr2 = tuple(float(x) for x in
                     1.0 / self.tree.dr[self._lvl_of(lvl)] ** 2)
        return dk.DenseStencilConfig(
            dims=self.dims[lvl], idr2=idr2, bc=[(1.0, 0.0, 0.0)] * 6,
            periodic=(False, False, False), dtype=self.cfg.dtype,
            b_const=[None] * 6, n_eps=self.n_eps,
            eps_bc=[(1.0, 0.0, 0.0)] * 6 if self.n_eps else None)

    def _sync_pads(self, arr, lvl):
        # periodic wraps ride the face planes / wrap segments; the pads
        # stay garbage by contract
        return arr

    def cell_centers(self, lvl: int) -> np.ndarray:
        """Canvas cell centers [Z, Y, X, 3] in global coordinates
        (non-footprint cells get coordinates too — harmless)."""
        t = self.tree
        X, Y, Z = self.dims[lvl]
        dr = t.dr[self._lvl_of(lvl)]
        off = self.offsets[lvl]
        out = np.zeros((Z, Y, X, 3))
        for d, sl in ((0, (None, None, slice(None))),
                      (1, (None, slice(None), None)),
                      (2, (slice(None), None, None))):
            c = t.r_min[d] + (off[d] + np.arange(self.dims[lvl][d]) + 0.5) \
                * dr[d]
            out[..., d] = c[sl]
        return out

    def footprint_mask(self, lvl: int) -> np.ndarray:
        """Boolean [Z, Y, X] mask of real (leaf-footprint) cells."""
        X, Y, Z = self.dims[lvl]
        m = np.zeros((Z, Y, X), dtype=bool)
        for lo, hi in self.geom[lvl].rects:
            m[lo[2]:hi[2], lo[1]:hi[1], lo[0]:hi[0]] = True
        return m

    def set_interior(self, state, lvl, key, values):
        """Coefficient fields get their garbage (non-footprint) cells
        pinned to 1.0: zero eps there would make the garbage harmonic
        means 0/0 = NaN.  Footprint values pass through untouched."""
        if key.startswith("eps"):
            values = torch.as_tensor(values).to(self.device, self.cfg.dtype)
            mask = torch.as_tensor(self.footprint_mask(lvl),
                                   device=self.device)
            values = torch.where(mask, values, 1.0)
        return super().set_interior(state, lvl, key, values)

    def _bc_plane_shape(self, lvl: int, nb: int) -> Tuple[int, int]:
        """Shape of the raw boundary-value plane of face nb (unpadded)."""
        X, Y, Z = self.dims[lvl]
        return ((Z, Y), (Z, X), (Y, X))[nb // 2]

    def _eval_bc_planes(self, lvl: int) -> List[torch.Tensor]:
        """RAW boundary values b per face, unpadded [face shape] (on
        every face, also where no physical segment lies); the ghost
        synthesis happens in the plane assembly."""
        t = self.tree
        X, Y, Z = self.dims[lvl]
        dr = t.dr[self._lvl_of(lvl)]
        r0g = t.r_min
        off = self.offsets[lvl]
        cx = r0g[0] + (off[0] + np.arange(X) + 0.5) * dr[0]
        cy = r0g[1] + (off[1] + np.arange(Y) + 0.5) * dr[1]
        cz = r0g[2] + (off[2] + np.arange(Z) + 0.5) * dr[2]
        lo_face = [r0g[d] + off[d] * dr[d] for d in range(3)]
        hi_face = [r0g[d] + (off[d] + self.dims[lvl][d]) * dr[d]
                   for d in range(3)]
        out = []
        for nbd in range(6):
            d = nbd // 2
            shape = self._bc_plane_shape(lvl, nbd)
            spec = self.bc_spec[nbd]
            if spec["fn"] is None:
                vals = np.full(shape, spec["value"], dtype=np.float64)
            else:
                coords = np.zeros(shape + (3,))
                face = lo_face[d] if nbd % 2 == 0 else hi_face[d]
                coords[..., d] = face
                if d == 0:
                    coords[..., 1] = cy[None, :]
                    coords[..., 2] = cz[:, None]
                elif d == 1:
                    coords[..., 0] = cx[None, :]
                    coords[..., 2] = cz[:, None]
                else:
                    coords[..., 0] = cx[None, :]
                    coords[..., 1] = cy[:, None]
                vals = np.asarray(spec["fn"](coords))
            out.append(torch.as_tensor(
                np.ascontiguousarray(vals, np.float64)).to(
                    self.device, self.cfg.dtype))
        return out

    # ------------------------------------------------------------------
    # ghost machinery
    # ------------------------------------------------------------------
    def _cansl(self, lo, hi):
        """Padded-canvas slice of a canvas-local cell rectangle."""
        return (slice(dk.PZ + int(lo[2]), dk.PZ + int(hi[2])),
                slice(dk.PY + int(lo[1]), dk.PY + int(hi[1])),
                slice(int(lo[0]), int(hi[0])))

    def _seg_x12(self, canvas, seg):
        """(x1, x2) interior planes adjacent to a ghost segment (2D,
        squeezed along the normal)."""
        d = seg.nb // 2
        step = 1 if seg.nb % 2 == 0 else -1  # towards the footprint
        lo1, hi1 = seg.lo.copy(), seg.hi.copy()
        lo1[d] += step
        hi1[d] += step
        lo2, hi2 = lo1.copy(), hi1.copy()
        lo2[d] += step
        hi2[d] += step
        ax = 2 - d
        x1 = canvas[self._cansl(lo1, hi1)].squeeze(ax)
        x2 = canvas[self._cansl(lo2, hi2)].squeeze(ax)
        return x1, x2

    def _memo_deps(self, state, lvl, key):
        """The tensors a coarse-side build of level lvl reads: every
        coarser canvas of ``key`` and every raw boundary plane."""
        return tuple(v for u, v in state[key].items()
                     if self._lvl_of(u) < self._lvl_of(lvl)) \
            + tuple(pp for ps in state["bc"].values() for pp in ps)

    def _rb_cache(self, state, lvl, key) -> Dict[int, torch.Tensor]:
        """Memoized coarse-side interpolation planes (see
        :func:`_dep_memo`)."""
        if not any(se.kind == "rb" for se in self.segs[lvl]):
            return {}
        return _dep_memo(self, "_rbc_memo", (lvl, key),
                         self._memo_deps(state, lvl, key),
                         lambda: self._rb_cache_build(state, lvl, key))

    def _rb_cache_build(self, state, lvl, key) -> Dict[int, torch.Tensor]:
        """Coarse-side interpolation planes b per rb segment
        (box_gc_for_fine_neighbor: strip + +-0.125 transverse gradients,
        m_ghost_cells.f90:500-577)."""
        uc = self._coarse_of(lvl)
        bc_c = self._rb_cache(state, uc, key)
        # +-1 transverse strip reads are per-axis ghost reads of the
        # coarse neighbor box (m_ghost_cells.f90:557-576); at conflicted
        # ring cells only the axis-preferenced assembly carries the right
        # value for that read direction
        need = self.conflicts.get(uc) is not None
        if need:
            asm_ax = {a: self._assemble(state, uc, key, bcache=bc_c,
                                        prefer=a)[:2] for a in range(3)}
            asm = asm_ax[0]
        else:
            asm = self._assemble(state, uc, key, bcache=bc_c)[:2]
        off_c = self.offsets[uc]
        off_f = self.offsets[lvl]
        out = {}
        for i, seg in enumerate(self.segs[lvl]):
            if seg.kind != "rb":
                continue
            d = seg.nb // 2
            sl: List = [0, 0, 0]
            # normal: global coarse layer -> ext index (+1 ghost ring)
            sl[2 - d] = seg.cg - int(off_c[d]) + 1
            for dd in range(3):
                if dd == d:
                    continue
                c0 = (int(off_f[dd]) + int(seg.lo[dd])) // 2 - int(off_c[dd])
                c1 = (int(off_f[dd]) + int(seg.hi[dd])) // 2 - int(off_c[dd])
                sl[2 - dd] = slice(c0, c1 + 2)  # ext coords: +-1 ring
            tmp = self._ext_strip(asm, uc, tuple(sl))  # [t_hi+2, t_lo+2]
            if need:
                t_lo, t_hi = [dd for dd in range(3) if dd != d]
                e_hi = self._ext_strip(asm_ax[t_hi], uc, tuple(sl))
                e_lo = self._ext_strip(asm_ax[t_lo], uc, tuple(sl))
                tmp[0, :] = e_hi[0, :]
                tmp[-1, :] = e_hi[-1, :]
                tmp[:, 0] = e_lo[:, 0]
                tmp[:, -1] = e_lo[:, -1]
            out[i] = interp_rb_strip(tmp[None])[0]
        return out

    def _ext_strip(self, asm, lvl, sl):
        """ext[sl] (one int index + two slices, array z,y,x order) of the
        [N+2]^3 canvas with all ghosts WITHOUT materializing it: interior
        positions slice the ring-written canvas; out-of-canvas border
        lines come from the assembled face planes; corner positions (two
        border coords) stay zero, as in the ext."""
        canvas, planes = asm
        N = [int(self.dims[lvl][2]), int(self.dims[lvl][1]),
             int(self.dims[lvl][0])]              # array-axis extents
        pads = (dk.PZ, dk.PY, 0)
        axes = [a for a in range(3) if isinstance(sl[a], slice)]
        a1, a2 = axes
        A0 = [a for a in range(3) if a not in axes][0]
        n = int(sl[A0])                           # interior ext layer
        s1, s2 = sl[a1], sl[a2]
        tmp = self._zeros((s1.stop - s1.start, s2.stop - s2.start))
        r0, r1 = max(s1.start, 1), min(s1.stop, N[a1] + 1)
        c0, c1 = max(s2.start, 1), min(s2.stop, N[a2] + 1)
        if r0 < r1 and c0 < c1:
            isl: List = [0, 0, 0]
            isl[A0] = pads[A0] + (n - 1)
            isl[a1] = slice(pads[a1] + r0 - 1, pads[a1] + r1 - 1)
            isl[a2] = slice(pads[a2] + c0 - 1, pads[a2] + c1 - 1)
            tmp[r0 - s1.start:r1 - s1.start,
                c0 - s2.start:c1 - s2.start] = canvas[tuple(isl)]

        def border(axis_b, e_coord):
            side = 0 if e_coord == 0 else 1
            p = planes[2 * (2 - axis_b) + side]
            idx = []
            for a in range(3):
                if a == axis_b:
                    continue
                padp = pads[a]
                if a == A0:
                    idx.append(padp + (n - 1))
                elif a == a1:
                    idx.append(slice(padp + r0 - 1, padp + r1 - 1))
                else:
                    idx.append(slice(padp + c0 - 1, padp + c1 - 1))
            return p[tuple(idx)]

        if s1.start == 0:
            tmp[0, c0 - s2.start:c1 - s2.start] = border(a1, 0)
        if s1.stop == N[a1] + 2:
            tmp[-1, c0 - s2.start:c1 - s2.start] = border(a1, N[a1] + 1)
        if s2.start == 0:
            tmp[r0 - s1.start:r1 - s1.start, 0] = border(a2, 0)
        if s2.stop == N[a2] + 2:
            tmp[r0 - s1.start:r1 - s1.start, -1] = border(a2, N[a2] + 1)
        return tmp

    def _ext_window(self, asm, lvl, sl3):
        """ext[sl3] (three slices) without materializing the ext (the
        3D-window form of :meth:`_ext_strip`): the interior block is ONE
        slice of the ring-written canvas; window faces at ext borders
        come from the assembled face planes; edge/corner positions (two
        or more border coords) stay zero, as in the ext."""
        canvas, planes = asm
        N = [int(self.dims[lvl][2]), int(self.dims[lvl][1]),
             int(self.dims[lvl][0])]
        pads = (dk.PZ, dk.PY, 0)
        T = [s.stop - s.start for s in sl3]
        lo = [max(s.start, 1) for s in sl3]
        hi = [min(s.stop, N[a] + 1) for a, s in enumerate(sl3)]
        tmp = self._zeros(tuple(T))
        tmp[tuple(slice(lo[a] - sl3[a].start, hi[a] - sl3[a].start)
                  for a in range(3))] = canvas[tuple(
                      slice(pads[a] + lo[a] - 1, pads[a] + hi[a] - 1)
                      for a in range(3))]
        for axis_b in range(3):
            others = [a for a in range(3) if a != axis_b]
            for side in (0, 1):
                if side == 0 and sl3[axis_b].start != 0:
                    continue
                if side == 1 and sl3[axis_b].stop != N[axis_b] + 2:
                    continue
                p = planes[2 * (2 - axis_b) + side]
                psl = tuple(slice(pads[a] + lo[a] - 1, pads[a] + hi[a] - 1)
                            for a in others)
                osl: List = [0, 0, 0]
                osl[axis_b] = 0 if side == 0 else T[axis_b] - 1
                for a in others:
                    osl[a] = slice(lo[a] - sl3[a].start, hi[a] - sl3[a].start)
                tmp[tuple(osl)] = p[psl]
        return tmp

    def _ring_values(self, canvas, bplanes_raw, bcache, lvl, key="phi"
                     ) -> Dict[int, torch.Tensor]:
        """Synthesized ghost values per ring segment (3D, seg-rect
        shaped), computed from the pre-sweep canvas.  Kept separate from
        the canvas write so concave-corner conflicts (two axes claiming
        one garbage cell — impossible in the reference's per-box ghost
        storage) can be resolved exactly by the fix-up passes.

        key: coefficient fields (eps*) take Neumann-zero physical ghosts
        (= own value, m_vlaplacian.f90:25-28) but the same sides_rb
        refinement faces and periodic wraps as phi."""
        bc_phys = self._ring_bc(lvl, key)
        is_eps = key.startswith("eps")
        out = {}
        for i, seg in enumerate(self.segs[lvl]):
            if seg.sink != "ring":
                continue
            d = seg.nb // 2
            if seg.kind == "wrap":
                lo, hi = seg.lo.copy(), seg.hi.copy()
                lo[d], hi[d] = seg.src, seg.src + 1
                out[i] = canvas[self._cansl(lo, hi)]
                continue
            x1, x2 = self._seg_x12(canvas, seg)
            if seg.kind == "rb":
                c0, c1, c2 = RB_COEFFS
                b = bcache[i]
            elif is_eps:
                # ghost = own value: 1.0*x1, bitwise the boxed copy
                out[i] = (1.0 * x1).unsqueeze(2 - d)
                continue
            else:
                c0, c1, c2 = bc_phys[seg.nb]
                b = self._seg_bwin(bplanes_raw, seg)
            vals = c0 * b + c1 * x1
            if c2 != 0.0:
                vals = vals + c2 * x2
            out[i] = vals.unsqueeze(2 - d)
        return out

    def _write_ring(self, canvas, vals, lvl, prefer: Optional[int] = None):
        """A copy of the canvas with the ring ghost values written in
        (refreshed before every half-sweep — the reference refills
        ghosts after every substep, m_multigrid.f90:412-423); the canvas
        itself when the level has no ring segment.

        prefer: optional axis whose segments are written LAST, so at
        conflicted cells the copy carries that axis's ghost (used by
        consumers that read ghosts along one known axis)."""
        items = [(i, s) for i, s in enumerate(self.segs[lvl])
                 if s.sink == "ring"]
        if not items:
            return canvas
        if prefer is not None:
            items.sort(key=lambda t: t[1].nb // 2 == prefer)
        canvas = canvas.clone()
        for i, seg in items:
            canvas[self._cansl(seg.lo, seg.hi)] = vals[i]
        return canvas

    def _seg_bwin(self, bplanes_raw, seg):
        """Window of the raw physical boundary-value plane for a seg."""
        d = seg.nb // 2
        tdims = [dd for dd in range(3) if dd != d]
        sl = tuple(slice(int(seg.lo[dd]), int(seg.hi[dd]))
                   for dd in reversed(tdims))  # slow -> fast plane axes
        return bplanes_raw[seg.nb][sl]

    # ------------------------------------------------------------------
    # concave-corner conflict fix-ups
    # ------------------------------------------------------------------
    def _plane_win(self, planes, dd, lo, hi):
        """Window of an assembled (padded) face plane over a rect's
        transverse extent, expanded to 3D [z, y, x] with normal size 1.
        The bulk pass reads these cells as ghost = 1.0*plane + 0.0*x1,
        which is bitwise the plane value."""
        d = dd // 2
        if d == 0:
            return planes[dd][dk.PZ + int(lo[2]):dk.PZ + int(hi[2]),
                              dk.PY + int(lo[1]):dk.PY + int(hi[1]), None]
        if d == 1:
            return planes[dd][dk.PZ + int(lo[2]):dk.PZ + int(hi[2]), None,
                              int(lo[0]):int(hi[0])]
        return planes[dd][None, dk.PY + int(lo[1]):dk.PY + int(hi[1]),
                          int(lo[0]):int(hi[0])]

    def _nb_vals(self, lvl, canvas, vals, planes, dd, ent):
        """Direction-dd neighbor values of a fix rect: canvas cells,
        with ring segments serving THIS direction overlaid (correct
        regardless of which axis won the canvas write), and face-plane
        values for the out-of-canvas layer."""
        ax = 2 - dd // 2
        vin = None
        ilo, ihi = ent["ilo"], ent["ihi"]
        if np.all(ilo < ihi):
            vin = canvas[self._cansl(ilo, ihi)].clone()
            for i, olo, ohi in ent["overlays"]:
                seg = self.segs[lvl][i]
                src = vals[i][
                    slice(int(olo[2] - seg.lo[2]), int(ohi[2] - seg.lo[2])),
                    slice(int(olo[1] - seg.lo[1]), int(ohi[1] - seg.lo[1])),
                    slice(int(olo[0] - seg.lo[0]), int(ohi[0] - seg.lo[0]))]
                vin[slice(int(olo[2] - ilo[2]), int(ohi[2] - ilo[2])),
                    slice(int(olo[1] - ilo[1]), int(ohi[1] - ilo[1])),
                    slice(int(olo[0] - ilo[0]), int(ohi[0] - ilo[0]))] = src
        if ent["out_side"] is None:
            return vin
        vout = self._plane_win(planes, dd, ent["nlo"], ent["nhi"])
        if vin is None:
            return vout
        if ent["out_side"] == "lo":
            return torch.cat([vout, vin], dim=ax)
        return torch.cat([vin, vout], dim=ax)

    def _fix_nbrs(self, lvl, canvas, vals, planes, d, fix):
        """Direction-d (lo, hi) neighbor values of a fix rect."""
        return (self._nb_vals(lvl, canvas, vals, planes, 2 * d,
                              fix.dirs[2 * d]),
                self._nb_vals(lvl, canvas, vals, planes, 2 * d + 1,
                              fix.dirs[2 * d + 1]))

    def _fix_coeffs(self, lvl, easm, d, fix, rsl):
        """The two harmonic-mean face coefficients of dim d on a fix rect,
        ``((2*e0)*e_nb)/(e0 + e_nb)*idr2[d]`` with direction-correct
        coefficient neighbours — the expression of dk._face_coeffs."""
        cfg = self._kcfgs[lvl]
        ec, epl, ev = easm[0 if cfg.n_eps == 1 else d]
        e0 = ec[rsl]
        elo, ehi = self._fix_nbrs(lvl, ec, ev, epl, d, fix)
        idr2 = cfg.rnd(cfg.idr2[d])
        return (2.0 * e0 * elo / (e0 + elo) * idr2,
                2.0 * e0 * ehi / (e0 + ehi) * idr2)

    def _upd(self, fix, parity):
        """The fix rect's update mask of a parity, on the device."""
        cache = fix.__dict__.setdefault("_upd_t", {})
        if parity not in cache:
            cache[parity] = torch.as_tensor(
                fix.upd0 if parity == 0 else ~fix.upd0, device=self.device)
        return cache[parity]

    def _fix_sweep(self, lvl, swept, canvas, vals, planes, rhs, lam, parity,
                   easm=()):
        """Recompute the GSRB update on the conflict rects with correct
        ghosts, in place on ``swept`` — the per-cell expression of
        dense_kernels._halfsweep (with coefficients its num/den form,
        coefficient neighbours first), so the result is bitwise the
        conflict-free value."""
        cfg = self._kcfgs[lvl]
        for fix in self.conflicts[lvl]:
            rsl = self._cansl(fix.lo, fix.hi)
            if cfg.n_eps:
                num = -rhs[rsl]
                den = cfg.rnd(lam)
                for d in range(3):
                    c_lo, c_hi = self._fix_coeffs(lvl, easm, d, fix, rsl)
                    lo_v, hi_v = self._fix_nbrs(lvl, canvas, vals, planes,
                                                d, fix)
                    num = num + c_lo * lo_v
                    den = den + c_lo
                    num = num + c_hi * hi_v
                    den = den + c_hi
                new = num / den
            else:
                acc = -rhs[rsl]
                for d in range(3):
                    lo_v, hi_v = self._fix_nbrs(lvl, canvas, vals, planes,
                                                d, fix)
                    acc = acc + cfg.rnd(cfg.idr2[d]) * (lo_v + hi_v)
                new = acc * cfg.inv_den(lam)
            swept[rsl] = torch.where(self._upd(fix, parity), new, swept[rsl])
        return swept

    def _fix_apply(self, lvl, out, canvas, vals, planes, rhs, lam, residual,
                   easm=()):
        """Recompute A(phi) (or rhs - A(phi)) on the conflict rects, in
        place on ``out`` — the expression of dense_kernels._apply_expr."""
        cfg = self._kcfgs[lvl]
        for fix in self.conflicts[lvl]:
            rsl = self._cansl(fix.lo, fix.hi)
            p = canvas[rsl]
            o = (-cfg.rnd(lam)) * p
            for d in range(3):
                lo_v, hi_v = self._fix_nbrs(lvl, canvas, vals, planes, d, fix)
                if cfg.n_eps:
                    c_lo, c_hi = self._fix_coeffs(lvl, easm, d, fix, rsl)
                    o = o + c_lo * (lo_v - p)
                    o = o + c_hi * (hi_v - p)
                else:
                    o = o + cfg.rnd(cfg.idr2[d]) * (lo_v + hi_v - 2.0 * p)
            out[rsl] = rhs[rsl] - o if residual else o
        return out

    def _face_planes(self, canvas, bplanes_raw, bcache, lvl, key="phi"):
        """The six ghost planes the stencil kernels read with identity
        coefficients (1, 0, 0), in their padded layouts.  Uncovered
        positions stay zero (they abut garbage cells only).  key: as in
        :meth:`_ring_values`."""
        X, Y, Z = self.dims[lvl]
        PZ, PY = dk.PZ, dk.PY
        planes = [self._zeros(s) for s in (
            (Z + 2 * PZ, Y + 2 * PY), (Z + 2 * PZ, Y + 2 * PY),
            (Z + 2 * PZ, X), (Z + 2 * PZ, X),
            (Y + 2 * PY, X), (Y + 2 * PY, X))]
        inner = [(slice(PZ, PZ + Z), slice(PY, PY + Y))] * 2 \
            + [(slice(PZ, PZ + Z), slice(None))] * 2 \
            + [(slice(PY, PY + Y), slice(None))] * 2
        bc_phys = self._ring_bc(lvl, key)
        is_eps = key.startswith("eps")
        for i, seg in enumerate(self.segs[lvl]):
            if seg.sink != "face":
                continue
            d = seg.nb // 2
            if seg.kind == "wrap":
                lo, hi = seg.lo.copy(), seg.hi.copy()
                lo[d], hi[d] = seg.src, seg.src + 1
                vals = canvas[self._cansl(lo, hi)].squeeze(2 - d)
            else:
                x1, x2 = self._seg_x12(canvas, seg)
                if seg.kind == "rb":
                    c0, c1, c2 = RB_COEFFS
                    b = bcache[i]
                elif is_eps:
                    c0, c1, c2, b = 0.0, 1.0, 0.0, None
                else:
                    c0, c1, c2 = bc_phys[seg.nb]
                    b = self._seg_bwin(bplanes_raw, seg)
                vals = 1.0 * x1 if b is None else c0 * b + c1 * x1
                if c2 != 0.0:
                    vals = vals + c2 * x2
            tdims = [dd for dd in range(3) if dd != d]
            sl = tuple(slice(int(seg.lo[dd]), int(seg.hi[dd]))
                       for dd in reversed(tdims))
            planes[seg.nb][inner[seg.nb]][sl] = vals
        return planes

    def _assemble(self, state, lvl, key, bcache=None, prefer=None):
        """(canvas_with_fresh_ring, face_planes, ring_vals) for one
        variable.

        All variables synthesize with phi's BC data: the reference saves
        iold = phi INCLUDING ghosts (update_coarse, m_multigrid.f90:
        369-383), so the corr-ring ghosts of iold are phi-BC ghosts of
        the saved field."""
        if bcache is None:
            bcache = self._rb_cache(state, lvl, key)
        canvas = state[key][lvl]
        raw = state["bc"][lvl]
        vals = self._ring_values(canvas, raw, bcache, lvl, key)
        canvas = self._write_ring(canvas, vals, lvl, prefer)
        planes = self._face_planes(canvas, raw, bcache, lvl, key)
        return canvas, planes, vals

    def _eps_assemble(self, state, lvl):
        """Per coefficient field (eps0..): (ringed canvas, face planes,
        ring values) — the ringed canvases feed the plain route's
        coefficient reads, the planes its identity ``eps_bc`` synthesis,
        the ring values the concave-corner fix-ups.  Memoized (see
        :func:`_dep_memo`) on every coefficient canvas of this level and
        the coarser ones and on the raw boundary planes, so a level
        visit builds it once while the coefficients stay unchanged."""
        if not self.n_eps:
            return []
        keys = self._eps_keys
        deps = tuple(v for k in keys for u, v in state[k].items()
                     if self._lvl_of(u) <= self._lvl_of(lvl)) \
            + tuple(pp for ps in state["bc"].values() for pp in ps)
        return _dep_memo(self, "_easm_memo", lvl, deps, lambda: [
            self._assemble(state, lvl, k) for k in keys])

    def _drop_eps_memos(self):
        """Forget the memoized coefficient assemblies and coefficient rb
        strips: after new coefficient values their entries could never
        match again (they are keyed on the old versions) and would only
        hold device memory until evicted."""
        self.__dict__.pop("_easm_memo", None)
        rbc = self.__dict__.get("_rbc_memo", {})
        for k in [k for k in rbc if k[1].startswith("eps")]:
            del rbc[k]

    def _ext(self, state, lvl, key, bcache=None, prefer=None):
        """[Z+2, Y+2, X+2] canvas with ALL ghosts materialized: interior
        + in-canvas ring values + the one-cell outer ring from the face
        planes.  The generalization of _var_with_ring to forests."""
        canvas, planes, _ = self._assemble(state, lvl, key, bcache, prefer)
        X, Y, Z = self.dims[lvl]
        PZ, PY = dk.PZ, dk.PY
        out = self._zeros((Z + 2, Y + 2, X + 2))
        out[1:-1, 1:-1, 1:-1] = canvas[_ISL]
        out[1:-1, 1:-1, 0] = planes[0][PZ:PZ + Z, PY:PY + Y]
        out[1:-1, 1:-1, -1] = planes[1][PZ:PZ + Z, PY:PY + Y]
        out[1:-1, 0, 1:-1] = planes[2][PZ:PZ + Z, :]
        out[1:-1, -1, 1:-1] = planes[3][PZ:PZ + Z, :]
        out[0, 1:-1, 1:-1] = planes[4][PY:PY + Y, :]
        out[-1, 1:-1, 1:-1] = planes[5][PY:PY + Y, :]
        return out

    def _var_with_ring(self, state, lvl, key):
        return self._ext(state, lvl, key)

    def _var_with_ring_axes(self, state, lvl, key):
        """Per-axis ringed exports: the face-d ghosts of an exported
        leaf must carry axis-d values at conflicted concave-corner cells
        (per-box ghost storage semantics).  Conflict-free levels return
        one array thrice."""
        if self.conflicts.get(lvl) is None:
            e = self._ext(state, lvl, key)
            return (e, e, e)
        return tuple(self._ext(state, lvl, key, prefer=a) for a in range(3))

    # ------------------------------------------------------------------
    # fused-canvas path: ghost synthesis inside the stencil kernels
    # ------------------------------------------------------------------
    def _seg_kcfg(self, lvl):
        """Kernel config of the segment-synthesis path: no uniform
        boundary machinery (the wrappers read no BC field of a segment
        launch); idr2 and dtype are what matters."""
        memo = self.__dict__.setdefault("_seg_kcfg_memo", {})
        if lvl not in memo:
            idr2 = tuple(float(x) for x in
                         1.0 / self.tree.dr[self._lvl_of(lvl)] ** 2)
            memo[lvl] = dk.DenseStencilConfig(
                dims=self.dims[lvl], idr2=idr2, bc=[(1.0, 0.0, 0.0)] * 6,
                periodic=(True, True, True), dtype=self.cfg.dtype,
                b_const=[0.0] * 6)
        return memo[lvl]

    def _seg_desc(self, lvl):
        """(descriptors, groups) for the fused-canvas kernels, or None
        outside the gate: ``seg_fused``, constant coefficients, no
        periodic wrap segment (their sources are not next to the reader;
        the JAX package excludes both, so both packages run the same
        path), and at most ``dk.MAX_SEGS`` ghost layers.

        descriptors: a ``dk.SegLayers`` of the sorted (d, c, side) ghost
        layers, with their reader table on the solver's device — d the
        normal dim, c the canvas coordinate of the one-cell-thick layer
        (-1/N for canvas faces), side 0 = ghost below its footprint run
        (seg.nb even).  groups maps each descriptor to the contributing
        segment indices (disjoint transverse rects)."""
        memo = self.__dict__.setdefault("_seg_desc_memo", {})
        if lvl in memo:
            return memo[lvl]
        out = None
        if self.seg_fused and self.n_eps == 0:
            groups: Optional[Dict] = {}
            for i, seg in enumerate(self.segs[lvl]):
                if seg.kind == "wrap":
                    groups = None
                    break
                d = seg.nb // 2
                side = 0 if seg.nb % 2 == 0 else 1
                groups.setdefault((d, int(seg.lo[d]), side), []).append(i)
            if groups is not None and len(groups) <= dk.MAX_SEGS:
                out = (dk.seg_layers(self._seg_kcfg(lvl), sorted(groups),
                                     self.device),
                       {k: tuple(v) for k, v in groups.items()})
        memo[lvl] = out
        return out

    def _seg_planes(self, state, lvl, bcache):
        """[4, T1, T2] coefficient planes per descriptor: A0 = c0*b
        (rb: 0.5 * coarse-interp; phys: c0 * raw boundary values), A1 =
        c1, A2 = c2, M = 1 at covered transverse positions — the same
        products and operand order as _ring_values/_face_planes, so the
        in-kernel synthesis (a0 + a1*x1) + a2*x2 is value-identical."""
        descs, groups = self._seg_desc(lvl)
        cfg = self._seg_kcfg(lvl)
        bc_phys = self._ring_bc(lvl)
        raw = state["bc"][lvl]
        PZ, PY = dk.PZ, dk.PY
        out = []
        for key in descs.segs:
            d = key[0]
            a = self._zeros(dk._seg_plane_shape(cfg, d))
            for i in groups[key]:
                seg = self.segs[lvl][i]
                if seg.kind == "rb":
                    c0, c1, c2 = RB_COEFFS
                    b = bcache[i]
                else:
                    c0, c1, c2 = bc_phys[seg.nb]
                    b = self._seg_bwin(raw, seg)
                if d == 2:
                    sl = (slice(PY + int(seg.lo[1]), PY + int(seg.hi[1])),
                          slice(int(seg.lo[0]), int(seg.hi[0])))
                elif d == 1:
                    sl = (slice(PZ + int(seg.lo[2]), PZ + int(seg.hi[2])),
                          slice(int(seg.lo[0]), int(seg.hi[0])))
                else:
                    sl = (slice(PZ + int(seg.lo[2]), PZ + int(seg.hi[2])),
                          slice(PY + int(seg.lo[1]), PY + int(seg.hi[1])))
                a[(0,) + sl] = c0 * b
                a[(1,) + sl] = c1
                a[(2,) + sl] = c2
                a[(3,) + sl] = 1.0
            out.append(a)
        return out

    def _seg_data(self, state, lvl):
        """Memoized (descs, seg planes) — same deps as _rb_cache (the A0
        channel also carries this level's raw boundary values)."""
        descs, _ = self._seg_desc(lvl)
        planes = _dep_memo(
            self, "_segp_memo", lvl, self._memo_deps(state, lvl, "phi"),
            lambda: self._seg_planes(state, lvl,
                                     self._rb_cache(state, lvl, "phi")))
        return descs, planes

    def _smooth_seg(self, state, lvl, n_cycle, lam):
        """Fused-canvas GSRB: red+black pairs, up to two per pass over
        device memory, with rb/phys ghosts synthesized inside the kernel
        — the mid-pair refresh is exact, since the b parts are constant
        during a level visit and x1/x2 are read as they are updated.
        Within 32 ulp of the sequential path (tests/test_torch_forest.py;
        the orders of the fix-ups and of the plane assembly differ)."""
        cfg = self._seg_kcfg(lvl)
        descs, planes = self._seg_data(state, lvl)
        canvas = state["phi"][lvl]
        rhs = state["rhs"][lvl]
        done = 0
        while done < n_cycle:
            k = min(n_cycle - done, 2)
            canvas = dk.pair_sweep_dense(cfg, canvas, rhs, lam, None,
                                         red_parity=0, n_pairs=k, segs=descs,
                                         seg_planes=planes)
            done += k
        state["phi"][lvl] = canvas
        return state

    # ------------------------------------------------------------------
    # cycle building blocks
    # ------------------------------------------------------------------
    def _smooth(self, state, lvl, n_cycle, lam):
        """n_cycle GSRB iterations: the fused-canvas path where the gate
        admits the level, else half-sweeps with ring and face-plane
        refreshes between them (smooth_boxes, m_multigrid.f90:404-424;
        red parity 0 first, as the dense path)."""
        if self._seg_desc(lvl) is not None:
            return self._smooth_seg(state, lvl, n_cycle, lam)
        cfg = self._kcfgs[lvl]
        bcache = self._rb_cache(state, lvl, "phi")
        raw = state["bc"][lvl]
        canvas = state["phi"][lvl]
        rhs = state["rhs"][lvl]
        plan = self.conflicts.get(lvl)
        easm = self._eps_assemble(state, lvl)
        eps = tuple(a[0] for a in easm)
        epl = [a[1] for a in easm] if easm else None
        for n in range(2 * n_cycle):
            vals = self._ring_values(canvas, raw, bcache, lvl)
            ringed = self._write_ring(canvas, vals, lvl)
            planes = self._face_planes(ringed, raw, bcache, lvl)
            canvas = dk.half_sweep_dense(cfg, ringed, rhs, lam, planes,
                                         parity=n % 2, eps=eps,
                                         eps_planes=epl)
            if plan:
                canvas = self._fix_sweep(lvl, canvas, ringed, vals, planes,
                                         rhs, lam, n % 2, easm)
        state["phi"][lvl] = canvas
        return state

    def _apply_any(self, state, lvl, lam, residual):
        """A(phi) or rhs - A(phi) on a canvas, by the level's path."""
        if self._seg_desc(lvl) is not None:
            descs, planes = self._seg_data(state, lvl)
            return dk.stencil_apply_dense(
                self._seg_kcfg(lvl), state["phi"][lvl], state["rhs"][lvl],
                lam, None, residual=residual, segs=descs, seg_planes=planes)
        canvas, planes, vals = self._assemble(state, lvl, "phi")
        easm = self._eps_assemble(state, lvl)
        out = dk.stencil_apply_dense(
            self._kcfgs[lvl], canvas, state["rhs"][lvl], lam, planes,
            residual=residual, eps=tuple(a[0] for a in easm),
            eps_planes=[a[1] for a in easm] if easm else None)
        if self.conflicts.get(lvl):
            out = self._fix_apply(lvl, out, canvas, vals, planes,
                                  state["rhs"][lvl], lam, residual, easm)
        return out

    def _residual(self, state, lvl, lam):
        state["ires"][lvl] = self._apply_any(state, lvl, lam, True)
        return state

    def _apply_op(self, state, lvl, lam):
        return self._apply_any(state, lvl, lam, False)

    def _max_residual(self, state, lvl, lam):
        """Max |res| over the FOOTPRINT cells only (garbage cells carry
        meaningless residuals)."""
        state = self._residual(state, lvl, lam)
        r = state["ires"][lvl]
        m = self._zero_scalar()
        for lo, hi in self.geom[lvl].rects:
            m = torch.maximum(m, r[self._cansl(lo, hi)].abs().max())
        return state, m

    def _fused_transfer_ok(self, state, lvl):
        return False

    def _image_rects(self, lvl):
        """Fine footprint rectangles mapped into the coarse canvas
        (canvas-local coarse cells)."""
        off_f = self.offsets[lvl]
        off_c = self.offsets[self._coarse_of(lvl)]
        return [((off_f + lo) // 2 - off_c, (off_f + hi) // 2 - off_c)
                for lo, hi in self.geom[lvl].rects]

    def _restrict_into(self, state, lvl, key):
        """Full-weighting restriction of the footprint into its coarse
        image rectangles (restrict_onto on parents,
        m_restrict.f90:165-214), in place on the coarse canvas."""
        avg = dk.restrict_dense(self._kcfgs[lvl], state[key][lvl])[_ISL]
        coarse = state[key][self._coarse_of(lvl)]
        for (lo, hi), (clo, chi) in zip(self.geom[lvl].rects,
                                        self._image_rects(lvl)):
            win = (slice(int(lo[2]) // 2, int(hi[2]) // 2),
                   slice(int(lo[1]) // 2, int(hi[1]) // 2),
                   slice(int(lo[0]) // 2, int(hi[0]) // 2))
            coarse[self._cansl(clo, chi)] = avg[win]
        return state

    def _finish_coarse_rhs(self, state, lvl, lam):
        """rhs_c = A(phi_c) + restrict(res) on the image rectangles only
        (parents, m_multigrid.f90:369-383); iold_c = phi_c."""
        a_phi = self._apply_op(state, lvl - 1, lam)
        rhs_c, ires_c = state["rhs"][lvl - 1], state["ires"][lvl - 1]
        for clo, chi in self._image_rects(lvl):
            sl = self._cansl(clo, chi)
            torch.add(a_phi[sl], ires_c[sl], out=rhs_c[sl])
        return self._save_iold(state, lvl - 1)

    def _correct_children(self, state, lvl_c, lam):
        """phi_fine += prolong(phi_c - iold_c) over the fine canvas's
        coarse image + one ghost ring (correct_children,
        m_multigrid.f90:387-402; ring = ghost(phi) - ghost(iold), both
        from the full ghost machinery)."""
        return self._correct_unit(state, lvl_c, lvl_c + 1, lam)

    def _correct_unit(self, state, lvl_c, lvl, lam):
        """One (coarse unit, fine unit) correction pair."""
        lo = (self.offsets[lvl] // 2) - self.offsets[lvl_c]  # image lo
        ext_dims = np.asarray(self.dims[lvl])[::-1] // 2     # (z, y, x)
        sl = tuple(slice(int(lo[d]), int(lo[d]) + int(ext_dims[2 - d]) + 2)
                   for d in (2, 1, 0))
        if self.conflicts.get(lvl_c) is None:
            ap = self._assemble(state, lvl_c, "phi")[:2]
            ai = self._assemble(state, lvl_c, "iold")[:2]
            sub = (self._ext_window(ap, lvl_c, sl)
                   - self._ext_window(ai, lvl_c, sl))
        else:
            # the prolongation's border-plane reads are per-axis ghost
            # reads of the parent boxes (mg_prolong_sparse uses face
            # neighbors only, m_prolong.f90:159-240); take each border
            # plane from the axis-preferenced window pair
            bc_p = self._rb_cache(state, lvl_c, "phi")
            bc_i = self._rb_cache(state, lvl_c, "iold")
            corr_ax = {a: (self._ext_window(
                self._assemble(state, lvl_c, "phi", bcache=bc_p,
                               prefer=a)[:2], lvl_c, sl)
                - self._ext_window(
                    self._assemble(state, lvl_c, "iold", bcache=bc_i,
                                   prefer=a)[:2], lvl_c, sl))
                for a in range(3)}
            sub = corr_ax[0]
            for axis, a in ((0, 2), (1, 1), (2, 0)):
                s2 = corr_ax[a]
                idx0 = (slice(None),) * axis + (0,)
                idx1 = (slice(None),) * axis + (-1,)
                sub[idx0] = s2[idx0]
                sub[idx1] = s2[idx1]
        self._prolong_add(sub, state["phi"][lvl])
        return state

    # -- subtract mean (fully periodic forests) -------------------------
    def _subtract_mean(self, state, key):
        """Leaf-weighted global mean over levels >= 1, removed from all
        levels in place (subtract_mean, m_multigrid.f90:245-294).  Leaf
        cells at lvl = footprint minus the finer level's image."""
        t = self.tree
        total = self._zero_scalar()
        for lvl in [l for l in self.levels if l >= 1]:
            w = float(np.prod(t.dr[lvl]))
            arr = state[key][lvl]
            s = self._zero_scalar()
            for lo, hi in self.geom[lvl].rects:
                s = s + arr[self._cansl(lo, hi)].sum()
            if lvl + 1 in self.levels:
                for clo, chi in self._image_rects(lvl + 1):
                    s = s - arr[self._cansl(clo, chi)].sum()
            total = total + w * s
        volume = float(np.prod(t.domain_size_lvl[1]) * np.prod(t.dr[1]))
        mean = total / volume
        for lvl in self.levels:
            state[key][lvl] -= mean
        return state

    # ------------------------------------------------------------------
    # direct coarse solve
    # ------------------------------------------------------------------
    def _build_direct(self):
        """Constant coefficients: the probe below, which then reads
        nothing of a state."""
        return self._build_direct_probe({})

    def _build_direct_probe(self, state):
        """The coarsest cycled level is gated to be a full-domain
        uniform canvas; probe its operator column by column through the
        forest apply (one stencil launch per column on the card; with
        coefficients the plain route) so the BC synthesis, periodic
        wraps included, is captured.  Variable-coefficient operators
        probe through ``state``'s coarse-level coefficient fields, on
        which the matrix depends.  A(lam) = A0 - lam*I, so probing at
        lam = 0 suffices; the affine BC part A(0) is probed too and
        subtracted."""
        lvl = self._unit0(self.levels[0])
        ishape = self._ishape(lvl)
        m = int(np.prod(ishape))
        phi = self._zeros(self._pshape(self.dims[lvl]))
        inner = phi[_ISL]
        st = {"phi": {lvl: phi}, "rhs": {lvl: self._zeros(phi.shape)},
              "bc": {lvl: self._eval_bc_planes(lvl)}}
        for k in self._eps_keys:
            st[k] = {lvl: state[k][lvl]}
        cols = self._zeros((m + 1, m))
        for j in range(m + 1):          # row m: A(0), the affine BC part
            cell = np.unravel_index(min(j, m - 1), ishape)
            if j < m:
                inner[cell] = 1.0
            cols[j] = self._apply_op(st, lvl, 0.0)[_ISL].reshape(-1)
            inner[cell] = 0.0
        cols = cols.cpu().numpy().astype(np.float64)
        return self._eigen_package(cols[:m].T - cols[m][:, None])
