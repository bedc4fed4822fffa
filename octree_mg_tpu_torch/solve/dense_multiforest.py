"""Multi-canvas dense-forest multigrid: sparse 3D forests on the dense path.

The single-canvas forest (solve/dense_forest.py) stores each refinement
level as one dense canvas over the bounding box of its leaf footprint and
gates on a footprint fill of at least ``min_fill``.  A scattered-patch
refinement — a few disjoint blobs in a large domain — fills a few
percent of its bounding box and would fall to the boxed solver.  This
solver (the port of the JAX package's ``solve/dense_multiforest.py``)
gives each level one canvas per CONNECTED COMPONENT of its boxes (face
adjacency through the tree's neighbour table, periodic wraps included):

* every component is a "unit" with its own canvas, ghost-segment plan
  and concave-corner fix-ups: the single-canvas machinery, reused as it
  is through dicts keyed by ``(lvl, c)`` unit tuples (``units_of``);
* disjoint components share no same-level ghost, so every missing
  neighbour is a refinement-boundary or physical face, as before;
* ``_coarse_of`` maps a fine unit to the coarse unit that holds its
  image (unique: the parents of a connected box set are connected), and
  ``_unit0`` points the direct coarse solve at the coarsest cycled
  level's single canvas;
* the per-level phases loop over the parent's per-unit phases; the
  level's max residual is a ``torch.maximum`` over its units, on the
  device.

Gate (``dense_multiforest_supported``): the dense forest's, without its
whole-level fill requirement, with a fill of at least ``min_fill`` per
COMPONENT bounding box and no fully periodic tree (its mean removal would
need cross-component plumbing; ``_subtract_mean`` raises, as in the JAX
package).  Forest transfers never fuse.  Not here: the GSPMD placement
``shard_state`` (ROADMAP A13b) and the 2D solver (ROADMAP A10b), whose
gate ``dense_multiforest2d_supported`` is here already so that
``make_solver`` routes as the JAX package does.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core.constants import NO_BOX
from ..core.tree import Tree
from .dense import _FIELD_KEYS
from .dense_forest import (DenseForestMGSolver, _build_conflict_plan,
                           _forest_balanced, _LevelGeom)
from .multigrid import MGConfig


def _components(tree: Tree, lvl: int) -> List[np.ndarray]:
    """Connected components of a level's boxes under face adjacency
    (tree.neighbors, periodic wraps included), each as a sorted id
    array."""
    ids = [int(b) for b in tree.lvls[lvl].ids]
    idset = set(ids)
    seen = set()
    out = []
    for b in ids:
        if b in seen:
            continue
        comp = []
        stack = [b]
        seen.add(b)
        while stack:
            cur = stack.pop()
            comp.append(cur)
            for nb in range(2 * tree.ndim):
                q = int(tree.neighbors[cur, nb])
                if q > NO_BOX and q in idset and q not in seen:
                    seen.add(q)
                    stack.append(q)
        out.append(np.array(sorted(comp), np.int64))
    out.sort(key=lambda c: int(c[0]))
    return out


def dense_multiforest_supported(tree: Tree, cfg: MGConfig,
                                min_fill: float = 0.01) -> bool:
    """Whether the multi-canvas forest path covers this configuration:
    the dense forest's gate without its whole-level fill requirement,
    with a fill of at least ``min_fill`` per component bounding box and
    no fully periodic tree (its mean removal would need cross-component
    plumbing)."""
    if not (tree.ndim == 3
            and tree.highest_lvl > 1
            and cfg.operator in ("laplacian", "helmholtz", "vlaplacian",
                                 "vhelmholtz", "ahelmholtz")
            and cfg.geometry == "cartesian"
            and cfg.smoother in ("gsrb", "gs")):
        return False
    if tree.subtract_mean:
        return False
    if not _forest_balanced(tree):
        return False
    for lvl in range(tree.lowest_lvl, tree.highest_lvl + 1):
        if len(tree.lvls[lvl].ids) == 0:
            return False
        for ids in _components(tree, lvl):
            g = _LevelGeom(tree, lvl, ids)
            if g.n_cells < min_fill * int(np.prod(g.dims)):
                return False
    return True


def dense_multiforest2d_supported(tree: Tree, cfg: MGConfig,
                                  min_fill: float = 0.01) -> bool:
    """2D form of :func:`dense_multiforest_supported` (sparse quadtree
    forests; the same component, fill and wrap rules with the 2D forest's
    operator and geometry gate, the cylindrical laplacian included).  Its
    solver waits for ROADMAP A10b."""
    from .dense_forest2d import _forest2d_ops, _LevelGeom2D
    if not (tree.ndim == 2 and tree.highest_lvl > 1 and _forest2d_ops(cfg)):
        return False
    if tree.subtract_mean:
        return False
    if not _forest_balanced(tree):
        return False
    for lvl in range(tree.lowest_lvl, tree.highest_lvl + 1):
        if len(tree.lvls[lvl].ids) == 0:
            return False
        for ids in _components(tree, lvl):
            g = _LevelGeom2D(tree, lvl, ids)
            if g.n_cells < min_fill * int(np.prod(g.dims)):
                return False
    return True


class _MultiUnitMixin:
    """Per-component canvas machinery of the multi-canvas forest.

    State keys are ``(lvl, c)`` component tuples; ``units_of(lvl)``
    lists a level's.  The per-unit machinery (ghost segments, smoother,
    transfers, exports) is the single-canvas parent's, reached through
    the unit-keyed dicts and the ``_coarse_of`` component map.  A
    subclass sets ``_GEOM`` (the canvas-geometry class taking an ids
    subset) and implements ``_build_unit_plans`` (ghost segments and
    conflict plans in the parent's representation)."""

    _GEOM = None

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def _build_levels(self):
        t = self.tree
        all_lvls = list(range(t.lowest_lvl, t.highest_lvl + 1))
        comps = {lvl: _components(t, lvl) for lvl in all_lvls}
        self.units: Dict[int, List] = {}
        self.geom = {}
        for lvl in all_lvls:
            us = []
            for c, ids in enumerate(comps[lvl]):
                u = (lvl, c)
                self.geom[u] = self._GEOM(t, lvl, ids)
                us.append(u)
            self.units[lvl] = us
        self.dims = {u: self.geom[u].dims for us in self.units.values()
                     for u in us}
        self.offsets = {u: self.geom[u].off for us in self.units.values()
                        for u in us}
        #: fine unit -> coarse unit (the component holding its image)
        self._coarse_unit: Dict = {}
        comp_of = {lvl: {} for lvl in all_lvls}
        for lvl in all_lvls:
            for u in self.units[lvl]:
                for b in self.geom[u].ids:
                    comp_of[lvl][int(b)] = u
        for lvl in all_lvls[1:]:
            for u in self.units[lvl]:
                parents = {comp_of[lvl - 1][int(t.parent[int(b)])]
                           for b in self.geom[u].ids}
                assert len(parents) == 1, (
                    "fine component spans coarse components", u, parents)
                self._coarse_unit[u] = parents.pop()
        if self.coarse_solver == "direct":
            direct = None
            for lvl in all_lvls:
                u = self.units[lvl][0]
                if (len(self.units[lvl]) == 1 and self.geom[u].full
                        and int(np.prod(self.dims[u]))
                        <= self.DIRECT_MAX_CELLS):
                    direct = lvl
            if direct is None:
                direct = all_lvls[0]
            self.levels = [l for l in all_lvls if l >= direct]
        else:
            self.levels = all_lvls
        per = tuple(bool(p) for p in t.periodic)
        self._build_unit_plans(per)

    def units_of(self, lvl: int) -> List:
        """State keys of a level's component canvases."""
        return self.units[lvl]

    def _fused_transfer_ok(self, state, lvl) -> bool:
        return False

    @property
    def _kcfgs(self):
        if self._kcfg_cache is None:
            self._kcfg_cache = {u: self._kcfg(u) for lvl in self.levels
                                for u in self.units[lvl]}
        return self._kcfg_cache

    def _coarse_of(self, u):
        if u in self._coarse_unit:
            return self._coarse_unit[u]
        lvl = self._lvl_of(u)
        assert len(self.units[lvl - 1]) == 1, (u, "no coarse mapping")
        return self.units[lvl - 1][0]

    def _unit0(self, lvl):
        return self.units[lvl][0]

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def allocate(self) -> Dict:
        dt, dev = self.cfg.dtype, self.device
        state: Dict = {k: {} for k in self._field_keys}
        state["bc"] = {}
        for lvl in self.levels:
            for u in self.units[lvl]:
                shape = self._pshape(self.dims[u])
                for k in _FIELD_KEYS:
                    state[k][u] = torch.zeros(shape, dtype=dt, device=dev)
                for k in self._eps_keys:
                    state[k][u] = torch.ones(shape, dtype=dt, device=dev)
                state["bc"][u] = self._eval_bc_planes(u)
        return state

    # ------------------------------------------------------------------
    # per-level phases = loops over the parent's per-unit phases; a tuple
    # argument is already a unit (the parent's methods cross-call through
    # self, e.g. _max_residual -> _residual)
    # ------------------------------------------------------------------
    def _zero_phi(self, state, lvl):
        if isinstance(lvl, tuple):
            return super()._zero_phi(state, lvl)
        for u in self.units[lvl]:
            state = super()._zero_phi(state, u)
        return state

    def _save_iold(self, state, lvl):
        if isinstance(lvl, tuple):
            return super()._save_iold(state, lvl)
        for u in self.units[lvl]:
            state = super()._save_iold(state, u)
        return state

    def _smooth(self, state, lvl, n_cycle, lam):
        if isinstance(lvl, tuple):
            return super()._smooth(state, lvl, n_cycle, lam)
        for u in self.units[lvl]:
            state = super()._smooth(state, u, n_cycle, lam)
        return state

    def _residual(self, state, lvl, lam):
        if isinstance(lvl, tuple):
            return super()._residual(state, lvl, lam)
        for u in self.units[lvl]:
            state = super()._residual(state, u, lam)
        return state

    def _max_residual(self, state, lvl, lam):
        """Max |res| over the footprints of the level's units, a 0-dim
        tensor on the device (no host read per unit)."""
        if isinstance(lvl, tuple):
            return super()._max_residual(state, lvl, lam)
        m = self._zero_scalar()
        for u in self.units[lvl]:
            state, r = super()._max_residual(state, u, lam)
            m = torch.maximum(m, r)
        return state, m

    def _restrict_into(self, state, lvl, key):
        if isinstance(lvl, tuple):
            return super()._restrict_into(state, lvl, key)
        for u in self.units[lvl]:
            state = super()._restrict_into(state, u, key)
        return state

    def _finish_coarse_rhs(self, state, lvl, lam):
        """rhs_c = A(phi_c) + restrict(res) on the union of the fine
        units' image rectangles in each coarse unit; iold_c = phi_c
        (parents, m_multigrid.f90:369-383)."""
        by_coarse: Dict = {}
        for u in self.units[lvl]:
            by_coarse.setdefault(self._coarse_of(u), []).append(u)
        for uc, fines in by_coarse.items():
            a_phi = self._apply_op(state, uc, lam)
            rhs_c, ires_c = state["rhs"][uc], state["ires"][uc]
            for u in fines:
                for clo, chi in self._image_rects(u):
                    sl = self._cansl(clo, chi)
                    torch.add(a_phi[sl], ires_c[sl], out=rhs_c[sl])
            state = self._save_iold(state, uc)
        return state

    def _correct_children(self, state, lvl_c, lam):
        for u in self.units[lvl_c + 1]:
            state = self._correct_unit(state, self._coarse_of(u), u, lam)
        return state

    def _subtract_mean(self, state, key):
        raise NotImplementedError(
            "fully-periodic trees are outside the multi-canvas gate")

    @torch.no_grad()
    def apply_operator(self, state, lam=0.0, out_key: str = "ires"):
        lam = self._lam(lam)
        for lvl in self.levels:
            for u in self.units[lvl]:
                state[out_key][u] = self._apply_op(state, u, lam)
        return state

    def shard_state(self, state, mesh, min_local: int = 8):
        """The JAX package's GSPMD placement of the unit canvases on a
        device mesh; multi-device placement is ROADMAP A13b."""
        raise NotImplementedError(
            "DenseMultiForestMGSolver.shard_state: multi-device placement "
            "is still to be ported (ROADMAP A13b)")


class DenseMultiForestMGSolver(_MultiUnitMixin, DenseForestMGSolver):
    """3D FAS multigrid on per-component dense canvases (see
    :class:`_MultiUnitMixin`)."""

    _supported = staticmethod(dense_multiforest_supported)
    _GEOM = _LevelGeom

    def _build_unit_plans(self, per):
        self.segs = {u: self.geom[u].build_segments(per)
                     for lvl in self.levels for u in self.units[lvl]}
        self.conflicts = {
            u: _build_conflict_plan(self.segs[u], self.dims[u])
            for lvl in self.levels for u in self.units[lvl]}
