"""The 2D dense forest's gate and canvas geometry.

The JAX package's ``DenseForest2DMGSolver`` (its solve/dense_forest2d.py)
runs arbitrary 2:1-balanced quadtree forests on the dense 2D path, one
canvas per refinement level over the bounding box of its leaf footprint.
Its solver waits for ROADMAP A10b.  What is here already is what
``make_solver`` needs to route every 2D configuration as the JAX package
does: the gate ``dense_forest2d_supported`` and the canvas geometry it
measures, ``_LevelGeom2D`` (its ghost-segment plan ``build_segments``
comes with the solver), with the helpers ``_runs_1d`` and
``_greedy_rects_2d``.  The multi-canvas form's gate is
``dense_multiforest.dense_multiforest2d_supported``.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core.tree import Tree
from .dense_forest import _forest_balanced
from .multigrid import MGConfig


def _runs_1d(mask: np.ndarray) -> List[Tuple[int, int]]:
    """Maximal True runs of a 1D boolean mask, half-open."""
    out = []
    i = 0
    n = len(mask)
    while i < n:
        if not mask[i]:
            i += 1
            continue
        j = i
        while j + 1 < n and mask[j + 1]:
            j += 1
        out.append((i, j + 1))
        i = j + 1
    return out


def _greedy_rects_2d(occ: np.ndarray) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Greedy decomposition of a 2D boolean occupancy [BX, BY] into
    rectangles ((x0, y0), (x1, y1)), half-open."""
    m = occ.copy()
    out = []
    while m.any():
        x, y = np.argwhere(m)[0]
        x1 = x
        while x1 + 1 < m.shape[0] and m[x1 + 1, y]:
            x1 += 1
        y1 = y
        while y1 + 1 < m.shape[1] and m[x:x1 + 1, y1 + 1].all():
            y1 += 1
        out.append((np.array([x, y]), np.array([x1 + 1, y1 + 1])))
        m[x:x1 + 1, y:y1 + 1] = False
    return out


class _LevelGeom2D:
    """Canvas geometry of one refinement level (2D), or of the boxes
    ``ids`` of one level (a component of the multi-canvas form)."""

    def __init__(self, tree: Tree, lvl: int, ids=None):
        self.lvl = lvl
        self.nc = nc = tree.box_size_lvl[lvl]
        ids = tree.lvls[lvl].ids if ids is None else np.asarray(ids)
        self.ids = ids
        ix = tree.ix[ids][:, :2] - 1             # [n, 2] 0-based box coords
        self.box_lo = ix.min(axis=0)
        box_hi = ix.max(axis=0) + 1
        self.B = box_hi - self.box_lo            # canvas extent, box units
        self.off = self.box_lo * nc              # cell offset (x, y)
        self.dims = tuple(int(v) for v in self.B * nc)
        self.dom_box = tree.domain_size_lvl[lvl][:2] // nc
        self.dom_cells = np.asarray(tree.domain_size_lvl[lvl][:2])
        occ = np.zeros(tuple(self.B), dtype=bool)
        loc = ix - self.box_lo
        occ[loc[:, 0], loc[:, 1]] = True
        self.occ = occ
        self.full = bool(occ.all() and np.all(self.B == self.dom_box))
        self.rects = [(lo * nc, hi * nc) for lo, hi in _greedy_rects_2d(occ)]
        self.n_cells = int(occ.sum()) * nc ** 2


def _forest2d_ops(cfg: MGConfig) -> bool:
    """The 2D forests' operator and geometry gate: the five cartesian
    operators, or the cylindrical laplacian, with GSRB."""
    ok_op = ((cfg.operator in ("laplacian", "helmholtz", "vlaplacian",
                               "vhelmholtz", "ahelmholtz")
              and cfg.geometry == "cartesian")
             or (cfg.operator == "laplacian"
                 and cfg.geometry == "cylindrical"))
    return ok_op and cfg.smoother in ("gsrb", "gs")


def dense_forest2d_supported(tree: Tree, cfg: MGConfig,
                             min_fill: float = 0.2) -> bool:
    """Whether the JAX package's 2D dense-forest path covers this
    configuration."""
    if not (tree.ndim == 2 and tree.highest_lvl > 1 and _forest2d_ops(cfg)):
        return False
    if not _forest_balanced(tree):
        return False
    for lvl in range(tree.lowest_lvl, tree.highest_lvl + 1):
        if len(tree.lvls[lvl].ids) == 0:
            return False
        g = _LevelGeom2D(tree, lvl)
        if g.n_cells < min_fill * int(np.prod(g.dims)):
            return False
    return True
