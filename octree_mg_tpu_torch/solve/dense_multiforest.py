"""The gate of the multi-canvas dense forest.

The JAX package sends a sparse 3D forest — one whose levels a single
canvas would fill too thinly for the dense forest's gate, as a few
disjoint refined blobs in a large domain do — to its multi-canvas forest
solver (``DenseMultiForestMGSolver``: one dense canvas per connected
component of a level), before the boxed solver.  ``make_solver`` here
routes the same way: this module holds the gate (``_components`` and
``dense_multiforest_supported``, the JAX package's
``solve/dense_multiforest.py:54-107``) so that such trees are recognised
and raise, naming ROADMAP A9, instead of falling to the boxed solver
while that solver is still to be ported.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..core.constants import NO_BOX
from ..core.tree import Tree
from .dense_forest import _forest_balanced, _LevelGeom
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
    """Whether the JAX package's multi-canvas forest path covers this
    configuration: the dense forest's gate without its whole-level fill
    requirement, with a fill of at least ``min_fill`` per component
    bounding box and no fully periodic tree (its mean removal would need
    cross-component plumbing)."""
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
