"""The gate of the dense-patch AMR solver, and the refinement-boundary
ghost combination it shares with the dense forest.

The JAX package routes a tree whose every level's boxes tile a
rectangle (each patch strictly inside its coarse patch except where flush
with the domain) to its dense-patch AMR solver, and only other 2:1
octrees to the dense forest.  ``make_solver`` here routes the same way:
this module holds the gate so that such trees are recognised and raise,
naming ROADMAP A8, while the solver itself (``DenseAMRMGSolver``) is
still to be ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..core.tree import Tree
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
    """Whether the JAX package's dense-patch AMR path covers this
    configuration (3D cartesian GSRB, non-periodic, rectangular patches
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
