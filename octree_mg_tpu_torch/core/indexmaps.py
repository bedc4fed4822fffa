"""Index maps derived from the tree, for the boxed solver.

This module replaces the reference's communication bookkeeping — the
dry-run buffer sizing (``m_ghost_cells.f90:17-62``,
``m_restrict.f90:16-69``, ``m_prolong.f90:16-48``) and the per-rank
send/recv buffers with their deterministic ordering
(``m_communication.f90:37-88``) — with static index maps computed once
per tree on the host.  The halo exchange of a level then becomes a few
batched row gathers (solve/multigrid.MGSolver).  This package's own copy
of the JAX package's ``core/indexmaps.py`` (numpy only), field for field.

Data layout per level: ``cc[n_vars, n_boxes, (nc+2), ... , (nc+2)]`` with
x fastest (identical memory order to Fortran ``cc(0:nc+1, ..., n_vars)``),
so 1-based Fortran cell indices equal the Python indices directly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import topology as topo
from .constants import NO_BOX, PHYS_BOUNDARY
from .tree import Tree, box_r_min


# ---------------------------------------------------------------------------
# slicing helpers
# ---------------------------------------------------------------------------

def interior_slices(ndim: int) -> Tuple[slice, ...]:
    return (slice(1, -1),) * ndim


def face_index(nb: int, nc: int, depth: int) -> int:
    """Index along the face-normal axis.

    depth=0 is the ghost layer, depth=1 the first interior cell, depth=2
    the second (used by continuous BCs and ``sides_rb``).
    """
    return depth if topo.neighb_low(nb) else nc + 1 - depth


def face_slicer(ndim: int, nb: int, nc: int, depth: int) -> Tuple:
    """Slice tuple selecting one face plane (transverse extent 1..nc,
    i.e. no corner ghosts — the reference never uses them, README.md:30-35).
    Result shape after slicing [n, ...]: [n] + [nc]*(ndim-1)."""
    d = topo.neighb_dim(nb)
    out: List = [slice(None)]  # box axis
    for dd in reversed(range(ndim)):  # slow -> fast spatial axes
        if dd == d:
            out.append(face_index(nb, nc, depth))
        else:
            out.append(slice(1, nc + 1))
    return tuple(out)


# ---------------------------------------------------------------------------
# per-level map containers (plain nested dicts of numpy arrays; converted
# to device arrays once by the solver)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GhostDirMaps:
    """Ghost-fill maps for one (level, direction)."""

    nb_loc: np.ndarray        # int32[n]  same-level neighbor loc (0 where absent)
    has_nb: np.ndarray        # bool[n]
    phys_loc: np.ndarray      # int32[mp] boxes with a physical face here
    rb_loc: np.ndarray        # int32[mr] fine boxes with refinement boundary here
    rb_cidx: Optional[np.ndarray]  # int32[mr, (hnc+2)^(D-1)] flat into coarse plane


@dataclasses.dataclass
class LevelMaps:
    lvl: int
    nc: int
    n_boxes: int          # padded count (= n_real unless pad_to > 1)
    n_real: int
    dirs: List[GhostDirMaps]
    # inter-level transfer (to/from lvl-1); None at lowest level
    parent_locs: Optional[np.ndarray]   # int32[n_parents(lvl-1)]
    multi_child: bool                   # 2^D children vs single child
    # leaf bookkeeping
    leaf_locs: np.ndarray               # int32[n_leaves]
    # physical-face coordinates for BC evaluation: per dir, [mp, nc^(D-1), D]
    phys_face_coords: List[np.ndarray]


def _face_coords(tree: Tree, box_id: int, nb: int, nc: int) -> np.ndarray:
    """Cell-center coordinates on a box face (m_data_structures.f90:495-539).

    Returns [nc]*(ndim-1) + [ndim] array ordered slow->fast transverse dims
    to match face plane slicing.
    """
    D = tree.ndim
    d = topo.neighb_dim(nb)
    lvl = int(tree.lvl[box_id])
    dr = tree.dr[lvl]
    rmin = box_r_min(tree, box_id)
    if not topo.neighb_low(nb):
        rmin = rmin.copy()
        rmin[d] = rmin[d] + dr[d] * nc
    tdims = [dd for dd in range(D) if dd != d]  # increasing dim number
    if D == 1:
        return rmin.reshape(1)
    # transverse axes ordered slow->fast = reversed(tdims)
    shape = [nc] * (D - 1)
    out = np.empty(shape + [D])
    out[...] = rmin
    for ax, dd in enumerate(reversed(tdims)):
        idx = np.arange(1, nc + 1) - 0.5
        bshape = [1] * (D - 1)
        bshape[ax] = nc
        out[..., dd] = rmin[dd] + idx.reshape(bshape) * dr[dd]
    return out


def build_level_maps(tree: Tree, lvl: int, pad_to: int = 1) -> LevelMaps:
    """pad_to > 1 pads the box axis to a multiple of pad_to with inert
    boxes (no neighbors, no faces), as a box axis split evenly across
    devices needs (the alternative to the reference's uneven rank chunks,
    m_load_balance.f90:38-56).  Pad boxes hold zeros and stay zero
    through every operation."""
    D = tree.ndim
    nc = tree.box_size_lvl[lvl]
    ids = tree.lvls[lvl].ids
    n = len(ids)
    n_pad = -(-n // pad_to) * pad_to
    loc_of: Dict[int, int] = {int(b): i for i, b in enumerate(ids)}

    coarse_exists = lvl - 1 >= tree.lowest_lvl
    if coarse_exists:
        nc_c = tree.box_size_lvl[lvl - 1]
        ids_c = tree.lvls[lvl - 1].ids
        loc_of_c = {int(b): i for i, b in enumerate(ids_c)}
        cshape = (nc_c + 2,) * D

    dirs: List[GhostDirMaps] = []
    phys_face_coords: List[np.ndarray] = []
    for nb in range(topo.num_neighbors(D)):
        nb_ids = tree.neighbors[ids, nb]
        has_nb = np.zeros(n_pad, dtype=bool)
        has_nb[:n] = nb_ids > NO_BOX
        nb_loc = np.zeros(n_pad, dtype=np.int32)
        nb_loc[np.nonzero(has_nb)[0]] = [loc_of[int(b)]
                                         for b in nb_ids[has_nb[:n]]]
        phys_mask = nb_ids == PHYS_BOUNDARY
        phys_loc = np.nonzero(phys_mask)[0].astype(np.int32)
        rb_mask = nb_ids == NO_BOX
        rb_loc = np.nonzero(rb_mask)[0].astype(np.int32)
        del rb_mask

        rb_cidx = None
        if len(rb_loc) > 0:
            assert coarse_exists, "refinement boundary below lowest level"
            hnc = nc // 2
            d = topo.neighb_dim(nb)
            # coarse neighbor of the parent supplies the strip
            # (m_ghost_cells.f90:287-328, 500-577)
            rows = []
            for floc in rb_loc:
                fid = int(ids[floc])
                p_id = int(tree.parent[fid])
                p_nb = int(tree.neighbors[p_id, nb])
                assert p_nb > NO_BOX, "rb face without coarse neighbor"
                cloc = loc_of_c[p_nb]
                di = tree.get_child_offset(fid)  # 0 or hnc per dim
                # normal index: fine low face -> coarse interior at nc_c;
                # fine high face -> coarse interior at 1
                # (box_gc_for_fine_neighbor called with reversed nb)
                norm_idx = nc_c if topo.neighb_low(nb) else 1
                tdims = [dd for dd in range(D) if dd != d]
                # index grids, slow->fast = reversed(tdims)
                grids = np.meshgrid(
                    *[np.arange(di[dd], di[dd] + hnc + 2)
                      for dd in reversed(tdims)],
                    indexing="ij") if D > 1 else []
                idx_per_axis: List[np.ndarray] = []
                gi = 0
                tshape = (hnc + 2,) * (D - 1) if D > 1 else (1,)
                for dd in reversed(range(D)):  # slow->fast spatial axes
                    if dd == d:
                        idx_per_axis.append(np.full(tshape, norm_idx, np.int64))
                    else:
                        idx_per_axis.append(grids[gi])
                        gi += 1
                flat = np.ravel_multi_index(
                    tuple(idx_per_axis), cshape) + cloc * int(np.prod(cshape))
                rows.append(flat.astype(np.int32))
            rb_cidx = np.stack(rows, axis=0)

        dirs.append(GhostDirMaps(nb_loc=nb_loc, has_nb=has_nb,
                                 phys_loc=phys_loc, rb_loc=rb_loc,
                                 rb_cidx=rb_cidx))
        if len(phys_loc) > 0:
            coords = np.stack(
                [_face_coords(tree, int(ids[l]), nb, nc) for l in phys_loc])
        else:
            fshape = (nc,) * (D - 1) if D > 1 else (1,)
            coords = np.zeros((0, *fshape, D) if D > 1 else (0, D))
        phys_face_coords.append(coords)

    # inter-level transfer maps
    parent_locs = None
    multi_child = True
    if coarse_exists:
        parents_c = tree.lvls[lvl - 1].parents
        loc_of_cm = loc_of_c
        parent_locs = np.array([loc_of_cm[int(p)] for p in parents_c],
                               dtype=np.int32)
        multi_child = tree.box_size_lvl[lvl] == tree.box_size_lvl[lvl - 1]
        # invariant from set_next_level_ids: fine level ids are children of
        # parents in order
        if multi_child:
            assert len(ids) == len(parents_c) * topo.num_children(D)
        else:
            assert len(ids) == len(parents_c)

    leaf_locs = np.array([loc_of[int(b)] for b in tree.lvls[lvl].leaves],
                         dtype=np.int32)

    return LevelMaps(lvl=lvl, nc=nc, n_boxes=n_pad, n_real=n, dirs=dirs,
                     parent_locs=parent_locs, multi_child=multi_child,
                     leaf_locs=leaf_locs, phys_face_coords=phys_face_coords)


def build_all_maps(tree: Tree, pad_to: int = 1) -> Dict[int, LevelMaps]:
    return {lvl: build_level_maps(tree, lvl, pad_to)
            for lvl in range(tree.lowest_lvl, tree.highest_lvl + 1)}


def checkerboard_parity(ndim: int, nc: int) -> np.ndarray:
    """(i+j+k) mod 2 over interior cells with 1-based indices, shaped
    [(nc,)*ndim].  The reference smoother updates cells where
    (i + sum(transverse) + redblack_cntr) is even
    (``i0 = 2 - iand(ieor(cntr, j+k), 1)``, m_laplacian.f90:79-102)."""
    idx = [np.arange(1, nc + 1)] * ndim
    grids = np.meshgrid(*idx, indexing="ij")
    s = sum(grids)
    return (s % 2).astype(np.int8)  # axes ordered slow->fast; symmetric anyway
