"""Ghost-cell (halo) filling: physical boundary-condition coefficients,
the refinement-boundary strip interpolation and the boxed solver's level
fill.

The port of the JAX package's ``ops/ghost.py``:

* same-level neighbor copy (``copy_from_nb`` m_ghost_cells.f90:330-346
  and the MPI buffer path :348-454) -> one row gather per direction;
* physical BCs (``bc_to_gc`` :665-766): ghost = c0*b + c1*x1 + c2*x2 with
  (Dirichlet: 2,-1,0), (Neumann: +-dr,1,0), (continuous: 0,2,-1) — the
  dense kernels synthesize these inline from ``bc_coeffs``;
* refinement boundaries: coarse-side transverse-gradient interpolation
  (``box_gc_for_fine_neighbor`` :500-577, +-0.125 weights,
  ``interp_rb_strip``, also used by the dense forest) followed by the
  flux-preserving fine-side combination (``sides_rb`` :769-861):
  ghost = 0.5*interp + 0.75*inner1 - 0.25*inner2  (1D: (2*gc+inner)/3).

``fill_ghost_lvl`` writes the ghost faces of one level IN PLACE (the JAX
function returns a new level array).  Faces are independent: filling
never reads a ghost value of the level being filled, so the directions
may be written one after the other.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..core import topology as topo
from ..core.constants import BCType
from ..core.indexmaps import face_slicer


def bc_coeffs(bc_type: BCType, dr_d: float, nb: int):
    """(c0, c1, c2) of ghost = c0*b + c1*x1 + c2*x2 (m_ghost_cells.f90:682-698)."""
    if bc_type == BCType.DIRICHLET:
        return 2.0, -1.0, 0.0
    if bc_type == BCType.NEUMANN:
        return dr_d * topo.neighb_high_pm(nb), 1.0, 0.0
    if bc_type == BCType.CONTINUOUS:
        return 0.0, 2.0, -1.0
    raise ValueError(f"unknown bc type {bc_type}")


def interp_rb_strip(tmp, ndim: int = 3):
    """Coarse strip -> values straight next to fine points
    (box_gc_for_fine_neighbor, m_ghost_cells.f90:557-576).  ``tmp`` is
    [m, 1] in 1D, [m, t + 2] in 2D and [m, t_hi + 2, t_lo + 2] in 3D (a
    one-cell transverse ring; the fast transverse axis carries the
    ``g_lo`` gradient).  Returns [m, 1], [m, 2 t] or [m, 2 t_hi, 2 t_lo]
    in the JAX package's operation order."""
    if ndim == 1:
        return tmp
    if ndim == 2:
        mid = tmp[:, 1:-1]
        g = 0.125 * (tmp[:, 2:] - tmp[:, :-2])
        return torch.stack([mid - g, mid + g], dim=-1).reshape(
            tmp.shape[0], -1)
    mid = tmp[:, 1:-1, 1:-1]
    g_lo = 0.125 * (tmp[:, 1:-1, 2:] - tmp[:, 1:-1, :-2])
    g_hi = 0.125 * (tmp[:, 2:, 1:-1] - tmp[:, :-2, 1:-1])
    m = tmp.shape[0]

    def ilv_last(a, b):  # interleave along the last axis
        return torch.stack([a, b], dim=-1).reshape(*a.shape[:-1],
                                                   2 * a.shape[-1])

    row_lo = ilv_last(mid - g_lo - g_hi, mid + g_lo - g_hi)  # hi even
    row_hi = ilv_last(mid - g_lo + g_hi, mid + g_lo + g_hi)  # hi odd
    return torch.stack([row_lo, row_hi], dim=2).reshape(
        m, 2 * mid.shape[1], 2 * mid.shape[2])


def fill_ghost_lvl(cc_lvl: torch.Tensor, cc_coarse: Optional[torch.Tensor],
                   dmaps: Dict, static: Dict, bc_static: List[Dict],
                   bc_vals: Optional[List[torch.Tensor]], iv: int,
                   ext_gathered=None) -> torch.Tensor:
    """Fill all ghost faces of variable ``iv`` at one level, in place.

    Args:
      cc_lvl: [n_vars, n, (nc+2)^D] level array (written in place).
      cc_coarse: coarse-level array (for refinement boundaries) or None.
      dmaps: device maps {"dirs": [{nb_loc, has_nb, is_phys, rb_loc,
        rb_cidx}...]}.
      static: {"nc": int, "ndim": int, "mp": [..], "mr": [..]} and, per
        direction, "all_nb": whether every box has a same-level neighbor
        there (then the gathered rows are the face as they are).
      bc_static: per direction {"c0","c1","c2","value"} floats for this
        variable.
      bc_vals: per direction full-face [n, face] raw boundary values b
        (zeros away from physical faces), or None for the scalar
        bc_static["value"].
      ext_gathered: the explicit neighbor-face exchange of a box axis
        split across devices (ROADMAP A13); not part of this package:
        anything but None raises.

    Returns ``cc_lvl``.
    """
    if ext_gathered is not None:
        raise NotImplementedError(
            "fill_ghost_lvl: the explicit neighbor-face exchange "
            "(ext_gathered, the ppermute halo) waits for multi-GPU "
            "(ROADMAP A13)")
    D = static["ndim"]
    nc = static["nc"]
    v = cc_lvl[iv]
    mshape = (-1,) + (1,) * (D - 1)

    for nb in range(topo.num_neighbors(D)):
        dm = dmaps["dirs"][nb]
        gh_sl = face_slicer(D, nb, nc, 0)
        in1_sl = face_slicer(D, nb, nc, 1)
        in2_sl = face_slicer(D, nb, nc, 2)
        src_sl = face_slicer(D, topo.neighb_rev(nb), nc, 1)
        ghost = v[gh_sl]

        # same-level neighbors (incl. periodic): gather rows of the source
        # interior face plane
        gathered = v[src_sl].index_select(0, dm["nb_loc"])
        if static["all_nb"][nb]:
            newface = gathered
        else:
            newface = torch.where(dm["has_nb"].reshape(mshape), gathered,
                                  ghost)

        # physical boundaries: dense masked blend
        if static["mp"][nb] > 0:
            bs = bc_static[nb]
            x1 = v[in1_sl]
            x2 = v[in2_sl] if bs["c2"] != 0.0 else 0.0
            if bc_vals is not None:
                const = bs["c0"] * bc_vals[nb]
            else:
                const = bs["c0"] * bs["value"]
            ghost_p = const + bs["c1"] * x1 + bs["c2"] * x2
            newface = torch.where(dm["is_phys"].reshape(mshape), ghost_p,
                                  newface)

        ghost.copy_(newface)

        # refinement boundaries (AMR only): row scatter
        if static["mr"][nb] > 0:
            rb_loc = dm["rb_loc"]
            tmp = cc_coarse[iv].reshape(-1)[dm["rb_cidx"]]
            gc = interp_rb_strip(tmp, D)
            x1 = v[in1_sl].index_select(0, rb_loc)
            if D == 1:
                ghost_rb = (2.0 * gc[:, 0] + x1) / 3.0
            else:
                x2 = v[in2_sl].index_select(0, rb_loc)
                ghost_rb = 0.5 * gc + 0.75 * x1 - 0.25 * x2
            ghost.index_copy_(0, rb_loc, ghost_rb)

    return cc_lvl
