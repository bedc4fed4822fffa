"""Physical boundary-condition coefficients and the refinement-boundary
strip interpolation.

Only the part of the ghost-cell machinery that the dense paths need:
the (c0, c1, c2) of ``bc_to_gc`` (m_ghost_cells.f90:665-766), where
ghost = c0*b + c1*x1 + c2*x2 with (Dirichlet: 2,-1,0),
(Neumann: +-dr,1,0), (continuous: 0,2,-1) — the dense kernels synthesize
ghost values inline from these at the cells that read them — and the
coarse-side strip interpolation of refinement-boundary ghosts that the
dense forest uses (``interp_rb_strip``).
"""
from __future__ import annotations

import torch

from ..core import topology as topo
from ..core.constants import BCType


def bc_coeffs(bc_type: BCType, dr_d: float, nb: int):
    """(c0, c1, c2) of ghost = c0*b + c1*x1 + c2*x2 (m_ghost_cells.f90:682-698)."""
    if bc_type == BCType.DIRICHLET:
        return 2.0, -1.0, 0.0
    if bc_type == BCType.NEUMANN:
        return dr_d * topo.neighb_high_pm(nb), 1.0, 0.0
    if bc_type == BCType.CONTINUOUS:
        return 0.0, 2.0, -1.0
    raise ValueError(f"unknown bc type {bc_type}")


def interp_rb_strip(tmp):
    """Coarse strip -> values straight next to fine points, 3D
    (box_gc_for_fine_neighbor, m_ghost_cells.f90:557-576): ``tmp`` is
    [m, t_hi + 2, t_lo + 2] with a one-cell transverse ring; the fast
    transverse axis carries the ``g_lo`` gradient.  Returns
    [m, 2 t_hi, 2 t_lo] in the JAX package's operation order."""
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
