"""Inter-level transfer of the boxed solver: restriction and prolongation.

The port of the JAX package's ``ops/transfer.py``: full weighting, 2^D-cell
averages (``m_restrict.f90``), and D-linear face-neighbor interpolation,
weights 1D: 3/4,1/4; 2D: 1/2,1/4,1/4; 3D: 1/4 x4 (``m_prolong.f90``).

Because each level's id list is the concatenation of its parents'
children in order (m_build_tree.f90:187-216, kept by the tree builder),
the child <-> parent mapping is a reshape: fine loc = 2^D * p + ichild.
The only gather/scatter is by parent box loc.  ``restrict_to_coarse``
writes the parents' interiors IN PLACE (the JAX function returns a new
plane); the parent locs of a level are distinct, so the row scatter
(``index_copy_``) has no repeated index.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..core import topology as topo


def _block_mean(interior: torch.Tensor, ndim: int) -> torch.Tensor:
    """[n, (nc)^D] -> [n, (nc/2)^D] 2^D-cell average (m_restrict.f90:183-194)."""
    n = interior.shape[0]
    nc = interior.shape[-1]
    h = nc // 2
    shape = [n]
    for _ in range(ndim):
        shape += [h, 2]
    a = interior.reshape(shape)
    return a.mean(dim=tuple(2 + 2 * d for d in range(ndim)))


def _assemble_children(avg: torch.Tensor, ndim: int) -> torch.Tensor:
    """[n_p * 2^D, (h)^D] in child order -> [n_p, (2h)^D] parent blocks.

    Child order: bit d of the child index is the offset along dim d
    (topology.child_dix), dims ordered x fastest."""
    nch = topo.num_children(ndim)
    n_p = avg.shape[0] // nch
    h = avg.shape[-1]
    # [n_p, c_z, c_y, c_x, (z, y, x spatial)]
    a = avg.reshape((n_p,) + (2,) * ndim + (h,) * ndim)
    perm = [0]
    for d in range(ndim):
        perm += [1 + d, 1 + ndim + d]
    return a.permute(perm).reshape((n_p,) + (2 * h,) * ndim)


def _split_children(blocks: torch.Tensor, ndim: int) -> torch.Tensor:
    """Inverse of _assemble_children: [n_p, (2h)^D] -> [n_p*2^D, (h)^D]."""
    n_p = blocks.shape[0]
    h = blocks.shape[-1] // 2
    shape = [n_p]
    for _ in range(ndim):
        shape += [2, h]
    a = blocks.reshape(shape)
    perm = ([0] + [1 + 2 * d for d in range(ndim)]
            + [2 + 2 * d for d in range(ndim)])
    return a.permute(perm).reshape((n_p * (1 << ndim),) + (h,) * ndim)


def restrict_to_coarse(fine_plane: torch.Tensor, coarse_plane: torch.Tensor,
                       dmaps_f: Dict, static_f: Dict) -> torch.Tensor:
    """Restrict one variable plane from a level into lvl-1 parents'
    interiors (mg_restrict_lvl, m_restrict.f90:83-114), writing
    ``coarse_plane`` in place; returns it."""
    ndim = static_f["ndim"]
    nr = static_f.get("n_real", fine_plane.shape[0])
    interior = fine_plane[(slice(0, nr),) + (slice(1, -1),) * ndim]
    avg = _block_mean(interior, ndim)
    vals = _assemble_children(avg, ndim) if static_f["multi_child"] else avg
    c_int = coarse_plane[(slice(None),) + (slice(1, -1),) * ndim]
    if static_f["parents_identity"]:
        c_int.copy_(vals)
    else:
        c_int.index_copy_(0, dmaps_f["parent_locs"], vals)
    return coarse_plane


def _interleave(a: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    """Interleave two arrays along spatial dim d (axis -(d+1))."""
    ax = a.dim() - (d + 1)
    st = torch.stack([a, b], dim=ax + 1)
    shape = list(a.shape)
    shape[ax] *= 2
    return st.reshape(shape)


def _prolong_block(sub: torch.Tensor, ndim: int) -> torch.Tensor:
    """D-linear sparse prolongation of one coarse block strip
    (mg_prolong_sparse, m_prolong.f90:159-240).

    sub: [n, (h+2)^D] coarse values incl. the needed neighbor layer.
    Returns [n, (2h)^D] fine values."""
    w0 = {1: 0.75, 2: 0.5, 3: 0.25}[ndim]
    ctr = sub[(slice(None),) + (slice(1, -1),) * ndim]

    def shifted(d, s):
        sl = [slice(None)]
        for dd in reversed(range(ndim)):
            if dd == d:
                sl.append(slice(1 + s, sub.shape[-1] - 1 + s))
            else:
                sl.append(slice(1, -1))
        return sub[tuple(sl)]

    f0 = w0 * ctr
    lo = [0.25 * shifted(d, -1) for d in range(ndim)]
    hi = [0.25 * shifted(d, +1) for d in range(ndim)]

    # value at fine parity b: f0 + sum_d (lo_d if bit_d==0 else hi_d);
    # interleave one dim at a time
    vals = {0: f0}
    for d in range(ndim):
        new = {}
        for key, a in vals.items():
            new[key] = a + lo[d]
            new[key | (1 << d)] = a + hi[d]
        vals = new

    def build(d_hi: int, bits: int):
        if d_hi < 0:
            return vals[bits]
        a = build(d_hi - 1, bits)
        b = build(d_hi - 1, bits | (1 << d_hi))
        return _interleave(a, b, d_hi)

    return build(ndim - 1, 0)


def prolong_from_coarse(coarse_plane: torch.Tensor, dmaps_f: Dict,
                        static_f: Dict) -> torch.Tensor:
    """Prolong one variable plane from lvl-1 onto a level's interiors.

    Returns fine interior values [n_f, (nc)^D]; the caller adds or sets
    (prolong_onto add flag, m_prolong.f90:149-154)."""
    ndim = static_f["ndim"]
    nc = static_f["nc"]
    h = nc // 2
    if static_f["parents_identity"]:
        P = coarse_plane
    else:
        P = coarse_plane.index_select(0, dmaps_f["parent_locs"])
    if not static_f["multi_child"]:
        # single child: whole parent incl. ghost layer is the strip
        return _prolong_block(P, ndim)
    outs = []
    nch = topo.num_children(ndim)
    for c in range(nch):
        sl = [slice(None)]
        for dd in reversed(range(ndim)):
            off = ((c >> dd) & 1) * h
            sl.append(slice(off, off + h + 2))
        outs.append(_prolong_block(P[tuple(sl)], ndim))
    stacked = torch.stack(outs, dim=1)  # [n_p, nch, (nc)^D]
    return stacked.reshape((stacked.shape[0] * nch,) + (nc,) * ndim)
