"""Per-level stencil operations of the boxed solver (operator apply and
smoother half-sweeps) as PyTorch operations on ``[n, (nc+2)^D]`` planes.

The port of the JAX package's ``ops/kernels.py``: one vectorized pass
over a whole level's boxes instead of the Fortran loop over boxes
(``m_multigrid.f90:414-417``).  The red-black Gauss-Seidel half-sweep is
a masked update: cells of one color read only opposite-color neighbors,
so the masked form equals the reference's in-place sweep
(``m_laplacian.f90:52-114``).  Each function keeps the JAX function's
operation order; Python-float scalars are rounded to the plane's dtype
at the multiply, as JAX's weakly typed scalars are.

The smoothers write the new interior into ``phi`` IN PLACE and return it
(the JAX functions return a new plane): every value they read is read
before the write.  The measured-negative ``gathered_shifts`` /
``helmholtz_smooth_half_gathered`` of the JAX package are not ported.

Operators (reference file per class):
  * Laplacian (+ 2D cylindrical)     m_laplacian.f90
  * Helmholtz                        m_helmholtz.f90
  * variable-coeff Laplacian         m_vlaplacian.f90
  * variable-coeff Helmholtz         m_vhelmholtz.f90
  * anisotropic Helmholtz            m_ahelmholtz.f90
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.constants import IPHI, IRHS, IVEPS


def _iv(a: torch.Tensor, ndim: int, nc: int, d: Optional[int] = None,
        s: int = 0) -> torch.Tensor:
    """Interior view of a [n, (nc+2)^D] plane, optionally shifted by s
    along dimension d."""
    sl = [slice(None)]
    for dd in reversed(range(ndim)):
        off = s if dd == d else 0
        sl.append(slice(1 + off, nc + 1 + off))
    return a[tuple(sl)]


def _set_interior(a: torch.Tensor, ndim: int, vals) -> torch.Tensor:
    """Write ``vals`` into the interior of ``a`` in place; returns ``a``."""
    a[(slice(None),) + (slice(1, -1),) * ndim] = vals
    return a


# ---------------------------------------------------------------------------
# constant-coefficient family: Laplacian / Helmholtz
# (m_laplacian.f90:155-195, m_helmholtz.f90:111-154)
# ---------------------------------------------------------------------------

def helmholtz_apply(phi: torch.Tensor, ndim: int, nc: int,
                    idr2: Sequence[float], lam) -> torch.Tensor:
    """A(phi) = laplacian(phi) - lam*phi on the interior."""
    c = _iv(phi, ndim, nc)
    out = -lam * c
    for d in range(ndim):
        out = out + idr2[d] * (_iv(phi, ndim, nc, d, -1)
                               + _iv(phi, ndim, nc, d, +1) - 2.0 * c)
    return out


def helmholtz_smooth_half(phi: torch.Tensor, rhs: torch.Tensor, ndim: int,
                          nc: int, idr2: Sequence[float], lam,
                          upd_mask: torch.Tensor,
                          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One red-black half-sweep (m_laplacian.f90:52-114 / m_helmholtz.f90:48-108).

    fac = 1 / (2*sum(idr2) + lam); phi_new = (sum idr2*(nbrs) - rhs) * fac.
    With ``dtype`` (the helmholtz operator's lam, a traced array in the
    working dtype in the JAX package) ``s + lam`` and the reciprocal round
    in that dtype; without it (the laplacian's Python 0.0) fac is
    evaluated in double and rounded once at the multiply."""
    acc = -_iv(rhs, ndim, nc)
    s = 0.0
    for d in range(ndim):
        acc = acc + idr2[d] * (_iv(phi, ndim, nc, d, -1)
                               + _iv(phi, ndim, nc, d, +1))
        s = s + 2.0 * idr2[d]
    if dtype is None:
        fac = 1.0 / (s + lam)
    else:
        t = np.float32 if dtype == torch.float32 else np.float64
        fac = float(t(1.0) / (t(s) + t(lam)))
    new = acc * fac
    cur = _iv(phi, ndim, nc)
    return _set_interior(phi, ndim, torch.where(upd_mask, new, cur))


def jacobi_sweep(phi: torch.Tensor, rhs: torch.Tensor, ndim: int, nc: int,
                 idr2: Sequence[float], lam, w: float = 2.0 / 3.0
                 ) -> torch.Tensor:
    """Damped Jacobi (the reference's commented kernel, m_laplacian.f90:116-152,
    generalized to Helmholtz)."""
    acc = -_iv(rhs, ndim, nc)
    s = 0.0
    for d in range(ndim):
        acc = acc + idr2[d] * (_iv(phi, ndim, nc, d, -1)
                               + _iv(phi, ndim, nc, d, +1))
        s = s + 2.0 * idr2[d]
    new = acc / (s + lam)
    cur = _iv(phi, ndim, nc)
    return _set_interior(phi, ndim, (1 - w) * cur + w * new)


# ---------------------------------------------------------------------------
# variable-coefficient family: vlaplacian / vhelmholtz
# (m_vlaplacian.f90:51-189, m_vhelmholtz.f90)
# ---------------------------------------------------------------------------

def _harmonic_face(e0: torch.Tensor, enb: torch.Tensor,
                   idr2_d: float) -> torch.Tensor:
    """Face coefficient c = 2*eps0*eps_nb/(eps0+eps_nb) * idr2
    (m_vlaplacian.f90:100)."""
    return 2.0 * e0 * enb / (e0 + enb) * idr2_d


def vhelmholtz_apply(phi: torch.Tensor, eps: torch.Tensor, ndim: int,
                     nc: int, idr2: Sequence[float], lam) -> torch.Tensor:
    u0 = _iv(phi, ndim, nc)
    e0 = _iv(eps, ndim, nc)
    out = -lam * u0
    for d in range(ndim):
        for s in (-1, +1):
            c = _harmonic_face(e0, _iv(eps, ndim, nc, d, s), idr2[d])
            out = out + c * (_iv(phi, ndim, nc, d, s) - u0)
    return out


def vhelmholtz_smooth_half(phi: torch.Tensor, rhs: torch.Tensor,
                           eps: torch.Tensor, ndim: int, nc: int,
                           idr2: Sequence[float], lam,
                           upd_mask: torch.Tensor) -> torch.Tensor:
    u0 = _iv(phi, ndim, nc)
    e0 = _iv(eps, ndim, nc)
    num = -_iv(rhs, ndim, nc)
    den = lam
    for d in range(ndim):
        for s in (-1, +1):
            c = _harmonic_face(e0, _iv(eps, ndim, nc, d, s), idr2[d])
            num = num + c * _iv(phi, ndim, nc, d, s)
            den = den + c
    return _set_interior(phi, ndim, torch.where(upd_mask, num / den, u0))


# ---------------------------------------------------------------------------
# anisotropic family: ahelmholtz (m_ahelmholtz.f90).
# Note: the reference smoother has an indexing slip (`a0(4:5)` where
# `a0(5:6)` is meant, m_ahelmholtz.f90:145); the mathematically intended
# per-direction coefficient is implemented here, as in the JAX package.
# ---------------------------------------------------------------------------

def ahelmholtz_apply(phi: torch.Tensor, eps_dirs: Sequence[torch.Tensor],
                     ndim: int, nc: int, idr2: Sequence[float],
                     lam) -> torch.Tensor:
    u0 = _iv(phi, ndim, nc)
    out = -lam * u0
    for d in range(ndim):
        e0 = _iv(eps_dirs[d], ndim, nc)
        for s in (-1, +1):
            c = _harmonic_face(e0, _iv(eps_dirs[d], ndim, nc, d, s), idr2[d])
            out = out + c * (_iv(phi, ndim, nc, d, s) - u0)
    return out


def ahelmholtz_smooth_half(phi: torch.Tensor, rhs: torch.Tensor,
                           eps_dirs: Sequence[torch.Tensor], ndim: int,
                           nc: int, idr2: Sequence[float], lam,
                           upd_mask: torch.Tensor) -> torch.Tensor:
    u0 = _iv(phi, ndim, nc)
    num = -_iv(rhs, ndim, nc)
    den = lam
    for d in range(ndim):
        e0 = _iv(eps_dirs[d], ndim, nc)
        for s in (-1, +1):
            c = _harmonic_face(e0, _iv(eps_dirs[d], ndim, nc, d, s), idr2[d])
            num = num + c * _iv(phi, ndim, nc, d, s)
            den = den + c
    return _set_interior(phi, ndim, torch.where(upd_mask, num / den, u0))


# ---------------------------------------------------------------------------
# 2D cylindrical (r,z) Laplacian (m_laplacian.f90:197-271)
# ---------------------------------------------------------------------------

def cyl_laplacian_apply(phi: torch.Tensor, nc: int, idr2: Sequence[float],
                        w_lo: torch.Tensor, w_hi: torch.Tensor
                        ) -> torch.Tensor:
    """w_lo[n,1,nc] = r_face(i)*r_inv(i), w_hi = r_face(i+1)*r_inv(i)."""
    ndim = 2
    c = _iv(phi, ndim, nc)
    return (idr2[0] * (w_lo * _iv(phi, ndim, nc, 0, -1)
                       + w_hi * _iv(phi, ndim, nc, 0, +1) - 2.0 * c)
            + idr2[1] * (_iv(phi, ndim, nc, 1, -1)
                         + _iv(phi, ndim, nc, 1, +1) - 2.0 * c))


def cyl_laplacian_smooth_half(phi: torch.Tensor, rhs: torch.Tensor, nc: int,
                              idr2: Sequence[float], w_lo: torch.Tensor,
                              w_hi: torch.Tensor,
                              upd_mask: torch.Tensor) -> torch.Tensor:
    ndim = 2
    fac = 0.5 / (idr2[0] + idr2[1])
    new = fac * (idr2[0] * (w_hi * _iv(phi, ndim, nc, 0, +1)
                            + w_lo * _iv(phi, ndim, nc, 0, -1))
                 + idr2[1] * (_iv(phi, ndim, nc, 1, +1)
                              + _iv(phi, ndim, nc, 1, -1))
                 - _iv(rhs, ndim, nc))
    cur = _iv(phi, ndim, nc)
    return _set_interior(phi, ndim, torch.where(upd_mask, new, cur))


# ---------------------------------------------------------------------------
# operator dispatch
# ---------------------------------------------------------------------------

class OpContext:
    """Static per-level operator context passed by the solver."""

    def __init__(self, ndim, nc, idr2, geometry="cartesian",
                 cyl_w_lo=None, cyl_w_hi=None):
        self.ndim = ndim
        self.nc = nc
        self.idr2 = tuple(float(x) for x in idr2)
        self.geometry = geometry
        self.cyl_w_lo = cyl_w_lo
        self.cyl_w_hi = cyl_w_hi


def op_apply(name: str, ctx: OpContext, cc_lvl: torch.Tensor,
             lam) -> torch.Tensor:
    """Apply the named operator to cc[IPHI]; returns interior values."""
    phi = cc_lvl[IPHI]
    D, nc = ctx.ndim, ctx.nc
    if name == "laplacian":
        if ctx.geometry == "cylindrical":
            return cyl_laplacian_apply(phi, nc, ctx.idr2, ctx.cyl_w_lo,
                                       ctx.cyl_w_hi)
        return helmholtz_apply(phi, D, nc, ctx.idr2, 0.0)
    if name == "helmholtz":
        return helmholtz_apply(phi, D, nc, ctx.idr2, lam)
    if name == "vlaplacian":
        return vhelmholtz_apply(phi, cc_lvl[IVEPS], D, nc, ctx.idr2, 0.0)
    if name == "vhelmholtz":
        return vhelmholtz_apply(phi, cc_lvl[IVEPS], D, nc, ctx.idr2, lam)
    if name == "ahelmholtz":
        eps_dirs = [cc_lvl[IVEPS + d] for d in range(D)]
        return ahelmholtz_apply(phi, eps_dirs, D, nc, ctx.idr2, lam)
    raise ValueError(f"unknown operator {name}")


def op_smooth_half(name: str, ctx: OpContext, cc_lvl: torch.Tensor, lam,
                   upd_mask: torch.Tensor) -> torch.Tensor:
    """One masked half-sweep on cc[IPHI], in place; returns the phi plane."""
    phi, rhs = cc_lvl[IPHI], cc_lvl[IRHS]
    D, nc = ctx.ndim, ctx.nc
    if name == "laplacian":
        if ctx.geometry == "cylindrical":
            return cyl_laplacian_smooth_half(phi, rhs, nc, ctx.idr2,
                                             ctx.cyl_w_lo, ctx.cyl_w_hi,
                                             upd_mask)
        return helmholtz_smooth_half(phi, rhs, D, nc, ctx.idr2, 0.0, upd_mask)
    if name == "helmholtz":
        return helmholtz_smooth_half(phi, rhs, D, nc, ctx.idr2, lam, upd_mask,
                                     dtype=phi.dtype)
    if name == "vlaplacian":
        return vhelmholtz_smooth_half(phi, rhs, cc_lvl[IVEPS], D, nc,
                                      ctx.idr2, 0.0, upd_mask)
    if name == "vhelmholtz":
        return vhelmholtz_smooth_half(phi, rhs, cc_lvl[IVEPS], D, nc,
                                      ctx.idr2, lam, upd_mask)
    if name == "ahelmholtz":
        eps_dirs = [cc_lvl[IVEPS + d] for d in range(D)]
        return ahelmholtz_smooth_half(phi, rhs, eps_dirs, D, nc, ctx.idr2,
                                      lam, upd_mask)
    raise ValueError(f"unknown operator {name}")
