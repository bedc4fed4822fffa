"""Dense-level 2D stencil operations as whole-array PyTorch expressions.

The port of the JAX package's ``ops/dense2d.py``: on a uniform 2D level
(or a rectangular 2D AMR patch) the cells form one dense ``[Y, X]``
array, x fastest, with no pads at all.  Physical-BC ghosts are
synthesized inline from the Fortran formula (ghost = c0*b + c1*x1 +
c2*x2, m_ghost_cells.f90:682-698) at the cells that read them, and
periodic wraps are exact ``torch.roll``s along axis ``1 - d``.

The JAX package leaves these to XLA (there is no TPU kernel on the 2D
path), so they are plain torch ops here on every device: each operation
of an expression is one eager kernel, in the JAX package's order, so no
multiply-add contraction changes a rounding.  The arithmetic per cell is
the boxed smoothers' and operators' (``ops/kernels.py``:
helmholtz/vhelmholtz/ahelmholtz and the 2D cylindrical laplacian,
m_laplacian.f90:52-271, m_vlaplacian.f90:51-189, m_ahelmholtz.f90:69-237).

Scalars: ``lam`` is a ``[1, 1]`` tensor in the working dtype (the JAX
package's ``_lam_2d``), so ``1.0 / (den0 + lam)`` rounds in that dtype;
the cylindrical ``fac = 0.5 / (idr2[0] + idr2[1])`` is a Python double
rounded once at its multiply; the harmonic face coefficient
``2*e0*e_nb/(e0+e_nb)*idr2`` divides two tensors.  No tensor is divided
by a Python scalar (on CUDA that multiplies by the reciprocal).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


class Dense2DConfig:
    """Static per-level configuration (2D).

    dims: (X, Y) cell counts; idr2 likewise (x, y); bc: per direction
    nb = 0..3 (x-, x+, y-, y+) a (c0, c1, c2) tuple (ignored on periodic
    axes); b_const: per direction a static boundary value, or None when
    the value varies along the face (then a vector input is used);
    cyl_w: optional (w_lo, w_hi) radial face-weight rows [1, X] (tensors
    on the solver's device, in dtype) of the 2D cylindrical laplacian
    (box_clpl, m_laplacian.f90:209-212); eps_bc: per face a (c0, c1, c2)
    ghost synthesis of the coefficient fields, or None for the
    reference's Neumann-zero default (m_vlaplacian.f90:25-28); the 2D
    dense-patch AMR solver sets refinement faces to the sides_rb
    combination (0.5, 0.75, -0.25) with vector-valued b.
    """

    def __init__(self, dims, idr2, bc, periodic, dtype, b_const=None,
                 n_eps=0, cyl_w=None, eps_bc=None):
        if dtype not in _NP_DTYPE:
            raise TypeError(f"dense 2D ops take float32/float64, not {dtype}")
        self.X, self.Y = int(dims[0]), int(dims[1])
        self.dims = (self.X, self.Y)
        self.idr2 = tuple(float(v) for v in idr2)
        self.bc = [tuple(float(c) for c in t) for t in bc]
        self.periodic = tuple(bool(p) for p in periodic)
        self.dtype = dtype
        self.np_dtype = _NP_DTYPE[dtype]
        self.n_eps = int(n_eps)
        self.eps_bc = (None if eps_bc is None
                       else [tuple(float(c) for c in t) for t in eps_bc])
        self.cyl_w = cyl_w
        self.b_const = list(b_const) if b_const is not None else [None] * 4
        for i in range(4):
            if self.periodic[i // 2]:
                self.b_const[i] = 0.0
        #: the shared solver code reads these: no kernel runs in 2D
        self.use_kernel = False
        self.fused_down_ok = False
        s = 0.0
        for d in range(2):
            s = s + 2.0 * self.idr2[d]
        self.den0 = s
        #: per device: face masks, parity masks and [1, 1] lam tensors,
        #: built once (a captured CUDA graph then reads fixed tensors)
        self._memo: Dict = {}

    @property
    def pshape(self):
        return (self.Y, self.X)

    def rnd(self, v) -> float:
        """v rounded to the working dtype, as a Python float."""
        return float(self.np_dtype(v))

    def plane_shape(self, nb: int):
        """Shape of the boundary-value vector of face nb: x faces vary
        along y, y faces along x."""
        return (self.Y,) if nb < 2 else (self.X,)

    def _cached(self, key, make):
        v = self._memo.get(key)
        if v is None:
            v = self._memo[key] = make()
        return v


def _iotas(cfg: Dense2DConfig, device):
    return cfg._cached(("iotas", str(device)), lambda: (
        torch.arange(cfg.X, device=device).reshape(1, cfg.X),
        torch.arange(cfg.Y, device=device).reshape(cfg.Y, 1)))


def _face_masks(cfg: Dense2DConfig, device):
    """Boundary masks per non-periodic dim ([1, X] / [Y, 1] booleans)."""
    def make():
        gx, gy = _iotas(cfg, device)
        masks = {}
        for d, g in ((0, gx), (1, gy)):
            masks[d] = (None if cfg.periodic[d]
                        else (g == 0, g == cfg.dims[d] - 1))
        return masks
    return cfg._cached(("masks", str(device)), make)


def _parity_mask(cfg: Dense2DConfig, red_parity: int, device):
    """(gx + gy) % 2 == red_parity: the global checkerboard, the boxed
    parity because box sizes are even."""
    def make():
        gx, gy = _iotas(cfg, device)
        return ((gx + gy) % 2) == red_parity
    return cfg._cached(("parity", int(red_parity), str(device)), make)


def _lam_2d(cfg: Dense2DConfig, lam, device) -> torch.Tensor:
    """The Helmholtz scalar as a [1, 1] tensor in the working dtype (the
    JAX package's traced [1, 1] array): ``den0 + lam`` and its
    reciprocal then round in that dtype."""
    if isinstance(lam, torch.Tensor):
        return lam.to(device, cfg.dtype).reshape(1, 1)
    lam = float(lam)
    return cfg._cached(("lam", lam, str(device)), lambda: torch.full(
        (1, 1), lam, dtype=cfg.dtype, device=device))


def _bvals(cfg: Dense2DConfig, bvecs):
    """Boundary values broadcast against [Y, X]: x faces vary along y
    ([Y] -> [Y, 1]), y faces along x ([X] -> [1, X])."""
    out = []
    for i in range(4):
        if cfg.b_const[i] is not None:
            out.append(cfg.b_const[i])
        elif i < 2:
            out.append(bvecs[i][:, None])
        else:
            out.append(bvecs[i][None, :])
    return out


def _neighbor_ops(cfg: Dense2DConfig, p, d, masks, bpw):
    """(lo, hi) neighbour values along dim d with inline BC synthesis."""
    axis = 1 - d
    lo_raw = torch.roll(p, 1, axis)
    hi_raw = torch.roll(p, -1, axis)
    if masks[d] is None:
        return lo_raw, hi_raw
    c0l, c1l, c2l = cfg.bc[2 * d]
    c0h, c1h, c2h = cfg.bc[2 * d + 1]
    glo = c0l * bpw[2 * d] + c1l * p
    if c2l != 0.0:
        glo = glo + c2l * hi_raw
    ghi = c0h * bpw[2 * d + 1] + c1h * p
    if c2h != 0.0:
        ghi = ghi + c2h * lo_raw
    m_lo, m_hi = masks[d]
    return torch.where(m_lo, glo, lo_raw), torch.where(m_hi, ghi, hi_raw)


def _eps_neighbor_ops(cfg: Dense2DConfig, e, d, masks, ebpw=None):
    """Coefficient-field neighbours: Neumann-zero physical ghosts (ghost
    = own value), or, with cfg.eps_bc, the full bc_to_gc synthesis per
    face (faces whose c0 is 0 never read ``ebpw``)."""
    axis = 1 - d
    lo_raw = torch.roll(e, 1, axis)
    hi_raw = torch.roll(e, -1, axis)
    if masks[d] is None:
        return lo_raw, hi_raw
    m_lo, m_hi = masks[d]
    if cfg.eps_bc is None:
        return torch.where(m_lo, e, lo_raw), torch.where(m_hi, e, hi_raw)
    c0l, c1l, c2l = cfg.eps_bc[2 * d]
    c0h, c1h, c2h = cfg.eps_bc[2 * d + 1]
    # the accumulation order of _neighbor_ops (c0*b + c1*x1 + c2*x2)
    glo = c1l * e
    if c0l != 0.0:
        glo = c0l * ebpw[2 * d] + glo
    if c2l != 0.0:
        glo = glo + c2l * hi_raw
    ghi = c1h * e
    if c0h != 0.0:
        ghi = c0h * ebpw[2 * d + 1] + ghi
    if c2h != 0.0:
        ghi = ghi + c2h * lo_raw
    return torch.where(m_lo, glo, lo_raw), torch.where(m_hi, ghi, hi_raw)


def _bvals_eps(eps_planes):
    """Coefficient-field boundary vectors broadcast against [Y, X]: per
    eps field a 4-list (``None`` faces broadcast as 0.0)."""
    if eps_planes is None:
        return None
    out = []
    for planes in eps_planes:
        row = []
        for i in range(4):
            p = planes[i]
            if p is None:
                row.append(0.0)
            elif i < 2:
                row.append(p[:, None])
            else:
                row.append(p[None, :])
        out.append(row)
    return out


def _harmonic(e0, enb, idr2_d):
    """Face coefficient 2*e0*e_nb/(e0+e_nb)*idr2 (m_vlaplacian.f90:100)."""
    return 2.0 * e0 * enb / (e0 + enb) * idr2_d


def _halfsweep(cfg: Dense2DConfig, p, rhs, lam, masks, upd, red, bpw, eps,
               ebpw=None):
    """One masked GSRB half-sweep; bitwise the boxed smoothers."""
    if cfg.cyl_w is not None:
        # the 2D cylindrical laplacian (cyl_laplacian_smooth_half order)
        w_lo, w_hi = cfg.cyl_w
        xlo, xhi = _neighbor_ops(cfg, p, 0, masks, bpw)
        ylo, yhi = _neighbor_ops(cfg, p, 1, masks, bpw)
        fac = 0.5 / (cfg.idr2[0] + cfg.idr2[1])
        new = fac * (cfg.idr2[0] * (w_hi * xhi + w_lo * xlo)
                     + cfg.idr2[1] * (yhi + ylo) - rhs)
        return torch.where(upd, new, p) if red else torch.where(upd, p, new)
    if cfg.n_eps:
        num = -rhs
        den = lam
        for d in range(2):
            e0 = eps[0] if cfg.n_eps == 1 else eps[d]
            eb = None if ebpw is None else ebpw[0 if cfg.n_eps == 1 else d]
            elo, ehi = _eps_neighbor_ops(cfg, e0, d, masks, eb)
            plo, phi_ = _neighbor_ops(cfg, p, d, masks, bpw)
            c = _harmonic(e0, elo, cfg.idr2[d])
            num = num + c * plo
            den = den + c
            c = _harmonic(e0, ehi, cfg.idr2[d])
            num = num + c * phi_
            den = den + c
        new = num / den
        return torch.where(upd, new, p) if red else torch.where(upd, p, new)
    acc = -rhs
    for d in range(2):
        lo, hi = _neighbor_ops(cfg, p, d, masks, bpw)
        acc = acc + cfg.idr2[d] * (lo + hi)
    new = acc * (1.0 / (cfg.den0 + lam))
    return torch.where(upd, new, p) if red else torch.where(upd, p, new)


def _apply_expr(cfg: Dense2DConfig, p, lam, masks, bpw, eps, ebpw=None):
    """A(phi) in the boxed op_apply order."""
    if cfg.cyl_w is not None:
        w_lo, w_hi = cfg.cyl_w
        xlo, xhi = _neighbor_ops(cfg, p, 0, masks, bpw)
        ylo, yhi = _neighbor_ops(cfg, p, 1, masks, bpw)
        return (cfg.idr2[0] * (w_lo * xlo + w_hi * xhi - 2.0 * p)
                + cfg.idr2[1] * (ylo + yhi - 2.0 * p))
    out = -lam * p
    if cfg.n_eps:
        for d in range(2):
            e0 = eps[0] if cfg.n_eps == 1 else eps[d]
            eb = None if ebpw is None else ebpw[0 if cfg.n_eps == 1 else d]
            elo, ehi = _eps_neighbor_ops(cfg, e0, d, masks, eb)
            plo, phi_ = _neighbor_ops(cfg, p, d, masks, bpw)
            c = _harmonic(e0, elo, cfg.idr2[d])
            out = out + c * (plo - p)
            c = _harmonic(e0, ehi, cfg.idr2[d])
            out = out + c * (phi_ - p)
        return out
    for d in range(2):
        lo, hi = _neighbor_ops(cfg, p, d, masks, bpw)
        out = out + cfg.idr2[d] * (lo + hi - 2.0 * p)
    return out


def pair_sweep_2d(cfg: Dense2DConfig, phi, rhs, lam, bvecs,
                  red_parity: int, eps=(), eps_planes=None):
    """One red+black GSRB pair over the dense [Y, X] level; returns the
    new field (``phi`` is not written)."""
    dev = phi.device
    lam = _lam_2d(cfg, lam, dev)
    masks = _face_masks(cfg, dev)
    upd = _parity_mask(cfg, red_parity, dev)
    bpw = _bvals(cfg, bvecs)
    ebpw = _bvals_eps(eps_planes)
    p1 = _halfsweep(cfg, phi, rhs, lam, masks, upd, True, bpw, eps, ebpw)
    return _halfsweep(cfg, p1, rhs, lam, masks, upd, False, bpw, eps, ebpw)


def stencil_apply_2d(cfg: Dense2DConfig, phi, rhs, lam, bvecs,
                     residual: bool, eps=(), eps_planes=None):
    """A(phi), or rhs - A(phi) with ``residual``."""
    dev = phi.device
    lam = _lam_2d(cfg, lam, dev)
    masks = _face_masks(cfg, dev)
    bpw = _bvals(cfg, bvecs)
    out = _apply_expr(cfg, phi, lam, masks, bpw, eps, _bvals_eps(eps_planes))
    return rhs - out if residual else out


def restrict_2d(fine: torch.Tensor, out: Optional[torch.Tensor] = None):
    """Full weighting [2Yc, 2Xc] -> [Yc, Xc] (m_restrict.f90:183-194) as
    strided slices, in the order of the JAX package's two pair-sum
    matmuls (``R_y @ fine @ R_x^T``, a workaround for the TPU's slow
    stride-2 reads): the y pairs first, then the x pairs, then * 0.25.
    Equal in value to the matmul form; an exact zero may differ in sign
    (the matmul also adds +0.0 products).  Writes into ``out`` if
    given."""
    s = ((fine[0::2, 0::2] + fine[1::2, 0::2])
         + (fine[0::2, 1::2] + fine[1::2, 1::2]))
    if out is None:
        return s * 0.25
    return torch.mul(s, 0.25, out=out)
