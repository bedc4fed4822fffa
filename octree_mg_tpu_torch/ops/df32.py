"""Double-float (float32-pair) residual for f64-class iterative refinement.

The mixed-precision outer loop (float32 sweeps + f64-class residual; the
Fortran reference is float64 throughout, m_data_structures.f90:8) needs
float64 accuracy in one place only, the residual

    r = rhs - A(x),

and A is linear.  This module evaluates it EXACTLY over a double-float
representation x = x_hi + x_lo (two float32 arrays, ~2^-48 relative
precision) using error-free transformations built from plain float32
adds (Knuth TwoSum) — no float64 operation at all, so the refined solve
keeps float32 kernels and float32 memory.

Exactness gating (``df32_ok``): every stencil product must be exact in
float32, which holds when

* the operator is the constant-coefficient cartesian laplacian or
  helmholtz (the +lam*x term rides an exact Dekker TwoProduct with lam
  split on the host — ``split_lam``/``two_prod``) with equal grid
  spacing per dim,
* 1/dx^2 is a power of two (unit-cube power-of-two grids; den0 = 6/dx^2
  splits into the exact 4/dx^2 + 2/dx^2 pair),
* BC coefficient triples have c1, c2 in {0, +-1, +-2} — Dirichlet
  (2,-1,0), continuous (0,2,-1) and zero-gradient Neumann qualify
  (m_ghost_cells.f90:682-698) — with static boundary values (their
  c0*b products are pre-split on the host into exact float32 pairs).

The error analysis: with exact products, the main-term sum is exact
(TwoSum chain) and all cancellation error lands in a compensation
channel that is applied at the end, so the returned float32 r is the
correctly rounded true residual of the represented x up to (a) its own
float32 rounding, RELATIVE to |r| (2^-24 — harmless for refinement, the
error shrinks with r), and (b) an absolute floor of ~2^-45 of the
stencil term magnitudes from the compensation channel's second-order
rounding and the double-float representation itself.  A plain float32
residual instead carries ~2^-24-of-term-magnitude ABSOLUTE cancellation
noise, which is what caps plain float32 solves at ~1e-6 relative.

Two renderings of one expression, one rounding per operation in both:

* ``residual_df32`` — the plain PyTorch version over the whole padded
  array (plain ``*``, ``+``, ``-``, ``torch.where`` only: a fused
  multiply-add would round differently and break the transformations);
* ``residual_df32_dense`` — the wrapper: a CPU tensor takes the plain
  version, a CUDA tensor launches the hand-written kernel
  ``csrc/residual_df32.cu`` (built with ``--fmad=false``) or raises.

The variable-coefficient operators have harmonic-mean face coefficients
whose products and quotients cannot be exact: ``residual_df32_vcoeff``
evaluates their residual in double-float PAIR arithmetic (``df_add`` …
``df_div``, ~2^-47 relative — float64-class but not error-free), as
plain PyTorch ops on whatever device its tensors lie, as the JAX package
leaves it to XLA.  Each operation is an eager kernel of its own, so no
multiply-add contraction can eat an error term; it must not go through
``torch.compile``, which fuses and may contract.

``residual_df32`` and ``residual_df32_dense`` take ``z_gates`` for one
slab of the z-slab solver's refined outer
(``ShardedRefinedPoisson``): the z neighbours beyond a face the slab does
not own are read from the z pads of x_hi and x_lo, which the caller's
halo exchange filled (ops/dense_kernels module docstring); on the card
the kernel's slab variant, counted under ``residual_df32_dense[z_gates]``.

``interp_rb_strip_df`` is the double-float coarse-strip interpolation of
the refinement-boundary ghosts, for the refined forest solve
(``solve/refine_forest.py``); its 2D branch waits for its caller, the 2D
refined forest (ROADMAP A10b).

``df32_ok_2d`` and ``residual_df32_2d`` are the 2D forms for the dense
``[Y, X]`` path (``RefinedPoisson2D``): the same error-free
transformations over unpadded arrays whose periodic wraps are exact
rolls, as plain PyTorch ops on every device (the JAX package leaves the
2D path to XLA; no kernel).  Still to come with its caller: the
``nch``-chunked evaluation.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import dense_kernels as dk


# ---------------------------------------------------------------------------
# error-free transformations (float32 adds and multiplies, each rounded
# once; eager PyTorch neither reassociates nor contracts them)
# ---------------------------------------------------------------------------

def two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (6 flops, branch-free).

    ``a`` is a tensor; ``b`` a tensor or a host scalar that float32
    holds exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Dekker FastTwoSum (requires |a| >= |b|): s + e == a + b."""
    s = a + b
    e = b - (s - a)
    return s, e


def veltkamp_split(a):
    """Split a into (a1, a2), a == a1 + a2 with both halves carrying
    <= 12 significant bits, so any a_i * b_j product of two splits is
    EXACT in float32 (Veltkamp; Dekker 1971).  Pure mul/add — no fma.

    A host scalar is split in numpy float32 arithmetic (the same IEEE
    operations) and returned as Python floats."""
    if not isinstance(a, torch.Tensor):
        a = np.float32(a)
        c = np.float32(4097.0) * a           # 2^12 + 1
        a1 = c - (c - a)
        return float(a1), float(a - a1)
    c = 4097.0 * a
    a1 = c - (c - a)
    return a1, a - a1


def two_prod(a, b):
    """Dekker TwoProduct: p + e == a * b exactly (float32, no overflow
    range issues at the magnitudes the residual handles).  Used for the
    lam*x term of the Helmholtz residual — the only stencil product that
    is not exact by construction."""
    p = a * b
    a1, a2 = veltkamp_split(a)
    b1, b2 = veltkamp_split(b)
    e = ((a1 * b1 - p) + a1 * b2 + a2 * b1) + a2 * b2
    return p, e


def accumulate_df32(xhi, xlo, delta):
    """(xhi + xlo) + delta in double-float: the outer-loop solution
    update x += e with no precision loss (delta is a plain float32).
    Returns new tensors; :func:`accumulate_df32_` is the in-place form."""
    s, err = two_sum(xhi, delta)
    lo = xlo + err
    return fast_two_sum(s, lo)


def accumulate_df32_(xhi, xlo, delta, scratch):
    """:func:`accumulate_df32` IN PLACE on (xhi, xlo), operation for
    operation, allocating nothing: ``scratch`` is three tensors shaped
    like xhi that the caller owns.  Returns (xhi, xlo)."""
    s, t, u = scratch
    torch.add(xhi, delta, out=s)         # s = a + b
    torch.sub(s, xhi, out=t)             # bb = s - a
    torch.sub(s, t, out=u)               # s - bb
    torch.sub(xhi, u, out=u)             # a - (s - bb)
    torch.sub(delta, t, out=t)           # b - bb
    torch.add(u, t, out=u)               # err
    torch.add(xlo, u, out=xlo)           # lo = xlo + err
    torch.add(s, xlo, out=xhi)           # hi' = s + lo
    torch.sub(xhi, s, out=t)             # hi' - s
    torch.sub(xlo, t, out=xlo)           # lo' = lo - (hi' - s)
    return xhi, xlo


def split_f64(a64):
    """Split a float64 array/scalar into an (hi, lo) float32 pair with
    hi + lo == a64 to float32-pair precision: numpy in, numpy out (on
    the host); a tensor in, tensors out on its device (setup only)."""
    if isinstance(a64, torch.Tensor):
        a = a64.to(torch.float64)
        hi = a.to(torch.float32)
        return hi, (a - hi.to(torch.float64)).to(torch.float32)
    hi = np.asarray(a64, np.float64).astype(np.float32)
    lo = (np.asarray(a64, np.float64) - hi.astype(np.float64)).astype(
        np.float32)
    return hi, lo


def _is_pow2(v: float) -> bool:
    m, _ = np.frexp(np.float64(v))
    return m == 0.5


# ---------------------------------------------------------------------------
# gating
# ---------------------------------------------------------------------------

_OK_C = (0.0, 1.0, -1.0, 2.0, -2.0)


def df32_ok(cfg: dk.DenseStencilConfig) -> bool:
    """Whether the exact double-float residual covers this config (see
    the module docstring for the conditions); variable coefficients
    take :func:`df32_vcoeff_ok` instead."""
    if cfg.n_eps:
        return False
    if len(set(cfg.idr2)) != 1 or not _is_pow2(cfg.idr2[0]):
        return False
    for d in range(3):
        if cfg.periodic[d]:
            continue
        for nb in (2 * d, 2 * d + 1):
            c0, c1, c2 = cfg.bc[nb]
            if c1 not in _OK_C or c2 not in _OK_C:
                return False
            if cfg.b_const[nb] is None:
                return False  # plane values: pre-split constants only
    return True


def _cb_pairs(cfg, b_values=None) -> List[Tuple[float, float]]:
    """Exact split, on the host, of the c0*b boundary constants of the
    six faces.

    b_values overrides cfg.b_const: iterative refinement keeps the TRUE
    inhomogeneous boundary values in the outer residual only, while the
    inner solver runs the homogeneous error equation (solve/refine)."""
    bs = cfg.b_const if b_values is None else list(b_values)
    out = []
    for nb in range(len(cfg.b_const)):
        b = bs[nb]
        c0 = cfg.bc[nb][0] if not cfg.periodic[nb // 2] else 0.0
        hi, lo = split_f64(np.float64(c0) * np.float64(b if b is not None
                                                       else 0.0))
        out.append((float(hi), float(lo)))
    return out


def split_lam(lam: float):
    """Host split of a Helmholtz lam into the (hi, lo) float32 pair the
    residual's TwoProduct term consumes; None for lam == 0 (keeps the
    laplacian expression free of the extra flops)."""
    if float(lam) == 0.0:
        return None
    hi, lo = split_f64(np.float64(lam))
    return (float(hi), float(lo))


# ---------------------------------------------------------------------------
# the residual
# ---------------------------------------------------------------------------

def _df32_expr(cfg, xhi, xlo, rhshi, rhslo, masks, cbs, lam_pair=None):
    """The residual expression over one array set — see residual_df32
    for semantics.  The operation order, TwoSum operand order included,
    is the JAX package's ``_df32_expr`` and the CUDA kernel's.

    lam_pair: (lam_hi, lam_lo) host split of the Helmholtz lam (None for
    the laplacian).  The +lam*x residual term rides a Dekker TwoProduct
    (exact), with the cross terms lam_hi*x_lo and lam_lo*x_hi landing in
    the compensation channel (m_helmholtz.f90:111-154's operator at f64
    accuracy)."""
    idr2 = cfg.idr2[0]

    comp = torch.zeros_like(xhi)  # first-order compensation channel
    s = rhshi                     # exact-sum accumulator
    alo = torch.zeros_like(xhi)   # plain A_hom(x_lo)

    for d, axis in dk._DIM_AXIS:
        rlo_h = torch.roll(xhi, +1, axis)
        rhi_h = torch.roll(xhi, -1, axis)
        rlo_l = torch.roll(xlo, +1, axis)
        rhi_l = torch.roll(xlo, -1, axis)
        vlo_h, vhi_h, vlo_l, vhi_l = rlo_h, rhi_h, rlo_l, rhi_l
        if masks[d] is not None:
            m_lo, m_hi = masks[d]
            # ghost(x) = (c0*b)_hi + c1*x1 + c2*x2 + (c0*b)_lo, the hi
            # part via an exact TwoSum chain; x1 is the boundary cell
            # itself, x2 its inner neighbour read from the RAW roll
            # (bc_to_gc, m_ghost_cells.f90:682-698).  The x_lo ghost is
            # the same formula with b = 0 (the boundary value is carried
            # once).
            c0l, c1l, c2l = cfg.bc[2 * d]
            c0h, c1h, c2h = cfg.bc[2 * d + 1]
            cbl_h, cbl_l = cbs[2 * d]
            cbh_h, cbh_l = cbs[2 * d + 1]

            gv, ge = two_sum(c1l * xhi, cbl_h)
            if c2l != 0.0:
                gv, e2 = two_sum(gv, c2l * rhi_h)
                ge = ge + e2
            ge = ge + cbl_l
            vlo_h = torch.where(m_lo, gv, rlo_h)
            vlo_l = torch.where(m_lo, c1l * xlo
                                + (c2l * rhi_l if c2l != 0.0 else 0.0),
                                rlo_l)
            e_lo = torch.where(m_lo, ge, 0.0)

            gv, ge = two_sum(c1h * xhi, cbh_h)
            if c2h != 0.0:
                gv, e2 = two_sum(gv, c2h * rlo_h)
                ge = ge + e2
            ge = ge + cbh_l
            vhi_h = torch.where(m_hi, gv, rhi_h)
            vhi_l = torch.where(m_hi, c1h * xlo
                                + (c2h * rlo_l if c2h != 0.0 else 0.0),
                                rhi_l)
            e_hi = torch.where(m_hi, ge, 0.0)
            comp = comp - idr2 * (e_lo + e_hi)
        sd, ed = two_sum(vlo_h, vhi_h)
        s, e = two_sum(s, -(idr2 * sd))
        comp = comp + (e - idr2 * ed)
        alo = alo + idr2 * (vlo_l + vhi_l)

    # + (den0 + lam) * x with den0 = 6*idr2 split into the exact
    # 4*idr2 + 2*idr2 pair
    s, e = two_sum(s, (4.0 * idr2) * xhi)
    comp = comp + e
    s, e = two_sum(s, (2.0 * idr2) * xhi)
    comp = comp + e
    comp = comp + rhslo - (alo - (6.0 * idr2) * xlo)
    if lam_pair is not None:
        lam_h, lam_l = lam_pair
        p, pe = two_prod(xhi, lam_h)
        s, e = two_sum(s, p)
        comp = comp + (e + pe) + (lam_h * xlo + lam_l * xhi)
    r_hi, _ = two_sum(s, comp)
    return r_hi


def _check_gate(cfg, what):
    if cfg.dtype != torch.float32:
        raise TypeError(f"{what}: the double-float residual is float32 "
                        f"only, the config has {cfg.dtype}")
    if not df32_ok(cfg):
        raise ValueError(f"{what} called outside its gate (df32_ok): needs "
                         f"equal power-of-two 1/dx^2, BC coefficients in "
                         f"{{0, +-1, +-2}} and constant boundary values")


def residual_df32(cfg: dk.DenseStencilConfig, xhi, xlo, rhshi, rhslo,
                  cbs=None, lam_pair=None, z_gates=None):
    """r_hi ~= (rhshi + rhslo) - A(xhi + xlo), exact to the double-float
    representation (see module docstring).  Inputs are padded arrays in
    the dense layout; pads follow the usual garbage-by-contract rules
    (periodic z/y pads of xhi and xlo kept current by the caller,
    non-periodic ghosts synthesized inline).  Plain PyTorch over the
    whole array; ``residual_df32_dense`` launches the kernel on CUDA
    tensors.  z_gates: a z-slab's (lo, hi) gates, as in
    ``dense_kernels.stencil_apply_dense``."""
    _check_gate(cfg, "residual_df32")
    for t in (xhi, xlo, rhshi, rhslo):
        if t.dtype != torch.float32:
            raise TypeError(f"residual_df32: float32 only, got {t.dtype}")
    g = dk._full_iotas(cfg, xhi.device)
    masks = dk._face_masks(cfg, g, dk._check_gates(z_gates, "residual_df32"))
    return _df32_expr(cfg, xhi, xlo, rhshi, rhslo, masks,
                      cbs if cbs is not None else _cb_pairs(cfg),
                      lam_pair=lam_pair)


class _Df32Params(ctypes.Structure):
    """Mirror of ``Df32Params`` in csrc/residual_df32.cu."""
    _fields_ = [("cb_hi", ctypes.c_float * 6), ("cb_lo", ctypes.c_float * 6),
                ("lam_hi", ctypes.c_float), ("lam_lo", ctypes.c_float),
                ("has_lam", ctypes.c_int)]


dk._ARGTYPES["omg_residual_df32"] = [
    ctypes.POINTER(dk._LevelParams), ctypes.POINTER(_Df32Params),
    dk._VP, dk._VP, dk._VP, dk._VP, dk._VP, dk._VP,
    ctypes.POINTER(ctypes.c_int)]
dk._ARGTYPES["omg_residual_df32_slab"] = [
    ctypes.POINTER(dk._LevelParams), ctypes.POINTER(_Df32Params),
    ctypes.POINTER(dk._SlabParams), dk._VP, dk._VP, dk._VP, dk._VP, dk._VP,
    dk._VP, ctypes.POINTER(ctypes.c_int)]


def residual_df32_dense(cfg: dk.DenseStencilConfig, xhi, xlo, rhshi, rhslo,
                        cbs=None, lam_pair=None, out=None, z_gates=None):
    """:func:`residual_df32` in one pass over device memory.  A CPU
    tensor runs the plain version; a CUDA tensor launches
    ``csrc/residual_df32.cu`` or raises.  Bitwise the plain version.

    On a level or slab of 2^24 cells and more in planes of 2^18 and more
    (the refined path's 512^3 level and its slabs over 8) the kernel is a
    z-march (planes of x_hi and x_lo in a shared-memory ring), whose
    launches are also counted under ``residual_df32_dense[march]``
    (``residual_df32_dense[z_gates][march]`` on a slab); smaller ones run
    a thread per cell.

    Returns a padded field with garbage pads: ``out`` when given (a
    padded float32 field that is none of the inputs), else a new one.
    The kernel reads wrapped indices on periodic axes and never a pad,
    so CUDA inputs need no pad sync and their pads may hold anything --
    except with z_gates (a z-slab, see :func:`residual_df32`), whose z
    pads of xhi and xlo must hold the neighbour slabs' planes 1 deep."""
    _check_gate(cfg, "residual_df32_dense")
    z_gates = dk._check_gates(z_gates, "residual_df32_dense")
    if cbs is None:
        cbs = _cb_pairs(cfg)
    if not xhi.is_cuda:
        r = residual_df32(cfg, xhi, xlo, rhshi, rhslo, cbs, lam_pair,
                          z_gates)
        if out is None:
            return r
        out.copy_(r)
        return out
    fields = {"xhi": xhi, "xlo": xlo, "rhshi": rhshi, "rhslo": rhslo}
    if out is None:
        out = torch.empty_like(xhi)
    else:
        fields["out"] = out
        if any(out.data_ptr() == t.data_ptr() for t in (xhi, xlo, rhshi,
                                                       rhslo)):
            raise ValueError("residual_df32_dense: out aliases an input")
    for name, t in fields.items():
        dk._check_field(cfg, t, name)
    P = dk._params(cfg, 0.0, [None] * 6)
    Q = _Df32Params()
    for nb in range(6):
        Q.cb_hi[nb], Q.cb_lo[nb] = cbs[nb]
    Q.has_lam = int(lam_pair is not None)
    Q.lam_hi, Q.lam_lo = lam_pair if lam_pair is not None else (0.0, 0.0)
    design = ctypes.c_int(0)
    ptrs = (xhi.data_ptr(), xlo.data_ptr(), rhshi.data_ptr(),
            rhslo.data_ptr(), out.data_ptr(), dk.cuda_stream(xhi),
            ctypes.byref(design))
    if z_gates is not None:
        Zs = dk._slab_params(z_gates)
        err = dk._fn("residual_df32", "omg_residual_df32_slab")(
            ctypes.byref(P), ctypes.byref(Q), ctypes.byref(Zs), *ptrs)
        name = dk.slab_name("residual_df32_dense")
        dk.record_launch(err, "residual_df32_dense", name)
        dk._count_design(name, 0, design.value)
        return out
    err = dk._fn("residual_df32", "omg_residual_df32")(
        ctypes.byref(P), ctypes.byref(Q), *ptrs)
    dk.record_launch(err, "residual_df32_dense")
    dk._count_design("residual_df32_dense", 0, design.value)
    return out


# ---------------------------------------------------------------------------
# double-float PAIR arithmetic (variable-coefficient operators)
#
# The constant-coefficient residual above is ERROR-FREE (every product
# exact by construction).  Variable-coefficient operators
# (vlaplacian/vhelmholtz/ahelmholtz, m_vlaplacian.f90:84-128,
# m_ahelmholtz.f90:69-162) have harmonic-mean face coefficients
# 2*ea*eb/(ea+eb) whose product and quotient cannot be exact; double-float
# ARITHMETIC (Dekker/Bailey pair operations built on the same TwoSum /
# TwoProduct transformations) evaluates them to ~1-2 ulp of the float32
# PAIR (~2^-47 relative), still the float64 accuracy class of the
# reference (m_data_structures.f90:8).  Each operation renormalizes with
# FastTwoSum, so errors do not grow past the pair ulp class over the
# ~20-operation residual chain.  A pair is a tuple (hi, lo).
# ---------------------------------------------------------------------------

def df_add(a, b):
    """(ah, al) + (bh, bl), ~1 ulp of the pair."""
    s, e = two_sum(a[0], b[0])
    return fast_two_sum(s, a[1] + b[1] + e)


def df_sub(a, b):
    s, e = two_sum(a[0], -b[0])
    return fast_two_sum(s, a[1] - b[1] + e)


def df_mul(a, b):
    """(ah, al) * (bh, bl), ~2 ulp of the pair (Dekker mul2)."""
    p, pe = two_prod(a[0], b[0])
    return fast_two_sum(p, pe + a[0] * b[1] + a[1] * b[0])


def df_div(a, b):
    """(ah, al) / (bh, bl), ~3 ulp of the pair (Dekker div2: high
    quotient + one exact-remainder correction step)."""
    q1 = a[0] / b[0]
    p, pe = two_prod(q1, b[0])
    # r = a - q1*b, the high part via TwoSum (p is close to a[0])
    rh, re = two_sum(a[0], -p)
    rl = a[1] - pe - q1 * b[1] + re
    q2 = (rh + rl) / b[0]
    return fast_two_sum(q1, q2)


def df_scale_pow2(a, s: float):
    """Exact power-of-two scale of a pair."""
    return s * a[0], s * a[1]


def df32_vcoeff_ok(cfg: dk.DenseStencilConfig) -> bool:
    """Gate for the double-float variable-coefficient residual: eps
    present, per-dim power-of-two 1/dx^2 (the c*idr2 scale stays exact),
    exact BC coefficient classes with static boundary values, default
    Neumann-zero eps ghosts (no ``eps_bc``).  Unlike ``df32_ok`` the
    per-dim spacings need not be equal (ahelmholtz grids)."""
    if not cfg.n_eps or cfg.eps_bc is not None:
        return False
    for d in range(3):
        if not _is_pow2(cfg.idr2[d]):
            return False
        if cfg.periodic[d]:
            continue
        for nb in (2 * d, 2 * d + 1):
            c0, c1, c2 = cfg.bc[nb]
            if c1 not in _OK_C or c2 not in _OK_C:
                return False
            if cfg.b_const[nb] is None:
                return False
    return True


def _ghost_pair(xh, xl, x2h, x2l, bc3, cb):
    """Physical-face ghost as a df pair: c0*b + c1*x1 + c2*x2 with the
    (c0*b) constant pre-split (cb) and c1, c2 in the exact class."""
    c0, c1, c2 = bc3
    cb_h, cb_l = cb
    gv, ge = two_sum(c1 * xh, cb_h)
    gl = c1 * xl + cb_l
    if c2 != 0.0:
        gv, e2 = two_sum(gv, c2 * x2h)
        ge = ge + e2
        gl = gl + c2 * x2l
    return fast_two_sum(gv, gl + ge)


def residual_df32_vcoeff(cfg: dk.DenseStencilConfig, xhi, xlo, rhshi,
                         rhslo, eps_pairs, cbs=None, lam_pair=None):
    """r_hi ~= (rhs) - A(x) for the variable-coefficient operators on the
    padded dense layout, in double-float pair arithmetic (~2^-47
    relative, float64-class; see the section comment):

        A(x) = -lam*x + sum_d [ c_lo*(x_lo - x) + c_hi*(x_hi - x) ],
        c = 2*e0*e_nbr/(e0 + e_nbr) * idr2[d]

    (the harmonic-mean form of the stencil kernels, m_vlaplacian.f90:
    84-128; ahelmholtz uses eps_pairs[d] per dim, m_ahelmholtz.f90:
    69-162).  eps_pairs: tuple of (eps_hi, eps_lo) padded float32 pairs,
    length cfg.n_eps; eps ghosts are the Neumann-zero mirror (= own
    value, exact).  Plain PyTorch over the whole padded array, on the
    tensors' device, in the JAX package's operation order (its function
    is plain XLA, no Pallas kernel); periodic z/y pads of every input
    kept current by the caller."""
    if cfg.dtype != torch.float32:
        raise TypeError(f"residual_df32_vcoeff: float32 pairs only, the "
                        f"config has {cfg.dtype}")
    if not df32_vcoeff_ok(cfg):
        raise ValueError("residual_df32_vcoeff called outside its gate "
                         "(df32_vcoeff_ok)")
    if len(eps_pairs) != cfg.n_eps:
        raise ValueError(f"residual_df32_vcoeff: {len(eps_pairs)} eps "
                         f"pairs, the config has n_eps={cfg.n_eps}")
    if cbs is None:
        cbs = _cb_pairs(cfg)
    g = dk._full_iotas(cfg, xhi.device)
    masks = dk._face_masks(cfg, g)
    x = (xhi, xlo)
    acc = (rhshi, rhslo)
    for d, axis in dk._DIM_AXIS:
        e0 = eps_pairs[0 if cfg.n_eps == 1 else d]
        elo = (torch.roll(e0[0], +1, axis), torch.roll(e0[1], +1, axis))
        ehi = (torch.roll(e0[0], -1, axis), torch.roll(e0[1], -1, axis))
        vlo = (torch.roll(xhi, +1, axis), torch.roll(xlo, +1, axis))
        vhi = (torch.roll(xhi, -1, axis), torch.roll(xlo, -1, axis))
        if masks[d] is not None:
            m_lo, m_hi = masks[d]
            # eps: Neumann-zero mirror (ghost = own value — exact)
            elo = (torch.where(m_lo, e0[0], elo[0]),
                   torch.where(m_lo, e0[1], elo[1]))
            ehi = (torch.where(m_hi, e0[0], ehi[0]),
                   torch.where(m_hi, e0[1], ehi[1]))
            # phi: full bc_to_gc synthesis as a pair
            gl = _ghost_pair(xhi, xlo, vhi[0], vhi[1], cfg.bc[2 * d],
                             cbs[2 * d])
            gh = _ghost_pair(xhi, xlo, vlo[0], vlo[1], cfg.bc[2 * d + 1],
                             cbs[2 * d + 1])
            vlo = (torch.where(m_lo, gl[0], vlo[0]),
                   torch.where(m_lo, gl[1], vlo[1]))
            vhi = (torch.where(m_hi, gh[0], vhi[0]),
                   torch.where(m_hi, gh[1], vhi[1]))
        for enb, v in ((elo, vlo), (ehi, vhi)):
            c = df_div(df_mul(e0, enb), df_add(e0, enb))
            c = df_scale_pow2(c, 2.0 * cfg.idr2[d])
            acc = df_sub(acc, df_mul(c, df_sub(v, x)))
    if lam_pair is not None:
        acc = df_add(acc, df_mul(x, lam_pair))
    return acc[0]


# ---------------------------------------------------------------------------
# double-float refinement-boundary ghost synthesis (forest trees)
# ---------------------------------------------------------------------------

def interp_rb_strip_df(th, tl, ndim: int):
    """Double-float rendering of ``ops.ghost.interp_rb_strip``: the
    coarse strip pair (th, tl) -> the interpolated plane pair next to the
    fine points (box_gc_for_fine_neighbor, m_ghost_cells.f90:557-576).

    Every weight is 0.125 or 1 (exact powers of two) and every sum is a
    TwoSum with its error folded into the lo channel, so the pair holds
    the exact interpolation of the exact strip values to the ~2^-48
    double-float class.  ``th``/``tl`` are [m, t + 2] in 2D and
    [m, t_hi + 2, t_lo + 2] in 3D, as for the float32 form; the operation
    order is the JAX package's."""
    def pair_add(ah, al, bh, bl):
        s, e = two_sum(ah, bh)
        return s, al + bl + e

    def pair_sub(ah, al, bh, bl):
        s, e = two_sum(ah, -bh)
        return s, al - bl + e

    if ndim == 2:
        mh, ml = th[:, 1:-1], tl[:, 1:-1]
        dh, de = two_sum(th[:, 2:], -th[:, :-2])
        gh = 0.125 * dh
        gl = 0.125 * (tl[:, 2:] - tl[:, :-2] + de)
        lo_h, lo_l = pair_sub(mh, ml, gh, gl)
        hi_h, hi_l = pair_add(mh, ml, gh, gl)

        def ilv(a, b):
            return torch.stack([a, b], dim=-1).reshape(a.shape[0], -1)

        return ilv(lo_h, hi_h), ilv(lo_l, hi_l)
    mh, ml = th[:, 1:-1, 1:-1], tl[:, 1:-1, 1:-1]
    dh, de = two_sum(th[:, 1:-1, 2:], -th[:, 1:-1, :-2])
    glo_h = 0.125 * dh
    glo_l = 0.125 * (tl[:, 1:-1, 2:] - tl[:, 1:-1, :-2] + de)
    dh, de = two_sum(th[:, 2:, 1:-1], -th[:, :-2, 1:-1])
    ghi_h = 0.125 * dh
    ghi_l = 0.125 * (tl[:, 2:, 1:-1] - tl[:, :-2, 1:-1] + de)
    m = th.shape[0]

    def combo(slo, shi):
        h, l = (pair_sub, pair_add)[slo](mh, ml, glo_h, glo_l)
        return (pair_sub, pair_add)[shi](h, l, ghi_h, ghi_l)

    c00, c10, c01, c11 = combo(0, 0), combo(1, 0), combo(0, 1), combo(1, 1)

    def ilv_last(a, b):  # interleave along the last axis
        return torch.stack([a, b], dim=-1).reshape(*a.shape[:-1],
                                                   2 * a.shape[-1])

    def assemble(i):
        row_lo = ilv_last(c00[i], c10[i])    # t_hi even
        row_hi = ilv_last(c01[i], c11[i])    # t_hi odd
        return torch.stack([row_lo, row_hi], dim=2).reshape(
            m, 2 * mh.shape[1], 2 * mh.shape[2])

    return assemble(0), assemble(1)


# ---------------------------------------------------------------------------
# 2D (the dense [Y, X] path: no pads, rolls wrap exactly)
# ---------------------------------------------------------------------------

def df32_ok_2d(cfg) -> bool:
    """The 2D gate: the cartesian constant-coefficient operator with equal
    power-of-two 1/dx^2 and exact BC coefficient classes with constant
    boundary values (the 2D den0 = 4/dx^2 is itself a power of two: no
    split needed)."""
    if cfg.n_eps or cfg.cyl_w is not None:
        return False
    if len(set(cfg.idr2)) != 1 or not _is_pow2(cfg.idr2[0]):
        return False
    for d in range(2):
        if cfg.periodic[d]:
            continue
        for nb in (2 * d, 2 * d + 1):
            c0, c1, c2 = cfg.bc[nb]
            if c1 not in _OK_C or c2 not in _OK_C:
                return False
            if cfg.b_const[nb] is None:
                return False
    return True


def residual_df32_2d(cfg, xhi, xlo, rhshi, rhslo, cbs=None, lam_pair=None,
                     out=None):
    """r_hi ~= (rhshi + rhslo) - A(xhi + xlo) on the dense 2D [Y, X]
    layout: the 2D rendering of :func:`residual_df32` (the same
    error-free transformations, exactness argument and TwoSum operand
    order; the ghost recipe of ops/dense2d._neighbor_ops), in the JAX
    package's operation order, each operation one eager torch op.
    ``out``: a float32 [Y, X] tensor that receives r_hi (the final sum
    writes it), else a new one."""
    from . import dense2d as d2
    if cfg.dtype != torch.float32:
        raise TypeError(f"residual_df32_2d: the double-float residual is "
                        f"float32 only, the config has {cfg.dtype}")
    if not df32_ok_2d(cfg):
        raise ValueError("residual_df32_2d called outside its gate "
                         "(df32_ok_2d)")
    if cbs is None:
        cbs = _cb_pairs(cfg)
    masks = d2._face_masks(cfg, xhi.device)
    idr2 = cfg.idr2[0]

    comp = torch.zeros_like(xhi)
    s = rhshi
    alo = torch.zeros_like(xhi)
    for d in (0, 1):
        axis = 1 - d
        rlo_h = torch.roll(xhi, 1, axis)
        rhi_h = torch.roll(xhi, -1, axis)
        rlo_l = torch.roll(xlo, 1, axis)
        rhi_l = torch.roll(xlo, -1, axis)
        vlo_h, vhi_h, vlo_l, vhi_l = rlo_h, rhi_h, rlo_l, rhi_l
        if masks[d] is not None:
            m_lo, m_hi = masks[d]
            c0l, c1l, c2l = cfg.bc[2 * d]
            c0h, c1h, c2h = cfg.bc[2 * d + 1]
            cbl_h, cbl_l = cbs[2 * d]
            cbh_h, cbh_l = cbs[2 * d + 1]

            gv, ge = two_sum(c1l * xhi, cbl_h)
            if c2l != 0.0:
                gv, e2 = two_sum(gv, c2l * rhi_h)
                ge = ge + e2
            ge = ge + cbl_l
            vlo_h = torch.where(m_lo, gv, rlo_h)
            vlo_l = torch.where(m_lo, c1l * xlo
                                + (c2l * rhi_l if c2l != 0.0 else 0.0),
                                rlo_l)
            e_lo = torch.where(m_lo, ge, 0.0)

            gv, ge = two_sum(c1h * xhi, cbh_h)
            if c2h != 0.0:
                gv, e2 = two_sum(gv, c2h * rlo_h)
                ge = ge + e2
            ge = ge + cbh_l
            vhi_h = torch.where(m_hi, gv, rhi_h)
            vhi_l = torch.where(m_hi, c1h * xlo
                                + (c2h * rlo_l if c2h != 0.0 else 0.0),
                                rhi_l)
            e_hi = torch.where(m_hi, ge, 0.0)
            comp = comp - idr2 * (e_lo + e_hi)
        sd, ed = two_sum(vlo_h, vhi_h)
        s, e = two_sum(s, -(idr2 * sd))
        comp = comp + (e - idr2 * ed)
        alo = alo + idr2 * (vlo_l + vhi_l)

    # + den0 * x with den0 = 4*idr2 (a power of two: one exact product)
    s, e = two_sum(s, (4.0 * idr2) * xhi)
    comp = comp + e
    comp = comp + rhslo - (alo - (4.0 * idr2) * xlo)
    if lam_pair is not None:
        lam_h, lam_l = lam_pair
        p, pe = two_prod(xhi, lam_h)
        s, e = two_sum(s, p)
        comp = comp + (e + pe) + (lam_h * xlo + lam_l * xhi)
    # the TwoSum's sum is all of r_hi
    if out is None:
        return s + comp
    return torch.add(s, comp, out=out)
