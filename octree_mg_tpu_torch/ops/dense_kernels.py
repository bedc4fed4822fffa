"""Stencil kernels for dense uniform levels: plain PyTorch versions and
their hand-written CUDA kernels.

On uniform levels the box decomposition exists in the Fortran reference
only to serve MPI distribution and AMR (``m_load_balance.f90:1-3``); the
cells themselves form one dense rectangular grid.  Storing such levels
densely removes the per-box ghost ring and the materialized ghost-fill
passes between smoother half-sweeps (``smooth_boxes``,
m_multigrid.f90:404-424).

Layout: ``[Z+2*PZ, Y+2*PY, X]`` with PZ = PY = 8, x fastest and unpadded
(the layout of the JAX package's dense path, kept so that both packages
compare on identical shapes).  Pad contents are *garbage by contract*:
physical-boundary ghost values are synthesized inline from the Fortran
BC formula (ghost = c0*b + c1*x1 + c2*x2, m_ghost_cells.f90:682-698) at
the cells that read them.  Periodic wraps: the plain versions read the
y/z pad planes, which the caller keeps current with :func:`sync_pads`
(x wraps are exact rolls); the CUDA kernels read wrapped indices and
never touch a pad.  Every function returns fields whose pads are
uninitialized (``torch.empty``).

Six entry points, each a wrapper that runs its plain version for a CPU
tensor and launches its CUDA kernel (``csrc/*.cu``, built at first use)
for a CUDA tensor — or raises; there is no fallback on the card:

* ``pair_sweep_dense`` — ``n_pairs`` fused red+black GSRB pairs (K1).
* ``stencil_apply_dense`` — ``A(phi)`` or ``rhs - A(phi)`` (K1).
* ``downsweep_dense`` — pairs + residual + both restrictions (K2).
* ``residual_restrict_dense`` — residual + both restrictions (K2).

The first four also carry the variable-coefficient operators
(``cfg.n_eps`` 1 for vlaplacian/vhelmholtz, 3 for ahelmholtz): they
take ``eps=`` (``n_eps`` padded coefficient fields) and use the
harmonic-mean face coefficients ``2*e0*e_nb/(e0+e_nb)*idr2[d]``, with
Neumann-zero coefficient ghosts (ghost = the cell's own value) at
physical faces.  Their launches are counted under ``name[n_eps=k]``.
* ``restrict_dense`` — 2x2x2 full weighting (K3).
* ``prolong_correct_dense`` — ``phi_f += prolong(phi_c - iold_c)`` (K4),
  in place on ``phi_f``.

Kernel and plain version keep one arithmetic order, one rounding per
operation, so on the card they agree bitwise.  Scalars (``idr2``, BC
coefficients, ``lam``) are Python floats rounded to the working dtype at
the multiply; ``1/(den0+lam)`` is evaluated in the working dtype.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from . import _cuda_build

#: pad depths of the z and y axes (the x axis has none)
PZ = 8
PY = 8

_ISL = (slice(PZ, -PZ), slice(PY, -PY), slice(None))

#: launches per entry point since the last reset; a wrapper adds one
#: where it launches its kernel, and nowhere else
_LAUNCHES = {"pair_sweep_dense": 0, "stencil_apply_dense": 0,
             "downsweep_dense": 0, "residual_restrict_dense": 0,
             "restrict_dense": 0, "prolong_correct_dense": 0,
             "residual_df32_dense": 0}      # the wrapper lives in ops/df32
#: the entry points with coefficient variants, and their counter names
EPS_ENTRIES = ("pair_sweep_dense", "stencil_apply_dense", "downsweep_dense",
               "residual_restrict_dense")


def variant_name(name: str, n_eps: int) -> str:
    """Launch-counter name of an entry point's ``n_eps`` variant."""
    return name if not n_eps else f"{name}[n_eps={n_eps}]"


for _n in (1, 3):
    for _e in EPS_ENTRIES:
        _LAUNCHES[variant_name(_e, _n)] = 0


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def add_launch_counts(delta: dict) -> None:
    """Add the launches of a replayed CUDA graph: the wrappers counted
    them once, at capture, and a replay launches them all again."""
    for k, v in delta.items():
        _LAUNCHES[k] += v


def padded_shape(dims) -> Tuple[int, int, int]:
    X, Y, Z = int(dims[0]), int(dims[1]), int(dims[2])
    return (Z + 2 * PZ, Y + 2 * PY, X)


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


class DenseStencilConfig:
    """Static per-level kernel configuration.

    dims: (X, Y, Z) cell counts (dim order matches the tree's dr order,
    x fastest); idr2 likewise (x, y, z); bc: per direction nb=0..5
    (x-,x+,y-,y+,z-,z+) a (c0,c1,c2) tuple (ignored on periodic axes);
    b_const: per direction a static boundary value, or None when the
    value varies over the face (then a plane input is used);
    periodic: (px, py, pz); dtype: torch.float32 or torch.float64;
    n_eps: coefficient fields riding along with phi/rhs (0 = constant
    coefficients, 1 = cell-centred eps of vlaplacian/vhelmholtz, 3 =
    per-direction eps of ahelmholtz); eps_bc: per-face ghost synthesis
    of the coefficient fields, which only the AMR patch solvers set —
    not part of this package yet, so anything but None raises.
    """

    def __init__(self, dims, idr2, bc, periodic, dtype, b_const=None,
                 n_eps=0, eps_bc=None):
        if eps_bc is not None:
            raise NotImplementedError(
                "eps_bc: plane-valued coefficient ghosts belong to the "
                "dense-patch AMR solvers, still to be ported (ROADMAP A8)")
        if int(n_eps) not in (0, 1, 3):
            raise ValueError(f"n_eps must be 0, 1 or 3, got {n_eps}")
        self.n_eps = int(n_eps)
        self.X, self.Y, self.Z = int(dims[0]), int(dims[1]), int(dims[2])
        self.dims = (self.X, self.Y, self.Z)
        self.idr2 = tuple(float(v) for v in idr2)
        self.bc = [tuple(float(c) for c in t) for t in bc]
        self.periodic = tuple(bool(p) for p in periodic)
        if dtype not in _NP_DTYPE:
            raise TypeError(f"dense kernels take float32/float64, not {dtype}")
        self.dtype = dtype
        self.np_dtype = _NP_DTYPE[dtype]
        self.b_const = list(b_const) if b_const is not None else [None] * 6
        for i in range(6):
            if self.periodic[i // 2]:
                self.b_const[i] = 0.0
        self.plane_faces = [i for i in range(6) if self.b_const[i] is None]
        #: the fused down-leg kernel restricts inside its tile: all extents even
        self.even_dims = all(d % 2 == 0 for d in self.dims)
        #: red/black colouring is consistent across a periodic seam only
        #: for an even extent; a fused double pair relies on it (wrapped
        #: halo cells must carry the colour of their source cells)
        self.periodic_even = all(d % 2 == 0 or not p
                                 for d, p in zip(self.dims, self.periodic))
        # denominator accumulated exactly like the boxed smoother
        s = 0.0
        for d in range(3):
            s = s + 2.0 * self.idr2[d]
        self.den0 = s

    @property
    def pshape(self):
        return padded_shape(self.dims)

    def rnd(self, v) -> float:
        """v rounded to the working dtype, as a Python float."""
        return float(self.np_dtype(v))

    def inv_den(self, lam) -> float:
        """1/(den0 + lam): round den0, add, reciprocal, all in dtype."""
        t = self.np_dtype
        return float(t(1.0) / (t(self.den0) + t(lam)))

    def plane_shape(self, nb: int) -> Tuple[int, int]:
        """Padded shape of the boundary-value plane of face nb."""
        ZP, YP, X = self.pshape
        return ((ZP, YP), (ZP, YP), (ZP, X), (ZP, X), (YP, X), (YP, X))[nb]


def sync_pads(cfg: DenseStencilConfig, arr: torch.Tensor,
              depth: int = PZ) -> torch.Tensor:
    """Periodic wrap maintenance of the z/y pad planes, IN PLACE (x wraps
    are rolls / wrapped indices and need none).  No-op on non-periodic
    axes.  Depth is clamped to the extent."""
    X, Y, Z = cfg.dims
    if cfg.periodic[2]:
        d = min(depth, Z)
        arr[PZ - d:PZ] = arr[Z + PZ - d:Z + PZ]
        arr[Z + PZ:Z + PZ + d] = arr[PZ:PZ + d]
    if cfg.periodic[1]:
        d = min(depth, Y)
        arr[:, PY - d:PY] = arr[:, Y + PY - d:Y + PY]
        arr[:, Y + PY:Y + PY + d] = arr[:, PY:PY + d]
    return arr


# ---------------------------------------------------------------------------
# plain PyTorch versions (identical computation over the whole padded array)
# ---------------------------------------------------------------------------

def _full_iotas(cfg, device):
    """Broadcastable per-axis global-coordinate iotas of the padded array
    (negative in the low pads)."""
    ZP, YP, X = cfg.pshape
    gz = (torch.arange(ZP, device=device) - PZ).view(ZP, 1, 1)
    gy = (torch.arange(YP, device=device) - PY).view(1, YP, 1)
    gx = torch.arange(X, device=device).view(1, 1, X)
    return gx, gy, gz


def _face_masks(cfg, gcoords):
    """Boundary masks per non-periodic dim, shared by all sweeps."""
    masks = {}
    for d in range(3):
        if cfg.periodic[d]:
            masks[d] = None
            continue
        g = gcoords[d]
        masks[d] = (g == 0, g == cfg.dims[d] - 1)
    return masks


def _parity_mask(gcoords, red_parity: int):
    """Boolean "cell parity == red parity" mask.  ``& 1`` and not ``%``:
    the coordinates are negative in the pads."""
    gx, gy, gz = gcoords
    pyx = (gy + gx) & 1
    pz = gz & 1
    return (pyx != pz) if red_parity == 1 else (pyx == pz)


def _bpw_full(cfg, bplanes):
    """Boundary values broadcast against the full padded array."""
    out = []
    for i in range(6):
        if cfg.b_const[i] is not None:
            out.append(cfg.b_const[i])
        elif i < 2:    # x faces: [ZP, YP]
            out.append(bplanes[i][:, :, None])
        elif i < 4:    # y faces: [ZP, X]
            out.append(bplanes[i][:, None, :])
        else:          # z faces: [YP, X]
            out.append(bplanes[i][None, :, :])
    return out


def _neighbor_ops(cfg, p, d, axis, masks, bpw):
    """(lo, hi) neighbor-value arrays along dim d with inline BC synth.

    bpw: per direction the boundary value (Python float or a tensor
    broadcast to the array shape); masks: from :func:`_face_masks`."""
    lo_raw = torch.roll(p, +1, axis)
    hi_raw = torch.roll(p, -1, axis)
    if masks[d] is None:
        # periodic: x wraps are exact rolls; z/y wraps come from the
        # caller-maintained pad planes, and the roll's own wraparound
        # lands only in pad rows whose results are never consumed
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


def _eps_neighbor_ops(e, d, axis, masks):
    """(lo, hi) neighbour values of a coefficient field along dim d:
    Neumann-zero physical ghosts (m_vlaplacian.f90:25-28,
    m_ahelmholtz.f90:28-41), i.e. at a physical face the neighbour value
    IS the cell's own value; periodic axes read the wrapped neighbour
    (the roll, or the caller-synced pad planes)."""
    lo_raw = torch.roll(e, +1, axis)
    hi_raw = torch.roll(e, -1, axis)
    if masks[d] is None:
        return lo_raw, hi_raw
    m_lo, m_hi = masks[d]
    return torch.where(m_lo, e, lo_raw), torch.where(m_hi, e, hi_raw)


_DIM_AXIS = ((0, 2), (1, 1), (2, 0))   # dim x,y,z -> array axis


def _face_coeffs(cfg, eps, d, axis, masks):
    """The two harmonic-mean face coefficients of dim d,
    ``((2*e0)*e_nb)/(e0 + e_nb)*idr2[d]`` for the low and the high
    neighbour; dim d reads eps[0] (n_eps 1) or eps[d] (n_eps 3)."""
    e0 = eps[0] if cfg.n_eps == 1 else eps[d]
    elo, ehi = _eps_neighbor_ops(e0, d, axis, masks)
    idr2 = cfg.rnd(cfg.idr2[d])
    return (2.0 * e0 * elo / (e0 + elo) * idr2,
            2.0 * e0 * ehi / (e0 + ehi) * idr2)


def _halfsweep(cfg, p, rhs_w, lam, masks, upd, red, bpw, eps=()):
    """One masked GSRB half-sweep over the array (constant coefficient,
    m_laplacian.f90 / m_helmholtz.f90 arithmetic order; with eps the
    harmonic-mean form of m_vlaplacian.f90:51-128 /
    m_ahelmholtz.f90:69-162: new = num / den, num = -rhs + sum c*nbr,
    den = lam + sum c, accumulated per dim x, y, z, low side first).

    upd: boolean "parity == red parity" mask; red=True updates those
    cells, red=False the complement (same mask, swapped select arms)."""
    if cfg.n_eps:
        num = -rhs_w
        den = cfg.rnd(lam)
        for d, axis in _DIM_AXIS:
            c_lo, c_hi = _face_coeffs(cfg, eps, d, axis, masks)
            lo, hi = _neighbor_ops(cfg, p, d, axis, masks, bpw)
            num = num + c_lo * lo
            den = den + c_lo
            num = num + c_hi * hi
            den = den + c_hi
        new = num / den
        return torch.where(upd, new, p) if red else torch.where(upd, p, new)
    acc = -rhs_w
    for d, axis in _DIM_AXIS:
        lo, hi = _neighbor_ops(cfg, p, d, axis, masks, bpw)
        acc = acc + cfg.rnd(cfg.idr2[d]) * (lo + hi)
    new = acc * cfg.inv_den(lam)
    return torch.where(upd, new, p) if red else torch.where(upd, p, new)


def _apply_expr(cfg, p, lam, masks, bpw, eps=()):
    """A(phi) over the array: out = -lam*c; out += idr2[d]*(lo+hi-2c),
    or with eps out += c_lo*(lo - c) + c_hi*(hi - c) per dim."""
    out = (-cfg.rnd(lam)) * p
    if cfg.n_eps:
        for d, axis in _DIM_AXIS:
            c_lo, c_hi = _face_coeffs(cfg, eps, d, axis, masks)
            lo, hi = _neighbor_ops(cfg, p, d, axis, masks, bpw)
            out = out + c_lo * (lo - p)
            out = out + c_hi * (hi - p)
        return out
    for d, axis in _DIM_AXIS:
        lo, hi = _neighbor_ops(cfg, p, d, axis, masks, bpw)
        out = out + cfg.rnd(cfg.idr2[d]) * (lo + hi - 2.0 * p)
    return out


def _pair_plain(cfg, phi, rhs, lam, bplanes, red_parity, eps=()):
    g = _full_iotas(cfg, phi.device)
    masks = _face_masks(cfg, g)
    upd = _parity_mask(g, red_parity)
    bpw = _bpw_full(cfg, bplanes)
    p1 = _halfsweep(cfg, phi, rhs, lam, masks, upd, True, bpw, eps)
    return _halfsweep(cfg, p1, rhs, lam, masks, upd, False, bpw, eps)


def _pairs_plain(cfg, phi, rhs, lam, bplanes, red_parity, n_pairs, eps=()):
    """n_pairs single pairs with the periodic pads re-synced between
    (what a fused multi-pair kernel computes in one pass).  CPU callers
    keep the periodic pads of the eps fields current."""
    for k in range(n_pairs):
        if k:
            sync_pads(cfg, phi)
        phi = _pair_plain(cfg, phi, rhs, lam, bplanes, red_parity, eps)
    return phi


def _apply_plain(cfg, phi, rhs, lam, bplanes, residual, eps=()):
    g = _full_iotas(cfg, phi.device)
    masks = _face_masks(cfg, g)
    out = _apply_expr(cfg, phi, lam, masks, _bpw_full(cfg, bplanes), eps)
    return rhs - out if residual else out


def _restrict_plain(cfg_f, fine):
    """Full weighting in the reference's order: (z0+z1), then + y
    neighbour, then + x neighbour, then / 8."""
    core = fine[_ISL]
    t = core[0::2] + core[1::2]
    t = t[:, 0::2] + t[:, 1::2]
    t = t[:, :, 0::2] + t[:, :, 1::2]
    X, Y, Z = cfg_f.dims
    out = torch.empty(padded_shape((X // 2, Y // 2, Z // 2)),
                      dtype=fine.dtype, device=fine.device)
    out[_ISL] = t / 8.0
    return out


def _down_plain(cfg, phi, rhs, lam, bplanes, red_parity, n_pairs, eps=()):
    if n_pairs:
        phi = _pairs_plain(cfg, phi, rhs, lam, bplanes, red_parity, n_pairs,
                           eps)
        sync_pads(cfg, phi)
    res = _apply_plain(cfg, phi, rhs, lam, bplanes, True, eps)
    return phi, _restrict_plain(cfg, phi), _restrict_plain(cfg, res)


def _prolong_correct_plain(cfg_c, phi_c, iold_c, phi_f, bplanes_c):
    g = _full_iotas(cfg_c, phi_c.device)
    masks = _face_masks(cfg_c, g)
    bpw = _bpw_full(cfg_c, bplanes_c)
    corr = phi_c - iold_c
    # neighbor values of corr with ghost semantics: synth(phi) -
    # synth(iold) at physical faces (the c0*b terms cancel only
    # mathematically, so both synths are evaluated)
    lo, hi = {}, {}
    for d, axis in _DIM_AXIS:
        lop, hip = _neighbor_ops(cfg_c, phi_c, d, axis, masks, bpw)
        loi, hii = _neighbor_ops(cfg_c, iold_c, d, axis, masks, bpw)
        lo[d] = (lop - loi)[_ISL]
        hi[d] = (hip - hii)[_ISL]
    # mg_prolong_sparse parity values; bit d of the key = high child
    # along dim d
    vals = {0: 0.25 * corr[_ISL]}
    for d in range(3):
        new = {}
        for key, a in vals.items():
            new[key] = a + 0.25 * lo[d]
            new[key | (1 << d)] = a + 0.25 * hi[d]
        vals = new
    core_f = phi_f[_ISL]
    for bits, v in vals.items():
        bx, by, bz = bits & 1, (bits >> 1) & 1, (bits >> 2) & 1
        core_f[bz::2, by::2, bx::2] += v
    return phi_f


# ---------------------------------------------------------------------------
# CUDA launch plumbing
# ---------------------------------------------------------------------------

class _LevelParams(ctypes.Structure):
    """Mirror of ``LevelParams`` in csrc/stencil_common.cuh."""
    _fields_ = [("X", ctypes.c_int), ("Y", ctypes.c_int), ("Z", ctypes.c_int),
                ("per", ctypes.c_int * 3),
                ("red_parity", ctypes.c_int), ("n_sweeps", ctypes.c_int),
                ("idr2", ctypes.c_double * 3),
                ("neg_lam", ctypes.c_double), ("inv_den", ctypes.c_double),
                ("c0", ctypes.c_double * 6), ("c1", ctypes.c_double * 6),
                ("c2", ctypes.c_double * 6), ("c0b", ctypes.c_double * 6),
                ("plane", ctypes.c_void_p * 6)]


class _EpsParams(ctypes.Structure):
    """Mirror of ``EpsParams`` in csrc/stencil_common.cuh."""
    _fields_ = [("n", ctypes.c_int), ("f", ctypes.c_void_p * 3)]


def _check_field(cfg, t, name, shape=None):
    shape = tuple(cfg.pshape if shape is None else shape)
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor beside the others")
    if t.dtype != cfg.dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, config has {cfg.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def _check_eps(cfg, eps, what):
    """The coefficient fields of a call: exactly cfg.n_eps of them, of
    the config's dtype and padded shape (on the card the launch checks
    their device and layout too)."""
    eps = tuple(eps)
    if len(eps) != cfg.n_eps:
        raise ValueError(f"{what}: {len(eps)} coefficient fields given, the "
                         f"config has n_eps={cfg.n_eps}")
    for i, e in enumerate(eps):
        if e.dtype != cfg.dtype:
            raise TypeError(f"{what}: eps[{i}] dtype {e.dtype}, config has "
                            f"{cfg.dtype}")
        if tuple(e.shape) != tuple(cfg.pshape):
            raise ValueError(f"{what}: eps[{i}] shape {tuple(e.shape)}, "
                             f"expected {cfg.pshape}")
    return eps


def _eps_params(cfg, eps) -> _EpsParams:
    E = _EpsParams()
    E.n = len(eps)
    for i, e in enumerate(eps):
        _check_field(cfg, e, f"eps[{i}]")
        E.f[i] = e.data_ptr()
    return E


def _params(cfg, lam, bplanes, red_parity=0, n_sweeps=0) -> _LevelParams:
    P = _LevelParams()
    P.X, P.Y, P.Z = cfg.dims
    P.red_parity, P.n_sweeps = int(red_parity), int(n_sweeps)
    for d in range(3):
        P.per[d] = int(cfg.periodic[d])
        P.idr2[d] = cfg.rnd(cfg.idr2[d])
    P.neg_lam = -cfg.rnd(lam)
    P.inv_den = cfg.inv_den(lam)
    for i in range(6):
        c0, c1, c2 = cfg.bc[i]
        P.c0[i], P.c1[i], P.c2[i] = cfg.rnd(c0), cfg.rnd(c1), cfg.rnd(c2)
        if cfg.b_const[i] is not None:
            # the product of two host scalars is taken in double and
            # rounded once, exactly as the plain version's c0 * b
            P.c0b[i] = cfg.rnd(c0 * cfg.b_const[i])
            P.plane[i] = None
        else:
            _check_field(cfg, bplanes[i], f"bplanes[{i}]", cfg.plane_shape(i))
            P.c0b[i] = 0.0
            P.plane[i] = bplanes[i].data_ptr()
    return P


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


_VP = ctypes.c_void_p
_ARGTYPES = {
    "omg_stencil_sweep": [ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(_LevelParams),
                          ctypes.POINTER(_EpsParams), _VP, _VP, _VP, _VP],
    "omg_downsweep": [ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(_LevelParams),
                      ctypes.POINTER(_EpsParams), _VP, _VP, _VP, _VP, _VP,
                      _VP],
    "omg_restrict": [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     _VP, _VP, _VP],
    "omg_prolong_correct": [ctypes.c_int, ctypes.POINTER(_LevelParams), _VP,
                            _VP, _VP, _VP],
}
_fns = {}


def _fn(source: str, symbol: str):
    f = _fns.get(symbol)
    if f is None:
        f = getattr(_cuda_build.load(source), symbol)
        f.argtypes = _ARGTYPES[symbol]
        f.restype = ctypes.c_int
        _fns[symbol] = f
    return f


def _dt(cfg) -> int:
    return 0 if cfg.dtype == torch.float32 else 1


_MODE_PAIRS, _MODE_APPLY, _MODE_RESIDUAL = 0, 1, 2


def _coarse_empty(cfg, like):
    return torch.empty(padded_shape((cfg.X // 2, cfg.Y // 2, cfg.Z // 2)),
                       dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def pair_sweep_dense(cfg: DenseStencilConfig, phi, rhs, lam, bplanes,
                     red_parity: int, n_pairs: int = 1, eps=()):
    """Fused [red half-sweep, ghost refresh, black half-sweep] x n_pairs.

    phi/rhs: padded_shape(dims); lam: host scalar; bplanes: 6 padded
    boundary-value planes (only plane-valued faces are read).
    red_parity: global (gx+gy+gz)%2 value updated by the red sweep.
    Returns new phi with garbage pads; the inputs are left as they are.

    n_pairs=2 is two full GSRB iterations (4 half-sweeps): identical per
    cell to two single pairs with a pad re-sync between.  On CUDA it is
    one pass over device memory with a 4-deep halo.  CPU tensors need
    their periodic pads current (:func:`sync_pads`), eps fields too.
    eps: cfg.n_eps padded coefficient fields."""
    eps = _check_eps(cfg, eps, "pair_sweep_dense")
    if n_pairs not in (1, 2):
        raise ValueError("pair_sweep_dense: n_pairs must be 1 or 2")
    if n_pairs == 2 and not cfg.periodic_even:
        raise ValueError(f"pair_sweep_dense: a double pair needs even extents "
                         f"on periodic axes, got {cfg.dims}; run single pairs")
    if not phi.is_cuda:
        return _pairs_plain(cfg, phi, rhs, lam, bplanes, red_parity, n_pairs,
                            eps)
    _check_field(cfg, phi, "phi")
    _check_field(cfg, rhs, "rhs")
    P = _params(cfg, lam, bplanes, red_parity, 2 * n_pairs)
    E = _eps_params(cfg, eps)
    out = torch.empty_like(phi)
    err = _fn("stencil_sweep", "omg_stencil_sweep")(
        _dt(cfg), _MODE_PAIRS, ctypes.byref(P), ctypes.byref(E),
        phi.data_ptr(), rhs.data_ptr(), out.data_ptr(), _stream(phi))
    _raise_on(err, "pair_sweep_dense")
    _LAUNCHES[variant_name("pair_sweep_dense", cfg.n_eps)] += 1
    return out


def stencil_apply_dense(cfg: DenseStencilConfig, phi, rhs, lam, bplanes,
                        residual: bool, eps=()):
    """A(phi) (or rhs - A(phi)) in one pass (box_lpl/box_helmh +
    residual_box, m_multigrid.f90:426-436; with eps box_vlpl/box_vhelmh/
    box_ahelmh).  Returns a new field."""
    eps = _check_eps(cfg, eps, "stencil_apply_dense")
    if not phi.is_cuda:
        return _apply_plain(cfg, phi, rhs, lam, bplanes, residual, eps)
    _check_field(cfg, phi, "phi")
    _check_field(cfg, rhs, "rhs")
    P = _params(cfg, lam, bplanes)
    E = _eps_params(cfg, eps)
    out = torch.empty_like(phi)
    err = _fn("stencil_sweep", "omg_stencil_sweep")(
        _dt(cfg), _MODE_RESIDUAL if residual else _MODE_APPLY,
        ctypes.byref(P), ctypes.byref(E), phi.data_ptr(), rhs.data_ptr(), out.data_ptr(),
        _stream(phi))
    _raise_on(err, "stencil_apply_dense")
    _LAUNCHES[variant_name("stencil_apply_dense", cfg.n_eps)] += 1
    return out


def _downsweep(name, cfg, phi, rhs, lam, bplanes, red_parity, n_pairs,
               fine_out, eps):
    eps = _check_eps(cfg, eps, name)
    if not cfg.even_dims:
        raise ValueError(f"{name}: every extent must be even, got {cfg.dims}")
    if not phi.is_cuda:
        return _down_plain(cfg, phi, rhs, lam, bplanes, red_parity, n_pairs,
                           eps)
    _check_field(cfg, phi, "phi")
    _check_field(cfg, rhs, "rhs")
    P = _params(cfg, lam, bplanes, red_parity, 2 * n_pairs)
    E = _eps_params(cfg, eps)
    phi_out = torch.empty_like(phi) if fine_out else None
    phi_c, ires_c = _coarse_empty(cfg, phi), _coarse_empty(cfg, phi)
    err = _fn("downsweep", "omg_downsweep")(
        _dt(cfg), int(fine_out), ctypes.byref(P), ctypes.byref(E),
        phi.data_ptr(),
        rhs.data_ptr(), phi_out.data_ptr() if fine_out else None,
        phi_c.data_ptr(), ires_c.data_ptr(), _stream(phi))
    _raise_on(err, name)
    _LAUNCHES[variant_name(name, cfg.n_eps)] += 1
    return phi_out, phi_c, ires_c


def downsweep_dense(cfg: DenseStencilConfig, phi, rhs, lam, bplanes,
                    red_parity: int, n_pairs: int = 2, eps=()):
    """Fused V-cycle down-leg: n_pairs GSRB pairs, residual, and
    full-weighting restriction of BOTH phi and the residual
    (smooth_boxes + update_coarse's residual/restrict,
    m_multigrid.f90:347-384,404-424).

    Returns (phi_new, phi_coarse, ires_coarse) — the coarse arrays are
    padded_shape(dims/2) with garbage pads.  Requires even extents.
    Identical per cell to [pair_sweep_dense(n_pairs),
    stencil_apply_dense(residual), restrict_dense x2]."""
    if n_pairs not in (1, 2):
        raise ValueError("downsweep_dense: n_pairs must be 1 or 2")
    return _downsweep("downsweep_dense", cfg, phi, rhs, lam, bplanes,
                      red_parity, n_pairs, True, eps)


def residual_restrict_dense(cfg: DenseStencilConfig, phi, rhs, lam, bplanes,
                            eps=()):
    """Fused plain update_coarse: residual + full-weighting restriction
    of BOTH phi and the residual, with NO full-size output
    (m_multigrid.f90:347-384 minus the smoothing).  Returns
    (phi_coarse, ires_coarse)."""
    _, phi_c, ires_c = _downsweep("residual_restrict_dense", cfg, phi, rhs,
                                  lam, bplanes, 0, 0, False, eps)
    return phi_c, ires_c


def restrict_dense(cfg_f: DenseStencilConfig, fine):
    """Full-weighting restriction (m_restrict.f90:183-194): fine padded
    -> new coarse padded (garbage pads).  Requires even extents."""
    if not cfg_f.even_dims:
        raise ValueError(f"restrict_dense: odd extent in {cfg_f.dims}")
    if not fine.is_cuda:
        return _restrict_plain(cfg_f, fine)
    _check_field(cfg_f, fine, "fine")
    coarse = _coarse_empty(cfg_f, fine)
    err = _fn("restrict", "omg_restrict")(
        _dt(cfg_f), cfg_f.X // 2, cfg_f.Y // 2, cfg_f.Z // 2,
        fine.data_ptr(), coarse.data_ptr(), _stream(fine))
    _raise_on(err, "restrict_dense")
    _LAUNCHES["restrict_dense"] += 1
    return coarse


def prolong_correct_dense(cfg_c: DenseStencilConfig, phi_c, iold_c, phi_f,
                          bplanes_c):
    """Fused correct_children (m_multigrid.f90:387-402): corr = phi_c -
    iold_c with ghost-ring semantics (BC synthesis / periodic wraps),
    mg_prolong_sparse D-linear weights (m_prolong.f90:159-240), added
    into phi_f IN PLACE (the JAX package returns a new array instead;
    its buffer is donated there).  Returns phi_f.

    Only this mode (add=True, corr_ready=False) exists here; the set
    mode and the ready-made-correction mode of the JAX package wait.
    CPU tensors need the periodic pads of phi_c and iold_c current."""
    X, Y, Z = cfg_c.dims
    shape_f = padded_shape((2 * X, 2 * Y, 2 * Z))
    if tuple(phi_f.shape) != shape_f:
        raise ValueError(f"phi_f: shape {tuple(phi_f.shape)}, expected "
                         f"{shape_f}")
    if not phi_c.is_cuda:
        return _prolong_correct_plain(cfg_c, phi_c, iold_c, phi_f, bplanes_c)
    _check_field(cfg_c, phi_c, "phi_c")
    _check_field(cfg_c, iold_c, "iold_c")
    _check_field(cfg_c, phi_f, "phi_f", shape_f)
    P = _params(cfg_c, 0.0, bplanes_c)
    err = _fn("prolong_correct", "omg_prolong_correct")(
        _dt(cfg_c), ctypes.byref(P), phi_c.data_ptr(), iold_c.data_ptr(),
        phi_f.data_ptr(), _stream(phi_c))
    _raise_on(err, "prolong_correct_dense")
    _LAUNCHES["prolong_correct_dense"] += 1
    return phi_f
