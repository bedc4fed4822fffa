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

Seven entry points, each a wrapper that runs its plain version for a CPU
tensor and launches its CUDA kernel (``csrc/*.cu``, built at first use)
for a CUDA tensor — or raises; there is no fallback on the card:

* ``pair_sweep_dense`` — ``n_pairs`` fused red+black GSRB pairs (K1).
* ``half_sweep_dense`` — one GSRB half-sweep of a given parity (K1 with
  one half-sweep; the dense forest's sequential smoother).
* ``stencil_apply_dense`` — ``A(phi)`` or ``rhs - A(phi)`` (K1).
* ``downsweep_dense`` — pairs + residual + both restrictions (K2).
* ``residual_restrict_dense`` — residual + both restrictions (K2).

``pair_sweep_dense`` and ``stencil_apply_dense`` also take a dense-forest
canvas's ghost layers (``segs``/``seg_planes``, the fused-canvas path):
then no physical-face synthesis runs, x wraps, a y or z read outside the
canvas is zero, and a reader next to a ghost layer substitutes
``(a0 + a1*x1) + a2*x2`` from the layer's planes (``seg_sweep.cu``;
launches counted under ``name[segs]``).  In float32 the double pair runs
the wide design (csrc/stream_wide.cuh) on canvases of 256^3 and up, also
counted under ``pair_sweep_dense[segs][wide]``, and the apply and the
residual the face-plane apply (csrc/apply_faces.cuh) on every canvas,
also counted under ``stencil_apply_dense[segs][faces]``; the rest runs
csrc/stream_kernel.cuh.

The first four also carry the variable-coefficient operators
(``cfg.n_eps`` 1 for vlaplacian/vhelmholtz, 3 for ahelmholtz): they
take ``eps=`` (``n_eps`` padded coefficient fields) and use the
harmonic-mean face coefficients ``2*e0*e_nb/(e0+e_nb)*idr2[d]``, with
Neumann-zero coefficient ghosts (ghost = the cell's own value) at
physical faces.  Their launches are counted under ``name[n_eps=k]``.
* ``restrict_dense`` — 2x2x2 full weighting (K3).
* ``prolong_correct_dense`` — ``phi_f += prolong(phi_c - iold_c)`` (K4),
  in place on ``phi_f``; or ``phi_f += prolong(phi_c)`` (``corr_ready``,
  the forest's correction) or ``phi_f = prolong(phi_c)`` (``add=False``),
  counted under ``prolong_correct_dense[corr_ready]`` / ``[set]``.

The z-slab solver (solve/dense_shard.py) passes ``z_gates`` to
``pair_sweep_dense``, ``stencil_apply_dense`` and ``prolong_correct_dense``
(and ops/df32's ``residual_df32_dense``): a ``(lo, hi)`` pair of bools
saying which z faces of the level, one slab of a larger domain, are
physical faces it owns.  Only those synthesize their BC ghost; every
other z neighbour beyond the slab, on a periodic z axis too, is read from
the z pads, which the caller's halo exchange filled with the neighbour
slabs' planes (the JAX package's ``_face_masks`` with ``zgates``).  On
the card these calls launch the slab variants of the kernels
(``SlabParams``, csrc/stencil_common.cuh), counted under
``name[z_gates]`` (``name[n_eps=k][z_gates]`` for the coefficient
variants); a slab double pair on the wide design (below) is counted
under ``pair_sweep_dense[z_gates][wide]`` as well, a constant-coefficient
slab apply or residual on the face-plane apply (below) under
``stencil_apply_dense[z_gates][faces]``, a coefficient slab launch on a
face-plane design under ``name[n_eps=k][z_gates][faces]``, and a slab
prolongation on the
pair kernel of csrc/prolong_correct.cu (every slab, both dtypes) under
``prolong_correct_dense[z_gates][pair]``.  ``half_sweep_dense``, ``downsweep_dense`` and
``residual_restrict_dense`` take no gates: the JAX package never calls
them with any.

The double pair and the down-leg run one of three kernel designs, which
the library picks by level size, dtype, ``n_eps`` and SM count:
csrc/stream_wide.cuh for constant coefficients on large levels (and for
the slab double pair on large slabs), csrc/stream_faces.cuh for the
coefficient variants on every float32 level and slab,
csrc/stream_kernel.cuh for the rest.  The apply and the residual run one
of two: csrc/apply_faces.cuh for the coefficient variants on every level
in both dtypes and on every float32 slab, and for the large float32
constant-coefficient slabs, csrc/stream_kernel.cuh for
the rest; ``residual_restrict_dense``
runs csrc/apply_faces.cuh on every launch, constant coefficients
included.  Both face-plane designs build each harmonic-mean face once
per plane, where stream_kernel.cuh builds a cell's six from the
coefficients of the cell and its neighbours at every update; they were
faster at every level they take, and so was the face-plane apply without
coefficients for the residual-restriction (PERF.md).  The library
reports which design a launch ran; a launch of the wide one is counted
under ``name[wide]`` as well, one of a face-plane one under
``name[n_eps=k][faces]`` (``residual_restrict_dense[faces]`` without
coefficients).  One half-sweep runs a register march (csrc/stencil_sweep.cu:
no shared memory, no barrier), every launch counted under
``half_sweep_dense[march]`` as well.

The dense-patch AMR solver's levels with refinement faces and
coefficient fields carry ``eps_bc`` (plane-valued coefficient ghosts,
``eps_planes=``): the pair, the half-sweep and the apply run their plain
versions for such a config on every device, as the JAX package runs its
jnp path for it, counted by :func:`plain_route_counts` and never as a
launch; the down-leg and the residual-restriction refuse it (the JAX
package's fused transfers never see one).

Kernel and plain version keep one arithmetic order, one rounding per
operation, so on the card they agree bitwise.  Scalars (``idr2``, BC
coefficients, ``lam``) are Python floats rounded to the working dtype at
the multiply; ``1/(den0+lam)`` is evaluated in the working dtype.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _cuda_build

#: pad depths of the z and y axes (the x axis has none)
PZ = 8
PY = 8

_ISL = (slice(PZ, -PZ), slice(PY, -PY), slice(None))

#: launches per entry point since the last reset; a wrapper adds one
#: where it launches its kernel (through record_launch), and nowhere else
_LAUNCHES = {"pair_sweep_dense": 0, "stencil_apply_dense": 0,
             "downsweep_dense": 0, "residual_restrict_dense": 0,
             "restrict_dense": 0, "prolong_correct_dense": 0,
             "residual_df32_dense": 0,
             "half_sweep_dense": 0,
             "pair_sweep_dense[segs]": 0, "stencil_apply_dense[segs]": 0,
             "pair_sweep_dense[segs][wide]": 0,
             "stencil_apply_dense[segs][faces]": 0,
             "prolong_correct_dense[set]": 0,
             "prolong_correct_dense[corr_ready]": 0,
             "half_sweep_flat": 0,
             "pair_sweep_dense[wide]": 0, "downsweep_dense[wide]": 0}
#: the entry points with coefficient variants, and their counter names
EPS_ENTRIES = ("pair_sweep_dense", "stencil_apply_dense", "downsweep_dense",
               "residual_restrict_dense")


def variant_name(name: str, n_eps: int) -> str:
    """Launch-counter name of an entry point's ``n_eps`` variant."""
    return name if not n_eps else f"{name}[n_eps={n_eps}]"


#: the entry points with z-slab variants (z_gates)
SLAB_ENTRIES = ("pair_sweep_dense", "stencil_apply_dense",
                "prolong_correct_dense", "residual_df32_dense")


def slab_name(name: str, n_eps: int = 0) -> str:
    """Launch-counter name of an entry point's z-slab variant."""
    return variant_name(name, n_eps) + "[z_gates]"


for _n in (1, 3):
    for _e in EPS_ENTRIES:
        _LAUNCHES[variant_name(_e, _n)] = 0
for _e in SLAB_ENTRIES:
    _LAUNCHES[slab_name(_e)] = 0
for _n in (1, 3):
    for _e in SLAB_ENTRIES[:2]:
        _LAUNCHES[slab_name(_e, _n)] = 0
#: the entry points with face-plane variants (csrc/stream_faces.cuh for
#: the double pair and the down-leg, csrc/apply_faces.cuh for the apply,
#: the residual and the residual-restriction)
FACE_ENTRIES = ("pair_sweep_dense", "downsweep_dense", "stencil_apply_dense",
                "residual_restrict_dense")


def faces_name(name: str, n_eps: int) -> str:
    """Launch-counter name of a launch of the face-plane design."""
    return variant_name(name, n_eps) + "[faces]"


for _n in (1, 3):
    for _e in FACE_ENTRIES:
        _LAUNCHES[faces_name(_e, _n)] = 0
#: the constant-coefficient residual-restriction runs the face-plane apply
#: too (csrc/apply_faces.cuh, with no coefficients)
_LAUNCHES[faces_name("residual_restrict_dense", 0)] = 0
#: a slab double pair on the wide design (csrc/stream_wide.cuh)
_LAUNCHES[slab_name("pair_sweep_dense") + "[wide]"] = 0
#: a slab apply or residual on the face-plane apply (csrc/apply_faces.cuh),
#: and a coefficient slab launch on a face-plane design (the double pair
#: on csrc/stream_faces.cuh, the apply and residual on csrc/apply_faces.cuh)
_LAUNCHES[slab_name("stencil_apply_dense") + "[faces]"] = 0
for _n in (1, 3):
    for _e in SLAB_ENTRIES[:2]:
        _LAUNCHES[slab_name(_e, _n) + "[faces]"] = 0
#: a slab prolongation on the pair kernel (csrc/prolong_correct.cu)
_LAUNCHES[slab_name("prolong_correct_dense") + "[pair]"] = 0
#: one half-sweep on the register march (csrc/stencil_sweep.cu)
_LAUNCHES["half_sweep_dense[march]"] = 0
#: a double-float residual on the z-march (csrc/residual_df32.cu), on a
#: level and on a slab
_LAUNCHES["residual_df32_dense[march]"] = 0
_LAUNCHES[slab_name("residual_df32_dense") + "[march]"] = 0


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


#: calls that ran the plain versions whatever the device because their
#: config carries ``eps_bc`` (the JAX package's jnp path for such configs,
#: ``use_kernel = False``); not kernel launches, and kept apart from them
_PLAIN_ROUTE = {"pair_sweep_dense[eps_bc]": 0, "half_sweep_dense[eps_bc]": 0,
                "stencil_apply_dense[eps_bc]": 0}


def plain_route_counts() -> dict:
    return dict(_PLAIN_ROUTE)


def reset_plain_route_counts() -> None:
    for k in _PLAIN_ROUTE:
        _PLAIN_ROUTE[k] = 0


def _plain_route(cfg, name: str, eps_planes) -> bool:
    """Whether a call takes the plain route (its config carries eps_bc),
    counted here; eps_planes belong to such configs only."""
    if cfg.eps_bc is None:
        if eps_planes is not None:
            raise ValueError(f"{name}: eps_planes need a config with eps_bc")
        return False
    _PLAIN_ROUTE[name + "[eps_bc]"] += 1
    return True


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
    per-direction eps of ahelmholtz); eps_bc: per face a (c0, c1, c2)
    ghost synthesis of the coefficient fields, or None for the
    reference's Neumann-zero default (ghost = own value,
    m_vlaplacian.f90:25-28).  The dense-patch AMR solver sets it on
    levels with refinement faces: there the sides_rb combination (0.5,
    0.75, -0.25) with a plane-valued b (the coarse interpolation of the
    coefficient field, ``eps_planes=``), (0, 1, 0) on physical faces.  A
    config with eps_bc runs the plain versions on every device, as the
    JAX package runs its jnp path for it (the plain route, counted by
    :func:`plain_route_counts`).
    """

    def __init__(self, dims, idr2, bc, periodic, dtype, b_const=None,
                 n_eps=0, eps_bc=None):
        if int(n_eps) not in (0, 1, 3):
            raise ValueError(f"n_eps must be 0, 1 or 3, got {n_eps}")
        if eps_bc is not None:
            if not n_eps or len(eps_bc) != 6:
                raise ValueError("eps_bc: six (c0, c1, c2) faces of a "
                                 "config with coefficient fields")
            eps_bc = [tuple(float(c) for c in t) for t in eps_bc]
        #: per-face coefficient-field ghost synthesis, or None
        self.eps_bc = eps_bc
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
              depth: int = PZ, slab: bool = False) -> torch.Tensor:
    """Periodic wrap maintenance of the z/y pad planes, IN PLACE (x wraps
    are rolls / wrapped indices and need none).  No-op on non-periodic
    axes.  Depth is clamped to the extent.  slab: arr is a z-slab, or a
    stack of them [K, ...], whose z pads are the halo the caller
    exchanges: the y pads only."""
    X, Y, Z = cfg.dims
    if cfg.periodic[2] and not slab:
        d = min(depth, Z)
        arr[PZ - d:PZ] = arr[Z + PZ - d:Z + PZ]
        arr[Z + PZ:Z + PZ + d] = arr[PZ:PZ + d]
    if cfg.periodic[1]:
        d = min(depth, Y)
        arr[..., PY - d:PY, :] = arr[..., Y + PY - d:Y + PY, :]
        arr[..., Y + PY:Y + PY + d, :] = arr[..., PY:PY + d, :]
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


def _face_masks(cfg, gcoords, z_gates=None):
    """Boundary masks per non-periodic dim, shared by all sweeps.
    z_gates: a z-slab's (lo, hi) bools, ANDed into the z-face masks: a
    face it does not own reads its pad planes (the halo)."""
    masks = {}
    for d in range(3):
        if cfg.periodic[d]:
            masks[d] = None
            continue
        g = gcoords[d]
        m_lo, m_hi = g == 0, g == cfg.dims[d] - 1
        if d == 2 and z_gates is not None:
            m_lo = m_lo & bool(z_gates[0])
            m_hi = m_hi & bool(z_gates[1])
        masks[d] = (m_lo, m_hi)
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


def _neighbor_ops(cfg, p, d, axis, masks, bpw, segd=None):
    """(lo, hi) neighbor-value arrays along dim d with inline BC synth.

    bpw: per direction the boundary value (Python float or a tensor
    broadcast to the array shape); masks: from :func:`_face_masks`;
    segd: the ghost layers of dim d of a segment launch (see
    :func:`_seg_substitute`), read with masks all None."""
    lo_raw = torch.roll(p, +1, axis)
    hi_raw = torch.roll(p, -1, axis)
    if segd:
        return _seg_substitute(p, lo_raw, hi_raw, d, segd)
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


def _reader_plane(d, r):
    """Index of the padded-array plane at coordinate r of dim d."""
    return ((PZ + r,), (slice(None), PY + r), (slice(None), slice(None), r))[
        2 - d]


def _seg_substitute(p, lo_raw, hi_raw, d, layers):
    """Segment synthesis along dim d (the JAX package's ``_neighbor_ops``
    segd branch): for each ghost layer (c, side, a) with planes a =
    [c0*b, c1, c2, mask], the readers at c + 1 (side 0) substitute their
    low neighbour, those at c - 1 (side 1) their high one, by
    ``(a0 + a1*x1) + a2*x2`` where the mask is non-zero — x1 the reader,
    x2 its raw neighbour on the other side.  Only the reader plane is
    touched."""
    lo, hi = lo_raw.clone(), hi_raw.clone()
    for c, side, a in layers:
        sl = _reader_plane(d, c + 1 if side == 0 else c - 1)
        m = a[3] != 0.0
        if side == 0:
            lo[sl] = torch.where(m, (a[0] + a[1] * p[sl]) + a[2] * hi_raw[sl],
                                 lo[sl])
        else:
            hi[sl] = torch.where(m, (a[0] + a[1] * p[sl]) + a[2] * lo_raw[sl],
                                 hi[sl])
    return lo, hi


def _eps_neighbor_ops(e, d, axis, masks, eps_bc=None, ebpw=None):
    """(lo, hi) neighbour values of a coefficient field along dim d:
    Neumann-zero physical ghosts (m_vlaplacian.f90:25-28,
    m_ahelmholtz.f90:28-41), i.e. at a physical face the neighbour value
    IS the cell's own value; periodic axes read the wrapped neighbour
    (the roll, or the caller-synced pad planes).  With eps_bc the face's
    ghost is c0*b + c1*x1 + c2*x2 (the JAX package's order; b from
    ``ebpw``, read only where c0 != 0)."""
    lo_raw = torch.roll(e, +1, axis)
    hi_raw = torch.roll(e, -1, axis)
    if masks[d] is None:
        return lo_raw, hi_raw
    m_lo, m_hi = masks[d]
    if eps_bc is None:
        return torch.where(m_lo, e, lo_raw), torch.where(m_hi, e, hi_raw)
    g = []
    for nb, x2 in ((2 * d, hi_raw), (2 * d + 1, lo_raw)):
        c0, c1, c2 = eps_bc[nb]
        v = c1 * e
        if c0 != 0.0:
            v = c0 * ebpw[nb] + v
        if c2 != 0.0:
            v = v + c2 * x2
        g.append(v)
    return torch.where(m_lo, g[0], lo_raw), torch.where(m_hi, g[1], hi_raw)


_DIM_AXIS = ((0, 2), (1, 1), (2, 0))   # dim x,y,z -> array axis


def _face_coeffs(cfg, eps, d, axis, masks, ebpw=None):
    """The two harmonic-mean face coefficients of dim d,
    ``((2*e0)*e_nb)/(e0 + e_nb)*idr2[d]`` for the low and the high
    neighbour; dim d reads eps[0] (n_eps 1) or eps[d] (n_eps 3), and
    its boundary planes ebpw[0] or ebpw[d] (cfg.eps_bc)."""
    i = 0 if cfg.n_eps == 1 else d
    e0 = eps[i]
    elo, ehi = _eps_neighbor_ops(e0, d, axis, masks, cfg.eps_bc,
                                 None if ebpw is None else ebpw[i])
    idr2 = cfg.rnd(cfg.idr2[d])
    return (2.0 * e0 * elo / (e0 + elo) * idr2,
            2.0 * e0 * ehi / (e0 + ehi) * idr2)


def _halfsweep(cfg, p, rhs_w, lam, masks, upd, red, bpw, eps=(), segd=None,
               ebpw=None):
    """One masked GSRB half-sweep over the array (constant coefficient,
    m_laplacian.f90 / m_helmholtz.f90 arithmetic order; with eps the
    harmonic-mean form of m_vlaplacian.f90:51-128 /
    m_ahelmholtz.f90:69-162: new = num / den, num = -rhs + sum c*nbr,
    den = lam + sum c, accumulated per dim x, y, z, low side first).

    upd: boolean "parity == red parity" mask; red=True updates those
    cells, red=False the complement (same mask, swapped select arms).
    ebpw: the coefficient fields' boundary planes (cfg.eps_bc)."""
    if cfg.n_eps:
        num = -rhs_w
        den = cfg.rnd(lam)
        for d, axis in _DIM_AXIS:
            c_lo, c_hi = _face_coeffs(cfg, eps, d, axis, masks, ebpw)
            lo, hi = _neighbor_ops(cfg, p, d, axis, masks, bpw)
            num = num + c_lo * lo
            den = den + c_lo
            num = num + c_hi * hi
            den = den + c_hi
        new = num / den
        return torch.where(upd, new, p) if red else torch.where(upd, p, new)
    acc = -rhs_w
    for d, axis in _DIM_AXIS:
        lo, hi = _neighbor_ops(cfg, p, d, axis, masks, bpw,
                               None if segd is None else segd[d])
        acc = acc + cfg.rnd(cfg.idr2[d]) * (lo + hi)
    new = acc * cfg.inv_den(lam)
    return torch.where(upd, new, p) if red else torch.where(upd, p, new)


def _apply_expr(cfg, p, lam, masks, bpw, eps=(), segd=None, ebpw=None):
    """A(phi) over the array: out = -lam*c; out += idr2[d]*(lo+hi-2c),
    or with eps out += c_lo*(lo - c) + c_hi*(hi - c) per dim."""
    out = (-cfg.rnd(lam)) * p
    if cfg.n_eps:
        for d, axis in _DIM_AXIS:
            c_lo, c_hi = _face_coeffs(cfg, eps, d, axis, masks, ebpw)
            lo, hi = _neighbor_ops(cfg, p, d, axis, masks, bpw)
            out = out + c_lo * (lo - p)
            out = out + c_hi * (hi - p)
        return out
    for d, axis in _DIM_AXIS:
        lo, hi = _neighbor_ops(cfg, p, d, axis, masks, bpw,
                               None if segd is None else segd[d])
        out = out + cfg.rnd(cfg.idr2[d]) * (lo + hi - 2.0 * p)
    return out


def _bpw_eps_full(eps_planes):
    """The coefficient fields' boundary planes (cfg.eps_bc) broadcast
    against the padded array: per field six planes, a face whose
    synthesis never reads b (None) as 0.0; layouts as in
    :func:`_bpw_full`."""
    if eps_planes is None:
        return None
    return [[0.0 if p is None else p[:, :, None] if i < 2
             else p[:, None, :] if i < 4 else p[None, :, :]
             for i, p in enumerate(planes)] for planes in eps_planes]


def _pair_plain(cfg, phi, rhs, lam, bplanes, red_parity, eps=(),
                z_gates=None, eps_planes=None):
    g = _full_iotas(cfg, phi.device)
    masks = _face_masks(cfg, g, z_gates)
    upd = _parity_mask(g, red_parity)
    bpw = _bpw_full(cfg, bplanes)
    ebpw = _bpw_eps_full(eps_planes)
    p1 = _halfsweep(cfg, phi, rhs, lam, masks, upd, True, bpw, eps,
                    ebpw=ebpw)
    return _halfsweep(cfg, p1, rhs, lam, masks, upd, False, bpw, eps,
                      ebpw=ebpw)


def _pairs_plain(cfg, phi, rhs, lam, bplanes, red_parity, n_pairs, eps=(),
                 z_gates=None, eps_planes=None):
    """n_pairs single pairs with the periodic pads re-synced between
    (what a fused multi-pair kernel computes in one pass).  CPU callers
    keep the periodic pads of the eps fields current.  On a z-slab
    (z_gates) only the y pads are re-synced: the z pads are the halo,
    swept redundantly like the rest of the array, as the kernel's halo
    planes are."""
    for k in range(n_pairs):
        if k:
            sync_pads(cfg, phi, slab=z_gates is not None)
        phi = _pair_plain(cfg, phi, rhs, lam, bplanes, red_parity, eps,
                          z_gates, eps_planes)
    return phi


def _apply_plain(cfg, phi, rhs, lam, bplanes, residual, eps=(),
                 z_gates=None, eps_planes=None):
    g = _full_iotas(cfg, phi.device)
    masks = _face_masks(cfg, g, z_gates)
    out = _apply_expr(cfg, phi, lam, masks, _bpw_full(cfg, bplanes), eps,
                      ebpw=_bpw_eps_full(eps_planes))
    return rhs - out if residual else out


def _half_plain(cfg, phi, rhs, lam, bplanes, parity, eps=(),
                eps_planes=None):
    """One half-sweep updating the cells of the given parity."""
    g = _full_iotas(cfg, phi.device)
    return _halfsweep(cfg, phi, rhs, lam, _face_masks(cfg, g),
                      _parity_mask(g, parity), True, _bpw_full(cfg, bplanes),
                      eps, ebpw=_bpw_eps_full(eps_planes))


_NO_MASKS = {0: None, 1: None, 2: None}


def _zero_pads(cfg, p):
    """A copy of p whose y/z pads (every cell outside the canvas) are
    zero: what a segment launch reads there."""
    q = p.clone()
    q[:PZ] = 0.0
    q[PZ + cfg.Z:] = 0.0
    q[:, :PY] = 0.0
    q[:, PY + cfg.Y:] = 0.0
    return q


def _seg_layers(segs, seg_planes):
    """{d: [(c, side, planes)]}: the ghost layers of a segment launch by
    normal dim."""
    out = {0: [], 1: [], 2: []}
    for (d, c, side), a in zip(segs, seg_planes):
        out[d].append((c, side, a))
    return out


def _seg_pairs_plain(cfg, phi, rhs, lam, red_parity, n_pairs, segs,
                     seg_planes):
    """n_pairs red+black pairs with segment synthesis: the pads are read
    as zero before every half-sweep, so k pairs in one call are exactly
    k single pairs."""
    g = _full_iotas(cfg, phi.device)
    upd = _parity_mask(g, red_parity)
    segd = _seg_layers(segs, seg_planes)
    for _ in range(n_pairs):
        for red in (True, False):
            phi = _halfsweep(cfg, _zero_pads(cfg, phi), rhs, lam, _NO_MASKS,
                             upd, red, None, segd=segd)
    return phi


def _seg_apply_plain(cfg, phi, rhs, lam, residual, segs, seg_planes):
    out = _apply_expr(cfg, _zero_pads(cfg, phi), lam, _NO_MASKS, None,
                      segd=_seg_layers(segs, seg_planes))
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


def _prolong_correct_plain(cfg_c, phi_c, iold_c, phi_f, bplanes_c,
                           mode="add", z_gates=None):
    """mode "add": phi_f += prolong(phi_c - iold_c); "corr_ready":
    phi_f += prolong(phi_c); "set": phi_f = prolong(phi_c) on the
    interior.  In place on phi_f; iold_c is read in mode "add" only.
    z_gates: a coarse z-slab's gates (its z pads are the halo)."""
    g = _full_iotas(cfg_c, phi_c.device)
    masks = _face_masks(cfg_c, g, z_gates)
    bpw = _bpw_full(cfg_c, bplanes_c)
    corr = phi_c - iold_c if mode == "add" else phi_c
    # neighbor values of corr with ghost semantics: synth(phi) -
    # synth(iold) at physical faces (the c0*b terms cancel only
    # mathematically, so both synths are evaluated)
    lo, hi = {}, {}
    for d, axis in _DIM_AXIS:
        lop, hip = _neighbor_ops(cfg_c, phi_c, d, axis, masks, bpw)
        if mode == "add":
            loi, hii = _neighbor_ops(cfg_c, iold_c, d, axis, masks, bpw)
            lop, hip = lop - loi, hip - hii
        lo[d] = lop[_ISL]
        hi[d] = hip[_ISL]
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
        if mode == "set":
            core_f[bz::2, by::2, bx::2] = v
        else:
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


#: most ghost layers a segment launch takes (``MAX_SEGS`` of
#: csrc/stencil_common.cuh)
MAX_SEGS = 96


class _SegParams(ctypes.Structure):
    """Mirror of ``SegParams`` in csrc/stencil_common.cuh."""
    _fields_ = [("n", ctypes.c_int), ("lut", ctypes.c_void_p),
                ("plane", ctypes.c_void_p * MAX_SEGS)]


class _SlabParams(ctypes.Structure):
    """Mirror of ``SlabParams`` in csrc/stencil_common.cuh."""
    _fields_ = [("gate", ctypes.c_int * 2)]


def _slab_params(z_gates) -> _SlabParams:
    Zs = _SlabParams()
    Zs.gate[0], Zs.gate[1] = (int(bool(g)) for g in z_gates)
    return Zs


def _check_gates(z_gates, what):
    """A z-slab's gates: a (lo, hi) pair of Python bools, or None."""
    if z_gates is None:
        return None
    z_gates = tuple(z_gates)
    if len(z_gates) != 2 or any(isinstance(g, torch.Tensor)
                                for g in z_gates):
        raise ValueError(f"{what}: z_gates must be a (lo, hi) pair of bools")
    return tuple(bool(g) for g in z_gates)


def _out_field(cfg, out, like, inputs, what):
    """The field a launch writes its core cells into: ``out`` (checked:
    a padded field of the config that is none of the inputs), or a new
    one with uninitialized pads."""
    if out is None:
        return torch.empty_like(like)
    _check_field(cfg, out, "out")
    if any(t is not None and out.data_ptr() == t.data_ptr() for t in inputs):
        raise ValueError(f"{what}: out aliases an input")
    return out


def _plain_out(out, r):
    """A plain version's result r written into ``out``'s core cells (the
    cells a kernel writes), or r itself."""
    if out is None:
        return r
    out[_ISL] = r[_ISL]
    return out


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


def _params(cfg, lam, bplanes, red_parity=0, n_sweeps=0,
            seg=False) -> _LevelParams:
    """seg: a segment launch, x periodic and nothing of the BCs read."""
    P = _LevelParams()
    P.X, P.Y, P.Z = cfg.dims
    P.red_parity, P.n_sweeps = int(red_parity), int(n_sweeps)
    for d in range(3):
        P.per[d] = int(d == 0) if seg else int(cfg.periodic[d])
        P.idr2[d] = cfg.rnd(cfg.idr2[d])
    P.neg_lam = -cfg.rnd(lam)
    P.inv_den = cfg.inv_den(lam)
    if seg:
        return P
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


def cuda_stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream of ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def _count_design(name: str, n_eps: int, design: int) -> None:
    """Count a launch of a kernel entry point under the design the
    library reports it ran (1 wide, 2 face-plane, 3 the pair
    prolongation, 4 a march: one half-sweep's register march, the
    double-float residual's z-march; 0 none of them).
    name: the entry point, or a name that already carries its variant
    (then n_eps 0)."""
    if design == 1:
        _LAUNCHES[name + "[wide]"] += 1
    elif design == 2:
        _LAUNCHES[faces_name(name, n_eps)] += 1
    elif design == 3:
        _LAUNCHES[name + "[pair]"] += 1
    elif design == 4:
        _LAUNCHES[name + "[march]"] += 1


def record_launch(err: int, what: str,
                  counter: Optional[str] = None) -> None:
    """After a kernel's launch: raise if it failed, else add one to its
    launch counter (``counter``, default ``what``).  Every kernel
    wrapper of the package counts its launches here, those of ops/df32
    and ops/flat_smoother too."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
    _LAUNCHES[counter or what] += 1


_VP = ctypes.c_void_p
_ARGTYPES = {
    "omg_stencil_sweep": [ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(_LevelParams),
                          ctypes.POINTER(_EpsParams), _VP, _VP, _VP, _VP,
                          ctypes.POINTER(ctypes.c_int)],
    "omg_downsweep": [ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(_LevelParams),
                      ctypes.POINTER(_EpsParams), _VP, _VP, _VP, _VP, _VP,
                      _VP, ctypes.POINTER(ctypes.c_int)],
    "omg_restrict": [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     _VP, _VP, _VP],
    "omg_prolong_correct": [ctypes.c_int, ctypes.c_int,
                            ctypes.POINTER(_LevelParams), _VP, _VP, _VP, _VP],
    "omg_seg_sweep": [ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(_LevelParams),
                      ctypes.POINTER(_SegParams), _VP, _VP, _VP, _VP,
                      ctypes.POINTER(ctypes.c_int)],
    "omg_stencil_slab": [ctypes.c_int, ctypes.c_int,
                         ctypes.POINTER(_LevelParams),
                         ctypes.POINTER(_EpsParams),
                         ctypes.POINTER(_SlabParams), _VP, _VP, _VP, _VP,
                         ctypes.POINTER(ctypes.c_int)],
    "omg_prolong_slab": [ctypes.c_int, ctypes.POINTER(_LevelParams),
                         ctypes.POINTER(_SlabParams), _VP, _VP, _VP, _VP,
                         ctypes.POINTER(ctypes.c_int)],
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


def _seg_plane_shape(cfg, d):
    """Shape of one ghost layer's planes [4, T1, T2]: the padded
    layout of dim d's face planes."""
    ZP, YP, X = cfg.pshape
    return (4,) + ((ZP, YP), (ZP, X), (YP, X))[d]


class SegLayers(NamedTuple):
    """A canvas's ghost layers, checked, with their reader -> layer table
    (``SegParams.lut``) on the launches' device: made once per canvas
    geometry by :func:`seg_layers` and passed as ``segs=``."""
    dims: Tuple[int, int, int]
    segs: Tuple[Tuple[int, int, int], ...]
    lut: torch.Tensor


def seg_layers(cfg, segs, device) -> SegLayers:
    """Check a canvas's ghost layers (unique (d, c, side) with readers
    inside the canvas, at most ``MAX_SEGS``) and build their table."""
    segs = tuple(tuple(int(v) for v in k) for k in segs)
    if len(set(segs)) != len(segs):
        raise ValueError("segs: no layer twice")
    if len(segs) > MAX_SEGS:
        raise ValueError(f"segs: {len(segs)} ghost layers, the kernel "
                         f"takes {MAX_SEGS}")
    X, Y, Z = cfg.dims
    a = np.full(2 * (X + Y + Z), -1, np.int32)
    base = (0, 2 * X, 2 * (X + Y))
    for j, (d, c, side) in enumerate(segs):
        r = c + 1 if side == 0 else c - 1
        if d not in (0, 1, 2) or side not in (0, 1) \
                or not 0 <= r < cfg.dims[d]:
            raise ValueError(f"segs: layer {(d, c, side)} has no reader in "
                             f"the canvas {cfg.dims}")
        a[base[d] + 2 * r + side] = j
    return SegLayers(tuple(cfg.dims), segs, torch.from_numpy(a).to(device))


def _check_segs(cfg, segs, seg_planes, eps, device):
    """The ghost layers of a segment launch (a :class:`SegLayers` of this
    canvas, or descriptors to check now) and one [4, T1, T2] plane per
    layer; constant coefficients."""
    if eps:
        raise NotImplementedError("segment synthesis: constant "
                                  "coefficients only")
    if not isinstance(segs, SegLayers):
        segs = seg_layers(cfg, segs, device)
    elif segs.dims != tuple(cfg.dims) or segs.lut.device != device:
        raise ValueError(f"segs: layers of a {segs.dims} canvas on "
                         f"{segs.lut.device}, launched on {cfg.dims} on "
                         f"{device}")
    seg_planes = list(seg_planes)
    if len(segs.segs) != len(seg_planes):
        raise ValueError("segs: one plane per layer")
    for (d, c, side), a in zip(segs.segs, seg_planes):
        if a.dtype != cfg.dtype or tuple(a.shape) != _seg_plane_shape(cfg, d):
            raise ValueError(f"seg plane of {(d, c, side)}: {a.dtype} "
                             f"{tuple(a.shape)}, expected {cfg.dtype} "
                             f"{_seg_plane_shape(cfg, d)}")
    return segs, seg_planes


def _seg_params(segs: SegLayers, seg_planes) -> _SegParams:
    """The ``SegParams`` of a segment launch: the table and the planes."""
    S = _SegParams()
    S.n = len(segs.segs)
    S.lut = segs.lut.data_ptr()
    for j, a in enumerate(seg_planes):
        S.plane[j] = a.data_ptr()
    return S


def _seg_launch(name, cfg, mode, phi, rhs, lam, red_parity, n_sweeps, segs,
                seg_planes):
    _check_field(cfg, phi, "phi")
    _check_field(cfg, rhs, "rhs")
    for j, ((d, _, _), a) in enumerate(zip(segs.segs, seg_planes)):
        _check_field(cfg, a, f"seg_planes[{j}]", _seg_plane_shape(cfg, d))
    S = _seg_params(segs, seg_planes)
    P = _params(cfg, lam, None, red_parity, n_sweeps, seg=True)
    out = torch.empty_like(phi)
    design = ctypes.c_int(0)
    err = _fn("seg_sweep", "omg_seg_sweep")(
        _dt(cfg), mode, ctypes.byref(P), ctypes.byref(S), phi.data_ptr(),
        rhs.data_ptr(), out.data_ptr(), cuda_stream(phi),
        ctypes.byref(design))
    record_launch(err, name, name + "[segs]")
    _count_design(name + "[segs]", 0, design.value)
    return out


def _coarse_empty(cfg, like):
    return torch.empty(padded_shape((cfg.X // 2, cfg.Y // 2, cfg.Z // 2)),
                       dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _slab_launch(name, cfg, mode, phi, rhs, lam, bplanes, red_parity,
                 n_sweeps, eps, z_gates, out):
    """One launch of a stencil kernel's z-slab variant."""
    _check_field(cfg, phi, "phi")
    _check_field(cfg, rhs, "rhs")
    P = _params(cfg, lam, bplanes, red_parity, n_sweeps)
    E = _eps_params(cfg, eps)
    Zs = _slab_params(z_gates)
    design = ctypes.c_int(0)
    err = _fn("stencil_sweep", "omg_stencil_slab")(
        _dt(cfg), mode, ctypes.byref(P), ctypes.byref(E), ctypes.byref(Zs),
        phi.data_ptr(), rhs.data_ptr(), out.data_ptr(), cuda_stream(phi),
        ctypes.byref(design))
    record_launch(err, name, slab_name(name, cfg.n_eps))
    # the slab name carries n_eps: name[n_eps=k][z_gates][faces]
    _count_design(slab_name(name, cfg.n_eps), 0, design.value)
    return out


def pair_sweep_dense(cfg: DenseStencilConfig, phi, rhs, lam, bplanes,
                     red_parity: int, n_pairs: int = 1, eps=(), segs=None,
                     seg_planes=None, z_gates=None, out=None,
                     eps_planes=None):
    """Fused [red half-sweep, ghost refresh, black half-sweep] x n_pairs.

    phi/rhs: padded_shape(dims); lam: host scalar; bplanes: 6 padded
    boundary-value planes (only plane-valued faces are read).
    red_parity: global (gx+gy+gz)%2 value updated by the red sweep.
    Returns new phi with garbage pads; the inputs are left as they are.

    n_pairs=2 is two full GSRB iterations (4 half-sweeps): identical per
    cell to two single pairs with a pad re-sync between.  On CUDA it is
    one pass over device memory with a 4-deep halo.  CPU tensors need
    their periodic pads current (:func:`sync_pads`), eps fields too.
    eps: cfg.n_eps padded coefficient fields.

    segs/seg_planes: a dense-forest canvas's ghost layers ((d, c, side)
    descriptors, or a :class:`SegLayers` made once for the canvas, and
    one [4, T1, T2] plane each, see ``csrc/stencil_common.cuh``);
    then bplanes and cfg's BC fields are not read, x wraps and y/z reads
    outside the canvas are zero, and the ghosts are synthesized at read
    time, so the pairs need no refresh between them.

    z_gates: the level is a z-slab (see the module docstring) whose z
    pads hold the neighbour slabs' planes at least 2*n_pairs deep (eps
    fields' too); between two pairs only the y pads are re-synced.  The
    local z of the slab must have the parity of the global z.
    out: a padded field, none of the inputs (a z-window of a larger one
    will do), that receives the core cells; its pads are not written.

    eps_planes: a config with eps_bc (the dense-patch AMR solver's levels
    with refinement faces) takes per coefficient field six boundary
    planes (None where the face's c0 is 0) and runs the plain version on
    any device, counted under ``pair_sweep_dense[eps_bc]`` by
    :func:`plain_route_counts`, as the JAX package runs its jnp path."""
    eps = _check_eps(cfg, eps, "pair_sweep_dense")
    z_gates = _check_gates(z_gates, "pair_sweep_dense")
    if n_pairs not in (1, 2):
        raise ValueError("pair_sweep_dense: n_pairs must be 1 or 2")
    if _plain_route(cfg, "pair_sweep_dense", eps_planes):
        if segs is not None or z_gates is not None:
            raise ValueError("pair_sweep_dense: eps_bc takes no segs and "
                             "no z_gates")
        return _plain_out(out, _pairs_plain(cfg, phi, rhs, lam, bplanes,
                                            red_parity, n_pairs, eps,
                                            eps_planes=eps_planes))
    if segs is not None:
        if z_gates is not None or out is not None:
            raise ValueError("pair_sweep_dense: segment launches take no "
                             "z_gates and no out")
        segs, seg_planes = _check_segs(cfg, segs, seg_planes, eps,
                                       phi.device)
        if cfg.X % 2:
            raise ValueError(f"pair_sweep_dense: segment launches wrap x, "
                             f"which needs an even extent, got {cfg.dims}")
        if not phi.is_cuda:
            return _seg_pairs_plain(cfg, phi, rhs, lam, red_parity, n_pairs,
                                    segs.segs, seg_planes)
        return _seg_launch("pair_sweep_dense", cfg, _MODE_PAIRS, phi, rhs,
                           lam, red_parity, 2 * n_pairs, segs, seg_planes)
    if n_pairs == 2 and not cfg.periodic_even:
        raise ValueError(f"pair_sweep_dense: a double pair needs even extents "
                         f"on periodic axes, got {cfg.dims}; run single pairs")
    if not phi.is_cuda:
        return _plain_out(out, _pairs_plain(cfg, phi, rhs, lam, bplanes,
                                            red_parity, n_pairs, eps,
                                            z_gates))
    out = _out_field(cfg, out, phi, (phi, rhs) + eps, "pair_sweep_dense")
    if z_gates is not None:
        return _slab_launch("pair_sweep_dense", cfg, _MODE_PAIRS, phi, rhs,
                            lam, bplanes, red_parity, 2 * n_pairs, eps,
                            z_gates, out)
    _check_field(cfg, phi, "phi")
    _check_field(cfg, rhs, "rhs")
    P = _params(cfg, lam, bplanes, red_parity, 2 * n_pairs)
    E = _eps_params(cfg, eps)
    design = ctypes.c_int(0)
    err = _fn("stencil_sweep", "omg_stencil_sweep")(
        _dt(cfg), _MODE_PAIRS, ctypes.byref(P), ctypes.byref(E),
        phi.data_ptr(), rhs.data_ptr(), out.data_ptr(), cuda_stream(phi),
        ctypes.byref(design))
    record_launch(err, "pair_sweep_dense",
                  variant_name("pair_sweep_dense", cfg.n_eps))
    _count_design("pair_sweep_dense", cfg.n_eps, design.value)
    return out


def half_sweep_dense(cfg: DenseStencilConfig, phi, rhs, lam, bplanes,
                     parity: int, eps=(), eps_planes=None):
    """ONE GSRB half-sweep: update the cells with (gx+gy+gz)%2 == parity,
    copy the others.  Returns a new field.

    The dense forest runs at half-sweep granularity where its ghosts are
    refreshed between half-sweeps (the reference's refill cadence,
    smooth_boxes, m_multigrid.f90:404-424): two calls with a refresh
    between are one pair.  The arithmetic of an updated cell is that of
    pair_sweep_dense's red half.  On the card: constant coefficients, on
    a register march (csrc/stencil_sweep.cu), also counted under
    ``half_sweep_dense[march]``.  eps_planes: as in
    :func:`pair_sweep_dense` (the plain route, on any device)."""
    eps = _check_eps(cfg, eps, "half_sweep_dense")
    if _plain_route(cfg, "half_sweep_dense", eps_planes):
        return _half_plain(cfg, phi, rhs, lam, bplanes, parity, eps,
                           eps_planes)
    if not phi.is_cuda:
        return _half_plain(cfg, phi, rhs, lam, bplanes, parity, eps)
    if eps:
        raise NotImplementedError("half_sweep_dense: the kernel has constant "
                                  "coefficients only; coefficient fields "
                                  "take the plain route (an eps_bc config)")
    _check_field(cfg, phi, "phi")
    _check_field(cfg, rhs, "rhs")
    P = _params(cfg, lam, bplanes, parity, 1)
    E = _eps_params(cfg, ())
    out = torch.empty_like(phi)
    design = ctypes.c_int(0)
    err = _fn("stencil_sweep", "omg_stencil_sweep")(
        _dt(cfg), _MODE_PAIRS, ctypes.byref(P), ctypes.byref(E),
        phi.data_ptr(), rhs.data_ptr(), out.data_ptr(), cuda_stream(phi),
        ctypes.byref(design))
    record_launch(err, "half_sweep_dense")
    _count_design("half_sweep_dense", 0, design.value)
    return out


def stencil_apply_dense(cfg: DenseStencilConfig, phi, rhs, lam, bplanes,
                        residual: bool, eps=(), segs=None, seg_planes=None,
                        z_gates=None, out=None, eps_planes=None):
    """A(phi) (or rhs - A(phi)) in one pass (box_lpl/box_helmh +
    residual_box, m_multigrid.f90:426-436; with eps box_vlpl/box_vhelmh/
    box_ahelmh).  Returns a new field.  segs/seg_planes: a forest
    canvas's ghost layers, as in :func:`pair_sweep_dense`; z_gates, out
    and eps_planes as there (the z pads 1 deep)."""
    eps = _check_eps(cfg, eps, "stencil_apply_dense")
    z_gates = _check_gates(z_gates, "stencil_apply_dense")
    if _plain_route(cfg, "stencil_apply_dense", eps_planes):
        if segs is not None or z_gates is not None:
            raise ValueError("stencil_apply_dense: eps_bc takes no segs and "
                             "no z_gates")
        return _plain_out(out, _apply_plain(cfg, phi, rhs, lam, bplanes,
                                            residual, eps,
                                            eps_planes=eps_planes))
    if segs is not None:
        if z_gates is not None or out is not None:
            raise ValueError("stencil_apply_dense: segment launches take no "
                             "z_gates and no out")
        segs, seg_planes = _check_segs(cfg, segs, seg_planes, eps,
                                       phi.device)
        if not phi.is_cuda:
            return _seg_apply_plain(cfg, phi, rhs, lam, residual, segs.segs,
                                    seg_planes)
        return _seg_launch("stencil_apply_dense", cfg,
                           _MODE_RESIDUAL if residual else _MODE_APPLY, phi,
                           rhs, lam, 0, 0, segs, seg_planes)
    if not phi.is_cuda:
        return _plain_out(out, _apply_plain(cfg, phi, rhs, lam, bplanes,
                                            residual, eps, z_gates))
    out = _out_field(cfg, out, phi, (phi, rhs) + eps, "stencil_apply_dense")
    mode = _MODE_RESIDUAL if residual else _MODE_APPLY
    if z_gates is not None:
        return _slab_launch("stencil_apply_dense", cfg, mode, phi, rhs, lam,
                            bplanes, 0, 0, eps, z_gates, out)
    _check_field(cfg, phi, "phi")
    _check_field(cfg, rhs, "rhs")
    P = _params(cfg, lam, bplanes)
    E = _eps_params(cfg, eps)
    design = ctypes.c_int(0)
    err = _fn("stencil_sweep", "omg_stencil_sweep")(
        _dt(cfg), mode, ctypes.byref(P), ctypes.byref(E), phi.data_ptr(),
        rhs.data_ptr(), out.data_ptr(), cuda_stream(phi),
        ctypes.byref(design))
    record_launch(err, "stencil_apply_dense",
                  variant_name("stencil_apply_dense", cfg.n_eps))
    _count_design("stencil_apply_dense", cfg.n_eps, design.value)
    return out


def _downsweep(name, cfg, phi, rhs, lam, bplanes, red_parity, n_pairs,
               fine_out, eps):
    eps = _check_eps(cfg, eps, name)
    if cfg.eps_bc is not None:
        # the JAX package's fused transfers need cfg.fused_down_ok, which
        # an eps_bc config never has
        raise ValueError(f"{name}: a config with eps_bc takes the separate "
                         f"phases (pair, residual, restriction)")
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
    design = ctypes.c_int(0)
    err = _fn("downsweep", "omg_downsweep")(
        _dt(cfg), int(fine_out), ctypes.byref(P), ctypes.byref(E),
        phi.data_ptr(),
        rhs.data_ptr(), phi_out.data_ptr() if fine_out else None,
        phi_c.data_ptr(), ires_c.data_ptr(), cuda_stream(phi),
        ctypes.byref(design))
    record_launch(err, name, variant_name(name, cfg.n_eps))
    _count_design(name, cfg.n_eps, design.value)
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


def restrict_dense(cfg_f: DenseStencilConfig, fine, out=None):
    """Full-weighting restriction (m_restrict.f90:183-194): fine padded
    -> new coarse padded (garbage pads), or into ``out``'s core cells (a
    coarse padded field).  Requires even extents."""
    if not cfg_f.even_dims:
        raise ValueError(f"restrict_dense: odd extent in {cfg_f.dims}")
    if not fine.is_cuda:
        return _plain_out(out, _restrict_plain(cfg_f, fine))
    _check_field(cfg_f, fine, "fine")
    if out is None:
        coarse = _coarse_empty(cfg_f, fine)
    else:
        _check_field(cfg_f, out, "out", padded_shape(
            (cfg_f.X // 2, cfg_f.Y // 2, cfg_f.Z // 2)))
        coarse = out
    err = _fn("restrict", "omg_restrict")(
        _dt(cfg_f), cfg_f.X // 2, cfg_f.Y // 2, cfg_f.Z // 2,
        fine.data_ptr(), coarse.data_ptr(), cuda_stream(fine))
    record_launch(err, "restrict_dense")
    return coarse


def prolong_correct_dense(cfg_c: DenseStencilConfig, phi_c, iold_c, phi_f,
                          bplanes_c, add: bool = True,
                          corr_ready: bool = False, z_gates=None):
    """Fused correct_children (m_multigrid.f90:387-402): corr = phi_c -
    iold_c with ghost-ring semantics (BC synthesis / periodic wraps),
    mg_prolong_sparse D-linear weights (m_prolong.f90:159-240), added
    into phi_f IN PLACE (the JAX package returns a new array instead;
    its buffer is donated there).  Returns phi_f.

    add=False (set mode, mg_prolong): iold_c is not read and the
    prolonged phi_c replaces phi_f's interior.  corr_ready=True: phi_c
    already is the correction (iold_c not read) and its prolongation is
    added — the dense forest's correction, whose window ring rides the
    plane-valued faces.  CPU tensors need the periodic pads of phi_c (and
    iold_c) current.  A write on the card bumps phi_f's version counter,
    as an in-place PyTorch operation would.

    z_gates: phi_c and iold_c are a coarse z-slab (see the module
    docstring; add mode only) whose z pads hold the neighbour slabs'
    planes 1 deep, and phi_f the fine slab above it."""
    mode = "set" if not add else "corr_ready" if corr_ready else "add"
    z_gates = _check_gates(z_gates, "prolong_correct_dense")
    if z_gates is not None and mode != "add":
        raise NotImplementedError(
            f"prolong_correct_dense: z_gates with the {mode} mode has no "
            f"caller in either package")
    X, Y, Z = cfg_c.dims
    shape_f = padded_shape((2 * X, 2 * Y, 2 * Z))
    if tuple(phi_f.shape) != shape_f:
        raise ValueError(f"phi_f: shape {tuple(phi_f.shape)}, expected "
                         f"{shape_f}")
    if not phi_c.is_cuda:
        return _prolong_correct_plain(cfg_c, phi_c, iold_c, phi_f, bplanes_c,
                                      mode, z_gates)
    _check_field(cfg_c, phi_c, "phi_c")
    if mode == "add":
        _check_field(cfg_c, iold_c, "iold_c")
    _check_field(cfg_c, phi_f, "phi_f", shape_f)
    P = _params(cfg_c, 0.0, bplanes_c)
    design = ctypes.c_int(0)
    if z_gates is not None:
        Zs = _slab_params(z_gates)
        err = _fn("prolong_correct", "omg_prolong_slab")(
            _dt(cfg_c), ctypes.byref(P), ctypes.byref(Zs), phi_c.data_ptr(),
            iold_c.data_ptr(), phi_f.data_ptr(), cuda_stream(phi_c),
            ctypes.byref(design))
        counter = slab_name("prolong_correct_dense")
    else:
        err = _fn("prolong_correct", "omg_prolong_correct")(
            _dt(cfg_c), ("add", "set", "corr_ready").index(mode),
            ctypes.byref(P), phi_c.data_ptr(),
            iold_c.data_ptr() if mode == "add" else None,
            phi_f.data_ptr(), cuda_stream(phi_c))
        counter = ("prolong_correct_dense" if mode == "add"
                   else f"prolong_correct_dense[{mode}]")
    record_launch(err, "prolong_correct_dense", counter)
    _count_design(counter, 0, design.value)
    torch.autograd.graph.increment_version(phi_f)
    return phi_f
