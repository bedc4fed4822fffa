"""3D free-space Poisson solver: FFT Green's-function solve on a coarse
uniform level + multigrid refinement.

The port of the JAX package's ``solve/free_space.py`` (the reference's
``m_free_space.f90``, ``mg_poisson_free_3d``): pick the coarsest uniform
level holding <= max_fft_frac of the unknowns (:84-92), solve free-space
Poisson there by FFT convolution with the Green's function, extract the
six boundary planes by face averaging (:167-174), install them as
bilinearly interpolated Dirichlet BCs on every physical face
(ghost_cells_free_bc/interp_bc :217-270), seed the multigrid initial
guess from the FFT solution (:180-199), then run FMG or V-cycles.

Two kernels on ``torch.fft``, as in the JAX package:

* ``kernel="igf"`` (default): Hockney domain doubling with the
  integrated Green's function (exact cell integrals of 1/r) plus a
  1/24-quadrature sharpening, ~4th order.  The kernel is built with
  float64 torch ops on the solver's device (at a 512^3 top level the
  doubled grid is 516^3, 1.1 GB per float64 array).
* ``kernel="spectral"``: the Vico-Greengard-Ferrando truncated kernel,
  spectrally accurate for smooth, compactly supported charge, at a
  ~2.6x pad per dim.

The FFT state keeps the JAX package's dtypes whatever the working
dtype: the IGF ``kernel_hat`` is complex128 and the spectral one
float64, so a float32 convolution multiplies and inverts in
complex128/float64 before casting back; the bilinear BC interpolation
weights are float64, so the interpolation runs in float64 and is cast
to the working dtype.

The solvers update the state in place; ``solve`` returns the same
dictionary and the residual as a 0-dim tensor on the state's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import topology as topo
from ..core.constants import IPHI, IRHS, BCType
from .multigrid import MGSolver


def _antideriv_inv_r(x, y, z):
    """Triple antiderivative of 1/r: F with d^3F/(dx dy dz) =
    1/sqrt(x^2+y^2+z^2), on float64 tensors that broadcast to one grid.

    F = yz ln(x+r) + xz ln(y+r) + xy ln(z+r)
        - x^2/2 atan(yz/(x r)) - y^2/2 atan(xz/(y r)) - z^2/2 atan(xy/(z r))
    (the closed form of integrated-Green-function Poisson solvers, e.g.
    Qiang et al. 2004), in the JAX package's operation order.
    """
    r = torch.sqrt(x * x + y * y + z * z)

    def safe_log(num):
        return torch.log(torch.where(num > 0, num, 1.0))

    def safe_atan(a, b):
        nz = b.abs() > 0
        return torch.atan(a / torch.where(nz, b, 1.0)) * nz

    return (y * z * safe_log(x + r) + x * z * safe_log(y + r)
            + x * y * safe_log(z + r)
            - 0.5 * x * x * safe_atan(y * z, x * r)
            - 0.5 * y * y * safe_atan(x * z, y * r)
            - 0.5 * z * z * safe_atan(x * y, z * r))


@dataclasses.dataclass
class FreeSpaceCache:
    """Persistent FFT state across calls (mg_free_bc_t,
    m_free_space.f90:9-24)."""

    fft_lvl: int
    kernel_hat: torch.Tensor          # FFT of the Green's kernel
    planes: Optional[Dict[int, torch.Tensor]] = None  # per nb: boundary plane
    phi_global: Optional[torch.Tensor] = None         # FFT potential (padded)
    pad_shape: Optional[Tuple[int, ...]] = None       # spectral kernel pad


def _build_cache(kernel: str, fft_lvl: int, nx: np.ndarray, dr: np.ndarray,
                 device="cuda") -> FreeSpaceCache:
    if kernel == "spectral":
        khat, ps = _green_kernel_hat_spectral(nx + 2, dr, device)
        return FreeSpaceCache(fft_lvl=fft_lvl, kernel_hat=khat, pad_shape=ps)
    assert kernel == "igf", kernel
    return FreeSpaceCache(fft_lvl=fft_lvl,
                          kernel_hat=_green_kernel_hat(nx + 2, dr, device))


def _green_kernel_hat(nx: np.ndarray, dr: np.ndarray,
                      device="cuda") -> torch.Tensor:
    """rFFT (complex128) of the free-space kernel on the doubled grid
    (Hockney circulant embedding).

    Integrated Green's function: each kernel entry is the exact integral
    of 1/|d - r'| over the source cell (8-corner alternating sum of the
    closed-form antiderivative).  The axis coordinates are the JAX
    package's numpy values; the 3D sum runs in float64 torch ops on
    ``device`` (``torch.log``/``torch.atan`` may differ from numpy's by
    an ulp)."""
    axes = []
    for d in range(3):
        m = 2 * int(nx[d])
        i = np.arange(m)
        i = np.minimum(i, m - i)  # circulant distance
        axes.append(i * dr[d])
    h = dr / 2.0
    dev = torch.device(device)

    def axis(d, s, shape):
        v = axes[d] + s * h[d]
        return torch.as_tensor(v, dtype=torch.float64,
                               device=dev).reshape(shape)

    n = (axes[2].size, axes[1].size, axes[0].size)
    k = torch.zeros(n, dtype=torch.float64, device=dev)
    for sx in (-1.0, 1.0):
        for sy in (-1.0, 1.0):
            for sz in (-1.0, 1.0):
                sign = sx * sy * sz
                k += sign * _antideriv_inv_r(axis(0, sx, (1, 1, -1)),
                                             axis(1, sy, (1, -1, 1)),
                                             axis(2, sz, (-1, 1, 1)))
    return torch.fft.rfftn(k)


def _good_fft_size(n: int) -> int:
    """Smallest 2^a * 3^b * 5^c >= n (torch.fft is mixed-radix)."""
    best = 1 << (int(n) - 1).bit_length()
    p5 = 1
    while p5 < best:
        p3 = p5
        while p3 < best:
            m = p3
            while m < n:
                m *= 2
            best = min(best, m)
            p3 *= 3
        p5 *= 5
    return best


def _green_kernel_hat_spectral(nx: np.ndarray, dr: np.ndarray,
                               device="cuda"
                               ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """Spectrally accurate free-space kernel: the truncated Green's
    function of Vico, Greengard & Ferrando (2016).

    G_L(r) = 1/|r| for |r| <= L, 0 beyond; its Fourier transform is
    4*pi*(1 - cos(L|k|))/|k|^2 (-> 2*pi*L^2 at k=0), sampled on the
    k-grid of a box padded to M_d*h_d >= B_d + L.  The wave numbers are
    the JAX package's numpy vectors; the 3D formula runs in float64
    torch ops on ``device``.

    Returns (float64 kernel_hat for the padded rfftn grid, padded shape
    [z,y,x])."""
    B = np.asarray(nx, np.float64) * np.asarray(dr, np.float64)
    L = float(np.sqrt(np.sum(B * B)))
    M = [int(_good_fft_size(int(np.ceil(nx[d] + L / dr[d]))))
         for d in range(3)]
    dev = torch.device(device)

    def vec(v, shape):
        return torch.as_tensor(v, dtype=torch.float64,
                               device=dev).reshape(shape)

    kx = vec(2 * np.pi * np.fft.rfftfreq(M[0], d=dr[0]), (1, 1, -1))
    ky = vec(2 * np.pi * np.fft.fftfreq(M[1], d=dr[1]), (1, -1, 1))
    kz = vec(2 * np.pi * np.fft.fftfreq(M[2], d=dr[2]), (-1, 1, 1))
    kk = kz ** 2 + ky ** 2 + kx ** 2
    kn = torch.sqrt(kk)
    khat = 4.0 * np.pi * (1.0 - torch.cos(L * kn)) / kk
    khat.view(-1)[0] = 2.0 * np.pi * L * L
    return khat, (M[2], M[1], M[0])


def _sharpen_rho(rho: torch.Tensor) -> torch.Tensor:
    """Quadrature correction rho_eff = rho - (1/24) * sum_d D2_d(rho),
    with D2_d the plain second difference (the IGF convolution treats
    the charge as piecewise constant; this raises it to ~4th order).
    Boundary cells stay uncorrected (free-space charges are compactly
    supported).  Returns a new tensor; the division is by a tensor on
    rho's device, as the JAX package divides (a Python-scalar divisor
    would make CUDA multiply by its reciprocal)."""
    interior = (slice(1, -1),) * 3
    d2 = 0.0
    for ax in range(3):
        sl_lo = [slice(1, -1)] * 3
        sl_hi = [slice(1, -1)] * 3
        sl_lo[ax] = slice(0, -2)
        sl_hi[ax] = slice(2, None)
        d2 = d2 + (rho[tuple(sl_lo)] + rho[tuple(sl_hi)]
                   - 2.0 * rho[interior])
    out = rho.clone()
    out[interior] += -d2 / torch.full((), 24.0, dtype=rho.dtype,
                                      device=rho.device)
    return out


def _fft_convolve(rho: torch.Tensor, kernel_hat: torch.Tensor,
                  pad_shape: Optional[Tuple[int, ...]] = None
                  ) -> torch.Tensor:
    nz, ny, nx = rho.shape
    ps = pad_shape or (2 * nz, 2 * ny, 2 * nx)
    pad = torch.zeros(ps, dtype=rho.dtype, device=rho.device)
    pad[:nz, :ny, :nx] = rho
    out = torch.fft.irfftn(torch.fft.rfftn(pad) * kernel_hat, s=ps)
    return out[:nz, :ny, :nx].to(rho.dtype)


def _face_planes(phi_g: torch.Tensor) -> Dict[int, torch.Tensor]:
    """Boundary planes by face averaging (m_free_space.f90:167-174),
    spanning the full padded transverse extent: x faces [z, y], y faces
    [z, x], z faces [y, x]."""
    return {
        0: 0.5 * (phi_g[:, :, 0] + phi_g[:, :, 1]),
        1: 0.5 * (phi_g[:, :, -2] + phi_g[:, :, -1]),
        2: 0.5 * (phi_g[:, 0, :] + phi_g[:, 1, :]),
        3: 0.5 * (phi_g[:, -2, :] + phi_g[:, -1, :]),
        4: 0.5 * (phi_g[0, :, :] + phi_g[1, :, :]),
        5: 0.5 * (phi_g[-2, :, :] + phi_g[-1, :, :]),
    }


def _interp_weights(x_fast, x_slow, r_min, dr_fft, tdims, device):
    """Bilinear interpolation onto an fft-level plane (interp_bc,
    m_free_space.f90:239-270): 0-based plane indices (int64) and the four
    float64 weights, as device tensors."""
    inv_dr = 1.0 / dr_fft[tdims]
    r0 = r_min[tdims] - 0.5 * dr_fft[tdims]
    frac_f = (x_fast - r0[0]) * inv_dr[0]
    frac_s = (x_slow - r0[1]) * inv_dr[1]
    i_f = np.ceil(frac_f).astype(np.int64)
    i_s = np.ceil(frac_s).astype(np.int64)
    lf_f = i_f - frac_f
    lf_s = i_s - frac_s

    def t(a, dt=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    return {"pf": t(i_f - 1, torch.int64), "ps": t(i_s - 1, torch.int64),
            "w00": t(lf_f * lf_s), "w10": t((1 - lf_f) * lf_s),
            "w01": t(lf_f * (1 - lf_s)), "w11": t((1 - lf_f) * (1 - lf_s))}


def _interp(ip, p):
    """The bilinear interpolation of plane p at ip's points, in float64
    (the weights' dtype), in the JAX package's order."""
    pf, ps = ip["pf"], ip["ps"]
    return (ip["w00"] * p[ps, pf] + ip["w10"] * p[ps, pf + 1]
            + ip["w01"] * p[ps + 1, pf] + ip["w11"] * p[ps + 1, pf + 1])


class FreeSpacePoisson3D:
    """Driver for mg_poisson_free_3d (m_free_space.f90:36-214) over the
    boxed ``MGSolver``."""

    def __init__(self, solver: MGSolver, max_fft_frac: float = 0.15,
                 kernel: str = "igf"):
        if solver.ndim != 3:
            raise ValueError("free-space solver is 3D only")
        if solver.cfg.operator != "laplacian" \
                or solver.cfg.geometry != "cartesian":
            raise ValueError("free-space solve needs a Cartesian Laplacian")
        if kernel not in ("igf", "spectral"):
            raise ValueError("kernel must be 'igf' or 'spectral'")
        self.solver = solver
        self.max_fft_frac = max_fft_frac
        self.kernel = kernel
        self.cache: Optional[FreeSpaceCache] = None
        # free-space BCs are interpolated Dirichlet values; mark the BC
        # type so ghost filling uses the Dirichlet formula
        solver.set_bc(IPHI, BCType.DIRICHLET, value=0.0)
        self._choose_fft_lvl()
        self._build_scatter_maps()

    # -- setup ----------------------------------------------------------
    def _choose_fft_lvl(self):
        t = self.solver.tree
        total = t.number_of_unknowns()
        lvl = t.highest_uniform_lvl()
        while lvl > t.lowest_lvl + 1:
            n_lvl = len(t.lvls[lvl].ids) * t.box_size ** 3
            if n_lvl <= self.max_fft_frac * total:
                break
            lvl -= 1
        self.fft_lvl = lvl
        self.nx = t.domain_size_lvl[lvl].copy()          # interior cells
        self.dr = t.dr[lvl].copy()

    def _build_scatter_maps(self):
        """Flat indices mapping fft-level boxes <-> the padded global grid
        (grid size domain+2 with a one-ghost-cell border,
        m_free_space.f90:102,144-151,183-189)."""
        t = self.solver.tree
        lvl = self.fft_lvl
        nc = t.box_size_lvl[lvl]
        ids = t.lvls[lvl].ids
        M = self.nx + 2  # padded global size, [x,y,z]
        gshape = (int(M[2]), int(M[1]), int(M[0]))  # [z,y,x]
        n = len(ids)
        int_idx = np.empty((n, nc, nc, nc), dtype=np.int64)
        full_idx = np.empty((n, nc + 2, nc + 2, nc + 2), dtype=np.int64)
        for i, b in enumerate(ids):
            off = (t.ix[int(b)] - 1) * nc  # 0-based cell offset, [x,y,z]
            zz, yy, xx = np.meshgrid(
                off[2] + 1 + np.arange(nc), off[1] + 1 + np.arange(nc),
                off[0] + 1 + np.arange(nc), indexing="ij")
            int_idx[i] = np.ravel_multi_index((zz, yy, xx), gshape)
            zz, yy, xx = np.meshgrid(
                off[2] + np.arange(nc + 2), off[1] + np.arange(nc + 2),
                off[0] + np.arange(nc + 2), indexing="ij")
            full_idx[i] = np.ravel_multi_index((zz, yy, xx), gshape)
        dev = self.solver.device
        self._int_idx = torch.as_tensor(int_idx.reshape(-1), device=dev)
        self._full_idx = torch.as_tensor(full_idx.reshape(-1), device=dev)
        self._gshape = gshape

    # -- solve ----------------------------------------------------------
    @torch.no_grad()
    def solve(self, state, new_rhs: bool = True, fmg_cycle: bool = True,
              need_res: bool = True) -> Tuple[dict, torch.Tensor]:
        sv = self.solver
        t = sv.tree
        lvl = self.fft_lvl
        dt = sv.cfg.dtype

        if self.cache is None and not new_rhs:
            raise ValueError("first call requires new_rhs=True")

        if self.cache is None:
            self.cache = _build_cache(self.kernel, lvl, self.nx, self.dr,
                                      sv.device)

        if new_rhs:
            # restrict rhs down to the fft level (m_free_space.f90:115-118)
            for l in range(t.highest_lvl, lvl, -1):
                state = sv.restrict_level(state, l, IRHS)

            rhs_fac = -1.0 / (4.0 * np.pi)
            isl = (slice(None),) + (slice(1, -1),) * 3
            rho_boxes = rhs_fac * state["cc"][lvl][IRHS][isl]
            n = len(t.lvls[lvl].ids)
            rho = torch.zeros(self._gshape, dtype=dt, device=sv.device)
            rho.view(-1)[self._int_idx] = rho_boxes[:n].reshape(-1)
            if self.kernel == "igf":
                rho = _sharpen_rho(rho)  # spectral needs raw samples
            phi_g = _fft_convolve(rho, self.cache.kernel_hat,
                                  self.cache.pad_shape)
            self.cache.phi_global = phi_g
            self.cache.planes = _face_planes(phi_g)

            # install interpolated Dirichlet BC values on every level
            # (mg_phi_bc_store path, :177)
            state = self._install_bc_values(state)

            # seed initial guess: copy FFT potential incl. ghost ring into
            # fft-level boxes, restrict down, prolong up (:180-199)
            nc = t.box_size_lvl[lvl]
            phi_boxes = phi_g.reshape(-1)[self._full_idx]
            phi_boxes = phi_boxes.reshape(-1, nc + 2, nc + 2, nc + 2)
            state = sv.set_plane(state, lvl, IPHI, phi_boxes.to(dt))
            for l in range(lvl, t.lowest_lvl, -1):
                state = sv.restrict_level(state, l, IPHI)
            for l in range(lvl, t.highest_lvl):
                state = sv.prolong_level(state, l, IPHI, IPHI, add=False)
                state = sv.fill_ghost(state, IPHI, lvl=l + 1)

        res = torch.zeros((), dtype=dt, device=sv.device)
        if lvl < t.highest_lvl:
            if fmg_cycle:
                state, res = sv.fas_fmg(state, have_guess=True,
                                        need_res=need_res)
            else:
                state, res = sv.fas_vcycle(state, need_res=need_res)
        return state, res

    def _install_bc_values(self, state):
        """Bilinear interpolation of the boundary planes at every physical
        face cell (interp_bc, m_free_space.f90:239-270), written into the
        state's BC value arrays (new tensors, zeros off the physical
        faces)."""
        sv = self.solver
        t = sv.tree
        planes = self.cache.planes
        for lvl in sv.levels:
            m = sv.maps[lvl]
            vals = list(state["bc"][lvl])
            for nb in range(6):
                coords = m.phys_face_coords[nb]  # [mp, nc, nc, 3]
                if coords.shape[0] == 0:
                    continue
                d = topo.neighb_dim(nb)
                tdims = [dd for dd in range(3) if dd != d]
                # plane axes are [slow, fast] = [t_hi, t_lo]
                ip = _interp_weights(coords[..., tdims[0]],
                                     coords[..., tdims[1]], t.r_min,
                                     self.dr, tdims, sv.device)
                full = torch.zeros_like(vals[nb])
                full[torch.as_tensor(m.dirs[nb].phys_loc.astype(np.int64),
                                     device=sv.device)] = \
                    _interp(ip, planes[nb]).to(sv.cfg.dtype)
                vals[nb] = full
            state["bc"][lvl] = vals
        return state


class FreeSpacePoisson3DDense:
    """Free-space Poisson driver on the dense uniform path
    (mg_poisson_free_3d, m_free_space.f90:36-214, over DenseMGSolver).

    Same scheme as :class:`FreeSpacePoisson3D`, but every level is one
    dense padded array, so the scatter maps are plain slices and the BC
    values are written straight into the dense solver's per-face plane
    arrays.  ``make_free_space`` also sends the dense-patch AMR solver
    (a DenseMGSolver subclass) here, as the JAX package does: the
    driver builds, and ``solve(new_rhs=True)`` raises ``ValueError`` on
    the seeding prolongation into the first patch level, as there."""

    def __init__(self, solver, max_fft_frac: float = 0.15,
                 kernel: str = "igf"):
        from .dense import DenseMGSolver
        if not isinstance(solver, DenseMGSolver):
            raise TypeError("FreeSpacePoisson3DDense needs DenseMGSolver")
        if any(solver.periodic):
            raise ValueError("free-space solve needs non-periodic BCs")
        if kernel not in ("igf", "spectral"):
            raise ValueError("kernel must be 'igf' or 'spectral'")
        self.solver = solver
        self.max_fft_frac = max_fft_frac
        self.kernel = kernel
        self.cache: Optional[FreeSpaceCache] = None
        # plane-valued Dirichlet on every face (interp values installed
        # per solve); fn marks the faces non-constant
        solver.set_bc(0, BCType.DIRICHLET,
                      fn=lambda c: np.zeros(c.shape[:-1]))
        self._choose_fft_lvl()
        self._interp = {lvl: self._build_interp(lvl)
                        for lvl in solver.levels}

    def _choose_fft_lvl(self):
        """Coarsest level holding <= max_fft_frac of the unknowns
        (m_free_space.f90:84-92), clamped to the solver's cycled
        levels."""
        sv = self.solver
        t = sv.tree
        total = t.number_of_unknowns()
        lvl = sv.levels[-1]
        while lvl > sv.levels[0] + 1:
            n_lvl = int(np.prod(sv.dims[lvl]))
            if n_lvl <= self.max_fft_frac * total:
                break
            lvl -= 1
        self.fft_lvl = lvl
        self.nx = np.array(sv.dims[lvl])        # (X, Y, Z) interior
        self.dr = sv.tree.dr[lvl].copy()

    def _build_interp(self, lvl):
        """Per-face bilinear interpolation onto the fft-level boundary
        planes (interp_bc, m_free_space.f90:239-270): static indices and
        float64 weights from this level's face-center coordinates."""
        sv = self.solver
        t = sv.tree
        dr_l = t.dr[lvl]
        r_min = t.r_min
        centers = [r_min[d] + (np.arange(sv.dims[lvl][d]) + 0.5) * dr_l[d]
                   for d in range(3)]
        out = {}
        for nb in range(6):
            d = nb // 2
            tdims = [dd for dd in range(3) if dd != d]
            # face grid [slow, fast] matching the plane layouts of
            # _eval_bc_planes: x faces [Z,Y], y faces [Z,X], z faces [Y,X]
            x_fast, x_slow = np.meshgrid(centers[tdims[0]],
                                         centers[tdims[1]])
            out[nb] = _interp_weights(x_fast, x_slow, r_min, self.dr, tdims,
                                      sv.device)
        return out

    def _install_bc_values(self, state):
        """Interpolate the cached boundary planes onto every level's
        face-plane arrays (mg_phi_bc_store analogue): new padded planes,
        zero in the pads."""
        from ..ops import dense_kernels as dk
        sv = self.solver
        planes = self.cache.planes
        dt = sv.cfg.dtype
        for lvl in sv.levels:
            vals = list(state["bc"][lvl])
            for nb in range(6):
                v = _interp(self._interp[lvl][nb], planes[nb]).to(dt)
                d = nb // 2
                if d == 0:       # [Z, Y] -> padded [ZP, YPW]
                    pad = ((dk.PZ, dk.PZ), (dk.PY, dk.PY))
                elif d == 1:     # [Z, X] -> [ZP, X]
                    pad = ((dk.PZ, dk.PZ), (0, 0))
                else:            # [Y, X] -> [YPW, X]
                    pad = ((dk.PY, dk.PY), (0, 0))
                full = torch.zeros_like(vals[nb])
                core = tuple(slice(p0, full.shape[i] - p1)
                             for i, (p0, p1) in enumerate(pad))
                full[core] = v
                vals[nb] = full
            state["bc"][lvl] = vals
        return state

    @torch.no_grad()
    def solve(self, state, new_rhs: bool = True, fmg_cycle: bool = True,
              need_res: bool = True):
        sv = self.solver
        lvl = self.fft_lvl
        top = sv.levels[-1]
        dt = sv.cfg.dtype

        if self.cache is None and not new_rhs:
            raise ValueError("first call requires new_rhs=True")
        if self.cache is None:
            self.cache = _build_cache(self.kernel, lvl, self.nx, self.dr,
                                      sv.device)

        if new_rhs:
            # restrict rhs to the fft level (m_free_space.f90:115-118)
            for l in range(top, lvl, -1):
                state = sv._restrict_into(state, l, "rhs")
            X, Y, Z = sv.dims[lvl]
            rhs_fac = -1.0 / (4.0 * np.pi)
            rho = torch.zeros((Z + 2, Y + 2, X + 2), dtype=dt,
                              device=sv.device)
            rho[(slice(1, -1),) * 3] = rhs_fac * sv.interior(state, lvl,
                                                             "rhs")
            if self.kernel == "igf":
                rho = _sharpen_rho(rho)  # spectral needs raw samples
            phi_g = _fft_convolve(rho, self.cache.kernel_hat,
                                  self.cache.pad_shape)
            self.cache.phi_global = phi_g
            self.cache.planes = _face_planes(phi_g)
            state = self._install_bc_values(state)

            # seed initial guess from the FFT potential (:180-199)
            state = sv.set_interior(state, lvl, "phi",
                                    phi_g[(slice(1, -1),) * 3])
            for l in range(lvl, sv.levels[0], -1):
                state = sv._restrict_into(state, l, "phi")
            for l in range(lvl, top):
                state = sv.prolong_set(state, l, with_ring=True)

        res = torch.zeros((), dtype=dt, device=sv.device)
        if lvl < top:
            if fmg_cycle:
                state, res = sv.fas_fmg(state, have_guess=True,
                                        need_res=need_res)
            else:
                state, res = sv.fas_vcycle(state, need_res=need_res)
        return state, res


def make_free_space(solver, max_fft_frac: float = 0.15,
                    kernel: str = "igf"):
    """Free-space driver matching the solver type (boxed or dense; the
    dense subclasses, the AMR patch solver included, take the dense
    driver, as in the JAX package).

    kernel="igf" (default): integrated Green's function + quadrature
    sharpening, ~4th order — right for the MG path.  kernel="spectral":
    the Vico-Greengard truncated kernel, for a solve whose FFT level is
    the top level, at ~2.6x the FFT extent."""
    from .dense import DenseMGSolver
    if isinstance(solver, DenseMGSolver):
        return FreeSpacePoisson3DDense(solver, max_fft_frac, kernel)
    return FreeSpacePoisson3D(solver, max_fft_frac, kernel)
