"""Carry solver state between the JAX package and this one.

Both packages keep the same per-level layout, so a state crosses as
plain numpy arrays:

    {"phi" | "rhs" | "iold" | "ires": {lvl: ndarray [Z+16, Y+16, X]},
     "eps0" .. "eps{n_eps-1}": {...}   (variable-coefficient operators),
     "bc": {lvl: [6 boundary-value planes]}}

The 2D dense solvers (``Dense2DMGSolver``, ``Dense2DAMRMGSolver``) keep
unpadded ``[Y, X]`` fields (an AMR level's patch) and four boundary
vectors per level: x faces [Y], y faces [X], periodic faces [1].

The z-slab solver (``ShardedDenseMGSolver``) has the JAX package's
sharded layout: a sharded level's fields are ``[K, Zl+16, Y+16, X]`` and
its non-periodic x/y-face planes stacked per slab (``[K, Zl+16, ...]``);
replicated levels and z-face planes are as above.

``state_from_numpy`` puts such a state on a solver's device in its
dtype, checking every shape level by level (the fields it carries are
the solver's: the coefficient fields of its operator included; a dense
forest's fields are its level canvases and its boundary planes the raw,
unpadded face values [Z, Y] / [Z, X] / [Y, X]);
``state_to_numpy`` is the reverse; ``direct_from_numpy`` does the same
for the eigenbasis package of the direct coarse solve (``V``, ``Vinv``,
``d``, ``tiny``), whether the JAX package assembled it from the stencil
or probed it from the coefficients.

The refined solve's state crosses the same way: ``df_pair_from_numpy``
puts a padded double-float pair (the solution ``(x_hi, x_lo)`` or the
right-hand side) into a ``RefinedPoisson``'s own buffers (a
``RefinedPoisson2D``'s: unpadded [Y, X]), and ``df_pair_to_numpy`` reads
one back.

The free-space drivers' FFT state crosses with
``free_space_cache_from_numpy``: the JAX driver's cache (``kernel_hat``
— complex128 for the IGF kernel, float64 for the spectral one, kept in
that dtype — the boundary ``planes`` and the FFT potential
``phi_global``, in the working dtype) becomes the port driver's, so a
test can hold the solve phases apart from the kernel build.

The boxed solver (``MGSolver``) has the JAX package's boxed layout,

    {"cc": {lvl: ndarray [n_vars, n_boxes, (nc+2)^D]},
     "bc": {lvl: [2D boundary-value planes [n_boxes, nc^(D-1)]]}},

which ``state_from_numpy`` checks and carries the same way.  Its host constants need no
conversion: ``RefinedPoisson.cbs`` (six ``(hi, lo)`` pairs) and
``lam_pair`` are plain Python floats in both packages and can be
compared or assigned as they are.

Nothing here imports JAX: the caller converts its arrays with
``np.asarray``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

def _to_tensor(solver, a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    return torch.from_numpy(a.copy()).to(solver.device, solver.cfg.dtype)


def _boxed_from_numpy(solver, np_state: Dict) -> Dict:
    state: Dict = {"cc": {}, "bc": {}}
    for lvl in solver.levels:
        st = solver.static[lvl]
        want = ((solver.n_vars, st["n_boxes"])
                + (st["nc"] + 2,) * solver.ndim)
        a = np.asarray(np_state["cc"][lvl])
        if tuple(a.shape) != want:
            raise ValueError(f"cc[{lvl}]: shape {a.shape}, this solver has "
                             f"{want}")
        state["cc"][lvl] = _to_tensor(solver, a)
        planes = list(np_state["bc"][lvl])
        if len(planes) != 2 * solver.ndim:
            raise ValueError(f"bc[{lvl}]: expected {2 * solver.ndim} planes")
        fshape = (st["nc"],) * (solver.ndim - 1)
        out = []
        for nb, p in enumerate(planes):
            p = np.asarray(p)
            if tuple(p.shape) != (st["n_boxes"],) + fshape:
                raise ValueError(f"bc[{lvl}][{nb}]: shape {p.shape}, "
                                 f"expected {(st['n_boxes'],) + fshape}")
            out.append(_to_tensor(solver, p))
        state["bc"][lvl] = out
    return state


def state_from_numpy(solver, np_state: Dict) -> Dict:
    """A new state for ``solver`` holding the values of ``np_state``: the
    fields of ``solver._field_keys`` (eps0.. for the variable-coefficient
    operators) and the boundary planes; for the boxed solver its "cc"
    arrays and boundary planes."""
    from .solve.multigrid import MGSolver
    if isinstance(solver, MGSolver):
        return _boxed_from_numpy(solver, np_state)
    keys = solver._field_keys
    missing = [k for k in keys if k not in np_state]
    if missing:
        raise ValueError(f"state lacks {missing} (operator "
                         f"{solver.cfg.operator!r})")
    state: Dict = {k: {} for k in keys}
    state["bc"] = {}
    for lvl in solver._kcfgs:   # level keys (unit keys on multi-canvas)
        want = solver._field_shape(lvl)
        for k in keys:
            a = np.asarray(np_state[k][lvl])
            if tuple(a.shape) != want:
                raise ValueError(f"{k}[{lvl}]: shape {a.shape}, this solver "
                                 f"has {want}")
            state[k][lvl] = _to_tensor(solver, a)
        planes = list(np_state["bc"][lvl])
        if len(planes) != 2 * solver.ndim:
            raise ValueError(f"bc[{lvl}]: expected {2 * solver.ndim} "
                             f"planes")
        out = []
        for nb, p in enumerate(planes):
            p = np.asarray(p)
            want = solver._bc_plane_shape(lvl, nb)
            if tuple(p.shape) != tuple(want):
                raise ValueError(f"bc[{lvl}][{nb}]: shape {p.shape}, "
                                 f"expected {want}")
            out.append(_to_tensor(solver, p))
        state["bc"][lvl] = out
    return state


def state_to_numpy(state: Dict) -> Dict:
    """The state as numpy arrays on the host (copies), every field the
    state holds."""
    out: Dict = {k: {lvl: t.detach().cpu().numpy().copy()
                     for lvl, t in per_lvl.items()}
                 for k, per_lvl in state.items() if k != "bc"}
    out["bc"] = {lvl: [p.detach().cpu().numpy().copy() for p in planes]
                 for lvl, planes in state["bc"].items()}
    return out


def direct_from_numpy(solver, package: Dict) -> Dict:
    """The eigenbasis package of the direct coarse solve on the solver's
    device in its dtype.  ``V`` and ``Vinv`` are [m, m], ``d`` is [m] with
    m the cell count of the coarsest cycled level; ``tiny`` is a scalar."""
    m = int(np.prod(solver.dims[solver._unit0(solver.levels[0])]))
    V, Vinv, d = (np.asarray(package[k]) for k in ("V", "Vinv", "d"))
    if V.shape != (m, m) or Vinv.shape != (m, m) or d.shape != (m,):
        raise ValueError(f"eigenbasis shapes {V.shape}, {Vinv.shape}, "
                         f"{d.shape} do not match {m} coarse cells")
    return {"V": _to_tensor(solver, V), "Vinv": _to_tensor(solver, Vinv),
            "d": _to_tensor(solver, d),
            "tiny": _to_tensor(solver, np.asarray(package["tiny"]))}


def free_space_cache_from_numpy(driver, np_cache: Dict):
    """Install a free-space FFT cache on ``driver`` (a
    ``FreeSpacePoisson3D`` or ``FreeSpacePoisson3DDense``) and return it.

    ``np_cache``: {"kernel_hat": array, "planes": {nb: [slow, fast]
    plane} or None, "phi_global": [Z+2, Y+2, X+2] or None, and, for the
    spectral kernel, "pad_shape": (z, y, x)}, the fields of the JAX
    package's ``FreeSpaceCache`` as numpy arrays.  The kernel keeps its
    dtype (complex128 or float64); planes and potential take the
    solver's dtype.  Shapes are checked against the driver's FFT level."""
    from .solve.free_space import FreeSpaceCache
    sv = driver.solver
    X, Y, Z = (int(v) + 2 for v in driver.nx)
    pad = np_cache.get("pad_shape")
    pad = tuple(int(v) for v in pad) if pad is not None else None
    kz, ky, kx = pad if pad is not None else (2 * Z, 2 * Y, 2 * X)
    khat = np.ascontiguousarray(np.asarray(np_cache["kernel_hat"]))
    if khat.shape != (kz, ky, kx // 2 + 1):
        raise ValueError(f"kernel_hat: shape {khat.shape}, this driver's "
                         f"FFT grid needs {(kz, ky, kx // 2 + 1)}")
    if khat.dtype not in (np.complex128, np.float64):
        raise TypeError(f"kernel_hat: complex128 or float64, got "
                        f"{khat.dtype}")
    cache = FreeSpaceCache(
        fft_lvl=driver.fft_lvl,
        kernel_hat=torch.from_numpy(khat.copy()).to(sv.device),
        pad_shape=pad)
    phi = np_cache.get("phi_global")
    if phi is not None:
        phi = np.asarray(phi)
        if phi.shape != (Z, Y, X):
            raise ValueError(f"phi_global: shape {phi.shape}, expected "
                             f"{(Z, Y, X)}")
        cache.phi_global = _to_tensor(sv, phi)
    planes = np_cache.get("planes")
    if planes is not None:
        want = {0: (Z, Y), 1: (Z, Y), 2: (Z, X), 3: (Z, X), 4: (Y, X),
                5: (Y, X)}
        cache.planes = {}
        for nb in range(6):
            p = np.asarray(planes[nb])
            if p.shape != want[nb]:
                raise ValueError(f"planes[{nb}]: shape {p.shape}, expected "
                                 f"{want[nb]}")
            cache.planes[nb] = _to_tensor(sv, p)
    driver.cache = cache
    return cache


def df_pair_from_numpy(refined, which: str, hi, lo):
    """Write a padded double-float pair into ``refined``'s buffers, in
    place: ``which`` is "x" for the solution pair or "rhs" for the
    right-hand side.  ``hi``/``lo``: float32 arrays of the instance's
    field shape (padded [Z+16, Y+16, X]; [Y, X] for ``RefinedPoisson2D``).
    Returns the two tensors."""
    if which not in ("x", "rhs"):
        raise ValueError(f"which must be 'x' or 'rhs', got {which!r}")
    refined._alloc()
    out = ((refined.x_hi, refined.x_lo) if which == "x"
           else (refined.rhs_hi, refined.rhs_lo))
    for t, a in zip(out, (hi, lo)):
        a = np.asarray(a)
        if a.dtype != np.float32:
            raise TypeError(f"{which}: a double-float pair is float32, "
                            f"got {a.dtype}")
        if tuple(a.shape) != tuple(refined.pshape):
            raise ValueError(f"{which}: shape {a.shape}, this solver has "
                             f"{tuple(refined.pshape)}")
        t.copy_(torch.from_numpy(np.ascontiguousarray(a).copy()))
    return out


def df_pair_to_numpy(refined, which: str):
    """The padded (hi, lo) pair "x" or "rhs" of ``refined`` as numpy
    arrays on the host (copies)."""
    if which not in ("x", "rhs"):
        raise ValueError(f"which must be 'x' or 'rhs', got {which!r}")
    refined._alloc()
    pair = ((refined.x_hi, refined.x_lo) if which == "x"
            else (refined.rhs_hi, refined.rhs_lo))
    return tuple(t.detach().cpu().numpy().copy() for t in pair)
