"""Masked GSRB half-sweep on flat boxes: the boxed solver's smoother
kernel and its plain PyTorch version.

The port of the JAX package's ``ops/pallas_smoother.py``.  On the flat
per-box layout ``[n_boxes, (nc+2)^D]`` every stencil neighbor is a
constant shift of the flat index (x: +-1, y: +-(nc+2), z: +-(nc+2)^2).
One half-sweep of the constant-coefficient laplacian/helmholtz updates
the interior cells of one checkerboard parity:

    out = mask ? (-rhs + sum_d idr2[d] * (phi[i-s_d] + phi[i+s_d])) * fac
               : phi,           fac = 1 / (sum_d 2 idr2[d] + lam),

``fac`` evaluated in Python double and rounded once at the multiply —
the arithmetic and order of ``ops/kernels.helmholtz_smooth_half``, so the
boxed solver's smoothing is the same with or without this kernel
(``MGExperimental.pallas_smoother``).  The ghost refresh is not part of
it.

``half_sweep_flat`` is the wrapper: for a CPU tensor it runs the plain
version (``_half_sweep_flat_plain``, circular rolls and ``torch.where``
as in the Pallas body: wrapped values land only on masked-off ghosts);
for a CUDA tensor it launches ``csrc/flat_sweep.cu`` (built at first use)
or raises.  Either way it updates ``phi_flat`` in place (the JAX
function returns a new array).  Launches are counted under
``half_sweep_flat`` in ``dense_kernels.launch_counts()``.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from . import _cuda_build
from . import dense_kernels as dk


def _mask_flat(ndim: int, nc: int, parity_val: int) -> np.ndarray:
    """Flattened interior+checkerboard mask: cell is updated when it is
    interior and (i+j+k) parity matches (cf. indexmaps.checkerboard_parity)."""
    shape = (nc + 2,) * ndim
    idx = np.indices(shape)  # python index == the reference's 0:nc+1 index
    interior = np.ones(shape, bool)
    for d in range(ndim):
        interior &= (idx[d] >= 1) & (idx[d] <= nc)
    par = idx.sum(axis=0) % 2
    return (interior & (par == parity_val)).reshape(-1)


def _shifts(ndim: int, nc: int):
    return [(nc + 2) ** d for d in range(ndim)]


def _fac(ndim: int, idr2: Sequence[float], lam: float) -> float:
    s = 0.0
    for d in range(ndim):
        s = s + 2.0 * idr2[d]
    return 1.0 / (s + lam)


def _half_sweep_flat_plain(phi_flat: torch.Tensor, rhs_flat: torch.Tensor,
                           ndim: int, nc: int, idr2: Sequence[float],
                           lam: float, parity_val: int) -> torch.Tensor:
    """The half-sweep as PyTorch operations; returns a new [n, S] plane."""
    acc = -rhs_flat
    for d, sh in enumerate(_shifts(ndim, nc)):
        acc = acc + idr2[d] * (torch.roll(phi_flat, sh, dims=-1)
                               + torch.roll(phi_flat, -sh, dims=-1))
    new = acc * _fac(ndim, idr2, lam)
    mask = torch.as_tensor(_mask_flat(ndim, nc, parity_val),
                           device=phi_flat.device)
    return torch.where(mask, new, phi_flat)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = _cuda_build.load("flat_sweep").omg_half_sweep_flat
        f.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_double), ctypes.c_double,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def half_sweep_flat(phi_flat: torch.Tensor, rhs_flat: torch.Tensor,
                    ndim: int, nc: int, idr2: Sequence[float], lam: float,
                    parity_val: int, block_boxes: int = 8) -> torch.Tensor:
    """One masked GSRB half-sweep on flat [n, (nc+2)^D] planes, in place
    on ``phi_flat``; returns it.  ``block_boxes`` (boxes per Pallas grid
    step on the TPU) is accepted for the JAX signature and means nothing
    here: the CUDA kernel runs one thread per cell."""
    del block_boxes
    n, S = phi_flat.shape
    if ndim not in (1, 2, 3) or S != (nc + 2) ** ndim:
        raise ValueError(f"half_sweep_flat: plane width {S} is not "
                         f"(nc+2)^ndim for nc={nc}, ndim={ndim}")
    if tuple(rhs_flat.shape) != (n, S) or rhs_flat.dtype != phi_flat.dtype:
        raise ValueError("half_sweep_flat: rhs must match phi in shape and "
                         "dtype")
    if parity_val not in (0, 1):
        raise ValueError(f"half_sweep_flat: parity {parity_val}")
    if not phi_flat.is_cuda:
        return phi_flat.copy_(_half_sweep_flat_plain(
            phi_flat, rhs_flat, ndim, nc, idr2, lam, parity_val))
    if phi_flat.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"half_sweep_flat: dtype {phi_flat.dtype}")
    for name, t in (("phi", phi_flat), ("rhs", rhs_flat)):
        if not t.is_cuda or t.device != phi_flat.device:
            raise ValueError(f"half_sweep_flat: {name} must be on "
                             f"{phi_flat.device}")
        if not t.is_contiguous():
            raise ValueError(f"half_sweep_flat: {name} must be contiguous")
    if n == 0:
        return phi_flat
    coef = (ctypes.c_double * 3)(*[float(idr2[d]) for d in range(ndim)])
    err = _kernel()(0 if phi_flat.dtype == torch.float32 else 1, ndim, n,
                    nc, int(parity_val), coef, _fac(ndim, idr2, lam),
                    phi_flat.data_ptr(), rhs_flat.data_ptr(),
                    dk.cuda_stream(phi_flat))
    dk.record_launch(err, "half_sweep_flat")
    torch.autograd.graph.increment_version(phi_flat)
    return phi_flat


def half_sweep_boxes(phi: torch.Tensor, rhs: torch.Tensor, ndim: int,
                     nc: int, idr2: Sequence[float], lam: float,
                     parity_val: int) -> torch.Tensor:
    """Wrapper taking [n, (nc+2)^D]-shaped planes (contiguous); updates
    ``phi`` in place and returns it."""
    n = phi.shape[0]
    S = int(np.prod(phi.shape[1:]))
    half_sweep_flat(phi.view(n, S), rhs.view(n, S), ndim, nc, idr2, lam,
                    parity_val)
    return phi
