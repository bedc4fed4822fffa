"""The flat-box half-sweep (ops/flat_smoother) against the JAX package's
Pallas ``half_sweep_boxes`` (interpret mode on the CPU) and inside the
boxed solver.

Bounds: against the Pallas body, float32, ``64 * eps32 * max|ref|``
(interpret mode compiles the body, where XLA:CPU may contract a*b+c);
the plain version against the boxed solver's own half-sweep
(``ops/kernels.helmholtz_smooth_half``) and the solver with the kernel
on or off: bitwise, one operation order.  The CUDA kernel is held
against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_mg_tpu.ops.pallas_smoother import half_sweep_boxes as ref_boxes

import octree_mg_tpu_torch as port
from octree_mg_tpu_torch.core.constants import IPHI, IRHS
from octree_mg_tpu_torch.core.indexmaps import checkerboard_parity
from octree_mg_tpu_torch.ops import dense_kernels as dk
from octree_mg_tpu_torch.ops import flat_smoother as fs
from octree_mg_tpu_torch.ops import kernels

torch.set_num_threads(1)


def fields(ndim, nc, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    shape = (n,) + (nc + 2,) * ndim
    return (rng.normal(size=shape).astype(dtype),
            rng.normal(size=shape).astype(dtype))


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("parity_val", [0, 1])
def test_plain_version_matches_pallas_body(ndim, parity_val):
    nc, n = 8, 16
    phi, rhs = fields(ndim, nc, n, np.float32)
    idr2 = tuple(float(x) for x in (1.0, 2.0, 0.5)[:ndim])
    lam = 0.7
    want = np.asarray(ref_boxes(jnp.asarray(phi), jnp.asarray(rhs), ndim,
                                nc, idr2, lam, parity_val, interpret=True))
    S = (nc + 2) ** ndim
    got = fs._half_sweep_flat_plain(torch.from_numpy(phi).reshape(n, S),
                                    torch.from_numpy(rhs).reshape(n, S),
                                    ndim, nc, idr2, lam, parity_val)
    got = got.reshape(phi.shape).numpy()
    tol = 64 * np.finfo(np.float32).eps * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    # only the masked cells moved
    moved = np.zeros(phi.shape, bool)
    moved[:] = fs._mask_flat(ndim, nc, parity_val).reshape(phi.shape[1:])
    np.testing.assert_array_equal(got[~moved], phi[~moved])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_wrapper_in_place_equals_the_solver_half_sweep(dtype, ndim):
    """On a CPU tensor the wrapper runs the plain version in place; it
    equals ops/kernels.helmholtz_smooth_half bitwise, both parities,
    with and without lam, and launches nothing."""
    nc, n = 4, 5
    idr2 = tuple(float(x) for x in (4.0, 0.25, 9.0)[:ndim])
    dk.reset_launch_counts()
    for parity in (0, 1):
        for lam in (0.0, 0.7):
            phi, rhs = fields(ndim, nc, n, dtype, seed=parity + 3)
            mask = torch.from_numpy(checkerboard_parity(ndim, nc) == parity)
            want = kernels.helmholtz_smooth_half(
                torch.from_numpy(phi.copy()), torch.from_numpy(rhs), ndim,
                nc, idr2, lam, mask)
            t = torch.from_numpy(phi.copy())
            got = fs.half_sweep_boxes(t, torch.from_numpy(rhs), ndim, nc,
                                      idr2, lam, parity)
            assert got is t
            assert torch.equal(got, want)
    assert dk.launch_counts()["half_sweep_flat"] == 0


def test_wrapper_checks_its_arguments():
    phi = torch.zeros(3, 6 ** 3)
    with pytest.raises(ValueError, match="plane width"):
        fs.half_sweep_flat(phi, phi.clone(), 3, 5, (1.0,) * 3, 0.0, 0)
    with pytest.raises(ValueError, match="rhs"):
        fs.half_sweep_flat(phi, torch.zeros(2, 6 ** 3), 3, 4, (1.0,) * 3,
                           0.0, 0)
    with pytest.raises(ValueError, match="parity"):
        fs.half_sweep_flat(phi, phi.clone(), 3, 4, (1.0,) * 3, 0.0, 2)


def test_kernel_smoother_in_solver_is_bitwise(monkeypatch):
    """MGExperimental(pallas_smoother=True) gives the same V-cycles as the
    default smoother, bit for bit (the JAX package's
    tests/test_pallas_smoother.py:31-54 on the port), and it is the flat
    half-sweep that smooths then."""
    calls = []
    inner = fs.half_sweep_boxes
    monkeypatch.setattr(fs, "half_sweep_boxes",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    results = []
    for use_kernel in (False, True):
        dsz = np.full(3, 16)
        tree = port.build_rectangle(3, dsz, 8, 1.0 / dsz, np.zeros(3))
        solver = port.MGSolver(tree, port.MGConfig(
            operator="laplacian", device="cpu",
            experimental=port.MGExperimental(pallas_smoother=use_kernel)))
        state = solver.allocate()
        top = solver.levels[-1]
        rng = np.random.default_rng(21)
        isl = (slice(None),) + (slice(1, -1),) * 3
        rhs = state["cc"][top][IRHS]
        rhs[isl] = torch.from_numpy(rng.normal(size=rhs[isl].shape))
        for _ in range(2):
            state, res = solver.fas_vcycle(state)
        results.append((state["cc"][top][IPHI].clone(), float(res)))
        assert bool(calls) == use_kernel
    assert torch.equal(results[0][0], results[1][0])
    assert results[0][1] == results[1][1]
