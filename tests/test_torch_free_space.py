"""The free-space Poisson drivers of the PyTorch package against the JAX
package's (``solve/free_space.py``), float64 on the CPU.

The Gaussian charge of tests/test_free_space.py (sigma 0.1, centred;
analytic potential erf(r/sigma)/(4 pi r)).  Trees: ``build_rectangle``
at 32^3 box 8 (dense, FFT level 16^3) and 16^3 box 4 (boxed), and
``build_amr_centered(3, 2, ...)``.  The reference's drivers run as its
tests run them; its FMG is replaced by a no-op on the solver instance
where a test holds the seeding phases (restriction, FFT, planes, BC
installation, seeded guess) apart from the cycle.

Bounds:

* the IGF kernel (``_green_kernel_hat``): 1e-13 of max|kernel_hat|
  (numpy and torch differ by an ulp in ``log``/``atan``, and the FFTs
  sum 8 M^3 such terms in different orders);
* everything downstream of an FFT (potential, planes, installed BC
  values, seeded guess, whole solves): 1e-13 of the field's max|.|
  (the FFTs' summation orders; the arithmetic after them is the same);
* ``_sharpen_rho``: bitwise, float64 and float32 (eager, same order,
  a true division by 24);
* ``_fft_convolve`` in float32: 64 float32 ulp of max|ref| (the forward
  transform runs in complex64 in both packages, in different orders);
* the interpolated BC values from the reference's own planes: bitwise
  (float64 weights, the same products in the same order).
"""
import numpy as np
import pytest
import torch
from scipy.special import erf

import jax.numpy as jnp

import octree_mg_tpu as ref
from octree_mg_tpu.solve import free_space as rfs

import octree_mg_tpu_torch as port
from octree_mg_tpu_torch import IPHI, IRHS, convert
from octree_mg_tpu_torch.solve import free_space as pfs

torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps
EPS32 = float(np.finfo(np.float32).eps)
FFT_BOUND = 1e-13
R0 = np.array([0.5, 0.5, 0.5])
SIGMA = 0.1


def analytic_solution(x):
    r = np.linalg.norm(x - R0, axis=-1)
    fac = 1.0 / (4 * np.pi)
    small = r < np.sqrt(np.finfo(float).eps)
    rs = np.where(small, 1.0, r)
    val = fac * erf(rs / SIGMA) / rs
    return np.where(small, 2 * fac / (np.sqrt(np.pi) * SIGMA), val)


def gaussian_rhs(x):
    r = (x - R0) / SIGMA
    return (-1.0 / (SIGMA ** 3 * np.pi * np.sqrt(np.pi))
            * np.exp(-np.sum(r ** 2, axis=-1)))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def no_cycle(sv, zero):
    """Replace the solver instance's FMG and V-cycle by no-ops (the
    seeding phases alone)."""
    sv.fas_fmg = lambda st, **kw: (st, zero)
    sv.fas_vcycle = lambda st, **kw: (st, zero)


# ---------------------------------------------------------------------------
# the kernels and the convolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nx,dr", [
    ((16, 16, 16), (1 / 16,) * 3),
    ((6, 8, 10), (0.1, 0.05, 0.07))], ids=["cube", "box"])
def test_igf_kernel_matches_reference(nx, dr):
    nx, dr = np.array(nx), np.array(dr)
    want = np.asarray(rfs._green_kernel_hat(nx, dr))
    got = pfs._green_kernel_hat(nx, dr, "cpu")
    assert got.dtype == torch.complex128 and want.dtype == np.complex128
    assert tuple(got.shape) == want.shape
    assert rel(got.numpy(), want) <= FFT_BOUND


@pytest.mark.parametrize("nx,dr", [
    ((18, 18, 18), (1 / 16,) * 3),
    ((8, 10, 12), (0.1, 0.05, 0.07))], ids=["cube", "box"])
def test_spectral_kernel_matches_reference(nx, dr):
    nx, dr = np.array(nx), np.array(dr)
    want, ps_w = rfs._green_kernel_hat_spectral(nx, dr)
    got, ps_g = pfs._green_kernel_hat_spectral(nx, dr, "cpu")
    assert ps_g == ps_w
    assert got.dtype == torch.float64
    assert rel(got.numpy(), want) <= FFT_BOUND


def test_good_fft_size_matches_reference():
    assert [pfs._good_fft_size(n) for n in range(1, 400)] == \
        [rfs._good_fft_size(n) for n in range(1, 400)]


def random_rho(shape, dtype, seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sharpen_rho_bitwise(dtype):
    rho = random_rho((10, 12, 14), dtype)
    want = np.asarray(rfs._sharpen_rho(jnp.asarray(rho)))
    got = pfs._sharpen_rho(torch.from_numpy(rho)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kernel", ["igf", "spectral"])
def test_fft_convolve_matches_reference(dtype, kernel):
    """The convolution with the reference's kernel: the port keeps the
    kernel's dtype, so a float32 convolution multiplies and inverts in
    complex128 / float64 and casts back, as there."""
    nx, dr = np.array([8, 10, 6]), np.array([0.1, 0.08, 0.12])
    rho = random_rho((8, 12, 10), dtype)          # [z, y, x] = nx + 2
    if kernel == "igf":
        khat, ps = rfs._green_kernel_hat(nx + 2, dr), None
    else:
        khat, ps = rfs._green_kernel_hat_spectral(nx + 2, dr)
    want = np.asarray(rfs._fft_convolve(jnp.asarray(rho), khat, ps))
    got = pfs._fft_convolve(torch.from_numpy(rho),
                            torch.from_numpy(np.array(khat)), ps).numpy()
    assert got.dtype == want.dtype == dtype
    bound = FFT_BOUND if dtype == np.float64 else 64 * EPS32
    assert rel(got, want) <= bound


# ---------------------------------------------------------------------------
# the dense driver
# ---------------------------------------------------------------------------

def dense_pair(size, box, **kw):
    dsz = np.full(3, size)
    rs = ref.DenseMGSolver(ref.build_rectangle(3, dsz, box, 1.0 / dsz,
                                               np.zeros(3)),
                           ref.MGConfig(operator="laplacian"))
    ps = port.DenseMGSolver(port.build_rectangle(3, dsz, box, 1.0 / dsz,
                                                 np.zeros(3)),
                            port.MGConfig(operator="laplacian", device="cpu"))
    return rs, rfs.make_free_space(rs, **kw), ps, pfs.make_free_space(ps,
                                                                      **kw)


def dense_rhs(rs, js, ps, ts):
    for lvl in rs.levels:
        g = gaussian_rhs(rs.cell_centers(lvl))
        js = rs.set_interior(js, lvl, "rhs", jnp.asarray(g))
        ps.set_interior(ts, lvl, "rhs", g)
    return js, ts


@pytest.fixture(scope="module")
def dense_ref():
    """The reference's dense driver at 32^3 box 8 (FFT level 16^3): the
    seeding alone (its FMG a no-op), then two solves (new_rhs, then a
    second FMG)."""
    rs, rf, _, _ = dense_pair(32, 8)
    js = rs.allocate()
    for lvl in rs.levels:
        js = rs.set_interior(js, lvl, "rhs",
                             jnp.asarray(gaussian_rhs(rs.cell_centers(lvl))))
    out = {"fft_lvl": rf.fft_lvl, "levels": rs.levels, "dims": rs.dims}
    seed_sv = ref.DenseMGSolver(rs.tree, ref.MGConfig(operator="laplacian"))
    seed_fs = rfs.make_free_space(seed_sv)
    no_cycle(seed_sv, jnp.asarray(0.0))
    st, _ = seed_fs.solve(dict(js), new_rhs=True)
    c = seed_fs.cache
    out["seed"] = {
        "phi": {l: np.asarray(seed_sv.interior(st, l, "phi"))
                for l in rs.levels},
        "bc": {l: [np.asarray(p) for p in st["bc"][l]] for l in rs.levels},
        "cache": {"kernel_hat": np.asarray(c.kernel_hat),
                  "planes": {nb: np.asarray(p) for nb, p in c.planes.items()},
                  "phi_global": np.asarray(c.phi_global)}}
    top = rs.levels[-1]
    sol = analytic_solution(rs.cell_centers(top))
    errs, res = [], []
    for n in range(2):
        js, r = rf.solve(js, new_rhs=(n == 0))
        phi = np.asarray(rs.interior(js, top, "phi"))
        errs.append(float(np.max(np.abs(phi - sol))))
        res.append(float(r))
    out.update(phi=phi, errs=errs, res=res)
    return out


def port_dense(size=32, box=8, **kw):
    _, _, ps, pf = dense_pair(size, box, **kw)
    ts = ps.allocate()
    for lvl in ps.levels:
        ps.set_interior(ts, lvl, "rhs", gaussian_rhs(ps.cell_centers(lvl)))
    return ps, pf, ts


def test_dense_seeding_matches_reference(dense_ref):
    """FFT level, potential, boundary planes, installed BC planes on
    every level and the seeded guess on every level."""
    ps, pf, ts = port_dense()
    assert pf.fft_lvl == dense_ref["fft_lvl"] and ps.levels == \
        dense_ref["levels"]
    no_cycle(ps, torch.zeros((), dtype=torch.float64))
    ts, _ = pf.solve(ts, new_rhs=True)
    want = dense_ref["seed"]
    assert pf.cache.kernel_hat.dtype == torch.complex128
    assert rel(pf.cache.kernel_hat.numpy(),
               want["cache"]["kernel_hat"]) <= FFT_BOUND
    assert rel(pf.cache.phi_global.numpy(),
               want["cache"]["phi_global"]) <= FFT_BOUND
    for nb in range(6):
        assert rel(pf.cache.planes[nb].numpy(),
                   want["cache"]["planes"][nb]) <= FFT_BOUND
    for lvl in ps.levels:
        for a, b in zip(ts["bc"][lvl], want["bc"][lvl]):
            assert a.shape == b.shape
            assert rel(a.numpy(), b) <= FFT_BOUND
        assert rel(ps.interior(ts, lvl, "phi").numpy(),
                   want["phi"][lvl]) <= FFT_BOUND


def test_dense_install_from_reference_planes_is_bitwise(dense_ref):
    """The reference's cache carried over (free_space_cache_from_numpy):
    the installed BC planes are its bits on every level."""
    ps, pf, ts = port_dense()
    cache = convert.free_space_cache_from_numpy(pf, dense_ref["seed"][
        "cache"])
    assert pf.cache is cache and cache.kernel_hat.dtype == torch.complex128
    ts = pf._install_bc_values(ts)
    for lvl in ps.levels:
        for a, b in zip(ts["bc"][lvl], dense_ref["seed"]["bc"][lvl]):
            np.testing.assert_array_equal(a.numpy(), b)


def test_dense_solve_matches_reference(dense_ref):
    """Two solves (the FFT-seeded FMG, then one more): phi, errors against
    the analytic potential and residuals as the reference's; converged
    after the first (the reference's errs[0] < 2 errs[-1])."""
    ps, pf, ts = port_dense()
    top = ps.levels[-1]
    sol = analytic_solution(ps.cell_centers(top))
    errs, res = [], []
    for n in range(2):
        ts, r = pf.solve(ts, new_rhs=(n == 0))
        phi = ps.interior(ts, top, "phi").numpy()
        errs.append(float(np.max(np.abs(phi - sol))))
        res.append(float(r))
    assert rel(phi, dense_ref["phi"]) <= FFT_BOUND
    np.testing.assert_allclose(errs, dense_ref["errs"], rtol=1e-10)
    np.testing.assert_allclose(res, dense_ref["res"], rtol=1e-8)
    assert errs[0] < 2 * errs[-1]


def test_dense_kernel_from_reference_cache(dense_ref):
    """With the reference's kernel carried over, the port's own solve
    phases give its potential and guess: the kernel build is held apart
    (the bound: the FFTs alone)."""
    ps, pf, ts = port_dense()
    c = dense_ref["seed"]["cache"]
    convert.free_space_cache_from_numpy(pf, {"kernel_hat": c["kernel_hat"]})
    no_cycle(ps, torch.zeros((), dtype=torch.float64))
    ts, _ = pf.solve(ts, new_rhs=True)
    assert rel(pf.cache.phi_global.numpy(), c["phi_global"]) <= FFT_BOUND
    top = ps.levels[-1]
    assert rel(ps.interior(ts, top, "phi").numpy(),
               dense_ref["seed"]["phi"][top]) <= FFT_BOUND


def test_cache_from_numpy_checks_shapes(dense_ref):
    _, pf, _ = port_dense()
    c = dense_ref["seed"]["cache"]
    with pytest.raises(ValueError, match="kernel_hat"):
        convert.free_space_cache_from_numpy(pf, {"kernel_hat": c[
            "kernel_hat"][:-1]})
    with pytest.raises(ValueError, match="phi_global"):
        convert.free_space_cache_from_numpy(pf, {
            "kernel_hat": c["kernel_hat"],
            "phi_global": c["phi_global"][1:]})
    with pytest.raises(TypeError, match="complex128"):
        convert.free_space_cache_from_numpy(pf, {
            "kernel_hat": c["kernel_hat"].astype(np.complex64)})


def test_dense_spectral_fft_only():
    """test_dense_driver_spectral_fft_only: the FFT level forced to the
    top (max_fft_frac=1.0), kernel="spectral": phi is the spectral solve
    at the reference's standalone accuracy (1e-10 against the analytic
    potential) and the reference's phi within the FFT bound."""
    rs, rf, ps, pf = dense_pair(32, 8, max_fft_frac=1.0, kernel="spectral")
    top = ps.levels[-1]
    assert rf.fft_lvl == pf.fft_lvl == top
    js, ts = dense_rhs(rs, rs.allocate(), ps, ps.allocate())
    js, _ = rf.solve(js, new_rhs=True)
    ts, res = pf.solve(ts, new_rhs=True)
    phi = ps.interior(ts, top, "phi").numpy()
    assert float(res) == 0.0
    assert np.max(np.abs(phi - analytic_solution(ps.cell_centers(top)))) \
        < 1e-10
    assert rel(phi, rs.interior(js, top, "phi")) <= FFT_BOUND


def test_bc_order_either_way():
    """The driver may be made before or after ``allocate`` (the dense
    test makes it before, the boxed test after, in the reference): the
    same phi either way, bit for bit."""
    out = []
    for before in (True, False):
        dsz = np.full(3, 16)
        ps = port.DenseMGSolver(port.build_rectangle(
            3, dsz, 4, 1.0 / dsz, np.zeros(3)),
            port.MGConfig(operator="laplacian", device="cpu"))
        pf = pfs.make_free_space(ps, max_fft_frac=0.5) if before else None
        ts = ps.allocate()
        if not before:
            pf = pfs.make_free_space(ps, max_fft_frac=0.5)
        for lvl in ps.levels:
            ps.set_interior(ts, lvl, "rhs",
                            gaussian_rhs(ps.cell_centers(lvl)))
        ts, _ = pf.solve(ts, new_rhs=True)
        out.append(ps.interior(ts, ps.levels[-1], "phi").clone())
    assert torch.equal(out[0], out[1])


def test_what_raises_as_in_the_reference():
    dsz = np.full(3, 16)
    per = port.DenseMGSolver(port.build_rectangle(
        3, dsz, 4, 1.0 / dsz, np.zeros(3), periodic=[True] * 3),
        port.MGConfig(operator="laplacian", device="cpu"))
    with pytest.raises(ValueError, match="non-periodic"):
        pfs.make_free_space(per)
    _, _, ps, pf = dense_pair(16, 4)
    with pytest.raises(ValueError, match="kernel"):
        pfs.make_free_space(ps, kernel="isf")
    with pytest.raises(ValueError, match="new_rhs"):
        pf.solve(ps.allocate(), new_rhs=False)
    helm = port.MGSolver(port.build_rectangle(3, dsz, 4, 1.0 / dsz,
                                              np.zeros(3)),
                         port.MGConfig(operator="helmholtz", device="cpu"))
    with pytest.raises(ValueError, match="Laplacian"):
        pfs.make_free_space(helm)
    with pytest.raises(TypeError, match="DenseMGSolver"):
        pfs.FreeSpacePoisson3DDense(helm)


def test_dense_amr_route_raises_value_error_in_both_packages():
    """make_free_space sends the dense-patch AMR solver to the dense
    driver in both packages: construction succeeds (FFT level 0), and
    solve(new_rhs=True) raises ValueError on the seeding prolongation
    into the first patch level — the JAX package's scatter refuses
    (64, 64, 64) into (32, 32, 32), and the port says the same."""
    args = (3, 2, np.full(3, 32), 8, np.full(3, 1.0 / 32))
    rs = ref.make_solver(ref.build_amr_centered(*args),
                         ref.MGConfig(operator="laplacian"))
    ps = port.make_solver(port.build_amr_centered(*args),
                          port.MGConfig(operator="laplacian", device="cpu"))
    assert isinstance(rs, ref.DenseAMRMGSolver)
    assert isinstance(ps, port.DenseAMRMGSolver)
    rf, pf = rfs.make_free_space(rs), pfs.make_free_space(ps)
    assert isinstance(pf, pfs.FreeSpacePoisson3DDense)
    assert rf.fft_lvl == pf.fft_lvl == 0
    msg = r"\(64, 64, 64\) and requested shape \(32, 32, 32\)"
    with pytest.raises(ValueError, match=msg):
        rf.solve(rs.allocate(), new_rhs=True)
    with pytest.raises(ValueError, match=msg):
        pf.solve(ps.allocate(), new_rhs=True)


# ---------------------------------------------------------------------------
# the boxed driver
# ---------------------------------------------------------------------------

def boxed_pair(tree_fn):
    rs = ref.MGSolver(tree_fn(ref), ref.MGConfig(operator="laplacian"))
    ps = port.MGSolver(tree_fn(port), port.MGConfig(operator="laplacian",
                                                    device="cpu"))
    js, ts = rs.allocate(), ps.allocate()
    isl = (slice(None),) + (slice(1, -1),) * 3
    for lvl in rs.levels:
        x = rs.cell_centers(lvl)
        rhs = np.zeros(x.shape[:-1])
        rhs[isl] = gaussian_rhs(x[isl])
        js["cc"][lvl] = js["cc"][lvl].at[IRHS].set(jnp.asarray(rhs))
        ts["cc"][lvl][IRHS] = torch.from_numpy(rhs)
    # the drivers are made after allocate, as tests/test_free_space.py does
    return rs, rfs.FreeSpacePoisson3D(rs), js, ps, pfs.make_free_space(ps), ts


def uniform16(pkg):
    dsz = np.full(3, 16)
    return pkg.build_rectangle(3, dsz, 4, 1.0 / dsz, np.zeros(3))


def amr16(pkg):
    return pkg.build_amr_centered(3, 2, np.full(3, 16), 4,
                                  np.full(3, 1.0 / 16))


@pytest.mark.parametrize("tree_fn", [uniform16, amr16],
                         ids=["uniform", "amr"])
def test_boxed_seeding_matches_reference(tree_fn):
    """The boxed driver's seeding (its FMG a no-op in both packages): FFT
    level, installed BC values on every level's physical faces, and the
    seeded guess on every level."""
    rs, rf, js, ps, pf, ts = boxed_pair(tree_fn)
    assert isinstance(pf, pfs.FreeSpacePoisson3D)
    assert pf.fft_lvl == rf.fft_lvl
    no_cycle(rs, jnp.asarray(0.0))
    no_cycle(ps, torch.zeros((), dtype=torch.float64))
    js, _ = rf.solve(js, new_rhs=True)
    ts, _ = pf.solve(ts, new_rhs=True)
    assert rel(pf.cache.phi_global.numpy(), rf.cache.phi_global) <= \
        FFT_BOUND
    for lvl in rs.levels:
        for a, b in zip(ts["bc"][lvl], js["bc"][lvl]):
            assert rel(a.numpy(), b) <= FFT_BOUND
        assert rel(ts["cc"][lvl][IPHI].numpy(), js["cc"][lvl][IPHI]) <= \
            FFT_BOUND


def boxed_errors(sv, st, tree):
    """Max leaf error against the analytic potential over levels >= 1."""
    isl = (slice(1, -1),) * 3
    err = 0.0
    for lvl in range(1, tree.highest_lvl + 1):
        leaves = tree.lvls[lvl].leaves
        if not len(leaves):
            continue
        locs = tree.loc_in_level(leaves, lvl)
        x = sv.cell_centers(lvl)[locs][(slice(None),) + isl]
        phi = np.asarray(st["cc"][lvl][IPHI])[locs][(slice(None),) + isl]
        err = max(err, float(np.max(np.abs(phi - analytic_solution(x)))))
    return err


@pytest.mark.parametrize("tree_fn", [uniform16, amr16],
                         ids=["uniform", "amr"])
def test_boxed_solve_converges(tree_fn):
    """Three solves of the port's boxed driver: converged after the first
    (the reference's max(errs) < 2 min(errs)) at the discretization
    level of a 16^3 grid, residual falling."""
    _, _, _, ps, pf, ts = boxed_pair(tree_fn)
    errs, res = [], []
    for n in range(3):
        ts, r = pf.solve(ts, new_rhs=(n == 0))
        errs.append(boxed_errors(ps, ts, ps.tree))
        res.append(float(r))
    assert max(errs) < 2 * min(errs), errs
    assert errs[-1] < 5e-2, errs
    assert res[-1] < res[0]


@pytest.mark.slow
@pytest.mark.parametrize("tree_fn", [uniform16, amr16],
                         ids=["uniform", "amr"])
def test_boxed_solve_matches_reference(tree_fn):
    """Three solves against the reference's (its compiled boxed FMG takes
    ~30 s per tree): leaf errors and residuals."""
    rs, rf, js, ps, pf, ts = boxed_pair(tree_fn)
    for n in range(3):
        js, r_ref = rf.solve(js, new_rhs=(n == 0))
        ts, r = pf.solve(ts, new_rhs=(n == 0))
        np.testing.assert_allclose(float(r), float(r_ref), rtol=1e-8)
        np.testing.assert_allclose(boxed_errors(ps, ts, ps.tree),
                                   boxed_errors(rs, js, rs.tree), rtol=1e-10)
    for lvl in rs.levels:
        assert rel(ts["cc"][lvl][IPHI].numpy(), js["cc"][lvl][IPHI]) <= \
            FFT_BOUND
