"""The 2D refined mode (RefinedPoisson2D, residual_df32_2d, df32_ok_2d)
of the PyTorch package against the JAX package's, on the CPU.

Mirrors the 2D cases of tests/test_df32.py: a 64^2 float32 laplacian
(box 16, Dirichlet 0 on the inner solver, the true boundary values
through ``bc_values``), and the periodic and mixed-BC residual cases.

Bounds:

* the gate and the host constants (``_cb_pairs``): equal;
* the double-float residual: bitwise the JAX package's eager function
  (every operation of both is one IEEE float32 op, no contraction), and
  within the JAX test's bound of the true float64 residual;
* the whole refined solve: the JAX package's step and inner FMG are
  compiled programs (XLA contracts multiply-adds; the port's eager ops
  do not), so its norm history agrees within 1e-4 relative while a norm
  is above 1e-9 of the first (measured: 1e-5; the last bits part at the
  double-float floor) and the solution within 1e-12 of max|x| (measured:
  4e-14); both reach the float64 class (the f64 residual of x_hi + x_lo
  below 1e-8 of the first norm, as the JAX test asks).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octree_mg_tpu as ref
from octree_mg_tpu.ops import df32 as rdf
from octree_mg_tpu.solve import refine as rrefine

import octree_mg_tpu_torch as port
from octree_mg_tpu_torch import convert
from octree_mg_tpu_torch.ops import dense2d as pd2
from octree_mg_tpu_torch.ops import df32 as pdf
from octree_mg_tpu_torch.solve.refine import Df32GateError, RefinedPoisson2D

torch.set_num_threads(1)

SIZE = 64
BVALS = [0.3, 0.0, 0.5, -0.25]
MIXED = (("NEUMANN", 0.3), ("CONTINUOUS", 0.0), ("DIRICHLET", 0.5),
         ("DIRICHLET", -0.25))


def solvers(periodic=False, bc=None, size=SIZE, operator="laplacian",
            geometry="cartesian", dx=None):
    """(port, JAX) dense 2D float32 solvers on a size^2 box-16 tree."""
    dsz = np.full(2, size)
    dx = 1.0 / dsz if dx is None else np.asarray(dx)
    out = []
    for pkg, kw in ((port, dict(device="cpu", dtype=torch.float32)),
                    (ref, dict(dtype=jnp.float32))):
        t = pkg.build_rectangle(2, dsz, 16, dx, np.zeros(2),
                                periodic=[periodic] * 2)
        sv = pkg.make_solver(t, pkg.MGConfig(operator=operator,
                                             geometry=geometry, **kw))
        assert type(sv).__name__ == "Dense2DMGSolver"
        for nb, (name, v) in enumerate(bc or ()):
            sv.set_bc(0, getattr(pkg.BCType, name), v, nb=nb)
        out.append(sv)
    return out


def f64_residual(cfg, x64, rhs64, b_const):
    """rhs - A(x) in float64 through the port's own 2D operator."""
    cfg64 = pd2.Dense2DConfig(dims=cfg.dims, idr2=cfg.idr2, bc=cfg.bc,
                              periodic=cfg.periodic, dtype=torch.float64,
                              b_const=b_const)
    return pd2.stencil_apply_2d(cfg64, torch.as_tensor(x64),
                                torch.as_tensor(rhs64), 0.0, [None] * 4,
                                residual=True).numpy()


# ---------------------------------------------------------------------------
# gate, constants, residual
# ---------------------------------------------------------------------------

def test_gate_and_constants_match_reference():
    """df32_ok_2d agrees with the JAX package's on the exact classes and
    on what it refuses (cylindrical, coefficients, spacing that is not a
    power of two, plane-valued faces); the c0*b pairs are equal."""
    cases = [dict(), dict(periodic=True), dict(bc=MIXED),
             dict(geometry="cylindrical"), dict(operator="vhelmholtz"),
             dict(dx=(0.013, 0.013)), dict(dx=(1 / 64, 1 / 32))]
    for kw in cases:
        sp, sr = solvers(size=32, **kw)
        top = sp.levels[-1]
        pc, rc = sp._kcfgs[top], sr._kcfgs[top]
        assert pdf.df32_ok_2d(pc) == rdf.df32_ok_2d(rc), kw
        assert pdf._cb_pairs(pc, BVALS) == rdf._cb_pairs(rc, BVALS)
    sp, sr = solvers(size=32)
    sp.set_bc(0, port.BCType.DIRICHLET, fn=lambda x: x[..., 0])
    sr.set_bc(0, ref.BCType.DIRICHLET, fn=lambda x: x[..., 0])
    top = sp.levels[-1]
    assert not pdf.df32_ok_2d(sp._kcfgs[top])
    assert not rdf.df32_ok_2d(sr._kcfgs[top])


@pytest.mark.parametrize("case", ["mixed", "periodic", "helmholtz"])
def test_residual_2d_bitwise_reference_and_f64_class(case):
    """residual_df32_2d bitwise the JAX package's eager function (lam
    through its TwoProduct for "helmholtz"), and within the JAX test's
    bound of the true float64 residual (x near the solution, dominated by
    cancellation)."""
    lam = 0.53 if case == "helmholtz" else 0.0
    sp, sr = solvers(periodic=case == "periodic",
                     bc=MIXED if case == "mixed" else None,
                     operator="helmholtz" if lam else "laplacian")
    top = sp.levels[-1]
    pc, rc = sp._kcfgs[top], sr._kcfgs[top]
    rng = np.random.default_rng(2)
    x64 = rng.normal(size=(SIZE, SIZE))
    xhi, xlo = pdf.split_f64(x64)
    xr = xhi.astype(np.float64) + xlo.astype(np.float64)
    ax = -f64_residual(pc, xr, np.zeros((SIZE, SIZE)), pc.b_const) - lam * xr
    rhs64 = ax + 1e-6 * rng.normal(size=(SIZE, SIZE))
    rhi, rlo = pdf.split_f64(rhs64)
    lam_pair = pdf.split_lam(lam)
    assert lam_pair == rdf.split_lam(lam)
    got = pdf.residual_df32_2d(pc, *(torch.from_numpy(a) for a in
                                     (xhi, xlo, rhi, rlo)),
                               lam_pair=lam_pair)
    want = rdf.residual_df32_2d(rc, *(jnp.asarray(a) for a in
                                      (xhi, xlo, rhi, rlo)),
                                lam_pair=lam_pair)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))
    out = torch.empty((SIZE, SIZE), dtype=torch.float32)
    again = pdf.residual_df32_2d(pc, *(torch.from_numpy(a) for a in
                                       (xhi, xlo, rhi, rlo)),
                                 lam_pair=lam_pair, out=out)
    assert again is out and torch.equal(out, got)
    r64 = rhs64 - ax
    scale = float(pc.idr2[0]) * float(np.abs(x64).max())
    err = float(np.abs(got.numpy().astype(np.float64) - r64).max())
    assert err <= 3e-7 * float(np.abs(r64).max()) + 1e-11 * scale, err


def test_residual_2d_refuses_outside_its_gate():
    sp, _ = solvers(size=32, dx=(0.013, 0.013))
    cfg = sp._kcfgs[sp.levels[-1]]
    z = torch.zeros(cfg.pshape)
    with pytest.raises(ValueError, match="df32_ok_2d"):
        pdf.residual_df32_2d(cfg, z, z, z, z)
    sp64 = port.Dense2DMGSolver(sp.tree, port.MGConfig(device="cpu"))
    with pytest.raises(TypeError, match="float32"):
        pdf.residual_df32_2d(sp64._kcfgs[sp64.levels[-1]], z, z, z, z)


# ---------------------------------------------------------------------------
# the refined solve
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def refined_pair():
    """The JAX test's problem (64^2, seeded float64 rhs, bc_values BVALS,
    8 outers) through both packages' PoissonSolver.solve_refined, which
    builds RefinedPoisson2D, and through the port's solve_refined on a
    solver of its own."""
    from octree_mg_tpu.models import PoissonSolver as RefPoissonSolver
    rng = np.random.default_rng(17)
    rhs64 = rng.normal(size=(SIZE, SIZE))
    rhi, rlo = pdf.split_f64(rhs64)
    sp, _ = solvers()
    xhi, xlo, norms, _ = port.solve_refined(sp, sp.allocate(), rhi, rlo,
                                            n_outer=8, bc_values=BVALS)
    pp = port.PoissonSolver(2, (SIZE, SIZE), 16, dtype=torch.float32,
                            device="cpu")
    rp = RefPoissonSolver(2, (SIZE, SIZE), 16, dtype=jnp.float32)
    pp.set_dirichlet(0.0)
    rp.set_dirichlet(0.0)
    phi_p, info_p = pp.solve_refined(rhs64, n_outer=8, bc_values=BVALS)
    phi_r, info_r = rp.solve_refined(rhs64, n_outer=8, bc_values=BVALS)
    return dict(rhs64=rhs64, sp=sp, x=(xhi.clone(), xlo.clone()),
                norms=norms, model=pp, phi=phi_p, info=info_p,
                ref_phi=np.asarray(phi_r, np.float64), ref_info=info_r)


def test_solve_refined_2d_reaches_f64_class(refined_pair):
    """tests/test_df32.py::test_solve_refined_2d_reaches_f64_class on the
    port: the norms fall to 1e-10 of the first, and x_hi + x_lo meets the
    float64 inhomogeneous operator to 1e-8 of the first norm."""
    norms = refined_pair["norms"]
    assert len(norms) == 9
    assert norms[-1] <= 1e-10 * norms[0], norms
    sp = refined_pair["sp"]
    cfg = sp._kcfgs[sp.levels[-1]]
    xhi, xlo = refined_pair["x"]
    x64 = xhi.double().numpy() + xlo.double().numpy()
    r64 = f64_residual(cfg, x64, refined_pair["rhs64"], BVALS)
    assert np.abs(r64).max() <= 1e-8 * norms[0]


def test_solve_refined_2d_matches_reference(refined_pair):
    """solve_refined on a Dense2DMGSolver and PoissonSolver.solve_refined
    give the same bits, and they agree with the JAX package's model."""
    norms, rnorms = refined_pair["norms"], refined_pair["ref_info"][
        "residuals"]
    assert refined_pair["info"]["residuals"] == norms
    x = sum(t.double().numpy() for t in refined_pair["x"])
    assert np.array_equal(refined_pair["phi"], x)
    for a, b in zip(norms, rnorms):
        if b > 1e-9 * rnorms[0]:
            assert abs(a - b) <= 1e-4 * b, (norms, rnorms)
    rx = refined_pair["ref_phi"]
    assert np.abs(x - rx).max() <= 1e-12 * np.abs(rx).max()


def test_helmholtz_refined_reaches_f64_class():
    """lam 0.53 on a helmholtz inner solver: the TwoProduct term carries
    it; the float64 helmholtz residual of the result is below 1e-8 of the
    first norm."""
    sp, _ = solvers(size=32, operator="helmholtz")
    rng = np.random.default_rng(5)
    rhs64 = rng.normal(size=(32, 32))
    rhi, rlo = pdf.split_f64(rhs64)
    rp = RefinedPoisson2D(sp, lam=0.53)
    xhi, xlo, norms, _ = rp.solve(sp.allocate(), rhi, rlo, n_outer=8)
    assert norms[-1] <= 1e-10 * norms[0], norms
    cfg = sp._kcfgs[sp.levels[-1]]
    x64 = xhi.double().numpy() + xlo.double().numpy()
    r64 = f64_residual(cfg, x64, rhs64, [0.0] * 4) + 0.53 * x64
    assert np.abs(r64).max() <= 1e-8 * norms[0]
    # rtol stops the loop at the first norm at or below rtol * norms[0]
    _, _, short, _ = rp.solve(sp.allocate(), rhi, rlo, n_outer=8, rtol=1e-4)
    assert short[-1] <= 1e-4 * short[0] and len(short) < len(norms)
    assert short == norms[:len(short)]


def test_gates_raise_as_the_reference():
    """The JAX package's refusals, with its exception types and texts."""
    sp, sr = solvers(size=32)
    for kw, err, text in ((dict(lam=0.5), ValueError, "helmholtz"),):
        with pytest.raises(err, match=text):
            rrefine.RefinedPoisson2D(sr, **kw)
        with pytest.raises(err, match=text):
            RefinedPoisson2D(sp, **kw)
    for pkg, sv in ((port, sp), (ref, sr)):
        sv.set_bc(0, pkg.BCType.DIRICHLET, 0.5, nb=2)
    with pytest.raises(ValueError, match="homogeneous"):
        rrefine.RefinedPoisson2D(sr)
    with pytest.raises(ValueError, match="homogeneous"):
        RefinedPoisson2D(sp)
    odd_p, odd_r = solvers(size=32, dx=(0.013, 0.013))
    with pytest.raises(AssertionError) as want:
        rrefine.RefinedPoisson2D(odd_r)
    with pytest.raises(AssertionError) as got:
        RefinedPoisson2D(odd_p)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, Df32GateError)
    f64 = port.Dense2DMGSolver(odd_p.tree, port.MGConfig(device="cpu"))
    with pytest.raises(ValueError, match="f32 inner solver"):
        RefinedPoisson2D(f64)
    with pytest.raises(AssertionError):
        RefinedPoisson2D(port.DenseMGSolver(
            port.build_rectangle(3, np.full(3, 16), 8, np.full(3, 1 / 16),
                                 np.zeros(3)),
            port.MGConfig(device="cpu", dtype=torch.float32)))


def test_poisson_solver_2d_solve_refined_matches_reference_model(
        refined_pair):
    """PoissonSolver(2, ...).solve_refined (float32, Dirichlet 0 with the
    true values through bc_values) against the JAX package's model: phi
    float64 [Y, X] within 1e-12 of max|phi|, the same cycle count; an
    (hi, lo) pair gives the float64 array's bits; the refinement instance
    is kept between calls."""
    pp, phi_p, info_p = (refined_pair[k] for k in ("model", "phi", "info"))
    phi_r, info_r = refined_pair["ref_phi"], refined_pair["ref_info"]
    assert phi_p.dtype == np.float64 and phi_p.shape == (SIZE, SIZE)
    assert np.abs(phi_p - phi_r).max() <= 1e-12 * np.abs(phi_r).max()
    h = info_p["residuals"]
    assert info_p["cycles"] == info_r["cycles"] == 8
    assert h[-1] <= 1e-10 * h[0]
    kept = pp._refined[1]
    phi2, info2 = pp.solve_refined(pdf.split_f64(refined_pair["rhs64"]),
                                   n_outer=8, bc_values=BVALS)
    assert pp._refined[1] is kept
    assert np.array_equal(phi2, phi_p) and info2 == info_p


def test_df_pair_roundtrip_2d():
    """convert carries a 2D refinement's (hi, lo) pairs both ways."""
    sp, _ = solvers(size=32)
    rp = RefinedPoisson2D(sp)
    rng = np.random.default_rng(3)
    hi = rng.normal(size=(32, 32)).astype(np.float32)
    lo = (1e-9 * rng.normal(size=(32, 32))).astype(np.float32)
    convert.df_pair_from_numpy(rp, "x", hi, lo)
    back = convert.df_pair_to_numpy(rp, "x")
    assert np.array_equal(back[0], hi) and np.array_equal(back[1], lo)
    with pytest.raises(ValueError, match="shape"):
        convert.df_pair_from_numpy(rp, "rhs", hi[:-1], lo[:-1])


def test_solve_refined_routes_as_the_reference():
    """solve_refined sends a Dense2DMGSolver to RefinedPoisson2D (the same
    bits as the class itself) and names A10b where the JAX package would
    build a 2D forest."""
    sp, _ = solvers(size=32)
    rng = np.random.default_rng(9)
    rhi, rlo = pdf.split_f64(rng.normal(size=(32, 32)))
    a = port.solve_refined(sp, sp.allocate(), rhi, rlo, n_outer=3)
    b = RefinedPoisson2D(sp).solve(sp.allocate(), rhi, rlo, n_outer=3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[2] == b[2]
    with pytest.raises(NotImplementedError, match="A10b"):
        port.solve_refined(object(), None, rhi, rlo)
