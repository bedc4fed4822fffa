"""solve/refine (RefinedPoisson, solve_refined, PoissonSolver.solve_refined)
of the PyTorch package against the JAX package's, on the CPU at 32^3.

Both packages start from identical bits (numpy seeds; the double-float
pair crosses with ``convert.df_pair_from_numpy``).  One module-scoped
JAX solver is shared, so its FMG program compiles once.

Tolerances, each with its reason:

* the double-float pair after an accumulation and the residual ``r_hi``:
  bitwise (error-free transformations, one IEEE sequence in both
  packages; tests/test_torch_df32.py);
* the inner FMG's correction: ``1e-4 * max|correction|``.  XLA:CPU
  contracts ``a*b+c`` inside the FMG program and PyTorch's eager ops do
  not; in float32 a contracted rounding moves a GSRB update by ~1 ulp
  (6e-8) of the largest value, and the chain of some forty kernel calls
  of a 32^3 FMG, each within ``64 * eps32`` of the reference's like the
  float64 phases of tests/test_torch_dense_kernels.py, stays three
  decades inside this bound (measured ~1e-6);
* norm histories: ``rtol = 1e-4`` plus ``atol = 1e-12 * norms[0]``.  A
  norm is the maximum of a residual that the previous (float32,
  differently rounded) correction left, so it inherits that correction's
  relative difference; below ~1e-12 of the first norm the residual sits
  on the double-float floor (~2^-45 of the stencil terms), where the two
  loops' rounding noise differs by percents of that floor;
* the converged solution ``x_hi + x_lo``: ``1e-11 * max|x|``.  Both
  loops end with residuals ~1e-12 of the first, so both solutions sit
  that close to the one float64 solution (measured 1e-14).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_mg_tpu.ops import df32 as jdf
from octree_mg_tpu.solve.refine import RefinedPoisson as RefRefined
from octree_mg_tpu.solve.refine import solve_refined as ref_solve_refined

import octree_mg_tpu_torch as port
from octree_mg_tpu_torch import convert
from octree_mg_tpu_torch.ops import dense_kernels as dk
from octree_mg_tpu_torch.ops import df32 as tdf
from octree_mg_tpu_torch.solve.refine import RefinedPoisson, solve_refined

from test_torch_df32 import OVERRIDE, np_residual64, solver_pair

# The suite runs in several worker processes on a few cores and these
# tensors are small: one intra-op thread per process keeps the
# workers from oversubscribing the cores.
torch.set_num_threads(1)

SIZE = 32
ISL = dk._ISL


def as64(hi, lo):
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def assert_norms_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-12 * want[0])


def rhs_pair(seed):
    rhs64 = np.random.default_rng(seed).normal(size=(SIZE,) * 3)
    return rhs64, tdf.split_f64(rhs64)


@pytest.fixture(scope="module")
def pair():
    """Dirichlet-0 laplacian solvers of both packages and the JAX
    package's refined solve of one right-hand side (compiles its FMG)."""
    js, ts = solver_pair("dirichlet0")
    rhs64, (rh, rl) = rhs_pair(7)
    jrp = RefRefined(js, nch=4)
    xh, xl, norms, jstate = jrp.solve(js.allocate(), rh, rl, n_outer=8)
    return dict(js=js, ts=ts, jrp=jrp, jstate=jstate, rhs64=rhs64, rh=rh,
                rl=rl, x_ref=as64(xh, xl), norms_ref=norms)


def test_one_outer_iteration_matches_reference(pair):
    """accumulate -> residual -> zero-guess FMG from one double-float
    state in both packages."""
    js, ts, jrp = pair["js"], pair["ts"], pair["jrp"]
    top = js.levels[-1]
    rng = np.random.default_rng(11)
    pshape = dk.padded_shape(ts.dims[top])

    def padded(v):
        a = np.zeros(pshape, np.float32)
        a[ISL] = v
        return a

    xh, xl = (padded(v) for v in tdf.split_f64(rng.normal(size=(SIZE,) * 3)))
    e32 = padded((1e-3 * rng.normal(size=(SIZE,) * 3)).astype(np.float32))
    rh, rl = padded(pair["rh"]), padded(pair["rl"])

    # reference: the pieces of its loop, as its solve calls them
    jxh, jxl = jrp._jit_accum(jnp.asarray(xh), jnp.asarray(xl),
                              jnp.asarray(e32))
    mx_ref, r_ref = jrp._jit_residual(jxh, jxl, jnp.asarray(rh),
                                      jnp.asarray(rl))
    jstate = js.set_interior(pair["jstate"], top, "rhs", r_ref)
    jstate, _ = js.fas_fmg(jstate, need_res=False)
    corr_ref = np.asarray(js.interior(jstate, top, "phi"))

    trp = RefinedPoisson(ts)
    tstate = ts.allocate()
    convert.df_pair_from_numpy(trp, "x", xh, xl)
    convert.df_pair_from_numpy(trp, "rhs", rh, rl)
    assert trp.cbs == jrp.cbs and trp.lam_pair == jrp.lam_pair
    with torch.no_grad():
        tdf.accumulate_df32_(trp.x_hi, trp.x_lo, torch.from_numpy(e32),
                             trp._scratch)
        got_h, got_l = convert.df_pair_to_numpy(trp, "x")
        assert np.array_equal(got_h[ISL], np.asarray(jxh)[ISL])
        assert np.array_equal(got_l[ISL], np.asarray(jxl)[ISL])
        mx = trp._outer(tstate)
    assert float(mx) == float(mx_ref)
    assert np.array_equal(ts.interior(tstate, top, "rhs").numpy(),
                          np.asarray(r_ref))
    corr = ts.interior(tstate, top, "phi").numpy()
    np.testing.assert_allclose(corr, corr_ref, rtol=0,
                               atol=1e-4 * np.max(np.abs(corr_ref)))
    # the outer ends with the accumulation of its own correction
    want_h, want_l = jdf.accumulate_df32(jxh, jxl, jnp.asarray(
        np.pad(corr, ((dk.PZ,) * 2, (dk.PY,) * 2, (0, 0)))))
    got_h, got_l = convert.df_pair_to_numpy(trp, "x")
    assert np.array_equal(got_h[ISL], np.asarray(want_h)[ISL])
    assert np.array_equal(got_l[ISL], np.asarray(want_l)[ISL])


def test_refined_solve_matches_reference(pair):
    ts = pair["ts"]
    xh, xl, norms, state = solve_refined(ts, ts.allocate(), pair["rh"],
                                         pair["rl"], n_outer=8, nch=4)
    assert len(norms) == 9 and norms[-1] <= 1e-10 * norms[0], norms
    assert_norms_close(norms, pair["norms_ref"])
    x = as64(xh.numpy(), xl.numpy())
    np.testing.assert_allclose(x, pair["x_ref"], rtol=0,
                               atol=1e-11 * np.max(np.abs(pair["x_ref"])))
    # and x satisfies the float64 operator to the same class
    cfg = ts._kcfgs[ts.levels[-1]]
    r64 = np_residual64(cfg, x, pair["rhs64"])
    assert np.max(np.abs(r64)) <= 1e-8 * norms[0]


def test_refined_solve_rtol_stops_early_and_reuses_buffers(pair):
    ts = pair["ts"]
    rp = RefinedPoisson(ts)
    state = ts.allocate()
    _, _, norms, _ = rp.solve(state, pair["rh"], pair["rl"], n_outer=8,
                              rtol=1e-6)
    assert len(norms) < 9 and norms[-2] <= 1e-6 * norms[0] < norms[-3]
    ptrs = [t.data_ptr() for t in rp._buffers]
    xh, xl, again, _ = rp.solve(state, pair["rh"], pair["rl"], n_outer=8)
    assert [t.data_ptr() for t in rp._buffers] == ptrs
    assert_norms_close(again, pair["norms_ref"])
    assert xh.data_ptr() == rp.x_hi[ISL].data_ptr()


def test_refined_solve_inhomogeneous_bc():
    """True boundary values through bc_values: the inner FMG runs the
    homogeneous error equation, and the converged x satisfies the
    inhomogeneous float64 operator."""
    _, ts = solver_pair("dirichlet0")
    rhs64, (rh, rl) = rhs_pair(13)
    xh, xl, norms, _ = solve_refined(ts, ts.allocate(), rh, rl, n_outer=8,
                                     bc_values=OVERRIDE)
    assert norms[-1] <= 1e-10 * norms[0], norms
    cfg = ts._kcfgs[ts.levels[-1]]
    r64 = np_residual64(cfg, as64(xh.numpy(), xl.numpy()), rhs64,
                        bvals=OVERRIDE)
    assert np.max(np.abs(r64)) <= 1e-8 * norms[0]


def test_refined_solve_helmholtz():
    lam = 0.37
    _, ts = solver_pair("dirichlet0", operator="helmholtz")
    rhs64, (rh, rl) = rhs_pair(23)
    xh, xl, norms, _ = solve_refined(ts, ts.allocate(), rh, rl, n_outer=8,
                                     lam=lam)
    assert norms[-1] <= 1e-10 * norms[0], norms
    cfg = ts._kcfgs[ts.levels[-1]]
    r64 = np_residual64(cfg, as64(xh.numpy(), xl.numpy()), rhs64, lam=lam)
    assert np.max(np.abs(r64)) <= 1e-8 * norms[0]


@pytest.mark.slow
@pytest.mark.parametrize("lam,bvals", [(0.37, None), (0.0, OVERRIDE)])
def test_refined_solve_variants_match_reference(lam, bvals):
    """Helmholtz and inhomogeneous boundary values against the JAX
    package's loop (each compiles another FMG program)."""
    js, ts = solver_pair("dirichlet0",
                         operator="helmholtz" if lam else "laplacian")
    _, (rh, rl) = rhs_pair(29)
    jxh, jxl, jnorms, _ = ref_solve_refined(
        js, js.allocate(), rh, rl, n_outer=8, nch=4, bc_values=bvals, lam=lam)
    xh, xl, norms, _ = solve_refined(ts, ts.allocate(), rh, rl, n_outer=8,
                                     bc_values=bvals, lam=lam)
    assert_norms_close(norms, jnorms)
    want = as64(jxh, jxl)
    np.testing.assert_allclose(as64(xh.numpy(), xl.numpy()), want, rtol=0,
                               atol=1e-11 * np.max(np.abs(want)))


def test_gate_errors():
    """RefinedPoisson's refusals (lam without a helmholtz solver, eps= on
    a constant-coefficient one, inhomogeneous inner BCs, a float64
    solver, spacing outside the df32 gate), and solve_refined's for a
    solver it has no class for, naming ROADMAP A10b (the 2D forests)."""
    _, ts = solver_pair("dirichlet0")
    with pytest.raises(ValueError, match="helmholtz"):
        RefinedPoisson(ts, lam=0.37)
    with pytest.raises(ValueError, match="eps"):
        RefinedPoisson(ts, eps=[np.ones((SIZE,) * 3)])
    _, inhom = solver_pair("dirichlet_val")
    with pytest.raises(ValueError, match="homogeneous"):
        RefinedPoisson(inhom)
    dsz = np.full(3, SIZE)
    tree = port.build_rectangle(3, dsz, 8, 1.0 / dsz, np.zeros(3))
    f64 = port.make_solver(tree, port.MGConfig(device="cpu"))
    with pytest.raises(ValueError, match="float32"):
        RefinedPoisson(f64)
    _, odd = solver_pair(size=24)
    with pytest.raises(ValueError, match="df32 gate"):
        RefinedPoisson(odd)
    with pytest.raises(NotImplementedError, match="A10b"):
        solve_refined(object(), None, None, None)


def test_poisson_solver_solve_refined(pair):
    """The model's entry point: a float64 array and an (hi, lo) pair give
    the same bits; float64 numpy [Z, Y, X] comes back."""
    ps = port.PoissonSolver(3, (SIZE,) * 3, 8, dtype=torch.float32,
                            device="cpu")
    ps.set_dirichlet(0.0)
    phi, info = ps.solve_refined(pair["rhs64"], n_outer=8)
    assert isinstance(phi, np.ndarray) and phi.dtype == np.float64
    assert phi.shape == (SIZE,) * 3 and info["cycles"] == 8
    assert_norms_close(info["residuals"], pair["norms_ref"])
    np.testing.assert_allclose(phi, pair["x_ref"], rtol=0,
                               atol=1e-11 * np.max(np.abs(pair["x_ref"])))
    rp = ps._refined[1]
    phi2, info2 = ps.solve_refined((pair["rh"], pair["rl"]), n_outer=8)
    assert ps._refined[1] is rp
    assert np.array_equal(phi, phi2)
    assert info2["residuals"] == info["residuals"]
    phi3, _ = ps.solve_refined(pair["rhs64"], n_outer=2, bc_values=OVERRIDE)
    assert ps._refined[1] is not rp and np.isfinite(phi3).all()


def test_df_pair_converters_check_their_input(pair):
    rp = RefinedPoisson(pair["ts"])
    good = np.zeros(rp.pshape, np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.df_pair_from_numpy(rp, "x", good[1:], good)
    with pytest.raises(TypeError, match="float32"):
        convert.df_pair_from_numpy(rp, "rhs", good.astype(np.float64), good)
    with pytest.raises(ValueError, match="which"):
        convert.df_pair_to_numpy(rp, "phi")


@pytest.mark.parametrize("have_guess", [False, True])
def test_fmg_mode_fused_equals_split_on_cpu(have_guess):
    """CPU states have no CUDA graphs: both modes run one eager sequence
    (bitwise).  An unknown mode is refused."""
    dsz = np.full(3, 16)
    rhs = np.random.default_rng(3).normal(size=(16,) * 3)
    out = {}
    for mode in ("split", "fused"):
        tree = port.build_rectangle(3, dsz, 8, 1.0 / dsz, np.zeros(3))
        sv = port.make_solver(tree, port.MGConfig(
            dtype=torch.float32, device="cpu", fmg_mode=mode))
        st = sv.allocate()
        sv.set_interior(st, sv.levels[-1], "rhs", rhs)
        for _ in range(3):      # fused: eager, capture, replay on a card
            sv.fas_fmg(st, have_guess=have_guess, need_res=False)
        assert not sv._graphs
        out[mode] = sv.interior(st, sv.levels[-1], "phi").numpy().copy()
    assert np.array_equal(out["split"], out["fused"])
    with pytest.raises(ValueError, match="fmg_mode"):
        port.make_solver(tree, port.MGConfig(device="cpu", fmg_mode="one"))
