"""ops/df32 of the PyTorch package against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both packages.  The JAX
functions run eagerly (one XLA program per operation), so neither side
can contract a multiply-add and every comparison of float32 results
below is BITWISE (``np.array_equal``): the two packages repeat one
sequence of IEEE operations.  Under ``jit`` XLA:CPU may contract
``lam_h*x_lo + lam_l*x_hi`` of the Helmholtz term (two inexact
products and an add); that sum sits in the compensation channel, so a
contraction could move ``r_hi`` by at most one ulp.  The jitted and the
interpret-mode (Pallas body) comparisons therefore allow 1 ulp of
max|r| where lam != 0 and ask 0 elsewhere (every other product of the
expression is exact, so an FMA rounds as a multiply and an add do).

Against float64: the double-float residual must reach
``3e-7 * max|r| + 1e-11 * idr2 * max|x|`` (its own float32 rounding plus
the ~2^-45 representation floor of the stencil terms), the bound of the
JAX package's tests/test_df32.py, held here against an independent numpy
float64 stencil.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octree_mg_tpu as ref
from octree_mg_tpu.ops import dense_kernels as jdk
from octree_mg_tpu.ops import df32 as jdf

import octree_mg_tpu_torch as port
from octree_mg_tpu_torch.ops import dense_kernels as dk
from octree_mg_tpu_torch.ops import df32 as tdf

# The suite runs in several worker processes on a few cores and these
# tensors are small: one intra-op thread per process keeps the
# workers from oversubscribing the cores.
torch.set_num_threads(1)

SIZE, BOX = 32, 8
ISL = dk._ISL

BC_CASES = {
    "dirichlet0": [("DIRICHLET", 0.0)] * 6,
    "dirichlet_val": [("DIRICHLET", 0.5), ("DIRICHLET", -0.25),
                      ("DIRICHLET", 0.1), ("DIRICHLET", 0.3),
                      ("DIRICHLET", 0.0), ("DIRICHLET", 1.0)],
    "mixed": [("NEUMANN", 0.3), ("NEUMANN", -0.1),
              ("CONTINUOUS", 0.0), ("CONTINUOUS", 0.0),
              ("DIRICHLET", 0.5), ("DIRICHLET", -0.25)],
}
OVERRIDE = [0.5, -0.25, 0.1, 0.3, 0.0, 1.0]


def solver_pair(case="dirichlet0", operator="laplacian", size=SIZE):
    """The same tree and BCs as a float32 dense solver in both packages
    (no program is compiled by building them)."""
    dsz = np.full(3, size)
    per = [case == "periodic"] * 3
    out = []
    for pkg, kw in ((ref, dict(dtype=jnp.float32)),
                    (port, dict(dtype=torch.float32, device="cpu"))):
        tree = pkg.build_rectangle(3, dsz, BOX, 1.0 / dsz, np.zeros(3),
                                   periodic=per)
        sv = pkg.make_solver(tree, pkg.MGConfig(operator=operator, **kw))
        for nb, (t, v) in enumerate(BC_CASES.get(case, [])):
            sv.set_bc(0, getattr(pkg.BCType, t), v, nb=nb)
        out.append(sv)
    return out


def top_cfgs(case="dirichlet0", operator="laplacian", size=SIZE):
    js, ts = solver_pair(case, operator, size)
    return js._kcfgs[js.levels[-1]], ts._kcfgs[ts.levels[-1]]


def padded(cfg, interior):
    """Interior values in a padded float32 numpy field; periodic pads
    wrapped (the solver's job), the others NaN: no pad may reach a cell."""
    a = np.full(cfg.pshape, np.nan, np.float32)
    a[ISL] = interior
    t = torch.from_numpy(a)
    dk.sync_pads(cfg, t)
    return t.numpy()


def pair_inputs(tcfg, seed, near_solution=False, lam=0.0, bvals=None):
    """Padded (x_hi, x_lo, rhs_hi, rhs_lo) plus the float64 x and rhs
    they represent.  near_solution: rhs = A(x) + 1e-6 noise, the regime
    refinement lives in (the residual is tiny against its terms)."""
    rng = np.random.default_rng(seed)
    Z, Y, X = tcfg.Z, tcfg.Y, tcfg.X
    x64 = rng.normal(size=(Z, Y, X))
    xh, xl = tdf.split_f64(x64)
    xr = xh.astype(np.float64) + xl.astype(np.float64)
    if near_solution:
        rhs64 = (-np_residual64(tcfg, xr, np.zeros_like(xr), lam, bvals)
                 + 1e-6 * rng.normal(size=(Z, Y, X)))
    else:
        rhs64 = rng.normal(size=(Z, Y, X))
    rh, rl = tdf.split_f64(rhs64)
    rr = rh.astype(np.float64) + rl.astype(np.float64)
    return [padded(tcfg, v) for v in (xh, xl, rh, rl)], xr, rr


def np_residual64(cfg, x, rhs, lam=0.0, bvals=None):
    """rhs - A(x) in numpy float64, written independently of both
    packages: ghost cells c0*b + c1*x1 + c2*x2 on physical faces, wraps
    on periodic axes, A = sum_d idr2*(lo + hi - 2x) - lam*x."""
    b = cfg.b_const if bvals is None else bvals
    a = -lam * x
    for d, axis in ((0, 2), (1, 1), (2, 0)):
        lo = np.roll(x, +1, axis)
        hi = np.roll(x, -1, axis)
        if not cfg.periodic[d]:
            first = [slice(None)] * 3
            second, last, before = list(first), list(first), list(first)
            first[axis], second[axis] = 0, 1
            last[axis], before[axis] = -1, -2
            c0, c1, c2 = cfg.bc[2 * d]
            lo[tuple(first)] = (c0 * b[2 * d] + c1 * x[tuple(first)]
                                + c2 * x[tuple(second)])
            c0, c1, c2 = cfg.bc[2 * d + 1]
            hi[tuple(last)] = (c0 * b[2 * d + 1] + c1 * x[tuple(last)]
                               + c2 * x[tuple(before)])
        a = a + cfg.idr2[d] * (lo + hi - 2.0 * x)
    return rhs - a


def f32(rng, n, scale=1.0):
    return (scale * rng.normal(size=n)).astype(np.float32)


def as64(*parts):
    return sum(np.asarray(p, np.float64) for p in parts)


# ---------------------------------------------------------------------------
# error-free transformations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,scalar", [
    ("two_sum", None), ("two_sum", 0.5), ("two_sum", 0.25),
    ("fast_two_sum", None),
    ("two_prod", None), ("two_prod", float(np.float32(0.3))),
    ("two_prod", float(np.float32(1.0 / 3.0)))])
def test_eft_exact_and_bitwise(name, scalar):
    """s + e (p + e) equals the float64 sum (product) of the operands
    exactly (float32 operands: both are exact in float64), and both
    halves equal the JAX functions' bit for bit."""
    rng = np.random.default_rng(2)
    a = f32(rng, 4096)
    b = f32(rng, 4096, 1e-3) if name == "fast_two_sum" else f32(rng, 4096)
    if name == "fast_two_sum":
        a = np.where(np.abs(a) >= np.abs(b), a, np.float32(1.0))
    tb = torch.from_numpy(b) if scalar is None else scalar
    jb = jnp.asarray(b) if scalar is None else scalar
    got = getattr(tdf, name)(torch.from_numpy(a), tb)
    want = getattr(jdf, name)(jnp.asarray(a), jb)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    b64 = np.float64(scalar) if scalar is not None else b.astype(np.float64)
    exact = (a.astype(np.float64) * b64 if name == "two_prod"
             else a.astype(np.float64) + b64)
    assert np.array_equal(as64(got[0].numpy(), got[1].numpy()), exact)


def test_veltkamp_split_scalar_matches_tensor():
    """A host scalar is split with the same float32 operations as a
    tensor element."""
    for v in (0.3, 1.0 / 3.0, 0.37, -1234.567):
        v32 = float(np.float32(v))
        hi, lo = tdf.veltkamp_split(v32)
        thi, tlo = tdf.veltkamp_split(torch.tensor([v32], dtype=torch.float32))
        assert (hi, lo) == (float(thi[0]), float(tlo[0]))
        jhi, jlo = jdf.veltkamp_split(jnp.float32(v32))
        assert (hi, lo) == (float(jhi), float(jlo))


def test_accumulate_df32_exact_in_place_and_bitwise():
    """Twenty accumulations of float32 corrections over six decades:
    the pair tracks the float64 sum to 1e-12 (the pair's ~2^-48), the
    in-place form allocates nothing and equals the returning form and the
    JAX function bit for bit."""
    rng = np.random.default_rng(1)
    x64 = np.zeros(1000)
    jhi = jlo = jnp.zeros(1000, jnp.float32)
    thi = tlo = torch.zeros(1000)
    ihi, ilo = torch.zeros(1000), torch.zeros(1000)
    scratch = [torch.empty(1000) for _ in range(3)]
    ptrs = (ihi.data_ptr(), ilo.data_ptr())
    for _ in range(20):
        d = f32(rng, 1000) * np.float32(10.0 ** rng.integers(-6, 0))
        x64 = x64 + d.astype(np.float64)
        jhi, jlo = jdf.accumulate_df32(jhi, jlo, jnp.asarray(d))
        thi, tlo = tdf.accumulate_df32(thi, tlo, torch.from_numpy(d))
        tdf.accumulate_df32_(ihi, ilo, torch.from_numpy(d), scratch)
    assert (ihi.data_ptr(), ilo.data_ptr()) == ptrs
    for a, b, c in ((thi, ihi, jhi), (tlo, ilo, jlo)):
        assert np.array_equal(a.numpy(), np.asarray(c))
        assert np.array_equal(b.numpy(), np.asarray(c))
    got = as64(thi.numpy(), tlo.numpy())
    assert np.max(np.abs(got - x64)) <= 1e-12 * np.max(np.abs(x64))


# ---------------------------------------------------------------------------
# host helpers and the gate
# ---------------------------------------------------------------------------

def test_split_f64_and_split_lam_match_reference():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(5, 7)) * 10.0 ** rng.integers(-8, 8, size=(5, 7))
    for g, w in zip(tdf.split_f64(a), jdf.split_f64(a)):
        assert g.dtype == np.float32 and np.array_equal(g, w)
    hi, lo = tdf.split_f64(a)
    assert np.max(np.abs(as64(hi, lo) - a) / np.abs(a)) < 2.0 ** -47
    for lam in (0.0, 0.37, 1.0 / 3.0, -2.5):
        assert tdf.split_lam(lam) == jdf.split_lam(lam)
    assert tdf.split_lam(0.0) is None


@pytest.mark.parametrize("case", list(BC_CASES) + ["periodic"])
def test_gate_and_cb_pairs_match_reference(case):
    jcfg, tcfg = top_cfgs(case)
    assert tdf.df32_ok(tcfg) and jdf.df32_ok(jcfg)
    assert tdf._cb_pairs(tcfg) == jdf._cb_pairs(jcfg)
    assert tdf._cb_pairs(tcfg, OVERRIDE) == jdf._cb_pairs(jcfg, OVERRIDE)


def test_gate_rejects_what_the_reference_rejects():
    # non-power-of-two spacing
    jcfg, tcfg = top_cfgs(size=24)
    assert not tdf.df32_ok(tcfg) and not jdf.df32_ok(jcfg)
    # plane-valued faces, unequal spacing
    idr2 = (1024.0,) * 3
    bc = [(2.0, -1.0, 0.0)] * 6
    planes = dk.DenseStencilConfig((8, 8, 8), idr2, bc, (False,) * 3,
                                   torch.float32, b_const=[None] * 6)
    assert not tdf.df32_ok(planes)
    uneq = dk.DenseStencilConfig((8, 8, 8), (1024.0, 1024.0, 256.0), bc,
                                 (False,) * 3, torch.float32,
                                 b_const=[0.0] * 6)
    assert not tdf.df32_ok(uneq)
    ok = dk.DenseStencilConfig((8, 8, 8), idr2, bc, (False,) * 3,
                               torch.float32, b_const=[0.0] * 6)
    z = torch.zeros(ok.pshape)
    with pytest.raises(ValueError, match="gate"):
        tdf.residual_df32_dense(uneq, z, z, z, z)
    with pytest.raises(TypeError, match="float32"):
        tdf.residual_df32_dense(ok, z.double(), z, z, z)
    f64 = dk.DenseStencilConfig((8, 8, 8), idr2, bc, (False,) * 3,
                                torch.float64, b_const=[0.0] * 6)
    with pytest.raises(TypeError, match="float32"):
        tdf.residual_df32(f64, z, z, z, z)


# ---------------------------------------------------------------------------
# the residual
# ---------------------------------------------------------------------------

RESIDUAL_CASES = [("dirichlet0", 0.0, None), ("dirichlet_val", 0.0, None),
                  ("mixed", 0.0, None), ("periodic", 0.0, None),
                  ("mixed", 0.37, None), ("dirichlet0", 0.0, OVERRIDE)]


@pytest.mark.parametrize("case,lam,bvals", RESIDUAL_CASES)
def test_residual_matches_reference_bitwise(case, lam, bvals):
    """The plain version (also through the wrapper, which takes it for a
    CPU tensor) against the JAX package's residual_df32 run eagerly:
    0 ulp, NaN in every non-periodic pad."""
    operator = "helmholtz" if lam else "laplacian"
    jcfg, tcfg = top_cfgs(case, operator)
    args, _, _ = pair_inputs(tcfg, seed=3)
    jcbs = jdf._cb_pairs(jcfg, bvals)
    tcbs = tdf._cb_pairs(tcfg, bvals)
    want = np.asarray(jdf.residual_df32(
        jcfg, *[jnp.asarray(a) for a in args], cbs=jcbs,
        lam_pair=jdf.split_lam(lam)))[ISL]
    targs = [torch.from_numpy(a) for a in args]
    got = tdf.residual_df32(tcfg, *targs, cbs=tcbs,
                            lam_pair=tdf.split_lam(lam))[ISL].numpy()
    assert np.isfinite(want).all()
    assert np.array_equal(got, want)
    before = dk.launch_counts()
    out = torch.full(tcfg.pshape, float("nan"))
    r = tdf.residual_df32_dense(tcfg, *targs, cbs=tcbs,
                                lam_pair=tdf.split_lam(lam), out=out)
    assert r is out and np.array_equal(out[ISL].numpy(), want)
    assert dk.launch_counts() == before     # no kernel on a CPU tensor


@pytest.mark.parametrize("case,lam,bvals", RESIDUAL_CASES)
def test_residual_matches_float64(case, lam, bvals):
    """x near a solution: the double-float residual recovers the true
    float64 residual to float32-relative accuracy plus the
    representation floor, where a plain float32 residual of the rounded
    x is at least 50 times worse (its cancellation noise is absolute in
    the size of the stencil terms)."""
    operator = "helmholtz" if lam else "laplacian"
    _, tcfg = top_cfgs(case, operator)
    args, xr, rr = pair_inputs(tcfg, seed=1, near_solution=True, lam=lam,
                               bvals=bvals)
    r64 = np_residual64(tcfg, xr, rr, lam, bvals)
    targs = [torch.from_numpy(a) for a in args]
    r32 = tdf.residual_df32(tcfg, *targs, cbs=tdf._cb_pairs(tcfg, bvals),
                            lam_pair=tdf.split_lam(lam))[ISL].numpy()
    scale = tcfg.idr2[0] * np.max(np.abs(xr))
    rmax = np.max(np.abs(r64))
    err = np.max(np.abs(r32 - r64))
    assert err <= 3e-7 * rmax + 1e-11 * scale, (err, rmax, scale)
    if bvals is None:
        plain = dk.stencil_apply_dense(
            tcfg, torch.from_numpy(padded(tcfg, xr.astype(np.float32))),
            torch.from_numpy(padded(tcfg, rr.astype(np.float32))),
            tcfg.rnd(lam), [None] * 6, residual=True)[ISL].numpy()
        err_plain = np.max(np.abs(plain - r64))
        assert err_plain > 50 * err, (err_plain, err)


def test_residual_matches_reference_under_jit():
    """The compiled JAX residual (what its solver runs): 0 ulp for the
    laplacian; for lam != 0 XLA may contract lam_h*x_lo + lam_l*x_hi,
    bound 1 ulp of max|r| (module docstring)."""
    for lam in (0.0, 0.37):
        jcfg, tcfg = top_cfgs("mixed", "helmholtz" if lam else "laplacian")
        args, _, _ = pair_inputs(tcfg, seed=5)
        want = np.asarray(jax.jit(lambda *w: jdf.residual_df32(
            jcfg, *w, lam_pair=jdf.split_lam(lam)))(
            *[jnp.asarray(a) for a in args]))[ISL]
        got = tdf.residual_df32(tcfg, *[torch.from_numpy(a) for a in args],
                                lam_pair=tdf.split_lam(lam))[ISL].numpy()
        tol = np.spacing(np.float32(np.max(np.abs(want)))) if lam else 0.0
        assert np.max(np.abs(got - want)) <= tol


@pytest.mark.slow
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("lam", [0.0, 0.37])
def test_residual_matches_pallas_body(periodic, lam):
    """(128, 16, 16) is kernel-eligible in the JAX package:
    residual_df32_dense runs the Pallas body in interpret mode.  0 ulp
    for the laplacian, 1 ulp of max|r| with lam (module docstring)."""
    X, Y, Z = 128, 16, 16
    bc = [(2.0, -1.0, 0.0), (0.0, 1.0, 0.0),   # dirichlet / neumann0
          (0.0, 2.0, -1.0), (2.0, -1.0, 0.0),  # continuous / dirichlet
          (2.0, -1.0, 0.0), (0.0, 1.0, 0.0)]
    b_const = [0.5, 0.0, 0.0, -0.25, 1.0, 0.0]
    idr2 = (64.0,) * 3
    jcfg = jdk.DenseStencilConfig(
        dims=(X, Y, Z), idr2=idr2, bc=bc, periodic=(periodic,) * 3,
        dtype=jnp.float32, b_const=b_const, interpret=True)
    assert jcfg.use_kernel and jdf.df32_ok(jcfg)
    tcfg = dk.DenseStencilConfig((X, Y, Z), idr2, bc, (periodic,) * 3,
                                 torch.float32, b_const=b_const)
    rng = np.random.default_rng(5)
    # the Pallas window reads non-periodic pads too (and masks them):
    # zeros there, as the reference's own test has
    args = []
    for _ in range(4):
        a = padded(tcfg, f32(rng, (Z, Y, X)))
        args.append(np.nan_to_num(a, nan=0.0))
    want = np.asarray(jdf.residual_df32_dense(
        jcfg, *[jnp.asarray(a) for a in args],
        lam_pair=jdf.split_lam(lam)))[ISL]
    got = tdf.residual_df32_dense(
        tcfg, *[torch.from_numpy(a) for a in args],
        lam_pair=tdf.split_lam(lam))[ISL].numpy()
    tol = np.spacing(np.float32(np.max(np.abs(want)))) if lam else 0.0
    assert np.max(np.abs(got - want)) <= tol
