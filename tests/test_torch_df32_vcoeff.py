"""The double-float pair arithmetic, ``residual_df32_vcoeff`` and the
variable-coefficient refined solve of the PyTorch package against the
JAX package's, on the CPU.

Inputs come from numpy seeds and go through both packages.  The JAX
functions run eagerly (one XLA program per operation), so neither side
can contract a multiply-add: the pair operations and the residual are
compared BITWISE (``np.array_equal``), one sequence of IEEE float32
operations in both packages.

The refined solves (float32 inner FMG, 16^3) are held to the bounds of
the JAX package's tests/test_df32.py:483-525: the norm history falls to
1e-10 of its first entry, and the refined solution, put through the
JAX package's float64 operator with the float64 coefficients, leaves a
residual at most 1e-9 of the first norm (the pair arithmetic is ~2^-47
relative, not error-free).  Against the JAX package's own refined
solution: ``1e-11 * max|x|`` (both end ~1e-12 of the first norm from the
one float64-class solution; the float32 inner FMGs round differently,
tests/test_torch_refine.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octree_mg_tpu as ref
from octree_mg_tpu.ops import dense_kernels as jdk
from octree_mg_tpu.ops import df32 as jdf
from octree_mg_tpu.ops.ghost import bc_coeffs as ref_bc_coeffs
from octree_mg_tpu.solve.refine import solve_refined as ref_solve_refined

import octree_mg_tpu_torch as port
from octree_mg_tpu_torch.ops import dense_kernels as dk
from octree_mg_tpu_torch.ops import df32 as tdf
from octree_mg_tpu_torch.solve.refine import RefinedPoisson, solve_refined

from test_torch_vcoeff import np_sync

# The suite runs in several worker processes on a few cores and these
# tensors are small: one intra-op thread per process keeps the
# workers from oversubscribing the cores.
torch.set_num_threads(1)

ISL = dk._ISL
OPS = {"vlaplacian": (0.0, 1), "vhelmholtz": (0.53, 1),
       "ahelmholtz": (0.31, 3)}


def f32_pairs(rng, shape, n=2):
    """n float32 pairs (hi, lo) with |lo| <= ulp(hi)/2, as numpy."""
    out = []
    for _ in range(n):
        a = rng.normal(size=shape) * 3.0 + 0.5
        out.append(tdf.split_f64(a))
    return out


def as_t(pair):
    return tuple(torch.from_numpy(np.asarray(p)) for p in pair)


def as_j(pair):
    return tuple(jnp.asarray(p) for p in pair)


@pytest.mark.parametrize("op", ["df_add", "df_sub", "df_mul", "df_div"])
def test_pair_ops_match_reference_bitwise(op):
    rng = np.random.default_rng(1)
    a, b = f32_pairs(rng, (64, 33))
    got = getattr(tdf, op)(as_t(a), as_t(b))
    want = getattr(jdf, op)(as_j(a), as_j(b))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert np.array_equal(g.numpy(), np.asarray(w))
    # a host pair as the second operand (lam in the residual)
    lam = tuple(float(v) for v in tdf.split_f64(np.float64(0.31)))
    if op == "df_mul":
        got = tdf.df_mul(as_t(a), lam)
        want = jdf.df_mul(as_j(a), lam)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    s = tdf.df_scale_pow2(as_t(a), 2.0 ** 9)
    assert np.array_equal(s[0].numpy(), np.asarray(a[0]) * np.float32(512))


def cfg_pair(n_eps, bc_kind, dims=(16, 8, 32), periodic=(False,) * 3):
    """One level config in both packages; per-dim power-of-two spacing."""
    dr = tuple(1.0 / n for n in dims)
    idr2 = tuple(1.0 / h ** 2 for h in dr)
    if bc_kind == "dirichlet":
        kinds = [("DIRICHLET", v) for v in (0.5, -0.25, 0.1, 0.3, 0.0, 1.0)]
    else:
        kinds = [("NEUMANN", 0.3), ("NEUMANN", -0.1), ("CONTINUOUS", 0.0),
                 ("CONTINUOUS", 0.0), ("DIRICHLET", 0.5), ("DIRICHLET", -0.25)]
    bc = [tuple(ref_bc_coeffs(getattr(ref.BCType, k), dr[nb // 2], nb))
          for nb, (k, _) in enumerate(kinds)]
    b = [v for _, v in kinds]
    j = jdk.DenseStencilConfig(dims, idr2, bc, periodic, jnp.float32,
                               b_const=b, interpret=True, n_eps=n_eps)
    t = dk.DenseStencilConfig(dims, idr2, bc, periodic, torch.float32,
                              b_const=b, n_eps=n_eps)
    return j, t


def test_gate_matches_reference():
    for n_eps in (0, 1, 3):
        for kind in ("dirichlet", "mixed"):
            j, t = cfg_pair(n_eps, kind)
            assert tdf.df32_vcoeff_ok(t) == jdf.df32_vcoeff_ok(j) == bool(
                n_eps)
            assert tdf.df32_ok(t) == jdf.df32_ok(j) is False
    j, t = cfg_pair(1, "dirichlet", dims=(16, 12, 16))   # 1/dy^2 = 144
    assert tdf.df32_vcoeff_ok(t) == jdf.df32_vcoeff_ok(j) is False


@pytest.mark.parametrize("n_eps,bc_kind,lam,periodic", [
    (1, "dirichlet", 0.0, (False,) * 3),
    (1, "mixed", 0.53, (True, False, True)),
    (3, "dirichlet", 0.31, (False,) * 3),
    (3, "mixed", 0.0, (False, True, False)),
])
def test_residual_vcoeff_matches_reference_bitwise(n_eps, bc_kind, lam,
                                                   periodic):
    dims = (16, 8, 32)
    j, t = cfg_pair(n_eps, bc_kind, dims, periodic)
    rng = np.random.default_rng(7)
    shape = dk.padded_shape(dims)

    def pair(scale=1.0, offset=0.0):
        hi, lo = tdf.split_f64(offset + scale * rng.normal(size=shape))
        return (np_sync(hi, dims, periodic), np_sync(lo, dims, periodic))

    x, rhs = pair(), pair()
    eps = [pair(0.2, 1.0) for _ in range(n_eps)]
    cbs = tdf._cb_pairs(t)
    lam_pair = tdf.split_lam(lam)
    assert cbs == jdf._cb_pairs(j) and lam_pair == jdf.split_lam(lam)
    got = tdf.residual_df32_vcoeff(t, *as_t(x), *as_t(rhs),
                                   tuple(as_t(e) for e in eps), cbs=cbs,
                                   lam_pair=lam_pair)
    want = jdf.residual_df32_vcoeff(j, *as_j(x), *as_j(rhs),
                                    tuple(as_j(e) for e in eps), cbs=cbs,
                                    lam_pair=lam_pair)
    assert got.dtype == torch.float32
    assert np.array_equal(got[ISL].numpy(), np.asarray(want)[ISL])


def refined_pair(operator, size=16):
    dsz = np.full(3, size)
    tp = port.build_rectangle(3, dsz, 8, 1.0 / dsz, np.zeros(3))
    sv = port.DenseMGSolver(tp, port.MGConfig(
        operator=operator, dtype=torch.float32, device="cpu"))
    sv.set_bc(0, port.BCType.DIRICHLET, 0.0)
    rng = np.random.default_rng(3)
    rhs64 = rng.normal(size=(size,) * 3)
    n_eps = OPS[operator][1] if operator in OPS else 0
    eps64 = [0.5 + rng.random((size,) * 3) for _ in range(n_eps)]
    return sv, rhs64, eps64


def f64_residual(operator, rhs64, x64, eps64, lam):
    """max |rhs - A(x)| with the JAX package's float64 operator and the
    float64 coefficients (independent of the port)."""
    size = rhs64.shape[0]
    dsz = np.full(3, size)
    tree = ref.build_rectangle(3, dsz, 8, 1.0 / dsz, np.zeros(3))
    sv6 = ref.DenseMGSolver(tree, ref.MGConfig(operator=operator,
                                               dtype=jnp.float64))
    sv6.set_bc(0, ref.BCType.DIRICHLET, 0.0)
    st6 = sv6.allocate()
    top = sv6.levels[-1]
    st6 = sv6.set_interior(st6, top, "phi", jnp.asarray(x64))
    for i, e in enumerate(eps64):
        st6 = sv6.set_interior(st6, top, f"eps{i}", jnp.asarray(e))
    st6 = sv6.apply_operator(st6, lam=lam)
    r = np.asarray(st6["ires"][top][ISL])
    return float(np.max(np.abs(rhs64 - r)))


@pytest.mark.parametrize("operator", list(OPS))
def test_refined_vcoeff_solve_f64_class(operator):
    lam, _ = OPS[operator]
    sv, rhs64, eps64 = refined_pair(operator)
    st = sv.allocate()
    rhi, rlo = tdf.split_f64(rhs64)
    xhi, xlo, norms, st = solve_refined(sv, st, rhi, rlo, n_outer=10,
                                        lam=lam, eps=eps64)
    assert norms[-1] <= 1e-10 * norms[0], norms
    x64 = xhi.double().numpy() + xlo.double().numpy()
    worst = f64_residual(operator, rhs64, x64, eps64, lam)
    assert worst <= 1e-9 * norms[0], (worst, norms)
    # the hi parts of the coefficients now sit on the inner solver
    top = sv.levels[-1]
    assert np.array_equal(sv.interior(st, top, f"eps{len(eps64) - 1}")
                          .numpy(), eps64[-1].astype(np.float32))


@pytest.mark.slow
@pytest.mark.parametrize("operator", list(OPS))
def test_refined_vcoeff_solve_matches_reference(operator):
    """The JAX package's refined solve of the same problem (compiles its
    outer program, ~8 s each; the tier-1 run holds the port to the
    independent float64 operator above instead)."""
    lam, _ = OPS[operator]
    sv, rhs64, eps64 = refined_pair(operator)
    rhi, rlo = tdf.split_f64(rhs64)
    xhi, xlo, norms, _ = solve_refined(sv, sv.allocate(), rhi, rlo,
                                       n_outer=10, lam=lam, eps=eps64)
    dsz = np.full(3, 16)
    tree = ref.build_rectangle(3, dsz, 8, 1.0 / dsz, np.zeros(3))
    js = ref.DenseMGSolver(tree, ref.MGConfig(operator=operator,
                                              dtype=jnp.float32))
    js.set_bc(0, ref.BCType.DIRICHLET, 0.0)
    jxh, jxl, jnorms, _ = ref_solve_refined(js, js.allocate(), rhi, rlo,
                                            n_outer=10, lam=lam, eps=eps64)
    np.testing.assert_allclose(norms, jnorms, rtol=1e-3,
                               atol=1e-12 * jnorms[0])
    want = np.asarray(jxh, np.float64) + np.asarray(jxl, np.float64)
    got = xhi.double().numpy() + xlo.double().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-11 * np.max(np.abs(want)))


def test_refine_vcoeff_gate_errors():
    """A vcoeff solver needs eps=, a constant-coefficient one refuses it,
    lam needs a helmholtz-family solver, the field count must match."""
    sv, _, eps64 = refined_pair("vlaplacian")
    with pytest.raises(ValueError, match="eps"):
        RefinedPoisson(sv)
    with pytest.raises(ValueError, match="helmholtz"):
        RefinedPoisson(sv, lam=0.5, eps=eps64)
    sa, _, eps3 = refined_pair("ahelmholtz")
    with pytest.raises(ValueError, match="3"):
        RefinedPoisson(sa, eps=eps3[:1])
    sc, _, _ = refined_pair("laplacian")
    with pytest.raises(ValueError, match="eps"):
        RefinedPoisson(sc, eps=[np.ones((16,) * 3)])
    with pytest.raises(TypeError, match="float32"):
        t = cfg_pair(1, "dirichlet")[1]
        f64 = dk.DenseStencilConfig(t.dims, t.idr2, t.bc, t.periodic,
                                    torch.float64, b_const=t.b_const,
                                    n_eps=1)
        z = torch.zeros(f64.pshape, dtype=torch.float64)
        tdf.residual_df32_vcoeff(f64, z, z, z, z, ((z, z),))


def test_tensor_coefficients_split_like_numpy():
    """eps= may be float64 tensors: the split is numpy's split_f64."""
    sv, rhs64, eps64 = refined_pair("vhelmholtz")
    a = RefinedPoisson(sv, lam=0.53, eps=eps64)
    b = RefinedPoisson(sv, lam=0.53, eps=[torch.from_numpy(eps64[0])])
    for pa, pb in zip(a._eps_pairs[0], b._eps_pairs[0]):
        assert torch.equal(pa, pb)
