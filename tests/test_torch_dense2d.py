"""The dense 2D solver (Dense2DMGSolver) of the PyTorch package against
the JAX package's, and against the port's own boxed solver, on the CPU.

Mirrors tests/test_dense2d.py: trees ``build_rectangle(2, 32^2, 8)``
(periodic or with Dirichlet faces from a function), fields made with
numpy from a seed on the port's boxed solver (ghosts filled) and the
dense interiors of both dense solvers assembled from its boxes.

Bounds, float64:

* smoothing, the residual and the operator: bitwise against the port's
  boxed ``MGSolver`` (the same arithmetic per cell in the same order, as
  the JAX tests assert for their pair) and bitwise against the JAX
  package's eager phases (every operation of both is one IEEE op);
* the cylindrical smoothing against the boxed solver within the JAX
  test's 1e-13 (the radial weights associate ``r_min + dr*i``
  differently per box); against the JAX package bitwise;
* the FAS coarse update and the correction: bitwise against the JAX
  package (its restriction is a pair of 0/1 matmuls, the port's strided
  pair sums in the same order: equal in value, the sign of an exact
  zero aside, so the comparisons use ``np.array_equal``), the JAX tests'
  5e-14 / 1e-14 against the boxed solver (whose restriction sums in
  another order);
* whole cycles: the JAX tests' 1e-13 (V-cycle against the boxed solver)
  and 5e-13 * max|reference| (FMG against the JAX package's eager FMG,
  whose probed coarse matrix comes from a compiled program).

In float32 the functions that round scalars of their own (``den0 + lam``
and its reciprocal in the working dtype, the cylindrical ``fac`` in
double, the harmonic face coefficients) are compared bitwise against
the JAX package's eager ops.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octree_mg_tpu as ref
from octree_mg_tpu.models import PoissonSolver as RefPoissonSolver
from octree_mg_tpu.ops import dense2d as rd2

import octree_mg_tpu_torch as port
from octree_mg_tpu_torch import convert
from octree_mg_tpu_torch.core.constants import IOLD, IPHI, IRES, IRHS, IVEPS
from octree_mg_tpu_torch.ops import dense2d as pd2
from octree_mg_tpu_torch.ops import dense_kernels as pdk

torch.set_num_threads(1)

N_EPS = {"laplacian": 0, "helmholtz": 0, "vlaplacian": 1, "vhelmholtz": 1,
         "ahelmholtz": 2}
OPERATORS = tuple(N_EPS)


def solution(x):
    out = 1.0
    for d in range(x.shape[-1]):
        out = out * np.sin(4 * np.pi * x[..., d])
    return out


def rel_near(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def boxed_to_dense2d(sb, st_b, lvl, iv):
    """The dense interior [Y, X] assembled from a boxed level."""
    t = sb.tree
    nc = t.box_size_lvl[lvl]
    dsz = t.domain_size_lvl[lvl]
    out = np.zeros((dsz[1], dsz[0]))
    arr = st_b["cc"][lvl][iv].numpy()
    for loc, b in enumerate(t.lvls[lvl].ids):
        ix = t.ix[b] - 1
        sl = tuple(slice(ix[d] * nc, (ix[d] + 1) * nc) for d in (1, 0))
        out[sl] = arr[loc][(slice(1, -1),) * 2]
    return out


def lam_of(operator):
    return 0.6 if operator.endswith("helmholtz") else 0.0


def setup(operator="laplacian", size=(32, 32), periodic=False,
          coarse="smooth", geometry="cartesian", r_min=(0.0, 0.0), seed=3):
    """(port boxed solver, its state, port dense 2D solver, its state,
    JAX dense 2D solver, its state) with the same random phi, rhs (and
    coefficients 0.5 + U[0, 1)) on every level."""
    dsz = np.asarray(size)
    kw = dict(operator=operator, smoother="gsrb", geometry=geometry)
    tp = port.build_rectangle(2, dsz, 8, 1.0 / dsz, np.asarray(r_min),
                              periodic=[periodic] * 2)
    tr = ref.build_rectangle(2, dsz, 8, 1.0 / dsz, np.asarray(r_min),
                             periodic=[periodic] * 2)
    sb = port.MGSolver(tp, port.MGConfig(device="cpu", **kw))
    sd = port.Dense2DMGSolver(tp, port.MGConfig(
        device="cpu", coarse_solver=coarse, **kw))
    rd = ref.Dense2DMGSolver(tr, ref.MGConfig(coarse_solver=coarse, **kw))
    if not periodic:
        sb.set_bc(IPHI, port.BCType.DIRICHLET, fn=solution)
        sd.set_bc(0, port.BCType.DIRICHLET, fn=solution)
        rd.set_bc(0, ref.BCType.DIRICHLET, fn=solution)
    st_b, st_d, st_r = sb.allocate(), sd.allocate(), rd.allocate()
    rng = np.random.default_rng(seed)
    n_eps = N_EPS[operator]
    isl = (slice(None),) + (slice(1, -1),) * 2
    for lvl in sb.levels:
        nb, nc = sb.static[lvl]["n_boxes"], sb.static[lvl]["nc"]
        fields = {IPHI: rng.normal(size=(nb, nc, nc)),
                  IRHS: rng.normal(size=(nb, nc, nc))}
        for d in range(n_eps):
            fields[IVEPS + d] = 0.5 + rng.random(size=(nb, nc, nc))
        for iv, vals in fields.items():
            st_b["cc"][lvl][(iv,) + isl] = torch.as_tensor(vals)
    for iv in [IPHI, IRHS] + [IVEPS + d for d in range(n_eps)]:
        st_b = sb.fill_ghost(st_b, iv)
    kmap = {"phi": IPHI, "rhs": IRHS}
    kmap.update({f"eps{d}": IVEPS + d for d in range(n_eps)})
    for lvl in sd.levels:
        for k, iv in kmap.items():
            vals = boxed_to_dense2d(sb, st_b, lvl, iv)
            st_d = sd.set_interior(st_d, lvl, k, vals)
            st_r = rd.set_interior(st_r, lvl, k, jnp.asarray(vals))
    return sb, st_b, sd, st_d, rd, st_r


def interior(sv, st, lvl, key):
    return np.asarray(sv.interior(st, lvl, key))


# ---------------------------------------------------------------------------
# gate, configs, state
# ---------------------------------------------------------------------------

def test_gating_and_routing():
    """dense2d_supported agrees with the JAX package's on the cases of
    its test; make_solver sends uniform 2D trees here."""
    cases = [dict(), dict(operator="ahelmholtz"), dict(smoother="jacobi"),
             dict(operator="vhelmholtz", geometry="cylindrical"),
             dict(geometry="cylindrical"), dict(operator="helmholtz")]
    dsz = np.full(2, 16)
    tp = port.build_rectangle(2, dsz, 8, 1.0 / dsz, np.zeros(2))
    tr = ref.build_rectangle(2, dsz, 8, 1.0 / dsz, np.zeros(2))
    for kw in cases:
        want = ref.dense2d_supported(tr, ref.MGConfig(**kw))
        assert port.dense2d_supported(tp, port.MGConfig(**kw)) == want, kw
        if want:
            sv = port.make_solver(tp, port.MGConfig(device="cpu", **kw))
            assert type(sv) is port.Dense2DMGSolver
    assert port.dense2d_supported(tp, port.MGConfig())
    assert not port.dense2d_supported(tp, port.MGConfig(smoother="jacobi"))
    t3 = port.build_rectangle(3, np.full(3, 16), 8, np.full(3, 1 / 16.),
                              np.zeros(3))
    assert not port.dense2d_supported(t3, port.MGConfig())
    with pytest.raises(ValueError, match="gate"):
        port.Dense2DMGSolver(t3, port.MGConfig(device="cpu"))


@pytest.mark.parametrize("operator,geometry,periodic", [
    ("laplacian", "cartesian", False), ("ahelmholtz", "cartesian", True),
    ("laplacian", "cylindrical", False)])
def test_configs_planes_and_state_roundtrip(operator, geometry, periodic):
    """Levels, per-level configs (radial weights included), boundary
    vectors and cell centres are the JAX package's; a state crosses both
    ways through convert, and a wrong vector count is refused."""
    r_min = (1.0, 0.0) if geometry == "cylindrical" else (0.0, 0.0)
    _, _, sd, st_d, rd, st_r = setup(operator, periodic=periodic,
                                     geometry=geometry, r_min=r_min)
    assert sd.levels == rd.levels and sd.dims == rd.dims
    assert sd.n_eps == rd.n_eps == N_EPS[operator]
    for lvl in sd.levels:
        pc, rc = sd._kcfgs[lvl], rd._kcfgs[lvl]
        assert pc.idr2 == rc.idr2 and pc.den0 == rc.den0
        assert pc.bc == [tuple(float(c) for c in t) for t in rc.bc]
        assert pc.b_const == rc.b_const and pc.periodic == rc.periodic
        assert pc.pshape == rc.pshape and not pc.use_kernel
        if geometry == "cylindrical":
            for a, b in zip(pc.cyl_w, rc.cyl_w):
                assert np.array_equal(a.numpy(), b)
        assert np.array_equal(sd.cell_centers(lvl), rd.cell_centers(lvl))
        assert len(st_d["bc"][lvl]) == 4
        for a, b in zip(st_d["bc"][lvl], st_r["bc"][lvl]):
            assert np.array_equal(a.numpy(), np.asarray(b))
    np_state = {k: {lvl: np.asarray(v) for lvl, v in per.items()}
                for k, per in st_r.items() if k != "bc"}
    np_state["bc"] = {lvl: [np.asarray(p) for p in ps]
                      for lvl, ps in st_r["bc"].items()}
    again = convert.state_from_numpy(sd, np_state)
    back = convert.state_to_numpy(again)
    for k in sd._field_keys:
        for lvl in sd.levels:
            assert torch.equal(again[k][lvl], st_d[k][lvl])
            assert np.array_equal(back[k][lvl], np_state[k][lvl])
    bad = dict(np_state)
    bad["bc"] = {lvl: ps[:3] for lvl, ps in np_state["bc"].items()}
    with pytest.raises(ValueError, match="4 planes"):
        convert.state_from_numpy(sd, bad)
    with pytest.raises(NotImplementedError, match="A13b"):
        sd.shard_state(again, None)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("operator", OPERATORS)
@pytest.mark.parametrize("periodic", [False, True])
def test_smooth_bitwise(operator, periodic):
    """One smoothing pair (red parity 1 first, the boxed substep order
    for ndim 2) bitwise the port's boxed smooth_boxes(1) and the JAX
    package's eager pair."""
    sb, st_b, sd, st_d, rd, st_r = setup(operator, periodic=periodic)
    lam, top = lam_of(operator), sd.levels[-1]
    st_d = sd._smooth(st_d, top, 1, sd._lam(lam))
    st_r = rd._smooth(st_r, top, 1, rd._lam(lam))
    st_b = sb._smooth_boxes(st_b, sb._to_device(), top, 1, lam)
    got = interior(sd, st_d, top, "phi")
    assert np.array_equal(got, boxed_to_dense2d(sb, st_b, top, IPHI))
    assert np.array_equal(got, interior(rd, st_r, top, "phi"))


@pytest.mark.parametrize("operator", ["helmholtz", "vhelmholtz",
                                      "ahelmholtz"])
def test_residual_and_apply_bitwise(operator):
    sb, st_b, sd, st_d, rd, st_r = setup(operator)
    lam, top = 0.7, sd.levels[-1]
    st_d = sd._residual(st_d, top, sd._lam(lam))
    st_r = rd._residual(st_r, top, rd._lam(lam))
    st_b = sb._residual_lvl(st_b, sb._to_device(), top, lam)
    got = interior(sd, st_d, top, "ires")
    assert np.array_equal(got, boxed_to_dense2d(sb, st_b, top, IRES))
    assert np.array_equal(got, interior(rd, st_r, top, "ires"))
    for lvl in sd.levels:
        a = sd._apply_op(st_d, lvl, sd._lam(lam)).numpy()
        assert np.array_equal(a, np.asarray(rd._apply_op(st_r, lvl,
                                                         rd._lam(lam))))


def test_cylindrical_phases():
    """The cylindrical laplacian's smoothing and operator: bitwise the
    JAX package's; the smoothing within the JAX test's 1e-13 of the boxed
    solver (its radial weights associate differently per box)."""
    sb, st_b, sd, st_d, rd, st_r = setup(
        "laplacian", geometry="cylindrical", r_min=(1.0, 0.0))
    top = sd.levels[-1]
    a = sd._apply_op(st_d, top, 0.0).numpy()
    assert np.array_equal(a, np.asarray(rd._apply_op(st_r, top,
                                                     rd._lam(0.0))))
    st_d = sd._smooth(st_d, top, 1, 0.0)
    st_r = rd._smooth(st_r, top, 1, rd._lam(0.0))
    st_b = sb._smooth_boxes(st_b, sb._to_device(), top, 1, 0.0)
    got = interior(sd, st_d, top, "phi")
    assert np.array_equal(got, interior(rd, st_r, top, "phi"))
    ref_b = boxed_to_dense2d(sb, st_b, top, IPHI)
    assert np.abs(got - ref_b).max() <= 1e-13


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_restriction_is_the_matmul_form(dtype):
    """The strided restriction equals the JAX package's pair-sum matmuls
    (R_y @ fine @ R_x^T * 0.25) value for value, in both dtypes, on
    random fields and on one with signed zeros: np.array_equal, since the
    matmul adds +0.0 products and may turn -0.0 into +0.0.  It writes
    into the coarse field in place."""
    dsz = np.array([64, 32])
    t = ref.build_rectangle(2, dsz, 8, 1.0 / dsz, np.zeros(2))
    jdt = jnp.float32 if dtype == np.float32 else jnp.float64
    rd = ref.Dense2DMGSolver(t, ref.MGConfig(dtype=jdt))
    top = rd.levels[-1]
    rng = np.random.default_rng(1)
    fine = rng.normal(size=(32, 64)).astype(dtype)
    zeros = np.zeros((32, 64), dtype)
    zeros[0::2, 0::2] = -0.0
    zeros[5, 7] = 1e-30
    for f in (fine, zeros, (fine * 1e6).astype(dtype)):
        st = rd.allocate()
        st = rd.set_interior(st, top, "rhs", jnp.asarray(f))
        want = np.asarray(rd._restrict_into(st, top, "rhs")["rhs"][top - 1])
        coarse = torch.zeros((16, 32), dtype=torch.from_numpy(f).dtype)
        out = pd2.restrict_2d(torch.from_numpy(f), out=coarse)
        assert out is coarse
        assert np.array_equal(coarse.numpy(), want)
        assert coarse.numpy().dtype == want.dtype


def test_update_coarse_and_correction():
    """The down-leg's FAS transfer and the up-leg correction: bitwise
    the JAX package's, within the JAX tests' bounds of the boxed
    solver's."""
    sb, st_b, sd, st_d, rd, st_r = setup("vhelmholtz", seed=11)
    lam, top = 0.4, sd.levels[-1]
    st_d = sd._update_coarse(st_d, top, sd._lam(lam))
    st_r = rd._update_coarse(st_r, top, rd._lam(lam))
    st_b = sb._update_coarse(st_b, sb._to_device(), top, lam)
    for key, iv in (("phi", IPHI), ("rhs", IRHS), ("iold", IOLD)):
        got = interior(sd, st_d, top - 1, key)
        assert np.array_equal(got, interior(rd, st_r, top - 1, key)), key
        rel_near(got, boxed_to_dense2d(sb, st_b, top - 1, iv), 5e-14, key)
    # a different coarse phi, then the correction of the top level
    rng = np.random.default_rng(4)
    new = rng.normal(size=sd._ishape(top - 1))
    st_d = sd.set_interior(st_d, top - 1, "phi", new)
    st_r = rd.set_interior(st_r, top - 1, "phi", jnp.asarray(new))
    nb, nc = sb.static[top - 1]["n_boxes"], sb.static[top - 1]["nc"]
    t = sb.tree
    for loc, b in enumerate(t.lvls[top - 1].ids):
        ix = t.ix[b] - 1
        st_b["cc"][top - 1][IPHI][loc, 1:-1, 1:-1] = torch.as_tensor(
            new[ix[1] * nc:(ix[1] + 1) * nc, ix[0] * nc:(ix[0] + 1) * nc])
    st_b = sb.fill_ghost(st_b, IPHI)
    st_d = sd._correct_children(st_d, top - 1, sd._lam(lam))
    st_r = rd._correct_children(st_r, top - 1, rd._lam(lam))
    st_b = sb._correct_children(st_b, sb._to_device(), top - 1)
    got = interior(sd, st_d, top, "phi")
    assert np.array_equal(got, interior(rd, st_r, top, "phi"))
    rel_near(got, boxed_to_dense2d(sb, st_b, top, IPHI), 1e-14, "correct")
    assert nb == len(t.lvls[top - 1].ids)


@pytest.mark.parametrize("operator,geometry,periodic", [
    ("laplacian", "cartesian", False), ("laplacian", "cartesian", True),
    ("vhelmholtz", "cartesian", False), ("ahelmholtz", "cartesian", False),
    ("laplacian", "cylindrical", False)])
def test_vcycle_matches_boxed_solver(operator, geometry, periodic):
    """One FAS V-cycle (smoothed coarse solve) within the JAX test's
    1e-13 of the boxed solver's; the port's dense 2D path launches no
    kernel counter."""
    r_min = (1.0, 0.0) if geometry == "cylindrical" else (0.0, 0.0)
    sb, st_b, sd, st_d, _, _ = setup(operator, geometry=geometry,
                                     periodic=periodic, r_min=r_min)
    lam = 0.4 if operator.endswith("helmholtz") else 0.0
    before = pdk.launch_counts()
    st_d, res_d = sd.fas_vcycle(st_d, lam=lam)
    assert pdk.launch_counts() == before
    st_b, res_b = sb.fas_vcycle(st_b, lam=lam)
    top = sd.levels[-1]
    rel_near(interior(sd, st_d, top, "phi"),
             boxed_to_dense2d(sb, st_b, top, IPHI), 1e-13, "V-cycle phi")
    assert abs(float(res_b) - float(res_d)) <= 1e-12 * max(
        1.0, abs(float(res_b)))


@pytest.mark.parametrize("operator", ["laplacian", "vhelmholtz"])
def test_fmg_matches_reference(operator):
    """One zero-guess and one have-guess FMG with the probed direct
    coarse solve against the JAX package's eager FMG: 5e-13 of max|phi|
    on every level, the residual likewise."""
    _, _, sd, st_d, rd, st_r = setup(operator, coarse="direct")
    lam = 0.4 if operator == "vhelmholtz" else 0.0
    for have in (False, True):
        st_d, r_d = sd.fas_fmg(st_d, lam=lam, have_guess=have)
        rd._ensure_direct(st_r)
        st_r, r_r = rd._fmg(st_r, rd._lam(lam), have, True)
        for lvl in sd.levels:
            rel_near(interior(sd, st_d, lvl, "phi"),
                     interior(rd, st_r, lvl, "phi"), 5e-13, f"lvl {lvl}")
        assert abs(float(r_d) - float(r_r)) <= 5e-13 * max(
            1.0, abs(float(r_r)))
    assert isinstance(sd._direct, dict)


# ---------------------------------------------------------------------------
# convergence (tests/test_dense2d.py's port-only checks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [False, True])
def test_fmg_manufactured(periodic):
    """FMG reaches machine error on a discretely generated rhs on a
    rectangular 64 x 32 domain, ~10x per cycle."""
    size = np.array([64, 32])
    tree = port.build_rectangle(2, size, 8, 1.0 / size, np.zeros(2),
                                periodic=[periodic] * 2)
    sd = port.Dense2DMGSolver(tree, port.MGConfig(device="cpu"))
    if not periodic:
        sd.set_bc(0, port.BCType.DIRICHLET, fn=solution)
    st = sd.allocate()
    for lvl in sd.levels:
        sd.set_interior(st, lvl, "phi", solution(sd.cell_centers(lvl)))
    st = sd.apply_operator(st, lam=0.0, out_key="rhs")
    for lvl in sd.levels:
        sd.set_interior(st, lvl, "phi", np.zeros(sd._ishape(lvl)))
    residuals = []
    for i in range(10):
        st, res = sd.fas_fmg(st, have_guess=(i > 0))
        residuals.append(float(res))
    assert isinstance(sd._direct, dict)
    top = sd.levels[-1]
    exact = solution(sd.cell_centers(top))
    if periodic:
        exact = exact - exact.mean()
    err = np.abs(interior(sd, st, top, "phi") - exact).max()
    assert err < 1e-11, f"solution error {err}"
    rate = (residuals[0] / residuals[2]) ** 0.5
    assert rate > 8.0, f"FMG contraction {rate}"


def test_fmg_vcoeff_converges():
    size = np.full(2, 64)
    tree = port.build_rectangle(2, size, 8, 1.0 / size, np.zeros(2))
    sd = port.make_solver(tree, port.MGConfig(operator="vhelmholtz",
                                              device="cpu"))
    assert isinstance(sd, port.Dense2DMGSolver)
    sd.set_bc(0, port.BCType.DIRICHLET, fn=solution)
    st = sd.allocate()
    x = sd.cell_centers(sd.levels[-1])
    sd.set_coefficient(st, 1.0 + 0.5 * np.cos(2 * np.pi * x[..., 0]))
    st = sd.prepare_coefficient(st)
    lam = 1.5
    for lvl in sd.levels:
        sd.set_interior(st, lvl, "phi", solution(sd.cell_centers(lvl)))
    st = sd.apply_operator(st, lam=lam, out_key="rhs")
    for lvl in sd.levels:
        sd.set_interior(st, lvl, "phi", np.zeros(sd._ishape(lvl)))
    st, res0 = sd.fas_fmg(st, lam=lam)
    for _ in range(5):
        st, res = sd.fas_fmg(st, lam=lam, have_guess=True)
    top = sd.levels[-1]
    err = np.abs(interior(sd, st, top, "phi")
                 - solution(sd.cell_centers(top))).max()
    assert err < 1e-9, f"solution error {err}"
    assert float(res) < float(res0) * 1e-4


def test_cylindrical_solve_second_order():
    """The manufactured cylindrical problem of tests/test_cylindrical.py
    reaches second-order discretization error."""
    def sol_fn(x):
        return x[..., 0] ** 2 * np.sin(2 * np.pi * x[..., 1])

    def rhs_fn(x):
        r, z = x[..., 0], x[..., 1]
        return (4.0 - (2 * np.pi) ** 2 * r ** 2) * np.sin(2 * np.pi * z)

    errs = []
    for size in (32, 64):
        dsz = np.full(2, size)
        tree = port.build_rectangle(2, dsz, 8, 1.0 / dsz,
                                    np.array([1.0, 0.0]))
        sd = port.make_solver(tree, port.MGConfig(
            operator="laplacian", geometry="cylindrical", device="cpu"))
        assert isinstance(sd, port.Dense2DMGSolver)
        sd.set_bc(0, port.BCType.DIRICHLET, fn=sol_fn)
        st = sd.allocate()
        for lvl in sd.levels:
            sd.set_interior(st, lvl, "rhs", rhs_fn(sd.cell_centers(lvl)))
        for i in range(8):
            st, _ = sd.fas_fmg(st, have_guess=(i > 0))
        top = sd.levels[-1]
        errs.append(np.abs(interior(sd, st, top, "phi")
                           - sol_fn(sd.cell_centers(top))).max())
    assert errs[0] / errs[1] > 3.5


def test_poisson_solver_2d_matches_reference_model():
    """PoissonSolver(2, ...).solve against the JAX package's model: phi
    within 5e-13 of max|phi| after one zero-guess FMG, and the residual
    within 1e-6 relative (the compiled JAX cycle contracts multiply-adds;
    the have-guess FMG is test_fmg_matches_reference's)."""
    def rhs_fn(x):
        return np.sin(np.pi * x[..., 0]) * np.cos(3 * x[..., 1]) + 0.2

    pp = port.PoissonSolver(2, (64, 64), 16, device="cpu")
    rp = RefPoissonSolver(2, (64, 64), 16)
    assert type(pp.solver) is port.Dense2DMGSolver
    for ps in (pp, rp):
        ps.set_dirichlet(fn=lambda x: 0.1 * x[..., 0])
        ps.set_rhs(rhs_fn=rhs_fn)
    phi_p, info_p = pp.solve(rtol=0.0, max_cycles=1)
    phi_r, info_r = rp.solve(rtol=0.0, max_cycles=1)
    rel_near(phi_p.numpy(), np.asarray(phi_r), 5e-13, "phi")
    (a,), (b,) = info_p["residuals"], info_r["residuals"]
    assert abs(a - b) <= 1e-6 * b
    assert np.array_equal(pp.phi(), phi_p.numpy())


# ---------------------------------------------------------------------------
# float32 scalar roundings against the JAX package's eager ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("operator,geometry", [
    ("helmholtz", "cartesian"), ("vhelmholtz", "cartesian"),
    ("ahelmholtz", "cartesian"), ("laplacian", "cylindrical")])
def test_float32_ops_match_reference_ops(operator, geometry):
    """In float32 on a level whose 1/dx^2 are not powers of two: one
    pair (both parities), the operator and the residual, through the
    solver's own scalars (``_lam``), bitwise the JAX package's eager ops
    (lam a [1, 1] array in float32; the cylindrical fac in double)."""
    dsz = np.array([24, 40])
    dr = np.array([0.0131, 0.0217])
    r_min = np.array([0.7, 0.0]) if geometry == "cylindrical" else np.zeros(2)
    kw = dict(operator=operator, geometry=geometry)
    tp = port.build_rectangle(2, dsz, 8, dr, r_min)
    tr = ref.build_rectangle(2, dsz, 8, dr, r_min)
    sd = port.Dense2DMGSolver(tp, port.MGConfig(device="cpu",
                                                dtype=torch.float32, **kw))
    rd = ref.Dense2DMGSolver(tr, ref.MGConfig(dtype=jnp.float32, **kw))
    for sv in (sd, rd):
        sv.set_bc(0, port.BCType.DIRICHLET if sv is sd
                  else ref.BCType.DIRICHLET, fn=lambda x: 0.3 + x[..., 1])
        sv.set_bc(0, port.BCType.NEUMANN if sv is sd
                  else ref.BCType.NEUMANN, 0.7, nb=1)
    top = sd.levels[-1]
    pc, rc = sd._kcfgs[top], rd._kcfgs[top]
    rng = np.random.default_rng(7)
    Y, X = pc.pshape
    phi = rng.normal(size=(Y, X)).astype(np.float32)
    rhs = rng.normal(size=(Y, X)).astype(np.float32)
    eps = [(0.5 + rng.random((Y, X))).astype(np.float32)
           for _ in range(sd.n_eps)]
    st_d, st_r = sd.allocate(), rd.allocate()
    bp = st_d["bc"][top]
    bq = st_r["bc"][top]
    lam = 0.53
    lp, lr = sd._lam(lam), rd._lam(lam)
    pt = [torch.from_numpy(a) for a in eps]
    jt = [jnp.asarray(a) for a in eps]
    for parity in (0, 1):
        got = pd2.pair_sweep_2d(pc, torch.from_numpy(phi),
                                torch.from_numpy(rhs), lp, bp, parity,
                                eps=pt)
        want = rd2.pair_sweep_2d(rc, jnp.asarray(phi), jnp.asarray(rhs), lr,
                                 bq, parity, eps=jt)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.asarray(want)), parity
    for residual in (False, True):
        got = pd2.stencil_apply_2d(pc, torch.from_numpy(phi),
                                   torch.from_numpy(rhs), lp, bp, residual,
                                   eps=pt)
        want = rd2.stencil_apply_2d(rc, jnp.asarray(phi), jnp.asarray(rhs),
                                    lr, bq, residual, eps=jt)
        assert np.array_equal(got.numpy(), np.asarray(want)), residual
