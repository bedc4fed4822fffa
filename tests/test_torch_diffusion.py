"""The implicit diffusion drivers of the PyTorch package against the JAX
package's (``solve/diffusion.py``), float64 on the CPU.

Solvers: the dense solver (``build_rectangle`` 16^3 box 8, Neumann-0
walls), the dense-patch AMR solver (``build_amr_centered(3, 2, 16^3, 8)``,
Neumann-0) and the boxed solver (the same uniform tree, fully periodic).
Initial phi = 2 + a smooth mode on every level, coefficients 1 + 0.3
cos(2 pi x_d) (smooth, positive), made with numpy in both packages.

Bounds:

* ``set_rhs_from_phi`` (both branches) and the order-2 ``apply`` into
  rhs: 64 eps64 of max|ref| (one operator application; the reference's
  eager ops in the same order);
* whole steps (FMG + V-cycles to ``max_res``): phi within 1e-12 of
  max|phi| and the final residual within 64 eps64 of the rhs scale
  (2 max|phi| / dt): the reference's cycles are compiled (XLA:CPU
  contracts a*b+c into FMAs), so the two packages agree to ~1e-15 per
  cycle, and the residual is a max over cells of rhs - A(phi), a
  difference of terms of the rhs scale;
* the physics checks are the reference tests' own (tests/test_diffusion.py,
  tests/test_dense_vcoeff.py:240-270, tests/test_dense_amr.py:203-227).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octree_mg_tpu as ref
from octree_mg_tpu.solve import diffusion as rdf

import octree_mg_tpu_torch as port
from octree_mg_tpu_torch import IPHI, IRHS
from octree_mg_tpu_torch.core.constants import IVEPS
from octree_mg_tpu_torch.solve import diffusion as pdf

torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps
SCHEMES = {"helmholtz": "diffusion_solve", "vhelmholtz":
           "diffusion_solve_vcoeff", "ahelmholtz": "diffusion_solve_acoeff"}
KINDS = ("dense", "amr", "boxed")
DT = 0.01
MAX_RES = 1e-7


def mode(x):
    out = 1.0
    for d in range(3):
        out = out * np.sin(4 * np.pi * x[..., d])
    return out


def coeff(x, d):
    return 1.0 + 0.3 * np.cos(2 * np.pi * x[..., d])


def tree(pkg, kind):
    n = np.full(3, 16)
    if kind == "amr":
        return pkg.build_amr_centered(3, 2, n, 8, 1.0 / n)
    return pkg.build_rectangle(3, n, 8, 1.0 / n, np.zeros(3),
                               periodic=[kind == "boxed"] * 3)


def setup(pkg, kind, op):
    """(solver, state) of one package with phi and the coefficients set
    (and, boxed, phi's ghosts filled)."""
    is_ref = pkg is ref
    cfg = (pkg.MGConfig(operator=op) if is_ref
           else pkg.MGConfig(operator=op, device="cpu"))
    t = tree(pkg, kind)
    if kind == "boxed":
        sv = pkg.MGSolver(t, cfg)
    else:
        sv = pkg.make_solver(t, cfg)
        sv.set_bc(0, pkg.BCType.NEUMANN, 0.0)
    st = sv.allocate()
    n_eps = {"helmholtz": 0, "vhelmholtz": 1, "ahelmholtz": 3}[op]
    for lvl in sv.levels:
        x = sv.cell_centers(lvl)
        if kind == "boxed":
            vals = {IPHI: 2.0 + mode(x)}
            vals.update({IVEPS + d: coeff(x, d) for d in range(n_eps)})
            for iv, v in vals.items():
                if is_ref:
                    st["cc"][lvl] = st["cc"][lvl].at[iv].set(jnp.asarray(v))
                else:
                    st["cc"][lvl][iv] = torch.from_numpy(v)
        else:
            put = ((lambda k, v: sv.set_interior(st, lvl, k, jnp.asarray(v)))
                   if is_ref else
                   (lambda k, v: sv.set_interior(st, lvl, k, v)))
            st = put("phi", 2.0 + mode(x))
            for d in range(n_eps):
                st = put(f"eps{d}", coeff(x, d))
    if kind == "boxed":
        st = sv.fill_ghost(st, IPHI)
    return sv, st


def top_phi(sv, st, kind):
    top = sv.levels[-1]
    if kind == "boxed":
        return np.asarray(st["cc"][top][IPHI])[(slice(None),)
                                               + (slice(1, -1),) * 3]
    return np.asarray(sv.interior(st, top, "phi"))


def fields(sv, st, kind, key):
    iv = {"phi": IPHI, "rhs": IRHS}[key]
    if kind == "boxed":
        isl = (slice(None),) + (slice(1, -1),) * 3
        return {l: np.asarray(st["cc"][l][iv])[isl] for l in sv.levels}
    return {l: np.asarray(sv.interior(st, l, key)) for l in sv.levels}


def assert_fields_close(got, want, bound):
    for lvl, w in want.items():
        g = got[lvl].numpy() if torch.is_tensor(got[lvl]) else got[lvl]
        assert np.max(np.abs(g - w)) <= bound * max(np.max(np.abs(w)),
                                                    1e-300), lvl


def run(sv, st, op, order, mod, steps=1):
    fn = getattr(mod, SCHEMES[op])
    res = []
    for _ in range(steps):
        if op == "helmholtz":
            st, r = fn(sv, st, DT, 1.0, order=order, max_res=MAX_RES)
        else:
            st, r = fn(sv, st, DT, order=order, max_res=MAX_RES)
        res.append(r)
    return st, res


# ---------------------------------------------------------------------------
# the driver's own arithmetic against the reference (eager)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("f1,f2", [(-2.0 / DT, -1.0), (-1.0 / DT, 0.0)],
                         ids=["order2", "order1"])
def test_set_rhs_from_phi_matches_reference(kind, f1, f2):
    """rhs = f1*phi + f2*rhs: every dense level's whole patch, the boxed
    leaves of levels >= 1 (both branches of set_rhs_from_phi)."""
    rs, js = setup(ref, kind, "helmholtz")
    ps, ts = setup(port, kind, "helmholtz")
    rng = np.random.default_rng(4)
    for lvl in rs.levels:
        if kind == "boxed":
            v = rng.normal(size=np.asarray(js["cc"][lvl][IRHS]).shape)
            js["cc"][lvl] = js["cc"][lvl].at[IRHS].set(jnp.asarray(v))
            ts["cc"][lvl][IRHS] = torch.from_numpy(v)
        else:
            v = rng.normal(size=rs._ishape(lvl))
            js = rs.set_interior(js, lvl, "rhs", jnp.asarray(v))
            ps.set_interior(ts, lvl, "rhs", v)
    js = rdf.set_rhs_from_phi(rs, js, f1, f2)
    ts = pdf.set_rhs_from_phi(ps, ts, f1, f2)
    assert_fields_close(fields(ps, ts, kind, "rhs"),
                        fields(rs, js, kind, "rhs"), 64 * EPS)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", list(SCHEMES))
def test_order2_apply_into_rhs_matches_reference(kind, op):
    """The order-2 scheme's first phase, A(phi) at lam = 0 into rhs on
    every level (apply_operator(out_key="rhs") / (i_out=IRHS))."""
    rs, js = setup(ref, kind, op)
    ps, ts = setup(port, kind, op)
    if kind == "boxed":
        js = rs.apply_operator(js, lam=0.0, i_out=ref.IRHS)
        ts = ps.apply_operator(ts, lam=0.0, i_out=IRHS)
    else:
        js = rs.apply_operator(js, lam=0.0, out_key="rhs")
        ts = ps.apply_operator(ts, lam=0.0, out_key="rhs")
    assert_fields_close(fields(ps, ts, kind, "rhs"),
                        fields(rs, js, kind, "rhs"), 64 * EPS)


# ---------------------------------------------------------------------------
# whole steps against the reference
# ---------------------------------------------------------------------------

def _slow(kind, op):
    """The reference's compiled cycles cost ~7 s per dense solver, ~15 s
    per AMR one and ~30 s per boxed one: the dense helmholtz pair runs in
    tier 1, the rest under -m slow."""
    if kind == "dense" and op == "helmholtz":
        return ()
    return (pytest.mark.slow,)


@pytest.mark.parametrize("kind,op", [
    pytest.param(k, o, marks=_slow(k, o), id=f"{k}-{o}")
    for k in KINDS for o in SCHEMES])
def test_steps_match_reference(kind, op):
    """An order-1 step, then an order-2 step, from the same state in both
    packages (one reference solver, so its cycles compile once)."""
    rs, js = setup(ref, kind, op)
    ps, ts = setup(port, kind, op)
    for order in (1, 2):
        js, (r_ref,) = run(rs, js, op, order, rdf)
        ts, (r,) = run(ps, ts, op, order, pdf)
        assert isinstance(r, float)
        rhs_scale = 2.0 * np.max(np.abs(top_phi(rs, js, kind))) / DT
        assert abs(r - r_ref) <= 64 * EPS * rhs_scale
        assert r <= MAX_RES
        assert_fields_close(fields(ps, ts, kind, "phi"),
                            fields(rs, js, kind, "phi"), 1e-12)
    # no convergence: the reference's error, in both packages
    args = (1.0,) if op == "helmholtz" else ()
    for mod, sv, st in ((rdf, rs, js), (pdf, ps, ts)):
        with pytest.raises(mod.DiffusionDivergenceError,
                           match="no convergence"):
            getattr(mod, SCHEMES[op])(sv, st, DT, *args, max_res=1e-30,
                                      max_its=0)


# ---------------------------------------------------------------------------
# every scheme and order on every solver: the reference tests' physics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", list(SCHEMES))
def test_every_scheme_and_order_conserves_and_smooths(kind, op):
    """An order-1 step, then an order-2 step of the port's driver: the
    residual target met every step; the variance of the top level falls
    every step; under Neumann-0 walls (dense) or periodic faces (boxed)
    the total mass is conserved (1e-10 relative: max_res against an rhs
    of ~2 phi / dt)."""
    ps, ts = setup(port, kind, op)
    phi0 = top_phi(ps, ts, kind)
    mass0, var = float(np.sum(phi0)), float(np.var(phi0))
    for order in (1, 2):
        ts, (r,) = run(ps, ts, op, order, pdf)
        assert r <= MAX_RES
        phi = top_phi(ps, ts, kind)
        assert np.all(np.isfinite(phi))
        assert float(np.var(phi)) < var
        var = float(np.var(phi))
        if kind != "amr":
            assert abs(float(np.sum(phi)) - mass0) <= 1e-10 * abs(mass0)


def periodic_2d(op, size, box):
    dsz = np.full(2, size)
    t = port.build_rectangle(2, dsz, box, 1.0 / dsz, np.zeros(2),
                             periodic=[True] * 2)
    return port.MGSolver(t, port.MGConfig(operator=op, device="cpu"))


def set_mode_2d(sv, st):
    for lvl in sv.levels:
        x = sv.cell_centers(lvl)
        f = np.sin(2 * np.pi * x[..., 0]) * np.cos(2 * np.pi * x[..., 1])
        st["cc"][lvl][IPHI] = torch.from_numpy(f)
    return sv.fill_ghost(st, IPHI)


def exact_2d(sv, decay):
    x = sv.cell_centers(sv.levels[-1])
    return decay * np.sin(2 * np.pi * x[..., 0]) * np.cos(2 * np.pi
                                                         * x[..., 1])


@pytest.mark.parametrize("order,tol", [(1, 0.05), (2, 0.004)])
def test_diffusion_decay_2d(order, tol):
    """tests/test_diffusion.py::test_diffusion_decay_2d: a periodic mode
    decays as exp(-D k^2 t) to the scheme's order."""
    k2 = 2 * (2 * np.pi) ** 2
    dt = 0.2 / k2
    sv = periodic_2d("helmholtz", 64, 16)
    st = set_mode_2d(sv, sv.allocate())
    for _ in range(4):
        st, _ = pdf.diffusion_solve(sv, st, dt, 1.0, order=order,
                                    max_res=1e-9)
    isl = (slice(None),) + (slice(1, -1),) * 2
    got = st["cc"][sv.levels[-1]][IPHI].numpy()[isl]
    assert np.max(np.abs(got - exact_2d(sv, np.exp(-k2 * dt * 4))[isl])) \
        < tol


def test_diffusion_vcoeff_matches_constant():
    """tests/test_diffusion.py: with eps == D constant, the vcoeff solve
    equals the constant-D solve (2e-7)."""
    D, k2 = 0.7, 2 * (2 * np.pi) ** 2
    dt = 0.3 / k2
    sv = periodic_2d("vhelmholtz", 32, 8)
    st_v = set_mode_2d(sv, sv.allocate())
    for lvl in sv.levels:
        st_v["cc"][lvl][IVEPS] = D
    st_v, _ = pdf.diffusion_solve_vcoeff(sv, st_v, dt, order=2, max_res=1e-9)
    sc = periodic_2d("helmholtz", 32, 8)
    st_c = set_mode_2d(sc, sc.allocate())
    st_c, _ = pdf.diffusion_solve(sc, st_c, dt, D, order=2, max_res=1e-9)
    top = sv.levels[-1]
    np.testing.assert_allclose(st_v["cc"][top][IPHI].numpy(),
                               st_c["cc"][top][IPHI].numpy(), atol=2e-7)


def test_diffusion_acoeff_anisotropic_decay():
    """tests/test_diffusion.py: D = (Dx, Dy), the mode decays with
    Dx kx^2 + Dy ky^2 (0.01)."""
    Dx, Dy = 1.0, 0.25
    k2 = (2 * np.pi) ** 2 * (Dx + Dy)
    dt = 0.2 / k2
    sv = periodic_2d("ahelmholtz", 64, 16)
    st = set_mode_2d(sv, sv.allocate())
    for d, Dv in enumerate((Dx, Dy)):
        for lvl in sv.levels:
            st["cc"][lvl][IVEPS + d] = Dv
    for _ in range(3):
        st, _ = pdf.diffusion_solve_acoeff(sv, st, dt, order=2, max_res=1e-9)
    isl = (slice(None),) + (slice(1, -1),) * 2
    got = st["cc"][sv.levels[-1]][IPHI].numpy()[isl]
    assert np.max(np.abs(got - exact_2d(sv, np.exp(-k2 * dt * 3))[isl])) \
        < 0.01


def solution3(x):
    out = 1.0
    for d in range(3):
        out = out * np.sin(2 * np.pi * 2 * x[..., d])
    return out


def test_diffusion_vcoeff_dense():
    """tests/test_dense_vcoeff.py:240-270 (there at 32^3; here 16^3, box
    8): mass conserved under Neumann-0 walls (1e-6), variance below 0.2
    of the first, residual <= 1e-7 after three order-2 steps."""
    dsz = np.full(3, 16)
    sv = port.make_solver(port.build_rectangle(3, dsz, 8, 1.0 / dsz,
                                               np.zeros(3)),
                          port.MGConfig(operator="vhelmholtz", device="cpu"))
    assert type(sv) is port.DenseMGSolver
    sv.set_bc(0, port.BCType.NEUMANN, 0.0)
    st = sv.allocate()
    top = sv.levels[-1]
    x = sv.cell_centers(top)
    st = sv.prepare_coefficient(sv.set_coefficient(
        st, 1.0 + 0.5 * np.cos(2 * np.pi * x[..., 0])))
    st = sv.set_interior(st, top, "phi", solution3(x) + 2.0)
    mass0 = float(sv.interior(st, top, "phi").sum())
    var0 = float(sv.interior(st, top, "phi").var(unbiased=False))
    for _ in range(3):
        st, res = pdf.diffusion_solve_vcoeff(sv, st, dt=0.01, order=2,
                                             max_res=1e-7)
    phi = sv.interior(st, top, "phi")
    assert abs(float(phi.sum()) - mass0) < 1e-6 * abs(mass0)
    assert float(phi.var(unbiased=False)) < 0.2 * var0
    assert res <= 1e-7


def test_diffusion_on_dense_amr():
    """tests/test_dense_amr.py:203-227: helmholtz order 2 on a dense AMR
    tree, residual target met, variance below half."""
    sv = port.make_solver(port.build_amr_centered(
        3, 2, np.full(3, 16), 8, np.full(3, 1.0 / 16)),
        port.MGConfig(operator="helmholtz", device="cpu"))
    assert isinstance(sv, port.DenseAMRMGSolver)
    sv.set_bc(0, port.BCType.NEUMANN, 0.0)
    st = sv.allocate()
    for lvl in sv.levels[-2:]:
        st = sv.set_interior(st, lvl, "phi",
                             2.0 + solution3(sv.cell_centers(lvl)))
    top = sv.levels[-1]
    var0 = float(sv.interior(st, top, "phi").var(unbiased=False))
    for _ in range(3):
        st, res = pdf.diffusion_solve(sv, st, dt=0.005, diffusion_coeff=1.0,
                                      order=2, max_res=1e-7)
    assert res <= 1e-7
    assert float(sv.interior(st, top, "phi").var(unbiased=False)) < \
        0.5 * var0


def test_what_raises():
    sv, st = setup(port, "dense", "vhelmholtz")
    with pytest.raises(ValueError, match="helmholtz"):
        pdf.diffusion_solve(sv, st, DT, 1.0)
    with pytest.raises(ValueError, match="vhelmholtz"):
        pdf.diffusion_solve_vcoeff(setup(port, "dense", "helmholtz")[0],
                                   st, DT)
    with pytest.raises(ValueError, match="ahelmholtz"):
        pdf.diffusion_solve_acoeff(sv, st, DT)
    with pytest.raises(ValueError, match="order"):
        pdf.diffusion_solve_vcoeff(sv, st, DT, order=3)
