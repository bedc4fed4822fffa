"""DenseMGSolver / PoissonSolver of the PyTorch package against the JAX
package: solver phases, whole cycles and the state converters.

float64 on the CPU.  Both packages start from identical bits: states are
made with numpy from a seed in the reference and carried over with
``convert.state_from_numpy``.  On (256, 16, 16) with box 8 the reference
runs its Pallas bodies in interpret mode (fused down-leg on the top
level, pair/apply kernels on 128x8x8, transfer kernels on the top pair):
the solver phases are compared there, eagerly.  Whole cycles are compared
on (128, 8, 8), whose top level still runs the Pallas pair and apply
bodies and whose two FMG programs compile in a third of the time, to
keep the default run short; the same tests on (256, 16, 16) are
`slow`.  32^3 exercises the reference's fallback-only levels.

Tolerances (reason: XLA:CPU contracts a*b+c into FMAs, PyTorch's eager
ops do not, and the reference's fallback restriction sums in XLA's
reduce_window order): per phase ``256 * eps64 * max|reference|``; whole
solves phi within 1e-10 of max|phi| and residuals within rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octree_mg_tpu as ref
from octree_mg_tpu.models import PoissonSolver as RefPoisson

import octree_mg_tpu_torch as port
from octree_mg_tpu_torch import convert

# The suite runs in several worker processes on a few cores and these
# tensors are small: one intra-op thread per process keeps the
# workers from oversubscribing the cores.
torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps
DIMS = (256, 16, 16)
KEYS = ("phi", "rhs", "iold", "ires")


def solution(x):
    out = 1.0
    for d in range(x.shape[-1]):
        out = out * np.sin(2 * np.pi * 2 * x[..., d])
    return out


def to_np(jstate):
    out = {k: {l: np.asarray(v) for l, v in jstate[k].items()} for k in KEYS}
    out["bc"] = {l: [np.asarray(p) for p in ps]
                 for l, ps in jstate["bc"].items()}
    return out


def copy_jstate(s):
    return {k: dict(v) for k, v in s.items()}


def random_jstate(sd, seed, keys=KEYS):
    """A reference state with random interiors on every level."""
    rng = np.random.default_rng(seed)
    st = sd.allocate()
    for lvl in sd.levels:
        X, Y, Z = sd.dims[lvl]
        for k in keys:
            st = sd.set_interior(st, lvl, k,
                                 jnp.asarray(rng.normal(size=(Z, Y, X))))
    return st


def assert_states_close(sd, jstate, sp, tstate, items, mult=256):
    for lvl, keys in items:
        for k in keys:
            w = np.asarray(sd.interior(jstate, lvl, k))
            g = sp.interior(tstate, lvl, k).numpy()
            atol = mult * EPS * max(np.max(np.abs(w)), 1e-300)
            np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                       err_msg=f"{k}@{lvl}")


def poisson_pair(dims):
    """The reference PoissonSolver with plane-valued Dirichlet faces and
    its PyTorch counterpart on the same tree."""
    dsz = np.array(dims)
    kw = dict(dr=np.full(3, 1.0 / 256), r_min=np.zeros(3))
    jp = RefPoisson(3, dsz, 8, dtype=jnp.float64, **kw)
    jp.set_dirichlet(fn=solution)
    pp = port.PoissonSolver(3, dsz, 8, dtype=torch.float64, device="cpu",
                            **kw)
    pp.set_dirichlet(fn=solution)
    return jp, pp


@pytest.fixture(scope="module")
def pair():
    """(256,16,16): for the solver phases (no compiled cycle)."""
    jp, pp = poisson_pair(DIMS)
    return dict(jp=jp, pp=pp)


@pytest.fixture(scope="module", params=[
    (128, 8, 8), pytest.param(DIMS, marks=pytest.mark.slow)])
def solved(request):
    """Both PoissonSolvers solved for three FMG cycles (compiles the
    reference's two FMG programs once per size)."""
    dims = request.param
    jp, pp = poisson_pair(dims)
    rhs = np.random.default_rng(42).normal(size=dims[::-1])
    top = jp.solver.levels[-1]
    jp.set_rhs(arrays={top: rhs})
    pp.set_rhs(arrays={top: rhs})
    phi_r, info_r = jp.solve(rtol=0.0, max_cycles=3)
    phi_p, info_p = pp.solve(rtol=0.0, max_cycles=3)
    return dict(jp=jp, pp=pp, phi_r=np.asarray(phi_r), info_r=info_r,
                phi_p=phi_p.numpy().copy(), info_p=info_p)


def test_levels_and_bc_planes_match(pair):
    sd, sp = pair["jp"].solver, pair["pp"].solver
    assert sd.levels == sp.levels and sd.dims == sp.dims
    assert sp.dims[sp.levels[0]] == (32, 2, 2)
    js, ts = sd.allocate(), sp.allocate()
    for lvl in sd.levels:
        for a, b in zip(js["bc"][lvl], ts["bc"][lvl]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        ck, cp = sd._kcfgs[lvl], sp._kcfgs[lvl]
        assert ck.idr2 == cp.idr2 and ck.den0 == cp.den0
        assert [tuple(c) for c in ck.bc] == cp.bc
        assert ck.b_const == cp.b_const


def test_poisson_solve_matches_reference(solved):
    """PoissonSolver.solve: one zero-guess FMG then have-guess FMGs."""
    pair = solved
    assert pair["jp"].solver._kcfgs[pair["jp"].solver.levels[-1]].use_kernel
    r, p = pair["info_r"]["residuals"], pair["info_p"]["residuals"]
    assert len(r) == len(p) == 3
    np.testing.assert_allclose(p, r, rtol=1e-6)
    assert p[2] < 1e-2 * p[0]
    scale = np.max(np.abs(pair["phi_r"]))
    np.testing.assert_allclose(pair["phi_p"], pair["phi_r"], rtol=0,
                               atol=1e-10 * scale)


@pytest.mark.parametrize("have_guess", [False, True])
def test_fas_fmg_matches_reference(solved, have_guess):
    sd, sp = solved["jp"].solver, solved["pp"].solver
    js = random_jstate(sd, 7, keys=("phi", "rhs"))
    ts = convert.state_from_numpy(sp, to_np(js))
    js, res_r = sd.fas_fmg(js, have_guess=have_guess)
    ts, res_p = sp.fas_fmg(ts, have_guess=have_guess)
    np.testing.assert_allclose(float(res_p), float(res_r), rtol=1e-6)
    top = sd.levels[-1]
    w = np.asarray(sd.interior(js, top, "phi"))
    np.testing.assert_allclose(sp.interior(ts, top, "phi").numpy(), w,
                               rtol=0, atol=1e-10 * np.max(np.abs(w)))


def test_down_leg_matches_reference(pair):
    """Reference: fused downsweep kernel; here: the separate phases."""
    sd, sp = pair["jp"].solver, pair["pp"].solver
    top = sd.levels[-1]
    assert sd._fused_down_ok(top)
    js = random_jstate(sd, 5)
    ts = convert.state_from_numpy(sp, to_np(js))
    js = sd._down_leg(copy_jstate(js), top, jnp.asarray(0.0))
    ts = sp._down_leg(ts, top, 0.0)
    assert_states_close(sd, js, sp, ts, [(top, ("phi",)), (top - 1, KEYS)])


@pytest.mark.parametrize("lvl_off", [0, 2])
def test_update_coarse_matches_reference(pair, lvl_off):
    """Top level (reference: residual_restrict kernel) and a small level
    (reference: jnp fallback with reduce_window)."""
    sd, sp = pair["jp"].solver, pair["pp"].solver
    lvl = sd.levels[-1] - lvl_off
    js = random_jstate(sd, 6)
    ts = convert.state_from_numpy(sp, to_np(js))
    js = sd._update_coarse(copy_jstate(js), lvl, jnp.asarray(0.0))
    ts = sp._update_coarse(ts, lvl, 0.0)
    assert_states_close(sd, js, sp, ts, [(lvl - 1, KEYS)])


@pytest.mark.parametrize("lvl_off", [1, 3])
def test_correct_children_matches_reference(pair, lvl_off):
    """Top pair (reference: prolong kernel) and the coarsest pair
    (reference: ring + interleave fallback)."""
    sd, sp = pair["jp"].solver, pair["pp"].solver
    lvl_c = sd.levels[-1] - lvl_off
    js = random_jstate(sd, 8)
    ts = convert.state_from_numpy(sp, to_np(js))
    js = sd._correct_children(copy_jstate(js), lvl_c, jnp.asarray(0.0))
    ts = sp._correct_children(ts, lvl_c, 0.0)
    assert_states_close(sd, js, sp, ts, [(lvl_c + 1, ("phi",))])


def test_coarse_direct_matches_reference(pair):
    sd, sp = pair["jp"].solver, pair["pp"].solver
    sd._ensure_direct()
    sp._ensure_direct()
    # same eigenbasis bits on both sides
    sp._direct = convert.direct_from_numpy(
        sp, {k: np.asarray(v) for k, v in sd._direct.items()})
    js = random_jstate(sd, 9)
    ts = convert.state_from_numpy(sp, to_np(js))
    js = sd._coarse_direct(copy_jstate(js), jnp.asarray(0.0))
    ts = sp._coarse_direct(ts, 0.0)
    lvl = sd.levels[0]
    # A^-1 amplifies rounding by the coarse level's condition number
    assert_states_close(sd, js, sp, ts, [(lvl, ("phi",))], mult=1 << 16)


def test_state_roundtrip(pair):
    sd, sp = pair["jp"].solver, pair["pp"].solver
    np_state = to_np(random_jstate(sd, 10))
    back = convert.state_to_numpy(convert.state_from_numpy(sp, np_state))
    for k in KEYS:
        for lvl in sd.levels:
            np.testing.assert_array_equal(back[k][lvl], np_state[k][lvl])
    for lvl in sd.levels:
        for a, b in zip(back["bc"][lvl], np_state["bc"][lvl]):
            np.testing.assert_array_equal(a, b)
    bad = {k: dict(v) for k, v in np_state.items()}
    bad["phi"][sd.levels[-1]] = np.zeros((3, 3, 3))
    with pytest.raises(ValueError, match="shape"):
        convert.state_from_numpy(sp, bad)
    with pytest.raises(ValueError, match="eigenbasis"):
        convert.direct_from_numpy(sp, {"V": np.eye(3), "Vinv": np.eye(3),
                                       "d": np.ones(3), "tiny": 0.0})


def test_cycle_updates_state_in_place(pair):
    sp = pair["pp"].solver
    ts = sp.allocate()
    sp.set_interior(ts, sp.levels[-1], "rhs",
                    np.random.default_rng(1).normal(size=DIMS[::-1]))
    assert sp.dims[sp.levels[-1]] == DIMS
    out, res = sp.fas_fmg(ts, need_res=False)
    assert out is ts and float(res) == 0.0
    for lvl in sp.levels:
        assert ts["phi"][lvl].data_ptr() != ts["iold"][lvl].data_ptr()


# -- 32^3: the reference's fallback-only levels, periodic, smooth solver ---

@pytest.fixture(scope="module")
def periodic32():
    dsz = np.full(3, 32)
    args = (3, dsz, 8, 1.0 / dsz, np.zeros(3), [True] * 3)
    sd = ref.make_solver(ref.build_rectangle(*args),
                         ref.MGConfig(operator="laplacian"))
    sp = port.make_solver(port.build_rectangle(*args),
                          port.MGConfig(operator="laplacian", device="cpu"))
    assert sd.subtract_mean and sp.subtract_mean
    return sd, sp


def test_subtract_mean_matches_reference(periodic32):
    sd, sp = periodic32
    js = random_jstate(sd, 11)
    ts = convert.state_from_numpy(sp, to_np(js))
    js = sd._subtract_mean(js, "rhs")
    ts = sp._subtract_mean(ts, "rhs")
    assert_states_close(sd, js, sp, ts, [(l, ("rhs",)) for l in sd.levels],
                        mult=16)


def test_fas_vcycle_periodic_matches_reference(periodic32):
    """Fully periodic V-cycles (mean removal, wrapped pads, direct solve
    of the singular coarse operator) on fallback-only levels."""
    sd, sp = periodic32
    js = random_jstate(sd, 12, keys=("rhs",))
    ts = convert.state_from_numpy(sp, to_np(js))
    for _ in range(2):
        js, res_r = sd.fas_vcycle(js)
        ts, res_p = sp.fas_vcycle(ts)
        np.testing.assert_allclose(float(res_p), float(res_r), rtol=1e-6)
    top = sd.levels[-1]
    w = np.asarray(sd.interior(js, top, "phi"))
    np.testing.assert_allclose(sp.interior(ts, top, "phi").numpy(), w,
                               rtol=0, atol=1e-10 * np.max(np.abs(w)))


def test_coarse_smooth_matches_reference():
    """coarse_solver="smooth": the iterate-to-tolerance loop on the
    coarsest level (Dirichlet constant faces, helmholtz)."""
    dsz = np.full(3, 16)
    args = (3, dsz, 8, 1.0 / dsz, np.zeros(3))
    sd = ref.make_solver(ref.build_rectangle(*args), ref.MGConfig(
        operator="helmholtz", coarse_solver="smooth"))
    sp = port.make_solver(port.build_rectangle(*args), port.MGConfig(
        operator="helmholtz", coarse_solver="smooth", device="cpu"))
    sd.set_bc(0, ref.BCType.DIRICHLET, value=0.5)
    sp.set_bc(0, port.BCType.DIRICHLET, value=0.5)
    assert sd.levels == sp.levels and sp.dims[sp.levels[0]] == (2, 2, 2)
    js = random_jstate(sd, 13)
    ts = convert.state_from_numpy(sp, to_np(js))
    js = sd._coarse_smooth(js, jnp.asarray(0.7))
    ts = sp._coarse_smooth(ts, sp._kcfgs[sp.levels[0]].rnd(0.7))
    lvl = sd.levels[0]
    w = np.asarray(sd.interior(js, lvl, "phi"))
    np.testing.assert_allclose(sp.interior(ts, lvl, "phi").numpy(), w,
                               rtol=0, atol=1e-7 * np.max(np.abs(w)))


def test_apply_operator_matches_reference(periodic32):
    sd, sp = periodic32
    js = random_jstate(sd, 14, keys=("phi",))
    ts = convert.state_from_numpy(sp, to_np(js))
    js = sd.apply_operator(js)
    ts = sp.apply_operator(ts)
    assert_states_close(sd, js, sp, ts, [(l, ("ires",)) for l in sd.levels])
