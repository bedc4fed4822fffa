"""The dense forest with coefficient fields (vlaplacian, vhelmholtz,
ahelmholtz) against the JAX package's DenseForestMGSolver, float64 on
the CPU: the 3D tests of tests/test_dense_forest_vcoeff.py.

Trees: the L, two and periodic forests of tests/test_dense_forest.py
(16^3 base, box 4; the L forest's level 2 has concave-corner ghost
conflicts, so the coefficient-aware fix-ups run).  Random phi, rhs and
positive coefficients on every level come from a seed with numpy, set
in the reference and carried over with ``convert.state_from_numpy``
(which carries the forest's eps fields).  The reference's whole cycles
run as its tests run them (compiled, the direct coarse solve).

Bounds, on footprint cells (garbage cells are never compared):

* smoothing and residual against the reference: bitwise (the plain
  route's eager ops in the reference's order);
* the port's forest against the port's boxed solver (as the reference's
  own test holds its forest against its boxed solver): smoothing and
  residual bitwise, a V-cycle within 5e-13 of max|phi| (the reference's
  bound: the restriction's summation order);
* a V-cycle or FMG against the reference: ``256 * eps64 * max|ref|``
  for phi, the residual within 1e-10 relative (the restriction's
  summation order, and XLA:CPU contracts a*b+c into FMAs in the
  compiled cycle, as tests/test_torch_forest.py states).
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octree_mg_tpu as ref
from octree_mg_tpu.core import tree as rtm
from octree_mg_tpu.solve.dense_forest import DenseForestMGSolver as RefForest

import octree_mg_tpu_torch as port
from octree_mg_tpu_torch import IPHI, IRES, IRHS, convert
from octree_mg_tpu_torch.core import tree as ptm
from octree_mg_tpu_torch.core.constants import IVEPS
from octree_mg_tpu_torch.ops import dense_kernels as dk

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import forest_tree as shared_forest_tree  # noqa: E402

torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps
N_EPS = {"vlaplacian": 1, "vhelmholtz": 1, "ahelmholtz": 3}
OPS = tuple(N_EPS)


def solution(x):
    out = 1.0
    for d in range(x.shape[-1]):
        out = out * np.sin(2 * np.pi * 2 * x[..., d])
    return out


def forest_tree(pkg, tm, kind):
    return shared_forest_tree(pkg, tm, kind, 16, 4)


def lam_of(op):
    return 0.0 if op == "vlaplacian" else 0.4


def make_pair(kind, op, coarse="direct"):
    rs = RefForest(forest_tree(ref, rtm, kind),
                   ref.MGConfig(operator=op, coarse_solver=coarse))
    ps = port.make_solver(forest_tree(port, ptm, kind), port.MGConfig(
        operator=op, coarse_solver=coarse, device="cpu"))
    assert isinstance(ps, port.DenseForestMGSolver)
    if kind != "periodic":
        rs.set_bc(0, ref.BCType.DIRICHLET, fn=solution)
        ps.set_bc(0, port.BCType.DIRICHLET, fn=solution)
    return rs, ps


def random_state(rs, seed):
    """Random phi/rhs and positive eps on every level of the reference;
    (jax state, numpy state)."""
    js = rs.allocate()
    rng = np.random.default_rng(seed)
    for lvl in rs.levels:
        X, Y, Z = rs.dims[lvl]
        for k in ("phi", "rhs"):
            js = rs.set_interior(js, lvl, k,
                                 jnp.asarray(rng.normal(size=(Z, Y, X))))
        for d in range(rs.n_eps):
            js = rs.set_interior(js, lvl, f"eps{d}", jnp.asarray(
                0.5 + rng.random((Z, Y, X))))
    keys = ("phi", "rhs", "iold", "ires") + tuple(
        f"eps{d}" for d in range(rs.n_eps))
    npst = {k: {l: np.asarray(v) for l, v in js[k].items()} for k in keys}
    npst["bc"] = {l: [np.asarray(p) for p in ps]
                  for l, ps in js["bc"].items()}
    return js, npst


def fp(sv, lvl, a):
    return np.where(sv.footprint_mask(lvl), np.asarray(a), 0.0)


# ---------------------------------------------------------------------------
# routing and state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", OPS)
def test_gating_and_routing(op):
    """Every forest goes to the dense forest with a coefficient operator,
    in both packages; the port's solver carries the coefficient fields
    and the identity eps_bc of its plain route on every level."""
    for kind in ("L", "two", "periodic"):
        t = forest_tree(port, ptm, kind)
        cfg = port.MGConfig(operator=op, device="cpu")
        assert not port.dense_amr_supported(t, cfg), kind
        assert port.dense_forest_supported(t, cfg), kind
        assert isinstance(ref.make_solver(forest_tree(ref, rtm, kind),
                                          ref.MGConfig(operator=op)),
                          RefForest)
        sv = port.make_solver(t, cfg)
        assert isinstance(sv, port.DenseForestMGSolver)
        assert sv.n_eps == N_EPS[op]
        assert sv._field_keys[-sv.n_eps:] == tuple(
            f"eps{d}" for d in range(sv.n_eps))
        for lvl in sv.levels:
            cfg_l = sv._kcfgs[lvl]
            assert cfg_l.n_eps == sv.n_eps
            assert cfg_l.eps_bc == [(1.0, 0.0, 0.0)] * 6
            assert sv._seg_desc(lvl) is None   # the reference's gate


def test_state_from_numpy_carries_eps():
    """A forest state with coefficient fields crosses both ways; a
    missing eps field or a wrong canvas shape is refused."""
    rs, ps = make_pair("L", "ahelmholtz")
    _, npst = random_state(rs, 2)
    ts = convert.state_from_numpy(ps, npst)
    back = convert.state_to_numpy(ts)
    for k in ("phi", "rhs", "eps0", "eps1", "eps2"):
        for lvl in ps.levels:
            np.testing.assert_array_equal(back[k][lvl], npst[k][lvl])
    bad = {k: v for k, v in npst.items() if k != "eps2"}
    with pytest.raises(ValueError, match="eps2"):
        convert.state_from_numpy(ps, bad)
    bad = dict(npst)
    top = ps.levels[-1]
    bad["eps1"] = dict(npst["eps1"])
    bad["eps1"][top] = npst["eps1"][top][:-1]
    with pytest.raises(ValueError, match="shape"):
        convert.state_from_numpy(ps, bad)


def test_set_interior_pins_garbage_coefficients():
    """Coefficient garbage cells become 1 (zero eps there would make the
    garbage harmonic means 0/0 = NaN), as in the reference."""
    rs, ps = make_pair("L", "vhelmholtz")
    lvl = ps.levels[-1]
    vals = np.zeros(ps._ishape(lvl))
    js = rs.set_interior(rs.allocate(), lvl, "eps0", jnp.asarray(vals))
    ts = ps.set_interior(ps.allocate(), lvl, "eps0", vals)
    np.testing.assert_array_equal(ps.interior(ts, lvl, "eps0").numpy(),
                                  np.asarray(rs.interior(js, lvl, "eps0")))
    assert float(ps.interior(ts, lvl, "eps0").sum()) == float(
        np.sum(~ps.footprint_mask(lvl)))


# ---------------------------------------------------------------------------
# phases against the reference (eager: bitwise)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["L", "periodic"])
@pytest.mark.parametrize("op", ["vlaplacian", "ahelmholtz"])
def test_smooth_bitwise_reference(kind, op):
    """Canvas smoothing (two GSRB cycles on the top level) == the
    reference's on every footprint cell, the eps ring/plane synthesis
    and the coefficient-aware concave-corner fix-ups included; every
    half-sweep on the plain route."""
    rs, ps = make_pair(kind, op)
    js, npst = random_state(rs, 7)
    top = rs.levels[-1]
    lam = lam_of(op)
    want = rs._smooth(dict(js), top, 2, jnp.asarray(lam, jnp.float64))
    ts = convert.state_from_numpy(ps, npst)
    dk.reset_plain_route_counts()
    ts = ps._smooth(ts, top, 2, lam)
    assert dk.plain_route_counts()["half_sweep_dense[eps_bc]"] == 4
    np.testing.assert_array_equal(
        fp(ps, top, ps.interior(ts, top, "phi").numpy()),
        fp(rs, top, rs.interior(want, top, "phi")))


@pytest.mark.parametrize("kind", ["L", "two", "periodic"])
def test_residual_bitwise_reference(kind):
    rs, ps = make_pair(kind, "vhelmholtz")
    js, npst = random_state(rs, 5)
    lam = 0.7
    for lvl in rs.levels[-2:]:
        want = rs._residual(dict(js), lvl, jnp.asarray(lam, jnp.float64))
        ts = convert.state_from_numpy(ps, npst)
        ts = ps._residual(ts, lvl, lam)
        np.testing.assert_array_equal(
            fp(ps, lvl, ps.interior(ts, lvl, "ires").numpy()),
            fp(rs, lvl, rs.interior(want, lvl, "ires")))


def test_eps_assembly_matches_reference():
    """The assembled coefficient fields (ringed canvas and six face
    planes) of a level with refinement, physical and conflicted ring
    segments, bitwise the reference's."""
    rs, ps = make_pair("L", "ahelmholtz")
    js, npst = random_state(rs, 11)
    ts = convert.state_from_numpy(ps, npst)
    for lvl in rs.levels[-2:]:
        want = rs._eps_assemble(js, lvl)
        got = ps._eps_assemble(ts, lvl)
        assert len(got) == len(want) == 3
        for (wc, wp, _), (gc, gp, _) in zip(want, got):
            np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
            for a, b in zip(wp, gp):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_eps_memo_sees_in_place_writes():
    """The memoized coefficient assembly is rebuilt after an in-place
    write to a coefficient canvas (set_coefficient, prepare_coefficient)
    and reused while the fields stay unchanged."""
    rs, ps = make_pair("L", "vhelmholtz")
    _, npst = random_state(rs, 4)
    ts = convert.state_from_numpy(ps, npst)
    top = ps.levels[-1]
    first = ps._eps_assemble(ts, top)
    assert ps._eps_assemble(ts, top) is first
    before = first[0][0].clone()
    ps.set_coefficient(ts, 2.0 + np.zeros(ps._ishape(top)))
    again = ps._eps_assemble(ts, top)
    assert again is not first
    ps.__dict__.pop("_easm_memo")
    fresh = ps._eps_assemble(ts, top)
    assert torch.equal(again[0][0], fresh[0][0])
    assert not torch.equal(again[0][0], before)
    # a coarser level's field feeds the refinement-face strips
    ts["eps0"][top - 1][dk._ISL] += 1.0
    assert ps._eps_assemble(ts, top) is not fresh


# ---------------------------------------------------------------------------
# the port's forest against the port's boxed solver (bitwise phases)
# ---------------------------------------------------------------------------

def boxed_to_canvas(sb, sd, st_b, lvl, iv):
    """Scatter a boxed level into the dense canvas [Z, Y, X] (garbage
    cells zero; tests/test_dense_forest.py's helper)."""
    t = sb.tree
    nc = t.box_size_lvl[lvl]
    X, Y, Z = sd.dims[lvl]
    off = sd.offsets[lvl] // nc
    out = np.zeros((Z, Y, X))
    arr = st_b["cc"][lvl][iv].numpy()
    for loc, b in enumerate(t.lvls[lvl].ids):
        ix = t.ix[b] - 1 - off
        sl = tuple(slice(ix[d] * nc, (ix[d] + 1) * nc) for d in (2, 1, 0))
        out[sl] = arr[loc][(slice(1, -1),) * 3]
    return out


def boxed_pair(kind, op, seed=7, coarse="smooth"):
    """The port's boxed solver and forest on one tree with the same
    random phi/rhs/eps (tests/test_dense_forest_vcoeff.py's setup_pair:
    the boxed coarse loop, the forest's coarse solve ``coarse``)."""
    tree = forest_tree(port, ptm, kind)
    sb = port.MGSolver(tree, port.MGConfig(operator=op, device="cpu"))
    sd = port.DenseForestMGSolver(tree, port.MGConfig(
        operator=op, device="cpu", coarse_solver=coarse))
    if not all(tree.periodic):
        sb.set_bc(IPHI, port.BCType.DIRICHLET, fn=solution)
        sd.set_bc(0, port.BCType.DIRICHLET, fn=solution)
    st_b, st_d = sb.allocate(), sd.allocate()
    rng = np.random.default_rng(seed)
    kmap = {"phi": IPHI, "rhs": IRHS}
    kmap.update({f"eps{d}": IVEPS + d for d in range(N_EPS[op])})
    isl = (slice(1, -1),) * 3
    for lvl in sb.levels:
        nb, nc = sb.static[lvl]["n_boxes"], sb.static[lvl]["nc"]
        for k, iv in kmap.items():
            v = (rng.normal(size=(nb,) + (nc,) * 3) if k in ("phi", "rhs")
                 else 0.5 + rng.random((nb,) + (nc,) * 3))
            st_b["cc"][lvl][(iv, slice(None)) + isl] = torch.from_numpy(v)
    for iv in kmap.values():
        sb.fill_ghost(st_b, iv)
    for lvl in sd.levels:
        for k, iv in kmap.items():
            sd.set_interior(st_d, lvl, k, boxed_to_canvas(sb, sd, st_b,
                                                          lvl, iv))
    return sb, st_b, sd, st_d


@pytest.mark.parametrize("kind", ["L", "periodic"])
@pytest.mark.parametrize("op", ["vlaplacian", "ahelmholtz"])
def test_smooth_and_residual_bitwise_boxed(kind, op):
    sb, st_b, sd, st_d = boxed_pair(kind, op)
    lvl = sb.levels[-1]
    lam = lam_of(op)
    dmaps = sb._to_device()
    st_b = sb._residual_lvl(st_b, dmaps, lvl, lam)
    st_d = sd._residual(st_d, lvl, lam)
    np.testing.assert_array_equal(
        fp(sd, lvl, sd.interior(st_d, lvl, "ires").numpy()),
        fp(sd, lvl, boxed_to_canvas(sb, sd, st_b, lvl, IRES)))
    st_b = sb._smooth_boxes(st_b, dmaps, lvl, 1, lam)
    st_d = sd._smooth(st_d, lvl, 1, lam)
    np.testing.assert_array_equal(
        fp(sd, lvl, sd.interior(st_d, lvl, "phi").numpy()),
        fp(sd, lvl, boxed_to_canvas(sb, sd, st_b, lvl, IPHI)))


@pytest.mark.parametrize("kind", ["L", "two", "periodic"])
@pytest.mark.parametrize("op", [
    "vhelmholtz", "ahelmholtz",
    # the singular periodic vlaplacian runs the boxed coarse loop to its
    # cap (~18 s)
    pytest.param("vlaplacian", marks=pytest.mark.slow)])
def test_vcycle_equivalent_boxed(kind, op):
    """A whole V-cycle of the port's forest against the port's boxed
    solver within the reference's own bound (5e-13 of max|phi| per
    level, residual 1e-11)."""
    sb, st_b, sd, st_d = boxed_pair(kind, op)
    lam = lam_of(op)
    st_b, res_b = sb.fas_vcycle(st_b, lam=lam)
    st_d, res_d = sd.fas_vcycle(st_d, lam=lam)
    for lvl in sd.levels:
        want = fp(sd, lvl, boxed_to_canvas(sb, sd, st_b, lvl, IPHI))
        got = fp(sd, lvl, sd.interior(st_d, lvl, "phi").numpy())
        assert np.max(np.abs(got - want)) <= 5e-13 * np.max(np.abs(want)), (
            kind, op, lvl)
    assert abs(float(res_b) - float(res_d)) <= 1e-11 * max(
        1.0, abs(float(res_b)))


# ---------------------------------------------------------------------------
# whole cycles against the reference (eager)
# ---------------------------------------------------------------------------

def ref_cycle(rs, js, which, lam):
    fn = rs.fas_vcycle if which == "vcycle" else rs.fas_fmg
    return fn(dict(js), lam=lam)


def assert_cycle_close(rs, js, res_ref, ps, ts, res):
    np.testing.assert_allclose(float(res), float(res_ref), rtol=1e-10)
    for lvl in ps.levels:
        want = fp(rs, lvl, rs.interior(js, lvl, "phi"))
        got = fp(ps, lvl, ps.interior(ts, lvl, "phi").numpy())
        assert np.max(np.abs(got - want)) <= 256 * EPS * np.max(
            np.abs(want)), lvl


@pytest.mark.parametrize("kind,op", [
    ("periodic", "ahelmholtz"),
    # the reference's compiled cycles on the L and two forests take
    # 20-35 s each
    pytest.param("L", "vlaplacian", marks=pytest.mark.slow),
    pytest.param("two", "vhelmholtz", marks=pytest.mark.slow),
    pytest.param("L", "ahelmholtz", marks=pytest.mark.slow),
    pytest.param("two", "vlaplacian", marks=pytest.mark.slow),
    pytest.param("periodic", "vhelmholtz", marks=pytest.mark.slow)])
def test_vcycle_matches_reference(kind, op):
    """One V-cycle with the probed direct coarse solve against the
    reference's."""
    rs, ps = make_pair(kind, op)
    js, npst = random_state(rs, 3)
    lam = lam_of(op)
    js, res_ref = ref_cycle(rs, js, "vcycle", lam)
    ts = convert.state_from_numpy(ps, npst)
    ts, res = ps.fas_vcycle(ts, lam=lam)
    assert_cycle_close(rs, js, res_ref, ps, ts, res)


def test_fmg_direct_coarse():
    """FMG with the probed direct coarse solve (L, vlaplacian): the probe
    reads the restricted coarse-level eps (not ones), and the residual
    reaches the boxed solver's class (the reference's test: res <= 2 *
    boxed)."""
    sb, st_b, sd, st_d = boxed_pair("L", "vlaplacian", seed=9,
                                    coarse="direct")
    st_b, res_b = sb.fas_fmg(st_b)
    st_d, res_d = sd.fas_fmg(st_d)
    assert float(res_d) <= 2.0 * float(res_b) + 1e-8
    assert isinstance(sd._direct, dict)
    st_ones = {**st_d, **{k: {l: torch.ones_like(v)
                              for l, v in st_d[k].items()}
                          for k in sd._eps_keys}}
    ones = sd._build_direct_probe(st_ones)     # the probe on eps = 1
    assert not torch.equal(ones["d"], sd._direct["d"])


@pytest.mark.slow
def test_fmg_direct_coarse_matches_reference():
    """The same FMG against the reference's, from one random state
    (its compiled FMG takes ~35 s)."""
    rs, ps = make_pair("L", "vlaplacian")
    js, npst = random_state(rs, 9)
    js, res_ref = ref_cycle(rs, js, "fmg", 0.0)
    ts = convert.state_from_numpy(ps, npst)
    ts, res = ps.fas_fmg(ts)
    assert_cycle_close(rs, js, res_ref, ps, ts, res)


def test_prepare_coefficient_restricts():
    """set_coefficient on the finest level + prepare_coefficient builds
    the coarse eps by footprint restriction, as the reference's: the
    coarse image cells are the mean of their 8 children, bitwise the
    reference's prepare_coefficient on every level's footprint."""
    t = forest_tree(port, ptm, "L")
    ps = port.DenseForestMGSolver(t, port.MGConfig(operator="vlaplacian",
                                                   device="cpu"))
    rs = RefForest(forest_tree(ref, rtm, "L"),
                   ref.MGConfig(operator="vlaplacian"))
    rng = np.random.default_rng(3)
    top = ps.levels[-1]
    vals = 0.5 + rng.random(ps._ishape(top))
    st = ps.set_coefficient(ps.allocate(), vals)
    st = ps.prepare_coefficient(st)
    js = rs.prepare_coefficient(rs.set_coefficient(rs.allocate(),
                                                   jnp.asarray(vals)))
    lvl = top - 1
    got = ps.interior(st, lvl, "eps0").numpy()
    Z, Y, X = vals.shape
    avg = vals.reshape(Z // 2, 2, Y // 2, 2, X // 2, 2).mean((1, 3, 5))
    off_f, off_c = ps.offsets[top], ps.offsets[lvl]
    for lo, hi in ps.geom[top].rects:
        clo = (off_f + lo) // 2 - off_c
        chi = (off_f + hi) // 2 - off_c
        win = (slice(int(lo[2]) // 2, int(hi[2]) // 2),
               slice(int(lo[1]) // 2, int(hi[1]) // 2),
               slice(int(lo[0]) // 2, int(hi[0]) // 2))
        np.testing.assert_allclose(
            got[clo[2]:chi[2], clo[1]:chi[1], clo[0]:chi[0]], avg[win],
            rtol=0, atol=1e-14)
    for l in ps.levels:
        np.testing.assert_allclose(
            fp(ps, l, ps.interior(st, l, "eps0").numpy()),
            fp(rs, l, rs.interior(js, l, "eps0")), rtol=0,
            atol=64 * EPS * 1.5)
