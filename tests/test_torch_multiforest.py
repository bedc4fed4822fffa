"""The multi-canvas dense forest of the PyTorch package against the JAX
package's DenseMultiForestMGSolver, float64 on the CPU, and against the
port's own boxed MGSolver.

Trees: the sparse forests of tests/test_dense_multiforest.py ("eight":
eight isolated corner patches; "mixed": a blob, an L-shaped patch with a
concave corner and a lone box; "threelvl": sparse at two depths; 16-32^3
base, box 4) and chip_smoke.forest_tree's "sparse" at base 16, box 4 (the
tree chip_smoke.py's multiforest_path runs at base 512, box 16).  Inputs
are made with numpy from a seed; the JAX package's results are shared
through module-scoped fixtures.

Bounds, on footprint cells (canvas cells outside a unit's footprint are
garbage by contract and never compared):

* each phase against the JAX package run eagerly (``jax.disable_jit``):
  ``64 * eps64 * max|reference|``, the port's per-call bound; the
  sequential path's smoothing and residual are bitwise (same operation
  order), the bound covers the segment path's read-time ghost synthesis
  and the restriction's summation order inside a V-cycle;
* against the port's boxed solver: the sequential path's smoothing and
  residual are bitwise (the boxed per-box ghost layout and the canvas
  give the same per-cell expressions, as the JAX package's own test
  holds its two); a V-cycle within 1e-13 of max|phi| with the residual
  max within 1e-12 relative, the JAX test's bounds;
* the segment path against the sequential one: 32 ulp of the field
  scale, the bound the JAX package sets between its two paths;
* float32 FMG histories, port against the compiled JAX package: relative
  1e-4 per cycle (XLA contracts a*b+c into FMAs in the compiled
  reference, eager torch does not; each cycle's float32 roundings then
  differ in the last bits, which shows in the residual max at ~1e-6
  relative).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octree_mg_tpu as ref
from octree_mg_tpu.core import tree as rtm
from octree_mg_tpu.solve.dense_forest import (
    dense_forest_supported as ref_dense_forest_supported)
from octree_mg_tpu.solve.dense_multiforest import (
    DenseMultiForestMGSolver as RefMulti)
from octree_mg_tpu.solve.refine import solve_refined as ref_solve_refined

import octree_mg_tpu_torch as port
from octree_mg_tpu_torch import convert
from octree_mg_tpu_torch.core import tree as ptm
from octree_mg_tpu_torch.core.constants import IPHI, IRES, IRHS

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import forest_tree as shared_forest_tree  # noqa: E402

torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps
KINDS = ("eight", "mixed", "threelvl")


def _refine(tm, t, lvl, pred):
    ids = t.lvls[lvl].ids
    pick = [int(b) for b in ids if pred(t.ix[int(b)])]
    tm.add_children_bulk(t, np.array(pick, np.int64))
    tm.set_leaves_parents(t, lvl)
    tm.set_next_level_ids(t, lvl)
    tm.set_neighbors_lvl(t, lvl + 1)


def sparse_tree(pkg, tm, kind):
    """tests/test_dense_multiforest.py's sparse_tree, in either package,
    and chip_smoke.forest_tree's "sparse" at base 16, box 4."""
    if kind == "sparse":
        return shared_forest_tree(pkg, tm, "sparse", 16, 4)
    if kind == "eight":
        t = pkg.build_rectangle(3, [32] * 3, 4, [1 / 32.] * 3, [0] * 3)
        corners = {1, 6}
        _refine(tm, t, 1, lambda ix: all(v in corners for v in ix))
        tm.finalize_amr(t, 2)
    elif kind == "mixed":
        t = pkg.build_rectangle(3, [32] * 3, 4, [1 / 32.] * 3, [0] * 3)

        def pred(ix):
            if all(1 <= v <= 2 for v in ix):
                return True                      # blob
            if ix[2] == 7 and ix[0] >= 6 and ix[1] >= 6 \
                    and not (ix[0] == 7 and ix[1] == 7):
                return True                      # L (concave corner)
            return bool(ix[0] == 7 and ix[1] == 1 and ix[2] == 4)
        _refine(tm, t, 1, pred)
        tm.finalize_amr(t, 2)
    elif kind == "threelvl":
        t = pkg.build_rectangle(3, [16] * 3, 4, [1 / 16.] * 3, [0] * 3)
        _refine(tm, t, 1, lambda ix: np.all(ix <= 1) or np.all(ix >= 4))
        _refine(tm, t, 2, lambda ix: np.all(ix <= 1))
        tm.finalize_amr(t, 3)
    else:
        raise ValueError(kind)
    return t


def to_np(js):
    out = {k: {u: np.asarray(v) for u, v in js[k].items()}
           for k in js if k != "bc"}
    out["bc"] = {u: [np.asarray(p) for p in ps] for u, ps in js["bc"].items()}
    return out


def fp_diff(rs, js, ps, ts, u, key):
    """(max footprint |port - reference|, max footprint |reference|)."""
    m = rs.footprint_mask(u)
    w = np.where(m, np.asarray(rs.interior(js, u, key)), 0.0)
    g = np.where(m, ps.interior(ts, u, key).numpy(), 0.0)
    return float(np.max(np.abs(g - w))), float(np.max(np.abs(w)))


def random_state(rs, seed, keys=("phi", "rhs")):
    js = rs.allocate()
    rng = np.random.default_rng(seed)
    for lvl in rs.levels:
        for u in rs.units_of(lvl):
            X, Y, Z = rs.dims[u]
            for k in keys:
                js = rs.set_interior(js, u, k,
                                     jnp.asarray(rng.normal(size=(Z, Y, X))))
    return js


def make_pair(kind, operator="laplacian", coarse_solver="smooth",
              dtype=torch.float64, bc=0.25):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    rs = RefMulti(sparse_tree(ref, rtm, kind), ref.MGConfig(
        operator=operator, coarse_solver=coarse_solver, dtype=jdt))
    ps = port.DenseMultiForestMGSolver(
        sparse_tree(port, ptm, kind), port.MGConfig(
            operator=operator, coarse_solver=coarse_solver, dtype=dtype,
            device="cpu"))
    rs.set_bc(0, ref.BCType.DIRICHLET, bc)
    ps.set_bc(0, port.BCType.DIRICHLET, bc)
    return rs, ps


def port_state(ps, npst, fused):
    ps.seg_fused = fused
    ps.__dict__.pop("_seg_desc_memo", None)
    return convert.state_from_numpy(ps, npst)


# ---------------------------------------------------------------------------
# gate, routing, geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS + ("sparse",))
def test_gating_and_routing_as_reference(kind):
    rt, pt = sparse_tree(ref, rtm, kind), sparse_tree(port, ptm, kind)
    rcfg, pcfg = ref.MGConfig(), port.MGConfig(device="cpu")
    assert not ref_dense_forest_supported(rt, rcfg)
    assert not port.dense_forest_supported(pt, pcfg)
    assert ref.dense_multiforest_supported(rt, rcfg)
    assert port.dense_multiforest_supported(pt, pcfg)
    rs, ps = ref.make_solver(rt, rcfg), port.make_solver(pt, pcfg)
    assert type(rs).__name__ == type(ps).__name__ \
        == "DenseMultiForestMGSolver"
    assert isinstance(ps, port.DenseMultiForestMGSolver)
    assert rs.levels == ps.levels and rs.units == ps.units
    assert rs._coarse_unit == ps._coarse_unit
    assert max(len(ps.units_of(l)) for l in ps.levels) >= 2
    for lvl in ps.levels:
        for u in ps.units_of(lvl):
            assert rs.dims[u] == ps.dims[u]
            np.testing.assert_array_equal(rs.offsets[u], ps.offsets[u])
            np.testing.assert_array_equal(rs.geom[u].ids, ps.geom[u].ids)
            assert [(s.nb, s.kind, s.sink, tuple(s.lo), tuple(s.hi), s.src,
                     s.cg) for s in rs.segs[u]] == \
                [(s.nb, s.kind, s.sink, tuple(s.lo), tuple(s.hi), s.src,
                  s.cg) for s in ps.segs[u]]
            assert (rs.conflicts[u] is None) == (ps.conflicts[u] is None)
            np.testing.assert_array_equal(rs.footprint_mask(u),
                                          ps.footprint_mask(u))
    if kind == "eight":
        assert len(ps.units_of(ps.levels[-1])) == 8
    if kind == "mixed":
        assert any(ps.conflicts[u] is not None for u in ps.units_of(2))


def test_periodic_and_refined_refusals_as_reference():
    """A fully periodic sparse tree is outside both packages' gate (the
    boxed solver takes it); the solver itself refuses a mean removal and
    the GSPMD placement; solve_refined refuses a multi-canvas solver
    with the JAX package's text."""
    rt = shared_forest_tree(ref, rtm, "sparse_periodic", 16, 4)
    pt = shared_forest_tree(port, ptm, "sparse_periodic", 16, 4)
    assert not ref.dense_multiforest_supported(rt, ref.MGConfig())
    assert not port.dense_multiforest_supported(
        pt, port.MGConfig(device="cpu"))
    assert type(ref.make_solver(rt, ref.MGConfig())).__name__ == "MGSolver"
    assert isinstance(port.make_solver(pt, port.MGConfig(device="cpu")),
                      port.MGSolver)
    with pytest.raises(ValueError, match="gate"):
        port.DenseMultiForestMGSolver(pt, port.MGConfig(device="cpu"))
    rs, ps = make_pair("eight", dtype=torch.float32)
    with pytest.raises(NotImplementedError) as want:
        ref_solve_refined(rs, rs.allocate(), {}, {})
    with pytest.raises(NotImplementedError) as got:
        port.solve_refined(ps, ps.allocate(), {}, {})
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError) as got:
        port.RefinedForestPoisson(ps)
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError, match="multi-canvas"):
        ps._subtract_mean(ps.allocate(), "phi")
    with pytest.raises(NotImplementedError, match="A13b"):
        ps.shard_state(ps.allocate(), None)


# ---------------------------------------------------------------------------
# phases against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=KINDS)
def ref_phases(request):
    """The JAX package's top-level smooth and residual, run eagerly, on
    one random state per tree."""
    kind = request.param
    rs, ps = make_pair(kind)
    js = random_state(rs, 3)
    top = rs.levels[-1]
    lam = jnp.asarray(0.0, jnp.float64)
    with jax.disable_jit():
        out = {"smooth": rs._smooth(dict(js), top, 1, lam),
               "residual": rs._residual(dict(js), top, lam)}
    return dict(rs=rs, ps=ps, out=out, np=to_np(js))


@pytest.mark.parametrize("fused", [False, True], ids=["sequential", "seg"])
@pytest.mark.parametrize("phase", ["smooth", "residual"])
def test_phase_matches_reference(ref_phases, phase, fused):
    """Every unit of the top level after one smoothing cycle or a
    residual: within 64 eps of the JAX package, and bitwise on the
    sequential path (the reference's operation order, eager)."""
    rs, ps = ref_phases["rs"], ref_phases["ps"]
    top = ps.levels[-1]
    ts = port_state(ps, ref_phases["np"], fused)
    if phase == "smooth":
        ts = ps._smooth(ts, top, 1, 0.0)
        key = "phi"
    else:
        ts = ps._residual(ts, top, 0.0)
        key = "ires"
    for u in ps.units_of(top):
        diff, scale = fp_diff(rs, ref_phases["out"][phase], ps, ts, u, key)
        assert diff <= 64 * EPS * scale, (u, key, diff, scale)
        if not fused:
            assert diff == 0.0, (u, key, diff)


@pytest.fixture(scope="module")
def ref_vcycle():
    """One JAX V-cycle, run eagerly (coarse smoothing, as its own test
    sets up), on the tree that is sparse at two depths (the others'
    V-cycles are held against the boxed solver below; an eager reference
    cycle costs ~30 s of op-by-op compilation on "mixed")."""
    rs, ps = make_pair("threelvl")
    js = random_state(rs, 3)
    lam = jnp.asarray(0.0, jnp.float64)
    npst = to_np(js)
    with jax.disable_jit():
        rs._ensure_direct(js)
        js, res = rs._vcycle(dict(js), lam, None, True, True)
    return dict(rs=rs, ps=ps, js=js, res=float(res), np=npst)


@pytest.mark.parametrize("fused", [False, True], ids=["sequential", "seg"])
def test_vcycle_matches_reference(ref_vcycle, fused):
    """One V-cycle: phi on every unit of every level within 64 eps of the
    JAX package's eager cycle, the residual max within 1e-10."""
    rs, ps = ref_vcycle["rs"], ref_vcycle["ps"]
    ts = port_state(ps, ref_vcycle["np"], fused)
    ts, res = ps.fas_vcycle(ts)
    np.testing.assert_allclose(float(res), ref_vcycle["res"], rtol=1e-10)
    for lvl in ps.levels:
        for u in ps.units_of(lvl):
            diff, scale = fp_diff(rs, ref_vcycle["js"], ps, ts, u, "phi")
            assert diff <= 64 * EPS * scale, (u, diff, scale)


# ---------------------------------------------------------------------------
# phases against the port's boxed solver
# ---------------------------------------------------------------------------

def boxed_to_unit(sb, sd, cc, u, iv):
    """A boxed level's component boxes scattered into a unit canvas."""
    t = sb.tree
    g = sd.geom[u]
    lvl = g.lvl
    nc = t.box_size_lvl[lvl]
    X, Y, Z = sd.dims[u]
    off = sd.offsets[u] // nc
    out = np.zeros((Z, Y, X))
    arr = cc[lvl][iv].numpy()
    pos = {int(b): i for i, b in enumerate(t.lvls[lvl].ids)}
    for b in g.ids:
        ix = t.ix[int(b)] - 1 - off
        sl = tuple(slice(ix[d] * nc, (ix[d] + 1) * nc) for d in (2, 1, 0))
        out[sl] = arr[pos[int(b)]][(slice(1, -1),) * 3]
    return out


def setup_boxed_pair(kind, fused, seed=3):
    """The port's boxed solver and multi-canvas forest on one random
    state (tests/test_dense_multiforest.py's setup_pair)."""
    tree = sparse_tree(port, ptm, kind)
    sb = port.MGSolver(tree, port.MGConfig(device="cpu"))
    sd = port.DenseMultiForestMGSolver(tree, port.MGConfig(
        coarse_solver="smooth", device="cpu"))
    sd.seg_fused = fused
    sb.set_bc(IPHI, port.BCType.DIRICHLET, 0.25)
    sd.set_bc(0, port.BCType.DIRICHLET, 0.25)
    st_b, st_d = sb.allocate(), sd.allocate()
    rng = np.random.default_rng(seed)
    for lvl in sb.levels:
        nb, nc = sb.static[lvl]["n_boxes"], sb.static[lvl]["nc"]
        isl = (slice(None),) + (slice(1, -1),) * 3
        for iv in (IPHI, IRHS):
            st_b["cc"][lvl][(iv,) + isl] = torch.as_tensor(
                rng.normal(size=(nb,) + (nc,) * 3))
    st_b = sb.fill_ghost(st_b, IPHI)
    st_b = sb.fill_ghost(st_b, IRHS)
    for lvl in sd.levels:
        for u in sd.units_of(lvl):
            for k, iv in (("phi", IPHI), ("rhs", IRHS)):
                sd.set_interior(st_d, u, k,
                                boxed_to_unit(sb, sd, st_b["cc"], u, iv))
    return sb, st_b, sd, st_d


def cmp_level(sb, st_b, sd, st_d, lvl, iv, key):
    worst = 0.0
    for u in sd.units_of(lvl):
        want = boxed_to_unit(sb, sd, st_b["cc"], u, iv)
        got = sd.interior(st_d, u, key).numpy() * sd.footprint_mask(u)
        worst = max(worst, float(np.max(np.abs(got - want))))
    return worst


@pytest.mark.parametrize("fused", [False, True], ids=["sequential", "seg"])
@pytest.mark.parametrize("kind", KINDS)
def test_phases_bitwise_boxed(kind, fused):
    """Per-unit smoothing and residual against the port's boxed
    smooth_boxes / residual: bitwise on the sequential path, 32 ulp of
    the field scale on the segment path; a V-cycle within the JAX test's
    bounds."""
    sb, st_b, sd, st_d = setup_boxed_pair(kind, fused)
    lvl = sb.levels[-1]
    dm = sb._to_device()
    scale = max(float(st_b["cc"][lvl][IPHI].abs().max()), 1.0)
    bound = 0.0 if not fused else 32 * EPS * scale
    sb2 = sb._smooth_boxes({"cc": {l: v.clone() for l, v in
                                   st_b["cc"].items()},
                            "bc": st_b["bc"]}, dm, lvl, 1, 0.0)
    sd2 = sd._smooth(convert.state_from_numpy(
        sd, convert.state_to_numpy(st_d)), lvl, 1, 0.0)
    assert cmp_level(sb, sb2, sd, sd2, lvl, IPHI, "phi") <= bound
    sb2 = sb._residual_lvl({"cc": {l: v.clone() for l, v in
                                   st_b["cc"].items()},
                            "bc": st_b["bc"]}, dm, lvl, 0.0)
    sd2 = sd._residual(convert.state_from_numpy(
        sd, convert.state_to_numpy(st_d)), lvl, 0.0)
    rscale = float(sb2["cc"][lvl][IRES].abs().max())
    assert cmp_level(sb, sb2, sd, sd2, lvl, IRES, "ires") <= (
        0.0 if not fused else 32 * EPS * rscale)
    st_b, res_b = sb.fas_vcycle(st_b)
    st_d, res_d = sd.fas_vcycle(st_d)
    top = sd.levels[-1]
    scale = float(st_b["cc"][top][IPHI].abs().max())
    assert cmp_level(sb, st_b, sd, st_d, top, IPHI, "phi") <= 1e-13 * scale
    assert abs(float(res_b) - float(res_d)) <= 1e-12 * float(res_b)


# ---------------------------------------------------------------------------
# whole cycles: float32 histories, coefficients
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_fmg32():
    """The compiled JAX package's float32 history on "sparse": one
    zero-guess FMG, then two V-cycles, Dirichlet 0, direct coarse solve,
    seeded normal rhs on the top level's units."""
    rs, ps = make_pair("sparse", coarse_solver="direct",
                       dtype=torch.float32, bc=0.0)
    js = rs.allocate()
    rng = np.random.default_rng(17)
    rhs = {u: rng.normal(size=rs.dims[u][::-1])
           for u in rs.units_of(rs.levels[-1])}
    for u, v in rhs.items():
        js = rs.set_interior(js, u, "rhs", jnp.asarray(v, jnp.float32))
    hist = []
    js, r = rs.fas_fmg(js)
    hist.append(float(r))
    for _ in range(2):
        js, r = rs.fas_vcycle(js)
        hist.append(float(r))
    return dict(ps=ps, rhs=rhs, hist=hist)


def test_float32_history_matches_reference(ref_fmg32):
    ps = ref_fmg32["ps"]
    ts = ps.allocate()
    for u, v in ref_fmg32["rhs"].items():
        ps.set_interior(ts, u, "rhs", v)
    hist = []
    ts, r = ps.fas_fmg(ts)
    hist.append(float(r))
    for _ in range(2):
        ts, r = ps.fas_vcycle(ts)
        hist.append(float(r))
    np.testing.assert_allclose(hist, ref_fmg32["hist"], rtol=1e-4)
    assert hist[2] < 0.2 * hist[1] < 0.04 * hist[0]


def test_vhelmholtz_prepare_coefficient_matches_reference():
    """vhelmholtz on "eight": eps set on the top level's units and
    restricted down by prepare_coefficient in both packages (the port
    keeps every coarse unit's tensor), then the top level's smoothing and
    residual at lam 0.4 against the JAX package run eagerly (64 eps), and
    one FMG and one V-cycle of the port contracting as the JAX test
    requires."""
    rs, ps = make_pair("eight", operator="vhelmholtz", coarse_solver="direct",
                       bc=0.0)
    assert isinstance(port.make_solver(sparse_tree(port, ptm, "eight"),
                                       port.MGConfig(operator="vhelmholtz",
                                                     device="cpu")),
                      port.DenseMultiForestMGSolver)
    js = rs.allocate()
    rng = np.random.default_rng(9)
    top = rs.levels[-1]
    for u in rs.units_of(top):
        X, Y, Z = rs.dims[u]
        for k in ("rhs", "phi"):
            js = rs.set_interior(js, u, k,
                                 jnp.asarray(rng.normal(size=(Z, Y, X))))
        js = rs.set_interior(js, u, "eps0",
                             jnp.asarray(0.5 + rng.random((Z, Y, X))))
    ts = convert.state_from_numpy(ps, to_np(js))
    ids = {u: id(v) for u, v in ts["eps0"].items()}
    js = rs.prepare_coefficient(js)
    ts = ps.prepare_coefficient(ts)
    assert {u: id(v) for u, v in ts["eps0"].items()} == ids
    for lvl in ps.levels:
        for u in ps.units_of(lvl):
            diff, scale = fp_diff(rs, js, ps, ts, u, "eps0")
            assert diff <= 64 * EPS * scale, (u, diff)
    lam = jnp.asarray(0.4, jnp.float64)
    with jax.disable_jit():
        want = {"phi": rs._smooth(dict(js), top, 1, lam),
                "ires": rs._residual(dict(js), top, lam)}
    npst = to_np(js)
    got = {"phi": ps._smooth(convert.state_from_numpy(ps, npst), top, 1,
                             0.4),
           "ires": ps._residual(convert.state_from_numpy(ps, npst), top,
                                0.4)}
    for key in ("phi", "ires"):
        for u in ps.units_of(top):
            diff, scale = fp_diff(rs, want[key], ps, got[key], u, key)
            assert diff <= 64 * EPS * scale, (key, u, diff)
    for u in ps.units_of(top):
        ps.set_interior(ts, u, "phi", np.zeros(ps._ishape(u)))
    ts, p0 = ps.fas_fmg(ts, lam=0.4)
    ts, p1 = ps.fas_vcycle(ts, lam=0.4)
    assert float(p1) < 0.5 * float(p0), (float(p0), float(p1))


def test_apply_operator_and_direct_level():
    """apply_operator writes every unit; the direct coarse level is the
    finest single full canvas within DIRECT_MAX_CELLS, as the JAX
    package picks it."""
    rs, ps = make_pair("threelvl", coarse_solver="direct")
    assert rs.levels == ps.levels
    js = random_state(rs, 4)
    ts = convert.state_from_numpy(ps, to_np(js))
    js = rs.apply_operator(js)
    ts = ps.apply_operator(ts)
    for lvl in ps.levels:
        for u in ps.units_of(lvl):
            diff, scale = fp_diff(rs, js, ps, ts, u, "ires")
            assert diff <= 64 * EPS * scale, (u, diff)
