"""The dense forest of the PyTorch package against the JAX package's
DenseForestMGSolver, float64 on the CPU.

Trees: the three forests of tests/test_dense_forest.py (L-shaped
three-level, two disjoint patches, a corner patch in a fully periodic
domain; 16^3 base, box 4).  States are made with numpy from a seed in
the reference and carried over with ``convert.state_from_numpy``.  The
reference runs its sequential plain-XLA path (``seg_fused = False``: on
these canvases its Pallas segment body is gated off anyway); the port
runs both its sequential path and its fused-canvas (segment) path.

Bounds, on footprint cells (canvas cells outside the footprint are
garbage by contract and are never compared):

* each phase on the sequential path: ``64 * eps64 * max|reference|`` —
  eager smoothing and residuals are bitwise (same operation order); the
  restriction sums in the reference's reduce_window order, and XLA:CPU
  contracts a*b+c into FMAs where the reference compiles;
* whole cycles (compiled by the reference): ``256 * eps64 * max|ref|``
  for phi, residuals rtol 1e-10;
* the port's segment path against the reference's sequential path:
  32 ulp of the field scale, the bound the reference's own
  fused-vs-sequential test sets (tests/test_dense_forest.py): the
  segment ghosts are synthesized at read time, the sequential ones are
  written into the canvas, and the concave-corner fix-ups are a separate
  pass.
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
from octree_mg_tpu_torch import convert
from octree_mg_tpu_torch.core import tree as ptm
from octree_mg_tpu_torch.ops import dense_kernels as dk
from octree_mg_tpu_torch.solve import dense_forest as pdf

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import forest_tree as shared_forest_tree  # noqa: E402

# several worker processes on a few cores, small tensors: one intra-op
# thread per process
torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps
KEYS = ("phi", "rhs", "iold", "ires")


def solution(x):
    out = 1.0
    for d in range(x.shape[-1]):
        out = out * np.sin(2 * np.pi * 2 * x[..., d])
    return out


def forest_tree(pkg, tm, kind):
    """tests/test_dense_forest.py's forests, in either package."""
    return shared_forest_tree(pkg, tm, kind, 16, 4)


def seg_tree():
    """tests/test_dense_forest.py's L-shaped _seg_tree (64x16x16, box 4)."""
    return shared_forest_tree(port, ptm, "slab", (64, 16, 16), 4)


def make_pair(kind, operator="laplacian"):
    rs = RefForest(forest_tree(ref, rtm, kind),
                   ref.MGConfig(operator=operator))
    rs.seg_fused = False
    ps = port.make_solver(forest_tree(port, ptm, kind), port.MGConfig(
        operator=operator, device="cpu"))
    assert isinstance(ps, port.DenseForestMGSolver)
    if kind != "periodic":
        rs.set_bc(0, ref.BCType.DIRICHLET, fn=solution)
        ps.set_bc(0, port.BCType.DIRICHLET, fn=solution)
    return rs, ps


def random_np_state(rs, seed, keys=("phi", "rhs", "iold")):
    js = rs.allocate()
    rng = np.random.default_rng(seed)
    for lvl in rs.levels:
        X, Y, Z = rs.dims[lvl]
        for k in keys:
            js = rs.set_interior(js, lvl, k,
                                 jnp.asarray(rng.normal(size=(Z, Y, X))))
    return js


def to_np(js):
    out = {k: {l: np.asarray(v) for l, v in js[k].items()} for k in KEYS}
    out["bc"] = {l: [np.asarray(p) for p in ps] for l, ps in js["bc"].items()}
    return out


def port_state(ps, npst, fused):
    ps.seg_fused = fused
    ps.__dict__.pop("_seg_desc_memo", None)
    return convert.state_from_numpy(ps, npst)


def footprint(sv, lvl, a):
    return np.where(sv.footprint_mask(lvl), a, 0.0)


def assert_fp_close(rs, js, ps, ts, lvl, key, bound):
    w = footprint(rs, lvl, np.asarray(rs.interior(js, lvl, key)))
    g = footprint(ps, lvl, ps.interior(ts, lvl, key).numpy())
    tol = bound * max(np.max(np.abs(w)), 1e-300)
    diff = np.max(np.abs(g - w))
    assert diff <= tol, f"{key}@{lvl}: {diff} > {tol}"


# ---------------------------------------------------------------------------
# geometry, routing, gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["L", "two", "periodic"])
def test_geometry_matches_reference(kind):
    rs, ps = make_pair(kind)
    assert rs.levels == ps.levels and rs.dims == ps.dims
    for lvl in rs.levels:
        assert np.array_equal(rs.offsets[lvl], ps.offsets[lvl])
        a, b = rs.segs[lvl], ps.segs[lvl]
        assert [(s.nb, s.kind, s.sink, tuple(s.lo), tuple(s.hi), s.src, s.cg)
                for s in a] == [(s.nb, s.kind, s.sink, tuple(s.lo),
                                 tuple(s.hi), s.src, s.cg) for s in b]
        ca, cb = rs.conflicts[lvl], ps.conflicts[lvl]
        assert (ca is None) == (cb is None)
        if ca:
            assert [(tuple(f.lo), tuple(f.hi)) for f in ca] == \
                [(tuple(f.lo), tuple(f.hi)) for f in cb]
        np.testing.assert_array_equal(rs.footprint_mask(lvl),
                                      ps.footprint_mask(lvl))
        np.testing.assert_array_equal(rs.cell_centers(lvl),
                                      ps.cell_centers(lvl))
        for a, b in zip(rs._eval_bc_planes(lvl), ps._eval_bc_planes(lvl)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the fused-canvas gate: every level without a wrap segment
    for lvl in ps.levels:
        wraps = any(s.kind == "wrap" for s in ps.segs[lvl])
        assert (ps._seg_desc(lvl) is None) == wraps


def test_routing_and_what_raises():
    cfg = port.MGConfig(device="cpu")
    for kind in ("L", "two", "periodic"):
        t = forest_tree(port, ptm, kind)
        assert port.dense_forest_supported(t, cfg)
        assert isinstance(port.make_solver(t, cfg), port.DenseForestMGSolver)
        assert isinstance(port.PoissonSolver(3, (16,) * 3, 4, tree=t,
                                             device="cpu").solver,
                          port.DenseForestMGSolver)
    # a rectangular AMR patch tree is the dense-patch AMR solver's
    rt = ptm.build_amr_centered(3, 3, np.full(3, 16), 8, np.full(3, 1 / 16))
    assert not port.dense_forest_supported(rt, cfg) or \
        port.dense_amr_supported(rt, cfg)
    assert type(port.make_solver(rt, cfg)) is port.DenseAMRMGSolver
    # variable-coefficient forests go to the forest too (ROADMAP A14,
    # tests/test_torch_forest_vcoeff.py); CUDA graphs on a forest raise
    t = forest_tree(port, ptm, "L")
    for op in ("vlaplacian", "vhelmholtz", "ahelmholtz"):
        assert isinstance(port.make_solver(t, port.MGConfig(
            operator=op, device="cpu")), port.DenseForestMGSolver)
    with pytest.raises(NotImplementedError, match="fused"):
        port.make_solver(t, port.MGConfig(device="cpu", fmg_mode="fused"))
    # the refined mode runs on a forest (RefinedForestPoisson,
    # tests/test_torch_refine_forest.py); a multi-canvas forest refuses
    # it with the JAX package's text
    ps = port.make_solver(t, port.MGConfig(device="cpu",
                                           dtype=torch.float32))
    ps.set_bc(0, port.BCType.DIRICHLET, 0.0)
    rhs = {lvl: np.ones(ps._ishape(lvl)) for lvl in ps.levels}
    zero = {lvl: np.zeros(ps._ishape(lvl)) for lvl in ps.levels}
    x, norms, _ = port.solve_refined(ps, ps.allocate(), rhs, zero,
                                     n_outer=2)
    assert len(norms) == 3 and norms[2] < 0.1 * norms[0]
    assert set(x) == set(ps.levels)
    st = shared_forest_tree(port, ptm, "sparse", 16, 4)
    rt = shared_forest_tree(ref, rtm, "sparse", 16, 4)
    ms = port.make_solver(st, port.MGConfig(device="cpu",
                                            dtype=torch.float32))
    assert isinstance(ms, port.DenseMultiForestMGSolver)
    with pytest.raises(NotImplementedError) as want:
        ref.solve_refined(ref.make_solver(rt, ref.MGConfig(
            dtype=jnp.float32)), None, {}, {})
    with pytest.raises(NotImplementedError) as got:
        port.solve_refined(ms, None, {}, {})
    assert str(got.value) == str(want.value)
    # the default device is the card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port.make_solver(t, port.MGConfig())


# ---------------------------------------------------------------------------
# phases against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["L", "two", "periodic"])
def phases(request):
    """The reference's phases, run eagerly on one random state per
    tree: smooth and residual on the top level, update_coarse of the top
    level, correct_children into it."""
    kind = request.param
    rs, ps = make_pair(kind, operator="helmholtz" if kind == "L"
                       else "laplacian")
    lam = 0.7 if kind == "L" else 0.0
    js = random_np_state(rs, 3)
    top = rs.levels[-1]
    jl = jnp.asarray(lam, jnp.float64)
    out = {"smooth": rs._smooth(dict(js), top, 2, jl),
           "residual": rs._residual(dict(js), top, jl),
           "update_coarse": rs._update_coarse(dict(js), top, jl),
           "correct_children": rs._correct_children(dict(js), top - 1, jl)}
    return dict(kind=kind, rs=rs, ps=ps, js=js, lam=lam, out=out,
                np=to_np(js))


PHASE_ITEMS = {
    "smooth": lambda top: [(top, "phi")],
    "residual": lambda top: [(top, "ires")],
    "update_coarse": lambda top: [(top - 1, k) for k in ("phi", "rhs",
                                                         "iold")],
    "correct_children": lambda top: [(top, "phi")],
}


@pytest.mark.parametrize("fused", [False, True], ids=["sequential", "seg"])
@pytest.mark.parametrize("phase", list(PHASE_ITEMS))
def test_phase_matches_reference(phases, phase, fused):
    rs, ps, lam = phases["rs"], phases["ps"], phases["lam"]
    top = rs.levels[-1]
    ts = port_state(ps, phases["np"], fused)
    lvl_arg = top - 1 if phase == "correct_children" else top
    fn = {"smooth": lambda: ps._smooth(ts, lvl_arg, 2, lam),
          "residual": lambda: ps._residual(ts, lvl_arg, lam),
          "update_coarse": lambda: ps._update_coarse(ts, lvl_arg, lam),
          "correct_children": lambda: ps._correct_children(ts, lvl_arg,
                                                           lam)}[phase]
    ts = fn()
    bound = 32 * EPS if fused else 64 * EPS
    for lvl, key in PHASE_ITEMS[phase](top):
        if phase == "update_coarse" and key == "iold":
            # iold = phi_c everywhere; compare on the fine image only
            img = np.zeros(rs.footprint_mask(lvl).shape, bool)
            for clo, chi in rs._image_rects(top):
                img[clo[2]:chi[2], clo[1]:chi[1], clo[0]:chi[0]] = True
            w = np.where(img, np.asarray(rs.interior(phases["out"][phase],
                                                     lvl, key)), 0.0)
            g = np.where(img, ps.interior(ts, lvl, key).numpy(), 0.0)
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=bound * np.max(np.abs(w)))
            continue
        assert_fp_close(rs, phases["out"][phase], ps, ts, lvl, key, bound)


@pytest.mark.parametrize("fused", [False, True], ids=["sequential", "seg"])
def test_smoothing_is_bitwise_reference_on_the_footprint(phases, fused):
    """Eager smoothing of the top level: both port paths give the
    reference's bits on every footprint cell (same operation order, no
    contraction outside a compiled program)."""
    rs, ps = phases["rs"], phases["ps"]
    top = rs.levels[-1]
    ts = port_state(ps, phases["np"], fused)
    ts = ps._smooth(ts, top, 2, phases["lam"])
    w = footprint(rs, top, np.asarray(
        rs.interior(phases["out"]["smooth"], top, "phi")))
    g = footprint(ps, top, ps.interior(ts, top, "phi").numpy())
    np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def vcycle_L():
    """The L forest: one compiled reference V-cycle, direct coarse
    solve."""
    rs, ps = make_pair("L")
    js = random_np_state(rs, 5, keys=("phi", "rhs"))
    npst = to_np(js)
    js, res = rs.fas_vcycle(js)
    return dict(rs=rs, ps=ps, js=js, res=float(res), np=npst)


@pytest.mark.parametrize("fused", [False, True], ids=["sequential", "seg"])
def test_vcycle_matches_reference(vcycle_L, fused):
    rs, ps = vcycle_L["rs"], vcycle_L["ps"]
    ts = port_state(ps, vcycle_L["np"], fused)
    ts, res = ps.fas_vcycle(ts)
    np.testing.assert_allclose(float(res), vcycle_L["res"], rtol=1e-10)
    for lvl in ps.levels:
        assert_fp_close(rs, vcycle_L["js"], ps, ts, lvl, "phi", 256 * EPS)


@pytest.fixture(scope="module")
def fmg_periodic():
    """The periodic forest (subtract_mean, wrap segments, sequential path
    on its full levels): one compiled reference FMG from a zero guess."""
    rs, ps = make_pair("periodic")
    js = random_np_state(rs, 9, keys=("rhs",))
    npst = to_np(js)
    js, res = rs.fas_fmg(js)
    return dict(rs=rs, ps=ps, js=js, res=float(res), np=npst)


@pytest.mark.parametrize("fused", [False, True], ids=["sequential", "seg"])
def test_fmg_matches_reference(fmg_periodic, fused):
    rs, ps = fmg_periodic["rs"], fmg_periodic["ps"]
    ts = port_state(ps, fmg_periodic["np"], fused)
    ts, res = ps.fas_fmg(ts)
    np.testing.assert_allclose(float(res), fmg_periodic["res"], rtol=1e-10)
    top = ps.levels[-1]
    assert_fp_close(rs, fmg_periodic["js"], ps, ts, top, "phi", 256 * EPS)


def test_ringed_exports_match_reference():
    """The per-axis ringed exports of a level with concave-corner
    conflicts (the L forest's level 2) and the plain one of a
    conflict-free level, against the reference: same bits everywhere
    (eager, one operation order)."""
    rs, ps = make_pair("L")
    js = random_np_state(rs, 12)
    ts = convert.state_from_numpy(ps, to_np(js))
    assert ps.conflicts[2] is not None and ps.conflicts[3] is None
    for a, b in zip(rs._var_with_ring_axes(js, 2, "phi"),
                    ps._var_with_ring_axes(ts, 2, "phi")):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(
        ps._var_with_ring(ts, 3, "iold").numpy(),
        np.asarray(rs._var_with_ring(js, 3, "iold")))


# ---------------------------------------------------------------------------
# the port's own identities
# ---------------------------------------------------------------------------

def test_prolong_add_is_bitwise_prolong_rect():
    """The forest correction through the prolongation's corr_ready mode
    equals phi[interior] += _prolong_rect(sub), bit for bit."""
    _, ps = make_pair("L")
    top = ps.levels[-1]
    X, Y, Z = ps.dims[top]
    rng = np.random.default_rng(1)
    sub = torch.from_numpy(rng.normal(size=(Z // 2 + 2, Y // 2 + 2,
                                            X // 2 + 2)))
    phi_f = torch.from_numpy(rng.normal(size=dk.padded_shape(ps.dims[top])))
    want = phi_f.clone()
    want[dk._ISL] += ps._prolong_rect(sub)
    got = ps._prolong_add(sub, phi_f.clone())
    assert torch.equal(got[dk._ISL], want[dk._ISL])


def test_sequential_and_seg_cycles_agree():
    """The two smoothing paths of the port, a whole FMG then a V-cycle on
    the reference's kernel-sized L tree (64x16x16): within 32 ulp."""
    out = {}
    for fused in (False, True):
        sv = port.DenseForestMGSolver(seg_tree(),
                                      port.MGConfig(device="cpu"))
        sv.seg_fused = fused
        sv.set_bc(0, port.BCType.DIRICHLET, 0.25)
        st = sv.allocate()
        rng = np.random.default_rng(7)
        for lvl in sv.levels:
            X, Y, Z = sv.dims[lvl]
            sv.set_interior(st, lvl, "rhs", rng.normal(size=(Z, Y, X)))
        top = sv.levels[-1]
        assert (sv._seg_desc(top) is not None) == fused
        st, _ = sv.fas_fmg(st)
        st, res = sv.fas_vcycle(st)
        out[fused] = (footprint(sv, top, sv.interior(st, top, "phi").numpy()),
                      float(res))
    (a, ra), (b, rb) = out[False], out[True]
    assert np.max(np.abs(a - b)) <= 32 * EPS * np.max(np.abs(a))
    assert abs(ra - rb) <= 1e-10 * max(ra, 1.0)


def test_memo_sees_in_place_writes(monkeypatch):
    """An in-place write to a coarse level must change the next rb strip.
    The state is updated in place, so an identity-keyed memo (the JAX
    package's, where a changed array is a new object) would hand back
    the stale strip: shown by keying on identity alone."""
    _, ps = make_pair("L")
    top = ps.levels[-1]
    ts = convert.state_from_numpy(ps, to_np(random_np_state(
        make_pair("L")[0], 4)))
    first = {i: v.clone() for i, v in ps._rb_cache(ts, top, "phi").items()}
    ts["phi"][top - 1][dk._ISL] += 1.0          # in place, same object
    fresh = ps._rb_cache_build(ts, top, "phi")
    again = ps._rb_cache(ts, top, "phi")
    assert first.keys() == fresh.keys() == again.keys()
    assert any(not torch.equal(first[i], fresh[i]) for i in first)
    assert all(torch.equal(again[i], fresh[i]) for i in fresh)
    # with the version dropped from the key, the memo returns stale data
    ps.__dict__.pop("_rbc_memo", None)
    monkeypatch.setattr(pdf, "_sig_matches", lambda sig, t: sig[0]() is t)
    ps._rb_cache(ts, top, "phi")
    ts["phi"][top - 1][dk._ISL] -= 1.0
    stale = ps._rb_cache(ts, top, "phi")
    assert any(not torch.equal(stale[i], first[i]) for i in first)


def test_poisson_solver_on_a_forest():
    """PoissonSolver(tree=forest): manufactured solution on the L forest
    through the model's entry points; solve reads the footprint
    max-norm, phi() is the top canvas.  The rhs is A(solution) level by
    level, so the composite solution differs from the sampled one at the
    discretization level (the reference's own bound, 5e-2,
    tests/test_dense_forest.py)."""
    t = forest_tree(port, ptm, "L")
    ps = port.PoissonSolver(3, (16,) * 3, 4, tree=t, device="cpu")
    sv = ps.solver
    ps.set_dirichlet(fn=solution)
    st = ps._ensure_state()
    for lvl in sv.levels:
        sv.set_interior(st, lvl, "phi", solution(sv.cell_centers(lvl)))
    sv.apply_operator(st, out_key="rhs")
    for lvl in sv.levels:
        sv.interior(st, lvl, "phi").zero_()
    phi, info = ps.solve(rtol=1e-8, max_cycles=8)
    top = sv.levels[-1]
    assert tuple(phi.shape) == sv._ishape(top)
    assert np.array_equal(ps.phi(), phi.numpy())
    res = info["residuals"]
    assert res[-1] < 1e-6 * res[0]
    err = np.max(np.abs(footprint(sv, top, phi.numpy()
                                  - solution(sv.cell_centers(top)))))
    assert err < 5e-2


@pytest.mark.parametrize("kind", ["L", "periodic"])
def test_solve_under_inference_mode_is_bitwise(kind):
    """Under torch.inference_mode() the tensors carry no version counter,
    so the memo stores nothing (an in-place write to a coarse level still
    moves the next rb strip) and a solve gives the bits of a solve
    outside it.  L: the segment path on its patch levels; periodic:
    the sequential path with wrap segments."""
    def run(inference):
        ps = port.PoissonSolver(3, (16,) * 3, 4,
                                tree=forest_tree(port, ptm, kind),
                                device="cpu")
        if kind != "periodic":
            ps.set_dirichlet(fn=solution)
        with torch.inference_mode(inference):
            sv, st = ps.solver, ps._ensure_state()
            rng = np.random.default_rng(3)
            for lvl in sv.levels:
                sv.set_interior(st, lvl, "rhs",
                                rng.normal(size=sv._ishape(lvl)))
            phi, info = ps.solve(rtol=0, max_cycles=2)
            assert phi.is_inference() == inference
            if inference:
                top = sv.levels[-1]
                first = sv._rb_cache(st, top, "phi")
                st["phi"][top - 1][dk._ISL] += 1.0
                again = sv._rb_cache(st, top, "phi")
                assert any(not torch.equal(first[i], again[i])
                           for i in first)
                assert not sv.__dict__.get("_rbc_memo")
        return phi.clone(), info["residuals"]
    (phi, res), (phi_i, res_i) = run(False), run(True)
    assert torch.equal(phi, phi_i)
    assert res == res_i
