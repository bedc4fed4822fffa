"""The boxed solver (MGSolver) of the PyTorch package against the JAX
package's, float64 on the CPU.

Trees (base 16, box 4): a 3D uniform tree, a 2D ``build_amr_centered``
tree, a 1D AMR tree and the sparse periodic tree (two corner patches of
a quarter extent in a fully periodic domain, ``chip_smoke.forest_tree``
kind "sparse_periodic": the tree ``make_solver`` sends to the boxed
solver in both packages).  States are made with numpy from a seed and
carried over with ``convert.state_from_numpy``.

Bounds:

* index maps: equal, field by field;
* each phase (ghost fill, restriction, prolongation, FAS coarse update,
  operator apply and half-sweep of every operator, Jacobi): ``64 *
  eps64 * max|reference|`` — the reference runs eagerly here, op by op
  in one IEEE sequence like the port; the restriction's mean sums in
  another order;
* whole cycles (compiled by the reference): ``256 * eps64 * max|ref|``
  for every field, residuals rtol 1e-10 — XLA:CPU contracts a*b+c into
  FMAs where it compiles, and torch eager does not (the bounds of
  tests/test_torch_forest.py).  Compiling the reference's unrolled
  cycle programs costs 3–26 s a tree on a CPU: the non-slow set holds a
  V-cycle on the 3D tree and an FMG on the 1D tree; the other four are
  ``slow``.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octree_mg_tpu as ref
from octree_mg_tpu.core import indexmaps as rim
from octree_mg_tpu.core import tree as rtm
from octree_mg_tpu.ops import ghost as rghost
from octree_mg_tpu.ops import kernels as rkernels
from octree_mg_tpu.solve.dense import make_solver as ref_make_solver

import octree_mg_tpu_torch as port
from octree_mg_tpu_torch import convert
from octree_mg_tpu_torch.core import indexmaps as pim
from octree_mg_tpu_torch.core import tree as ptm
from octree_mg_tpu_torch.core.constants import IOLD, IPHI, IRES, IRHS, IVEPS
from octree_mg_tpu_torch.ops import ghost as pghost
from octree_mg_tpu_torch.ops import kernels as pkernels

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import forest_tree  # noqa: E402

torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps


def build(kind, pkg, tm):
    """The trees of these tests, in either package."""
    if kind == "uniform3":
        return pkg.build_rectangle(3, np.full(3, 16), 4, np.full(3, 1 / 16),
                                   np.zeros(3))
    if kind == "amr2":
        return tm.build_amr_centered(2, 2, [16, 16], 4, [1 / 16] * 2)
    if kind == "amr1":
        return tm.build_amr_centered(1, 2, [16], 4, [1 / 16])
    if kind == "amr3":
        return tm.build_amr_centered(3, 2, [16] * 3, 4, [1 / 16] * 3)
    if kind == "cyl2":
        return pkg.build_rectangle(2, np.full(2, 16), 4, np.full(2, 1 / 16),
                                   np.array([0.5, 0.0]))
    return forest_tree(pkg, tm, kind, 16, 4)


TREES = ("uniform3", "amr2", "amr1", "sparse_periodic")


def near(got, want, k=64, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max()
    assert err <= k * EPS * scale, f"{what}: {err} > {k} eps * {scale}"


def bc_fn(x):
    return 0.25 + np.sin(3 * x[..., 0]) * np.cos(2 * x[..., -1])


def make_pair(kind, bcs=True, **kw):
    """(reference solver, port solver, numpy state): random fields
    (coefficient variables 0.5 + U[0,1)) and mixed physical BCs."""
    rs = ref.MGSolver(build(kind, ref, rtm), ref.MGConfig(**kw))
    ps = port.MGSolver(build(kind, port, ptm),
                       port.MGConfig(device="cpu", **kw))
    if bcs:
        nnb = 2 * rs.ndim
        spec = [(ref.BCType.DIRICHLET, 0.0, bc_fn),
                (ref.BCType.NEUMANN, 0.3, None),
                (ref.BCType.CONTINUOUS, 0.0, None)]
        for nb in range(nnb):
            t, v, fn = spec[nb % 3]
            rs.set_bc(IPHI, t, value=v, nb=nb, fn=fn)
            ps.set_bc(IPHI, port.BCType(int(t)), value=v, nb=nb, fn=fn)
            # a scalar-valued variable too (bc_vals None in the fill)
            t2 = [ref.BCType.NEUMANN, ref.BCType.DIRICHLET][nb % 2]
            rs.set_bc(IRHS, t2, value=-0.7, nb=nb)
            ps.set_bc(IRHS, port.BCType(int(t2)), value=-0.7, nb=nb)
    rst = rs.allocate()
    rng = np.random.default_rng(5)
    cc = {}
    for lvl in rs.levels:
        a = rng.normal(size=np.asarray(rst["cc"][lvl]).shape)
        a[IVEPS:] = 0.5 + rng.random(size=a[IVEPS:].shape)
        cc[lvl] = a
    bc = {lvl: [np.asarray(p) for p in rst["bc"][lvl]] for lvl in rs.levels}
    return rs, ps, {"cc": cc, "bc": bc}


def states(rs, ps, np_state):
    rst = {"cc": {l: jnp.asarray(a) for l, a in np_state["cc"].items()},
           "bc": {l: [jnp.asarray(p) for p in ps_]
                  for l, ps_ in np_state["bc"].items()}}
    return rst, convert.state_from_numpy(ps, np_state)


def port_cc(pst, lvl):
    return pst["cc"][lvl].numpy()


# ---------------------------------------------------------------------------
# index maps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,pad_to", [(k, 1) for k in TREES]
                         + [("sparse_periodic", 8)])
def test_indexmaps_equal_field_by_field(kind, pad_to):
    rm = rim.build_all_maps(build(kind, ref, rtm), pad_to=pad_to)
    pm = pim.build_all_maps(build(kind, port, ptm), pad_to=pad_to)
    assert sorted(rm) == sorted(pm)
    for lvl in rm:
        a, b = rm[lvl], pm[lvl]
        for f in ("lvl", "nc", "n_boxes", "n_real", "multi_child"):
            assert getattr(a, f) == getattr(b, f), (lvl, f)
        for f in ("parent_locs", "leaf_locs"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype
        for da, db in zip(a.dirs, b.dirs):
            for f in ("nb_loc", "has_nb", "phys_loc", "rb_loc", "rb_cidx"):
                x, y = getattr(da, f), getattr(db, f)
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)
                    assert x.dtype == y.dtype
        assert len(a.phys_face_coords) == len(b.phys_face_coords)
        for x, y in zip(a.phys_face_coords, b.phys_face_coords):
            np.testing.assert_array_equal(x, y)
    D = build(kind, port, ptm).ndim
    for nc in (2, 4):
        np.testing.assert_array_equal(rim.checkerboard_parity(D, nc),
                                      pim.checkerboard_parity(D, nc))


@pytest.mark.parametrize("kind", TREES)
def test_scatter_indices_are_unique(kind):
    """The rows the port writes with index_copy_ (parent locs of a
    restriction or FAS update, refinement-boundary boxes of one
    direction) never repeat, so a row scatter is a set, not an add."""
    for m in pim.build_all_maps(build(kind, port, ptm)).values():
        if m.parent_locs is not None:
            assert len(np.unique(m.parent_locs)) == len(m.parent_locs)
        for d in m.dirs:
            assert len(np.unique(d.rb_loc)) == len(d.rb_loc)
            assert len(np.unique(d.phys_loc)) == len(d.phys_loc)


# ---------------------------------------------------------------------------
# phases (the reference eagerly, op by op)
# ---------------------------------------------------------------------------

# the 1D tree's fills and transfers are held by its whole FMG below
@pytest.mark.parametrize("kind", ("amr3", "amr2", "sparse_periodic"))
def test_fill_ghost(kind):
    """Same-level (periodic included), physical (Dirichlet from a
    function, Neumann, continuous; state-held and scalar values) and
    refinement-boundary ghosts on the two finest levels (where the
    refinement boundaries are; the whole cycles below fill every level),
    two variables on the top."""
    rs, ps, np_state = make_pair(kind)
    rst, pst = states(rs, ps, np_state)
    rdm, pdm = rs._to_device(), ps._to_device()
    for lvl in rs.levels[-2:]:
        for p_r, p_p in zip(rst["bc"][lvl], pst["bc"][lvl]):
            np.testing.assert_array_equal(np.asarray(p_r), p_p.numpy())
        for iv in (IPHI, IRHS) if lvl == rs.levels[-1] else (IPHI,):
            rst = rs._fill_ghost_lvl(rst, rdm, lvl, iv)
            ps._fill_ghost_lvl(pst, pdm, lvl, iv)
            near(port_cc(pst, lvl)[iv], rst["cc"][lvl][iv],
                 what=f"{kind} lvl {lvl} iv {iv}")
    assert any(any(s["mr"]) for s in ps.static.values())


@pytest.mark.parametrize("kind", ("amr2", "sparse_periodic"))
def test_transfer_and_coarse_update(kind):
    """Restriction, prolongation (add and set) and correct_children onto
    the coarsest level (one child of a larger box size) and onto the two
    below the top (2^D children; identity parents below a refined level,
    a parent list onto it); the FAS coarse update from the top."""
    rs, ps, np_state = make_pair(kind)
    rst, pst = states(rs, ps, np_state)
    rdm, pdm = rs._to_device(), ps._to_device()
    pairs = sorted({rs.levels[1]} | set(rs.levels[-2:]))
    assert not ps.static[pairs[0]]["multi_child"]
    assert not all(ps.static[l]["parents_identity"] for l in pairs)
    for lvl in pairs:
        rst = rs._restrict_lvl(rst, rdm, lvl, IPHI)
        ps._restrict_lvl(pst, pdm, lvl, IPHI)
        near(port_cc(pst, lvl - 1)[IPHI], rst["cc"][lvl - 1][IPHI],
             what=f"restrict {lvl}")
        for add in (True, False):
            rst = rs.prolong_lvl(rst, rdm, lvl - 1, IPHI, IRES, add)
            ps.prolong_lvl(pst, pdm, lvl - 1, IPHI, IRES, add)
            near(port_cc(pst, lvl)[IRES], rst["cc"][lvl][IRES],
                 what=f"prolong {lvl} add={add}")
        rst = rs._correct_children(rst, rdm, lvl - 1)
        ps._correct_children(pst, pdm, lvl - 1)
        near(port_cc(pst, lvl)[IPHI], rst["cc"][lvl][IPHI],
             what=f"correct {lvl}")
        if lvl != rs.levels[-1]:
            continue
        rst = rs._update_coarse(rst, rdm, lvl, rs._lam_arr(0.0))
        ps._update_coarse(pst, pdm, lvl, 0.0)
        for iv in (IPHI, IRHS, IOLD, IRES):
            near(port_cc(pst, lvl - 1)[iv], rst["cc"][lvl - 1][iv],
                 what=f"update_coarse {lvl} iv {iv}")
        near(port_cc(pst, lvl)[IRES], rst["cc"][lvl][IRES],
             what=f"update_coarse residual {lvl}")


def test_iold_is_a_copy_not_an_alias():
    """update_coarse with identity parents copies phi into iold: a later
    write to phi leaves iold as it was."""
    _, ps, np_state = make_pair("uniform3", bcs=False)
    pst = convert.state_from_numpy(ps, np_state)
    pdm = ps._to_device()
    top = ps.levels[-1]
    assert ps.static[top]["parents_identity"]
    ps._update_coarse(pst, pdm, top, 0.0)
    c = pst["cc"][top - 1]
    keep = c[IOLD].clone()
    c[IPHI].add_(1.0)
    assert torch.equal(c[IOLD], keep)


OPERATORS = [("laplacian", 0.0), ("helmholtz", 0.7), ("vlaplacian", 0.0),
             ("vhelmholtz", 0.7), ("ahelmholtz", 0.7)]


@pytest.mark.parametrize("op,lam", OPERATORS)
def test_operator_apply_and_half_sweep(op, lam):
    rs, ps, np_state = make_pair("amr3", bcs=False, operator=op)
    rst, pst = states(rs, ps, np_state)
    rdm, pdm = rs._to_device(), ps._to_device()
    for lvl in rs.levels:
        rctx, pctx = rs._op_ctx(lvl, rdm), ps._op_ctx(lvl, pdm)
        rcc = rst["cc"][lvl]
        near(pkernels.op_apply(op, pctx, pst["cc"][lvl], lam),
             rkernels.op_apply(op, rctx, rcc, rs._lam_arr(lam)[0]),
             what=f"{op} apply lvl {lvl}")
        for parity in (0, 1):
            want = rkernels.op_smooth_half(op, rctx, rcc, rs._lam_arr(lam)[0],
                                           rdm[lvl]["parity"] == parity)
            cc = pst["cc"][lvl].clone()
            got = pkernels.op_smooth_half(op, pctx, cc, lam,
                                          pdm[lvl]["upd_mask"][parity])
            assert got.data_ptr() == cc[IPHI].data_ptr()   # in place
            near(got, want, what=f"{op} half-sweep {parity} lvl {lvl}")


#: (lam, 1/dx) of the float32 fac check: the first four round the
#: denominator differently in double and in float32, the rest alike
FAC_PAIRS = [(0.31, 16), (0.31, 40), (0.001, 16), (123.4, 40)] + [
    (lam, inv_dx) for lam in (0.7, 1.5, 2.9) for inv_dx in (100, 256)]


@pytest.mark.parametrize("lam,inv_dx", FAC_PAIRS)
def test_helmholtz_half_sweep_float32_fac_is_the_references(lam, inv_dx):
    """The boxed helmholtz half-sweep in float32, every cell updated, is
    bitwise the JAX function's with lam shaped as the solver's _lam_arr
    shapes it: s + lam and its reciprocal round in float32 there."""
    import types
    rng = np.random.default_rng(int(1000 * lam) + inv_dx)
    ndim, nc, n = 3, 8, 64
    phi = rng.normal(size=(n,) + (nc + 2,) * ndim).astype(np.float32)
    rhs = rng.normal(size=phi.shape).astype(np.float32)
    idr2 = (float(inv_dx) ** 2,) * ndim
    mask = np.ones((1,) + (nc,) * ndim, bool)
    want = rkernels.helmholtz_smooth_half(
        jnp.asarray(phi), jnp.asarray(rhs), ndim, nc, idr2,
        jnp.asarray(lam, jnp.float32).reshape((1,) * (ndim + 1)),
        jnp.asarray(mask))
    ctx = types.SimpleNamespace(ndim=ndim, nc=nc, idr2=idr2,
                                geometry="cartesian")
    cc = torch.zeros((IRHS + 1,) + phi.shape, dtype=torch.float32)
    cc[IPHI], cc[IRHS] = torch.from_numpy(phi), torch.from_numpy(rhs)
    got = pkernels.op_smooth_half("helmholtz", ctx, cc, lam,
                                  torch.from_numpy(mask))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("what", ["apply", "half_sweep"])
def test_cylindrical_laplacian(what):
    rs, ps, np_state = make_pair("cyl2", bcs=False, geometry="cylindrical")
    rst, pst = states(rs, ps, np_state)
    rdm, pdm = rs._to_device(), ps._to_device()
    for lvl in rs.levels:
        for k in ("cyl_w_lo", "cyl_w_hi"):
            np.testing.assert_array_equal(np.asarray(rdm[lvl][k]),
                                          pdm[lvl][k].numpy())
        rctx, pctx = rs._op_ctx(lvl, rdm), ps._op_ctx(lvl, pdm)
        if what == "apply":
            near(pkernels.op_apply("laplacian", pctx, pst["cc"][lvl], 0.0),
                 rkernels.op_apply("laplacian", rctx, rst["cc"][lvl], 0.0))
            continue
        for parity in (0, 1):
            want = rkernels.op_smooth_half("laplacian", rctx,
                                           rst["cc"][lvl], 0.0,
                                           rdm[lvl]["parity"] == parity)
            got = pkernels.op_smooth_half("laplacian", pctx,
                                          pst["cc"][lvl].clone(), 0.0,
                                          pdm[lvl]["upd_mask"][parity])
            near(got, want, what=f"cyl half-sweep {parity} lvl {lvl}")


@pytest.mark.parametrize("kind", ("amr3", "amr1"))
def test_jacobi_sweep(kind):
    rs, ps, np_state = make_pair(kind, bcs=False, smoother="jacobi")
    rst, pst = states(rs, ps, np_state)
    for lvl in rs.levels:
        st = ps.static[lvl]
        rcc = rst["cc"][lvl]
        want = rkernels.jacobi_sweep(rcc[IPHI], rcc[IRHS], rs.ndim, st["nc"],
                                     st["idr2"], 0.4)
        got = pkernels.jacobi_sweep(pst["cc"][lvl][IPHI].clone(),
                                    pst["cc"][lvl][IRHS], ps.ndim, st["nc"],
                                    st["idr2"], 0.4)
        near(got, want, what=f"jacobi lvl {lvl}")


def test_interp_rb_strip_in_every_dimension():
    rng = np.random.default_rng(2)
    for D, shape in ((1, (5, 1)), (2, (5, 6)), (3, (5, 4, 6))):
        tmp = rng.normal(size=shape)
        near(pghost.interp_rb_strip(torch.from_numpy(tmp), D),
             rghost.interp_rb_strip(jnp.asarray(tmp), D), what=f"D={D}")


# ---------------------------------------------------------------------------
# whole cycles (the reference compiled)
# ---------------------------------------------------------------------------

def seeded(rs, ps):
    """A problem state: a seeded rhs on every box (the FMG's FAS update
    replaces it on parents), zero phi."""
    rst = rs.allocate()
    rng = np.random.default_rng(9)
    cc = {}
    for lvl in rs.levels:
        a = np.zeros(np.asarray(rst["cc"][lvl]).shape)
        isl = (slice(None),) + (slice(1, -1),) * rs.ndim
        a[IRHS][isl] = rng.normal(size=a[IRHS][isl].shape)
        cc[lvl] = a
    bc = {lvl: [np.asarray(p) for p in rst["bc"][lvl]] for lvl in rs.levels}
    return states(rs, ps, {"cc": cc, "bc": bc})


def cycle_pair(kind):
    cfg = {}
    rs = ref.MGSolver(build(kind, ref, rtm), ref.MGConfig(**cfg))
    ps = port.MGSolver(build(kind, port, ptm),
                       port.MGConfig(device="cpu", **cfg))
    if kind != "sparse_periodic":
        rs.set_bc(IPHI, ref.BCType.DIRICHLET, fn=bc_fn)
        ps.set_bc(IPHI, port.BCType.DIRICHLET, fn=bc_fn)
    return rs, ps


def compare_states(rs, rst, pst, res_r, res_p, what):
    """Every field of every level within 256 eps of its scale: phi's for
    phi and iold; for the rhs and residual fields that of the terms they
    are sums of (max|rhs| + 2 sum(idr2) max|phi|)."""
    for lvl in rs.levels:
        a = np.asarray(rst["cc"][lvl])
        got = port_cc(pst, lvl)
        near(got[IPHI], a[IPHI], k=256, what=f"{what} lvl {lvl} phi")
        # iold holds an earlier phi (on an idle level, minus the mean
        # removals of the cycles below): phi's scale
        err = np.abs(got[IOLD] - a[IOLD]).max()
        assert err <= 256 * EPS * max(np.abs(a[IPHI]).max(),
                                      np.abs(a[IOLD]).max()), (what, lvl)
        # a coarse rhs is A(phi_c) + restricted residual (FAS), and the
        # residual field rhs - A(phi): both cancelled sums of terms of
        # this size
        scale = (np.abs(a[IRHS]).max() + 2 * sum(rs.static[lvl]["idr2"])
                 * np.abs(a[IPHI]).max())
        for iv in (IRHS, IRES):
            err = np.abs(got[iv] - a[iv]).max()
            assert err <= 256 * EPS * scale, f"{what} lvl {lvl} iv {iv}"
    np.testing.assert_allclose(float(res_p), float(res_r), rtol=1e-10)


@pytest.mark.parametrize("kind", [
    "sparse_periodic",
    pytest.param("amr2", marks=pytest.mark.slow),
    pytest.param("amr1", marks=pytest.mark.slow)])
def test_vcycle_matches_reference(kind):
    rs, ps = cycle_pair(kind)
    rst, pst = seeded(rs, ps)
    rst, rr = rs.fas_vcycle(rst)
    pst, pr = ps.fas_vcycle(pst)
    compare_states(rs, rst, pst, rr, pr, f"{kind} V-cycle")
    assert ps.subtract_mean == (kind == "sparse_periodic")


@pytest.mark.parametrize("kind", [
    "amr1",
    pytest.param("sparse_periodic", marks=pytest.mark.slow),
    pytest.param("amr2", marks=pytest.mark.slow)])
def test_fmg_matches_reference(kind):
    rs, ps = cycle_pair(kind)
    rst, pst = seeded(rs, ps)
    rst, rr = rs.fas_fmg(rst)
    pst, pr = ps.fas_fmg(pst)
    compare_states(rs, rst, pst, rr, pr, f"{kind} FMG")


def coarse_solves_counted(ps):
    """Wrap ``ps._coarse_solve`` to record each call's host reads (its
    iterations + 1)."""
    reads = []
    inner = ps._coarse_solve

    def counted(*args):
        before = ps.coarse_host_reads
        out = inner(*args)
        reads.append(ps.coarse_host_reads - before)
        return out
    ps._coarse_solve = counted
    return reads


def cast(rst, dtype):
    return {"cc": {l: a.astype(dtype) for l, a in rst["cc"].items()},
            "bc": {l: [p.astype(dtype) for p in b]
                   for l, b in rst["bc"].items()}}


@pytest.mark.slow
def test_float32_periodic_solve_stalls_in_both_packages():
    """Why chip_smoke.py's boxed_path checks convergence in float64.  In
    float32 the reference's coarse rule (residual 1e-8 of its start, at
    most ``max_coarse_cycles`` iterations) is out of reach on the fully
    periodic sparse tree: the coarse loop runs to its cap in every FMG,
    in both packages (the JAX package's first FMG changes when the cap
    moves from 1000 to 1001), and eight FMGs' residuals rise as well as
    fall in both.  In float64 the same problem falls monotonically,
    ~14x per FMG, and no coarse solve reaches the cap."""
    n_fmg = 8
    out = {}
    for dt_r, dt_p in ((jnp.float32, torch.float32),
                       (jnp.float64, torch.float64)):
        rs = ref.MGSolver(build("sparse_periodic", ref, rtm),
                          ref.MGConfig(dtype=dt_r))
        ps = port.MGSolver(build("sparse_periodic", port, ptm),
                           port.MGConfig(device="cpu", dtype=dt_p))
        rst, pst = seeded(rs, ps)       # the port's in its own dtype
        rst = cast(rst, dt_r)
        reads = coarse_solves_counted(ps)
        hr, hp, per_fmg = [], [], []
        for k in range(n_fmg):
            rst, r = rs.fas_fmg(rst, have_guess=k > 0)
            hr.append(float(r))
            n0 = len(reads)
            pst, r = ps.fas_fmg(pst, have_guess=k > 0)
            hp.append(float(r))
            per_fmg.append(reads[n0:])
        out[dt_p] = (rs, hr, hp, per_fmg)

    cap = port.MGConfig().max_coarse_cycles
    rs, hr, hp, per_fmg = out[torch.float32]
    assert all(cap + 1 in r for r in per_fmg), per_fmg
    for h in (hr, hp):
        assert all(np.isfinite(h))
        assert any(b > a for a, b in zip(h, h[1:])), h
    # the reference's loop runs to its cap too: one more allowed
    # iteration changes its first FMG
    rs1 = ref.MGSolver(build("sparse_periodic", ref, rtm),
                       ref.MGConfig(dtype=jnp.float32,
                                    max_coarse_cycles=cap + 1))
    rst1, _ = seeded(rs1, port.MGSolver(build("sparse_periodic", port, ptm),
                                        port.MGConfig(device="cpu")))
    assert float(rs1.fas_fmg(cast(rst1, jnp.float32))[1]) != hr[0]

    rs, hr, hp, per_fmg = out[torch.float64]
    assert max(max(r) for r in per_fmg) < cap + 1, per_fmg
    for h in (hr, hp):
        assert all(b < a / 10 for a, b in zip(h, h[1:])), h


def test_poisson_solver_on_the_sparse_periodic_tree():
    """PoissonSolver(tree=...) through make_solver to the boxed solver:
    per-box planes, the residual falls ~10x per FMG, phi's mean over the
    leaves stays zero."""
    t = build("sparse_periodic", port, ptm)
    ps = port.PoissonSolver(3, (16,) * 3, 4, tree=t, periodic=True,
                            device="cpu")
    sv = ps.solver
    assert type(sv) is port.MGSolver and not ps.dense
    rng = np.random.default_rng(4)
    ps.set_rhs(arrays={l: rng.normal(size=(len(t.lvls[l].ids), 4, 4, 4))
                       for l in (1, 2)})
    phi, info = ps.solve(rtol=0.0, max_cycles=4)
    top = sv.levels[-1]
    assert tuple(phi.shape) == (len(t.lvls[top].ids), 6, 6, 6)
    np.testing.assert_array_equal(ps.phi(), phi.numpy())
    hist = info["residuals"]
    assert all(b < 0.2 * a for a, b in zip(hist, hist[1:])), hist
    assert sv.coarse_host_reads > 4 * len(sv.levels)
    with pytest.raises(ValueError, match="dense fast path"):
        ps.solve_refined(np.zeros(1))


def test_state_round_trip_and_shape_checks():
    _, ps, np_state = make_pair("amr2", bcs=False)
    st = convert.state_from_numpy(ps, np_state)
    back = convert.state_to_numpy(st)
    for lvl in ps.levels:
        np.testing.assert_array_equal(back["cc"][lvl], np_state["cc"][lvl])
        for a, b in zip(back["bc"][lvl], np_state["bc"][lvl]):
            np.testing.assert_array_equal(a, b)
    bad = {"cc": dict(np_state["cc"]), "bc": np_state["bc"]}
    lvl = ps.levels[-1]
    bad["cc"][lvl] = bad["cc"][lvl][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        convert.state_from_numpy(ps, bad)


def test_what_is_not_ported_raises():
    t = build("amr2", port, ptm)
    cfg = port.MGConfig(device="cpu")
    with pytest.raises(NotImplementedError, match="measured-negative"):
        port.MGExperimental(gathered_smoother=True)
    with pytest.raises(NotImplementedError, match="A11"):
        port.MGSolver(t, port.MGConfig(device="cpu", fmg_mode="fused"))
    with pytest.raises(NotImplementedError, match="A13"):
        port.MGSolver(t, port.MGConfig(device="cpu", halo="ppermute"))
    sv = port.MGSolver(t, cfg)
    with pytest.raises(NotImplementedError, match="A13"):
        sv.attach_mesh(None)
    st = sv.allocate()
    lvl = sv.levels[-1]
    with pytest.raises(NotImplementedError, match="A13"):
        pghost.fill_ghost_lvl(st["cc"][lvl], None, sv._to_device()[lvl],
                              sv.static[lvl], sv._bc_static(IPHI, lvl), None,
                              IPHI, ext_gathered=[])


# ---------------------------------------------------------------------------
# make_solver routing against the JAX package's
# ---------------------------------------------------------------------------

ROUTES = {
    "uniform3": dict(),
    "L": dict(), "two": dict(), "periodic": dict(),
    "sparse": dict(), "sparse_periodic": dict(),
    "uniform3_jacobi": dict(smoother="jacobi"),
    "amr1": dict(),
    "uniform2": dict(),
    "uniform2_jacobi": dict(smoother="jacobi"),
    "cyl2_helmholtz": dict(geometry="cylindrical", operator="helmholtz"),
}
#: the rectangular AMR patch tree with each of the five operators (the
#: dense-patch AMR solver in both packages)
ROUTES.update({f"amr3_{op}": dict(operator=op) for op in (
    "laplacian", "helmholtz", "vlaplacian", "vhelmholtz", "ahelmholtz")})
#: the three forests with each variable-coefficient operator (the dense
#: forest in both packages)
ROUTES.update({f"{kind}_{op}": dict(operator=op)
               for kind in ("L", "two", "periodic")
               for op in ("vlaplacian", "vhelmholtz", "ahelmholtz")})
#: the sparse trees of tests/test_dense_multiforest.py and "sparse" with
#: the other operators and the Jacobi smoother (the multi-canvas forest
#: in both packages, the boxed solver for Jacobi)
ROUTES.update({kind: dict() for kind in ("eight", "mixed", "threelvl")})
ROUTES.update({f"sparse_{op}": dict(operator=op) for op in (
    "helmholtz", "vlaplacian", "vhelmholtz", "ahelmholtz")})
ROUTES["sparse_jacobi"] = dict(smoother="jacobi")
#: 2D: the uniform tree with each operator and the cylindrical laplacian
#: (the dense 2D solver), the 3-level centred AMR tree likewise (the 2D
#: dense-patch AMR solver), its periodic form and an L forest (the JAX
#: package's 2D dense forest), a sparse tree (its 2D multi-canvas forest),
#: and what goes to the boxed solver: the periodic sparse tree, Jacobi
ROUTES.update({f"uniform2_{op}": dict(operator=op) for op in (
    "helmholtz", "vlaplacian", "vhelmholtz", "ahelmholtz")})
ROUTES["cyl2_laplacian"] = dict(geometry="cylindrical")
ROUTES.update({f"amr2c_{op}": dict(operator=op) for op in (
    "laplacian", "helmholtz", "vlaplacian", "vhelmholtz", "ahelmholtz")})
ROUTES["amr2c_cyl"] = dict(geometry="cylindrical")
ROUTES["amr2c_jacobi"] = dict(smoother="jacobi")
ROUTES["amr2p"] = dict()
ROUTES.update({"L2": dict(), "L2_cyl": dict(geometry="cylindrical"),
               "L2_vhelmholtz": dict(operator="vhelmholtz"),
               "sparse2": dict(), "sparse2_ahelmholtz": dict(
                   operator="ahelmholtz"),
               "sparse2p": dict(), "sparse2_jacobi": dict(smoother="jacobi")})


def forest_tree_2d(pkg, tm, kind, base=16, box=4):
    """2D trees for the routing cases: "L2" (level 2 over an L of three
    quarters of the domain, level 3 over its corner), "sparse2" /
    "sparse2p" (two corner patches of a quarter of the extent, closed or
    fully periodic), "amr2p" (the centred 3-level AMR tree, periodic)."""
    if kind == "amr2p":
        return pkg.build_amr_centered(2, 3, np.full(2, base), box,
                                      np.full(2, 1.0 / base),
                                      periodic=[True] * 2)
    nb = base // box
    h, q = (nb + 1) // 2, nb // 4
    t = pkg.build_rectangle(2, np.full(2, base), box, np.full(2, 1.0 / base),
                            np.zeros(2), periodic=[kind == "sparse2p"] * 2)

    def refine(lvl, pred):
        ids = t.lvls[lvl].ids
        pick = [int(b) for b in ids if pred(t.ix[int(b)])]
        tm.add_children_bulk(t, np.array(pick, np.int64))
        tm.set_leaves_parents(t, lvl)
        tm.set_next_level_ids(t, lvl)
        tm.set_neighbors_lvl(t, lvl + 1)

    if kind == "L2":
        refine(1, lambda ix: ix[0] <= h or ix[1] <= h)
        refine(2, lambda ix: np.all(ix <= h))
        tm.finalize_amr(t, 3)
        return t
    refine(1, lambda ix: np.all(ix <= q) or np.all(ix > nb - q))
    tm.finalize_amr(t, 2)
    return t


def route_tree(name, pkg, tm):
    base = name.split("_")[0] if name != "sparse_periodic" else name
    if base == "uniform2":
        return pkg.build_rectangle(2, np.full(2, 16), 4, np.full(2, 1 / 16),
                                   np.zeros(2))
    if base == "cyl2":
        return build("cyl2", pkg, tm)
    if base in ("uniform3", "amr1", "amr3"):
        return build(base, pkg, tm)
    if base == "amr2c":
        return pkg.build_amr_centered(2, 3, np.full(2, 16), 4,
                                      np.full(2, 1 / 16))
    if base in ("L2", "sparse2", "sparse2p", "amr2p"):
        return forest_tree_2d(pkg, tm, base)
    if base in ("eight", "mixed", "threelvl"):
        from test_torch_multiforest import sparse_tree
        return sparse_tree(pkg, tm, base)
    return forest_tree(pkg, tm, base, 16, 4)


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_make_solver_routes_as_the_reference(name):
    """The class the JAX package's make_solver picks, or a raise naming a
    ROADMAP item where that class is not ported yet; never the boxed
    solver where the reference picks another."""
    kw = ROUTES[name]
    want = type(ref_make_solver(route_tree(name, ref, rtm),
                                ref.MGConfig(**kw))).__name__
    ported = ("DenseMGSolver", "DenseAMRMGSolver", "DenseForestMGSolver",
              "DenseMultiForestMGSolver", "MGSolver", "Dense2DMGSolver",
              "Dense2DAMRMGSolver")
    tree = route_tree(name, port, ptm)
    cfg = port.MGConfig(device="cpu", **kw)
    if want in ported:
        assert type(port.make_solver(tree, cfg)).__name__ == want
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP A10b"):
            port.make_solver(tree, cfg)
    if name in ("sparse_periodic", "amr1", "uniform3_jacobi",
                "uniform2_jacobi", "cyl2_helmholtz"):
        assert want == "MGSolver"
    if name in ("sparse", "eight", "mixed", "threelvl") or (
            name.startswith("sparse_") and name not in (
                "sparse_periodic", "sparse_jacobi")):
        assert want == "DenseMultiForestMGSolver"
    if name == "sparse_jacobi":
        assert want == "MGSolver"
    if name.startswith("amr3_"):
        assert want == "DenseAMRMGSolver"
    if name.split("_")[0] in ("L", "two", "periodic"):
        assert want == "DenseForestMGSolver"
    if name.startswith("uniform2") and name != "uniform2_jacobi" or \
            name in ("uniform2", "cyl2_laplacian"):
        assert want == "Dense2DMGSolver"
    if name.startswith("amr2c_"):
        assert want == ("MGSolver" if name == "amr2c_jacobi"
                        else "Dense2DAMRMGSolver")
    if name in ("amr2p", "L2", "L2_cyl", "L2_vhelmholtz"):
        assert want == "DenseForest2DMGSolver"
    if name in ("sparse2", "sparse2_ahelmholtz"):
        assert want == "DenseMultiForest2DMGSolver"
    if name in ("sparse2p", "sparse2_jacobi"):
        assert want == "MGSolver"
