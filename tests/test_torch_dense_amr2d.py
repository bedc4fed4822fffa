"""The 2D dense-patch AMR solver (Dense2DAMRMGSolver) of the PyTorch
package against the JAX package's, and against the port's own boxed
solver, on the CPU.

Mirrors tests/test_dense_amr2d.py, the 2D cases of
tests/test_dense_amr_vcoeff.py and tests/test_amr_extra.py::
test_amr_vlaplacian_2d.  Trees, both packages alike:

* "centered": ``build_amr_centered(2, n, 16^2, 8)`` — level 1 16^2,
  level 2 the whole 32^2 domain, level 3 (n = 3) a 32^2 patch in the
  middle with four refinement faces, each inside its coarse patch;
* "mixed": level 1 32^2, level 2 the patch x < 48 of the 64^2 domain,
  level 3 the patch x < 32, y >= 64 of the 128^2 domain: refinement
  faces on the high x side (inside its coarse patch) and, at level 3,
  on the low y side; the other faces flush with the domain (so a
  footprint region is flush with its coarse patch face, and a strip
  reaches the coarse ring at a domain-flush transverse edge).

Fields are made with numpy from a seed on the port's boxed solver
(ghosts filled), and the patch interiors of both dense solvers are
assembled from its boxes.  Bounds, float64: each phase bitwise against
the JAX package's eager phase (its restriction's 0/1 matmuls and the
port's strided pair sums agree in value, compared with
``np.array_equal``); smoothing and the residual bitwise against the
port's boxed solver, as the JAX tests hold theirs; the coarse update and
the correction within the JAX tests' 5e-14 / 1e-14 of the boxed solver,
whole cycles within their 5e-13.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octree_mg_tpu as ref
import octree_mg_tpu.core.tree as rtm
from octree_mg_tpu.models import PoissonSolver as RefPoissonSolver

import octree_mg_tpu_torch as port
import octree_mg_tpu_torch.core.tree as ptm
from octree_mg_tpu_torch import convert
from octree_mg_tpu_torch.core.constants import IOLD, IPHI, IRES, IRHS, IVEPS
from octree_mg_tpu_torch.ops import dense_kernels as pdk
from octree_mg_tpu_torch.solve.dense_amr import RB_COEFFS

torch.set_num_threads(1)

N_EPS = {"laplacian": 0, "helmholtz": 0, "vlaplacian": 1, "vhelmholtz": 1,
         "ahelmholtz": 2}


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


def _refine(tm, t, lvl, pred):
    ids = t.lvls[lvl].ids
    pick = [int(b) for b in ids if pred(t.ix[int(b)])]
    tm.add_children_bulk(t, np.array(pick, np.int64))
    tm.set_leaves_parents(t, lvl)
    tm.set_next_level_ids(t, lvl)
    tm.set_neighbors_lvl(t, lvl + 1)


def build(pkg, tm, kind, n_levels=3):
    if kind == "centered":
        return pkg.build_amr_centered(2, n_levels, np.full(2, 16), 8,
                                      np.full(2, 1.0 / 16))
    t = pkg.build_rectangle(2, np.full(2, 32), 8, np.full(2, 1.0 / 32),
                            np.zeros(2))
    _refine(tm, t, 1, lambda ix: ix[0] <= 3)
    _refine(tm, t, 2, lambda ix: ix[0] <= 4 and ix[1] >= 5)
    tm.finalize_amr(t, 3)
    return t


def boxed_to_patch(sb, sd, st_b, lvl, iv):
    """The dense patch interior [Y, X] assembled from a boxed level."""
    t = sb.tree
    nc = t.box_size_lvl[lvl]
    X, Y = sd.dims[lvl]
    off = sd.offsets[lvl] // nc
    out = np.zeros((Y, X))
    arr = st_b["cc"][lvl][iv].numpy()
    for loc, b in enumerate(t.lvls[lvl].ids):
        ix = t.ix[b] - 1 - off
        sl = tuple(slice(ix[d] * nc, (ix[d] + 1) * nc) for d in (1, 0))
        out[sl] = arr[loc][(slice(1, -1),) * 2]
    return out


def setup(operator="laplacian", kind="centered", n_levels=3,
          coarse="smooth", seed=3, geometry="cartesian"):
    """(port boxed solver, its state, port 2D AMR solver, its state, JAX
    2D AMR solver, its state): random phi/rhs (eps 0.5 + U[0, 1)) on
    every level, Dirichlet faces from ``solution``."""
    tp, tr = build(port, ptm, kind, n_levels), build(ref, rtm, kind,
                                                     n_levels)
    kw = dict(operator=operator, smoother="gsrb", geometry=geometry)
    sb = port.MGSolver(tp, port.MGConfig(device="cpu", **kw))
    sd = port.Dense2DAMRMGSolver(tp, port.MGConfig(
        device="cpu", coarse_solver=coarse, **kw))
    rd = ref.Dense2DAMRMGSolver(tr, ref.MGConfig(coarse_solver=coarse, **kw))
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
            vals = boxed_to_patch(sb, sd, st_b, lvl, iv)
            st_d = sd.set_interior(st_d, lvl, k, vals)
            st_r = rd.set_interior(st_r, lvl, k, jnp.asarray(vals))
    return sb, st_b, sd, st_d, rd, st_r


def interior(sv, st, lvl, key):
    return np.asarray(sv.interior(st, lvl, key))


# ---------------------------------------------------------------------------
# geometry, gate, configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,n_levels", [("centered", 2),
                                           ("centered", 3), ("mixed", 3)])
def test_geometry_and_gating(kind, n_levels):
    """Patch geometry, face kinds, levels, configs, boundary vectors and
    cell centres are the JAX package's; make_solver sends the tree here
    for the five operators and the cylindrical laplacian, as the JAX
    package does; uniform and periodic trees go elsewhere."""
    tp, tr = build(port, ptm, kind, n_levels), build(ref, rtm, kind,
                                                     n_levels)
    for kw in [dict(operator=op) for op in N_EPS] + [
            dict(geometry="cylindrical")]:
        sv = port.make_solver(tp, port.MGConfig(device="cpu", **kw))
        rv = ref.make_solver(tr, ref.MGConfig(**kw))
        assert type(sv).__name__ == type(rv).__name__ == "Dense2DAMRMGSolver"
        assert sv.levels == rv.levels and sv.dims == rv.dims
        assert sv.face_kind == rv.face_kind
        st_d, st_r = sv.allocate(), rv.allocate()
        for lvl in sv.levels:
            assert tuple(sv.offsets[lvl]) == tuple(rv.offsets[lvl])
            if lvl in rv.regions:
                for a, b in zip(sv.regions[lvl], rv.regions[lvl]):
                    assert tuple(a) == tuple(b)
            assert sv._whole_region(lvl) == rv._whole_region(lvl)
            pc, rc = sv._kcfgs[lvl], rv._kcfgs[lvl]
            assert pc.bc == [tuple(float(c) for c in t) for t in rc.bc]
            assert pc.b_const == rc.b_const
            assert pc.eps_bc == (None if rc.eps_bc is None else
                                 [tuple(t) for t in rc.eps_bc])
            if rc.cyl_w is not None:
                for a, b in zip(pc.cyl_w, rc.cyl_w):
                    assert np.array_equal(a.numpy(), b)
            assert np.array_equal(sv.cell_centers(lvl),
                                  rv.cell_centers(lvl))
            for a, b in zip(st_d["bc"][lvl], st_r["bc"][lvl]):
                assert np.array_equal(a.numpy(), np.asarray(b))
    sv = port.make_solver(tp, port.MGConfig(device="cpu"))
    top = sv.levels[-1]
    if kind == "centered" and n_levels == 3:
        assert sv._whole_region(2) and not sv._whole_region(3)
        assert sv.face_kind[3] == ["rb"] * 4
        assert sv._kcfgs[3].bc == [RB_COEFFS] * 4
    if kind == "mixed":
        assert sv.face_kind[top] == ["phys", "rb", "rb", "phys"]
        assert sv.face_kind[top - 1] == ["phys", "rb", "phys", "phys"]
    ut = port.build_rectangle(2, np.full(2, 16), 8, np.full(2, 1.0 / 16),
                              np.zeros(2))
    assert not port.dense_amr2d_supported(ut, port.MGConfig())
    pt = port.build_amr_centered(2, 2, np.full(2, 16), 8,
                                 np.full(2, 1.0 / 16), periodic=[True] * 2)
    assert not port.dense_amr2d_supported(pt, port.MGConfig())
    assert not port.dense_amr2d_supported(tp, port.MGConfig(
        operator="vlaplacian", geometry="cylindrical"))


@pytest.mark.parametrize("kind", ["centered", "mixed"])
def test_refinement_face_vectors(kind):
    """The refinement-face vectors of phi and of each coefficient field
    on every level (coarse strip with its synthesized ring, the 2D
    interpolation): bitwise the JAX package's, on faces inside the coarse
    patch, on low and high sides, and next to domain-flush faces."""
    _, _, sd, st_d, rd, st_r = setup("ahelmholtz", kind=kind)
    for lvl in sd.levels:
        for key in ("phi",) + sd._eps_keys:
            got = sd._planes(st_d, lvl, key)
            want = rd._planes(st_r, lvl, key)
            for nb in range(4):
                assert np.array_equal(got[nb].numpy(), np.asarray(want[nb])), \
                    (lvl, key, nb)
        epl = sd._eps_planes(st_d, lvl)
        assert (epl is None) == ("rb" not in sd.face_kind[lvl])


def test_var_with_ring_window_is_the_whole_ring():
    """A window of the ringed coarse patch equals that window of the
    whole ring (the JAX package builds the whole one)."""
    _, _, sd, st_d, _, _ = setup("laplacian", kind="mixed")
    for lvl in [l for l in sd.levels if min(sd.dims[l]) >= 8]:
        whole = sd._var_with_ring(st_d, lvl, "phi")
        Y, X = whole.shape
        for lo, hi in (((0, 3), (1, X - 2)), ((Y - 1, 0), (Y, X)),
                       ((2, 0), (Y - 3, 1)), ((0, 0), (Y, X))):
            part = sd._var_with_ring(st_d, lvl, "phi", lo, hi)
            assert torch.equal(part, whole[lo[0]:hi[0], lo[1]:hi[1]])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("operator,kind,lvl_kind", [
    ("laplacian", "centered", "top"), ("laplacian", "centered", "mid"),
    ("laplacian", "mixed", "top"), ("laplacian", "mixed", "mid"),
    ("helmholtz", "mixed", "top"), ("vlaplacian", "centered", "top"),
    ("ahelmholtz", "mixed", "top")])
def test_smooth_bitwise(operator, kind, lvl_kind):
    """Patch smoothing with its refinement-face ghosts (coefficient
    ghosts included) bitwise the JAX package's eager phase and the port's
    boxed smooth_boxes."""
    sb, st_b, sd, st_d, rd, st_r = setup(operator, kind=kind)
    lam = 0.4 if operator.endswith("helmholtz") else 0.0
    lvl = sd.levels[-1] if lvl_kind == "top" else sd.levels[-1] - 1
    st_d = sd._smooth(st_d, lvl, 2, sd._lam(lam))
    st_r = rd._smooth(st_r, lvl, 2, rd._lam(lam))
    st_b = sb._smooth_boxes(st_b, sb._to_device(), lvl, 2, lam)
    got = interior(sd, st_d, lvl, "phi")
    assert np.array_equal(got, interior(rd, st_r, lvl, "phi"))
    assert np.array_equal(got, boxed_to_patch(sb, sd, st_b, lvl, IPHI))


@pytest.mark.parametrize("operator,kind", [("helmholtz", "centered"),
                                           ("vhelmholtz", "mixed")])
def test_residual_bitwise(operator, kind):
    sb, st_b, sd, st_d, rd, st_r = setup(operator, kind=kind)
    lam, top = 0.7, sd.levels[-1]
    st_d = sd._residual(st_d, top, sd._lam(lam))
    st_r = rd._residual(st_r, top, rd._lam(lam))
    st_b = sb._residual_lvl(st_b, sb._to_device(), top, lam)
    got = interior(sd, st_d, top, "ires")
    assert np.array_equal(got, interior(rd, st_r, top, "ires"))
    assert np.array_equal(got, boxed_to_patch(sb, sd, st_b, top, IRES))


@pytest.mark.parametrize("kind", ["centered", "mixed"])
def test_update_coarse(kind):
    """The FAS transfer on the footprint region: phi, the tau-corrected
    rhs and iold of the coarse patch, bitwise the JAX package's; within
    the JAX test's 5e-14 of the boxed solver (iold on the region: the
    boxed solver keeps it on parent boxes only)."""
    sb, st_b, sd, st_d, rd, st_r = setup("laplacian", kind=kind)
    top = sd.levels[-1]
    st_d = sd._update_coarse(st_d, top, 0.0)
    st_r = rd._update_coarse(st_r, top, rd._lam(0.0))
    st_b = sb._update_coarse(st_b, sb._to_device(), top, 0.0)
    r0, r1 = sd.regions[top]
    reg = tuple(slice(int(r0[d]), int(r1[d])) for d in (1, 0))
    for key, iv in (("phi", IPHI), ("rhs", IRHS), ("iold", IOLD)):
        got = interior(sd, st_d, top - 1, key)
        assert np.array_equal(got, interior(rd, st_r, top - 1, key)), key
        want = boxed_to_patch(sb, sd, st_b, top - 1, iv)
        if key == "iold":
            got, want = got[reg], want[reg]
        rel_near(got, want, 5e-14, f"{key} vs boxed")


@pytest.mark.parametrize("kind", ["centered", "mixed"])
def test_correct_children(kind):
    """The up-leg correction from the region and its one-cell ring (the
    coarse neighbours inside, the physical synthesis difference where the
    region is flush with the coarse patch): bitwise the JAX package's,
    within the JAX test's 1e-14 of the boxed solver."""
    sb, st_b, sd, st_d, rd, st_r = setup("laplacian", kind=kind, seed=11)
    top = sd.levels[-1]
    lvl_c = top - 1
    rng = np.random.default_rng(4)
    nb, nc = sb.static[lvl_c]["n_boxes"], sb.static[lvl_c]["nc"]
    isl = (slice(None),) + (slice(1, -1),) * 2
    st_b["cc"][lvl_c][(IOLD,) + isl] = torch.as_tensor(
        rng.normal(size=(nb, nc, nc)))
    st_b = sb.fill_ghost(st_b, IOLD)
    iold = boxed_to_patch(sb, sd, st_b, lvl_c, IOLD)
    st_d = sd.set_interior(st_d, lvl_c, "iold", iold)
    st_r = rd.set_interior(st_r, lvl_c, "iold", jnp.asarray(iold))
    before = pdk.launch_counts()
    st_d = sd._correct_children(st_d, lvl_c, 0.0)
    assert pdk.launch_counts() == before
    st_r = rd._correct_children(st_r, lvl_c, rd._lam(0.0))
    st_b = sb._correct_children(st_b, sb._to_device(), lvl_c)
    got = interior(sd, st_d, top, "phi")
    assert np.array_equal(got, interior(rd, st_r, top, "phi"))
    rel_near(got, boxed_to_patch(sb, sd, st_b, top, IPHI), 1e-14,
             "correction vs boxed")


def test_prepare_coefficient_restricts_into_regions():
    """prepare_coefficient restricts each coefficient into the footprint
    regions only, bitwise the JAX package's, keeping the fields'
    identity."""
    _, _, sd, st_d, rd, st_r = setup("ahelmholtz", kind="mixed")
    ids = {(k, lvl): st_d[k][lvl] for k in sd._eps_keys for lvl in sd.levels}
    st_d = sd.prepare_coefficient(st_d)
    st_r = rd.prepare_coefficient(st_r)
    for (k, lvl), t in ids.items():
        assert st_d[k][lvl] is t
        assert np.array_equal(interior(sd, st_d, lvl, k),
                              interior(rd, st_r, lvl, k)), (k, lvl)


@pytest.mark.parametrize("operator,kind,n_levels", [
    ("laplacian", "centered", 2), ("laplacian", "centered", 3),
    ("laplacian", "mixed", 3), ("vlaplacian", "centered", 3),
    ("vhelmholtz", "mixed", 3), ("ahelmholtz", "centered", 3)])
def test_vcycle_matches_boxed_solver(operator, kind, n_levels):
    """One V-cycle (smoothed coarse solve) within the JAX tests' 5e-13 of
    the boxed solver on every level; no kernel counter moves."""
    sb, st_b, sd, st_d, _, _ = setup(operator, kind=kind, n_levels=n_levels)
    lam = 0.4 if operator.endswith("helmholtz") else 0.0
    before = pdk.launch_counts()
    st_d, res_d = sd.fas_vcycle(st_d, lam=lam)
    assert pdk.launch_counts() == before
    st_b, res_b = sb.fas_vcycle(st_b, lam=lam)
    for lvl in sd.levels:
        rel_near(interior(sd, st_d, lvl, "phi"),
                 boxed_to_patch(sb, sd, st_b, lvl, IPHI), 5e-13, f"lvl {lvl}")
    assert abs(float(res_b) - float(res_d)) <= 1e-11 * max(
        1.0, abs(float(res_b)))


def test_cylindrical_smooth_and_vcycle():
    """Offset-aware radial weights: smoothing bitwise the boxed
    solver's and the JAX package's, a V-cycle within 5e-13 of the boxed
    solver's."""
    sb, st_b, sd, st_d, rd, st_r = setup("laplacian", geometry="cylindrical")
    top = sd.levels[-1]
    st_d1 = sd._smooth({k: dict(v) for k, v in st_d.items()}, top, 1, 0.0)
    st_r1 = rd._smooth(st_r, top, 1, rd._lam(0.0))
    st_b1 = sb._smooth_boxes({"cc": {l: v.clone() for l, v in
                                     st_b["cc"].items()},
                              "bc": st_b["bc"]}, sb._to_device(), top, 1, 0.0)
    got = interior(sd, st_d1, top, "phi")
    assert np.array_equal(got, interior(rd, st_r1, top, "phi"))
    assert np.array_equal(got, boxed_to_patch(sb, sd, st_b1, top, IPHI))
    st_d, _ = sd.fas_vcycle(st_d)
    st_b, _ = sb.fas_vcycle(st_b)
    for lvl in sd.levels:
        rel_near(interior(sd, st_d, lvl, "phi"),
                 boxed_to_patch(sb, sd, st_b, lvl, IPHI), 5e-13, f"lvl {lvl}")


@pytest.mark.parametrize("kind", ["centered", "mixed"])
def test_fmg_matches_reference_and_boxed(kind):
    """A zero-guess FMG (smoothed coarse solve) within 5e-13 of the boxed
    solver's, and with the direct coarse solve within 5e-13 of the JAX
    package's eager FMG."""
    sb, st_b, sd, st_d, _, _ = setup("laplacian", kind=kind, seed=8)
    st_b, res_b = sb.fas_fmg(st_b)
    st_d, res_d = sd.fas_fmg(st_d)
    top = sd.levels[-1]
    rel_near(interior(sd, st_d, top, "phi"),
             boxed_to_patch(sb, sd, st_b, top, IPHI), 5e-13, "FMG vs boxed")
    assert abs(float(res_b) - float(res_d)) <= 1e-11 * max(
        1.0, abs(float(res_b)))
    _, _, sd, st_d, rd, st_r = setup("vhelmholtz", kind=kind, seed=8,
                                     coarse="direct")
    st_d, res_d = sd.fas_fmg(st_d, lam=0.4)
    rd._ensure_direct(st_r)
    st_r, res_r = rd._fmg(st_r, rd._lam(0.4), False, True)
    for lvl in sd.levels:
        rel_near(interior(sd, st_d, lvl, "phi"),
                 interior(rd, st_r, lvl, "phi"), 5e-13, f"lvl {lvl}")
    assert abs(float(res_d) - float(res_r)) <= 5e-13 * abs(float(res_r))


# ---------------------------------------------------------------------------
# convergence
# ---------------------------------------------------------------------------

def test_manufactured_convergence():
    """FMG + V-cycles drive the top-level error to the discretization
    level on a 3-level quadtree (test_refinement.f90 semantics)."""
    tree = port.build_amr_centered(2, 3, np.full(2, 32), 8,
                                   np.full(2, 1.0 / 32))
    sd = port.make_solver(tree, port.MGConfig(device="cpu"))
    assert isinstance(sd, port.Dense2DAMRMGSolver)
    sd.set_bc(0, port.BCType.DIRICHLET, fn=solution)
    st = sd.allocate()
    for lvl in sd.levels:
        sd.set_interior(st, lvl, "phi", solution(sd.cell_centers(lvl)))
    for lvl in reversed(sd.levels[1:]):
        st = sd._restrict_into(st, lvl, "phi")
    rhs_all = {lvl: sd._apply_op(st, lvl, 0.0) for lvl in sd.levels}
    for lvl in sd.levels:
        sd.set_interior(st, lvl, "rhs", rhs_all[lvl])
        sd.set_interior(st, lvl, "phi", np.zeros(sd._ishape(lvl)))
    st, _ = sd.fas_fmg(st)
    for _ in range(6):
        st, _ = sd.fas_vcycle(st)
    top = sd.levels[-1]
    err = np.abs(interior(sd, st, top, "phi")
                 - solution(sd.cell_centers(top))).max()
    assert err < 1e-8, f"top-level error {err}"


def _u(x):
    return np.sin(2 * np.pi * x[..., 0]) * np.sin(2 * np.pi * x[..., 1])


def _eps(x):
    return 1.0 + 0.5 * np.cos(2 * np.pi * x[..., 0])


def _rhs(x):
    tp = 2 * np.pi
    sx, cx = np.sin(tp * x[..., 0]), np.cos(tp * x[..., 0])
    sy = np.sin(tp * x[..., 1])
    return -0.5 * tp * sx * tp * cx * sy + _eps(x) * (-2 * tp ** 2 * sx * sy)


@pytest.mark.parametrize("size", [16, 32])
def test_vlaplacian_amr_convergence(size):
    """Two FMGs reach second-order discretization error on a 2D AMR tree
    (tests/test_dense_amr_vcoeff.py's bound, 25 h^2)."""
    tree = port.build_amr_centered(2, 2, np.full(2, size), 8,
                                   np.full(2, 1.0 / size))
    sd = port.make_solver(tree, port.MGConfig(
        operator="vlaplacian", coarse_solver="smooth", device="cpu"))
    assert isinstance(sd, port.Dense2DAMRMGSolver)
    sd.set_bc(0, port.BCType.DIRICHLET, fn=_u)
    st = sd.allocate()
    for lvl in sd.levels:
        cc = sd.cell_centers(lvl)
        sd.set_interior(st, lvl, "rhs", _rhs(cc))
        sd.set_coefficient(st, _eps(cc), lvl=lvl)
    st = sd.prepare_coefficient(st)
    st, _ = sd.fas_fmg(st)
    st, _ = sd.fas_fmg(st, have_guess=True)
    top = sd.levels[-1]
    err = np.abs(interior(sd, st, top, "phi")
                 - _u(sd.cell_centers(top))).max()
    h = 1.0 / (2 * size)
    assert err <= 25.0 * h ** 2, f"size {size}: err {err}"


def test_amr_vlaplacian_2d_discrete():
    """tests/test_amr_extra.py::test_amr_vlaplacian_2d on the solver
    make_solver picks: eps 1 + x/2 on every level, restricted down; a
    discrete rhs A(sol) with sol restricted down; ten FMGs take the
    residual below 1e-6 of the first and the leaf error below 1e-7."""
    tree = port.build_amr_centered(2, 2, [32, 32], 8, [1 / 32] * 2)
    sd = port.make_solver(tree, port.MGConfig(operator="vlaplacian",
                                              device="cpu"))
    assert isinstance(sd, port.Dense2DAMRMGSolver)

    def manufactured(x):
        return np.sin(2 * np.pi * x[..., 0]) * np.cos(np.pi * x[..., 1])

    sd.set_bc(0, port.BCType.DIRICHLET, fn=manufactured)
    st = sd.allocate()
    for lvl in sd.levels:
        x = sd.cell_centers(lvl)
        sd.set_coefficient(st, 1.0 + 0.5 * x[..., 0], lvl=lvl)
        sd.set_interior(st, lvl, "phi", manufactured(x))
    st = sd.prepare_coefficient(st)
    for lvl in reversed(sd.levels[1:]):
        st = sd._restrict_into(st, lvl, "phi")
    sols = {lvl: interior(sd, st, lvl, "phi").copy() for lvl in sd.levels}
    rhs_all = {lvl: sd._apply_op(st, lvl, 0.0) for lvl in sd.levels}
    for lvl in sd.levels:
        sd.set_interior(st, lvl, "rhs", rhs_all[lvl])
        sd.set_interior(st, lvl, "phi", np.zeros(sd._ishape(lvl)))
    residuals = []
    for i in range(10):
        st, res = sd.fas_fmg(st, have_guess=(i > 0))
        residuals.append(float(res))
    assert residuals[-1] < 1e-6 * max(residuals[0], 1.0), residuals
    err = 0.0
    for lvl in sd.levels:
        diff = interior(sd, st, lvl, "phi") - sols[lvl]
        if lvl + 1 in sd.regions:     # leaves: outside the fine footprint
            diff[sd._region(lvl + 1)] = 0.0
        err = max(err, float(np.abs(diff).max()))
    assert err < 1e-7, err


# ---------------------------------------------------------------------------
# state, refinement
# ---------------------------------------------------------------------------

def test_state_roundtrip():
    """A 2D AMR state (patches, four boundary vectors per level, zero
    placeholders on refinement faces) crosses both ways through
    convert."""
    _, _, sd, st_d, rd, st_r = setup("vlaplacian", kind="mixed")
    np_state = {k: {lvl: np.asarray(v) for lvl, v in per.items()}
                for k, per in st_r.items() if k != "bc"}
    np_state["bc"] = {lvl: [np.asarray(p) for p in ps]
                      for lvl, ps in st_r["bc"].items()}
    again = convert.state_from_numpy(sd, np_state)
    for k in sd._field_keys:
        for lvl in sd.levels:
            assert torch.equal(again[k][lvl], st_d[k][lvl])
    for lvl in sd.levels:
        for a, b in zip(again["bc"][lvl], st_d["bc"][lvl]):
            assert torch.equal(a, b)


def test_refined_solve_refuses_as_the_reference():
    """The JAX package's PoissonSolver.solve_refined on a 2D AMR tree
    builds RefinedPoisson2D, whose double-float gate fails on the top
    patch's refinement faces (AssertionError); the port's raises the same
    way.  A float64 solver is told to use float32 in both.  The port's
    solve_refined on the AMR solver (which the JAX package rebuilds as a
    2D forest) names ROADMAP A10b."""
    rhs = np.zeros((32, 32))
    for dtype, err in ((np.float32, AssertionError), (np.float64,
                                                      ValueError)):
        tp, tr = build(port, ptm, "centered"), build(ref, rtm, "centered")
        pp = port.PoissonSolver(2, (16, 16), 8, tree=tp, device="cpu",
                                dtype=(torch.float32 if dtype == np.float32
                                       else torch.float64))
        rp = RefPoissonSolver(2, (16, 16), 8, tree=tr,
                              dtype=(jnp.float32 if dtype == np.float32
                                     else jnp.float64))
        assert type(pp.solver).__name__ == type(rp.solver).__name__
        with pytest.raises(err) as want:
            rp.solve_refined(rhs)
        with pytest.raises(err) as got:
            pp.solve_refined(rhs)
        if dtype == np.float32:
            assert str(got.value) == str(want.value)
        else:
            assert "f32 inner solver" in str(got.value)
    with pytest.raises(NotImplementedError, match="A10b"):
        port.solve_refined(pp.solver, pp._ensure_state(), rhs, rhs)
