"""The dense-patch AMR solver (DenseAMRMGSolver) of the PyTorch package
against the JAX package's, and against the port's own boxed solver, on
the CPU.

Trees: ``build_amr_centered(3, n, 16, 8)`` — level 1 16^3, level 2 the
whole 32^3 domain, level 3 (n = 3) a 32^3 patch in the middle with six
refinement faces.  Fields are made with numpy from a seed on the port's
boxed solver (ghosts filled), and the patch interiors of both dense
solvers are assembled from its boxes, as the JAX package's own tests
(tests/test_dense_amr.py, test_dense_amr_vcoeff.py) assemble theirs.

Bounds, float64:

* each phase (smoothing with refinement faces, residual, the FAS coarse
  update on the footprint region, the region correction, the
  refinement-face planes, the plain route of ``eps_bc`` configs): ``64 *
  eps64 * max|reference|`` against the JAX package run eagerly — one IEEE
  sequence per cell in both, but the JAX package restricts with
  ``reduce_window`` (another summation order) where the port runs its
  restriction kernel's (z, y, x) order;
* against the port's boxed ``MGSolver``: bitwise for smoothing and the
  residual (the same arithmetic per cell in the same order, as the JAX
  tests assert for their pair), the JAX tests' bounds elsewhere;
* whole cycles: the JAX tests' ``5e-13 * max|reference|``, since
  restriction rounding differences of ~1 ulp per level grow through the
  cycle's smoothing and coarse solve.

In float32 the functions that round scalars of their own (the sides_rb
coefficients, the 0.125 interpolation gradients, lam in the working
dtype) are compared one by one against the JAX package's eager ops.

The whole cycles against the JAX package and the float32 comparisons
are ``slow`` (~80 s: the JAX package's eager ops compile one by one on
their first call); the rest takes ~15 s serially.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octree_mg_tpu as ref
from octree_mg_tpu.ops import dense_kernels as rdk

import octree_mg_tpu_torch as port
from octree_mg_tpu_torch import convert
from octree_mg_tpu_torch.core.constants import IOLD, IPHI, IRES, IRHS, IVEPS
from octree_mg_tpu_torch.ops import dense_kernels as pdk
from octree_mg_tpu_torch.solve.dense_amr import RB_COEFFS

torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps
N_EPS = {"laplacian": 0, "helmholtz": 0, "vlaplacian": 1, "vhelmholtz": 1,
         "ahelmholtz": 3}
OPERATORS = tuple(N_EPS)


def solution(x):
    out = 1.0
    for d in range(x.shape[-1]):
        out = out * np.sin(4 * np.pi * x[..., d])
    return out


def near(got, want, k=64, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max()
    assert err <= k * EPS * scale, f"{what}: {err} > {k} eps * {scale}"


def rel_near(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def boxed_to_patch(sb, sd, st_b, lvl, iv):
    """The dense patch interior [Z, Y, X] assembled from a boxed level."""
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


def lam_of(operator):
    return 0.0 if operator in ("laplacian", "vlaplacian") else 0.4


def setup(operator="laplacian", n_levels=3, coarse="smooth", seed=3,
          dtype=np.float64, bc_fn=solution):
    """(port boxed solver, its state, port dense AMR solver, its state,
    JAX dense AMR solver, its state): random phi/rhs (eps 0.5 + U[0,1))
    on every level, Dirichlet faces from ``bc_fn``."""
    tp = port.build_amr_centered(3, n_levels, np.full(3, 16), 8,
                                 np.full(3, 1.0 / 16))
    tr = ref.build_amr_centered(3, n_levels, np.full(3, 16), 8,
                                np.full(3, 1.0 / 16))
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    jdt = jnp.float32 if dtype == np.float32 else jnp.float64
    sb = port.MGSolver(tp, port.MGConfig(operator=operator, smoother="gsrb",
                                         device="cpu", dtype=tdt))
    sd = port.DenseAMRMGSolver(tp, port.MGConfig(
        operator=operator, smoother="gsrb", coarse_solver=coarse,
        device="cpu", dtype=tdt))
    rd = ref.DenseAMRMGSolver(tr, ref.MGConfig(
        operator=operator, smoother="gsrb", coarse_solver=coarse, dtype=jdt))
    sb.set_bc(IPHI, port.BCType.DIRICHLET, fn=bc_fn)
    sd.set_bc(0, port.BCType.DIRICHLET, fn=bc_fn)
    rd.set_bc(0, ref.BCType.DIRICHLET, fn=bc_fn)
    st_b, st_d, st_r = sb.allocate(), sd.allocate(), rd.allocate()
    rng = np.random.default_rng(seed)
    n_eps = N_EPS[operator]
    isl = (slice(None),) + (slice(1, -1),) * 3
    for lvl in sb.levels:
        nb, nc = sb.static[lvl]["n_boxes"], sb.static[lvl]["nc"]
        fields = {IPHI: rng.normal(size=(nb,) + (nc,) * 3),
                  IRHS: rng.normal(size=(nb,) + (nc,) * 3)}
        for d in range(n_eps):
            fields[IVEPS + d] = 0.5 + rng.random(size=(nb,) + (nc,) * 3)
        for iv, vals in fields.items():
            st_b["cc"][lvl][(iv,) + isl] = torch.as_tensor(vals, dtype=tdt)
    for iv in [IPHI, IRHS] + [IVEPS + d for d in range(n_eps)]:
        st_b = sb.fill_ghost(st_b, iv)
    kmap = {"phi": IPHI, "rhs": IRHS}
    kmap.update({f"eps{d}": IVEPS + d for d in range(n_eps)})
    for lvl in sd.levels:
        for k, iv in kmap.items():
            vals = boxed_to_patch(sb, sd, st_b, lvl, iv).astype(dtype)
            st_d = sd.set_interior(st_d, lvl, k, vals)
            st_r = rd.set_interior(st_r, lvl, k, jnp.asarray(vals))
    return sb, st_b, sd, st_d, rd, st_r


def interior(sv, st, lvl, key):
    return np.asarray(sv.interior(st, lvl, key))


# ---------------------------------------------------------------------------
# geometry, gate, configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_levels", [2, 3])
def test_geometry_and_gating(n_levels):
    """Patch geometry, face kinds, levels and kernel configs are the JAX
    package's; make_solver sends the tree here for all five operators;
    uniform and periodic trees go elsewhere."""
    tp = port.build_amr_centered(3, n_levels, np.full(3, 16), 8,
                                 np.full(3, 1.0 / 16))
    tr = ref.build_amr_centered(3, n_levels, np.full(3, 16), 8,
                                np.full(3, 1.0 / 16))
    for op in OPERATORS:
        sv = port.make_solver(tp, port.MGConfig(operator=op, device="cpu"))
        rv = ref.make_solver(tr, ref.MGConfig(operator=op))
        assert type(sv).__name__ == type(rv).__name__ == "DenseAMRMGSolver"
        assert port.dense_amr_supported(tp, sv.cfg)
        assert sv.levels == rv.levels and sv.dims == rv.dims
        assert sv.face_kind == rv.face_kind
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
            assert np.array_equal(sv.cell_centers(lvl),
                                  rv.cell_centers(lvl))
    if n_levels == 3:
        sv = port.make_solver(tp, port.MGConfig(device="cpu"))
        assert sv._whole_region(2) and not sv._whole_region(3)
        assert sv.face_kind[3] == ["rb"] * 6
        assert sv._kcfgs[3].bc == [RB_COEFFS] * 6
    ut = port.build_rectangle(3, np.full(3, 16), 8, np.full(3, 1.0 / 16),
                              np.zeros(3))
    assert not port.dense_amr_supported(ut, port.MGConfig())
    pt = port.build_amr_centered(3, 2, np.full(3, 16), 8,
                                 np.full(3, 1.0 / 16), periodic=[True] * 3)
    assert not port.dense_amr_supported(pt, port.MGConfig())


def test_bc_planes_and_state_roundtrip():
    """Offset-aware boundary planes equal the JAX package's (zero
    placeholders on refinement faces), and a state crosses both ways
    through convert."""
    _, _, sd, st_d, rd, st_r = setup("ahelmholtz")
    for lvl in sd.levels:
        for a, b in zip(st_d["bc"][lvl], st_r["bc"][lvl]):
            assert np.array_equal(a.numpy(), np.asarray(b))
    back = convert.state_to_numpy(st_d)
    again = convert.state_from_numpy(sd, back)
    for k in sd._field_keys:
        for lvl in sd.levels:
            assert torch.equal(again[k][lvl], st_d[k][lvl])


@pytest.mark.parametrize("operator", ["laplacian", "ahelmholtz"])
def test_refinement_face_planes(operator):
    """The refinement-face planes of phi and of every coefficient field
    (coarse strip with its synthesized ring, box_gc_for_fine_neighbor
    interpolation) against the JAX package's."""
    _, _, sd, st_d, rd, st_r = setup(operator)
    top = sd.levels[-1]
    for key in ("phi",) + sd._eps_keys:
        got = sd._planes(st_d, top, key)
        want = rd._planes(st_r, top, key)
        for nb in range(6):
            near(got[nb].numpy(), np.asarray(want[nb]),
                 what=f"{key} face {nb}")
    epl = sd._eps_planes(st_d, top)
    assert (epl is None) == (not sd.n_eps)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("operator,lvl_kind", [
    ("laplacian", "top"), ("laplacian", "mid"), ("helmholtz", "top"),
    ("vlaplacian", "top"), ("ahelmholtz", "top")])
def test_smooth(operator, lvl_kind):
    """Patch smoothing (two GSRB cycles) with its refinement-face ghosts,
    coefficient ghosts included, against the JAX package's and bitwise
    against the port's boxed smooth_boxes."""
    sb, st_b, sd, st_d, rd, st_r = setup(operator)
    lam = lam_of(operator)
    lvl = sd.levels[-1] if lvl_kind == "top" else sd.levels[-1] - 1
    st_d = sd._smooth(st_d, lvl, 2, sd._lam(lam))
    st_r = rd._smooth(st_r, lvl, 2, rd._lam(lam))
    st_b = sb._smooth_boxes(st_b, sb._to_device(), lvl, 2, lam)
    got = interior(sd, st_d, lvl, "phi")
    near(got, interior(rd, st_r, lvl, "phi"), what="smooth vs JAX")
    assert np.array_equal(got, boxed_to_patch(sb, sd, st_b, lvl, IPHI))


@pytest.mark.parametrize("operator", ["helmholtz", "vhelmholtz"])
def test_residual(operator):
    sb, st_b, sd, st_d, rd, st_r = setup(operator)
    lam, top = 0.7, sd.levels[-1]
    st_d = sd._residual(st_d, top, sd._lam(lam))
    st_r = rd._residual(st_r, top, rd._lam(lam))
    st_b = sb._residual_lvl(st_b, sb._to_device(), top, lam)
    got = interior(sd, st_d, top, "ires")
    near(got, interior(rd, st_r, top, "ires"), what="residual vs JAX")
    assert np.array_equal(got, boxed_to_patch(sb, sd, st_b, top, IRES))


@pytest.mark.parametrize("operator", ["laplacian", "vhelmholtz"])
def test_update_coarse(operator):
    """The down-leg's FAS transfer on the footprint region: phi, the
    tau-corrected rhs and iold of the coarse level (iold on the region:
    the boxed solver keeps it on parent boxes only)."""
    sb, st_b, sd, st_d, rd, st_r = setup(operator)
    lam, top = lam_of(operator), sd.levels[-1]
    st_d = sd._update_coarse(st_d, top, sd._lam(lam))
    st_r = rd._update_coarse(st_r, top, rd._lam(lam))
    st_b = sb._update_coarse(st_b, sb._to_device(), top, lam)
    r0, r1 = sd.regions[top]
    reg = tuple(slice(int(r0[d]), int(r1[d])) for d in (2, 1, 0))
    for key, iv in (("phi", IPHI), ("rhs", IRHS), ("iold", IOLD)):
        got = interior(sd, st_d, top - 1, key)
        near(got, interior(rd, st_r, top - 1, key), what=f"{key} vs JAX")
        want = boxed_to_patch(sb, sd, st_b, top - 1, iv)
        if key == "iold":
            got, want = got[reg], want[reg]
        rel_near(got, want, 2e-13, f"{key} vs boxed")


def test_correct_children():
    """The up-leg correction from the region and its one-cell ring,
    through the prolongation kernel's corr_ready mode."""
    sb, st_b, sd, st_d, rd, st_r = setup("laplacian", seed=11)
    top = sd.levels[-1]
    lvl_c = top - 1
    rng = np.random.default_rng(4)
    nb, nc = sb.static[lvl_c]["n_boxes"], sb.static[lvl_c]["nc"]
    isl = (slice(None),) + (slice(1, -1),) * 3
    st_b["cc"][lvl_c][(IOLD,) + isl] = torch.as_tensor(
        rng.normal(size=(nb,) + (nc,) * 3))
    st_b = sb.fill_ghost(st_b, IOLD)
    iold = boxed_to_patch(sb, sd, st_b, lvl_c, IOLD)
    st_d = sd.set_interior(st_d, lvl_c, "iold", iold)
    st_r = rd.set_interior(st_r, lvl_c, "iold", jnp.asarray(iold))
    before = pdk.launch_counts()
    st_d = sd._correct_children(st_d, lvl_c, 0.0)
    assert pdk.launch_counts() == before   # CPU tensors launch nothing
    st_r = rd._correct_children(st_r, lvl_c, rd._lam(0.0))
    st_b = sb._correct_children(st_b, sb._to_device(), lvl_c)
    got = interior(sd, st_d, top, "phi")
    near(got, interior(rd, st_r, top, "phi"), what="correction vs JAX")
    rel_near(got, boxed_to_patch(sb, sd, st_b, top, IPHI), 1e-14,
             "correction vs boxed")


def test_region_correction_is_prolong_rect_plus_add():
    """The region correction through the corr_ready mode equals
    ``phi[interior] += _prolong_rect(sub)`` bitwise (its ghost 1.0*b +
    0.0*x1 is b), the JAX package's plain-XLA form."""
    _, _, sd, st_d, _, _ = setup("laplacian", seed=12)
    top = sd.levels[-1]
    rng = np.random.default_rng(9)
    Z, Y, X = (v // 2 + 2 for v in sd._ishape(top))
    sub = torch.from_numpy(rng.normal(size=(Z, Y, X)))
    phi = st_d["phi"][top].clone()
    want = phi.clone()
    want[pdk._ISL] += sd._prolong_rect(sub)
    sd._prolong_add(sub, phi)
    assert torch.equal(phi[pdk._ISL], want[pdk._ISL])


def test_prepare_coefficient_restricts_into_regions():
    """prepare_coefficient restricts each level's coefficient into its
    footprint region only (coarse leaves keep their own values) and
    keeps the coarse fields' identity."""
    _, _, sd, st_d, rd, st_r = setup("vlaplacian")
    ids = {lvl: st_d["eps0"][lvl] for lvl in sd.levels}
    st_d = sd.prepare_coefficient(st_d)
    st_r = rd.prepare_coefficient(st_r)
    for lvl in sd.levels:
        assert st_d["eps0"][lvl] is ids[lvl]
        near(interior(sd, st_d, lvl, "eps0"), interior(rd, st_r, lvl, "eps0"),
             what=f"eps0 level {lvl}")


# ---------------------------------------------------------------------------
# the eps_bc plain route
# ---------------------------------------------------------------------------

def eps_bc_case(n_eps, seed, dtype=np.float64):
    """Configs of both packages on an 8x6x10 level with mixed faces:
    refinement faces (RB_COEFFS, plane-valued b; coefficient ghosts
    sides_rb with a plane) on x-, y+ and z+, Dirichlet constants
    elsewhere; random fields, planes and coefficient planes (0.5 +
    U[0,1)), pads random."""
    rng = np.random.default_rng(seed)
    dims = (8, 6, 10)
    rb = (0, 3, 5)
    bc = [RB_COEFFS if nb in rb else (2.0, -1.0, 0.0) for nb in range(6)]
    b_const = [None if nb in rb else 0.3 for nb in range(6)]
    eps_bc = [RB_COEFFS if nb in rb else (0.0, 1.0, 0.0) for nb in range(6)]
    idr2 = (64.0, 36.0, 100.0)
    jdt = jnp.float32 if dtype == np.float32 else jnp.float64
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    rc = rdk.DenseStencilConfig(dims, idr2, bc, (False,) * 3, jdt,
                                b_const=b_const, n_eps=n_eps, eps_bc=eps_bc)
    pc = pdk.DenseStencilConfig(dims, idr2, bc, (False,) * 3, tdt,
                                b_const=b_const, n_eps=n_eps, eps_bc=eps_bc)
    shape = pc.pshape
    phi, rhs = (rng.normal(size=shape).astype(dtype) for _ in range(2))
    eps = [(0.5 + rng.random(size=shape)).astype(dtype)
           for _ in range(n_eps)]
    planes = [rng.normal(size=pc.plane_shape(nb)).astype(dtype)
              for nb in range(6)]
    eplanes = [[(0.5 + rng.random(size=pc.plane_shape(nb))).astype(dtype)
                if nb in rb else None for nb in range(6)]
               for _ in range(n_eps)]

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    rargs = (rc, j(phi), j(rhs), jnp.asarray(0.7, jdt), [j(p) for p in planes])
    pargs = (pc, t(phi), t(rhs), pc.rnd(0.7), [t(p) for p in planes])
    rkw = dict(eps=tuple(j(e) for e in eps),
               eps_planes=[[j(p) for p in row] for row in eplanes])
    pkw = dict(eps=tuple(t(e) for e in eps),
               eps_planes=[[t(p) for p in row] for row in eplanes])
    return rargs, pargs, rkw, pkw


@pytest.mark.parametrize("n_eps", [1, 3])
def test_eps_bc_plain_versions_match_reference(n_eps):
    """The pair, one half-sweep and the apply/residual of a config with
    eps_bc (plane-valued coefficient ghosts) against the JAX package's jnp
    path, on the plain route: counted, no kernel launch."""
    rargs, pargs, rkw, pkw = eps_bc_case(n_eps, 40 + n_eps)
    assert not rargs[0].use_kernel
    before, plain0 = pdk.launch_counts(), pdk.plain_route_counts()
    cases = [
        ("pair", lambda: rdk.pair_sweep_dense(*rargs, red_parity=1, **rkw),
         lambda: pdk.pair_sweep_dense(*pargs, red_parity=1, **pkw)),
        ("half", lambda: rdk.half_sweep_dense(*rargs, 0, **rkw),
         lambda: pdk.half_sweep_dense(*pargs, 0, **pkw)),
        ("residual", lambda: rdk.stencil_apply_dense(*rargs, True, **rkw),
         lambda: pdk.stencil_apply_dense(*pargs, True, **pkw)),
        ("apply", lambda: rdk.stencil_apply_dense(*rargs, False, **rkw),
         lambda: pdk.stencil_apply_dense(*pargs, False, **pkw))]
    for what, rf, pf in cases:
        near(pf()[pdk._ISL].numpy(), np.asarray(rf())[pdk._ISL], what=what)
    assert pdk.launch_counts() == before
    plain = pdk.plain_route_counts()
    assert {k: plain[k] - plain0[k] for k in plain} == {
        "pair_sweep_dense[eps_bc]": 1, "half_sweep_dense[eps_bc]": 1,
        "stencil_apply_dense[eps_bc]": 2}


def test_plain_route_only_for_eps_bc_configs():
    """eps_planes without eps_bc is refused, the fused transfers refuse an
    eps_bc config (the JAX package's fused_down_ok is False for it), and
    a config without eps_bc never counts on the plain route."""
    _, pargs, _, pkw = eps_bc_case(1, 7)
    cfg = pargs[0]
    plain = pdk.plain_route_counts()
    nc = pdk.DenseStencilConfig(cfg.dims, cfg.idr2, cfg.bc, cfg.periodic,
                                cfg.dtype, b_const=cfg.b_const, n_eps=1)
    args = (nc,) + pargs[1:]
    pdk.pair_sweep_dense(*args, 0, eps=pkw["eps"])
    pdk.stencil_apply_dense(*args, True, eps=pkw["eps"])
    assert pdk.plain_route_counts() == plain
    with pytest.raises(ValueError, match="eps_planes need"):
        pdk.pair_sweep_dense(*args, 0, **pkw)
    with pytest.raises(ValueError, match="eps_bc"):
        pdk.residual_restrict_dense(*pargs, eps=pkw["eps"])
    with pytest.raises(ValueError, match="eps_bc"):
        pdk.DenseStencilConfig(cfg.dims, cfg.idr2, cfg.bc, cfg.periodic,
                               cfg.dtype, eps_bc=[(0.0, 1.0, 0.0)] * 6)


def test_amr_vcycle_counts_the_plain_route_on_patch_levels_only():
    """A vhelmholtz V-cycle: the levels with refinement faces take the
    plain route (pair, residual, the coarse patch's apply), the whole
    levels never."""
    _, _, sd, st_d, _, _ = setup("vhelmholtz", coarse="direct")
    pdk.reset_plain_route_counts()
    sd.fas_vcycle(st_d, lam=0.4)
    got = pdk.plain_route_counts()
    # the top patch: one pair per smoothing cycle on CPU tensors, down
    # and up; the update_coarse residual and the max-residual's; every
    # other level has no refinement face
    n_pairs = sd.cfg.n_cycle_down + sd.cfg.n_cycle_up
    assert got == {"pair_sweep_dense[eps_bc]": n_pairs,
                   "half_sweep_dense[eps_bc]": 0,
                   "stencil_apply_dense[eps_bc]": 2}


# ---------------------------------------------------------------------------
# whole cycles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("operator,n_levels", [
    ("laplacian", 3), ("laplacian", 2), ("vhelmholtz", 3),
    ("ahelmholtz", 3)])
def test_vcycle_matches_boxed_solver(operator, n_levels):
    """A whole V-cycle (the reference's coarse smoothing loop) against the
    port's boxed MGSolver on the same fields, as the JAX tests hold their
    dense AMR solver against their boxed one."""
    sb, st_b, sd, st_d, _, _ = setup(operator, n_levels=n_levels)
    lam = lam_of(operator)
    st_b, res_b = sb.fas_vcycle(st_b, lam=lam)
    st_d, res_d = sd.fas_vcycle(st_d, lam=lam)
    for lvl in sd.levels:
        rel_near(interior(sd, st_d, lvl, "phi"),
                 boxed_to_patch(sb, sd, st_b, lvl, IPHI), 5e-13,
                 f"level {lvl}")
    assert abs(float(res_b) - float(res_d)) <= 1e-11 * max(
        1.0, abs(float(res_b)))


def cycle_against_reference(operator, coarse, fmg, seed=8):
    """One have-guess FMG or V-cycle of both packages from the same
    fields, both eager (the JAX cycle uncompiled, so no FMA
    contraction): every level's phi and the residual."""
    _, _, sd, st_d, rd, st_r = setup(operator, coarse=coarse, seed=seed)
    lam = lam_of(operator)
    rd._ensure_direct(st_r)
    if fmg:
        st_r, res_r = rd._fmg(st_r, rd._lam(lam), have_guess=True,
                              need_res=True)
        st_d, res_d = sd.fas_fmg(st_d, lam=lam, have_guess=True)
    else:
        st_r, res_r = rd._vcycle(st_r, rd._lam(lam), None, True, True)
        st_d, res_d = sd.fas_vcycle(st_d, lam=lam)
    for lvl in sd.levels:
        rel_near(interior(sd, st_d, lvl, "phi"),
                 interior(rd, st_r, lvl, "phi"), 5e-13, f"level {lvl}")
    assert abs(float(res_r) - float(res_d)) <= 1e-11 * abs(float(res_r))


@pytest.mark.slow
@pytest.mark.parametrize("operator,coarse,fmg", [
    ("laplacian", "direct", False),
    ("ahelmholtz", "direct", True), ("laplacian", "direct", True),
    ("laplacian", "smooth", True), ("vlaplacian", "direct", True),
    ("helmholtz", "smooth", True), ("vhelmholtz", "direct", False)])
def test_cycles_match_reference(operator, coarse, fmg):
    cycle_against_reference(operator, coarse, fmg)


def test_fmg_matches_boxed_solver():
    """A zero-guess FMG with the coarse smoothing loop against the port's
    boxed solver on a 3-level tree."""
    sb, st_b, sd, st_d, _, _ = setup("laplacian", seed=8)
    st_b, res_b = sb.fas_fmg(st_b)
    st_d, res_d = sd.fas_fmg(st_d)
    top = sd.levels[-1]
    rel_near(interior(sd, st_d, top, "phi"),
             boxed_to_patch(sb, sd, st_b, top, IPHI), 5e-13, "fmg")
    assert abs(float(res_b) - float(res_d)) <= 1e-11 * max(
        1.0, abs(float(res_b)))


def test_poisson_solver_converges_on_amr_tree():
    """test_refinement.f90 through PoissonSolver: a discretely generated
    rhs on an AMR tree; FMGs drive the top-level error to the
    discretization level and the residual contracts (the JAX test's
    checks)."""
    tree = port.build_amr_centered(3, 3, np.full(3, 16), 8,
                                   np.full(3, 1.0 / 16))
    ps = port.PoissonSolver(3, (16,) * 3, 8, tree=tree, device="cpu")
    sd = ps.solver
    assert isinstance(sd, port.DenseAMRMGSolver) and ps.dense
    ps.set_dirichlet(fn=solution)
    st = ps._ensure_state()
    for lvl in sd.levels:
        sd.set_interior(st, lvl, "phi", solution(sd.cell_centers(lvl)))
    sd.apply_operator(st, lam=0.0, out_key="rhs")
    for lvl in sd.levels:
        st["phi"][lvl].zero_()
    phi, info = ps.solve(rtol=1e-10, max_cycles=8)
    res = info["residuals"]
    assert phi.shape == (32, 32, 32)
    top = sd.levels[-1]
    err = np.max(np.abs(phi.numpy() - solution(sd.cell_centers(top))))
    assert err < 5e-2, f"solution error {err}"
    assert (res[0] / res[4]) ** 0.25 > 5.0


def test_solve_refined_on_amr_solver_refuses_as_the_reference():
    """solve_refined on a float32 AMR solver: the JAX package sends it to
    RefinedPoisson, whose double-float gate refuses the top level's
    plane-valued refinement faces with an AssertionError; the port
    refuses it there too, with the same error type."""
    from octree_mg_tpu.solve.refine import solve_refined as ref_refined
    tr = ref.build_amr_centered(3, 3, np.full(3, 16), 8,
                                np.full(3, 1.0 / 16))
    tp = port.build_amr_centered(3, 3, np.full(3, 16), 8,
                                 np.full(3, 1.0 / 16))
    for op in ("laplacian", "vlaplacian"):
        rd = ref.make_solver(tr, ref.MGConfig(operator=op,
                                              dtype=jnp.float32))
        sd = port.make_solver(tp, port.MGConfig(operator=op, device="cpu",
                                                dtype=torch.float32))
        z = np.zeros((32,) * 3, np.float32)
        eps = None if op == "laplacian" else [np.ones((32,) * 3)]
        with pytest.raises(AssertionError, match="df32") as ei:
            ref_refined(rd, rd.allocate(), z, z, eps=eps)
        with pytest.raises(type(ei.value), match="df32 .*gate"):
            port.solve_refined(sd, sd.allocate(), torch.from_numpy(z),
                               torch.from_numpy(z), eps=eps)


# ---------------------------------------------------------------------------
# float32: the scalar roundings, function by function
# ---------------------------------------------------------------------------

def float32_pair():
    return setup("helmholtz", dtype=np.float32,
                 bc_fn=lambda x: 0.3 + solution(x))


@pytest.mark.slow
def test_float32_planes_and_smoothing_match_reference_ops():
    """float32 refinement-face planes (the 0.125 gradients, the RB_COEFFS
    ring synthesis) and one smoothing cycle (lam rounded in float32, the
    sides_rb ghosts) bitwise the JAX package's eager ops."""
    _, _, sd, st_d, rd, st_r = float32_pair()
    top = sd.levels[-1]
    lam = 0.7
    assert sd._lam(lam) == float(np.float32(lam))
    for nb, (a, b) in enumerate(zip(sd._planes(st_d, top),
                                    rd._planes(st_r, top))):
        assert np.array_equal(a.numpy(), np.asarray(b)), f"plane {nb}"
    st_d = sd._smooth(st_d, top, 1, sd._lam(lam))
    st_r = rd._smooth(st_r, top, 1, rd._lam(lam))
    assert np.array_equal(interior(sd, st_d, top, "phi"),
                          interior(rd, st_r, top, "phi"))


@pytest.mark.slow
def test_float32_transfers_match_reference_ops():
    """float32 residual (lam in float32) and region correction bitwise
    the JAX package's eager ops; the region restriction and the coarse
    rhs within 4 float32 ulps of max|ref| (reduce_window sums in
    another order)."""
    _, _, sd, st_d, rd, st_r = float32_pair()
    top = sd.levels[-1]
    lam = 0.7
    st_d = sd._residual(st_d, top, sd._lam(lam))
    st_r = rd._residual(st_r, top, rd._lam(lam))
    assert np.array_equal(interior(sd, st_d, top, "ires"),
                          interior(rd, st_r, top, "ires"))
    st_d = sd._update_coarse(st_d, top, sd._lam(lam))
    st_r = rd._update_coarse(st_r, top, rd._lam(lam))
    e32 = np.finfo(np.float32).eps
    for key in ("phi", "rhs"):
        got, want = (interior(sd, st_d, top - 1, key),
                     interior(rd, st_r, top - 1, key))
        assert np.abs(got - want).max() <= 4 * e32 * np.abs(want).max(), key
    # the correction from identical coarse fields
    for key in ("phi", "iold"):
        a = interior(rd, st_r, top - 1, key)
        if key == "iold":
            a = a + np.float32(0.01) * a
        st_d = sd.set_interior(st_d, top - 1, key, a)
        st_r = rd.set_interior(st_r, top - 1, key, jnp.asarray(a))
    st_d = sd._correct_children(st_d, top - 1, sd._lam(lam))
    st_r = rd._correct_children(st_r, top - 1, rd._lam(lam))
    assert np.array_equal(interior(sd, st_d, top, "phi"),
                          interior(rd, st_r, top, "phi"))


@pytest.mark.parametrize("operator", ["laplacian", "vlaplacian"])
def test_var_with_ring_window_is_the_whole_ring_bitwise(operator):
    """The refinement-face strips are windows of ``_var_with_ring``
    computed on their own cells, which must equal the whole level's
    ringed field over any window: inside, through a face, an edge and a
    corner of the ring, on the whole 32^3 level (physical faces) and on
    the 32^3 patch (refinement faces), phi and the coefficient field."""
    _, _, sd, st_d, _, _ = setup(operator, bc_fn=lambda x: 0.3 + solution(x))
    windows = [((3, 4, 5), (9, 12, 7)), ((0, 2, 3), (5, 9, 10)),
               ((30, 0, 1), (34, 34, 2)), ((0, 0, 0), (34, 34, 34)),
               ((33, 5, 33), (34, 20, 34))]
    for lvl in sd.levels[-2:]:
        for key in ("phi",) + sd._eps_keys:
            full = sd._var_with_ring(st_d, lvl, key)
            for lo, hi in windows:
                got = sd._var_with_ring(st_d, lvl, key, lo, hi)
                want = full[tuple(slice(a, b) for a, b in zip(lo, hi))]
                assert torch.equal(got, want), (lvl, key, lo, hi)
