"""Variable-coefficient operators (vlaplacian, vhelmholtz, ahelmholtz) of
the PyTorch package against the JAX package's, on the CPU in float64.

The same seeded numpy inputs go through both packages: stencil bodies
(the JAX package's whole-array jnp forms, run eagerly, against the
port's plain versions), solver phases (eagerly) and whole cycles (the
JAX package's jitted programs).  States cross with
``convert.state_from_numpy``, coefficient fields included.

Tolerances, each with its reason:

* a stencil body per call: ``64 * eps64 * max|reference|``, the bound of
  tests/test_torch_dense_kernels.py (the JAX package's Pallas bodies
  run under jit, where XLA:CPU may contract ``a*b+c``; the eager jnp
  forms used here do not, and agree to the last bit so far);
* solver phases: ``256 * eps64 * max|reference|`` per field, as in
  tests/test_torch_dense_solver.py; the restricted coefficients
  ``1e-14`` absolute, the bound of tests/test_dense_vcoeff.py:122 (the
  JAX package restricts small levels with reduce_window, in its own
  summation order);
* the probed coarse matrix: ``1e-12`` of its largest entry (each column
  is one stencil application, the same arithmetic in both packages, up
  to the contraction above);
* whole cycles: phi within ``1e-13`` of max|phi| and the residual within
  ``1e-12`` of max(1, |res|), the bounds of tests/test_dense_vcoeff.py:
  96-109 (one V-cycle or FMG accumulates the per-call differences of
  some hundred kernel calls and two coarse matrix products);
* manufactured solutions: error below 1e-8 after the cycles of
  tests/test_dense_vcoeff.py:126-160.

The interpret-mode Pallas bodies with eps windows (the JAX package's
kernel path) take minutes on the CPU and are marked ``slow``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octree_mg_tpu as ref
from octree_mg_tpu.ops import dense_kernels as jdk
from octree_mg_tpu.ops.ghost import bc_coeffs as ref_bc_coeffs

import octree_mg_tpu_torch as port
from octree_mg_tpu_torch import convert
from octree_mg_tpu_torch.ops import dense_kernels as dk

# The suite runs in several worker processes on a few cores and these
# tensors are small: one intra-op thread per process keeps the
# workers from oversubscribing the cores.
torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps
N_EPS = {"vlaplacian": 1, "vhelmholtz": 1, "ahelmholtz": 3}
OPS = tuple(N_EPS)
ISL = dk._ISL


def solution(x):
    out = 1.0
    for d in range(x.shape[-1]):
        out = out * np.sin(2 * np.pi * 2 * x[..., d])
    return out


def eps_field(x, d=0):
    """Smooth positive coefficient field (tests/test_dense_vcoeff.py)."""
    return 1.0 + 0.5 * np.cos(2 * np.pi * (x[..., d % x.shape[-1]]
                                           + 0.1 * d))


def np_sync(a, dims, per):
    """Periodic pad wrap of a padded numpy field (the solver's job)."""
    X, Y, Z = dims
    if per[2]:
        d = min(dk.PZ, Z)
        a[dk.PZ - d:dk.PZ] = a[Z + dk.PZ - d:Z + dk.PZ]
        a[Z + dk.PZ:Z + dk.PZ + d] = a[dk.PZ:dk.PZ + d]
    if per[1]:
        d = min(dk.PY, Y)
        a[:, dk.PY - d:dk.PY] = a[:, Y + dk.PY - d:Y + dk.PY]
        a[:, Y + dk.PY:Y + dk.PY + d] = a[:, dk.PY:dk.PY + d]
    return a


def close(got, want, mult, what=""):
    want = np.asarray(want)
    atol = mult * EPS * max(np.max(np.abs(want)), 1e-300)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=atol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# stencil bodies
# ---------------------------------------------------------------------------

BODY_DIMS = (16, 12, 10)
BCS = {"dirichlet": ("DIRICHLET", 0.5), "neumann": ("NEUMANN", 0.3),
       "continuous": ("CONTINUOUS", 0.0), "planes": ("DIRICHLET", None)}


class BodyCase:
    """A level config with n_eps coefficient fields in both packages."""

    def __init__(self, n_eps, per, bc_kind, seed, dims=BODY_DIMS,
                 interpret_kernel=False):
        rng = np.random.default_rng(seed)
        X, Y, Z = dims
        dr = (1.0 / X, 1.0 / Y, 1.0 / Z)
        idr2 = tuple(1.0 / h ** 2 for h in dr)
        kind, b = BCS[bc_kind]
        bt = getattr(ref.BCType, kind)
        bc = [tuple(ref_bc_coeffs(bt, dr[nb // 2], nb)) for nb in range(6)]
        b_const = [b] * 6
        self.dims, self.per, self.lam = dims, per, 0.3
        self.jcfg = jdk.DenseStencilConfig(dims, idr2, bc, per, jnp.float64,
                                           b_const=b_const, interpret=True,
                                           n_eps=n_eps)
        assert self.jcfg.use_kernel == interpret_kernel
        self.tcfg = dk.DenseStencilConfig(dims, idr2, bc, per, torch.float64,
                                          b_const=b_const, n_eps=n_eps)
        shape = dk.padded_shape(dims)
        self.phi = np_sync(rng.normal(size=shape), dims, per)
        self.rhs = np_sync(rng.normal(size=shape), dims, per)
        self.eps = [np_sync(0.5 + rng.random(size=shape), dims, per)
                    for _ in range(n_eps)]
        self.planes = []
        for nb in range(6):
            if self.tcfg.b_const[nb] is not None:
                self.planes.append(np.zeros((1, 1)))
            else:
                p = rng.normal(size=self.tcfg.plane_shape(nb))
                self.planes.append(p)

    def sync(self, a):
        return np_sync(np.array(a), self.dims, self.per)

    def run_ref(self, entry):
        c, lam = self.jcfg, jnp.asarray(self.lam, jnp.float64)
        phi, rhs = jnp.asarray(self.phi), jnp.asarray(self.rhs)
        bp = [jnp.asarray(p) for p in self.planes]
        eps = tuple(jnp.asarray(e) for e in self.eps)
        if entry == "residual_restrict":
            # the JAX solver's update_coarse where no fused kernel takes
            # the level: the residual, then both restrictions by
            # reduce_window (solve/dense.py _restrict_into)
            res = jdk._apply_jnp(c, phi, rhs, lam, bp, True, eps=eps)
            return [np.asarray(jax.lax.reduce_window(
                a[ISL], 0.0, jax.lax.add, (2, 2, 2), (2, 2, 2), "VALID")
                / 8.0) for a in (phi, res)]
        if entry == "pair1":
            out = (jdk._pair_jnp(c, phi, rhs, lam, bp, 0, eps=eps),)
        elif entry == "pair2":
            mid = self.sync(jdk._pair_jnp(c, phi, rhs, lam, bp, 0, eps=eps))
            out = (jdk._pair_jnp(c, jnp.asarray(mid), rhs, lam, bp, 0,
                                 eps=eps),)
        elif entry in ("apply", "residual"):
            out = (jdk._apply_jnp(c, phi, rhs, lam, bp, entry == "residual",
                                  eps=eps),)
        elif entry == "pair2_kernel":
            out = (jdk.pair_sweep_dense(c, phi, rhs, lam, bp, 0, n_pairs=2,
                                        eps=eps),)
        elif entry == "residual_kernel":
            out = (jdk.stencil_apply_dense(c, phi, rhs, lam, bp, True,
                                           eps=eps),)
        elif entry == "downsweep_kernel":
            out = jdk.downsweep_dense(c, phi, rhs, lam, bp, 0, eps=eps)
        else:   # residual_restrict_kernel
            out = jdk.residual_restrict_dense(c, phi, rhs, lam, bp, eps=eps)
        return [np.asarray(o)[ISL] for o in out]

    def run_port(self, entry):
        c, lam = self.tcfg, self.lam
        phi, rhs = torch.from_numpy(self.phi.copy()), torch.from_numpy(
            self.rhs.copy())
        bp = [torch.from_numpy(p.copy()) for p in self.planes]
        eps = tuple(torch.from_numpy(e.copy()) for e in self.eps)
        name = entry.replace("_kernel", "")
        if name in ("pair1", "pair2"):
            out = (dk.pair_sweep_dense(c, phi, rhs, lam, bp, 0,
                                       n_pairs=int(name[-1]), eps=eps),)
        elif name in ("apply", "residual"):
            out = (dk.stencil_apply_dense(c, phi, rhs, lam, bp,
                                          name == "residual", eps=eps),)
        elif name == "downsweep":
            out = dk.downsweep_dense(c, phi, rhs, lam, bp, 0, eps=eps)
        else:
            out = dk.residual_restrict_dense(c, phi, rhs, lam, bp, eps=eps)
        return [o[ISL].numpy() for o in out]


_BODY = [(e, n, per, bc)
         for i, (e, n, per) in enumerate(
             (e, n, per) for e in ("pair1", "pair2", "apply", "residual",
                                   "residual_restrict")
             for n in (1, 3)
             for per in ((False, False, False), (True, False, True)))
         for bc in (list(BCS)[i % 4],)]


@pytest.mark.parametrize("entry,n_eps,per,bc", _BODY)
def test_eps_body_matches_reference(entry, n_eps, per, bc):
    case = BodyCase(n_eps, per, bc, seed=11)
    want, got = case.run_ref(entry), case.run_port(entry)
    for w, g in zip(want, got):
        close(g, w, 64, entry)


@pytest.mark.slow
@pytest.mark.parametrize("n_eps", [1, 3])
@pytest.mark.parametrize("dims,entries", [
    ((128, 16, 16), ("pair2_kernel", "residual_kernel")),
    ((256, 16, 16), ("downsweep_kernel", "residual_restrict_kernel"))])
def test_eps_pallas_body_matches_plain(dims, entries, n_eps):
    """The JAX package's Pallas bodies with eps windows (interpret mode,
    tests/test_dense_vcoeff.py:163-240) against the port's plain
    versions."""
    case = BodyCase(n_eps, (False,) * 3, "dirichlet", seed=21, dims=dims,
                    interpret_kernel=True)
    for entry in entries:
        want, got = case.run_ref(entry), case.run_port(entry)
        assert len(want) == len(got)
        for w, g in zip(want, got):
            close(g, w, 64, entry)


@pytest.mark.parametrize("n_eps", [1, 3])
def test_face_counters_exist_and_cpu_tensors_never_count(n_eps):
    """Every entry point with a face-plane design (the double pair, the
    down-leg, the apply and the residual-restriction) has its
    ``name[n_eps=k][faces]`` counter, and a call on CPU tensors (the
    plain versions) counts under none of them."""
    counts = dk.launch_counts()
    for e in ("pair_sweep_dense", "downsweep_dense", "stencil_apply_dense",
              "residual_restrict_dense"):
        assert e in dk.FACE_ENTRIES and dk.faces_name(e, n_eps) in counts
    case = BodyCase(n_eps, (False,) * 3, "dirichlet", seed=3, dims=(8, 6, 4))
    before = dk.launch_counts()
    for entry in ("apply", "residual", "residual_restrict"):
        case.run_port(entry)
    assert dk.launch_counts() == before


def test_eps_fields_are_checked():
    case = BodyCase(3, (False,) * 3, "dirichlet", seed=1)
    c = case.tcfg
    phi = torch.from_numpy(case.phi)
    eps = [torch.from_numpy(e) for e in case.eps]
    with pytest.raises(ValueError, match="n_eps"):
        dk.stencil_apply_dense(c, phi, phi, 0.0, [None] * 6, False,
                               eps=eps[:1])
    with pytest.raises(ValueError, match="shape"):
        dk.pair_sweep_dense(c, phi, phi, 0.0, [None] * 6, 0,
                            eps=[eps[0], eps[1], eps[2][1:]])
    with pytest.raises(TypeError, match="dtype"):
        dk.downsweep_dense(c, phi, phi, 0.0, [None] * 6, 0,
                           eps=[eps[0].float(), eps[1], eps[2]])
    # plane-valued coefficient ghosts (eps_bc) need coefficient fields
    # and six faces
    with pytest.raises(ValueError, match="eps_bc"):
        dk.DenseStencilConfig(c.dims, c.idr2, c.bc, c.periodic,
                              torch.float64, n_eps=0,
                              eps_bc=[(0.0, 1.0, 0.0)] * 6)
    with pytest.raises(ValueError, match="eps_bc"):
        dk.DenseStencilConfig(c.dims, c.idr2, c.bc, c.periodic,
                              torch.float64, n_eps=1,
                              eps_bc=[(0.0, 1.0, 0.0)] * 5)


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32
                               else torch.int64)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("n_eps", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_face_coefficients_are_symmetric(dtype, n_eps, periodic):
    """What the face-plane kernels (csrc/stream_faces.cuh) rest on: the
    plain version's high face coefficient of cell i along each dim is,
    bit for bit, the low face of cell i+1, on coefficients spanning 1e-30
    to 1e30 with equal neighbours among them; on a periodic dim the high
    face of the last cell is the low face of the first, on a physical
    face the first cell's low face and the last cell's high face are the
    self-face ((2*e)*e)/(e + e)*idr2 the kernel builds from a clamped
    source."""
    dims = (6, 5, 4)
    X, Y, Z = dims
    rng = np.random.default_rng(17 + 2 * n_eps + int(periodic))
    cfg = dk.DenseStencilConfig(dims, (36.0, 25.0, 16.0),
                                [(2.0, -1.0, 0.0)] * 6, (periodic,) * 3,
                                dtype, b_const=[0.0] * 6, n_eps=n_eps)
    eps = []
    for _ in range(n_eps):
        v = 10.0 ** rng.uniform(-3.0, 3.0, (Z, Y, X))
        flat = v.reshape(-1)
        flat[rng.choice(flat.size, 8, replace=False)] = [1e-30, 1e30] * 4
        v[:, :, 2] = v[:, :, 1]          # equal neighbours along each dim
        v[:, 3, :] = v[:, 2, :]
        v[1] = v[0]
        a = torch.full(cfg.pshape, float("nan"), dtype=dtype)
        a[ISL] = torch.from_numpy(v).to(dtype)
        eps.append(dk.sync_pads(cfg, a))
    masks = dk._face_masks(cfg, dk._full_iotas(cfg, "cpu"))
    for d, axis in dk._DIM_AXIS:
        lo, hi = (c[ISL] for c in dk._face_coeffs(cfg, eps, d, axis, masks))
        n = dims[d]
        assert torch.equal(_bits(hi.narrow(axis, 0, n - 1)),
                           _bits(lo.narrow(axis, 1, n - 1))), d
        first, last = lo.narrow(axis, 0, 1), hi.narrow(axis, n - 1, 1)
        if periodic:
            assert torch.equal(_bits(last), _bits(first)), d
            continue
        e = (eps[0] if n_eps == 1 else eps[d])[ISL]
        idr2 = cfg.rnd(cfg.idr2[d])
        for face, cell in ((first, e.narrow(axis, 0, 1)),
                           (last, e.narrow(axis, n - 1, 1))):
            assert torch.equal(_bits(face), _bits(
                2.0 * cell * cell / (cell + cell) * idr2)), d


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------

def solver_pair(operator, size=16, periodic=False, bc_fn=True, **kw):
    dsz = np.full(3, size)
    tr = ref.build_rectangle(3, dsz, 8, 1.0 / dsz, np.zeros(3),
                             periodic=[periodic] * 3)
    tp = port.build_rectangle(3, dsz, 8, 1.0 / dsz, np.zeros(3),
                              [periodic] * 3)
    sr = ref.DenseMGSolver(tr, ref.MGConfig(operator=operator, **kw))
    sp = port.DenseMGSolver(tp, port.MGConfig(operator=operator,
                                              device="cpu", **kw))
    if not periodic and bc_fn:
        sr.set_bc(0, ref.BCType.DIRICHLET, fn=solution)
        sp.set_bc(0, port.BCType.DIRICHLET, fn=solution)
    return sr, sp


def to_np(sr, jstate):
    out = {k: {l: np.asarray(v) for l, v in jstate[k].items()}
           for k in sr._field_keys}
    out["bc"] = {l: [np.asarray(p) for p in ps]
                 for l, ps in jstate["bc"].items()}
    return out


def random_states(sr, sp, seed):
    """Random phi, rhs and positive eps on every level, in both
    packages, identical bits."""
    rng = np.random.default_rng(seed)
    st = sr.allocate()
    for lvl in sr.levels:
        X, Y, Z = sr.dims[lvl]
        for k in ("phi", "rhs"):
            st = sr.set_interior(st, lvl, k,
                                 jnp.asarray(rng.normal(size=(Z, Y, X))))
        for k in sr._eps_keys:
            st = sr.set_interior(st, lvl, k, jnp.asarray(
                0.5 + rng.random(size=(Z, Y, X))))
    return st, convert.state_from_numpy(sp, to_np(sr, st))


def coefficient_states(sr, sp, seed):
    """eps_field coefficients on the finest level, restricted down by
    each package, and a random rhs on every level."""
    st = sr.allocate()
    tst = sp.allocate()
    top = sr.levels[-1]
    x = sr.cell_centers(top)
    for d in range(sr.n_eps):
        st = sr.set_coefficient(st, jnp.asarray(eps_field(x, d)), d)
        sp.set_coefficient(tst, eps_field(x, d), d)
    st = sr.prepare_coefficient(st)
    sp.prepare_coefficient(tst)
    rng = np.random.default_rng(seed)
    for lvl in sr.levels:
        X, Y, Z = sr.dims[lvl]
        r = rng.normal(size=(Z, Y, X))
        st = sr.set_interior(st, lvl, "rhs", jnp.asarray(r))
        sp.set_interior(tst, lvl, "rhs", r)
    return st, tst


def assert_states_close(sr, jstate, sp, tstate, items, mult=256):
    for lvl, keys in items:
        for k in keys:
            close(sp.interior(tstate, lvl, k).numpy(),
                  sr.interior(jstate, lvl, k), mult, f"{k}@{lvl}")


@pytest.mark.parametrize("operator", OPS)
def test_make_solver_builds_and_allocates_coefficients(operator):
    sr, sp = solver_pair(operator)
    assert isinstance(port.make_solver(sp.tree, sp.cfg), port.DenseMGSolver)
    assert sp.n_eps == sr.n_eps == N_EPS[operator]
    assert sp._field_keys == sr._field_keys
    st = sp.allocate()
    for k in sp._eps_keys:
        for lvl in sp.levels:
            assert torch.equal(st[k][lvl], torch.ones_like(st[k][lvl]))
    with pytest.raises(ValueError, match="coefficient field"):
        sp.set_coefficient(st, np.ones((16,) * 3), d=sp.n_eps)


@pytest.mark.parametrize("operator", OPS)
def test_lam_is_dropped_where_the_reference_drops_it(operator):
    """vlaplacian ignores the helmholtz parameter, like laplacian."""
    sr, sp = solver_pair(operator, bc_fn=False)
    assert sp._lam(0.4) == float(sr._lam(0.4))
    assert sp._lam(0.4) == (0.0 if operator == "vlaplacian" else 0.4)


@pytest.mark.parametrize("operator", ["vhelmholtz", "ahelmholtz"])
def test_down_leg_matches_reference(operator):
    """smooth(2) + update_coarse, eagerly in both packages, from random
    states with random coefficients on every level."""
    sr, sp = solver_pair(operator)
    st, tst = random_states(sr, sp, 5)
    lam = 0.6
    top = sr.levels[-1]
    st = sr._down_leg(st, top, jnp.asarray(lam, jnp.float64))
    sp._down_leg(tst, top, sp._lam(lam))
    assert_states_close(sr, st, sp, tst, [
        (top, ("phi",)), (top - 1, ("phi", "rhs", "iold", "ires"))])


@pytest.mark.parametrize("operator", OPS)
def test_prepare_coefficient_matches_reference(operator):
    sr, sp = solver_pair(operator)
    st, tst = coefficient_states(sr, sp, 3)
    for k in sr._eps_keys:
        for lvl in sr.levels:
            np.testing.assert_allclose(
                sp.interior(tst, lvl, k).numpy(),
                np.asarray(sr.interior(st, lvl, k)), rtol=0, atol=1e-14,
                err_msg=f"{k}@{lvl}")


def test_prepare_coefficient_outdates_graphs_and_direct():
    """prepare_coefficient swaps no tensor of the state, drops the probed
    coarse solve and outdates every captured CUDA graph (which holds the
    old factorization's and coefficients' addresses)."""
    _, sp = solver_pair("vhelmholtz")
    st = sp.allocate()
    keep = {lvl: t for lvl, t in st["eps0"].items()}
    sp.fas_fmg(st, lam=1.0)
    assert isinstance(sp._direct, dict)
    sp._graphs[("any",)] = None
    epoch = sp._graph_epoch
    sp.prepare_coefficient(st)
    assert sp._direct is None and not sp._graphs
    assert sp._graph_epoch == epoch + 1
    assert all(st["eps0"][lvl] is t for lvl, t in keep.items())


@pytest.mark.parametrize("operator", ["vlaplacian", "ahelmholtz"])
def test_probed_coarse_matrix_matches_reference(operator):
    sr, sp = solver_pair(operator)
    st, tst = coefficient_states(sr, sp, 4)
    sr._eigen_package = lambda A: A
    sp._eigen_package = lambda A: A
    want = sr._build_direct_probe(st)
    got = sp._build_direct_probe(tst)
    assert got.shape == want.shape == (512, 512)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.max(np.abs(want)))


@pytest.fixture(scope="module", params=[
    pytest.param("vlaplacian", marks=pytest.mark.slow),
    pytest.param("vhelmholtz", marks=pytest.mark.slow), "ahelmholtz"])
def cycled(request):
    """Both solvers at 32^3 (direct probe, plane-valued Dirichlet faces,
    so A(0) carries the coefficients), eps_field coefficients and a
    random rhs; one V-cycle and one FMG in each package.  Each operator
    compiles two JAX programs (~10 s): the tier-1 run takes ahelmholtz,
    whose three coefficient fields cover the n_eps = 1 code paths too."""
    operator = request.param
    sr, sp = solver_pair(operator, size=32)
    st, tst = coefficient_states(sr, sp, 8)
    # vlaplacian ignores lam: passing one checks that both drop it
    lam = 0.4
    out = dict(sr=sr, sp=sp, operator=operator)
    for name, cyc in (("vcycle", "fas_vcycle"), ("fmg", "fas_fmg")):
        js, rj = getattr(sr, cyc)({k: dict(v) for k, v in st.items()},
                                  lam=lam)
        ts = convert.state_from_numpy(sp, convert.state_to_numpy(tst))
        ts, rt = getattr(sp, cyc)(ts, lam=lam)
        out[name] = (js, float(rj), ts, float(rt))
    return out


@pytest.mark.parametrize("cycle", ["vcycle", "fmg"])
def test_cycle_matches_reference(cycled, cycle):
    sr, sp = cycled["sr"], cycled["sp"]
    js, rj, ts, rt = cycled[cycle]
    top = sr.levels[-1]
    want = np.asarray(sr.interior(js, top, "phi"))
    got = sp.interior(ts, top, "phi").numpy()
    assert np.max(np.abs(got - want)) <= 1e-13 * np.max(np.abs(want))
    assert abs(rj - rt) <= 1e-12 * max(1.0, abs(rj))
    assert isinstance(sp._direct, dict)


def manufactured(operator, size=32):
    dsz = np.full(3, size)
    tree = port.build_rectangle(3, dsz, 8, 1.0 / dsz, np.zeros(3))
    sd = port.DenseMGSolver(tree, port.MGConfig(operator=operator,
                                                device="cpu"))
    sd.set_bc(0, port.BCType.DIRICHLET, fn=solution)
    st = sd.allocate()
    for d in range(sd.n_eps):
        sd.set_coefficient(st, eps_field(sd.cell_centers(sd.levels[-1]), d),
                           d)
    sd.prepare_coefficient(st)
    for lvl in sd.levels:
        sd.set_interior(st, lvl, "phi", solution(sd.cell_centers(lvl)))
    return sd, st


@pytest.mark.parametrize("operator", ["vhelmholtz", "ahelmholtz"])
def test_manufactured_solution_converges(operator):
    """FMG with the probed direct coarse solve reaches the discrete
    solution of a manufactured variable-coefficient problem
    (tests/test_dense_vcoeff.py:126-160; ahelmholtz contracts slower)."""
    lam = 1.5
    sd, st = manufactured(operator)
    sd.apply_operator(st, lam=lam, out_key="rhs")
    for lvl in sd.levels:
        sd.interior(st, lvl, "phi").zero_()
    st, res0 = sd.fas_fmg(st, lam=lam)
    assert isinstance(sd._direct, dict), "probe direct solve unavailable"
    for _ in range(8 if operator == "ahelmholtz" else 5):
        st, res = sd.fas_fmg(st, lam=lam, have_guess=True)
    top = sd.levels[-1]
    err = np.max(np.abs(sd.interior(st, top, "phi").numpy()
                        - solution(sd.cell_centers(top))))
    assert err < 1e-8, f"solution error {err}"
    assert float(res) < float(res0) * 1e-4


def test_poisson_solver_vcoeff_periodic():
    """The model front end with operator= on a periodic grid:
    coefficients through ps.solver, residuals fall ~7x per FMG or
    better."""
    ps = port.PoissonSolver(3, (16,) * 3, 8, periodic=True,
                            operator="vhelmholtz", device="cpu")
    st = ps._ensure_state()
    x = ps.solver.cell_centers(ps.solver.levels[-1])
    ps.solver.set_coefficient(st, eps_field(x))
    ps.solver.prepare_coefficient(st)
    ps.set_rhs(rhs_fn=solution)
    phi, info = ps.solve(lam=2.0, rtol=1e-9, max_cycles=12)
    r = info["residuals"]
    assert r[-1] < 1e-9 * r[0] and len(r) <= 12
    assert all(b < a / 5 for a, b in zip(r, r[1:]))


def test_state_roundtrip_carries_coefficients():
    sr, sp = solver_pair("ahelmholtz")
    st, tst = random_states(sr, sp, 6)
    back = convert.state_to_numpy(tst)
    assert set(back) == set(sr._field_keys) | {"bc"}
    for k in sr._field_keys:
        for lvl in sr.levels:
            assert np.array_equal(back[k][lvl], np.asarray(st[k][lvl]))
    missing = {k: v for k, v in back.items() if k != "eps2"}
    with pytest.raises(ValueError, match="eps2"):
        convert.state_from_numpy(sp, missing)
    pkg = sr._build_direct_probe(st)
    d = convert.direct_from_numpy(sp, {k: np.asarray(v)
                                       for k, v in pkg.items()})
    assert np.array_equal(d["V"].numpy(), np.asarray(pkg["V"]))
