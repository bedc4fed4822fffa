"""The z-slab dense solver of the PyTorch package (ShardedDenseMGSolver,
ShardedRefinedPoisson and the z_gates forms of the entry points they
call) against the JAX package's, and against the port's own
single-device solver.  float64 on the CPU (the double-float residual in
float32); inputs are made with numpy from a seed and handed to both.

Bounds:

* gated plain versions against the JAX package's jnp bodies with
  ``zgates`` (eager ops, one rounding per operation on both sides):
  bitwise;
* the gated prolongation against the JAX Pallas kernel in interpret
  mode, and one whole FMG against the JAX ``ShardedDenseMGSolver`` on
  the 8-device CPU mesh of tests/conftest.py: ``64 * eps64 * max|ref|``
  (XLA:CPU contracts a*b+c into FMAs inside its programs,
  tests/test_dense.py:334-339; the bound of the other port tests);
* sharded against the port's single-device solver: bitwise, except
  where a fully periodic laplacian removes the mean, which the slab
  solver sums slab by slab and the single-device one in one pass
  (``64 * eps64 * max|phi|``, residual rtol 1e-12).

The sharded solver is also held against the JAX one on the periodic,
variable-coefficient and refined paths; those compile larger JAX
programs and are ``slow``.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import octree_mg_tpu as ref
from octree_mg_tpu.ops import dense_kernels as jdk
from octree_mg_tpu.ops import df32 as jdf
from octree_mg_tpu.ops.ghost import bc_coeffs as ref_bc_coeffs
from octree_mg_tpu.solve.dense_shard import \
    ShardedDenseMGSolver as RefSharded
from octree_mg_tpu.solve.refine import \
    ShardedRefinedPoisson as RefShardedRefined

import octree_mg_tpu_torch as port
from octree_mg_tpu_torch import convert
from octree_mg_tpu_torch.ops import dense_kernels as dk
from octree_mg_tpu_torch.ops import df32 as df
from octree_mg_tpu_torch.solve.dense_shard import MIN_LOCAL_Z

torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps
GATES = list(itertools.product((False, True), repeat=2))
SLAB = (8, 6, 4)            # X, Y, Zl of the gated-kernel slab


def solution(x):
    out = 1.0
    for d in range(x.shape[-1]):
        out = out * np.sin(2 * np.pi * 2 * x[..., d])
    return out


def mesh(k=8):
    return Mesh(np.array(jax.devices()[:k]), ("z",))


# ---------------------------------------------------------------------------
# the gated entry points on one slab
# ---------------------------------------------------------------------------

def slab_case(per_z, n_eps, seed, dtype=np.float64, dirichlet=False):
    """One slab's configs in both packages and random padded fields,
    pads included (a gated-off face reads them; both sides read the same
    values wherever they read a pad)."""
    rng = np.random.default_rng(seed)
    X, Y, Z = SLAB
    per = (per_z, per_z, per_z)
    dr = 1.0 / 16
    if dirichlet:
        t, b_const = ref.BCType.DIRICHLET, [0.25] * 6
    else:
        t, b_const = ref.BCType.NEUMANN, [None] * 6
    bc = [tuple(ref_bc_coeffs(t, dr, nb)) for nb in range(6)]
    idr2 = (1.0 / dr ** 2,) * 3
    jt = jnp.float32 if dtype == np.float32 else jnp.float64
    tt = torch.float32 if dtype == np.float32 else torch.float64
    jcfg = jdk.DenseStencilConfig(SLAB, idr2, bc, per, jt, b_const=b_const,
                                  n_eps=n_eps)
    tcfg = dk.DenseStencilConfig(SLAB, idr2, bc, per, tt, b_const=b_const,
                                 n_eps=n_eps)
    pshape = dk.padded_shape(SLAB)
    fields = [rng.normal(size=pshape).astype(dtype) for _ in range(2)]
    eps = [(0.5 + rng.random(pshape)).astype(dtype) for _ in range(n_eps)]
    planes = [rng.normal(size=tcfg.plane_shape(nb)).astype(dtype)
              for nb in range(6)]
    return jcfg, tcfg, fields, eps, planes


def np_sync_y(a, per_y):
    """The y pads of a slab (the JAX package's ``_sync_y``)."""
    Y, PY = SLAB[1], dk.PY
    if per_y:
        d = min(dk.PZ, Y)
        a = a.copy()
        a[:, PY - d:PY] = a[:, Y + PY - d:Y + PY]
        a[:, Y + PY:Y + PY + d] = a[:, PY:PY + d]
    return a


@pytest.mark.parametrize("what", ["pair1", "pair2", "apply", "residual"])
@pytest.mark.parametrize("n_eps", [0, 1, 3])
@pytest.mark.parametrize("per_z", [False, True])
@pytest.mark.parametrize("gates", GATES)
def test_gated_pair_and_apply_match_reference(what, n_eps, per_z, gates):
    jcfg, tcfg, (phi, rhs), eps, planes = slab_case(per_z, n_eps,
                                                    seed=n_eps + 10 * per_z)
    lam = 0.3
    jeps = tuple(jnp.asarray(e) for e in eps)
    jpl = [jnp.asarray(p) for p in planes]
    teps = tuple(torch.from_numpy(e) for e in eps)
    tpl = [torch.from_numpy(p) for p in planes]
    if what.startswith("pair"):
        # two pairs: the y pads re-synced between, the z pads swept on
        want = np.asarray(jdk._pair_jnp(jcfg, jnp.asarray(phi),
                                        jnp.asarray(rhs), lam, jpl, 0,
                                        gates, jeps))
        if what == "pair2":
            want = np.asarray(jdk._pair_jnp(
                jcfg, jnp.asarray(np_sync_y(want, per_z)), jnp.asarray(rhs),
                lam, jpl, 0, gates, jeps))
        got = dk.pair_sweep_dense(tcfg, torch.from_numpy(phi),
                                  torch.from_numpy(rhs), lam, tpl, 0,
                                  n_pairs=int(what[-1]), eps=teps,
                                  z_gates=gates)
    else:
        res = what == "residual"
        want = np.asarray(jdk._apply_jnp(jcfg, jnp.asarray(phi),
                                         jnp.asarray(rhs), lam, jpl, res,
                                         gates, jeps))
        got = dk.stencil_apply_dense(tcfg, torch.from_numpy(phi),
                                     torch.from_numpy(rhs), lam, tpl, res,
                                     eps=teps, z_gates=gates)
    assert np.array_equal(got[dk._ISL].numpy(), want[dk._ISL])


@pytest.mark.parametrize("per_z", [False, True])
@pytest.mark.parametrize("gates", GATES)
def test_gated_residual_df32_matches_reference(per_z, gates):
    jcfg, tcfg, (xhi, rhi), _, _ = slab_case(per_z, 0, seed=3 + per_z,
                                             dtype=np.float32,
                                             dirichlet=True)
    rng = np.random.default_rng(5)
    xlo, rlo = (rng.normal(size=xhi.shape).astype(np.float32) * 2.0 ** -25
                for _ in range(2))
    lam_pair = df.split_lam(0.37)
    want = np.asarray(jdf.residual_df32(
        jcfg, *(jnp.asarray(a) for a in (xhi, xlo, rhi, rlo)),
        z_gates=gates, lam_pair=lam_pair))
    got = df.residual_df32_dense(
        tcfg, *(torch.from_numpy(a) for a in (xhi, xlo, rhi, rlo)),
        lam_pair=lam_pair, z_gates=gates)
    assert np.array_equal(got[dk._ISL].numpy(), want[dk._ISL])


def test_gated_prolongation_matches_reference_kernel():
    """One aligned coarse slab (the JAX kernel's Pallas body, interpret
    mode): its low face reads the pads, its high face synthesizes."""
    rng = np.random.default_rng(21)
    dims_c = (128, 8, 4)
    dr = 1.0 / 256
    bc = [tuple(ref_bc_coeffs(ref.BCType.DIRICHLET, dr, nb))
          for nb in range(6)]
    per = (False,) * 3
    idr2 = (1.0 / dr ** 2,) * 3
    jcfg = jdk.DenseStencilConfig(dims_c, idr2, bc, per, jnp.float64,
                                  b_const=[None] * 6, interpret=True)
    tcfg = dk.DenseStencilConfig(dims_c, idr2, bc, per, torch.float64,
                                 b_const=[None] * 6)
    phi_c, iold_c = (rng.normal(size=dk.padded_shape(dims_c))
                     for _ in range(2))
    phi_f = rng.normal(size=dk.padded_shape(tuple(2 * d for d in dims_c)))
    planes = [rng.normal(size=tcfg.plane_shape(nb)) for nb in range(6)]
    gates = (False, True)
    want = np.asarray(jdk.prolong_correct_dense(
        jcfg, jnp.asarray(phi_c), jnp.asarray(iold_c), jnp.asarray(phi_f),
        [jnp.asarray(p) for p in planes], z_gates=gates))[dk._ISL]
    got = dk.prolong_correct_dense(
        tcfg, torch.from_numpy(phi_c), torch.from_numpy(iold_c),
        torch.from_numpy(phi_f.copy()),
        [torch.from_numpy(p) for p in planes], z_gates=gates)[dk._ISL]
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=64 * EPS * np.abs(want).max())


@pytest.mark.parametrize("n_pairs,gates,per_z", [(1, (True, False), False),
                                                  (2, (False, True), False),
                                                  (2, (False, False), True)])
def test_gated_pair_matches_reference_kernel(n_pairs, gates, per_z):
    """The gated double pair on one aligned slab against the JAX
    package's Pallas body (interpret mode), n_pairs 1 and 2: the face a
    gate turns off, and a periodic z axis, read the pads 2 * n_pairs
    deep."""
    rng = np.random.default_rng(31 + n_pairs)
    dims = (256, 16, 8)
    dr = 1.0 / 256
    bc = [tuple(ref_bc_coeffs(ref.BCType.DIRICHLET, dr, nb))
          for nb in range(6)]
    per = (False, False, per_z)
    idr2 = (1.0 / dr ** 2,) * 3
    jcfg = jdk.DenseStencilConfig(dims, idr2, bc, per, jnp.float64,
                                  b_const=[None] * 6, interpret=True)
    assert jcfg.use_kernel
    tcfg = dk.DenseStencilConfig(dims, idr2, bc, per, torch.float64,
                                 b_const=[None] * 6)
    phi, rhs = (rng.normal(size=dk.padded_shape(dims)) for _ in range(2))
    planes = [rng.normal(size=tcfg.plane_shape(nb)) for nb in range(6)]
    want = np.asarray(jdk.pair_sweep_dense(
        jcfg, jnp.asarray(phi), jnp.asarray(rhs), 0.3,
        [jnp.asarray(p) for p in planes], 0, z_gates=gates,
        n_pairs=n_pairs))[dk._ISL]
    got = dk.pair_sweep_dense(
        tcfg, torch.from_numpy(phi), torch.from_numpy(rhs), 0.3,
        [torch.from_numpy(p) for p in planes], 0, n_pairs=n_pairs,
        z_gates=gates)[dk._ISL]
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=64 * EPS * np.abs(want).max())


@pytest.mark.parametrize("residual,gates", [(False, (True, False)),
                                            (True, (False, True))])
def test_gated_apply_matches_reference_kernel(residual, gates):
    """The gated apply and residual on one aligned slab against the JAX
    package's Pallas body (interpret mode): the face a gate turns off
    reads the pads 1 deep, the other synthesizes its ghost."""
    rng = np.random.default_rng(41 + residual)
    dims = (256, 16, 8)
    dr = 1.0 / 256
    bc = [tuple(ref_bc_coeffs(ref.BCType.DIRICHLET, dr, nb))
          for nb in range(6)]
    per = (False, False, False)
    idr2 = (1.0 / dr ** 2,) * 3
    jcfg = jdk.DenseStencilConfig(dims, idr2, bc, per, jnp.float64,
                                  b_const=[None] * 6, interpret=True)
    assert jcfg.use_kernel
    tcfg = dk.DenseStencilConfig(dims, idr2, bc, per, torch.float64,
                                 b_const=[None] * 6)
    phi, rhs = (rng.normal(size=dk.padded_shape(dims)) for _ in range(2))
    planes = [rng.normal(size=tcfg.plane_shape(nb)) for nb in range(6)]
    want = np.asarray(jdk.stencil_apply_dense(
        jcfg, jnp.asarray(phi), jnp.asarray(rhs), 0.3,
        [jnp.asarray(p) for p in planes], residual,
        z_gates=gates))[dk._ISL]
    got = dk.stencil_apply_dense(
        tcfg, torch.from_numpy(phi), torch.from_numpy(rhs), 0.3,
        [torch.from_numpy(p) for p in planes], residual,
        z_gates=gates)[dk._ISL]
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=64 * EPS * np.abs(want).max())


@pytest.mark.parametrize("counter", [
    "pair_sweep_dense[z_gates][wide]", "residual_restrict_dense[faces]",
    "stencil_apply_dense[z_gates][faces]",
    "prolong_correct_dense[z_gates][pair]",
    "pair_sweep_dense[n_eps=1][z_gates][faces]",
    "stencil_apply_dense[n_eps=1][z_gates][faces]",
    "pair_sweep_dense[n_eps=3][z_gates][faces]",
    "stencil_apply_dense[n_eps=3][z_gates][faces]",
    "half_sweep_dense[march]", "residual_df32_dense[march]",
    "residual_df32_dense[z_gates][march]"])
def test_design_counters_exist_and_cpu_tensors_never_count(counter):
    """The counters of the wide slab double pair, of the
    constant-coefficient residual-restriction and the slab apply on the
    face-plane apply, of the pair slab prolongation, of the coefficient
    slab double pair, apply and residual on the face-plane designs, of one
    half-sweep on the register march and of the double-float residual on
    its z-march (level and slab) exist, each
    once (a coefficient slab launch is named ``[n_eps=k]`` once), and
    calls on CPU tensors (the plain versions) count under no counter."""
    counts = dk.launch_counts()
    assert counter in counts
    assert all(k.count("[n_eps=") <= 1 for k in counts)
    _, tcfg, (phi, rhs), _, planes = slab_case(False, 0, seed=2)
    args = (tcfg, torch.from_numpy(phi), torch.from_numpy(rhs), 0.3,
            [torch.from_numpy(p) for p in planes])
    n_eps = int(counter.split("=")[1][0]) if "n_eps" in counter else 0
    _, ecfg, (ephi, erhs), eps, eplanes = slab_case(False, n_eps, seed=3)
    eargs = (ecfg, torch.from_numpy(ephi), torch.from_numpy(erhs), 0.3,
             [torch.from_numpy(p) for p in eplanes])
    teps = tuple(torch.from_numpy(e) for e in eps)
    before = dk.launch_counts()
    dk.pair_sweep_dense(*args, 0, n_pairs=2, z_gates=(False, True))
    dk.residual_restrict_dense(*args)
    dk.stencil_apply_dense(*args, True, z_gates=(True, False))
    X, Y, Z = tcfg.dims
    dk.prolong_correct_dense(tcfg, args[1], args[2], torch.zeros(
        dk.padded_shape((2 * X, 2 * Y, 2 * Z)), dtype=torch.float64),
        args[4], z_gates=(False, True))
    dk.pair_sweep_dense(*eargs, 0, n_pairs=2, eps=teps, z_gates=(True, False))
    dk.stencil_apply_dense(*eargs, False, eps=teps, z_gates=(False, True))
    dk.half_sweep_dense(*args, parity=1)
    _, fcfg, fields, _, _ = slab_case(False, 0, seed=4, dtype=np.float32,
                                      dirichlet=True)
    x, r = (torch.from_numpy(a) for a in fields)
    df.residual_df32_dense(fcfg, x, x * 2.0 ** -25, r, r * 2.0 ** -25)
    df.residual_df32_dense(fcfg, x, x * 2.0 ** -25, r, r * 2.0 ** -25,
                           z_gates=(True, False))
    assert dk.launch_counts() == before


@pytest.mark.parametrize("what,n_eps,gates", [
    ("pair2", 1, (True, False)), ("residual", 3, (False, True))])
def test_gated_eps_bodies_match_reference_kernel(what, n_eps, gates):
    """The gated coefficient double pair and residual on one aligned slab
    against the JAX package's Pallas eps bodies with z_gates (interpret
    mode): the face a gate turns off reads the pads, phi's and the
    coefficients' (2 * n_pairs deep for the pair), the other synthesizes
    its ghost and pairs its cells' z faces with themselves."""
    rng = np.random.default_rng(51 + n_eps)
    dims = (256, 16, 8)
    dr = 1.0 / 256
    bc = [tuple(ref_bc_coeffs(ref.BCType.DIRICHLET, dr, nb))
          for nb in range(6)]
    per = (False, False, False)
    idr2 = (1.0 / dr ** 2,) * 3
    jcfg = jdk.DenseStencilConfig(dims, idr2, bc, per, jnp.float64,
                                  b_const=[None] * 6, interpret=True,
                                  n_eps=n_eps)
    assert jcfg.use_kernel
    tcfg = dk.DenseStencilConfig(dims, idr2, bc, per, torch.float64,
                                 b_const=[None] * 6, n_eps=n_eps)
    phi, rhs = (rng.normal(size=dk.padded_shape(dims)) for _ in range(2))
    eps = [0.5 + rng.random(dk.padded_shape(dims)) for _ in range(n_eps)]
    planes = [rng.normal(size=tcfg.plane_shape(nb)) for nb in range(6)]
    jargs = (jcfg, jnp.asarray(phi), jnp.asarray(rhs), 0.3,
             [jnp.asarray(p) for p in planes])
    targs = (tcfg, torch.from_numpy(phi), torch.from_numpy(rhs), 0.3,
             [torch.from_numpy(p) for p in planes])
    jeps = tuple(jnp.asarray(e) for e in eps)
    teps = tuple(torch.from_numpy(e) for e in eps)
    if what == "pair2":
        want = jdk.pair_sweep_dense(*jargs, 0, z_gates=gates, n_pairs=2,
                                    eps=jeps)
        got = dk.pair_sweep_dense(*targs, 0, n_pairs=2, eps=teps,
                                  z_gates=gates)
    else:
        want = jdk.stencil_apply_dense(*jargs, True, z_gates=gates,
                                       eps=jeps)
        got = dk.stencil_apply_dense(*targs, True, eps=teps, z_gates=gates)
    want = np.asarray(want)[dk._ISL]
    np.testing.assert_allclose(got[dk._ISL].numpy(), want, rtol=0,
                               atol=64 * EPS * np.abs(want).max())


def test_gates_are_checked():
    _, tcfg, (phi, rhs), _, planes = slab_case(False, 0, seed=1)
    args = (tcfg, torch.from_numpy(phi), torch.from_numpy(rhs), 0.0,
            [torch.from_numpy(p) for p in planes])
    with pytest.raises(ValueError):
        dk.stencil_apply_dense(*args, True, z_gates=(True,))
    with pytest.raises(ValueError):
        dk.pair_sweep_dense(*args, 0, z_gates=(torch.tensor(True), False))
    with pytest.raises(NotImplementedError):
        dk.prolong_correct_dense(tcfg, args[1], None, torch.zeros(
            dk.padded_shape((16, 12, 8)), dtype=torch.float64), args[4],
            add=False, z_gates=(True, False))


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

def pair_of_solvers(size=32, k=8, periodic=False, operator="laplacian",
                    dtype=torch.float64, overlap=True):
    dsz = np.full(3, size)
    tree = port.build_rectangle(3, dsz, 8, 1.0 / dsz, np.zeros(3),
                                periodic=[periodic] * 3)
    mk = dict(operator=operator, device="cpu", dtype=dtype)
    sd = port.DenseMGSolver(tree, port.MGConfig(**mk))
    ss = port.ShardedDenseMGSolver(
        tree, port.MGConfig(**mk, overlap_halo=overlap), n_shards=k)
    if not periodic:
        sd.set_bc(0, port.BCType.DIRICHLET, fn=solution)
        ss.set_bc(0, port.BCType.DIRICHLET, fn=solution)
    return sd, ss


def seeded(solvers, size, seed=7, eps=False):
    """States with the same seeded rhs (and coefficients) on the top."""
    rng = np.random.default_rng(seed)
    rhs = torch.from_numpy(rng.normal(size=(size,) * 3))
    out = []
    for sv in solvers:
        st = sv.allocate()
        top = sv.levels[-1]
        sv.set_interior(st, top, "rhs", rhs)
        if eps:
            x = sv.cell_centers(top)
            for d in range(sv.n_eps):
                sv.set_coefficient(st, torch.from_numpy(
                    1.0 + 0.5 * np.cos(2 * np.pi * (x[..., d] + 0.1 * d))), d)
            sv.prepare_coefficient(st)
        out.append(st)
    return out


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_sharding_decisions_are_the_references(size, k):
    dsz = np.full(3, size)
    rtree = ref.build_rectangle(3, dsz, 8, 1.0 / dsz, np.zeros(3))
    ptree = port.build_rectangle(3, dsz, 8, 1.0 / dsz, np.zeros(3))
    rs = RefSharded(rtree, ref.MGConfig(), mesh=mesh(k))
    ps = port.ShardedDenseMGSolver(ptree, port.MGConfig(device="cpu"),
                                   n_shards=k)
    assert ps.levels == rs.levels
    assert ps.sharded == rs.sharded
    assert any(ps.sharded.values())
    for lvl in ps.levels:
        zl = ps.dims[lvl][2] // k
        assert not ps.sharded[lvl] or zl >= MIN_LOCAL_Z


def ref_pair(size=32, periodic=False, operator="laplacian"):
    dsz = np.full(3, size)
    rtree = ref.build_rectangle(3, dsz, 8, 1.0 / dsz, np.zeros(3),
                                periodic=[periodic] * 3)
    ptree = port.build_rectangle(3, dsz, 8, 1.0 / dsz, np.zeros(3),
                                 periodic=[periodic] * 3)
    rs = RefSharded(rtree, ref.MGConfig(operator=operator), mesh=mesh())
    ps = port.ShardedDenseMGSolver(
        ptree, port.MGConfig(operator=operator, device="cpu"), n_shards=8)
    if not periodic:
        rs.set_bc(0, ref.BCType.DIRICHLET, fn=solution)
        ps.set_bc(0, port.BCType.DIRICHLET, fn=solution)
    return rs, ps


def np_state(rs, st):
    return {k: ({l: [np.asarray(p) for p in v] for l, v in st[k].items()}
                if k == "bc" else {l: np.asarray(a) for l, a in st[k].items()})
            for k in st}


def ref_state(rs, size, seed=7, eps=False):
    rng = np.random.default_rng(seed)
    st = rs.allocate()
    top = rs.levels[-1]
    st = rs.set_interior(st, top, "rhs",
                         jnp.asarray(rng.normal(size=(size,) * 3)))
    if eps:
        x = rs.cell_centers(top)
        for d in range(rs.n_eps):
            st = rs.set_interior(st, top, f"eps{d}", jnp.asarray(
                1.0 + 0.5 * np.cos(2 * np.pi * (x[..., d] + 0.1 * d))))
        st = rs.prepare_coefficient(st)
    return st


def assert_fmg_matches_reference(rs, ps, rst, fmgs=1, lam=0.0):
    pst = convert.state_from_numpy(ps, np_state(rs, rst))
    for i in range(fmgs):
        rst, rres = rs.fas_fmg(rst, lam=lam, have_guess=i > 0)
        pst, pres = ps.fas_fmg(pst, lam=lam, have_guess=i > 0)
    top = rs.levels[-1]
    want = np.asarray(rs.interior(rst, top, "phi"))
    got = ps.interior(pst, top, "phi").numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=64 * EPS * np.abs(want).max())
    np.testing.assert_allclose(float(pres), float(rres), rtol=1e-10)


def test_sharded_fmg_matches_reference():
    """The slice as a whole: one FMG at 32^3 over 8 slabs, Dirichlet."""
    rs, ps = ref_pair()
    assert_fmg_matches_reference(rs, ps, ref_state(rs, 32))


@pytest.mark.slow
def test_sharded_periodic_fmg_matches_reference():
    rs, ps = ref_pair(periodic=True)
    assert_fmg_matches_reference(rs, ps, ref_state(rs, 32), fmgs=2)


@pytest.mark.slow
@pytest.mark.parametrize("operator,lam", [("vlaplacian", 0.0),
                                          ("ahelmholtz", 1.5)])
def test_sharded_vcoeff_fmg_matches_reference(operator, lam):
    rs, ps = ref_pair(operator=operator)
    assert_fmg_matches_reference(rs, ps, ref_state(rs, 32, eps=True),
                                 lam=lam)


@pytest.mark.slow
def test_sharded_refined_matches_reference():
    n = 32
    dsz = np.full(3, n)
    rtree = ref.build_rectangle(3, dsz, 8, 1.0 / dsz, np.zeros(3))
    ptree = port.build_rectangle(3, dsz, 8, 1.0 / dsz, np.zeros(3))
    rs = RefSharded(rtree, ref.MGConfig(dtype=jnp.float32), mesh=mesh())
    ps = port.ShardedDenseMGSolver(
        ptree, port.MGConfig(device="cpu", dtype=torch.float32), n_shards=8)
    rng = np.random.default_rng(3)
    hi, lo = df.split_f64(rng.normal(size=(n,) * 3))
    *_, want, _ = RefShardedRefined(rs).solve(rs.allocate(), hi, lo,
                                              n_outer=4)
    *_, got, _ = port.ShardedRefinedPoisson(ps).solve(ps.allocate(), hi, lo,
                                                      n_outer=4)
    # the norms of float32 FMGs: the reference's compiled cycle contracts
    # FMAs, so each outer's float32 correction differs in the last bits
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < 1e-5 * got[0]


def test_state_round_trip_from_the_reference_layout():
    """A JAX sharded state (random values everywhere, the slab-stacked
    planes included) -> the port -> numpy is the original, sharded and
    replicated levels both."""
    rs, ps = ref_pair()
    rng = np.random.default_rng(2)
    st = np_state(rs, rs.allocate())
    for k in st:
        for lvl in st[k]:
            if k == "bc":
                st[k][lvl] = [rng.normal(size=p.shape) for p in st[k][lvl]]
            else:
                st[k][lvl] = rng.normal(size=st[k][lvl].shape)
    assert ps.sharded[ps.levels[-1]] and not ps.sharded[ps.levels[0]]
    back = convert.state_to_numpy(convert.state_from_numpy(ps, st))
    for k in st:
        for lvl in st[k]:
            if k == "bc":
                for a, b in zip(back[k][lvl], st[k][lvl]):
                    assert np.array_equal(a, b)
            else:
                assert np.array_equal(back[k][lvl], st[k][lvl])
    # the port's own layout is the reference's, plane by plane
    pst = ps.allocate()
    for lvl in ps.levels:
        assert tuple(pst["phi"][lvl].shape) == st["phi"][lvl].shape
        assert [tuple(p.shape) for p in pst["bc"][lvl]] == \
            [p.shape for p in st["bc"][lvl]]


@pytest.mark.parametrize("periodic", [False, True])
def test_sharded_matches_single_device(periodic):
    sd, ss = pair_of_solvers(periodic=periodic)
    st_d, st_s = seeded((sd, ss), 32)
    for i in range(2):
        st_d, rd = sd.fas_fmg(st_d, have_guess=i > 0)
        st_s, rs_ = ss.fas_fmg(st_s, have_guess=i > 0)
    top = sd.levels[-1]
    a = sd.interior(st_d, top, "phi").numpy()
    b = ss.interior(st_s, top, "phi").numpy()
    if periodic:
        # the removed mean is summed slab by slab here, in one pass there
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=64 * EPS * np.abs(a).max())
        np.testing.assert_allclose(float(rs_), float(rd), rtol=1e-12)
    else:
        assert np.array_equal(a, b)
        assert float(rs_) == float(rd)


def test_overlap_halo_is_bitwise_the_exchange_then_sweep_order():
    _, on = pair_of_solvers(size=64, overlap=True)
    _, off = pair_of_solvers(size=64, overlap=False)
    st_on, st_off = seeded((on, off), 64)
    assert on._zl(on.levels[-1]) >= 4
    for i in range(2):
        st_on, r_on = on.fas_fmg(st_on, have_guess=i > 0)
        st_off, r_off = off.fas_fmg(st_off, have_guess=i > 0)
    for lvl in on.levels:
        assert torch.equal(on.interior(st_on, lvl, "phi"),
                           off.interior(st_off, lvl, "phi"))
    assert float(r_on) == float(r_off)


def test_vlaplacian_sharded_matches_single_device():
    sd, ss = pair_of_solvers(operator="vlaplacian")
    st_d, st_s = seeded((sd, ss), 32, eps=True)
    st_d, rd = sd.fas_fmg(st_d)
    st_s, rs_ = ss.fas_fmg(st_s)
    top = sd.levels[-1]
    assert torch.equal(sd.interior(st_d, top, "phi"),
                       ss.interior(st_s, top, "phi"))
    assert float(rs_) == float(rd)


def test_sharded_refined_norms_match_single_device():
    sd, ss = pair_of_solvers(dtype=torch.float32)
    for sv in (sd, ss):
        sv.set_bc(0, port.BCType.DIRICHLET, 0.0)
    rng = np.random.default_rng(3)
    hi, lo = df.split_f64(rng.normal(size=(32,) * 3))
    xd_hi, xd_lo, want, _ = port.solve_refined(sd, sd.allocate(), hi, lo,
                                               n_outer=4)
    xs_hi, xs_lo, got, _ = port.solve_refined(ss, ss.allocate(), hi, lo,
                                              n_outer=4)
    assert got == want
    assert torch.equal(xs_hi, xd_hi) and torch.equal(xs_lo, xd_lo)
    assert got[-1] < 1e-5 * got[0]


def test_what_the_slab_solver_refuses():
    dsz = np.full(3, 32)
    tree = port.build_rectangle(3, dsz, 8, 1.0 / dsz, np.zeros(3))
    with pytest.raises(NotImplementedError, match="A13d"):
        port.ShardedDenseMGSolver(
            tree, port.MGConfig(device="cpu", fmg_mode="fused"), n_shards=8)
    ss = port.ShardedDenseMGSolver(tree, port.MGConfig(device="cpu"),
                                   n_shards=8)
    st = ss.allocate()
    with pytest.raises(ValueError, match="whole V-cycles"):
        ss.fas_vcycle(st, max_lvl=ss.levels[-1] - 1)
    vs = port.ShardedDenseMGSolver(
        tree, port.MGConfig(device="cpu", operator="vlaplacian",
                            dtype=torch.float32), n_shards=8)
    with pytest.raises(ValueError, match="constant coefficients only"):
        port.solve_refined(vs, vs.allocate(), np.zeros((32,) * 3),
                           np.zeros((32,) * 3))
