"""The six dense-kernel entry points of the PyTorch package against the
JAX package's, on identical numpy inputs (float64, CPU).

The JAX side runs as its own tests run it: dims (256, 16, 16) are
kernel-eligible, so every call below goes through the Pallas bodies in
interpret mode.  The PyTorch side runs the plain versions (CPU tensors).

Tolerance: ``atol = 64 * eps64 * max|reference|`` per call.  Bitwise
equality is not attainable here: XLA:CPU contracts ``a*b+c`` into an FMA
inside its programs and PyTorch's eager ops round every operation (the
reference's own interpret-mode tests concede ~1 ulp for the same reason,
tests/test_dense.py).  A GSRB update divides an O(idr2)-sized sum by
den0, so one contracted rounding moves a result by about one ulp of the
largest value; 64 leaves room for the 4-sweep chain.  Bitwise equality
is asked where it can hold: kernel against plain version on the GPU
(chip_smoke.py), and fused against unfused within this package (below).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octree_mg_tpu.ops import dense_kernels as jdk
from octree_mg_tpu.ops.ghost import bc_coeffs as ref_bc_coeffs
from octree_mg_tpu import BCType as RefBC

from octree_mg_tpu_torch.ops import dense_kernels as dk

# The suite runs in several worker processes on a few cores and these
# tensors are small: one intra-op thread per process keeps the
# workers from oversubscribing the cores.
torch.set_num_threads(1)

DIMS = (256, 16, 16)       # fine level: fused-downsweep eligible in JAX
DIMS_C = (128, 8, 8)       # its coarse level (prolongation source)
DR = 1.0 / 256
EPS = np.finfo(np.float64).eps

BCS = ("dirichlet", "neumann", "continuous", "planes")
PERS = ((False, False, False), (True, False, True))
LAMS = (0.0, 0.3)
ENTRIES = ("pair1", "pair2", "apply", "residual", "downsweep",
           "residual_restrict", "restrict", "prolong")


def bc_setup(kind):
    if kind == "dirichlet":
        t, b = RefBC.DIRICHLET, [0.5] * 6
    elif kind == "neumann":
        t, b = RefBC.NEUMANN, [0.3] * 6
    elif kind == "continuous":
        t, b = RefBC.CONTINUOUS, [0.0] * 6
    else:
        t, b = RefBC.DIRICHLET, [None] * 6
    return [tuple(ref_bc_coeffs(t, DR, nb)) for nb in range(6)], b


def np_sync(a, dims, per):
    """Periodic pad wrap of a padded numpy field (the solver's job)."""
    X, Y, Z = dims
    PZ, PY = dk.PZ, dk.PY
    if per[2]:
        d = min(PZ, Z)
        a[PZ - d:PZ] = a[Z + PZ - d:Z + PZ]
        a[Z + PZ:Z + PZ + d] = a[PZ:PZ + d]
    if per[1]:
        d = min(PZ, Y)
        a[:, PY - d:PY] = a[:, Y + PY - d:Y + PY]
        a[:, Y + PY:Y + PY + d] = a[:, PY:PY + d]
    return a


def np_planes(rng, dims, per):
    """Six padded boundary-value planes: wrap pads on periodic axes (as
    the solvers make them), zeros elsewhere."""
    X, Y, Z = dims
    out = []
    for nb in range(6):
        d = nb // 2
        shape, axes, pads = (
            ((Z, Y), (2, 1), (dk.PZ, dk.PY)), ((Z, X), (2, 0), (dk.PZ, 0)),
            ((Y, X), (1, 0), (dk.PY, 0)))[d]
        vals = rng.normal(size=shape)
        for ax in range(2):
            p1 = [(0, 0), (0, 0)]
            p1[ax] = (pads[ax], pads[ax])
            vals = np.pad(vals, p1,
                          mode="wrap" if per[axes[ax]] else "constant")
        out.append(vals)
    return out


class Case:
    """One configuration in both packages with shared numpy inputs."""

    def __init__(self, bc_kind, per, lam, seed=0, nan_pads=False):
        rng = np.random.default_rng(seed)
        bc, b_const = bc_setup(bc_kind)
        idr2 = (1.0 / DR ** 2,) * 3
        self.per, self.lam = per, lam
        self.jcfg = jdk.DenseStencilConfig(DIMS, idr2, bc, per, jnp.float64,
                                           b_const=b_const, interpret=True)
        self.jcfg_c = jdk.DenseStencilConfig(DIMS_C, idr2, bc, per,
                                             jnp.float64, b_const=b_const,
                                             interpret=True)
        assert self.jcfg.use_kernel and self.jcfg.fused_down_ok
        self.tcfg = dk.DenseStencilConfig(DIMS, idr2, bc, per, torch.float64,
                                          b_const=b_const)
        self.tcfg_c = dk.DenseStencilConfig(DIMS_C, idr2, bc, per,
                                            torch.float64, b_const=b_const)

        def field(dims):
            a = rng.normal(size=dk.padded_shape(dims))
            if nan_pads:
                core = a[dk._ISL].copy()
                a[:] = np.nan
                a[dk._ISL] = core
            return np_sync(a, dims, per)

        self.phi, self.rhs = field(DIMS), field(DIMS)
        self.phi_c, self.iold_c = field(DIMS_C), field(DIMS_C)
        self.planes = np_planes(rng, DIMS, per)
        self.planes_c = np_planes(rng, DIMS_C, per)

    def run_ref(self, entry):
        c, lam = self.jcfg, jnp.asarray(self.lam, jnp.float64)
        phi, rhs = jnp.asarray(self.phi), jnp.asarray(self.rhs)
        bp = [jnp.asarray(p) for p in self.planes]
        if entry in ("pair1", "pair2"):
            out = jdk.pair_sweep_dense(c, phi, rhs, lam, bp, 0,
                                       n_pairs=int(entry[-1]))
        elif entry in ("apply", "residual"):
            out = jdk.stencil_apply_dense(c, phi, rhs, lam, bp,
                                          entry == "residual")
        elif entry == "downsweep":
            out = jdk.downsweep_dense(c, phi, rhs, lam, bp, 0)
        elif entry == "residual_restrict":
            out = jdk.residual_restrict_dense(c, phi, rhs, lam, bp)
        elif entry == "restrict":
            out = jdk.restrict_dense(c, phi)
        else:
            out = jdk.prolong_correct_dense(
                self.jcfg_c, jnp.asarray(self.phi_c),
                jnp.asarray(self.iold_c), phi,
                [jnp.asarray(p) for p in self.planes_c])
        out = out if isinstance(out, tuple) else (out,)
        return [np.asarray(o)[dk._ISL] for o in out]

    def run_port(self, entry):
        c, lam = self.tcfg, self.lam
        phi, rhs = torch.from_numpy(self.phi.copy()), torch.from_numpy(
            self.rhs.copy())
        bp = [torch.from_numpy(p.copy()) for p in self.planes]
        if entry in ("pair1", "pair2"):
            out = dk.pair_sweep_dense(c, phi, rhs, lam, bp, 0,
                                      n_pairs=int(entry[-1]))
        elif entry in ("apply", "residual"):
            out = dk.stencil_apply_dense(c, phi, rhs, lam, bp,
                                         entry == "residual")
        elif entry == "downsweep":
            out = dk.downsweep_dense(c, phi, rhs, lam, bp, 0)
        elif entry == "residual_restrict":
            out = dk.residual_restrict_dense(c, phi, rhs, lam, bp)
        elif entry == "restrict":
            out = dk.restrict_dense(c, phi)
        else:
            out = dk.prolong_correct_dense(
                self.tcfg_c, torch.from_numpy(self.phi_c.copy()),
                torch.from_numpy(self.iold_c.copy()), phi,
                [torch.from_numpy(p.copy()) for p in self.planes_c])
        out = out if isinstance(out, tuple) else (out,)
        return [o[dk._ISL].numpy() for o in out]


def check(case, entry):
    want, got = case.run_ref(entry), case.run_port(entry)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.shape == g.shape
        atol = 64 * EPS * np.max(np.abs(w))
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=entry)


# The tier-1 selection: every entry point once, under six configurations
# that between them cover every BC kind, both periodic settings and both
# lam (each JAX interpret-mode call costs one to two seconds, and the
# tier-1 run is close to its time limit).  The full product is `slow`.
_ROT = [("dirichlet", PERS[0], 0.3), ("neumann", PERS[1], 0.0),
        ("continuous", PERS[0], 0.0), ("planes", PERS[0], 0.3),
        ("planes", PERS[1], 0.0), ("dirichlet", (True, True, True), 0.3)]
_FAST = [(e, *_ROT[i % len(_ROT)]) for i, e in enumerate(ENTRIES)]


@pytest.mark.parametrize("entry,bc,per,lam", _FAST)
def test_entry_point_matches_reference(entry, bc, per, lam):
    check(Case(bc, per, lam, seed=1), entry)


@pytest.mark.slow
@pytest.mark.parametrize("entry,bc,per,lam", [
    c for c in itertools.product(ENTRIES, BCS, PERS + ((True, True, True),),
                                 LAMS) if c not in set(_FAST)])
def test_entry_point_matches_reference_full(entry, bc, per, lam):
    check(Case(bc, per, lam, seed=2), entry)


# -- within the PyTorch package (no JAX, cheap) ------------------------------

@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("bc,per", [("dirichlet", PERS[0]),
                                    ("planes", PERS[1]),
                                    ("neumann", (False, True, False))])
def test_nan_pads_never_reach_the_interior(entry, bc, per):
    """Pads are garbage by contract: with every pad NaN (periodic pads
    hold their wrapped copies) each entry point returns the same finite
    interior as with random pads."""
    clean = Case(bc, per, 0.3, seed=3, nan_pads=False)
    dirty = Case(bc, per, 0.3, seed=3, nan_pads=True)
    for a, b in zip(clean.run_port(entry), dirty.run_port(entry)):
        assert np.isfinite(b).all()
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bc,per", [("dirichlet", PERS[0]),
                                    ("planes", PERS[1]),
                                    ("continuous", (True, True, True))])
def test_double_pair_is_two_synced_single_pairs(bc, per):
    case = Case(bc, per, 0.3, seed=4)
    c = case.tcfg
    phi, rhs = torch.from_numpy(case.phi), torch.from_numpy(case.rhs)
    bp = [torch.from_numpy(p) for p in case.planes]
    two = dk.pair_sweep_dense(c, phi, rhs, 0.3, bp, 0, n_pairs=2)
    mid = dk.pair_sweep_dense(c, phi, rhs, 0.3, bp, 0, n_pairs=1)
    one = dk.pair_sweep_dense(c, dk.sync_pads(c, mid), rhs, 0.3, bp, 0)
    assert torch.equal(two[dk._ISL], one[dk._ISL])


@pytest.mark.parametrize("bc,per", [("neumann", PERS[0]),
                                    ("planes", (True, True, True))])
def test_downsweep_is_its_separate_phases(bc, per):
    """Fused down-leg == pairs, residual, two restrictions, bitwise."""
    case = Case(bc, per, 0.3, seed=5)
    c = case.tcfg
    phi, rhs = torch.from_numpy(case.phi), torch.from_numpy(case.rhs)
    bp = [torch.from_numpy(p) for p in case.planes]
    p_f, pc_f, rc_f = dk.downsweep_dense(c, phi, rhs, 0.3, bp, 0)
    p_s = dk.sync_pads(c, dk.pair_sweep_dense(c, phi, rhs, 0.3, bp, 0,
                                              n_pairs=2))
    res = dk.stencil_apply_dense(c, p_s, rhs, 0.3, bp, True)
    for a, b in ((p_f, p_s), (pc_f, dk.restrict_dense(c, p_s)),
                 (rc_f, dk.restrict_dense(c, res))):
        assert torch.equal(a[dk._ISL], b[dk._ISL])
    pc_u, rc_u = dk.residual_restrict_dense(c, phi, rhs, 0.3, bp)
    res0 = dk.stencil_apply_dense(c, phi, rhs, 0.3, bp, True)
    assert torch.equal(pc_u[dk._ISL], dk.restrict_dense(c, phi)[dk._ISL])
    assert torch.equal(rc_u[dk._ISL], dk.restrict_dense(c, res0)[dk._ISL])


def test_float32_scalars_round_once():
    """den0 is rounded to the dtype, lam added and the reciprocal taken
    in the dtype; c0*b of a constant face is one double product."""
    c = dk.DenseStencilConfig((8, 8, 8), (3.0, 7.0, 11.0),
                              [(0.1, 1.0, 0.0)] * 6, (False,) * 3,
                              torch.float32, b_const=[0.3] * 6)
    f = np.float32
    assert c.inv_den(0.3) == float(f(1.0) / (f(42.0) + f(0.3)))
    P = dk._params(c, 0.3, [None] * 6)
    assert P.c0b[0] == float(f(0.1 * 0.3))
    assert P.neg_lam == -float(f(0.3))


def test_wrappers_raise_on_bad_input():
    c = dk.DenseStencilConfig((7, 8, 8), (1.0,) * 3, [(2.0, -1.0, 0.0)] * 6,
                              (False,) * 3, torch.float64, b_const=[0.0] * 6)
    a = torch.zeros(c.pshape, dtype=torch.float64)
    with pytest.raises(ValueError, match="even"):
        dk.downsweep_dense(c, a, a, 0.0, [None] * 6, 0)
    with pytest.raises(ValueError, match="odd"):
        dk.restrict_dense(c, a)
    with pytest.raises(ValueError, match="n_pairs"):
        dk.pair_sweep_dense(c, a, a, 0.0, [None] * 6, 0, n_pairs=3)
    with pytest.raises(TypeError):
        dk.DenseStencilConfig((8, 8, 8), (1.0,) * 3, [(2.0, -1.0, 0.0)] * 6,
                              (False,) * 3, torch.float16)
    odd = dk.DenseStencilConfig((8, 5, 8), (1.0,) * 3, [(2.0, -1.0, 0.0)] * 6,
                                (False, True, False), torch.float64,
                                b_const=[0.0] * 6)
    b = torch.zeros(odd.pshape, dtype=torch.float64)
    with pytest.raises(ValueError, match="periodic"):
        dk.pair_sweep_dense(odd, b, b, 0.0, [None] * 6, 0, n_pairs=2)
    dk.pair_sweep_dense(odd, b, b, 0.0, [None] * 6, 0, n_pairs=1)
