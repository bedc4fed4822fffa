"""The dense forest's kernel entry points of the PyTorch package (plain
versions, CPU, float64) against the JAX package's functions on the same
numpy inputs: ``half_sweep_dense``, the segment-synthesis bodies of
``pair_sweep_dense``/``stencil_apply_dense`` and the ``corr_ready`` /
set modes of ``prolong_correct_dense``.

The JAX side runs eagerly (its whole-array path: these canvases are
below its Pallas alignment), op by op, so nothing is contracted into an
FMA and the results are compared bit for bit.  The segment bodies are
held against the JAX package's ``_halfsweep``/``_apply_expr`` with its
segment windows over the whole padded array, pads read as zero (what its
Pallas body does in-window, ops/dense_kernels.py:677-686; the port keeps
them zero through a multi-sweep call).  The Pallas bodies themselves, in
interpret mode, are the ``slow`` tests (about a minute each).
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import octree_mg_tpu as ref
from octree_mg_tpu.ops import dense_kernels as jdk

import octree_mg_tpu_torch as port
from octree_mg_tpu_torch import convert
from octree_mg_tpu_torch.core import tree as ptm
from octree_mg_tpu_torch.ops import dense_kernels as dk

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import forest_tree, seg_layer_set  # noqa: E402

torch.set_num_threads(1)

EPS = np.finfo(np.float64).eps
DIMS = (24, 16, 12)
PZ, PY = dk.PZ, dk.PY


def configs(dims, per, bc, b_const):
    idr2 = tuple(float(v) for v in (1.0 / np.array([0.5, 0.25, 0.125])) ** 2)
    return (jdk.DenseStencilConfig(dims, idr2, bc, per, jnp.float64,
                                   b_const=b_const, interpret=True),
            dk.DenseStencilConfig(dims, idr2, bc, per, torch.float64,
                                  b_const=b_const))


def padded_field(rng, dims, nan_pads=False):
    a = rng.normal(size=dk.padded_shape(dims))
    if nan_pads:
        core = a[dk._ISL].copy()
        a[:] = np.nan
        a[dk._ISL] = core
    return a


def planes_for(rng, cfg):
    """Six padded boundary-value planes; on a periodic axis the pads are
    wrapped copies (as the solvers make them: a pad row is a copy of its
    source row and must see that row's boundary values)."""
    X, Y, Z = cfg.dims
    out = []
    for nb in range(6):
        d = nb // 2
        shape, axes, pads = (((Z, Y), (2, 1), (PZ, PY)),
                             ((Z, X), (2, 0), (PZ, 0)),
                             ((Y, X), (1, 0), (PY, 0)))[d]
        vals = rng.normal(size=shape)
        for ax in range(2):
            p1 = [(0, 0), (0, 0)]
            p1[ax] = (pads[ax], pads[ax])
            vals = np.pad(vals, p1, mode="wrap" if cfg.periodic[axes[ax]]
                          else "constant")
        out.append(vals)
    return out


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("kind", ["identity_planes", "dirichlet_periodic_y"])
def test_half_sweep_matches_reference(parity, kind):
    """The forest's sequential kernel: one half-sweep with plane-valued
    faces of identity coefficients (the forest's own configuration), and
    with constant Dirichlet faces and a periodic axis."""
    rng = np.random.default_rng(parity)
    if kind == "identity_planes":
        per, bc, b = (False,) * 3, [(1.0, 0.0, 0.0)] * 6, [None] * 6
    else:
        per, bc, b = (False, True, False), [(2.0, -1.0, 0.0)] * 6, [0.3] * 6
    jc, tc = configs(DIMS, per, bc, b)
    assert not jc.use_kernel            # the reference's whole-array path
    phi, rhs = padded_field(rng, DIMS), padded_field(rng, DIMS)
    if per[1]:
        dk.sync_pads(tc, torch.from_numpy(phi))
        dk.sync_pads(tc, torch.from_numpy(rhs))
    bp = planes_for(rng, tc)
    want = jdk.half_sweep_dense(jc, jnp.asarray(phi), jnp.asarray(rhs),
                                jnp.asarray(0.37), [jnp.asarray(p) for p in bp],
                                parity=parity)
    got = dk.half_sweep_dense(tc, torch.from_numpy(phi), torch.from_numpy(rhs),
                              0.37, [torch.from_numpy(p) for p in bp],
                              parity=parity)
    np.testing.assert_array_equal(got[dk._ISL].numpy(),
                                  np.asarray(want)[dk._ISL])


def test_half_sweep_matches_reference_pallas_body():
    """The same against the JAX package's Pallas body of half_sweep_dense
    (interpret mode): an aligned float64 [256, 16, 16] level
    (tests/test_dense.py's kernel-path size) with plane-valued faces of
    the forest's identity coefficients, parity 1: bit for bit."""
    rng = np.random.default_rng(7)
    dims = (256, 16, 16)
    jc, tc = configs(dims, (False,) * 3, [(1.0, 0.0, 0.0)] * 6, [None] * 6)
    assert jc.use_kernel                # the Pallas body, interpreted
    phi, rhs = padded_field(rng, dims), padded_field(rng, dims)
    bp = planes_for(rng, tc)
    want = np.asarray(jdk.half_sweep_dense(
        jc, jnp.asarray(phi), jnp.asarray(rhs), jnp.asarray(0.37),
        [jnp.asarray(p) for p in bp], parity=1))[dk._ISL]
    got = dk.half_sweep_dense(tc, torch.from_numpy(phi), torch.from_numpy(rhs),
                              0.37, [torch.from_numpy(p) for p in bp],
                              parity=1)[dk._ISL].numpy()
    np.testing.assert_array_equal(got, want)


def test_two_half_sweeps_are_one_pair():
    """half_sweep_dense(parity 0), a pad refresh, half_sweep_dense(parity
    1) is pair_sweep_dense(red_parity 0), bit for bit."""
    rng = np.random.default_rng(5)
    per = (True, True, False)
    _, tc = configs(DIMS, per, [(2.0, -1.0, 0.0)] * 6, [None] * 6)
    phi = dk.sync_pads(tc, torch.from_numpy(padded_field(rng, DIMS)))
    rhs = dk.sync_pads(tc, torch.from_numpy(padded_field(rng, DIMS)))
    bp = [torch.from_numpy(p) for p in planes_for(rng, tc)]
    a = dk.half_sweep_dense(tc, phi, rhs, 0.2, bp, parity=0)
    a = dk.half_sweep_dense(tc, dk.sync_pads(tc, a), rhs, 0.2, bp, parity=1)
    b = dk.pair_sweep_dense(tc, phi, rhs, 0.2, bp, red_parity=0)
    assert torch.equal(a[dk._ISL], b[dk._ISL])


def seg_case(rng, dims, nan_pads, layers="faces_and_middle"):
    """Ghost layers on a canvas (chip_smoke.seg_layer_set: by default both
    canvas faces of each dim and two layers inside; ``both_sides`` readers
    served by a layer on each side; ``max`` MAX_SEGS layers), random
    coefficient planes, masks covering part of each layer."""
    segs = seg_layer_set(dims, layers)
    _, tc = configs(dims, (True,) * 3, [(1.0, 0.0, 0.0)] * 6, [0.0] * 6)
    planes = []
    for d, c, side in segs:
        a = rng.normal(size=dk._seg_plane_shape(tc, d))
        a[3] = rng.random(a.shape[1:]) < 0.7
        planes.append(a)
    return tc, segs, planes, padded_field(rng, dims, nan_pads), \
        padded_field(rng, dims, nan_pads)


def ref_seg(dims, segs, planes, phi, rhs, lam, what, red_parity=0,
            n_pairs=1):
    """The JAX package's segment bodies over the whole padded array,
    the pads read as zero before every half-sweep."""
    jc, _ = configs(dims, (True,) * 3, [(1.0, 0.0, 0.0)] * 6, [0.0] * 6)
    g = jdk._full_iotas(jc)
    masks = jdk._face_masks(jc, g)
    X, Y, Z = dims
    pad = np.ones(dk.padded_shape(dims), bool)
    pad[dk._ISL] = False
    pad = jnp.asarray(pad)
    bcast = {2: lambda w: w[None, :, :], 1: lambda w: w[:, None, :],
             0: lambda w: w[:, :, None]}
    segw = {0: [], 1: [], 2: []}
    for (d, c, side), a in zip(segs, planes):
        segw[d].append((c, side, tuple(bcast[d](jnp.asarray(a[k]))
                                       for k in range(4))))
    bpw = [0.0] * 6
    lam = jnp.asarray(lam, jnp.float64)
    p, r = jnp.asarray(phi), jnp.asarray(rhs)
    zero = lambda a: jnp.where(pad, 0.0, a)      # noqa: E731
    if what == "pairs":
        upd = jdk._parity_mask(g, red_parity)
        for _ in range(n_pairs):
            for red in (True, False):
                p = jdk._halfsweep(jc, zero(p), r, lam, masks, upd, red, bpw,
                                   True, segw=segw, g=g)
        return np.asarray(p)
    out = jdk._apply_expr(jc, zero(p), lam, masks, bpw, True, segw=segw, g=g)
    return np.asarray(r - out if what == "residual" else out)


SEG_KINDS = ("pairs1", "pairs2", "apply", "residual")


@pytest.mark.parametrize("what,layers", [
    pytest.param(w, "faces_and_middle", id=w) for w in SEG_KINDS] + [
    pytest.param(w, k, id=f"{w}-{k}") for k in ("both_sides", "max")
    for w in SEG_KINDS])
def test_seg_bodies_match_reference(what, layers):
    """The segment bodies against the JAX package's, bit for bit; also
    with readers served by a layer on each side (each ghost takes the
    other side's raw value) and with MAX_SEGS layers."""
    rng = np.random.default_rng(len(what))
    tc, segs, planes, phi, rhs = seg_case(rng, DIMS, nan_pads=True,
                                          layers=layers)
    assert layers != "max" or len(segs) == dk.MAX_SEGS
    tp = [torch.from_numpy(a) for a in planes]
    lam = 0.6
    if what.startswith("pairs"):
        n = int(what[-1])
        want = ref_seg(DIMS, segs, planes, phi, rhs, lam, "pairs",
                       n_pairs=n)
        got = dk.pair_sweep_dense(tc, torch.from_numpy(phi),
                                  torch.from_numpy(rhs), lam, None, 0,
                                  n_pairs=n, segs=segs, seg_planes=tp)
    else:
        want = ref_seg(DIMS, segs, planes, phi, rhs, lam, what)
        got = dk.stencil_apply_dense(tc, torch.from_numpy(phi),
                                     torch.from_numpy(rhs), lam, None,
                                     residual=what == "residual", segs=segs,
                                     seg_planes=tp)
    got = got[dk._ISL].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want[dk._ISL])


def test_seg_pairs_chain_exactly():
    """Pads read as zero before every half-sweep: two pairs in one call
    are two single calls, bit for bit (the forest chunks its pairs by
    two on every device); with the default layers, with readers served
    on both sides and with MAX_SEGS layers."""
    rng = np.random.default_rng(11)
    for layers in ("faces_and_middle", "both_sides", "max"):
        tc, segs, planes, phi, rhs = seg_case(rng, DIMS, nan_pads=True,
                                              layers=layers)
        tp = [torch.from_numpy(a) for a in planes]
        args = (torch.from_numpy(rhs), 0.1, None, 0)
        two = dk.pair_sweep_dense(tc, torch.from_numpy(phi), *args,
                                  n_pairs=2, segs=segs, seg_planes=tp)
        one = dk.pair_sweep_dense(tc, torch.from_numpy(phi), *args,
                                  segs=segs, seg_planes=tp)
        one = dk.pair_sweep_dense(tc, one, *args, segs=segs, seg_planes=tp)
        assert torch.equal(two[dk._ISL], one[dk._ISL]), layers


def test_seg_descriptors_are_checked():
    rng = np.random.default_rng(2)
    tc, segs, planes, phi, rhs = seg_case(rng, DIMS, nan_pads=False)
    tp = [torch.from_numpy(a) for a in planes]
    t = torch.from_numpy(phi)
    with pytest.raises(ValueError, match="reader"):
        dk.stencil_apply_dense(tc, t, t, 0.0, None, False,
                               segs=[(0, DIMS[0] - 1, 0)], seg_planes=tp[:1])
    with pytest.raises(ValueError, match="twice"):
        dk.stencil_apply_dense(tc, t, t, 0.0, None, False,
                               segs=segs[:1] * 2, seg_planes=tp[:2])
    with pytest.raises(ValueError, match="seg plane"):
        dk.stencil_apply_dense(tc, t, t, 0.0, None, False, segs=segs[:1],
                               seg_planes=tp[4:5])
    with pytest.raises(ValueError, match="one plane per layer"):
        dk.stencil_apply_dense(tc, t, t, 0.0, None, False, segs=segs[:2],
                               seg_planes=tp[:1])
    # layers made once for the canvas: the same bits as descriptors
    layers = dk.seg_layers(tc, segs, t.device)
    assert torch.equal(
        dk.stencil_apply_dense(tc, t, t, 0.0, None, True, segs=layers,
                               seg_planes=tp),
        dk.stencil_apply_dense(tc, t, t, 0.0, None, True, segs=segs,
                               seg_planes=tp))
    other = dk.DenseStencilConfig((DIMS[0] * 2,) + tuple(DIMS[1:]),
                                  tc.idr2, tc.bc, tc.periodic, tc.dtype,
                                  b_const=tc.b_const)
    with pytest.raises(ValueError, match="canvas"):
        dk.stencil_apply_dense(tc, t, t, 0.0, None, True,
                               segs=dk.seg_layers(other, segs, t.device),
                               seg_planes=tp)


@pytest.mark.parametrize("periodic", [False, True])
def test_set_mode_matches_prolong_set(periodic):
    """prolong_correct_dense(add=False) on a uniform level equals
    prolong_set(with_ring=True) of the port's solver, which equals the
    JAX package's prolong_set (plain XLA there)."""
    dsz = np.array([32, 16, 16])
    args = (3, dsz, 8, 1.0 / dsz, np.zeros(3), [periodic] * 3)
    js = ref.DenseMGSolver(ref.build_rectangle(*args), ref.MGConfig())
    ts = port.DenseMGSolver(port.build_rectangle(*args),
                            port.MGConfig(device="cpu"))
    if not periodic:
        fn = lambda x: np.cos(3 * x[..., 0]) + x[..., 2]   # noqa: E731
        js.set_bc(0, ref.BCType.DIRICHLET, fn=fn)
        ts.set_bc(0, port.BCType.DIRICHLET, fn=fn)
    jst = js.allocate()
    rng = np.random.default_rng(3)
    top = js.levels[-1]
    for lvl in js.levels:
        X, Y, Z = js.dims[lvl]
        jst = js.set_interior(jst, lvl, "phi",
                              jnp.asarray(rng.normal(size=(Z, Y, X))))
    npst = {k: {l: np.asarray(v) for l, v in jst[k].items()}
            for k in ("phi", "rhs", "iold", "ires")}
    npst["bc"] = {l: [np.asarray(p) for p in ps]
                  for l, ps in jst["bc"].items()}
    tst = convert.state_from_numpy(ts, npst)
    want = np.asarray(js.interior(js.prolong_set(jst, top - 1,
                                                 with_ring=True),
                                  top, "phi"))
    phi_c = ts._sync_pads(tst["phi"][top - 1].clone(), top - 1)
    kern = dk.prolong_correct_dense(ts._kcfgs[top - 1], phi_c, None,
                                    tst["phi"][top].clone(),
                                    tst["bc"][top - 1], add=False)
    got = ts.interior(ts.prolong_set(tst, top - 1, with_ring=True), top,
                      "phi").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(kern[dk._ISL].numpy(), want)


def test_corr_ready_mode_is_the_add_mode_of_a_difference():
    """On a fully periodic level (no BC synthesis, only wraps)
    corr_ready with phi_c = a - b is the add mode of (a, b), bit for
    bit."""
    rng = np.random.default_rng(9)
    dims = (8, 8, 8)
    _, tc = configs(dims, (True,) * 3, [(2.0, -1.0, 0.0)] * 6, [0.0] * 6)
    a = dk.sync_pads(tc, torch.from_numpy(padded_field(rng, dims)))
    b = dk.sync_pads(tc, torch.from_numpy(padded_field(rng, dims)))
    fine = torch.from_numpy(padded_field(rng, (16, 16, 16)))
    bp = [torch.zeros(1, 1)] * 6
    want = dk.prolong_correct_dense(tc, a, b, fine.clone(), bp)
    got = dk.prolong_correct_dense(tc, a - b, None, fine.clone(), bp,
                                   corr_ready=True)
    assert torch.equal(got[dk._ISL], want[dk._ISL])


# ---------------------------------------------------------------------------
# the JAX package's Pallas bodies in interpret mode (slow)
# ---------------------------------------------------------------------------

def kernel_tree(pkg, tm, dims):
    return forest_tree(pkg, tm, "slab", dims, 4)


@pytest.mark.slow
@pytest.mark.parametrize("what", ["smooth", "residual"])
def test_seg_path_matches_reference_pallas_body(what):
    """The port's segment path against the JAX package's Pallas segment
    body (interpret mode) on its kernel-sized L tree (64x16x16, box 4):
    within 32 ulp of the field scale on the footprint (the reference's
    own fused-vs-sequential bound; its body zeroes pads once per window
    where the port keeps them zero, which moves garbage cells only)."""
    from octree_mg_tpu.core import tree as rtm
    from octree_mg_tpu.solve.dense_forest import DenseForestMGSolver as RF
    rs = RF(kernel_tree(ref, rtm, (64, 16, 16)), ref.MGConfig())
    ps = port.DenseForestMGSolver(kernel_tree(port, ptm, (64, 16, 16)),
                                  port.MGConfig(device="cpu"))
    rs.set_bc(0, ref.BCType.DIRICHLET, 0.25)
    ps.set_bc(0, port.BCType.DIRICHLET, 0.25)
    top = rs.levels[-1]
    assert rs._seg_desc(top) is not None and ps._seg_desc(top) is not None
    jst = rs.allocate()
    rng = np.random.default_rng(7)
    for lvl in rs.levels:
        X, Y, Z = rs.dims[lvl]
        for k in ("phi", "rhs"):
            jst = rs.set_interior(jst, lvl, k,
                                  jnp.asarray(rng.normal(size=(Z, Y, X))))
    npst = {k: {l: np.asarray(v) for l, v in jst[k].items()}
            for k in ("phi", "rhs", "iold", "ires")}
    npst["bc"] = {l: [np.asarray(p) for p in pl]
                  for l, pl in jst["bc"].items()}
    tst = convert.state_from_numpy(ps, npst)
    lam = jnp.asarray(0.0, jnp.float64)
    if what == "smooth":
        key, w = "phi", rs._smooth(dict(jst), top, 2, lam)
        g = ps._smooth(tst, top, 2, 0.0)
    else:
        key, w = "ires", rs._residual(dict(jst), top, lam)
        g = ps._residual(tst, top, 0.0)
    m = rs.footprint_mask(top)
    w = np.where(m, np.asarray(rs.interior(w, top, key)), 0.0)
    g = np.where(m, ps.interior(g, top, key).numpy(), 0.0)
    assert np.max(np.abs(g - w)) <= 32 * EPS * np.max(np.abs(w))


@pytest.mark.slow
def test_prolong_add_matches_reference_pallas_body():
    """The forest correction through the corr_ready mode against the
    JAX package's Pallas prolongation in that mode (interpret mode) on a
    kernel-eligible window (128x32x32 tree)."""
    from octree_mg_tpu.core import tree as rtm
    from octree_mg_tpu.solve.dense_forest import DenseForestMGSolver as RF
    rs = RF(kernel_tree(ref, rtm, (128, 32, 32)), ref.MGConfig())
    ps = port.DenseForestMGSolver(kernel_tree(port, ptm, (128, 32, 32)),
                                  port.MGConfig(device="cpu"))
    top = rs.levels[-1]
    X, Y, Z = rs.dims[top]
    assert jdk.transfer_tiles((X // 2, Y // 2, Z // 2)) is not None
    rng = np.random.default_rng(1)
    sub = rng.normal(size=(Z // 2 + 2, Y // 2 + 2, X // 2 + 2))
    phi_f = rng.normal(size=dk.padded_shape(rs.dims[top]))
    want = np.asarray(rs._prolong_add(jnp.asarray(sub), jnp.asarray(phi_f)))
    got = ps._prolong_add(torch.from_numpy(sub), torch.from_numpy(phi_f))
    np.testing.assert_allclose(got[dk._ISL].numpy(), want[dk._ISL], rtol=0,
                               atol=64 * EPS * np.max(np.abs(want[dk._ISL])))
