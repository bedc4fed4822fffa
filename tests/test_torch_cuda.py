"""Tests of the PyTorch package that need an NVIDIA GPU and nvcc.

    python -m pytest tests/test_torch_cuda.py -q -m cuda

They build the CUDA kernels from ``octree_mg_tpu_torch/csrc`` at first
use and skip, with a reason, on a machine without a CUDA device.  Whether
there is one is decided inside each test, never at import.
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
def test_kernels_equal_plain_versions_bitwise():
    """Every kernel variant against its plain version on CUDA tensors
    (chip_smoke.py's check matrix, small shapes): 0 ulp."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    from octree_mg_tpu_torch.ops import df32 as df
    chip_smoke.phase_checks(dk, df, quick=True)   # SystemExit on a miss


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", range(7))
def test_wide_kernels_equal_plain_versions_bitwise_at_edges(shape, dtype):
    """The double pair and the down-leg (n_pairs 1 and 2; the wide design
    of csrc/stream_wide.cuh) against their plain versions on a level at
    that design's edges (chip_smoke.WIDE_EDGE_SHAPES: ragged big and
    coarse tiles, Y below the tile, extents below the halo, periodic
    double pairs, 16^3, 8^3), the four BC kinds, NaN pads: 0 ulp, and
    every launch counted under its entry point."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    dk.reset_launch_counts()
    rows = chip_smoke.wide_checks(dk, [chip_smoke.WIDE_EDGE_SHAPES[shape]],
                                  (getattr(torch, dtype),))
    assert rows and all(r["max_ulp"] == 0 for r in rows), [
        r for r in rows if r["max_ulp"]][:5]
    counts = dk.launch_counts()
    assert counts["pair_sweep_dense"] == sum(
        r["kernel"].startswith("pairs") for r in rows)
    assert counts["downsweep_dense"] == sum(
        r["kernel"].startswith("downsweep") for r in rows)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("level", ["edge", "large", "odd"])
def test_face_kernels_equal_plain_versions_bitwise(level, dtype):
    """The coefficient kernels of the face-plane designs (n_eps 1 and 3):
    in float32 the double pair and the down-leg (n_pairs 1 and 2,
    csrc/stream_faces.cuh), in both dtypes the apply, the residual and
    the residual-restriction (csrc/apply_faces.cuh), against their plain
    versions on a level with ragged big and coarse tiles
    (chip_smoke.WIDE_EDGE_SHAPES[0]) or on 520x520x264 with x and z
    periodic (WIDE_DOWN_SHAPES[2]), and the apply and the residual on a
    small level with odd extents (ODD_APPLY_SHAPE): the four BC kinds,
    smooth and rough coefficients, NaN pads, 0 ulp, every launch on its
    face-plane design."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    kinds = (chip_smoke.FACE_KINDS if level != "odd" and dtype == "float32"
             else chip_smoke.FACE_KINDS[2:])
    shape = {"edge": chip_smoke.WIDE_EDGE_SHAPES[0],
             "large": chip_smoke.WIDE_DOWN_SHAPES[2],
             "odd": chip_smoke.ODD_APPLY_SHAPE}[level]
    # ten cases (n_eps 1 and 3, five BC and coefficient sets) per kernel:
    # the pair and the down-leg with one and two pairs, the apply, the
    # residual and, on even levels, the residual-restriction
    n_rows = 10 * (2 if level == "odd" else 7 if len(kinds) == 5 else 3)
    dk.reset_launch_counts()
    rows = chip_smoke.face_checks(dk, [shape], kinds, getattr(torch, dtype))
    assert len(rows) == n_rows and all(
        r["max_ulp"] == 0 and r["faces"] for r in rows), [
        r for r in rows if r["max_ulp"] or not r["faces"]][:5]
    counts = dk.launch_counts()
    entry_of = {"pairs": "pair_sweep_dense", "downsweep": "downsweep_dense",
                "apply": "stencil_apply_dense",
                "residual": "stencil_apply_dense",
                "residual_restrict": "residual_restrict_dense"}
    for n_eps in (1, 3):
        for entry in set(entry_of.values()):
            assert counts[dk.faces_name(entry, n_eps)] == sum(
                entry_of[r["kernel"].split("[")[0].rstrip("12")] == entry
                and f"[n_eps={n_eps}]" in r["kernel"] for r in rows), entry


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", range(10))
def test_residual_restriction_equals_plain_version_bitwise(shape, dtype):
    """The constant-coefficient residual-restriction (the face-plane
    apply of csrc/apply_faces.cuh with no coefficients, every launch)
    against its plain version on the wide design's edge levels and the
    520x520x264 ones (chip_smoke.WIDE_EDGE_SHAPES + WIDE_DOWN_SHAPES):
    the four BC kinds, NaN pads, 0 ulp, every launch counted under
    residual_restrict_dense[faces]."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    shapes = chip_smoke.WIDE_EDGE_SHAPES + chip_smoke.WIDE_DOWN_SHAPES
    dk.reset_launch_counts()
    rows = chip_smoke.rr_checks(dk, [shapes[shape]], (getattr(torch, dtype),))
    assert len(rows) == 4 and all(
        r["max_ulp"] == 0 and r["faces"] for r in rows), rows
    counts = dk.launch_counts()
    assert counts["residual_restrict_dense"] == 4
    assert counts[chip_smoke.RR_FACES] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", range(6))
def test_wide_slab_pair_equals_plain_version_bitwise(shape):
    """The float32 slab double pair (n_pairs 1 and 2) on slabs its wide
    design takes (chip_smoke.SLAB_WIDE_SHAPES: 520x520x64, 512x512x64,
    256x256x32, 512x512x8 and 512x512x12): every gate pair, physical and
    periodic z, the four BC kinds, the pads of gated-off faces random and
    every other pad NaN; both gates on also against the ungated kernel:
    0 ulp, every launch counted under pair_sweep_dense[z_gates][wide]."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    dk.reset_launch_counts()
    rows = chip_smoke.slab_wide_checks(
        dk, [chip_smoke.SLAB_WIDE_SHAPES[shape]])
    # 2 z axes x 4 gate pairs x 4 BC kinds x 2 n_pairs, and 4 against the
    # ungated kernel
    assert len(rows) == 68 and all(
        r["max_ulp"] == 0 and r["wide"] for r in rows), [
        r for r in rows if r["max_ulp"] or not r["wide"]][:5]
    counts = dk.launch_counts()
    assert counts[chip_smoke.SLAB_WIDE] == 68
    assert counts["pair_sweep_dense[z_gates]"] == 68


@pytest.mark.cuda
@pytest.mark.parametrize("shape", range(3))
def test_wide_down_leg_equals_plain_version_bitwise_on_a_large_level(shape):
    """The float32 down-leg takes the wide design only on large levels
    (chip_smoke.WIDE_DOWN_SHAPES: 520x520x264, X, Y and the coarse tiles
    ragged; on faces, fully periodic and mixed): n_pairs 1 and 2, the
    four BC kinds, NaN pads, 0 ulp, every launch on the wide design."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    dk.reset_launch_counts()
    rows = chip_smoke.wide_checks(dk, [chip_smoke.WIDE_DOWN_SHAPES[shape]],
                                  (torch.float32,), ("downsweep",))
    assert len(rows) == 8 and all(r["max_ulp"] == 0 for r in rows), [
        r for r in rows if r["max_ulp"]][:5]
    assert all(r["wide"] for r in rows)
    assert dk.launch_counts()["downsweep_dense[wide]"] == 8


@pytest.mark.cuda
def test_solver_on_card_matches_cpu():
    """32^3 float64, two FMGs: the card (kernels) and the CPU (plain
    versions) agree to 1e-11 of max|phi|; they differ only by the
    summation order of the coarse solve's matrix-vector products."""
    need_cuda()
    import octree_mg_tpu_torch as port
    rhs = np.random.default_rng(0).normal(size=(32,) * 3)
    out = {}
    for dev in ("cuda", "cpu"):
        ps = port.PoissonSolver(3, (32,) * 3, 8, device=dev)
        ps.set_dirichlet(0.25)
        ps.set_rhs(arrays={ps.solver.levels[-1]: rhs})
        phi, info = ps.solve(rtol=0.0, max_cycles=2)
        out[dev] = phi.cpu().numpy()
    scale = np.abs(out["cpu"]).max()
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0,
                               atol=1e-11 * scale)


@pytest.mark.cuda
def test_df32_kernel_equals_plain_version_and_float64():
    """The double-float residual kernel: bitwise its plain version (the
    check matrix above has it too), and within the double-float bound of
    the native float64 residual, 50x better than plain float32."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    from octree_mg_tpu_torch.ops import df32 as df
    chip_smoke.phase_df32_exactness(dk, df)   # raises SystemExit on a miss


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["split", "fused"])
def test_refined_solve_on_card_matches_cpu(mode):
    """64^3, eight outers, eager and as CUDA graphs: the norm history
    falls to 1e-10 of its first entry, and the solution agrees with the
    CPU's (plain versions) to 1e-11 of max|x| — both converge to the one
    float64-class solution; the float32 corrections differ by the
    summation order of the coarse solve's matrix-vector products."""
    need_cuda()
    import octree_mg_tpu_torch as port
    rhs = np.random.default_rng(0).normal(size=(64,) * 3)
    out = {}
    for dev in ("cuda", "cpu"):
        ps = port.PoissonSolver(3, (64,) * 3, 16, dtype=torch.float32,
                                device=dev, fmg_mode=mode)
        ps.set_dirichlet(0.0)
        phi, info = ps.solve_refined(rhs, n_outer=8)
        assert info["residuals"][-1] <= 1e-10 * info["residuals"][0]
        out[dev] = phi
    scale = np.abs(out["cpu"]).max()
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0,
                               atol=1e-11 * scale)


@pytest.mark.cuda
def test_eps_fields_on_card_are_checked():
    """A coefficient field of the wrong shape, dtype or device raises on
    the card; nothing falls back to the plain version."""
    need_cuda()
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    cfg = dk.DenseStencilConfig((16, 8, 8), (1.0,) * 3,
                                [(2.0, -1.0, 0.0)] * 6, (False,) * 3,
                                torch.float32, b_const=[0.0] * 6, n_eps=1)
    a = torch.zeros(cfg.pshape, dtype=torch.float32, device="cuda")
    before = dk.launch_counts()
    with pytest.raises(ValueError, match="shape"):
        dk.stencil_apply_dense(cfg, a, a, 0.0, [None] * 6, False,
                               eps=[a[1:]])
    with pytest.raises(TypeError, match="dtype"):
        dk.pair_sweep_dense(cfg, a, a, 0.0, [None] * 6, 0, eps=[a.double()])
    with pytest.raises(ValueError, match="CUDA"):
        dk.downsweep_dense(cfg, a, a, 0.0, [None] * 6, 0, eps=[a.cpu()])
    assert dk.launch_counts() == before
    dk.residual_restrict_dense(cfg, a, a, 0.0, [None] * 6, eps=[a + 1])
    assert dk.launch_counts()["residual_restrict_dense[n_eps=1]"] == \
        before["residual_restrict_dense[n_eps=1]"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("operator", ["vlaplacian", "ahelmholtz"])
def test_vcoeff_solver_on_card_matches_cpu(operator):
    """32^3 float64, two FMGs with smooth coefficients and plane-valued
    Dirichlet faces: card (eps kernels, probed coarse matrix from the
    kernel) and CPU agree to 1e-11 of max|phi|."""
    need_cuda()
    import octree_mg_tpu_torch as port
    rhs = np.random.default_rng(1).normal(size=(32,) * 3)
    out = {}
    for dev in ("cuda", "cpu"):
        ps = port.PoissonSolver(3, (32,) * 3, 8, operator=operator,
                                device=dev)
        ps.set_dirichlet(fn=lambda x: np.sin(3 * x[..., 0]) + x[..., 2])
        sv = ps.solver
        st = ps._ensure_state()
        x = sv.cell_centers(sv.levels[-1])
        for d in range(sv.n_eps):
            sv.set_coefficient(st, 1.0 + 0.5 * np.cos(
                2 * np.pi * (x[..., d] + 0.1 * d)), d)
        sv.prepare_coefficient(st)
        ps.set_rhs(arrays={sv.levels[-1]: rhs})
        phi, info = ps.solve(lam=1.5, rtol=0.0, max_cycles=2)
        out[dev] = phi.cpu().numpy()
    scale = np.abs(out["cpu"]).max()
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0,
                               atol=1e-11 * scale)


@pytest.mark.cuda
def test_fused_vcoeff_after_second_prepare_is_bitwise_eager():
    """fmg_mode="fused" on a vhelmholtz solver: a second
    prepare_coefficient with new values outdates the captured graphs
    (new coarse matrix, same coefficient tensors), and the replays keep
    the eager bits (chip_smoke.py's fused_mode at 512^3 does the same)."""
    need_cuda()
    import octree_mg_tpu_torch as port
    rng = np.random.default_rng(2)
    rhs = rng.normal(size=(64,) * 3)
    e1, e2 = (0.5 + rng.random((64,) * 3) for _ in range(2))
    out = {}
    for mode in ("split", "fused"):
        ps = port.PoissonSolver(3, (64,) * 3, 16, operator="vhelmholtz",
                                dtype=torch.float32, fmg_mode=mode)
        ps.set_dirichlet(0.0)
        sv, st = ps.solver, ps._ensure_state()
        sv.set_coefficient(st, e1)
        sv.prepare_coefficient(st)
        ps.set_rhs(arrays={sv.levels[-1]: rhs})
        snaps = []
        for have in (False, True):
            for _ in range(3):
                sv.fas_fmg(st, lam=1.5, have_guess=have, need_res=False)
        snaps.append(sv.interior(st, sv.levels[-1], "phi").clone())
        sv.set_coefficient(st, e2)
        sv.prepare_coefficient(st)
        for _ in range(3):
            sv.fas_fmg(st, lam=1.5, have_guess=True, need_res=False)
        snaps.append(sv.interior(st, sv.levels[-1], "phi").clone())
        out[mode] = snaps
    for a, b in zip(out["split"], out["fused"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_refined_vcoeff_periodic_on_card_matches_cpu():
    """ahelmholtz refined solve at 32^3, periodic in y and z: the outer
    residual (plain PyTorch) reads periodic pad planes that the kernels
    never write.  Card (eager and graphs) and CPU reach one float64-class
    solution (chip_smoke.py's cpu_agreement runs the same check)."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    import octree_mg_tpu_torch as port
    from octree_mg_tpu_torch.ops import df32 as df
    chip_smoke.refined_vcoeff_periodic(port, df)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["L", "periodic"])
def test_forest_on_card_matches_cpu(kind):
    """The 32^3-base L and periodic forests, float64, three FMGs on the
    card (segment and half-sweep kernels, corr_ready prolongation) and on
    the CPU (plain versions): footprint phi within 1e-11 of max|phi|,
    residuals within 1e-8 relative — the stencils agree bitwise, the
    coarse solve's matrix-vector products sum in another order."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    import octree_mg_tpu_torch as port
    r = chip_smoke.forest_cpu_agreement(port, kinds=(kind,))[
        f"forest_{kind}"]
    assert r["phi_max_rel_diff"] < 1e-11, r
    assert r["residual_max_rel_diff"] < 1e-8, r


@pytest.mark.cuda
def test_forest_kernels_on_card_are_checked():
    """Segment launches check their layers on the card too, count under
    their own names and leave the constant-coefficient counters alone."""
    need_cuda()
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    dims = (16, 8, 8)
    cfg = dk.DenseStencilConfig(dims, (1.0,) * 3, [(1.0, 0.0, 0.0)] * 6,
                                (True,) * 3, torch.float32,
                                b_const=[0.0] * 6)
    a = torch.zeros(cfg.pshape, dtype=torch.float32, device="cuda")
    pl = torch.zeros(dk._seg_plane_shape(cfg, 2), device="cuda")
    before = dk.launch_counts()
    with pytest.raises(ValueError, match="seg plane"):
        dk.stencil_apply_dense(cfg, a, a, 0.0, None, False,
                               segs=[(0, -1, 0)], seg_planes=[pl])
    dk.pair_sweep_dense(cfg, a, a, 0.0, None, 0, n_pairs=2,
                        segs=[(2, -1, 0)], seg_planes=[pl])
    after = dk.launch_counts()
    assert after["pair_sweep_dense[segs]"] == \
        before["pair_sweep_dense[segs]"] + 1
    assert after["pair_sweep_dense"] == before["pair_sweep_dense"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [1, 4, 6])
def test_seg_new_designs_equal_plain_and_old_design_bitwise(shape):
    """The float32 segment pair (1 and 2 pairs), apply and residual on a
    canvas of chip_smoke.SEG_WIDE_SHAPES (x, y and z tails; MAX_SEGS
    layers; readers served on both sides), NaN pads: 0 ulp against the
    plain version and against the old design (-DOMG_SEGWIDE=0), every
    launch counted under the new design's counter."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    before = dk.launch_counts()
    rows = chip_smoke.seg_wide_checks(dk, chip_smoke.old_seg_library(dk),
                                      [chip_smoke.SEG_WIDE_SHAPES[shape]])
    assert len(rows) == 4 and all(
        r["max_ulp"] == 0 and r["new_design"] for r in rows), rows
    after = dk.launch_counts()
    assert after[chip_smoke.SEG_WIDE] - before[chip_smoke.SEG_WIDE] == 2
    assert after[chip_smoke.SEG_FACES] - before[chip_smoke.SEG_FACES] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [1, 3, 4, 5])
def test_slab_new_designs_equal_plain_and_old_design_bitwise(shape):
    """The slab apply, residual and prolongation on a slab of
    chip_smoke.SLAB_APPLY_SHAPES (the sharded 256^3 level's slab and the
    thinnest the face-plane apply's rule takes, 2 planes with ragged
    tiles; the sharded 128^3 level's slab and float64 32^2 x 4, which it
    leaves to stream_kernel.cuh; the pair prolongation takes all four):
    every gate pair, physical and periodic z, the four BC kinds, the pads
    of gated-off faces random and every other pad NaN: 0 ulp against the
    plain version and against the old designs (-DOMG_SLABAP=0), counted
    under the new designs' counters exactly where the rules take the
    slab."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    before = dk.launch_counts()
    rows = chip_smoke.slab_apply_checks(
        dk, chip_smoke.old_slab_library(dk),
        [chip_smoke.SLAB_APPLY_SHAPES[shape]])
    # 2 z axes x 4 gate pairs x 4 BC kinds x 3 kinds
    assert len(rows) == 96 and all(
        r["max_ulp"] == 0 and r["new_design"] == r["want_new"]
        for r in rows), [r for r in rows if r["max_ulp"]
                         or r["new_design"] != r["want_new"]][:5]
    faces = chip_smoke.slab_faces_takes(*chip_smoke.SLAB_APPLY_SHAPES[shape][
        ::2])
    after = dk.launch_counts()
    assert after[chip_smoke.SLAB_FACES] - before[chip_smoke.SLAB_FACES] == \
        (64 if faces else 0)
    assert after[chip_smoke.SLAB_PAIR] - before[chip_smoke.SLAB_PAIR] == 32


@pytest.mark.cuda
def test_sharded_solver_runs_the_new_slab_designs():
    """256^3 over 8 slabs (levels 256 to 32 sharded), float32: the 16 slab
    applies and residuals of a have-guess FMG on the 256^2 x 32 slabs run
    the face-plane apply and those on the smaller slabs stream_kernel.cuh
    (chip_smoke.slab_faces_takes), every slab prolongation (coarse slabs
    128^2 x 16 to 32^2 x 4) runs the pair kernel, and two FMGs stay
    bitwise the single-device solver's."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    import octree_mg_tpu_torch as port
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    rhs = torch.from_numpy(np.random.default_rng(4).normal(size=(256,) * 3))
    sd, ss = chip_smoke.dense_pair(port, 256, 8)
    st_d = chip_smoke.seeded_state(sd, rhs.float().cuda())
    st_s = chip_smoke.seeded_state(ss, rhs.float().cuda())
    hist_d = chip_smoke.run_fmgs(sd, st_d, 2)
    hist_s = chip_smoke.run_fmgs(ss, st_s, 2)
    assert chip_smoke.sharded_vs_single(sd, st_d, hist_d, ss, st_s, hist_s,
                                        "sharded 256^3")["bitwise"]
    _, per_fmg = chip_smoke.timed_fmgs(ss, st_s, 1)
    by = chip_smoke.slab_launches_by_slab(dk, ss, st_s)
    apply_by = by["stencil_apply_dense[z_gates]"]
    assert per_fmg[chip_smoke.SLAB_FACES] == sum(
        n for c, n in apply_by.items() if chip_smoke.slab_faces_takes(
            tuple(int(v) for v in c.split("x")), torch.float32)) == \
        apply_by["256x256x32"] == 16, (per_fmg, by)
    pro = dk.slab_name("prolong_correct_dense")
    assert per_fmg[chip_smoke.SLAB_PAIR] == per_fmg[pro] == sum(
        by[pro].values()) > 0, (per_fmg, by)


@pytest.mark.cuda
def test_flat_half_sweep_kernel_equals_plain_version_bitwise():
    """The boxed solver's half-sweep kernel against its plain version:
    float32/float64, D = 1, 2, 3, nc 2 to 16, 1 to 4096 boxes, lam 0 and
    0.7, both parities (chip_smoke.py's cases): 0 ulp; launches counted."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    dk.reset_launch_counts()
    rows = chip_smoke.flat_cases()
    assert rows and all(r["max_ulp"] == 0 for r in rows)
    assert dk.launch_counts()["half_sweep_flat"] == len(rows)


@pytest.mark.cuda
def test_boxed_solver_on_card_matches_cpu():
    """The sparse periodic tree at base 32, box 4, float64, the kernel
    smoother on: two FMGs on the card and on the CPU agree to 1e-11 of
    max|phi| (residuals 1e-8), and the card ran the kernel."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    import octree_mg_tpu_torch as port
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    dk.reset_launch_counts()
    r = chip_smoke.boxed_cpu_agreement(port)
    assert dk.launch_counts()["half_sweep_flat"] > 0
    assert r["phi_max_rel_diff"] < 1e-11, r
    assert r["residual_max_rel_diff"] < 1e-8, r


@pytest.mark.cuda
def test_slab_kernels_equal_plain_versions_bitwise():
    """The z_gates variants of the pair, apply, residual, prolongation
    and double-float residual kernels against their plain versions
    (chip_smoke.py's slab check matrix, small shapes): 0 ulp, pads of
    gated-off faces as data and every other pad NaN."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    from octree_mg_tpu_torch.ops import df32 as df
    rows = chip_smoke.slab_checks(dk, df, quick=True)
    assert rows and all(r["max_ulp"] == 0 for r in rows), [
        r for r in rows if r["max_ulp"]][:5]


@pytest.mark.cuda
@pytest.mark.parametrize("periodic", [False, True])
def test_sharded_solver_on_card_matches_single_device(periodic):
    """32^3 over 8 slabs on the card: float32, two FMGs, bitwise the
    single-device solver's (Dirichlet; the periodic mean is summed slab
    by slab, 1e-5 of max|phi|); float64, the card against the CPU to
    1e-11 of max|phi|."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    import octree_mg_tpu_torch as port
    rhs = torch.from_numpy(np.random.default_rng(3).normal(size=(32,) * 3))
    sd, ss = chip_smoke.dense_pair(port, 32, 8, periodic=periodic)
    st_d = chip_smoke.seeded_state(sd, rhs)
    st_s = chip_smoke.seeded_state(ss, rhs)
    hist_d = chip_smoke.run_fmgs(sd, st_d, 2)
    hist_s = chip_smoke.run_fmgs(ss, st_s, 2)
    cmp = chip_smoke.sharded_vs_single(sd, st_d, hist_d, ss, st_s, hist_s,
                                       "sharded 32^3")
    assert cmp["bitwise"] or periodic
    phis = {}
    for dev in ("cuda", "cpu"):
        _, sv = chip_smoke.dense_pair(port, 32, 8, periodic=periodic,
                                      dtype=torch.float64, device=dev)
        st = chip_smoke.seeded_state(sv, rhs)
        chip_smoke.run_fmgs(sv, st, 2)
        phis[dev] = sv.interior(st, sv.levels[-1], "phi").cpu().numpy()
    np.testing.assert_allclose(phis["cuda"], phis["cpu"], rtol=0,
                               atol=1e-11 * np.abs(phis["cpu"]).max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [3, 4, 5, 7, 8, 9])
def test_slab_eps_designs_equal_plain_and_old_design_bitwise(shape):
    """The float32 coefficient slab double pair (1 and 2 pairs), apply and
    residual, n_eps 1 and 3, on a slab of chip_smoke.SLAB_EPS_SHAPES (the
    sharded 64^3 level's, the smallest the apply's rule takes; the 32^3
    level's and 64 x 62 x 8, which it leaves to stream_kernel.cuh; a
    single pair's 2-plane edge strip, ragged tiles, an odd level): every
    gate pair, physical and periodic z, the four BC kinds, the pads of
    gated-off faces random (the coefficients' too) and every other pad
    NaN: 0 ulp against the plain version and against the old design
    (-DOMG_SLABEPS=0), counted under the face-plane counters exactly
    where the rules take the slab."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    dims = chip_smoke.SLAB_EPS_SHAPES[shape][0]
    before = dk.launch_counts()
    rows = chip_smoke.slab_eps_checks(
        dk, chip_smoke.old_slab_library(dk, "-DOMG_SLABEPS=0"),
        [chip_smoke.SLAB_EPS_SHAPES[shape]])
    # 2 z axes x 4 gate pairs x 4 BC kinds x 2 n_eps x 4 kinds
    assert len(rows) == 256 and all(
        r["max_ulp"] == 0 and r["new_design"] == r["want_new"]
        for r in rows), [r for r in rows if r["max_ulp"]
                         or r["new_design"] != r["want_new"]][:5]
    after = dk.launch_counts()
    for kind, takes in (("pairs1", True),
                        ("apply", chip_smoke.slab_eps_apply_takes(dims))):
        for n_eps in (1, 3):
            c = chip_smoke.slab_eps_counter(dk, kind, n_eps)
            assert after[c] - before[c] == (64 if takes else 0)


@pytest.mark.cuda
def test_sharded_vcoeff_runs_the_face_plane_slab_designs():
    """vhelmholtz at 128^3 over 8 slabs (levels 128 to 32 sharded),
    float32: every coefficient slab double pair of a have-guess FMG, and
    every apply and residual on the slabs of 128^3 and 64^3 (not on the
    32^2 x 4 ones), runs its face-plane design, and two FMGs stay bitwise
    the single-device solver's."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    import octree_mg_tpu_torch as port
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    rhs = torch.from_numpy(np.random.default_rng(5).normal(size=(128,) * 3))
    sd, ss = chip_smoke.dense_pair(port, 128, 8, operator="vhelmholtz")
    eps = (chip_smoke.smooth_eps(sd, 0, torch.float32),)
    st_d = chip_smoke.seeded_state(sd, rhs.float().cuda(), eps)
    st_s = chip_smoke.seeded_state(ss, rhs.float().cuda(), eps)
    hist_d = chip_smoke.run_fmgs(sd, st_d, 2, 1.5)
    hist_s = chip_smoke.run_fmgs(ss, st_s, 2, 1.5)
    assert chip_smoke.sharded_vs_single(sd, st_d, hist_d, ss, st_s, hist_s,
                                        "sharded vcoeff 128^3")["bitwise"]
    _, per_fmg = chip_smoke.timed_fmgs(ss, st_s, 1, 1.5)
    by = chip_smoke.slab_launches_by_slab(dk, ss, st_s, 1.5)
    pair = dk.slab_name("pair_sweep_dense", 1)
    assert 0 < per_fmg[pair + "[faces]"] == per_fmg[pair], per_fmg
    app = dk.slab_name("stencil_apply_dense", 1)
    assert 0 < per_fmg[app + "[faces]"] == sum(
        n for c, n in by[app].items() if chip_smoke.slab_eps_apply_takes(
            tuple(int(v) for v in c.split("x")))) < per_fmg[app], (per_fmg,
                                                                  by)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [2, 3, 4, 5, 6, 7])
def test_half_sweep_new_design_equals_plain_and_old_design_bitwise(shape):
    """One half-sweep on a canvas of chip_smoke.HALF_SHAPES (the forests'
    64^3 .. 16^3 levels, a thin 2-plane canvas with ragged tiles,
    ragged tiles in every dim, an odd canvas), as given, non-periodic and
    fully periodic: float32 and float64, the four BC kinds and the
    forest's identity planes, both parities, NaN pads: 0 ulp against the
    plain version and against the old design (-DOMG_HALFAF=0), every
    launch counted under half_sweep_dense[march]."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    old = chip_smoke.old_library(dk, "-DOMG_HALFAF=0", (
        ("stencil_sweep", "omg_stencil_sweep"),))["omg_stencil_sweep"]
    before = dk.launch_counts()
    rows = chip_smoke.half_checks(dk, old, [chip_smoke.HALF_SHAPES[shape]])
    assert rows and all(r["max_ulp"] == 0 and r["new_design"]
                        for r in rows), [r for r in rows if r["max_ulp"]
                                         or not r["new_design"]][:5]
    after = dk.launch_counts()
    assert after[chip_smoke.HALF_MARCH] - before[chip_smoke.HALF_MARCH] == \
        len(rows) == after["half_sweep_dense"] - before["half_sweep_dense"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [3, 4, 7, 8, 11, 12])
def test_df32_march_equals_plain_and_old_design_bitwise(shape):
    """The double-float residual on a level or slab of
    chip_smoke.DF32_MARCH_SHAPES (the sharded 64^3 and 32^3 levels'
    slabs, which keep the thread-per-cell kernel; a 1032 x 520 x 32 slab
    with ragged tiles on the z-march; odd extents; slabs with every gate
    pair, physical and periodic z): 0 ulp against the plain version and
    against the old design (-DOMG_DF32MARCH=0), within the double-float
    bound of the float64 residual, counted under its z-march counter
    exactly where the rule takes it."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    from octree_mg_tpu_torch.ops import df32 as df
    before = dk.launch_counts()
    rows = chip_smoke.df32_march_checks(dk, df,
                                        chip_smoke.old_df32_library(dk),
                                        [chip_smoke.DF32_MARCH_SHAPES[shape]])
    assert rows and all(r["max_ulp"] == 0
                        and r["new_design"] == r["want_new"]
                        and r["within_float64_bound"] for r in rows), [
        r for r in rows if r["max_ulp"] or r["new_design"] != r["want_new"]
        or not r["within_float64_bound"]][:5]
    after = dk.launch_counts()
    moved = sum(after[c] - before[c] for c in (chip_smoke.DF32_MARCH,
                                               chip_smoke.DF32_SLAB_MARCH))
    assert moved == sum(r["want_new"] for r in rows)
    launched = sum(after[c] - before[c] for c in (
        "residual_df32_dense", "residual_df32_dense[z_gates]"))
    assert launched == len(rows)


@pytest.mark.cuda
def test_amr_kernel_cases_equal_plain_versions_bitwise():
    """chip_smoke.py's "amr" case kinds (refinement faces with
    plane-valued b and c2 = -0.25, alone and beside constant Dirichlet
    faces) on the small patch shapes, and the AMR solver's region
    correction (the corr_ready mode against ``_prolong_rect`` plus the
    add): 0 ulp, each launch on the design its rule gives."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    import octree_mg_tpu_torch as port
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    rows, _ = chip_smoke.amr_checks(dk, port, quick=True)
    assert rows and all(r["max_ulp"] == 0 for r in rows), [
        r for r in rows if r["max_ulp"]][:5]
    assert all(r["design_as_its_rule_gives"] for r in rows), [
        r for r in rows if not r["design_as_its_rule_gives"]][:5]


@pytest.mark.cuda
def test_amr_solver_on_card_matches_cpu():
    """3-level AMR trees in float64, four operators, three FMGs on the
    card and on the CPU (chip_smoke.phase_amr_cpu_agreement): phi within
    1e-11 of max|phi|, the plain route the same count on both."""
    need_cuda()
    sys.path.insert(0, ROOT)
    import chip_smoke
    import octree_mg_tpu_torch as port
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    chip_smoke.phase_amr_cpu_agreement(port, dk)   # SystemExit on a miss


@pytest.mark.cuda
def test_eps_bc_config_takes_the_plain_route_on_card():
    """A config with plane-valued coefficient ghosts (eps_bc) on CUDA
    tensors runs the plain versions, counted under ``[eps_bc]`` and never
    as a launch, with the CPU's values (1e-13 of max|ref|)."""
    need_cuda()
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    rb = (0, 3, 5)
    rbc = (0.5, 0.75, -0.25)
    cfg = dk.DenseStencilConfig(
        (16, 8, 12), (256.0, 64.0, 144.0),
        [rbc if nb in rb else (2.0, -1.0, 0.0) for nb in range(6)],
        (False,) * 3, torch.float64,
        b_const=[None if nb in rb else 0.3 for nb in range(6)], n_eps=3,
        eps_bc=[rbc if nb in rb else (0.0, 1.0, 0.0) for nb in range(6)])
    g = torch.Generator().manual_seed(5)
    phi, rhs = (torch.randn(cfg.pshape, generator=g, dtype=torch.float64)
                for _ in range(2))
    eps = [0.5 + torch.rand(cfg.pshape, generator=g, dtype=torch.float64)
           for _ in range(3)]
    planes = [torch.randn(cfg.plane_shape(nb), generator=g,
                          dtype=torch.float64) for nb in range(6)]
    eplanes = [[0.5 + torch.rand(cfg.plane_shape(nb), generator=g,
                                 dtype=torch.float64) if nb in rb else None
                for nb in range(6)] for _ in range(3)]

    def run(dev):
        def to(t):
            return None if t is None else t.to(dev)
        a = (cfg, to(phi), to(rhs), 0.7, [to(p) for p in planes])
        kw = dict(eps=[to(e) for e in eps],
                  eps_planes=[[to(p) for p in row] for row in eplanes])
        return [dk.pair_sweep_dense(*a, 0, n_pairs=2, **kw),
                dk.half_sweep_dense(*a, 1, **kw),
                dk.stencil_apply_dense(*a, True, **kw)]

    want = run("cpu")
    before, plain = dk.launch_counts(), dk.plain_route_counts()
    got = run("cuda")
    after = dk.plain_route_counts()
    assert dk.launch_counts() == before
    assert {k: after[k] - plain[k] for k in after} == {
        "pair_sweep_dense[eps_bc]": 1, "half_sweep_dense[eps_bc]": 1,
        "stencil_apply_dense[eps_bc]": 1}
    for a, b in zip(got, want):
        a, b = a[dk._ISL].cpu(), b[dk._ISL]
        assert float((a - b).abs().max()) <= 1e-13 * float(b.abs().max())
