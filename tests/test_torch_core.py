"""PyTorch package vs the JAX package: tree metadata, BC coefficients,
import hygiene and the gates of what is not ported yet."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import octree_mg_tpu as ref
from octree_mg_tpu.ops.ghost import bc_coeffs as ref_bc_coeffs

import octree_mg_tpu_torch as port
from octree_mg_tpu_torch.core import constants as pconst
from octree_mg_tpu_torch.core.tree import build_amr_centered
from octree_mg_tpu_torch.ops.ghost import bc_coeffs

# The suite runs in several worker processes on a few cores and these
# tensors are small: one intra-op thread per process keeps the
# workers from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_trees_equal(a, b):
    for name in ("ndim", "box_size", "highest_lvl", "lowest_lvl",
                 "first_normal_lvl", "n_boxes", "subtract_mean",
                 "tree_created"):
        assert getattr(a, name) == getattr(b, name), name
    for name in ("periodic", "r_min", "coarsest_grid"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    n = a.n_boxes
    for name in ("ix", "lvl", "parent", "children", "neighbors", "rank"):
        np.testing.assert_array_equal(getattr(a, name)[:n],
                                      getattr(b, name)[:n], err_msg=name)
    for name in ("box_size_lvl", "domain_size_lvl", "dr"):
        da, db = getattr(a, name), getattr(b, name)
        assert sorted(da) == sorted(db), name
        for lvl in da:
            np.testing.assert_array_equal(np.asarray(da[lvl]),
                                          np.asarray(db[lvl]),
                                          err_msg=f"{name}[{lvl}]")
    assert sorted(a.lvls) == sorted(b.lvls)
    for lvl in a.lvls:
        for name in ("ids", "leaves", "parents", "ref_bnds"):
            np.testing.assert_array_equal(getattr(a.lvls[lvl], name),
                                          getattr(b.lvls[lvl], name),
                                          err_msg=f"lvls[{lvl}].{name}")


@pytest.mark.parametrize("periodic", [False, True, (True, False, True)])
@pytest.mark.parametrize("dims,box", [((32, 32, 32), 8), ((64, 16, 32), 16),
                                      ((256, 16, 16), 8)])
def test_build_rectangle_matches_reference(dims, box, periodic):
    per = [periodic] * 3 if isinstance(periodic, bool) else list(periodic)
    dsz = np.array(dims)
    args = (3, dsz, box, 1.0 / dsz, np.array([0.0, -1.0, 2.0]), per)
    assert_trees_equal(port.build_rectangle(*args),
                       ref.build_rectangle(*args))


def test_build_amr_centered_matches_reference():
    """The AMR constructor is part of the copied tree module (numpy path of
    the reference's native-or-numpy pair)."""
    args = (3, 3, (16, 16, 16), 8, np.full(3, 1.0 / 16))
    assert_trees_equal(build_amr_centered(*args),
                       ref.build_amr_centered(*args))


@pytest.mark.parametrize("nb", range(6))
@pytest.mark.parametrize("kind", ["DIRICHLET", "NEUMANN", "CONTINUOUS"])
def test_bc_coeffs_match_reference(kind, nb):
    got = bc_coeffs(getattr(port.BCType, kind), 0.125, nb)
    want = ref_bc_coeffs(getattr(ref.BCType, kind), 0.125, nb)
    assert tuple(got) == tuple(want)


def test_constants_match_reference():
    for name in ("IPHI", "IRHS", "IOLD", "IRES", "NUM_VARS"):
        assert getattr(port, name) == getattr(ref, name)
    assert pconst.NO_BOX == -1 and pconst.PHYS_BOUNDARY == -2
    assert [int(b) for b in port.BCType] == [int(b) for b in ref.BCType]


def test_port_imports_no_jax():
    """Importing the package and chip_smoke pulls in neither JAX nor the
    JAX package (checked in a fresh interpreter, as a set difference so
    that modules preloaded by the environment do not count)."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import octree_mg_tpu_torch, chip_smoke\n"
        "import octree_mg_tpu_torch.ops.dense_kernels\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'jaxlib' or m == 'octree_mg_tpu'\n"
        "             or m.startswith('octree_mg_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'triton' not in new\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _tree3(n=16, box=8, per=False):
    dsz = np.full(3, n)
    return port.build_rectangle(3, dsz, box, 1.0 / dsz, np.zeros(3),
                                [per] * 3)


@pytest.mark.parametrize("case", ["2d", "amr", "jacobi", "cylindrical"])
def test_make_solver_raises_for_what_waits(case):
    """A uniform 2D tree goes to the dense 2D solver, and the 2D forests
    still wait and raise (a 2:1 quadtree with a level over an L, ROADMAP
    A10b); rectangular AMR patches go to the dense-patch AMR solver; a
    uniform 3D tree with the Jacobi smoother or cylindrical geometry is
    no dense path's and goes to the boxed MGSolver, as in the JAX
    package."""
    cfg = port.MGConfig(device="cpu")
    tree = _tree3()
    if case == "2d":
        dsz = np.full(2, 16)
        tree = port.build_rectangle(2, dsz, 8, 1.0 / dsz, np.zeros(2))
        assert type(port.make_solver(tree, cfg)) is port.Dense2DMGSolver
        from octree_mg_tpu_torch.core import tree as ptm
        tree = port.build_rectangle(2, dsz, 4, 1.0 / dsz, np.zeros(2))
        ids = [int(b) for b in tree.lvls[1].ids
               if tree.ix[int(b)][0] <= 2 or tree.ix[int(b)][1] <= 2]
        ptm.add_children_bulk(tree, np.array(ids, np.int64))
        ptm.set_leaves_parents(tree, 1)
        ptm.set_next_level_ids(tree, 1)
        ptm.set_neighbors_lvl(tree, 2)
        ptm.finalize_amr(tree, 2)
        with pytest.raises(NotImplementedError, match="ROADMAP A10b"):
            port.make_solver(tree, cfg)
        return
    elif case == "amr":
        tree = build_amr_centered(3, 2, (16, 16, 16), 8, np.full(3, 1 / 16))
    elif case == "jacobi":
        cfg.smoother = "jacobi"
    else:
        cfg.geometry = "cylindrical"
    if case in ("jacobi", "cylindrical"):
        assert type(port.make_solver(tree, cfg)) is port.MGSolver
        return
    if case == "amr":
        assert type(port.make_solver(tree, cfg)) is port.DenseAMRMGSolver
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.make_solver(tree, cfg)


@pytest.mark.parametrize("op", ["vlaplacian", "vhelmholtz", "ahelmholtz"])
def test_variable_coefficients_raise(op):
    """The variable-coefficient operators build on the dense path (their
    tests are tests/test_torch_vcoeff.py), and the plane-valued
    coefficient ghost synthesis of the AMR patch solver (eps_bc) is
    accepted for them (tests/test_torch_dense_amr.py); what raises is
    eps_bc on a config without coefficient fields."""
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    sv = port.make_solver(_tree3(), port.MGConfig(operator=op, device="cpu"))
    assert isinstance(sv, port.DenseMGSolver) and sv.n_eps in (1, 3)
    c = sv._kcfgs[sv.levels[-1]]
    assert c.eps_bc is None
    e = dk.DenseStencilConfig(c.dims, c.idr2, c.bc, c.periodic, c.dtype,
                              b_const=c.b_const, n_eps=sv.n_eps,
                              eps_bc=[(0.0, 1.0, 0.0)] * 6)
    assert e.eps_bc == [(0.0, 1.0, 0.0)] * 6
    with pytest.raises(ValueError, match="eps_bc"):
        dk.DenseStencilConfig(c.dims, c.idr2, c.bc, c.periodic, c.dtype,
                              b_const=c.b_const,
                              eps_bc=[(0.0, 1.0, 0.0)] * 6)


def test_make_solver_dispatch_and_levels():
    for op in ("laplacian", "helmholtz"):
        sv = port.make_solver(_tree3(32), port.MGConfig(operator=op,
                                                        device="cpu"))
        assert isinstance(sv, port.DenseMGSolver)
    tree_r = ref.build_rectangle(3, np.full(3, 32), 8, np.full(3, 1 / 32),
                                 np.zeros(3))
    sr = ref.make_solver(tree_r, ref.MGConfig())
    assert sv.levels == sr.levels and sv.dims == sr.dims


def test_solve_refined_names_what_is_missing():
    """The refined solve is there (its own tests are
    tests/test_torch_refine.py, tests/test_torch_df32_vcoeff.py and, in
    2D, tests/test_torch_refine2d.py); what is not (a solver with no
    refinement class: the 2D forests') names its ROADMAP item, A10b, a
    float64 solver is told what the refined mode needs, and a
    constant-coefficient solver refuses eps=."""
    ps = port.PoissonSolver(3, (16,) * 3, 8, device="cpu")
    rhs = np.zeros((16,) * 3)
    with pytest.raises(ValueError, match="float32"):
        ps.solve_refined(rhs)
    with pytest.raises(NotImplementedError, match="A10b"):
        port.solve_refined(object(), None, rhs, rhs)
    ps32 = port.PoissonSolver(3, (16,) * 3, 8, dtype=torch.float32,
                              device="cpu")
    ps32.set_dirichlet(0.0)
    with pytest.raises(ValueError, match="eps"):
        port.solve_refined(ps32.solver, None, rhs, rhs, eps=[rhs])
    phi, info = ps32.solve_refined(rhs, n_outer=1)
    assert phi.dtype == np.float64 and not phi.any()
    assert info["residuals"] == [0.0, 0.0]


def test_bcs_may_be_set_after_the_rhs():
    f = lambda x: np.sin(x[..., 0]) + x[..., 1]  # noqa: E731
    g = lambda x: x[..., 2]  # noqa: E731
    a = port.PoissonSolver(3, (16,) * 3, 8, device="cpu")
    a.set_dirichlet(fn=f)
    a.set_rhs(rhs_fn=g)
    b = port.PoissonSolver(3, (16,) * 3, 8, device="cpu")
    b.set_rhs(rhs_fn=g)
    b.set_dirichlet(fn=f)
    assert torch.equal(a.solve(max_cycles=2)[0], b.solve(max_cycles=2)[0])


def test_default_device_is_cuda():
    assert port.MGConfig().device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port.make_solver(_tree3(), port.MGConfig())


def test_cuda_tensor_never_takes_the_plain_version():
    """The wrappers choose by the tensor's device alone: a tensor that
    claims to lie on the card launches the kernel (here: fails to build
    or launch, there being no card) and never runs the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from octree_mg_tpu_torch.ops import dense_kernels as dk

    class FakeCuda:
        is_cuda = True

    cfg = dk.DenseStencilConfig((8, 8, 8), (1.0,) * 3, [(2.0, -1.0, 0.0)] * 6,
                                (False,) * 3, torch.float64,
                                b_const=[0.0] * 6)
    with pytest.raises(Exception):
        dk.restrict_dense(cfg, FakeCuda())
    assert all(v == 0 for v in dk.launch_counts().values())


def test_timers_sections():
    from octree_mg_tpu_torch.utils.timers import Timers
    t = Timers()
    with t.section("a"):
        pass
    with t.section("a", block_on=torch.zeros(1)):
        pass
    t.add("b", 0.5)
    out = t.show()
    assert "a" in out and "b" in out and t._count["a"] == 2
