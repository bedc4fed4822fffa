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
