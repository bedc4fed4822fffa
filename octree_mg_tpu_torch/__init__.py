"""octree_mg_tpu_torch: the PyTorch/CUDA package of octree-mg-tpu.

Geometric FAS multigrid with the capabilities of the octree-mg
Fortran/MPI library (Teunissen & Keppens, CPC 2019), for one NVIDIA
Hopper GPU.  This package holds what has been brought over so far: the
uniform 3D solve on dense levels for the five operators (laplacian,
helmholtz and the variable-coefficient vlaplacian, vhelmholtz,
ahelmholtz; FAS V-cycle and FMG, GSRB pair smoothing, direct eigenbasis
coarse solve, assembled or probed), its f64-class refined mode
(double-float residual around the float32 FMG) and the dense forest
(any 2:1-balanced 3D octree, the five operators; one canvas per
connected component of a level for sparse trees,
``DenseMultiForestMGSolver``; its f64-class refined mode
``RefinedForestPoisson``) and the
dense-patch AMR solver (rectangular AMR patches, the five operators),
whose stencil,
restriction, prolongation and double-float residual passes are CUDA
kernels written by hand (``csrc/``), each beside a plain PyTorch version
that serves CPU tensors; and the boxed solver ``MGSolver`` (ghost-padded
boxes in 1D, 2D and 3D, all five operators, the 2D cylindrical
laplacian, GSRB or Jacobi), which serves what no dense path takes, with
its flat-box half-sweep as a CUDA kernel; and the z-slab dense solver
``ShardedDenseMGSolver`` with its refined mode ``ShardedRefinedPoisson``
(K slabs on one device, the kernels' z_gates variants); and the
free-space and implicit-diffusion drivers over these solvers
(``models``: ``make_free_space``, ``diffusion_solve`` and its
variable-coefficient and anisotropic forms), as the JAX package's
``models`` exports them; and the 2D dense paths, plain torch ops as the
JAX package's are plain XLA: the uniform 2D solver ``Dense2DMGSolver``
(the five operators and the cylindrical laplacian) with its f64-class
refined mode ``RefinedPoisson2D``, and the 2D dense-patch AMR solver
``Dense2DAMRMGSolver``.

It imports ``torch`` and ``numpy`` only.  Entry points run on the GPU
unless the caller passes ``device="cpu"``.
"""

from .core.constants import (BCType, Geometry, Operator, Smoother, IPHI,
                             IRHS, IOLD, IRES, NUM_VARS)
from .core.tree import Tree, box_r_min, build_amr_centered, build_rectangle
from .solve.multigrid import MGConfig, MGExperimental, MGSolver
from .solve.dense import DenseMGSolver, dense_supported, make_solver
from .solve.dense2d import Dense2DMGSolver, dense2d_supported
from .solve.dense_amr import DenseAMRMGSolver, dense_amr_supported
from .solve.dense_amr2d import Dense2DAMRMGSolver, dense_amr2d_supported
from .solve.dense_forest import DenseForestMGSolver, dense_forest_supported
from .solve.dense_multiforest import (DenseMultiForestMGSolver,
                                      dense_multiforest_supported)
from .solve.dense_shard import ShardedDenseMGSolver
from .models.poisson import PoissonSolver
from .solve.refine import (RefinedPoisson, RefinedPoisson2D,
                           ShardedRefinedPoisson, solve_refined)
from .solve.refine_forest import RefinedForestPoisson
from .ops.df32 import df32_ok, df32_ok_2d, df32_vcoeff_ok, split_f64
from .convert import (state_from_numpy, state_to_numpy, direct_from_numpy,
                      df_pair_from_numpy, df_pair_to_numpy,
                      free_space_cache_from_numpy)

__all__ = [
    "BCType", "Geometry", "Operator", "Smoother",
    "IPHI", "IRHS", "IOLD", "IRES", "NUM_VARS",
    "Tree", "build_rectangle", "build_amr_centered", "box_r_min",
    "MGConfig", "MGExperimental", "MGSolver", "DenseMGSolver", "dense_supported", "make_solver",
    "Dense2DMGSolver", "dense2d_supported",
    "DenseAMRMGSolver", "dense_amr_supported",
    "Dense2DAMRMGSolver", "dense_amr2d_supported",
    "DenseForestMGSolver", "dense_forest_supported",
    "DenseMultiForestMGSolver", "dense_multiforest_supported",
    "ShardedDenseMGSolver",
    "PoissonSolver", "RefinedPoisson", "RefinedPoisson2D",
    "RefinedForestPoisson",
    "ShardedRefinedPoisson",
    "solve_refined", "df32_ok", "df32_ok_2d",
    "df32_vcoeff_ok", "split_f64", "state_from_numpy", "state_to_numpy",
    "direct_from_numpy", "df_pair_from_numpy", "df_pair_to_numpy",
    "free_space_cache_from_numpy",
]

__version__ = "0.1.0"
