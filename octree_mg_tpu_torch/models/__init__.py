"""High-level solver model families, as the JAX package's ``models``.

* PoissonSolver — uniform/AMR elliptic solves (Laplacian/Helmholtz and
  variable/anisotropic-coefficient variants) with BC helpers.
* Diffusion drivers — implicit heat-equation stepping (solve.diffusion).
* FreeSpacePoisson3D — FFT-boundary free-space solves (solve.free_space).
"""
from .poisson import PoissonSolver
from ..solve.diffusion import (diffusion_solve, diffusion_solve_vcoeff,
                               diffusion_solve_acoeff)
from ..solve.free_space import (FreeSpacePoisson3D,
                                FreeSpacePoisson3DDense,
                                make_free_space)

__all__ = ["PoissonSolver", "diffusion_solve", "diffusion_solve_vcoeff",
           "diffusion_solve_acoeff", "FreeSpacePoisson3D",
           "FreeSpacePoisson3DDense", "make_free_space"]
