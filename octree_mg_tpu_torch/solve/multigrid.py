"""Runtime configuration of the FAS multigrid solvers.

The cycle structure follows ``m_multigrid.f90`` of the Fortran
reference: ``fas_vcycle`` / ``fas_fmg`` (:150-243 / :84-147) with the FAS
tau correction in ``update_coarse`` (:347-384), ``correct_children``
(:387-402), the coarse-grid stopping rule (:196-209) and
``subtract_mean`` for fully periodic problems (:245-294).  This module
holds the configuration only; the dense solver that reads it lives in
``solve/dense.py``.  The boxed solver (``MGSolver``) is not part of this
package yet.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class MGConfig:
    """Runtime configuration (the reference's mg_t public fields,
    m_data_structures.f90:250-342)."""

    operator: str = "laplacian"  # laplacian|helmholtz|vlaplacian|vhelmholtz|ahelmholtz
    geometry: str = "cartesian"
    smoother: str = "gsrb"               # gsrb|gs (aliased)
    n_cycle_down: int = 2
    n_cycle_up: int = 2
    max_coarse_cycles: int = 1000
    residual_coarse_abs: float = 1e-8
    residual_coarse_rel: float = 1e-8
    dtype: torch.dtype = torch.float64
    #: where the state lives and the cycle runs.  On "cuda" every phase
    #: goes through the hand-written kernels; "cpu" runs their plain
    #: PyTorch versions (tests, small checks).
    device: str = "cuda"
    #: kept for signature parity with the JAX package; it means nothing
    #: here: the cycle always updates the state dictionaries in place,
    #: so there is nothing to donate
    donate: bool = False
    #: "split": every phase of a cycle is an eager launch (default).
    #: "fused": on the card, ``fas_fmg(need_res=False)`` and the refined
    #: outer iteration each replay one captured CUDA graph (the
    #: counterpart of the JAX package's one-program FMG and outer): the
    #: first call runs eagerly, the second captures, later ones replay.
    #: A capture that fails raises.  CPU states have no graphs and run
    #: the same eager sequence in both modes.
    fmg_mode: str = "split"
    #: coarse-grid solve strategy: "direct" solves the coarsest cycled
    #: level exactly via a precomputed eigenbasis (two small matmuls);
    #: "smooth" is the reference's iterate-to-tolerance loop
    #: (m_multigrid.f90:196-209)
    coarse_solver: str = "direct"
