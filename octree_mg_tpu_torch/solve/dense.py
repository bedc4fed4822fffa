"""Dense-level FAS multigrid solver for uniform (non-AMR) 3D trees.

On a uniform tree every level is one dense rectangular grid; this
solver stores each level as ``[Z+2*PZ, Y+2*PY, X]`` per variable (see
ops/dense_kernels for the pad geometry) and runs the cycle
(``mg_fas_vcycle``/``mg_fas_fmg``, m_multigrid.f90:84-243) with:

* a fused red+black pair kernel per smoothing pair — no materialized
  ghost fills inside the smoother at all (the Fortran reference fills
  after every half-sweep, m_multigrid.f90:412-423);
* one-pass operator/residual application;
* a fused down-leg (smooth + residual + both restrictions in one pass);
* restriction/prolongation kernels with the m_restrict.f90:183-194 /
  m_prolong.f90:159-240 numerics;
* a **direct coarse solve**: the coarsest cycled level's operator is
  assembled into a dense matrix at setup and eigendecomposed, so the
  coarse solve is two small matmuls instead of the reference's
  launch-latency-bound smoothing loop (m_multigrid.f90:196-209).  The
  reference-faithful smooth-to-tolerance loop remains available as
  ``coarse_solver="smooth"``.

Every phase goes through the six entry points of ops/dense_kernels: on a
CUDA state they launch the hand-written kernels on every level, whatever
its size; on a CPU state they run the plain PyTorch versions.

The state is a dictionary of per-level tensors and is updated IN PLACE:
``fas_vcycle``/``fas_fmg`` return the same dictionary they were given (the JAX
package returns a new pytree and donates the old buffers).

Operators: ``laplacian``/``helmholtz`` and the variable-coefficient
``vlaplacian``/``vhelmholtz`` (one coefficient field ``eps0``) and
``ahelmholtz`` (``eps0``..``eps2``, one per direction).  Coefficients
are written with ``set_coefficient`` on the finest level and restricted
down every level by ``prepare_coefficient``; their ghosts are the
reference's Neumann-zero default.  The direct coarse solve then probes
the coarsest level's operator column by column (its matrix depends on
the coefficients).

Gating: 3D cartesian GSRB on uniform trees.  ``make_solver`` routes as
the JAX package does: uniform 3D trees here, uniform 2D trees to the
dense 2D solver (solve/dense2d.py), rectangular AMR patch trees to the
dense-patch AMR solvers (solve/dense_amr.py, solve/dense_amr2d.py), other
2:1-balanced 3D octrees to the dense forests (solve/dense_forest.py,
solve/dense_multiforest.py; all subclasses of this solver), what no
dense path takes to the boxed solver (solve/multigrid.py); the 2D
forests, still to be ported, raise.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.constants import BCType
from ..core.tree import Tree
from ..ops import dense_kernels as dk
from ..ops.ghost import bc_coeffs
from ..utils.timers import Timers
from .multigrid import MGConfig


#: coefficient-field count per operator (m_vlaplacian.f90:17-21,
#: m_ahelmholtz.f90:22-26)
_OP_N_EPS = {"laplacian": 0, "helmholtz": 0,
             "vlaplacian": 1, "vhelmholtz": 1, "ahelmholtz": 3}


def dense_supported(tree: Tree, cfg: MGConfig) -> bool:
    """Whether the dense fast path covers this configuration."""
    return (tree.ndim == 3
            and tree.highest_lvl == 1          # uniform, no AMR
            and cfg.operator in _OP_N_EPS
            and cfg.geometry == "cartesian"
            and cfg.smoother in ("gsrb", "gs"))


def make_solver(tree: Tree, config: Optional[MGConfig] = None):
    """The solver the JAX package's ``make_solver`` would pick, in its
    order (its solve/dense.py:68-98): the dense fast path for a uniform 3D
    tree, the dense 2D path for a uniform 2D one, the dense-patch AMR
    solvers for trees whose levels are nested rectangular patches (3D,
    then 2D), the dense forest for other 2:1-balanced 3D octrees, the 2D
    dense forest, the multi-canvas dense forest for sparse 3D trees and
    its 2D form, and the boxed ``MGSolver`` for what no dense path takes
    (1D, the Jacobi smoother, operators or geometries the dense paths
    reject, fully periodic sparse trees).  The two 2D forests raise,
    naming ROADMAP A10b, where the JAX package would pick them."""
    from .dense2d import Dense2DMGSolver, dense2d_supported
    from .dense_amr import DenseAMRMGSolver, dense_amr_supported
    from .dense_amr2d import Dense2DAMRMGSolver, dense_amr2d_supported
    from .dense_forest import DenseForestMGSolver, dense_forest_supported
    from .dense_forest2d import dense_forest2d_supported
    from .dense_multiforest import (DenseMultiForestMGSolver,
                                    dense_multiforest2d_supported,
                                    dense_multiforest_supported)
    from .multigrid import MGSolver
    cfg = config or MGConfig()
    if dense_supported(tree, cfg):
        return DenseMGSolver(tree, cfg)
    if dense2d_supported(tree, cfg):
        return Dense2DMGSolver(tree, cfg)
    if dense_amr_supported(tree, cfg):
        return DenseAMRMGSolver(tree, cfg)
    if dense_amr2d_supported(tree, cfg):
        return Dense2DAMRMGSolver(tree, cfg)
    if dense_forest_supported(tree, cfg):
        return DenseForestMGSolver(tree, cfg)
    if dense_forest2d_supported(tree, cfg):
        raise NotImplementedError(
            "octree_mg_tpu_torch: the JAX package sends this configuration "
            "to its 2D dense forest (DenseForest2DMGSolver), which waits "
            "for ROADMAP A10b")
    if dense_multiforest_supported(tree, cfg):
        return DenseMultiForestMGSolver(tree, cfg)
    if dense_multiforest2d_supported(tree, cfg):
        raise NotImplementedError(
            "octree_mg_tpu_torch: the JAX package sends this configuration "
            "to its 2D multi-canvas forest (DenseMultiForest2DMGSolver), "
            "which waits for ROADMAP A10b")
    return MGSolver(tree, cfg)


_ISL = (slice(dk.PZ, -dk.PZ), slice(dk.PY, -dk.PY), slice(None))

_FIELD_KEYS = ("phi", "rhs", "iold", "ires")


class _CapturedCycle:
    """One cycle on one state as a CUDA graph (``fmg_mode="fused"``).

    A graph replays fixed launches on fixed addresses, while the eager
    cycle swaps new tensors into the state.  So the captured region ends
    by copying every field that was swapped back into the tensor the
    state held when capture began and restoring the dictionary: a replay
    then reads and writes the same tensors every time, and the state
    never changes identity.  The copies are part of the graph (one
    top-level field per FMG, and the smaller levels).

    Capture launches nothing, so what the wrappers counted during it is
    taken back and added once per replay instead."""

    def __init__(self, solver, state, fn):
        self.epoch = solver._graph_epoch
        self.tensors = {k: dict(state[k]) for k in solver._field_keys}
        self.planes = {lvl: list(p) for lvl, p in state["bc"].items()}
        before = dk.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn()
            for k, per_lvl in self.tensors.items():
                for lvl, t in per_lvl.items():
                    if state[k][lvl] is not t:
                        t.copy_(state[k][lvl])
                        state[k][lvl] = t
        after = dk.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        dk.add_launch_counts({k: -v for k, v in self.launches.items()})

    def matches(self, solver, state) -> bool:
        """Whether ``state`` still holds the tensors this graph is bound
        to (coefficient fields included) and the solver the boundary
        conditions and coarse factorization it was captured with."""
        return (self.epoch == solver._graph_epoch
                and all(state[k][lvl] is t
                        for k, per_lvl in self.tensors.items()
                        for lvl, t in per_lvl.items())
                and all(a is b for lvl, ps in self.planes.items()
                        for a, b in zip(state["bc"][lvl], ps)))

    def replay(self):
        """Run the cycle; returns what the captured function returned
        (tensors that the next replay overwrites)."""
        self.graph.replay()
        dk.add_launch_counts(self.launches)
        return self.out


class DenseMGSolver:
    """FAS multigrid on dense uniform levels.

    State:
        {"phi": {lvl: [Z+2*PZ, Y+2*PY, X]}, "rhs": {...}, "iold": {...},
         "ires": {...}, "eps0".."eps{n_eps-1}": {...},
         "bc": {lvl: [6 padded boundary-value planes]}}
    on ``config.device`` in ``config.dtype``, updated in place.
    """

    #: finest level whose cell count is <= this bound becomes the direct
    #: coarse-solve level (matrix size bound)
    DIRECT_MAX_CELLS = 512

    #: support predicate checked at construction (the forest overrides)
    _supported = staticmethod(dense_supported)

    def __init__(self, tree: Tree, config: Optional[MGConfig] = None):
        self.tree = tree
        self.cfg = config or MGConfig()
        cfg = self.cfg
        if not self._supported(tree, cfg):
            raise ValueError(f"{type(self).__name__}: configuration outside "
                             f"its gate ({self._supported.__name__})")
        if cfg.fmg_mode not in ("split", "fused"):
            raise ValueError(f"MGConfig.fmg_mode must be 'split' or 'fused', "
                             f"got {cfg.fmg_mode!r}")
        if cfg.smoother == "gs":
            warnings.warn("lexicographic GS does not vectorize; using "
                          "red-black GS (the reference's gsrb mode)")
            cfg.smoother = "gsrb"
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "MGConfig.device is 'cuda' but no CUDA device is "
                    "available; pass device='cpu' for the plain versions")
            # the two matmuls of the direct coarse solve run in full
            # float32, like every kernel of the cycle
            torch.backends.cuda.matmul.allow_tf32 = False
        self.ndim = tree.ndim
        #: interior slicer into the padded per-level arrays
        self._isl = _ISL
        #: coefficient fields carried by the state as eps0..eps{n-1};
        #: ahelmholtz takes one per dimension (m_ahelmholtz.f90:25)
        self.n_eps = min(_OP_N_EPS[cfg.operator], self.ndim)
        self.subtract_mean = tree.subtract_mean and cfg.operator == "laplacian"
        #: "direct" (default) or "smooth" (reference-faithful loop)
        self.coarse_solver = cfg.coarse_solver
        self.timers = Timers()

        self.periodic = tuple(bool(p) for p in tree.periodic)
        self._build_levels()
        self.bc_spec: List[Dict] = [
            {"type": BCType.DIRICHLET, "value": 0.0, "fn": None}
            for _ in range(2 * self.ndim)]
        self._kcfg_cache: Optional[Dict[int, dk.DenseStencilConfig]] = None
        self._direct = None  # built lazily after BC spec is final
        #: fmg_mode="fused": captured FMGs by (state, lam, have_guess);
        #: an entry is None after the eager first call and a
        #: _CapturedCycle from the second on.  set_bc and
        #: prepare_coefficient outdate them all.
        self._graphs: Dict = {}
        self._graph_epoch = 0

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def _build_levels(self):
        t = self.tree
        all_lvls = list(range(t.lowest_lvl, t.highest_lvl + 1))
        self.dims = {lvl: tuple(int(v) for v in t.domain_size_lvl[lvl])
                     for lvl in all_lvls}  # (X, Y, Z) per tree dim order
        if self.coarse_solver == "direct":
            # coarsest cycled level = finest level small enough to solve
            # directly; levels below it exist in the tree but are unused
            direct = None
            for lvl in all_lvls:  # coarsest -> finest
                if int(np.prod(self.dims[lvl])) <= self.DIRECT_MAX_CELLS:
                    direct = lvl
            if direct is None:
                direct = all_lvls[0]
            self.levels = [l for l in all_lvls if l >= direct]
        else:
            self.levels = all_lvls
        for lvl in self.levels[1:]:
            # restriction halves every extent, and periodic pad rows
            # must carry the parity of their source rows
            if any(d % 2 for d in self.dims[lvl]):
                raise ValueError(f"level {lvl}: odd extent in "
                                 f"{self.dims[lvl]} above the coarsest level")

    def set_bc(self, iv: int, bc_type: BCType, value: float = 0.0,
               nb: Optional[int] = None, fn: Optional[Callable] = None):
        """Physical BCs for phi (mg_subr_bc analogue; dense path only
        carries BCs for the solution variable).  Call before
        ``allocate``: the state's boundary planes are evaluated there."""
        if iv != 0:
            raise ValueError("dense path: BCs apply to phi (iv == 0) only")
        nbs = range(2 * self.ndim) if nb is None else [nb]
        for b in nbs:
            self.bc_spec[b] = {"type": bc_type, "value": value, "fn": fn}
        self._direct = None
        self._kcfg_cache = None
        self._graphs = {}
        self._graph_epoch += 1

    @staticmethod
    def _lvl_of(u) -> int:
        """Real tree level of a level key (an int here; the multi-canvas
        forest uses (lvl, c) unit keys), for per-level tree attributes
        (dr, box size)."""
        return u if isinstance(u, int) else u[0]

    def _unit0(self, lvl):
        """State key of a level's (single) canvas."""
        return lvl

    def _coarse_of(self, u):
        """Key of the coarse level under level key u."""
        return u - 1

    def _bc_static(self, lvl: int):
        """Per-direction (c0,c1,c2) or None on periodic axes."""
        out = []
        dr = self.tree.dr[self._lvl_of(lvl)]
        for nbd in range(2 * self.ndim):
            d = nbd // 2
            if self.periodic[d]:
                out.append(None)
                continue
            spec = self.bc_spec[nbd]
            out.append(bc_coeffs(spec["type"], float(dr[d]), nbd))
        return out

    def _kcfg(self, lvl: int) -> dk.DenseStencilConfig:
        t = self.tree
        idr2 = tuple(float(x) for x in 1.0 / t.dr[lvl] ** 2)
        bc = self._bc_static(lvl)
        bc_full = [c if c is not None else (0.0, 0.0, 0.0) for c in bc]
        # static boundary value per face where it is a constant (the
        # common case; plane-valued faces read a plane)
        b_const = []
        for nbd in range(6):
            spec = self.bc_spec[nbd]
            b_const.append(float(spec["value"]) if spec["fn"] is None
                           else None)
        return dk.DenseStencilConfig(
            dims=self.dims[lvl], idr2=idr2, bc=bc_full,
            periodic=self.periodic, dtype=self.cfg.dtype, b_const=b_const,
            n_eps=self.n_eps)

    @property
    def _kcfgs(self) -> Dict[int, dk.DenseStencilConfig]:
        if self._kcfg_cache is None:
            self._kcfg_cache = {lvl: self._kcfg(lvl) for lvl in self.levels}
        return self._kcfg_cache

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    @property
    def _eps_keys(self) -> Tuple[str, ...]:
        return tuple(f"eps{i}" for i in range(self.n_eps))

    @property
    def _field_keys(self) -> Tuple[str, ...]:
        """All per-level fields of the state."""
        return _FIELD_KEYS + self._eps_keys

    def _pshape(self, dims) -> Tuple[int, ...]:
        """Padded per-level array shape."""
        return dk.padded_shape(dims)

    def _field_shape(self, lvl) -> Tuple[int, ...]:
        """Shape of the state's per-level fields at lvl."""
        return tuple(self._kcfgs[lvl].pshape)

    def _ishape(self, lvl) -> Tuple[int, ...]:
        """Interior array shape (spatial dims reversed, x fastest)."""
        return tuple(int(v) for v in self.dims[lvl][::-1])

    def allocate(self) -> Dict:
        dt, dev = self.cfg.dtype, self.device
        state: Dict = {k: {} for k in self._field_keys}
        state["bc"] = {}
        for lvl in self.levels:
            shape = self._pshape(self.dims[lvl])
            for k in _FIELD_KEYS:
                state[k][lvl] = torch.zeros(shape, dtype=dt, device=dev)
            # coefficient fields default to 1 (harmless harmonic means
            # everywhere; the user overwrites via set_coefficient)
            for k in self._eps_keys:
                state[k][lvl] = torch.ones(shape, dtype=dt, device=dev)
            state["bc"][lvl] = self._eval_bc_planes(lvl)
        return state

    def set_coefficient(self, state, values, d: int = 0,
                        lvl: Optional[int] = None):
        """Write the cell-centred coefficient field eps{d} (the boxed
        path's IVEPS+d variable) on the finest level, or on ``lvl``, in
        place; follow with prepare_coefficient before solving."""
        if not 0 <= d < self.n_eps:
            raise ValueError(f"coefficient field {d}: operator "
                             f"{self.cfg.operator!r} has {self.n_eps}")
        if lvl is None:
            lvl = self.levels[-1]
        return self.set_interior(state, lvl, f"eps{d}", values)

    def prepare_coefficient(self, state):
        """Restrict the coefficient field(s) down every level, in place
        (the reference expects eps present on all levels,
        m_vhelmholtz.f90:7-10; ghost values are synthesized inline by the
        kernels).  Drops the direct coarse factorization — it is probed
        again from the new coarse-level eps on the next solve — and every
        captured CUDA graph, which holds the old factorization's
        addresses."""
        for i in range(self.n_eps):
            key = f"eps{i}"
            for lvl in range(self.levels[-1], self.levels[0], -1):
                # keep the coarse fields' identity (a captured graph
                # holds their addresses); a level may have several
                # canvases (the multi-canvas forest's unit keys)
                coarse = {u: v for u, v in state[key].items()
                          if self._lvl_of(u) == lvl - 1}
                state = self._restrict_into(state, lvl, key)
                for u, v in coarse.items():
                    if state[key][u] is not v:
                        v.copy_(state[key][u])
                        state[key][u] = v
        self._direct = None
        self._graphs = {}
        self._graph_epoch += 1
        return state

    def _bc_plane_shape(self, lvl: int, nb: int) -> Tuple[int, int]:
        """Shape of the state's boundary-value plane of face nb."""
        if self.periodic[nb // 2]:
            return (1, 1)
        return self._kcfgs[lvl].plane_shape(nb)

    def _eval_bc_planes(self, lvl: int) -> List[torch.Tensor]:
        """Boundary-value planes b per direction, padded to match the
        padded fields (mg_phi_bc_store analogue)."""
        t = self.tree
        X, Y, Z = self.dims[lvl]
        dr = t.dr[lvl]
        r0 = t.r_min
        dt, dev = self.cfg.dtype, self.device
        # cell-center coordinate vectors
        cx = r0[0] + (np.arange(X) + 0.5) * dr[0]
        cy = r0[1] + (np.arange(Y) + 0.5) * dr[1]
        cz = r0[2] + (np.arange(Z) + 0.5) * dr[2]
        hi = [r0[d] + self.dims[lvl][d] * dr[d] for d in range(3)]
        out = []
        for nbd in range(6):
            d = nbd // 2
            if self.periodic[d]:
                out.append(torch.zeros((1, 1), dtype=dt, device=dev))
                continue
            spec = self.bc_spec[nbd]
            # face coordinates: on-face position along d, centers across
            if d == 0:
                shape = (Z, Y)
                coords = np.zeros(shape + (3,))
                coords[..., 0] = r0[0] if nbd % 2 == 0 else hi[0]
                coords[..., 1] = cy[None, :]
                coords[..., 2] = cz[:, None]
                pad = ((dk.PZ, dk.PZ), (dk.PY, dk.PY))
            elif d == 1:
                shape = (Z, X)
                coords = np.zeros(shape + (3,))
                coords[..., 1] = r0[1] if nbd % 2 == 0 else hi[1]
                coords[..., 0] = cx[None, :]
                coords[..., 2] = cz[:, None]
                pad = ((dk.PZ, dk.PZ), (0, 0))
            else:
                shape = (Y, X)
                coords = np.zeros(shape + (3,))
                coords[..., 2] = r0[2] if nbd % 2 == 0 else hi[2]
                coords[..., 0] = cx[None, :]
                coords[..., 1] = cy[:, None]
                pad = ((dk.PY, dk.PY), (0, 0))
            if spec["fn"] is not None:
                vals = np.asarray(spec["fn"](coords))
            else:
                vals = np.full(shape, spec["value"])
            # pad axes that are periodic with wrapped values: halo pad
            # rows (copies of wrapped interior rows) must synthesize
            # their BC ghosts from the *source* row's boundary value so
            # they evolve in lockstep with their source rows
            ax_dims = (2, 1) if d == 0 else ((2,) if d == 1 else (1,))
            for ax, dim in enumerate(ax_dims):
                p1 = [(0, 0)] * vals.ndim
                p1[ax] = pad[ax]
                mode = "wrap" if self.periodic[dim] else "constant"
                vals = np.pad(vals, p1, mode=mode)
            out.append(torch.as_tensor(
                np.ascontiguousarray(vals, np.float64)).to(dev, dt))
        return out

    def cell_centers(self, lvl: int) -> np.ndarray:
        """Interior cell-center coordinates [Z, Y, X, 3] (host-side)."""
        t = self.tree
        X, Y, Z = self.dims[lvl]
        dr = t.dr[lvl]
        out = np.zeros((Z, Y, X, 3))
        out[..., 0] = (t.r_min[0] + (np.arange(X) + 0.5) * dr[0])[None, None, :]
        out[..., 1] = (t.r_min[1] + (np.arange(Y) + 0.5) * dr[1])[None, :, None]
        out[..., 2] = (t.r_min[2] + (np.arange(Z) + 0.5) * dr[2])[:, None, None]
        return out

    def set_interior(self, state, lvl, key, values):
        """Write interior values [Z, Y, X] of a variable, in place."""
        values = torch.as_tensor(values)
        state[key][lvl][self._isl] = values.to(self.device, self.cfg.dtype)
        return state

    def interior(self, state, lvl, key):
        """Interior view [Z, Y, X] of a variable (shares memory)."""
        return state[key][lvl][self._isl]

    # ------------------------------------------------------------------
    # building blocks
    # ------------------------------------------------------------------
    def _sync_pads(self, arr, lvl):
        """Periodic wrap maintenance of the z/y pad planes, in place (x
        wraps are exact rolls / wrapped indices).  No-op on non-periodic
        axes.  The plain versions read these pads; the CUDA kernels read
        wrapped indices instead, so CUDA states skip the copies."""
        if arr.is_cuda:
            return arr
        return dk.sync_pads(self._kcfgs[lvl], arr)

    def _lam(self, lam) -> float:
        """The helmholtz parameter as a host scalar rounded to the
        working dtype (0 for the lam-free operators, laplacian and
        vlaplacian, which ignore it like the boxed dispatch)."""
        if self.cfg.operator in ("laplacian", "vlaplacian"):
            lam = 0.0
        return self._kcfgs[self._unit0(self.levels[-1])].rnd(lam)

    def _eps(self, state, lvl):
        """The level's coefficient fields for the kernels (empty for the
        constant-coefficient family), periodic pads synced on CPU."""
        return tuple(self._sync_pads(state[f"eps{i}"][lvl], lvl)
                     for i in range(self.n_eps))

    def _planes(self, state, lvl, key="phi"):
        """The boundary-value planes the kernels read at lvl; the AMR
        subclass replaces refinement faces by the coarse interpolation of
        ``key``'s coarse field here."""
        return state["bc"][lvl]

    def _eps_planes(self, state, lvl):
        """The coefficient fields' boundary planes, or None for the
        reference's Neumann-zero ghosts (the AMR subclass puts coarse
        interpolation planes on refinement faces)."""
        return None

    def _smooth(self, state, lvl, n_cycle, lam):
        """n_cycle GSRB cycles as fused pair kernels — double pairs (4
        half-sweeps, one pass over device memory) on CUDA
        (smooth_boxes, m_multigrid.f90:404-424)."""
        cfg = self._kcfgs[lvl]
        phi = state["phi"][lvl]
        rhs = self._sync_pads(state["rhs"][lvl], lvl)
        bp = self._planes(state, lvl)
        eps = self._eps(state, lvl)
        epl = self._eps_planes(state, lvl)
        rem = n_cycle
        while rem > 0:
            # the plain route of an eps_bc config runs single pairs on
            # any device, as the JAX package's jnp path does
            k = 2 if (rem >= 2 and phi.is_cuda and cfg.periodic_even
                      and cfg.eps_bc is None) else 1
            phi = self._sync_pads(phi, lvl)
            # substeps n=1,2 -> red parity (n+1)%2 = 0
            phi = dk.pair_sweep_dense(cfg, phi, rhs, lam, bp,
                                      red_parity=0, n_pairs=k, eps=eps,
                                      eps_planes=epl)
            rem -= k
        state["phi"][lvl] = phi
        return state

    def _residual(self, state, lvl, lam):
        cfg = self._kcfgs[lvl]
        phi = self._sync_pads(state["phi"][lvl], lvl)
        state["ires"][lvl] = dk.stencil_apply_dense(
            cfg, phi, state["rhs"][lvl], lam, self._planes(state, lvl),
            residual=True, eps=self._eps(state, lvl),
            eps_planes=self._eps_planes(state, lvl))
        return state

    def _apply_op(self, state, lvl, lam):
        cfg = self._kcfgs[lvl]
        phi = self._sync_pads(state["phi"][lvl], lvl)
        return dk.stencil_apply_dense(cfg, phi, state["rhs"][lvl], lam,
                                      self._planes(state, lvl),
                                      residual=False,
                                      eps=self._eps(state, lvl),
                                      eps_planes=self._eps_planes(state, lvl))

    def _kernel_apply(self, cfg, phi, rhs, lam, bplanes, eps):
        """A(phi) on explicit arrays (the probed coarse matrix's columns;
        the 2D solver applies its own operator)."""
        return dk.stencil_apply_dense(cfg, phi, rhs, lam, bplanes,
                                      residual=False, eps=eps)

    def _max_residual(self, state, lvl, lam):
        """(state, max |residual|) — a 0-dim tensor on the state's
        device, not read back here."""
        state = self._residual(state, lvl, lam)
        return state, state["ires"][lvl][self._isl].abs().max()

    def _restrict_into(self, state, lvl, key):
        """Full-weighting restriction lvl -> lvl-1 (m_restrict.f90:183-194)."""
        state[key][lvl - 1] = dk.restrict_dense(self._kcfgs[lvl],
                                                state[key][lvl])
        return state

    def _update_coarse(self, state, lvl, lam):
        """FAS tau correction (update_coarse, m_multigrid.f90:347-384);
        residual + both restrictions fuse into one no-full-output
        kernel where eligible."""
        if self._fused_transfer_ok(state, lvl):
            cfg = self._kcfgs[lvl]
            phi_c, ires_c = dk.residual_restrict_dense(
                cfg, state["phi"][lvl], state["rhs"][lvl], lam,
                self._planes(state, lvl), eps=self._eps(state, lvl))
            state["phi"][lvl - 1] = phi_c
            state["ires"][lvl - 1] = ires_c
        else:
            state = self._residual(state, lvl, lam)
            state = self._restrict_into(state, lvl, "phi")
            state = self._restrict_into(state, lvl, "ires")
        return self._finish_coarse_rhs(state, lvl, lam)

    def _finish_coarse_rhs(self, state, lvl, lam):
        """rhs_c = A(restrict phi) + restrict(res); iold_c = phi_c."""
        a_phi = self._apply_op(state, lvl - 1, lam)
        isl = self._isl
        torch.add(a_phi[isl], state["ires"][lvl - 1][isl],
                  out=state["rhs"][lvl - 1][isl])
        return self._save_iold(state, lvl - 1)

    def _fused_transfer_ok(self, state, lvl):
        """Whether the fused residual+restrict kernels cover lvl ->
        lvl-1: a CUDA state (every cycled level above the coarsest has
        even extents).  CPU states take the separate phases."""
        return lvl - 1 in self.levels and state["phi"][lvl].is_cuda

    def _fused_down_ok(self, state, lvl):
        """Whether the fused downsweep kernel covers [smooth(2) +
        update_coarse] at lvl."""
        return (self.cfg.n_cycle_down == 2
                and self._fused_transfer_ok(state, lvl))

    def _down_leg(self, state, lvl, lam):
        """smooth(n_cycle_down) + update_coarse, fused into one kernel
        pass where eligible (identical per cell to the separate path)."""
        if not self._fused_down_ok(state, lvl):
            state = self._smooth(state, lvl, self.cfg.n_cycle_down, lam)
            return self._update_coarse(state, lvl, lam)
        cfg = self._kcfgs[lvl]
        phi, phi_c, ires_c = dk.downsweep_dense(
            cfg, state["phi"][lvl], state["rhs"][lvl], lam,
            self._planes(state, lvl), red_parity=0,
            eps=self._eps(state, lvl))
        state["phi"][lvl] = phi
        state["phi"][lvl - 1] = phi_c
        state["ires"][lvl - 1] = ires_c
        return self._finish_coarse_rhs(state, lvl, lam)

    def _correct_children(self, state, lvl_c, lam):
        """phi_fine += prolong(phi_c - iold_c) (correct_children,
        m_multigrid.f90:387-402), in place on phi_fine."""
        phi_c = self._sync_pads(state["phi"][lvl_c], lvl_c)
        iold_c = self._sync_pads(state["iold"][lvl_c], lvl_c)
        dk.prolong_correct_dense(self._kcfgs[lvl_c], phi_c, iold_c,
                                 state["phi"][lvl_c + 1],
                                 self._planes(state, lvl_c))
        return state

    def _prolong_rect(self, sub):
        """D-linear prolongation of [Zc+2, Yc+2, Xc+2] -> [2Zc, 2Yc, 2Xc]
        (mg_prolong_sparse weights, m_prolong.f90:159-240), in the plain
        version's order: 0.25*centre, then + 0.25*neighbour per dim x, y,
        z."""
        ctr = sub[1:-1, 1:-1, 1:-1]

        def shifted(d, s):
            sl = [slice(1, -1)] * 3
            ax = 2 - d
            sl[ax] = slice(1 + s, sub.shape[ax] - 1 + s)
            return sub[tuple(sl)]

        vals = {0: 0.25 * ctr}
        for d in range(3):
            lo, hi = 0.25 * shifted(d, -1), 0.25 * shifted(d, +1)
            new = {}
            for key, a in vals.items():
                new[key] = a + lo
                new[key | (1 << d)] = a + hi
            vals = new
        Zc, Yc, Xc = ctr.shape
        out = torch.empty((2 * Zc, 2 * Yc, 2 * Xc), dtype=sub.dtype,
                          device=sub.device)
        for bits, v in vals.items():
            out[(bits >> 2) & 1::2, (bits >> 1) & 1::2, bits & 1::2] = v
        return out

    def _zeros(self, shape):
        return torch.zeros(shape, dtype=self.cfg.dtype, device=self.device)

    def _prolong_add(self, sub, phi_f):
        """phi_f += prolong(sub), in place, through the prolongation
        kernel's corr_ready mode: sub's interior is the coarse field and
        its one-cell ring rides the kernel's identity face planes (the
        window ring IS the window's six faces).  Bitwise
        ``phi_f[interior] += _prolong_rect(sub)``: the same
        mg_prolong_sparse accumulation order, and the ghost 1.0*b +
        0.0*x1 is b."""
        cfg_w, cp, planes = self._corr_window(sub)
        return dk.prolong_correct_dense(cfg_w, cp, cp, phi_f, planes,
                                        corr_ready=True)

    def _corr_window(self, sub):
        """(config, padded field, six face planes) of a correction window
        [Zs+2, Ys+2, Xs+2]: its interior as a padded field, its ring as
        the plane values of identity-coefficient faces."""
        Zs, Ys, Xs = (int(v) - 2 for v in sub.shape)
        dims_w = (Xs, Ys, Zs)
        memo = self.__dict__.setdefault("_cfg_w_memo", {})
        if dims_w not in memo:
            memo[dims_w] = dk.DenseStencilConfig(
                dims=dims_w, idr2=(1.0, 1.0, 1.0), bc=[(1.0, 0.0, 0.0)] * 6,
                periodic=(False,) * 3, dtype=self.cfg.dtype,
                b_const=[None] * 6)
        cfg_w = memo[dims_w]
        PZ, PY = dk.PZ, dk.PY
        cp = self._zeros(dk.padded_shape(dims_w))
        cp[_ISL] = sub[1:-1, 1:-1, 1:-1]
        planes = []
        for nb, face in enumerate((
                sub[1:-1, 1:-1, 0], sub[1:-1, 1:-1, -1],   # x faces
                sub[1:-1, 0, 1:-1], sub[1:-1, -1, 1:-1],   # y faces
                sub[0, 1:-1, 1:-1], sub[-1, 1:-1, 1:-1])):  # z faces
            p = self._zeros(cfg_w.plane_shape(nb))
            if nb < 2:
                p[PZ:PZ + Zs, PY:PY + Ys] = face
            elif nb < 4:
                p[PZ:PZ + Zs, :] = face
            else:
                p[PY:PY + Ys, :] = face
            planes.append(p)
        return cfg_w, cp, planes

    def _ring_bc(self, lvl, key="phi"):
        """(c0,c1,c2) per face for ghost-ring synthesis; coefficient
        fields (eps*) take the reference's Neumann-zero default, ghost =
        own value (m_vlaplacian.f90:25-28)."""
        if key.startswith("eps"):
            return [(0.0, 1.0, 0.0)] * (2 * self.ndim)
        return self._bc_static(lvl)

    #: pads of the state's fields per array axis (z, y, x), which
    #: _var_with_ring and the boundary planes share
    _RING_PADS = (dk.PZ, dk.PY, 0)

    def _var_with_ring(self, state, lvl, key, lo=None, hi=None):
        """One variable with a one-cell ghost ring [Z+2, Y+2, X+2] ([Y+2,
        X+2] in 2D): ring faces from the bc_to_gc formula (ghost = c0*b +
        c1*x1 + c2*x2, m_ghost_cells.f90:682-698) or the periodic wrap; on
        AMR patches refinement faces take (0.5, 0.75, -0.25) with the
        coarse interpolation plane (_ring_bc, _planes).  The ring's edges
        and corners are 0.  lo/hi (per array axis, in the ringed array's
        coordinates): only the window [lo:hi], computed on its own cells
        (the same values; the planes are read only if a ring face of the
        window needs them)."""
        D = self.ndim
        n = tuple(int(v) for v in self.dims[lvl][::-1])
        lo = (0,) * D if lo is None else tuple(lo)
        hi = tuple(m + 2 for m in n) if hi is None else tuple(hi)
        pads = self._RING_PADS        # field and plane pads per axis
        arr = state[key][lvl]
        out = torch.zeros(tuple(h - l for l, h in zip(lo, hi)),
                          dtype=arr.dtype, device=arr.device)
        # ring coordinate c holds interior cell c - 1 (1 <= c <= n)
        tl = [max(l, 1) for l in lo]
        th = [min(h, m + 1) for h, m in zip(hi, n)]
        if all(a < b for a, b in zip(tl, th)):
            out[tuple(slice(a - l, b - l) for a, b, l in zip(tl, th, lo))] = \
                arr[tuple(slice(a - 1 + p, b - 1 + p)
                          for a, b, p in zip(tl, th, pads))]
        bc = self._ring_bc(lvl, key)
        bp = None
        for nbd in range(2 * D):
            d = nbd // 2
            ax = D - 1 - d
            lowside = nbd % 2 == 0
            c = 0 if lowside else n[ax] + 1
            if not (lo[ax] <= c < hi[ax]
                    and all(tl[a] < th[a] for a in range(D) if a != ax)):
                continue
            tsl = [slice(tl[a] - 1 + pads[a], th[a] - 1 + pads[a])
                   for a in range(D)]

            def pick(idx):
                sl = list(tsl)
                sl[ax] = idx + pads[ax]
                return arr[tuple(sl)]

            if self.periodic[d]:
                ring = pick(n[ax] - 1 if lowside else 0)
            else:
                if bp is None:
                    bp = self._planes(state, lvl, key)
                bpl = bp[nbd][tuple(tsl[a] for a in range(D) if a != ax)]
                c0, c1, c2 = bc[nbd]
                ring = c0 * bpl + c1 * pick(0 if lowside else n[ax] - 1)
                if c2 != 0.0:
                    ring = ring + c2 * pick(1 if lowside else n[ax] - 2)
            osl = [slice(tl[a] - lo[a], th[a] - lo[a]) for a in range(D)]
            osl[ax] = c - lo[ax]
            out[tuple(osl)] = ring
        return out

    def prolong_set(self, state, lvl_c, key_from="phi", key_to="phi",
                    with_ring: bool = False):
        """Non-additive prolongation of level lvl_c into the interior of
        lvl_c + 1, in place (the JAX package's free-space seeding).
        with_ring=True synthesizes the coarse ghost ring from the BCs
        (mg_prolong's use of parent ghost cells); otherwise it is zero."""
        if with_ring:
            corr = self._var_with_ring(state, lvl_c, key_from)
        else:
            src = state[key_from][lvl_c]
            corr = torch.zeros(tuple(np.array(self.dims[lvl_c])[::-1] + 2),
                               dtype=src.dtype, device=src.device)
            corr[1:-1, 1:-1, 1:-1] = src[_ISL]
        vals = self._prolong_rect(corr)
        dst = state[key_to][lvl_c + 1][_ISL]
        if tuple(vals.shape) != tuple(dst.shape):
            # a patch level smaller than twice the coarse one (the
            # dense-patch AMR solver): the JAX package's scatter refuses
            # it with this ValueError
            raise ValueError(f"Incompatible shapes for broadcasting: "
                             f"{tuple(vals.shape)} and requested shape "
                             f"{tuple(dst.shape)}")
        dst.copy_(vals)
        return state

    # -- subtract mean (fully periodic) ---------------------------------
    def _subtract_mean(self, state, key):
        """Leaf mean removal (subtract_mean, m_multigrid.f90:245-294;
        uniform tree -> mean over the finest level), in place."""
        top = self.levels[-1]
        mean = (state[key][top][self._isl].sum()
                / float(np.prod(self.dims[top])))
        for lvl in self.levels:
            state[key][lvl] -= mean
        return state

    # ------------------------------------------------------------------
    # coarse solve
    # ------------------------------------------------------------------
    def _build_direct(self):
        """Assemble the coarsest cycled level's operator into a dense
        matrix (host, float64) and eigendecompose.  BC ghosts are
        eliminated into the matrix; the inhomogeneous b-contribution is
        evaluated at runtime as A(0)."""
        lvl = self.levels[0]
        X, Y, Z = self.dims[lvl]
        m = X * Y * Z
        idr2 = tuple(float(x) for x in 1.0 / self.tree.dr[lvl] ** 2)
        bc = self._bc_static(lvl)
        A = np.zeros((m, m))
        strides = (1, X, X * Y)
        sizes = (X, Y, Z)
        for z in range(Z):
            for y in range(Y):
                for x in range(X):
                    i = (z * Y + y) * X + x
                    pos = (x, y, z)
                    for d in range(3):
                        A[i, i] -= 2.0 * idr2[d]
                        for side, step in ((0, -1), (1, +1)):
                            p = pos[d] + step
                            if 0 <= p < sizes[d]:
                                A[i, i + step * strides[d]] += idr2[d]
                            elif self.periodic[d]:
                                j = i + (step - step * sizes[d]) * strides[d]
                                A[i, j] += idr2[d]
                            else:
                                c0, c1, c2 = bc[2 * d + side]
                                A[i, i] += idr2[d] * c1
                                if c2 != 0.0:
                                    A[i, i - step * strides[d]] += idr2[d] * c2
        return self._eigen_package(A)

    def _eigen_package(self, A):
        """Eigendecompose the coarse operator in float64 on the host
        (symmetric fast path, general real fallback) and cast to the
        working dtype; None when unusable."""
        if np.allclose(A, A.T, atol=1e-12):
            d_eig, V = np.linalg.eigh(A)
            Vinv = V.T
        else:
            d_c, V_c = np.linalg.eig(A)
            if np.max(np.abs(d_c.imag)) > 1e-8 * np.max(np.abs(d_c.real)):
                return None  # fall back to smoothing
            d_eig = d_c.real
            V = V_c.real
            Vinv = np.linalg.inv(V)
        from ..convert import direct_from_numpy
        return direct_from_numpy(self, {
            "V": V, "Vinv": Vinv, "d": d_eig,
            "tiny": 1e-10 * np.max(np.abs(d_eig))})

    def _build_direct_probe(self, state):
        """Probe the coarsest cycled level's operator column by column
        through the stencil entry point the cycle uses (on the card: its
        kernel, one launch per column), for the variable-coefficient
        operators, whose matrix depends on the coarse-level eps in
        ``state``.  A(lam) = A0 - lam*I, so probing at lam = 0 suffices;
        the affine BC part A(0) is probed too and subtracted.  The
        matrix is assembled in float64 on the host and eigendecomposed
        there."""
        lvl = self.levels[0]
        cfg = self._kcfgs[lvl]
        ishape = self._ishape(lvl)
        m = int(np.prod(ishape))
        eps = self._eps(state, lvl)
        bp = state["bc"][lvl]
        phi = torch.zeros(self._pshape(self.dims[lvl]), dtype=self.cfg.dtype,
                          device=self.device)
        inner = phi[self._isl]
        cols = torch.empty((m + 1, m), dtype=self.cfg.dtype,
                           device=self.device)
        for j in range(m + 1):          # row m: A(0), the affine BC part
            cell = np.unravel_index(min(j, m - 1), ishape)
            if j < m:
                inner[cell] = 1.0
            self._sync_pads(phi, lvl)
            out = self._kernel_apply(cfg, phi, phi, 0.0, bp, eps)
            cols[j] = out[self._isl].reshape(-1)
            inner[cell] = 0.0
        cols = cols.cpu().numpy().astype(np.float64)
        A = cols[:m].T - cols[m][:, None]
        return self._eigen_package(A)

    def _ensure_direct(self, state=None):
        """Build the direct coarse solve's eigenbasis if it is missing:
        assembled from the stencil for constant coefficients, probed from
        ``state``'s coarse-level eps otherwise (without a state the
        variable-coefficient solver leaves it missing)."""
        if self.coarse_solver != "direct" or self._direct is not None:
            return
        if self.n_eps:
            if state is None:
                return
            self._direct = self._build_direct_probe(state) or "unavailable"
        else:
            self._direct = self._build_direct() or "unavailable"

    def _coarse_solve(self, state, lam):
        self._ensure_direct(state)
        if isinstance(self._direct, dict):
            return self._coarse_direct(state, lam)
        return self._coarse_smooth(state, lam)

    def _coarse_direct(self, state, lam):
        """phi = A^{-1}(rhs - A(0)) via the precomputed eigenbasis: two
        matrix-vector products in the working dtype (TF32 off)."""
        lvl = self._unit0(self.levels[0])
        dd = self._direct
        isl = self._isl
        zero = dict(state)
        zero["phi"] = {lvl: torch.zeros_like(state["phi"][lvl])}
        bterm = self._apply_op(zero, lvl, lam)[isl].reshape(-1)
        r = state["rhs"][lvl][isl].reshape(-1) - bterm
        comp = dd["Vinv"] @ r
        # a null mode of A stays null only while lam leaves it unshifted
        # (singular laplacian: drop the mean component; helmholtz with
        # lam != 0: the shifted spectrum is regular and must be solved)
        denom = dd["d"] - lam
        safe = denom.abs() > dd["tiny"]
        comp = torch.where(safe, comp / torch.where(safe, denom, 1.0), 0.0)
        x = (dd["V"] @ comp).reshape(self._ishape(lvl))
        state["phi"][lvl][isl] = x
        return state

    def _coarse_smooth(self, state, lam):
        """Reference-faithful coarse smoothing loop with the rel/abs
        1e-8, <=1000 rule (m_multigrid.f90:196-209).  The stopping test
        reads the residual back to the host every iteration."""
        cfg = self.cfg
        lvl = self.levels[0]
        n_cyc = cfg.n_cycle_up + cfg.n_cycle_down
        state, init_res = self._max_residual(state, lvl, lam)
        init_res = float(init_res)
        it, res = 0, float("inf")
        while (it < cfg.max_coarse_cycles
               and res >= cfg.residual_coarse_rel * init_res
               and res >= cfg.residual_coarse_abs):
            state = self._smooth(state, lvl, n_cyc, lam)
            state, r = self._max_residual(state, lvl, lam)
            it, res = it + 1, float(r)
        return state

    # ------------------------------------------------------------------
    # the cycles (mg_fas_vcycle / mg_fas_fmg)
    # ------------------------------------------------------------------
    def _zero_scalar(self):
        return torch.zeros((), dtype=self.cfg.dtype, device=self.device)

    def _vcycle(self, state, lam, max_lvl, need_res):
        cfg = self.cfg
        min_lvl = self.levels[0]
        top = self.levels[-1] if max_lvl is None else max_lvl

        if self.subtract_mean and max_lvl is None:
            state = self._subtract_mean(state, "rhs")

        for lvl in range(top, min_lvl, -1):
            state = self._down_leg(state, lvl, lam)

        state = self._coarse_solve(state, lam)

        for lvl in range(min_lvl + 1, top + 1):
            state = self._correct_children(state, lvl - 1, lam)
            state = self._smooth(state, lvl, cfg.n_cycle_up, lam)

        res = self._zero_scalar()
        if need_res:
            for lvl in range(min_lvl, top + 1):
                state, r = self._max_residual(state, lvl, lam)
                res = torch.maximum(res, r)

        if self.subtract_mean:
            state = self._subtract_mean(state, "phi")
        return state, res

    def _a0_zero(self) -> bool:
        """Whether A(0) == 0 exactly on every level — all faces periodic
        or homogeneous constant BCs (ghost(0) = c0*b = 0).  Then the
        zero-guess FMG's initial update_coarse chain is exactly
        rhs_c = restrict(rhs) (ires = rhs - A(0) = rhs, phi_c = 0,
        A(phi_c) = 0), so the down pass needs only the restriction
        kernel — no residual/apply passes."""
        for lvl in self.levels:
            cfg = self._kcfgs[lvl]
            for nb in range(2 * self.ndim):
                if cfg.periodic[nb // 2]:
                    continue
                b = cfg.b_const[nb]
                if b is None or float(b) != 0.0:
                    return False
        return True

    def _zero_phi(self, state, lvl):
        state["phi"][lvl].zero_()
        return state

    def _save_iold(self, state, lvl):
        """iold = phi, as a copy into iold's own buffer: phi is later
        corrected in place, so the two never share memory."""
        state["iold"][lvl].copy_(state["phi"][lvl])
        return state

    def _fmg(self, state, lam, have_guess, need_res):
        min_lvl, top = self.levels[0], self.levels[-1]
        zero_fast = not have_guess and self._a0_zero()
        if not have_guess:
            for lvl in self.levels:
                state = self._zero_phi(state, lvl)
        for lvl in range(top, min_lvl, -1):
            if zero_fast:
                # A(0) = 0: the whole update_coarse collapses to the
                # rhs restriction (values equal the full chain's)
                state = self._restrict_into(state, lvl, "rhs")
                state = self._save_iold(state, lvl - 1)
            else:
                state = self._update_coarse(state, lvl, lam)
        if self.subtract_mean:
            state = self._subtract_mean(state, "rhs")

        res = self._zero_scalar()
        for lvl in range(min_lvl, top + 1):
            state = self._save_iold(state, lvl)
            if lvl > min_lvl:
                state = self._correct_children(state, lvl - 1, lam)
            last = lvl == top
            state, r = self._vcycle(state, lam, max_lvl=lvl,
                                    need_res=(need_res and last))
            if last:
                res = r
        return state, res

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------
    @torch.no_grad()
    def fas_vcycle(self, state, lam=0.0, max_lvl=None, need_res=True):
        """One FAS V-cycle, in place on ``state``.  Returns (state, res)
        with res a 0-dim tensor on the state's device (0 when
        ``need_res`` is False); nothing is read back to the host."""
        self._ensure_direct(state)
        with self.timers.section("total V-cycle"):
            return self._vcycle(state, self._lam(lam), max_lvl, need_res)

    @torch.no_grad()
    def fas_fmg(self, state, lam=0.0, have_guess=False, need_res=True):
        """One FAS full-multigrid cycle, in place on ``state``.  Returns
        (state, res) like :meth:`fas_vcycle`.

        With ``MGConfig.fmg_mode="fused"`` on the card and
        ``need_res=False`` the cycle is one CUDA graph per (state, lam,
        have_guess): the first such call runs eagerly (and warms what is
        built lazily), the second captures and replays, later ones
        replay.  The result is bitwise the eager cycle's."""
        self._ensure_direct(state)
        lam = self._lam(lam)
        with self.timers.section("total FMG cycle"):
            if need_res or not self._graphs_on(state):
                return self._fmg(state, lam, have_guess, need_res)
            key = (id(state), lam, bool(have_guess))
            cyc = self._graphs.get(key)
            if cyc is not None and not cyc.matches(self, state):
                cyc = None
            if cyc is None and key not in self._graphs:
                self._graphs[key] = None
                return self._fmg(state, lam, have_guess, False)
            if cyc is None:
                cyc = self._capture(state, lambda: self._fmg(
                    state, lam, have_guess, False)[1])
                self._graphs[key] = cyc
            return state, cyc.replay()

    def _graphs_on(self, state) -> bool:
        """Whether cycles on this state go through CUDA graphs."""
        return (self.cfg.fmg_mode == "fused"
                and state["phi"][self.levels[-1]].is_cuda)

    def _capture(self, state, fn) -> _CapturedCycle:
        """``fn`` (a cycle on ``state``) as a CUDA graph; raises if the
        capture fails."""
        self._ensure_direct(state)
        return _CapturedCycle(self, state, fn)

    @torch.no_grad()
    def apply_operator(self, state, lam=0.0, out_key: str = "ires"):
        lam = self._lam(lam)
        for lvl in self.levels:
            state[out_key][lvl] = self._apply_op(state, lvl, lam)
        return state
