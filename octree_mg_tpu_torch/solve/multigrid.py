"""FAS multigrid configuration, and the boxed solver ``MGSolver``.

The cycle structure follows ``m_multigrid.f90`` of the Fortran
reference: ``fas_vcycle`` / ``fas_fmg`` (:150-243 / :84-147) with the FAS
tau correction in ``update_coarse`` (:347-384), ``correct_children``
(:387-402), the coarse-grid smoothing loop with the rel/abs 1e-8, <= 1000
iteration stopping rule (:196-209, defaults m_data_structures.f90:318-327)
and ``subtract_mean`` for fully periodic problems (:245-294).

``MGSolver`` is the port of the JAX package's boxed solver (its
``solve/multigrid.py``): every level is a stack of ghost-padded boxes
``[n_vars, n_boxes, (nc+2)^D]``, the per-box loops of the reference
become whole-level PyTorch operations (ops/kernels, ops/ghost,
ops/transfer) and the level loop runs eagerly in Python.  It serves what
no dense path takes (``make_solver``'s fall-through): 1D trees, the
Jacobi smoother, operators and geometries the 2D dense paths reject,
fully periodic sparse AMR trees.  ``MGExperimental.pallas_smoother``
routes the constant-coefficient laplacian half-sweep through the
hand-written CUDA kernel of ops/flat_smoother (its plain version on the
CPU); results are bitwise those of the default smoother.

Differences from the JAX package, none of them numerical:

* the state is updated IN PLACE (``iold`` is a copy of ``phi``, never
  an alias); the drivers return the dictionary they were given;
* the coarse loop (a device-side ``lax.while_loop`` there) runs on the
  host with the same stopping rule, compared in the state's dtype, so
  it takes the same number of iterations; each iteration reads its
  residual back to the host (``coarse_host_reads`` counts the reads);
* not here: CUDA graphs (``fmg_mode="fused"`` raises: the coarse loop's
  host reads cannot be captured, ROADMAP A11), the multi-device halo
  (``attach_mesh``, ``halo="ppermute"``: ROADMAP A13) and the
  measured-negative ``gathered_smoother``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core import indexmaps, topology as topo
from ..core.constants import (IPHI, IRES, IRHS, IOLD, IVEPS, NUM_VARS,
                              BCType)
from ..core.tree import Tree, box_r_min
from ..ops import flat_smoother
from ..ops import ghost as ghost_ops
from ..ops import kernels
from ..ops import transfer
from ..utils.timers import Timers


@dataclasses.dataclass
class MGExperimental:
    """Research options of the boxed solver.

    The JAX package's ``gathered_smoother`` (ghost values read inside
    the half-sweep instead of filled between sweeps) measured slower
    than the shipped path and is not ported: passing it raises."""

    #: the hand-written flat-box half-sweep kernel (ops/flat_smoother)
    #: for the constant-coefficient cartesian laplacian smoother of
    #: ``MGSolver`` (2D and 3D); bitwise the default smoother's results
    pallas_smoother: bool = False
    gathered_smoother: dataclasses.InitVar[Optional[bool]] = None

    def __post_init__(self, gathered_smoother):
        if gathered_smoother is not None:
            raise NotImplementedError(
                "MGExperimental.gathered_smoother is a measured-negative "
                "knob of the JAX package and is not ported (ROADMAP, open "
                "items: do not port the measured-negative knobs)")


@dataclasses.dataclass
class MGConfig:
    """Runtime configuration (the reference's mg_t public fields,
    m_data_structures.f90:250-342)."""

    operator: str = "laplacian"  # laplacian|helmholtz|vlaplacian|vhelmholtz|ahelmholtz
    geometry: str = "cartesian"          # cartesian|cylindrical (2D)
    smoother: str = "gsrb"               # gsrb|gs (aliased)|jacobi
    n_cycle_down: int = 2
    n_cycle_up: int = 2
    max_coarse_cycles: int = 1000
    residual_coarse_abs: float = 1e-8
    residual_coarse_rel: float = 1e-8
    #: extra cell-centred variables of the boxed state beyond the four
    #: of the reference (the coefficient operators raise it to what
    #: they need)
    n_extra_vars: int = 0
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
    #: outer iteration of the uniform dense solver each replay one
    #: captured CUDA graph (the counterpart of the JAX package's
    #: one-program FMG and outer): the first call runs eagerly, the
    #: second captures, later ones replay.  A capture that fails raises.
    #: CPU states have no graphs and run the same eager sequence in both
    #: modes.  The dense forest and the boxed solver refuse it.
    fmg_mode: str = "split"
    #: pad every boxed level's box count to a multiple of this (0/1 =
    #: off) with inert boxes that stay zero (the JAX package's even
    #: box-axis split across a device mesh)
    pad_boxes_multiple: int = 0
    #: coarse-grid solve strategy of the dense solvers: "direct" solves
    #: the coarsest cycled level exactly via a precomputed eigenbasis
    #: (two small matmuls); "smooth" is the reference's iterate-to-
    #: tolerance loop (m_multigrid.f90:196-209).  The boxed solver always
    #: smooths.
    coarse_solver: str = "direct"
    #: halo movement of the boxed solver: "gspmd", one device's row
    #: gathers (the only value here); "ppermute", the JAX package's
    #: explicit exchange across a device mesh, waits for ROADMAP A13 and
    #: raises
    halo: str = "gspmd"
    #: the z-slab dense solver's smoother (solve/dense_shard.py) sweeps
    #: each slab from the data before the halo exchange, then recomputes
    #: the two edge strips the halo reaches with the exchanged pads and
    #: patches them in: bitwise the exchange-then-sweep order, which
    #: False selects (the JAX package's field and default)
    overlap_halo: bool = True
    #: research options (see MGExperimental)
    experimental: MGExperimental = dataclasses.field(
        default_factory=MGExperimental)


def _dt_np(dtype):
    return np.float32 if dtype == torch.float32 else np.float64


class MGSolver:
    """Boxed multigrid solver bound to one tree.

    Index maps are built once on the host (core/indexmaps, replacing the
    reference's buffer-sizing dry runs, m_allocate_storage.f90:80-96).
    State:

        {"cc": {lvl: [n_vars, n_boxes, (nc+2)^D]},
         "bc": {lvl: [per-direction boundary values [n_boxes, nc^(D-1)]]}}

    on ``config.device`` in ``config.dtype``, updated in place.
    """

    def __init__(self, tree: Tree, config: Optional[MGConfig] = None):
        self.tree = tree
        self.cfg = config or MGConfig()
        cfg = self.cfg
        if cfg.fmg_mode == "fused":
            raise NotImplementedError(
                "MGSolver: fmg_mode='fused' (CUDA graphs) is not supported: "
                "the coarse loop reads its residual on the host every "
                "iteration, which a graph cannot capture (ROADMAP A11, "
                "left out)")
        if cfg.fmg_mode != "split":
            raise ValueError(f"MGConfig.fmg_mode must be 'split' or 'fused', "
                             f"got {cfg.fmg_mode!r}")
        if cfg.halo != "gspmd":
            raise NotImplementedError(
                f"MGConfig.halo={cfg.halo!r}: the explicit exchange across "
                f"devices waits for multi-GPU (ROADMAP A13)")
        if cfg.smoother not in ("gsrb", "gs", "jacobi"):
            raise ValueError(f"unknown smoother {cfg.smoother!r}")
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "MGConfig.device is 'cuda' but no CUDA device is available; "
                "pass device='cpu' for the plain versions")
        self.ndim = tree.ndim
        if cfg.smoother == "gs":
            warnings.warn("lexicographic GS does not vectorize; using "
                          "red-black GS (the reference's gsrb mode)")
            cfg.smoother = "gsrb"
        self.substeps = 2 if cfg.smoother == "gsrb" else 1
        # operator-required extra variables (m_vlaplacian.f90:17-21,
        # m_ahelmholtz.f90:22-26)
        if cfg.operator in ("vlaplacian", "vhelmholtz"):
            cfg.n_extra_vars = max(1, cfg.n_extra_vars)
        if cfg.operator == "ahelmholtz":
            cfg.n_extra_vars = max(self.ndim, cfg.n_extra_vars)
        self.n_vars = NUM_VARS + cfg.n_extra_vars
        self.subtract_mean = tree.subtract_mean and cfg.operator == "laplacian"

        #: named phase timers (mg_add_timers, m_multigrid.f90:72-81),
        #: whole-cycle granularity
        self.timers = Timers()
        self.maps = indexmaps.build_all_maps(
            tree, pad_to=max(1, cfg.pad_boxes_multiple))
        self._build_static()
        self._build_bc_defaults()
        self._dmaps = None  # built lazily
        self._bcs: Dict = {}
        #: pluggable prolongation (the reference's mg%box_prolong pointer,
        #: m_data_structures.f90:335-336): signature
        #: (coarse_plane, dmaps_f, static_f) -> fine interior values
        self.box_prolong = transfer.prolong_from_coarse
        #: device-to-host reads of the coarse loop's residual so far (one
        #: for the starting residual and one per iteration); callers
        #: reset it
        self.coarse_host_reads = 0

    def attach_mesh(self, mesh):
        """The JAX package binds a device mesh here for its explicit
        halo exchange; multi-GPU waits for ROADMAP A13."""
        raise NotImplementedError(
            "MGSolver.attach_mesh: the explicit halo exchange across "
            "devices waits for multi-GPU (ROADMAP A13)")

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def _build_static(self):
        t = self.tree
        self.levels = list(range(t.lowest_lvl, t.highest_lvl + 1))
        self.static: Dict[int, Dict] = {}
        for lvl in self.levels:
            m = self.maps[lvl]
            # uniform levels: every coarse box is a parent in id order, so
            # parent indexing degenerates to the identity (off when the
            # box axis is padded — pad rows sit between levels' counts)
            coarse_padded = (lvl - 1 >= t.lowest_lvl and
                             self.maps[lvl - 1].n_boxes
                             != self.maps[lvl - 1].n_real)
            parents_identity = (
                m.parent_locs is not None
                and lvl - 1 >= t.lowest_lvl
                and not coarse_padded
                and m.n_boxes == m.n_real
                and len(m.parent_locs) == len(t.lvls[lvl - 1].ids)
                and bool(np.array_equal(m.parent_locs,
                                        np.arange(len(m.parent_locs)))))
            self.static[lvl] = {
                "ndim": self.ndim,
                "nc": m.nc,
                "n_boxes": m.n_boxes,
                "n_real": m.n_real,
                "mp": [len(d.phys_loc) for d in m.dirs],
                "mr": [len(d.rb_loc) for d in m.dirs],
                # every box has a same-level neighbor in this direction:
                # the ghost face is the gathered rows as they are
                "all_nb": [bool(d.has_nb.all()) for d in m.dirs],
                "multi_child": m.multi_child,
                "idr2": tuple(float(x) for x in 1.0 / t.dr[lvl] ** 2),
                "dr": tuple(float(x) for x in t.dr[lvl]),
                "parents_identity": parents_identity,
                "leaves_all": (len(t.lvls[lvl].leaves)
                               == len(t.lvls[lvl].ids)
                               and m.n_boxes == m.n_real),
            }

    def _build_bc_defaults(self):
        nnb = topo.num_neighbors(self.ndim)
        # per-variable BC spec: list per direction of
        # {"type": BCType, "value": float, "fn": callable|None}
        self.bc_spec: Dict[int, List[Dict]] = {}
        for iv in range(self.n_vars):
            self.bc_spec[iv] = [
                {"type": BCType.DIRICHLET, "value": 0.0, "fn": None}
                for _ in range(nnb)]
        # coefficient variables get Neumann-zero ghosts
        # (m_vlaplacian.f90:25-28, m_ahelmholtz.f90:28-41)
        if self.cfg.operator in ("vlaplacian", "vhelmholtz"):
            for nb in range(nnb):
                self.bc_spec[IVEPS][nb] = {"type": BCType.NEUMANN,
                                           "value": 0.0, "fn": None}
        if self.cfg.operator == "ahelmholtz":
            for d in range(self.ndim):
                for nb in range(nnb):
                    self.bc_spec[IVEPS + d][nb] = {"type": BCType.NEUMANN,
                                                   "value": 0.0, "fn": None}

    def set_bc(self, iv: int, bc_type: BCType, value: float = 0.0,
               nb: Optional[int] = None, fn: Optional[Callable] = None):
        """Set physical boundary conditions for a variable.

        ``fn(x)`` receives face cell-center coordinates [..., ndim] and
        returns boundary values (the reference's mg_subr_bc callback,
        m_data_structures.f90:346-361, evaluated when a state is
        allocated, like mg_phi_bc_store, m_ghost_cells.f90:66-117).
        """
        nbs = range(topo.num_neighbors(self.ndim)) if nb is None else [nb]
        for b in nbs:
            self.bc_spec[iv][b] = {"type": bc_type, "value": value, "fn": fn}
        self._bcs = {}

    # -- device maps ----------------------------------------------------
    def _to_device(self):
        """The index maps as tensors on the solver's device (built once):
        per level {"dirs": [{nb_loc, has_nb, is_phys, rb_loc, rb_cidx}],
        "parent_locs", "leaf_locs", "upd_mask" (the half-sweep masks of
        parity 0 and 1)} and, for cylindrical geometry, the radial face
        weights."""
        if self._dmaps is not None:
            return self._dmaps
        dev = self.device

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        dm: Dict[int, Dict] = {}
        for lvl in self.levels:
            m = self.maps[lvl]
            dirs = []
            for d in m.dirs:
                is_phys = np.zeros(m.n_boxes, dtype=bool)
                is_phys[d.phys_loc] = True
                dirs.append({
                    "nb_loc": idx(d.nb_loc),
                    "has_nb": torch.as_tensor(d.has_nb, device=dev),
                    "is_phys": torch.as_tensor(is_phys, device=dev),
                    "rb_loc": idx(d.rb_loc),
                    "rb_cidx": (idx(d.rb_cidx) if d.rb_cidx is not None
                                else idx(np.zeros((0,)))),
                })
            parity = indexmaps.checkerboard_parity(self.ndim, m.nc)
            entry = {
                "dirs": dirs,
                "parent_locs": (idx(m.parent_locs)
                                if m.parent_locs is not None
                                else idx(np.zeros((0,)))),
                "leaf_locs": idx(m.leaf_locs),
                "upd_mask": [torch.as_tensor(parity == p, device=dev)
                             for p in (0, 1)],
            }
            if self.cfg.geometry == "cylindrical":
                entry.update(self._cyl_weights(lvl))
            dm[lvl] = entry
        self._dmaps = dm
        return dm

    def _cyl_weights(self, lvl: int):
        """Per-box radial face weights (box_clpl, m_laplacian.f90:209-212)."""
        t = self.tree
        nc = t.box_size_lvl[lvl]
        dr0 = t.dr[lvl][0]
        ids = t.lvls[lvl].ids
        rmin = np.stack([box_r_min(t, int(b)) for b in ids])[:, 0]  # [n]
        n_pad = self.static[lvl]["n_boxes"]
        if n_pad > len(ids):  # inert pad boxes: any nonzero radius works
            rmin = np.concatenate([rmin, np.ones(n_pad - len(ids))])
        i = np.arange(1, nc + 1)
        r_face = rmin[:, None] + dr0 * (i - 1)[None, :]  # face left of cell i
        r_face_hi = rmin[:, None] + dr0 * i[None, :]
        r_inv = 1.0 / (rmin[:, None] + dr0 * (i - 0.5)[None, :])
        w_lo = (r_face * r_inv)[:, None, :]    # [n, 1(y), nc(x)]
        w_hi = (r_face_hi * r_inv)[:, None, :]
        dt, dev = self.cfg.dtype, self.device
        return {"cyl_w_lo": torch.as_tensor(w_lo, dtype=dt, device=dev),
                "cyl_w_hi": torch.as_tensor(w_hi, dtype=dt, device=dev)}

    def _op_ctx(self, lvl: int, dmaps) -> kernels.OpContext:
        st = self.static[lvl]
        return kernels.OpContext(
            ndim=self.ndim, nc=st["nc"], idr2=st["idr2"],
            geometry=self.cfg.geometry,
            cyl_w_lo=dmaps[lvl].get("cyl_w_lo"),
            cyl_w_hi=dmaps[lvl].get("cyl_w_hi"))

    def _bc_static(self, iv: int, lvl: int) -> List[Dict]:
        """Per-direction static BC coefficients at a level."""
        key = (iv, lvl)
        out = self._bcs.get(key)
        if out is not None:
            return out
        out = []
        st = self.static[lvl]
        for nb in range(topo.num_neighbors(self.ndim)):
            spec = self.bc_spec[iv][nb]
            d = topo.neighb_dim(nb)
            c0, c1, c2 = ghost_ops.bc_coeffs(spec["type"], st["dr"][d], nb)
            out.append({"c0": c0, "c1": c1, "c2": c2,
                        "value": spec["value"]})
        self._bcs[key] = out
        return out

    # ------------------------------------------------------------------
    # state allocation / access
    # ------------------------------------------------------------------
    def allocate(self) -> Dict:
        """Allocate the state (mg_allocate_storage,
        m_allocate_storage.f90:51-99; buffers are replaced by index maps)."""
        cc, bc = {}, {}
        for lvl in self.levels:
            st = self.static[lvl]
            shape = (self.n_vars, st["n_boxes"]) + (st["nc"] + 2,) * self.ndim
            cc[lvl] = torch.zeros(shape, dtype=self.cfg.dtype,
                                  device=self.device)
            bc[lvl] = self._eval_bc_values(lvl)
        return {"cc": cc, "bc": bc}

    def _eval_bc_values(self, lvl: int) -> List[torch.Tensor]:
        """Evaluate IPHI boundary values on physical faces (cf.
        mg_phi_bc_store, m_ghost_cells.f90:66-117).  Stored as full-face
        [n_boxes, nc^(D-1)] arrays (zeros away from physical faces) so
        the ghost fill needs no scatter."""
        out = []
        m = self.maps[lvl]
        st = self.static[lvl]
        fshape = (st["nc"],) * (self.ndim - 1) if self.ndim > 1 else ()
        for nb in range(topo.num_neighbors(self.ndim)):
            spec = self.bc_spec[IPHI][nb]
            full = np.zeros((st["n_boxes"],) + fshape)
            coords = m.phys_face_coords[nb]  # [mp, (nc,)*(D-1), D]
            if coords.shape[0] > 0:
                if spec["fn"] is not None:
                    vals = np.asarray(spec["fn"](coords))
                else:
                    vals = np.full(coords.shape[:-1], spec["value"])
                full[m.dirs[nb].phys_loc] = vals.reshape(
                    (len(m.dirs[nb].phys_loc),) + fshape)
            out.append(torch.as_tensor(full, dtype=self.cfg.dtype,
                                       device=self.device))
        return out

    def cell_centers(self, lvl: int) -> np.ndarray:
        """Cell-center coordinates incl. ghost layer:
        [n_boxes, (nc+2)^D, ndim] (host-side; for problem setup)."""
        t = self.tree
        nc = t.box_size_lvl[lvl]
        dr = t.dr[lvl]
        ids = t.lvls[lvl].ids
        rmin = np.stack([box_r_min(t, int(b)) for b in ids])  # [n, D]
        shape = (nc + 2,) * self.ndim
        out = np.empty((len(ids),) + shape + (self.ndim,))
        for d in range(self.ndim):
            ax = self.ndim - 1 - d  # spatial axis among the shape dims
            idx = (np.arange(0, nc + 2) - 0.5) * dr[d]
            bshape = [1] * self.ndim
            bshape[ax] = nc + 2
            out[..., d] = rmin[:, d].reshape(-1, *[1] * self.ndim) \
                + idx.reshape(bshape)
        return out

    # ------------------------------------------------------------------
    # building blocks: functions of (state, dmaps) that write the state
    # in place and return it
    # ------------------------------------------------------------------
    def _isl(self):
        return (slice(None),) + (slice(1, -1),) * self.ndim

    def _fill_ghost_lvl(self, state, dmaps, lvl: int, iv: int):
        cc = state["cc"]
        bc_vals = state["bc"][lvl] if iv == IPHI else None
        ghost_ops.fill_ghost_lvl(
            cc[lvl], cc.get(lvl - 1), dmaps[lvl], self.static[lvl],
            self._bc_static(iv, lvl), bc_vals, iv)
        return state

    def fill_ghost_all(self, state, dmaps, iv: int):
        """mg_fill_ghost_cells (m_ghost_cells.f90:120-128)."""
        for lvl in self.levels:
            state = self._fill_ghost_lvl(state, dmaps, lvl, iv)
        return state

    def _smooth_boxes(self, state, dmaps, lvl: int, n_cycle: int, lam):
        """smooth_boxes (m_multigrid.f90:404-424): ghost fill after every
        substep."""
        ctx = self._op_ctx(lvl, dmaps)
        # laplacian only (the JAX package bakes the denominator into its
        # kernel statically, and lam is a traced scalar there)
        use_pallas = (self.cfg.experimental.pallas_smoother
                      and self.cfg.smoother == "gsrb"
                      and self.cfg.operator == "laplacian"
                      and self.cfg.geometry == "cartesian"
                      and self.ndim >= 2)
        for n in range(1, n_cycle * self.substeps + 1):
            cc = state["cc"][lvl]
            if self.cfg.smoother == "jacobi":
                kernels.jacobi_sweep(cc[IPHI], cc[IRHS], self.ndim, ctx.nc,
                                     ctx.idr2, lam)
            elif use_pallas:
                flat_smoother.half_sweep_boxes(
                    cc[IPHI], cc[IRHS], self.ndim, ctx.nc, ctx.idr2, 0.0,
                    parity_val=(n % 2))
            else:
                kernels.op_smooth_half(self.cfg.operator, ctx, cc, lam,
                                       dmaps[lvl]["upd_mask"][n % 2])
            state = self._fill_ghost_lvl(state, dmaps, lvl, IPHI)
        return state

    def _residual_lvl(self, state, dmaps, lvl: int, lam):
        """residual_box over a level (m_multigrid.f90:426-436); writes IRES."""
        ctx = self._op_ctx(lvl, dmaps)
        cc = state["cc"][lvl]
        out = kernels.op_apply(self.cfg.operator, ctx, cc, lam)
        isl = self._isl()
        cc[IRES][isl] = cc[IRHS][isl] - out
        return state

    def _max_residual_lvl(self, state, dmaps, lvl: int, lam):
        """max_residual_lvl (m_multigrid.f90:296-311): returns (state, a
        0-d tensor on the device)."""
        state = self._residual_lvl(state, dmaps, lvl, lam)
        return state, state["cc"][lvl][IRES][self._isl()].abs().max()

    def _update_coarse(self, state, dmaps, lvl: int, lam):
        """update_coarse (m_multigrid.f90:347-384): FAS tau correction."""
        isl = self._isl()
        state = self._residual_lvl(state, dmaps, lvl, lam)
        state = self._restrict_lvl(state, dmaps, lvl, IPHI)
        state = self._restrict_lvl(state, dmaps, lvl, IRES)
        state = self._fill_ghost_lvl(state, dmaps, lvl - 1, IPHI)

        cc_c = state["cc"][lvl - 1]
        ctx_c = self._op_ctx(lvl - 1, dmaps)
        a_phi = kernels.op_apply(self.cfg.operator, ctx_c, cc_c, lam)
        if self.static[lvl]["parents_identity"]:
            cc_c[IRHS][isl] = a_phi + cc_c[IRES][isl]
            # a copy into iold, never an alias of phi
            cc_c[IOLD].copy_(cc_c[IPHI])
        else:
            ploc = dmaps[lvl]["parent_locs"]
            cc_c[IRHS][isl].index_copy_(
                0, ploc, a_phi.index_select(0, ploc)
                + cc_c[IRES][isl].index_select(0, ploc))
            cc_c[IOLD].index_copy_(0, ploc, cc_c[IPHI].index_select(0, ploc))
        return state

    def _restrict_lvl(self, state, dmaps, lvl: int, iv: int):
        """mg_restrict_lvl from lvl into lvl-1 (m_restrict.f90:83-114)."""
        transfer.restrict_to_coarse(state["cc"][lvl][iv],
                                    state["cc"][lvl - 1][iv], dmaps[lvl],
                                    self.static[lvl])
        return state

    def restrict_all(self, state, dmaps, iv: int):
        """mg_restrict (m_restrict.f90:72-80)."""
        for lvl in reversed(self.levels[1:]):
            state = self._restrict_lvl(state, dmaps, lvl, iv)
        return state

    def _correct_children(self, state, dmaps, lvl: int):
        """correct_children (m_multigrid.f90:387-402):
        phi_fine += prolong(phi_c - phi_old_c); the correction's ghost
        layer participates in the interpolation, as in the reference."""
        cc_c = state["cc"][lvl]
        corr = cc_c[IPHI] - cc_c[IOLD]
        vals = self.box_prolong(corr, dmaps[lvl + 1], self.static[lvl + 1])
        nr = self.static[lvl + 1]["n_real"]
        isl = (slice(0, nr),) + (slice(1, -1),) * self.ndim
        state["cc"][lvl + 1][IPHI][isl].add_(vals)
        return state

    def prolong_lvl(self, state, dmaps, lvl: int, iv: int, iv_to: int,
                    add: bool, method=None):
        """mg_prolong from lvl onto lvl+1 (m_prolong.f90:51-85)."""
        method = method or self.box_prolong
        vals = method(state["cc"][lvl][iv], dmaps[lvl + 1],
                      self.static[lvl + 1])
        nr = self.static[lvl + 1]["n_real"]
        isl = (slice(0, nr),) + (slice(1, -1),) * self.ndim
        dst = state["cc"][lvl + 1][iv_to][isl]
        if add:
            dst.add_(vals)
        else:
            dst.copy_(vals)
        return state

    def _subtract_mean(self, state, dmaps, iv: int, include_ghostcells: bool):
        """subtract_mean (m_multigrid.f90:245-294): leaf-weighted global
        mean over levels >= 1, removed from all levels."""
        t = self.tree
        isl = self._isl()
        total = 0.0
        for lvl in [l for l in self.levels if l >= 1]:
            w = float(np.prod(t.dr[lvl]))
            plane = state["cc"][lvl][iv]
            if self.static[lvl]["leaves_all"]:
                interior = plane[isl]
            else:
                interior = plane.index_select(
                    0, dmaps[lvl]["leaf_locs"])[isl]
            total = total + w * interior.sum()
        nc1 = t.box_size_lvl[1]
        volume = nc1 ** self.ndim * float(np.prod(t.dr[1])) \
            * len(t.lvls[1].ids)
        mean = total / volume
        for lvl in self.levels:
            plane = state["cc"][lvl][iv]
            if include_ghostcells:
                plane.sub_(mean)
            else:
                plane[isl].add_(-mean)
        return state

    # ------------------------------------------------------------------
    # cycle drivers
    # ------------------------------------------------------------------
    def _coarse_solve(self, state, dmaps, lam):
        """Coarse-grid smoothing loop (m_multigrid.f90:196-209).  The
        JAX package's device-side while loop, on the host: the same
        stopping rule in the state's dtype, one residual read per
        iteration."""
        cfg = self.cfg
        min_lvl = self.levels[0]
        n_cyc = cfg.n_cycle_up + cfg.n_cycle_down
        f = _dt_np(cfg.dtype)
        state, init_res = self._max_residual_lvl(state, dmaps, min_lvl, lam)
        init = f(init_res.item())
        self.coarse_host_reads += 1
        thr_rel = f(cfg.residual_coarse_rel) * init
        thr_abs = f(cfg.residual_coarse_abs)
        it, res = 0, f(np.inf)
        while (it < cfg.max_coarse_cycles and res >= thr_rel
               and res >= thr_abs):
            state = self._smooth_boxes(state, dmaps, min_lvl, n_cyc, lam)
            state, r = self._max_residual_lvl(state, dmaps, min_lvl, lam)
            res = f(r.item())
            self.coarse_host_reads += 1
            it += 1
        return state

    def _vcycle(self, state, dmaps, lam, max_lvl: Optional[int],
                standalone: bool, need_res: bool):
        """mg_fas_vcycle (m_multigrid.f90:150-243)."""
        cfg = self.cfg
        min_lvl = self.levels[0]
        top = self.levels[-1] if max_lvl is None else max_lvl

        if self.subtract_mean and max_lvl is None:
            state = self._subtract_mean(state, dmaps, IRHS, False)
        if standalone:
            state = self._fill_ghost_lvl(state, dmaps, top, IPHI)

        for lvl in range(top, min_lvl, -1):
            state = self._smooth_boxes(state, dmaps, lvl, cfg.n_cycle_down,
                                       lam)
            state = self._update_coarse(state, dmaps, lvl, lam)

        state = self._coarse_solve(state, dmaps, lam)

        for lvl in range(min_lvl + 1, top + 1):
            state = self._correct_children(state, dmaps, lvl - 1)
            state = self._fill_ghost_lvl(state, dmaps, lvl, IPHI)
            state = self._smooth_boxes(state, dmaps, lvl, cfg.n_cycle_up, lam)

        res = torch.zeros((), dtype=cfg.dtype, device=self.device)
        if need_res:
            for lvl in range(min_lvl, top + 1):
                state, r = self._max_residual_lvl(state, dmaps, lvl, lam)
                res = torch.maximum(res, r)

        if self.subtract_mean:
            state = self._subtract_mean(state, dmaps, IPHI, True)
        return state, res

    def _fmg(self, state, dmaps, lam, have_guess: bool, need_res: bool):
        """mg_fas_fmg (m_multigrid.f90:84-147)."""
        min_lvl, top = self.levels[0], self.levels[-1]
        if not have_guess:
            for lvl in self.levels:
                state["cc"][lvl][IPHI].zero_()

        state = self._fill_ghost_lvl(state, dmaps, top, IPHI)
        for lvl in range(top, min_lvl, -1):
            state = self._update_coarse(state, dmaps, lvl, lam)
        if self.subtract_mean:
            state = self._subtract_mean(state, dmaps, IRHS, False)

        res = torch.zeros((), dtype=self.cfg.dtype, device=self.device)
        for lvl in range(min_lvl, top + 1):
            cc = state["cc"][lvl]
            cc[IOLD].copy_(cc[IPHI])
            if lvl > min_lvl:
                state = self._correct_children(state, dmaps, lvl - 1)
                state = self._fill_ghost_lvl(state, dmaps, lvl, IPHI)
            last = lvl == top
            state, r = self._vcycle(state, dmaps, lam, max_lvl=lvl,
                                    standalone=False,
                                    need_res=(need_res and last))
            if last:
                res = r
        return state, res

    def apply_op(self, state, dmaps, lam, i_out: int):
        """mg_apply_op (m_multigrid.f90:439-456)."""
        isl = self._isl()
        for lvl in self.levels:
            ctx = self._op_ctx(lvl, dmaps)
            cc = state["cc"][lvl]
            cc[i_out][isl] = kernels.op_apply(self.cfg.operator, ctx, cc, lam)
        return state

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------
    def fas_vcycle(self, state, lam=0.0, max_lvl=None, need_res=True):
        """One V-cycle; returns (state, max-norm residual as a 0-d
        tensor; 0 when need_res is False)."""
        dmaps = self._to_device()
        with self.timers.section("total V-cycle"):
            return self._vcycle(state, dmaps, float(lam), max_lvl=max_lvl,
                                standalone=True, need_res=need_res)

    def fas_fmg(self, state, lam=0.0, have_guess=False, need_res=True):
        """mg_fas_fmg; returns (state, max-norm residual of the top
        level's V-cycle as a 0-d tensor; 0 when need_res is False)."""
        dmaps = self._to_device()
        with self.timers.section("total FMG cycle"):
            return self._fmg(state, dmaps, float(lam), have_guess, need_res)

    # -- public state-access API (for drivers layered on the solver) ----
    def set_plane(self, state, lvl: int, iv: int, plane):
        """Overwrite one variable plane at a level (in place)."""
        state["cc"][lvl][iv].copy_(plane)
        return state

    def restrict_level(self, state, lvl: int, iv: int):
        """Restrict one variable from lvl into lvl-1 (mg_restrict_lvl)."""
        return self._restrict_lvl(state, self._to_device(), lvl, iv)

    def prolong_level(self, state, lvl: int, iv: int, iv_to: int,
                      add: bool = False, method=None):
        """Prolong one variable from lvl onto lvl+1 (mg_prolong)."""
        return self.prolong_lvl(state, self._to_device(), lvl, iv, iv_to,
                                add, method)

    def fill_ghost(self, state, iv: int = IPHI, lvl: Optional[int] = None):
        dmaps = self._to_device()
        if lvl is not None:
            return self._fill_ghost_lvl(state, dmaps, lvl, iv)
        return self.fill_ghost_all(state, dmaps, iv)

    def restrict(self, state, iv: int):
        return self.restrict_all(state, self._to_device(), iv)

    def prepare_coefficient(self, state, iv: int = IVEPS):
        """Make a coefficient field usable on every level: restrict it
        down the hierarchy and fill its ghost cells (the reference
        expects eps present on all levels, m_vhelmholtz.f90:7-10)."""
        state = self.restrict(state, iv)
        return self.fill_ghost(state, iv)

    def apply_operator(self, state, lam=0.0, i_out: int = IRES):
        return self.apply_op(state, self._to_device(), float(lam), i_out)
