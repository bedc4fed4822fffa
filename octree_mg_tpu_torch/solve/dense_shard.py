"""The z-slab dense solver: the port of the JAX package's
``solve/dense_shard.py`` (``ShardedDenseMGSolver``).

Each uniform level is split into K z-slabs; the only communication of
the smoother is the z halo, which the exchange copies from the
neighbouring slabs' boundary planes into each slab's z pads (the
reference's per-face isend/irecv, ``m_communication.f90:37-66``).
Coarse levels whose slabs would be thinner than ``MIN_LOCAL_Z`` planes
are replicated (the reference's coarse-level agglomeration,
``m_load_balance.f90:27-29``), as is the coarsest cycled level.

Layout: a sharded level is stored as ``[K, Zl+2*PZ, Y+2*PY, X]``, slab
``k`` at ``state[key][lvl][k]``, a padded dense level of its own whose z
pads double as the halo receive buffers; a replicated level has the
single-device layout.  The x- and y-face boundary planes of a sharded
level are stacked per slab (``[K, Zl+2*PZ, ...]``, overlapping rows);
its z-face planes are the global ones.

Every phase runs slab by slab through the entry points of
``ops/dense_kernels``, each launch with its slab's ``z_gates`` = (first
slab, last slab): only those synthesize a physical z ghost, the others
read their pads (on the card the kernels' slab variants).  The
exchange, the reductions (the ``pmax`` of the residual norm, the
``psum`` of the mean) and the gather at the sharded -> replicated
transition go through one small object, :class:`LocalSlabs`: K slabs of
one process on one device, the exchange a device-to-device copy.  A
``torch.distributed`` backend with one slab per process is a second
class with the same four methods (ROADMAP A13c).

Differences from the JAX package, all of TPU mechanics: no
``shard_map`` (the phases loop over the slabs); the fused transfer
kernels stay off on sharded levels as there, but the gated prolongation
kernel covers every sharded coarse level, so ``_corr_with_ring_sharded``
(the JAX package's path where Mosaic's tiling gate fails) is not needed;
on the card sharded levels take double pairs, as the dense path does.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..core.tree import Tree
from ..ops import dense_kernels as dk
from .dense import DenseMGSolver, _ISL
from .multigrid import MGConfig

#: minimum local slab thickness to keep a level sharded; thinner levels
#: are replicated (coarse-level agglomeration)
MIN_LOCAL_Z = 4

#: interior of every slab of a stacked level
_ISL4 = (slice(None),) + _ISL


class LocalSlabs:
    """K z-slabs held by one process on one device.

    The solver asks this object for everything that crosses slabs:
    ``exchange`` (the halo), ``max`` and ``sum`` (reductions of per-slab
    values) and ``gather`` (per-slab coarse interiors into the whole
    level).  Arrays are stacks of the slabs this process holds, in the
    order of ``shards`` (their global indices): here all K of them."""

    def __init__(self, n_shards: int):
        self.K = int(n_shards)
        self.shards = tuple(range(self.K))

    def exchange(self, arr: torch.Tensor, zl: int, periodic: bool,
                 depth: int) -> torch.Tensor:
        """In place on a stack [K, Zl+2PZ, ...]: each slab's z pads,
        ``depth`` planes each side, receive its neighbours' boundary
        interior planes; on a periodic axis the first and last slab are
        neighbours."""
        PZ, e = dk.PZ, depth
        top = arr[:, zl + PZ - e:zl + PZ]
        bot = arr[:, PZ:PZ + e]
        arr[1:, PZ - e:PZ] = top[:-1]
        arr[:-1, zl + PZ:zl + PZ + e] = bot[1:]
        if periodic:
            arr[0, PZ - e:PZ] = top[-1]
            arr[-1, zl + PZ:zl + PZ + e] = bot[0]
        return arr

    def max(self, per_slab: torch.Tensor) -> torch.Tensor:
        return per_slab.max()

    def sum(self, per_slab: torch.Tensor) -> torch.Tensor:
        return per_slab.sum()

    def gather(self, slabs: List[torch.Tensor]) -> torch.Tensor:
        """The slabs' interiors [Zl', Y', X'] stacked along z, in global
        order: the whole level's interior."""
        return torch.cat(slabs, 0)


class ShardedDenseMGSolver(DenseMGSolver):
    """Dense solver over ``n_shards`` z-slabs (see the module docstring).

    State: as :class:`DenseMGSolver`'s, with the sharded levels' fields
    ``[K, Zl+2*PZ, Y+2*PY, X]`` and their x/y boundary planes stacked per
    slab; ``self.sharded[lvl]`` says which levels are sharded.  Updated
    in place.  ``fas_vcycle`` runs whole cycles only (``max_lvl=None``);
    ``MGConfig.fmg_mode="fused"`` is refused."""

    def __init__(self, tree: Tree, config: Optional[MGConfig] = None, *,
                 n_shards: int):
        cfg = config or MGConfig()
        if cfg.fmg_mode != "split":
            raise NotImplementedError(
                "ShardedDenseMGSolver: fmg_mode='fused' (CUDA graphs of the "
                "slab solver) waits for ROADMAP A13d")
        self.comm = LocalSlabs(n_shards)
        self.K = self.comm.K
        super().__init__(tree, cfg)
        self._isl = (Ellipsis,) + _ISL
        self.sharded: Dict[int, bool] = {}
        for lvl in self.levels:
            X, Y, Z = self.dims[lvl]
            # the coarsest cycled level never shards (the direct coarse
            # solve works on it globally); an even Zl keeps the local
            # red/black parity the global one
            self.sharded[lvl] = (lvl != self.levels[0]
                                 and Z % self.K == 0
                                 and (Z // self.K) % 2 == 0
                                 and Z // self.K >= MIN_LOCAL_Z
                                 and self.K > 1)

    # -- local kernel configs ------------------------------------------
    def _kcfg(self, lvl: int) -> dk.DenseStencilConfig:
        cfg = super()._kcfg(lvl)
        if not self.sharded.get(lvl):
            return cfg
        return self._z_cfg(cfg, self._zl(lvl))

    @staticmethod
    def _z_cfg(cfg, z: int) -> dk.DenseStencilConfig:
        """cfg with z extent z (a slab, or an edge strip of one)."""
        return dk.DenseStencilConfig(
            dims=(cfg.X, cfg.Y, z), idr2=cfg.idr2, bc=cfg.bc,
            periodic=cfg.periodic, dtype=cfg.dtype, b_const=cfg.b_const,
            n_eps=cfg.n_eps)

    def _zl(self, lvl: int) -> int:
        return self.dims[lvl][2] // self.K

    def _gates(self, lvl: int, k: int):
        """Slab k's (lo, hi) z-face gates on a sharded level, else None."""
        if not self.sharded[lvl]:
            return None
        return (k == 0, k == self.K - 1)

    def _stacked_plane(self, lvl: int, nb: int) -> bool:
        """Whether face nb's boundary plane is stacked per slab."""
        return (self.sharded[lvl] and nb < 4
                and not self.periodic[nb // 2])

    def _slab_planes(self, bp, lvl: int, i: int):
        """The boundary planes slab i (local index) reads."""
        return [p[i] if self._stacked_plane(lvl, nb) else p
                for nb, p in enumerate(bp)]

    # ------------------------------------------------------------------
    # state (sharded layout)
    # ------------------------------------------------------------------
    def _field_shape(self, lvl: int):
        shape = tuple(self._kcfgs[lvl].pshape)
        return (self.K,) + shape if self.sharded[lvl] else shape

    def _bc_plane_shape(self, lvl: int, nb: int):
        shape = super()._bc_plane_shape(lvl, nb)
        return (self.K,) + shape if self._stacked_plane(lvl, nb) else shape

    def allocate(self) -> Dict:
        dt, dev = self.cfg.dtype, self.device
        state: Dict = {k: {} for k in self._field_keys}
        state["bc"] = {}
        for lvl in self.levels:
            shape = self._field_shape(lvl)
            for k in ("phi", "rhs", "iold", "ires"):
                state[k][lvl] = torch.zeros(shape, dtype=dt, device=dev)
            for k in self._eps_keys:
                state[k][lvl] = torch.ones(shape, dtype=dt, device=dev)
            state["bc"][lvl] = self._alloc_bc(lvl)
        return state

    def _alloc_bc(self, lvl: int) -> List[torch.Tensor]:
        """Boundary planes in the sharded layout: the x/y-face planes span
        z and are stacked as overlapping slab windows; the z-face planes
        are the global ones."""
        planes = self._eval_bc_planes(lvl)
        Zl, PZ = self._zl(lvl), dk.PZ
        return [torch.stack([p[k * Zl:k * Zl + Zl + 2 * PZ]
                             for k in self.comm.shards])
                if self._stacked_plane(lvl, nb) else p
                for nb, p in enumerate(planes)]

    def set_interior(self, state, lvl, key, values):
        """Write the interior [Z, Y, X] of a variable, in place."""
        if not self.sharded[lvl]:
            return super().set_interior(state, lvl, key, values)
        X, Y, _ = self.dims[lvl]
        v = torch.as_tensor(values).to(self.device, self.cfg.dtype)
        state[key][lvl][_ISL4] = v.reshape(self.K, self._zl(lvl), Y, X)
        return state

    def interior(self, state, lvl, key):
        """The interior [Z, Y, X] of a variable (a copy on sharded
        levels)."""
        if not self.sharded[lvl]:
            return super().interior(state, lvl, key)
        X, Y, Z = self.dims[lvl]
        return state[key][lvl][_ISL4].reshape(Z, Y, X)

    def prepare_coefficient(self, state):
        """Restrict the coefficient field(s) down every level, in place,
        slab by slab and through the sharded -> replicated transition
        (the restriction's order and values are the single-device
        solver's)."""
        for key in self._eps_keys:
            for lvl in range(self.levels[-1], self.levels[0], -1):
                state = self._restrict_into(state, lvl, key)
        self._direct = None
        return state

    # ------------------------------------------------------------------
    # the exchange
    # ------------------------------------------------------------------
    def _sync_z(self, arr, lvl):
        """z halo exchange of a sharded level, in place: min(PZ, Zl)
        planes each side, one exchange feeding the double pair's whole
        4-deep halo."""
        zl = self._zl(lvl)
        return self.comm.exchange(arr, zl, self.periodic[2], min(dk.PZ, zl))

    def _sync_y(self, arr, lvl):
        """The y-periodic pads of every slab, in place: the plain versions
        read them; the kernels read wrapped y indices instead."""
        if arr.is_cuda:
            return arr
        return dk.sync_pads(self._kcfgs[lvl], arr, slab=True)

    def _sync_pads(self, arr, lvl):
        if not self.sharded[lvl]:
            return super()._sync_pads(arr, lvl)
        return self._sync_y(self._sync_z(arr, lvl), lvl)

    # ------------------------------------------------------------------
    # building blocks on sharded levels
    # ------------------------------------------------------------------
    def _slab_pairs(self, cfg, lvl, phi, rhs, lam, bp, eps, k, out,
                    z0=0, h=None):
        """pair_sweep_dense on every slab, into out's core: the whole slab
        (h None), or the window of h + 2*PZ planes at z0 with the gate of
        the face it does not touch off (an edge strip)."""
        for i, s in enumerate(self.comm.shards):
            zg = self._gates(lvl, s)
            planes = self._slab_planes(bp, lvl, i)
            fields = [phi[i], rhs[i], out[i]] + [e[i] for e in eps]
            if h is not None:
                w = slice(z0, z0 + h + 2 * dk.PZ)
                zg = (zg[0], False) if z0 == 0 else (False, zg[1])
                planes = [p[w] if self._stacked_plane(lvl, nb) else p
                          for nb, p in enumerate(planes)]
                fields = [f[w] for f in fields]
            dk.pair_sweep_dense(cfg, fields[0], fields[1], lam, planes, 0,
                                n_pairs=k, eps=tuple(fields[3:]),
                                z_gates=zg, out=fields[2])

    def _overlapped_pairs(self, lvl, cfg, phi, rhs, lam, bp, k, eps, out):
        """Halo-overlapped pair group: sweep every whole slab from the
        data before the exchange (cells whose dependency cone, h =
        2*n_pairs planes, reaches the halo come out wrong), exchange, then
        recompute the two h-plane edge strips of each slab with the fresh
        halo into out.  Bitwise the exchange-then-sweep order: an edge
        cell is computed by the same per-cell arithmetic on a window."""
        Zl, h = self._zl(lvl), 2 * k
        self._sync_y(phi, lvl)
        self._slab_pairs(cfg, lvl, phi, rhs, lam, bp, eps, k, out)
        self._sync_z(phi, lvl)
        ecfg = self._z_cfg(cfg, h)
        for z0 in (0, Zl - h):
            self._slab_pairs(ecfg, lvl, phi, rhs, lam, bp, eps, k, out,
                             z0=z0, h=h)

    def _smooth(self, state, lvl, n_cycle, lam):
        if not self.sharded[lvl]:
            return super()._smooth(state, lvl, n_cycle, lam)
        cfg = self._kcfgs[lvl]
        phi = state["phi"][lvl]
        rhs = self._sync_pads(state["rhs"][lvl], lvl)
        bp = state["bc"][lvl]
        eps = self._eps(state, lvl)
        rem = n_cycle
        while rem > 0:
            k = 2 if (rem >= 2 and phi.is_cuda) else 1
            out = torch.empty_like(phi)
            if self.cfg.overlap_halo and self._zl(lvl) >= 4 * k:
                self._overlapped_pairs(lvl, cfg, phi, rhs, lam, bp, k, eps,
                                       out)
            else:
                self._sync_pads(phi, lvl)
                self._slab_pairs(cfg, lvl, phi, rhs, lam, bp, eps, k, out)
            phi = out
            rem -= k
        state["phi"][lvl] = phi
        return state

    def _fused_transfer_ok(self, state, lvl):
        # the fused down-leg kernels restrict inside their tile, across
        # what would be slab boundaries: a transfer from or to a sharded
        # level runs the separate kernels (the JAX package's rule)
        if self.sharded[lvl] or self.sharded.get(lvl - 1):
            return False
        return super()._fused_transfer_ok(state, lvl)

    def _slab_apply(self, state, lvl, lam, residual, out):
        cfg = self._kcfgs[lvl]
        phi = self._sync_pads(state["phi"][lvl], lvl)
        rhs, bp = state["rhs"][lvl], state["bc"][lvl]
        eps = self._eps(state, lvl)
        for i, s in enumerate(self.comm.shards):
            dk.stencil_apply_dense(cfg, phi[i], rhs[i], lam,
                                   self._slab_planes(bp, lvl, i), residual,
                                   eps=tuple(e[i] for e in eps),
                                   z_gates=self._gates(lvl, s), out=out[i])
        return out

    def _residual(self, state, lvl, lam):
        if not self.sharded[lvl]:
            return super()._residual(state, lvl, lam)
        self._slab_apply(state, lvl, lam, True, state["ires"][lvl])
        return state

    def _apply_op(self, state, lvl, lam):
        if not self.sharded[lvl]:
            return super()._apply_op(state, lvl, lam)
        return self._slab_apply(state, lvl, lam, False,
                                torch.empty_like(state["phi"][lvl]))

    def _max_residual(self, state, lvl, lam):
        if not self.sharded[lvl]:
            return super()._max_residual(state, lvl, lam)
        state = self._residual(state, lvl, lam)
        per_slab = state["ires"][lvl][_ISL4].abs().amax(dim=(1, 2, 3))
        return state, self.comm.max(per_slab)

    def _restrict_into(self, state, lvl, key):
        """Full weighting lvl -> lvl-1 slab by slab (the restriction
        reads interiors only), into the coarse slabs, or gathered into a
        replicated coarse level at the transition; in place."""
        if not self.sharded[lvl]:
            return super()._restrict_into(state, lvl, key)
        cfg, fine = self._kcfgs[lvl], state[key][lvl]
        if self.sharded[lvl - 1]:
            coarse = state[key][lvl - 1]
            for i in range(len(self.comm.shards)):
                dk.restrict_dense(cfg, fine[i], out=coarse[i])
            return state
        slabs = [dk.restrict_dense(cfg, fine[i])[_ISL]
                 for i in range(len(self.comm.shards))]
        state[key][lvl - 1][_ISL] = self.comm.gather(slabs)
        return state

    def _correct_children(self, state, lvl_c, lam):
        lvl = lvl_c + 1
        if not self.sharded[lvl_c] and not self.sharded[lvl]:
            return super()._correct_children(state, lvl_c, lam)
        phi_f = state["phi"][lvl]
        if self.sharded[lvl_c]:
            cfg_c, bp = self._kcfgs[lvl_c], state["bc"][lvl_c]
            phi_c = self._sync_pads(state["phi"][lvl_c], lvl_c)
            iold_c = self._sync_pads(state["iold"][lvl_c], lvl_c)
            for i, s in enumerate(self.comm.shards):
                dk.prolong_correct_dense(cfg_c, phi_c[i], iold_c[i],
                                         phi_f[i],
                                         self._slab_planes(bp, lvl_c, i),
                                         z_gates=self._gates(lvl_c, s))
            return state
        # replicated coarse -> sharded fine: every slab takes its z-window
        # of the whole level's correction ring and prolongs it
        corr = (self._var_with_ring(state, lvl_c, "phi")
                - self._var_with_ring(state, lvl_c, "iold"))
        Zlc = self.dims[lvl_c][2] // self.K
        for i, s in enumerate(self.comm.shards):
            phi_f[i][_ISL] += self._prolong_rect(
                corr[s * Zlc:s * Zlc + Zlc + 2])
        return state

    def _subtract_mean(self, state, key):
        top = self.levels[-1]
        if not self.sharded[top]:
            return super()._subtract_mean(state, key)
        X, Y, Z = self.dims[top]
        per_slab = state[key][top][_ISL4].sum(dim=(1, 2, 3))
        mean = self.comm.sum(per_slab) / float(X * Y * Z)
        for lvl in self.levels:
            state[key][lvl] -= mean
        return state

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------
    @torch.no_grad()
    def fas_vcycle(self, state, lam=0.0, max_lvl=None, need_res=True):
        """One whole FAS V-cycle (``max_lvl`` None), in place."""
        if max_lvl is not None:
            raise ValueError("ShardedDenseMGSolver: whole V-cycles only "
                             "(max_lvl=None), as in the JAX package")
        return super().fas_vcycle(state, lam, None, need_res)
