#!/usr/bin/env python3
"""CPU calibration of chip_smoke.py's 2D gates (no GPU needed).

    python experiments/twod_bounds_cpu.py floor       # ~15 s
    python experiments/twod_bounds_cpu.py agreement   # ~30 s

``floor``: the float32 residual floor of the dense 2D solve of bench.py
run_2d's problem (``build_rectangle(2, (n, n), 16)``, Dirichlet 0) with a
seeded normal rhs, n = 256 .. 2048: nine FMGs, the floor (least residual)
over the first FMG's residual.  It rises with n, which is why
``chip_smoke.py`` gates the 2D paths' convergence in float64
(``twod_f64_gate``) and holds the float32 histories to falling to their
floor (``check_floor_history``).

``agreement``: the bounds of ``twod_cpu_agreement``.  The card and the
CPU run the same IEEE operations except the direct coarse solve's two
matrix products (cuBLAS against the CPU's BLAS) and the periodic mean's
sum.  So each case of that phase runs twice on the CPU, once with the
coarse solve's result perturbed by up to 32 ulp per cell, and prints how
far phi (relative to max|phi|, in eps) and the residuals (relative to
the first) move; the refined solves (float32) likewise, x relative to
max|x| and the norms where above 1e-9 of the first.
"""
import sys
import time

import numpy as np
import torch

sys.path.insert(0, __file__.rsplit("/experiments/", 1)[0])
import octree_mg_tpu_torch as pkg  # noqa: E402
from octree_mg_tpu_torch.solve import dense as D  # noqa: E402

BVALS = [0.3, 0.0, 0.5, -0.25]
_direct = D.DenseMGSolver._coarse_direct


def perturbed(k):
    """_coarse_direct with its result scaled by 1 + k*eps*U(-1, 1)."""
    def f(self, state, lam):
        st = _direct(self, state, lam)
        x = st["phi"][self._unit0(self.levels[0])]
        g = torch.Generator().manual_seed(1)
        eps = torch.finfo(x.dtype).eps
        x.mul_(1 + k * eps * (2 * torch.rand(x.shape, generator=g,
                                             dtype=x.dtype) - 1))
        return st
    return f


def floor():
    for n in (256, 512, 1024, 2048):
        t0 = time.time()
        tree = pkg.build_rectangle(2, np.full(2, n), 16, np.full(2, 1.0 / n),
                                   np.zeros(2))
        sv = pkg.make_solver(tree, pkg.MGConfig(dtype=torch.float32,
                                                device="cpu"))
        st = sv.allocate()
        g = torch.Generator().manual_seed(41)
        sv.set_interior(st, sv.levels[-1], "rhs",
                        torch.randn((n, n), generator=g))
        h = []
        for i in range(9):
            st, r = sv.fas_fmg(st, have_guess=i > 0)
            h.append(float(r))
        print(f"{n}^2: floor / first {min(h) / h[0]:.3g}, last / first "
              f"{h[-1] / h[0]:.3g}, history "
              f"{[float(f'{v:.3g}') for v in h]} ({time.time() - t0:.1f} s)",
              flush=True)


def solver_case(kind, op, geom, periodic, k):
    D.DenseMGSolver._coarse_direct = perturbed(k) if k else _direct

    def bc_fn(x):
        return 0.25 + np.sin(3 * x[..., 0]) * np.cos(2 * x[..., 1])

    if kind == "amr":
        tree = pkg.build_amr_centered(2, 3, np.full(2, 32), 8,
                                      np.full(2, 1.0 / 32))
    else:
        tree = pkg.build_rectangle(
            2, np.full(2, 64), 8, np.full(2, 1.0 / 64),
            np.array([0.5, 0.0]) if geom == "cylindrical" else np.zeros(2),
            periodic=[periodic] * 2)
    sv = pkg.make_solver(tree, pkg.MGConfig(
        operator=op, geometry=geom, dtype=torch.float64, device="cpu"))
    if not periodic:
        sv.set_bc(0, pkg.BCType.DIRICHLET, fn=bc_fn)
    st = sv.allocate()
    rng = np.random.default_rng(64)
    for lvl in sv.levels:
        sv.set_interior(st, lvl, "rhs", rng.normal(size=sv._ishape(lvl)))
        x = sv.cell_centers(lvl)
        for d in range(sv.n_eps):
            sv.set_coefficient(st, 1.0 + 0.5 * np.cos(
                2 * np.pi * (x[..., d] + 0.1 * d)), d, lvl=lvl)
    if sv.n_eps:
        sv.prepare_coefficient(st)
    lam = 0.7 if op.endswith("helmholtz") else 0.0
    hist = []
    for i in range(3):
        st, r = sv.fas_fmg(st, lam=lam, have_guess=i > 0)
        hist.append(float(r))
    return {l: sv.interior(st, l, "phi").numpy().copy()
            for l in sv.levels}, hist


def refined_case(lam, k, n=64):
    D.DenseMGSolver._coarse_direct = perturbed(k) if k else _direct
    tree = pkg.build_rectangle(2, np.full(2, n), 16, np.full(2, 1.0 / n),
                               np.zeros(2))
    sv = pkg.make_solver(tree, pkg.MGConfig(
        operator="helmholtz" if lam else "laplacian", dtype=torch.float32,
        device="cpu"))
    rng = np.random.default_rng(n + 1)
    rh, rl = pkg.split_f64(rng.normal(size=(n, n)))
    xh, xl, norms, _ = pkg.solve_refined(
        sv, sv.allocate(), rh, rl, n_outer=8, lam=lam,
        bc_values=None if lam else BVALS)
    return xh.double().numpy() + xl.double().numpy(), norms


def agreement(k=32):
    eps = float(np.finfo(np.float64).eps)
    ops = ("laplacian", "helmholtz", "vlaplacian", "vhelmholtz", "ahelmholtz")
    cases = [("uniform", op, "cartesian", per) for op in ops
             for per in (False, True)]
    cases += [("uniform", "laplacian", "cylindrical", False)]
    cases += [("amr", op, "cartesian", False) for op in ops]
    cases += [("amr", "laplacian", "cylindrical", False)]
    worst = {"uniform": [0.0, 0.0], "amr": [0.0, 0.0]}
    for kind, op, geom, per in cases:
        a, ha = solver_case(kind, op, geom, per, 0)
        b, hb = solver_case(kind, op, geom, per, k)
        dphi = max(np.abs(a[l] - b[l]).max() / np.abs(a[l]).max()
                   for l in a) / eps
        dres = max(abs(x - y) for x, y in zip(ha, hb)) / abs(ha[0])
        worst[kind] = [max(worst[kind][0], dphi), max(worst[kind][1], dres)]
        print(f"{kind} {op} {geom} periodic={per}: phi {dphi:.3g} eps, "
              f"residuals {dres:.3g} of the first", flush=True)
    for kind, (p, r) in worst.items():
        print(f"{kind}: worst phi {p:.3g} eps, worst residual {r:.3g}")
    for lam in (0.0, 0.53):
        xa, na = refined_case(lam, 0)
        xb, nb = refined_case(lam, k)
        keep = [i for i, v in enumerate(na) if v > 1e-9 * na[0]]
        print(f"refined lam {lam}: x {np.abs(xa - xb).max() / np.abs(xa).max():.3g}"
              f" of max|x|, norms {max(abs(na[i] - nb[i]) / na[i] for i in keep):.3g}"
              f" relative ({len(keep)} compared)", flush=True)
    D.DenseMGSolver._coarse_direct = _direct


if __name__ == "__main__":
    torch.set_num_threads(4)
    what = sys.argv[1] if len(sys.argv) > 1 else "floor"
    {"floor": floor, "agreement": agreement}[what]()
