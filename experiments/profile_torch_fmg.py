#!/usr/bin/env python3
"""Where one FMG of the PyTorch package spends its time on one GPU.

    python3 experiments/profile_torch_fmg.py            # the uniform passes
    python3 experiments/profile_torch_fmg.py --vcoeff   # the coefficient ones
    python3 experiments/profile_torch_fmg.py --forest   # the forest ones
    python3 experiments/profile_torch_fmg.py --forest-periodic  # one of them
    python3 experiments/profile_torch_fmg.py --refined  # the refined outers
    python3 experiments/profile_torch_fmg.py --boxed    # the boxed solver
    python3 experiments/profile_torch_fmg.py --sharded  # the slab solver
    python3 experiments/profile_torch_fmg.py --amr      # the AMR solver

On the 512^3 float32 main path (``PoissonSolver(3, (512,)*3, 16)``,
Dirichlet 0, seeded random right-hand side) it prints, one JSON object
per line:

* ``profile`` — ``torch.profiler`` over a free-running loop of have-guess
  FMGs (``need_res=False``, one synchronisation at the end): wall ms per
  FMG, device time summed by kernel name, and the device's busy share
  (summed kernel time over wall time; one stream, so kernels never
  overlap).  If the profiler reports no device time the line says so and
  carries no share;
* ``profile_refined`` — the same pass over whole refined solves
  (``RefinedPoisson.solve``, ``n_outer`` outers and the closing
  residual): wall ms per outer, busy share, device time by kernel name
  per outer — the eager accumulation shows as its ten elementwise
  kernels beside ``residual_df32_kernel`` and the inner FMG's;
* ``residual_cost`` — ms per cycle of ``fas_fmg(need_res=True)`` followed
  by ``float(res)`` (what ``PoissonSolver.solve`` does every cycle)
  against ``need_res=False`` with one synchronisation at the end,
  alternating inside the process;
* ``float64`` — the six kernel entry points at 512^3 (prolongation
  256^3 -> 512^3) in float64 beside float32: median ms of 10, CUDA
  events, and the byte bound at 3.35 TB/s;
* ``profile_vcoeff`` — the ``profile`` pass for the variable-coefficient
  operators (``operator`` vhelmholtz and ahelmholtz, lam 1.5, smooth
  coefficients 1 + 0.5 cos(2 pi (x_d + 0.1 d)), restricted on the card);
* ``profile_refined_vcoeff`` — the ``profile_refined`` pass for the
  ahelmholtz refined solve (lam 0.31, three coefficient fields
  0.5 + U[0,1)): its outer is dominated by the plain-PyTorch
  ``residual_df32_vcoeff``, whose ~900 elementwise kernels show by name;
* ``profile_forest`` (``--forest`` only; ``--forest-periodic`` the
  periodic one alone) — the ``profile`` pass for the dense forests of
  ``chip_smoke.py``: the L forest at base 256, box 16 (``forest_path``)
  and the fully periodic forest at base 256, box 16
  (``forest_periodic``), float32: the busy share says how much of an FMG
  is the card's and how much the host's eager ghost assembly, the kernel
  names what runs, summed by the kernel rows of ``PERF.md`` section 6
  (``by_row``: row 2, the half-sweep of the periodic forest's sequential
  levels, the segment rows 1s and 5s, ...);
* ``profile_boxed`` (``--boxed`` only) — the same pass for
  ``chip_smoke.py``'s ``boxed_path`` float64 solve: the boxed solver
  (``MGSolver``) on the fully periodic sparse tree at base 256, box 16,
  the flat half-sweep kernel on; with the kernel launches and the
  coarse loop's host reads per FMG;
* ``--refined`` alone: ``profile_refined`` and ``profile_sharded_refined``
  (below), each with its ``by_row`` (rows 8 and 8z);
* ``profile_sharded``, ``profile_sharded_refined``,
  ``profile_sharded_vcoeff`` (``--sharded`` only) — the same pass for
  ``chip_smoke.py``'s ``sharded_path`` solver (512^3 float32 over 8 slabs
  on one card), for its refined solve (``ShardedRefinedPoisson``, the
  ``sharded_refined`` phase's float64 rhs, per outer) and for its
  ``sharded_vcoeff`` one (vhelmholtz at 512^3 over 8 slabs): the device
  time per FMG (per outer) of every kernel by name, and summed by the
  port's kernel rows (``by_row``: ``PERF.md`` section 6's 1z, 1ze, 5z,
  5ze, 7z, 8z ... and the copies and other PyTorch kernels), shows the slab
  kernels' share, which the stage clocks of a launch-bound FMG do not;
* ``profile_amr`` (``--amr`` only) — the same pass for ``chip_smoke.py``'s
  ``amr_path`` solver: bench.py amr's tree at level-1 size 512, box 16
  (three 512^3 levels, two of them patches with six refinement faces),
  float32, ones on the top patch (its problem): device ms per FMG against
  wall ms, busy share, kernel time by name and by row; the PyTorch
  kernels of the refinement-face planes (``DenseAMRMGSolver._planes``)
  and of the region correction's window fall under ``other`` and
  ``copies``.

Needs a CUDA device and nvcc.
"""
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import octree_mg_tpu_torch as pkg  # noqa: E402
from octree_mg_tpu_torch.ops import dense_kernels as dk  # noqa: E402

N = 512
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet


def emit(obj):
    print(json.dumps(obj), flush=True)


def main_path():
    ps = pkg.PoissonSolver(3, (N,) * 3, 16, dtype=torch.float32)
    ps.set_dirichlet(0.0)
    g = torch.Generator(device="cuda").manual_seed(0)
    ps.set_rhs(arrays={ps.solver.levels[-1]: torch.randn(
        (N,) * 3, generator=g, device="cuda")})
    ps.solve(rtol=0.0, max_cycles=3)
    return ps


def loop_ms(ps, n, need_res):
    """ms per have-guess FMG over n in a row."""
    sv = ps.solver
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        _, res = sv.fas_fmg(ps.state, have_guess=True, need_res=need_res)
        if need_res:
            float(res)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def profiled(run, n, unit, top=20):
    """``run()`` (returns wall ms per unit over n units) under
    ``torch.profiler``: device time by kernel name per unit (the ``top``
    largest; None: every kernel) and the busy share; ``run`` once more
    with the profiler off beside it."""
    from torch.profiler import ProfilerActivity, profile
    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = run()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
        on_device = str(getattr(ev, "device_type", "")).endswith("CUDA")
        if on_device and dev_us > 0:
            rows.append({"kernel": ev.key[:100],
                         f"calls_per_{unit}": ev.count / n,
                         f"device_ms_per_{unit}": 1e-3 * dev_us / n})
    rows.sort(key=lambda r: -r[f"device_ms_per_{unit}"])
    busy = sum(r[f"device_ms_per_{unit}"] for r in rows)
    out = {f"{unit}s": n, f"wall_ms_per_{unit}_profiler_on": wall,
           f"wall_ms_per_{unit}_profiler_off": run()}
    if rows:
        out.update({f"device_ms_per_{unit}": busy, "busy_share": busy / wall,
                    f"device_calls_per_{unit}": sum(
                        r[f"calls_per_{unit}"] for r in rows),
                    "by_kernel": rows[:top]})
    else:
        out["device_time"] = "not measured: the profiler saw no device events"
    return out


def phase_profile(ps, n=4):
    emit({"profile": profiled(lambda: loop_ms(ps, n, False), n, "fmg")})


def phase_profile_refined(ps, n_outer=6):
    """Whole refined solves on a seeded float64 right-hand side."""
    g = torch.Generator(device="cuda").manual_seed(1)
    rhs = torch.randn((N,) * 3, generator=g, dtype=torch.float64,
                      device="cuda")
    rh = rhs.float()
    rl = (rhs - rh.double()).float()
    del rhs
    rp = pkg.RefinedPoisson(ps.solver)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rp.solve(ps.state, rh, rl, n_outer=n_outer)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n_outer

    emit({"profile_refined": by_row(profiled(run, n_outer, "outer",
                                             top=None), "outer")})


def phase_residual_cost(ps):
    rows = []
    for need_res in (False, True, True, False) * 2:
        loop_ms(ps, 2, need_res)
        rows.append({"need_res_and_host_read": need_res,
                     "ms_per_cycle": loop_ms(ps, 8, need_res)})
    emit({"residual_cost": rows})


def time_ms(fn, reps=10):
    fn(), fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def phase_float64():
    rows = []
    for dtype in (torch.float32, torch.float64):
        item = 4 if dtype == torch.float32 else 8

        def level(n):
            cfg = dk.DenseStencilConfig(
                (n,) * 3, (float(n * n),) * 3, [(2.0, -1.0, 0.0)] * 6,
                (False,) * 3, dtype, b_const=[0.0] * 6)
            return cfg, [torch.randn(cfg.pshape, device="cuda", dtype=dtype)
                         for _ in range(2)]

        cfg, (phi, rhs) = level(N)
        cfg_c, (phi_c, iold_c) = level(N // 2)
        bp = [None] * 6
        n_f, n_c = N ** 3, (N // 2) ** 3
        cases = {
            "pair_sweep_dense": (3 * n_f, lambda: dk.pair_sweep_dense(
                cfg, phi, rhs, 0.0, bp, 0, n_pairs=2)),
            "stencil_apply_dense": (3 * n_f, lambda: dk.stencil_apply_dense(
                cfg, phi, rhs, 0.0, bp, True)),
            "downsweep_dense": (3 * n_f + 2 * n_c, lambda: dk.downsweep_dense(
                cfg, phi, rhs, 0.0, bp, 0)),
            "residual_restrict_dense": (
                2 * n_f + 2 * n_c,
                lambda: dk.residual_restrict_dense(cfg, phi, rhs, 0.0, bp)),
            "restrict_dense": (n_f + n_c, lambda: dk.restrict_dense(cfg, phi)),
            "prolong_correct_dense": (
                2 * n_c + 2 * n_f,
                lambda: dk.prolong_correct_dense(cfg_c, phi_c, iold_c, phi, bp)),
        }
        for name, (cells, fn) in cases.items():
            rows.append({"name": name, "dtype": str(dtype)[6:],
                         "ms": time_ms(fn),
                         "bound_ms": 1e3 * cells * item / HBM_BYTES_PER_S})
        del phi, rhs, phi_c, iold_c
        torch.cuda.empty_cache()
    emit({"float64": rows})


def smooth_eps(sv, d):
    top = sv.levels[-1]
    x = (torch.arange(N, dtype=torch.float64, device="cuda") + 0.5) / N
    shape = [1, 1, 1]
    shape[2 - d] = N
    e = 1.0 + 0.5 * torch.cos(2 * torch.pi * (x + 0.1 * d))
    return e.view(shape).expand(*sv._ishape(top)).float()


def phase_profile_vcoeff(n=4):
    for op in ("vhelmholtz", "ahelmholtz"):
        ps = pkg.PoissonSolver(3, (N,) * 3, 16, operator=op,
                               dtype=torch.float32)
        ps.set_dirichlet(0.0)
        sv = ps.solver
        st = ps._ensure_state()
        for d in range(sv.n_eps):
            sv.set_coefficient(st, smooth_eps(sv, d), d)
        sv.prepare_coefficient(st)
        g = torch.Generator(device="cuda").manual_seed(0)
        ps.set_rhs(arrays={sv.levels[-1]: torch.randn(
            (N,) * 3, generator=g, device="cuda")})
        ps.solve(lam=1.5, rtol=0.0, max_cycles=3)

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                sv.fas_fmg(st, lam=1.5, have_guess=True, need_res=False)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / n

        emit({"profile_vcoeff": {"operator": op, **profiled(run, n, "fmg")}})
        del ps, sv, st
        torch.cuda.empty_cache()


def phase_profile_refined_vcoeff(n_outer=2):
    tree = pkg.build_rectangle(3, (N,) * 3, 16, (1.0 / N,) * 3, (0.0,) * 3)
    sv = pkg.make_solver(tree, pkg.MGConfig(operator="ahelmholtz",
                                            dtype=torch.float32))
    sv.set_bc(0, pkg.BCType.DIRICHLET, 0.0)
    st = sv.allocate()
    g = torch.Generator(device="cuda").manual_seed(1)
    eps = [0.5 + torch.rand((N,) * 3, generator=g, dtype=torch.float64,
                            device="cuda") for _ in range(3)]
    rhs = torch.randn((N,) * 3, generator=g, dtype=torch.float64,
                      device="cuda")
    rh = rhs.float()
    rl = (rhs - rh.double()).float()
    del rhs
    rp = pkg.RefinedPoisson(sv, lam=0.31, eps=eps)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rp.solve(st, rh, rl, n_outer=n_outer)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n_outer

    emit({"profile_refined_vcoeff": profiled(run, n_outer, "outer")})


def phase_profile_forest(n=4, base=256, kinds=("L", "periodic")):
    import chip_smoke
    from octree_mg_tpu_torch.core import tree as tm
    for name, kind, dirichlet in (("forest_path", "L", True),
                                  ("forest_periodic", "periodic", False)):
        if kind not in kinds:
            continue
        tree = chip_smoke.forest_tree(pkg, tm, kind, base, 16)
        torch.cuda.empty_cache()
        ps = pkg.PoissonSolver(3, (1,) * 3, 16, tree=tree,
                               dtype=torch.float32)
        if dirichlet:
            ps.set_dirichlet(0.0)
        top = ps.solver.levels[-1]
        g = torch.Generator(device="cuda").manual_seed(11)
        ps.set_rhs(arrays={top: torch.randn(ps.solver._ishape(top),
                                            generator=g, device="cuda")})
        ps.solve(rtol=0.0, max_cycles=3)
        emit({"profile_forest": {"name": name, "base": base, **by_row(
            profiled(lambda: loop_ms(ps, n, False), n, "fmg", top=None),
            "fmg")}})
        del ps


def phase_profile_sharded(n=4, parts=("fmg", "refined", "vcoeff")):
    """The ``profile`` pass for the slab solver: chip_smoke.py's
    ``sharded_path`` problem (the main path's 512^3 level and rhs over 8
    slabs on the card) and its ``sharded_vcoeff`` one (vhelmholtz at
    512^3 over 8 slabs, lam 1.5, smooth coefficients), each after three
    FMGs."""
    import chip_smoke

    def profile(ss, st, lam):
        chip_smoke.run_fmgs(ss, st, 3, lam)

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                ss.fas_fmg(st, lam=lam, have_guess=True, need_res=False)
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / n

        return by_row(profiled(run, n, "fmg", top=None), "fmg")

    _, ss = chip_smoke.dense_pair(pkg, N, 8)
    if "fmg" in parts:
        g = torch.Generator(device="cuda").manual_seed(0)
        st = chip_smoke.seeded_state(ss, torch.randn((N,) * 3, generator=g,
                                                     device="cuda"))
        emit({"profile_sharded": profile(ss, st, 0.0)})
        del st
        torch.cuda.empty_cache()
    if "refined" in parts:
        phase_profile_sharded_refined(ss)
    del ss
    torch.cuda.empty_cache()
    if "vcoeff" not in parts:
        return
    sd, ss = chip_smoke.dense_pair(pkg, N, 8, operator="vhelmholtz")
    g = torch.Generator(device="cuda").manual_seed(5)
    rhs = torch.randn((N,) * 3, generator=g, device="cuda")
    st = chip_smoke.seeded_state(
        ss, rhs, (chip_smoke.smooth_eps(sd, 0, torch.float32),))
    del sd, rhs
    emit({"profile_sharded_vcoeff": profile(ss, st, 1.5)})
    del ss, st


def phase_profile_sharded_refined(ss, n_outer=4):
    """The profile pass over the slab solver's refined outers
    (chip_smoke.py's sharded_refined rhs)."""
    import chip_smoke
    from octree_mg_tpu_torch.ops import df32 as df
    rh, rl = df.split_f64(chip_smoke.seeded_rhs64(N, 1))
    rp = pkg.ShardedRefinedPoisson(ss)
    st = ss.allocate()

    def outers():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rp.solve(st, rh, rl, n_outer=n_outer)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n_outer

    emit({"profile_sharded_refined": by_row(
        profiled(outers, n_outer, "outer", top=None), "outer")})
    del st, rp, rh, rl


#: kernel names (demangled, as the profiler gives them) by the row of
#: PERF.md section 6 they run: (row, a pattern of the name), first match
ROW_PATTERNS = [
    ("1z wide", r"wide_kernel<float, [24], 0, 1"),
    ("1z", r"stream_kernel<\w+, [24], 0, 0, 0, 1>"),
    ("1ze face-plane", r"face_kernel<float, [24], 0, [13], 1>"),
    ("1ze", r"stream_kernel<\w+, [24], 0, [13], 0, 1>"),
    ("5z face-plane", r"apply_faces_kernel<\w+, [12], 0, 0, 1>"),
    ("5ze face-plane", r"apply_faces_kernel<\w+, [12], [13], 0, 1>"),
    ("5z", r"stream_kernel<\w+, 0, [12], 0, 0, 1>"),
    ("5ze", r"stream_kernel<\w+, 0, [12], [13], 0, 1>"),
    ("7z pair", r"prolong_pair_kernel<"),
    ("7z", r"prolong_correct_kernel<\w+, 0, 1>"),
    ("8z", r"residual_df32_kernel<1>"),
    ("8", r"residual_df32_kernel<0>"),
    ("8z march", r"df32_march_kernel<1>"),
    ("8 march", r"df32_march_kernel<0>"),
    ("2 march", r"half_march_kernel<"),
    ("2", r"stream_kernel<\w+, 1, 0, 0, 0, 0>"),
    ("1s wide", r"wide_kernel<float, [24], 0, 0, 1>"),
    ("5s face-plane", r"apply_faces_kernel<\w+, [12], 0, 1, 0>"),
    ("1s/5s", r"stream_kernel<\w+, \d, [012], 0, 1, 0>"),
    ("7c", r"prolong_correct_kernel<\w+, 2, 0>"),
    ("1/3 wide", r"wide_kernel<"),
    ("1e/3e face-plane", r"face_kernel<"),
    ("4/4e/5e face-plane", r"apply_faces_kernel<"),
    ("7", r"prolong_correct_kernel<"),
    ("6", r"restrict_kernel<"),
    ("1-5 stream", r"stream_kernel<"),
    ("copies", r"[Cc]opy|memcpy|Memcpy"),
]


def by_row(out, unit):
    """``profiled``'s result with the device time per unit summed by the
    kernel row each kernel runs (ROW_PATTERNS; the rest under
    ``other``)."""
    import re
    rows = {}
    for r in out.get("by_kernel", []):
        name = r["kernel"].replace("(int)", "")
        row = next((k for k, pat in ROW_PATTERNS if re.search(pat, name)),
                   "other")
        agg = rows.setdefault(row, {f"calls_per_{unit}": 0.0,
                                    f"device_ms_per_{unit}": 0.0})
        agg[f"calls_per_{unit}"] += r[f"calls_per_{unit}"]
        agg[f"device_ms_per_{unit}"] += r[f"device_ms_per_{unit}"]
    out["by_row"] = dict(sorted(rows.items(),
                                key=lambda kv: -kv[1][f"device_ms_per_{unit}"]))
    return out


def phase_profile_amr(n=4, size=512):
    import chip_smoke
    torch.cuda.empty_cache()
    ps, _, _ = chip_smoke.amr_poisson(pkg, size)
    sv = ps.solver
    top = sv.levels[-1]
    ps.set_rhs(arrays={top: torch.ones(sv._ishape(top), device="cuda")})
    ps.solve(rtol=0.0, max_cycles=3)
    emit({"profile_amr": {"size": size, **by_row(
        profiled(lambda: loop_ms(ps, n, False), n, "fmg", top=None),
        "fmg")}})


def phase_profile_boxed(n=4):
    import chip_smoke
    from octree_mg_tpu_torch.core import tree as tm
    tree = chip_smoke.forest_tree(pkg, tm, "sparse_periodic", 256, 16)
    torch.cuda.empty_cache()
    ps = chip_smoke.boxed_poisson(pkg, tree, 256, 16, torch.float64)
    chip_smoke.seed_boxed_rhs(ps, tree, 16, torch.float64)
    ps.solve(rtol=0.0, max_cycles=3)
    sv = ps.solver
    sv.coarse_host_reads = 0
    out = profiled(lambda: loop_ms(ps, n, False), n, "fmg")
    # profiled() runs the loop three times (warm-up, profiled, off)
    out["coarse_host_reads_per_fmg"] = sv.coarse_host_reads / (3 * n)
    emit({"profile_boxed": out})


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("profile_torch_fmg: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"card": smi, "torch": torch.__version__})
    if "--forest" in sys.argv[1:]:
        phase_profile_forest()
        sys.exit(0)
    if "--forest-periodic" in sys.argv[1:]:
        phase_profile_forest(kinds=("periodic",))
        sys.exit(0)
    if "--refined" in sys.argv[1:]:
        solver = main_path()
        phase_profile_refined(solver)
        del solver
        torch.cuda.empty_cache()
        phase_profile_sharded(parts=("refined",))
        sys.exit(0)
    if "--boxed" in sys.argv[1:]:
        phase_profile_boxed()
        sys.exit(0)
    if "--sharded" in sys.argv[1:]:
        phase_profile_sharded()
        sys.exit(0)
    if "--amr" in sys.argv[1:]:
        phase_profile_amr()
        sys.exit(0)
    if "--vcoeff" not in sys.argv[1:]:
        solver = main_path()
        phase_profile(solver)
        phase_profile_refined(solver)
        phase_residual_cost(solver)
        del solver
        torch.cuda.empty_cache()
        phase_float64()
    phase_profile_vcoeff()
    phase_profile_refined_vcoeff()
