#!/usr/bin/env python3
"""Probe of the PyTorch package's streaming stencil kernels on one GPU.

    python3 experiments/probe_torch_kernels.py [tiles] [df32_blocks] [chunk]

Rebuilds ``stencil_sweep.cu``, ``downsweep.cu`` and ``residual_df32.cu`` with other build-time
constants (``-DOMG_TILE_X/Y``, ``-DOMG_CHUNK_Z``,
``-DOMG_MIN_BLOCKS_PER_SM``) into ``build/probe`` and prints, one JSON
object per line:

* ``tiles``  — double pair and downsweep at 512^3 float32 for a list of
  (tile x, tile y, chunk z) shapes, median of 8, CUDA events;
* ``df32_blocks`` — the double-float residual kernel
  (``residual_df32.cu``) at 512^3 for a list of thread-block shapes
  (``-DOMG_DF32_BX/BY/BZ``), median of 8, CUDA events, the shipped shape
  first and last;
* ``chunk``  — ms per have-guess FMG of the 512^3 float32 main path with
  the z chunk fixed at 64 against the shipped choice by level size,
  alternating inside one process (fixed, chosen, chosen, fixed, ...).

Needs a CUDA device and nvcc; the shipped kernels are not changed.
"""
import ctypes
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
from octree_mg_tpu_torch.ops import _cuda_build as cb  # noqa: E402
from octree_mg_tpu_torch.ops import dense_kernels as dk  # noqa: E402

CSRC = os.path.join(ROOT, "octree_mg_tpu_torch", "csrc")
OUT = os.path.join(cb.build_dir(), "probe")
SYMS = {"stencil_sweep": "omg_stencil_sweep", "downsweep": "omg_downsweep"}
SHAPES = [(32, 16, 64), (32, 8, 64), (32, 16, 128), (32, 16, 32), (64, 8, 64),
          (64, 16, 64), (32, 32, 64), (16, 16, 64), (32, 12, 64)]


def build(tag, flags, syms=SYMS):
    """The sources of ``syms`` with extra flags; returns {symbol: ctypes
    function}."""
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for name in syms:
        so = os.path.join(OUT, f"{name}_{tag}.so")
        procs.append(subprocess.Popen(
            [cb._nvcc(), *cb.NVCC_FLAGS, *flags, "-I", CSRC, "-o", so,
             os.path.join(CSRC, name + ".cu")]))
    for p in procs:
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed for {tag}")
    fns = {}
    for name, sym in syms.items():
        f = getattr(ctypes.CDLL(os.path.join(OUT, f"{name}_{tag}.so")), sym)
        f.argtypes, f.restype = dk._ARGTYPES[sym], ctypes.c_int
        fns[sym] = f
    return fns


def time_ms(fn, reps=8):
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


def probe_tiles():
    n = 512
    cfg = dk.DenseStencilConfig((n,) * 3, (float(n * n),) * 3,
                                [(2.0, -1.0, 0.0)] * 6, (False,) * 3,
                                torch.float32, b_const=[0.0] * 6)
    phi = torch.randn(cfg.pshape, device="cuda")
    rhs = torch.randn(cfg.pshape, device="cuda")
    out = torch.empty_like(phi)
    pc = torch.empty(dk.padded_shape((n // 2,) * 3), device="cuda")
    rc = torch.empty_like(pc)
    st = torch.cuda.current_stream().cuda_stream
    P = dk._params(cfg, 0.0, [None] * 6, 0, 4)
    rows = []
    for tx, ty, cz in SHAPES:
        fns = build(f"{tx}_{ty}_{cz}", [f"-DOMG_TILE_X={tx}",
                                        f"-DOMG_TILE_Y={ty}",
                                        f"-DOMG_CHUNK_Z={cz}"])

        def pair():
            e = fns["omg_stencil_sweep"](0, 0, ctypes.byref(P), None,
                                         phi.data_ptr(), rhs.data_ptr(),
                                         out.data_ptr(), st)
            assert e == 0, e

        def down():
            e = fns["omg_downsweep"](0, 1, ctypes.byref(P), None,
                                     phi.data_ptr(),
                                     rhs.data_ptr(), out.data_ptr(),
                                     pc.data_ptr(), rc.data_ptr(), st)
            assert e == 0, e

        rows.append({"tile": [tx, ty, cz], "pair2_ms": time_ms(pair),
                     "downsweep_ms": time_ms(down)})
    print(json.dumps({"tiles": rows}), flush=True)


DF32_BLOCKS = [(32, 2, 2), (32, 1, 4), (32, 4, 1), (64, 2, 1), (32, 4, 2),
               (32, 2, 4), (64, 2, 2), (128, 2, 1), (32, 4, 4), (64, 4, 2),
               (128, 2, 2), (32, 8, 4), (32, 2, 2)]


def probe_df32_blocks():
    from octree_mg_tpu_torch.ops import df32 as df
    n = 512
    cfg = dk.DenseStencilConfig((n,) * 3, (float(n * n),) * 3,
                                [(2.0, -1.0, 0.0)] * 6, (False,) * 3,
                                torch.float32, b_const=[0.0] * 6)
    xhi = torch.randn(cfg.pshape, device="cuda")
    rhi = torch.randn(cfg.pshape, device="cuda")
    xlo, rlo = xhi * 2.0 ** -25, rhi * 2.0 ** -25
    out = torch.empty_like(xhi)
    want = df.residual_df32_dense(cfg, xhi, xlo, rhi, rlo).clone()
    st = torch.cuda.current_stream().cuda_stream
    P = dk._params(cfg, 0.0, [None] * 6)
    Q = df._Df32Params()
    rows = []
    for bx, by, bz in DF32_BLOCKS:
        fn = build(f"{bx}_{by}_{bz}",
                   [f"-DOMG_DF32_BX={bx}", f"-DOMG_DF32_BY={by}",
                    f"-DOMG_DF32_BZ={bz}"],
                   {"residual_df32": "omg_residual_df32"})["omg_residual_df32"]

        def run():
            e = fn(ctypes.byref(P), ctypes.byref(Q), xhi.data_ptr(),
                   xlo.data_ptr(), rhi.data_ptr(), rlo.data_ptr(),
                   out.data_ptr(), st)
            assert e == 0, e

        ms = time_ms(run)
        rows.append({"block": [bx, by, bz], "ms": ms,
                     "bitwise": bool(torch.equal(out[dk._ISL],
                                                 want[dk._ISL]))})
    print(json.dumps({"df32_blocks": rows}), flush=True)


def probe_chunk():
    ps = pkg.PoissonSolver(3, (512,) * 3, 16, dtype=torch.float32)
    ps.set_dirichlet(0.0)
    sv = ps.solver
    g = torch.Generator(device="cuda").manual_seed(0)
    ps.set_rhs(arrays={sv.levels[-1]: torch.randn((512,) * 3, generator=g,
                                                  device="cuda")})
    ps.solve(rtol=0.0, max_cycles=3)
    chosen = {s: dk._fns[s] for s in SYMS.values()}
    fixed = build("fixed_chunk", ["-DOMG_MIN_BLOCKS_PER_SM=0"])

    def run(n=8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            sv.fas_fmg(ps.state, have_guess=True, need_res=False)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    rows = []
    for which in ("fixed", "chosen", "chosen", "fixed") * 2:
        dk._fns.update(fixed if which == "fixed" else chosen)
        run(2)
        rows.append({"chunk": which, "ms_per_fmg": run()})
    dk._fns.update(chosen)
    print(json.dumps({"chunk": rows}), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("probe_torch_kernels: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    only = sys.argv[1:]
    for name, probe in (("tiles", probe_tiles),
                        ("df32_blocks", probe_df32_blocks),
                        ("chunk", probe_chunk)):
        if not only or name in only:
            probe()
