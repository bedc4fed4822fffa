#!/usr/bin/env python3
"""Probe of the PyTorch package's streaming stencil kernels on one GPU.

    python3 experiments/probe_torch_kernels.py [wide] [wide_fmg] [faces] [faces_fmg] [apply_faces] [rr_slab] [seg] [slab_apply] [slab_eps] [half] [df32_march] [sass] [tiles] [df32_blocks] [chunk]

Rebuilds ``stencil_sweep.cu``, ``downsweep.cu`` and ``residual_df32.cu``
(and ``seg_sweep.cu``, ``prolong_correct.cu``) with other build-time
constants (``-DOMG_WIDE``, ``-DOMG_FACES``, ``-DOMG_SEGWIDE``,
``-DOMG_SLABAP``, ``-DOMG_SLABEPS``, ``-DOMG_HALFAF``, ``-DOMG_DF32MARCH``,
``-DOMG_TILE_X/Y``, ``-DOMG_CHUNK_Z``, ``-DOMG_MIN_BLOCKS_PER_SM``)
into ``build/probe`` and prints, one JSON object per line:

* ``wide``   — the double pair and the down-leg (n_pairs 2) as shipped
  (the wide design of csrc/stream_wide.cuh where it takes the level)
  against the design before it (``-DOMG_WIDE=0``, stream_kernel.cuh
  alone), at every level from 512^3 to 16^3 in float32 and at 512^3 and
  256^3 in float64, in turns (old, new, new, old), median of 10 per
  turn, CUDA events, beside the byte bound at 3.35 TB/s; then old
  against new at 512^3, bitwise, for n_pairs 1 and 2 of both kernels in
  both dtypes (``wide_bitwise``), and the resources ptxas reports for
  both designs' instantiations (``wide_ptxas``);
* ``wide_fmg`` — the main path's have-guess FMG (512^3 float32, zero
  Dirichlet faces, seeded rhs) with both kernels of the old design
  (``old``), the wide double pair and the old down-leg (``pair``), and
  both wide (``new``), in turns (old, pair, new, new, pair, old), 10
  FMGs a turn: the device time (CUDA events) of the whole FMG and of its
  512^3 V-cycle stage, median per turn;
* ``faces``  — the coefficient double pair and down-leg (n_eps 1 and 3,
  n_pairs 2 and 1, coefficients 0.5 + U[0,1), lam 0.3, Dirichlet faces)
  as shipped (the face-plane design of csrc/stream_faces.cuh on every
  float32 launch) against the design before it (``-DOMG_FACES=0``,
  stream_kernel.cuh alone), at every level from 512^3 to 16^3 in
  float32, in turns (old, new, new, old), median of 10 per turn, CUDA
  events, with the design each launch ran and the byte bound at 3.35
  TB/s; then old against new at 512^3, bitwise, for n_pairs 1 and 2 of
  both kernels and both n_eps (``faces_bitwise``), and the resources
  ptxas reports for both designs' instantiations (``faces_ptxas``);
* ``faces_fmg`` — chip_smoke.py's ``vcoeff_path`` solver (512^3 float32,
  vhelmholtz and ahelmholtz, lam 1.5) after three FMGs: the device time
  (CUDA events) of a have-guess FMG and of its 512^3 V-cycle stage with
  the coefficient kernels of the old design (``-DOMG_FACES=0``:
  stream_kernel.cuh for every one) and of the shipped ones, in turns
  (old, new, new, old), median of 10 per turn;
* ``apply_faces`` — the coefficient apply, residual and residual-
  restriction (n_eps 1 and 3, coefficients 0.5 + U[0,1), lam 0.3,
  Dirichlet faces) as shipped (the face-plane apply of
  csrc/apply_faces.cuh on every coefficient launch) against the design
  before it (``-DOMG_FACES=0``, stream_kernel.cuh), at every level from
  512^3 to 16^3 in float32, in turns (old, new, new, old), median of 10
  per turn, CUDA events, with the design each launch ran and the byte
  bound at 3.35 TB/s; the same in float64; then the design forced on
  every launch (``-DOMG_FACES=2``) for constant coefficients (float32,
  512^3 to 128^3) against the old one; then old
  against new at 512^3, bitwise, for the three kernels and both n_eps
  (``apply_faces_bitwise``), and the resources ptxas reports for the
  face-plane apply's instantiations (``apply_faces_ptxas``);
* ``rr_slab`` — row 4, the constant-coefficient residual-restriction, as
  shipped (the face-plane apply of csrc/apply_faces.cuh without
  coefficients) against the design before it (``-DOMG_FACES=0``,
  stream_kernel.cuh) at every level from 512^3 to 16^3 in float32 and
  float64; and row 1z, the slab double pair (interior slab, gates off),
  as shipped (stream_wide.cuh with SLAB = 1 where wide_slab_takes)
  against the design before it (``-DOMG_WIDE=0``) on the whole slabs of
  the 512^3 .. 32^3 levels over 8 slabs (n_pairs 2 and 1) and the edge
  strips of the 512^3 and 256^3 levels' overlapped pair groups, float32
  (float64 slabs keep stream_kernel.cuh); in turns (old, new, new, old),
  median of 10 per turn, CUDA events, the design each launch ran and
  the byte bound at 3.35 TB/s; then old against new bitwise (row 4 at
  512^3 in both dtypes, row 1z on a 512^2 x 64 slab for both n_pairs and
  every gate pair) and the registers ptxas reports (``rr_slab_bitwise``,
  ``rr_slab_ptxas``);
* ``seg``    — rows 1s and 5s, the dense forest's segment double pair
  (n_pairs 2) and its residual and apply, as shipped (float32: the wide
  design of csrc/stream_wide.cuh with SEG = 1 where wide_seg_takes the
  canvas, the face-plane apply of csrc/apply_faces.cuh with SEG = 1)
  against the design before them (``-DOMG_SEGWIDE=0``, stream_kernel.cuh
  alone), on every segment canvas of chip_smoke.py's ``forest_path``
  forest (L tree, base 256, box 16: level 2's 512^3 canvas and levels 1
  and 3's 256^3 ones with their real ghost layers and planes after one
  FMG, the coarse canvases 128^3 .. 16^3 with theirs), in turns (old,
  new, new, old), median of 10 per turn, CUDA events, with the design
  each launch ran and the byte bound at 3.35 TB/s; old against new
  bitwise on every canvas and kind (``seg_bitwise``), and the registers
  and spills ptxas reports for both designs' instances (``seg_ptxas``);
* ``slab_apply`` — rows 5z and 7z of the z-slab solver: the slab apply
  and residual (constant coefficients) and the slab prolongation (add) as
  shipped (the face-plane apply of csrc/apply_faces.cuh with SLAB = 1
  where af_slab_takes, else stream_kernel.cuh; the pair kernel of
  csrc/prolong_correct.cu on every slab) against the designs before them
  (``-DOMG_SLABAP=0``: stream_kernel.cuh, the thread-per-coarse-cell
  kernel) on an interior slab (gates off) of each sharded level over 8
  slabs, 512^2 x 64 to 32^2 x 4 (the prolongation from each coarse slab,
  256^2 x 32 to 32^2 x 4), float32, and 32^2 x 4 in float64, in turns
  (old, new, new, old), median of 10 per turn, CUDA events, with the
  design each launch ran and the byte bound at 3.35 TB/s (pad planes
  included); then new against old bitwise, every gate pair
  (``slab_apply_bitwise``: the apply and the residual on 512^2 x 64, the
  prolongation from 256^2 x 32 and, in float64, from 32^2 x 4), and the
  registers and spills ptxas reports (``slab_apply_ptxas``);
* ``slab_eps`` — rows 1ze and 5ze of the z-slab solver: the float32
  coefficient slab double pair (two pairs, and one pair on the 512^2 x
  64 slab), residual and apply, n_eps 1 and 3 (coefficients 0.5 +
  U[0,1), lam 1.5, Dirichlet faces), as shipped (the face-plane designs:
  csrc/stream_faces.cuh and csrc/apply_faces.cuh with SLAB = 1) against
  the design before them (``-DOMG_SLABEPS=0``: stream_kernel.cuh) on an
  interior slab (gates off) of each sharded level over 8 slabs, 512^2 x
  64 to 32^2 x 4, and the double pair also on the 4-plane edge strips of
  the overlapped levels (512^2 .. 64^2), in turns (old, new, new, old),
  median of 10 per turn, CUDA events, with the design each launch ran
  and the byte bound at 3.35 TB/s (pad planes included); row 8z, the
  slab double-float residual, on the 512^2 x 64 slab from its library
  beside it; then new against old bitwise on the 512^2 x 64 slab, every
  gate pair, each kind and n_eps (``slab_eps_bitwise``), and the
  registers and spills ptxas reports (``slab_eps_ptxas``);
* ``sass``   — static SASS instructions of the double pair's and the
  down-leg's main loop (the longest backward branch), old and new, and
  per cell a thread updates in one step of that loop (old: one per
  half-sweep; new: R per half-sweep); the same for the float32
  coefficient kernels of both designs (``stream_kernel`` with n_eps 1
  or 3, ``face_kernel``), and per cell of a thread's step for the
  coefficient apply, residual and residual-restriction and the
  constant-coefficient residual-restriction of both designs
  (``stream_kernel`` with no half-sweep, ``apply_faces_kernel``): the
  face-plane kernels from the shipped build, the ``stream_kernel`` ones
  they replaced from a build with ``-DOMG_FACES=0``; the slab double
  pair's rows (``SLAB`` 1) beside the unsharded ones;
* ``tiles``  — double pair and downsweep at 512^3 float32 for a list of
  (tile x, tile y, chunk z) shapes of the old design, median of 8, CUDA
  events;
* ``half``   — row 2, one half-sweep (``half_sweep_dense``: the dense
  forest's sequential smoother, constant coefficients, its identity
  plane-valued faces, random planes, lam 0), as shipped (the register
  march of csrc/stencil_sweep.cu) against the design before it
  (``-DOMG_HALFAF=0``: stream_kernel.cuh's wavefront, NS = 1) on every
  canvas the forests send, 256^3 to 16^3, float32 and float64, in turns
  (old, new, new, old), from the library: ``ms`` CUDA events around one
  call (median of 10; the host's launch work shows on small canvases),
  ``device_ms`` 20 launches in one CUDA graph, its replay timed, over 20
  (median of 10), with the design each launch ran and the byte bound at
  3.35 TB/s; then old against new bitwise on every canvas, both parities
  (``half_bitwise``), and the registers and spills ptxas reports
  (``half_ptxas``);
* ``df32_march`` — rows 8z and 8, the double-float residual, as shipped
  (the z-march of csrc/residual_df32.cu on levels and slabs of 2^24
  cells and more in planes of 2^18 and more, a thread per cell on the
  rest) against the design
  before it (``-DOMG_DF32MARCH=0``: a thread per cell everywhere) on an
  interior slab (gates off) of each sharded level over 8 slabs, 512^2 x
  64 to 32^2 x 4, and on the unsharded 512^3 and 256^3 levels (equal
  power-of-two spacing, Dirichlet 0, lam 0), in turns (old, new, new,
  old), ``ms`` and ``device_ms`` as for ``half``, with the design each
  launch ran and the byte bound at 3.35 TB/s (pad planes included); then
  old against new bitwise on the 512^2 x 64 slab, every gate pair,
  physical and periodic z, lam 0 and 0.37, and at 512^3
  (``df32_march_bitwise``), and the registers and spills ptxas reports
  (``df32_march_ptxas``);
* ``df32_blocks`` — the double-float residual's thread-per-cell kernel,
  the design before the z-march (built with ``-DOMG_DF32MARCH=0``), at
  512^3 for a list of thread-block shapes (``-DOMG_DF32_BX/BY/BZ``),
  median of 8, CUDA events, the shipped shape first and last;
* ``chunk``  — ms per have-guess FMG of the 512^3 float32 main path with
  the z chunk fixed at 64 against the shipped choice by level size,
  alternating inside one process (fixed, chosen, chosen, fixed, ...).

Needs a CUDA device and nvcc; the shipped kernels are not changed.
"""
import ctypes
import json
import math
import os
import re
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


def build(tag, flags, syms=SYMS, log=None):
    """The sources of ``syms`` with extra flags; returns {symbol: ctypes
    function}.  log: a list that receives the compilers' output."""
    os.makedirs(OUT, exist_ok=True)
    procs = []
    for name in syms:
        so = os.path.join(OUT, f"{name}_{tag}.so")
        procs.append(subprocess.Popen(
            [cb._nvcc(), *cb.NVCC_FLAGS, *flags, "-I", CSRC, "-o", so,
             os.path.join(CSRC, name + ".cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for p in procs:
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{text}")
        if log is not None:
            log.append(text)
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
        fns = build(f"{tx}_{ty}_{cz}", ["-DOMG_WIDE=0", f"-DOMG_TILE_X={tx}",
                                        f"-DOMG_TILE_Y={ty}",
                                        f"-DOMG_CHUNK_Z={cz}"])

        def pair():
            e = fns["omg_stencil_sweep"](0, 0, ctypes.byref(P), None,
                                         phi.data_ptr(), rhs.data_ptr(),
                                         out.data_ptr(), st, None)
            assert e == 0, e

        def down():
            e = fns["omg_downsweep"](0, 1, ctypes.byref(P), None,
                                     phi.data_ptr(),
                                     rhs.data_ptr(), out.data_ptr(),
                                     pc.data_ptr(), rc.data_ptr(), st, None)
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
                   ["-DOMG_DF32MARCH=0", f"-DOMG_DF32_BX={bx}",
                    f"-DOMG_DF32_BY={by}", f"-DOMG_DF32_BZ={bz}"],
                   {"residual_df32": "omg_residual_df32"})["omg_residual_df32"]

        def run():
            e = fn(ctypes.byref(P), ctypes.byref(Q), xhi.data_ptr(),
                   xlo.data_ptr(), rhi.data_ptr(), rlo.data_ptr(),
                   out.data_ptr(), st, None)
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

def build_many(variants, syms=SYMS):
    """build() of several variants side by side: {tag: flags} ->
    ({tag: {symbol: function}}, {tag: compiler output})."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for tag, flags in variants.items():
        for name in syms:
            so = os.path.join(OUT, f"{name}_{tag}.so")
            procs[(tag, name)] = subprocess.Popen(
                [cb._nvcc(), *cb.NVCC_FLAGS, *flags, "-I", CSRC, "-o", so,
                 os.path.join(CSRC, name + ".cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
    logs = {tag: "" for tag in variants}
    for (tag, name), p in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}/{name}:\n{text}")
        logs[tag] += text
    fns = {}
    for tag in variants:
        fns[tag] = {}
        for name, sym in syms.items():
            f = getattr(ctypes.CDLL(os.path.join(OUT, f"{name}_{tag}.so")),
                        sym)
            f.argtypes, f.restype = dk._ARGTYPES[sym], ctypes.c_int
            fns[tag][sym] = f
    return fns, logs


#: the wide design as shipped against the design before it (OMG_WIDE=0)
WIDE_VARIANTS = {"old": ["-DOMG_WIDE=0"], "new": []}
#: rows a thread of the wide design owns (WIDE_ROWS of stream_wide.cuh)
WIDE_ROWS = 2
#: the builds of WIDE_VARIANTS, once made
_WIDE_FNS = {}


def wide_geo(ns, down, tx, ty, rows, item):
    """Threads, window and ring bytes of a wide instantiation (the
    constexpr geometry of csrc/stream_wide.cuh)."""
    h = ns + (1 if down else 0)
    hx = (h + 1) & ~1
    while (tx // 2 + hx) % rows:
        hx += 2
    cx = tx // 2 + hx
    ws = 2 * cx
    while (rows * ws - cx) % 32:
        ws += 1
    wy = ty + 2 * ((h + 1) & ~1)
    nb = 2 * ns + (4 if down else 2)
    return {"tile": [tx, ty], "rows": rows, "threads": cx * (wy // rows),
            "window": [2 * cx, wy],
            "smem_bytes": item * (nb * ws * wy + 2 * (ws + 2))}


def old_geo(ns, down, item):
    """The same for stream_kernel.cuh's 32x16 tile."""
    h = ns + (1 if down else 0)
    wx, wy = 32 + 2 * h, 16 + 2 * h
    nb = 2 * ns + (4 if down else 2)
    return {"tile": [32, 16], "threads": wx // 2 * wy, "window": [wx, wy],
            "smem_bytes": item * (2 * nb * wx * wy +
                                  (2 * 32 * 16 if down else 0))}


def level_fields(n, dtype):
    cfg = dk.DenseStencilConfig((n,) * 3, (float(n * n),) * 3,
                                [(2.0, -1.0, 0.0)] * 6, (False,) * 3,
                                dtype, b_const=[0.0] * 6)
    g = torch.Generator(device="cuda").manual_seed(n)
    f = {k: torch.randn(cfg.pshape, generator=g, dtype=dtype, device="cuda")
         for k in ("phi", "rhs")}
    f["out"] = torch.empty_like(f["phi"])
    f["pc"] = torch.empty(dk.padded_shape((n // 2,) * 3), dtype=dtype,
                          device="cuda")
    f["rc"] = torch.empty_like(f["pc"])
    return cfg, f


def wide_calls(fns, cfg, f, n_pairs):
    """(pair, down) launches of one build on the fields f."""
    st = torch.cuda.current_stream().cuda_stream
    P = dk._params(cfg, 0.0, [None] * 6, 0, 2 * n_pairs)
    dt = dk._dt(cfg)

    def pair():
        e = fns["omg_stencil_sweep"](dt, 0, ctypes.byref(P), None,
                                     f["phi"].data_ptr(), f["rhs"].data_ptr(),
                                     f["out"].data_ptr(), st, None)
        assert e == 0, e

    def down():
        e = fns["omg_downsweep"](dt, 1, ctypes.byref(P), None,
                                 f["phi"].data_ptr(), f["rhs"].data_ptr(),
                                 f["out"].data_ptr(), f["pc"].data_ptr(),
                                 f["rc"].data_ptr(), st, None)
        assert e == 0, e

    return pair, down


def ptxas_resources(log, pick):
    """{demangled kernel: registers, stack, spills} of the kernels whose
    demangled name ``pick`` accepts, from ``-Xptxas -v`` output."""
    rows, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            rows[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            rows[name].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[name]["registers"] = int(m.group(1))
    names = list(rows)
    dem = subprocess.run([os.path.join(os.path.dirname(cb._nvcc()),
                                       "cu++filt")],
                         input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return {d: rows[k] for k, d in zip(names, dem) if pick(d)}


def probe_wide():
    fns, logs = build_many({k: v + ["-Xptxas", "-v"]
                            for k, v in WIDE_VARIANTS.items()})
    _WIDE_FNS.update(fns)
    names = list(WIDE_VARIANTS)
    rows = []
    for dtype, levels, tags in (
            (torch.float32, (512, 256, 128, 64, 32, 16), names),
            (torch.float64, (512, 256), names)):
        item = 4 if dtype == torch.float32 else 8
        for n in levels:
            cfg, f = level_fields(n, dtype)
            calls = {t: wide_calls(fns[t], cfg, f, 2) for t in tags}
            nb = {"pair": 3 * n ** 3 * item,
                  "down": (3 * n ** 3 + 2 * (n // 2) ** 3) * item}
            for k, kern in enumerate(("pair", "down")):
                ms = {t: [] for t in tags}
                for t in tags + tags[::-1]:
                    ms[t].append(time_ms(calls[t][k], reps=10))
                rows.append({"n": n, "dtype": str(dtype)[6:], "kernel": kern,
                             "n_pairs": 2, "ms": ms,
                             "bound_ms": 1e3 * nb[kern] / 3.35e12})
                print(json.dumps({"wide": rows[-1]}), flush=True)
            del f
            torch.cuda.empty_cache()
    # old against new, bitwise, at 512^3
    checks = []
    for dtype in (torch.float32, torch.float64):
        cfg, f = level_fields(512, dtype)
        for n_pairs in (1, 2):
            for k, kern in enumerate(("pair", "down")):
                got = {}
                for t in ("old", "new"):
                    for key in ("out", "pc", "rc"):
                        f[key].fill_(float("nan"))
                    wide_calls(fns[t], cfg, f, n_pairs)[k]()
                    keys = ("out",) if kern == "pair" else ("out", "pc", "rc")
                    got[t] = [f[key][dk._ISL].clone() for key in keys]
                torch.cuda.synchronize()
                checks.append({"dtype": str(dtype)[6:], "kernel": kern,
                               "n_pairs": n_pairs, "bitwise": all(
                                   torch.equal(a, b) for a, b in
                                   zip(got["old"], got["new"]))})
                del got
        del f
        torch.cuda.empty_cache()
    print(json.dumps({"wide_bitwise": checks}), flush=True)
    old = ptxas_resources(logs["old"], lambda d: re.match(
        r"void stream_kernel<(float|double), (\(int\))?[24], (\(int\))?[03], "
        r"(\(int\))?0, (\(int\))?0, (\(int\))?0>", d))
    new = ptxas_resources(logs["new"], lambda d: "wide_kernel" in d)
    geo = {}
    for ns in (2, 4):
        for down in (False, True):
            for item, ty in ((4, 32), (8, 16)):
                key = f"ns{ns}_{'down' if down else 'pair'}_{item * 8}"
                geo[key] = {"old": old_geo(ns, down, item),
                            "new": wide_geo(ns, down, 64, ty, WIDE_ROWS,
                                            item)}
    print(json.dumps({"wide_ptxas": {"old": old, "new": new,
                                     "geometry": geo}}), flush=True)


def probe_wide_fmg():
    import chip_smoke
    if not _WIDE_FNS:
        _WIDE_FNS.update(build_many(WIDE_VARIANTS)[0])
    fns = _WIDE_FNS
    designs = {"old": (fns["old"], fns["old"]),
               "pair": (fns["new"], fns["old"]),
               "new": (fns["new"], fns["new"])}
    n = 512
    ps = pkg.PoissonSolver(3, (n,) * 3, 16, dtype=torch.float32)
    ps.set_dirichlet(0.0)
    sv = ps.solver
    g = torch.Generator(device="cuda").manual_seed(0)
    ps.set_rhs(arrays={sv.levels[-1]: torch.randn((n,) * 3, generator=g,
                                                  device="cuda")})
    ps.solve(rtol=0.0, atol=0.0, max_cycles=3)
    chosen = {s: dk._fns[s] for s in SYMS.values()}

    def fmg():
        sv.fas_fmg(ps.state, have_guess=True, need_res=False)

    rows = {d: {"fmg_ms": [], "vcycle_512_ms": []} for d in designs}
    for d in ("old", "pair", "new", "new", "pair", "old"):
        pair_fns, down_fns = designs[d]
        dk._fns["omg_stencil_sweep"] = pair_fns["omg_stencil_sweep"]
        dk._fns["omg_downsweep"] = down_fns["omg_downsweep"]
        fmg()
        rows[d]["fmg_ms"].append(statistics.median(
            chip_smoke.event_ms(fmg) for _ in range(10)))
        rows[d]["vcycle_512_ms"].append(statistics.median(
            [m["device_ms"] for m in chip_smoke.fmg_stage_marks(sv, ps.state)
             if m["stage"] == "vcycle_to" and m["dims"] == [n] * 3][0]
            for _ in range(10)))
    dk._fns.update(chosen)
    print(json.dumps({"wide_fmg": rows}), flush=True)


_BRA = re.compile(r"\bBRA\b[^;]*?0x([0-9a-f]+)")


def sass_loops(flags):
    """{demangled kernel: (instructions, main-loop instructions)} of
    stencil_sweep.cu and downsweep.cu built with flags."""
    out = {}
    work = os.path.join(OUT, "sass")
    os.makedirs(work, exist_ok=True)
    tool = os.path.dirname(cb._nvcc())
    for name in SYMS:
        cubin = os.path.join(work, f"{name}{'_'.join(flags)}.cubin")
        subprocess.run([cb._nvcc(), *[f for f in cb.NVCC_FLAGS if f not in (
            "-shared", "-Xcompiler", "-fPIC")], *flags, "-cubin", "-I", CSRC,
            "-o", cubin, os.path.join(CSRC, name + ".cu")], check=True)
        sass = subprocess.run([os.path.join(tool, "cuobjdump"), "-sass",
                               cubin], capture_output=True, text=True,
                              check=True).stdout
        fn, ins = None, {}
        for line in sass.splitlines():
            t = line.strip()
            if t.startswith("Function :"):
                fn = t.split(":", 1)[1].strip()
                ins[fn] = []
                continue
            m = re.match(r"/\*([0-9a-f]{4,})\*/\s+(.*)", t)
            if fn and m:
                ins[fn].append((int(m.group(1), 16), m.group(2)))
        dem = subprocess.run([os.path.join(tool, "cu++filt")],
                             input="\n".join(ins), capture_output=True,
                             text=True).stdout.splitlines()
        for k, d in zip(ins, dem):
            best = (0, 0)
            for addr, text in ins[k]:
                m = _BRA.search(text)
                if m and int(m.group(1), 16) < addr:
                    best = max(best, (addr - int(m.group(1), 16), addr))
            span, end = best
            n_loop = sum(1 for a, _ in ins[k] if end - span <= a <= end)
            out[d] = (len(ins[k]), n_loop)
    return out


def probe_sass():
    old = sass_loops(["-DOMG_WIDE=0"])
    new = sass_loops([])
    # the coefficient kernels the face-plane designs replaced are built
    # only with OMG_FACES=0
    faces_old = sass_loops(["-DOMG_FACES=0"])
    rows = []
    for d, (n_all, n_loop) in sorted(old.items()):
        # the unsharded double pair and down-leg, and the slab double pair
        m = re.match(r"void stream_kernel<float, (?:\(int\))?([24]), "
                     r"(?:\(int\))?([03]), (?:\(int\))?0, (?:\(int\))?0, "
                     r"(?:\(int\))?[01]>", d)
        if m:
            ns = int(m.group(1))
            rows.append({"kernel": d, "design": "old", "instructions": n_all,
                         "loop": n_loop, "updates_per_thread_step": ns,
                         "loop_per_update": n_loop / ns})
    for d, (n_all, n_loop) in sorted(new.items()):
        m = re.match(r"void wide_kernel<float, (?:\(int\))?([24]), "
                     r"(?:\(int\))?([03]), (?:\(int\))?[01]>", d)
        if m:
            ns, r = int(m.group(1)), WIDE_ROWS
            rows.append({"kernel": d, "design": "new", "instructions": n_all,
                         "loop": n_loop, "updates_per_thread_step": ns * r,
                         "loop_per_update": n_loop / (ns * r)})
    for built, design in ((new, "faces"), (faces_old, "stream (n_eps)")):
        for d, (n_all, n_loop) in sorted(built.items()):
            # the face-plane kernels and the coefficient kernels they
            # replace
            m = re.match(r"void (face_kernel<float, (?:\(int\))?([24]), "
                         r"(?:\(int\))?[03], (?:\(int\))?[13]>|"
                         r"stream_kernel<float, (?:\(int\))?([24]), "
                         r"(?:\(int\))?[03], (?:\(int\))?[13], "
                         r"(?:\(int\))?0, (?:\(int\))?0>)", d)
            if m and (m.group(2) is not None) == (design == "faces"):
                ns = int(m.group(2) or m.group(3))
                rows.append({"kernel": d, "design": design,
                             "instructions": n_all, "loop": n_loop,
                             "updates_per_thread_step": ns,
                             "loop_per_update": n_loop / ns})
            # the face-plane apply (four cells a thread and step) and the
            # coefficient apply, residual and residual-restriction it
            # replaces, and the constant-coefficient residual-restriction
            # (two cells a thread and step)
            m = re.match(r"void (apply_faces_kernel<float, (?:\(int\))?"
                         r"([123]), (?:\(int\))?([013])>|stream_kernel<"
                         r"float, (?:\(int\))?0, (?:\(int\))?([123]), "
                         r"(?:\(int\))?([013]), (?:\(int\))?0, "
                         r"(?:\(int\))?0>)", d)
            cells = 4 if d.startswith("void apply_faces") else 2
            if m and (m.group(3) or m.group(5)) == "0" and \
                    (m.group(2) or m.group(4)) != "3":
                m = None        # the constant apply and residual
            if m and (cells == 4) == (design == "faces"):
                rows.append({"kernel": d, "design": "apply_faces"
                             if cells == 4 else design,
                             "instructions": n_all, "loop": n_loop,
                             "cells_per_thread_step": cells,
                             "loop_per_cell": n_loop / cells})
    print(json.dumps({"sass": rows}), flush=True)


#: the face-plane design as shipped against the design before it
#: (OMG_FACES=0: the coefficient kernels of stream_kernel.cuh alone)
FACES_VARIANTS = {"old": ["-DOMG_FACES=0"], "new": []}
#: the builds of FACES_VARIANTS, once made
_FACES_FNS = {}


def eps_level(n, n_eps, dtype):
    """A level of n^3 with n_eps coefficient fields 0.5 + U[0,1), Dirichlet
    faces, and the fields of level_fields."""
    cfg, f = level_fields(n, dtype)
    cfg = dk.DenseStencilConfig(cfg.dims, cfg.idr2, cfg.bc, cfg.periodic,
                                dtype, b_const=cfg.b_const, n_eps=n_eps)
    g = torch.Generator(device="cuda").manual_seed(7 * n + n_eps)
    f["eps"] = tuple(0.5 + torch.rand(cfg.pshape, generator=g, dtype=dtype,
                                      device="cuda") for _ in range(n_eps))
    return cfg, f


def eps_launch_args(cfg, f, n_sweeps=0):
    """(stream, LevelParams, EpsParams, dtype code, design out) of a
    launch on the fields f with their coefficient fields, lam 0.3."""
    P = dk._params(cfg, 0.3, [None] * 6, 0, n_sweeps)
    E = dk._EpsParams()
    E.n = len(f["eps"])
    for i, e in enumerate(f["eps"]):
        E.f[i] = e.data_ptr()
    return (torch.cuda.current_stream().cuda_stream, P, E, dk._dt(cfg),
            ctypes.c_int(0))


def faces_calls(fns, cfg, f, n_pairs):
    """(pair, down) launches of one build on the fields f with their
    coefficient fields; each returns the design the library ran."""
    st, P, E, dt, d = eps_launch_args(cfg, f, 2 * n_pairs)

    def pair():
        e = fns["omg_stencil_sweep"](dt, 0, ctypes.byref(P), ctypes.byref(E),
                                     f["phi"].data_ptr(), f["rhs"].data_ptr(),
                                     f["out"].data_ptr(), st, ctypes.byref(d))
        assert e == 0, e
        return d.value

    def down():
        e = fns["omg_downsweep"](dt, 1, ctypes.byref(P), ctypes.byref(E),
                                 f["phi"].data_ptr(), f["rhs"].data_ptr(),
                                 f["out"].data_ptr(), f["pc"].data_ptr(),
                                 f["rc"].data_ptr(), st, ctypes.byref(d))
        assert e == 0, e
        return d.value

    return pair, down


def probe_faces():
    fns, logs = build_many({k: v + ["-Xptxas", "-v"]
                            for k, v in FACES_VARIANTS.items()})
    _FACES_FNS.update(fns)
    names = list(FACES_VARIANTS)
    item = 4
    for n in (512, 256, 128, 64, 32, 16):
        for n_eps in (1, 3):
            cfg, f = eps_level(n, n_eps, torch.float32)
            for n_pairs in (2, 1):
                calls = {t: faces_calls(fns[t], cfg, f, n_pairs)
                         for t in names}
                nb = {"pair": (3 + n_eps) * n ** 3 * item,
                      "down": ((3 + n_eps) * n ** 3 + 2 * (n // 2) ** 3) *
                      item}
                for k, kern in enumerate(("pair", "down")):
                    design = {t: calls[t][k]() for t in names}
                    ms = {t: [] for t in names}
                    for t in names + names[::-1]:
                        ms[t].append(time_ms(calls[t][k], reps=10))
                    print(json.dumps({"faces": {
                        "n": n, "dtype": "float32", "n_eps": n_eps,
                        "kernel": kern, "n_pairs": n_pairs, "ms": ms,
                        "design": design,
                        "bound_ms": 1e3 * nb[kern] / 3.35e12}}), flush=True)
            del f
            torch.cuda.empty_cache()
    # old against new, bitwise, at 512^3
    checks = []
    for n_eps in (1, 3):
        cfg, f = eps_level(512, n_eps, torch.float32)
        for n_pairs in (1, 2):
            for k, kern in enumerate(("pair", "down")):
                got = {}
                for t in names:
                    for key in ("out", "pc", "rc"):
                        f[key].fill_(float("nan"))
                    faces_calls(fns[t], cfg, f, n_pairs)[k]()
                    keys = ("out",) if kern == "pair" else ("out", "pc", "rc")
                    got[t] = [f[key][dk._ISL].clone() for key in keys]
                torch.cuda.synchronize()
                checks.append({"n_eps": n_eps, "kernel": kern,
                               "n_pairs": n_pairs, "bitwise": all(
                                   torch.equal(a, b) for a, b in
                                   zip(got["old"], got["new"]))})
                del got
        del f
        torch.cuda.empty_cache()
    print(json.dumps({"faces_bitwise": checks}), flush=True)
    old = ptxas_resources(logs["old"], lambda d: re.match(
        r"void stream_kernel<float, (\(int\))?[24], (\(int\))?[03], "
        r"(\(int\))?[13], (\(int\))?0, (\(int\))?0>", d))
    new = ptxas_resources(logs["new"], lambda d: "face_kernel" in d)
    print(json.dumps({"faces_ptxas": {"old": old, "new": new}}), flush=True)


#: the face-plane apply (csrc/apply_faces.cuh) as shipped against the
#: design before it (OMG_FACES=0: stream_kernel.cuh alone), and a build
#: that sends every apply, residual and residual-restriction to it
#: (OMG_FACES=2: constant coefficients too)
APPLY_VARIANTS = {"old": ["-DOMG_FACES=0"], "new": [], "all": ["-DOMG_FACES=2"]}


def apply_calls(fns, cfg, f):
    """(apply, residual, residual-restriction) launches of one build on
    the fields f with their coefficient fields; each returns the design
    the library ran."""
    st, P, E, dt, d = eps_launch_args(cfg, f)

    def sweep(mode):
        def run():
            e = fns["omg_stencil_sweep"](
                dt, mode, ctypes.byref(P), ctypes.byref(E),
                f["phi"].data_ptr(), f["rhs"].data_ptr(),
                f["out"].data_ptr(), st, ctypes.byref(d))
            assert e == 0, e
            return d.value
        return run

    def rr():
        e = fns["omg_downsweep"](dt, 0, ctypes.byref(P), ctypes.byref(E),
                                 f["phi"].data_ptr(), f["rhs"].data_ptr(),
                                 None, f["pc"].data_ptr(),
                                 f["rc"].data_ptr(), st, ctypes.byref(d))
        assert e == 0, e
        return d.value

    return sweep(1), sweep(2), rr


def apply_bytes(kern, n, n_eps, item):
    """Bytes an apply (phi in, out), residual (phi, rhs in, out) or
    residual-restriction (phi, rhs in, two coarse fields out) must move,
    each coefficient field read once."""
    n_f, n_c = n ** 3, (n // 2) ** 3
    return item * ({"apply": 2 * n_f, "residual": 3 * n_f,
                    "residual_restrict": 2 * n_f + 2 * n_c}[kern] +
                   n_eps * n_f)


APPLY_KINDS = ("apply", "residual", "residual_restrict")


def probe_apply_faces():
    fns, logs = build_many({k: v + ["-Xptxas", "-v"]
                            for k, v in APPLY_VARIANTS.items()})
    # coefficients: the shipped dispatch (new) against the old design at
    # every level, float32 and float64; constant coefficients: the
    # design forced (all) against the old one, as input for row 4
    plan = [(torch.float32, n_eps, n, "new") for n in (512, 256, 128, 64,
                                                        32, 16)
            for n_eps in (1, 3)]
    plan += [(torch.float64, n_eps, n, "new") for n in (512, 256, 128, 64,
                                                        32, 16)
             for n_eps in (1, 3)]
    plan += [(torch.float32, 0, n, "all") for n in (512, 256, 128)]
    for dtype, n_eps, n, tag in plan:
        cfg, f = eps_level(n, n_eps, dtype)
        item = 4 if dtype == torch.float32 else 8
        calls = {t: apply_calls(fns[t], cfg, f) for t in ("old", tag)}
        for k, kern in enumerate(APPLY_KINDS):
            design = {t: calls[t][k]() for t in calls}
            ms = {t: [] for t in calls}
            for t in ("old", tag, tag, "old"):
                ms[t].append(time_ms(calls[t][k], reps=10))
            print(json.dumps({"apply_faces": {
                "n": n, "dtype": str(dtype)[6:], "n_eps": n_eps,
                "kernel": kern, "build": tag, "ms": ms, "design": design,
                "bound_ms": 1e3 * apply_bytes(kern, n, n_eps, item) /
                3.35e12}}), flush=True)
        del f, calls
        torch.cuda.empty_cache()
    # old against new, bitwise, at 512^3
    checks = []
    for n_eps in (1, 3):
        cfg, f = eps_level(512, n_eps, torch.float32)
        for k, kern in enumerate(APPLY_KINDS):
            got = {}
            for t in ("old", "new"):
                for key in ("out", "pc", "rc"):
                    f[key].fill_(float("nan"))
                apply_calls(fns[t], cfg, f)[k]()
                keys = ("pc", "rc") if kern == "residual_restrict" else (
                    "out",)
                got[t] = [f[key][dk._ISL].clone() for key in keys]
            torch.cuda.synchronize()
            checks.append({"n_eps": n_eps, "kernel": kern, "bitwise": all(
                torch.equal(a, b) for a, b in zip(got["old"], got["new"]))})
            del got
        del f
        torch.cuda.empty_cache()
    print(json.dumps({"apply_faces_bitwise": checks}), flush=True)
    print(json.dumps({"apply_faces_ptxas": ptxas_resources(
        logs["all"], lambda d: "apply_faces_kernel" in d)}), flush=True)


#: row 4, the constant-coefficient residual-restriction, as shipped
#: (csrc/apply_faces.cuh with no coefficients) against the design before
#: it (OMG_FACES=0: stream_kernel.cuh), and row 1z, the slab double pair,
#: as shipped (csrc/stream_wide.cuh with SLAB = 1 where it takes the
#: slab) against the design before it (OMG_WIDE=0: stream_kernel.cuh)
RR_VARIANTS = {"old": ["-DOMG_FACES=0"], "new": []}
SLAB_VARIANTS = {"old": ["-DOMG_WIDE=0"], "new": []}
def rr_call(fns, cfg, f):
    """The residual-restriction (lam 0) of one build on the fields f;
    returns the design the library ran."""
    st = torch.cuda.current_stream().cuda_stream
    P = dk._params(cfg, 0.0, [None] * 6, 0, 0)
    d = ctypes.c_int(0)

    def run():
        e = fns["omg_downsweep"](dk._dt(cfg), 0, ctypes.byref(P), None,
                                 f["phi"].data_ptr(), f["rhs"].data_ptr(),
                                 None, f["pc"].data_ptr(), f["rc"].data_ptr(),
                                 st, ctypes.byref(d))
        assert e == 0, e
        return d.value
    return run


def slab_fields(n, zl, dtype, seed=3, n_eps=0):
    """One z-slab of n^2 x zl cells (Dirichlet 0 faces), phi and rhs
    random in the core and in the pads (the neighbour slabs' planes), and
    n_eps coefficient fields 0.5 + U[0,1), pads included."""
    cfg = dk.DenseStencilConfig((n, n, zl), (float(n * n),) * 3,
                                [(2.0, -1.0, 0.0)] * 6, (False,) * 3,
                                dtype, b_const=[0.0] * 6, n_eps=n_eps)
    g = torch.Generator(device="cuda").manual_seed(seed)
    f = {k: torch.randn(cfg.pshape, generator=g, dtype=dtype, device="cuda")
         for k in ("phi", "rhs")}
    f["eps"] = tuple(0.5 + torch.rand(cfg.pshape, generator=g, dtype=dtype,
                                      device="cuda") for _ in range(n_eps))
    f["out"] = torch.empty_like(f["phi"])
    return cfg, f


def slab_call(fns, cfg, f, n_pairs, gates=(False, False)):
    """The slab double pair of one build on the fields f."""
    st = torch.cuda.current_stream().cuda_stream
    P = dk._params(cfg, 0.0, [None] * 6, 0, 2 * n_pairs)
    Zs = dk._slab_params(gates)
    d = ctypes.c_int(0)

    def run():
        e = fns["omg_stencil_slab"](dk._dt(cfg), 0, ctypes.byref(P), None,
                                    ctypes.byref(Zs), f["phi"].data_ptr(),
                                    f["rhs"].data_ptr(), f["out"].data_ptr(),
                                    st, ctypes.byref(d))
        assert e == 0, e
        return d.value
    return run


def in_turns(calls, reps=10):
    """{tag: [ms, ms]}: each call timed in the turns t1 .. tn, tn .. t1."""
    tags = list(calls)
    ms = {t: [] for t in tags}
    for t in tags + tags[::-1]:
        ms[t].append(time_ms(calls[t], reps=reps))
    return ms


def graph_ms(run, n=20, reps=10):
    """Device ms per launch: n launches of run (which must launch on the
    current stream) captured in one CUDA graph, its replay timed with CUDA
    events (median of reps), over n: no host work between launches."""
    run()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            run()
    ms = time_ms(g.replay, reps=reps) / n
    del g
    return ms


def graph_turns(calls, n=20, reps=10):
    """{tag: [ms, ms]}: graph_ms of each call in the turns t1 .. tn,
    tn .. t1."""
    tags = list(calls)
    ms = {t: [] for t in tags}
    for t in tags + tags[::-1]:
        ms[t].append(graph_ms(calls[t], n, reps))
    return ms


def probe_rr_slab(levels=(512, 256, 128, 64, 32, 16)):
    rr_fns, rr_logs = build_many(
        {k: v + ["-Xptxas", "-v"] for k, v in RR_VARIANTS.items()},
        {"downsweep": "omg_downsweep"})
    sl_fns, sl_logs = build_many(
        {k: v + ["-Xptxas", "-v"] for k, v in SLAB_VARIANTS.items()},
        {"stencil_sweep": "omg_stencil_slab"})
    slab_levels = levels[:-1]
    # row 4 at every level of the main path, float32 and float64
    for dtype in (torch.float32, torch.float64):
        item = 4 if dtype == torch.float32 else 8
        for n in levels:
            cfg, f = level_fields(n, dtype)
            calls = {t: rr_call(fns, cfg, f) for t, fns in rr_fns.items()}
            design = {t: c() for t, c in calls.items()}
            print(json.dumps({"rr_slab": {
                "kernel": "residual_restrict", "dims": [n] * 3,
                "dtype": str(dtype)[6:], "ms": in_turns(calls),
                "design": design,
                "bound_ms": 1e3 * (2 * n ** 3 + 2 * (n // 2) ** 3) * item /
                3.35e12}}), flush=True)
            del f, calls
            torch.cuda.empty_cache()
    # row 1z: the whole slabs of the sharded levels over 8 slabs and the
    # edge strips of their overlapped pair groups (2 * n_pairs planes)
    shapes = [(n, n // 8, k, torch.float32) for n in slab_levels
              for k in (2, 1)]
    shapes += [(n, 2 * k, k, torch.float32) for n in slab_levels[:2]
               for k in (2, 1)]
    for n, zl, k, dtype in shapes:
        item = 4 if dtype == torch.float32 else 8
        cfg, f = slab_fields(n, zl, dtype)
        calls = {t: slab_call(fns, cfg, f, k) for t, fns in sl_fns.items()}
        design = {t: c() for t, c in calls.items()}
        h = 2 * k
        print(json.dumps({"rr_slab": {
            "kernel": "slab_pairs", "dims": [n, n, zl], "n_pairs": k,
            "dtype": str(dtype)[6:], "ms": in_turns(calls),
            "design": design,
            "bound_ms": 1e3 * (2 * (zl + 2 * h) + zl) * n * n * item /
            3.35e12}}), flush=True)
        del f, calls
        torch.cuda.empty_cache()
    # every build against the first, bitwise: row 4 at 512^3 in both
    # dtypes, the slab pair on a 512^2 x 64 slab for both n_pairs and
    # every gate pair
    ref = list(rr_fns)[0]
    checks = []
    for dtype in (torch.float32, torch.float64):
        cfg, f = level_fields(512, dtype)
        got = {}
        for t, fns in rr_fns.items():
            f["pc"].fill_(float("nan"))
            f["rc"].fill_(float("nan"))
            rr_call(fns, cfg, f)()
            got[t] = [f[k][dk._ISL].clone() for k in ("pc", "rc")]
        torch.cuda.synchronize()
        checks.append({"kernel": "residual_restrict",
                       "dtype": str(dtype)[6:], "bitwise": {
                           t: all(torch.equal(a, b) for a, b in
                                  zip(got[ref], g)) for t, g in got.items()}})
        del f, got
        torch.cuda.empty_cache()
    ref = list(sl_fns)[0]
    cfg, f = slab_fields(512, 64, torch.float32)
    for k in (1, 2):
        for gates in ((False, False), (True, False), (False, True),
                      (True, True)):
            got = {}
            for t, fns in sl_fns.items():
                f["out"].fill_(float("nan"))
                slab_call(fns, cfg, f, k, gates)()
                got[t] = f["out"][dk._ISL].clone()
            torch.cuda.synchronize()
            checks.append({"kernel": "slab_pairs", "n_pairs": k,
                           "gates": gates, "bitwise": {
                               t: torch.equal(got[ref], g)
                               for t, g in got.items()}})
            del got
    del f
    torch.cuda.empty_cache()
    print(json.dumps({"rr_slab_bitwise": checks}), flush=True)
    i = r"(?:\(int\))?"
    pick_rr = re.compile(rf"void (apply_faces_kernel<\w+, {i}\d, {i}0>|"
                         rf"stream_kernel<\w+, {i}0, {i}3, {i}0, {i}0, "
                         rf"{i}0>)")
    pick_slab = re.compile(rf"void (wide_kernel<\w+, {i}[24], {i}0, {i}1>|"
                           rf"stream_kernel<\w+, {i}[24], {i}0, {i}0, "
                           rf"{i}0, {i}1>)")
    print(json.dumps({"rr_slab_ptxas": {
        "residual_restrict": {t: ptxas_resources(g, pick_rr.match)
                              for t, g in rr_logs.items()},
        "slab_pairs": {t: ptxas_resources(g, pick_slab.match)
                       for t, g in sl_logs.items()}}}), flush=True)


#: rows 1s and 5s as shipped against the design before them
#: (OMG_SEGWIDE=0: every segment launch on stream_kernel.cuh)
SEG_VARIANTS = {"old": ["-DOMG_SEGWIDE=0"], "new": []}


def seg_call(fns, cfg, phi, rhs, out, layers, planes, mode, n_pairs=0):
    """One segment launch (mode 0 pairs, 1 apply, 2 residual) of one
    build; returns the design the library ran."""
    st = torch.cuda.current_stream().cuda_stream
    S = dk._seg_params(layers, planes)
    P = dk._params(cfg, 0.0, None, 0, 2 * n_pairs, seg=True)
    d = ctypes.c_int(0)

    def run():
        e = fns["omg_seg_sweep"](dk._dt(cfg), mode, ctypes.byref(P),
                                 ctypes.byref(S), phi.data_ptr(),
                                 rhs.data_ptr(), out.data_ptr(), st,
                                 ctypes.byref(d))
        assert e == 0, e
        return d.value
    return run


def probe_seg():
    import chip_smoke
    from octree_mg_tpu_torch.core import tree as tm
    fns, logs = build_many({k: v + ["-Xptxas", "-v"]
                            for k, v in SEG_VARIANTS.items()},
                           {"seg_sweep": "omg_seg_sweep"})
    tree = chip_smoke.forest_tree(pkg, tm, "L", 256, 16)
    ps = pkg.PoissonSolver(3, (1,) * 3, 16, tree=tree, dtype=torch.float32)
    ps.set_dirichlet(0.0)
    sv = ps.solver
    top = sv.levels[-1]
    g = torch.Generator(device="cuda").manual_seed(11)
    ps.set_rhs(arrays={top: torch.randn(sv._ishape(top), generator=g,
                                        device="cuda")})
    ps.solve(rtol=0.0, atol=0.0, max_cycles=1)
    state = ps.state
    checks = []
    for lvl in sorted(sv.levels, key=lambda l: -math.prod(sv.dims[l])):
        if sv._seg_desc(lvl) is None:
            continue
        cfg = sv._seg_kcfg(lvl)
        layers, planes = sv._seg_data(state, lvl)
        phi, rhs = state["phi"][lvl], state["rhs"][lvl]
        out = torch.empty_like(phi)
        n = math.prod(cfg.dims)
        pb = sum(p.numel() for p in planes) * 4
        for kind, mode, k in (("pairs2", 0, 2), ("residual", 2, 0),
                              ("apply", 1, 0)):
            calls = {t: seg_call(f, cfg, phi, rhs, out, layers, planes, mode,
                                 k) for t, f in fns.items()}
            design = {t: c() for t, c in calls.items()}
            nbytes = (3 if mode != 1 else 2) * n * 4 + pb
            print(json.dumps({"seg": {
                "kernel": kind, "level": lvl, "dims": list(cfg.dims),
                "ghost_layers": len(layers.segs), "ms": in_turns(calls),
                "design": design,
                "bound_ms": 1e3 * nbytes / 3.35e12}}), flush=True)
            got = {}
            for t, c in calls.items():
                out.fill_(float("nan"))
                c()
                got[t] = out[dk._ISL].clone()
            torch.cuda.synchronize()
            checks.append({"kernel": kind, "dims": list(cfg.dims),
                           "bitwise": torch.equal(got["old"], got["new"])})
            del got, calls
        del out
        torch.cuda.empty_cache()
    print(json.dumps({"seg_bitwise": checks}), flush=True)
    i = r"(?:\(int\))?"
    pick = re.compile(rf"void (wide_kernel<float, {i}[24], {i}0, {i}0, "
                      rf"{i}1>|apply_faces_kernel<float, {i}[12], {i}0, "
                      rf"{i}1>|stream_kernel<\w+, {i}[024], {i}[012], {i}0, "
                      rf"{i}1, {i}0>)")
    print(json.dumps({"seg_ptxas": {t: ptxas_resources(g, pick.match)
                                    for t, g in logs.items()}}), flush=True)
    del ps, sv, state
    torch.cuda.empty_cache()


#: rows 5z and 7z as shipped against the designs before them
#: (OMG_SLABAP=0: the slab apply and residual on stream_kernel.cuh, the
#: slab prolongation on its thread-per-coarse-cell kernel)
SLAB_APPLY_VARIANTS = {"old": ["-DOMG_SLABAP=0"], "new": []}


def slab_apply_call(fns, kind, cfg, f, gates=(False, False), n_pairs=2,
                    lam=0.0):
    """One slab launch (the double pair of ``pairs``, apply, residual, with
    the coefficient fields f["eps"], or the prolongation with the slab as
    the coarse one) of one build on the fields f; returns the design the
    library ran."""
    st = torch.cuda.current_stream().cuda_stream
    P = dk._params(cfg, lam, [None] * 6, 0,
                   2 * n_pairs if kind == "pairs" else 0)
    Zs = dk._slab_params(gates)
    d = ctypes.c_int(-1)
    if kind == "prolong":
        args = (dk._dt(cfg), ctypes.byref(P), ctypes.byref(Zs),
                f["phi"].data_ptr(), f["rhs"].data_ptr(), f["fine"].data_ptr(),
                st, ctypes.byref(d))
        fn = fns["omg_prolong_slab"]
    else:
        E = dk._eps_params(cfg, f["eps"]) if cfg.n_eps else None
        args = (dk._dt(cfg), ("pairs", "apply", "residual").index(kind),
                ctypes.byref(P), None if E is None else ctypes.byref(E),
                ctypes.byref(Zs), f["phi"].data_ptr(), f["rhs"].data_ptr(),
                f["out"].data_ptr(), st, ctypes.byref(d))
        fn = fns["omg_stencil_slab"]

    def run():
        e = fn(*args)
        assert e == 0, e
        return d.value
    return run


def probe_slab_apply(levels=(512, 256, 128, 64, 32), K=8):
    fns, logs = build_many(
        {k: v + ["-Xptxas", "-v"] for k, v in SLAB_APPLY_VARIANTS.items()},
        {"stencil_sweep": "omg_stencil_slab",
         "prolong_correct": "omg_prolong_slab"})

    def fields(n, zl, dtype, fine=False):
        cfg, f = slab_fields(n, zl, dtype)
        if fine:
            f["fine"] = torch.randn(dk.padded_shape((2 * n, 2 * n, 2 * zl)),
                                    dtype=dtype, device="cuda")
        return cfg, f

    # 5z: the apply and the residual on an interior slab of each sharded
    # level over K slabs; 7z: the prolongation from each coarse slab;
    # float32, and float64 on the 32^2 x 4 slab
    shapes = [(n, torch.float32) for n in levels] + [(32, torch.float64)]
    for kind in ("residual", "apply", "prolong"):
        for n, dtype in shapes:
            if kind == "prolong" and n == levels[0]:
                continue
            zl = n // K
            item = 4 if dtype == torch.float32 else 8
            cfg, f = fields(n, zl, dtype, fine=kind == "prolong")
            calls = {t: slab_apply_call(fn, kind, cfg, f)
                     for t, fn in fns.items()}
            design = {t: c() for t, c in calls.items()}
            if kind == "prolong":
                nbytes = (2 * (zl + 2) + 16 * zl) * n * n * item
            else:
                nbytes = ((zl + 2) + (2 if kind == "residual" else 1) * zl) \
                    * n * n * item
            print(json.dumps({"slab_apply": {
                "kernel": kind, "slab": [n, n, zl],
                "dtype": str(dtype)[6:], "ms": in_turns(calls),
                "design": design, "bound_ms": 1e3 * nbytes / 3.35e12}}),
                flush=True)
            del f, calls
            torch.cuda.empty_cache()
    # new against old, bitwise, every gate pair: 5z on a 512^2 x 64 slab,
    # 7z from a 256^2 x 32 one and, in float64, from 32^2 x 4
    checks = []
    for kind, n, dtype in (("apply", 512, torch.float32),
                           ("residual", 512, torch.float32),
                           ("prolong", 256, torch.float32),
                           ("prolong", 32, torch.float64)):
        cfg, f = fields(n, n // K, dtype, fine=kind == "prolong")
        keep = f["fine"].clone() if kind == "prolong" else None
        for gates in ((False, False), (True, False), (False, True),
                      (True, True)):
            got = {}
            for t, fn in fns.items():
                if keep is not None:
                    f["fine"].copy_(keep)
                else:
                    f["out"].fill_(float("nan"))
                slab_apply_call(fn, kind, cfg, f, gates)()
                got[t] = f["fine" if keep is not None else "out"][
                    dk._ISL].clone()
            torch.cuda.synchronize()
            checks.append({"kernel": kind, "slab": [n, n, n // K],
                           "dtype": str(dtype)[6:], "gates": gates,
                           "bitwise": torch.equal(got["old"], got["new"])})
            del got
        del f, keep
        torch.cuda.empty_cache()
    print(json.dumps({"slab_apply_bitwise": checks}), flush=True)
    i = r"(?:\(int\))?"
    pick = re.compile(rf"void (apply_faces_kernel<\w+, {i}[12], {i}0, {i}0, "
                      rf"{i}1>|stream_kernel<\w+, {i}0, {i}[12], {i}0, {i}0, "
                      rf"{i}1>|prolong_pair_kernel<\w+>|"
                      rf"prolong_correct_kernel<\w+, {i}0, {i}1>)")
    print(json.dumps({"slab_apply_ptxas": {
        t: ptxas_resources(g, pick.match) for t, g in logs.items()}}),
        flush=True)


#: rows 1ze and 5ze as shipped against the design before them
#: (OMG_SLABEPS=0: the coefficient slab launches on stream_kernel.cuh)
SLAB_EPS_VARIANTS = {"old": ["-DOMG_SLABEPS=0"], "new": []}


def probe_slab_eps(levels=(512, 256, 128, 64, 32), K=8):
    from octree_mg_tpu_torch.ops import df32 as df
    fns, logs = build_many(
        {k: v + ["-Xptxas", "-v"] for k, v in SLAB_EPS_VARIANTS.items()},
        {"stencil_sweep": "omg_stencil_slab"})
    # whole slabs of every sharded level, the double pair also on the
    # 4-plane edge strips of the overlapped levels (Zl >= 8) and with one
    # pair on the largest slab
    shapes = [("pairs", n, n // K, 2) for n in levels]
    shapes += [("pairs", n, 4, 2) for n in levels if n // K >= 8]
    shapes += [("pairs", levels[0], levels[0] // K, 1)]
    shapes += [(kind, n, n // K, 0) for kind in ("residual", "apply")
               for n in levels]
    for (kind, n, zl, k), n_eps in ((sh, e) for sh in shapes for e in (1, 3)):
        cfg, f = slab_fields(n, zl, torch.float32, 7, n_eps)
        calls = {t: slab_apply_call(fn, kind, cfg, f, n_pairs=k, lam=1.5)
                 for t, fn in fns.items()}
        design = {t: c() for t, c in calls.items()}
        h = 2 * k if kind == "pairs" else 1
        # phi (and rhs) with the pad planes read, the coefficients with
        # theirs, the output's core
        reads = (2 if kind != "apply" else 1) + n_eps
        nbytes = (reads * (zl + 2 * h) + zl) * n * n * 4
        print(json.dumps({"slab_eps": {
            "kernel": kind, "n_pairs": k or None, "n_eps": n_eps,
            "slab": [n, n, zl], "ms": in_turns(calls), "design": design,
            "bound_ms": 1e3 * nbytes / 3.35e12}}), flush=True)
        del f, calls
        torch.cuda.empty_cache()
    # row 8z beside them: the slab double-float residual on the 512^2 x 64
    # slab from its library (the shipped build), equal power-of-two
    # spacing, Dirichlet 0
    n, zl = levels[0], levels[0] // K
    cfg = dk.DenseStencilConfig((n, n, zl), (float(n * n),) * 3,
                                [(2.0, -1.0, 0.0)] * 6, (False,) * 3,
                                torch.float32, b_const=[0.0] * 6)
    g = torch.Generator(device="cuda").manual_seed(8)
    xhi, rhi = (torch.randn(cfg.pshape, generator=g, device="cuda")
                for _ in range(2))
    xlo, rlo = xhi * 2.0 ** -25, rhi * 2.0 ** -25
    out = torch.empty_like(xhi)
    P = dk._params(cfg, 0.0, [None] * 6)
    Q = df._Df32Params()
    for nb, (hi, lo) in enumerate(df._cb_pairs(cfg)):
        Q.cb_hi[nb], Q.cb_lo[nb] = hi, lo
    Zs = dk._slab_params((False, False))
    fn = dk._fn("residual_df32", "omg_residual_df32_slab")
    st = torch.cuda.current_stream().cuda_stream

    def r8z():
        e = fn(ctypes.byref(P), ctypes.byref(Q), ctypes.byref(Zs),
               xhi.data_ptr(), xlo.data_ptr(), rhi.data_ptr(),
               rlo.data_ptr(), out.data_ptr(), st, None)
        assert e == 0, e

    r8z()
    torch.cuda.synchronize()
    want = df.residual_df32_dense(cfg, xhi, xlo, rhi, rlo,
                                  z_gates=(False, False))
    print(json.dumps({"slab_eps_8z": {
        "kernel": "residual_df32_dense[z_gates]", "slab": [n, n, zl],
        "ms": [time_ms(r8z, reps=10) for _ in range(2)],
        "bitwise_the_wrapper": torch.equal(out[dk._ISL], want[dk._ISL]),
        "bound_ms": 1e3 * (2 * (zl + 2) + 3 * zl) * n * n * 4 / 3.35e12}}),
        flush=True)
    del xhi, xlo, rhi, rlo, out, want
    torch.cuda.empty_cache()
    # new against old, bitwise, every gate pair, on the 512^2 x 64 slab
    checks = []
    for n_eps in (1, 3):
        cfg, f = slab_fields(levels[0], levels[0] // K, torch.float32, 7,
                             n_eps)
        for (kind, k), gates in (
                (kk, gg) for kk in (("pairs", 2), ("pairs", 1),
                                    ("residual", 0), ("apply", 0))
                for gg in ((False, False), (True, False), (False, True),
                           (True, True))):
            got = {}
            for t, fn in fns.items():
                f["out"].fill_(float("nan"))
                slab_apply_call(fn, kind, cfg, f, gates, k, 1.5)()
                got[t] = f["out"][dk._ISL].clone()
            torch.cuda.synchronize()
            checks.append({"kernel": kind, "n_pairs": k or None,
                           "n_eps": n_eps, "gates": gates,
                           "bitwise": torch.equal(got["old"], got["new"])})
            del got
        del f
        torch.cuda.empty_cache()
    print(json.dumps({"slab_eps_bitwise": checks}), flush=True)
    i = r"(?:\(int\))?"
    pick = re.compile(rf"void (face_kernel<\w+, {i}[24], {i}0, {i}[13], "
                      rf"{i}1>|apply_faces_kernel<\w+, {i}[12], {i}[13], "
                      rf"{i}0, {i}1>|stream_kernel<\w+, {i}\d, {i}[012], "
                      rf"{i}[13], {i}0, {i}1>)")
    print(json.dumps({"slab_eps_ptxas": {
        t: ptxas_resources(g, pick.match) for t, g in logs.items()}}),
        flush=True)


HALF_VARIANTS = {"old": ["-DOMG_HALFAF=0"], "new": []}
#: the canvases the forests send one half-sweep (forest_periodic's full
#: levels at base 256)
HALF_LEVELS = (256, 128, 64, 32, 16)


def half_fields(n, dtype, seed=9):
    """A forest level's half-sweep inputs on an n^3 canvas: the dense
    forest's kernel config (identity coefficients, every face a plane),
    phi, rhs and the six planes random."""
    cfg = dk.DenseStencilConfig((n,) * 3, (float(n * n),) * 3,
                                [(1.0, 0.0, 0.0)] * 6, (False,) * 3, dtype,
                                b_const=[None] * 6)
    g = torch.Generator(device="cuda").manual_seed(seed)
    f = {k: torch.randn(cfg.pshape, generator=g, dtype=dtype, device="cuda")
         for k in ("phi", "rhs")}
    f["planes"] = [torch.randn(cfg.plane_shape(nb), generator=g, dtype=dtype,
                               device="cuda") for nb in range(6)]
    f["out"] = torch.empty_like(f["phi"])
    return cfg, f


def half_call(fns, cfg, f, parity=0):
    """One half-sweep of one build into f["out"], on the current stream;
    returns the design."""
    P = dk._params(cfg, 0.0, f["planes"], parity, 1)
    E = dk._eps_params(cfg, ())
    d = ctypes.c_int(-1)

    def run():
        st = torch.cuda.current_stream().cuda_stream
        e = fns["omg_stencil_sweep"](dk._dt(cfg), 0, ctypes.byref(P),
                                     ctypes.byref(E), f["phi"].data_ptr(),
                                     f["rhs"].data_ptr(),
                                     f["out"].data_ptr(), st,
                                     ctypes.byref(d))
        assert e == 0, e
        return d.value
    return run


def probe_half(levels=HALF_LEVELS):
    fns, logs = build_many(
        {k: v + ["-Xptxas", "-v"] for k, v in HALF_VARIANTS.items()},
        {"stencil_sweep": "omg_stencil_sweep"})
    checks = []
    for dtype in (torch.float32, torch.float64):
        item = 4 if dtype == torch.float32 else 8
        for n in levels:
            cfg, f = half_fields(n, dtype)
            calls = {t: half_call(fn, cfg, f) for t, fn in fns.items()}
            design = {t: c() for t, c in calls.items()}
            # phi and rhs read, the output written, the six planes read
            nbytes = 3 * n ** 3 * item + sum(p.numel() for p in
                                             f["planes"]) * item
            print(json.dumps({"half": {
                "dims": [n] * 3, "dtype": str(dtype)[6:],
                "ms": in_turns(calls), "device_ms": graph_turns(calls),
                "design": design,
                "bound_ms": 1e3 * nbytes / 3.35e12}}), flush=True)
            for parity in (0, 1):
                got = {}
                for t, fn in fns.items():
                    f["out"].fill_(float("nan"))
                    half_call(fn, cfg, f, parity)()
                    got[t] = f["out"][dk._ISL].clone()
                torch.cuda.synchronize()
                checks.append({"dims": [n] * 3, "dtype": str(dtype)[6:],
                               "parity": parity,
                               "bitwise": torch.equal(got["old"],
                                                      got["new"])})
                del got
            del f, calls
            torch.cuda.empty_cache()
    print(json.dumps({"half_bitwise": checks}), flush=True)
    i = r"(?:\(int\))?"
    pick = re.compile(rf"void (apply_faces_kernel<\w+, {i}4, {i}0, {i}0, "
                      rf"{i}0>|stream_kernel<\w+, {i}1, {i}0, {i}0, {i}0, "
                      rf"{i}0>)")
    print(json.dumps({"half_ptxas": {
        t: ptxas_resources(g, pick.match) for t, g in logs.items()}}),
        flush=True)


DF32_VARIANTS = {"old": ["-DOMG_DF32MARCH=0"], "new": []}


def df32_fields(dims, per=(False, False, False), gates=None, seed=8):
    """The double-float residual's inputs on a level (or, with gates, a
    slab whose z pads hold random neighbour planes): equal power-of-two
    spacing, Dirichlet 0; x_hi and rhs_hi N(0,1), their lo parts 2^-25 of
    that, pads random."""
    n = max(dims) if gates is None else max(dims[:2])
    h2 = float(2 ** (2 * int(math.ceil(math.log2(n)))))
    cfg = dk.DenseStencilConfig(dims, (h2,) * 3, [(2.0, -1.0, 0.0)] * 6,
                                per, torch.float32, b_const=[0.0] * 6)
    g = torch.Generator(device="cuda").manual_seed(seed)
    f = {k: torch.randn(cfg.pshape, generator=g, device="cuda")
         for k in ("xhi", "rhi")}
    f["xlo"], f["rlo"] = f["xhi"] * 2.0 ** -25, f["rhi"] * 2.0 ** -25
    f["out"] = torch.empty_like(f["xhi"])
    return cfg, f


def df32_call(fns, cfg, f, gates=None, lam=0.0):
    """One double-float residual of one build into f["out"], on the
    current stream; returns the design (gates: the slab mode)."""
    from octree_mg_tpu_torch.ops import df32 as df
    P = dk._params(cfg, 0.0, [None] * 6)
    Q = df._Df32Params()
    for nb, (hi, lo) in enumerate(df._cb_pairs(cfg)):
        Q.cb_hi[nb], Q.cb_lo[nb] = hi, lo
    lp = df.split_lam(lam)
    Q.has_lam = int(lp is not None)
    Q.lam_hi, Q.lam_lo = lp if lp is not None else (0.0, 0.0)
    Zs = dk._slab_params(gates) if gates is not None else None
    d = ctypes.c_int(-1)
    ptrs = [f[k].data_ptr() for k in ("xhi", "xlo", "rhi", "rlo", "out")]

    def run():
        st = torch.cuda.current_stream().cuda_stream
        if gates is None:
            e = fns["omg_residual_df32"](ctypes.byref(P), ctypes.byref(Q),
                                         *ptrs, st, ctypes.byref(d))
        else:
            e = fns["omg_residual_df32_slab"](
                ctypes.byref(P), ctypes.byref(Q), ctypes.byref(Zs), *ptrs,
                st, ctypes.byref(d))
        assert e == 0, e
        return d.value
    return run


def probe_df32_march(levels=(512, 256, 128, 64, 32), K=8):
    fns, logs = build_many(
        {k: v + ["-Xptxas", "-v"] for k, v in DF32_VARIANTS.items()},
        {"residual_df32": "omg_residual_df32"})
    for t in fns:       # the slab mode from the same library
        f = ctypes.CDLL(os.path.join(OUT, f"residual_df32_{t}.so"))
        f = f.omg_residual_df32_slab
        f.argtypes = dk._ARGTYPES["omg_residual_df32_slab"]
        f.restype = ctypes.c_int
        fns[t]["omg_residual_df32_slab"] = f
    shapes = [((n, n, n // K), (False, False)) for n in levels]
    shapes += [((n, n, n), None) for n in levels[:2]]
    for dims, gates in shapes:
        cfg, f = df32_fields(dims, gates=gates)
        calls = {t: df32_call(fn, cfg, f, gates) for t, fn in fns.items()}
        design = {t: c() for t, c in calls.items()}
        X, Y, Z = dims
        # x_hi and x_lo with the pad planes a slab reads, rhs_hi, rhs_lo
        # and the output
        halo = 2 if gates is not None else 0
        nbytes = (2 * (Z + halo) + 3 * Z) * X * Y * 4
        print(json.dumps({"df32_march": {
            "kernel": "residual_df32_dense" + ("[z_gates]" if gates else ""),
            "dims": list(dims), "ms": in_turns(calls),
            "device_ms": graph_turns(calls), "design": design,
            "bound_ms": 1e3 * nbytes / 3.35e12}}), flush=True)
        del f, calls
        torch.cuda.empty_cache()
    checks = []
    n = levels[0]
    for per_z, gates, lam in (
            (pz, gg, lm) for pz in (False, True)
            for gg in ((False, False), (True, False), (False, True),
                       (True, True)) for lm in (0.0, 0.37)):
        cfg, f = df32_fields((n, n, n // K), (False, False, per_z), gates)
        got = {}
        for t, fn in fns.items():
            f["out"].fill_(float("nan"))
            df32_call(fn, cfg, f, gates, lam)()
            got[t] = f["out"][dk._ISL].clone()
        torch.cuda.synchronize()
        checks.append({"dims": [n, n, n // K], "periodic_z": per_z,
                       "gates": gates, "lam": lam,
                       "bitwise": torch.equal(got["old"], got["new"])})
        del f, got
    cfg, f = df32_fields((n,) * 3)
    got = {}
    for t, fn in fns.items():
        f["out"].fill_(float("nan"))
        df32_call(fn, cfg, f, None, 0.37)()
        got[t] = f["out"][dk._ISL].clone()
    torch.cuda.synchronize()
    checks.append({"dims": [n] * 3, "lam": 0.37,
                   "bitwise": torch.equal(got["old"], got["new"])})
    del f, got
    torch.cuda.empty_cache()
    print(json.dumps({"df32_march_bitwise": checks}), flush=True)
    i = r"(?:\(int\))?"
    pick = re.compile(rf"void (df32_march_kernel<{i}[01]>|"
                      rf"residual_df32_kernel<{i}[01]>)")
    print(json.dumps({"df32_march_ptxas": {
        t: ptxas_resources(g, pick.match) for t, g in logs.items()}}),
        flush=True)


def vcoeff_solver(op, n=512):
    """The vcoeff_path solver of chip_smoke.py (512^3 float32, lam 1.5,
    Dirichlet 0, smooth coefficients, seeded rhs) after three FMGs."""
    import chip_smoke
    ps = pkg.PoissonSolver(3, (n,) * 3, 16, operator=op, dtype=torch.float32)
    ps.set_dirichlet(0.0)
    sv = ps.solver
    state = ps._ensure_state()
    for d in range(sv.n_eps):
        sv.set_coefficient(state, chip_smoke.smooth_eps(sv, d, torch.float32),
                           d)
    sv.prepare_coefficient(state)
    g = torch.Generator(device="cuda").manual_seed(5)
    ps.set_rhs(arrays={sv.levels[-1]: torch.randn((n,) * 3, generator=g,
                                                  device="cuda")})
    ps.solve(lam=1.5, rtol=0.0, atol=0.0, max_cycles=3)
    return ps, sv


def probe_faces_fmg():
    import chip_smoke
    if not _FACES_FNS:
        _FACES_FNS.update(build_many(FACES_VARIANTS)[0])
    fns = _FACES_FNS
    chosen = {s: dk._fn(name, s) for name, s in SYMS.items()}
    n = 512
    for op in ("vhelmholtz", "ahelmholtz"):
        ps, sv = vcoeff_solver(op, n)

        def fmg():
            sv.fas_fmg(ps.state, lam=1.5, have_guess=True, need_res=False)

        rows = {d: {"fmg_ms": [], "vcycle_512_ms": []} for d in fns}
        for d in ("old", "new", "new", "old"):
            dk._fns.update(fns[d])
            fmg()
            rows[d]["fmg_ms"].append(statistics.median(
                chip_smoke.event_ms(fmg) for _ in range(10)))
            rows[d]["vcycle_512_ms"].append(statistics.median(
                [m["device_ms"] for m in chip_smoke.fmg_stage_marks(
                    sv, ps.state) if m["stage"] == "vcycle_to"
                 and m["dims"] == [n] * 3][0] for _ in range(10)))
        dk._fns.update(chosen)
        print(json.dumps({"faces_fmg": {"operator": op, **rows}}),
              flush=True)
        del ps, sv
        torch.cuda.empty_cache()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("probe_torch_kernels: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    only = sys.argv[1:]
    for name, probe in (("wide", probe_wide), ("wide_fmg", probe_wide_fmg),
                        ("faces", probe_faces),
                        ("faces_fmg", probe_faces_fmg),
                        ("apply_faces", probe_apply_faces),
                        ("rr_slab", probe_rr_slab),
                        ("seg", probe_seg),
                        ("slab_apply", probe_slab_apply),
                        ("slab_eps", probe_slab_eps),
                        ("half", probe_half),
                        ("df32_march", probe_df32_march),
                        ("sass", probe_sass),
                        ("tiles", probe_tiles),
                        ("df32_blocks", probe_df32_blocks),
                        ("chunk", probe_chunk)):
        if not only or name in only:
            probe()
