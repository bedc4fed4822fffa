#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA package on one NVIDIA Hopper GPU.

    python3 chip_smoke.py            # everything, as below
    python3 chip_smoke.py --quick    # build + small kernel checks only
    python3 chip_smoke.py --amr      # build + the AMR solver's part only
    python3 chip_smoke.py --drivers  # build + the free-space, diffusion
                                     # and coefficient-forest part only
    python3 chip_smoke.py --forests  # build + the multi-canvas forest and
                                     # refined forest part only
    python3 chip_smoke.py --twod     # build + the 2D dense paths only

Builds the CUDA kernels of ``octree_mg_tpu_torch`` from the sources in
this checkout (the first use compiles them with nvcc), then, one JSON
object per line:

* ``setup``    — card name and power limit, torch/CUDA versions, build s;
* ``checks``   — every kernel against its plain PyTorch version on CUDA
  tensors: 256x128x128, small and ragged periodic levels and an odd one,
  float32 and float64, constant Dirichlet / Neumann / continuous /
  plane-valued faces, NaN-filled pads; the forest's kernels on the same
  levels (the half-sweep of both parities, also with identity-coefficient
  plane faces; the corr_ready and set modes of the prolongation; the
  segment pair (1 and 2 pairs), apply and residual with four ghost
  layers per dim, on every level with even extents); the z-slab variants
  (z_gates) of the pair (1 and 2 pairs), apply, residual and
  prolongation (add) for n_eps 0/1/3 on slabs of 4, 8 and 72 planes,
  every gate pair, periodic and physical z, the pads of a gated-off face
  random and every other pad NaN, with both gates on also against the
  ungated kernels, and the double-float residual's slab variant; the
  double pair and the down-leg (n_pairs 1 and 2, the wide design of
  csrc/stream_wide.cuh) on levels at that design's edges (ragged big
  tiles and coarse tiles, Y below the tile, extents below the halo,
  periodic double pairs, 16^3 and 8^3), and the float32 down-leg on a
  520x520x264 level on faces, fully periodic and mixed, where it must
  run the wide design; the coefficient double pair and down-leg
  (n_eps 1 and 3, n_pairs 1 and 2, float32: the face-plane design of
  csrc/stream_faces.cuh, which every case must run) on the same edge
  levels and the 520x520x264 ones, and the coefficient apply, residual
  and residual-restriction (n_eps 1 and 3, float32 and float64: the
  face-plane apply of csrc/apply_faces.cuh, which every case must run)
  on the edge levels, the 520x520x264 one with x and z periodic and a
  13x7x5 one (apply and residual), the four BC kinds with coefficients
  0.5 + U[0,1) and Dirichlet faces also with 10**(3 U[0,1)) (a 1e3
  contrast); the constant-coefficient residual-restriction (the
  face-plane apply of csrc/apply_faces.cuh without coefficients, which
  every case must run) on the edge levels and the three 520x520x264
  ones, float32 and float64; the slab double pair on float32 slabs its
  wide design takes (csrc/stream_wide.cuh with SLAB = 1, which every
  case must run: 520x520x64, 512x512x64, the sharded 256^3 level's
  256x256x32 and the thin 512x512x8 and 512x512x12, x and y on faces,
  periodic and mixed), n_pairs 1 and 2, every gate pair, physical and periodic z, the four BC kinds, the pads of
  gated-off faces random and every other pad NaN, both gates on also
  against the ungated kernel; the float32 segment pair (1 and 2 pairs),
  apply and residual on canvases their new designs take
  (``SEG_WIDE_SHAPES``: csrc/stream_wide.cuh with SEG = 1 for the pair,
  csrc/apply_faces.cuh with SEG = 1 for the apply and the residual, which
  every case must run): the forest's 256^3 canvas, one with x, y and z
  tails, the smallest and the thinnest the pair's rule takes, 96 layers,
  readers at tile and chunk edges, readers served on both sides and the
  multi-canvas forest's 256^3 unit with its six face layers, NaN
  pads, each against its plain version and against the design before
  (csrc/seg_sweep.cu built with -DOMG_SEGWIDE=0); the slab apply,
  residual and prolongation (add) (``SLAB_APPLY_SHAPES``: the apply and
  the residual on csrc/apply_faces.cuh with SLAB = 1 on float32 slabs of
  2^20 cells and more — the sharded 512^3 and 256^3 levels' slabs, the
  thinnest in 4 and in 2 planes — and on stream_kernel.cuh on the slabs
  its rule leaves — the 128^3 level's, float64 32^2 x 4, 2 planes just
  below 2^20 cells; the prolongation on the pair kernel of
  csrc/prolong_correct.cu on every one of them), every gate pair,
  physical and periodic z, the four BC kinds, the pads of gated-off faces
  random and every other pad NaN, each against its plain version and
  against the designs before (csrc/stencil_sweep.cu and
  csrc/prolong_correct.cu built with -DOMG_SLABAP=0), each counted under
  its new design's counter exactly where the rule takes the slab; the
  float32 coefficient slab double pair (1 and 2 pairs), apply and
  residual, n_eps 1 and 3 (``SLAB_EPS_SHAPES``: csrc/stream_faces.cuh and
  csrc/apply_faces.cuh with SLAB = 1, which every case must run — the
  slabs of sharded_vcoeff's 512^3 .. 32^3 levels over 8, the 4- and
  2-plane edge strips of an overlapped pair group, ragged tiles, an odd
  level), every gate pair, physical and periodic z, the four BC kinds,
  the pads of gated-off faces random (the coefficients' too) and every
  other pad NaN, each against its plain version and against the design
  before (csrc/stencil_sweep.cu built with -DOMG_SLABEPS=0); the
  double-float
  residual on the same shapes (float32, equal power-of-two spacing, constant faces, with
  and without lam, with a boundary-value override); the coefficient
  variants of the four stencil entry points (n_eps 1 and 3, coefficients
  0.5 + U[0,1) with NaN pads) on every level shape, dtype and BC kind;
  the boxed solver's flat half-sweep (float32/float64, D = 1, 2, 3, nc
  2 to 16, 1, 7 and 4096 boxes, lam 0 and 0.7, both parities);
  ``max_ulp`` must be 0 (the kernels repeat the plain arithmetic
  operation by operation, built with --fmad=false);
* ``amr_checks`` — the dense-patch AMR levels' faces against the plain
  versions, 0 ulp: six refinement faces (plane-valued b, the sides_rb
  coefficients with c2 = -0.25), and three of them beside constant
  Dirichlet faces, lam 0 and 0.3, on the AMR path's 512^3 patches and
  256^3 level (float32), the thinnest 512 x 512 levels on which the wide
  design takes the double pair and the down-leg, and 64^3 .. 8^3 and a
  48 x 32 x 16 level in both dtypes: the pair (1 and 2 pairs), apply,
  residual, down-leg, residual-restriction, restriction, one half-sweep,
  the coefficient variants (n_eps 1 and 3) up to 64^3, and the AMR
  solver's region correction (the corr_ready mode against
  ``_prolong_rect`` plus the add, the 258^3 window into a 512^3 patch and
  small ones); each case on the design its rule gives (wide, face-plane,
  the face-plane residual-restriction, the register march, corr_ready;
  the constant-coefficient apply and residual on stream_kernel.cuh);
* ``main_path`` — ``PoissonSolver(3, (512,)*3, 16, dtype=float32)``, zero
  Dirichlet faces, a seeded random right-hand side: one zero-guess FMG
  and eight have-guess FMGs through ``solve``, then a timed loop of
  have-guess FMGs; residual history, ms per FMG, unknowns/s, kernel
  launches (the six residual-restrictions of a have-guess FMG must all
  run the face-plane apply), peak memory;
* ``fmg_stages`` — device and host time of each FMG stage by level;
* ``refined_path`` — the same solver's f64-class mode: a seeded float64
  right-hand side through ``solve_refined(rhs, n_outer=10)``; the norm
  history must fall to 1e-10 of its first entry, the double-float
  residual kernel must have been launched n_outer + 1 times and the
  other five kernels of this path at least once (``update_coarse`` and
  its ``residual_restrict_dense`` do not run from a zero guess; over
  both parts of the main path all seven must have run); then a timed
  ``RefinedPoisson.solve`` (ms per outer, unknowns/s, contraction
  factors, peak memory) and the device time of one outer's pieces;
* ``df32_exactness`` — the double-float residual kernel against the
  native float64 residual of ``x_hi + x_lo`` (the float64 stencil
  kernel), x near a solution; a plain float32 residual must be at least
  50 times worse;
* ``refined_vs_f64`` — at 256^3 the refined solution against the native
  float64 solve run to its floor on the same right-hand side;
* ``fused_mode`` — ``MGConfig.fmg_mode="fused"`` (one CUDA graph per FMG
  and per refined outer) beside the eager default: same bits, ms per FMG
  and per outer of both;
  then the vhelmholtz solver with graphs against eager, bitwise, before
  and after a second ``prepare_coefficient`` with new coefficients;
* ``cpu_agreement`` — the solver at 64^3 in float64 on the card and on
  the CPU (plain versions), three FMGs, laplacian and ahelmholtz; the
  32^3-base L and periodic forests the same way (footprint cells); the
  boxed solver on the sparse periodic tree at base 32, box 4, two FMGs;
  and the drivers' rows (``drivers_cpu_agreement``, also its own line
  under ``--drivers``): both free-space drivers (dense IGF 32^3 box 8,
  boxed 16^3 box 4, two solves each), the spectral and IGF kernel
  tables and the dense driver with the FFT level at the top (spectral),
  every diffusion scheme (helmholtz, vhelmholtz, ahelmholtz) in both
  orders on the dense, dense-AMR and boxed solvers at 16^3, the
  ahelmholtz L forest and the periodic vhelmholtz forest at base 32
  (three FMGs, the plain route's counts equal on both devices); bounds
  1e-11 of max|phi|, residuals 1e-8 relative (the diffusion rows'
  within 64 eps of the step's rhs scale max|rhs|: their residuals sit
  at the 1e-7 target, ~1e-10 of the terms they cancel; the card read
  at most 4.1e-15 of that scale);
* ``vcoeff_path`` — ``PoissonSolver(3, (512,)*3, 16, operator=...,
  dtype=float32)`` for vhelmholtz and ahelmholtz (lam 1.5, Dirichlet 0,
  coefficients 1 + 0.5 cos(2 pi (x_d + 0.1 d)) set and restricted on the
  card, a seeded right-hand side): residual history of one zero-guess
  and eight have-guess FMGs (must fall monotonically below 1e-3 of the
  first), the probe's setup time, ms per have-guess FMG, unknowns/s,
  launches (the coefficient kernels on every level, no
  constant-coefficient stencil launch, every double pair, down-leg,
  apply, residual and residual-restriction on its face-plane design),
  peak memory;
* ``refined_vcoeff`` — ``solve_refined`` for ahelmholtz at 512^3 (lam
  0.31, three float64 coefficient fields, ten outers): norms to 1e-10 of
  the first, ms per outer, device time of ``residual_df32_vcoeff`` (plain
  PyTorch ops; beside its bound) and of the inner FMG; the solution under a float64
  ahelmholtz solver's operator on the card within 1e-9 of the first norm;
* ``forest_path`` — the dense forest at full width: the JAX package's
  L-shaped benchmark forest (experiments/probe_forest_perf.py) at base
  256, box 16 (level 1 256^3, level 2 a 512^3 canvas at 75 % fill, level
  3 256^3; 1.2e8 leaf unknowns) through ``PoissonSolver(tree=...)`` in
  float32, Dirichlet 0, a seeded normal rhs on the top level (the probe
  puts ones there; see phase_forest_path): one zero-guess and
  eight have-guess FMGs (footprint residuals must fall monotonically to
  below 1e-3 of the first), then eight have-guess FMGs with one sync:
  ``ms_per_fmg``, ``leaf_unknowns_per_s``, launches (the segment pair
  and apply and the corr_ready prolongation must have run), the timed
  run's segment launches per FMG by canvas (every segment pair on a
  canvas of 256^3 and up, and every segment apply and residual, must
  have run its new design), peak memory;
* ``forest_periodic`` — a fully periodic forest (base 128, box 16, a
  corner patch): its full levels run the sequential path, so
  ``half_sweep_dense`` must have run;
* ``boxed_path`` — the boxed solver at full width: ``PoissonSolver(3,
  (256,)*3, 16, tree=..., periodic=True)`` on the fully periodic sparse
  tree (two corner patches of a quarter extent), which ``make_solver``
  sends to ``MGSolver``, the flat half-sweep kernel on: in float32 two
  FMGs (finite, the residual below its first; the coarse loop runs to
  its cap, see phase_boxed_path) and the kernel row on that state; in
  float64 one zero-guess and eight
  have-guess FMGs (residuals must fall monotonically below 1e-3 of the
  first), eight timed have-guess FMGs (``ms_per_fmg``,
  ``leaf_unknowns_per_s``, launches and coarse-loop host reads per FMG,
  peak memory, set-up seconds), and two FMGs with the kernel against two
  with the torch-ops smoother from one state, which must agree bitwise;
* ``amr_path`` — the dense-patch AMR solver at full width: bench.py
  amr's tree ``build_amr_centered(3, 3, 512^3, 16, 1/512)`` (levels 1, 2
  and 3 each 512^3, the two patches with six refinement faces; 3.69e8
  leaf unknowns) through ``PoissonSolver(tree=...)``, laplacian,
  float32, Dirichlet 0: with bench.py's ones on the top patch one
  zero-guess and eight have-guess FMGs (residual history, falling;
  launches: every entry point of the cycle, the corr_ready mode of the
  region corrections, the wide pair and down-leg and the face-plane
  residual-restriction must have run; the plain route must not), eight
  timed have-guess FMGs (``ms_per_fmg``, ``leaf_unknowns_per_s`` as
  bench.py defines it, launches per FMG by entry point and design,
  peak memory, tree build seconds); with a seeded normal rhs on the top
  patch one zero-guess and eight have-guess FMGs (residuals must fall
  monotonically below 1e-3 of the first); ``fmg_mode="fused"`` against
  eager from one state, bitwise on every level, and ms per replayed
  FMG;
* ``amr_cpu_agreement`` — 3-level AMR trees at level-1 size 32 and 16,
  box 8, float64, three FMGs on the card and on the CPU: laplacian,
  helmholtz, vhelmholtz and ahelmholtz (their patch levels with
  refinement faces on the plain route, counted on both), phi within
  1e-11 of max|phi| on every level;
* ``free_space_path`` — ``make_free_space`` over the main path's tree
  (512^3, box 16, float32; IGF kernel, FFT level 256^3, Hockney grid
  516^3), the Gaussian charge of tests/test_free_space.py (sigma 0.1,
  centred): the kernel build clocked apart, five solves (the first
  ``new_rhs=True``, each with an FMG), ms per solve, the max error
  against erf(r/sigma)/(4 pi r) per solve, the residuals, launches,
  peak memory; gates: the last error below FS_ERR_BOUND (6.8e-5: twice
  the O(h^2) extrapolation of the CPU's float32 errors at 64^3 and
  128^3, experiments/driver_bounds_cpu.py), the first below twice the
  last, rows 1, 3, 4, 5, 6 and 7
  launched;
* ``diffusion_path`` — ``diffusion_solve_vcoeff``, order 2, on
  vcoeff_path's 512^3 vhelmholtz problem with Neumann-0 walls and phi0 =
  solution + 2, three steps of dt 0.01, max_res DIFF_MAX_RES (5.71:
  four times the float32 floor extrapolated from the CPU's 32^3 .. 128^3
  floors, experiments/driver_bounds_cpu.py): per step ms, cycles and their residuals, the mass drift
  (summed in float64) and the variance ratio, then the floor measured
  by six more V-cycles; gates: residual <= max_res (the driver raises
  otherwise), mass within 1e-5 relative, variance falling every step,
  the coefficient rows 1e, 3e, 4e, 5e and rows 6 and 7 launched, the
  plain route not;
* ``forest_vcoeff`` — forest_path's L tree (512^3 level-2 canvas,
  1.195e8 leaf unknowns) under vhelmholtz (n_eps 1), float32, lam 1.5,
  eps 1 + 0.5 cos(2 pi x) sin(2 pi y) on every canvas, a seeded normal
  rhs: one zero-guess and eight have-guess FMGs through ``solve``
  (residual history, launches and plain-route counts), three timed
  have-guess FMGs (ms each, launches and plain-route counts per FMG);
  the plain half-sweeps and applies per FMG by canvas and one of each
  timed on the 512^3 and 256^3 canvases; gates: the residual below 1e-3
  of the first, finite footprint, rows 6 and 7c launched, the plain
  route (half-sweep, apply) taken;
* ``multiforest_path`` — the multi-canvas forest at full width:
  forest_tree "sparse" at base 512, box 16 (two 8^3-box corner blobs at
  level 2; one 512^3 level-1 canvas and two 256^3 level-2 canvases;
  1.64e8 leaf unknowns) through ``make_solver``, which must give
  ``DenseMultiForestMGSolver``, float32, Dirichlet 0, a seeded normal rhs
  on the leaf levels: first every distinct unit canvas with its own ghost
  layers through the segment checks (0 ulp against the plain version and
  the old design, each on the design its rule gives), then one
  zero-guess and eight have-guess FMGs (footprint residuals must fall
  monotonically below 1e-3 of the first), eight timed have-guess FMGs
  with one sync (``ms_per_fmg``, ``leaf_unknowns_per_s``, launches per
  FMG, segment launches by canvas on their designs), the unit canvases
  per level, peak memory;
* ``refined_forest_path`` — ``solve_refined`` on forest_path's L tree
  (float32 inner forest, a seeded float64 rhs on every level, eight
  outers, rtol 0, one sync): ms per outer, the leaf residual history
  and its contraction, the device time of the eager double-float step
  and of the inner FMG, launches, peak memory; gates: the last norm <=
  1e-9 of the first and the float64 leaf residual of x_hi + x_lo (an
  independent float64 forest solver on the card) <= 1e-7 of the first
  norm;
* ``forests_cpu_agreement`` — card against CPU: the multi-canvas forest
  (laplacian, vhelmholtz) at base 32, box 4, float64, three FMGs (bounds
  as cpu_agreement's), and the refined forest on the L tree at base 16,
  box 4 (laplacian, vhelmholtz n_eps 1, ahelmholtz n_eps 3; six outers):
  x_hi + x_lo within 1e-11 of max|x| on leaf cells, norms within
  REFINED_AGREE_NORMS (1e-4) relative;
* ``sharded_path`` — the main path's problem through
  ``ShardedDenseMGSolver(n_shards=8)`` (K slabs on one card; levels 512
  to 32 sharded, 16 replicated, 8 the direct coarse level): one
  zero-guess and eight have-guess FMGs against the single-device
  solver's on the same rhs (phi within 1e-5 of max|phi|, the difference
  and its place printed), ms per have-guess FMG of both, launches, the
  stage breakdown of both, the slab double pairs per timed FMG on the
  wide design (the 48 whole slabs of the 512^3 and 256^3 levels must
  run it, the edge strips and smaller slabs not), the slab applies and
  residuals per timed FMG on the face-plane apply (the 16 + 40 on the
  512^2 x 64 and 256^2 x 32 slabs must run it, the smaller slabs not) and
  the slab prolongations on the pair kernel (every one), the slab
  launches by slab in one more untimed FMG, and overlap_halo off bitwise
  against on;
* ``sharded_periodic`` — fully periodic 128^3 over 8 slabs, sharded
  against single; ``sharded_refined`` — ``ShardedRefinedPoisson`` at
  512^3, n_outer=10, norms against ``RefinedPoisson``'s (1e-5
  relative), ms per outer; ``sharded_vcoeff`` — vhelmholtz at 512^3 over
  8 slabs (vcoeff_path's coefficients, lam 1.5), bitwise the single
  device solver, and in four timed have-guess FMGs every coefficient slab
  double pair, apply and residual on its face-plane design (those on the
  512^2 x 64 and 256^2 x 32 slabs included, by slab from one more FMG);
  ``cpu_agreement.sharded`` — 32^3 over 8 slabs, float64, card against
  CPU;
* ``dense2d_path_8192`` / ``dense2d_path_2048`` — bench.py run_2d's
  problem (``build_rectangle(2, (n, n), 16)``, laplacian, Dirichlet 0,
  float32) through ``make_solver``, which must give ``Dense2DMGSolver``:
  bench.py's ones and a seeded normal rhs, one zero-guess and eight
  have-guess FMGs each (histories; the float32 one must fall
  monotonically to its floor), eight timed have-guess FMGs
  (``ms_per_fmg``, ``unknowns_per_s``), the same in
  ``fmg_mode="fused"`` bitwise the split mode, peak memory; at 8192^2 the
  1e-3 convergence gate on the same problem in float64
  (``residuals_float64``);
* ``refined2d_path`` — ``solve_refined`` on the 8192^2 solver (seeded
  float64 rhs, bc_values (0.3, 0, 0.5, -0.25), ten outers, rtol 0): ms per
  outer, norms to 1e-10 of the first, the float64 residual of x_hi + x_lo
  on the card within 1e-8 of the first norm, the device time of one
  eager step and of one inner FMG;
* ``amr2d_path`` — ``build_amr_centered(2, 3, (8192, 8192), 16)`` (three
  8192^2 levels, 1.68e8 leaf unknowns; the tree build clocked apart)
  through ``make_solver``, which must give ``Dense2DAMRMGSolver``: a
  seeded normal rhs on every level, one zero-guess and eight have-guess
  FMGs, eight timed ones (``ms_per_fmg``, ``leaf_unknowns_per_s``), fused
  mode bitwise, peak memory, the float64 gate as above;
* ``twod_op_costs`` — one eager ``pair_sweep_2d``, residual, restriction
  and ``residual_df32_2d`` at 8192^2 float32 (CUDA events; device
  launches from ``torch.profiler``) beside their byte bounds;
* ``twod_cpu_agreement`` — the 2D solvers at <= 64^2 in float64 on the
  card and on the CPU (the uniform solver with the five operators,
  periodic and not, and the cylindrical laplacian; the AMR solver with the
  five operators and the cylindrical laplacian; three FMGs; phi within 64
  eps of max|phi|, residuals within 1e-9 of the first) and
  ``RefinedPoisson2D`` (lam 0 and 0.53, float32; x within 1e-12 of max|x|,
  norms within 1e-4 above 1e-9 of the first).  No 2D phase may move a
  counter of ``ops.dense_kernels``: the 2D paths are torch ops only;
* ``kernels``  — per kernel entry point at the main path's 512^3 float32
  shape, and per coefficient variant ``name[n_eps=k]``: launches on its
  path (the float32 solve for the six stencil kernels, the refined solve
  for the double-float residual, the vcoeff solve for the variants),
  max_abs_err against the plain version, ms (median, CUDA events),
  plain_ms, bound_ms (bytes over 3.35 TB/s or flops over 67 TFLOP/s,
  whichever is larger), library_ms (the double pair's and the
  down-leg's rows name the design they run at 512^3 in ``design``, the
  wide one or, for ``n_eps`` 1 and 3, the face-plane one, and so do the
  apply's and the residual-restriction's ``n_eps`` rows;
  the apply's row carries ``conv3d_core_ms``, a cuDNN 7-point
  convolution of the zero-padded core as a yardstick: not the same
  function at the faces); then the forest's kernels at the
  shapes the forest paths give them (the segment pair and residual on
  level 2's 512^3 canvas with its ghost layers, each row naming its
  design, its launches on it per FMG by canvas and the old design's time
  on the same inputs, the corr_ready
  correction 256^3 -> 512^3, the half-sweep on the periodic forest's
  128^3 level) and the set mode at the main path's prolongation shape;
  the flat half-sweep at the boxed path's level-1 shape [4096, 18^3]
  (float32, its float64 time beside it); the slab variants
  ``name[z_gates]`` (and the pair's and apply's ``[n_eps=1][z_gates]``)
  on an interior slab of the 512^3 level over 8 slabs (64 planes; the
  prolongation's coarse slab 32 planes), both gates off, their bound
  counting the pad planes they read (the pair's row names the wide
  design and its launches; the residual-restriction's row the
  face-plane apply and its launches; the residual's and the
  prolongation's rows their new designs, the old design's time on the
  same inputs, and level by level the time as shipped and on the old
  design, the bound and the launches per FMG; so do the coefficient
  pair's and residual's ``[n_eps=1][z_gates]`` rows, the pair's levels
  with the 4-plane edge strips, their launches per FMG from
  sharded_vcoeff);
  every row whose counter ``amr_path``'s solve launched carries those
  launches and the timed FMGs' per FMG (``amr_path_launches``,
  ``amr_path_launches_per_fmg``), and likewise the launches of the
  driver paths (``free_space_launches``, ``diffusion_launches``,
  ``forest_vcoeff_launches``, ``forest_vcoeff_launches_per_fmg``) and of
  the two forest paths (``multiforest_path_launches``,
  ``multiforest_path_launches_per_fmg``, ``refined_forest_path_launches``,
  ``refined_forest_path_launches_per_outer``);
* the ``nvidia-smi`` name and power limit line;
* ``{"ok": true, "device": {...}}`` as the last line.

Any failed phase raises: the script then exits non-zero and prints no
final line.  Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOP_PER_S = 67e12        # H100 SXM data sheet, outside tensor cores
SOURCES = {
    "pair_sweep_dense": "octree_mg_tpu_torch/csrc/stencil_sweep.cu",
    "stencil_apply_dense": "octree_mg_tpu_torch/csrc/stencil_sweep.cu",
    "downsweep_dense": "octree_mg_tpu_torch/csrc/downsweep.cu",
    "residual_restrict_dense": "octree_mg_tpu_torch/csrc/downsweep.cu",
    "restrict_dense": "octree_mg_tpu_torch/csrc/restrict.cu",
    "prolong_correct_dense": "octree_mg_tpu_torch/csrc/prolong_correct.cu",
    "residual_df32_dense": "octree_mg_tpu_torch/csrc/residual_df32.cu",
}
REPLACES = {
    "pair_sweep_dense": "octree_mg_tpu/ops/dense_kernels.py:932",
    "stencil_apply_dense": "octree_mg_tpu/ops/dense_kernels.py:1061",
    "downsweep_dense": "octree_mg_tpu/ops/dense_kernels.py:1008",
    "residual_restrict_dense": "octree_mg_tpu/ops/dense_kernels.py:1043",
    "restrict_dense": "octree_mg_tpu/ops/dense_kernels.py:1157",
    "prolong_correct_dense": "octree_mg_tpu/ops/dense_kernels.py:1213",
    "residual_df32_dense": "octree_mg_tpu/ops/df32.py:285",
}
#: the coefficient variants of the four stencil entry points: the same
#: sources and TPU kernels (the Pallas bodies with eps windows)
EPS_VARIANTS = tuple(f"{k}[n_eps={n}]" for n in (1, 3) for k in (
    "pair_sweep_dense", "downsweep_dense", "residual_restrict_dense",
    "stencil_apply_dense"))
for _v in EPS_VARIANTS:
    SOURCES[_v] = SOURCES[_v.split("[")[0]]
    REPLACES[_v] = REPLACES[_v.split("[")[0]]
#: the kernels of the float32 FMG path, and of the refined path: its inner
#: FMG starts from a zero guess with A(0) = 0, so its coarse right-hand
#: sides come from restrict_dense alone and update_coarse (the caller of
#: residual_restrict_dense) never runs
CONST_KERNELS = tuple(k for k in SOURCES if k not in EPS_VARIANTS)
#: the dense forest's kernels: the half-sweep of its sequential path, the
#: segment-synthesis variants of its fused-canvas path and the two other
#: modes of the prolongation (corr_ready: its correction; set: no caller
#: in either package, checked and timed only)
FOREST_VARIANTS = ("half_sweep_dense", "pair_sweep_dense[segs]",
                   "stencil_apply_dense[segs]",
                   "prolong_correct_dense[corr_ready]",
                   "prolong_correct_dense[set]")
SOURCES.update({
    "half_sweep_dense": "octree_mg_tpu_torch/csrc/stencil_sweep.cu",
    "pair_sweep_dense[segs]": "octree_mg_tpu_torch/csrc/seg_sweep.cu",
    "stencil_apply_dense[segs]": "octree_mg_tpu_torch/csrc/seg_sweep.cu",
    "prolong_correct_dense[corr_ready]":
        "octree_mg_tpu_torch/csrc/prolong_correct.cu",
    "prolong_correct_dense[set]":
        "octree_mg_tpu_torch/csrc/prolong_correct.cu"})
REPLACES.update({
    "half_sweep_dense": "octree_mg_tpu/ops/dense_kernels.py:979",
    "pair_sweep_dense[segs]": "octree_mg_tpu/ops/dense_kernels.py:932",
    "stencil_apply_dense[segs]": "octree_mg_tpu/ops/dense_kernels.py:1061",
    "prolong_correct_dense[corr_ready]":
        "octree_mg_tpu/ops/dense_kernels.py:1213",
    "prolong_correct_dense[set]": "octree_mg_tpu/ops/dense_kernels.py:1213"})
#: what each forest phase must launch
FOREST_PATH_KERNELS = ("pair_sweep_dense[segs]", "stencil_apply_dense[segs]",
                       "prolong_correct_dense[corr_ready]", "restrict_dense")
FOREST_PERIODIC_KERNELS = FOREST_PATH_KERNELS + ("half_sweep_dense",
                                                 "stencil_apply_dense")
#: the boxed solver's kernel (MGSolver with MGExperimental.pallas_smoother)
SOURCES["half_sweep_flat"] = "octree_mg_tpu_torch/csrc/flat_sweep.cu"
REPLACES["half_sweep_flat"] = "octree_mg_tpu/ops/pallas_smoother.py:50"
BOXED_KERNELS = ("half_sweep_flat",)
FMG_KERNELS = tuple(k for k in CONST_KERNELS if k != "residual_df32_dense")
REFINED_KERNELS = tuple(k for k in CONST_KERNELS
                        if k != "residual_restrict_dense")
#: the z-slab variants (z_gates) of the four kernels the slab solver
#: launches (ShardedDenseMGSolver, ShardedRefinedPoisson), and the
#: coefficient variants of the stencil two (its vhelmholtz path): the
#: sources and TPU kernels of the entry points, called with z_gates
SLAB_VARIANTS = ("pair_sweep_dense[z_gates]", "stencil_apply_dense[z_gates]",
                 "prolong_correct_dense[z_gates]",
                 "residual_df32_dense[z_gates]")
SLAB_EPS_VARIANTS = ("pair_sweep_dense[n_eps=1][z_gates]",
                     "stencil_apply_dense[n_eps=1][z_gates]")
for _v in SLAB_VARIANTS + SLAB_EPS_VARIANTS:
    SOURCES[_v] = SOURCES[_v.split("[")[0]]
    REPLACES[_v] = REPLACES[_v.split("[")[0]]
#: what the sharded FMG must launch (restrict_dense: slab to slab)
SHARDED_KERNELS = SLAB_VARIANTS[:3] + ("restrict_dense",)


#: the refinement-face ghost of the dense-patch AMR solver (sides_rb):
#: ghost = 0.5*b + 0.75*x1 - 0.25*x2, b the coarse interpolation plane
RB_COEFFS = (0.5, 0.75, -0.25)
#: the refinement faces of the "amr_mixed" case kind (x-, y+, z+)
AMR_MIXED_RB = (0, 3, 5)


def vcoeff_kernels(n_eps):
    """The kernels of a variable-coefficient solve: the four stencil
    entry points' n_eps variants, the restriction (prepare_coefficient
    and the zero-guess FMG) and the prolongation."""
    return tuple(v for v in EPS_VARIANTS if v.endswith(f"={n_eps}]")) + (
        "restrict_dense", "prolong_correct_dense")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# kernel cases
# ---------------------------------------------------------------------------

def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units of the last place; NaN anywhere counts
    as a failure (-1)."""
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        return -1
    it = torch.int32 if a.dtype == torch.float32 else torch.int64
    ia, ib = a.contiguous().view(it).long(), b.contiguous().view(it).long()
    # map the sign-magnitude float order onto the integers
    lim = -(1 << (31 if it == torch.int32 else 63))
    ia = torch.where(ia < 0, lim - ia, ia)
    ib = torch.where(ib < 0, lim - ib, ib)
    return int((ia - ib).abs().max())


def make_case(dk, dims, periodic, bc_kind, dtype, seed, nan_pads=True,
              equal_pow2=False, n_eps=0):
    """A level config with random fields on the card.  Pads are NaN
    except where a periodic axis makes them wrapped copies.
    equal_pow2: one power-of-two spacing on all axes (the double-float
    residual's gate) instead of 1/extent per axis."""
    X, Y, Z = dims
    g = torch.Generator(device="cuda").manual_seed(seed)
    dr = (1.0 / X, 1.0 / Y, 1.0 / Z)
    if equal_pow2:
        dr = (2.0 ** -int(np.ceil(np.log2(max(dims)))),) * 3
    idr2 = tuple(1.0 / h ** 2 for h in dr)
    if bc_kind == "dirichlet":
        bc = [(2.0, -1.0, 0.0)] * 6
        b_const = [0.5] * 6
    elif bc_kind == "neumann":
        bc = [(dr[nb // 2] * (-1 if nb % 2 == 0 else 1), 1.0, 0.0)
              for nb in range(6)]
        b_const = [0.3] * 6
    elif bc_kind == "continuous":
        bc = [(0.0, 2.0, -1.0)] * 6
        b_const = [0.0] * 6
    elif bc_kind == "planes":
        bc = [(2.0, -1.0, 0.0)] * 6
        b_const = [None] * 6
    elif bc_kind == "forest":
        # the forest's sequential levels: ghosts assembled into the
        # planes, read with identity coefficients
        bc = [(1.0, 0.0, 0.0)] * 6
        b_const = [None] * 6
    elif bc_kind in ("amr", "amr_mixed"):
        # a dense-patch AMR level: refinement faces (the sides_rb
        # combination with a plane-valued b, c2 = -0.25) on all six faces
        # (the patches of amr_path) or on AMR_MIXED_RB beside constant
        # Dirichlet faces
        rb = range(6) if bc_kind == "amr" else AMR_MIXED_RB
        bc = [RB_COEFFS if nb in rb else (2.0, -1.0, 0.0) for nb in range(6)]
        b_const = [None if nb in rb else 0.3 for nb in range(6)]
    else:
        raise ValueError(bc_kind)
    cfg = dk.DenseStencilConfig(dims, idr2, bc, periodic, dtype,
                                b_const=b_const, n_eps=n_eps)

    def field(c):
        a = torch.full(c.pshape, float("nan") if nan_pads else 0.0,
                       dtype=dtype, device="cuda")
        a[dk.PZ:-dk.PZ, dk.PY:-dk.PY] = torch.randn(
            (c.Z, c.Y, c.X), generator=g, dtype=dtype, device="cuda")
        return dk.sync_pads(c, a)

    planes = []
    for nb in range(6):
        if cfg.b_const[nb] is not None:
            planes.append(torch.zeros((1, 1), dtype=dtype, device="cuda"))
            continue
        n0, n1 = ((Z, Y), (Z, Y), (Z, X), (Z, X), (Y, X), (Y, X))[nb]
        core = torch.randn((n0, n1), generator=g, dtype=dtype, device="cuda")
        p = torch.full(cfg.plane_shape(nb), float("nan"), dtype=dtype,
                       device="cuda")
        # axes of the plane and their pads; wrap on periodic axes
        dims_of = ((2, 1), (2, 1), (2, 0), (2, 0), (1, 0), (1, 0))[nb]
        pads = [(dk.PZ if d == 2 else dk.PY if d == 1 else 0)
                for d in dims_of]
        p[pads[0]:pads[0] + n0, pads[1]:pads[1] + n1] = core
        for ax, d in enumerate(dims_of):
            if pads[ax] and periodic[d]:
                n, w = (n0, n1)[ax], pads[ax]
                idx = (torch.arange(-w, n + w, device="cuda") % n) + w
                p = p.index_select(ax, idx)
        planes.append(p.contiguous())
    return cfg, field, planes


def eps_fields(dk, cfg, seed, rough=False):
    """cfg.n_eps coefficient fields 0.5 + U[0,1) (rough: 10**(3 U[0,1)),
    a 1e3 contrast from cell to cell) from a seeded generator on the
    card; NaN pads except where a periodic axis makes them wrapped
    copies."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(cfg.n_eps):
        a = torch.full(cfg.pshape, float("nan"), dtype=cfg.dtype,
                       device="cuda")
        u = torch.rand((cfg.Z, cfg.Y, cfg.X), generator=g, dtype=cfg.dtype,
                       device="cuda")
        a[dk._ISL] = 10.0 ** (3.0 * u) if rough else 0.5 + u
        out.append(dk.sync_pads(cfg, a))
    return tuple(out)


def eps_variants(dk, cfg, field, planes, lam, eps):
    """(name, kernel call, plain call) for each coefficient variant of
    the four stencil entry points (cfg.n_eps 1 or 3)."""
    phi, rhs = field(cfg), field(cfg)
    isl, n = dk._ISL, cfg.n_eps
    out = []

    def inner(*ts):
        return tuple(t[isl] for t in ts if t is not None)

    for k in (1, 2) if cfg.periodic_even else (1,):
        out.append((f"pairs{k}[n_eps={n}]",
                    lambda k=k: inner(dk.pair_sweep_dense(
                        cfg, phi, rhs, lam, planes, 0, n_pairs=k, eps=eps)),
                    lambda k=k: inner(dk._pairs_plain(
                        cfg, phi, rhs, lam, planes, 0, k, eps))))
    for res in (False, True):
        out.append((("residual" if res else "apply") + f"[n_eps={n}]",
                    lambda res=res: inner(dk.stencil_apply_dense(
                        cfg, phi, rhs, lam, planes, res, eps=eps)),
                    lambda res=res: inner(dk._apply_plain(
                        cfg, phi, rhs, lam, planes, res, eps))))
    if cfg.even_dims:
        out.append((f"downsweep[n_eps={n}]",
                    lambda: inner(*dk.downsweep_dense(
                        cfg, phi, rhs, lam, planes, 0, eps=eps)),
                    lambda: inner(*dk._down_plain(
                        cfg, phi, rhs, lam, planes, 0, 2, eps))))
        out.append((f"residual_restrict[n_eps={n}]",
                    lambda: inner(*dk.residual_restrict_dense(
                        cfg, phi, rhs, lam, planes, eps=eps)),
                    lambda: inner(*dk._down_plain(
                        cfg, phi, rhs, lam, planes, 0, 0, eps)[1:])))
    return out


def variants(dk, cfg, field, planes, lam):
    """(name, kernel call, plain call) for each kernel variant on fresh
    inputs.  Each call returns a tuple of fields whose
    interiors are compared."""
    phi, rhs = field(cfg), field(cfg)
    X, Y, Z = cfg.dims
    isl = dk._ISL
    out = []

    def inner(*ts):
        return tuple(t[isl] for t in ts if t is not None)

    for n in (1, 2) if cfg.periodic_even else (1,):
        out.append((f"pairs{n}",
                    lambda n=n: inner(dk.pair_sweep_dense(
                        cfg, phi, rhs, lam, planes, 0, n_pairs=n)),
                    lambda n=n: inner(dk._pairs_plain(
                        cfg, phi, rhs, lam, planes, 0, n))))
    for res in (False, True):
        out.append(("residual" if res else "apply",
                    lambda res=res: inner(dk.stencil_apply_dense(
                        cfg, phi, rhs, lam, planes, res)),
                    lambda res=res: inner(dk._apply_plain(
                        cfg, phi, rhs, lam, planes, res))))
    if cfg.even_dims:
        out.append(("downsweep",
                    lambda: inner(*dk.downsweep_dense(
                        cfg, phi, rhs, lam, planes, 0)),
                    lambda: inner(*dk._down_plain(
                        cfg, phi, rhs, lam, planes, 0, 2))))
        out.append(("residual_restrict",
                    lambda: inner(*dk.residual_restrict_dense(
                        cfg, phi, rhs, lam, planes)),
                    lambda: inner(*dk._down_plain(
                        cfg, phi, rhs, lam, planes, 0, 0)[1:])))
        out.append(("restrict",
                    lambda: inner(dk.restrict_dense(cfg, phi)),
                    lambda: inner(dk._restrict_plain(cfg, phi))))
    # prolongation: cfg is the coarse level; the fine level is twice it
    cfg_f = dk.DenseStencilConfig((2 * X, 2 * Y, 2 * Z), cfg.idr2, cfg.bc,
                                  cfg.periodic, cfg.dtype,
                                  b_const=cfg.b_const)
    phi_f = field(cfg_f)
    iold = field(cfg)
    out.append(("prolong_correct",
                lambda: inner(dk.prolong_correct_dense(
                    cfg, phi, iold, phi_f.clone(), planes)),
                lambda: inner(dk._prolong_correct_plain(
                    cfg, phi, iold, phi_f.clone(), planes))))
    out += forest_variants(dk, cfg, phi, rhs, planes, lam, phi_f)
    return out


def forest_variants(dk, cfg, phi, rhs, planes, lam, phi_f):
    """The forest's kernels on a level: the half-sweep of both parities
    and the corr_ready / set modes of the prolongation (cfg the coarse
    level, phi_f a fine field twice its size)."""
    isl = dk._ISL
    out = []
    for parity in (0, 1):
        out.append((f"half_sweep{parity}",
                    lambda parity=parity: (dk.half_sweep_dense(
                        cfg, phi, rhs, lam, planes, parity)[isl],),
                    lambda parity=parity: (dk._half_plain(
                        cfg, phi, rhs, lam, planes, parity)[isl],)))
    for mode in ("corr_ready", "set"):
        kw = dict(corr_ready=True) if mode == "corr_ready" else dict(add=False)
        out.append((f"prolong_correct[{mode}]",
                    lambda kw=kw: (dk.prolong_correct_dense(
                        cfg, phi, None, phi_f.clone(), planes, **kw)[isl],),
                    lambda mode=mode: (dk._prolong_correct_plain(
                        cfg, phi, None, phi_f.clone(), planes, mode)[isl],)))
    return out


def seg_layer_set(dims, kind):
    """Ghost layers (d, c, side) of a canvas: ``faces`` both canvas faces
    of each dim (a multi-canvas forest's corner-blob unit: physical and
    rb faces only); ``faces_and_middle`` both
    canvas faces of each dim (where phys and rb layers lie) and two
    inside (where ring layers lie); ``both_sides`` readers served by a
    layer on each side (at both canvas faces and in the middle);
    ``edges`` readers at the new designs' tile edges (x 3/4 and 63/64,
    y 15/16 and 31/32), at the z-chunk edges of 8 and 16 planes, and at
    the canvas faces, each served on both sides; ``max`` MAX_SEGS layers
    drawn from every one the canvas admits."""
    segs = []
    if kind == "faces":
        for d, n in enumerate(dims):
            segs += [(d, -1, 0), (d, n, 1)]
    elif kind == "faces_and_middle":
        for d, n in enumerate(dims):
            segs += [(d, -1, 0), (d, n, 1), (d, n // 2 - 1, 0),
                     (d, n // 2, 1)]
    elif kind == "both_sides":
        for d, n in enumerate(dims):
            segs += [(d, -1, 0), (d, 1, 1), (d, n // 2 - 1, 0),
                     (d, n // 2 + 1, 1), (d, n - 2, 0), (d, n, 1)]
    elif kind == "edges":
        at = ((0, 3, 4, 63, 64), (0, 15, 16, 31, 32), (0, 7, 8, 15, 16))
        for d, n in enumerate(dims):
            for r in at[d] + (n - 1,):
                if 0 <= r < n:
                    segs += [(d, r - 1, 0), (d, r + 1, 1)]
    elif kind == "max":
        every = [(d, c, side) for d, n in enumerate(dims) for side in (0, 1)
                 for c in (range(-1, n - 1) if side == 0 else
                           range(1, n + 1))]
        pick = np.random.default_rng(len(every)).choice(
            len(every), size=min(96, len(every)), replace=False)
        segs = [every[i] for i in sorted(pick)]
    else:
        raise ValueError(kind)
    return sorted(set(segs), key=segs.index)


def seg_case(dk, dims, dtype, seed, segs):
    """A forest canvas on the card with ghost layers ``segs``: random
    coefficient planes whose masks cover ~70 % of each layer, random phi
    and rhs with NaN pads."""
    X, Y, Z = dims
    idr2 = (1.0 / X ** 2 * 4, 1.0 / Y ** 2 * 2, 1.0 / Z ** 2)
    cfg = dk.DenseStencilConfig(dims, idr2, [(1.0, 0.0, 0.0)] * 6,
                                (True,) * 3, dtype, b_const=[0.0] * 6)
    g = torch.Generator(device="cuda").manual_seed(seed)
    planes = []
    for d, _, _ in segs:
        a = torch.randn(dk._seg_plane_shape(cfg, d), generator=g,
                        dtype=dtype, device="cuda")
        a[3] = (torch.rand(a.shape[1:], generator=g, device="cuda")
                < 0.7).to(dtype)
        planes.append(a)

    def field():
        a = torch.full(cfg.pshape, float("nan"), dtype=dtype, device="cuda")
        a[dk._ISL] = torch.randn((Z, Y, X), generator=g, dtype=dtype,
                                 device="cuda")
        return a

    return cfg, planes, field(), field()


def seg_variants(dk, dims, dtype, seed, lam):
    """The segment-synthesis variants of pair (1 and 2 pairs), apply and
    residual on a canvas with four ghost layers per dim
    (``faces_and_middle``); NaN pads."""
    segs = seg_layer_set(dims, "faces_and_middle")
    cfg, planes, phi, rhs = seg_case(dk, dims, dtype, seed, segs)
    isl = dk._ISL
    kw = dict(segs=segs, seg_planes=planes)
    out = []
    for n in (1, 2):
        out.append((f"pairs{n}[segs]",
                    lambda n=n: (dk.pair_sweep_dense(
                        cfg, phi, rhs, lam, None, 0, n_pairs=n, **kw)[isl],),
                    lambda n=n: (dk._seg_pairs_plain(
                        cfg, phi, rhs, lam, 0, n, segs, planes)[isl],)))
    for res in (False, True):
        out.append((("residual" if res else "apply") + "[segs]",
                    lambda res=res: (dk.stencil_apply_dense(
                        cfg, phi, rhs, lam, None, res, **kw)[isl],),
                    lambda res=res: (dk._seg_apply_plain(
                        cfg, phi, rhs, lam, res, segs, planes)[isl],)))
    return out


def slab_field(dk, cfg, g, gates, coef=False):
    """A z-slab's field on the card: random core (N(0,1), or 0.5 + U[0,1)
    for a coefficient), random z pads on each side whose pads the slab
    reads (a periodic z axis, or a gate off: the neighbour slab's
    planes), NaN in every other pad but the y wraps of a periodic y
    axis."""
    PZ, PY, Z = dk.PZ, dk.PY, cfg.Z
    a = torch.full(cfg.pshape, float("nan"), dtype=cfg.dtype, device="cuda")
    rows = [(PZ, PZ + Z)]
    if cfg.periodic[2] or not gates[0]:
        rows.append((0, PZ))
    if cfg.periodic[2] or not gates[1]:
        rows.append((PZ + Z, 2 * PZ + Z))
    for z0, z1 in rows:
        shape = (z1 - z0, cfg.Y, cfg.X)
        v = (0.5 + torch.rand(shape, generator=g, dtype=cfg.dtype,
                              device="cuda") if coef else
             torch.randn(shape, generator=g, dtype=cfg.dtype, device="cuda"))
        a[z0:z1, PY:PY + cfg.Y] = v
    return dk.sync_pads(cfg, a, slab=True)


def slab_case(dk, dims, per, bc_kind, dtype, seed, gates, n_eps=0,
              equal_pow2=False):
    """make_case for one z-slab with the given gates: its fields from
    slab_field, its plane-valued faces random and finite everywhere (the
    halo planes' rows are read), their y pads on a periodic y axis the
    wrapped copies the solver keeps there."""
    cfg, _, planes = make_case(dk, dims, per, bc_kind, dtype, seed,
                               equal_pow2=equal_pow2, n_eps=n_eps)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def plane(nb):
        p = torch.randn(cfg.plane_shape(nb), generator=g, dtype=dtype,
                        device="cuda")
        ax = (1, 1, None, None, 0, 0)[nb]        # the y axis of the plane
        if ax is not None and cfg.periodic[1]:
            Y, w = cfg.Y, dk.PY
            idx = (torch.arange(-w, Y + w, device="cuda") % Y) + w
            p = p.index_select(ax, idx).contiguous()
        return p

    planes = [plane(nb) if cfg.b_const[nb] is None else p
              for nb, p in enumerate(planes)]
    return cfg, lambda coef=False: slab_field(dk, cfg, g, gates, coef), planes


def slab_variants(dk, cfg, field, planes, lam, gates):
    """(name, kernel call, plain call) for the z-slab variants on a slab:
    pairs (1 and 2), apply, residual and (constant coefficients) the
    prolongation's add mode; with both gates on a non-periodic z axis
    also the gated kernels against the ungated ones."""
    phi, rhs = field(), field()
    eps = tuple(field(coef=True) for _ in range(cfg.n_eps))
    isl = dk._ISL
    tag = f"[z_gates={int(gates[0])}{int(gates[1])}]"
    if cfg.n_eps:
        tag = f"[n_eps={cfg.n_eps}]" + tag
    out = []
    for k in (1, 2):
        out.append((f"pairs{k}" + tag,
                    lambda k=k: (dk.pair_sweep_dense(
                        cfg, phi, rhs, lam, planes, 0, n_pairs=k, eps=eps,
                        z_gates=gates)[isl],),
                    lambda k=k: (dk._pairs_plain(
                        cfg, phi, rhs, lam, planes, 0, k, eps, gates)[isl],)))
    for res in (False, True):
        out.append((("residual" if res else "apply") + tag,
                    lambda res=res: (dk.stencil_apply_dense(
                        cfg, phi, rhs, lam, planes, res, eps=eps,
                        z_gates=gates)[isl],),
                    lambda res=res: (dk._apply_plain(
                        cfg, phi, rhs, lam, planes, res, eps,
                        gates)[isl],)))
    if cfg.n_eps:
        return out
    X, Y, Z = cfg.dims
    phi_f = torch.randn(dk.padded_shape((2 * X, 2 * Y, 2 * Z)),
                        dtype=cfg.dtype, device="cuda")
    iold = field()
    out.append(("prolong_correct" + tag,
                lambda: (dk.prolong_correct_dense(
                    cfg, phi, iold, phi_f.clone(), planes,
                    z_gates=gates)[isl],),
                lambda: (dk._prolong_correct_plain(
                    cfg, phi, iold, phi_f.clone(), planes, "add",
                    gates)[isl],)))
    if gates == (True, True) and not cfg.periodic[2]:
        out += [
            ("pairs2[both gates on = ungated kernel]",
             lambda: (dk.pair_sweep_dense(cfg, phi, rhs, lam, planes, 0,
                                          n_pairs=2, z_gates=gates)[isl],),
             lambda: (dk.pair_sweep_dense(cfg, phi, rhs, lam, planes, 0,
                                          n_pairs=2)[isl],)),
            ("residual[both gates on = ungated kernel]",
             lambda: (dk.stencil_apply_dense(cfg, phi, rhs, lam, planes,
                                             True, z_gates=gates)[isl],),
             lambda: (dk.stencil_apply_dense(cfg, phi, rhs, lam, planes,
                                             True)[isl],)),
            ("prolong_correct[both gates on = ungated kernel]",
             lambda: (dk.prolong_correct_dense(
                 cfg, phi, iold, phi_f.clone(), planes, z_gates=gates)[isl],),
             lambda: (dk.prolong_correct_dense(
                 cfg, phi, iold, phi_f.clone(), planes)[isl],))]
    return out


def slab_checks(dk, df, quick):
    """The z-slab variants against their plain versions (and, both gates
    on, the ungated kernels): every gate pair, periodic and physical z,
    float32 and float64, n_eps 0/1/3, slabs of 4, 8 and 72 planes (the
    last two z chunks), pads of gated-off faces random, every other pad
    NaN; then the double-float residual's slab variant (float32, equal
    power-of-two spacing, constant faces).  Rows as phase_checks'."""
    shapes = [((16, 8, 4), True), ((64, 24, 8), False),
              ((64, 24, 8), True), ((48, 40, 72), False)]
    if quick:
        shapes = shapes[:2]
    rows, seed = [], 500
    for (dims, per_z), dtype, gates in itertools.product(
            shapes, (torch.float32, torch.float64),
            itertools.product((False, True), repeat=2)):
        per = (per_z,) * 3
        bc_kind = "planes" if dtype == torch.float64 else "neumann"
        lam = 0.3
        for n_eps in (0, 1, 3):
            seed += 1
            cfg, field, planes = slab_case(dk, dims, per, bc_kind, dtype,
                                           seed, gates, n_eps=n_eps)
            for name, kern, plain in slab_variants(dk, cfg, field, planes,
                                                   lam, gates):
                got, want = kern(), plain()
                torch.cuda.synchronize()
                u = max(ulp_diff(a, b) if ulp_diff(a, b) >= 0 else 1 << 62
                        for a, b in zip(got, want))
                rows.append({"kernel": name, "dims": dims, "periodic": per,
                             "dtype": str(dtype)[6:], "bc": bc_kind,
                             "lam": lam, "max_ulp": u})
    for (dims, per_z), bc_kind, gates in itertools.product(
            shapes, ("dirichlet", "neumann", "continuous"),
            itertools.product((False, True), repeat=2)):
        seed += 1
        cfg, field, _ = slab_case(dk, dims, (per_z,) * 3, bc_kind,
                                  torch.float32, seed, gates,
                                  equal_pow2=True)
        xhi, rhi = field(), field()
        xlo, rlo = field() * 2.0 ** -25, field() * 2.0 ** -25
        kw = dict(cbs=df._cb_pairs(cfg), lam_pair=df.split_lam(0.37),
                  z_gates=gates)
        got = df.residual_df32_dense(cfg, xhi, xlo, rhi, rlo, **kw)
        want = df.residual_df32(cfg, xhi, xlo, rhi, rlo, **kw)
        torch.cuda.synchronize()
        u = ulp_diff(got[dk._ISL], want[dk._ISL])
        rows.append({"kernel": f"residual_df32[z_gates={int(gates[0])}"
                               f"{int(gates[1])}]", "dims": dims,
                     "periodic": (per_z,) * 3, "dtype": "float32",
                     "bc": bc_kind, "lam": 0.37,
                     "max_ulp": u if u >= 0 else 1 << 62})
    return rows


def phase_checks(dk, df, quick):
    rows, worst = [], 0
    shapes = [((256, 128, 128), (False, False, False)),
              ((16, 8, 8), (True, True, True)),
              ((64, 8, 16), (False, True, False)),
              ((8, 8, 8), (True, False, True)),
              ((48, 40, 72), (True, True, True)),   # ragged tiles, 2 z chunks
              ((7, 5, 3), (False, True, False))]    # odd (coarsest-level) extents
    if quick:
        shapes = [((64, 32, 32), (False, False, False))] + shapes[1:]
    seed = 0
    for dims, per in shapes:
        for dtype in (torch.float32, torch.float64):
            for bc_kind in ("dirichlet", "neumann", "continuous", "planes"):
                lam = 0.3 if bc_kind in ("neumann", "planes") else 0.0
                seed += 1
                cfg, field, planes = make_case(dk, dims, per, bc_kind, dtype,
                                               seed)
                cases = variants(dk, cfg, field, planes, lam)
                for n_eps in (1, 3):
                    # the same level with coefficient fields; lam 0 is
                    # the vlaplacian case (den starts at 0)
                    seed += 1
                    ce, fe, pe = make_case(dk, dims, per, bc_kind, dtype,
                                           seed, n_eps=n_eps)
                    cases += eps_variants(dk, ce, fe, pe, lam,
                                          eps_fields(dk, ce, seed))
                if bc_kind == "planes":
                    # the forest's own configurations: identity-coefficient
                    # plane faces, and segment synthesis
                    seed += 1
                    cf, ff, pf = make_case(dk, dims, per, "forest", dtype,
                                           seed)
                    X, Y, Z = dims
                    cf_f = dk.DenseStencilConfig(
                        (2 * X, 2 * Y, 2 * Z), cf.idr2, cf.bc, cf.periodic,
                        dtype, b_const=cf.b_const)
                    cases += forest_variants(dk, cf, ff(cf), ff(cf), pf,
                                             lam, ff(cf_f))
                    if all(v % 2 == 0 for v in dims):
                        cases += seg_variants(dk, dims, dtype, seed, lam)
                for name, kern, plain in cases:
                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    u = max(ulp_diff(a, b) if ulp_diff(a, b) >= 0 else 1 << 62
                            for a, b in zip(got, want))
                    worst = max(worst, u)
                    rows.append({"kernel": name, "dims": dims,
                                 "periodic": per, "dtype": str(dtype)[6:],
                                 "bc": bc_kind, "lam": lam, "max_ulp": u})
    # the double-float residual: float32, constant faces, equal spacing
    for dims, per in shapes:
        for bc_kind in ("dirichlet", "neumann", "continuous"):
            seed += 1
            cfg, field, _ = make_case(dk, dims, per, bc_kind, torch.float32,
                                      seed, equal_pow2=True)
            if not df.df32_ok(cfg):
                fail(f"df32 case {dims} {bc_kind} is outside df32_ok")
            xhi, rhi = field(cfg), field(cfg)
            xlo, rlo = field(cfg) * 2.0 ** -25, field(cfg) * 2.0 ** -25
            override = [0.5, -0.25, 0.1, 0.3, 0.0, 1.0]
            for lam, bvals in ((0.0, None), (0.37, None), (0.0, override)):
                kw = dict(cbs=df._cb_pairs(cfg, bvals),
                          lam_pair=df.split_lam(lam))
                got = df.residual_df32_dense(cfg, xhi, xlo, rhi, rlo, **kw)
                want = df.residual_df32(cfg, xhi, xlo, rhi, rlo, **kw)
                torch.cuda.synchronize()
                u = ulp_diff(got[dk._ISL], want[dk._ISL])
                u = u if u >= 0 else 1 << 62
                worst = max(worst, u)
                rows.append({"kernel": "residual_df32", "dims": dims,
                             "periodic": per, "dtype": "float32",
                             "bc": bc_kind, "lam": lam,
                             "bc_values_override": bvals is not None,
                             "max_ulp": u})
    flat = flat_cases()
    worst = max([worst] + [r["max_ulp"] for r in flat])
    rows += flat
    slab = slab_checks(dk, df, quick)
    worst = max([worst] + [r["max_ulp"] for r in slab])
    rows += slab
    big = wide_checks(dk, WIDE_DOWN_SHAPES, (torch.float32,), ("downsweep",))
    if not all(r["wide"] for r in big):
        fail("the float32 down-leg did not take the wide design on "
             f"{[r['dims'] for r in big if not r['wide']][:1]}")
    wide = wide_checks(dk) + big
    worst = max([worst] + [r["max_ulp"] for r in wide])
    rows += wide
    # float32: every kind on the edge levels and on 520x520x264 with x
    # and z periodic, the double pair and the down-leg on the other two
    # large levels, the apply and the residual on the odd one; float64:
    # the apply's three kinds on the same levels as in float32
    apply_shapes = WIDE_EDGE_SHAPES + WIDE_DOWN_SHAPES[2:]
    faces = (face_checks(dk) + face_checks(dk, WIDE_DOWN_SHAPES[2:]) +
             face_checks(dk, WIDE_DOWN_SHAPES[:2], FACE_KINDS[:2]) +
             face_checks(dk, [ODD_APPLY_SHAPE], FACE_KINDS[2:]) +
             face_checks(dk, apply_shapes + [ODD_APPLY_SHAPE],
                         FACE_KINDS[2:], torch.float64))
    if not all(r["faces"] for r in faces):
        fail("a coefficient kernel did not run its face-plane design: "
             f"{[r for r in faces if not r['faces']][:1]}")
    worst = max([worst] + [r["max_ulp"] for r in faces])
    rows += faces
    rr = rr_checks(dk)
    if not all(r["faces"] for r in rr):
        fail("a residual-restriction did not run the face-plane apply: "
             f"{[r for r in rr if not r['faces']][:1]}")
    swide = slab_wide_checks(dk)
    if not all(r["wide"] for r in swide):
        fail("a slab double pair did not run the wide design: "
             f"{[r for r in swide if not r['wide']][:1]}")
    worst = max([worst] + [r["max_ulp"] for r in rr + swide])
    rows += rr + swide
    sgw = seg_wide_checks(dk, old_seg_library(dk))
    if not all(r["new_design"] for r in sgw):
        fail("a segment launch did not run its new design: "
             f"{[r for r in sgw if not r['new_design']][:1]}")
    worst = max([worst] + [r["max_ulp"] for r in sgw])
    rows += sgw
    sap = slab_apply_checks(dk, old_slab_library(dk))
    if not all(r["new_design"] == r["want_new"] for r in sap):
        fail("a slab apply, residual or prolongation ran another design "
             "than its rule gives: "
             f"{[r for r in sap if r['new_design'] != r['want_new']][:1]}")
    worst = max([worst] + [r["max_ulp"] for r in sap])
    rows += sap
    sep = slab_eps_checks(dk, old_slab_library(dk, "-DOMG_SLABEPS=0"))
    if not all(r["new_design"] == r["want_new"] for r in sep):
        fail("a coefficient slab launch ran another design than its rule "
             "gives: "
             f"{[r for r in sep if r['new_design'] != r['want_new']][:1]}")
    worst = max([worst] + [r["max_ulp"] for r in sep])
    rows += sep
    half = half_checks(dk, old_library(dk, "-DOMG_HALFAF=0", (
        ("stencil_sweep", "omg_stencil_sweep"),))["omg_stencil_sweep"])
    if not all(r["new_design"] for r in half):
        fail("a half-sweep did not run the register march: "
             f"{[r for r in half if not r['new_design']][:1]}")
    worst = max([worst] + [r["max_ulp"] for r in half])
    rows += half
    dfm = df32_march_checks(dk, df, old_df32_library(dk))
    if not all(r["new_design"] == r["want_new"] for r in dfm):
        fail("a double-float residual ran another design than its rule "
             "gives: "
             f"{[r for r in dfm if r['new_design'] != r['want_new']][:1]}")
    if not all(r["within_float64_bound"] for r in dfm):
        fail("a double-float residual is off the float64 one: "
             f"{[r for r in dfm if not r['within_float64_bound']][:1]}")
    worst = max([worst] + [r["max_ulp"] for r in dfm])
    rows += dfm
    bad = [r for r in rows if r["max_ulp"] != 0]
    n_eps_cases = sum("n_eps" in r["kernel"] and "gates" not in r["kernel"]
                      and "faces" not in r["kernel"] for r in rows)
    forest = [r for r in rows if "segs" in r["kernel"]
              or r["kernel"] in ("half_sweep0", "half_sweep1")
              or "[" in r["kernel"] and "prolong" in r["kernel"]
              and "gates" not in r["kernel"]]
    emit({"checks": {"cases": len(rows), "eps_cases": n_eps_cases,
                     "forest_cases": len(forest),
                     "forest_max_ulp": max(r["max_ulp"] for r in forest),
                     "flat_cases": len(flat),
                     "flat_max_ulp": max(r["max_ulp"] for r in flat),
                     "slab_cases": len(slab),
                     "slab_max_ulp": max(r["max_ulp"] for r in slab),
                     "wide_cases": len(wide),
                     "wide_cases_on_the_wide_design": sum(
                         r["wide"] for r in wide),
                     "wide_max_ulp": max(r["max_ulp"] for r in wide),
                     "face_cases": len(faces),
                     "face_cases_on_the_face_design": sum(
                         r["faces"] for r in faces),
                     "face_max_ulp": max(r["max_ulp"] for r in faces),
                     "rr_faces_cases": len(rr),
                     "rr_faces_max_ulp": max(r["max_ulp"] for r in rr),
                     "slab_wide_cases": len(swide),
                     "slab_wide_max_ulp": max(r["max_ulp"] for r in swide),
                     "seg_wide_cases": len(sgw),
                     "seg_wide_max_ulp": max(r["max_ulp"] for r in sgw),
                     "slab_apply_cases": len(sap),
                     "slab_apply_cases_on_the_new_designs": sum(
                         r["new_design"] for r in sap),
                     "slab_apply_max_ulp": max(r["max_ulp"] for r in sap),
                     "slab_eps_cases": len(sep),
                     "slab_eps_cases_on_the_face_designs": sum(
                         r["new_design"] for r in sep),
                     "slab_eps_max_ulp": max(r["max_ulp"] for r in sep),
                     "half_cases": len(half),
                     "half_cases_on_the_new_design": sum(
                         r["new_design"] for r in half),
                     "half_max_ulp": max(r["max_ulp"] for r in half),
                     "df32_march_cases": len(dfm),
                     "df32_march_cases_on_the_new_design": sum(
                         r["new_design"] for r in dfm),
                     "df32_march_max_ulp": max(r["max_ulp"] for r in dfm),
                     "df32_march_worst_float64_err_over_bound": max(
                         r["float64_max_abs_err"] / r["float64_bound"]
                         for r in dfm),
                     "max_ulp": worst, "expected_max_ulp": 0,
                     "nan_pads": True, "failed": bad[:20]}})
    if bad:
        fail(f"{len(bad)} kernel cases differ from their plain version")


#: levels on the edges of the wide design of the double pair and the
#: down-leg (csrc/stream_wide.cuh; big tile 64x32 float32, 64x16 float64,
#: where it gives two blocks per SM on the 132 SMs of an H100; smaller
#: levels run stream_kernel.cuh): (dims, periodic)
WIDE_EDGE_SHAPES = [
    # big tile; X and Y not multiples of it; coarse extents odd, so the
    # down-leg's coarse tiles are ragged too
    ((212, 74, 170), (False, False, False)),
    # big tile; a double pair on even periodic extents
    ((136, 72, 256), (True, True, True)),
    # big tile; Y smaller than the tile, periodic
    ((520, 14, 304), (False, True, False)),
    # extents smaller than the halo: wrapped, and on faces
    ((6, 4, 8), (True, True, True)),
    ((4, 6, 2), (False, False, False)),
    # the 16^3 and 8^3 levels
    ((16, 16, 16), (False, False, False)),
    ((8, 8, 8), (False, False, False)),
]
#: a level on which the float32 down-leg takes the wide design (four
#: blocks per SM with 64-plane chunks on an H100): X, Y and the coarse
#: tiles ragged; on faces, fully periodic (every window wraps) and mixed
WIDE_DOWN_SHAPES = [((520, 520, 264), (False, False, False)),
                    ((520, 520, 264), (True, True, True)),
                    ((520, 520, 264), (True, False, True))]
#: the entry points whose constant-coefficient kernels are the wide design
#: on large levels, and the counters of those launches (the main path's
#: 512^3 level runs both)
WIDE_KERNELS = ("pair_sweep_dense", "downsweep_dense")
WIDE_COUNTERS = tuple(k + "[wide]" for k in WIDE_KERNELS)


def wide_checks(dk, shapes=WIDE_EDGE_SHAPES,
                dtypes=(torch.float32, torch.float64),
                kernels=("pairs", "downsweep")):
    """The double pair and the down-leg (n_pairs 1 and 2; ``kernels``)
    against their plain versions on ``shapes``: each dtype, the four BC
    kinds, NaN pads."""
    rows, seed = [], 500
    for dims, per in shapes:
        for dtype in dtypes:
            for bc_kind in ("dirichlet", "neumann", "continuous", "planes"):
                lam = 0.3 if bc_kind in ("neumann", "planes") else 0.0
                seed += 1
                cfg, field, planes = make_case(dk, dims, per, bc_kind, dtype,
                                               seed)
                phi, rhs = field(cfg), field(cfg)
                cases = []
                for k in (1, 2) if cfg.periodic_even else (1,):
                    if "pairs" in kernels:
                        cases.append((
                            f"pairs{k}[wide]",
                            lambda k=k: (dk.pair_sweep_dense(
                                cfg, phi, rhs, lam, planes, 0, n_pairs=k),),
                            lambda k=k: (dk._pairs_plain(
                                cfg, phi, rhs, lam, planes, 0, k),)))
                    if cfg.even_dims and "downsweep" in kernels:
                        cases.append((
                            f"downsweep{k}[wide]",
                            lambda k=k: dk.downsweep_dense(
                                cfg, phi, rhs, lam, planes, 0, n_pairs=k),
                            lambda k=k: dk._down_plain(
                                cfg, phi, rhs, lam, planes, 0, k)))
                for name, kern, plain in cases:
                    before = dk.launch_counts()
                    got = kern()
                    after = dk.launch_counts()
                    want = plain()
                    torch.cuda.synchronize()
                    us = [ulp_diff(a[dk._ISL], b[dk._ISL])
                          for a, b in zip(got, want)]
                    u = max(us) if min(us) >= 0 else 1 << 62
                    wide = any(after[k] > before[k] for k in after
                               if k.endswith("[wide]"))
                    rows.append({"kernel": name, "dims": dims,
                                 "periodic": per, "dtype": str(dtype)[6:],
                                 "bc": bc_kind, "lam": lam, "max_ulp": u,
                                 "wide": wide})
                del phi, rhs, cases
    torch.cuda.empty_cache()
    return rows


#: the face-plane design of each entry point's coefficient launches
#: (the double pair's and the down-leg's in float32 only)
FACE_DESIGNS = {
    "pair_sweep_dense": "octree_mg_tpu_torch/csrc/stream_faces.cuh",
    "downsweep_dense": "octree_mg_tpu_torch/csrc/stream_faces.cuh",
    "stencil_apply_dense": "octree_mg_tpu_torch/csrc/apply_faces.cuh",
    "residual_restrict_dense": "octree_mg_tpu_torch/csrc/apply_faces.cuh"}
#: the kernels of face_checks: the double pair and the down-leg
#: (csrc/stream_faces.cuh), the apply, the residual and the
#: residual-restriction (csrc/apply_faces.cuh)
FACE_KINDS = ("pairs", "downsweep", "apply", "residual", "residual_restrict")
#: a small level with odd extents, y periodic, for the apply and the
#: residual (they need no even extents; the others do, or take one pair)
ODD_APPLY_SHAPE = ((13, 7, 5), (False, True, False))


def face_checks(dk, shapes=WIDE_EDGE_SHAPES, kinds=FACE_KINDS,
                dtype=torch.float32):
    """The coefficient kernels of ``kinds`` (n_eps 1 and 3; the
    face-plane designs: the double pair and the down-leg, n_pairs 1 and
    2, in csrc/stream_faces.cuh, which takes every float32 launch, the
    apply, the residual and residual_restrict_dense in
    csrc/apply_faces.cuh, which takes every launch) against their plain
    versions on ``shapes`` in ``dtype``: the four BC kinds with smooth
    coefficients 0.5 + U[0,1), Dirichlet faces also with rough ones
    10**(3 U[0,1)), NaN pads.  A case must be 0 ulp and counted under
    its ``[faces]`` counter."""
    rows, seed = [], 700
    for dims, per in shapes:
        for n_eps in (1, 3):
            for bc_kind, rough in (("dirichlet", False), ("neumann", False),
                                   ("continuous", False), ("planes", False),
                                   ("dirichlet", True)):
                lam = 0.3 if bc_kind in ("neumann", "planes") else 0.0
                seed += 1
                cfg, field, planes = make_case(dk, dims, per, bc_kind,
                                               dtype, seed, n_eps=n_eps)
                eps = eps_fields(dk, cfg, seed, rough)
                phi, rhs = field(cfg), field(cfg)
                cases = []
                for k in (1, 2) if cfg.periodic_even else (1,):
                    if "pairs" in kinds:
                        cases.append((
                            f"pairs{k}[n_eps={n_eps}][faces]",
                            "pair_sweep_dense",
                            lambda k=k: (dk.pair_sweep_dense(
                                cfg, phi, rhs, lam, planes, 0, n_pairs=k,
                                eps=eps),),
                            lambda k=k: (dk._pairs_plain(
                                cfg, phi, rhs, lam, planes, 0, k, eps),)))
                    if cfg.even_dims and "downsweep" in kinds:
                        cases.append((
                            f"downsweep{k}[n_eps={n_eps}][faces]",
                            "downsweep_dense",
                            lambda k=k: dk.downsweep_dense(
                                cfg, phi, rhs, lam, planes, 0, n_pairs=k,
                                eps=eps),
                            lambda k=k: dk._down_plain(
                                cfg, phi, rhs, lam, planes, 0, k, eps)))
                for res in (False, True):
                    kind = "residual" if res else "apply"
                    if kind in kinds:
                        cases.append((
                            f"{kind}[n_eps={n_eps}][faces]",
                            "stencil_apply_dense",
                            lambda res=res: (dk.stencil_apply_dense(
                                cfg, phi, rhs, lam, planes, res, eps=eps),),
                            lambda res=res: (dk._apply_plain(
                                cfg, phi, rhs, lam, planes, res, eps),)))
                if cfg.even_dims and "residual_restrict" in kinds:
                    cases.append((
                        f"residual_restrict[n_eps={n_eps}][faces]",
                        "residual_restrict_dense",
                        lambda: dk.residual_restrict_dense(
                            cfg, phi, rhs, lam, planes, eps=eps),
                        lambda: dk._down_plain(
                            cfg, phi, rhs, lam, planes, 0, 0, eps)[1:]))
                for name, entry, kern, plain in cases:
                    counter = dk.faces_name(entry, n_eps)
                    before = dk.launch_counts()[counter]
                    got = kern()
                    faces = dk.launch_counts()[counter] == before + 1
                    want = plain()
                    torch.cuda.synchronize()
                    us = [ulp_diff(a[dk._ISL], b[dk._ISL])
                          for a, b in zip(got, want)]
                    u = max(us) if min(us) >= 0 else 1 << 62
                    rows.append({"kernel": name, "dims": dims,
                                 "periodic": per, "dtype": str(dtype)[6:],
                                 "bc": bc_kind, "rough_eps": rough,
                                 "lam": lam, "max_ulp": u, "faces": faces})
                del phi, rhs, eps, cases
    torch.cuda.empty_cache()
    return rows


#: the counter of a constant-coefficient residual-restriction on the
#: face-plane apply (csrc/apply_faces.cuh with no coefficients)
RR_FACES = "residual_restrict_dense[faces]"


def rr_checks(dk, shapes=WIDE_EDGE_SHAPES + WIDE_DOWN_SHAPES,
              dtypes=(torch.float32, torch.float64)):
    """The constant-coefficient residual-restriction (csrc/apply_faces.cuh,
    which takes every launch) against its plain version on ``shapes``:
    each dtype, the four BC kinds, NaN pads.  A case must be 0 ulp and
    counted under RR_FACES."""
    rows, seed = [], 900
    for dims, per in shapes:
        for dtype in dtypes:
            for bc_kind in ("dirichlet", "neumann", "continuous", "planes"):
                lam = 0.3 if bc_kind in ("neumann", "planes") else 0.0
                seed += 1
                cfg, field, planes = make_case(dk, dims, per, bc_kind, dtype,
                                               seed)
                phi, rhs = field(cfg), field(cfg)
                before = dk.launch_counts()[RR_FACES]
                got = dk.residual_restrict_dense(cfg, phi, rhs, lam, planes)
                faces = dk.launch_counts()[RR_FACES] == before + 1
                want = dk._down_plain(cfg, phi, rhs, lam, planes, 0, 0)[1:]
                torch.cuda.synchronize()
                us = [ulp_diff(a[dk._ISL], b[dk._ISL])
                      for a, b in zip(got, want)]
                rows.append({"kernel": "residual_restrict[faces]",
                             "dims": dims, "periodic": per,
                             "dtype": str(dtype)[6:], "bc": bc_kind,
                             "lam": lam,
                             "max_ulp": max(us) if min(us) >= 0 else 1 << 62,
                             "faces": faces})
                del phi, rhs, got, want
    torch.cuda.empty_cache()
    return rows


#: float32 slabs that the slab double pair's wide design takes
#: (csrc/stream_wide.cuh with SLAB = 1): the slabs of the sharded 512^3
#: and 256^3 levels over 8 (512^2 x 64 in 16-plane chunks, 256^2 x 32 in
#: 8-plane ones), a ragged 520^2 x 64 one, the thinnest the rule takes
#: (8 planes: one chunk holds both z faces) and 512^2 x 12 (an 8-plane
#: chunk and a 4-plane one); (dims, (x, y) periodic), z physical and
#: periodic
SLAB_WIDE_SHAPES = [((520, 520, 64), (False, False)),
                    ((512, 512, 64), (True, True)),
                    ((520, 520, 64), (True, False)),
                    ((256, 256, 32), (False, False)),
                    ((512, 512, 8), (False, True)),
                    ((512, 512, 12), (True, True))]
SLAB_WIDE = "pair_sweep_dense[z_gates][wide]"


def slab_wide_checks(dk, shapes=SLAB_WIDE_SHAPES):
    """The float32 slab double pair (n_pairs 1 and 2) on slabs its wide
    design takes, against its plain version: every gate pair, physical
    and periodic z, the four BC kinds, the pads of gated-off faces random
    and every other pad NaN; with both gates on a physical z axis also
    against the ungated kernel.  A case must be 0 ulp and counted under
    SLAB_WIDE (``wide``)."""
    rows, seed, dtype = [], 1100, torch.float32
    for (dims, pxy), per_z, gates in itertools.product(
            shapes, (False, True),
            itertools.product((False, True), repeat=2)):
        per = tuple(pxy) + (per_z,)
        for bc_kind in ("dirichlet", "neumann", "continuous", "planes"):
            lam = 0.3 if bc_kind in ("neumann", "planes") else 0.0
            seed += 1
            cfg, field, planes = slab_case(dk, dims, per, bc_kind, dtype,
                                           seed, gates)
            phi, rhs = field(), field()
            tag = f"[z_gates={int(gates[0])}{int(gates[1])}]"
            cases = [(f"pairs{k}" + tag,
                      lambda k=k: dk.pair_sweep_dense(
                          cfg, phi, rhs, lam, planes, 0, n_pairs=k,
                          z_gates=gates),
                      lambda k=k: dk._pairs_plain(
                          cfg, phi, rhs, lam, planes, 0, k, (), gates))
                     for k in (1, 2)]
            if gates == (True, True) and not per_z:
                cases.append((
                    "pairs2[both gates on = ungated kernel]",
                    lambda: dk.pair_sweep_dense(cfg, phi, rhs, lam, planes,
                                                0, n_pairs=2, z_gates=gates),
                    lambda: dk.pair_sweep_dense(cfg, phi, rhs, lam, planes,
                                                0, n_pairs=2)))
            for name, kern, plain in cases:
                before = dk.launch_counts()[SLAB_WIDE]
                got = kern()
                wide = dk.launch_counts()[SLAB_WIDE] == before + 1
                want = plain()
                torch.cuda.synchronize()
                u = ulp_diff(got[dk._ISL], want[dk._ISL])
                rows.append({"kernel": name, "dims": dims, "periodic": per,
                             "dtype": str(dtype)[6:], "bc": bc_kind,
                             "lam": lam, "max_ulp": u if u >= 0 else 1 << 62,
                             "wide": wide})
                del got, want
            del phi, rhs
    torch.cuda.empty_cache()
    return rows


#: the slab launches of rows 5z and 7z (PERF.md): the apply and the
#: residual on a slab, the prolongation (add) with the slab as the coarse
#: one
SLAB_KINDS = ("apply", "residual", "prolong")
#: slabs of the slab apply, residual and prolongation checks: those the
#: face-plane apply (csrc/apply_faces.cuh with SLAB = 1) takes by its rule
#: (slab_faces_takes), the slabs of the sharded 512^3 and 256^3 levels
#: over 8 (float32, the slab solver's) and the thinnest the rule takes
#: (2^20 cells in 4 planes of 512^2, and in 2 planes with ragged tiles),
#: and some it leaves to stream_kernel.cuh: the sharded 128^3 level's
#: slab, 32^2 x 4 in float64 (cpu_agreement.sharded's) and 2 planes just
#: below 2^20 cells; the pair prolongation of csrc/prolong_correct.cu
#: takes every slab; (dims, (x, y) periodic, dtype, kinds).  The apply
#: and the residual run on the slab, the prolongation with the slab as
#: the coarse one (the 512^3 level is never a coarse slab).
SLAB_APPLY_SHAPES = [
    ((512, 512, 64), (False, False), torch.float32, SLAB_KINDS[:2]),
    ((256, 256, 32), (True, True), torch.float32, SLAB_KINDS),
    ((512, 512, 4), (False, True), torch.float32, SLAB_KINDS),
    ((1032, 520, 2), (False, False), torch.float32, SLAB_KINDS),
    ((128, 128, 16), (False, True), torch.float32, SLAB_KINDS),
    ((32, 32, 4), (True, True), torch.float64, SLAB_KINDS),
    ((1024, 510, 2), (True, False), torch.float32, SLAB_KINDS)]


def slab_faces_takes(dims, dtype):
    """Whether the face-plane apply takes a slab apply or residual:
    af_slab_takes of csrc/apply_faces.cuh, float32 slabs of 2^20 cells
    or more in two planes or more (the pair prolongation takes every
    slab)."""
    X, Y, Z = dims
    return dtype == torch.float32 and Z >= 2 and X * Y * Z >= 1 << 20


#: the counters of the slab launches on the new designs
SLAB_FACES = "stencil_apply_dense[z_gates][faces]"
SLAB_PAIR = "prolong_correct_dense[z_gates][pair]"


#: the designs before this tree's, each behind a build flag, and the
#: sources that flag rebuilds: the checks hold every new design against
#: its old one (main() builds them all beside the shipped libraries)
OLD_DESIGNS = {"-DOMG_SEGWIDE=0": ("seg_sweep",),
               "-DOMG_SLABAP=0": ("stencil_sweep", "prolong_correct"),
               "-DOMG_SLABEPS=0": ("stencil_sweep", "prolong_correct"),
               "-DOMG_HALFAF=0": ("stencil_sweep",),
               "-DOMG_DF32MARCH=0": ("residual_df32",)}


def old_library(dk, flag, syms):
    """{symbol: function} of the (source, symbol) pairs syms from the
    sources built with a design flag (OLD_DESIGNS)."""
    import ctypes
    from octree_mg_tpu_torch.ops import _cuda_build
    paths = _cuda_build.build_kernels(
        (flag,), sources=tuple(dict.fromkeys(src for src, _ in syms)))
    fns = {}
    for src, sym in syms:
        f = getattr(ctypes.CDLL(paths[src]), sym)
        f.argtypes, f.restype = dk._ARGTYPES[sym], ctypes.c_int
        fns[sym] = f
    return fns


def old_slab_library(dk, flag="-DOMG_SLABAP=0"):
    """omg_stencil_slab and omg_prolong_slab of csrc/stencil_sweep.cu and
    csrc/prolong_correct.cu built with a design flag, to hold the new
    designs against the ones before: -DOMG_SLABAP=0, the constant-
    coefficient slab apply and residual on csrc/stream_kernel.cuh and
    the slab prolongation on its thread-per-coarse-cell kernel;
    -DOMG_SLABEPS=0, every float32 coefficient slab double pair, apply
    and residual on csrc/stream_kernel.cuh."""
    return old_library(dk, flag, (("stencil_sweep", "omg_stencil_slab"),
                                  ("prolong_correct", "omg_prolong_slab")))


def slab_runner(dk, fn, kind, cfg, phi, rhs, lam, planes, gates, iold=None,
                out=None, eps=(), n_pairs=2):
    """A closure that launches one slab kernel of a library (fn: its
    omg_stencil_slab, or omg_prolong_slab for ``prolong``) on fixed
    arguments as the wrappers make them, into out (the double pair of
    ``pairs``, the apply and the residual, with the coefficient fields
    eps) or out = phi_f in place (the prolongation), and returns the
    design the library reports; not counted (a comparison, not the path).
    """
    import ctypes
    Zs = dk._slab_params(gates)
    design = ctypes.c_int(-1)
    st = dk.cuda_stream(phi)
    P = dk._params(cfg, 0.0 if kind == "prolong" else lam, planes, 0,
                   2 * n_pairs if kind == "pairs" else 0)
    E = dk._eps_params(cfg, eps) if eps else None
    if kind == "prolong":
        args = (dk._dt(cfg), ctypes.byref(P), ctypes.byref(Zs),
                phi.data_ptr(), iold.data_ptr(), out.data_ptr(), st,
                ctypes.byref(design))
    else:
        args = (dk._dt(cfg), ("pairs", "apply", "residual").index(kind),
                ctypes.byref(P), ctypes.byref(E) if eps else None,
                ctypes.byref(Zs), phi.data_ptr(), rhs.data_ptr(),
                out.data_ptr(), st, ctypes.byref(design))

    def run():
        err = fn(*args)
        if err != 0:
            fail(f"slab {kind}: launch error {err}")
        return design.value
    return run


def old_slab_launch(dk, fns, kind, cfg, phi, rhs, lam, planes, gates,
                    iold=None, phi_f=None):
    """One launch of the old design (old_slab_library) into a new field
    (the apply, the residual) or phi_f (the prolongation, in place)."""
    out = phi_f if kind == "prolong" else torch.empty_like(phi)
    fn = fns["omg_prolong_slab" if kind == "prolong" else "omg_stencil_slab"]
    design = slab_runner(dk, fn, kind, cfg, phi, rhs, lam, planes, gates,
                         iold, out)()
    if design != 0:
        fail(f"the old slab {kind} design reported design {design}")
    return out


def slab_apply_checks(dk, old_fns, shapes=SLAB_APPLY_SHAPES):
    """The slab apply, residual and prolongation (add) on SLAB_APPLY_SHAPES:
    every gate pair, physical and periodic z, the four BC kinds, the pads
    of gated-off faces random and every other pad NaN: 0 ulp against the
    plain version and against the old design (old_slab_library), and
    counted under SLAB_FACES / SLAB_PAIR (``new_design``) exactly where
    the rules take the slab (``want_new``: slab_faces_takes for the apply
    and the residual, every prolongation)."""
    rows, seed, isl = [], 1500, dk._ISL
    for (dims, pxy, dtype, kinds), per_z, gates in itertools.product(
            shapes, (False, True),
            itertools.product((False, True), repeat=2)):
        per = tuple(pxy) + (per_z,)
        for bc_kind in ("dirichlet", "neumann", "continuous", "planes"):
            lam = 0.3 if bc_kind in ("neumann", "planes") else 0.0
            seed += 1
            cfg, field, planes = slab_case(dk, dims, per, bc_kind, dtype,
                                           seed, gates)
            phi, rhs = field(), field()
            tag = f"[z_gates={int(gates[0])}{int(gates[1])}]"
            for kind in kinds:
                counter = SLAB_PAIR if kind == "prolong" else SLAB_FACES
                before = dk.launch_counts()[counter]
                if kind == "prolong":
                    X, Y, Z = dims
                    iold = field()
                    phi_f = torch.randn(
                        dk.padded_shape((2 * X, 2 * Y, 2 * Z)), dtype=dtype,
                        device="cuda")
                    got = dk.prolong_correct_dense(cfg, phi, iold,
                                                   phi_f.clone(), planes,
                                                   z_gates=gates)
                    new = dk.launch_counts()[counter] == before + 1
                    want = dk._prolong_correct_plain(
                        cfg, phi, iold, phi_f.clone(), planes, "add", gates)
                    old = old_slab_launch(dk, old_fns, kind, cfg, phi, None,
                                          0.0, planes, gates, iold,
                                          phi_f.clone())
                    del iold, phi_f
                else:
                    res = kind == "residual"
                    got = dk.stencil_apply_dense(cfg, phi, rhs, lam, planes,
                                                 res, z_gates=gates)
                    new = dk.launch_counts()[counter] == before + 1
                    want = dk._apply_plain(cfg, phi, rhs, lam, planes, res,
                                           (), gates)
                    old = old_slab_launch(dk, old_fns, kind, cfg, phi, rhs,
                                          lam, planes, gates)
                torch.cuda.synchronize()
                up = ulp_diff(got[isl], want[isl])
                uo = ulp_diff(got[isl], old[isl])
                u = max(up, uo) if min(up, uo) >= 0 else 1 << 62
                rows.append({"kernel": f"{kind}{tag}[z_gates][new design]",
                             "dims": dims, "periodic": per,
                             "dtype": str(dtype)[6:], "bc": bc_kind,
                             "lam": lam, "max_ulp": u,
                             "max_ulp_vs_plain": up,
                             "max_ulp_vs_old_design": uo, "new_design": new,
                             "want_new": kind == "prolong"
                             or slab_faces_takes(dims, dtype)})
                del got, want, old
            del phi, rhs
    torch.cuda.empty_cache()
    return rows


#: the coefficient slab launches of rows 1ze and 5ze (PERF.md): the double
#: pair (one and two pairs), the apply and the residual on a slab
SLAB_EPS_KINDS = ("pairs1", "pairs2", "apply", "residual")
#: slabs of the coefficient slab checks, n_eps 1 and 3, float32: the rules
#: send every float32 coefficient slab double pair to csrc/stream_faces.cuh
#: and the apply and residual on slabs of 2^15 cells and more to
#: csrc/apply_faces.cuh (SLAB = 1; slab_eps_apply_takes): the slabs of
#: sharded_vcoeff's 512^3 .. 32^3 levels over 8 (the 64^2 x 8 one the
#: smallest the apply's rule takes, the 32^2 x 4 one left to
#: stream_kernel.cuh), 64 x 62 x 8 just below the rule, the 4-plane edge
#: strip of a 512^3 slab's overlapped double pair group, the 2-plane one
#: of a single pair (the thinnest slab the solver launches), ragged tiles
#: (8 of the pair's 32 x 24 tile and 4 of the apply's 64 x 16 one, three
#: z chunks of the apply) and an odd level (unaligned rows); (dims, (x, y)
#: periodic)
SLAB_EPS_SHAPES = [((512, 512, 64), (False, False)),
                   ((256, 256, 32), (True, True)),
                   ((128, 128, 16), (False, True)),
                   ((64, 64, 8), (True, False)),
                   ((32, 32, 4), (False, False)),
                   ((64, 62, 8), (False, True)),
                   ((512, 512, 4), (False, False)),
                   ((256, 256, 2), (True, True)),
                   ((520, 260, 6), (False, True)),
                   ((13, 7, 4), (False, False))]


def slab_eps_apply_takes(dims):
    """Whether the face-plane apply takes a float32 coefficient slab apply
    or residual: af_eps_slab_takes of csrc/apply_faces.cuh, slabs of 2^15
    cells or more (the face-plane double pair takes every slab)."""
    X, Y, Z = dims
    return X * Y * Z >= 1 << 15


def slab_eps_counter(dk, kind, n_eps):
    """The counter of a coefficient slab launch on its face-plane design."""
    base = "pair_sweep_dense" if kind.startswith("pairs") \
        else "stencil_apply_dense"
    return dk.slab_name(base, n_eps) + "[faces]"


def slab_eps_checks(dk, old_fns, shapes=SLAB_EPS_SHAPES):
    """The float32 coefficient slab double pair (1 and 2 pairs), apply and
    residual, n_eps 1 and 3, on SLAB_EPS_SHAPES: every gate pair, physical
    and periodic z, the four BC kinds, coefficients 0.5 + U[0,1), the pads
    of gated-off faces random (the coefficients' too) and every other pad
    NaN: 0 ulp against the plain version and against the old design
    (old_slab_library with -DOMG_SLABEPS=0), and counted under the
    face-plane counter (slab_eps_counter, ``new_design``) exactly where
    the rules take the slab (``want_new``: every double pair,
    slab_eps_apply_takes for the apply and the residual)."""
    rows, seed, isl, dtype = [], 1900, dk._ISL, torch.float32
    for (dims, pxy), per_z, gates in itertools.product(
            shapes, (False, True),
            itertools.product((False, True), repeat=2)):
        per = tuple(pxy) + (per_z,)
        for bc_kind, n_eps in itertools.product(
                ("dirichlet", "neumann", "continuous", "planes"), (1, 3)):
            lam = 0.3 if bc_kind in ("neumann", "planes") else 0.0
            seed += 1
            cfg, field, planes = slab_case(dk, dims, per, bc_kind, dtype,
                                           seed, gates, n_eps=n_eps)
            phi, rhs = field(), field()
            eps = tuple(field(coef=True) for _ in range(n_eps))
            tag = f"[n_eps={n_eps}][z_gates={int(gates[0])}{int(gates[1])}]"
            for kind in SLAB_EPS_KINDS:
                k = int(kind[-1]) if kind.startswith("pairs") else 0
                if k == 2 and not cfg.periodic_even:
                    continue
                counter = slab_eps_counter(dk, kind, n_eps)
                before = dk.launch_counts()[counter]
                if k:
                    got = dk.pair_sweep_dense(cfg, phi, rhs, lam, planes, 0,
                                              n_pairs=k, eps=eps,
                                              z_gates=gates)
                    new = dk.launch_counts()[counter] == before + 1
                    want = dk._pairs_plain(cfg, phi, rhs, lam, planes, 0, k,
                                           eps, gates)
                else:
                    res = kind == "residual"
                    got = dk.stencil_apply_dense(cfg, phi, rhs, lam, planes,
                                                 res, eps=eps, z_gates=gates)
                    new = dk.launch_counts()[counter] == before + 1
                    want = dk._apply_plain(cfg, phi, rhs, lam, planes, res,
                                           eps, gates)
                old = torch.empty_like(phi)
                design = slab_runner(dk, old_fns["omg_stencil_slab"],
                                     "pairs" if k else kind,
                                     cfg, phi, rhs, lam, planes, gates,
                                     out=old, eps=eps, n_pairs=k)()
                if design != 0:
                    fail(f"the old coefficient slab design reported design "
                         f"{design}")
                torch.cuda.synchronize()
                up = ulp_diff(got[isl], want[isl])
                uo = ulp_diff(got[isl], old[isl])
                u = max(up, uo) if min(up, uo) >= 0 else 1 << 62
                rows.append({"kernel": f"{kind}{tag}[z_gates][new design]",
                             "dims": dims, "periodic": per,
                             "dtype": "float32", "bc": bc_kind, "lam": lam,
                             "max_ulp": u, "max_ulp_vs_plain": up,
                             "max_ulp_vs_old_design": uo, "new_design": new,
                             "want_new": bool(k) or slab_eps_apply_takes(
                                 dims)})
                del got, want, old
            del phi, rhs, eps
    torch.cuda.empty_cache()
    return rows


#: float32 forest canvases that the segment kernels' new designs take
#: (csrc/stream_wide.cuh with SEG = 1 for the double pair, where
#: wide_seg_takes; csrc/apply_faces.cuh with SEG = 1 for every apply and
#: residual), with their ghost layers (seg_layer_set): the forest's 256^3
#: canvas; one with x, y and z tails (8 of the pair's 64 x 32 tile, 8 of
#: the apply's 64 x 16 one, 4 of an 8-plane chunk); on the 132 SMs of an
#: H100 the smallest canvas the pair's rule takes (one tile, 264 chunks
#: of 8 planes) and the thinnest (2 planes, 272 tiles); MAX_SEGS layers;
#: readers at tile and chunk edges; readers served on both sides; the
#: multi-canvas forest's 256^3 corner-blob unit (multiforest_path's level
#: 2), whose six layers are its canvas faces
SEG_WIDE_SHAPES = [((256, 256, 256), "faces_and_middle"),
                   ((264, 168, 100), "faces_and_middle"),
                   ((2, 2, 2112), "faces_and_middle"),
                   ((1024, 544, 2), "faces_and_middle"),
                   ((264, 168, 100), "max"),
                   ((264, 168, 100), "edges"),
                   ((264, 168, 100), "both_sides"),
                   ((256, 256, 256), "faces")]
#: the counters of the segment launches on the new designs
SEG_WIDE = "pair_sweep_dense[segs][wide]"
SEG_FACES = "stencil_apply_dense[segs][faces]"


def old_seg_library(dk):
    """omg_seg_sweep of csrc/seg_sweep.cu built with -DOMG_SEGWIDE=0: every
    segment launch on csrc/stream_kernel.cuh, the design before the wide
    and face-plane ones, to hold the new designs against."""
    return old_library(dk, "-DOMG_SEGWIDE=0", (
        ("seg_sweep", "omg_seg_sweep"),))["omg_seg_sweep"]


def old_seg_launch(dk, fn, cfg, mode, phi, rhs, lam, n_pairs, layers,
                   planes):
    """One launch of the old design (old_seg_library) as the wrappers
    make it; not counted (a comparison, not the path)."""
    import ctypes
    S = dk._seg_params(layers, planes)
    P = dk._params(cfg, lam, None, 0, 2 * n_pairs, seg=True)
    out = torch.empty_like(phi)
    design = ctypes.c_int(-1)
    err = fn(dk._dt(cfg), mode, ctypes.byref(P), ctypes.byref(S),
             phi.data_ptr(), rhs.data_ptr(), out.data_ptr(),
             dk.cuda_stream(phi), ctypes.byref(design))
    if err != 0 or design.value != 0:
        fail(f"the old segment design: error {err}, design {design.value}")
    return out


def seg_wide_checks(dk, old_fn, shapes=SEG_WIDE_SHAPES):
    """The float32 segment pair (1 and 2 pairs), apply and residual on
    canvases their new designs take, NaN pads: 0 ulp against the plain
    version and against the old design (old_seg_library), and counted
    under SEG_WIDE / SEG_FACES (``new_design``).  ``kind``: a name of
    seg_layer_set, or the layers themselves."""
    rows, seed, dtype, lam, isl = [], 1300, torch.float32, 0.37, dk._ISL
    for dims, kind in shapes:
        seed += 1
        segs = seg_layer_set(dims, kind) if isinstance(kind, str) \
            else list(kind)
        kind = kind if isinstance(kind, str) else "solver"
        cfg, planes, phi, rhs = seg_case(dk, dims, dtype, seed, segs)
        layers = dk.seg_layers(cfg, segs, phi.device)
        for name, mode, n in (("pairs1", 0, 1), ("pairs2", 0, 2),
                              ("apply", 1, 0), ("residual", 2, 0)):
            counter = SEG_WIDE if mode == 0 else SEG_FACES
            before = dk.launch_counts()[counter]
            if mode == 0:
                got = dk.pair_sweep_dense(cfg, phi, rhs, lam, None, 0,
                                          n_pairs=n, segs=layers,
                                          seg_planes=planes)
            else:
                got = dk.stencil_apply_dense(cfg, phi, rhs, lam, None,
                                             mode == 2, segs=layers,
                                             seg_planes=planes)
            new = dk.launch_counts()[counter] == before + 1
            if mode == 0:
                want = dk._seg_pairs_plain(cfg, phi, rhs, lam, 0, n, segs,
                                           planes)
            else:
                want = dk._seg_apply_plain(cfg, phi, rhs, lam, mode == 2,
                                           segs, planes)
            old = old_seg_launch(dk, old_fn, cfg, mode, phi, rhs, lam, n,
                                 layers, planes)
            torch.cuda.synchronize()
            up = ulp_diff(got[isl], want[isl])
            uo = ulp_diff(got[isl], old[isl])
            u = max(up, uo) if min(up, uo) >= 0 else 1 << 62
            rows.append({"kernel": f"{name}[segs][new design]",
                         "dims": dims, "layers": kind,
                         "ghost_layers": len(segs), "dtype": "float32",
                         "lam": lam, "max_ulp": u, "max_ulp_vs_plain": up,
                         "max_ulp_vs_old_design": uo, "new_design": new})
            del got, want, old
        del cfg, planes, phi, rhs, layers
    torch.cuda.empty_cache()
    return rows


#: canvases of one half-sweep (row 2 of PERF.md; its register march of
#: csrc/stencil_sweep.cu takes every launch): the forests' sequential
#: levels (forest_periodic's full levels at base 256, 256^3 .. 16^3), a
#: thin canvas with ragged tiles (2 planes: 8 of the 64 x 16 tile in x
#: and y), ragged tiles in every dim and an odd canvas; (dims, periodic),
#: each also fully non-periodic and fully periodic
HALF_SHAPES = [((256, 256, 256), (False, False, False)),
               ((128, 128, 128), (True, True, True)),
               ((64, 64, 64), (False, True, False)),
               ((32, 32, 32), (True, False, True)),
               ((16, 16, 16), (False, False, True)),
               ((1032, 520, 2), (True, False, False)),
               ((72, 20, 10), (True, True, False)),
               ((7, 5, 3), (False, True, True))]
#: the counter of a half-sweep on the register march
HALF_MARCH = "half_sweep_dense[march]"
HALF_BC_KINDS = ("dirichlet", "neumann", "continuous", "planes", "forest")


def old_half_launch(dk, fn, cfg, phi, rhs, lam, planes, parity):
    """One half-sweep of the old design (-DOMG_HALFAF=0: stream_kernel.cuh's
    wavefront) as the wrapper makes it; not counted."""
    out = torch.empty_like(phi)
    design = half_runner(dk, fn, cfg, phi, rhs, lam, planes, parity, out)()
    if design != 0:
        fail(f"the old half-sweep reported design {design}")
    return out


def half_checks(dk, old_fn, shapes=HALF_SHAPES):
    """One half-sweep on HALF_SHAPES, each also non-periodic and fully
    periodic: float32 and float64, the four BC kinds with constant faces
    and plane-valued ones, and the forest's identity-coefficient planes,
    both parities, NaN in every pad but the wrapped copies of a periodic
    axis: 0 ulp against the plain version and against the old design
    (old_fn: -DOMG_HALFAF=0), every launch counted under HALF_MARCH
    (``new_design``)."""
    rows, seed, isl = [], 2300, dk._ISL
    for dims, per0 in shapes:
        pers = list(dict.fromkeys([per0, (False,) * 3, (True,) * 3]))
        for per, dtype, bc_kind in itertools.product(
                pers, (torch.float32, torch.float64), HALF_BC_KINDS):
            lam = 0.3 if bc_kind in ("neumann", "planes") else 0.0
            seed += 1
            cfg, field, planes = make_case(dk, dims, per, bc_kind, dtype,
                                           seed)
            phi, rhs = field(cfg), field(cfg)
            for parity in (0, 1):
                before = dk.launch_counts()[HALF_MARCH]
                got = dk.half_sweep_dense(cfg, phi, rhs, lam, planes, parity)
                new = dk.launch_counts()[HALF_MARCH] == before + 1
                want = dk._half_plain(cfg, phi, rhs, lam, planes, parity)
                old = old_half_launch(dk, old_fn, cfg, phi, rhs, lam, planes,
                                      parity)
                torch.cuda.synchronize()
                up = ulp_diff(got[isl], want[isl])
                uo = ulp_diff(got[isl], old[isl])
                u = max(up, uo) if min(up, uo) >= 0 else 1 << 62
                rows.append({"kernel": f"half_sweep{parity}[new design]",
                             "dims": dims, "periodic": per,
                             "dtype": str(dtype)[6:], "bc": bc_kind,
                             "lam": lam, "max_ulp": u,
                             "max_ulp_vs_plain": up,
                             "max_ulp_vs_old_design": uo, "new_design": new})
                del got, want, old
            del phi, rhs, planes
    torch.cuda.empty_cache()
    return rows


#: levels and slabs of the double-float residual (rows 8 and 8z of
#: PERF.md; df32_march_takes of csrc/residual_df32.cu sends levels and
#: slabs of 2^24 cells and more in planes of 2^18 and more to the z-march,
#: the rest to the thread-per-cell kernel): the slabs of the sharded
#: 512^3 .. 32^3 levels over 8 (512^2 x 64 on the march), the thinnest
#: slab the rule takes (2 planes, a ragged x tile) and one just below it
#: (a ragged y tile), ragged tiles in every dim on the march and an odd
#: slab (slab mode, every gate pair, physical and periodic z); the
#: refined path's 256^3 level (refined_vs_f64, below the rule's planes),
#: the ragged one as a level (on the march), a small level and an odd one
#: (the level mode, as given and fully periodic); (dims, (x, y) periodic,
#: "slab") or (dims, periodic, "level")
DF32_MARCH_SHAPES = [((512, 512, 64), (False, False), "slab"),
                     ((256, 256, 32), (True, True), "slab"),
                     ((128, 128, 16), (False, True), "slab"),
                     ((64, 64, 8), (True, False), "slab"),
                     ((32, 32, 4), (False, False), "slab"),
                     ((4104, 2048, 2), (False, True), "slab"),
                     ((4096, 2047, 2), (True, False), "slab"),
                     ((1032, 520, 32), (True, False), "slab"),
                     ((13, 7, 4), (False, False), "slab"),
                     ((256, 256, 256), (False, False, False), "level"),
                     ((1032, 520, 32), (False, True, False), "level"),
                     ((72, 40, 36), (False, True, False), "level"),
                     ((13, 7, 5), (True, False, True), "level")]


def df32_march_takes(dims):
    """Whether the z-march takes a double-float residual: df32_march_takes
    of csrc/residual_df32.cu, levels and slabs of 2^24 cells or more in
    planes of 2^18 cells or more."""
    X, Y, Z = dims
    return X * Y >= 1 << 18 and X * Y * Z >= 1 << 24
#: the counters of the double-float residual on its z-march
DF32_MARCH = "residual_df32_dense[march]"
DF32_SLAB_MARCH = "residual_df32_dense[z_gates][march]"


def df32_runner(dk, df, fns, cfg, xhi, xlo, rhi, rlo, out, cbs, lam_pair,
                gates=None):
    """A closure that launches the double-float residual of a library
    (fns: its omg_residual_df32 and omg_residual_df32_slab) into out as
    the wrapper makes it, gates: the slab mode, and returns the design
    the library reports; not counted."""
    import ctypes
    P = dk._params(cfg, 0.0, [None] * 6)
    Q = df._Df32Params()
    for nb in range(6):
        Q.cb_hi[nb], Q.cb_lo[nb] = cbs[nb]
    Q.has_lam = int(lam_pair is not None)
    Q.lam_hi, Q.lam_lo = lam_pair if lam_pair is not None else (0.0, 0.0)
    design = ctypes.c_int(-1)
    ptrs = (xhi.data_ptr(), xlo.data_ptr(), rhi.data_ptr(), rlo.data_ptr(),
            out.data_ptr(), dk.cuda_stream(xhi), ctypes.byref(design))
    Zs = dk._slab_params(gates) if gates is not None else None

    def run():
        if gates is None:
            err = fns["omg_residual_df32"](ctypes.byref(P), ctypes.byref(Q),
                                           *ptrs)
        else:
            err = fns["omg_residual_df32_slab"](
                ctypes.byref(P), ctypes.byref(Q), ctypes.byref(Zs), *ptrs)
        if err != 0:
            fail(f"residual_df32: launch error {err}")
        return design.value
    return run


def old_df32_library(dk):
    """The double-float residual of csrc/residual_df32.cu built with
    -DOMG_DF32MARCH=0: a thread per cell, the design before the z-march."""
    return old_library(dk, "-DOMG_DF32MARCH=0", (
        ("residual_df32", "omg_residual_df32"),
        ("residual_df32", "omg_residual_df32_slab")))


def df32_march_checks(dk, df, old_fns, shapes=DF32_MARCH_SHAPES):
    """The double-float residual on DF32_MARCH_SHAPES: slabs with every
    gate pair, physical and periodic z, the z pads random beyond a
    gated-off face (or a periodic z) and NaN elsewhere; levels as given
    and fully periodic, NaN pads but the wrapped copies; Dirichlet,
    Neumann and continuous faces, with and without lam, with a
    boundary-value override (below 2^22 cells each face kind with all
    three, above it one each): 0 ulp against the plain version and against
    the old design (old_fns: -DOMG_DF32MARCH=0), counted under DF32_MARCH
    / DF32_SLAB_MARCH (``new_design``) exactly where the rule takes it
    (``want_new``: df32_march_takes), and within the
    double-float bound of phase_df32_exactness (3e-7 max|r| + 1e-11 idr2
    max|x|) of the native float64 residual of x_hi + x_lo (the plain
    float64 version)."""
    rows, seed, isl, f32 = [], 2700, dk._ISL, torch.float32
    todo = []
    for dims, per, mode in shapes:
        if mode == "slab":
            todo += [(dims, tuple(per) + (pz,), g) for pz in (False, True)
                     for g in itertools.product((False, True), repeat=2)]
        else:
            todo += [(dims, p, None)
                     for p in dict.fromkeys([tuple(per), (True,) * 3])]
    for (dims, per, gates), (k, bc_kind) in itertools.product(
            todo, enumerate(("dirichlet", "neumann", "continuous"))):
        seed += 1
        if gates is None:
            cfg, field, _ = make_case(dk, dims, per, bc_kind, f32, seed,
                                      equal_pow2=True)
            fld = lambda: field(cfg)
        else:
            cfg, field, _ = slab_case(dk, dims, per, bc_kind, f32, seed,
                                      gates, equal_pow2=True)
            fld = field
        if not df.df32_ok(cfg):
            fail(f"df32 case {dims} {bc_kind} is outside df32_ok")
        xhi, rhi = fld(), fld()
        xlo, rlo = fld() * 2.0 ** -25, fld() * 2.0 ** -25
        counter = DF32_MARCH if gates is None else DF32_SLAB_MARCH
        override = [0.5, -0.25, 0.1, 0.3, 0.0, 1.0]
        variants = ((0.0, None), (0.37, None), (0.0, override))
        if int(np.prod(dims)) >= 1 << 22:
            variants = variants[k:k + 1]
        for lam, bvals in variants:
            kw = dict(cbs=df._cb_pairs(cfg, bvals),
                      lam_pair=df.split_lam(lam))
            before = dk.launch_counts()[counter]
            got = df.residual_df32_dense(cfg, xhi, xlo, rhi, rlo,
                                         z_gates=gates, **kw)
            new = dk.launch_counts()[counter] == before + 1
            want = df.residual_df32(cfg, xhi, xlo, rhi, rlo, z_gates=gates,
                                    **kw)
            old = torch.empty_like(xhi)
            if df32_runner(dk, df, old_fns, cfg, xhi, xlo, rhi, rlo, old,
                           gates=gates, **kw)() != 0:
                fail("the old double-float residual reported a new design")
            # the native float64 residual of the represented x
            b64 = bvals if bvals is not None else cfg.b_const
            c64 = dk.DenseStencilConfig(cfg.dims, cfg.idr2, cfg.bc,
                                        cfg.periodic, torch.float64,
                                        b_const=b64)
            x64 = xhi.double() + xlo.double()
            r64 = dk._apply_plain(c64, x64, rhi.double() + rlo.double(), lam,
                                  [None] * 6, True, (), gates)[isl]
            torch.cuda.synchronize()
            up = ulp_diff(got[isl], want[isl])
            uo = ulp_diff(got[isl], old[isl])
            u = max(up, uo) if min(up, uo) >= 0 else 1 << 62
            err64 = float((got[isl].double() - r64).abs().max())
            bound64 = (3e-7 * float(r64.abs().max()) +
                       1e-11 * cfg.idr2[0] * float(x64[isl].abs().max()))
            rows.append({"kernel": "residual_df32[new design]"
                         + ("" if gates is None else
                            f"[z_gates={int(gates[0])}{int(gates[1])}]"),
                         "dims": dims, "periodic": per, "dtype": "float32",
                         "bc": bc_kind, "lam": lam,
                         "bc_values_override": bvals is not None,
                         "max_ulp": u, "max_ulp_vs_plain": up,
                         "max_ulp_vs_old_design": uo, "new_design": new,
                         "want_new": df32_march_takes(dims),
                         "float64_max_abs_err": err64,
                         "float64_bound": bound64,
                         "within_float64_bound": err64 <= bound64})
            del got, want, old, x64, r64
        del xhi, xlo, rhi, rlo
    torch.cuda.empty_cache()
    return rows


def flat_cases():
    """The boxed solver's half-sweep kernel against its plain version:
    float32 and float64, D = 1, 2, 3, nc 2, 4, 8, 16, n = 1, 7 and 4096
    boxes, lam 0 and 0.7, both parities; random fields, ghosts included
    (the kernel must leave them as they are)."""
    from octree_mg_tpu_torch.ops import flat_smoother as fs
    rows = []
    g = torch.Generator(device="cuda").manual_seed(31)
    for dtype in (torch.float32, torch.float64):
        for ndim in (1, 2, 3):
            idr2 = (7.3, 2.0, 0.55)[:ndim]
            for nc in (2, 4, 8, 16):
                S = (nc + 2) ** ndim
                for n in (1, 7, 4096):
                    phi = torch.randn((n, S), generator=g, dtype=dtype,
                                      device="cuda")
                    rhs = torch.randn((n, S), generator=g, dtype=dtype,
                                      device="cuda")
                    for lam in (0.0, 0.7):
                        for parity in (0, 1):
                            want = fs._half_sweep_flat_plain(
                                phi, rhs, ndim, nc, idr2, lam, parity)
                            got = fs.half_sweep_flat(phi.clone(), rhs, ndim,
                                                     nc, idr2, lam, parity)
                            torch.cuda.synchronize()
                            u = ulp_diff(got, want)
                            rows.append({
                                "kernel": "half_sweep_flat", "ndim": ndim,
                                "nc": nc, "n": n, "dtype": str(dtype)[6:],
                                "lam": lam, "parity": parity,
                                "max_ulp": u if u >= 0 else 1 << 62})
                    del phi, rhs
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, reps, warmup=2):
    """Median time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
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


def work_model(name, n_f, n_c, item):
    """(bytes, flops) the function needs: every input cell read once,
    every output cell written once.  n_f/n_c: fine/coarse cell counts.

    A coefficient variant ``name[n_eps=k]`` reads k more fields.  Its
    operations per cell: an update 50 (six face coefficients of five
    operations each, three per side into num and den, the negated rhs
    and the division), an application 49 (the coefficients, three per
    side, -lam*p), a residual 50; the double pair updates each cell twice
    and the down-leg adds a residual and two restrictions."""
    if name in FOREST_VARIANTS:
        raise ValueError(f"{name}: see forest_work_model")
    if "[" in name:
        base, n_eps = name.split("[")[0], int(name.split("=")[1][:-1])
        nbytes = work_model(base, n_f, n_c, item)[0] + n_eps * n_f * item
        return nbytes, {"pair_sweep_dense": 100 * n_f,
                        "stencil_apply_dense": 50 * n_f,
                        "downsweep_dense": (100 + 50 + 2) * n_f,
                        "residual_restrict_dense": (50 + 2) * n_f}[base]
    return {
        # phi, rhs in; phi out.  11 flops per updated cell and half-sweep
        "pair_sweep_dense": (3 * n_f * item, 2 * 11 * n_f),
        # phi, rhs in; residual out.  15 flops per cell
        "stencil_apply_dense": (3 * n_f * item, 15 * n_f),
        # phi, rhs in; phi and two coarse fields out
        "downsweep_dense": ((3 * n_f + 2 * n_c) * item,
                            (22 + 15 + 2) * n_f),
        "residual_restrict_dense": ((2 * n_f + 2 * n_c) * item,
                                    (15 + 2) * n_f),
        "restrict_dense": ((n_f + n_c) * item, n_f),
        # phi_c, iold_c, phi_f in; phi_f out
        "prolong_correct_dense": ((2 * n_c + 2 * n_f) * item, 40 * n_c),
        # x_hi, x_lo, rhs_hi, rhs_lo in; r_hi out.  Per cell and axis a
        # TwoSum of the neighbours, a TwoSum into the accumulator and the
        # compensation and x_lo terms (22), then two TwoSums for 6*idr2*x
        # and the closing terms (21): 87 flops on an interior cell
        "residual_df32_dense": (5 * n_f * item, 87 * n_f),
    }[name]


def forest_work_model(name, n, n_c, plane_bytes, item):
    """(bytes, flops) of a forest kernel call: n cells of the canvas (the
    fine canvas of a prolongation), n_c of its coarse window,
    plane_bytes the ghost planes it reads (the six faces of a half-sweep
    and of a corr_ready window; the [4, T1, T2] planes of a segment
    launch).  A half-sweep updates half the cells (11 flops each); a
    segment pair or apply is the plain one plus its planes."""
    return {
        "half_sweep_dense": (3 * n * item + plane_bytes, 11 * n // 2),
        "pair_sweep_dense[segs]": (3 * n * item + plane_bytes, 2 * 11 * n),
        "stencil_apply_dense[segs]": (3 * n * item + plane_bytes, 15 * n),
        # correction window in, fine field read and written
        "prolong_correct_dense[corr_ready]": (
            (n_c + 2 * n) * item + plane_bytes, 34 * n_c),
        # coarse field in, fine field written
        "prolong_correct_dense[set]": ((n_c + n) * item, 34 * n_c),
    }[name]


def timed_row(name, kern, plain, launches, per_fmg, shape, nbytes, flops,
              extra=None, inplace=None):
    """One ``kernels`` row: the kernel against its plain version (max abs
    error, 0 required), kernel and plain times, bound.  inplace: the
    buffer that both write into (the prolongation's fine field): each
    of the two then starts from its original values and is compared on
    a copy of what it left, never on two views of one storage."""
    keep = inplace.clone() if inplace is not None else None
    got = tuple(a.clone() for a in kern())
    if keep is not None:
        inplace.copy_(keep)
    want = tuple(a.clone() for a in plain())
    if keep is not None:
        inplace.copy_(keep)
    del keep
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    if not all(bool(torch.isfinite(a).all()) for a in got):
        fail(f"{name}: non-finite output at {shape}")
    del got, want
    ms = time_ms(kern, 12)
    plain_ms = time_ms(plain, 3, warmup=1)
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    if err != 0.0:
        fail(f"{name}: differs from its plain version at {shape} (max abs "
             f"err {err}; tolerance 0, identical arithmetic)")
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "launches_per_fmg": per_fmg, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_b, t_f),
            "bound_by": "bytes" if t_b >= t_f else "operations",
            "library_ms": None, "shape": list(shape), "dtype": "float32",
            **(extra or {})}


def df32_design(dk, df, cfg, xhi, xlo, rhi, rlo, cbs, launches, gates=None):
    """The keys of rows 8 and 8z beside the wrapper's time: the design,
    the launches on it (launches: the counts of the row's path), its time
    from the library and the old design's (-DOMG_DF32MARCH=0) on the same
    inputs."""
    new = {s: dk._fn("residual_df32", s)
           for s in ("omg_residual_df32", "omg_residual_df32_slab")}
    out = torch.empty_like(xhi)
    counter = DF32_MARCH if gates is None else DF32_SLAB_MARCH
    row = {"design": "octree_mg_tpu_torch/csrc/residual_df32.cu "
                     "(df32_march_kernel)",
           "launches_on_the_new_design": launches[counter],
           "ms_from_library": time_ms(df32_runner(
               dk, df, new, cfg, xhi, xlo, rhi, rlo, out, cbs, None, gates),
               12),
           "old_design": "octree_mg_tpu_torch/csrc/residual_df32.cu "
                         "(residual_df32_kernel, -DOMG_DF32MARCH=0)",
           "old_design_ms": time_ms(df32_runner(
               dk, df, old_df32_library(dk), cfg, xhi, xlo, rhi, rlo, out,
               cbs, None, gates), 12)}
    del out
    return row


def phase_kernel_times(dk, df, launches, launches_refined, vcoeff):
    """Every entry point at the main path's top-level shape.  launches:
    counts of the float32 solve; launches_refined: of the refined solve
    (the path of the double-float residual); vcoeff: {n_eps: (counts of
    the variable-coefficient path, launches per have-guess FMG)} (the
    path of the coefficient variants)."""
    import torch.nn.functional as F
    dtype, n = torch.float32, 512
    per = (False,) * 3
    cfg, field, planes = make_case(dk, (n,) * 3, per, "dirichlet", dtype, 99,
                                   nan_pads=False)
    cfg.b_const = [0.0] * 6          # the main path's faces
    cfg_c, field_c, planes_c = make_case(dk, (n // 2,) * 3, per, "dirichlet",
                                         dtype, 98, nan_pads=False)
    cfg_c.b_const = [0.0] * 6
    phi, rhs = field(cfg), field(cfg)
    phi_c, iold_c = field_c(cfg_c), field_c(cfg_c)
    lam, isl = 0.0, dk._ISL
    n_f, n_c = n ** 3, (n // 2) ** 3
    # measured device-to-device copy rate, for reference beside the peak
    src, dst = torch.empty_like(phi), torch.empty_like(phi)
    copy_ms = time_ms(lambda: dst.copy_(src), 10)
    copy_bps = 2 * src.numel() * 4 / (copy_ms * 1e-3)
    del src, dst

    def inner(*ts):
        return tuple(t[isl] for t in ts if t is not None)

    cases = [
        ("pair_sweep_dense",
         lambda: dk.pair_sweep_dense(cfg, phi, rhs, lam, planes, 0, n_pairs=2),
         lambda: dk._pairs_plain(cfg, phi, rhs, lam, planes, 0, 2), None),
        ("stencil_apply_dense",
         lambda: dk.stencil_apply_dense(cfg, phi, rhs, lam, planes, True),
         lambda: dk._apply_plain(cfg, phi, rhs, lam, planes, True), None),
        ("downsweep_dense",
         lambda: dk.downsweep_dense(cfg, phi, rhs, lam, planes, 0),
         lambda: dk._down_plain(cfg, phi, rhs, lam, planes, 0, 2), None),
        ("residual_restrict_dense",
         lambda: dk.residual_restrict_dense(cfg, phi, rhs, lam, planes),
         lambda: dk._down_plain(cfg, phi, rhs, lam, planes, 0, 0)[1:], None),
        ("restrict_dense",
         lambda: dk.restrict_dense(cfg, phi),
         lambda: dk._restrict_plain(cfg, phi),
         lambda: F.avg_pool3d(phi[isl][None, None], 2)),
        ("prolong_correct_dense",
         lambda: dk.prolong_correct_dense(cfg_c, phi_c, iold_c, phi,
                                          planes_c),
         lambda: dk._prolong_correct_plain(cfg_c, phi_c, iold_c, phi,
                                           planes_c), None),
    ]
    # the double-float residual: x_lo and rhs_lo one pair ulp below
    xlo, rlo = phi * 2.0 ** -25, rhs * 2.0 ** -25
    cbs = df._cb_pairs(cfg)
    r_out = torch.empty_like(phi)
    df32_extra = df32_design(dk, df, cfg, phi, xlo, rhs, rlo, cbs,
                             launches_refined)
    cases.append((
        "residual_df32_dense",
        lambda: df.residual_df32_dense(cfg, phi, xlo, rhs, rlo, cbs=cbs,
                                       out=r_out),
        lambda: df.residual_df32(cfg, phi, xlo, rhs, rlo, cbs=cbs), None))
    # the coefficient variants: 0.5 + U[0,1) fields, as the checks use
    for n_eps in (1, 3):
        ce = dk.DenseStencilConfig(cfg.dims, cfg.idr2, cfg.bc, cfg.periodic,
                                   dtype, b_const=cfg.b_const, n_eps=n_eps)
        eps = eps_fields(dk, ce, 97 + n_eps)
        v = f"[n_eps={n_eps}]"
        cases += [
            ("pair_sweep_dense" + v,
             lambda ce=ce, eps=eps: dk.pair_sweep_dense(
                 ce, phi, rhs, lam, planes, 0, n_pairs=2, eps=eps),
             lambda ce=ce, eps=eps: dk._pairs_plain(
                 ce, phi, rhs, lam, planes, 0, 2, eps), None),
            ("stencil_apply_dense" + v,
             lambda ce=ce, eps=eps: dk.stencil_apply_dense(
                 ce, phi, rhs, lam, planes, True, eps=eps),
             lambda ce=ce, eps=eps: dk._apply_plain(
                 ce, phi, rhs, lam, planes, True, eps), None),
            ("downsweep_dense" + v,
             lambda ce=ce, eps=eps: dk.downsweep_dense(
                 ce, phi, rhs, lam, planes, 0, eps=eps),
             lambda ce=ce, eps=eps: dk._down_plain(
                 ce, phi, rhs, lam, planes, 0, 2, eps), None),
            ("residual_restrict_dense" + v,
             lambda ce=ce, eps=eps: dk.residual_restrict_dense(
                 ce, phi, rhs, lam, planes, eps=eps),
             lambda ce=ce, eps=eps: dk._down_plain(
                 ce, phi, rhs, lam, planes, 0, 0, eps)[1:], None)]
    # a yardstick beside the apply kernel: the 7-point stencil as one
    # cuDNN convolution of the level's core, zero-padded (full float32:
    # no TF32).  Not the same function: it sums in another order and
    # reads zeros where the kernel synthesizes the BC ghosts.
    wt = torch.zeros((1, 1, 3, 3, 3), dtype=dtype, device="cuda")
    i2 = [cfg.rnd(v) for v in cfg.idr2]
    wt[0, 0, 1, 1, 1] = -lam - 2.0 * sum(i2)
    for (a, b, c), v in (((1, 1, 0), i2[0]), ((1, 1, 2), i2[0]),
                         ((1, 0, 1), i2[1]), ((1, 2, 1), i2[1]),
                         ((0, 1, 1), i2[2]), ((2, 1, 1), i2[2])):
        wt[0, 0, a, b, c] = v
    core = phi[isl].contiguous()[None, None]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    conv3d_ms = time_ms(lambda: F.conv3d(core, wt, padding=1), 10)
    torch.backends.cudnn.allow_tf32 = tf32
    del core
    rows = []
    for name, kern, plain, lib in cases:
        if name == "prolong_correct_dense":
            # in place on the fine field: compare on copies
            keep = phi.clone()
            got = dk.prolong_correct_dense(cfg_c, phi_c, iold_c, phi, planes_c)
            got = got[isl].clone()
            phi.copy_(keep)
            want = dk._prolong_correct_plain(cfg_c, phi_c, iold_c, phi,
                                             planes_c)[isl].clone()
            phi.copy_(keep)
            del keep
            pairs = [(got, want)]
        else:
            g, w = kern(), plain()
            g = g if isinstance(g, tuple) else (g,)
            w = w if isinstance(w, tuple) else (w,)
            pairs = list(zip(inner(*g), inner(*w)))
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in pairs)
        if not all(torch.isfinite(a).all() for a, _ in pairs):
            fail(f"{name}: non-finite output at 512^3")
        del pairs
        ms = time_ms(kern, 12)
        plain_ms = time_ms(plain, 3, warmup=1)
        lib_ms = time_ms(lib, 10) if lib is not None else None
        torch.cuda.empty_cache()
        nbytes, flops = work_model(name, n_f, n_c, 4)
        t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
        if name in EPS_VARIANTS:
            path, per_fmg = vcoeff[int(name.split("=")[1][:-1])]
            extra = {"launches_per_vcoeff_fmg": per_fmg[name]}
        else:
            path = (launches_refined if name == "residual_df32_dense"
                    else launches)
            extra = {"launches_in_refined_solve": launches_refined[name]}
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": path[name], **extra,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_b, t_f),
            "bound_by": "bytes" if t_b >= t_f else "operations",
            "library_ms": lib_ms, "shape": [n, n, n], "dtype": "float32",
            "bound_ms_at_measured_copy_rate": 1e3 * nbytes / copy_bps,
            **({"design": "octree_mg_tpu_torch/csrc/stream_wide.cuh",
                "launches_on_the_wide_design": path[name + "[wide]"]}
               if name in WIDE_KERNELS else {}),
            **({"design": FACE_DESIGNS[name.split("[")[0]],
                "launches_on_the_face_design": path[name + "[faces]"]}
               if name.split("[")[0] in dk.FACE_ENTRIES
               and name in EPS_VARIANTS else {}),
            **({"design": FACE_DESIGNS[name],
                "launches_on_the_face_design": path[RR_FACES]}
               if name == "residual_restrict_dense" else {}),
            **({"conv3d_core_ms": conv3d_ms}
               if name == "stencil_apply_dense" else {}),
            **(df32_extra if name == "residual_df32_dense" else {}),
        })
        if err != 0.0:
            fail(f"{name}: differs from its plain version at 512^3 "
                 f"(max abs err {err}; tolerance 0, identical arithmetic)")
    return rows, copy_bps


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------

def check_fmg_history(hist, what):
    """Finite, falling to below 1e-3 of the first, and monotone until
    within 10x of its floor."""
    if not all(np.isfinite(hist)):
        fail(f"{what}: non-finite residuals {hist}")
    if not hist[-1] < 1e-3 * hist[0]:
        fail(f"{what}: residual fell only {hist[0]} -> {hist[-1]}")
    floor = 10.0 * min(hist)
    for a, b in zip(hist, hist[1:]):
        if a > floor and not b < a:
            fail(f"{what}: residual history not monotone: {hist}")


def phase_main_path(pkg, dk):
    n, n_have, n_timed = 512, 8, 8
    torch.cuda.reset_peak_memory_stats()
    ps = pkg.PoissonSolver(3, (n,) * 3, 16, dtype=torch.float32)
    ps.set_dirichlet(0.0)
    sv = ps.solver
    top = sv.levels[-1]
    g = torch.Generator(device="cuda").manual_seed(0)
    rhs = torch.randn((n,) * 3, generator=g, dtype=torch.float32,
                      device="cuda")
    ps.set_rhs(arrays={top: rhs})
    del rhs

    dk.reset_launch_counts()
    phi, info = ps.solve(rtol=0.0, atol=0.0, max_cycles=1 + n_have)
    launches = dk.launch_counts()
    hist = info["residuals"]
    if tuple(phi.shape) != (n, n, n) or not bool(torch.isfinite(phi).all()):
        fail("main path: phi has a wrong shape or non-finite values")
    check_fmg_history(hist, "main path")
    missing = [k for k in FMG_KERNELS + WIDE_COUNTERS if launches[k] == 0]
    if missing:
        fail(f"main path launched no kernel for {missing}")

    # timed loop: have-guess FMGs without the residual, one sync at the end
    state = ps.state
    sv.fas_fmg(state, have_guess=True, need_res=False)
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        sv.fas_fmg(state, have_guess=True, need_res=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    per_fmg = {k: v / n_timed for k, v in dk.launch_counts().items()}
    # update_coarse on every level 512^3 .. 16^3: the residual-restriction
    # on the face-plane apply
    if not per_fmg[RR_FACES] == per_fmg["residual_restrict_dense"] == 6:
        fail(f"main path: {per_fmg['residual_restrict_dense']} "
             f"residual-restrictions per FMG, {per_fmg[RR_FACES]} on the "
             f"face-plane apply (6 of 6 expected)")
    unknowns = float(sum(int(np.prod(sv.dims[l])) for l in sv.levels))
    emit({"main_path": {
        "model": "PoissonSolver(3, (512,)*3, 16, float32), Dirichlet 0",
        "levels": [list(sv.dims[l]) for l in sv.levels],
        "residuals": hist, "cycles": len(hist),
        "ms_per_fmg": 1e3 * dt / n_timed,
        "unknowns_per_s": unknowns * n_timed / dt,
        "launches_in_solve": launches, "launches_per_fmg": per_fmg,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}})
    return ps, launches, 1e3 * dt / n_timed


def phase_fmg_stages(ps):
    """Device time (CUDA events) and host time of each stage of one
    have-guess FMG, by level: where host time exceeds device time the
    stage is bound by launches, not by the card."""
    emit({"fmg_stages": fmg_stage_marks(ps.solver, ps.state)})


def fmg_stage_marks(sv, state):
    """phase_fmg_stages' marks for any dense solver and state."""
    lam = sv._lam(0.0)
    min_lvl, top = sv.levels[0], sv.levels[-1]
    marks = []

    def run(label, lvl, fn):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        host = time.perf_counter() - t0
        b.synchronize()
        marks.append({"stage": label, "dims": list(sv.dims[lvl]),
                      "device_ms": a.elapsed_time(b), "host_ms": 1e3 * host})

    with torch.no_grad():
        for lvl in range(top, min_lvl, -1):
            run("update_coarse", lvl,
                lambda: sv._update_coarse(state, lvl, lam))

        def stage(lvl):
            sv._save_iold(state, lvl)
            if lvl > min_lvl:
                sv._correct_children(state, lvl - 1, lam)
            sv._vcycle(state, lam, max_lvl=lvl, need_res=False)

        for lvl in range(min_lvl, top + 1):
            run("vcycle_to", lvl, lambda: stage(lvl))
    return marks


# ---------------------------------------------------------------------------
# the refined (f64-class) path
# ---------------------------------------------------------------------------

def event_ms(fn):
    """Device time of one call of fn, CUDA events, starting synchronised."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def check_refined_history(norms, what):
    if not all(np.isfinite(norms)):
        fail(f"{what}: non-finite norm history {norms}")
    floor = 10.0 * min(norms)
    for a, b in zip(norms, norms[1:]):
        if a > floor and not b < a:
            fail(f"{what}: norm history not monotone: {norms}")
    if not norms[-1] <= 1e-10 * norms[0]:
        fail(f"{what}: norms fell only {norms[0]} -> {norms[-1]}, wanted "
             f"1e-10 of the first")


def timed_refined(rp, state, rh, rl, n_outer, reps=3):
    """bench-style: warm, then whole ``rp.solve`` calls clocked on the
    host with one synchronisation at the end; the best of reps."""
    rp.solve(state, rh, rl, n_outer=n_outer)
    best, norms = float("inf"), None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, norms, _ = rp.solve(state, rh, rl, n_outer=n_outer)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, norms


def seeded_rhs64(n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((n,) * 3, generator=g, dtype=torch.float64,
                       device="cuda")


def phase_refined_path(ps, dk, df):
    """The f64-class mode of the main path's solver, through
    ``PoissonSolver.solve_refined``."""
    n, n_outer = 512, 10
    sv = ps.solver
    torch.cuda.reset_peak_memory_stats()
    rhs_dev = seeded_rhs64(n, 1)
    rhs64 = rhs_dev.cpu().numpy()          # split on the host by the model
    rh, rl = df.split_f64(rhs_dev)         # the same pair, for the timed run
    del rhs_dev

    dk.reset_launch_counts()
    phi, info = ps.solve_refined(rhs64, n_outer=n_outer)
    launches = dk.launch_counts()
    norms = info["residuals"]
    if phi.shape != (n, n, n) or phi.dtype != np.float64 or \
            not np.isfinite(phi).all():
        fail("refined path: phi has a wrong shape, dtype or values")
    check_refined_history(norms, "refined path")
    if launches["residual_df32_dense"] != n_outer + 1 or \
            launches[DF32_MARCH] != n_outer + 1:
        fail(f"refined path: the double-float residual kernel ran "
             f"{launches['residual_df32_dense']} times, "
             f"{launches[DF32_MARCH]} on the z-march, expected "
             f"{n_outer + 1}")
    missing = [k for k in REFINED_KERNELS if launches[k] == 0]
    if missing:
        fail(f"refined path launched no kernel for {missing}")
    del phi, rhs64

    rp = ps._refined[1]
    state = ps.state
    dk.reset_launch_counts()
    dt, norms_t = timed_refined(rp, state, rh, rl, n_outer)
    per_outer = {k: v / (4 * n_outer) for k, v in dk.launch_counts().items()}
    check_refined_history(norms_t, "refined path (timed run)")
    x_pair = (rp.x_hi.clone(), rp.x_lo.clone())   # the pieces below go on
    unknowns = float(sum(int(np.prod(sv.dims[l])) for l in sv.levels))

    # device time of one outer's pieces, each starting synchronised
    lam, top = sv._lam(0.0), sv.levels[-1]
    with torch.no_grad():
        pieces = {
            "residual_kernel_ms": event_ms(lambda: df.residual_df32_dense(
                rp.cfg, rp.x_hi, rp.x_lo, rp.rhs_hi, rp.rhs_lo, cbs=rp.cbs,
                lam_pair=rp.lam_pair, out=state["rhs"][top])),
            "max_norm_ms": event_ms(lambda: torch.linalg.vector_norm(
                state["rhs"][top][dk._ISL], float("inf"))),
            "inner_fmg_ms": event_ms(lambda: sv._fmg(
                state, lam, have_guess=False, need_res=False)),
            "accumulate_ms": event_ms(lambda: df.accumulate_df32_(
                rp.x_hi, rp.x_lo, state["phi"][top], rp._scratch)),
        }
    emit({"refined_path": {
        "model": "PoissonSolver(3, (512,)*3, 16, float32).solve_refined("
                 "float64 rhs, n_outer=10), Dirichlet 0",
        "norms": norms, "norms_timed_run": norms_t,
        "contraction_factors": [a / b for a, b in zip(norms, norms[1:])],
        "ms_per_outer": 1e3 * dt / n_outer,
        "unknowns_per_s_refined": unknowns * n_outer / dt,
        "launches_in_solve": launches, "launches_per_outer": per_outer,
        "outer_pieces_device_ms": pieces,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}})
    return launches, (rh, rl, dt / n_outer, norms_t, *x_pair)


def phase_df32_exactness(dk, df):
    """The kernel's r_hi against the native float64 residual of
    x_hi + x_lo (the float64 stencil kernel), x near a solution.  Bound:
    3e-7 * max|r| (r_hi's own float32 rounding) + 1e-11 * idr2 * max|x|
    (the ~2^-45 double-float floor of the stencil terms)."""
    n = 256
    cfg, _, _ = make_case(dk, (n,) * 3, (False,) * 3, "dirichlet",
                          torch.float32, 7, equal_pow2=True)
    cfg64 = dk.DenseStencilConfig(cfg.dims, cfg.idr2, cfg.bc, cfg.periodic,
                                  torch.float64, b_const=cfg.b_const)

    def pad(v):
        a = torch.zeros(cfg.pshape, dtype=v.dtype, device="cuda")
        a[dk._ISL] = v
        return a

    xh, xl = df.split_f64(seeded_rhs64(n, 2))
    x_rep = pad(xh.double() + xl.double())
    bp = [None] * 6
    ax = dk.stencil_apply_dense(cfg64, x_rep, x_rep, 0.0, bp, False)[dk._ISL]
    rh, rl = df.split_f64(ax + 1e-6 * seeded_rhs64(n, 3))
    rhs_rep = pad(rh.double() + rl.double())
    r64 = dk.stencil_apply_dense(cfg64, x_rep, rhs_rep, 0.0, bp,
                                 True)[dk._ISL]
    r_df = df.residual_df32_dense(cfg, pad(xh), pad(xl), pad(rh),
                                  pad(rl))[dk._ISL]
    r_plain = dk.stencil_apply_dense(cfg, x_rep.float(), rhs_rep.float(),
                                     0.0, bp, True)[dk._ISL]
    rmax = float(r64.abs().max())
    scale = cfg.idr2[0] * float(x_rep[dk._ISL].abs().max())
    err = float((r_df.double() - r64).abs().max())
    err_plain = float((r_plain.double() - r64).abs().max())
    bound = 3e-7 * rmax + 1e-11 * scale
    emit({"df32_exactness": {
        "dims": [n] * 3, "max_abs_residual": rmax, "stencil_scale": scale,
        "df32_max_abs_err": err, "bound": bound,
        "plain_float32_max_abs_err": err_plain,
        "plain_over_df32": err_plain / err}})
    if not err <= bound:
        fail(f"df32 residual off the float64 one by {err}, bound {bound}")
    if not err_plain > 50 * err:
        fail(f"plain float32 residual error {err_plain} is not 50x the "
             f"double-float one {err}")


def phase_refined_vs_f64(pkg):
    """256^3: the refined solution x_hi + x_lo against the native float64
    solve run to its floor on the same right-hand side.  Bound 1e-10 of
    max|x|: each solution sits within its residual floor times the
    operator's condition number (~0.4 N^2 = 2.7e4) of the exact one —
    float64 ~ 3e-11, double-float (floor 2^-45 of the stencil terms)
    ~ 6e-11 at worst; expected ~1e-13 (1.5e-14 at 64^3 on the CPU)."""
    n, bound = 256, 1e-10
    rhs64 = seeded_rhs64(n, 4).cpu().numpy()
    ps = pkg.PoissonSolver(3, (n,) * 3, 16, dtype=torch.float32)
    ps.set_dirichlet(0.0)
    phi_r, info_r = ps.solve_refined(rhs64, n_outer=10)
    check_refined_history(info_r["residuals"], "refined_vs_f64")
    del ps
    p64 = pkg.PoissonSolver(3, (n,) * 3, 16, dtype=torch.float64)
    p64.set_dirichlet(0.0)
    p64.set_rhs(arrays={p64.solver.levels[-1]: rhs64})
    phi_64, info_64 = p64.solve(rtol=0.0, max_cycles=14)
    phi_64 = phi_64.cpu().numpy()
    del p64
    torch.cuda.empty_cache()
    diff = float(np.abs(phi_r - phi_64).max() / np.abs(phi_64).max())
    emit({"refined_vs_f64": {
        "dims": [n] * 3, "max_rel_diff": diff, "bound": bound,
        "refined_norms": info_r["residuals"],
        "float64_residuals": info_64["residuals"]}})
    if not diff < bound:
        fail(f"refined and float64 solutions differ by {diff} of max|x|")


def phase_fused_mode(pkg, dk, ms_per_fmg_split, refined_split):
    """``MGConfig.fmg_mode="fused"`` at 512^3: one CUDA graph per FMG and
    per refined outer.  A replay must leave the bits of the eager cycle."""
    n, n_timed, n_outer = 512, 8, 10
    rh, rl, s_outer_split, norms_split, xhi_split, xlo_split = refined_split

    def solver(mode):
        ps = pkg.PoissonSolver(3, (n,) * 3, 16, dtype=torch.float32,
                               fmg_mode=mode)
        ps.set_dirichlet(0.0)
        g = torch.Generator(device="cuda").manual_seed(0)
        ps.set_rhs(arrays={ps.solver.levels[-1]: torch.randn(
            (n,) * 3, generator=g, dtype=torch.float32, device="cuda")})
        return ps

    def cycles(ps):
        """zero-guess FMG, then three have-guess ones: in fused mode an
        eager call, the capture with its first replay, and a replay."""
        sv, st = ps.solver, ps._ensure_state()
        for k in range(3):
            sv.fas_fmg(st, have_guess=False, need_res=False)
        for k in range(3):
            sv.fas_fmg(st, have_guess=True, need_res=False)
        return sv.interior(st, sv.levels[-1], "phi").clone()

    ps = solver("split")
    phi_split = cycles(ps)
    del ps
    ps = solver("fused")
    sv = ps.solver
    dk.reset_launch_counts()
    phi_fused = cycles(ps)
    counted = dk.launch_counts()
    if not torch.equal(phi_split, phi_fused):
        fail("fused FMG: a graph replay left other bits than the eager cycle")
    del phi_split, phi_fused
    graphs = [c for c in sv._graphs.values() if c is not None]
    if len(graphs) != 2:
        fail(f"fused FMG: expected 2 captured graphs, found {len(graphs)}")
    state = ps.state
    sv.fas_fmg(state, have_guess=True, need_res=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        sv.fas_fmg(state, have_guess=True, need_res=False)
    torch.cuda.synchronize()
    ms_fmg_fused = 1e3 * (time.perf_counter() - t0) / n_timed

    rp = pkg.RefinedPoisson(sv)
    dt, norms = timed_refined(rp, state, rh, rl, n_outer)
    if rp._graph is None:
        fail("fused refined outer: no graph was captured")
    if norms != norms_split or not (torch.equal(rp.x_hi, xhi_split)
                                    and torch.equal(rp.x_lo, xlo_split)):
        fail(f"fused refined solve differs from the eager one: norms "
             f"{norms} against {norms_split}")
    replayed = rp._graph.launches
    del rp, ps, sv, state
    torch.cuda.empty_cache()
    vc = fused_vcoeff(pkg)
    emit({"fused_mode": {
        "vhelmholtz_bitwise_equal_to_split_after_second_prepare": True,
        "vhelmholtz": vc,
        "bitwise_equal_to_split": True,
        "ms_per_fmg": {"split": ms_per_fmg_split, "fused": ms_fmg_fused},
        "ms_per_outer": {"split": 1e3 * s_outer_split,
                         "fused": 1e3 * dt / n_outer},
        "launches_counted_in_six_fmgs": counted,
        "launches_per_replayed_outer": replayed}})


# ---------------------------------------------------------------------------
# the variable-coefficient path
# ---------------------------------------------------------------------------

def smooth_eps(sv, d, dtype):
    """1 + 0.5*cos(2*pi*(x_d + 0.1*d)) on the finest level's cell
    centres, [Z, Y, X] on the card (tests/test_dense_vcoeff.py:25-27)."""
    top = sv.levels[-1]
    n = sv.dims[top][d]
    x = (sv.tree.r_min[d]
         + (torch.arange(n, dtype=torch.float64, device="cuda") + 0.5)
         * float(sv.tree.dr[top][d]))
    e = 1.0 + 0.5 * torch.cos(2 * np.pi * (x + 0.1 * d))
    shape = [1, 1, 1]
    shape[2 - d] = n
    Z, Y, X = sv._ishape(top)
    return e.view(shape).expand(Z, Y, X).to(dtype)


def phase_vcoeff_path(pkg, dk):
    """``PoissonSolver(3, (512,)*3, 16, operator=...)`` for vhelmholtz and
    ahelmholtz, lam 1.5, Dirichlet 0: coefficients set and restricted on
    the card, one zero-guess and eight have-guess FMGs through ``solve``
    (ahelmholtz contracts slower, tests/test_dense_vcoeff.py:150-153),
    then a timed loop of have-guess FMGs.  Returns {n_eps: (launches of
    the path, launches per have-guess FMG)}."""
    n, n_have, n_timed, lam = 512, 8, 8, 1.5
    out = {}
    for op, n_eps in (("vhelmholtz", 1), ("ahelmholtz", 3)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ps = pkg.PoissonSolver(3, (n,) * 3, 16, operator=op,
                               dtype=torch.float32)
        ps.set_dirichlet(0.0)
        sv = ps.solver
        top = sv.levels[-1]
        g = torch.Generator(device="cuda").manual_seed(5)
        dk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = ps._ensure_state()
        for d in range(sv.n_eps):
            sv.set_coefficient(state, smooth_eps(sv, d, torch.float32), d)
        sv.prepare_coefficient(state)
        ps.set_rhs(arrays={top: torch.randn((n,) * 3, generator=g,
                                            dtype=torch.float32,
                                            device="cuda")})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sv._ensure_direct(state)            # the probe: setup, on the card
        t2 = time.perf_counter()
        phi, info = ps.solve(lam=lam, rtol=0.0, atol=0.0,
                             max_cycles=1 + n_have)
        launches = dk.launch_counts()
        hist = info["residuals"]
        if tuple(phi.shape) != (n,) * 3 or not bool(
                torch.isfinite(phi).all()):
            fail(f"vcoeff path {op}: phi has a wrong shape or values")
        check_fmg_history(hist, f"vcoeff path {op}")
        missing = [k for k in vcoeff_kernels(n_eps) if launches[k] == 0]
        if missing:
            fail(f"vcoeff path {op} launched no kernel for {missing}")
        const = [k for k in ("pair_sweep_dense", "stencil_apply_dense",
                             "downsweep_dense", "residual_restrict_dense")
                 if launches[k]]
        if const:
            fail(f"vcoeff path {op} ran constant-coefficient kernels {const}")
        # every float32 coefficient double pair, down-leg, apply,
        # residual and residual-restriction, the 512^3 ones and the
        # probe's included, runs its face-plane design
        off = [k for k in dk.FACE_ENTRIES
               if launches[dk.faces_name(k, n_eps)]
               != launches[dk.variant_name(k, n_eps)]]
        if off:
            fail(f"vcoeff path {op}: {off} launched stream_kernel.cuh, not "
                 f"the face-plane design")

        sv.fas_fmg(state, lam=lam, have_guess=True, need_res=False)
        torch.cuda.synchronize()
        dk.reset_launch_counts()
        t3 = time.perf_counter()
        for _ in range(n_timed):
            sv.fas_fmg(state, lam=lam, have_guess=True, need_res=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t3
        per_fmg = {k: v / n_timed for k, v in dk.launch_counts().items()}
        unknowns = float(sum(int(np.prod(sv.dims[l])) for l in sv.levels))
        emit({"vcoeff_path": {
            "model": f"PoissonSolver(3, (512,)*3, 16, operator={op!r}, "
                     f"float32), lam {lam}, Dirichlet 0, eps "
                     f"1 + 0.5 cos(2 pi (x_d + 0.1 d))",
            "n_eps": n_eps, "residuals": hist, "cycles": len(hist),
            "contraction_factors": [a / b for a, b in zip(hist, hist[1:])],
            "ms_per_fmg": 1e3 * dt / n_timed,
            "unknowns_per_s": unknowns * n_timed / dt,
            "setup_s": {"coefficients_and_rhs": t1 - t0,
                        "direct_probe": t2 - t1},
            "launches_in_path": launches, "launches_per_fmg": per_fmg,
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}})
        out[n_eps] = (launches, per_fmg)
        del ps, sv, state, phi
    torch.cuda.empty_cache()
    return out


def phase_refined_vcoeff(pkg, dk, df):
    """``solve_refined`` for ahelmholtz at 512^3 (float32 inner solver,
    lam 0.31, three float64 coefficient fields, Dirichlet 0), then the
    refined solution through a float64 ahelmholtz solver's
    ``apply_operator`` on the card (tests/test_df32.py:510-525)."""
    n, n_outer, lam = 512, 10, 0.31
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tree = pkg.build_rectangle(3, np.full(3, n), 16, np.full(3, 1.0 / n),
                               np.zeros(3))
    sv = pkg.make_solver(tree, pkg.MGConfig(operator="ahelmholtz",
                                            dtype=torch.float32))
    sv.set_bc(0, pkg.BCType.DIRICHLET, 0.0)
    state = sv.allocate()
    # 0.5 + U[0,1) as tests/test_df32.py:483-525 (the smooth fields of
    # vcoeff_path contract ~5x per FMG under ahelmholtz's anisotropy,
    # too slowly for 1e-10 in ten outers; these ~25x)
    g = torch.Generator(device="cuda").manual_seed(8)
    eps64 = [0.5 + torch.rand((n,) * 3, generator=g, dtype=torch.float64,
                              device="cuda") for _ in range(3)]
    rhs64 = seeded_rhs64(n, 6)
    rh, rl = df.split_f64(rhs64)
    dk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xh, xl, norms, state = pkg.solve_refined(sv, state, rh, rl,
                                             n_outer=n_outer, lam=lam,
                                             eps=eps64)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dk.launch_counts()
    check_refined_history(norms, "refined vcoeff")
    # the inner FMGs start from a zero guess: no update_coarse, so no
    # residual_restrict_dense[n_eps=3] (as on the constant refined path)
    missing = [k for k in vcoeff_kernels(3) if launches[k] == 0
               and k != "residual_restrict_dense[n_eps=3]"]
    if missing:
        fail(f"refined vcoeff launched no kernel for {missing}")

    # a timed solve on a warm RefinedPoisson: its set-up (coefficient
    # install, restriction and probe: ``prepare``) and its outer loop
    # (``iterate``: n_outer outers and the closing residual) clocked apart
    rp = pkg.RefinedPoisson(sv, lam=lam, eps=eps64)
    rp.solve(state, rh, rl, n_outer=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rp.prepare(state, rh, rl)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, _, norms_t, _ = rp.iterate(state, n_outer)
    torch.cuda.synchronize()
    setup_s, dt = t1 - t0, time.perf_counter() - t1
    check_refined_history(norms_t, "refined vcoeff (timed run)")
    top = sv.levels[-1]
    with torch.no_grad():
        pieces = {
            "residual_df32_vcoeff_ms": event_ms(lambda: df.residual_df32_vcoeff(
                rp.cfg, rp.x_hi, rp.x_lo, rp.rhs_hi, rp.rhs_lo,
                rp._eps_pairs, cbs=rp.cbs, lam_pair=rp.lam_pair)),
            "inner_fmg_ms": event_ms(lambda: sv._fmg(
                state, sv._lam(lam), have_guess=False, need_res=False)),
        }
    peak = torch.cuda.max_memory_allocated()
    # the least time of residual_df32_vcoeff: x, rhs and three eps pairs
    # read once, r_hi written once; 749 flops per cell (per side a pair
    # product, sum and quotient for the face coefficient, a scale, a pair
    # difference, product and difference into the accumulator, 119; then
    # lam*x, 35; ops.df32's EFT op counts, no fma)
    t_b = (4 + 2 * 3 + 1) * n ** 3 * 4 / HBM_BYTES_PER_S
    t_f = 749 * n ** 3 / F32_FLOP_PER_S
    res_bound = {"bound_ms": 1e3 * max(t_b, t_f),
                 "bound_by": "bytes" if t_b >= t_f else "operations"}
    x64 = torch.zeros_like(rhs64)
    x64 += xh.double()
    x64 += xl.double()
    del rp, xh, xl, state, sv
    torch.cuda.empty_cache()

    # the float64 check: the refined solution under the float64 operator
    s64 = pkg.make_solver(tree, pkg.MGConfig(operator="ahelmholtz",
                                             dtype=torch.float64))
    s64.set_bc(0, pkg.BCType.DIRICHLET, 0.0)
    st6 = s64.allocate()
    s64.set_interior(st6, top, "phi", x64)
    for d in range(3):
        s64.set_coefficient(st6, eps64[d], d)
    with torch.no_grad():
        r = s64._apply_op(st6, top, s64._lam(lam))[dk._ISL]
        worst = float((rhs64 - r).abs().max())
    del st6, s64, r
    torch.cuda.empty_cache()
    bound = 1e-9 * norms[0]
    emit({"refined_vcoeff": {
        "model": "solve_refined(ahelmholtz 512^3 float32 inner solver, "
                 "lam 0.31, eps = 3 float64 fields 0.5 + U[0,1), "
                 "n_outer=10), Dirichlet 0",
        "norms": norms, "norms_timed_run": norms_t,
        "contraction_factors": [a / b for a, b in zip(norms, norms[1:])],
        "ms_per_outer": 1e3 * dt / n_outer,
        "first_solve_s": first_s, "setup_s": setup_s,
        "timed_solve_s": dt + setup_s,
        "outer_pieces_device_ms": pieces,
        "residual_df32_vcoeff_bound": res_bound,
        "launches_in_solve": launches,
        "float64_worst_residual": worst, "float64_bound": bound,
        "peak_memory_bytes": peak}})
    if not worst <= bound:
        fail(f"refined vcoeff: float64 residual {worst} above {bound}")


def refined_vcoeff_periodic(pkg, df, n=32, n_outer=10):
    """ahelmholtz refined solve on an n^3 grid periodic in y and z
    (Dirichlet 0 in x), float32 inner solver, lam 0.31, coefficients
    0.5 + U[0,1): on the CPU, and on the card eagerly and with CUDA
    graphs.  The outer residual is plain PyTorch on every device and
    reads the periodic pads of x and of the coefficient pairs, which the
    card's kernels never write.  Checks: the graphs keep the eager bits;
    card and CPU reach one float64-class solution (1e-9 of max|x|; each
    lies ~1e-12 from it, a residual of another operator misses by far
    more); the card's solution under a float64 ahelmholtz solver's
    operator (CPU) leaves at most 1e-9 of the first norm."""
    lam, bound = 0.31, 1e-9
    rng = np.random.default_rng(9)
    rhs64 = rng.normal(size=(n,) * 3)
    eps64 = [0.5 + rng.random((n,) * 3) for _ in range(3)]
    rh, rl = df.split_f64(rhs64)
    periodic = [False, True, True]
    tree = pkg.build_rectangle(3, np.full(3, n), 8, np.full(3, 1.0 / n),
                               np.zeros(3), periodic)
    runs = {}
    for dev, mode in (("cpu", "split"), ("cuda", "split"), ("cuda", "fused")):
        sv = pkg.make_solver(tree, pkg.MGConfig(
            operator="ahelmholtz", dtype=torch.float32, device=dev,
            fmg_mode=mode))
        sv.set_bc(0, pkg.BCType.DIRICHLET, 0.0)
        xh, xl, norms, _ = pkg.solve_refined(sv, sv.allocate(), rh, rl,
                                             n_outer=n_outer, lam=lam,
                                             eps=eps64)
        check_refined_history(norms, f"periodic refined vcoeff {dev} {mode}")
        runs[f"{dev}_{mode}"] = (xh.cpu(), xl.cpu(), norms)
    (ah, al, an), (bh, bl, bn) = runs["cuda_split"], runs["cuda_fused"]
    if an != bn or not (torch.equal(ah, bh) and torch.equal(al, bl)):
        fail(f"periodic refined vcoeff: the graphs left other bits than the "
             f"eager outers: norms {bn} against {an}")
    x = {k: (h.double() + l.double()).numpy() for k, (h, l, _) in
         runs.items()}
    scale = float(np.abs(x["cpu_split"]).max())
    diff = float(np.abs(x["cuda_split"] - x["cpu_split"]).max()) / scale
    s64 = pkg.make_solver(tree, pkg.MGConfig(operator="ahelmholtz",
                                             dtype=torch.float64,
                                             device="cpu"))
    s64.set_bc(0, pkg.BCType.DIRICHLET, 0.0)
    st6 = s64.allocate()
    top = s64.levels[-1]
    s64.set_interior(st6, top, "phi", x["cuda_split"])
    for d in range(3):
        s64.set_coefficient(st6, eps64[d], d)
    with torch.no_grad():
        r = s64._apply_op(st6, top, s64._lam(lam))[s64._isl].numpy()
    first = runs["cuda_split"][2][0]
    worst = float(np.abs(rhs64 - r).max())
    row = {"dims": [n] * 3, "periodic": periodic, "lam": lam,
           "norms_cuda": runs["cuda_split"][2],
           "norms_cpu": runs["cpu_split"][2],
           "x_max_rel_diff_card_cpu": diff, "bound": bound,
           "float64_worst_residual": worst,
           "float64_bound": bound * first}
    if not diff <= bound:
        fail(f"periodic refined vcoeff: card and CPU solutions differ by "
             f"{diff} of max|x|")
    if not worst <= bound * first:
        fail(f"periodic refined vcoeff: float64 residual {worst} above "
             f"{bound * first}")
    return row


def fused_vcoeff(pkg):
    """The vhelmholtz solver at 512^3 with graphs and eagerly: three
    zero-guess and three have-guess FMGs, then new coefficients through a
    second ``prepare_coefficient`` (new probed coarse matrix; every graph
    outdated) and three more have-guess FMGs.  phi must keep the eager
    bits after both parts."""
    n, lam = 512, 1.5
    snaps, info = {}, {}
    for mode in ("split", "fused"):
        ps = pkg.PoissonSolver(3, (n,) * 3, 16, operator="vhelmholtz",
                               dtype=torch.float32, fmg_mode=mode)
        ps.set_dirichlet(0.0)
        sv = ps.solver
        st = ps._ensure_state()
        top = sv.levels[-1]
        sv.set_coefficient(st, smooth_eps(sv, 0, torch.float32))
        sv.prepare_coefficient(st)
        g = torch.Generator(device="cuda").manual_seed(7)
        ps.set_rhs(arrays={top: torch.randn((n,) * 3, generator=g,
                                            dtype=torch.float32,
                                            device="cuda")})
        out = []
        for k in range(3):
            sv.fas_fmg(st, lam=lam, have_guess=False, need_res=False)
        for k in range(3):
            sv.fas_fmg(st, lam=lam, have_guess=True, need_res=False)
        out.append(sv.interior(st, top, "phi").clone())
        graphs_first = sum(c is not None for c in sv._graphs.values())
        # new coefficients: 2 - 0.5 cos(...), in the same tensors
        sv.set_coefficient(st, 2.5 - smooth_eps(sv, 0, torch.float32))
        sv.prepare_coefficient(st)
        for k in range(3):
            sv.fas_fmg(st, lam=lam, have_guess=True, need_res=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(4):
            sv.fas_fmg(st, lam=lam, have_guess=True, need_res=False)
        torch.cuda.synchronize()
        info[mode] = {"ms_per_fmg": 1e3 * (time.perf_counter() - t0) / 4,
                      "graphs_before_second_prepare": graphs_first,
                      "graphs_after": sum(c is not None
                                          for c in sv._graphs.values())}
        out.append(sv.interior(st, top, "phi").clone())
        snaps[mode] = out
        del ps, sv, st
        torch.cuda.empty_cache()
    for a, b in zip(snaps["split"], snaps["fused"]):
        if not torch.equal(a, b):
            fail("fused vhelmholtz FMG: a graph replay left other bits "
                 "than the eager cycle")
    if info["fused"]["graphs_before_second_prepare"] != 2 or \
            info["fused"]["graphs_after"] != 1:
        fail(f"fused vhelmholtz FMG: unexpected graph counts {info}")
    return info


# ---------------------------------------------------------------------------
# the dense forest
# ---------------------------------------------------------------------------

def _refine(tm, t, lvl, pred):
    ids = t.lvls[lvl].ids
    pick = [int(b) for b in ids if pred(t.ix[int(b)])]
    tm.add_children_bulk(t, np.array(pick, np.int64))
    tm.set_leaves_parents(t, lvl)
    tm.set_next_level_ids(t, lvl)
    tm.set_neighbors_lvl(t, lvl + 1)


def forest_tree(pkg, tm, kind, base, box):
    """The forests of these checks and of the port's tests, built by
    either package (``pkg`` and its tree module ``tm``, so that the tests
    build the same tree in the JAX package): base cells a side (or an
    (X, Y, Z) extent for "slab"), boxes of ``box`` cells, nb = base //
    box boxes a side, h = (nb + 1) // 2.

    * "L": the JAX package's forest benchmark tree
      (experiments/probe_forest_perf.py:43-50), level 2 over ix0 <= h or
      ix1 <= h (an L over three quarters of the domain), level 3 over
      the corner ix <= h;
    * "two": two disjoint corner patches, ix <= nb/2 and ix > nb/2;
    * "periodic": a fully periodic domain with one corner patch ix <=
      nb/2;
    * "slab": an (X, Y, Z) domain with an L-shaped level 2 over iy <= c
      or iz <= c, c half the boxes of y;
    * "sparse" / "sparse_periodic": two corner patches of a quarter of
      the extent, ix <= nb/4 and ix > nb - nb/4, in a closed or a fully
      periodic domain (at base 256, box 16: 1024 level-2 boxes, 3.1 % of
      the level-2 canvas, so the dense forest's fill gate rejects it;
      the closed one goes to the JAX package's multi-canvas forest, the
      periodic one, whose mean removal that solver refuses, to the boxed
      MGSolver).

    At base 16, box 4 the first three are tests/test_dense_forest.py's
    forests, and "slab" at (64, 16, 16) is its _seg_tree."""
    dims = [base] * 3 if isinstance(base, int) else list(base)
    nb = dims[1] // box
    h = (nb + 1) // 2
    q = nb // 4
    t = pkg.build_rectangle(3, dims, box, [1.0 / n for n in dims], [0] * 3,
                            periodic=[kind in ("periodic",
                                               "sparse_periodic")] * 3)
    if kind == "L":
        _refine(tm, t, 1, lambda ix: ix[0] <= h or ix[1] <= h)
        _refine(tm, t, 2, lambda ix: np.all(ix <= h))
        tm.finalize_amr(t, 3)
        return t
    pick = {"two": lambda ix: np.all(ix <= nb // 2) or np.all(ix > nb // 2),
            "periodic": lambda ix: np.all(ix <= nb // 2),
            "slab": lambda ix: ix[1] <= nb // 2 or ix[2] <= nb // 2,
            "sparse": lambda ix: np.all(ix <= q) or np.all(ix > nb - q),
            "sparse_periodic":
                lambda ix: np.all(ix <= q) or np.all(ix > nb - q)}[kind]
    _refine(tm, t, 1, pick)
    tm.finalize_amr(t, 2)
    return t


def leaf_unknowns(t, box):
    """Leaf cells of the tree (experiments/probe_forest_perf.py:53-55;
    in 2D experiments/probe_dense_amr2d_perf.py's count)."""
    return sum(len(t.lvls[l].leaves)
               for l in range(1, t.highest_lvl + 1)) * box ** t.ndim


def footprint_finite(sv, state, lvl):
    m = torch.as_tensor(sv.footprint_mask(lvl), device="cuda")
    return bool(torch.isfinite(sv.interior(state, lvl, "phi")[m]).all())


class SegTally:
    """Segment launches (attr "_seg_launch") or half-sweeps (attr
    "half_sweep_dense") by entry point and canvas, and how many of them
    ran the new design (the SEG_WIDE / SEG_FACES / HALF_MARCH counter
    moved): a wrap of that function of dense_kernels, in place while the
    object is entered (two counter reads per launch, ~1 us)."""

    def __init__(self, dk, attr="_seg_launch"):
        self.dk, self.n, self.attr = dk, {}, attr

    def __enter__(self):
        dk, orig = self.dk, getattr(self.dk, self.attr)

        def launch(*args, **kw):
            if self.attr == "_seg_launch":
                name, cfg = args[0] + "[segs]", args[1]
                key = SEG_WIDE if args[0] == "pair_sweep_dense" \
                    else SEG_FACES
            else:
                name, cfg, key = self.attr, args[0], HALF_MARCH
            before = dk._LAUNCHES[key]
            out = orig(*args, **kw)
            row = self.n.setdefault(name, {}).setdefault(
                "x".join(map(str, cfg.dims)),
                {"launches": 0, "on_the_new_design": 0})
            row["launches"] += 1
            row["on_the_new_design"] += dk._LAUNCHES[key] - before
            return out

        self.orig = orig
        setattr(dk, self.attr, launch)
        return self

    def __exit__(self, *exc):
        setattr(self.dk, self.attr, self.orig)

    def per(self, n):
        """The tally divided by n (per FMG)."""
        return {k: {c: {f: v / n for f, v in r.items()}
                    for c, r in by.items()} for k, by in self.n.items()}


def phase_forest(pkg, dk, name, tree, box, rhs_top, need, dirichlet,
                 n_have=8, n_timed=8):
    """A forest through ``PoissonSolver(tree=...)`` in float32: one
    zero-guess and ``n_have`` have-guess FMGs through ``solve`` (the
    footprint max-norm residual after each), launches counted over that
    run; then ``n_timed`` have-guess FMGs without the residual and one
    synchronisation at the end, segment launches tallied by canvas
    (SegTally).  Returns (solver, state, launches of the run, launches
    per timed FMG, the emitted record)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base = int(tree.domain_size_lvl[1][0])
    ps = pkg.PoissonSolver(3, (base,) * 3, box, tree=tree,
                           dtype=torch.float32)
    sv = ps.solver
    if not isinstance(sv, pkg.DenseForestMGSolver):
        fail(f"{name}: make_solver gave {type(sv).__name__}")
    if dirichlet:
        ps.set_dirichlet(0.0)
    top = sv.levels[-1]
    ps.set_rhs(arrays={top: rhs_top(sv, top)})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    dk.reset_launch_counts()
    phi, info = ps.solve(rtol=0.0, atol=0.0, max_cycles=1 + n_have)
    launches = dk.launch_counts()
    hist = info["residuals"]
    if tuple(phi.shape) != sv._ishape(top) or not footprint_finite(
            sv, ps.state, top):
        fail(f"{name}: phi has a wrong shape or non-finite footprint values")
    check_fmg_history(hist, name)
    missing = [k for k in need if launches[k] == 0]
    if missing:
        fail(f"{name} launched no kernel for {missing}")
    state = ps.state
    sv.fas_fmg(state, have_guess=True, need_res=False)
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    with SegTally(dk) as tally, SegTally(dk, "half_sweep_dense") as halves:
        t1 = time.perf_counter()
        for _ in range(n_timed):
            sv.fas_fmg(state, have_guess=True, need_res=False)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t1) / n_timed
    per_fmg = {k: v / n_timed for k, v in dk.launch_counts().items() if v}
    n_unk = leaf_unknowns(tree, box)
    rec = {"model": f"PoissonSolver(tree={name} base {base} box {box}, "
                    f"float32), laplacian, "
                    f"{'Dirichlet 0' if dirichlet else 'fully periodic'}",
           "levels": {str(l): {"canvas": list(sv.dims[l]),
                               "fill": sv.geom[l].n_cells
                               / float(np.prod(sv.dims[l])),
                               "path": "seg" if sv._seg_desc(l) is not None
                               else "sequential",
                               "ghost_layers": None if sv._seg_desc(l) is None
                               else len(sv._seg_desc(l)[0].segs)}
                      for l in sv.levels},
           "leaf_unknowns": n_unk, "residuals": hist, "cycles": len(hist),
           "contraction_factors": [a / b for a, b in zip(hist, hist[1:])],
           "setup_s": setup_s, "ms_per_fmg": 1e3 * dt,
           "leaf_unknowns_per_s": n_unk / dt,
           "launches_in_solve": {k: v for k, v in launches.items() if v},
           "launches_per_fmg": per_fmg,
           "seg_launches_per_fmg_by_canvas": tally.per(n_timed),
           "half_launches_per_fmg_by_canvas": halves.per(n_timed),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    return sv, state, launches, per_fmg, rec


def phase_forest_path(pkg, dk, base=256):
    """The slice at full width: the L forest at base 256, box 16 (level 2
    a 512^3 canvas at 75 % fill), Dirichlet 0, laplacian, float32 (the
    JAX package's probe_forest_perf.py set-up), with a seeded normal rhs
    on the top level where the probe puts ones: with ones the float32
    footprint residual reaches its floor within ~100x of the first FMG's
    (88x at base 128 on the CPU), so the 1e-3 convergence check could
    not tell a working cycle from a broken one; the time of an FMG does
    not depend on the values.  Then the kernel rows
    of its segment launches and its correction at the shapes it gives
    them: level 2's canvas with its ghost layers, and the 256^3 -> 512^3
    correction window."""
    box = 16
    from octree_mg_tpu_torch.core import tree as tm
    tree = forest_tree(pkg, tm, "L", base, box)
    g = torch.Generator(device="cuda").manual_seed(11)
    sv, state, launches, per_fmg, rec = phase_forest(
        pkg, dk, "forest_path", tree, box,
        lambda sv, top: torch.randn(sv._ishape(top), generator=g,
                                    dtype=torch.float32, device="cuda"),
        FOREST_PATH_KERNELS, dirichlet=True)
    emit({"forest_path": rec})
    # the timed run: every segment pair on a canvas of 256^3 and up, and
    # every segment apply and residual, ran the new design; the counters
    # agree with the tally
    by = rec["seg_launches_per_fmg_by_canvas"]
    for entry, counter in (("pair_sweep_dense[segs]", SEG_WIDE),
                           ("stencil_apply_dense[segs]", SEG_FACES)):
        rows_ = by.get(entry, {})
        want = {c: r["launches"] for c, r in rows_.items()
                if entry.startswith("stencil") or
                min(int(v) for v in c.split("x")) >= 256}
        got = {c: rows_[c]["on_the_new_design"] for c in want}
        if not want or got != want:
            fail(f"forest_path: {entry} per FMG on the new design {got}, "
                 f"not {want}")
        if sum(r["on_the_new_design"] for r in rows_.values()) != \
                per_fmg.get(counter, 0):
            fail(f"forest_path: {counter} per FMG {per_fmg.get(counter)} "
                 f"disagrees with the tally {rows_}")
    rows = []
    lvl = 2
    cfg = sv._seg_kcfg(lvl)
    descs, planes = sv._seg_data(state, lvl)
    phi, rhs, isl = state["phi"][lvl], state["rhs"][lvl], dk._ISL
    n = int(np.prod(sv.dims[lvl]))
    pb = sum(p.numel() for p in planes) * 4
    shape = list(sv.dims[lvl])
    extra = {"ghost_layers": len(descs.segs), "level": lvl}
    old_fn = old_seg_library(dk)
    designs = {"pair_sweep_dense[segs]": (
        "octree_mg_tpu_torch/csrc/stream_wide.cuh", SEG_WIDE),
        "stencil_apply_dense[segs]": (
        "octree_mg_tpu_torch/csrc/apply_faces.cuh", SEG_FACES)}

    def design(entry, mode, n_pairs):
        """The row's design, its launches, and the old design's time on
        the same inputs (-DOMG_SEGWIDE=0, csrc/stream_kernel.cuh)."""
        src, counter = designs[entry]
        old_ms = time_ms(lambda: old_seg_launch(
            dk, old_fn, cfg, mode, phi, rhs, 0.0, n_pairs, descs, planes), 12)
        return {"design": src,
                "launches_on_the_new_design": launches[counter],
                "launches_per_fmg_on_the_new_design": per_fmg.get(counter, 0),
                "launches_per_fmg_by_canvas": by.get(entry, {}),
                "old_design": "octree_mg_tpu_torch/csrc/stream_kernel.cuh",
                "old_design_ms": old_ms}

    rows.append(timed_row(
        "pair_sweep_dense[segs]",
        lambda: (dk.pair_sweep_dense(cfg, phi, rhs, 0.0, None, 0, n_pairs=2,
                                     segs=descs, seg_planes=planes)[isl],),
        lambda: (dk._seg_pairs_plain(cfg, phi, rhs, 0.0, 0, 2, descs.segs,
                                     planes)[isl],),
        launches["pair_sweep_dense[segs]"],
        per_fmg.get("pair_sweep_dense[segs]", 0), shape,
        *forest_work_model("pair_sweep_dense[segs]", n, 0, pb, 4),
        dict(extra, n_pairs=2, **design("pair_sweep_dense[segs]", 0, 2))))
    rows.append(timed_row(
        "stencil_apply_dense[segs]",
        lambda: (dk.stencil_apply_dense(cfg, phi, rhs, 0.0, None, True,
                                        segs=descs, seg_planes=planes)[isl],),
        lambda: (dk._seg_apply_plain(cfg, phi, rhs, 0.0, True, descs.segs,
                                     planes)[isl],),
        launches["stencil_apply_dense[segs]"],
        per_fmg.get("stencil_apply_dense[segs]", 0), shape,
        *forest_work_model("stencil_apply_dense[segs]", n, 0, pb, 4),
        dict(extra, residual=True,
             **design("stencil_apply_dense[segs]", 2, 0))))
    # the correction of level 2 from level 1: its window is level 1's
    # whole 256^3 canvas with a ring
    X, Y, Z = sv.dims[lvl]
    g = torch.Generator(device="cuda").manual_seed(21)
    sub = torch.randn((Z // 2 + 2, Y // 2 + 2, X // 2 + 2), generator=g,
                      device="cuda")
    cfg_w, cp, wplanes = sv._corr_window(sub)
    fine = phi.clone()
    del state, sv
    torch.cuda.empty_cache()
    n_c = (X // 2) * (Y // 2) * (Z // 2)
    wpb = sum(p.numel() for p in wplanes) * 4
    rows.append(timed_row(
        "prolong_correct_dense[corr_ready]",
        lambda: (dk.prolong_correct_dense(cfg_w, cp, None, fine, wplanes,
                                          corr_ready=True)[isl],),
        lambda: (dk._prolong_correct_plain(cfg_w, cp, None, fine, wplanes,
                                           "corr_ready")[isl],),
        launches["prolong_correct_dense[corr_ready]"],
        per_fmg.get("prolong_correct_dense[corr_ready]", 0), shape,
        *forest_work_model("prolong_correct_dense[corr_ready]", n, n_c,
                           wpb, 4),
        {"window": [X // 2 + 2, Y // 2 + 2, Z // 2 + 2]}, inplace=fine))
    return rows, launches


def half_runner(dk, fn, cfg, phi, rhs, lam, planes, parity, out):
    """A closure that launches one half-sweep of a library (fn: its
    omg_stencil_sweep) into out as the wrapper makes it and returns the
    design the library reports; not counted."""
    import ctypes
    P = dk._params(cfg, lam, planes, parity, 1)
    E = dk._eps_params(cfg, ())
    design = ctypes.c_int(-1)
    args = (dk._dt(cfg), 0, ctypes.byref(P), ctypes.byref(E),
            phi.data_ptr(), rhs.data_ptr(), out.data_ptr(),
            dk.cuda_stream(phi), ctypes.byref(design))

    def run():
        err = fn(*args)
        if err != 0:
            fail(f"half_sweep: launch error {err}")
        return design.value
    return run


def phase_forest_periodic(pkg, dk, base=256):
    """The fully periodic forest at forest_path's base 256, box 16, one
    corner patch: its full periodic levels (256^3 .. 16^3) carry wrap
    segments and run the sequential path (ring writes, assembled face
    planes, ``half_sweep_dense`` between refreshes), the patch the
    segment path.  rhs: seeded normal on the top level (the solver
    removes its mean).  The timed FMGs must run every half-sweep on the
    register march of csrc/stencil_sweep.cu (it takes every launch).
    Then the half-sweep's
    kernel row at level 1's 256^3 canvas with its assembled planes, with
    every sequential canvas beside it (``by_canvas``: 128^3 is the canvas
    of the row before base 256): the wrapper's time, the library's, the
    old design's (-DOMG_HALFAF=0, stream_kernel.cuh's wavefront), the
    bound and the launches per FMG."""
    box = 16
    from octree_mg_tpu_torch.core import tree as tm
    tree = forest_tree(pkg, tm, "periodic", base, box)
    g = torch.Generator(device="cuda").manual_seed(13)
    sv, state, launches, per_fmg, rec = phase_forest(
        pkg, dk, "forest_periodic", tree, box,
        lambda sv, top: torch.randn(sv._ishape(top), generator=g,
                                    dtype=torch.float32, device="cuda"),
        FOREST_PERIODIC_KERNELS, dirichlet=False)
    emit({"forest_periodic": rec})
    by = rec["half_launches_per_fmg_by_canvas"].get("half_sweep_dense", {})
    n_half = per_fmg.get("half_sweep_dense", 0)
    if not n_half or per_fmg.get(HALF_MARCH, 0) != n_half or any(
            r["on_the_new_design"] != r["launches"] for r in by.values()):
        fail(f"forest_periodic: half-sweeps per FMG {n_half}, on the new "
             f"design {per_fmg.get(HALF_MARCH, 0)}, by canvas {by}")
    new_fn = dk._fn("stencil_sweep", "omg_stencil_sweep")
    old_fn = old_library(dk, "-DOMG_HALFAF=0", (
        ("stencil_sweep", "omg_stencil_sweep"),))["omg_stencil_sweep"]
    canvases, isl = [], dk._ISL
    seq = sorted((l for l in sv.levels if sv._seg_desc(l) is None and
                  "x".join(map(str, sv.dims[l])) in by),
                 key=lambda l: -int(np.prod(sv.dims[l])))
    for lvl in seq:
        cfg = sv._kcfgs[lvl]
        ringed, planes, _ = sv._assemble(state, lvl, "phi")
        rhs = state["rhs"][lvl]
        out = torch.empty_like(ringed)
        n = int(np.prod(sv.dims[lvl]))
        nbytes, flops = forest_work_model(
            "half_sweep_dense", n, 0, sum(p.numel() for p in planes) * 4, 4)
        c = "x".join(map(str, sv.dims[lvl]))
        canvases.append({
            "level": lvl, "canvas": list(sv.dims[lvl]),
            "ms": time_ms(lambda: dk.half_sweep_dense(
                cfg, ringed, rhs, 0.0, planes, 0), 12),
            "ms_from_library": time_ms(half_runner(
                dk, new_fn, cfg, ringed, rhs, 0.0, planes, 0, out), 12),
            "old_design_ms": time_ms(half_runner(
                dk, old_fn, cfg, ringed, rhs, 0.0, planes, 0, out), 12),
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                  flops / F32_FLOP_PER_S),
            "launches_per_fmg": by.get(c, {}).get("launches", 0),
            "launches_per_fmg_on_the_new_design": by.get(c, {}).get(
                "on_the_new_design", 0)})
        del ringed, planes, out
    lvl = 1
    cfg = sv._kcfgs[lvl]
    ringed, planes, _ = sv._assemble(state, lvl, "phi")
    rhs = state["rhs"][lvl]
    n = int(np.prod(sv.dims[lvl]))
    top = next(c for c in canvases if c["level"] == lvl)
    row = timed_row(
        "half_sweep_dense",
        lambda: (dk.half_sweep_dense(cfg, ringed, rhs, 0.0, planes, 0)[isl],),
        lambda: (dk._half_plain(cfg, ringed, rhs, 0.0, planes, 0)[isl],),
        launches["half_sweep_dense"], per_fmg.get("half_sweep_dense", 0),
        list(sv.dims[lvl]),
        *forest_work_model("half_sweep_dense", n, 0,
                           sum(p.numel() for p in planes) * 4, 4),
        {"level": lvl, "parity": 0,
         "design": "octree_mg_tpu_torch/csrc/stencil_sweep.cu "
                   "(half_march_kernel)",
         "launches_on_the_new_design": launches[HALF_MARCH],
         "launches_per_fmg_on_the_new_design": per_fmg.get(HALF_MARCH, 0),
         "ms_from_library": top["ms_from_library"],
         "old_design": "octree_mg_tpu_torch/csrc/stream_kernel.cuh (NS = 1, "
                       "-DOMG_HALFAF=0)",
         "old_design_ms": top["old_design_ms"], "by_canvas": canvases})
    del state, sv
    torch.cuda.empty_cache()
    return [row], launches


def phase_set_mode_row(dk, launches_forest, n=512):
    """The set mode (no caller in either package) timed at the main
    path's 256^3 -> 512^3 prolongation."""
    cfg_c, field_c, planes_c = make_case(dk, (n // 2,) * 3, (False,) * 3,
                                         "dirichlet", torch.float32, 98,
                                         nan_pads=False)
    cfg_c.b_const = [0.0] * 6
    phi_c = field_c(cfg_c)
    # random, not zeros: on zeros a kernel that added would pass as set
    g = torch.Generator(device="cuda").manual_seed(23)
    fine = torch.randn(dk.padded_shape((n,) * 3), generator=g,
                       device="cuda")
    isl = dk._ISL
    row = timed_row(
        "prolong_correct_dense[set]",
        lambda: (dk.prolong_correct_dense(cfg_c, phi_c, None, fine, planes_c,
                                          add=False)[isl],),
        lambda: (dk._prolong_correct_plain(cfg_c, phi_c, None, fine,
                                           planes_c, "set")[isl],),
        launches_forest["prolong_correct_dense[set]"], 0, [n] * 3,
        *forest_work_model("prolong_correct_dense[set]", n ** 3,
                           (n // 2) ** 3, 0, 4),
        {"path": "no caller in either package: checked and timed only"},
        inplace=fine)
    del fine, phi_c
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# the boxed solver
# ---------------------------------------------------------------------------

def clone_boxed(state):
    return {"cc": {l: t.clone() for l, t in state["cc"].items()},
            "bc": {l: [p.clone() for p in ps] for l, ps in state["bc"].items()}}


def flat_sweep_bytes(n, nc, ndim, item):
    """Bytes one flat half-sweep must move, counted as ``work_model``
    counts ``half_sweep_dense``: phi's interior and face ghosts read
    (the stencil reads no edge or corner ghost), rhs's interior read,
    phi's interior written (a checkerboard covers every sector)."""
    return item * n * (3 * nc ** ndim + 2 * ndim * nc ** (ndim - 1))


def boxed_poisson(pkg, tree, base, box, dtype):
    """The boxed path's entry with the kernel smoother on."""
    ps = pkg.PoissonSolver(
        3, (base,) * 3, box, tree=tree, periodic=True, dtype=dtype,
        experimental=pkg.MGExperimental(pallas_smoother=True))
    if type(ps.solver) is not pkg.MGSolver:
        fail(f"boxed_path: make_solver gave {type(ps.solver).__name__}")
    return ps


def seed_boxed_rhs(ps, tree, box, dtype):
    """A seeded normal rhs on every box of levels 1 and 2 (the FMG's FAS
    update replaces it on parents; the solver removes its leaf mean)."""
    g = torch.Generator(device="cuda").manual_seed(41)
    ps.set_rhs(arrays={l: torch.randn((len(tree.lvls[l].ids),) + (box,) * 3,
                                      generator=g, dtype=dtype,
                                      device="cuda")
                       for l in (1, 2)})


def check_boxed_phi(phi, sv, tree, box, what):
    want = (len(tree.lvls[sv.levels[-1]].ids),) + (box + 2,) * 3
    if tuple(phi.shape) != want or not bool(torch.isfinite(phi).all()):
        fail(f"{what}: phi has a wrong shape or non-finite values")


def phase_boxed_path(pkg, dk, base=256, box=16, n_have=8, n_timed=8,
                     n_f32=2):
    """The boxed solver at full width, through the normal entry:
    ``PoissonSolver(3, (256,)*3, 16, tree=t, periodic=True)`` on the
    fully periodic sparse tree (two corner patches of a quarter extent:
    4096 level-1 boxes, 1024 level-2 boxes at 3.1 % of the level-2
    canvas; 2.04e7 leaf unknowns), which ``make_solver`` sends to
    ``MGSolver``; laplacian, the flat half-sweep kernel on
    (``MGExperimental(pallas_smoother=True)``).

    First float32: one zero-guess and ``n_f32 - 1`` have-guess FMGs
    through ``solve`` (finite phi of the right shape, the kernel
    launched, the residual below its first; residuals, coarse-loop host
    reads and wall time recorded), and the kernel's row timed on that
    state's level-1 planes ([4096, 18^3]).  With the reference's coarse
    rule (residual 1e-8 of its start, at most 1000 iterations) a fully
    periodic float32 solve does not converge monotonically in either
    package: the coarse loop runs to its cap and the residuals rise and
    fall (tests/test_torch_boxed.py::
    test_float32_periodic_solve_stalls_in_both_packages).  So the
    convergence check runs in float64: one zero-guess and ``n_have``
    have-guess FMGs (residuals must fall monotonically to below 1e-3 of
    the first), launches and coarse-loop host reads counted over that
    run; ``n_timed`` have-guess FMGs without the residual, one sync at
    the end; two FMGs from one state with the kernel and with the
    default torch-ops smoother, which must agree bitwise.  Returns the
    kernel's ``kernels`` row (float32 time, the float64 time beside it)
    and the launches of the float64 solve."""
    from octree_mg_tpu_torch.core import tree as tm
    from octree_mg_tpu_torch.ops import flat_smoother as fs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # float32: the configuration as a user would first run it
    tree = forest_tree(pkg, tm, "sparse_periodic", base, box)
    ps = boxed_poisson(pkg, tree, base, box, torch.float32)
    seed_boxed_rhs(ps, tree, box, torch.float32)
    sv = ps.solver
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    sv.coarse_host_reads = 0
    t1 = time.perf_counter()
    phi, info = ps.solve(rtol=0.0, atol=0.0, max_cycles=n_f32)
    torch.cuda.synchronize()
    s_f32 = time.perf_counter() - t1
    launches_f32 = dk.launch_counts()
    hist32 = info["residuals"]
    check_boxed_phi(phi, sv, tree, box, "boxed_path float32")
    if not (all(np.isfinite(hist32)) and hist32[-1] < hist32[0]):
        fail(f"boxed_path float32: residuals {hist32}")
    if launches_f32["half_sweep_flat"] == 0:
        fail("boxed_path float32 launched no half_sweep_flat")
    rec32 = {"residuals": hist32,
             "monotone": all(b < a for a, b in zip(hist32, hist32[1:])),
             "s_per_fmg": s_f32 / n_f32,
             "coarse_host_reads_per_fmg": sv.coarse_host_reads / n_f32,
             "max_coarse_cycles": sv.cfg.max_coarse_cycles,
             "half_sweep_flat_launches": launches_f32["half_sweep_flat"]}
    lvl = 1
    nc, n = sv.static[lvl]["nc"], sv.static[lvl]["n_boxes"]
    S, idr2 = (nc + 2) ** 3, sv.static[lvl]["idr2"]
    phi32 = ps.state["cc"][lvl][0].reshape(n, S)
    rhs32 = ps.state["cc"][lvl][1].reshape(n, S)
    row = timed_row(
        "half_sweep_flat",
        lambda: (fs.half_sweep_flat(phi32, rhs32, 3, nc, idr2, 0.0, 0),),
        lambda: (fs._half_sweep_flat_plain(phi32, rhs32, 3, nc, idr2, 0.0,
                                           0),),
        0, 0, [n, S], flat_sweep_bytes(n, nc, 3, 4), 11 * n * nc ** 3 // 2,
        {"level": lvl, "parity": 0,
         "state": "the float32 boxed solve's level-1 planes",
         "library_ms_note":
         "no single PyTorch call computes a masked half-sweep"},
        inplace=phi32)
    del phi32, rhs32, phi, ps, sv
    torch.cuda.empty_cache()

    # float64: the convergence check, the clock and the bitwise check
    t0 = time.perf_counter()
    tree = forest_tree(pkg, tm, "sparse_periodic", base, box)
    t_tree = time.perf_counter() - t0
    ps = boxed_poisson(pkg, tree, base, box, torch.float64)
    sv = ps.solver
    t_maps = time.perf_counter() - t0 - t_tree
    seed_boxed_rhs(ps, tree, box, torch.float64)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    dk.reset_launch_counts()
    sv.coarse_host_reads = 0
    phi, info = ps.solve(rtol=0.0, atol=0.0, max_cycles=1 + n_have)
    launches = dk.launch_counts()
    reads_solve = sv.coarse_host_reads
    hist = info["residuals"]
    check_boxed_phi(phi, sv, tree, box, "boxed_path")
    check_fmg_history(hist, "boxed_path")
    missing = [k for k in BOXED_KERNELS if launches[k] == 0]
    if missing:
        fail(f"boxed_path launched no kernel for {missing}")

    state = ps.state
    sv.fas_fmg(state, have_guess=True, need_res=False)
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    sv.coarse_host_reads = 0
    t1 = time.perf_counter()
    for _ in range(n_timed):
        sv.fas_fmg(state, have_guess=True, need_res=False)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t1) / n_timed
    per_fmg = {k: v / n_timed for k, v in dk.launch_counts().items() if v}
    reads_per_fmg = sv.coarse_host_reads / n_timed

    # the kernel against the torch-ops smoother: two FMGs from one state
    other = clone_boxed(state)
    runs = {}
    for use_kernel, st in ((True, state), (False, other)):
        sv.cfg.experimental.pallas_smoother = use_kernel
        res = [float(sv.fas_fmg(st, have_guess=True)[1]) for _ in range(2)]
        runs[use_kernel] = (st, res)
    sv.cfg.experimental.pallas_smoother = True
    same = (runs[True][1] == runs[False][1] and all(
        torch.equal(state["cc"][l], other["cc"][l]) for l in sv.levels))
    del other, runs
    n_unk = leaf_unknowns(tree, box)
    rec = {"model": f"PoissonSolver(3, ({base},)*3, {box}, tree="
                    f"sparse_periodic, periodic=True, "
                    f"pallas_smoother=True) -> make_solver -> "
                    f"{type(sv).__name__}, laplacian",
           "levels": {str(l): {"boxes": sv.static[l]["n_boxes"],
                               "nc": sv.static[l]["nc"]}
                      for l in sv.levels},
           "level2_canvas_fill": len(tree.lvls[2].ids) * box ** 3
           / float((2 * base) ** 3),
           "leaf_unknowns": n_unk,
           "float32": rec32,
           "float64": {
               "residuals": hist, "cycles": len(hist),
               "contraction_factors": [a / b for a, b in zip(hist, hist[1:])],
               "setup_s": {"tree": t_tree, "maps_and_solver": t_maps,
                           "allocation_and_rhs": setup_s - t_tree - t_maps,
                           "total": setup_s},
               "ms_per_fmg": 1e3 * dt, "leaf_unknowns_per_s": n_unk / dt,
               "launches_in_solve": {k: v for k, v in launches.items() if v},
               "launches_per_fmg": per_fmg,
               "coarse_host_reads_in_solve": reads_solve,
               "coarse_host_reads_per_fmg": reads_per_fmg,
               "kernel_vs_torch_ops_smoother_bitwise": same},
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit({"boxed_path": rec})
    if not same:
        fail("boxed_path: the flat half-sweep kernel and the torch-ops "
             "smoother gave different FMGs")

    # the float64 time at the same shape, on the float64 state's planes
    phi64 = state["cc"][lvl][0].reshape(n, S)
    rhs64 = state["cc"][lvl][1].reshape(n, S)
    row.update({
        "launches": launches["half_sweep_flat"],
        "launches_per_fmg": per_fmg.get("half_sweep_flat", 0),
        "launches_path": "the float64 solve (the float32 solve: "
                         f"{launches_f32['half_sweep_flat']})",
        "ms_float64": time_ms(lambda: fs.half_sweep_flat(
            phi64, rhs64, 3, nc, idr2, 0.0, 0), 12),
        "bound_ms_float64": 1e3 * flat_sweep_bytes(n, nc, 3, 8)
        / HBM_BYTES_PER_S})
    del state, sv, ps, phi64, rhs64
    torch.cuda.empty_cache()
    return [row], launches


#: card-against-CPU bounds in float64: phi within AGREE_PHI of max|phi|,
#: each residual within AGREE_RES relative (a residual is the cancelled
#: difference rhs - A(phi) of O(1) terms, so a 1e-16 perturbation of phi
#: shows at 1e-16/|residual| relative)
AGREE_PHI, AGREE_RES = 1e-11, 1e-8


def agreement(cuda, cpu, res_scale=None, res_bound=AGREE_RES):
    """One card-against-CPU row from the (phi, residuals) pairs of the two
    devices: phi's max difference over max|phi| (phi an array, or a dict
    of levels: the worst level; residuals None for a table alone), the
    residuals' over each CPU residual, or over ``res_scale`` where given
    (the row then carries the scale and ``res_bound``)."""
    a, b = cuda[0], cpu[0]
    if not isinstance(b, dict):
        a, b = {0: a}, {0: b}
    phi_d = max(np.abs(np.asarray(a[l]) - np.asarray(b[l])).max()
                / max(np.abs(np.asarray(b[l])).max(), 1e-300) for l in b)
    row = {"phi_max_rel_diff": float(phi_d), "residual_max_rel_diff": 0.0}
    if cpu[1] is not None:
        rd, rc = np.asarray(cuda[1], float), np.asarray(cpu[1], float)
        scale = (np.maximum(np.abs(rc), 1e-300) if res_scale is None
                 else res_scale)
        row.update(residual_max_rel_diff=float(np.max(np.abs(rd - rc)
                                                      / scale)),
                   residuals_cuda=rd.tolist(), residuals_cpu=rc.tolist())
    if res_scale is not None:
        row.update(residual_scale=float(res_scale), residual_bound=res_bound)
    return row


def check_agreement(rows, what):
    """Fail on the first row outside AGREE_PHI or its residual bound."""
    for k, r in rows.items():
        if not (r["phi_max_rel_diff"] < AGREE_PHI
                and r["residual_max_rel_diff"]
                < r.get("residual_bound", AGREE_RES)):
            fail(f"{what}: card and CPU disagree ({k}): {r}")


def boxed_cpu_agreement(pkg, base=32, box=4):
    """The sparse periodic tree at base 32, box 4, float64, the kernel
    smoother on, two FMGs on the card and on the CPU (plain versions)."""
    from octree_mg_tpu_torch.core import tree as tm
    rng = np.random.default_rng(19)
    out = {}
    for dev in ("cuda", "cpu"):
        t = forest_tree(pkg, tm, "sparse_periodic", base, box)
        ps = pkg.PoissonSolver(
            3, (base,) * 3, box, tree=t, periodic=True, dtype=torch.float64,
            device=dev, experimental=pkg.MGExperimental(pallas_smoother=True))
        if dev == "cuda":
            rhs = {l: rng.normal(size=(len(t.lvls[l].ids),) + (box,) * 3)
                   for l in (1, 2)}
        ps.set_rhs(arrays=rhs)
        phi, info = ps.solve(rtol=0.0, max_cycles=2)
        out[dev] = (phi.cpu().numpy(), info["residuals"])
    return agreement(out["cuda"], out["cpu"])


def forest_cpu_agreement(pkg, kinds=("L", "periodic")):
    """The 32^3-base L forest and the periodic forest, float64, three
    FMGs on the card and on the CPU (plain versions), footprint cells."""
    from octree_mg_tpu_torch.core import tree as tm
    out = {}
    rng = np.random.default_rng(17)
    for kind in kinds:
        pair = {}
        for dev in ("cuda", "cpu"):
            t = forest_tree(pkg, tm, kind, 32, 8)
            ps = pkg.PoissonSolver(3, (32,) * 3, 8, tree=t,
                                   dtype=torch.float64, device=dev)
            sv = ps.solver
            if kind == "L":
                ps.set_dirichlet(0.25)
            top = sv.levels[-1]
            if dev == "cuda":
                rhs = rng.normal(size=sv._ishape(top))
            ps.set_rhs(arrays={top: rhs})
            phi, info = ps.solve(rtol=0.0, max_cycles=3)
            pair[dev] = (np.where(sv.footprint_mask(top),
                                  phi.cpu().numpy(), 0.0), info["residuals"])
        out[f"forest_{kind}"] = agreement(pair["cuda"], pair["cpu"])
    return out


def phase_cpu_agreement(pkg, df):
    """64^3 float64, three FMGs, on the card and on the CPU.  The stencil
    arithmetic is identical on both; the two matrix-vector products of
    the direct coarse solve sum in another order in cuBLAS than on the
    CPU, which perturbs the coarse correction at the 1e-16 relative level
    and is then carried through the cycle.  Bounds: phi within 1e-11 of
    max|phi|; each residual within 1e-8 relative (a residual is the
    cancelled difference rhs - A(phi) of O(1) terms, so a 1e-16
    perturbation of phi shows at 1e-16/|residual| relative)."""
    n = 64
    rng = np.random.default_rng(3)
    rhs = rng.normal(size=(n, n, n))
    rows = {}
    for op, lam in (("laplacian", 0.0), ("ahelmholtz", 1.5)):
        out = {}
        for dev in ("cuda", "cpu"):
            ps = pkg.PoissonSolver(3, (n,) * 3, 16, dtype=torch.float64,
                                   device=dev, operator=op)
            ps.set_dirichlet(0.0)
            sv = ps.solver
            st = ps._ensure_state()
            x = sv.cell_centers(sv.levels[-1])
            for d in range(sv.n_eps):
                sv.set_coefficient(st, 1.0 + 0.5 * np.cos(
                    2 * np.pi * (x[..., d] + 0.1 * d)), d)
            sv.prepare_coefficient(st)
            ps.set_rhs(arrays={sv.levels[-1]: rhs})
            phi, info = ps.solve(lam=lam, rtol=0.0, max_cycles=3)
            out[dev] = (phi.cpu().numpy(), info["residuals"])
        rows[op] = agreement(out["cuda"], out["cpu"])
    rows.update(forest_cpu_agreement(pkg))
    rows["boxed"] = boxed_cpu_agreement(pkg)
    rows["sharded"] = sharded_cpu_agreement(pkg)
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    rows.update(drivers_cpu_agreement(pkg, dk))
    emit({"cpu_agreement": {
        "dims": [n] * 3, "dtype": "float64", "fmgs": 3,
        "bound": AGREE_PHI, "residual_bound": AGREE_RES,
        "reason": "identical stencil arithmetic; cuBLAS and CPU BLAS sum "
                  "the coarse solve's matrix-vector products in different "
                  "orders", **rows,
        "refined_vcoeff_periodic": refined_vcoeff_periodic(pkg, df)}})
    check_agreement(rows, "cpu_agreement")


# ---------------------------------------------------------------------------
# the z-slab solver (ShardedDenseMGSolver, ShardedRefinedPoisson)
# ---------------------------------------------------------------------------

def dense_pair(pkg, n, k, periodic=False, dtype=torch.float32,
               operator="laplacian", device="cuda"):
    """(DenseMGSolver, ShardedDenseMGSolver over k slabs) of the
    PoissonSolver tree of n^3 cells (box 16, or 8 below 64^3), Dirichlet 0
    or fully periodic."""
    dsz = np.full(3, n)
    tree = pkg.build_rectangle(3, dsz, 16 if n >= 64 else 8, 1.0 / dsz,
                               np.zeros(3), [periodic] * 3)
    mk = dict(operator=operator, dtype=dtype, device=device)
    return (pkg.DenseMGSolver(tree, pkg.MGConfig(**mk)),
            pkg.ShardedDenseMGSolver(tree, pkg.MGConfig(**mk), n_shards=k))


def seeded_state(sv, rhs, eps=()):
    """A state with rhs (and the coefficients eps) on the top level."""
    st = sv.allocate()
    for d, e in enumerate(eps):
        sv.set_coefficient(st, e, d)
    if eps:
        sv.prepare_coefficient(st)
    sv.set_interior(st, sv.levels[-1], "rhs", rhs)
    return st


def run_fmgs(sv, st, n, lam=0.0):
    """One zero-guess and n - 1 have-guess FMGs; the residual history."""
    hist = []
    for i in range(n):
        st, r = sv.fas_fmg(st, lam=lam, have_guess=i > 0)
        hist.append(float(r))
    return hist


def timed_fmgs(sv, st, n, lam=0.0):
    """ms per have-guess FMG (need_res False) over n in a row, one sync
    at the end, after a warm one; the launches per FMG."""
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    sv.fas_fmg(st, lam=lam, have_guess=True, need_res=False)
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(n):
        sv.fas_fmg(st, lam=lam, have_guess=True, need_res=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return 1e3 * dt / n, {k: v / n for k, v in dk.launch_counts().items()
                          if v}


def slab_launches_by_slab(dk, sv, st, lam=0.0):
    """The slab double pairs, applies and residuals by slab (an edge strip
    by its own extent), and the slab prolongations by coarse slab, of one
    have-guess FMG (need_res False), untimed: dense_kernels'
    pair_sweep_dense, stencil_apply_dense and prolong_correct_dense
    wrapped for its length.  {"name[z_gates]": {"XxYxZ": launches}}
    (``name[n_eps=k][z_gates]`` for coefficients)."""
    by, orig = {}, {}

    def wrap(name, f):
        def run(cfg, *args, **kw):
            if kw.get("z_gates") is not None:
                # the prolongation has no coefficient variant
                row = by.setdefault(dk.slab_name(
                    name, 0 if name == "prolong_correct_dense"
                    else cfg.n_eps), {})
                key = "x".join(map(str, cfg.dims))
                row[key] = row.get(key, 0) + 1
            return f(cfg, *args, **kw)
        return run

    try:
        for name in ("pair_sweep_dense", "stencil_apply_dense",
                     "prolong_correct_dense"):
            orig[name] = getattr(dk, name)
            setattr(dk, name, wrap(name, orig[name]))
        sv.fas_fmg(st, lam=lam, have_guess=True, need_res=False)
    finally:
        for name, f in orig.items():
            setattr(dk, name, f)
    return by


def sharded_vs_single(sd, st_d, hist_d, ss, st_s, hist_s, what):
    """The slab solver against the single-device one on the same card:
    the largest difference of the top level's phi (with its place, z y
    x) and of the residual histories; phi must agree to 1e-5 of
    max|phi| (the bound of __graft_entry__.dryrun_multichip)."""
    top = sd.levels[-1]
    a, b = sd.interior(st_d, top, "phi"), ss.interior(st_s, top, "phi")
    if not bool(torch.isfinite(b).all()):
        fail(f"{what}: non-finite phi")
    d = (a - b).abs()
    diff, scale = float(d.max()), float(a.abs().max())
    place = np.unravel_index(int(d.argmax()), tuple(a.shape))
    out = {"phi_max_abs_diff": diff, "phi_max_abs": scale,
           "phi_diff_bound": 1e-5 * scale,
           "phi_diff_place_zyx": [int(v) for v in place] if diff else None,
           "residual_max_abs_diff": max(abs(x - y)
                                        for x, y in zip(hist_d, hist_s)),
           "residual_max_rel_diff": max(abs(x - y) / abs(x)
                                        for x, y in zip(hist_d, hist_s)),
           "bitwise": bool(torch.equal(a, b)) and hist_d == hist_s,
           "residuals_single": hist_d, "residuals_sharded": hist_s}
    if not diff <= 1e-5 * scale:
        fail(f"{what}: sharded and single-device phi differ by {diff} at "
             f"{out['phi_diff_place_zyx']} (bound {1e-5 * scale})")
    return out


def phase_sharded_path(pkg, dk):
    """The main path's problem (512^3, box 16, Dirichlet 0, laplacian,
    float32, the seeded rhs of main_path) through ShardedDenseMGSolver
    over 8 slabs (levels 512..32 sharded, Zl 64..4; 16 replicated; 8 the
    direct coarse level): one zero-guess and eight have-guess FMGs
    against the single-device solver's, then eight timed have-guess
    FMGs of each, the stage breakdown of one FMG of each, and two FMGs
    with overlap_halo off, which must be bitwise those with it on."""
    n, K, n_have, n_timed = 512, 8, 8, 8
    torch.cuda.empty_cache()
    sd, ss = dense_pair(pkg, n, K)
    g = torch.Generator(device="cuda").manual_seed(0)
    rhs = torch.randn((n,) * 3, generator=g, dtype=torch.float32,
                      device="cuda")
    st_d = seeded_state(sd, rhs)
    hist_d = run_fmgs(sd, st_d, 1 + n_have)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    st_s = seeded_state(ss, rhs)
    dk.reset_launch_counts()
    hist_s = run_fmgs(ss, st_s, 1 + n_have)
    launches = dk.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    check_fmg_history(hist_s, "sharded path")
    missing = [k for k in SHARDED_KERNELS if launches[k] == 0]
    if missing:
        fail(f"sharded path launched no kernel for {missing}")
    cmp = sharded_vs_single(sd, st_d, hist_d, ss, st_s, hist_s,
                            "sharded path")
    ms_single, per_single = timed_fmgs(sd, st_d, n_timed)
    ms, per_fmg = timed_fmgs(ss, st_s, n_timed)
    # a have-guess FMG runs 16 slab applies and residuals on the 512^2 x 64
    # slabs and 40 on the 256^2 x 32 ones, which the face-plane apply takes
    # (smaller slabs keep stream_kernel.cuh), and every slab prolongation
    # on the pair kernel
    pro = dk.slab_name("prolong_correct_dense")
    if per_fmg.get(SLAB_FACES, 0) != 16 + 40:
        fail(f"sharded path: {per_fmg.get(SLAB_FACES, 0)} slab applies and "
             "residuals per FMG on the face-plane apply, not the 56 on the "
             "512^2 x 64 and 256^2 x 32 slabs")
    if not 0 < per_fmg.get(SLAB_PAIR, 0) == per_fmg.get(pro, 0):
        fail(f"sharded path: {per_fmg.get(SLAB_PAIR, 0)} of "
             f"{per_fmg.get(pro, 0)} slab prolongations per FMG on the pair "
             "kernel")
    slab_by = slab_launches_by_slab(dk, ss, st_s)
    for entry, by in slab_by.items():
        if sum(by.values()) != per_fmg.get(entry, 0):
            fail(f"sharded path: {entry} by slab {by} disagrees with the "
                 f"{per_fmg.get(entry, 0)} per timed FMG")
    stages = {"sharded": fmg_stage_marks(ss, st_s),
              "single": fmg_stage_marks(sd, st_d)}
    # a have-guess FMG runs 2 (d + 1) overlapped pair groups on the level
    # d below the top, each of 8 whole-slab launches and 16 edge strips:
    # the whole slabs of 512^3 (2 groups) and 256^3 (4) run the wide
    # design, the strips and the smaller levels' slabs do not
    wide_want = K * (2 + 4)
    if per_fmg.get(SLAB_WIDE, 0) != wide_want:
        fail(f"sharded path: {per_fmg.get(SLAB_WIDE, 0)} slab double pairs "
             f"per FMG on the wide design, not the {wide_want} whole slabs "
             "of the 512^3 and 256^3 levels")
    del st_d, sd
    torch.cuda.empty_cache()
    # overlap_halo off against on, from one rhs, two FMGs each
    off = pkg.ShardedDenseMGSolver(
        ss.tree, dataclasses.replace(ss.cfg, overlap_halo=False), n_shards=K)
    st_on, st_off = seeded_state(ss, rhs), seeded_state(off, rhs)
    h_on, h_off = run_fmgs(ss, st_on, 2), run_fmgs(off, st_off, 2)
    same = h_on == h_off and all(
        torch.equal(ss.interior(st_on, l, "phi"),
                    off.interior(st_off, l, "phi")) for l in ss.levels)
    if not same:
        fail(f"sharded path: overlap_halo on and off differ ({h_on} vs "
             f"{h_off})")
    unknowns = float(sum(int(np.prod(ss.dims[l])) for l in ss.levels))
    emit({"sharded_path": {
        "model": "ShardedDenseMGSolver(build_rectangle(3, (512,)*3, 16), "
                 "float32, n_shards=8), Dirichlet 0, main_path's rhs",
        "levels": [list(ss.dims[l]) for l in ss.levels],
        "sharded": {str(l): ss.sharded[l] for l in ss.levels},
        "slab_planes": {str(l): ss._zl(l) for l in ss.levels
                        if ss.sharded[l]},
        "residuals": hist_s, "cycles": len(hist_s),
        "ms_per_fmg": ms, "unknowns_per_s": unknowns / (1e-3 * ms),
        "single_device_ms_per_fmg": ms_single,
        "launches_in_solve": launches, "launches_per_fmg": per_fmg,
        "single_device_launches_per_fmg": per_single,
        "stages": stages, "vs_single_device": cmp,
        "wide_slab_pairs_per_fmg": per_fmg.get(SLAB_WIDE, 0),
        "slab_launches_per_fmg_by_slab": slab_by,
        "overlap_halo_off_bitwise": same,
        "peak_memory_bytes": peak}})
    del st_s, st_on, st_off, off
    torch.cuda.empty_cache()
    return launches, per_fmg, slab_by


def phase_sharded_periodic(pkg, dk):
    """Fully periodic 128^3 over 8 slabs (the wrap exchange and the
    periodic-z pad reads), three FMGs, sharded against single."""
    n, K = 128, 8
    sd, ss = dense_pair(pkg, n, K, periodic=True)
    g = torch.Generator(device="cuda").manual_seed(4)
    rhs = torch.randn((n,) * 3, generator=g, dtype=torch.float32,
                      device="cuda")
    st_d, st_s = seeded_state(sd, rhs), seeded_state(ss, rhs)
    hist_d = run_fmgs(sd, st_d, 3)
    dk.reset_launch_counts()
    hist_s = run_fmgs(ss, st_s, 3)
    launches = dk.launch_counts()
    missing = [k for k in SHARDED_KERNELS if launches[k] == 0]
    if missing:
        fail(f"sharded periodic launched no kernel for {missing}")
    emit({"sharded_periodic": {
        "model": "ShardedDenseMGSolver(build_rectangle(3, (128,)*3, 16, "
                 "periodic), float32, n_shards=8)",
        "vs_single_device": sharded_vs_single(sd, st_d, hist_d, ss, st_s,
                                              hist_s, "sharded periodic"),
        "launches": {k: v for k, v in launches.items() if v}}})


def phase_sharded_refined(pkg, dk, df):
    """ShardedRefinedPoisson at 512^3 over 8 slabs, n_outer=10, the
    refined path's float64 rhs: norms against the single-device
    RefinedPoisson's (each within 1e-5 relative), ms per outer of a timed
    solve after a warm one."""
    n, K, n_outer = 512, 8, 10
    torch.cuda.empty_cache()
    sd, ss = dense_pair(pkg, n, K)
    rh, rl = df.split_f64(seeded_rhs64(n, 1))
    rp_d = pkg.RefinedPoisson(sd)
    _, _, norms_d, _ = rp_d.solve(sd.allocate(), rh, rl, n_outer=n_outer)
    del rp_d
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rp = pkg.ShardedRefinedPoisson(ss)
    st = ss.allocate()
    dk.reset_launch_counts()
    _, _, norms, _ = rp.solve(st, rh, rl, n_outer=n_outer)
    launches = dk.launch_counts()
    check_refined_history(norms, "sharded refined")
    want = (n_outer + 1) * K
    if launches["residual_df32_dense[z_gates]"] != want or \
            launches[DF32_SLAB_MARCH] != want:
        fail(f"sharded refined: the slab residual kernel ran "
             f"{launches['residual_df32_dense[z_gates]']} times, "
             f"{launches[DF32_SLAB_MARCH]} on the z-march, expected {want}")
    rel = [abs(a - b) / b for a, b in zip(norms, norms_d)]
    if not max(rel) <= 1e-5:
        fail(f"sharded refined: norms {norms} against single {norms_d}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, norms_t, _ = rp.solve(st, rh, rl, n_outer=n_outer)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    emit({"sharded_refined": {
        "model": "ShardedRefinedPoisson(ShardedDenseMGSolver(512^3, box 16, "
                 "float32, n_shards=8)).solve(float64 rhs, n_outer=10)",
        "norms": norms, "norms_single_device": norms_d,
        "norm_max_rel_diff": max(rel), "norms_timed_run": norms_t,
        "ms_per_outer": 1e3 * dt / n_outer,
        "launches_in_solve": {k: v for k, v in launches.items() if v},
        "peak_memory_bytes": torch.cuda.max_memory_allocated() - base}})
    del rp, st, ss, sd
    torch.cuda.empty_cache()
    return launches


def phase_sharded_vcoeff(pkg, dk):
    """vhelmholtz (lam 1.5, the coefficients of vcoeff_path) at 512^3 over
    8 slabs (levels 512 .. 32 sharded, Zl 64 .. 4), three FMGs, sharded
    against single (bitwise: Dirichlet faces); four timed have-guess FMGs,
    whose every coefficient slab double pair, apply and residual must run
    its face-plane design (csrc/stream_faces.cuh, csrc/apply_faces.cuh
    with SLAB = 1), those on the 512^2 x 64 and 256^2 x 32 slabs included
    (by slab from one more, untimed FMG)."""
    n, K, lam = 512, 8, 1.5
    torch.cuda.empty_cache()
    sd, ss = dense_pair(pkg, n, K, operator="vhelmholtz")
    g = torch.Generator(device="cuda").manual_seed(5)
    rhs = torch.randn((n,) * 3, generator=g, dtype=torch.float32,
                      device="cuda")
    eps = (smooth_eps(sd, 0, torch.float32),)
    st_d = seeded_state(sd, rhs, eps)
    hist_d = run_fmgs(sd, st_d, 3, lam)
    dk.reset_launch_counts()
    st_s = seeded_state(ss, rhs, eps)
    hist_s = run_fmgs(ss, st_s, 3, lam)
    launches = dk.launch_counts()
    missing = [k for k in SLAB_EPS_VARIANTS + SLAB_VARIANTS[2:3]
               if launches[k] == 0]
    if missing:
        fail(f"sharded vcoeff launched no kernel for {missing}")
    cmp = sharded_vs_single(sd, st_d, hist_d, ss, st_s, hist_s,
                            "sharded vcoeff")
    if not cmp["bitwise"]:
        fail("sharded vcoeff: not bitwise the single-device solver")
    del st_d, sd
    torch.cuda.empty_cache()
    ms, per_fmg = timed_fmgs(ss, st_s, 4, lam)
    slab_by = slab_launches_by_slab(dk, ss, st_s, lam)
    faces = {}
    for base in ("pair_sweep_dense", "stencil_apply_dense"):
        entry = dk.slab_name(base, 1)
        by = slab_by.get(entry, {})
        if sum(by.values()) != per_fmg.get(entry, 0) or not all(
                by.get(k) for k in ("512x512x64", "256x256x32")):
            fail(f"sharded vcoeff: {entry} by slab {by} disagrees with the "
                 f"{per_fmg.get(entry, 0)} per timed FMG or misses the "
                 "512^2 x 64 and 256^2 x 32 slabs")
        # every double pair, and every apply and residual on a slab the
        # rule takes, on the face-plane design
        want = sum(v for k, v in by.items() if base == "pair_sweep_dense"
                   or slab_eps_apply_takes(tuple(map(int, k.split("x")))))
        faces[entry + "[faces]"] = per_fmg.get(entry + "[faces]", 0)
        if faces[entry + "[faces]"] != want:
            fail(f"sharded vcoeff: {faces[entry + '[faces]']} {entry} per "
                 f"timed FMG on the face-plane design, not the {want} its "
                 f"rule takes (by slab {by})")
    emit({"sharded_vcoeff": {
        "model": "ShardedDenseMGSolver(512^3, box 16, vhelmholtz, float32, "
                 "n_shards=8), lam 1.5, eps 1 + 0.5 cos(2 pi (x + 0.1 d))",
        "levels": [list(ss.dims[l]) for l in ss.levels],
        "slab_planes": {str(l): ss._zl(l) for l in ss.levels
                        if ss.sharded[l]},
        "vs_single_device": cmp,
        "ms_per_fmg": ms,
        "launches_per_fmg": per_fmg,
        "face_plane_launches_per_fmg": faces,
        "slab_launches_per_fmg_by_slab": slab_by,
        "launches": {k: v for k, v in launches.items() if v}}})
    del st_s, ss
    torch.cuda.empty_cache()
    return launches, per_fmg, slab_by


def sharded_cpu_agreement(pkg, n=32, k=8):
    """32^3 over 8 slabs, float64, three FMGs on the card and on the CPU
    (plain versions)."""
    rhs = torch.from_numpy(np.random.default_rng(23).normal(size=(n,) * 3))
    out = {}
    for dev in ("cuda", "cpu"):
        _, ss = dense_pair(pkg, n, k, dtype=torch.float64, device=dev)
        st = seeded_state(ss, rhs)
        res = run_fmgs(ss, st, 3)
        out[dev] = (ss.interior(st, ss.levels[-1], "phi").cpu().numpy(), res)
    return agreement(out["cuda"], out["cpu"])


def slab_work_model(name, zl, xy, item, halo, n_eps=0):
    """(bytes, flops) of a slab kernel call on a slab of zl planes of xy
    cells: every input read once, its halo planes (the pad planes the
    kernel reads, ``halo`` each side) included, every output written
    once; the operations of the core cells only (the redundant halo
    sweeps are not needed work).  The prolongation: zl, xy the coarse
    slab's."""
    n = zl * xy
    if name.startswith("prolong_correct_dense"):
        # phi_c, iold_c with their ring planes; the fine slab read and
        # written
        return ((2 * (zl + 2 * halo) * xy + 2 * 8 * n) * item, 40 * n)
    if name.startswith("residual_df32_dense"):
        return ((2 * (zl + 2 * halo) + 3 * zl) * xy * item, 87 * n)
    wide = (zl + 2 * halo) * xy * item
    if name.startswith("pair_sweep_dense"):
        nbytes, flops = 2 * wide + n * item, (100 if n_eps else 22) * n
    else:
        nbytes, flops = wide + 2 * n * item, (50 if n_eps else 15) * n
    return nbytes + n_eps * wide, flops


#: the slab kernels timed level by level (slab_level_times): (kind, entry
#: point, n_eps, design as shipped, the old design's build flag)
SLAB_LEVEL_ROWS = (
    ("residual", "stencil_apply_dense", 0,
     "octree_mg_tpu_torch/csrc/apply_faces.cuh (SLAB = 1)", "-DOMG_SLABAP=0"),
    ("prolong", "prolong_correct_dense", 0,
     "octree_mg_tpu_torch/csrc/prolong_correct.cu (prolong_pair_kernel)",
     "-DOMG_SLABAP=0"),
    ("pairs", "pair_sweep_dense", 1,
     "octree_mg_tpu_torch/csrc/stream_faces.cuh (SLAB = 1)",
     "-DOMG_SLABEPS=0"),
    ("residual", "stencil_apply_dense", 1,
     "octree_mg_tpu_torch/csrc/apply_faces.cuh (SLAB = 1)",
     "-DOMG_SLABEPS=0"))


def slab_level_times(dk, slab_by, eps_by, n=512, K=8):
    """Rows 5z, 7z, 1ze and 5ze level by level: the residual (n_eps 0
    and 1) on an interior slab of each sharded level (512^2 x 64 .. 32^2
    x 4, gates off), the prolongation from each coarse slab (256^2 x 32
    .. 32^2 x 4), the coefficient double pair (two pairs, n_eps 1) on the
    slabs and on the 4-plane edge strips of the overlapped levels (512^2
    .. 64^2); float32, Dirichlet 0 (lam 0; the coefficient rows lam 1.5,
    coefficients 0.5 + U[0,1)): as shipped (``design``: the row's new
    design where its rule takes the slab) and on the old design
    (old_slab_library) on the same inputs, each launched straight from
    its library (as experiments/probe_torch_kernels.py does), median ms
    (CUDA events), bound, launches per have-guess FMG of sharded_path
    (slab_by) or, for n_eps 1, sharded_vcoeff (eps_by; both from
    slab_launches_by_slab); the two designs must agree bitwise.  Returns
    {row name: extra} for the ``kernels`` rows."""
    old = {flag: old_slab_library(dk, flag)
           for flag in {r[4] for r in SLAB_LEVEL_ROWS}}
    slabs = [(m, m, m // K) for m in (n, n // 2, n // 4, n // 8, n // 16)]
    out = {}
    for kind, base, n_eps, design, flag in SLAB_LEVEL_ROWS:
        pro = kind == "prolong"
        entry = dk.slab_name(base, n_eps)
        sym = "omg_prolong_slab" if pro else "omg_stencil_slab"
        new_fn = dk._fn("prolong_correct" if pro else "stencil_sweep", sym)
        dims_list = slabs[1:] if pro else slabs
        if kind == "pairs":
            dims_list = dims_list + [(m, m, 4) for m, _, z in slabs if z >= 8]
        lam = 1.5 if n_eps else 0.0
        by = (eps_by if n_eps else slab_by).get(entry, {})
        rows = []
        for dims in dims_list:
            cfg, field, planes = slab_case(
                dk, dims, (False,) * 3, "dirichlet", torch.float32,
                90 + dims[0] + dims[2] + n_eps, (False, False), n_eps=n_eps)
            cfg.b_const = [0.0] * 6          # the sharded path's faces
            phi, rhs = field(), field()
            eps = tuple(field(coef=True) for _ in range(n_eps))
            iold = field() if pro else None
            if pro:
                X, Y, Z = dims
                f0 = torch.randn(dk.padded_shape((2 * X, 2 * Y, 2 * Z)),
                                 dtype=torch.float32, device="cuda")
                outs = {"new": f0.clone(), "old": f0.clone()}
                del f0
            else:
                outs = {"new": torch.empty_like(phi),
                        "old": torch.empty_like(phi)}
            runs = {t: slab_runner(dk, fn, kind, cfg, phi, rhs, lam, planes,
                                   (False, False), iold, outs[t], eps)
                    for t, fn in (("new", new_fn), ("old", old[flag][sym]))}
            got = {t: r() for t, r in runs.items()}
            torch.cuda.synchronize()
            want = (3 if pro else 2 if kind == "pairs" else
                    2 if (slab_eps_apply_takes(dims) if n_eps else
                          slab_faces_takes(dims, torch.float32)) else 0)
            if got != {"new": want, "old": 0}:
                fail(f"{entry} on {dims}: designs {got}, not new {want}, "
                     "old 0")
            if not torch.equal(outs["new"][dk._ISL], outs["old"][dk._ISL]):
                fail(f"{entry} on {dims}: the new design and the old one "
                     "differ")
            ms = {t: time_ms(r, 12) for t, r in runs.items()}
            nbytes, flops = slab_work_model(entry, dims[2], dims[0] * dims[1],
                                            4, 4 if kind == "pairs" else 1,
                                            n_eps)
            rows.append({"slab": list(dims), "ms": ms["new"],
                         "design": "new" if want else "old",
                         "old_design_ms": ms["old"],
                         "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                               flops / F32_FLOP_PER_S),
                         "launches_per_fmg": by.get(
                             "x".join(map(str, dims)), 0)})
            del phi, rhs, eps, iold, outs, runs
            torch.cuda.empty_cache()
        # the row's "ms" goes through the wrapper, whose host work before
        # the launch the events see on a kernel this short (0.175 against
        # 0.102 ms launched straight from the library for the 512^2 x 64
        # residual on an H100); ms_direct and old_design_ms launch
        # straight from the libraries
        out[entry] = {"design": design,
                      "counter": entry + ("[pair]" if pro else "[faces]"),
                      "old_design": flag, "ms_direct": rows[0]["ms"],
                      "old_design_ms": rows[0]["old_design_ms"],
                      "levels": rows}
    return out


def phase_slab_kernel_times(dk, df, path, refined, vcoeff):
    """The slab variants at the shape of an interior slab of the 512^3
    sharded level (8 slabs: 64 planes; the prolongation's coarse slab 32
    planes of 256^2), both gates off, float32, Dirichlet 0: each against
    its plain version (0 required), kernel and plain ms, bound.  path:
    (launches in the sharded solve, per have-guess FMG); refined:
    launches of the sharded refined solve; vcoeff: (launches of the
    vhelmholtz slab path, per FMG, by slab)."""
    n, K, dtype = 512, 8, torch.float32
    zl, gates, isl = n // K, (False, False), dk._ISL
    rows = []

    def case(dims, n_eps=0, equal_pow2=False, seed=70):
        cfg, field, planes = slab_case(dk, dims, (False,) * 3, "dirichlet",
                                       dtype, seed, gates, n_eps=n_eps,
                                       equal_pow2=equal_pow2)
        cfg.b_const = [0.0] * 6          # the sharded path's faces
        return cfg, field, planes

    launches, per_fmg, slab_by = path
    levels = slab_level_times(dk, slab_by, vcoeff[2])
    for n_eps in (0, 1):
        cfg, field, planes = case((n, n, zl), n_eps, seed=70 + n_eps)
        phi, rhs = field(), field()
        eps = tuple(field(coef=True) for _ in range(n_eps))
        src = (launches, per_fmg) if not n_eps else vcoeff
        for base, halo in (("pair_sweep_dense", 4),
                           ("stencil_apply_dense", 1)):
            name = dk.slab_name(base, n_eps)
            if base == "pair_sweep_dense":
                kern = lambda: (dk.pair_sweep_dense(
                    cfg, phi, rhs, 0.0, planes, 0, n_pairs=2, eps=eps,
                    z_gates=gates)[isl],)
                plain = lambda: (dk._pairs_plain(
                    cfg, phi, rhs, 0.0, planes, 0, 2, eps, gates)[isl],)
            else:
                kern = lambda: (dk.stencil_apply_dense(
                    cfg, phi, rhs, 0.0, planes, True, eps=eps,
                    z_gates=gates)[isl],)
                plain = lambda: (dk._apply_plain(
                    cfg, phi, rhs, 0.0, planes, True, eps, gates)[isl],)
            nbytes, flops = slab_work_model(name, zl, n * n, 4, halo, n_eps)
            wide = ({"design": "octree_mg_tpu_torch/csrc/stream_wide.cuh",
                     "launches_on_the_wide_design": launches[SLAB_WIDE],
                     "launches_per_fmg_on_the_wide_design":
                         per_fmg.get(SLAB_WIDE, 0.0)}
                    if name == SLAB_WIDE.rsplit("[", 1)[0] else levels[name])
            rows.append(timed_row(name, kern, plain, src[0][name],
                                  src[1].get(name, 0.0), (n, n, zl),
                                  nbytes, flops, extra=wide))
        del phi, rhs, eps
        torch.cuda.empty_cache()
    # the prolongation: coarse slab of the 256^3 level into the 512^3 one
    cfg_c, field_c, planes_c = case((n // 2, n // 2, zl // 2), seed=72)
    phi_c, iold_c = field_c(), field_c()
    phi_f = torch.randn(dk.padded_shape((n, n, zl)), dtype=dtype,
                        device="cuda")
    name = dk.slab_name("prolong_correct_dense")
    nbytes, flops = slab_work_model(name, zl // 2, (n // 2) ** 2, 4, 1)
    rows.append(timed_row(
        name,
        lambda: (dk.prolong_correct_dense(cfg_c, phi_c, iold_c, phi_f,
                                          planes_c, z_gates=gates)[isl],),
        lambda: (dk._prolong_correct_plain(cfg_c, phi_c, iold_c, phi_f,
                                           planes_c, "add", gates)[isl],),
        launches[name], per_fmg.get(name, 0.0), (n, n, zl), nbytes, flops,
        extra=levels[name], inplace=phi_f))
    del phi_c, iold_c, phi_f
    # the double-float residual of the refined outer
    cfg, field, _ = case((n, n, zl), equal_pow2=True, seed=73)
    xhi, rhi = field(), field()
    xlo, rlo = field() * 2.0 ** -25, field() * 2.0 ** -25
    r_out = torch.empty_like(xhi)
    kw = dict(cbs=df._cb_pairs(cfg), z_gates=gates)
    name = dk.slab_name("residual_df32_dense")
    nbytes, flops = slab_work_model(name, zl, n * n, 4, 1)
    rows.append(timed_row(
        name,
        lambda: (df.residual_df32_dense(cfg, xhi, xlo, rhi, rlo, out=r_out,
                                        **kw)[isl],),
        lambda: (df.residual_df32(cfg, xhi, xlo, rhi, rlo, **kw)[isl],),
        refined[name], None, (n, n, zl), nbytes, flops,
        extra={"launches_per_outer": refined[name] / 11.0,
               **df32_design(dk, df, cfg, xhi, xlo, rhi, rlo, kw["cbs"],
                             refined, gates)}))
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the dense-patch AMR solver (DenseAMRMGSolver)
# ---------------------------------------------------------------------------

def amr_thinnest_z(X, Y, sms):
    """The thinnest even z extents of an X x Y level on which the wide
    design takes the float32 double pair and the float32 down-leg
    (``wide_takes``, csrc/stream_wide.cuh: 64 x 32 tiles, 8-plane chunks
    for two blocks per SM, 64-plane chunks for four)."""
    tiles = -(-X // 64) * -(-Y // 32)
    zp = next(z for z in range(2, 1 << 14, 2) if tiles * -(-z // 8) >= 2 * sms)
    zd = next(z for z in range(2, 1 << 14, 2)
              if tiles * -(-z // 64) >= 4 * sms)
    return zp, zd


def amr_case_list(dk, cfg, field, planes, lam, kinds):
    """(name, kernel call, plain call) of the entry points in ``kinds``
    on one "amr" level: the pair (1 and 2 pairs), apply and residual,
    down-leg (1 and 2 pairs) and residual-restriction, restriction, one
    half-sweep (both parities), and with cfg.n_eps the coefficient
    variants."""
    phi, rhs = field(cfg), field(cfg)
    isl = dk._ISL
    out = []

    def inner(*ts):
        return tuple(t[isl] for t in ts if t is not None)

    if cfg.n_eps:
        return eps_variants(dk, cfg, field, planes, lam,
                            eps_fields(dk, cfg, cfg.X + cfg.Z))
    if "pairs" in kinds:
        for k in (1, 2):
            out.append((f"pairs{k}", lambda k=k: inner(dk.pair_sweep_dense(
                cfg, phi, rhs, lam, planes, 0, n_pairs=k)),
                lambda k=k: inner(dk._pairs_plain(cfg, phi, rhs, lam, planes,
                                                  0, k))))
    if "apply" in kinds:
        for res in (False, True):
            out.append(("residual" if res else "apply",
                        lambda res=res: inner(dk.stencil_apply_dense(
                            cfg, phi, rhs, lam, planes, res)),
                        lambda res=res: inner(dk._apply_plain(
                            cfg, phi, rhs, lam, planes, res))))
    if "down" in kinds:
        for k in (1, 2):
            out.append((f"downsweep{k}", lambda k=k: inner(*dk.downsweep_dense(
                cfg, phi, rhs, lam, planes, 0, n_pairs=k)),
                lambda k=k: inner(*dk._down_plain(cfg, phi, rhs, lam, planes,
                                                  0, k))))
        out.append(("residual_restrict",
                    lambda: inner(*dk.residual_restrict_dense(
                        cfg, phi, rhs, lam, planes)),
                    lambda: inner(*dk._down_plain(
                        cfg, phi, rhs, lam, planes, 0, 0)[1:])))
        out.append(("restrict", lambda: inner(dk.restrict_dense(cfg, phi)),
                    lambda: inner(dk._restrict_plain(cfg, phi))))
    if "half" in kinds:
        for par in (0, 1):
            out.append((f"half_sweep{par}",
                        lambda par=par: inner(dk.half_sweep_dense(
                            cfg, phi, rhs, lam, planes, par)),
                        lambda par=par: inner(dk._half_plain(
                            cfg, phi, rhs, lam, planes, par))))
    return out


ALL_AMR_KINDS = ("pairs", "apply", "down", "half")


def amr_checks(dk, pkg, quick=False):
    """The "amr" case kinds (six refinement faces, plane-valued b with
    c2 = -0.25; and the mixed kind beside constant Dirichlet faces)
    against the plain versions, 0 ulp, on the levels the AMR path sends
    each entry point: its 512^3 patches and 256^3 level, small patches
    (amr_cpu_agreement's 32^3 and 16^3, both dtypes), a non-cubic one,
    the thinnest levels on which the wide design takes the double pair
    and the down-leg; the coefficient variants (the face-plane designs)
    on the small ones.  Each row names the design counters its launch
    added to.  Also the region correction of the AMR solver: the
    prolongation kernel's corr_ready mode against ``_prolong_rect`` plus
    the add on the card, on the AMR path's 258^3 window into a 512^3
    patch and on small and non-cubic windows."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    zp, zd = amr_thinnest_z(512, 512, sms)
    f32, f64 = torch.float32, torch.float64
    big = [((512, 512, 512), (f32,), ("amr",), ALL_AMR_KINDS),
           ((256, 256, 256), (f32,), ("amr", "amr_mixed"), ALL_AMR_KINDS),
           ((512, 512, zp), (f32,), ("amr",), ("pairs", "apply")),
           ((512, 512, zd), (f32,), ("amr",), ("down",))]
    small = [((64, 64, 64), (f32, f64), ("amr", "amr_mixed"), ALL_AMR_KINDS),
             ((32, 32, 32), (f32, f64), ("amr", "amr_mixed"), ALL_AMR_KINDS),
             ((16, 16, 16), (f32, f64), ("amr", "amr_mixed"), ALL_AMR_KINDS),
             ((48, 32, 16), (f32, f64), ("amr_mixed",), ALL_AMR_KINDS),
             ((8, 8, 8), (f32, f64), ("amr",), ALL_AMR_KINDS)]
    rows, seed = [], 7000
    for dims, dtypes, bcs, kinds in (small if quick else big + small):
        for dtype in dtypes:
            for bc_kind in bcs:
                for lam in (0.0, 0.3):
                    for n_eps in (0, 1, 3) if max(dims) <= 64 else (0,):
                        seed += 1
                        cfg, field, planes = make_case(
                            dk, dims, (False,) * 3, bc_kind, dtype, seed,
                            n_eps=n_eps)
                        for name, kern, plain in amr_case_list(
                                dk, cfg, field, planes, lam, kinds):
                            before = dk.launch_counts()
                            got = kern()
                            after = dk.launch_counts()
                            want = plain()
                            torch.cuda.synchronize()
                            us = [ulp_diff(a, b) for a, b in zip(got, want)]
                            rows.append({
                                "kernel": f"{name}[amr]", "dims": dims,
                                "dtype": str(dtype)[6:], "bc": bc_kind,
                                "lam": lam,
                                "max_ulp": max(us) if min(us) >= 0 else 1 << 62,
                                "counters": sorted(
                                    k for k in after if after[k] > before[k])})
                            del got, want
                        torch.cuda.empty_cache()
    # the region correction: corr_ready against _prolong_rect + add
    windows = [(18, 18, 18), (10, 34, 18)] if quick else \
        [(258, 258, 258), (18, 18, 18), (10, 34, 18)]
    for dtype in (f32, f64):
        sv = pkg.DenseAMRMGSolver(
            pkg.build_amr_centered(3, 3, np.full(3, 16), 8,
                                   np.full(3, 1.0 / 16)),
            pkg.MGConfig(dtype=dtype))
        g = torch.Generator(device="cuda").manual_seed(seed)
        for win in windows:
            if dtype == f64 and max(win) > 64:
                continue
            sub = torch.randn(win, generator=g, dtype=dtype, device="cuda")
            fine = torch.randn(dk.padded_shape(tuple(2 * (v - 2)
                                                     for v in win[::-1])),
                               generator=g, dtype=dtype, device="cuda")
            want = fine.clone()
            want[dk._ISL] += sv._prolong_rect(sub)
            before = dk.launch_counts()
            got = sv._prolong_add(sub, fine.clone())
            after = dk.launch_counts()
            torch.cuda.synchronize()
            u = ulp_diff(got[dk._ISL], want[dk._ISL])
            rows.append({"kernel": "region_correction[amr]",
                         "window": list(win), "dtype": str(dtype)[6:],
                         "max_ulp": u if u >= 0 else 1 << 62,
                         "counters": sorted(k for k in after
                                            if after[k] > before[k])})
            del sub, fine, want, got
        torch.cuda.empty_cache()
    # each entry point on the design its rule gives: the double pair on
    # the wide design from 256^3 up and on the thinnest level it takes,
    # the float32 down-leg at 512^3 and the thinnest, every
    # residual-restriction on the face-plane apply, every half-sweep on
    # the register march, every coefficient pair (float32), apply,
    # residual and residual-restriction on a face-plane design, every
    # region correction on the corr_ready mode
    def want_counter(r):
        k, d = r["kernel"], r["dims"] if "dims" in r else None
        if k == "region_correction[amr]":
            return "prolong_correct_dense[corr_ready]"
        if "n_eps" in k and not (r["dtype"] == "float64"
                                 and k.split("[")[0] in ("pairs1", "pairs2",
                                                         "downsweep")):
            return "[faces]"
        if k == "pairs2[amr]" and r["dtype"] == "float32" and \
                (min(d) >= 256 or d == (512, 512, zp)):
            return "pair_sweep_dense[wide]"
        if k == "downsweep2[amr]" and r["dtype"] == "float32" and \
                d in ((512, 512, 512), (512, 512, zd)):
            return "downsweep_dense[wide]"
        if k == "residual_restrict[amr]":
            return RR_FACES
        if k.startswith("half_sweep"):
            return "half_sweep_dense[march]"
        return None

    for r in rows:
        w = want_counter(r)
        r["design_as_its_rule_gives"] = w is None or any(
            c.endswith(w) if w == "[faces]" else c == w
            for c in r["counters"])
    return rows, {"thinnest_wide_pair_z": zp, "thinnest_wide_down_z": zd,
                  "sms": sms}


def amr_poisson(pkg, n, box=16, dtype=torch.float32, device="cuda",
                operator="laplacian"):
    """bench.py amr's tree, ``build_amr_centered(3, 3, n^3, box, 1/n)``,
    through ``PoissonSolver``, Dirichlet 0: (PoissonSolver, tree, seconds
    to build the tree)."""
    t0 = time.perf_counter()
    tree = pkg.build_amr_centered(3, 3, np.full(3, n), box,
                                  np.full(3, 1.0 / n))
    build_s = time.perf_counter() - t0
    ps = pkg.PoissonSolver(3, (n,) * 3, box, tree=tree, dtype=dtype,
                           device=device, operator=operator)
    if not isinstance(ps.solver, pkg.DenseAMRMGSolver):
        fail(f"amr: make_solver gave {type(ps.solver).__name__}")
    ps.set_dirichlet(0.0)
    return ps, tree, build_s


#: what amr_path's solve must launch: every entry point of the AMR FMG,
#: the prolongation's corr_ready mode (the region corrections) and the
#: designs its 512^3 levels take
AMR_PATH_KERNELS = ("pair_sweep_dense", "stencil_apply_dense",
                    "downsweep_dense", "residual_restrict_dense",
                    "restrict_dense", "prolong_correct_dense",
                    "prolong_correct_dense[corr_ready]",
                    "pair_sweep_dense[wide]", "downsweep_dense[wide]",
                    RR_FACES)


def amr_fused_check(sv, state, n_fmg=3, n_timed=8, what="amr_path"):
    """``fmg_mode="fused"`` (one CUDA graph per FMG) against the eager
    cycle from one state: ``n_fmg`` have-guess FMGs each way (the first
    fused call runs eagerly, the second captures and replays, the third
    replays), every level's phi compared bitwise; then ms per replayed
    FMG (``what`` names the phase in a failure)."""
    keys = sv._field_keys
    twin = {k: {lvl: t.clone() for lvl, t in state[k].items()} for k in keys}
    twin["bc"] = {lvl: list(p) for lvl, p in state["bc"].items()}
    sv.cfg.fmg_mode = "fused"
    try:
        for _ in range(n_fmg):
            sv.fas_fmg(state, have_guess=True, need_res=False)
        sv.cfg.fmg_mode = "split"
        for _ in range(n_fmg):
            sv.fas_fmg(twin, have_guess=True, need_res=False)
        torch.cuda.synchronize()
        ulps = {str(lvl): ulp_diff(sv.interior(state, lvl, "phi"),
                                   sv.interior(twin, lvl, "phi"))
                for lvl in sv.levels}
        del twin
        torch.cuda.empty_cache()
        sv.cfg.fmg_mode = "fused"
        sv.fas_fmg(state, have_guess=True, need_res=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_timed):
            sv.fas_fmg(state, have_guess=True, need_res=False)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / n_timed
    finally:
        sv.cfg.fmg_mode = "split"
        sv._graphs = {}
        torch.cuda.empty_cache()
    if any(u != 0 for u in ulps.values()):
        fail(f"{what}: fmg_mode='fused' differs from the eager FMG: "
             f"ulps by level {ulps}")
    return {"max_ulp_by_level": ulps, "ms_per_fmg_fused": ms}


def phase_amr_path(pkg, dk, n=512, n_have=8, n_timed=8):
    """The slice at full width: bench.py amr's tree at level-1 size 512,
    box 16 (levels 1, 2 and 3 each 512^3: level 1 the whole domain,
    levels 2 and 3 centred patches with six refinement faces; below them
    the uniform chain 256^3 .. 8^3), laplacian, float32, Dirichlet 0.

    bench.py's problem, ones on the top patch: one zero-guess and
    ``n_have`` have-guess FMGs through ``solve`` (residual history,
    launches, the plain route), then ``n_timed`` have-guess FMGs without
    the residual and one synchronisation (``ms_per_fmg``,
    ``leaf_unknowns_per_s`` as bench.py:289-290 defines it, launches per
    FMG).  Its float32 residual reaches its floor within ~1e2 of the
    first FMG's (a CPU run at level-1 size 64: 4.7e-3), so it is held
    to falling (bench.py's ``r1 <= r0``); the 1e-3 convergence gate runs
    on a seeded normal rhs on the top patch, the same solver from a zero
    guess (the forest paths' choice, phase_forest_path).  Then
    ``fmg_mode="fused"`` against eager, bitwise."""
    box = 16
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ps, tree, build_s = amr_poisson(pkg, n, box)
    sv = ps.solver
    top = sv.levels[-1]
    ps.set_rhs(arrays={top: torch.ones(sv._ishape(top), dtype=torch.float32,
                                       device="cuda")})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    dk.reset_launch_counts()
    dk.reset_plain_route_counts()
    phi, info = ps.solve(rtol=0.0, atol=0.0, max_cycles=1 + n_have)
    launches = dk.launch_counts()
    plain = dk.plain_route_counts()
    hist_ones = info["residuals"]
    if tuple(phi.shape) != sv._ishape(top) or not bool(
            torch.isfinite(phi).all()):
        fail("amr_path: phi has a wrong shape or non-finite values")
    if not (all(np.isfinite(hist_ones)) and hist_ones[-1] < hist_ones[0]):
        fail(f"amr_path: the residual of bench.py's problem did not fall: "
             f"{hist_ones}")
    missing = [k for k in AMR_PATH_KERNELS if launches[k] == 0]
    if missing:
        fail(f"amr_path launched no kernel for {missing}")
    if any(plain.values()):
        fail(f"amr_path: the plain route ran on the laplacian: {plain}")
    state = ps.state
    sv.fas_fmg(state, have_guess=True, need_res=False)
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    t1 = time.perf_counter()
    for _ in range(n_timed):
        sv.fas_fmg(state, have_guess=True, need_res=False)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t1) / n_timed
    per_fmg = {k: v / n_timed for k, v in dk.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    # the convergence gate: a seeded normal rhs on the top patch
    g = torch.Generator(device="cuda").manual_seed(13)
    ps.set_rhs(arrays={top: torch.randn(sv._ishape(top), generator=g,
                                        dtype=torch.float32, device="cuda")})
    phi, info = ps.solve(rtol=0.0, atol=0.0, max_cycles=1 + n_have)
    hist = info["residuals"]
    check_fmg_history(hist, "amr_path")
    del phi
    fused = amr_fused_check(sv, ps.state)
    n_unk = leaf_unknowns(tree, box)
    emit({"amr_path": {
        "model": f"bench.py amr: PoissonSolver(tree=build_amr_centered(3, 3, "
                 f"{n}^3, {box}, 1/{n}), float32), laplacian, Dirichlet 0",
        "levels": {str(lvl): {"dims": list(sv.dims[lvl]),
                              "offset": [int(v) for v in sv.offsets[lvl]],
                              "faces": sv.face_kind[lvl],
                              "whole_region": sv._whole_region(lvl)}
                   for lvl in sv.levels},
        "leaf_unknowns": n_unk, "tree_build_s": build_s,
        "setup_s": setup_s,
        "residuals_ones": hist_ones, "residuals": hist,
        "contraction_factors": [a / b for a, b in zip(hist, hist[1:])],
        "ms_per_fmg": 1e3 * dt, "leaf_unknowns_per_s": n_unk / dt,
        "launches_in_solve": {k: v for k, v in launches.items() if v},
        "plain_route_in_solve": plain,
        "launches_per_fmg": per_fmg,
        "fused_mode": fused,
        "peak_memory_bytes": peak}})
    del ps, sv, state
    torch.cuda.empty_cache()
    return launches, per_fmg


def phase_amr_cpu_agreement(pkg, dk):
    """Small AMR trees (3 levels, level-1 size 16 and 32, box 8) in
    float64 on the card and on the CPU, three FMGs from the same seeded
    rhs on every level, Dirichlet faces from a function: laplacian,
    helmholtz, vhelmholtz and ahelmholtz (the coefficient operators' patch
    levels with refinement faces on the plain route, counted; smooth
    coefficients set on every level and prepared).  Bounds as in
    cpu_agreement (AGREE_PHI on every level, AGREE_RES)."""

    def bc_fn(x):
        return 0.25 + np.sin(3 * x[..., 0]) * np.cos(2 * x[..., 2])

    rows = {}
    for n, op, lam in ((32, "laplacian", 0.0), (32, "helmholtz", 0.9),
                       (32, "vhelmholtz", 1.5), (32, "ahelmholtz", 0.7),
                       (16, "laplacian", 0.0), (16, "ahelmholtz", 0.7)):
        out = {}
        for dev in ("cuda", "cpu"):
            tree = pkg.build_amr_centered(3, 3, np.full(3, n), 8,
                                          np.full(3, 1.0 / n))
            sv = pkg.make_solver(tree, pkg.MGConfig(
                operator=op, dtype=torch.float64, device=dev))
            if not isinstance(sv, pkg.DenseAMRMGSolver):
                fail(f"amr_cpu_agreement: {type(sv).__name__}")
            sv.set_bc(0, pkg.BCType.DIRICHLET, fn=bc_fn)
            st = sv.allocate()
            rng = np.random.default_rng(n)
            for lvl in sv.levels:
                sv.set_interior(st, lvl, "rhs", rng.normal(size=sv._ishape(lvl)))
                x = sv.cell_centers(lvl)
                for d in range(sv.n_eps):
                    sv.set_coefficient(st, 1.0 + 0.5 * np.cos(
                        2 * np.pi * (x[..., d] + 0.1 * d)), d, lvl=lvl)
            if sv.n_eps:
                sv.prepare_coefficient(st)
            dk.reset_plain_route_counts()
            hist = []
            for i in range(3):
                st, r = sv.fas_fmg(st, lam=lam, have_guess=i > 0)
                hist.append(float(r))
            out[dev] = ({lvl: sv.interior(st, lvl, "phi").cpu().numpy()
                         for lvl in sv.levels}, hist,
                        dk.plain_route_counts())
        rows[f"{op}_{n}"] = {
            **agreement(out["cuda"][:2], out["cpu"][:2]),
            "plain_route_cuda": {k: v for k, v in out["cuda"][2].items() if v},
            "plain_route_cpu": {k: v for k, v in out["cpu"][2].items() if v}}
    emit({"amr_cpu_agreement": {
        "tree": "build_amr_centered(3, 3, n^3, 8, 1/n), n 16 and 32",
        "dtype": "float64", "fmgs": 3, "bound": AGREE_PHI,
        "residual_bound": AGREE_RES, **rows}})
    check_agreement(rows, "amr_cpu_agreement")
    for k, r in rows.items():
        if ("vhelmholtz" in k or "ahelmholtz" in k) and \
                r["plain_route_cuda"] != r["plain_route_cpu"]:
            fail(f"amr_cpu_agreement: the plain route differs ({k}): {r}")


def phase_amr_checks(dk, pkg, quick):
    """amr_checks as one ``amr_checks`` line: cases, worst ulp, cases by
    design counter; fails on any ulp or a design its rule does not give."""
    rows, info = amr_checks(dk, pkg, quick)
    by_counter = {}
    for r in rows:
        for c in r["counters"]:
            by_counter[c] = by_counter.get(c, 0) + 1
    bad = [r for r in rows if r["max_ulp"] != 0]
    off = [r for r in rows if not r["design_as_its_rule_gives"]]
    emit({"amr_checks": {"cases": len(rows),
                         "max_ulp": max(r["max_ulp"] for r in rows),
                         "expected_max_ulp": 0, **info,
                         "cases_by_counter": by_counter, "failed": bad[:20],
                         "off_design": off[:20]}})
    if bad:
        fail(f"{len(bad)} amr kernel cases differ from their plain version")
    if off:
        fail(f"{len(off)} amr kernel cases ran another design than their "
             f"rule gives")


def amr_rows(rows, launches, per_fmg):
    """The ``kernels`` rows with the AMR path's launches of their counter
    (the solve's and per timed FMG) where it launched any."""
    for r in rows:
        if launches.get(r["name"], 0):
            r["amr_path_launches"] = launches[r["name"]]
            r["amr_path_launches_per_fmg"] = per_fmg.get(r["name"], 0.0)
    return rows


# ---------------------------------------------------------------------------
# the free-space and diffusion drivers, the coefficient forest
# ---------------------------------------------------------------------------

def _centres(sv, lvl, d, dev):
    """Cell-centre coordinates of dim d on level lvl's grid or canvas
    (offset-aware), float64 on ``dev``."""
    off = getattr(sv, "offsets", {}).get(lvl, np.zeros(3, np.int64))
    n = sv.dims[lvl][d]
    return (float(sv.tree.r_min[d]) + (float(off[d])
            + torch.arange(n, dtype=torch.float64, device=dev) + 0.5)
            * float(sv.tree.dr[lvl][d]))


def _field(sv, lvl, fn, dev):
    """fn(x, y, z) on the level's cells as a float64 [Z, Y, X] tensor
    (coordinates broadcast, never materialized on the host)."""
    x = _centres(sv, lvl, 0, dev).view(1, 1, -1)
    y = _centres(sv, lvl, 1, dev).view(1, -1, 1)
    z = _centres(sv, lvl, 2, dev).view(-1, 1, 1)
    return fn(x, y, z).expand(sv._ishape(lvl))


#: the free-space Gaussian (tests/test_free_space.py): sigma 0.1, centred
FS_SIGMA = 0.1


def fs_rhs(x, y, z):
    r2 = ((x - 0.5) / FS_SIGMA) ** 2 + ((y - 0.5) / FS_SIGMA) ** 2 \
        + ((z - 0.5) / FS_SIGMA) ** 2
    return (-1.0 / (FS_SIGMA ** 3 * np.pi * np.sqrt(np.pi))) * torch.exp(-r2)


def fs_solution(x, y, z):
    """erf(r/sigma)/(4 pi r), its limit at r = 0."""
    r = torch.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
    small = r < np.sqrt(np.finfo(float).eps)
    rs = torch.where(small, 1.0, r)
    val = torch.erf(rs / FS_SIGMA) / (4 * np.pi * rs)
    return torch.where(small, 2.0 / (4 * np.pi * np.sqrt(np.pi) * FS_SIGMA),
                       val)


#: free_space_path's error gate: the port's dense driver on the CPU in
#: float32 (box 16, five solves; experiments/driver_bounds_cpu.py) ends
#: at max|phi - erf(r/s)/(4 pi r)| = 2.156e-3 at 64^3 and 5.444e-4 at
#: 128^3 (3.96x: O(h^2)); at 512^3 that predicts 5.444e-4 / 16 = 3.4e-5,
#: and the gate allows twice that
FS_ERR_BOUND = 2 * 5.444e-4 / 16
#: the stencil entry points of the dense FMG (rows 1, 3, 4, 5, 6, 7)
FS_KERNELS = ("pair_sweep_dense", "downsweep_dense",
              "residual_restrict_dense", "stencil_apply_dense",
              "restrict_dense", "prolong_correct_dense")


def phase_free_space_path(pkg, dk, n=512, box=16, n_solves=5):
    """The free-space driver at full width: the main path's tree
    (build_rectangle n^3, box 16), float32, ``make_free_space(solver)``
    (IGF kernel; FFT level n/2, Hockney grid 2 (n/2 + 2) a side), the
    Gaussian charge of tests/test_free_space.py on the top level.  The
    kernel is built and clocked apart, then ``n_solves`` solves (the
    first ``new_rhs=True``, each with an FMG): seconds per solve, the max
    error against the analytic potential per solve, the residual, the
    launches of the solves, peak memory; then one more ``new_rhs`` solve
    (cuFFT's plans made) and the FFT convolution alone (CUDA events).  Gates: every error finite,
    the last below FS_ERR_BOUND, the first below twice the last (the
    reference test's), and every stencil entry point of the FMG
    launched."""
    from octree_mg_tpu_torch.solve import free_space as fsm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dsz = np.full(3, n)
    sv = pkg.make_solver(pkg.build_rectangle(3, dsz, box, 1.0 / dsz,
                                             np.zeros(3)),
                         pkg.MGConfig(operator="laplacian",
                                      dtype=torch.float32, device="cuda"))
    fs = fsm.make_free_space(sv)
    if not isinstance(fs, fsm.FreeSpacePoisson3DDense):
        fail(f"free_space_path: make_free_space gave {type(fs).__name__}")
    state = sv.allocate()
    top = sv.levels[-1]
    sv.set_interior(state, top, "rhs", _field(sv, top, fs_rhs, "cuda"))
    sol = _field(sv, top, fs_solution, "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    fs.cache = fsm._build_cache(fs.kernel, fs.fft_lvl, fs.nx, fs.dr,
                                sv.device)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t1
    dk.reset_launch_counts()
    solve_ms, errs, res = [], [], []
    for i in range(n_solves):
        t2 = time.perf_counter()
        state, r = fs.solve(state, new_rhs=(i == 0))
        r = float(r)
        solve_ms.append(1e3 * (time.perf_counter() - t2))
        phi = sv.interior(state, top, "phi")
        errs.append(float((phi.double() - sol).abs().max()))
        res.append(r)
    launches = dk.launch_counts()
    # where the first solve's time goes: the same solve again with cuFFT's
    # plans made, and the convolution alone (events, 5 calls)
    t3 = time.perf_counter()
    state, r = fs.solve(state, new_rhs=True)
    float(r)
    warm_ms = 1e3 * (time.perf_counter() - t3)
    X, Y, Z = sv.dims[fs.fft_lvl]
    rho = torch.zeros((Z + 2, Y + 2, X + 2), dtype=torch.float32,
                      device="cuda")
    rho[1:-1, 1:-1, 1:-1] = sv.interior(state, fs.fft_lvl, "rhs")
    conv_ms = time_ms(lambda: fsm._fft_convolve(rho, fs.cache.kernel_hat), 5)
    del rho
    rec = {
        "model": f"make_free_space(DenseMGSolver(build_rectangle({n}^3, box "
                 f"{box}), float32)), kernel igf, Gaussian sigma "
                 f"{FS_SIGMA}",
        "fft_lvl": fs.fft_lvl, "fft_dims": list(sv.dims[fs.fft_lvl]),
        "hockney_grid": [2 * (int(v) + 2) for v in fs.nx[::-1]],
        "kernel_hat_dtype": str(fs.cache.kernel_hat.dtype),
        "kernel_build_s": kernel_s, "setup_s": setup_s,
        "solve_ms": solve_ms, "new_rhs_solve_ms": solve_ms[0],
        "later_solve_ms": solve_ms[1:],
        "new_rhs_solve_again_ms": warm_ms, "fft_convolve_ms": conv_ms,
        "max_err": errs,
        "err_bound": FS_ERR_BOUND, "residuals": res,
        "rhs_scale": float(1.0 / (FS_SIGMA ** 3 * np.pi * np.sqrt(np.pi))),
        "launches_in_solves": {k: v for k, v in launches.items() if v},
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit({"free_space_path": rec})
    if not (all(np.isfinite(errs)) and all(np.isfinite(res))):
        fail(f"free_space_path: non-finite errors or residuals {errs} {res}")
    if not errs[-1] < FS_ERR_BOUND:
        fail(f"free_space_path: error {errs[-1]} above {FS_ERR_BOUND}")
    if not errs[0] < 2 * errs[-1]:
        fail(f"free_space_path: not converged after the first solve {errs}")
    missing = [k for k in FS_KERNELS if launches[k] == 0]
    if missing:
        fail(f"free_space_path launched no kernel for {missing}")
    del fs, sv, state, sol
    torch.cuda.empty_cache()
    return launches


def diffusion_phi0(x, y, z):
    """tests/test_dense_vcoeff.py's initial condition: solution + 2, the
    solution sin(4 pi x) sin(4 pi y) sin(4 pi z) (tests/test_dense.py)."""
    return (torch.sin(4 * np.pi * x) * torch.sin(4 * np.pi * y)
            * torch.sin(4 * np.pi * z) + 2.0)


#: diffusion_path's residual target: the float32 residual floor of this
#: problem (three steps, then six V-cycles, the largest of the last
#: three: the phase's measured_floor) on the CPU was 0.00534 at 32^3,
#: 0.0229 at 64^3 and 0.0892 at 128^3 (experiments/driver_bounds_cpu.py),
#: growing 4.3x and 3.9x per doubling, as h^-2; at 512^3 that predicts
#: 0.0892 * 16 = 1.43, and the target is 4x that
DIFF_MAX_RES = 4 * 0.0892 * 16
#: float32 mass drift bound: the CPU's runs drift by at most 2.7e-7 (128^3,
#: three steps, summed in float64; the same script); the gate allows 1e-5
DIFF_MASS_BOUND = 1e-5


class _CycleLog:
    """Residuals of the solver's FMG and V-cycles as the driver reads
    them (a wrap of the two entry points on the instance, removed on
    exit); the driver reads each residual on the host anyway."""

    def __init__(self, sv):
        self.sv, self.res = sv, []

    def __enter__(self):
        for name in ("fas_fmg", "fas_vcycle"):
            orig = getattr(self.sv, name)

            def wrap(*a, _orig=orig, **k):
                st, r = _orig(*a, **k)
                self.res.append(float(r))
                return st, r
            setattr(self.sv, name, wrap)
        return self

    def __exit__(self, *exc):
        for name in ("fas_fmg", "fas_vcycle"):
            self.sv.__dict__.pop(name, None)


def phase_diffusion_path(pkg, dk, n=512, n_steps=3, dt=0.01):
    """``diffusion_solve_vcoeff``, order 2, on vcoeff_path's problem at
    full width (PoissonSolver(3, (n,)*3, 16, operator="vhelmholtz"),
    float32, eps 1 + 0.5 cos(2 pi (x + 0.1 d)) set and prepared on the
    card) with Neumann-0 walls and phi0 = solution + 2
    (tests/test_dense_vcoeff.py's set-up), ``n_steps`` steps of dt:
    per step ms, cycles and their residuals, the mass drift (summed in
    float64) and the variance ratio; the launches of the path, counted
    from before ``prepare_coefficient`` (the steps' have-guess FMGs
    restrict on the fused down-leg, so row 6 launches only in the
    coefficients' restriction); then six more V-cycles on
    the last step's system (the measured float32 floor).  Gates: each step's
    residual <= DIFF_MAX_RES (the driver raises otherwise), the mass
    within DIFF_MASS_BOUND relative, the variance falling every step,
    every coefficient stencil entry point launched, the plain route
    never."""
    from octree_mg_tpu_torch.solve import diffusion as dfm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ps = pkg.PoissonSolver(3, (n,) * 3, 16 if n >= 64 else 8,
                           operator="vhelmholtz", dtype=torch.float32,
                           device="cuda")
    sv = ps.solver
    ps.set_neumann(0.0)
    state = ps._ensure_state()
    top = sv.levels[-1]
    dk.reset_launch_counts()
    dk.reset_plain_route_counts()
    sv.set_coefficient(state, _field(sv, top, lambda x, y, z: 1.0 + 0.5
                                     * torch.cos(2 * np.pi * x), "cuda"))
    sv.prepare_coefficient(state)
    sv.set_interior(state, top, "phi", _field(sv, top, diffusion_phi0,
                                              "cuda"))
    phi = sv.interior(state, top, "phi")
    mass0 = float(phi.double().sum())
    var0 = float(phi.double().var(unbiased=False))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps, var_prev = [], var0
    for _ in range(n_steps):
        with _CycleLog(sv) as log:
            t1 = time.perf_counter()
            state, r = dfm.diffusion_solve_vcoeff(sv, state, dt, order=2,
                                                  max_res=DIFF_MAX_RES)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t1)
        phi = sv.interior(state, top, "phi")
        mass = float(phi.double().sum())
        var = float(phi.double().var(unbiased=False))
        steps.append({"ms": ms, "cycles": len(log.res),
                      "residuals": log.res, "residual": r,
                      "mass_drift_rel": (mass - mass0) / mass0,
                      "variance_ratio": var / var0,
                      "variance_fell": var < var_prev})
        var_prev = var
    launches = dk.launch_counts()
    plain = dk.plain_route_counts()
    lam = sv._lam(2.0 / dt)
    floor = []
    for _ in range(6):
        state, r = sv.fas_vcycle(state, lam=lam)
        floor.append(float(r))
    rec = {
        "model": f"PoissonSolver(3, ({n},)*3, 16, operator='vhelmholtz', "
                 f"float32), Neumann 0, eps 1 + 0.5 cos(2 pi x), phi0 = "
                 f"solution + 2, diffusion_solve_vcoeff order 2, dt {dt}",
        "max_res": DIFF_MAX_RES, "mass_bound": DIFF_MASS_BOUND,
        "setup_s": setup_s, "steps": steps,
        "ms_per_step": [s["ms"] for s in steps],
        "floor_vcycles": floor, "measured_floor": max(floor[-3:]),
        "launches_in_path": {k: v for k, v in launches.items() if v},
        "plain_route": {k: v for k, v in plain.items() if v},
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit({"diffusion_path": rec})
    for s in steps:
        if not (np.isfinite(s["residual"]) and s["residual"]
                <= DIFF_MAX_RES):
            fail(f"diffusion_path: residual {s['residual']} above "
                 f"{DIFF_MAX_RES}")
        if not abs(s["mass_drift_rel"]) <= DIFF_MASS_BOUND:
            fail(f"diffusion_path: mass drift {s['mass_drift_rel']}")
        if not s["variance_fell"]:
            fail(f"diffusion_path: the variance did not fall {steps}")
    missing = [k for k in vcoeff_kernels(1) if launches[k] == 0]
    if missing:
        fail(f"diffusion_path launched no kernel for {missing}")
    if any(plain.values()):
        fail(f"diffusion_path: the plain route ran on a uniform tree: "
             f"{plain}")
    del ps, sv, state, phi
    torch.cuda.empty_cache()
    return launches


#: the coefficient forest's kernels: the restriction and the
#: prolongation's corr_ready mode (every correction of a forest); its
#: smoothing and applies take the plain route
FOREST_VCOEFF_KERNELS = ("restrict_dense",
                         "prolong_correct_dense[corr_ready]")


def forest_eps(x, y, z):
    """0.5 + a smooth field: 1 + 0.5 cos(2 pi x) sin(2 pi y)."""
    return 1.0 + 0.5 * torch.cos(2 * np.pi * x) * torch.sin(2 * np.pi * y)


def phase_forest_vcoeff(pkg, dk, base=256, box=16, n_have=8, n_timed=3,
                        lam=1.5):
    """forest_path's L tree (chip_smoke.forest_tree: base 256, box 16, a
    512^3 level-2 canvas, 1.195e8 leaf unknowns) under vhelmholtz (n_eps
    1), float32, Dirichlet 0, lam 1.5: eps 1 + 0.5 cos(2 pi x) sin(2 pi
    y) set on every level's canvas and prepared, a seeded normal rhs on
    the top level; one zero-guess and ``n_have`` have-guess FMGs through
    ``solve`` (residual history, launches and plain-route counts), then
    ``n_timed`` timed have-guess FMGs without the residual, each
    synchronized (ms per FMG, launches and plain-route counts per FMG,
    the plain half-sweeps and applies per FMG by canvas); then one plain
    half-sweep, residual and phi ghost assembly on levels 2 and 3
    (CUDA events: the breakdown of an FMG).
    Gates: the residual below 1e-3 of the first (check_fmg_history),
    finite footprint, the restriction and the prolongation's corr_ready
    mode launched (FOREST_VCOEFF_KERNELS), the plain route's half-sweep
    and apply taken."""
    from octree_mg_tpu_torch.core import tree as tm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = forest_tree(pkg, tm, "L", base, box)
    ps = pkg.PoissonSolver(3, (base,) * 3, box, tree=tree,
                           operator="vhelmholtz", dtype=torch.float32,
                           device="cuda")
    sv = ps.solver
    if not isinstance(sv, pkg.DenseForestMGSolver):
        fail(f"forest_vcoeff: make_solver gave {type(sv).__name__}")
    ps.set_dirichlet(0.0)
    state = ps._ensure_state()
    for lvl in sv.levels:
        sv.set_coefficient(state, _field(sv, lvl, forest_eps, "cuda"),
                           lvl=lvl)
    sv.prepare_coefficient(state)
    top = sv.levels[-1]
    g = torch.Generator(device="cuda").manual_seed(23)
    ps.set_rhs(arrays={top: torch.randn(sv._ishape(top), generator=g,
                                        dtype=torch.float32, device="cuda")})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    dk.reset_launch_counts()
    dk.reset_plain_route_counts()
    t1 = time.perf_counter()
    phi, info = ps.solve(lam=lam, rtol=0.0, atol=0.0, max_cycles=1 + n_have)
    solve_s = time.perf_counter() - t1
    launches = dk.launch_counts()
    plain = dk.plain_route_counts()
    hist = info["residuals"]
    m = torch.as_tensor(sv.footprint_mask(top), device="cuda")
    finite = bool(torch.isfinite(sv.interior(ps.state, top, "phi")[m]).all())
    state = ps.state
    dk.reset_launch_counts()
    dk.reset_plain_route_counts()
    ms = []
    with SegTally(dk, "half_sweep_dense") as halves, \
            SegTally(dk, "stencil_apply_dense") as applies:
        for _ in range(n_timed):
            t2 = time.perf_counter()
            sv.fas_fmg(state, lam=lam, have_guess=True, need_res=False)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t2))
    per_fmg = {k: v / n_timed for k, v in dk.launch_counts().items() if v}
    plain_per_fmg = {k: v / n_timed for k, v in
                     dk.plain_route_counts().items() if v}
    by_canvas = {}
    for name, tally in (("half_sweeps", halves), ("applies", applies)):
        for c, r in tally.per(n_timed).get(
                "half_sweep_dense" if name == "half_sweeps"
                else "stencil_apply_dense", {}).items():
            by_canvas.setdefault(c, {})[name + "_per_fmg"] = r["launches"]
    # one plain half-sweep, one plain residual and one ghost assembly
    # of phi per canvas size, CUDA events (the breakdown of an FMG)
    for lvl in (2, 3):
        cfg = sv._kcfgs[lvl]
        canvas, planes, _ = sv._assemble(state, lvl, "phi")
        easm = sv._eps_assemble(state, lvl)
        eps, epl = tuple(a[0] for a in easm), [a[1] for a in easm]
        rhs = state["rhs"][lvl]
        row = by_canvas.setdefault("x".join(map(str, cfg.dims)), {})
        row["half_sweep_ms"] = time_ms(lambda: dk.half_sweep_dense(
            cfg, canvas, rhs, lam, planes, 0, eps=eps,
            eps_planes=epl), 3)
        row["residual_ms"] = time_ms(lambda: dk.stencil_apply_dense(
            cfg, canvas, rhs, lam, planes, True, eps=eps,
            eps_planes=epl), 3)
        row["phi_assembly_ms"] = time_ms(
            lambda: sv._assemble(state, lvl, "phi"), 3)
        del canvas, planes, easm, eps, epl
    n_unk = leaf_unknowns(tree, box)
    rec = {
        "model": f"PoissonSolver(tree=L base {base} box {box}, "
                 f"operator='vhelmholtz', float32), Dirichlet 0, lam {lam}, "
                 f"eps 1 + 0.5 cos(2 pi x) sin(2 pi y)",
        "levels": {str(l): {"canvas": list(sv.dims[l]),
                            "fill": sv.geom[l].n_cells
                            / float(np.prod(sv.dims[l])),
                            "conflicts": sv.conflicts.get(l) is not None}
                   for l in sv.levels},
        "leaf_unknowns": n_unk, "setup_s": setup_s, "solve_s": solve_s,
        "residuals": hist,
        "contraction_factors": [a / b for a, b in zip(hist, hist[1:])],
        "ms_per_fmg": ms, "leaf_unknowns_per_s": n_unk / (min(ms) / 1e3),
        "launches_in_solve": {k: v for k, v in launches.items() if v},
        "plain_route_in_solve": {k: v for k, v in plain.items() if v},
        "launches_per_fmg": per_fmg, "plain_route_per_fmg": plain_per_fmg,
        "plain_route_by_canvas": by_canvas,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit({"forest_vcoeff": rec})
    if not finite:
        fail("forest_vcoeff: non-finite footprint values")
    check_fmg_history(hist, "forest_vcoeff")
    missing = [k for k in FOREST_VCOEFF_KERNELS if launches[k] == 0]
    if missing:
        fail(f"forest_vcoeff launched no kernel for {missing}")
    if not (plain["half_sweep_dense[eps_bc]"]
            and plain["stencil_apply_dense[eps_bc]"]):
        fail(f"forest_vcoeff: the plain route did not run: {plain}")
    del ps, sv, state, phi
    torch.cuda.empty_cache()
    return launches, per_fmg


def _fs_case(pkg, kind, dev):
    """Two solves of a free-space driver at <= 32^3, float64: (top phi,
    residuals)."""
    from octree_mg_tpu_torch.solve import free_space as fsm
    if kind == "boxed":
        dsz = np.full(3, 16)
        sv = pkg.MGSolver(pkg.build_rectangle(3, dsz, 4, 1.0 / dsz,
                                              np.zeros(3)),
                          pkg.MGConfig(operator="laplacian",
                                       dtype=torch.float64, device=dev))
        st = sv.allocate()
        isl = (slice(None),) + (slice(1, -1),) * 3
        for lvl in sv.levels:
            x = torch.from_numpy(sv.cell_centers(lvl)[isl])
            st["cc"][lvl][1][isl] = fs_rhs(x[..., 0], x[..., 1],
                                           x[..., 2]).to(dev)
        fs = fsm.make_free_space(sv)
    else:
        dsz = np.full(3, 32)
        sv = pkg.DenseMGSolver(pkg.build_rectangle(3, dsz, 8, 1.0 / dsz,
                                                   np.zeros(3)),
                               pkg.MGConfig(operator="laplacian",
                                            dtype=torch.float64, device=dev))
        fs = fsm.make_free_space(sv, **({"max_fft_frac": 1.0,
                                         "kernel": "spectral"}
                                        if kind == "spectral" else {}))
        st = sv.allocate()
        top = sv.levels[-1]
        sv.set_interior(st, top, "rhs", _field(sv, top, fs_rhs, dev))
    res = []
    for i in range(1 if kind == "spectral" else 2):
        st, r = fs.solve(st, new_rhs=(i == 0))
        res.append(float(r))
    top = sv.levels[-1]
    phi = (st["cc"][top][0] if kind == "boxed"
           else sv.interior(st, top, "phi"))
    return phi.cpu().numpy(), res


def _diffusion_case(pkg, kind, op, dev):
    """An order-1 then an order-2 step (dt 0.01, max_res 1e-7) of the
    scheme of ``op`` on a 16^3 tree, float64: (top phi, residuals,
    max|rhs| of the last step on the top level)."""
    from octree_mg_tpu_torch.solve import diffusion as dfm
    n = np.full(3, 16)
    cfg = pkg.MGConfig(operator=op, dtype=torch.float64, device=dev)
    if kind == "amr":
        sv = pkg.make_solver(pkg.build_amr_centered(3, 2, n, 8, 1.0 / n),
                             cfg)
    else:
        t = pkg.build_rectangle(3, n, 8, 1.0 / n, np.zeros(3),
                                periodic=[kind == "boxed"] * 3)
        sv = pkg.MGSolver(t, cfg) if kind == "boxed" else pkg.make_solver(
            t, cfg)
    if kind != "boxed":
        sv.set_bc(0, pkg.BCType.NEUMANN, 0.0)
    st = sv.allocate()
    n_eps = {"helmholtz": 0, "vhelmholtz": 1, "ahelmholtz": 3}[op]
    for lvl in sv.levels:
        if kind == "boxed":
            x = torch.from_numpy(sv.cell_centers(lvl))
            st["cc"][lvl][0] = diffusion_phi0(x[..., 0], x[..., 1],
                                              x[..., 2]).to(dev)
            for d in range(n_eps):
                st["cc"][lvl][4 + d] = (1.0 + 0.3 * torch.cos(
                    2 * np.pi * x[..., d])).to(dev)
            continue
        sv.set_interior(st, lvl, "phi", _field(sv, lvl, diffusion_phi0, "cpu"))
        for d in range(n_eps):
            sv.set_interior(st, lvl, f"eps{d}", _field(
                sv, lvl, lambda x, y, z, d=d: 1.0 + 0.3 * torch.cos(
                    2 * np.pi * (x, y, z)[d]), "cpu"))
    if kind == "boxed":
        st = sv.fill_ghost(st, 0)
    fn = {"helmholtz": dfm.diffusion_solve,
          "vhelmholtz": dfm.diffusion_solve_vcoeff,
          "ahelmholtz": dfm.diffusion_solve_acoeff}[op]
    args = (1.0,) if op == "helmholtz" else ()
    res = []
    for order in (1, 2):
        st, r = fn(sv, st, 0.01, *args, order=order, max_res=1e-7)
        res.append(r)
    top = sv.levels[-1]
    phi = st["cc"][top][0] if kind == "boxed" else sv.interior(st, top,
                                                               "phi")
    rhs = st["cc"][top][1] if kind == "boxed" else sv.interior(st, top,
                                                               "rhs")
    return phi.cpu().numpy(), res, float(rhs.abs().max())


def _forest_vcoeff_case(pkg, dk, kind, op, dev):
    """Three FMGs of a coefficient forest at base 32, box 8, float64,
    seeded rhs, smooth eps on every level: (footprint top phi, residuals,
    plain-route counts)."""
    from octree_mg_tpu_torch.core import tree as tm
    t = forest_tree(pkg, tm, kind, 32, 8)
    ps = pkg.PoissonSolver(3, (32,) * 3, 8, tree=t, operator=op,
                           dtype=torch.float64, device=dev)
    sv = ps.solver
    if kind == "L":
        ps.set_dirichlet(0.25)
    st = ps._ensure_state()
    for lvl in sv.levels:
        for d in range(sv.n_eps):
            sv.set_coefficient(st, _field(
                sv, lvl, lambda x, y, z, d=d: 1.0 + 0.5 * torch.cos(
                    2 * np.pi * ((x, y, z)[d] + 0.1 * d)), "cpu"), d, lvl=lvl)
    sv.prepare_coefficient(st)
    top = sv.levels[-1]
    rhs = np.random.default_rng(29).normal(size=sv._ishape(top))
    ps.set_rhs(arrays={top: rhs})
    dk.reset_plain_route_counts()
    phi, info = ps.solve(lam=0.9, rtol=0.0, max_cycles=3)
    return (np.where(sv.footprint_mask(top), phi.cpu().numpy(), 0.0),
            info["residuals"], dict(dk.plain_route_counts()))


#: the diffusion rows' residual bound, relative to the step's rhs scale
#: max|rhs|: the card's readings were 0 to 4.1e-15 of it on an H100
#: (tests/test_torch_diffusion.py holds the port's CPU residuals to the
#: JAX package's at the same bound)
AGREE_RES_RHS = 64 * float(np.finfo(np.float64).eps)


def drivers_cpu_agreement(pkg, dk):
    """Card against CPU, float64, <= 32^3 (bounds as cpu_agreement's:
    AGREE_PHI, AGREE_RES): both free-space drivers (dense igf 32^3 box 8,
    boxed 16^3 box 4; two solves each) and the spectral kernel (its
    table, and the dense driver with the FFT level at the top); every
    diffusion scheme (helmholtz, vhelmholtz, ahelmholtz) and both orders
    on the dense, dense-AMR and boxed solvers (16^3; their residual
    differences relative to the step's rhs scale max|rhs| ~ 2 max|phi| /
    dt, within AGREE_RES_RHS: the residuals sit at the 1e-7 target, ~1e-10
    of the rhs terms they cancel, so the card's 1e-16 perturbation of phi
    from cuBLAS's coarse solve shows at ~1e-5 of the residual itself);
    the ahelmholtz L forest and the periodic vhelmholtz forest (base 32,
    three FMGs; the plain route's counts equal on both devices).  Returns
    the rows."""
    from octree_mg_tpu_torch.solve import free_space as fsm
    devs = ("cuda", "cpu")
    rows = {}
    for kind in ("dense", "boxed", "spectral"):
        rows[f"free_space_{kind}"] = agreement(
            *(_fs_case(pkg, kind, dev) for dev in devs))
    nx, dr = np.array([34, 34, 34]), np.full(3, 1.0 / 32)
    rows["spectral_kernel"] = agreement(*(
        (fsm._green_kernel_hat_spectral(nx, dr, dev)[0].cpu().numpy(), None)
        for dev in devs))
    rows["igf_kernel"] = agreement(*(
        (fsm._green_kernel_hat(nx, dr, dev).cpu().numpy(), None)
        for dev in devs))
    for kind in ("dense", "amr", "boxed"):
        for op in ("helmholtz", "vhelmholtz", "ahelmholtz"):
            a, b = (_diffusion_case(pkg, kind, op, dev) for dev in devs)
            rows[f"diffusion_{kind}_{op}"] = agreement(
                a[:2], b[:2], res_scale=b[2], res_bound=AGREE_RES_RHS)
    for kind, op in (("L", "ahelmholtz"), ("periodic", "vhelmholtz")):
        a, b = (_forest_vcoeff_case(pkg, dk, kind, op, dev) for dev in devs)
        r = agreement(a[:2], b[:2])
        r["plain_route_cuda"] = {k: v for k, v in a[2].items() if v}
        r["plain_route_cpu"] = {k: v for k, v in b[2].items() if v}
        if r["plain_route_cuda"] != r["plain_route_cpu"]:
            fail(f"drivers_cpu_agreement: the plain route differs "
                 f"({kind}): {r}")
        rows[f"forest_vcoeff_{kind}_{op}"] = r
    return rows


def phase_drivers_cpu_agreement(pkg, dk):
    """drivers_cpu_agreement as one line of its own (``--drivers``)."""
    rows = drivers_cpu_agreement(pkg, dk)
    emit({"drivers_cpu_agreement": {"dtype": "float64", "bound": AGREE_PHI,
                                    "residual_bound": AGREE_RES,
                                    "diffusion_residual_bound":
                                        AGREE_RES_RHS, **rows}})
    check_agreement(rows, "drivers_cpu_agreement")


def driver_rows(rows, paths):
    """The ``kernels`` rows with the launches of the driver paths (the
    free-space solves, the diffusion steps, the coefficient forest's
    solve and its timed FMGs) where a path launched the row's counter."""
    for r in rows:
        for key, counts in paths.items():
            if counts.get(r["name"], 0):
                r[key] = counts[r["name"]]
    return rows


# ---------------------------------------------------------------------------
# the multi-canvas forest and the refined forest
# ---------------------------------------------------------------------------

def multiforest_seg_checks(dk, sv):
    """Every distinct (canvas, ghost layers) that the multi-canvas
    forest ``sv`` sends to the segment kernels, float32, random planes,
    NaN pads (seg_wide_checks with the solver's own layer sets): 0 ulp
    against the plain version and the old design; the apply and the
    residual must run the face-plane design, the pair the wide one on
    canvases of 256^3 and up (the rule's reach on these cubes)."""
    shapes = []
    for lvl in sv.levels:
        for u in sv.units_of(lvl):
            desc = sv._seg_desc(u)
            if desc is None:
                continue
            key = (tuple(int(v) for v in sv.dims[u]), tuple(desc[0].segs))
            if key not in shapes:
                shapes.append(key)
    rows = seg_wide_checks(dk, old_seg_library(dk), shapes)
    for r in rows:
        r["want_new"] = not r["kernel"].startswith("pairs") or \
            min(r["dims"]) >= 256
    bad = [r for r in rows if r["max_ulp"] != 0
           or r["new_design"] != r["want_new"]]
    if bad:
        fail(f"multiforest segment checks: {bad[:3]}")
    return rows


def phase_multiforest_path(pkg, dk, base=512, box=16, n_have=8, n_timed=8):
    """The multi-canvas forest at full width: forest_tree "sparse" at base
    512, box 16 (two 8^3-box corner blobs at level 2: one 512^3 level-1
    canvas and two 256^3 level-2 canvases, the level-2 fill 3.1 % of its
    bounding box, 1.64e8 leaf unknowns), through ``make_solver`` (which
    must give DenseMultiForestMGSolver), float32, Dirichlet 0, laplacian,
    a seeded normal rhs on the leaf levels; first the segment checks of
    its unit canvases; one zero-guess and ``n_have`` have-guess FMGs
    (footprint residuals; launches counted over this run), then
    ``n_timed`` have-guess FMGs without the residual and one sync at the
    end (ms per FMG, launches per FMG, segment launches by canvas, peak
    memory of the solves, and of set-up and checks apart).  Gates: the history (check_fmg_history), finite footprints,
    every kernel of FOREST_PATH_KERNELS launched, and every timed segment
    launch on the design its rule gives.  Returns (launches of the run,
    per timed FMG, the check rows)."""
    from octree_mg_tpu_torch.core import tree as tm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = forest_tree(pkg, tm, "sparse", base, box)
    sv = pkg.make_solver(tree, pkg.MGConfig(dtype=torch.float32))
    if not isinstance(sv, pkg.DenseMultiForestMGSolver):
        fail(f"multiforest_path: make_solver gave {type(sv).__name__}")
    sv.set_bc(0, pkg.BCType.DIRICHLET, 0.0)
    state = sv.allocate()
    g = torch.Generator(device="cuda").manual_seed(31)
    for lvl in sv.levels[sv.levels.index(1):]:       # the leaf levels
        for u in sv.units_of(lvl):
            sv.set_interior(state, u, "rhs", torch.randn(
                sv._ishape(u), generator=g, device="cuda"))
    sv._ensure_direct(state)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    checks = multiforest_seg_checks(dk, sv)
    peak_checks = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dk.reset_launch_counts()
    hist = []
    for it in range(1 + n_have):
        state, r = sv.fas_fmg(state, have_guess=it > 0)
        hist.append(float(r))
    launches = dk.launch_counts()
    finite = all(bool(torch.isfinite(sv.interior(state, u, "phi")[
        torch.as_tensor(sv.footprint_mask(u), device="cuda")]).all())
        for u in sv.units_of(sv.levels[-1]))
    sv.fas_fmg(state, have_guess=True, need_res=False)
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    with SegTally(dk) as tally:
        t1 = time.perf_counter()
        for _ in range(n_timed):
            sv.fas_fmg(state, have_guess=True, need_res=False)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t1) / n_timed
    per_fmg = {k: v / n_timed for k, v in dk.launch_counts().items() if v}
    by = tally.per(n_timed)
    n_unk = leaf_unknowns(tree, box)
    rec = {"model": f"make_solver(forest_tree('sparse', base {base}, box "
                    f"{box}), float32), laplacian, Dirichlet 0",
           "solver": type(sv).__name__,
           "levels": {str(l): [{"unit": list(u), "canvas": list(sv.dims[u]),
                                "fill": sv.geom[u].n_cells
                                / float(np.prod(sv.dims[u])),
                                "path": "seg" if sv._seg_desc(u) is not None
                                else "sequential",
                                "ghost_layers": None
                                if sv._seg_desc(u) is None
                                else len(sv._seg_desc(u)[0].segs)}
                               for u in sv.units_of(l)] for l in sv.levels},
           "unit_canvases_per_level": {str(l): len(sv.units_of(l))
                                       for l in sv.levels},
           "leaf_unknowns": n_unk, "residuals": hist, "cycles": len(hist),
           "contraction_factors": [a / b for a, b in zip(hist, hist[1:])],
           "setup_s": setup_s, "ms_per_fmg": 1e3 * dt,
           "leaf_unknowns_per_s": n_unk / dt,
           "launches_in_solve": {k: v for k, v in launches.items() if v},
           "launches_per_fmg": per_fmg,
           "seg_launches_per_fmg_by_canvas": by,
           "seg_checks": {"cases": len(checks),
                          "canvases": sorted({"x".join(map(str, r["dims"]))
                                              for r in checks}),
                          "max_ulp": max(r["max_ulp"] for r in checks),
                          "on_the_rule's_design": sum(
                              r["new_design"] == r["want_new"]
                              for r in checks)},
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "peak_memory_bytes_with_the_checks": peak_checks}
    emit({"multiforest_path": rec})
    if not finite:
        fail("multiforest_path: non-finite footprint values")
    check_fmg_history(hist, "multiforest_path")
    missing = [k for k in FOREST_PATH_KERNELS if launches[k] == 0]
    if missing:
        fail(f"multiforest_path launched no kernel for {missing}")
    for entry, counter in (("pair_sweep_dense[segs]", SEG_WIDE),
                           ("stencil_apply_dense[segs]", SEG_FACES)):
        rows_ = by.get(entry, {})
        want = {c: r["launches"] for c, r in rows_.items()
                if entry.startswith("stencil") or
                min(int(v) for v in c.split("x")) >= 256}
        got = {c: rows_[c]["on_the_new_design"] for c in want}
        if not want or got != want:
            fail(f"multiforest_path: {entry} per FMG on the new design "
                 f"{got}, not {want}")
    del state, sv
    torch.cuda.empty_cache()
    return launches, per_fmg, checks


def phase_refined_forest_path(pkg, dk, df, base=256, box=16, n_outer=8):
    """The refined forest at full width: ``solve_refined`` on forest_path's
    L tree (base 256, box 16: a 256^3 level 1, a 512^3 level-2 canvas with
    a concave corner, a 256^3 level 3), float32 inner forest, Dirichlet 0,
    laplacian, a seeded float64 rhs on every level split by ``split_f64``,
    ``n_outer`` outers with rtol 0 (no host read in the loop) and one sync
    at the end: ms per outer (the closing residual step included in the
    total), the leaf residual history and its contraction per outer,
    launches, peak memory; then the device time of one outer's pieces
    (CUDA events): the eager double-float step (accumulate, restriction,
    residuals; ``RefinedForestPoisson._jit_step``) and the inner FMG.
    Gates (tests/test_refine_forest.py:103-107): norms[-1] <= 1e-9 *
    norms[0], and the float64 leaf residual of x_hi + x_lo, computed on
    the card by an independent float64 DenseForestMGSolver of the port,
    <= 1e-7 * norms[0].  Returns (launches of the solve, per outer)."""
    from octree_mg_tpu_torch.core import tree as tm
    from octree_mg_tpu_torch.solve.refine_forest import RefinedForestPoisson
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tree = forest_tree(pkg, tm, "L", base, box)
    sv = pkg.make_solver(tree, pkg.MGConfig(dtype=torch.float32))
    if type(sv) is not pkg.DenseForestMGSolver:
        fail(f"refined_forest_path: make_solver gave {type(sv).__name__}")
    sv.set_bc(0, pkg.BCType.DIRICHLET, 0.0)
    state = sv.allocate()
    g = torch.Generator(device="cuda").manual_seed(37)
    rhs64 = {lvl: torch.randn(sv._ishape(lvl), generator=g,
                              dtype=torch.float64, device="cuda")
             for lvl in sv.levels}
    rh, rl = {}, {}
    for lvl in sv.levels:
        rh[lvl], rl[lvl] = df.split_f64(rhs64[lvl])
    sv._ensure_direct(state)
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    t0 = time.perf_counter()
    x_pairs, norms, state = pkg.solve_refined(sv, state, rh, rl,
                                              n_outer=n_outer, rtol=0.0)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = dk.launch_counts()
    peak_solve = torch.cuda.max_memory_allocated()
    # one outer's pieces, from the solve's end state
    rp = RefinedForestPoisson(sv)
    X = {lvl: tuple(a.clone() for a in x_pairs[lvl]) for lvl in sv.levels}
    shape = {lvl: sv._pshape(sv.dims[lvl]) for lvl in sv.levels}
    Xp = {}
    for lvl in sv.levels:
        Xp[lvl] = tuple(torch.zeros(shape[lvl], device="cuda")
                        for _ in range(2))
        for a, b in zip(Xp[lvl], X[lvl]):
            a[dk._ISL] = b
    del X
    RH = {lvl: torch.zeros(shape[lvl], device="cuda") for lvl in sv.levels}
    RL = {lvl: torch.zeros(shape[lvl], device="cuda") for lvl in sv.levels}
    for lvl in sv.levels:
        RH[lvl][dk._ISL], RL[lvl][dk._ISL] = rh[lvl], rl[lvl]
    E = {lvl: state["phi"][lvl] for lvl in sv.levels}
    step_ms = [event_ms(lambda: rp._jit_step(Xp, E, RH, RL))
               for _ in range(3)]
    lam = sv._lam(0.0)
    fmg_ms = [event_ms(lambda: sv._fmg(state, lam, False, False))
              for _ in range(3)]
    del Xp, RH, RL, E
    torch.cuda.empty_cache()
    # the float64 leaf residual of x_hi + x_lo on an independent solver
    sv64 = pkg.DenseForestMGSolver(forest_tree(pkg, tm, "L", base, box),
                                   pkg.MGConfig(dtype=torch.float64))
    sv64.set_bc(0, pkg.BCType.DIRICHLET, 0.0)
    st64 = sv64.allocate()
    worst = 0.0
    for lvl in sv64.levels:
        xh, xl = x_pairs[lvl]
        sv64.set_interior(st64, lvl, "phi", xh.double() + xl.double())
        sv64.set_interior(st64, lvl, "rhs", rhs64[lvl])
    for lvl in sv64.levels:
        st64 = sv64._residual(st64, lvl, 0.0)
        r = sv64.interior(st64, lvl, "ires")
        worst = max(worst, float(torch.where(rp.leaf_mask[lvl], r.abs(),
                                             0.0).max()))
    n_unk = leaf_unknowns(tree, box)
    rec = {"model": f"solve_refined(DenseForestMGSolver(forest_tree('L', "
                    f"base {base}, box {box}), float32)), laplacian, "
                    f"Dirichlet 0, seeded float64 rhs on every level",
           "levels": {str(l): {"canvas": list(sv.dims[l]),
                               "conflicts": sv.conflicts.get(l) is not None,
                               "leaf_cells": int(rp.leaf_mask[l].sum())}
                      for l in sv.levels},
           "leaf_unknowns": n_unk, "n_outer": n_outer, "rtol": 0.0,
           "norms": norms,
           "contraction_per_outer": [a / b for a, b in zip(norms, norms[1:])],
           "solve_s": solve_s, "ms_per_outer": 1e3 * solve_s / n_outer,
           "step_device_ms": step_ms, "inner_fmg_device_ms": fmg_ms,
           "f64_leaf_residual": worst,
           "f64_leaf_residual_over_first_norm": worst / norms[0],
           "launches_in_solve": {k: v for k, v in launches.items() if v},
           "launches_per_outer": {k: v / n_outer for k, v in launches.items()
                                  if v},
           "peak_memory_bytes_solve": peak_solve,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit({"refined_forest_path": rec})
    if not all(np.isfinite(norms)) or not norms[-1] <= 1e-9 * norms[0]:
        fail(f"refined_forest_path: norms fell only {norms}")
    if not worst <= 1e-7 * norms[0]:
        fail(f"refined_forest_path: float64 leaf residual {worst} above "
             f"1e-7 of the first norm {norms[0]}")
    missing = [k for k in FOREST_PATH_KERNELS if launches[k] == 0]
    if missing:
        fail(f"refined_forest_path launched no kernel for {missing}")
    del state, sv, sv64, st64, x_pairs, rp
    torch.cuda.empty_cache()
    return launches, {k: v / n_outer for k, v in launches.items() if v}


def _multiforest_case(pkg, op, dev, n=32, box=4):
    """Three FMGs of the multi-canvas forest on forest_tree "sparse" at
    base n, box ``box``, float64, Dirichlet 0.25, a seeded rhs on the leaf
    levels (vhelmholtz: lam 0.4, eps 0.5 + U[0,1) on the leaf units,
    restricted down): ({unit: footprint phi}, residuals)."""
    from octree_mg_tpu_torch.core import tree as tm
    sv = pkg.make_solver(forest_tree(pkg, tm, "sparse", n, box),
                         pkg.MGConfig(operator=op, dtype=torch.float64,
                                      device=dev))
    if not isinstance(sv, pkg.DenseMultiForestMGSolver):
        fail(f"forests_cpu_agreement: make_solver gave {type(sv).__name__}")
    sv.set_bc(0, pkg.BCType.DIRICHLET, 0.25)
    st = sv.allocate()
    rng = np.random.default_rng(41)
    for lvl in sv.levels:
        if lvl < 1:
            continue
        for u in sv.units_of(lvl):
            sv.set_interior(st, u, "rhs", rng.normal(size=sv._ishape(u)))
            for d in range(sv.n_eps):
                sv.set_interior(st, u, f"eps{d}",
                                0.5 + rng.random(sv._ishape(u)))
    if sv.n_eps:
        sv.prepare_coefficient(st)
    lam = 0.4 if sv.n_eps else 0.0
    res = []
    for it in range(3):
        st, r = sv.fas_fmg(st, lam=lam, have_guess=it > 0)
        res.append(float(r))
    top = sv.levels[-1]
    phi = {u: np.where(sv.footprint_mask(u),
                       sv.interior(st, u, "phi").cpu().numpy(), 0.0)
           for u in sv.units_of(top)}
    return phi, res


def _refined_forest_case(pkg, op, lam, n_eps, dev, n_outer=6):
    """solve_refined on the JAX tests' L tree (forest_tree "L" at base 16,
    box 4), float32 inner, a seeded float64 rhs (and eps 0.5 + U[0,1) per
    level): ({lvl: x_hi + x_lo in float64, leaf cells}, norms)."""
    from octree_mg_tpu_torch.core import tree as tm
    sv = pkg.DenseForestMGSolver(forest_tree(pkg, tm, "L", 16, 4),
                                 pkg.MGConfig(operator=op,
                                              dtype=torch.float32,
                                              device=dev))
    sv.set_bc(0, pkg.BCType.DIRICHLET, 0.0)
    rng = np.random.default_rng(43)
    rhs = {l: rng.normal(size=sv._ishape(l)) for l in sv.levels}
    eps = {l: [0.5 + rng.random(sv._ishape(l)) for _ in range(n_eps)]
           for l in sv.levels} if n_eps else None
    from octree_mg_tpu_torch.ops.df32 import split_f64
    rh = {l: split_f64(rhs[l])[0] for l in sv.levels}
    rl = {l: split_f64(rhs[l])[1] for l in sv.levels}
    x, norms, _ = pkg.solve_refined(sv, sv.allocate(), rh, rl,
                                    n_outer=n_outer, lam=lam, eps=eps)
    from octree_mg_tpu_torch.solve.refine_forest import RefinedForestPoisson
    leaf = RefinedForestPoisson(sv, lam=lam, eps=eps).leaf_mask
    return ({l: np.where(leaf[l].cpu().numpy(),
                         x[l][0].double().cpu().numpy()
                         + x[l][1].double().cpu().numpy(), 0.0)
             for l in sv.levels}, norms)


#: card-against-CPU bounds of the refined forest (float32 inner FMGs):
#: the solutions' leaf cells within AGREE_PHI of max|x|, the norms within
#: REFINED_AGREE_NORMS relative while above 1e-6 of the first.  The
#: stencil arithmetic is identical on both; the coarse solve's float32
#: matrix-vector products sum in another order in cuBLAS.  On the CPU, a
#: random perturbation of 32 float32 ulp of every coarse solve moved the
#: six-outer solutions by at most 2.9e-13 of max|x| and the norms by
#: 5.2e-6 relative (laplacian, vhelmholtz, ahelmholtz on this tree)
REFINED_AGREE_NORMS = 1e-4


def forests_cpu_agreement(pkg):
    """Card against CPU at small size: the multi-canvas forest (laplacian
    and vhelmholtz) on forest_tree "sparse" at base 32, box 4, float64,
    three FMGs (bounds AGREE_PHI, AGREE_RES); the refined forest on the L
    tree at base 16, box 4 (laplacian, vhelmholtz lam 0.41 with n_eps 1,
    ahelmholtz lam 0.27 with n_eps 3; float32 inner, six outers): x_hi +
    x_lo within AGREE_PHI of max|x| on leaf cells and the norms within
    REFINED_AGREE_NORMS while above 1e-6 of the first."""
    rows = {}
    for op in ("laplacian", "vhelmholtz"):
        rows[f"multiforest_{op}"] = agreement(
            *(_multiforest_case(pkg, op, dev) for dev in ("cuda", "cpu")))
    for op, lam, n_eps in (("laplacian", 0.0, 0), ("vhelmholtz", 0.41, 1),
                           ("ahelmholtz", 0.27, 3)):
        a, b = (_refined_forest_case(pkg, op, lam, n_eps, dev)
                for dev in ("cuda", "cpu"))
        row = agreement((a[0], None), (b[0], None))
        keep = [i for i, v in enumerate(b[1]) if v > 1e-6 * b[1][0]]
        row.update(norms_cuda=a[1], norms_cpu=b[1],
                   norms_max_rel_diff=max(abs(a[1][i] - b[1][i]) / b[1][i]
                                          for i in keep),
                   norms_bound=REFINED_AGREE_NORMS)
        rows[f"refined_forest_{op}"] = row
    return rows


def phase_forests_cpu_agreement(pkg):
    rows = forests_cpu_agreement(pkg)
    emit({"forests_cpu_agreement": {"bound": AGREE_PHI,
                                    "residual_bound": AGREE_RES, **rows}})
    for k, r in rows.items():
        if k.startswith("refined"):
            if not (r["phi_max_rel_diff"] < AGREE_PHI
                    and r["norms_max_rel_diff"] < REFINED_AGREE_NORMS):
                fail(f"forests_cpu_agreement: card and CPU disagree ({k}): "
                     f"{r}")
        else:
            check_agreement({k: r}, "forests_cpu_agreement")


# ---------------------------------------------------------------------------
# the 2D dense paths (plain torch ops: no kernel of the library)
# ---------------------------------------------------------------------------

#: bc_values of the 2D refined phases (tests/test_df32.py:458)
BVALS_2D = (0.3, 0.0, 0.5, -0.25)
#: card against CPU, 2D: phi within 64 eps of max|phi| on every level,
#: residuals within 1e-9 of the first residual; the refined solve's x
#: within 1e-12 of max|x| and its norms within 1e-4 relative where the
#: CPU norm is above 1e-9 of its first.  Calibrated on the CPU by
#: ``experiments/twod_bounds_cpu.py agreement``: perturbing the direct
#: coarse solve's result by 32 ulp (the card's and the CPU's matrix
#: products differ there and nowhere else) moves phi by at most 55 eps,
#: the residuals by 1.2e-10 of the first (AMR; 1.8e-13 uniform), the
#: refined x by 3.6e-14 and its norms by 3.3e-5
AGREE_2D_PHI = 64 * float(np.finfo(np.float64).eps)
AGREE_2D_RES = 1e-9
AGREE_2D_X, AGREE_2D_NORMS = 1e-12, 1e-4


def check_floor_history(hist, what):
    """A float32 history at full width in 2D: finite, falling at the
    second FMG, and monotone until within 10x of its floor
    (check_fmg_history without its 1e-3 test).  The float32 floor of a
    2D solve rises with n (h^-2 times a solution of size ~h): on the CPU
    (``experiments/twod_bounds_cpu.py floor``) it is 3.3e-4 of the first
    FMG's residual at 256^2, 7.2e-4 at 512^2, 3.2e-3 at 1024^2 and 3.6e-3
    at 2048^2, so the 1e-3 gate runs on a float64 solve of the same
    problem (twod_f64_gate)."""
    if not all(np.isfinite(hist)):
        fail(f"{what}: non-finite residuals {hist}")
    if not hist[1] < hist[0]:
        fail(f"{what}: the residual did not fall: {hist}")
    floor = 10.0 * min(hist)
    for a, b in zip(hist, hist[1:]):
        if a > floor and not b < a:
            fail(f"{what}: residual history not monotone: {hist}")


def twod_f64_gate(pkg, tree, rhs_of, n_fmg, what):
    """The convergence gate of a 2D path at full width in float64:
    ``make_solver`` on ``tree`` with dtype float64 (Dirichlet 0), the rhs
    ``rhs_of(sv, lvl)`` (the float32 run's, widened) on its levels, one
    zero-guess and ``n_fmg - 1`` have-guess FMGs; check_fmg_history (below
    1e-3 of the first, monotone until the floor).  Returns the history."""
    sv = pkg.make_solver(tree, pkg.MGConfig(dtype=torch.float64))
    sv.set_bc(0, pkg.BCType.DIRICHLET, 0.0)
    st = sv.allocate()
    for lvl in sv.levels:
        r = rhs_of(sv, lvl)
        if r is not None:
            sv.set_interior(st, lvl, "rhs", r.to(torch.float64))
    hist = run_fmgs(sv, st, n_fmg)
    del st, sv
    torch.cuda.empty_cache()
    check_fmg_history(hist, what)
    return hist


def no_library_launches(dk, what):
    """Fail if any kernel counter or plain-route counter of
    ops.dense_kernels moved since the last reset: the 2D paths are torch
    ops only, and a 3D kernel launched by mistake would show here."""
    moved = {k: v for k, v in dk.launch_counts().items() if v}
    moved.update({k: v for k, v in dk.plain_route_counts().items() if v})
    if moved:
        fail(f"{what}: the 2D path launched library kernels {moved}")
    return 0


def phase_dense2d_path(pkg, dk, sizes=(8192, 2048), box=16, n_have=8,
                       n_timed=8):
    """bench.py run_2d's problem at full width: ``build_rectangle(2, (n,
    n), 16)``, laplacian, float32, Dirichlet 0, through ``make_solver``
    (which must give Dense2DMGSolver), n = 8192 (2^26 cells, a field 0.27
    GB) and 2048 (bench.py's default).  bench.py's ones as rhs: one
    zero-guess and ``n_have`` have-guess FMGs (history, printed); a seeded
    normal rhs, the same (the gate: check_fmg_history); ``n_timed``
    have-guess FMGs without the residual and one sync (``ms_per_fmg``,
    ``unknowns_per_s`` n^2/s as bench.py:272); the same in
    ``fmg_mode="fused"``, bitwise the split mode; peak memory.  No library
    counter may move.  Returns the 8192^2 solver and its state."""
    out = None
    for n in sizes:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dsz = np.full(2, n)
        tree = pkg.build_rectangle(2, dsz, box, 1.0 / dsz, np.zeros(2))
        sv = pkg.make_solver(tree, pkg.MGConfig(dtype=torch.float32))
        if type(sv) is not pkg.Dense2DMGSolver:
            fail(f"dense2d_path: make_solver gave {type(sv).__name__}")
        sv.set_bc(0, pkg.BCType.DIRICHLET, 0.0)
        state = sv.allocate()
        top = sv.levels[-1]
        sv.set_interior(state, top, "rhs", torch.ones(
            (n, n), dtype=torch.float32, device="cuda"))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        dk.reset_launch_counts()
        dk.reset_plain_route_counts()
        hist_ones = run_fmgs(sv, state, 1 + n_have)
        g = torch.Generator(device="cuda").manual_seed(41)
        sv.set_interior(state, top, "rhs", torch.randn(
            (n, n), generator=g, dtype=torch.float32, device="cuda"))
        rhs = state["rhs"][top].clone()
        hist = run_fmgs(sv, state, 1 + n_have)
        phi = sv.interior(state, top, "phi")
        finite = tuple(phi.shape) == (n, n) and bool(torch.isfinite(phi).all())
        lib = no_library_launches(dk, "dense2d_path")
        hist64 = None
        if n == max(sizes):
            hist64 = twod_f64_gate(
                pkg, tree, lambda s, l: rhs if l == s.levels[-1] else None,
                1 + n_have, f"dense2d_path {n}^2 float64")
            no_library_launches(dk, "dense2d_path (float64)")
        del rhs
        ms, per_fmg = timed_fmgs(sv, state, n_timed)
        no_library_launches(dk, "dense2d_path (timed)")
        peak = torch.cuda.max_memory_allocated()
        fused = amr_fused_check(sv, state, what=f"dense2d_path {n}^2")
        rec = {"model": f"bench.py run_2d: make_solver(build_rectangle(2, "
                        f"({n}, {n}), {box}), float32), laplacian, "
                        f"Dirichlet 0",
               "solver": type(sv).__name__,
               "levels": [list(sv.dims[l]) for l in sv.levels],
               "setup_s": setup_s, "residuals_ones": hist_ones,
               "residuals": hist,
               "contraction_factors": [a / b for a, b in zip(hist, hist[1:])],
               "floor_over_first": min(hist) / hist[0],
               "residuals_float64": hist64,
               "ms_per_fmg": ms, "unknowns_per_s": n * n / (1e-3 * ms),
               "library_kernel_launches": lib,
               "fused_mode": fused, "peak_memory_bytes": peak}
        emit({f"dense2d_path_{n}": rec})
        if not finite:
            fail(f"dense2d_path {n}^2: phi has a wrong shape or non-finite "
                 f"values")
        check_floor_history(hist, f"dense2d_path {n}^2")
        if n == max(sizes):
            out = (sv, state)
        else:
            del sv, state
    torch.cuda.empty_cache()
    return out


def phase_refined2d_path(pkg, dk, df, sv, state, n_outer=10, seed=43):
    """The 2D f64-class mode at full width: ``solve_refined`` on the
    8192^2 float32 solver of dense2d_path (Dirichlet 0 on the inner
    solver), a seeded float64 rhs split by ``split_f64``, ``bc_values``
    BVALS_2D, ``n_outer`` outers, rtol 0 (no host read in the loop), one
    sync: ms per outer (warm, then the best of three timed solves), the
    norm history and its contraction, the device time of one eager step
    (accumulate + double-float residual) and of one inner FMG (CUDA
    events), peak memory.  Gates (tests/test_df32.py:453-480): the last
    norm <= 1e-10 of the first, and the float64 residual of x_hi + x_lo,
    computed on the card by the port's float64 ``stencil_apply_2d`` with
    the true boundary values, <= 1e-8 of the first norm.  No library
    counter may move."""
    from octree_mg_tpu_torch.ops import dense2d as d2
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    top = sv.levels[-1]
    n = sv.dims[top][0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    rhs64 = torch.randn((n, n), generator=g, dtype=torch.float64,
                        device="cuda")
    rh, rl = df.split_f64(rhs64)
    dk.reset_launch_counts()
    dk.reset_plain_route_counts()
    xh, xl, norms, _ = pkg.solve_refined(sv, state, rh, rl, n_outer=n_outer,
                                         bc_values=list(BVALS_2D))
    lib = no_library_launches(dk, "refined2d_path")
    cfg = sv._kcfgs[top]
    cfg64 = d2.Dense2DConfig(dims=cfg.dims, idr2=cfg.idr2, bc=cfg.bc,
                             periodic=cfg.periodic, dtype=torch.float64,
                             b_const=list(BVALS_2D))
    x64 = xh.double() + xl.double()
    r64 = float(d2.stencil_apply_2d(cfg64, x64, rhs64, 0.0, [None] * 4,
                                    residual=True).abs().max())
    del x64, rhs64
    rp = pkg.RefinedPoisson2D(sv, bc_values=list(BVALS_2D))
    dt, norms_t = timed_refined(rp, state, rh, rl, n_outer)
    e32 = state["phi"][top].clone()
    step_ms = event_ms(lambda: rp._step(state, e32))
    fmg_ms = event_ms(lambda: sv.fas_fmg(state, need_res=False))
    no_library_launches(dk, "refined2d_path (timed)")
    emit({"refined2d_path": {
        "model": f"solve_refined(dense2d_path's {n}^2 float32 solver, "
                 f"seeded float64 rhs, bc_values={list(BVALS_2D)}, "
                 f"n_outer={n_outer}, rtol=0)",
        "norms": norms, "norms_timed_solve": norms_t,
        "contraction_factors": [a / b for a, b in zip(norms, norms[1:])],
        "f64_residual_over_first_norm": r64 / norms[0],
        "ms_per_outer": 1e3 * dt / n_outer,
        "step_device_ms": step_ms, "inner_fmg_device_ms": fmg_ms,
        "library_kernel_launches": lib,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}})
    check_refined_history(norms, "refined2d_path")
    if not r64 <= 1e-8 * norms[0]:
        fail(f"refined2d_path: the float64 residual of x_hi + x_lo is "
             f"{r64}, over 1e-8 of the first norm {norms[0]}")
    del rp, xh, xl, e32
    torch.cuda.empty_cache()


def phase_amr2d_path(pkg, dk, n=8192, box=16, n_have=8, n_timed=8,
                     seed=47):
    """The 2D dense-patch AMR solver at full width: the tree of
    experiments/probe_dense_amr2d_perf.py, ``build_amr_centered(2, 3,
    (n, n), 16)`` (levels 1, 2 and 3 each 8192^2: level 1 the whole
    domain, levels 2 and 3 centred patches with four refinement faces;
    1.68e8 leaf unknowns; the tree build clocked apart), through
    ``make_solver`` (which must give Dense2DAMRMGSolver), laplacian,
    float32, Dirichlet 0, a seeded normal rhs on every level: one
    zero-guess and ``n_have`` have-guess FMGs (the gate:
    check_fmg_history, as amr_path), ``n_timed`` have-guess FMGs without
    the residual and one sync (``ms_per_fmg``, ``leaf_unknowns_per_s``),
    ``fmg_mode="fused"`` bitwise the split mode, peak memory.  No library
    counter may move."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = pkg.build_amr_centered(2, 3, np.full(2, n), box,
                                  np.full(2, 1.0 / n))
    build_s = time.perf_counter() - t0
    sv = pkg.make_solver(tree, pkg.MGConfig(dtype=torch.float32))
    if type(sv) is not pkg.Dense2DAMRMGSolver:
        fail(f"amr2d_path: make_solver gave {type(sv).__name__}")
    sv.set_bc(0, pkg.BCType.DIRICHLET, 0.0)
    state = sv.allocate()
    g = torch.Generator(device="cuda").manual_seed(seed)
    for lvl in sv.levels:
        sv.set_interior(state, lvl, "rhs", torch.randn(
            sv._ishape(lvl), generator=g, dtype=torch.float32, device="cuda"))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0 - build_s
    dk.reset_launch_counts()
    dk.reset_plain_route_counts()
    rhs = {lvl: state["rhs"][lvl].clone() for lvl in sv.levels}
    hist = run_fmgs(sv, state, 1 + n_have)
    top = sv.levels[-1]
    finite = bool(torch.isfinite(sv.interior(state, top, "phi")).all())
    lib = no_library_launches(dk, "amr2d_path")
    hist64 = twod_f64_gate(pkg, tree, lambda s, l: rhs[l], 1 + n_have,
                           "amr2d_path float64")
    no_library_launches(dk, "amr2d_path (float64)")
    del rhs
    ms, _ = timed_fmgs(sv, state, n_timed)
    no_library_launches(dk, "amr2d_path (timed)")
    peak = torch.cuda.max_memory_allocated()
    fused = amr_fused_check(sv, state, what="amr2d_path")
    n_unk = leaf_unknowns(tree, box)
    emit({"amr2d_path": {
        "model": f"experiments/probe_dense_amr2d_perf.py: make_solver("
                 f"build_amr_centered(2, 3, ({n}, {n}), {box}, 1/{n}), "
                 f"float32), laplacian, Dirichlet 0",
        "solver": type(sv).__name__,
        "levels": {str(lvl): {"dims": list(sv.dims[lvl]),
                              "offset": [int(v) for v in sv.offsets[lvl]],
                              "faces": sv.face_kind[lvl],
                              "whole_region": sv._whole_region(lvl)}
                   for lvl in sv.levels},
        "leaf_unknowns": n_unk, "tree_build_s": build_s, "setup_s": setup_s,
        "residuals": hist,
        "contraction_factors": [a / b for a, b in zip(hist, hist[1:])],
        "floor_over_first": min(hist) / hist[0],
        "residuals_float64": hist64,
        "ms_per_fmg": ms, "leaf_unknowns_per_s": n_unk / (1e-3 * ms),
        "library_kernel_launches": lib, "fused_mode": fused,
        "peak_memory_bytes": peak}})
    if not finite:
        fail("amr2d_path: non-finite phi on the top patch")
    check_floor_history(hist, "amr2d_path")
    del state, sv
    torch.cuda.empty_cache()


def _twod_solver_case(pkg, kind, op, geom, periodic, dev):
    """(phi by level, residual history) of three FMGs (float64, lam 0.7
    for the helmholtz family) on a small 2D solver: "uniform" 64^2 box 8
    (r_min (0.5, 0) for the cylindrical laplacian), "amr"
    build_amr_centered(2, 3, 32^2, 8); Dirichlet faces from a function
    unless periodic; seeded rhs and coefficients on every level."""
    def bc_fn(x):
        return 0.25 + np.sin(3 * x[..., 0]) * np.cos(2 * x[..., 1])

    if kind == "amr":
        tree = pkg.build_amr_centered(2, 3, np.full(2, 32), 8,
                                      np.full(2, 1.0 / 32))
        want = pkg.Dense2DAMRMGSolver
    else:
        tree = pkg.build_rectangle(
            2, np.full(2, 64), 8, np.full(2, 1.0 / 64),
            np.array([0.5, 0.0]) if geom == "cylindrical" else np.zeros(2),
            periodic=[periodic] * 2)
        want = pkg.Dense2DMGSolver
    sv = pkg.make_solver(tree, pkg.MGConfig(
        operator=op, geometry=geom, dtype=torch.float64, device=dev))
    if type(sv) is not want:
        fail(f"twod_cpu_agreement: make_solver gave {type(sv).__name__}")
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
    return ({lvl: sv.interior(st, lvl, "phi").cpu().numpy()
             for lvl in sv.levels}, hist)


def _twod_refined_case(pkg, lam, dev, n=64, n_outer=8):
    """x_hi + x_lo (float64) and the norms of a 2D refined solve: 64^2
    float32, laplacian with BVALS_2D (lam 0) or helmholtz lam 0.53 with
    zero boundary values, a seeded float64 rhs."""
    tree = pkg.build_rectangle(2, np.full(2, n), 16, np.full(2, 1.0 / n),
                               np.zeros(2))
    sv = pkg.make_solver(tree, pkg.MGConfig(
        operator="helmholtz" if lam else "laplacian", dtype=torch.float32,
        device=dev))
    rng = np.random.default_rng(n + 1)
    rh, rl = pkg.split_f64(rng.normal(size=(n, n)))
    xh, xl, norms, _ = pkg.solve_refined(
        sv, sv.allocate(), rh, rl, n_outer=n_outer, lam=lam,
        bc_values=None if lam else list(BVALS_2D))
    return (xh.double() + xl.double()).cpu().numpy(), norms


def phase_twod_cpu_agreement(pkg, dk):
    """The 2D solvers at <= 64^2 on the card against the CPU: the uniform
    solver with the five operators (periodic and not) and the cylindrical
    laplacian, the AMR solver with the five operators and the cylindrical
    laplacian (float64, three FMGs; bounds AGREE_2D_PHI on every level,
    residuals within AGREE_2D_RES of the first), and RefinedPoisson2D
    with lam 0 and 0.53 (float32, eight outers; AGREE_2D_X,
    AGREE_2D_NORMS).  No library counter may move."""
    dk.reset_launch_counts()
    dk.reset_plain_route_counts()
    rows = {}
    cases = [("uniform", op, "cartesian", per)
             for op in ("laplacian", "helmholtz", "vlaplacian", "vhelmholtz",
                        "ahelmholtz") for per in (False, True)]
    cases += [("uniform", "laplacian", "cylindrical", False)]
    cases += [("amr", op, "cartesian", False)
              for op in ("laplacian", "helmholtz", "vlaplacian", "vhelmholtz",
                         "ahelmholtz")]
    cases += [("amr", "laplacian", "cylindrical", False)]
    for kind, op, geom, per in cases:
        cuda = _twod_solver_case(pkg, kind, op, geom, per, "cuda")
        cpu = _twod_solver_case(pkg, kind, op, geom, per, "cpu")
        name = f"{kind}_{op}" + ("_cyl" if geom == "cylindrical" else "") + \
            ("_periodic" if per else "")
        rows[name] = agreement(cuda, cpu, res_scale=abs(cpu[1][0]),
                               res_bound=AGREE_2D_RES)
        rows[name]["phi_max_rel_diff_eps"] = (rows[name]["phi_max_rel_diff"]
                                              / float(np.finfo(float).eps))
    refined = {}
    for lam in (0.0, 0.53):
        (xa, na), (xb, nb) = (_twod_refined_case(pkg, lam, "cuda"),
                              _twod_refined_case(pkg, lam, "cpu"))
        keep = [i for i, v in enumerate(nb) if v > 1e-9 * nb[0]]
        refined[f"lam_{lam}"] = {
            "x_max_rel_diff": float(np.abs(xa - xb).max()
                                    / np.abs(xb).max()),
            "norms_max_rel_diff": float(max(abs(na[i] - nb[i]) / nb[i]
                                            for i in keep)),
            "norms_compared": len(keep), "norms_cuda": na, "norms_cpu": nb}
    lib = no_library_launches(dk, "twod_cpu_agreement")
    for r in rows.values():
        r["within_bounds"] = bool(
            r["phi_max_rel_diff"] <= AGREE_2D_PHI
            and r["residual_max_rel_diff"] <= AGREE_2D_RES)
    emit({"twod_cpu_agreement": {
        "trees": "build_rectangle(2, 64^2, 8); build_amr_centered(2, 3, "
                 "32^2, 8); refined: build_rectangle(2, 64^2, 16) float32",
        "dtype": "float64 (refined: float32 inner solver)", "fmgs": 3,
        "bound_phi": AGREE_2D_PHI, "bound_residual_over_first": AGREE_2D_RES,
        "bound_refined_x": AGREE_2D_X, "bound_refined_norms": AGREE_2D_NORMS,
        "library_kernel_launches": lib, **rows, "refined": refined}})
    for k, r in rows.items():
        if not r["within_bounds"]:
            fail(f"twod_cpu_agreement: card and CPU disagree ({k}): {r}")
    for k, r in refined.items():
        if not (r["x_max_rel_diff"] <= AGREE_2D_X
                and r["norms_max_rel_diff"] <= AGREE_2D_NORMS):
            fail(f"twod_cpu_agreement: the refined solve differs ({k}): {r}")


def phase_twod_op_costs(pkg, df, n=8192, reps=5):
    """The eager 2D ops at n^2 float32 against their byte bounds: one
    ``pair_sweep_2d`` and one residual (12 B a cell: read phi and rhs,
    write the result), the restriction (5 B a fine cell), one
    ``residual_df32_2d`` (20 B a cell: four inputs, one output); each the
    median of ``reps`` calls timed with CUDA events (starting
    synchronised, the host ahead), and its device launches counted by
    ``torch.profiler`` (CUDA kernel and memset/memcpy events of one call;
    "not measured" if the profiler records none)."""
    from octree_mg_tpu_torch.ops import dense2d as d2
    torch.cuda.empty_cache()
    dsz = np.full(2, n)
    tree = pkg.build_rectangle(2, dsz, 16, 1.0 / dsz, np.zeros(2))
    sv = pkg.make_solver(tree, pkg.MGConfig(dtype=torch.float32))
    sv.set_bc(0, pkg.BCType.DIRICHLET, 0.0)
    top = sv.levels[-1]
    cfg = sv._kcfgs[top]
    g = torch.Generator(device="cuda").manual_seed(53)
    f = [torch.randn((n, n), generator=g, device="cuda") for _ in range(4)]
    bp = [torch.zeros((n,), device="cuda") for _ in range(4)]
    coarse = torch.empty((n // 2, n // 2), device="cuda")
    cbs = df._cb_pairs(cfg)
    ops = {
        "pair_sweep_2d": (lambda: d2.pair_sweep_2d(cfg, f[0], f[1], 0.0, bp,
                                                   1), 12),
        "stencil_apply_2d (residual)": (lambda: d2.stencil_apply_2d(
            cfg, f[0], f[1], 0.0, bp, residual=True), 12),
        "restrict_2d": (lambda: d2.restrict_2d(f[0], out=coarse), 5),
        "residual_df32_2d": (lambda: df.residual_df32_2d(
            cfg, f[0], 1e-8 * f[1], f[2], 1e-8 * f[3], cbs=cbs), 20),
    }
    rows = {}
    for name, (fn, b_cell) in ops.items():
        fn()
        ms = statistics.median(event_ms(fn) for _ in range(reps))
        launches = "not measured"
        try:
            from torch.autograd import DeviceType
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            k = sum(1 for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
            launches = k if k else "not measured"
        except Exception as exc:   # the profiler is not guaranteed here
            launches = f"not measured ({type(exc).__name__})"
        bound = b_cell * n * n / HBM_BYTES_PER_S * 1e3
        rows[name] = {"ms": ms, "bound_ms": bound, "x_bound": ms / bound,
                      "bytes_per_cell_bound": b_cell,
                      "device_launches": launches}
    emit({"twod_op_costs": {"shape": [n, n], "dtype": "float32",
                            "hbm_bytes_per_s": HBM_BYTES_PER_S, **rows}})
    del f, bp, coarse, sv
    torch.cuda.empty_cache()


def run_twod(pkg, dk, df):
    """The 2D part (``--twod``, and in the full run): the phases above in
    order, the 8192^2 solver shared by dense2d_path and refined2d_path."""
    sv, state = phase_dense2d_path(pkg, dk)
    phase_refined2d_path(pkg, dk, df, sv, state)
    del sv, state
    torch.cuda.empty_cache()
    phase_amr2d_path(pkg, dk)
    phase_twod_op_costs(pkg, df)
    phase_twod_cpu_agreement(pkg, dk)


def main(argv) -> int:
    t_start = time.perf_counter()
    quick = "--quick" in argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script measures the GPU "
              "package and does not fall back to the CPU", file=sys.stderr)
        return 1
    import octree_mg_tpu_torch as pkg
    from octree_mg_tpu_torch.ops import _cuda_build
    from octree_mg_tpu_torch.ops import dense_kernels as dk
    from octree_mg_tpu_torch.ops import df32 as df

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    # the shipped libraries and the old designs' (OLD_DESIGNS), every
    # nvcc started at once
    from concurrent.futures import ThreadPoolExecutor
    t_build = time.perf_counter()
    with ThreadPoolExecutor(len(OLD_DESIGNS)) as ex:
        olds = [ex.submit(_cuda_build.build_kernels, (flag,), sources=srcs)
                for flag, srcs in OLD_DESIGNS.items()]
        paths = _cuda_build.build_kernels(
            extra_flags=("-Xptxas", "-v") if quick else (), verbose=quick)
        for f in olds:
            f.result()
    emit({"setup": {"card": smi, "torch": torch.__version__,
                    "cuda": torch.version.cuda,
                    "python": sys.version.split()[0],
                    "sources_built": sorted(paths),
                    "old_designs_built": sorted(OLD_DESIGNS),
                    "build_s": time.perf_counter() - t_build}})
    t0 = time.perf_counter()
    if "--amr" in argv:
        # the dense-patch AMR solver alone: its checks and phases
        phase_amr_checks(dk, pkg, quick)
        phase_amr_path(pkg, dk)
        phase_amr_cpu_agreement(pkg, dk)
        print(smi)
        emit({"ok": True, "amr": True})
        return 0
    if "--forests" in argv:
        # the multi-canvas forest and the refined forest
        phase_multiforest_path(pkg, dk)
        phase_refined_forest_path(pkg, dk, df)
        phase_forests_cpu_agreement(pkg)
        print(smi)
        emit({"ok": True, "forests": True})
        return 0
    if "--twod" in argv:
        # the uniform 2D path, its refined mode and the 2D AMR solver
        run_twod(pkg, dk, df)
        print(smi)
        emit({"ok": True, "twod": True})
        return 0
    if "--drivers" in argv:
        # the free-space and diffusion drivers and the coefficient forest
        phase_free_space_path(pkg, dk)
        phase_diffusion_path(pkg, dk)
        phase_forest_vcoeff(pkg, dk)
        phase_drivers_cpu_agreement(pkg, dk)
        print(smi)
        emit({"ok": True, "drivers": True})
        return 0
    phase_checks(dk, df, quick)
    phase_amr_checks(dk, pkg, quick)
    if quick:
        print(smi)
        emit({"ok": True, "quick": True})
        return 0
    ps, launches, ms_per_fmg = phase_main_path(pkg, dk)
    phase_fmg_stages(ps)
    launches_refined, refined_split = phase_refined_path(ps, dk, df)
    never = [k for k in CONST_KERNELS
             if launches[k] + launches_refined[k] == 0]
    if never:
        fail(f"neither part of the main path launched {never}")
    del ps
    torch.cuda.empty_cache()
    phase_fused_mode(pkg, dk, ms_per_fmg, refined_split)
    del refined_split
    torch.cuda.empty_cache()
    phase_df32_exactness(dk, df)
    phase_refined_vs_f64(pkg)
    phase_cpu_agreement(pkg, df)
    vcoeff = phase_vcoeff_path(pkg, dk)
    phase_refined_vcoeff(pkg, dk, df)
    never = [k for k in EPS_VARIANTS
             if vcoeff[int(k.split("=")[1][:-1])][0][k] == 0]
    if never:
        fail(f"the variable-coefficient paths never launched {never}")
    sharded_launches, sharded_per_fmg, slab_by = phase_sharded_path(pkg, dk)
    phase_sharded_periodic(pkg, dk)
    launches_sharded_refined = phase_sharded_refined(pkg, dk, df)
    sharded_vcoeff = phase_sharded_vcoeff(pkg, dk)
    slab_rows = phase_slab_kernel_times(
        dk, df, (sharded_launches, sharded_per_fmg, slab_by),
        launches_sharded_refined, sharded_vcoeff)
    torch.cuda.empty_cache()
    forest_rows, launches_forest = phase_forest_path(pkg, dk)
    periodic_rows, launches_periodic = phase_forest_periodic(pkg, dk)
    forest_rows += periodic_rows
    forest_rows.append(phase_set_mode_row(dk, launches_forest))
    boxed_rows, _ = phase_boxed_path(pkg, dk)
    amr_launches, amr_per_fmg = phase_amr_path(pkg, dk)
    phase_amr_cpu_agreement(pkg, dk)
    drivers = {"free_space_launches": phase_free_space_path(pkg, dk),
               "diffusion_launches": phase_diffusion_path(pkg, dk)}
    (drivers["forest_vcoeff_launches"],
     drivers["forest_vcoeff_launches_per_fmg"]) = phase_forest_vcoeff(pkg, dk)
    (drivers["multiforest_path_launches"],
     drivers["multiforest_path_launches_per_fmg"],
     _) = phase_multiforest_path(pkg, dk)
    (drivers["refined_forest_path_launches"],
     drivers["refined_forest_path_launches_per_outer"]) = \
        phase_refined_forest_path(pkg, dk, df)
    phase_forests_cpu_agreement(pkg)
    run_twod(pkg, dk, df)
    rows, copy_bps = phase_kernel_times(dk, df, launches, launches_refined,
                                        vcoeff)
    emit({"measured_copy_bytes_per_s": copy_bps,
          "seconds_after_build": time.perf_counter() - t0,
          "seconds_total": time.perf_counter() - t_start})
    emit({"kernels": driver_rows(amr_rows(
        rows + forest_rows + boxed_rows + slab_rows, amr_launches,
        amr_per_fmg), drivers)})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
