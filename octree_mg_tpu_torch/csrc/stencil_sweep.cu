// K1 stencil_sweep: fused GSRB pairs, operator application and residual
// on one dense level.
//
// Replaces the Pallas entry points pair_sweep_dense (n_pairs 1 or 2) and
// stencil_apply_dense of the JAX package's ops/dense_kernels.py (scaffold
// _make_kernel/_call_kernel, bodies _halfsweep and _apply_expr).
//
// Bound: bytes.  A pair reads phi and rhs once and writes phi once
// (12 B/cell in float32) against 11 flops per updated cell, far below
// the card's flop-per-byte ratio.  Design: the z-streaming wavefront of
// stream_kernel.cuh.  All 2*n_pairs half-sweeps run in one launch and
// one pass over device memory; the halo is paid in x and y only (a
// 32x16 tile with halo 4 loads 1.9x its cells), one thread owns one cell
// pair for the whole march, and a step costs one barrier.  What limits it
// now is the instructions a step issues, not the bytes: float64 costs
// under twice float32, and neither a deeper register prefetch nor a
// conflict-free colour-split shared layout changed its time.  Of roughly
// 290 instructions per thread and step only 80 are the four updates
// (seven shared-memory reads, eleven flops, one write each); the rest is
// index, slot and predicate arithmetic that more cells per thread would
// share.  So on levels of 256^3 and up the constant-coefficient double
// pair runs the wide design of stream_wide.cuh instead (two rows of a
// pair per thread, a phi-only ring, a 64x32 tile): 1.75 against 2.24 ms
// at 512^3 float32 on an H100 (PERF.md, experiments/probe_torch_kernels.py
// wide); smaller levels keep this kernel, which is faster there.
//
// half_sweep_dense (n_sweeps 1, constant coefficients) replaces the Pallas
// entry point of that name: ONE half-sweep updating the cells of parity
// red_parity, every other cell copied; the NS = 1 instantiation of the
// same wavefront (halo 1, four planes in the ring).  The dense forest's
// sequential smoother calls it between ghost refreshes, with its ghosts
// in the six plane-valued faces.  Bound: bytes, as a pair, for half the
// updates.
//
// The variable-coefficient variants (E->n 1 or 3) replace the Pallas
// bodies' eps windows (_halfsweep / _apply_expr with eps).  Bound: bytes,
// one more field read per coefficient field.  Which design runs them:
// * the double pair in float32 (one or two pairs): the face-plane design
//   of stream_faces.cuh at every level, because it was faster than the
//   kernel below at every level from 16^3 to 512^3 on an H100 (4.33
//   against 8.95 ms for n_eps 1 and two pairs at 512^3, PERF.md,
//   experiments/probe_torch_kernels.py faces): each face coefficient is
//   built once per plane, from one read per field, into shared-memory
//   face rings beside the phi ring;
// * the apply and the residual in float32 and float64: the face-plane
//   apply of apply_faces.cuh at every level, because it was faster than
//   stream_kernel.cuh at every level from 16^3 to 512^3 on an H100 (1.32
//   against 2.56 ms for the n_eps 1 residual at 512^3 float32, PERF.md,
//   experiments/probe_torch_kernels.py apply_faces): no wavefront, four
//   cells a thread, planes copied in by cp.async, each face built once
//   per plane.  Building a cell's six faces from seven or nine
//   scattered reads and six divisions, as the kernel below does, was
//   what the apply lost its time to, not a deep ring;
// * the double pair in float64 and the float64 slab variants:
//   stream_kernel.cuh's ring and wavefront, which build the six harmonic
//   means of a cell at every update from the coefficients of the cell and
//   its six neighbours, read from device memory (L1/L2 serve the reuse),
//   so shared memory stays what the NE = 0 kernel needs.  In float64 the
//   face rings of the double pair would not fit a block's 227 KB.
//
// The z-slab variants (omg_stencil_slab, SLAB = 1) replace the same
// Pallas entry points called with z_gates, on one slab of the z-slab
// solver (the JAX package's solve/dense_shard.py): pairs (n_pairs 1 or
// 2) and A(phi) / rhs - A(phi), for every NE.  The planes beyond a face
// the slab does not own come from its z pads (the halo exchange's
// copies of the neighbour slabs' planes), 2*n_pairs deep for a pair, 1
// for the apply; the wavefront sweeps them redundantly, as the Pallas
// kernel's hz = 2*n_pairs window does, and writes core planes only.
// Bound: bytes, as the unsharded kernel, plus the halo planes read.  The
// constant-coefficient double pair on a whole slab of the 512^3 or 256^3
// level over 8 slabs runs the wide design (stream_wide.cuh with SLAB = 1,
// wide_slab_takes): 0.313 against 0.382 ms on a 512^2 x 64 slab, 0.070
// against 0.084 on a 256^2 x 32 one (two pairs, float32, H100, PERF.md,
// experiments/probe_torch_kernels.py rr_slab); float32 only, the dtype of
// every slab solve that has such slabs.  The edge strips of an overlapped
// pair group (2*n_pairs planes), smaller slabs and float64 keep
// stream_kernel.cuh.  The constant-coefficient apply and residual on a
// float32 slab of at least 2^20 cells (the sharded 512^3 and 256^3 levels
// over 8) run the face-plane apply (apply_faces.cuh with SLAB = 1,
// af_slab_takes): no wavefront for halo 1, the pad planes copied into its
// ring like every other plane; smaller slabs (latency-bound) and float64
// keep stream_kernel.cuh, whose slab apply and residual -DOMG_SLABAP=0
// sends every slab to (the probe's old design).  The float32 coefficient
// slab variants (n_eps 1 and 3) run the face-plane designs, each face
// built once per plane, the pad planes' coefficients with the rest: the
// double pair stream_faces.cuh with SLAB = 1 on every slab and edge strip
// (0.61 against 0.86 ms on a 512^2 x 64 slab, two pairs, n_eps 1), the
// apply and the residual apply_faces.cuh with SLAB = 1 on slabs of 2^15
// cells and more (af_eps_slab_takes; 0.20 against 0.34 ms for the
// residual on 512^2 x 64; H100, PERF.md,
// experiments/probe_torch_kernels.py slab_eps); -DOMG_SLABEPS=0 sends them
// all to stream_kernel.cuh (the probe's old design).  half_sweep_dense
// with z_gates has no caller in the JAX package and is not instantiated.
#include "apply_faces.cuh"

// n_sweeps half-sweeps of one or two pairs: constant coefficients on the
// wide design (stream_wide.cuh, *design = 1) where it takes the level,
// float32 coefficients on the face-plane design (stream_faces.cuh,
// *design = 2), the rest on stream_kernel.cuh
template <typename T, int NS, int NE>
static int launch_pairs(const LevelParams& P, const EpsParams& E,
                        const void* phi, const void* rhs, void* out,
                        cudaStream_t s, int* design) {
#if OMG_WIDE
  if constexpr (NE == 0)
    if (wide_takes<T, M_PAIRS>(P)) {
      *design = 1;
      return launch_wide<T, NS, M_PAIRS>(P, phi, rhs, out, nullptr, nullptr, s);
    }
#endif
#if OMG_FACES
  if constexpr (NE != 0 && sizeof(T) == 4) {
    *design = 2;
    return launch_faces<T, NS, M_PAIRS, NE>(P, E, phi, rhs, out, nullptr, nullptr, s);
  }
#endif
  return launch_stream<T, NS, M_PAIRS, NE>(P, E, 0, phi, rhs, out, nullptr, nullptr, s);
}

// A(phi) or rhs - A(phi): coefficients on the face-plane apply
// (apply_faces.cuh, *design = 2), the rest on stream_kernel.cuh.  The
// stream_kernel.cuh instance of a launch the face-plane apply takes is
// built only with -DOMG_FACES=0, for the probe.
template <typename T, int MODE, int NE>
static int launch_apply(const LevelParams& P, const EpsParams& E,
                        const void* phi, const void* rhs, void* out,
                        cudaStream_t s, int* design) {
#if OMG_FACES
  if constexpr (af_takes<T, MODE, NE>()) {
    *design = 2;
    return launch_apply_faces<T, MODE, NE>(P, E, phi, rhs, out, nullptr, nullptr, s);
  } else
#endif
    return launch_stream<T, 0, MODE, NE>(P, E, 0, phi, rhs, out, nullptr, nullptr, s);
}

template <typename T, int NE>
static int dispatch(int mode, const LevelParams& P, const EpsParams& E,
                    const void* phi, const void* rhs, void* out,
                    cudaStream_t s, int* design) {
  if (mode == M_APPLY)
    return launch_apply<T, M_APPLY, NE>(P, E, phi, rhs, out, s, design);
  if (mode == M_RESIDUAL)
    return launch_apply<T, M_RESIDUAL, NE>(P, E, phi, rhs, out, s, design);
  if (mode != M_PAIRS) return (int)cudaErrorInvalidValue;
  if (P.n_sweeps == 1) {
    // half_sweep_dense: constant coefficients only
    if constexpr (NE == 0)
      return launch_stream<T, 1, M_PAIRS, 0>(P, E, 0, phi, rhs, out, nullptr, nullptr, s);
    return (int)cudaErrorInvalidValue;
  }
  if (P.n_sweeps == 2) return launch_pairs<T, 2, NE>(P, E, phi, rhs, out, s, design);
  if (P.n_sweeps == 4) return launch_pairs<T, 4, NE>(P, E, phi, rhs, out, s, design);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int dispatch_eps(int mode, const LevelParams& P, const EpsParams& E,
                        const void* phi, const void* rhs, void* out,
                        cudaStream_t s, int* design) {
  switch (E.n) {
    case 0: return dispatch<T, 0>(mode, P, E, phi, rhs, out, s, design);
    case 1: return dispatch<T, 1>(mode, P, E, phi, rhs, out, s, design);
    case 3: return dispatch<T, 3>(mode, P, E, phi, rhs, out, s, design);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = float64; mode: 0 = n_sweeps half-sweeps (1, 2
// or 4; 1 only with E->n 0), 1 = A(phi), 2 = rhs - A(phi); E: E->n coefficient fields (0, 1 or
// 3) in E->f, or null for none.  design, unless null, receives 1 where
// the launch ran the wide design (stream_wide.cuh), 2 where it ran a
// face-plane design (stream_faces.cuh for pairs, apply_faces.cuh for
// modes 1 and 2), else 0.  Returns the cudaError_t of the launch.
extern "C" int omg_stencil_sweep(int dtype, int mode, const LevelParams* P,
                                 const EpsParams* E, const void* phi,
                                 const void* rhs, void* out, void* stream,
                                 int* design) {
  cudaStream_t s = (cudaStream_t)stream;
  const EpsParams e = E ? *E : EpsParams{0, {nullptr, nullptr, nullptr}};
  int w = 0;
  const int err = dtype == 0
      ? dispatch_eps<float>(mode, *P, e, phi, rhs, out, s, &w)
      : dispatch_eps<double>(mode, *P, e, phi, rhs, out, s, &w);
  if (design) *design = w;
  return err;
}

// The slab double pair of NS half-sweeps: constant coefficients on the
// wide design (stream_wide.cuh with SLAB = 1, *design = 1) where it takes
// the slab, float32 coefficients on the face-plane design
// (stream_faces.cuh with SLAB = 1, *design = 2), the rest (float64, the
// constant-coefficient edge strips of an overlapped pair group and small
// slabs) on stream_kernel.cuh.  float64 stays there: no slab solve runs a
// float64 slab large enough for the wide rule, nor any with coefficients.
template <typename T, int NS, int NE>
static int launch_slab_pairs(const LevelParams& P, const EpsParams& E,
                             const SlabParams& Zs, const void* phi,
                             const void* rhs, void* out, cudaStream_t s,
                             int* design) {
#if OMG_WIDE
  if constexpr (NE == 0 && sizeof(T) == 4)
    if (wide_slab_takes<T>(P)) {
      *design = 1;
      return launch_wide<T, NS, M_PAIRS, 1>(P, phi, rhs, out, nullptr, nullptr, s, &Zs);
    }
#endif
#if OMG_SLABEPS
  if constexpr (NE != 0 && sizeof(T) == 4) {
    *design = 2;
    return launch_faces<T, NS, M_PAIRS, NE, 1>(P, E, phi, rhs, out, nullptr, nullptr, s, &Zs);
  } else
#endif
    return launch_stream<T, NS, M_PAIRS, NE, 0, 1>(P, E, 0, phi, rhs, out, nullptr, nullptr, s, nullptr, &Zs);
}

// The slab A(phi) or rhs - A(phi) on the face-plane apply
// (apply_faces.cuh with SLAB = 1, *design = 2): constant coefficients on
// a float32 slab where af_slab_takes the slab, float32 coefficients where
// af_eps_slab_takes it; the rest (float64, small slabs) on
// stream_kernel.cuh.
template <typename T, int MODE, int NE>
static int launch_slab_apply(const LevelParams& P, const EpsParams& E,
                             const SlabParams& Zs, const void* phi,
                             const void* rhs, void* out, cudaStream_t s,
                             int* design) {
#if OMG_SLABAP
  if constexpr (NE == 0 && sizeof(T) == 4)
    if (af_slab_takes(P)) {
      *design = 2;
      return launch_apply_faces<T, MODE, 0, 0, 1>(P, E, phi, rhs, out, nullptr, nullptr, s, nullptr, &Zs);
    }
#endif
#if OMG_SLABEPS
  if constexpr (NE != 0 && sizeof(T) == 4)
    if (af_eps_slab_takes(P)) {
      *design = 2;
      return launch_apply_faces<T, MODE, NE, 0, 1>(P, E, phi, rhs, out, nullptr, nullptr, s, nullptr, &Zs);
    }
#endif
  return launch_stream<T, 0, MODE, NE, 0, 1>(P, E, 0, phi, rhs, out, nullptr, nullptr, s, nullptr, &Zs);
}

template <typename T, int NE>
static int dispatch_slab(int mode, const LevelParams& P, const EpsParams& E,
                         const SlabParams& Zs, const void* phi,
                         const void* rhs, void* out, cudaStream_t s,
                         int* design) {
  if (mode == M_APPLY)
    return launch_slab_apply<T, M_APPLY, NE>(P, E, Zs, phi, rhs, out, s, design);
  if (mode == M_RESIDUAL)
    return launch_slab_apply<T, M_RESIDUAL, NE>(P, E, Zs, phi, rhs, out, s, design);
  if (mode != M_PAIRS) return (int)cudaErrorInvalidValue;
  if (P.n_sweeps == 2)
    return launch_slab_pairs<T, 2, NE>(P, E, Zs, phi, rhs, out, s, design);
  if (P.n_sweeps == 4)
    return launch_slab_pairs<T, 4, NE>(P, E, Zs, phi, rhs, out, s, design);
  return (int)cudaErrorInvalidValue;
}

// The z-slab variants: as omg_stencil_sweep, on one slab whose z pads
// hold the neighbour slabs' planes; Zs: the slab's (lo, hi) z-face gates.
// mode 0 takes n_sweeps 2 or 4 (one or two pairs).  design, unless null,
// receives 1 where the launch ran the wide design (stream_wide.cuh), 2
// where it ran a face-plane design (stream_faces.cuh for pairs,
// apply_faces.cuh for modes 1 and 2), else 0.
extern "C" int omg_stencil_slab(int dtype, int mode, const LevelParams* P,
                                const EpsParams* E, const SlabParams* Zs,
                                const void* phi, const void* rhs, void* out,
                                void* stream, int* design) {
  cudaStream_t s = (cudaStream_t)stream;
  const EpsParams e = E ? *E : EpsParams{0, {nullptr, nullptr, nullptr}};
  if (e.n != 0 && e.n != 1 && e.n != 3) return (int)cudaErrorInvalidValue;
  int w = 0, err;
  if (dtype == 0) {
    if (e.n == 0) err = dispatch_slab<float, 0>(mode, *P, e, *Zs, phi, rhs, out, s, &w);
    else if (e.n == 1) err = dispatch_slab<float, 1>(mode, *P, e, *Zs, phi, rhs, out, s, &w);
    else err = dispatch_slab<float, 3>(mode, *P, e, *Zs, phi, rhs, out, s, &w);
  } else {
    if (e.n == 0) err = dispatch_slab<double, 0>(mode, *P, e, *Zs, phi, rhs, out, s, &w);
    else if (e.n == 1) err = dispatch_slab<double, 1>(mode, *P, e, *Zs, phi, rhs, out, s, &w);
    else err = dispatch_slab<double, 3>(mode, *P, e, *Zs, phi, rhs, out, s, &w);
  }
  if (design) *design = w;
  return err;
}
