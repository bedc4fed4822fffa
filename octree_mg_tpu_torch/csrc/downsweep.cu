// K2 downsweep: the fused V-cycle down-leg on one dense level.
//
// Replaces the Pallas entry points downsweep_dense (n_pairs GSRB pairs,
// residual, full-weighting restriction of phi and of the residual) and
// residual_restrict_dense (the same without smoothing and without a
// fine output) of the JAX package's ops/dense_kernels.py.
//
// Bound: bytes.  The fused pass reads phi and rhs once and writes phi
// plus two coarse fields (13 B per fine cell in float32); run apart, the
// same work is a pair pass, a residual pass and two restriction passes.
// Design: the z-streaming wavefront of stream_kernel.cuh in mode DOWN,
// halo 2*n_pairs + 1: two steps after its last half-sweep a plane goes
// through the residual stage, the residual of the tile goes to a
// two-plane buffer in shared memory, and every second step one thread
// per coarse cell sums the 2x2x2 children of phi and of the residual, in
// the order (z0+z1), + y neighbour, + x neighbour, * 0.125 (identical to
// / 8).  The ring holds 12 planes of a 42x26 window of phi and of rhs:
// 109 KB in float32, 218 KB in float64 (large dynamic shared memory).
// The variable-coefficient variants (E->n 1 or 3; eps windows of the
// Pallas body) use the apply form out + c*(nbr - p) per side in the
// residual stage.  In float32 the down-leg with its fine output runs the
// face-plane design of stream_faces.cuh at every level: its harmonic
// means are built once per plane into two face rings (low x and low y
// faces, one value per cell whatever NE is) beside the phi and rhs rings,
// 214 KB for two pairs, and it was faster than this kernel at every
// level from 16^3 to 512^3 on an H100 (6.77 against 13.55 ms for n_eps 1
// at 512^3, PERF.md, experiments/probe_torch_kernels.py faces).  In
// float64 those rings would not fit a block's 227 KB, and there this
// kernel reads the coefficients of each cell and its six neighbours from
// device memory at every update.  Without smoothing and without the
// fine output (residual_restrict_dense) every launch, with or without
// coefficients, runs the face-plane apply of apply_faces.cuh in both
// dtypes at every level: it was faster than this kernel at every level
// from 16^3 to 512^3 on an H100 (1.32 against 2.57 ms for n_eps 1 at
// 512^3 float32, experiments/probe_torch_kernels.py apply_faces; 0.55
// against 0.85 ms without coefficients, probe_torch_kernels.py rr_slab;
// PERF.md).  It needs no wavefront, builds each face once per plane
// (none without coefficients) and restricts from registers, the y
// partner one warp shuffle away.
//
// On float32 levels of 512^3 the constant-coefficient down-leg runs the
// wide design of stream_wide.cuh instead (a phi-only ring with the plane
// copied in by cp.async, the restriction from registers): 3.12 against
// 3.43 ms on an H100 (PERF.md); at 256^3 and in float64 it was no
// faster, and this kernel stays.
#include "apply_faces.cuh"

// n_sweeps = 2 or 4 half-sweeps, then the residual and the restrictions,
// with the fine output in float32: constant coefficients on the wide
// design (stream_wide.cuh, *design = 1) where it takes the level,
// coefficients on the face-plane design (stream_faces.cuh, *design = 2),
// the rest on stream_kernel.cuh
template <typename T, int NS, int NE>
static int launch_down(const LevelParams& P, const EpsParams& E,
                       int fine_out, const void* phi, const void* rhs,
                       void* phi_out, void* phic_out, void* iresc_out,
                       cudaStream_t s, int* design) {
#if OMG_WIDE
  if constexpr (NE == 0 && sizeof(T) == 4)
    if (fine_out && wide_takes<T, M_DOWN>(P)) {
      *design = 1;
      return launch_wide<T, NS, M_DOWN>(P, phi, rhs, phi_out, phic_out, iresc_out, s);
    }
#endif
#if OMG_FACES
  if constexpr (NE != 0 && sizeof(T) == 4)
    if (fine_out) {
      *design = 2;
      return launch_faces<T, NS, M_DOWN, NE>(P, E, phi, rhs, phi_out, phic_out, iresc_out, s);
    }
#endif
  return launch_stream<T, NS, M_DOWN, NE>(P, E, fine_out, phi, rhs, phi_out, phic_out, iresc_out, s);
}

// The residual and both restrictions without smoothing: every launch on
// the face-plane apply (apply_faces.cuh, *design = 2), which has no fine
// output (residual_restrict_dense asks for none).  The stream_kernel.cuh
// instances it replaced are built only with -DOMG_FACES=0, for the probe.
template <typename T, int NE>
static int launch_restrict(const LevelParams& P, const EpsParams& E,
                           int fine_out, const void* phi, const void* rhs,
                           void* phi_out, void* phic_out, void* iresc_out,
                           cudaStream_t s, int* design) {
#if OMG_FACES
  if constexpr (af_takes<T, M_DOWN, NE>()) {
    if (fine_out) return (int)cudaErrorInvalidValue;
    *design = 2;
    return launch_apply_faces<T, M_DOWN, NE>(P, E, phi, rhs, nullptr, phic_out, iresc_out, s);
  } else
#endif
    return launch_stream<T, 0, M_DOWN, NE>(P, E, fine_out, phi, rhs, phi_out, phic_out, iresc_out, s);
}

template <typename T, int NE>
static int dispatch(const LevelParams& P, const EpsParams& E, int fine_out,
                    const void* phi, const void* rhs, void* phi_out,
                    void* phic_out, void* iresc_out, cudaStream_t s,
                    int* design) {
  switch (P.n_sweeps) {
    case 0: return launch_restrict<T, NE>(P, E, fine_out, phi, rhs, phi_out, phic_out, iresc_out, s, design);
    case 2: return launch_down<T, 2, NE>(P, E, fine_out, phi, rhs, phi_out, phic_out, iresc_out, s, design);
    case 4: return launch_down<T, 4, NE>(P, E, fine_out, phi, rhs, phi_out, phic_out, iresc_out, s, design);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
static int dispatch_eps(const LevelParams& P, const EpsParams& E,
                        int fine_out, const void* phi, const void* rhs,
                        void* phi_out, void* phic_out, void* iresc_out,
                        cudaStream_t s, int* design) {
  switch (E.n) {
    case 0: return dispatch<T, 0>(P, E, fine_out, phi, rhs, phi_out, phic_out, iresc_out, s, design);
    case 1: return dispatch<T, 1>(P, E, fine_out, phi, rhs, phi_out, phic_out, iresc_out, s, design);
    case 3: return dispatch<T, 3>(P, E, fine_out, phi, rhs, phi_out, phic_out, iresc_out, s, design);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = float64.  P->n_sweeps = 2*n_pairs (0, 2 or 4);
// E: E->n coefficient fields (0, 1 or 3) in E->f, or null for none.  All
// of X, Y, Z must be even; n_sweeps 0 takes no fine output
// (cudaErrorInvalidValue).  design, unless null, receives 1 where
// the launch ran the wide design (stream_wide.cuh), 2 where it ran a
// face-plane design (stream_faces.cuh, or apply_faces.cuh for
// n_sweeps 0), else 0.  Returns the cudaError_t of the launch.
extern "C" int omg_downsweep(int dtype, int fine_out, const LevelParams* P,
                             const EpsParams* E, const void* phi,
                             const void* rhs, void* phi_out, void* phic_out,
                             void* iresc_out, void* stream, int* design) {
  cudaStream_t s = (cudaStream_t)stream;
  if ((P->X | P->Y | P->Z) & 1) return (int)cudaErrorInvalidValue;
  const EpsParams e = E ? *E : EpsParams{0, {nullptr, nullptr, nullptr}};
  int w = 0;
  const int err = dtype == 0
      ? dispatch_eps<float>(*P, e, fine_out, phi, rhs, phi_out, phic_out, iresc_out, s, &w)
      : dispatch_eps<double>(*P, e, fine_out, phi, rhs, phi_out, phic_out, iresc_out, s, &w);
  if (design) *design = w;
  return err;
}
