// The segment-synthesis variants of K1: pair_sweep_dense and
// stencil_apply_dense with segs/seg_planes, the dense forest's
// fused-canvas path.
//
// Replaces the Pallas bodies of those entry points in the JAX package's
// ops/dense_kernels.py when they carry forest segment planes
// (_neighbor_ops' segd branch, :249-257, and the in-window pad zeroing,
// :677-686): every ghost of a forest canvas, refinement-boundary or
// physical, is synthesized at read time from per-layer planes, so a GSRB
// pair needs no ghost refresh between its half-sweeps and two pairs run
// in one pass.
//
// Bound: bytes, as the plain K1 (phi and rhs read once, phi written
// once), plus the planes of the layers that the canvas has.  A reader
// finds its layer through a lookup table (reader coordinate and side ->
// descriptor) that the wrapper builds once per canvas geometry.  x wraps,
// a y or z read outside the canvas is 0 (the Pallas body zeroes its pad
// rows), and no pad is read.  Three designs, by dtype, mode and size:
// * the float32 double pair on canvases of 256^3 and up (wide_seg_takes):
//   stream_wide.cuh with SEG = 1, which stages the layers read by a tile
//   beside its ring and forms the sums of the reader columns and rows
//   one step ahead into line buffers: 1.83 against 3.04 ms for two pairs
//   on the forest's 512^3 canvas, 0.34 against 0.61 at 256^3, on an
//   NVIDIA H100 80GB HBM3 at 700 W (PERF.md,
//   experiments/probe_torch_kernels.py seg);
// * the float32 apply and residual on every canvas: apply_faces.cuh with
//   SEG = 1, no faces, two planes ahead, four blocks per SM: 0.80
//   against 1.26 ms for the residual at 512^3, 0.15 against 0.28 at
//   256^3, within the launches' noise at 32^3 and below;
// * the rest (float64, and the double pair below 256^3, whose launches
//   are latency-bound, as the constant double pair's rule has it): the
//   z-streaming wavefront of stream_kernel.cuh with SEG = 1, x and y
//   lookups once per thread, z once per plane.
#include "apply_faces.cuh"

// OMG_SEGWIDE 0 builds every segment launch on stream_kernel.cuh (the
// design before the wide and face-plane ones), for
// experiments/probe_torch_kernels.py seg and chip_smoke.py to hold the
// two against each other.
#ifndef OMG_SEGWIDE
#define OMG_SEGWIDE 1
#endif

// n_sweeps half-sweeps of one or two pairs: the wide design
// (stream_wide.cuh with SEG = 1, *design = 1) where wide_seg_takes the
// canvas, else stream_kernel.cuh
template <typename T, int NS>
static int launch_seg_pairs(const LevelParams& P, const SegParams& S,
                            const void* phi, const void* rhs, void* out,
                            cudaStream_t s, int* design) {
#if OMG_SEGWIDE
  if constexpr (sizeof(T) == 4)
    if (wide_seg_takes<T>(P)) {
      *design = 1;
      return launch_wide<T, NS, M_PAIRS, 0, 1>(P, phi, rhs, out, nullptr,
                                               nullptr, s, nullptr, &S);
    }
#endif
  const EpsParams e{0, {nullptr, nullptr, nullptr}};
  return launch_stream<T, NS, M_PAIRS, 0, 1>(P, e, 0, phi, rhs, out, nullptr, nullptr, s, &S);
}

// A(phi) or rhs - A(phi): float32 on the face-plane apply (apply_faces.cuh
// with SEG = 1, *design = 2), float64 on stream_kernel.cuh
template <typename T, int MODE>
static int launch_seg_apply(const LevelParams& P, const SegParams& S,
                            const void* phi, const void* rhs, void* out,
                            cudaStream_t s, int* design) {
  const EpsParams e{0, {nullptr, nullptr, nullptr}};
#if OMG_SEGWIDE
  if constexpr (sizeof(T) == 4) {
    *design = 2;
    return launch_apply_faces<T, MODE, 0, 1>(P, e, phi, rhs, out, nullptr,
                                             nullptr, s, &S);
  } else
#endif
    return launch_stream<T, 0, MODE, 0, 1>(P, e, 0, phi, rhs, out, nullptr, nullptr, s, &S);
}

template <typename T>
static int dispatch(int mode, const LevelParams& P, const SegParams& S,
                    const void* phi, const void* rhs, void* out,
                    cudaStream_t s, int* design) {
  if (mode == M_APPLY)
    return launch_seg_apply<T, M_APPLY>(P, S, phi, rhs, out, s, design);
  if (mode == M_RESIDUAL)
    return launch_seg_apply<T, M_RESIDUAL>(P, S, phi, rhs, out, s, design);
  if (mode != M_PAIRS) return (int)cudaErrorInvalidValue;
  if (P.n_sweeps == 2)
    return launch_seg_pairs<T, 2>(P, S, phi, rhs, out, s, design);
  if (P.n_sweeps == 4)
    return launch_seg_pairs<T, 4>(P, S, phi, rhs, out, s, design);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = float64; mode: 0 = n_sweeps half-sweeps (2 or
// 4), 1 = A(phi), 2 = rhs - A(phi); P: the canvas (per = {1, 0, 0}; its
// BC fields are not read); S: the ghost layers.  design, unless null,
// receives 1 where the launch ran the wide design (stream_wide.cuh), 2
// where it ran the face-plane apply (apply_faces.cuh), else 0.  Returns
// the cudaError_t of the launch.
extern "C" int omg_seg_sweep(int dtype, int mode, const LevelParams* P,
                             const SegParams* S, const void* phi,
                             const void* rhs, void* out, void* stream,
                             int* design) {
  cudaStream_t s = (cudaStream_t)stream;
  if (S->n < 1 || S->n > MAX_SEGS || S->lut == nullptr)
    return (int)cudaErrorInvalidValue;
  int w = 0;
  const int err = dtype == 0
      ? dispatch<float>(mode, *P, *S, phi, rhs, out, s, &w)
      : dispatch<double>(mode, *P, *S, phi, rhs, out, s, &w);
  if (design) *design = w;
  return err;
}
