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
// once), plus the planes of the layers that the canvas has.  Design: the
// z-streaming wavefront of stream_kernel.cuh with SEG = 1.  A reader
// finds its layer through a lookup table (reader coordinate and side ->
// descriptor) that the wrapper builds once per canvas geometry; x and y
// lookups are done once per thread, z once per plane.  x wraps, a y or z
// read outside the canvas is 0 (the Pallas body zeroes its pad rows),
// and no pad is read.
#include "stream_kernel.cuh"

template <typename T>
static int dispatch(int mode, const LevelParams& P, const SegParams& S,
                    const void* phi, const void* rhs, void* out,
                    cudaStream_t s) {
  const EpsParams e{0, {nullptr, nullptr, nullptr}};
  if (mode == M_APPLY)
    return launch_stream<T, 0, M_APPLY, 0, 1>(P, e, 0, phi, rhs, out, nullptr, nullptr, s, &S);
  if (mode == M_RESIDUAL)
    return launch_stream<T, 0, M_RESIDUAL, 0, 1>(P, e, 0, phi, rhs, out, nullptr, nullptr, s, &S);
  if (mode != M_PAIRS) return (int)cudaErrorInvalidValue;
  if (P.n_sweeps == 2)
    return launch_stream<T, 2, M_PAIRS, 0, 1>(P, e, 0, phi, rhs, out, nullptr, nullptr, s, &S);
  if (P.n_sweeps == 4)
    return launch_stream<T, 4, M_PAIRS, 0, 1>(P, e, 0, phi, rhs, out, nullptr, nullptr, s, &S);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = float64; mode: 0 = n_sweeps half-sweeps (2 or
// 4), 1 = A(phi), 2 = rhs - A(phi); P: the canvas (per = {1, 0, 0}; its
// BC fields are not read); S: the ghost layers.  Returns the cudaError_t
// of the launch.
extern "C" int omg_seg_sweep(int dtype, int mode, const LevelParams* P,
                             const SegParams* S, const void* phi,
                             const void* rhs, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (S->n < 1 || S->n > MAX_SEGS || S->lut == nullptr)
    return (int)cudaErrorInvalidValue;
  return dtype == 0 ? dispatch<float>(mode, *P, *S, phi, rhs, out, s)
                    : dispatch<double>(mode, *P, *S, phi, rhs, out, s);
}
