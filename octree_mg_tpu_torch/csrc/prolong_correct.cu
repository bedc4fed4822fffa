// K4 prolong_correct: phi_fine += prolong(phi_coarse - iold_coarse).
//
// Replaces the Pallas entry point prolong_correct_dense of the JAX
// package's ops/dense_kernels.py in its three modes (correct_children,
// m_multigrid.f90:387-402, with the sparse D-linear weights of
// mg_prolong_sparse, m_prolong.f90:159-240):
//   MODE 0 add (add=True): corr = phi_c - iold_c, added into phi_fine;
//   MODE 1 set (add=False): corr = phi_c, iold_c not read, the prolonged
//     values replace phi_fine's interior (mg_prolong's set mode);
//   MODE 2 corr_ready (corr_ready=True): phi_c already is the correction,
//     iold_c not read, added into phi_fine (the dense forest's
//     correction, whose window ring rides the six plane-valued faces).
// Modes 1 and 2 evaluate one BC synthesis per face (of phi_c) where mode
// 0 evaluates two and subtracts.
//
// Bound: bytes (per coarse cell: read 2 coarse values, read and write 8
// fine values).  Design: one thread per coarse cell.  It reads the
// 7-point neighbourhood of phi_c and of iold_c directly from device
// memory (the neighbours of adjacent threads overlap in L1/L2), with
// wrapped indices on periodic axes and both BC syntheses evaluated at
// the domain faces: lo[d] = synth(phi)_lo - synth(iold)_lo, whose c0*b
// terms cancel only mathematically.  Then
//   f0 = 0.25*corr; for d = x, y, z: a + 0.25*lo[d] | a + 0.25*hi[d]
// gives the eight child values, which are added into phi_fine in place as
// four 2-wide vector read-modify-writes.
#include "stencil_common.cuh"

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

template <typename T, int MODE>
__global__ void prolong_correct_kernel(LevelParams P,
                                       const T* __restrict__ phic,
                                       const T* __restrict__ ioldc,
                                       T* __restrict__ phif) {
  using V = typename Vec2<T>::type;
  int gx = blockIdx.x * blockDim.x + threadIdx.x;
  int gy = blockIdx.y * blockDim.y + threadIdx.y;
  int gz = blockIdx.z * blockDim.z + threadIdx.z;
  if (gx >= P.X || gy >= P.Y || gz >= P.Z) return;
  const int g[3] = {gx, gy, gz};
  const int n[3] = {P.X, P.Y, P.Z};
  const long long o = field_off(P, gx, gy, gz);
  const T pc = phic[o];
  const T ic = MODE == 0 ? ioldc[o] : (T)0;

  T lo[3], hi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    // raw neighbours; a neighbour that does not exist is never used
    int c[3] = {gx, gy, gz};
    c[d] = src_idx(g[d] - 1, n[d], P.per[d]);
    long long ol = c[d] >= 0 ? field_off(P, c[0], c[1], c[2]) : o;
    c[d] = src_idx(g[d] + 1, n[d], P.per[d]);
    long long oh = c[d] >= 0 ? field_off(P, c[0], c[1], c[2]) : o;
    T lop, hip;
    neighbor_pair<T>(P, d, g[d], n[d], pc, phic[ol], phic[oh], gx, gy, gz, lop,
                     hip);
    if constexpr (MODE == 0) {
      T loi, hii;
      neighbor_pair<T>(P, d, g[d], n[d], ic, ioldc[ol], ioldc[oh], gx, gy, gz,
                       loi, hii);
      lo[d] = (T)0.25 * (lop - loi);
      hi[d] = (T)0.25 * (hip - hii);
    } else {
      lo[d] = (T)0.25 * lop;
      hi[d] = (T)0.25 * hip;
    }
  }

  const T f0 = MODE == 0 ? (T)0.25 * (pc - ic) : (T)0.25 * pc;
  const long long Xf = 2 * P.X, rowz = (long long)(2 * P.Y + 2 * PY) * Xf;
  T* f = phif + (long long)(2 * gz + PZ) * rowz + (long long)(2 * gy + PY) * Xf +
         2 * gx;
  const T ax0 = f0 + lo[0], ax1 = f0 + hi[0];
#pragma unroll
  for (int bz = 0; bz < 2; ++bz) {
#pragma unroll
    for (int by = 0; by < 2; ++by) {
      T ty = by ? hi[1] : lo[1], tz = bz ? hi[2] : lo[2];
      V* q = reinterpret_cast<V*>(f + bz * rowz + by * Xf);
      if constexpr (MODE == 1) {
        V v;
        v.x = (ax0 + ty) + tz;
        v.y = (ax1 + ty) + tz;
        *q = v;
      } else {
        V v = *q;
        v.x = v.x + ((ax0 + ty) + tz);
        v.y = v.y + ((ax1 + ty) + tz);
        *q = v;
      }
    }
  }
}

template <typename T, int MODE>
static int launch(const LevelParams& P, const void* phic, const void* ioldc,
                  void* phif, cudaStream_t stream) {
  dim3 block(32, 4, 2);
  dim3 grid(cdiv(P.X, 32), cdiv(P.Y, 4), cdiv(P.Z, 2));
  prolong_correct_kernel<T, MODE><<<grid, block, 0, stream>>>(
      P, (const T*)phic, (const T*)ioldc, (T*)phif);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_mode(int mode, const LevelParams& P, const void* phic,
                       const void* ioldc, void* phif, cudaStream_t s) {
  switch (mode) {
    case 0: return launch<T, 0>(P, phic, ioldc, phif, s);
    case 1: return launch<T, 1>(P, phic, ioldc, phif, s);
    case 2: return launch<T, 2>(P, phic, ioldc, phif, s);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = float64; mode: 0 add, 1 set, 2 corr_ready (ioldc
// is read in mode 0 only); P describes the COARSE level.  phif must be
// 16-byte aligned.  Returns the cudaError_t of the launch.
extern "C" int omg_prolong_correct(int dtype, int mode, const LevelParams* P,
                                   const void* phic, const void* ioldc,
                                   void* phif, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch_mode<float>(mode, *P, phic, ioldc, phif, s)
                    : launch_mode<double>(mode, *P, phic, ioldc, phif, s);
}
