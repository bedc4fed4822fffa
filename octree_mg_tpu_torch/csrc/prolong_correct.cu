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
//
// SLAB = 1 (omg_prolong_slab, MODE 0 only) replaces the entry point
// called with z_gates on one coarse slab of the z-slab solver: a z
// neighbour beyond a face the slab does not own is read from the coarse
// z pads (the halo exchange's copies of phi_c and iold_c), so the ring's
// z plane there is phi_c - iold_c of the neighbour slab instead of the
// synthesized pair.  Bound and design: as MODE 0.
#include "stencil_common.cuh"

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

template <typename T, int MODE, int SLAB>
__global__ void prolong_correct_kernel(LevelParams P,
                                       const T* __restrict__ phic,
                                       const T* __restrict__ ioldc,
                                       T* __restrict__ phif, SlabParams Zs) {
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
  // SLAB: the z faces this slab synthesizes (else it reads their pads)
  const bool zsyn_lo = SLAB != 0 && slab_syn(P, Zs, 0);
  const bool zsyn_hi = SLAB != 0 && slab_syn(P, Zs, 1);

  T lo[3], hi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    // raw neighbours; a neighbour that does not exist is never used
    int c[3] = {gx, gy, gz};
    long long ol, oh;
    if (SLAB != 0 && d == 2) {
      // the pad plane beyond a face that does not synthesize
      ol = gz > 0 || !zsyn_lo ? field_off(P, gx, gy, gz - 1) : o;
      oh = gz < P.Z - 1 || !zsyn_hi ? field_off(P, gx, gy, gz + 1) : o;
    } else {
      c[d] = src_idx(g[d] - 1, n[d], P.per[d]);
      ol = c[d] >= 0 ? field_off(P, c[0], c[1], c[2]) : o;
      c[d] = src_idx(g[d] + 1, n[d], P.per[d]);
      oh = c[d] >= 0 ? field_off(P, c[0], c[1], c[2]) : o;
    }
    T lop, hip;
    if (SLAB != 0 && d == 2)
      slab_z_pair<T>(P, zsyn_lo, zsyn_hi, gz, pc, phic[ol], phic[oh], gx, gy,
                     gz, lop, hip);
    else
      neighbor_pair<T>(P, d, g[d], n[d], pc, phic[ol], phic[oh], gx, gy, gz,
                       lop, hip);
    if constexpr (MODE == 0) {
      T loi, hii;
      if (SLAB != 0 && d == 2)
        slab_z_pair<T>(P, zsyn_lo, zsyn_hi, gz, ic, ioldc[ol], ioldc[oh], gx,
                       gy, gz, loi, hii);
      else
        neighbor_pair<T>(P, d, g[d], n[d], ic, ioldc[ol], ioldc[oh], gx, gy,
                         gz, loi, hii);
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

template <typename T, int MODE, int SLAB = 0>
static int launch(const LevelParams& P, const void* phic, const void* ioldc,
                  void* phif, cudaStream_t stream,
                  const SlabParams& Zs = SlabParams{}) {
  dim3 block(32, 4, 2);
  dim3 grid(cdiv(P.X, 32), cdiv(P.Y, 4), cdiv(P.Z, 2));
  prolong_correct_kernel<T, MODE, SLAB><<<grid, block, 0, stream>>>(
      P, (const T*)phic, (const T*)ioldc, (T*)phif, Zs);
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

// The z-slab variant of mode 0 (add): P describes the coarse SLAB, Zs its
// (lo, hi) z-face gates; phic and ioldc carry the exchanged z pads.
// Returns the cudaError_t of the launch.
extern "C" int omg_prolong_slab(int dtype, const LevelParams* P,
                                const SlabParams* Zs, const void* phic,
                                const void* ioldc, void* phif, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? launch<float, 0, 1>(*P, phic, ioldc, phif, s, *Zs)
                    : launch<double, 0, 1>(*P, phic, ioldc, phif, s, *Zs);
}
