// Masked GSRB half-sweep on flat boxes: the boxed solver's smoother.
//
// Replaces the Pallas kernel half_sweep_flat of the JAX package's
// ops/pallas_smoother.py (the lane-roll half-sweep of the constant-
// coefficient laplacian/helmholtz on [n, (nc+2)^D] planes).  For every
// cell of every box:
//
//   out = mask ? (acc * fac) : phi,
//   acc = -rhs + idr2_x (phi[i-1] + phi[i+1])
//              + idr2_y (phi[i-P] + phi[i+P])
//              + idr2_z (phi[i-P^2] + phi[i+P^2]),   P = nc + 2,
//
// where mask = "interior, and (i+j+k) of the padded indices 0..nc+1 is
// parity (mod 2)" (_mask_flat, computed here from the index, no mask
// array is read) and fac = 1/(sum 2 idr2 + lam) is the host's double
// rounded to T.  The sums run in the order above with one rounding per
// operation (built with --fmad=false), the order of the plain PyTorch
// version in ops/flat_smoother.py and of ops/kernels.helmholtz_smooth_half,
// so the three agree bitwise.
//
// In place on phi: a masked cell reads only unmasked cells (its
// neighbours have the other parity or are ghosts), so no thread reads a
// value another thread writes.  The TPU kernel's circular rolls are not
// needed: a ghost cell is never updated and an interior cell's
// neighbours lie inside its own box.
//
// Bound: bytes (read phi and rhs, write half of phi; 2D+1 adds, D
// multiplies and one multiply per updated cell).  Design, simple first:
// one thread per cell, block.x = one box (up to 2^31-1 boxes), block.y =
// a 256-cell chunk of it, so a warp reads consecutive cells of one box
// and its x neighbours from the same lines; the y/z neighbours are
// re-read through L1/L2 rather than staged in shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int D>
__global__ void half_sweep_flat_kernel(int nc, int parity, T i0, T i1, T i2,
                                       T fac, T* __restrict__ phi,
                                       const T* __restrict__ rhs) {
  const int P = nc + 2;
  const int S = D == 1 ? P : D == 2 ? P * P : P * P * P;
  const int l = blockIdx.y * kThreads + threadIdx.x;
  if (l >= S) return;
  const int ix = l % P;
  const int r = l / P;
  const int iy = D >= 2 ? r % P : 1;
  const int iz = D == 3 ? r / P : 1;
  if (ix < 1 || ix > nc || iy < 1 || iy > nc || iz < 1 || iz > nc) return;
  const int s = D == 1 ? ix : D == 2 ? ix + iy : ix + iy + iz;
  if ((s & 1) != parity) return;
  const long long o = (long long)blockIdx.x * S + l;
  T acc = -rhs[o];
  acc = acc + i0 * (phi[o - 1] + phi[o + 1]);
  if (D >= 2) acc = acc + i1 * (phi[o - P] + phi[o + P]);
  if (D == 3) acc = acc + i2 * (phi[o - P * P] + phi[o + P * P]);
  phi[o] = acc * fac;
}

template <typename T, int D>
int launch(long long n, int nc, int parity, const double* idr2, double fac,
           void* phi, const void* rhs, cudaStream_t stream) {
  const int P = nc + 2;
  const int S = D == 1 ? P : D == 2 ? P * P : P * P * P;
  dim3 grid((unsigned)n, (unsigned)((S + kThreads - 1) / kThreads));
  half_sweep_flat_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      nc, parity, (T)idr2[0], (T)(D >= 2 ? idr2[1] : 0.0),
      (T)(D == 3 ? idr2[2] : 0.0), (T)fac, (T*)phi, (const T*)rhs);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int ndim, long long n, int nc, int parity, const double* idr2,
             double fac, void* phi, const void* rhs, cudaStream_t s) {
  switch (ndim) {
    case 1: return launch<T, 1>(n, nc, parity, idr2, fac, phi, rhs, s);
    case 2: return launch<T, 2>(n, nc, parity, idr2, fac, phi, rhs, s);
    case 3: return launch<T, 3>(n, nc, parity, idr2, fac, phi, rhs, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  phi, rhs: contiguous [n, (nc+2)^ndim]
// planes; phi is updated in place.  idr2: ndim doubles (x, y, z); fac:
// 1/(sum 2 idr2 + lam) in double.  Returns the cudaError_t of the launch.
extern "C" int omg_half_sweep_flat(int dtype, int ndim, long long n, int nc,
                                   int parity, const double* idr2, double fac,
                                   void* phi, const void* rhs, void* stream) {
  if (n < 1 || n > 0x7fffffffLL || nc < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0
             ? launch_d<float>(ndim, n, nc, parity, idr2, fac, phi, rhs, s)
             : launch_d<double>(ndim, n, nc, parity, idr2, fac, phi, rhs, s);
}
