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
// synthesized pair.  Bound: as MODE 0, plus the two pad planes.  Design:
// the pair kernel below, on every slab in both dtypes; -DOMG_SLABAP=0
// builds the thread-per-coarse-cell kernel above for every slab instead
// (the probe's old design).
//
// The pair kernel (prolong_pair_kernel).  A thread of the design above
// makes 14 scattered loads of phi_c and iold_c for one coarse cell and
// adds its children as 8-byte read-modify-writes.  Here a thread owns two
// x-adjacent coarse cells: it loads each row of their neighbourhood as
// one pair (phi_c and iold_c: the cells, y -1/+1 and z -1/+1 as 8-byte
// pairs, the two x neighbours alone: 12 loads for two cells), and adds
// their sixteen fine values into phi_f as four 16-byte
// read-modify-writes (two rows in y, two planes in z).  A ring of planes
// in shared memory instead (cp.async, the neighbours from the ring and
// from registers) was no faster than the design above at the slab size
// and is not kept (PERF.md).  A neighbour outside a non-periodic dim is
// the cell itself, as above; the arithmetic is MODE 0's above, operation
// by operation.
#include <cstdint>
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

// The pair kernel's block ((x, y, z): 64 x 4 x 2 coarse cells) and the
// float32 blocks per SM its registers must leave room for
// (__launch_bounds__)
constexpr int PP_BX = 32, PP_BY = 4, PP_BZ = 2, PP_MINB = 2;

// The BC ghosts of both fields at a cell on a face: n holds the raw
// neighbours (lo x y z of phi_c, hi of phi_c, lo of iold_c, hi of iold_c);
// a neighbour beyond a face that synthesizes is the cell itself, then
// neighbor_pair (x, y) / slab_z_pair (z) replace it by the ghost.
template <typename T>
__device__ __forceinline__ void pp_face(const LevelParams& P, bool zsyn_lo,
                                        bool zsyn_hi, int g, int gy, int r,
                                        T p, T i, T (&n)[12]) {
  const int px = P.per[0], py = P.per[1];
  const int gg[3] = {g, gy, r}, nn[3] = {P.X, P.Y, P.Z};
  const bool slo[3] = {!px && g == 0, !py && gy == 0, zsyn_lo && r == 0};
  const bool shi[3] = {!px && g == P.X - 1, !py && gy == P.Y - 1,
                       zsyn_hi && r == P.Z - 1};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    T& lp = n[d];
    T& hp = n[3 + d];
    T& li = n[6 + d];
    T& hi = n[9 + d];
    if (slo[d]) { lp = p; li = i; }
    if (shi[d]) { hp = p; hi = i; }
    T a, b;
    if (d == 2) {
      slab_z_pair<T>(P, zsyn_lo, zsyn_hi, r, p, lp, hp, g, gy, r, a, b);
      lp = a; hp = b;
      slab_z_pair<T>(P, zsyn_lo, zsyn_hi, r, i, li, hi, g, gy, r, a, b);
      li = a; hi = b;
    } else {
      neighbor_pair<T>(P, d, gg[d], nn[d], p, lp, hp, g, gy, r, a, b);
      lp = a; hp = b;
      neighbor_pair<T>(P, d, gg[d], nn[d], i, li, hi, g, gy, r, a, b);
      li = a; hi = b;
    }
  }
}

// The pair (gx0, gx0 + 1) of row sy of the plane at offset zo: one 2-wide
// load where vec, else one a cell from its source column; a row or plane
// with no source (sy < 0, zo < 0), or a column with none, is the cell
// itself (own0, own1).
template <typename T>
__device__ __forceinline__ void pp_ld(const T* fld, long long zo, int sy,
                                      int gx0, int X, int per, bool vec,
                                      T own0, T own1, T& a, T& b) {
  if (sy < 0 || zo < 0) { a = own0; b = own1; return; }
  const T* row = fld + zo + (long long)(sy + PY) * X;
  if (vec) {
    const typename Vec2<T>::type w =
        *reinterpret_cast<const typename Vec2<T>::type*>(row + gx0);
    a = w.x; b = w.y;
    return;
  }
  const int s0 = src_idx(gx0, X, per), s1 = src_idx(gx0 + 1, X, per);
  a = s0 >= 0 ? row[s0] : own0;
  b = s1 >= 0 ? row[s1] : own1;
}

template <typename T>
__global__ void __launch_bounds__(PP_BX * PP_BY * PP_BZ,
                                  sizeof(T) == 4 ? PP_MINB : 1)
prolong_pair_kernel(LevelParams P, int vec, const T* __restrict__ phic,
                    const T* __restrict__ ioldc, T* __restrict__ phif,
                    SlabParams Zs) {
  const int X = P.X, Y = P.Y, Z = P.Z;
  const int px = P.per[0], py = P.per[1];
  const int gx0 = 2 * (blockIdx.x * PP_BX + threadIdx.x);
  const int gy = blockIdx.y * PP_BY + threadIdx.y;
  const int r = blockIdx.z * PP_BZ + threadIdx.z;
  if (gx0 >= X || gy >= Y || r >= Z) return;
  const bool in1 = gx0 + 1 < X;                 // cell 1 is in the level
  const bool pv = vec != 0 && in1;              // pairs and 16-byte rows
  // the z faces that synthesize (the ones the slab owns; beyond the
  // others the pad plane is read)
  const bool zsyn_lo = slab_syn(P, Zs, 0), zsyn_hi = slab_syn(P, Zs, 1);
  const long long gplane = (long long)(Y + 2 * PY) * X;
  // the offset of plane q (-1 to Z: a pad plane beyond a face that does
  // not synthesize); -1 beyond one that does
  auto zoff = [&](int q) -> long long {
    if ((q < 0 && zsyn_lo) || (q >= Z && zsyn_hi)) return -1;
    return (long long)(q + PZ) * gplane;
  };
  const long long zo = (long long)(r + PZ) * gplane;
  const long long zl = zoff(r - 1), zh = zoff(r + 1);
  const int yl = src_idx(gy - 1, Y, py), yh = src_idx(gy + 1, Y, py);
  const int xl = src_idx(gx0 - 1, X, px), xh = src_idx(gx0 + 2, X, px);
  const int s1 = src_idx(gx0 + 1, X, px);
  // the cells [field][cell] and their raw neighbours [field][cell][lo,
  // hi][x, y, z]
  T own[2][2], nb[2][2][2][3];
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const T* fld = f ? ioldc : phic;
    const T* row = fld + zo + (long long)(gy + PY) * X;
    T a, b;
    pp_ld<T>(fld, zo, gy, gx0, X, px, pv, (T)0, (T)0, a, b);
    own[f][0] = a;
    own[f][1] = in1 ? b : a;
    // x: cell 0's high neighbour is cell 1 (beyond X: cell 1's source
    // column), cell 1's low neighbour is cell 0
    nb[f][0][0][0] = xl >= 0 ? row[xl] : own[f][0];
    nb[f][0][1][0] = in1 ? own[f][1] : s1 >= 0 ? row[s1] : own[f][0];
    nb[f][1][0][0] = own[f][0];
    nb[f][1][1][0] = xh >= 0 ? row[xh] : own[f][1];
    pp_ld<T>(fld, zo, yl, gx0, X, px, pv, own[f][0], own[f][1], a, b);
    nb[f][0][0][1] = a; nb[f][1][0][1] = b;
    pp_ld<T>(fld, zo, yh, gx0, X, px, pv, own[f][0], own[f][1], a, b);
    nb[f][0][1][1] = a; nb[f][1][1][1] = b;
    pp_ld<T>(fld, zl, gy, gx0, X, px, pv, own[f][0], own[f][1], a, b);
    nb[f][0][0][2] = a; nb[f][1][0][2] = b;
    pp_ld<T>(fld, zh, gy, gx0, X, px, pv, own[f][0], own[f][1], a, b);
    nb[f][0][1][2] = a; nb[f][1][1][2] = b;
  }
  // the four fine rows (two in y, two planes in z) the two cells add into
  const int Xf = 2 * X;
  const long long rowzf = (long long)(2 * Y + 2 * PY) * Xf;
  T* const fxy = phif + (long long)(2 * r + PZ) * rowzf +
                 (long long)(2 * gy + PY) * Xf + 2 * gx0;
  T fv[2][2][4];
#pragma unroll
  for (int bz = 0; bz < 2; ++bz)
#pragma unroll
    for (int by = 0; by < 2; ++by) {
      const T* q = fxy + bz * rowzf + by * Xf;
      if (pv) {
        af_ld4<T>(q, fv[bz][by]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          fv[bz][by][j] = j < 2 || in1 ? q[j] : (T)0;
      }
    }
  const bool yface = !py && (gy == 0 || gy == Y - 1);
  const bool zf = (zsyn_lo && r == 0) || (zsyn_hi && r == Z - 1);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const T p = own[0][c], i = own[1][c];
    T n[12] = {nb[0][c][0][0], nb[0][c][0][1], nb[0][c][0][2],
               nb[0][c][1][0], nb[0][c][1][1], nb[0][c][1][2],
               nb[1][c][0][0], nb[1][c][0][1], nb[1][c][0][2],
               nb[1][c][1][0], nb[1][c][1][1], nb[1][c][1][2]};
    const int g = gx0 + c;
    if ((c == 0 || in1) && (yface || zf || (!px && (g == 0 || g == X - 1))))
      pp_face<T>(P, zsyn_lo, zsyn_hi, g, gy, r, p, i, n);
    T lo[3], up[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      lo[d] = (T)0.25 * (n[d] - n[6 + d]);
      up[d] = (T)0.25 * (n[3 + d] - n[9 + d]);
    }
    const T f0 = (T)0.25 * (p - i);
    const T ax0 = f0 + lo[0], ax1 = f0 + up[0];
#pragma unroll
    for (int bz = 0; bz < 2; ++bz)
#pragma unroll
      for (int by = 0; by < 2; ++by) {
        const T tyv = by ? up[1] : lo[1], tz = bz ? up[2] : lo[2];
        fv[bz][by][2 * c] = fv[bz][by][2 * c] + ((ax0 + tyv) + tz);
        fv[bz][by][2 * c + 1] = fv[bz][by][2 * c + 1] + ((ax1 + tyv) + tz);
      }
  }
#pragma unroll
  for (int bz = 0; bz < 2; ++bz)
#pragma unroll
    for (int by = 0; by < 2; ++by) {
      T* q = fxy + bz * rowzf + by * Xf;
      if (pv) {
        af_st4<T>(q, fv[bz][by]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < 2 || in1) q[j] = fv[bz][by][j];
      }
    }
}

// The slab add-mode prolongation on the pair kernel; P the coarse slab,
// Zs its gates.
template <typename T>
static int launch_pair(const LevelParams& P, const void* phic,
                       const void* ioldc, void* phif, cudaStream_t stream,
                       const SlabParams& Zs) {
  // pairs and 16-byte fine rows need even rows and aligned fields
  auto al = [](const void* p, size_t b) { return (uintptr_t)p % b == 0; };
  const int vec = P.X % 2 == 0 && al(phif, 16) &&
                  al(phic, 2 * sizeof(T)) && al(ioldc, 2 * sizeof(T));
  dim3 block(PP_BX, PP_BY, PP_BZ);
  dim3 grid(cdiv(P.X, 2 * PP_BX), cdiv(P.Y, PP_BY), cdiv(P.Z, PP_BZ));
  prolong_pair_kernel<T><<<grid, block, 0, stream>>>(
      P, vec, (const T*)phic, (const T*)ioldc, (T*)phif, Zs);
  return (int)cudaGetLastError();
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
// design, unless null, receives 3 where the launch ran the pair kernel
// (every launch; 0 under -DOMG_SLABAP=0).  Returns the cudaError_t of
// the launch.
extern "C" int omg_prolong_slab(int dtype, const LevelParams* P,
                                const SlabParams* Zs, const void* phic,
                                const void* ioldc, void* phif, void* stream,
                                int* design) {
  cudaStream_t s = (cudaStream_t)stream;
#if OMG_SLABAP
  if (design) *design = 3;
  return dtype == 0 ? launch_pair<float>(*P, phic, ioldc, phif, s, *Zs)
                    : launch_pair<double>(*P, phic, ioldc, phif, s, *Zs);
#else
  if (design) *design = 0;
  return dtype == 0 ? launch<float, 0, 1>(*P, phic, ioldc, phif, s, *Zs)
                    : launch<double, 0, 1>(*P, phic, ioldc, phif, s, *Zs);
#endif
}
