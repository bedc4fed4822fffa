// Shared device code of the dense-level kernels (Hopper, sm_90a): the
// level parameters, wrapped indexing and the inline BC ghost synthesis.
//
// Layout of every per-level field: [Z + 2*PZ, Y + 2*PY, X], x fastest,
// PZ = PY = 8.  Pad contents are garbage by contract: the kernels never
// let a pad value reach a core cell.  Physical-boundary ghosts are
// synthesized inline (ghost = c0*b + c1*x1 + c2*x2) at the cells that
// read them, and periodic axes are read with wrapped indices, so no
// kernel here reads a pad at all, except the z-slab variants (SlabParams
// below), whose z pads hold the neighbour slabs' planes.
//
// Arithmetic order is that of the plain PyTorch versions in
// ops/dense_kernels.py (and of the JAX package's _halfsweep/_apply_expr),
// one rounding per operation: build with --fmad=false so that nvcc does
// not contract a*b+c, and kernel and plain version agree bitwise.
#pragma once
#include <cuda_runtime.h>

constexpr int PZ = 8;
constexpr int PY = 8;

// Mirrored field by field by ops/dense_kernels.py:_LevelParams (ctypes).
// Every double holds a value already rounded to the working dtype on the
// host, so the cast to T inside a kernel is exact.
struct LevelParams {
  int X, Y, Z;        // cell counts
  int per[3];         // periodic flags (x, y, z)
  int red_parity;     // (gx+gy+gz)&1 of the cells the red half-sweep updates
  int n_sweeps;       // half-sweeps to run (2 per GSRB pair)
  double idr2[3];     // 1/dr^2 per dim (x, y, z)
  double neg_lam;     // -lam
  double inv_den;     // 1/(sum_d 2*idr2[d] + lam), evaluated in the dtype
  double c0[6];       // ghost = c0*b + c1*x1 + c2*x2 per face
  double c1[6];       //   faces: x-, x+, y-, y+, z-, z+
  double c2[6];
  double c0b[6];      // c0*b of constant-valued faces (host double product)
  const void* plane[6];  // boundary-value plane of a face, or null (constant)
};

// The coefficient fields of the variable-coefficient variants, mirrored
// by ops/dense_kernels.py:_EpsParams.  A kernel argument of its own,
// passed last, so that LevelParams and the parameter layout of every
// constant-coefficient kernel stay those of the NE = 0 stencil.
struct EpsParams {
  int n;              // coefficient fields (0, 1 or 3; the kernels' NE)
  const void* f[3];   // the padded coefficient fields, read-only
};

// The ghost layers of a dense-forest canvas, for the segment-synthesis
// variants of the stencil kernels (the forest's fused-canvas path),
// mirrored by ops/dense_kernels.py:_SegParams.  A kernel argument of its
// own, passed last, so that the parameter layout of every other kernel
// stays what it was.
//
// Descriptor j is a one-cell-thick ghost layer at canvas coordinate c
// along dim d, on side 0 (below its footprint run: readers at c + 1
// substitute their low neighbour) or side 1 (readers at c - 1 substitute
// their high neighbour).  Its plane [4, T1, T2] holds, per transverse
// position in the padded layout of that dim's face planes (x: [Z+2PZ,
// Y+2PY], y: [Z+2PZ, X], z: [Y+2PY, X]), a0 = c0*b, a1 = c1, a2 = c2 and
// a mask m; where m != 0 the reader's neighbour is
//   ghost = (a0 + a1*x1) + a2*x2,
// x1 the reader itself and x2 its other neighbour along d.  lut maps a
// reader to its descriptor: entry base_d + 2*g + side (base 0, 2X,
// 2X + 2Y for d = x, y, z) is the descriptor whose readers sit at
// coordinate g, or -1.
constexpr int MAX_SEGS = 96;
struct SegParams {
  int n;                          // descriptors (0: not a segment launch)
  const int* lut;                 // [2*(X+Y+Z)] reader -> descriptor
  const void* plane[MAX_SEGS];    // [4, T1, T2] per descriptor
};

// The z-slab variants of the stencil, prolongation and double-float
// residual kernels (template flag SLAB = 1; the z_gates argument of the
// JAX package's kernels), mirrored by ops/dense_kernels.py:_SlabParams.
// The level is one of K z-slabs of a larger domain, and the caller's
// halo exchange has written the neighbour slabs' boundary planes into
// its z pads (up to PZ deep).  A slab synthesizes the physical BC ghost
// of a z face only where it owns that face (gate 1: the first slab's low
// face, the last one's high face) and the z axis is not periodic; every
// other z neighbour outside [0, Z), on a periodic axis too, is read from
// the pad plane itself, not wrapped inside the slab.  A kernel argument
// of its own, passed last, so that the parameter layout of every other
// kernel stays what it was.
struct SlabParams {
  int gate[2];        // (lo, hi): 1 where this slab owns the physical z face
};

// OMG_SLABAP (slab apply and prolongation) 0 builds the slab apply and
// residual (constant coefficients) on stream_kernel.cuh and the slab
// prolongation on its thread-per-coarse-cell kernel, the designs before
// the face-plane apply (apply_faces.cuh with SLAB = 1) and the pair
// prolongation (prolong_correct.cu), for
// experiments/probe_torch_kernels.py slab_apply and chip_smoke.py to hold
// the two against each other.
#ifndef OMG_SLABAP
#define OMG_SLABAP 1
#endif

// OMG_SLABEPS (coefficient slabs) 0 builds the float32 coefficient slab
// double pair, apply and residual (n_eps 1 and 3) on stream_kernel.cuh,
// the design before the face-plane ones (stream_faces.cuh and
// apply_faces.cuh with SLAB = 1), for experiments/probe_torch_kernels.py
// slab_eps and chip_smoke.py to hold the two against each other.
#ifndef OMG_SLABEPS
#define OMG_SLABEPS 1
#endif

// OMG_HALFAF (half-sweep) 0 builds one half-sweep (half_sweep_dense) on
// stream_kernel.cuh's wavefront (NS = 1), the design before the register
// march (stencil_sweep.cu), and OMG_DF32MARCH 0 builds every double-float
// residual (residual_df32.cu, both modes) as one thread per cell reading
// its neighbourhoods from device memory, the design before the z-march on
// large levels and slabs: for experiments/probe_torch_kernels.py half and
// df32_march and chip_smoke.py to hold the two against each other.
#ifndef OMG_HALFAF
#define OMG_HALFAF 1
#endif
#ifndef OMG_DF32MARCH
#define OMG_DF32MARCH 1
#endif

// Whether the low / high z face of a slab synthesizes its BC ghost
// (else its neighbours beyond the face are pad planes).
__device__ __forceinline__ bool slab_syn(const LevelParams& P,
                                         const SlabParams& Zs, int side) {
  return !P.per[2] && Zs.gate[side] != 0;
}

__device__ __forceinline__ int wrap_idx(int g, int n) {
  g %= n;
  return g < 0 ? g + n : g;
}

// Source index of global coordinate g along a dim of n cells: g itself
// inside the domain, the wrapped index on a periodic dim, -1 otherwise.
__device__ __forceinline__ int src_idx(int g, int n, int per) {
  if (g >= 0 && g < n) return g;
  return per ? wrap_idx(g, n) : -1;
}

__device__ __forceinline__ long long field_off(const LevelParams& P, int sx,
                                                int sy, int sz) {
  return ((long long)(sz + PZ) * (P.Y + 2 * PY) + (sy + PY)) * P.X + sx;
}

// c0*b of face f at the cell with source coordinates (sx, sy, sz).
// Plane layouts: x faces [Z+2PZ, Y+2PY], y faces [Z+2PZ, X],
// z faces [Y+2PY, X].
template <typename T>
__device__ __forceinline__ T face_c0b(const LevelParams& P, int f, int sx,
                                      int sy, int sz) {
  const T* pl = (const T*)P.plane[f];
  if (pl == nullptr) return (T)P.c0b[f];
  long long o;
  if (f < 2) o = (long long)(sz + PZ) * (P.Y + 2 * PY) + (sy + PY);
  else if (f < 4) o = (long long)(sz + PZ) * P.X + sx;
  else o = (long long)(sy + PY) * P.X + sx;
  return (T)P.c0[f] * pl[o];
}

// Ghost value of face f: c0*b + c1*x1 (+ c2*x2 when c2 != 0).
template <typename T>
__device__ __forceinline__ T ghost_val(const LevelParams& P, int f, T c0b,
                                       T x1, T x2) {
  T g = c0b + (T)P.c1[f] * x1;
  if (P.c2[f] != 0.0) g = g + (T)P.c2[f] * x2;
  return g;
}

// (lo, hi) neighbour values along dim d of a cell whose raw neighbours
// are lo_raw/hi_raw, with the BC ghost selected in at the domain faces.
template <typename T>
__device__ __forceinline__ void neighbor_pair(const LevelParams& P, int d,
                                              int g, int n, T p, T lo_raw,
                                              T hi_raw, int sx, int sy,
                                              int sz, T& lo, T& hi) {
  lo = lo_raw;
  hi = hi_raw;
  if (P.per[d]) return;
  if (g == 0)
    lo = ghost_val<T>(P, 2 * d, face_c0b<T>(P, 2 * d, sx, sy, sz), p, hi_raw);
  if (g == n - 1)
    hi = ghost_val<T>(P, 2 * d + 1, face_c0b<T>(P, 2 * d + 1, sx, sy, sz), p,
                      lo_raw);
}

// (lo, hi) z neighbour values of a slab cell at local z = g from its raw
// neighbours (pad planes beyond the slab), with the BC ghost selected in
// only at the faces the slab owns (syn_lo / syn_hi): neighbor_pair's
// arithmetic.
template <typename T>
__device__ __forceinline__ void slab_z_pair(const LevelParams& P, bool syn_lo,
                                            bool syn_hi, int g, T p, T lo_raw,
                                            T hi_raw, int sx, int sy, int sz,
                                            T& lo, T& hi) {
  lo = lo_raw;
  hi = hi_raw;
  if (syn_lo && g == 0)
    lo = ghost_val<T>(P, 4, face_c0b<T>(P, 4, sx, sy, sz), p, hi_raw);
  if (syn_hi && g == P.Z - 1)
    hi = ghost_val<T>(P, 5, face_c0b<T>(P, 5, sx, sy, sz), p, lo_raw);
}

// A(phi) at one cell whose (lo, hi) pairs are already there:
// out = -lam*p; out += idr2[d]*(lo + hi - 2p) for d = x, y, z.
template <typename T>
__device__ __forceinline__ T apply_from(const LevelParams& P, T p,
                                        const T lo[3], const T hi[3]) {
  T two_p = (T)2 * p;
  T out = (T)P.neg_lam * p;
  out = out + (T)P.idr2[0] * (lo[0] + hi[0] - two_p);
  out = out + (T)P.idr2[1] * (lo[1] + hi[1] - two_p);
  out = out + (T)P.idr2[2] * (lo[2] + hi[2] - two_p);
  return out;
}

// ---- variable coefficients (n_eps 1: vlaplacian/vhelmholtz, 3:
// ahelmholtz) ----
//
// Coefficient fields are read-only for a whole launch, so they need no
// ring in shared memory: a cell reads its own value and its neighbours'
// straight from device memory through the read-only path.  Their ghosts
// are the Neumann-zero mirror (the cell's own value) at physical faces
// and the wrapped neighbour on periodic axes; no pad is read.

// Source index of the low / high coefficient neighbour of source index s
// along a dim of n cells.
__device__ __forceinline__ int eps_lo_idx(int s, int n, int per) {
  return s > 0 ? s - 1 : (per ? n - 1 : s);
}
__device__ __forceinline__ int eps_hi_idx(int s, int n, int per) {
  return s < n - 1 ? s + 1 : (per ? 0 : s);
}

// The six harmonic-mean face coefficients of a cell with source
// coordinates (sx, sy, sz): c[2d] low side, c[2d+1] high side of dim d,
// each ((2*e0)*e_nb)/(e0 + e_nb)*idr2[d] rounded once per operation as
// in the plain version (IEEE division: no fast-math flag).  Dim d reads
// field 0 (NE = 1) or field d (NE = 3).  SLAB: sz is the raw local z (a
// halo cell's is outside [0, Z)), and a z neighbour beyond a face that
// does not synthesize (syn_lo / syn_hi 0) is the pad plane's value.
template <typename T, int NE, int SLAB = 0>
__device__ __forceinline__ void face_coeffs(const LevelParams& P,
                                            const EpsParams& E, int sx,
                                            int sy, int sz, T c[6],
                                            bool syn_lo = false,
                                            bool syn_hi = false) {
  const long long plane = (long long)(P.Y + 2 * PY) * P.X;
  const long long zo = (long long)(sz + PZ) * plane;
  const long long yo = (long long)(sy + PY) * P.X;
  const long long o = zo + yo + sx;
  const long long lo[3] = {
      zo + yo + eps_lo_idx(sx, P.X, P.per[0]),
      zo + (long long)(eps_lo_idx(sy, P.Y, P.per[1]) + PY) * P.X + sx,
      (long long)((SLAB != 0 ? (sz > 0 || !syn_lo ? sz - 1 : sz)
                             : eps_lo_idx(sz, P.Z, P.per[2])) + PZ) * plane +
          yo + sx};
  const long long hi[3] = {
      zo + yo + eps_hi_idx(sx, P.X, P.per[0]),
      zo + (long long)(eps_hi_idx(sy, P.Y, P.per[1]) + PY) * P.X + sx,
      (long long)((SLAB != 0 ? (sz < P.Z - 1 || !syn_hi ? sz + 1 : sz)
                             : eps_hi_idx(sz, P.Z, P.per[2])) + PZ) * plane +
          yo + sx};
  T e0 = (T)0;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const T* e = (const T*)E.f[NE == 1 ? 0 : d];
    if (NE != 1 || d == 0) e0 = __ldg(e + o);
    const T el = __ldg(e + lo[d]), eh = __ldg(e + hi[d]);
    const T idr2 = (T)P.idr2[d];
    c[2 * d] = (T)2 * e0 * el / (e0 + el) * idr2;
    c[2 * d + 1] = (T)2 * e0 * eh / (e0 + eh) * idr2;
  }
}

// GSRB update with coefficients: (-rhs + sum c*nbr) / (lam + sum c),
// accumulated per dim x, y, z, low side first.
template <typename T>
__device__ __forceinline__ T eps_update(const LevelParams& P, T rhs,
                                        const T c[6], const T lo[3],
                                        const T hi[3]) {
  T num = -rhs;
  T den = -(T)P.neg_lam;            // lam, exactly as rounded on the host
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    num = num + c[2 * d] * lo[d];
    den = den + c[2 * d];
    num = num + c[2 * d + 1] * hi[d];
    den = den + c[2 * d + 1];
  }
  return num / den;
}

// A(phi) with coefficients: out = -lam*p; out += c*(nbr - p) per side.
template <typename T>
__device__ __forceinline__ T eps_apply(const LevelParams& P, T p,
                                       const T c[6], const T lo[3],
                                       const T hi[3]) {
  T out = (T)P.neg_lam * p;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    out = out + c[2 * d] * (lo[d] - p);
    out = out + c[2 * d + 1] * (hi[d] - p);
  }
  return out;
}

// Segment synthesis of the (lo, hi) neighbours along dim d of a cell
// with source coordinates (sx, sy, sz) and value v, from its raw
// neighbours: descriptor jlo (or -1) serves the low side, jhi the high
// side.  The raw values of the other side are the x2 of the formula.
template <typename T>
__device__ __forceinline__ void seg_pair(const LevelParams& P,
                                         const SegParams& S, int d, int jlo,
                                         int jhi, int sx, int sy, int sz, T v,
                                         T lo_raw, T hi_raw, T& lo, T& hi) {
  lo = lo_raw;
  hi = hi_raw;
  if (jlo < 0 && jhi < 0) return;
  const long long YP = P.Y + 2 * PY, ZP = P.Z + 2 * PZ;
  long long o, st;
  if (d == 0) { o = (sz + PZ) * YP + (sy + PY); st = ZP * YP; }
  else if (d == 1) { o = (long long)(sz + PZ) * P.X + sx; st = ZP * P.X; }
  else { o = (long long)(sy + PY) * P.X + sx; st = YP * P.X; }
  if (jlo >= 0) {
    const T* a = (const T*)S.plane[jlo] + o;
    if (__ldg(a + 3 * st) != (T)0)
      lo = (__ldg(a) + __ldg(a + st) * v) + __ldg(a + 2 * st) * hi_raw;
  }
  if (jhi >= 0) {
    const T* a = (const T*)S.plane[jhi] + o;
    if (__ldg(a + 3 * st) != (T)0)
      hi = (__ldg(a) + __ldg(a + st) * v) + __ldg(a + 2 * st) * lo_raw;
  }
}

// seg_pair's substitution for the designs that look their descriptors up
// once per thread and stage the descriptors' plane pointers in shared
// memory.  One side: a points into a layer's [4, T1, T2] planes at the
// reader's offset (st: one plane); where the layer's mask is set, the
// neighbour becomes (a0 + a1*v) + a2*x2, v the reader, x2 its raw
// neighbour on the other side.  The four loads are independent (one
// latency, not two), the mask selects.  I: the offsets' type (int where
// the plane fits it and the caller's registers are scarce).
template <typename T, typename I>
__device__ __forceinline__ void seg_side(const T* a, I st, T v, T x2,
                                         T& out) {
  const T m = __ldg(a + 3 * st), a0 = __ldg(a), a1 = __ldg(a + st),
          a2 = __ldg(a + 2 * st);
  if (m != (T)0) out = (a0 + a1 * v) + a2 * x2;
}

// Both sides of a reader with value v along one dim from descriptors jlo,
// jhi (-1: none) whose plane pointers are pl[j]: (lo, hi) raw on entry,
// o the reader's offset in its dim's face-plane layout (as in seg_pair).
// Each ghost takes the other side's raw value as x2.
template <typename T, typename I>
__device__ __forceinline__ void seg_sub(const T* const* pl, int jlo, int jhi,
                                        I o, I st, T v, T& lo, T& hi) {
  const T lo_raw = lo, hi_raw = hi;
  if (jlo >= 0) seg_side<T>(pl[jlo] + o, st, v, hi_raw, lo);
  if (jhi >= 0) seg_side<T>(pl[jhi] + o, st, v, lo_raw, hi);
}

// Byte k of a word of four packed bytes (0xff: none), and the word with
// byte k set to v (0 .. 0xff; a descriptor -1 packs as 0xff).
__device__ __forceinline__ unsigned seg_byte(unsigned w, int k) {
  return (w >> (8 * k)) & 0xffu;
}
__device__ __forceinline__ unsigned seg_put(unsigned w, int k, int v) {
  return (w & ~(0xffu << (8 * k))) | ((unsigned)(v & 0xff) << (8 * k));
}

// A descriptor of a packed byte: -1 for none.
__device__ __forceinline__ int seg_desc(unsigned b) {
  return b == 0xffu ? -1 : (int)b;
}

// Four consecutive values at a 16-byte aligned address
template <typename T>
__device__ __forceinline__ void af_ld4(const T* p, T (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
}

template <typename T>
__device__ __forceinline__ void af_st4(T* p, const T (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  }
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline unsigned cdiv(int a, int b) { return (unsigned)((a + b - 1) / b); }
