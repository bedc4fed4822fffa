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
// red_parity, every other cell copied.  The dense forest's sequential
// smoother calls it between ghost refreshes, with its ghosts in the six
// plane-valued faces.  Bound: bytes (phi and rhs read, the output
// written, 12 B per cell in float32).  A half-sweep has no dependence
// between planes: a cell of one colour reads only the other colour, and
// every read is of the input.  So it runs a register march with no
// shared memory and no barrier (half_march_kernel below, every launch),
// where it ran the NS = 1 instantiation of stream_kernel.cuh's wavefront
// (a ring in shared memory, a barrier per plane), which now builds only
// with -DOMG_HALFAF=0, the probe's old design: 0.094 against 0.122 ms
// at 256^3 float32 on an H100, 0.014 against 0.017 at 128^3 (device
// time, PERF.md, experiments/probe_torch_kernels.py half).
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

// ---- one half-sweep as a register march: no shared memory, no barrier --
//
// A block owns a 64 x 16 tile of (x, y) and a chunk of z planes; a thread
// owns four x-adjacent cells of one row (sixteen threads a row, two rows
// a warp) and marches up its chunk with phi's planes r-1, r and r+1 of
// its cells in registers, plane r+2 loaded one step ahead.  Its x
// neighbours come from the threads beside it (a warp shuffle within the
// row, a load at the tile's edges), its y neighbours are loads of the
// rows above and below, which the warps of those rows load as their own
// (L1 serves them).  Warps never wait for each other, so the loads of
// many planes are in flight at once; that is what the ring's barrier per
// plane did not allow.  Chunks shorten until a launch has HR_BPS blocks
// per SM (the register cap leaves room for 4 float32 blocks, 64
// registers, or 2 float64): more, shorter chunks were faster at 256^3
// than fewer, longer ones in the probe's trials (PERF.md).  The faces
// are synthesized as in apply_faces.cuh (neighbor_pair); the update is
// stream_kernel.cuh's, in the plain version's order.
constexpr int HR_C = 4, HR_TX = 64, HR_TY = 16, HR_HT = HR_TX / HR_C;
constexpr int HR_NT = HR_HT * HR_TY;
constexpr int HR_CHUNK_Z = 64, HR_MIN_CZ = 2, HR_BPS = 8;

template <typename T>
__global__ void __launch_bounds__(HR_NT, sizeof(T) == 4 ? 4 : 2)
half_march_kernel(LevelParams P, int cz, int vec, const T* __restrict__ phi,
                  const T* __restrict__ rhs, T* __restrict__ out) {
  constexpr int C = HR_C, HT = HR_HT;
  const int X = P.X, Y = P.Y, Z = P.Z;
  const int x0 = blockIdx.x * HR_TX, y0 = blockIdx.y * HR_TY;
  const int zb = blockIdx.z * cz;
  const int ze = zb + cz < Z ? zb + cz : Z;
  const int h = threadIdx.x % HT, ty = threadIdx.x / HT;
  const int gx0 = x0 + C * h, gy = y0 + ty;
  const int px = P.per[0], py = P.per[1];
  const int sy = src_idx(gy, Y, py), sym = src_idx(gy - 1, Y, py),
            syp = src_idx(gy + 1, Y, py);
  const bool ovec = vec != 0 && gx0 + C <= X;
  int sx[C];
  bool in[C], xyf[C];
  const bool yface = !py && (gy == 0 || gy == Y - 1);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int g = gx0 + c;
    sx[c] = src_idx(g, X, px);
    in[c] = g < X && gy < Y;
    xyf[c] = in[c] && (yface || (!px && (g == 0 || g == X - 1)));
  }
  const int sxl = src_idx(gx0 - 1, X, px), sxh = src_idx(gx0 + C, X, px);
  const long long gplane = (long long)(Y + 2 * PY) * X;
  const T idx2 = (T)P.idr2[0], idy2 = (T)P.idr2[1], idz2 = (T)P.idr2[2];
  const T inv_den = (T)P.inv_den;
  // row offsets inside a plane (-1: the row has no source, zeros)
  auto roff = [&](int s) { return s < 0 ? -1LL : (long long)(s + PY) * X; };
  const long long oc = roff(sy), om = roff(sym), op = roff(syp);
  // the four cells at row offset o of the plane at offset zo (-1: zeros)
  auto row4 = [&](const T* f, long long zo, long long o, T (&v)[C]) {
    if (zo < 0 || o < 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = (T)0;
      return;
    }
    const T* p = f + zo + o;
    if (ovec) {
      af_ld4<T>(p + gx0, v);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = sx[c] >= 0 ? p[sx[c]] : (T)0;
    }
  };
  // the offset of the source plane of plane q, or -1
  auto plane = [&](int q) {
    const int sq = src_idx(q, Z, P.per[2]);
    return sq < 0 ? -1LL : (long long)(sq + PZ) * gplane;
  };
  T m[C], cc[C], n[C];
  row4(phi, plane(zb - 1), oc, m);
  row4(phi, plane(zb), oc, cc);
  row4(phi, plane(zb + 1), oc, n);
  for (int r = zb; r < ze; ++r) {
    T q[C] = {};
    if (r + 2 <= ze) row4(phi, plane(r + 2), oc, q);
    const long long zr = (long long)(r + PZ) * gplane;
    T yl[C], yh[C], rr[C];
    row4(phi, zr, om, yl);
    row4(phi, zr, op, yh);
    row4(rhs, zr, oc, rr);
    T xl = __shfl_up_sync(0xffffffffu, cc[C - 1], 1, HT);
    T xh = __shfl_down_sync(0xffffffffu, cc[0], 1, HT);
    if (h == 0) xl = oc >= 0 && sxl >= 0 ? phi[zr + oc + sxl] : (T)0;
    if (h == HT - 1) xh = oc >= 0 && sxh >= 0 ? phi[zr + oc + sxh] : (T)0;
    const bool zf = !P.per[2] && (r == 0 || r == Z - 1);
    T a[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const T v = cc[c];
      T lo[3] = {c ? cc[c - 1] : xl, yl[c], m[c]};
      T hi[3] = {c < C - 1 ? cc[c + 1] : xh, yh[c], n[c]};
      if (xyf[c] || (zf && in[c])) {
        const int g = gx0 + c;
        T l, u;
        neighbor_pair<T>(P, 0, g, X, v, lo[0], hi[0], g, gy, r, l, u);
        lo[0] = l; hi[0] = u;
        neighbor_pair<T>(P, 1, gy, Y, v, lo[1], hi[1], g, gy, r, l, u);
        lo[1] = l; hi[1] = u;
        neighbor_pair<T>(P, 2, r, Z, v, lo[2], hi[2], g, gy, r, l, u);
        lo[2] = l; hi[2] = u;
      }
      T acc = -rr[c];
      acc = acc + idx2 * (lo[0] + hi[0]);
      acc = acc + idy2 * (lo[1] + hi[1]);
      acc = acc + idz2 * (lo[2] + hi[2]);
      a[c] = ((gx0 + c + gy + r) & 1) == P.red_parity ? acc * inv_den : v;
    }
    if (gy < Y) {
      T* o = out + zr + (long long)(gy + PY) * X;
      if (ovec) {
        af_st4<T>(o + gx0, a);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (in[c]) o[gx0 + c] = a[c];
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      m[c] = cc[c];
      cc[c] = n[c];
      n[c] = q[c];
    }
  }
}

template <typename T>
static int launch_half_march(const LevelParams& P, const void* phi,
                             const void* rhs, void* out, cudaStream_t s) {
  auto al = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const int vec = (P.X * (int)sizeof(T)) % 16 == 0 && al(phi) && al(rhs) &&
                  al(out);
  int cz = HR_CHUNK_Z;
  while (cz > HR_MIN_CZ &&
         cdiv(P.X, HR_TX) * cdiv(P.Y, HR_TY) * cdiv(P.Z, cz) <
             HR_BPS * (unsigned)wide_sms())
    cz /= 2;
  dim3 grid(cdiv(P.X, HR_TX), cdiv(P.Y, HR_TY), cdiv(P.Z, cz));
  half_march_kernel<T><<<grid, HR_NT, 0, s>>>(P, cz, vec, (const T*)phi,
                                              (const T*)rhs, (T*)out);
  return (int)cudaGetLastError();
}

// One half-sweep: the register march (*design = 4), every launch; with
// -DOMG_HALFAF=0 stream_kernel.cuh's wavefront (NS = 1), the design before.
template <typename T>
static int launch_half(const LevelParams& P, const EpsParams& E,
                       const void* phi, const void* rhs, void* out,
                       cudaStream_t s, int* design) {
#if OMG_HALFAF
  (void)E;
  *design = 4;
  return launch_half_march<T>(P, phi, rhs, out, s);
#else
  return launch_stream<T, 1, M_PAIRS, 0>(P, E, 0, phi, rhs, out, nullptr, nullptr, s);
#endif
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
      return launch_half<T>(P, E, phi, rhs, out, s, design);
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
// modes 1 and 2), 4 where one half-sweep ran the register march, else 0.
// Returns the cudaError_t of the launch.
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
