// The z-streaming stencil kernel behind K1 (stencil_sweep.cu) and K2
// (downsweep.cu).
//
// A block owns a TX x TY tile of (x, y) with an H-deep halo and marches
// through a chunk of cz planes in z (64, fewer on small levels).  Planes
// live in a ring of NB slots in shared memory (phi and rhs).  One thread
// owns one pair of x-adjacent cells (one red, one black) of the tile
// window for the whole march, so every index, ring depth and face flag
// of its cells is computed once; the hot loop has no division and no
// decode.
//
// The NS half-sweeps run as a wavefront, two planes apart: in step t the
// block loads plane t+1 and applies half-sweep s to plane t-1-2s, for
// every s at once.  Half-sweep s of a plane reads the other colour of
// the planes next to it, which are at even distance from every plane
// written in the same step, and a cell of one colour reads only cells of
// the other: so all NS half-sweeps of a step are independent, update in
// place, and need ONE barrier per step.  In x and y each half-sweep
// shrinks the valid ring by one, as in a brick; in z the halo costs only
// 2H planes per chunk.  After its last half-sweep a plane is written out
// (PAIRS), or goes through a residual stage two steps later (APPLY,
// RESIDUAL, DOWN); DOWN keeps two residual planes and restricts phi and
// the residual of each plane pair from shared memory.
//
// Arithmetic per cell is that of the plain PyTorch versions, operation by
// operation (see stencil_common.cuh).
//
// The NS = 1 instantiation (one half-sweep, half_sweep_dense) builds only
// with -DOMG_HALFAF=0, the probe's old design: every half-sweep runs the
// register march of stencil_sweep.cu.
//
// NE (0, 1 or 3) is the number of coefficient fields.  NE = 0 is the
// constant-coefficient stencil; NE > 0 (vlaplacian/vhelmholtz,
// ahelmholtz) replaces the update and the apply by their harmonic-mean
// forms and reads the coefficients of a cell and its six neighbours from
// device memory at every update (face_coeffs): the ring, the wavefront
// and the geometry are the same for every NE, and the NE = 0 code paths
// are untouched.  These NE > 0 instantiations run the float64 double
// pair and down-leg (whose face rings would not fit a block in float64)
// and the float64 slab variants.  The float32 double pair and down-leg
// with its fine output run stream_faces.cuh, and the apply, the residual
// and residual_restrict_dense apply_faces.cuh in both dtypes, the float32
// slab double pair, apply and residual the SLAB = 1 modes of the same
// two: they build each face once per plane and were faster at every
// level and slab they take (PERF.md).  The float32 NE > 0 slab double
// pairs here are instantiated only in the probe's -DOMG_SLABEPS=0 build;
// the float32 NE > 0 slab apply and residual run the slabs of fewer than
// 2^15 cells (af_eps_slab_takes, apply_faces.cuh).  The NE > 0 apply, residual and residual-restriction here
// are instantiated only in the probe's -DOMG_FACES=0 build, and so is the
// NE = 0 residual-restriction (MODE M_DOWN with NS = 0), which
// apply_faces.cuh runs too.
//
// SEG = 1 is the segment-synthesis variant of the dense forest's
// fused-canvas path (NE = 0 only): no physical-face synthesis at all;
// x is periodic (wrapped indices), a y or z neighbour outside the canvas
// reads 0, and a reader next to one of the canvas's ghost layers
// substitutes that layer's ghost (seg_pair, stencil_common.cuh).  The
// SEG = 0 code paths are untouched.  It runs the float64 segment launches
// and the float32 double pair on canvases below 256^3; the float32 double
// pair from 256^3 up runs stream_wide.cuh's SEG = 1, and the float32 apply
// and residual apply_faces.cuh's, which were faster (seg_sweep.cu).  Its
// float32 apply and residual are instantiated only in the probe's
// -DOMG_SEGWIDE=0 build.
//
// SLAB = 1 is the z-slab variant (any NE, SEG = 0; SlabParams,
// stencil_common.cuh): the planes beyond a z face that does not
// synthesize its ghost are loaded from the z pads, H deep, and swept
// redundantly like the halo planes between two chunks, each half-sweep
// one plane shallower (a double pair sweeps 3 pad planes and reads 4);
// only core planes are written.  A halo plane's cells keep their local
// z (negative below the slab): parity, BC-plane rows and coefficient
// reads follow from it.  The SLAB = 0 code paths are untouched.  The
// constant-coefficient double pair on a large slab runs stream_wide.cuh's
// SLAB = 1 instead (wide_slab_takes), and the float32 coefficient pair
// stream_faces.cuh's; the constant-coefficient edge strips of an
// overlapped pair group, smaller slabs and float64 run this one.
#pragma once
#include "stencil_common.cuh"

// Tile of (x, y) cells per block and most planes per z chunk: 32x16x64 is
// within 10 % of the best of nine shapes tried at 512^3 float32 and is
// the largest whose float64 down-leg ring still fits shared memory.  A
// launch shortens its chunks until it has MIN_BLOCKS_PER_SM blocks per
// SM (0: never).  experiments/probe_torch_kernels.py rebuilds with other
// values of these four to measure them; nothing else overrides them.
#ifndef OMG_TILE_X
#define OMG_TILE_X 32
#endif
#ifndef OMG_TILE_Y
#define OMG_TILE_Y 16
#endif
#ifndef OMG_CHUNK_Z
#define OMG_CHUNK_Z 64
#endif
#ifndef OMG_MIN_BLOCKS_PER_SM
#define OMG_MIN_BLOCKS_PER_SM 2
#endif
constexpr int TILE_X = OMG_TILE_X, TILE_Y = OMG_TILE_Y, CHUNK_Z = OMG_CHUNK_Z;
constexpr unsigned MIN_BLOCKS_PER_SM = OMG_MIN_BLOCKS_PER_SM;

enum { M_PAIRS = 0, M_APPLY = 1, M_RESIDUAL = 2, M_DOWN = 3 };

template <int NS, int MODE>
struct Geo {
  static constexpr bool RES = MODE != M_PAIRS;   // has a residual stage
  static constexpr int H = NS + (RES ? 1 : 0);   // halo in x, y and z
  static constexpr int TX = TILE_X, TY = TILE_Y;
  static constexpr int WX = TX + 2 * H, WY = TY + 2 * H;
  static constexpr int HX = WX / 2;              // cell pairs per row
  static constexpr int NT = HX * WY;             // threads: one per pair
  static constexpr int PL = WX * WY;             // cells per plane
  static constexpr int NB = 2 * NS + (RES ? 4 : 2);  // planes in the ring
  static constexpr bool RHS = MODE != M_APPLY;   // rhs is read
  static_assert(TX % 2 == 0 && TY % 2 == 0 && CHUNK_Z % 8 == 0, "even tiles");
  static_assert(NT <= 1024, "one thread per pair must fit a block");
  static size_t smem_bytes(size_t item) {
    return item * ((RHS ? 2 : 1) * (size_t)NB * PL +
                   (MODE == M_DOWN ? 2 * TX * TY : 0));
  }
};

template <typename T, int NS, int MODE, int NE, int SEG, int SLAB>
__global__ void __launch_bounds__(Geo<NS, MODE>::NT)
stream_kernel(LevelParams P, int cz, int fine_out, const T* __restrict__ phi,
              const T* __restrict__ rhs, T* __restrict__ out,
              T* __restrict__ phic_out, T* __restrict__ iresc_out,
              EpsParams E, SegParams S, SlabParams Zs) {
  static_assert(SEG == 0 || NE == 0, "segment synthesis: constant "
                "coefficients only");
  static_assert(SLAB == 0 || (SEG == 0 && MODE != M_DOWN),
                "slab variants: no segments, no down-leg");
  using G = Geo<NS, MODE>;
  constexpr int H = G::H, WX = G::WX, PL = G::PL, NB = G::NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_phi = reinterpret_cast<T*>(smem_raw);
  T* s_rhs = s_phi + NB * PL;                       // when G::RHS
  T* s_res = s_rhs + (G::RHS ? NB * PL : 0);        // when M_DOWN

  const int x0 = blockIdx.x * G::TX, y0 = blockIdx.y * G::TY;
  const int zb = blockIdx.z * cz;                  // this block's z chunk
  const int ze = zb + cz < P.Z ? zb + cz : P.Z;

  // ---- this thread's pair: everything that does not depend on z ----
  const int hx = threadIdx.x % G::HX, ly = threadIdx.x / G::HX;
  const int lx = 2 * hx;
  const int gx = x0 - H + lx, gy = y0 - H + ly;     // cell a; cell b = gx+1
  const int i0 = ly * WX + lx;                      // shared index of cell a
  const int sy = src_idx(gy, P.Y, P.per[1]);
  const int sxs[2] = {sy < 0 ? -1 : src_idx(gx, P.X, P.per[0]),
                      sy < 0 ? -1 : src_idx(gx + 1, P.X, P.per[0])};
  const int ry = ly < G::WY - 1 - ly ? ly : G::WY - 1 - ly;
  int ring[2], core[2], face[2];
  long long goff[2];                                // offset inside a plane
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int l = lx + c, g = gx + c;
    const int rx = l < WX - 1 - l ? l : WX - 1 - l;
    ring[c] = rx < ry ? rx : ry;
    core[c] = l >= H && l < H + G::TX && ly >= H && ly < H + G::TY &&
              g < P.X && gy < P.Y;
    face[c] = (!P.per[0] && (g == 0 || g == P.X - 1)) ||
              (!P.per[1] && (gy == 0 || gy == P.Y - 1));
    goff[c] = sxs[c] < 0 ? 0 : (long long)(sy + PY) * P.X + sxs[c];
  }
  const long long gplane = (long long)(P.Y + 2 * PY) * P.X;
  // SEG: the descriptors serving this thread's cells along x (per cell,
  // low and high side) and y
  int jx[2][2] = {{-1, -1}, {-1, -1}}, jy[2] = {-1, -1};
  if constexpr (SEG != 0) {
    if (sy >= 0) {
      jy[0] = __ldg(S.lut + 2 * P.X + 2 * sy);
      jy[1] = __ldg(S.lut + 2 * P.X + 2 * sy + 1);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if (sxs[c] >= 0) {
        jx[c][0] = __ldg(S.lut + 2 * sxs[c]);
        jx[c][1] = __ldg(S.lut + 2 * sxs[c] + 1);
      }
  }
  // SLAB: the z faces this slab synthesizes (else it reads their pads)
  const bool zsyn_lo = SLAB != 0 && slab_syn(P, Zs, 0);
  const bool zsyn_hi = SLAB != 0 && slab_syn(P, Zs, 1);
  const int pb = (gx + gy) & 1;                     // parity of cell a at z = 0
  const T idx2 = (T)P.idr2[0], idy2 = (T)P.idr2[1], idz2 = (T)P.idr2[2];
  const T inv_den = (T)P.inv_den;

  // Ring slot (cell offset) of plane t+1-k in step t, 0 <= k < NB: the
  // slot of the incoming plane t+1 advances by one per step, so no step
  // divides.
  int slot_in = 0;
  auto slot = [&](int k) {
    const int o = slot_in - k * PL;
    return o < 0 ? o + NB * PL : o;
  };

  // (lo, hi) of a cell of plane p = t+1-k: plain loads off the faces
  auto neighbors = [&](int p, int k, bool xyface, int sx, int g, int i, T v,
                       T lo[3], T hi[3]) {
    const int sc = slot(k), sm = slot(k + 1), sp = slot(k - 1);
    const T xl = s_phi[sc + i - 1], xh = s_phi[sc + i + 1];
    const T yl = s_phi[sc + i - WX], yh = s_phi[sc + i + WX];
    const T zl = s_phi[sm + i], zh = s_phi[sp + i];
    bool zface;
    if constexpr (SLAB != 0)
      zface = (zsyn_lo && p == 0) || (zsyn_hi && p == P.Z - 1);
    else
      zface = !P.per[2] && (p == 0 || p == P.Z - 1);
    if (!(xyface || zface)) {
      lo[0] = xl; hi[0] = xh; lo[1] = yl; hi[1] = yh; lo[2] = zl; hi[2] = zh;
      return;
    }
    const int sz = SLAB != 0 ? p : src_idx(p, P.Z, P.per[2]);
    neighbor_pair<T>(P, 0, g, P.X, v, xl, xh, sx, sy, sz, lo[0], hi[0]);
    neighbor_pair<T>(P, 1, gy, P.Y, v, yl, yh, sx, sy, sz, lo[1], hi[1]);
    if constexpr (SLAB != 0)
      slab_z_pair<T>(P, zsyn_lo, zsyn_hi, p, v, zl, zh, sx, sy, sz, lo[2],
                     hi[2]);
    else
      neighbor_pair<T>(P, 2, p, P.Z, v, zl, zh, sx, sy, sz, lo[2], hi[2]);
  };

  // SEG: (lo, hi) of cell c of plane p = t+1-k (0 <= p < Z): raw loads,
  // then the ghost layers' substitutions
  auto seg_neighbors = [&](int p, int k, int c, int i, T v, T lo[3],
                           T hi[3]) {
    const int sc = slot(k), sm = slot(k + 1), sp = slot(k - 1);
    const T xl = s_phi[sc + i - 1], xh = s_phi[sc + i + 1];
    const T yl = s_phi[sc + i - WX], yh = s_phi[sc + i + WX];
    const T zl = s_phi[sm + i], zh = s_phi[sp + i];
    const int sx = c ? sxs[1] : sxs[0];
    const int* lz = S.lut + 2 * (P.X + P.Y) + 2 * p;
    seg_pair<T>(P, S, 0, c ? jx[1][0] : jx[0][0], c ? jx[1][1] : jx[0][1],
                sx, sy, p, v, xl, xh, lo[0], hi[0]);
    seg_pair<T>(P, S, 1, jy[0], jy[1], sx, sy, p, v, yl, yh, lo[1], hi[1]);
    seg_pair<T>(P, S, 2, __ldg(lz), __ldg(lz + 1), sx, sy, p, v, zl, zh,
                lo[2], hi[2]);
  };

  const int t_last = G::RES ? ze + 2 * NS : ze - 1 + 2 * NS;
  for (int t = zb - H - 1; t <= t_last;
       ++t, slot_in = slot_in + PL == NB * PL ? 0 : slot_in + PL) {
    // ---- A. fetch plane t+1 into registers ----
    const int pin = t + 1;
    const bool loading = pin <= ze - 1 + H;
    T va[2] = {(T)0, (T)0}, qa[2] = {(T)0, (T)0};
    if (loading) {
      // SLAB: a plane beyond a face that does not synthesize is its pad
      int sz;
      bool have;
      if constexpr (SLAB != 0) {
        sz = pin;
        have = !((zsyn_lo && pin < 0) || (zsyn_hi && pin >= P.Z));
      } else {
        sz = src_idx(pin, P.Z, P.per[2]);
        have = sz >= 0;
      }
      if (have) {
        const long long zo = (long long)(sz + PZ) * gplane;
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (sxs[c] >= 0) {
            va[c] = phi[zo + goff[c]];
            if (G::RHS) qa[c] = rhs[zo + goff[c]];
          }
      }
    }

    // ---- B. half-sweep s on plane t-1-2s, all s at once ----
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int p = t - 1 - 2 * s;
      // z range in which half-sweep s is still valid, and the plane exists
      if (p < zb - (H - 1 - s) || p > ze - 1 + (H - 1 - s)) continue;
      if constexpr (SLAB != 0) {
        if ((zsyn_lo && p < 0) || (zsyn_hi && p >= P.Z)) continue;
      } else {
        if (!P.per[2] && (p < 0 || p >= P.Z)) continue;
      }
      const int want = (s & 1) ? (P.red_parity ^ 1) : P.red_parity;
      const int c = ((pb + p) & 1) == want ? 0 : 1;   // cell of that colour
      // selects, not indexing: c is only known at run time
      const int sxc = c ? sxs[1] : sxs[0];
      if (sxc < 0 || (c ? ring[1] : ring[0]) <= s) continue;
      const int i = i0 + c, sc = slot(2 + 2 * s);
      const T v = s_phi[sc + i];
      T lo[3], hi[3];
      if constexpr (SEG != 0)
        seg_neighbors(p, 2 + 2 * s, c, i, v, lo, hi);
      else
        neighbors(p, 2 + 2 * s, c ? face[1] : face[0], sxc, gx + c, i, v, lo,
                  hi);
      if constexpr (NE > 0) {
        T cf[6];
        if constexpr (SLAB != 0)
          face_coeffs<T, NE, 1>(P, E, sxc, sy, p, cf, zsyn_lo, zsyn_hi);
        else
          face_coeffs<T, NE>(P, E, sxc, sy, src_idx(p, P.Z, P.per[2]), cf);
        s_phi[sc + i] = eps_update<T>(P, s_rhs[sc + i], cf, lo, hi);
        continue;
      }
      T acc = -s_rhs[sc + i];
      acc = acc + idx2 * (lo[0] + hi[0]);
      acc = acc + idy2 * (lo[1] + hi[1]);
      acc = acc + idz2 * (lo[2] + hi[2]);
      s_phi[sc + i] = acc * inv_den;
    }

    // ---- C. the plane that is finished ----
    constexpr int KR = G::RES ? 2 * NS + 2 : 2 * NS + 1;   // r = t+1-KR
    const int r = t + 1 - KR;
    const bool r_live = r >= zb && r < ze;
    if (r_live) {
      const int sc = slot(KR);
      const long long zo = (long long)(r + PZ) * gplane;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (!core[c]) continue;
        const int i = i0 + c;
        const T v = s_phi[sc + i];
        if (MODE == M_PAIRS) {
          out[zo + goff[c]] = v;
          continue;
        }
        T lo[3], hi[3];
        if constexpr (SEG != 0)
          seg_neighbors(r, KR, c, i, v, lo, hi);
        else
          neighbors(r, KR, face[c], sxs[c], gx + c, i, v, lo, hi);
        T a;
        if constexpr (NE > 0) {
          T cf[6];
          if constexpr (SLAB != 0)
            face_coeffs<T, NE, 1>(P, E, sxs[c], sy, r, cf, zsyn_lo, zsyn_hi);
          else
            face_coeffs<T, NE>(P, E, sxs[c], sy, r, cf);
          a = eps_apply<T>(P, v, cf, lo, hi);
        } else {
          a = apply_from<T>(P, v, lo, hi);
        }
        if (MODE != M_APPLY) a = s_rhs[sc + i] - a;
        if (MODE == M_DOWN) {
          s_res[(r & 1) * (G::TX * G::TY) + (ly - H) * G::TX + (lx + c - H)] = a;
          if (fine_out) out[zo + goff[c]] = v;
        } else {
          out[zo + goff[c]] = a;
        }
      }
    }

    // ---- D. plane t+1 into its slot ----
    if (loading) {
      const int sc = slot_in;
      s_phi[sc + i0] = va[0];
      s_phi[sc + i0 + 1] = va[1];
      if (G::RHS) {
        s_rhs[sc + i0] = qa[0];
        s_rhs[sc + i0 + 1] = qa[1];
      }
    }
    __syncthreads();

    // ---- E. restrict the plane pair (r-1, r): (z0+z1), + y, + x, /8 ----
    if (MODE == M_DOWN && r_live && (r & 1)) {
      constexpr int QX = G::TX / 2, QY = G::TY / 2;
      const int Xc = P.X / 2, Yc = P.Y / 2;
      if (threadIdx.x < QX * QY) {
        const int qx = threadIdx.x % QX, qy = threadIdx.x / QX;
        const int cx = x0 / 2 + qx, cy = y0 / 2 + qy;
        if (cx < Xc && cy < Yc) {
          const long long o =
              ((long long)(r / 2 + PZ) * (Yc + 2 * PY) + (cy + PY)) * Xc + cx;
          {
            const T* s0 = s_phi + slot(KR + 1) + (2 * qy + H) * WX + 2 * qx + H;
            const T* s1 = s_phi + slot(KR) + (2 * qy + H) * WX + 2 * qx + H;
            const T t00 = s0[0] + s1[0], t10 = s0[WX] + s1[WX];
            const T t01 = s0[1] + s1[1], t11 = s0[WX + 1] + s1[WX + 1];
            phic_out[o] = ((t00 + t10) + (t01 + t11)) * (T)0.125;
          }
          {
            const T* s0 = s_res + (2 * qy) * G::TX + 2 * qx;
            const T* s1 = s0 + G::TX * G::TY;
            const T t00 = s0[0] + s1[0], t10 = s0[G::TX] + s1[G::TX];
            const T t01 = s0[1] + s1[1], t11 = s0[G::TX + 1] + s1[G::TX + 1];
            iresc_out[o] = ((t00 + t10) + (t01 + t11)) * (T)0.125;
          }
        }
      }
      __syncthreads();
    }
  }
}

template <typename T, int NS, int MODE, int NE, int SEG = 0, int SLAB = 0>
static int launch_stream(const LevelParams& P, const EpsParams& E,
                         int fine_out, const void* phi, const void* rhs,
                         void* out, void* phic_out, void* iresc_out,
                         cudaStream_t stream, const SegParams* S = nullptr,
                         const SlabParams* Zs = nullptr) {
  using G = Geo<NS, MODE>;
  auto kernel = stream_kernel<T, NS, MODE, NE, SEG, SLAB>;
  const size_t smem = G::smem_bytes(sizeof(T));
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  // a block marches through its chunk plane by plane: on a small level
  // shorter chunks (more blocks, shorter marches) cut the latency, on a
  // large one long chunks keep the 2H halo planes per chunk cheap
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  int cz = CHUNK_Z;
  while (cz > 8 && cdiv(P.X, G::TX) * cdiv(P.Y, G::TY) * cdiv(P.Z, cz) <
                       MIN_BLOCKS_PER_SM * (unsigned)sms)
    cz /= 2;
  dim3 grid(cdiv(P.X, G::TX), cdiv(P.Y, G::TY), cdiv(P.Z, cz));
  kernel<<<grid, G::NT, smem, stream>>>(P, cz, fine_out, (const T*)phi,
                                        (const T*)rhs, (T*)out, (T*)phic_out,
                                        (T*)iresc_out, E,
                                        S ? *S : SegParams{},
                                        Zs ? *Zs : SlabParams{});
  return (int)cudaGetLastError();
}
