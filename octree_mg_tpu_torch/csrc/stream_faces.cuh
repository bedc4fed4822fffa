// The face-plane z-streaming kernel: the variable-coefficient double pair
// (pair_sweep_dense with n_eps 1 or 3, n_pairs 1 or 2) of K1
// (stencil_sweep.cu) and the fused down-leg (downsweep_dense with n_eps 1
// or 3 and its fine output) of K2 (downsweep.cu), float32, no segments;
// and the double pair on one slab of the z-slab solver (SLAB = 1,
// omg_stencil_slab of stencil_sweep.cu).  The coefficient apply, residual
// and residual_restrict_dense run apply_faces.cuh, which builds its faces
// the same way without a wavefront; every other coefficient launch of the
// two sources (the float64 double pair and down-leg, float64 slabs) runs
// stream_kernel.cuh.
//
// Replaces, with stream_kernel.cuh, the eps bodies of the Pallas entry
// points pair_sweep_dense and downsweep_dense of the JAX package's
// ops/dense_kernels.py (_halfsweep and _apply_expr with eps).  Bound:
// bytes (12 B per cell in float32 plus 4 B per coefficient field, 13 B
// plus 4 B for the down-leg).
//
// The march, the ring and the wavefront are stream_kernel.cuh's (one
// thread per x pair of a tile with its halo; in step t plane t+1 is
// loaded and half-sweep s runs on plane t-1-2s, all s at once, one
// barrier per step).  What differs is where the coefficients come from.
// stream_kernel.cuh builds the six harmonic means of a cell at every
// update, from seven or nine scattered reads of the coefficient fields
// and six divisions.  Here each face is built once per plane:
//
// * The face coefficient ((2*e0)*e_nb)/(e0 + e_nb)*idr2[d] is bitwise
//   symmetric in its two cells: 2*e is exact (while it is finite), the
//   product of the same two values is rounded once either way, and IEEE
//   addition commutes.  So a cell's high face along d is its high
//   neighbour's low face, and a cell needs only the low faces of itself
//   and of its three high neighbours.
// * When plane t+1 is loaded, each thread reads the coefficients of its
//   two cells and of their low x and y neighbours (whole rows, the
//   neighbours' mostly from L1), builds the low x and y faces of its two
//   cells and stores them in two face rings beside the phi and rhs rings;
//   the low z face pairs the plane's coefficient with the previous
//   plane's, which the thread kept in a register, and goes into a
//   register array that shifts by one plane per step.  Three divisions
//   per window cell and plane instead of six per update.
// * A face on a non-periodic domain face pairs a cell with itself (the
//   Neumann-zero coefficient ghost of _eps_neighbor_ops): the sources of
//   a face are clamped into the level, so the self-face of cell 0 and
//   the high self-face of cell n-1 (the low face of the window cell at
//   n) come out of the same expression.  A plane-valued coefficient
//   ghost (eps_bc, not ported) would replace the clamped source there.
//
// Shared memory holds four rings (phi, rhs, low x faces, low y faces) of
// 2*NS + 2 planes (the down-leg 2*NS + 4): with two pairs a 32x24 tile
// (205 KB in float32) and the down-leg's 32x16 (214 KB), one block per
// SM.  In float64 the rings do not fit a block, and stream_kernel.cuh
// stays.  On an H100 this design is faster than stream_kernel.cuh at
// every level from 16^3 to 512^3, for n_eps 1 and 3 and one or two
// pairs (PERF.md; experiments/probe_torch_kernels.py faces), so every
// float32 launch of these two takes it.  Tried and slower at 512^3: rhs
// read from device memory instead of its ring (the freed shared memory
// buys a 64x16 tile, not the L1 hits the reads need), and the updates'
// shared-memory stores held back to the end of the step (more
// registers, no gain).
//
// SLAB = 1 (the double pair, SlabParams of stencil_common.cuh) is
// stream_kernel.cuh's z-slab variant on this march: a plane beyond a z
// face that does not synthesize its ghost is loaded from the z pads, phi,
// rhs and the coefficients alike, H = 2*n_pairs deep, and swept
// redundantly like the halo planes between two chunks; only core planes
// are written.  A halo plane's cells keep their local z (negative below
// the slab), from which parity and BC-plane rows follow.  Its z faces are
// built like every other from the coefficient planes as they come in, so
// the low z face of plane 0 pairs the cell with the pad plane's
// coefficient, and a halo plane's faces pair pad planes; only where the
// gates give the slab a face (slab_syn) is the plane beyond it its
// clamped source, the cell itself (slab_eps_src: face_coeffs' SLAB rule).
// x and y, the rings and the tile are those of SLAB = 0, whose code paths
// are selected by constants and unchanged.
//
// Arithmetic per cell is that of the plain PyTorch versions, operation by
// operation (eps_update / eps_apply of stencil_common.cuh).
#pragma once
#include "stream_wide.cuh"

// OMG_FACES 0 builds the coefficient double pair and down-leg from
// stream_kernel.cuh alone (the design before this one), for
// experiments/probe_torch_kernels.py faces to time the two against each
// other.
#ifndef OMG_FACES
#define OMG_FACES 1
#endif

// The longest z chunk: 128 planes halve the share of the 2H + 2NS halo
// steps a block marches through against 64 (2-3 % faster at 512^3 on an
// H100, no change at 256^3, PERF.md); shorter chunks on small levels.
constexpr int FACE_CHUNK_Z = 128;

template <int NS, int MODE>
struct FaceGeo {
  static constexpr bool DOWN = MODE == M_DOWN;
  static constexpr int H = NS + (DOWN ? 1 : 0);  // halo in x, y and z
  // the tile: the double pair's four rings fit 32x24 (205 KB in
  // float32), the down-leg's, two planes deeper, 32x16 (214 KB)
  static constexpr int TX = 32, TY = DOWN ? 16 : 24;
  static constexpr int WX = TX + 2 * H, WY = TY + 2 * H;
  static constexpr int HX = WX / 2;              // cell pairs per row
  static constexpr int NT = HX * WY;             // threads: one per pair
  static constexpr int PL = WX * WY;             // cells per plane
  static constexpr int NB = 2 * NS + (DOWN ? 4 : 2);  // planes in the rings
  static constexpr int KR = DOWN ? 2 * NS + 2 : 2 * NS + 1;  // r = t+1-KR
  // z faces of planes t+1-k, 0 <= k <= KZ, that a step reads
  static constexpr int KZ = DOWN ? KR : 2 * NS;
  static_assert(MODE == M_PAIRS || MODE == M_DOWN, "pairs or down-leg");
  static_assert(NS == 2 || NS == 4, "one or two pairs");
  static_assert(NT <= 1024, "one thread per pair must fit a block");
  static constexpr size_t smem_bytes(size_t item) {
    return item * (4 * (size_t)NB * PL + (DOWN ? 2 * TX * TY : 0));
  }
};

// The low face coefficient along a dim of a cell with coefficient e0
// whose low neighbour has e_nb: the plain version's expression, and its
// high face of the neighbour.
template <typename T>
__device__ __forceinline__ T face_coef(T e0, T e_nb, T idr2) {
  return (T)2 * e0 * e_nb / (e0 + e_nb) * idr2;
}

// Source index of a cell on one side of a coefficient face along a dim
// of n cells: wrapped on a periodic dim, else clamped into [0, n).
__device__ __forceinline__ int face_src(int g, int n, int per) {
  if (per) return wrap_idx(g, n);
  return g < 0 ? 0 : g < n ? g : n - 1;
}

// The coefficient plane of local plane q of a slab of Z planes: q itself
// (a pad plane beyond a face the slab does not own holds the neighbour
// slab's), clamped into the slab only beyond a face that synthesizes
// (syn_lo / syn_hi, slab_syn), whose coefficient ghost is the cell's own
// value.
__device__ __forceinline__ int slab_eps_src(int q, int Z, bool syn_lo,
                                            bool syn_hi) {
  return q < 0 && syn_lo ? 0 : q >= Z && syn_hi ? Z - 1 : q;
}

template <typename T, int NS, int MODE, int NE, int SLAB = 0>
__global__ void __launch_bounds__(FaceGeo<NS, MODE>::NT)
face_kernel(LevelParams P, EpsParams E, int cz, const T* __restrict__ phi,
            const T* __restrict__ rhs, T* __restrict__ out,
            T* __restrict__ phic_out, T* __restrict__ iresc_out,
            SlabParams Zs) {
  static_assert(NE == 1 || NE == 3, "coefficient fields: 1 or 3");
  static_assert(SLAB == 0 || MODE == M_PAIRS, "slab variant: the double pair");
  using G = FaceGeo<NS, MODE>;
  constexpr int H = G::H, WX = G::WX, PL = G::PL, NB = G::NB;
  constexpr int KR = G::KR, KZ = G::KZ;
  constexpr bool DOWN = G::DOWN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_phi = reinterpret_cast<T*>(smem_raw);
  T* s_rhs = s_phi + NB * PL;
  T* s_fx = s_rhs + NB * PL;                       // low x face of a cell
  T* s_fy = s_fx + NB * PL;                        // low y face
  T* s_res = s_fy + NB * PL;                       // DOWN: residual planes

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
  // coefficient reads inside a plane: cells a and b, the low x
  // neighbour of a, the low y neighbours of a and b (face_src: every
  // window cell reads inside the level)
  const int fy0 = face_src(gy, P.Y, P.per[1]);
  const int fy1 = face_src(gy - 1, P.Y, P.per[1]);
  const int fxm = face_src(gx - 1, P.X, P.per[0]);
  const int fxa = face_src(gx, P.X, P.per[0]);
  const int fxb = face_src(gx + 1, P.X, P.per[0]);
  const int ea = (fy0 + PY) * P.X + fxa, eb = (fy0 + PY) * P.X + fxb;
  const int exm = (fy0 + PY) * P.X + fxm;
  const int eya = (fy1 + PY) * P.X + fxa, eyb = (fy1 + PY) * P.X + fxb;
  const T* const e_x = (const T*)E.f[0];
  const T* const e_y = (const T*)E.f[NE == 1 ? 0 : 1];
  const T* const e_z = (const T*)E.f[NE == 1 ? 0 : 2];
  const int pb = (gx + gy) & 1;                     // parity of cell a at z = 0
  const T idx2 = (T)P.idr2[0], idy2 = (T)P.idr2[1], idz2 = (T)P.idr2[2];
  // SLAB: the z faces this slab synthesizes (else it reads their pads)
  const bool zsyn_lo = SLAB != 0 && slab_syn(P, Zs, 0);
  const bool zsyn_hi = SLAB != 0 && slab_syn(P, Zs, 1);

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

  // low z faces of the thread's two cells on plane t+1-k in step t,
  // 0 <= k <= KZ: shifted by one plane per step
  T fz[KZ + 1][2];
#pragma unroll
  for (int k = 0; k <= KZ; ++k) fz[k][0] = fz[k][1] = (T)0;
  // the six face coefficients of the cell at shared index i of the plane
  // in slot sc, its z faces given (fz[k] low, fz[k-1] high)
  auto coeffs = [&](int sc, int i, T zlo, T zhi, T cf[6]) {
    cf[0] = s_fx[sc + i];
    cf[1] = s_fx[sc + i + 1];
    cf[2] = s_fy[sc + i];
    cf[3] = s_fy[sc + i + WX];
    cf[4] = zlo;
    cf[5] = zhi;
  };
  // z coefficients of the thread's cells on the plane before the incoming
  // one (the first plane's low z face is never read)
  T ezp[2] = {(T)1, (T)1};
  // the cell half-sweep s updates on plane p
  auto colour = [&](int s, int p) {
    const int want = (s & 1) ? (P.red_parity ^ 1) : P.red_parity;
    return ((pb + p) & 1) == want ? 0 : 1;
  };

  const int t_last = DOWN ? ze + 2 * NS : ze - 1 + 2 * NS;
  for (int t = zb - H - 1; t <= t_last;
       ++t, slot_in = slot_in + PL == NB * PL ? 0 : slot_in + PL) {
#pragma unroll
    for (int k = KZ; k > 0; --k) {
      fz[k][0] = fz[k - 1][0];
      fz[k][1] = fz[k - 1][1];
    }
    // ---- A. fetch plane t+1 and its coefficients into registers ----
    const int pin = t + 1;
    const bool loading = pin <= ze - 1 + H;
    T va[2] = {(T)0, (T)0}, qa[2] = {(T)0, (T)0};
    T xa = (T)0, xb = (T)0, xm = (T)0, ya = (T)0, yb = (T)0, yma = (T)0,
      ymb = (T)0, za = (T)0, zbv = (T)0;
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
            qa[c] = rhs[zo + goff[c]];
          }
      }
      const long long eo =
          (long long)((SLAB != 0 ? slab_eps_src(pin, P.Z, zsyn_lo, zsyn_hi)
                                 : face_src(pin, P.Z, P.per[2])) + PZ) *
          gplane;
      xa = __ldg(e_x + eo + ea);
      xb = __ldg(e_x + eo + eb);
      xm = __ldg(e_x + eo + exm);
      yma = __ldg(e_y + eo + eya);
      ymb = __ldg(e_y + eo + eyb);
      if (NE == 1) {
        ya = xa; yb = xb; za = xa; zbv = xb;
      } else {
        ya = __ldg(e_y + eo + ea);
        yb = __ldg(e_y + eo + eb);
        za = __ldg(e_z + eo + ea);
        zbv = __ldg(e_z + eo + eb);
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
      const int c = colour(s, p);                    // cell of that colour
      // selects, not indexing: c is only known at run time
      const int sxc = c ? sxs[1] : sxs[0];
      if (sxc < 0 || (c ? ring[1] : ring[0]) <= s) continue;
      const int i = i0 + c, sc = slot(2 + 2 * s);
      const T v = s_phi[sc + i];
      T lo[3], hi[3], cf[6];
      neighbors(p, 2 + 2 * s, c ? face[1] : face[0], sxc, gx + c, i, v, lo,
                hi);
      coeffs(sc, i, c ? fz[2 + 2 * s][1] : fz[2 + 2 * s][0],
             c ? fz[1 + 2 * s][1] : fz[1 + 2 * s][0], cf);
      s_phi[sc + i] = eps_update<T>(P, s_rhs[sc + i], cf, lo, hi);
    }

    // ---- C. the plane that is finished ----
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
        if (!DOWN) {
          out[zo + goff[c]] = v;
          continue;
        }
        T lo[3], hi[3], cf[6];
        neighbors(r, KR, face[c], sxs[c], gx + c, i, v, lo, hi);
        coeffs(sc, i, fz[KR][c], fz[KR - 1][c], cf);
        const T a = s_rhs[sc + i] - eps_apply<T>(P, v, cf, lo, hi);
        s_res[(r & 1) * (G::TX * G::TY) + (ly - H) * G::TX + (lx + c - H)] = a;
        out[zo + goff[c]] = v;
      }
    }

    // ---- D. plane t+1 and its low faces into their slots ----
    if (loading) {
      const int sc = slot_in;
      s_phi[sc + i0] = va[0];
      s_phi[sc + i0 + 1] = va[1];
      s_rhs[sc + i0] = qa[0];
      s_rhs[sc + i0 + 1] = qa[1];
      s_fx[sc + i0] = face_coef<T>(xa, xm, idx2);
      s_fx[sc + i0 + 1] = face_coef<T>(xb, xa, idx2);
      s_fy[sc + i0] = face_coef<T>(ya, yma, idy2);
      s_fy[sc + i0 + 1] = face_coef<T>(yb, ymb, idy2);
      fz[0][0] = face_coef<T>(za, ezp[0], idz2);
      fz[0][1] = face_coef<T>(zbv, ezp[1], idz2);
      ezp[0] = za;
      ezp[1] = zbv;
    }
    __syncthreads();

    // ---- E. restrict the plane pair (r-1, r): (z0+z1), + y, + x, /8 ----
    if (DOWN && r_live && (r & 1)) {
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

// The double pair (MODE M_PAIRS) or the fused down-leg with its fine
// output (M_DOWN) of NS half-sweeps with NE coefficient fields, float32;
// SLAB 1: the double pair on a slab, Zs its gates.
template <typename T, int NS, int MODE, int NE, int SLAB = 0>
static int launch_faces(const LevelParams& P, const EpsParams& E,
                        const void* phi, const void* rhs, void* out,
                        void* phic_out, void* iresc_out,
                        cudaStream_t stream, const SlabParams* Zs = nullptr) {
  using G = FaceGeo<NS, MODE>;
  static_assert(G::smem_bytes(sizeof(T)) <= 232448, "the rings must fit a "
                "block's 227 KB of shared memory");
  auto kernel = face_kernel<T, NS, MODE, NE, SLAB>;
  const size_t smem = G::smem_bytes(sizeof(T));
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  // stream_kernel.cuh's rule from a longer chunk: chunks shorten until
  // the launch has MIN_BLOCKS_PER_SM blocks per SM
  int cz = FACE_CHUNK_Z;
  while (cz > 8 && cdiv(P.X, G::TX) * cdiv(P.Y, G::TY) * cdiv(P.Z, cz) <
                       MIN_BLOCKS_PER_SM * (unsigned)wide_sms())
    cz /= 2;
  dim3 grid(cdiv(P.X, G::TX), cdiv(P.Y, G::TY), cdiv(P.Z, cz));
  kernel<<<grid, G::NT, smem, stream>>>(P, E, cz, (const T*)phi,
                                        (const T*)rhs, (T*)out, (T*)phic_out,
                                        (T*)iresc_out,
                                        Zs ? *Zs : SlabParams{});
  return (int)cudaGetLastError();
}
