// The face-plane apply: A(phi), rhs - A(phi) (stencil_apply_dense, K1,
// stencil_sweep.cu) with coefficients, n_eps 1 or 3, and the
// residual-restriction without a fine output (residual_restrict_dense,
// K2, downsweep.cu) with and without coefficients (NE 0, 1 or 3); float32
// and float64; the float32 segment apply and residual of a dense-forest
// canvas (SEG = 1, NE = 0, seg_sweep.cu); the constant-coefficient
// apply and residual of a large float32 z-slab (SLAB = 1, NE = 0,
// stencil_sweep.cu, where af_slab_takes); and the coefficient apply and
// residual of a float32 z-slab (SLAB = 1, NE 1 or 3, where
// af_eps_slab_takes).  Every other apply and residual of the three
// sources (constant coefficients unsharded, small or float64 slabs, the
// float64 segments) runs stream_kernel.cuh.
//
// Replaces, with stream_kernel.cuh, the eps bodies of the Pallas entry
// points stencil_apply_dense and residual_restrict_dense of the JAX
// package's ops/dense_kernels.py (_apply_expr with eps), and the body of
// residual_restrict_dense without them (_apply_expr).  Bound: bytes
// (phi, rhs where read and the output, 12 B per cell for a float32
// residual, plus 4 B per coefficient field; the residual-restriction
// writes two coarse fields instead of the output).
//
// An apply has halo 1, so it needs no wavefront, and its coefficients
// are what it loses time to (stream_kernel.cuh builds the six harmonic
// means of a cell from seven or nine scattered reads and six divisions).
// The design:
//
// * A block owns a 64 x 16 tile of (x, y) and marches through a chunk
//   of z planes, one barrier per plane.  A thread owns four x-adjacent
//   cells of one row, so index, slot and predicate work is shared by
//   four cells; sixteen threads make a row, two rows a warp.
// * Each plane of phi (with a one-cell halo in x and y), of every
//   coefficient field (the halo only where a face needs it) and of rhs
//   (the thread's own cells) is copied into a ring in shared memory by
//   cp.async, one plane ahead of the plane being computed: one
//   16-byte copy per row of four cells where the row lies inside an
//   aligned level, else one copy per cell with its wrapped or clamped
//   source.  Nothing is copied twice, and the copies overlap the work.
// * Phi's z neighbours are the thread's own cells of the planes before
//   and after, kept in registers; its x and y neighbours are read from
//   the plane in shared memory.
// * Each face coefficient ((2*e0)*e_nb)/(e0 + e_nb)*idr2[d] is built
//   once per plane (it is bitwise symmetric in its two cells, see
//   stream_faces.cuh): when a plane's coefficients have arrived, each
//   thread builds the low x and low y faces of its cells into two face
//   arrays in shared memory (the last thread of a row also the low face
//   of the cell after the tile, the top row those of the row above
//   it); the low z face pairs the plane's coefficient with the previous
//   plane's, kept in a register, and becomes the high z face of the
//   plane before.  A cell's high x/y face is its neighbour's low face.
//   Three divisions per cell instead of six.  A physical face pairs a
//   cell with itself through clamped sources (face_src), a periodic dim
//   wraps.  The faces of plane s are built in step s and read in step
//   s + 1, after its barrier, when plane s is applied.
// * The residual-restriction keeps the residual of the plane before in
//   registers and, on the second plane of a pair, sums phi and the
//   residual in the reference's order, (z0+z1), + y neighbour, + x
//   neighbour, * 0.125: the z pair and the x pair lie in the thread,
//   the y partner is the thread sixteen lanes away in the same warp
//   (__shfl_xor_sync); the even row writes phi's coarse cells and the
//   odd row the residual's.
//
// Arithmetic per cell is that of the plain PyTorch versions, operation by
// operation (face_coef of stream_faces.cuh, eps_apply and the BC
// synthesis of stencil_common.cuh, rhs - a for the residual).
//
// SEG = 1 (NE = 0's instance, the forest's segment apply and residual,
// SegParams of stencil_common.cuh): no face synthesis; x wraps and a y
// or z row or plane outside the canvas is copied in as zeros (the rows'
// sources are src_idx's, x periodic, y and z not); a cell next to a ghost
// layer substitutes its raw neighbours with the layer's ghost, in the
// plain version's order (seg_sub), from device memory: its descriptors
// looked up once per thread (x, y) or plane (z), the layers' plane
// pointers staged in shared memory.
//
// SLAB = 1 (the apply and residual on one slab of the z-slab solver,
// SlabParams of stencil_common.cuh; NE 0, 1 or 3): a z plane beyond a face
// the slab does not own is its pad plane (-1 or Z of the padded layout,
// the halo exchange's copy of the neighbour slab's plane), copied into
// the ring by the same cp.async as every other plane, its coefficient
// planes too, so the z face of a core cell next to it pairs the cell with
// the pad plane's coefficient; a face the gates give the slab synthesizes
// its ghost (slab_syn, slab_z_pair), its phi plane beyond is copied in as
// zeros and its coefficient planes beyond are the clamped source, the
// cell itself (slab_eps_src, stream_faces.cuh).  x and y as without
// slabs.
//
// NE = 0 (apply_from, no faces: no face arrays and no coefficient rings)
// runs the constant-coefficient residual-restriction, row 4 of PERF.md,
// with its own planes ahead and register cap (AF0_*, below): 0.55
// against 0.85 ms for stream_kernel.cuh at 512^3 float32 on an H100
// (experiments/probe_torch_kernels.py rr_slab).  The constant apply and
// residual of an unsharded level stay on stream_kernel.cuh; OMG_FACES 2
// sends them here too, for the probe (experiments/probe_torch_kernels.py
// apply_faces).
#pragma once
#include "stream_faces.cuh"

// The tile's rows, the planes loaded ahead, the float32 blocks per SM
// the registers must leave room for (__launch_bounds__: 2 caps them at
// 128, where uncapped they took ~160 and one block filled an SM) and the
// shortest z chunk, which small levels take to have more blocks: the
// set measured fastest of twelve (PERF_HISTORY.md, PR 9's trials).
constexpr int AF_TY = 16, AF_PD = 1, AF_MINB = 2;
// The longest z chunk (two planes of every chunk are loaded only for
// their z neighbours and coefficients) and the shortest one.  A chunk
// holds whole z pairs: the residual-restriction's pair (r - 1, r) must
// not cross a chunk's edge.
constexpr int AF_CHUNK_Z = 64, AF_MIN_CZ = 2;
static_assert(AF_MIN_CZ % 2 == 0 && AF_CHUNK_Z % AF_MIN_CZ == 0 &&
                  (AF_CHUNK_Z & (AF_CHUNK_Z - 1)) == 0,
              "chunks halve from AF_CHUNK_Z to AF_MIN_CZ, all even");

// The constant-coefficient residual-restriction (NE = 0; under OMG_FACES 2
// also the constant apply and residual) builds no faces: it loads two
// planes ahead and caps its registers for more blocks per SM (float32 4,
// at 56 registers; float64 2): the set measured fastest of fourteen
// (PERF_HISTORY.md, the rr_slab trials).
constexpr int AF0_PD = 2, AF0_MINB = 4, AF0_MINB64 = 2;

template <typename T, int MODE, int NE>
struct AfGeo {
  static constexpr int C = 4;                    // x cells per thread
  static constexpr int TX = 64, TY = AF_TY;      // the tile
  static constexpr int HT = TX / C;              // threads per row
  static constexpr int NT = HT * TY;             // threads
  static constexpr int PD = NE ? AF_PD : AF0_PD; // planes loaded ahead
  // blocks per SM the registers must leave room for (__launch_bounds__)
  static constexpr int MINB = NE ? (sizeof(T) == 4 ? AF_MINB : 1)
                                 : (sizeof(T) == 4 ? AF0_MINB : AF0_MINB64);
  // a plane in shared memory: TY + 2 rows of SX cells, the tile's cells
  // at columns 4 .. TX + 3 (16-byte aligned), its x halo at 3 and TX + 4
  static constexpr int SX = TX + 8;
  static constexpr int PL = SX * (TY + 2);
  // rings: phi (planes s-1 .. s+PD), coefficients (s .. s+PD), rhs
  // (s-1 .. s+PD, the tile's cells only)
  static constexpr int NP = PD + 2, NQ = PD + 1, NR = PD + 2;
  static constexpr bool RHS = MODE != M_APPLY;
  static constexpr bool DOWN = MODE == M_DOWN;
  // face arrays of one plane: TY rows of low x faces (columns 0 .. TX,
  // TX the cell after the tile), then TY + 1 rows of low y faces (row TY
  // the row above the tile); two planes
  static constexpr int FS = TX + 4;
  static constexpr int FP = FS * (2 * TY + 1);
  static_assert(MODE == M_APPLY || MODE == M_RESIDUAL || MODE == M_DOWN,
                "apply, residual or residual-restriction");
  static_assert(NE == 0 || NE == 1 || NE == 3, "coefficient fields");
  static_assert(HT == 16 && TY % 2 == 0 && PD >= 1,
                "two rows a warp: the restriction's y partner is lane ^ 16");
  static constexpr size_t smem_bytes() {
    return sizeof(T) * ((size_t)NP * PL + (size_t)NE * NQ * PL +
                        (RHS ? (size_t)NR * TX * TY : 0) +
                        (NE ? 2 * (size_t)FP : 0));
  }
  static_assert(smem_bytes() <= 232448, "the rings must fit a block's "
                "227 KB of shared memory");
  // SEG: the descriptors' plane pointers after the rings (a constant,
  // not a function: the kernel reads it)
  static constexpr size_t SEG_TABLE =
      (sizeof(T) * ((size_t)NP * PL + (size_t)NE * NQ * PL +
                    (RHS ? (size_t)NR * TX * TY : 0) +
                    (NE ? 2 * (size_t)FP : 0)) + 7) & ~(size_t)7;
  static constexpr size_t seg_smem_bytes() {
    return SEG_TABLE + MAX_SEGS * sizeof(void*);
  }
};

// cp.async of 16 bytes, bypassing L1; zero-filled when !ok
__device__ __forceinline__ void af_cp16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void af_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void af_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the four cells gx0 .. gx0+3 of one source row into dst (16-byte
// aligned).  row: the row in the field, or null where the row has no
// source (zero-filled); base, any address of the field, stands in for
// the source of a zero-filled copy.  Where vec (the four cells lie in
// the level, the row is aligned) one or two 16-byte copies, else one
// copy per cell from its source column: src_idx (none outside a
// non-periodic dim: zero-filled) or, where clamp, face_src.
template <typename T>
__device__ __forceinline__ void af_row(T* dst, const T* base, const T* row,
                                       int gx0, int X, int per, bool clamp,
                                       bool vec) {
  if (vec) {
#pragma unroll
    for (int k = 0; k < 4; k += 16 / (int)sizeof(T))
      af_cp16(dst + k, row ? row + gx0 + k : base, row != nullptr);
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int x = clamp ? face_src(gx0 + c, X, per) : src_idx(gx0 + c, X, per);
    const bool ok = row != nullptr && x >= 0;
    wide_cp_async<sizeof(T)>(dst + c, ok ? row + x : base, ok);
  }
}

// Copy one cell: source column x of row (-1 or a null row: zero-filled)
template <typename T>
__device__ __forceinline__ void af_cell(T* dst, const T* base, const T* row,
                                        int x) {
  const bool ok = row != nullptr && x >= 0;
  wide_cp_async<sizeof(T)>(dst, ok ? row + x : base, ok);
}

template <typename T, int MODE, int NE, int SEG = 0, int SLAB = 0>
__global__ void __launch_bounds__(AfGeo<T, MODE, NE>::NT,
                                  AfGeo<T, MODE, NE>::MINB)
apply_faces_kernel(LevelParams P, EpsParams E, int cz, int vec,
                   const T* __restrict__ phi, const T* __restrict__ rhs,
                   T* __restrict__ out, T* __restrict__ phic_out,
                   T* __restrict__ iresc_out, SegParams S, SlabParams Zs) {
  static_assert(SEG == 0 || (NE == 0 && MODE != M_DOWN),
                "segment variant: constant coefficients, apply or residual");
  static_assert(SLAB == 0 || (SEG == 0 && MODE != M_DOWN),
                "slab variant: apply or residual");
  using G = AfGeo<T, MODE, NE>;
  constexpr int C = G::C, TX = G::TX, TY = G::TY, HT = G::HT;
  constexpr int SX = G::SX, PL = G::PL, FS = G::FS, FP = G::FP;
  constexpr int PD = G::PD, NP = G::NP, NQ = G::NQ, NR = G::NR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const s_phi = reinterpret_cast<T*>(smem_raw);      // NP planes
  T* const s_eps = s_phi + NP * PL;                     // NE x NQ planes
  T* const s_rhs = s_eps + NE * NQ * PL;                // NR x TX*TY
  T* const s_face = s_rhs + (G::RHS ? NR * TX * TY : 0);  // 2 x FP

  const int X = P.X, Y = P.Y, Z = P.Z;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int zb = blockIdx.z * cz;                  // this block's z chunk
  const int ze = zb + cz < Z ? zb + cz : Z;

  // ---- this thread's four cells: everything that does not depend on z --
  const int h = threadIdx.x % HT, ty = threadIdx.x / HT;
  const int gx0 = x0 + C * h, gy = y0 + ty;
  const int io = (ty + 1) * SX + 4 + C * h;    // cell 0 in a plane
  const int ir = ty * TX + C * h;              // cell 0 in an rhs plane
  const int ifx = ty * FS + C * h;             // its low x face
  const int ify = (TY + ty) * FS + C * h;      // its low y face
  bool in[C], xyf[C];
  const bool yface = SEG == 0 && !P.per[1] && (gy == 0 || gy == Y - 1);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int g = gx0 + c;
    in[c] = g < X && gy < Y;
    // a cell of the level on a non-periodic x or y face
    xyf[c] = in[c] && (yface || (!P.per[0] && (g == 0 || g == X - 1)));
  }
  const bool ovec = vec != 0 && gx0 + C <= X;   // aligned, inside in x
  // source rows: phi's (-1 outside a non-periodic dim: never part of a
  // result), the coefficients' (clamped or wrapped: always inside)
  const int sy = src_idx(gy, Y, P.per[1]);
  const int ey = face_src(gy, Y, P.per[1]);
  const long long gplane = (long long)(Y + 2 * PY) * X;
  const T idx2 = (T)P.idr2[0], idy2 = (T)P.idr2[1], idz2 = (T)P.idr2[2];
  // SLAB: the z faces this slab synthesizes (else it reads their pads)
  const bool zsyn_lo = SLAB != 0 && slab_syn(P, Zs, 0);
  const bool zsyn_hi = SLAB != 0 && slab_syn(P, Zs, 1);
  // SEG: the descriptors serving the thread's cells, a byte each (-1:
  // none): x per cell and side (byte 2c + side of jxs[c / 2]), y per side;
  // their planes' pointers, staged in shared memory after the rings
  unsigned jxs[2] = {~0u, ~0u}, jys = ~0u;
  bool segxy = false;
  const T** const s_pl = reinterpret_cast<const T**>(
      smem_raw + G::SEG_TABLE);
  if constexpr (SEG != 0) {
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int side = 0; side < 2; ++side)
        if (in[c])
          jxs[c / 2] = seg_put(jxs[c / 2], 2 * (c % 2) + side,
                               __ldg(S.lut + 2 * (gx0 + c) + side));
#pragma unroll
    for (int side = 0; side < 2; ++side)
      if (sy >= 0)
        jys = seg_put(jys, side, __ldg(S.lut + 2 * (X + sy) + side));
    segxy = jxs[0] != ~0u || jxs[1] != ~0u || jys != ~0u;
    for (int i = threadIdx.x; i < S.n; i += G::NT)
      s_pl[i] = (const T*)S.plane[i];
  }

  // ---- A. copy plane q into ring position k (cp.async, one group): the
  // thread's cells, the x halo (first and last thread of a row), the y
  // halo (first and last row) where a neighbour or a face reads it ----
  auto load = [&](int q, int k) {
    const int px = P.per[0], py = P.per[1];
    // SLAB: plane q is its local plane, a pad plane beyond the slab too;
    // it has no source (zq) beyond a face that synthesizes
    const int sq = SLAB != 0 ? q : src_idx(q, Z, P.per[2]);
    const bool zq = SLAB != 0
                        ? !((q < 0 && zsyn_lo) || (q >= Z && zsyn_hi))
                        : sq >= 0;
    {
      const T* pz =
          phi + (long long)((SLAB != 0 ? sq : sq < 0 ? 0 : sq) + PZ) * gplane;
      auto row = [&](int s) {
        return zq && s >= 0 ? pz + (s + PY) * X : nullptr;
      };
      T* d = s_phi + (k % NP) * PL + io;
      af_row<T>(d, phi, row(sy), gx0, X, px, false, ovec);
      if (h == 0) af_cell<T>(d - 1, phi, row(sy), src_idx(x0 - 1, X, px));
      if (h == HT - 1)
        af_cell<T>(d + C, phi, row(sy), src_idx(x0 + TX, X, px));
      if (ty == 0)
        af_row<T>(d - SX, phi, row(src_idx(y0 - 1, Y, py)), gx0, X, px,
                  false, ovec);
      if (ty == TY - 1)
        af_row<T>(d + SX, phi, row(src_idx(y0 + TY, Y, py)), gx0, X, px,
                  false, ovec);
    }
    if constexpr (NE > 0) {
      const long long eo =
          (long long)((SLAB != 0 ? slab_eps_src(q, Z, zsyn_lo, zsyn_hi)
                                 : face_src(q, Z, P.per[2])) + PZ) * gplane;
#pragma unroll
      for (int f = 0; f < NE; ++f) {
        const T* ez = (const T*)E.f[f] + eo;
        const T* er = ez + (ey + PY) * X;
        T* d = s_eps + (f * NQ + k % NQ) * PL + io;
        af_row<T>(d, ez, er, gx0, X, px, true, ovec);
        if (f == 0) {            // x faces read field 0 (n_eps 1 and 3)
          if (h == 0) af_cell<T>(d - 1, ez, er, face_src(x0 - 1, X, px));
          if (h == HT - 1)
            af_cell<T>(d + C, ez, er, face_src(x0 + TX, X, px));
        }
        if (f == (NE == 1 ? 0 : 1)) {   // y faces read field 0 or 1
          if (ty == 0)
            af_row<T>(d - SX, ez, ez + (face_src(y0 - 1, Y, py) + PY) * X,
                      gx0, X, px, true, ovec);
          if (ty == TY - 1)
            af_row<T>(d + SX, ez, ez + (face_src(y0 + TY, Y, py) + PY) * X,
                      gx0, X, px, true, ovec);
        }
      }
    }
    if constexpr (G::RHS) {
      const T* rz = rhs + (long long)((sq < 0 ? 0 : sq) + PZ) * gplane;
      // SLAB: the rhs of a pad plane is never read
      const bool rq = SLAB != 0 ? q >= 0 && q < Z : sq >= 0;
      af_row<T>(s_rhs + (k % NR) * TX * TY + ir, rhs,
                rq && sy >= 0 ? rz + (sy + PY) * X : nullptr, gx0, X,
                px, false, ovec);
    }
  };

  // ring position k holds plane zb - 1 + k; the first PD go now
#pragma unroll
  for (int k = 0; k < PD; ++k) {
    if (zb - 1 + k <= ze) load(zb - 1 + k, k);
    af_commit();
  }

  T pm[C], pc[C], pn[C];      // phi of the thread's cells, planes r-1, r, r+1
  T fxo[C], fyo[C];           // their low x / y faces on plane r
  T fzl[C], fzh[C];           // low z faces of planes r and r+1
  T ezp[C];                   // z coefficients of the plane before
  T rp[C];                    // DOWN: the residual of plane r-1
#pragma unroll
  for (int c = 0; c < C; ++c)
    pm[c] = pc[c] = pn[c] = fxo[c] = fyo[c] = fzl[c] = fzh[c] = ezp[c] =
        rp[c] = (T)0;

  // step k: plane s = zb - 1 + k has arrived; build its faces and apply
  // plane r = s - 1
  for (int k = 0, s = zb - 1; s <= ze; ++k, ++s) {
    af_wait<PD - 1>();
    __syncthreads();
    if (s + PD <= ze) load(s + PD, k + PD);
    af_commit();

    af_ld4<T>(s_phi + (k % NP) * PL + io, pn);
    T fxn[C], fyn[C];
#pragma unroll
    for (int c = 0; c < C; ++c) fxn[c] = fyn[c] = (T)0;
    if constexpr (NE > 0) {
      // ---- B. the faces of plane s ----
      const T* e0 = s_eps + (k % NQ) * PL;
      const T* eyf = NE == 1 ? e0 : e0 + NQ * PL;
      const T* ezf = NE == 1 ? e0 : e0 + 2 * NQ * PL;
      T ez[C];
      af_ld4<T>(ezf + io, ez);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        fzh[c] = face_coef<T>(ez[c], ezp[c], idz2);
        ezp[c] = ez[c];
      }
      if (s >= zb && s < ze) {
        T exv[C], eyv[C], eym[C];
        if constexpr (NE == 1) {
#pragma unroll
          for (int c = 0; c < C; ++c) exv[c] = eyv[c] = ez[c];
        } else {
          af_ld4<T>(e0 + io, exv);
          af_ld4<T>(eyf + io, eyv);
        }
        af_ld4<T>(eyf + io - SX, eym);
        const T exm = e0[io - 1];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          fxn[c] = face_coef<T>(exv[c], c ? exv[c - 1] : exm, idx2);
          fyn[c] = face_coef<T>(eyv[c], eym[c], idy2);
        }
        T* fs = s_face + (k & 1) * FP;
        af_st4<T>(fs + ifx, fxn);
        af_st4<T>(fs + ify, fyn);
        if (h == HT - 1) fs[ifx + C] = face_coef<T>(e0[io + C], exv[C - 1], idx2);
        if (ty == TY - 1) {
          T eyp[C], f4[C];
          af_ld4<T>(eyf + io + SX, eyp);
#pragma unroll
          for (int c = 0; c < C; ++c) f4[c] = face_coef<T>(eyp[c], eyv[c], idy2);
          af_st4<T>(fs + ify + FS, f4);
        }
      }
    }

    // ---- C. apply plane r = s - 1 ----
    const int r = s - 1;
    if (r >= zb) {
      const T* sp = s_phi + ((k + NP - 1) % NP) * PL + io;
      T yl[C], yh[C];
      af_ld4<T>(sp - SX, yl);
      af_ld4<T>(sp + SX, yh);
      const T xl = sp[-1], xh = sp[C];
      T fxh = (T)0, fyh[C] = {};
      if constexpr (NE > 0) {
        const T* fs = s_face + ((k - 1) & 1) * FP;
        fxh = fs[ifx + C];
        af_ld4<T>(fs + ify + FS, fyh);
      }
      T q[C] = {};
      if constexpr (G::RHS)
        af_ld4<T>(s_rhs + ((k + NR - 1) % NR) * TX * TY + ir, q);
      const bool zf = SLAB != 0
                          ? (zsyn_lo && r == 0) || (zsyn_hi && r == Z - 1)
                          : SEG == 0 && !P.per[2] && (r == 0 || r == Z - 1);
      // SEG: the z layers of plane r (every x and y one is the thread's)
      int jzl = -1, jzh = -1;
      if constexpr (SEG != 0) {
        const int* lz = S.lut + 2 * (X + Y) + 2 * r;
        jzl = __ldg(lz);
        jzh = __ldg(lz + 1);
      }
      T a[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const T v = pc[c];
        T lo[3] = {c ? pc[c - 1] : xl, yl[c], pm[c]};
        T hi[3] = {c < C - 1 ? pc[c + 1] : xh, yh[c], pn[c]};
        if (SEG != 0 && in[c] && (segxy || jzl >= 0 || jzh >= 0)) {
          // a cell next to a ghost layer: its substitutions, in the
          // plain version's order (layouts as in seg_pair)
          const long long YP = Y + 2 * PY, ZP = Z + 2 * PZ;
          seg_sub<T>(s_pl, seg_desc(seg_byte(jxs[c / 2], 2 * (c % 2))),
                     seg_desc(seg_byte(jxs[c / 2], 2 * (c % 2) + 1)),
                     (long long)(r + PZ) * YP + (gy + PY), ZP * YP, v, lo[0],
                     hi[0]);
          seg_sub<T>(s_pl, seg_desc(seg_byte(jys, 0)),
                     seg_desc(seg_byte(jys, 1)),
                     (long long)(r + PZ) * X + gx0 + c, ZP * X, v, lo[1],
                     hi[1]);
          seg_sub<T>(s_pl, jzl, jzh, (long long)(gy + PY) * X + gx0 + c,
                     YP * X, v, lo[2], hi[2]);
        }
        if (SEG == 0 && (xyf[c] || (zf && in[c]))) {
          // a cell of the level on a face: the BC ghosts
          const int g = gx0 + c;
          T l, u;
          neighbor_pair<T>(P, 0, g, X, v, lo[0], hi[0], g, gy, r, l, u);
          lo[0] = l; hi[0] = u;
          neighbor_pair<T>(P, 1, gy, Y, v, lo[1], hi[1], g, gy, r, l, u);
          lo[1] = l; hi[1] = u;
          if constexpr (SLAB != 0)
            slab_z_pair<T>(P, zsyn_lo, zsyn_hi, r, v, lo[2], hi[2], g, gy,
                           r, l, u);
          else
            neighbor_pair<T>(P, 2, r, Z, v, lo[2], hi[2], g, gy, r, l, u);
          lo[2] = l; hi[2] = u;
        }
        if constexpr (NE > 0) {
          const T cf[6] = {fxo[c], c < C - 1 ? fxo[c + 1] : fxh, fyo[c],
                           fyh[c], fzl[c], fzh[c]};
          a[c] = eps_apply<T>(P, v, cf, lo, hi);
        } else {
          a[c] = apply_from<T>(P, v, lo, hi);
        }
        if constexpr (G::RHS) a[c] = q[c] - a[c];
      }
      if constexpr (!G::DOWN) {
        if (gy < Y) {
          T* o = out + (long long)(r + PZ) * gplane + (long long)(gy + PY) * X;
          if (ovec) {
            af_st4<T>(o + gx0, a);
          } else {
#pragma unroll
            for (int c = 0; c < C; ++c)
              if (in[c]) o[gx0 + c] = a[c];
          }
        }
      } else if (r & 1) {
        // ---- D. restrict the plane pair (r-1, r): (z0+z1), + y, + x,
        // * 1/8; the even row phi, the odd row the residual ----
        const bool odd = ty & 1;
        T b[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const T zp = pm[c] + pc[c], zr = rp[c] + a[c];
          const T w = __shfl_xor_sync(0xffffffffu, odd ? zp : zr, HT);
          b[c] = odd ? w + zr : zp + w;
        }
        const int Xc = X / 2, Yc = Y / 2, cy = (gy - (ty & 1)) / 2;
        const int cx = gx0 / 2;
        if (cy < Yc) {
          T* o = (odd ? iresc_out : phic_out) +
                 ((long long)(r / 2 + PZ) * (Yc + 2 * PY) + (cy + PY)) * Xc;
          if (cx < Xc) o[cx] = (b[0] + b[1]) * (T)0.125;
          if (cx + 1 < Xc) o[cx + 1] = (b[2] + b[3]) * (T)0.125;
        }
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) rp[c] = a[c];
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      pm[c] = pc[c];
      pc[c] = pn[c];
      fzl[c] = fzh[c];
      fxo[c] = fxn[c];
      fyo[c] = fyn[c];
    }
  }
}

// Whether the face-plane apply takes the apply, residual and residual-
// restriction launches of a mode, dtype and coefficient count: the
// coefficient ones and every residual-restriction (OMG_FACES 1), float32
// and float64, where it was faster than stream_kernel.cuh at every level
// measured, 16^3 to 512^3 (PERF.md); every one under OMG_FACES 2, for the
// probe.
template <typename T, int MODE, int NE>
constexpr bool af_takes() {
#if OMG_FACES == 2
  return true;
#else
  return NE != 0 || MODE == M_DOWN;
#endif
}

// Whether the face-plane apply (SLAB = 1) takes a constant-coefficient
// float32 slab apply or residual: slabs of 2^20 cells or more in two
// planes or more, the slabs of the sharded 512^3 and 256^3 levels over 8,
// where it was faster than stream_kernel.cuh in every turn of
// experiments/probe_torch_kernels.py slab_apply (PERF.md); smaller slabs
// are latency-bound and keep stream_kernel.cuh, as does float64 (no slab
// solve with large slabs uses it; not instantiated).
inline bool af_slab_takes(const LevelParams& P) {
  return P.Z >= 2 && (long long)P.X * P.Y * P.Z >= (1LL << 20);
}

// Whether the face-plane apply (SLAB = 1) takes a float32 coefficient
// slab apply or residual (n_eps 1 or 3): slabs of 2^15 cells or more, the
// slabs of the sharded 512^3 .. 64^3 levels over 8, where it was faster
// than stream_kernel.cuh in both turns of
// experiments/probe_torch_kernels.py slab_eps (PERF.md); on the 32^2 x 4
// slab of the 32^3 level it was slower in both (latency-bound, by 1-3
// us), and such slabs keep stream_kernel.cuh, as does float64 (no slab
// solve with coefficients uses it; not instantiated).
inline bool af_eps_slab_takes(const LevelParams& P) {
  return (long long)P.X * P.Y * P.Z >= (1LL << 15);
}

// A(phi) (MODE M_APPLY), rhs - A(phi) (M_RESIDUAL) or the residual-
// restriction without a fine output (M_DOWN) on the face-plane apply; Zs
// the gates of a slab (SLAB = 1).
template <typename T, int MODE, int NE, int SEG = 0, int SLAB = 0>
static int launch_apply_faces(const LevelParams& P, const EpsParams& E,
                              const void* phi, const void* rhs, void* out,
                              void* phic_out, void* iresc_out,
                              cudaStream_t stream,
                              const SegParams* S = nullptr,
                              const SlabParams* Zs = nullptr) {
  using G = AfGeo<T, MODE, NE>;
  auto kernel = apply_faces_kernel<T, MODE, NE, SEG, SLAB>;
  const size_t smem = SEG != 0 ? G::seg_smem_bytes() : G::smem_bytes();
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  // 16-byte copies and stores need aligned rows and fields
  auto al = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  int vec = (P.X * (int)sizeof(T)) % 16 == 0 && al(phi) &&
            (MODE == M_APPLY || al(rhs)) && (MODE == M_DOWN || al(out));
  for (int f = 0; f < NE; ++f) vec = vec && al(E.f[f]);
  // stream_kernel.cuh's rule: chunks shorten until the launch has
  // MIN_BLOCKS_PER_SM blocks per SM
  int cz = AF_CHUNK_Z;
  while (cz > AF_MIN_CZ && cdiv(P.X, G::TX) * cdiv(P.Y, G::TY) * cdiv(P.Z, cz) <
                       MIN_BLOCKS_PER_SM * (unsigned)wide_sms())
    cz /= 2;
  dim3 grid(cdiv(P.X, G::TX), cdiv(P.Y, G::TY), cdiv(P.Z, cz));
  kernel<<<grid, G::NT, smem, stream>>>(P, E, cz, vec, (const T*)phi,
                                        (const T*)rhs, (T*)out, (T*)phic_out,
                                        (T*)iresc_out,
                                        S ? *S : SegParams{},
                                        Zs ? *Zs : SlabParams{});
  return (int)cudaGetLastError();
}
