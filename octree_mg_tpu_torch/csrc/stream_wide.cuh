// The wide z-streaming kernel: the double pair (pair_sweep_dense, n_pairs
// 1 or 2) of K1 (stencil_sweep.cu) and the fused down-leg
// (downsweep_dense) of K2 (downsweep.cu), constant coefficients, on large
// levels (wide_takes, at the end); the double pair on one z-slab of the
// slab solver (SLAB = 1, omg_stencil_slab) on large slabs
// (wide_slab_takes); and the float32 segment double pair of a dense-forest
// canvas (SEG = 1, seg_sweep.cu) on large canvases (wide_seg_takes).
// Every other launch of the three sources runs stream_kernel.cuh.
//
// Replaces, with stream_kernel.cuh, the Pallas entry points
// pair_sweep_dense (also called with z_gates) and downsweep_dense of the
// JAX package's ops/dense_kernels.py.  Bound: bytes (12 and 13 B per cell
// in float32; a slab also reads its 2 * n_pairs pad planes each side).
//
// The march is stream_kernel.cuh's: a block owns a tile of (x, y) with a
// halo and walks a chunk of z planes through a ring in shared memory; in
// step t it loads plane t+1 and applies half-sweep s to plane t-1-2s for
// every s at once, with one barrier per step.  What differs is the
// movement of data and the assignment of work:
//
// * One thread owns a column of R rows of one x pair (2R cells; R = 2),
//   so the per-half-sweep set-up is shared by R updates, and the y
//   neighbours of a row's updated cell are the other colour's cells of
//   the rows above and below, loaded once for the column.
// * The colour of a half-sweep is a template argument of the step (it
//   alternates with t; every column starts on an even x and y), so every
//   ring offset and face test folds to a constant.
// * The ring holds phi only, so the tile is 64x32 (float32; 64x16 in
//   float64) where stream_kernel.cuh's is 32x16: the block loads 1.41
//   (double pair) and 1.63 (down-leg) cells per tile cell, not 1.88 and
//   2.13.  rhs is read at the thread's own cells from device memory, one
//   step ahead into registers (the double pair), or after stage C into
//   the registers stage B has done with (the down-leg, whose registers
//   are scarce).
// * Planes are stored colour-split: a row holds its even-x cells, then
//   its odd-x cells, with a row stride chosen so that the 32 threads of a
//   warp hit 32 banks in every access (R * WS == CX mod 32).
// * A cell sums its neighbours from the ring as they are; only a cell on
//   a non-periodic face (known per thread for x and y, per plane for z)
//   then runs stream_kernel.cuh's BC synthesis, behind one branch per
//   half-sweep that a column with no face cell skips.
// * Plane t+1 is fetched as one 8- or 16-byte load per row pair where
//   the window lies inside the level (the double pair), or copied into
//   its slot with cp.async (the down-leg).
// * The down-leg restricts the plane pair (r-1, r) from its own cells'
//   phi and residual, held in registers: no residual buffer in shared
//   memory and no second barrier.
//
// SLAB = 1 is stream_kernel.cuh's z-slab variant on this march (SlabParams,
// stencil_common.cuh): a plane beyond a z face that does not synthesize its
// ghost is loaded from the z pads (rhs too), H deep, and swept redundantly
// like the halo planes between two chunks; a halo plane's cells keep their
// local z (negative below the slab), from which parity and BC-plane rows
// follow; only core planes are written.  The x and y faces, the colour
// template and the chunking are those of SLAB = 0, whose code paths are
// selected by constants and unchanged.
//
// SEG = 1 is stream_kernel.cuh's segment variant on this march (SegParams,
// stencil_common.cuh; the pair only): no face synthesis, x wraps, a y or z
// neighbour outside the canvas is 0 (plane t+1 comes in by cp.async,
// zero-filled there, and a row outside the canvas is never written), and
// a reader next to a ghost layer takes the layer's ghost (a0 + a1*x1) +
// a2*x2.  A reader column of an x layer, or row of a y layer, runs
// through every row group, or every column, of a tile, so every warp of
// the block would hold one of its cells; substituted by each thread for
// its own cells, it cost more than the rest of the half-sweep
// (PERF.md).  So the window's reader columns and rows are its lines: a
// block stages the layers' four planes over the window beside the ring,
// plane by plane by cp.async, and during step t one thread per line cell
// forms the substituted neighbour sum of each cell a half-sweep of step
// t + 1 updates (its plane, t - 2s, is not written in step t) into a line
// buffer, which the cell's owner reads in step t + 1 with one predicated
// shared-memory load.  z layers (a whole plane, every thread at once) and
// lines beyond SEG_NL are substituted by the owners from device memory,
// out of line (wide_seg_rare).  rhs comes late, as in the down-leg: the
// registers go to the substitutions.  The SEG = 0 code paths are selected
// by constants and unchanged.
//
// Arithmetic per cell is that of the plain PyTorch versions, operation by
// operation; a sum of two neighbours may be formed in the other order
// (IEEE addition commutes), so the kernels stay bitwise.
#pragma once
#include <cstdint>
#include <type_traits>
#include "stream_kernel.cuh"

// OMG_WIDE 0 builds the double pair and the down-leg from stream_kernel.cuh
// alone (the design before this one), for experiments/probe_torch_kernels.py
// wide to time the two against each other.
#ifndef OMG_WIDE
#define OMG_WIDE 1
#endif

// The tile (x; y 32, or 16 for the float64 double pair, whose ring is
// twice as wide), the rows per thread and the longest z chunk: the values
// measured fastest (PERF.md keeps the trials of the others).
constexpr int WIDE_TX = 64, WIDE_ROWS = 2, WIDE_CHUNK_Z = 64;
template <typename T>
constexpr int wide_ty() { return sizeof(T) == 8 ? 16 : 32; }

constexpr int wide_even_up(int v) { return (v + 1) & ~1; }

// x halo: at least h, even, and such that the pair columns of a row are a
// multiple of the rows per thread (needed for the bank-free stride)
constexpr int wide_halo_x(int h, int tx, int rows) {
  int hx = wide_even_up(h);
  while ((tx / 2 + hx) % rows != 0) hx += 2;
  return hx;
}

// row stride >= 2*cx with rows * stride == cx (mod 32): thread k of a
// block then sits at bank k (mod 32) in every access
constexpr int wide_stride(int cx, int rows) {
  int w = 2 * cx;
  while ((rows * w - cx) % 32 != 0) ++w;
  return w;
}

template <typename T, int NS, int MODE>
struct WideGeo {
  static constexpr bool DOWN = MODE == M_DOWN;
  static constexpr int H = NS + (DOWN ? 1 : 0);  // halo the sweeps need
  static constexpr int R = WIDE_ROWS;            // rows per thread
  static constexpr int TX = WIDE_TX, TY = wide_ty<T>();
  static constexpr int HX = wide_halo_x(H, TX, R), HY = wide_even_up(H);
  static constexpr int CX = TX / 2 + HX;         // pair columns of a row
  static constexpr int WS = wide_stride(CX, R);  // row stride in the ring
  static constexpr int WY = TY + 2 * HY;
  static constexpr int NT = CX * (WY / R);       // threads
  static constexpr int PL = WS * WY;             // a plane of the ring
  static constexpr int NB = 2 * NS + (DOWN ? 4 : 2);
  static constexpr int GUARD = WS + 2;           // before and after the ring
  static_assert(MODE == M_PAIRS || MODE == M_DOWN, "pairs or down-leg");
  static_assert(NS == 2 || NS == 4, "one or two pairs");
  static_assert(!DOWN || sizeof(T) == 4, "the down-leg is wide in float32");
  static_assert(R % 2 == 0 && 32 % R == 0, "rows per thread: 2, 4, 8 ...");
  static_assert(TX % 8 == 0 && TY % R == 0 && WY % R == 0 && TY >= HY,
                "tile shape");
  static_assert(NT <= 1024, "threads per block");
  static constexpr size_t smem_bytes() {
    return sizeof(T) * ((size_t)NB * PL + 2 * GUARD);
  }
  static_assert(smem_bytes() <= 232448, "the ring must fit a block's "
                "227 KB of shared memory");
  // SEG: after the ring, in shared memory: the descriptors' plane
  // pointers and a word each; the staged entries' descriptors, dims and
  // count; two line counters and the lines (window column or row, and
  // their descriptors); the chunk's z layers; the entry ring (per plane of
  // the ring and entry, a layer's four planes a0, a1, a2, m over the
  // window's rows, an x layer, or columns, a y layer); two line buffers
  // (per half-sweep of a step and line, the substituted neighbour sum of
  // each cell).  Constants, not functions: the kernel reads them.
  static constexpr int SEG_MAXE = 4;                     // entries staged
  // lines a dim buffers: at most 4, and few enough that a thread has at
  // most one line cell a step
  static constexpr int SEG_NL =
      NT / (NS * (WY / 2 + CX)) < 4 ? NT / (NS * (WY / 2 + CX)) : 4;
  static constexpr int SEG_EW = 2 * CX > WY ? 2 * CX : WY;
  static constexpr int SEG_EP = SEG_MAXE * 4 * SEG_EW;   // values a plane
  static constexpr int SEG_NZ = WIDE_CHUNK_Z + 2 * H;    // chunk + halo
  static constexpr int SEG_GX = NS * SEG_NL * WY;        // x lines of a step
  static constexpr int SEG_GB = SEG_GX + NS * SEG_NL * 2 * CX;
  static constexpr size_t SEG_TABLE =
      (sizeof(T) * ((size_t)NB * PL + 2 * GUARD) + 7) & ~(size_t)7;
  static constexpr size_t SEG_MAP = SEG_TABLE + MAX_SEGS * sizeof(void*);
  static constexpr size_t SEG_ENT = SEG_MAP + MAX_SEGS * sizeof(int);
  static constexpr size_t SEG_LINE =
      SEG_ENT + (2 * SEG_MAXE + 3) * sizeof(int);
  static constexpr size_t SEG_LZ = SEG_LINE + 4 * SEG_NL * sizeof(int);
  static constexpr size_t SEG_RING =
      (SEG_LZ + SEG_NZ * sizeof(int) + 15) & ~(size_t)15;
  static constexpr size_t SEG_GBUF =
      SEG_RING + sizeof(T) * (size_t)NB * SEG_EP;
  static constexpr size_t seg_smem_bytes() {
    return SEG_GBUF + sizeof(T) * 2 * (size_t)SEG_GB;
  }
};

template <typename T> struct WidePair;
template <> struct WidePair<float> { using type = float2; };
template <> struct WidePair<double> { using type = double2; };

// cp.async of one cell into shared memory; zero-filled when !ok
template <int B>
__device__ __forceinline__ void wide_cp_async(void* dst, const void* src,
                                              bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(B), "r"(ok ? B : 0)
               : "memory");
}

// seg_side of stencil_common.cuh for a layer staged in shared memory: a
// points at the reader's a0, its a1, a2 and m follow st apart
template <typename T>
__device__ __forceinline__ void seg_side_staged(const T* a, int st, T v, T x2,
                                                T& out) {
  const T m = a[3 * st], a0 = a[0], a1 = a[st], a2 = a[2 * st];
  if (m != (T)0) out = (a0 + a1 * v) + a2 * x2;
}

// SEG's substitutions that the line buffers do not hold, for the R rows
// of a column in one half-sweep of the wide kernel: a cell on an x or y
// line beyond SEG_NL (gw byte 0xfe; its descriptors in jxs / jys) and
// every cell of a plane with a z layer (zw: its descriptors), from device
// memory.  The cells are read from the ring s again (volatile: not merged
// with the loads before); the rows in rows (bit j), the offsets of the
// updated cell's plane (bc), of the planes below and above (bm, bp) and
// within a row those of the wide kernel's stage B.  Writes the sums of
// row j to sums[3j + d] (d = x, y, z) and returns which it wrote.  Out of
// line: it runs on few steps, and inlined it would grow the march.
template <typename T, int R>
__device__ __noinline__ unsigned wide_seg_rare(
    const T* s, const T* const* pl, int ws, int bc, int bm, int bp, int ue,
    int uo, int xe, int xo, int c, int gy0, int sx0, int sx1, unsigned rows,
    unsigned gw, unsigned jxs, unsigned jys, int zw, int p, int X, int YP,
    int ZP, T* sums) {
  auto ld = [&](int i) { return *(volatile const T*)(s + i); };
  unsigned set = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (!(rows >> j & 1u)) continue;
    const int cu = (j & 1) ^ c, gy = gy0 + j, r = bc + j * ws;
    const int u = (j & 1) ? uo : ue, sx = cu ? sx1 : sx0;
    const T v = ld(r + u);
    if (seg_byte(gw, cu) == 0xfeu) {
      const T xp = ld(r + ((j & 1) ? ue : uo)),
              xq = ld(r + ((j & 1) ? xo : xe));
      T lo = cu ? xp : xq, hi = cu ? xq : xp;
      seg_sub<T>(pl, seg_desc(seg_byte(jxs, 2 * cu)),
                 seg_desc(seg_byte(jxs, 2 * cu + 1)),
                 (p + PZ) * YP + (gy + PY), ZP * YP, v, lo, hi);
      sums[3 * j] = lo + hi;
      set |= 1u << (3 * j);
    }
    if (seg_byte(gw, 2 + j) == 0xfeu) {
      T lo = ld(r - ws + ((j & 1) ? uo : ue)),
        hi = ld(r + ws + ((j & 1) ? uo : ue));
      seg_sub<T>(pl, seg_desc(seg_byte(jys, 2 * j)),
                 seg_desc(seg_byte(jys, 2 * j + 1)), (p + PZ) * X + sx,
                 ZP * X, v, lo, hi);
      sums[3 * j + 1] = lo + hi;
      set |= 2u << (3 * j);
    }
    if (zw != 0xffff) {
      T lo = ld(bm + j * ws + u), hi = ld(bp + j * ws + u);
      seg_sub<T>(pl, seg_desc(zw & 0xff), seg_desc(zw >> 8),
                 (gy + PY) * X + sx, YP * X, v, lo, hi);
      sums[3 * j + 2] = lo + hi;
      set |= 4u << (3 * j);
    }
  }
  return set;
}

// SLAB: plane q of a slab swept H deep beyond its faces, clamped into
// [-H, Z - 1 + H], inside the pads (a clamped plane's values are unused)
__device__ __forceinline__ int slab_clamp(int q, int Z, int H) {
  return q < -H ? -H : q > Z - 1 + H ? Z - 1 + H : q;
}

template <typename T, int NS, int MODE, int SLAB = 0, int SEG = 0>
__global__ void __launch_bounds__(WideGeo<T, NS, MODE>::NT)
wide_kernel(LevelParams P, int cz, int vec,
            const T* __restrict__ phi, const T* __restrict__ rhs,
            T* __restrict__ out, T* __restrict__ phic_out,
            T* __restrict__ iresc_out, SlabParams Zs, SegParams S) {
  static_assert(SLAB == 0 || MODE == M_PAIRS, "slab variant: the double pair");
  static_assert(SEG == 0 || (MODE == M_PAIRS && SLAB == 0),
                "segment variant: the double pair, no slab");
  using G = WideGeo<T, NS, MODE>;
  static_assert(SEG == 0 || (G::SEG_NL >= 1 && 2 * G::NT >= G::SEG_EP &&
                             2 * G::NT / G::SEG_EW < 256 &&
                             G::SEG_EW < 256 && G::SEG_EW % 4 == 0 &&
                             G::WY % 4 == 0),
                "segment variant: a line cell and two staging copies a "
                "thread");
  using V2 = typename WidePair<T>::type;
  constexpr int H = G::H, HX = G::HX, HY = G::HY, CX = G::CX, WS = G::WS;
  constexpr int PL = G::PL, NB = G::NB, R = G::R;
  constexpr bool DOWN = G::DOWN;
  constexpr int KR = DOWN ? 2 * NS + 2 : 2 * NS + 1;  // plane t+1-KR is done
  // the double pair fetches plane t+1 into registers and the rhs of step
  // t+1 before the half-sweeps of step t; the down-leg, whose registers
  // are scarce, copies the plane into its slot by cp.async and fetches the
  // rhs after stage C, into the registers stage B has done with
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const s = reinterpret_cast<T*>(smem_raw) + G::GUARD;

  const int x0 = blockIdx.x * G::TX, y0 = blockIdx.y * G::TY;
  const int zb = blockIdx.z * cz;                  // this block's z chunk
  const int ze = zb + cz < P.Z ? zb + cz : P.Z;

  // ---- this thread's column: everything that does not depend on z ----
  // gx and gy0 are even (so are the tile, the halo and R): cell 0 of an
  // even row has the parity of its plane
  const int hx = threadIdx.x % CX, ly0 = (int)(threadIdx.x / CX) * R;
  const int gx = x0 - HX + 2 * hx, gy0 = y0 - HY + ly0;  // cell (0, row 0)
  const int i0 = ly0 * WS + hx;         // its ring index; cell 1 at +CX
  // the window lies inside the level: no wrap, no face, aligned pairs
  const bool inner = (SEG != 0 ? vec & 1 : vec) && x0 >= HX &&
                     x0 + G::TX + HX <= P.X &&
                     y0 >= HY && y0 + G::TY + HY <= P.Y;
  int sx[2];                            // source x of the two cells, or -1
  bool fx[2];                           // the cell is on a non-periodic x face
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    sx[c] = src_idx(gx + c, P.X, P.per[0]);
    fx[c] = !P.per[0] && (gx + c == 0 || gx + c == P.X - 1);
  }
  // the tile's cells inside the level: the pair (cell 1 only where
  // gx + 1 < X) if xcore, rows [jlo, jhi) of the column
  const bool xcore = 2 * hx >= HX && 2 * hx < HX + G::TX && gx < P.X;
  const bool xin1 = xcore && gx + 1 < P.X;
  const int jlo = HY - ly0 > 0 ? HY - ly0 : 0;
  int jhi = HY + G::TY - ly0;
  jhi = jhi < R ? jhi : R;
  jhi = jhi < P.Y - gy0 ? jhi : P.Y - gy0;
  const bool writes = xcore && jlo < jhi;
  int roff[R];                          // offset of each row in a plane, or -1
  bool fy[R];                           // the row is on a non-periodic y face
  bool face = fx[0] || fx[1];           // some cell of the column is
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int gy = gy0 + j, sy = src_idx(gy, P.Y, P.per[1]);
    roff[j] = sy < 0 ? -1 : (sy + PY) * P.X;
    fy[j] = SEG == 0 && !P.per[1] && (gy == 0 || gy == P.Y - 1);
    face = face || fy[j];
  }
  const long long gplane = (long long)(P.Y + 2 * PY) * P.X;
  const T idx2 = (T)P.idr2[0], idy2 = (T)P.idr2[1], idz2 = (T)P.idr2[2];
  const T inv_den = (T)P.inv_den;
  // SLAB: the z faces this slab synthesizes (else it reads their pads)
  const bool zsyn_lo = SLAB != 0 && slab_syn(P, Zs, 0);
  const bool zsyn_hi = SLAB != 0 && slab_syn(P, Zs, 1);
  // SEG: the layers serving the column (descriptor bytes, 0xff none): x
  // per cell and side (byte 2c + side of jxs), y per row and side (2j +
  // side of jys).  The window's reader columns of x layers and rows of y
  // layers are its lines, SEG_NL a dim buffered: during step t, spread
  // over the block's threads, each buffered line's cells that a half-sweep
  // of step t + 1 updates get their substituted neighbour sum along the
  // line's dim (their plane is not written in step t), from the layers'
  // values staged beside the ring (the first SEG_MAXE layers the window
  // reads; any other from device memory); in step t + 1 the owner of a
  // cell takes it from the line buffer.  So the work of a line's cells is
  // not repeated by every warp that holds one of them, as it is when each
  // thread substitutes its own cells.  A line beyond SEG_NL, and every z
  // layer (a whole plane: all threads at once), is substituted by the
  // cell's owner from device memory.  gw: per cell (byte c) its x line,
  // per row (byte 2 + j) its y line; < SEG_NL buffered, 0xfe substituted
  // by the owner, 0xff none.
  constexpr int EW = G::SEG_EW, EP = G::SEG_EP, MAXE = G::SEG_MAXE;
  constexpr int NL = G::SEG_NL, HWY = G::WY / 2;
  unsigned jxs = ~0u, jys = ~0u, gw = ~0u;
  int ne = 0, nxl = 0, nyl = 0;
  int item = -1;    // the thread's line cell: half-sweep, dim, line, place
  bool inl = false;  // a cell or row of the thread is on an unbuffered line
  unsigned rows = 0;  // bit j: row j of the column lies in the canvas
  // the thread's staging copies, a row (entry and value) and a place in
  // it each: one of 4 cells, 16 bytes (sv: the window starts on a
  // multiple of 4 in x and y, X and Y are multiples of 4 and the planes
  // are aligned, vec bit 2), else two of one cell
  const bool sv = SEG != 0 && HX % 4 == 0 && HY % 4 == 0 && (vec & 2);
  const unsigned cw = sv
      ? (unsigned)(threadIdx.x / (EW / 4)) |
            (unsigned)(4 * (threadIdx.x % (EW / 4))) << 8 | 0xff0000u
      : (unsigned)(threadIdx.x / EW) | (unsigned)(threadIdx.x % EW) << 8 |
            (unsigned)((threadIdx.x + G::NT) / EW) << 16 |
            (unsigned)((threadIdx.x + G::NT) % EW) << 24;
  const T** const s_pl = reinterpret_cast<const T**>(smem_raw + G::SEG_TABLE);
  int* const s_map = reinterpret_cast<int*>(smem_raw + G::SEG_MAP);
  int* const s_ent = reinterpret_cast<int*>(smem_raw + G::SEG_ENT);
  int* const s_line = reinterpret_cast<int*>(smem_raw + G::SEG_LINE);
  int* const s_lz = reinterpret_cast<int*>(smem_raw + G::SEG_LZ);
  T* const s_ev = reinterpret_cast<T*>(smem_raw + G::SEG_RING);
  T* const s_gb = reinterpret_cast<T*>(smem_raw + G::SEG_GBUF);
  if constexpr (SEG != 0) {
    for (int i = threadIdx.x; i < S.n; i += G::NT) {
      s_pl[i] = (const T*)S.plane[i];
      s_map[i] = 0;
    }
    const int* lz = S.lut + 2 * (P.X + P.Y);
    for (int i = threadIdx.x; i < ze - zb + 2 * H; i += G::NT) {
      const int p = zb - H + i;
      s_lz[i] = p < 0 || p >= P.Z ? 0xffff
          : (__ldg(lz + 2 * p) & 0xff) | ((__ldg(lz + 2 * p + 1) & 0xff) << 8);
    }
    if (threadIdx.x == 0) s_ent[2 * MAXE + 1] = s_ent[2 * MAXE + 2] = 0;
    __syncthreads();
    // the thread's layers, each marked with its dim (1 x, 2 y); the lines
    // (x: by the threads of the first row group, y: of the first column)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      int d[2];
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        d[side] = __ldg(S.lut + 2 * sx[c] + side);
        jxs = seg_put(jxs, 2 * c + side, d[side]);
        if (d[side] >= 0) s_map[d[side]] = 1;
      }
      if (ly0 == 0 && (d[0] >= 0 || d[1] >= 0)) {
        const int k = atomicAdd(s_ent + 2 * MAXE + 1, 1);
        if (k < NL) {
          s_line[k] = 2 * hx + c;
          s_line[NL + k] = (d[0] & 0xff) | ((d[1] & 0xff) << 8);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (roff[j] < 0) continue;
      int d[2];
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        d[side] = __ldg(S.lut + 2 * (P.X + gy0 + j) + side);
        jys = seg_put(jys, 2 * j + side, d[side]);
        if (d[side] >= 0) s_map[d[side]] = 2;
      }
      if (hx == 0 && (d[0] >= 0 || d[1] >= 0)) {
        const int k = atomicAdd(s_ent + 2 * MAXE + 2, 1);
        if (k < NL) {
          s_line[2 * NL + k] = ly0 + j;
          s_line[3 * NL + k] = (d[0] & 0xff) | ((d[1] & 0xff) << 8);
        }
      }
    }
    __syncthreads();
    // the first MAXE layers the window reads, in descriptor order, are
    // staged (s_map: entry < 0x80); the rest are read from device memory
    // (0x80 + descriptor)
    if (threadIdx.x == 0) {
      int n = 0;
      for (int i = 0; i < S.n; ++i) {
        const int m = s_map[i];
        if (m == 0) continue;
        if (n < MAXE) {
          s_ent[n] = i;
          s_ent[MAXE + n] = m;
          s_map[i] = n++;
        } else {
          s_map[i] = 0x80 + i;
        }
      }
      s_ent[2 * MAXE] = n;
      // a buffered line's descriptors become their codes: entry, or 0x80 +
      // descriptor (read from device memory), 0xff none
      const int nx = s_ent[2 * MAXE + 1], ny = s_ent[2 * MAXE + 2];
      for (int k = 0; k < 2 * NL; ++k) {
        if (k < NL ? k >= nx : k - NL >= ny) continue;
        const int q = (k < NL ? NL : 2 * NL) + k;
        int w = 0;
        for (int side = 0; side < 2; ++side) {
          const int d = (s_line[q] >> (8 * side)) & 0xff;
          w |= (d == 0xff ? 0xff : s_map[d]) << (8 * side);
        }
        s_line[q] = w;
      }
    }
    __syncthreads();
    ne = s_ent[2 * MAXE];
    nxl = s_ent[2 * MAXE + 1] < NL ? s_ent[2 * MAXE + 1] : NL;
    nyl = s_ent[2 * MAXE + 2] < NL ? s_ent[2 * MAXE + 2] : NL;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if ((seg_byte(jxs, 2 * c) & seg_byte(jxs, 2 * c + 1)) != 0xffu) {
        int k = 0;
        while (k < nxl && s_line[k] != 2 * hx + c) ++k;
        gw = seg_put(gw, c, k < nxl ? k : 0xfe);
      }
#pragma unroll
    for (int j = 0; j < R; ++j)
      if ((seg_byte(jys, 2 * j) & seg_byte(jys, 2 * j + 1)) != 0xffu) {
        int k = 0;
        while (k < nyl && s_line[2 * NL + k] != ly0 + j) ++k;
        gw = seg_put(gw, 2 + j, k < nyl ? k : 0xfe);
      }
    inl = seg_byte(gw, 0) == 0xfeu || seg_byte(gw, 1) == 0xfeu ||
          seg_byte(gw, 2) == 0xfeu || seg_byte(gw, 3) == 0xfeu;
#pragma unroll
    for (int j = 0; j < R; ++j) rows |= (roff[j] >= 0 ? 1u : 0u) << j;
    // the line cells of a step, NS * per <= NT: one a thread (x lines'
    // cells of a colour, then y lines')
    const int per = nxl * HWY + nyl * CX;
    if (threadIdx.x < NS * per) {
      const int sw = threadIdx.x / per, e = threadIdx.x - sw * per;
      const int ey = e - nxl * HWY;
      item = (sw << 16) | (ey < 0 ? ((e / HWY) << 8) | (e % HWY)
                                  : (1 << 15) | ((ey / CX) << 8) | (ey % CX));
    }
  }

  // Ring slot (cell offset) of plane t+1-k in step t: the slot of the
  // incoming plane t+1 advances by one per step, so no step divides.
  int slot_in = 0;
  auto slot = [&](int k) {
    const int o = slot_in - k * PL;
    return o < 0 ? o + NB * PL : o;
  };

  T vprev[R][2] = {}, rprev[R][2] = {};  // DOWN: phi, residual of plane r-1
  // rhs of the cells half-sweep s updates in this step, and of the cells
  // of the plane the residual stage takes (DOWN): fetched one step ahead
  T q[NS][R] = {}, qr[R][2] = {};

  // One step.  B: the x cell that half-sweep 0 updates in even rows,
  // ((t-1) & 1) ^ red_parity; half-sweep s updates B ^ (s & 1) there and
  // the other cell in odd rows.  A template argument, so that every
  // offset and face test below folds to a constant.
  auto step = [&](const int t, auto colour) {
    constexpr int B = decltype(colour)::value;
    // ---- A. plane t+1: fetched into registers, or copied into its slot ----
    const int pin = t + 1;
    const bool loading = pin <= ze - 1 + H;
    // SLAB: every plane is read where it lies (a pad plane beyond the
    // slab), but one beyond a face that synthesizes
    const int szin = SLAB != 0 ? pin : src_idx(pin, P.Z, P.per[2]);
    const bool have = SLAB != 0
        ? !((zsyn_lo && pin < 0) || (zsyn_hi && pin >= P.Z)) : szin >= 0;
    const T* src = phi + (long long)((SLAB != 0 ? szin : szin < 0 ? 0 : szin) +
                                     PZ) * gplane;
    T va[R][2] = {};
    if ((DOWN || SEG != 0) && loading) {
      T* d = s + slot_in + i0;
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool ok = szin >= 0 && roff[j] >= 0 && sx[c] >= 0;
          wide_cp_async<sizeof(T)>(d + j * WS + c * CX,
                                   ok ? src + roff[j] + sx[c] : src, ok);
        }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    if (!DOWN && SEG == 0 && loading && have) {
      if (inner) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const V2 w = __ldcg(reinterpret_cast<const V2*>(src + roff[j] + gx));
          va[j][0] = w.x;
          va[j][1] = w.y;
        }
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (roff[j] >= 0 && sx[c] >= 0) va[j][c] = src[roff[j] + sx[c]];
      }
    }
    // SEG: the entries' values of plane t+1 into its slot of the entry
    // ring, by cp.async, landing before this step's barrier
    if (SEG != 0 && ne > 0 && loading && have) {
      T* const ev = s_ev + (slot_in / PL) * EP;
      const int YP = P.Y + 2 * PY, ZP = P.Z + 2 * PZ;
      // the thread's copies of the plane's ne * 4 rows (entry, value) of
      // EW places, as cw says
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int row = (int)(cw >> (16 * n)) & 0xff;
        const int w = (int)(cw >> (16 * n + 8)) & 0xff;
        if (row >= 4 * ne) continue;
        const int e = row >> 2, k = row & 3;
        int o;
        if (s_ent[MAXE + e] == 1) {     // an x layer: the window's rows
          const int gy = y0 - HY + w;
          if (w >= G::WY || gy < 0 || gy >= P.Y) continue;
          o = (pin + PZ) * YP + (gy + PY) + k * (ZP * YP);
        } else {                        // a y layer: the window's columns
          if (w >= 2 * CX) continue;
          int g = x0 - HX + w;
          if (g < 0 || g >= P.X) g = wrap_idx(g, P.X);
          o = (pin + PZ) * P.X + g + k * (ZP * P.X);
        }
        if (sv)
          wide_cp_async<16>(ev + row * EW + w, s_pl[s_ent[e]] + o, true);
        else
          wide_cp_async<sizeof(T)>(ev + row * EW + w, s_pl[s_ent[e]] + o,
                                   true);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }

    // ---- A'. rhs for step t+1: half-sweep s on plane t-2s, residual on
    // plane t+2-KR (clamped into the level where a plane does not exist:
    // those values are not used); the double pair into a second buffer
    // here, the down-leg into the one of this step once stage C is done
    // with it ----
    auto fetch_rhs = [&](T(&dq)[NS][R], T(&dqr)[R][2]) {
#pragma unroll
      for (int sw = 0; sw < NS; ++sw) {
        const int c1 = B ^ 1 ^ (sw & 1);
        // SLAB: the plane where it lies, clamped into the pads
        const int sz1 = SLAB != 0 ? slab_clamp(t - 2 * sw, P.Z, H)
                                  : src_idx(t - 2 * sw, P.Z, P.per[2]);
        const T* rz = rhs + (long long)((SLAB != 0 ? sz1 : sz1 < 0 ? 0 : sz1) +
                                        PZ) * gplane;
#pragma unroll
        for (int j = 0; j < R; ++j)
          dq[sw][j] = __ldg(rz + roff[j] + sx[(j & 1) ^ c1]);
      }
      if (DOWN) {
        int r1 = t + 2 - KR;
        r1 = r1 < 0 ? 0 : r1 < P.Z ? r1 : P.Z - 1;
        const T* rz = rhs + (long long)(r1 + PZ) * gplane;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          dqr[j][0] = __ldg(rz + roff[j] + sx[0]);
          dqr[j][1] = __ldg(rz + roff[j] + sx[1]);
        }
      }
    };
    // (SEG: late, as the down-leg, into the registers stage B has done
    // with: its line work and substitutions need the registers)
    T qn[NS][R] = {}, qrn[R][2] = {};
    if (!DOWN && SEG == 0) fetch_rhs(qn, qrn);

    // ---- B. half-sweep s on plane t-1-2s, all s at once ----
#pragma unroll
    for (int sw = 0; sw < NS; ++sw) {
      const int p = t - 1 - 2 * sw;
      // z range in which half-sweep sw is still valid, and the plane exists
      if (p < zb - (H - 1 - sw) || p > ze - 1 + (H - 1 - sw)) continue;
      if constexpr (SLAB != 0) {
        if ((zsyn_lo && p < 0) || (zsyn_hi && p >= P.Z)) continue;
      } else {
        if (!P.per[2] && (p < 0 || p >= P.Z)) continue;
      }
      const int c = B ^ (sw & 1);       // x cell updated in even rows
      const int sc = slot(2 + 2 * sw), sm = slot(3 + 2 * sw),
                sp = slot(1 + 2 * sw);
      const bool zface = SEG != 0 ? false : SLAB != 0
          ? (zsyn_lo && p == 0) || (zsyn_hi && p == P.Z - 1)
          : !P.per[2] && (p == 0 || p == P.Z - 1);
      // ring offsets, relative to a row's cell 0: the updated cell, and
      // its x neighbour outside the pair, in even and in odd rows; the
      // pair partner of even rows is odd rows' updated cell and back
      const int ue = c * CX, uo = CX - ue;
      const int xe = c ? 1 : CX - 1, xo = c ? CX - 1 : 1;
      const int bc = sc + i0, bm = sm + i0, bp = sp + i0;
      // a[j + 1]: row j's cell that this half-sweep does not update, which
      // is the y neighbour of rows j - 1 and j + 1; a[0], a[R + 1]: the
      // rows above and below the column
      T a[R + 2];
      a[0] = s[bc - WS + ue];
#pragma unroll
      for (int j = 0; j < R; ++j) a[j + 1] = s[bc + j * WS + ((j & 1) ? ue : uo)];
      a[R + 1] = s[bc + R * WS + uo];
      // the neighbour sums lo + hi per dim and row (an order of the two
      // that differs from the plain version's is the same sum)
      T xn[R], zl[R], zh[R], xs[R], ys[R], zs[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int u = (j & 1) ? uo : ue;
        xn[j] = s[bc + j * WS + ((j & 1) ? xo : xe)];
        zl[j] = s[bm + j * WS + u];
        zh[j] = s[bp + j * WS + u];
        xs[j] = a[j + 1] + xn[j];
        ys[j] = a[j] + a[j + 2];
        zs[j] = zl[j] + zh[j];
      }
      if (SEG == 0 && (face || zface)) {
        // a cell on a face: stream_kernel.cuh's BC synthesis
        const int sz = SLAB != 0 ? p : src_idx(p, P.Z, P.per[2]);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int cu = (j & 1) ^ c;   // x cell of the updated one
          if (!(fx[cu] || fy[j] || zface)) continue;
          const int sy = src_idx(gy0 + j, P.Y, P.per[1]);
          if (sx[cu] < 0 || sy < 0) continue;
          const T v = s[bc + j * WS + ((j & 1) ? uo : ue)];
          T lo, hi;
          neighbor_pair<T>(P, 0, gx + cu, P.X, v, cu ? a[j + 1] : xn[j],
                           cu ? xn[j] : a[j + 1], sx[cu], sy, sz, lo, hi);
          xs[j] = lo + hi;
          neighbor_pair<T>(P, 1, gy0 + j, P.Y, v, a[j], a[j + 2], sx[cu], sy,
                           sz, lo, hi);
          ys[j] = lo + hi;
          if constexpr (SLAB != 0)
            slab_z_pair<T>(P, zsyn_lo, zsyn_hi, p, v, zl[j], zh[j], sx[cu],
                           sy, sz, lo, hi);
          else
            neighbor_pair<T>(P, 2, p, P.Z, v, zl[j], zh[j], sx[cu], sy, sz,
                             lo, hi);
          zs[j] = lo + hi;
        }
      }
      if constexpr (SEG != 0) {
        // the buffered lines' sums: one predicated shared-memory load per
        // row and dim, no branch
        const T* const gb = s_gb + (t & 1) * G::SEG_GB;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int cu = (j & 1) ^ c;
          const unsigned xb = seg_byte(gw, cu), yb = seg_byte(gw, 2 + j);
          if (xb < 0xfeu) xs[j] = gb[(sw * NL + xb) * G::WY + ly0 + j];
          if (yb < 0xfeu)
            ys[j] = gb[G::SEG_GX + (sw * NL + yb) * 2 * CX + 2 * hx + cu];
        }
        // the rest, lines beyond SEG_NL and z layers, substituted from
        // device memory behind one branch, out of line
        const int zw = s_lz[p - (zb - H)];
        if (inl || zw != 0xffff) {
          T sums[3 * R];
          const unsigned set = wide_seg_rare<T, R>(
              s, s_pl, WS, bc, bm, bp, ue, uo, xe, xo, c, gy0, sx[0], sx[1],
              rows, gw, jxs, jys, zw, p, P.X, P.Y + 2 * PY, P.Z + 2 * PZ,
              sums);
#pragma unroll
          for (int j = 0; j < R; ++j) {
            if (set >> (3 * j) & 1u) xs[j] = sums[3 * j];
            if (set >> (3 * j + 1) & 1u) ys[j] = sums[3 * j + 1];
            if (set >> (3 * j + 2) & 1u) zs[j] = sums[3 * j + 2];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        T acc = -q[sw][j];
        acc = acc + idx2 * xs[j];
        acc = acc + idy2 * ys[j];
        acc = acc + idz2 * zs[j];
        // SEG: a row outside the canvas stays 0, as the pads read
        if (SEG == 0 || roff[j] >= 0)
          s[bc + j * WS + ((j & 1) ? uo : ue)] = acc * inv_den;
      }
    }

    // ---- C. the plane that is finished ----
    const int r = t + 1 - KR;
    if (r >= zb && r < ze && writes) {
      const int sc = slot(KR);
      T* o = out + (long long)(r + PZ) * gplane;
      T vc[R][2];
      if constexpr (!DOWN) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          vc[j][0] = s[sc + i0 + j * WS];
          vc[j][1] = s[sc + i0 + j * WS + CX];
        }
      } else {
        // residual of the tile's cells of plane r
        const int sm = slot(KR + 1), sp = slot(KR - 1);
        const bool zface = !P.per[2] && (r == 0 || r == P.Z - 1);
        T y[R + 2][2];
#pragma unroll
        for (int j = -1; j <= R; ++j) {
          y[j + 1][0] = s[sc + i0 + j * WS];
          y[j + 1][1] = s[sc + i0 + j * WS + CX];
        }
        T rc[R][2];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int b = i0 + j * WS;
          const T xl0 = s[sc + b + CX - 1], xh1 = s[sc + b + 1];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            T lo[3], hi[3];
            lo[0] = c ? y[j + 1][0] : xl0;
            hi[0] = c ? xh1 : y[j + 1][1];
            lo[1] = y[j][c];
            hi[1] = y[j + 2][c];
            lo[2] = s[sm + b + c * CX];
            hi[2] = s[sp + b + c * CX];
            vc[j][c] = y[j + 1][c];
            if ((face || zface) && (fx[c] || fy[j] || zface) && j >= jlo &&
                j < jhi) {
              // a tile cell on a face: BC synthesis (x, y and r in the level)
              const int g = gx + c, gy = gy0 + j;
              neighbor_pair<T>(P, 0, g, P.X, vc[j][c], lo[0], hi[0], g, gy,
                               r, lo[0], hi[0]);
              neighbor_pair<T>(P, 1, gy, P.Y, vc[j][c], lo[1], hi[1], g, gy,
                               r, lo[1], hi[1]);
              neighbor_pair<T>(P, 2, r, P.Z, vc[j][c], lo[2], hi[2], g, gy,
                               r, lo[2], hi[2]);
            }
            rc[j][c] = qr[j][c] - apply_from<T>(P, vc[j][c], lo, hi);
          }
        }
        // restrict the plane pair (r-1, r): (z0+z1), + y, + x, * 1/8
        if (r & 1) {
          const int Yc = P.Y / 2, Xc = P.X / 2;
#pragma unroll
          for (int j = 0; j < R; j += 2) {
            if (j < jlo || j >= jhi) continue;
            const long long oc = ((long long)(r / 2 + PZ) * (Yc + 2 * PY) +
                                  ((gy0 + j) / 2 + PY)) * Xc + gx / 2;
            {
              T vp[2][2];               // phi of plane r-1 at rows j, j+1
#pragma unroll
              for (int k = 0; k < 2; ++k)
#pragma unroll
                for (int c = 0; c < 2; ++c)
                  vp[k][c] = vprev[j + k][c];
              const T t00 = vp[0][0] + vc[j][0];
              const T t10 = vp[1][0] + vc[j + 1][0];
              const T t01 = vp[0][1] + vc[j][1];
              const T t11 = vp[1][1] + vc[j + 1][1];
              phic_out[oc] = ((t00 + t10) + (t01 + t11)) * (T)0.125;
            }
            {
              const T t00 = rprev[j][0] + rc[j][0];
              const T t10 = rprev[j + 1][0] + rc[j + 1][0];
              const T t01 = rprev[j][1] + rc[j][1];
              const T t11 = rprev[j + 1][1] + rc[j + 1][1];
              iresc_out[oc] = ((t00 + t10) + (t01 + t11)) * (T)0.125;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < R; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              vprev[j][c] = vc[j][c];
              rprev[j][c] = rc[j][c];
            }
        }
      }
      // the finished phi of the tile's cells
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j < jlo || j >= jhi) continue;
        if (inner) {
          V2 w;
          w.x = vc[j][0];
          w.y = vc[j][1];
          *reinterpret_cast<V2*>(o + roff[j] + gx) = w;
        } else {
          o[roff[j] + sx[0]] = vc[j][0];
          if (xin1) o[roff[j] + sx[1]] = vc[j][1];
        }
      }
    }

    // ---- C'. SEG: the buffered lines' sums for the half-sweeps of step
    // t + 1, on planes t - 2s that step t does not write ----
    if (SEG != 0 && item >= 0) {
      const int sw = item >> 16, k = (item >> 8) & 0x7f, m = item & 0xff;
      const bool xline = !(item & (1 << 15));
      const int pp = t - 2 * sw;               // its plane
      const int cs = ((t & 1) ^ P.red_parity) ^ (sw & 1);  // x parity
      // updated in even rows by half-sweep sw of step t + 1
      const int sc = slot(1 + 2 * sw);
      const T* const ev = s_ev + (sc / PL) * EP;
      const int YP = P.Y + 2 * PY, ZP = P.Z + 2 * PZ;
      auto at = [&](int r_, int c_) {
        return s[sc + r_ * WS + (c_ >> 1) + (c_ & 1) * CX];
      };
      const int wc = xline ? s_line[k] : 0, wr0 = xline ? 0 : s_line[2 * NL + k];
      const int wcol = xline ? wc : 2 * m + (cs ^ (wr0 & 1));
      const int wrow = xline ? 2 * m + (cs ^ (wc & 1)) : wr0;
      const int gy = y0 - HY + wrow;
      const bool ok = pp >= 0 && pp < P.Z &&
          (xline ? wcol >= 1 && wcol <= 2 * CX - 2 && gy >= 0 && gy < P.Y
                 : wrow >= 1 && wrow <= G::WY - 2);
      if (ok) {
        const int dw = s_line[(xline ? NL : 3 * NL) + k];   // side codes
        T lo = xline ? at(wrow, wcol - 1) : at(wrow - 1, wcol);
        T hi = xline ? at(wrow, wcol + 1) : at(wrow + 1, wcol);
        const int w = xline ? wrow : wcol;
        const T v = at(wrow, wcol), lo_raw = lo, hi_raw = hi;
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const int me = (dw >> (8 * side)) & 0xff;
          if (me == 0xff) continue;
          T& out = side ? hi : lo;
          const T x2 = side ? lo_raw : hi_raw;
          if (me < 0x80) {
            seg_side_staged<T>(ev + me * 4 * EW + w, EW, v, x2, out);
          } else {
            const int o = xline ? (pp + PZ) * YP + (gy + PY)
                : (pp + PZ) * P.X + wrap_idx(x0 - HX + wcol, P.X);
            seg_side<T>(s_pl[me - 0x80] + o, xline ? ZP * YP : ZP * P.X, v,
                        x2, out);
          }
        }
        T* const gb = s_gb + ((t + 1) & 1) * G::SEG_GB;
        gb[xline ? (sw * NL + k) * G::WY + wrow
                 : G::SEG_GX + (sw * NL + k) * 2 * CX + wcol] = lo + hi;
      }
    }

    if (DOWN || SEG != 0) {
      fetch_rhs(q, qr);
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) {
#pragma unroll
        for (int sw = 0; sw < NS; ++sw) q[sw][j] = qn[sw][j];
        qr[j][0] = qrn[j][0];
        qr[j][1] = qrn[j][1];
      }
    }

    // ---- D. plane t+1 into its slot ----
    if (DOWN) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else {
      // SEG: plane t+1 and its entries land before the barrier
      if (SEG != 0) asm volatile("cp.async.wait_all;\n" ::: "memory");
      if (SEG == 0 && loading) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[slot_in + i0 + j * WS] = va[j][0];
          s[slot_in + i0 + j * WS + CX] = va[j][1];
        }
      }
    }
    __syncthreads();
  };

  const int t_last = DOWN ? ze + 2 * NS : ze - 1 + 2 * NS;
  for (int t = zb - H - 1; t <= t_last;
       ++t, slot_in = slot_in + PL == NB * PL ? 0 : slot_in + PL) {
    if (((t - 1) & 1) ^ P.red_parity)
      step(t, std::integral_constant<int, 1>{});
    else
      step(t, std::integral_constant<int, 0>{});
  }
}

// Streaming multiprocessors of the current device (0 if it cannot be
// read: then every level takes the wide design).
static int wide_sms() {
  static int sms = -1;
  if (sms < 0) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
    sms = n;
  }
  return sms;
}

// Whether the wide design takes a level (else stream_kernel.cuh does,
// launched by the caller).  The double pair: where the tile gives
// MIN_BLOCKS_PER_SM blocks per SM with the shortest chunk (on an H100
// 256^3 and up).  The down-leg (float32 only): where the tile gives 4
// blocks per SM with the longest chunk (512^3 on an H100); at 256^3 and
// in float64 it was no faster than stream_kernel.cuh (PERF.md).
template <typename T, int MODE>
static bool wide_takes(const LevelParams& P) {
  const unsigned tiles = cdiv(P.X, WIDE_TX) * cdiv(P.Y, wide_ty<T>());
  if (MODE == M_DOWN)
    return tiles * cdiv(P.Z, WIDE_CHUNK_Z) >= 4u * (unsigned)wide_sms();
  return tiles * cdiv(P.Z, 8) >= MIN_BLOCKS_PER_SM * (unsigned)wide_sms();
}

// Whether the wide design takes a slab double pair (SLAB = 1): a slab of
// at least one 8-plane chunk (an edge strip of an overlapped pair group
// is 2 * n_pairs planes thick, all of them halo) whose tiles and 8-plane
// chunks give a block for every second SM; on an H100 the 512^2 x 64 and
// 256^2 x 32 slabs of the 512^3 and 256^3 levels over 8 slabs, where it
// was faster than stream_kernel.cuh (PERF.md); chip_smoke.py holds it
// against the plain version on these, on the thinnest it takes (512^2 x
// 8, one chunk holding both z faces) and on 512^2 x 12 (a 4-plane last
// chunk).
template <typename T>
static bool wide_slab_takes(const LevelParams& P) {
  const unsigned tiles = cdiv(P.X, WIDE_TX) * cdiv(P.Y, wide_ty<T>());
  return P.Z >= 8 &&
         2 * tiles * cdiv(P.Z, 8) >= (unsigned)wide_sms();
}

// Whether the wide design takes a segment double pair (SEG = 1, the dense
// forest's fused canvases): float32, on the canvases wide_takes gives the
// double pair (256^3 and up on an H100); smaller canvases and float64
// keep stream_kernel.cuh.
template <typename T>
static bool wide_seg_takes(const LevelParams& P) {
  return sizeof(T) == 4 && wide_takes<T, M_PAIRS>(P);
}

// The double pair (MODE M_PAIRS) or the fused down-leg with its fine
// output (M_DOWN) of NS half-sweeps on a level that wide_takes; SLAB 1:
// the double pair on a slab that wide_slab_takes, Zs its gates.
template <typename T, int NS, int MODE, int SLAB = 0, int SEG = 0>
static int launch_wide(const LevelParams& P, const void* phi, const void* rhs,
                       void* out, void* phic_out, void* iresc_out,
                       cudaStream_t stream, const SlabParams* Zs = nullptr,
                       const SegParams* S = nullptr) {
  using G = WideGeo<T, NS, MODE>;
  auto kernel = wide_kernel<T, NS, MODE, SLAB, SEG>;
  const size_t smem = SEG != 0 ? G::seg_smem_bytes() : G::smem_bytes();
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const uintptr_t al = 2 * sizeof(T);
  int vec = P.X % 2 == 0 && (uintptr_t)phi % al == 0 &&
            (uintptr_t)out % al == 0;
  // SEG: the layers' values staged 16 bytes a copy (float32)
  if (SEG != 0 && sizeof(T) == 4 && P.X % 4 == 0 && P.Y % 4 == 0) {
    bool al16 = true;
    for (int j = 0; j < S->n; ++j)
      al16 = al16 && (uintptr_t)S->plane[j] % 16 == 0;
    if (al16) vec |= 2;
  }
  // stream_kernel.cuh's rule: chunks shorten until the launch has
  // MIN_BLOCKS_PER_SM blocks per SM
  int cz = WIDE_CHUNK_Z;
  while (cz > 8 && cdiv(P.X, G::TX) * cdiv(P.Y, G::TY) * cdiv(P.Z, cz) <
                       MIN_BLOCKS_PER_SM * (unsigned)wide_sms())
    cz /= 2;
  dim3 grid(cdiv(P.X, G::TX), cdiv(P.Y, G::TY), cdiv(P.Z, cz));
  kernel<<<grid, G::NT, smem, stream>>>(P, cz, vec, (const T*)phi,
                                        (const T*)rhs, (T*)out, (T*)phic_out,
                                        (T*)iresc_out,
                                        Zs ? *Zs : SlabParams{},
                                        S ? *S : SegParams{});
  return (int)cudaGetLastError();
}
