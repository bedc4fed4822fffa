// K8 residual_df32: the error-free double-float residual
//   r_hi ~= (rhs_hi + rhs_lo) - A(x_hi + x_lo)
// of the constant-coefficient laplacian / helmholtz on one dense level,
// float32 only.
//
// Replaces the Pallas entry point residual_df32_dense of the JAX
// package's ops/df32.py (body _df32_expr, which rides the dense-kernel
// scaffold with x_lo and rhs_lo in its coefficient windows).  Here it is
// one kernel of its own: what is carried over is the expression, not the
// windows.
//
// Every operation below rounds once, in the order of the plain PyTorch
// version (ops/df32.py:_df32_expr): Knuth TwoSum chains for the hi
// channel, their errors gathered in a compensation channel, a Dekker
// TwoProduct (Veltkamp split, c = 4097*a; c - (c - a)) for lam*x.  None
// of these survives a contracted multiply-add or a reassociated sum: the
// build has --fmad=false and no fast-math flag, and the error terms stay
// in the Dekker form so that kernel and plain version agree bitwise.
//
// Bound: bytes.  Four fields read and one written (20 B per cell)
// against roughly 100 float operations per cell, which the card does in
// a quarter of the time the bytes take.  Periodic axes read wrapped
// indices and physical faces synthesize their ghosts inline, so no pad
// is ever read: pads of the inputs may hold NaN.
//
// SLAB = 1 (omg_residual_df32_slab) replaces the entry point called with
// z_gates, on one slab of the z-slab solver's refined outer: a z
// neighbour of x_hi and x_lo beyond a face the slab does not own is read
// from the z pads (the halo exchange's copies), and only a face the slab
// owns synthesizes its ghost pair.  Same arithmetic, same bound.
//
// Two designs, chosen by df32_march_takes.  On levels and slabs of 2^24
// cells and more in planes of 2^18 and more (the refined path's 512^3
// level, the sharded 512^3 level's slabs over 8), a z-march on
// apply_faces.cuh's copies (df32_march_kernel): a block owns a 64 x 16
// tile of (x, y) and marches a chunk of z planes, one barrier per plane;
// a thread owns four x-adjacent cells of one row.  Each plane of x_hi and
// x_lo, with a one-cell x/y halo, and of rhs_hi and rhs_lo (the tile's
// cells) is copied into a ring in shared memory by cp.async, two planes
// ahead; the z neighbours are the thread's own cells of the planes
// before and after, kept in registers, the x and y neighbours are read
// from the plane.  So each input is read from device memory once, with
// its halo, where the thread-per-cell kernel issues 16 loads per cell and
// leaves 13 of them to L1/L2.  A plane beyond a z face is the wrapped
// plane (periodic), the pad plane (SLAB = 1, a face the slab does not
// own) or zeros (a face that synthesizes: the raw value is replaced by
// the ghost).  It is 7 % faster there (0.192 against 0.208 ms on a
// 512^2 x 64 slab, 1.40 against 1.49-1.52 at 512^3, device time on an
// H100, PERF.md, experiments/probe_torch_kernels.py df32_march), and both
// stay far from the byte bound (0.101, 0.801): the march keeps two
// 256-thread blocks an SM (111-123 registers) on ~110 dependent float
// operations a cell, and where its time goes is not measured.  Everywhere
// else, and with -DOMG_DF32MARCH=0 (the probe's old design) everywhere,
// one thread per cell (residual_df32_kernel): a march of few planes is
// latency, and that kernel runs every cell at once.  The arithmetic of a
// cell is the same, operation by operation (df32_cell repeats
// residual_df32_kernel's): every value enters the same operation.
#include "apply_faces.cuh"

// Threads of a block along x, y, z.  experiments/probe_torch_kernels.py
// rebuilds with other shapes: blocks of 128 threads were the fastest,
// blocks of 512 a fifth slower.
#ifndef OMG_DF32_BX
#define OMG_DF32_BX 32
#endif
#ifndef OMG_DF32_BY
#define OMG_DF32_BY 2
#endif
#ifndef OMG_DF32_BZ
#define OMG_DF32_BZ 2
#endif

// Mirrored field by field by ops/df32.py:_Df32Params (ctypes).
struct Df32Params {
  float cb_hi[6];  // (c0*b) of each face, split on the host into an
  float cb_lo[6];  //   exact float32 pair
  float lam_hi;    // Helmholtz lam as a float32 pair
  float lam_lo;
  int has_lam;     // 0: laplacian, the lam term is left out entirely
};

struct SumErr { float s, e; };

// Knuth TwoSum: s + e == a + b exactly.
__device__ __forceinline__ SumErr two_sum(float a, float b) {
  SumErr r;
  r.s = a + b;
  float bb = r.s - a;
  r.e = (a - (r.s - bb)) + (b - bb);
  return r;
}

// Veltkamp split: a == hi + lo, both halves with <= 12 significant bits.
__device__ __forceinline__ void veltkamp(float a, float& hi, float& lo) {
  float c = 4097.0f * a;
  hi = c - (c - a);
  lo = a - hi;
}

// Hi ghost of one face as a TwoSum chain, its rounding errors in ge:
// ghost = cb_hi + c1*x1 (+ c2*x2) (+ cb_lo via ge).
__device__ __forceinline__ void ghost_hi(float c1, float c2, float cb_hi,
                                         float cb_lo, float x1, float x2,
                                         float& gv, float& ge) {
  SumErr t = two_sum(c1 * x1, cb_hi);
  gv = t.s;
  ge = t.e;
  if (c2 != 0.0f) {
    SumErr u = two_sum(gv, c2 * x2);
    gv = u.s;
    ge = ge + u.e;
  }
  ge = ge + cb_lo;
}

// Lo ghost: the same formula with b = 0.
__device__ __forceinline__ float ghost_lo(float c1, float c2, float x1,
                                          float x2) {
  return c1 * x1 + (c2 != 0.0f ? c2 * x2 : 0.0f);
}

template <int SLAB>
__global__ void __launch_bounds__(OMG_DF32_BX * OMG_DF32_BY * OMG_DF32_BZ)
residual_df32_kernel(LevelParams P, Df32Params Q,
                     const float* __restrict__ xhi,
                     const float* __restrict__ xlo,
                     const float* __restrict__ rhshi,
                     const float* __restrict__ rhslo,
                     float* __restrict__ out, SlabParams Zs) {
  int gx = blockIdx.x * blockDim.x + threadIdx.x;
  int gy = blockIdx.y * blockDim.y + threadIdx.y;
  int gz = blockIdx.z * blockDim.z + threadIdx.z;
  if (gx >= P.X || gy >= P.Y || gz >= P.Z) return;
  const int g[3] = {gx, gy, gz};
  const int n[3] = {P.X, P.Y, P.Z};
  const long long stride[3] = {1, P.X, (long long)(P.Y + 2 * PY) * P.X};
  const long long o = field_off(P, gx, gy, gz);
  const float idr2 = (float)P.idr2[0];
  const float xh = xhi[o], xl = xlo[o];
  // SLAB: the z faces this slab synthesizes (else it reads their pads)
  const bool zsyn[2] = {SLAB != 0 && slab_syn(P, Zs, 0),
                        SLAB != 0 && slab_syn(P, Zs, 1)};

  float comp = 0.0f;     // first-order compensation channel
  float s = rhshi[o];    // exact-sum accumulator
  float alo = 0.0f;      // plain A_hom(x_lo)

#pragma unroll
  for (int d = 0; d < 3; ++d) {
    // raw neighbours, wrapped on a periodic axis; one that does not exist
    // (offset o) is never used
    const long long wrap = P.per[d] ? (long long)(n[d] - 1) * stride[d] : 0;
    long long ol, oh;
    if (SLAB != 0 && d == 2) {
      // the pad plane beyond a face that does not synthesize
      ol = g[d] > 0 || !zsyn[0] ? o - stride[d] : o;
      oh = g[d] < n[d] - 1 || !zsyn[1] ? o + stride[d] : o;
    } else {
      ol = g[d] > 0 ? o - stride[d] : o + wrap;
      oh = g[d] < n[d] - 1 ? o + stride[d] : o - wrap;
    }
    // SLAB: on z, the low / high ghost only where the slab owns the face
    const bool syn_lo = SLAB != 0 && d == 2 ? zsyn[0] : true;
    const bool syn_hi = SLAB != 0 && d == 2 ? zsyn[1] : true;
    const float rlo_h = xhi[ol], rhi_h = xhi[oh];
    const float rlo_l = xlo[ol], rhi_l = xlo[oh];
    float vlo_h = rlo_h, vhi_h = rhi_h, vlo_l = rlo_l, vhi_l = rhi_l;
    if (!P.per[d]) {
      float e_lo = 0.0f, e_hi = 0.0f;
      if (syn_lo && g[d] == 0) {
        const int f = 2 * d;
        const float c1 = (float)P.c1[f], c2 = (float)P.c2[f];
        ghost_hi(c1, c2, Q.cb_hi[f], Q.cb_lo[f], xh, rhi_h, vlo_h, e_lo);
        vlo_l = ghost_lo(c1, c2, xl, rhi_l);
      }
      if (syn_hi && g[d] == n[d] - 1) {
        const int f = 2 * d + 1;
        const float c1 = (float)P.c1[f], c2 = (float)P.c2[f];
        ghost_hi(c1, c2, Q.cb_hi[f], Q.cb_lo[f], xh, rlo_h, vhi_h, e_hi);
        vhi_l = ghost_lo(c1, c2, xl, rlo_l);
      }
      comp = comp - idr2 * (e_lo + e_hi);
    }
    const SumErr sd = two_sum(vlo_h, vhi_h);
    const SumErr t = two_sum(s, -(idr2 * sd.s));
    s = t.s;
    comp = comp + (t.e - idr2 * sd.e);
    alo = alo + idr2 * (vlo_l + vhi_l);
  }

  // + (den0 + lam) * x with den0 = 6*idr2 split into the exact
  // 4*idr2 + 2*idr2 pair
  SumErr t = two_sum(s, (4.0f * idr2) * xh);
  s = t.s;
  comp = comp + t.e;
  t = two_sum(s, (2.0f * idr2) * xh);
  s = t.s;
  comp = comp + t.e;
  comp = (comp + rhslo[o]) - (alo - (6.0f * idr2) * xl);
  if (Q.has_lam) {
    const float lam_h = Q.lam_hi, lam_l = Q.lam_lo;
    // Dekker TwoProduct of x_hi * lam_hi
    const float p = xh * lam_h;
    float a1, a2, b1, b2;
    veltkamp(xh, a1, a2);
    veltkamp(lam_h, b1, b2);
    const float pe = (((a1 * b1 - p) + a1 * b2) + a2 * b1) + a2 * b2;
    t = two_sum(s, p);
    s = t.s;
    comp = (comp + (t.e + pe)) + (lam_h * xl + lam_l * xh);
  }
  out[o] = s + comp;
}

// ---- the z-march (OMG_DF32MARCH 1) ----

// The tile (a thread owns DF_C x-adjacent cells of a row: sixteen
// threads a row), the planes loaded ahead, the blocks per SM the
// registers must leave room for, and the longest and shortest z chunk
// (chunks halve until a launch has MIN_BLOCKS_PER_SM blocks per SM, as
// apply_faces.cuh's).
constexpr int DF_C = 4, DF_TX = 64, DF_TY = 16, DF_HT = DF_TX / DF_C;
constexpr int DF_NT = DF_HT * DF_TY;
constexpr int DF_PD = 2, DF_MINB = 2;
constexpr int DF_CHUNK_Z = 64, DF_MIN_CZ = 2;
// a plane of x_hi or x_lo in shared memory: TY + 2 rows of SX cells, the
// tile's at columns 4 .. TX + 3 (16-byte aligned), its x halo at 3 and
// TX + 4; rings of NP planes (s-1 .. s+PD) of x_hi and x_lo and of NR
// (the tile's cells only) of rhs_hi and rhs_lo
constexpr int DF_SX = DF_TX + 8, DF_PL = DF_SX * (DF_TY + 2);
constexpr int DF_NP = DF_PD + 2, DF_NR = DF_PD + 2;
constexpr size_t DF_SMEM = sizeof(float) * (2 * (size_t)DF_NP * DF_PL +
                                            2 * (size_t)DF_NR * DF_TX * DF_TY);
static_assert(DF_HT == 16 && DF_SMEM <= 232448, "four cells a thread, the "
              "rings within a block's 227 KB of shared memory");

// The residual of one cell at coordinates g (local z on a slab) of a level
// of extents n, from its x_hi, x_lo, rhs_hi and rhs_lo (xh, xl, rh, rl)
// and its raw neighbours along each dim d (rlo_*: low, rhi_*: high; *_h
// of x_hi, *_l of x_lo): residual_df32_kernel's arithmetic, operation by
// operation.
template <int SLAB>
__device__ __forceinline__ float df32_cell(const LevelParams& P,
                                           const Df32Params& Q, const int g[3],
                                           const int n[3], const bool zsyn[2],
                                           float xh, float xl, float rh,
                                           float rl, const float rlo_h[3],
                                           const float rhi_h[3],
                                           const float rlo_l[3],
                                           const float rhi_l[3]) {
  const float idr2 = (float)P.idr2[0];
  float comp = 0.0f;     // first-order compensation channel
  float s = rh;          // exact-sum accumulator
  float alo = 0.0f;      // plain A_hom(x_lo)
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    // SLAB: on z, the low / high ghost only where the slab owns the face
    const bool syn_lo = SLAB != 0 && d == 2 ? zsyn[0] : true;
    const bool syn_hi = SLAB != 0 && d == 2 ? zsyn[1] : true;
    float vlo_h = rlo_h[d], vhi_h = rhi_h[d], vlo_l = rlo_l[d],
          vhi_l = rhi_l[d];
    if (!P.per[d]) {
      float e_lo = 0.0f, e_hi = 0.0f;
      if (syn_lo && g[d] == 0) {
        const int f = 2 * d;
        const float c1 = (float)P.c1[f], c2 = (float)P.c2[f];
        ghost_hi(c1, c2, Q.cb_hi[f], Q.cb_lo[f], xh, rhi_h[d], vlo_h, e_lo);
        vlo_l = ghost_lo(c1, c2, xl, rhi_l[d]);
      }
      if (syn_hi && g[d] == n[d] - 1) {
        const int f = 2 * d + 1;
        const float c1 = (float)P.c1[f], c2 = (float)P.c2[f];
        ghost_hi(c1, c2, Q.cb_hi[f], Q.cb_lo[f], xh, rlo_h[d], vhi_h, e_hi);
        vhi_l = ghost_lo(c1, c2, xl, rlo_l[d]);
      }
      comp = comp - idr2 * (e_lo + e_hi);
    }
    const SumErr sd = two_sum(vlo_h, vhi_h);
    const SumErr t = two_sum(s, -(idr2 * sd.s));
    s = t.s;
    comp = comp + (t.e - idr2 * sd.e);
    alo = alo + idr2 * (vlo_l + vhi_l);
  }
  SumErr t = two_sum(s, (4.0f * idr2) * xh);
  s = t.s;
  comp = comp + t.e;
  t = two_sum(s, (2.0f * idr2) * xh);
  s = t.s;
  comp = comp + t.e;
  comp = (comp + rl) - (alo - (6.0f * idr2) * xl);
  if (Q.has_lam) {
    const float lam_h = Q.lam_hi, lam_l = Q.lam_lo;
    // Dekker TwoProduct of x_hi * lam_hi
    const float p = xh * lam_h;
    float a1, a2, b1, b2;
    veltkamp(xh, a1, a2);
    veltkamp(lam_h, b1, b2);
    const float pe = (((a1 * b1 - p) + a1 * b2) + a2 * b1) + a2 * b2;
    t = two_sum(s, p);
    s = t.s;
    comp = (comp + (t.e + pe)) + (lam_h * xl + lam_l * xh);
  }
  return s + comp;
}

template <int SLAB>
__global__ void __launch_bounds__(DF_NT, DF_MINB)
df32_march_kernel(LevelParams P, Df32Params Q, int cz, int vec,
                  const float* __restrict__ xhi,
                  const float* __restrict__ xlo,
                  const float* __restrict__ rhshi,
                  const float* __restrict__ rhslo, float* __restrict__ out,
                  SlabParams Zs) {
  constexpr int C = DF_C, TX = DF_TX, TY = DF_TY, HT = DF_HT;
  constexpr int SX = DF_SX, PL = DF_PL, PD = DF_PD, NP = DF_NP, NR = DF_NR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const s_xh = reinterpret_cast<float*>(smem_raw);   // NP planes
  float* const s_xl = s_xh + NP * PL;                       // NP planes
  float* const s_rh = s_xl + NP * PL;                       // NR x TX*TY
  float* const s_rl = s_rh + NR * TX * TY;                  // NR x TX*TY

  const int X = P.X, Y = P.Y, Z = P.Z;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int zb = blockIdx.z * cz;                  // this block's z chunk
  const int ze = zb + cz < Z ? zb + cz : Z;

  // ---- this thread's four cells: everything that does not depend on z --
  const int h = threadIdx.x % HT, ty = threadIdx.x / HT;
  const int gx0 = x0 + C * h, gy = y0 + ty;
  const int io = (ty + 1) * SX + 4 + C * h;    // cell 0 in a plane
  const int ir = ty * TX + C * h;              // cell 0 in an rhs plane
  bool in[C];
#pragma unroll
  for (int c = 0; c < C; ++c) in[c] = gx0 + c < X && gy < Y;
  const bool ovec = vec != 0 && gx0 + C <= X;   // aligned, inside in x
  const int sy = src_idx(gy, Y, P.per[1]);      // -1 outside a face
  const long long gplane = (long long)(Y + 2 * PY) * X;
  // SLAB: the z faces this slab synthesizes (else it reads their pads)
  const bool zsyn[2] = {SLAB != 0 && slab_syn(P, Zs, 0),
                        SLAB != 0 && slab_syn(P, Zs, 1)};

  // ---- copy plane q into ring position k (cp.async, one group): the
  // thread's cells of x_hi and x_lo, the x halo (first and last thread of
  // a row), the y halo (first and last row), and rhs_hi and rhs_lo ----
  auto load = [&](int q, int k) {
    const int px = P.per[0], py = P.per[1];
    // SLAB: plane q is its local plane, a pad plane beyond the slab too;
    // it has no source (zq) beyond a face that synthesizes
    const int sq = SLAB != 0 ? q : src_idx(q, Z, P.per[2]);
    const bool zq = SLAB != 0 ? !((q < 0 && zsyn[0]) || (q >= Z && zsyn[1]))
                              : sq >= 0;
    const long long zo =
        (long long)((SLAB != 0 ? sq : sq < 0 ? 0 : sq) + PZ) * gplane;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const float* base = f ? xlo : xhi;
      const float* pz = base + zo;
      auto row = [&](int s) {
        return zq && s >= 0 ? pz + (long long)(s + PY) * X : nullptr;
      };
      float* d = (f ? s_xl : s_xh) + (k % NP) * PL + io;
      af_row<float>(d, base, row(sy), gx0, X, px, false, ovec);
      if (h == 0) af_cell<float>(d - 1, base, row(sy), src_idx(x0 - 1, X, px));
      if (h == HT - 1)
        af_cell<float>(d + C, base, row(sy), src_idx(x0 + TX, X, px));
      if (ty == 0)
        af_row<float>(d - SX, base, row(src_idx(y0 - 1, Y, py)), gx0, X, px,
                      false, ovec);
      if (ty == TY - 1)
        af_row<float>(d + SX, base, row(src_idx(y0 + TY, Y, py)), gx0, X, px,
                      false, ovec);
    }
    // the rhs of a plane outside [0, Z) is never read
    const bool rq = q >= 0 && q < Z && sy >= 0;
    const long long ro = (long long)((rq ? q : 0) + PZ) * gplane +
                         (long long)((rq ? sy : 0) + PY) * X;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const float* base = f ? rhslo : rhshi;
      af_row<float>((f ? s_rl : s_rh) + (k % NR) * TX * TY + ir, base,
                    rq ? base + ro : nullptr, gx0, X, px, false, ovec);
    }
  };

  // ring position k holds plane zb - 1 + k; the first PD go now
#pragma unroll
  for (int k = 0; k < PD; ++k) {
    if (zb - 1 + k <= ze) load(zb - 1 + k, k);
    af_commit();
  }

  // x_hi and x_lo of the thread's cells on planes r-1, r, r+1
  float hm[C], hc[C], hn[C], lm[C], lc[C], ln[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    hm[c] = hc[c] = hn[c] = lm[c] = lc[c] = ln[c] = 0.0f;
  const int n[3] = {X, Y, Z};

  // step k: plane s = zb - 1 + k has arrived; plane r = s - 1 is computed
  for (int k = 0, s = zb - 1; s <= ze; ++k, ++s) {
    af_wait<PD - 1>();
    __syncthreads();
    if (s + PD <= ze) load(s + PD, k + PD);
    af_commit();

    af_ld4<float>(s_xh + (k % NP) * PL + io, hn);
    af_ld4<float>(s_xl + (k % NP) * PL + io, ln);
    const int r = s - 1;
    if (r >= zb) {
      const float* ph = s_xh + ((k + NP - 1) % NP) * PL + io;
      const float* pl = s_xl + ((k + NP - 1) % NP) * PL + io;
      float yhl[C], yhh[C], yll[C], ylh[C], qh[C], ql[C];
      af_ld4<float>(ph - SX, yhl);
      af_ld4<float>(ph + SX, yhh);
      af_ld4<float>(pl - SX, yll);
      af_ld4<float>(pl + SX, ylh);
      af_ld4<float>(s_rh + ((k + NR - 1) % NR) * TX * TY + ir, qh);
      af_ld4<float>(s_rl + ((k + NR - 1) % NR) * TX * TY + ir, ql);
      const float xhl = ph[-1], xhh = ph[C], xll = pl[-1], xlh = pl[C];
      float o[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int g[3] = {gx0 + c, gy, r};
        const float rlo_h[3] = {c ? hc[c - 1] : xhl, yhl[c], hm[c]};
        const float rhi_h[3] = {c < C - 1 ? hc[c + 1] : xhh, yhh[c], hn[c]};
        const float rlo_l[3] = {c ? lc[c - 1] : xll, yll[c], lm[c]};
        const float rhi_l[3] = {c < C - 1 ? lc[c + 1] : xlh, ylh[c], ln[c]};
        o[c] = df32_cell<SLAB>(P, Q, g, n, zsyn, hc[c], lc[c], qh[c], ql[c],
                               rlo_h, rhi_h, rlo_l, rhi_l);
      }
      if (gy < Y) {
        float* w =
            out + (long long)(r + PZ) * gplane + (long long)(gy + PY) * X;
        if (ovec) {
          af_st4<float>(w + gx0, o);
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c)
            if (in[c]) w[gx0 + c] = o[c];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      hm[c] = hc[c];
      hc[c] = hn[c];
      lm[c] = lc[c];
      lc[c] = ln[c];
    }
  }
}

// Whether the z-march takes a launch, in either mode: levels and slabs of
// 2^24 cells and more whose planes hold 2^18 cells and more (the refined
// path's 512^3 level, the sharded 512^3 level's slabs over 8), where it
// was faster than the thread-per-cell kernel in both turns of every run
// of experiments/probe_torch_kernels.py df32_march; on the 256^3 level
// the two were even (faster in both turns in three runs, in one of two
// in the fourth), on the 256^2 x 32 slab and smaller the march was
// slower in both (a march of few planes is latency, and the
// thread-per-cell kernel runs every cell at once), and those keep the
// thread-per-cell kernel (PERF.md).
inline bool df32_march_takes(const LevelParams& P) {
  const long long plane = (long long)P.X * P.Y;
  return plane >= (1LL << 18) && plane * P.Z >= (1LL << 24);
}

// One launch of the double-float residual: the z-march (*design = 4) where
// df32_march_takes, else (and with -DOMG_DF32MARCH=0, always) the
// thread-per-cell kernel (*design = 0).
template <int SLAB>
static int launch_df32(const LevelParams& P, const Df32Params& Q,
                       const SlabParams& Zs, const void* xhi, const void* xlo,
                       const void* rhshi, const void* rhslo, void* out,
                       cudaStream_t stream, int* design) {
#if OMG_DF32MARCH
  if (df32_march_takes(P)) {
    *design = 4;
    auto kernel = df32_march_kernel<SLAB>;
    cudaError_t e = allow_smem(kernel, DF_SMEM);
    if (e != cudaSuccess) return (int)e;
    auto al = [](const void* p) { return (uintptr_t)p % 16 == 0; };
    const int vec = P.X % 4 == 0 && al(xhi) && al(xlo) && al(rhshi) &&
                    al(rhslo) && al(out);
    int cz = DF_CHUNK_Z;
    while (cz > DF_MIN_CZ &&
           cdiv(P.X, DF_TX) * cdiv(P.Y, DF_TY) * cdiv(P.Z, cz) <
               MIN_BLOCKS_PER_SM * (unsigned)wide_sms())
      cz /= 2;
    dim3 grid(cdiv(P.X, DF_TX), cdiv(P.Y, DF_TY), cdiv(P.Z, cz));
    kernel<<<grid, DF_NT, DF_SMEM, stream>>>(
        P, Q, cz, vec, (const float*)xhi, (const float*)xlo,
        (const float*)rhshi, (const float*)rhslo, (float*)out, Zs);
    return (int)cudaGetLastError();
  }
#endif
  *design = 0;
  dim3 block(OMG_DF32_BX, OMG_DF32_BY, OMG_DF32_BZ);
  dim3 grid(cdiv(P.X, OMG_DF32_BX), cdiv(P.Y, OMG_DF32_BY),
            cdiv(P.Z, OMG_DF32_BZ));
  residual_df32_kernel<SLAB><<<grid, block, 0, stream>>>(
      P, Q, (const float*)xhi, (const float*)xlo, (const float*)rhshi,
      (const float*)rhslo, (float*)out, Zs);
  return (int)cudaGetLastError();
}

// Every field is a float32 [Z+16, Y+16, X] array; P carries the extents,
// the periodic flags, idr2[0] (equal on all axes, a power of two) and the
// c1/c2 coefficients of the faces.  design, unless null, receives 4 where
// the launch ran the z-march, else 0.  Returns the cudaError_t of the
// launch.
extern "C" int omg_residual_df32(const LevelParams* P, const Df32Params* Q,
                                 const void* xhi, const void* xlo,
                                 const void* rhshi, const void* rhslo,
                                 void* out, void* stream, int* design) {
  int w = 0;
  const int err = launch_df32<0>(*P, *Q, SlabParams{}, xhi, xlo, rhshi,
                                 rhslo, out, (cudaStream_t)stream, &w);
  if (design) *design = w;
  return err;
}

// The z-slab variant: as omg_residual_df32, on one slab whose z pads of
// x_hi and x_lo hold the neighbour slabs' planes; Zs: the slab's (lo, hi)
// z-face gates.  Returns the cudaError_t of the launch.
extern "C" int omg_residual_df32_slab(const LevelParams* P,
                                      const Df32Params* Q,
                                      const SlabParams* Zs, const void* xhi,
                                      const void* xlo, const void* rhshi,
                                      const void* rhslo, void* out,
                                      void* stream, int* design) {
  int w = 0;
  const int err = launch_df32<1>(*P, *Q, *Zs, xhi, xlo, rhshi, rhslo, out,
                                 (cudaStream_t)stream, &w);
  if (design) *design = w;
  return err;
}
