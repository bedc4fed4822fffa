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
// a quarter of the time the bytes take.  Design: one thread per cell; it
// reads the 7-point neighbourhoods of x_hi and x_lo straight from device
// memory, x fastest across a warp, so each warp reads whole rows and the
// neighbours' reuse (13 of the 16 loads) is served by L1/L2.  Periodic
// axes read wrapped indices and physical faces synthesize their ghosts
// inline, so no pad is ever read: pads of the inputs may hold NaN.
//
// SLAB = 1 (omg_residual_df32_slab) replaces the entry point called with
// z_gates, on one slab of the z-slab solver's refined outer: a z
// neighbour of x_hi and x_lo beyond a face the slab does not own is read
// from the z pads (the halo exchange's copies), and only a face the slab
// owns synthesizes its ghost pair.  Same arithmetic, same bound.
#include "stencil_common.cuh"

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

// Every field is a float32 [Z+16, Y+16, X] array; P carries the extents,
// the periodic flags, idr2[0] (equal on all axes, a power of two) and the
// c1/c2 coefficients of the faces.  Returns the cudaError_t of the launch.
extern "C" int omg_residual_df32(const LevelParams* P, const Df32Params* Q,
                                 const void* xhi, const void* xlo,
                                 const void* rhshi, const void* rhslo,
                                 void* out, void* stream) {
  dim3 block(OMG_DF32_BX, OMG_DF32_BY, OMG_DF32_BZ);
  dim3 grid(cdiv(P->X, OMG_DF32_BX), cdiv(P->Y, OMG_DF32_BY),
            cdiv(P->Z, OMG_DF32_BZ));
  residual_df32_kernel<0><<<grid, block, 0, (cudaStream_t)stream>>>(
      *P, *Q, (const float*)xhi, (const float*)xlo, (const float*)rhshi,
      (const float*)rhslo, (float*)out, SlabParams{});
  return (int)cudaGetLastError();
}

// The z-slab variant: as omg_residual_df32, on one slab whose z pads of
// x_hi and x_lo hold the neighbour slabs' planes; Zs: the slab's (lo, hi)
// z-face gates.  Returns the cudaError_t of the launch.
extern "C" int omg_residual_df32_slab(const LevelParams* P,
                                      const Df32Params* Q,
                                      const SlabParams* Zs, const void* xhi,
                                      const void* xlo, const void* rhshi,
                                      const void* rhslo, void* out,
                                      void* stream) {
  dim3 block(OMG_DF32_BX, OMG_DF32_BY, OMG_DF32_BZ);
  dim3 grid(cdiv(P->X, OMG_DF32_BX), cdiv(P->Y, OMG_DF32_BY),
            cdiv(P->Z, OMG_DF32_BZ));
  residual_df32_kernel<1><<<grid, block, 0, (cudaStream_t)stream>>>(
      *P, *Q, (const float*)xhi, (const float*)xlo, (const float*)rhshi,
      (const float*)rhslo, (float*)out, *Zs);
  return (int)cudaGetLastError();
}
