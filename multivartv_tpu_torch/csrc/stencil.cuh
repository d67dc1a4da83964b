// Device stencils shared by the residual (rhs.cu), the CG matvec
// (xupdate.cu) and the tiled and row-slab kernels (tiled.cu), in the
// operation order of the TPU kernels' _gram_matvec_kernel and _rhs_kernel
// (multivartv_tpu/ops/pallas_kernels.py).  Each takes the rows it reads as
// pointers, so the whole-lattice kernels pass the circular neighbours and
// the row-slab kernels (B9s, B11s) their halo rows.
#pragma once

#include "common.cuh"

namespace mvtv {

// sum_b g_b adj_b(fwd_b(v)) at column c of row r0, with rm and rp the rows
// above and below and cm, cp the columns left and right of c, in
// _gram_matvec_kernel's order: g_ax1 adj1(d1) + g_ax0 adj0(d0) + g_mix
// adj0(adj1(dm)).  e1m and e10 mask the axis-1 differences taken at the
// column left of the knot and at its own; e0m and e00 the axis-0 ones taken
// at the row above and at this row.
__device__ __forceinline__ float gram_cols(const float* __restrict__ rm,
                                           const float* __restrict__ r0,
                                           const float* __restrict__ rp, int cm, int c, int cp,
                                           float e1m, float e10, float e0m, float e00,
                                           float g_mix, float g_ax1, float g_ax0) {
  const float v_mm = rm[cm], v_m0 = rm[c], v_mp = rm[cp];
  const float v_0m = r0[cm], v_00 = r0[c], v_0p = r0[cp];
  const float v_pm = rp[cm], v_p0 = rp[c], v_pp = rp[cp];
  // d0[r, c] = (v[r+1, c] - v[r, c]) * edge0(r)
  const float d0_mm = (v_0m - v_mm) * e0m, d0_m0 = (v_00 - v_m0) * e0m;
  const float d0_mp = (v_0p - v_mp) * e0m;
  const float d0_0m = (v_pm - v_0m) * e00, d0_00 = (v_p0 - v_00) * e00;
  const float d0_0p = (v_pp - v_0p) * e00;
  // dm[r, c] = (d0[r, c+1] - d0[r, c]) * edge1(c)
  const float dm_mm = (d0_m0 - d0_mm) * e1m, dm_m0 = (d0_mp - d0_m0) * e10;
  const float dm_0m = (d0_00 - d0_0m) * e1m, dm_00 = (d0_0p - d0_00) * e10;
  // d1[r, c] = (v[r, c+1] - v[r, c]) * edge1(c)
  const float d1_0m = (v_00 - v_0m) * e1m, d1_00 = (v_0p - v_00) * e10;
  const float adj1_d1 = d1_0m - d1_00;
  const float adj0_d0 = d0_m0 - d0_00;
  const float adj01_dm = (dm_mm - dm_m0) - (dm_0m - dm_00);
  return g_ax1 * adj1_d1 + g_ax0 * adj0_d0 + g_mix * adj01_dm;
}

// gram_cols at column j of a lattice row of m1 (circular columns).
__device__ __forceinline__ float gram_rows(const float* __restrict__ rm,
                                           const float* __restrict__ r0,
                                           const float* __restrict__ rp, int j, int m1,
                                           float e0m, float e00, float g_mix, float g_ax1,
                                           float g_ax0) {
  const int jm = dec(j, m1);
  return gram_cols(rm, r0, rp, jm, j, inc(j, m1), edge(jm, m1), edge(j, m1), e0m, e00, g_mix,
                   g_ax1, g_ax0);
}

// gram_rows at (i, j) of a whole lattice (circular neighbours).
__device__ __forceinline__ float gram_at(const float* __restrict__ v, int i, int j, Lat L,
                                         float g_mix, float g_ax1, float g_ax0) {
  const int im = dec(i, L.m0), ip = inc(i, L.m0);
  return gram_rows(v + size_t(im) * L.m1, v + size_t(i) * L.m1, v + size_t(ip) * L.m1, j,
                   L.m1, edge(im, L.m0), edge(i, L.m0), g_mix, g_ax1, g_ax0);
}

// (counts + rho D'D) x at (i, j) of a whole lattice, cnt the count there:
// the CG's matvec and the A x of its residual (_gram_matvec_kernel).
__device__ __forceinline__ float gram_apply_at(const float* __restrict__ x, float cnt, int i,
                                               int j, Lat L, float rho, Scales sc) {
  return cnt * x[size_t(i) * L.m1 + j] + gram_at(x, i, j, L, rho * sc.mix * sc.mix,
                                                 rho * sc.ax1 * sc.ax1, rho * sc.ax0 * sc.ax0);
}

// The rows (this one and the one above) of one block of alpha and of u.
struct BlockRows {
  const float *a, *a_up, *u, *u_up;
};

// s_mix adj0(adj1(w0)) + s_ax1 adj1(w1) + s_ax0 adj0(w2) at column j,
// w_b = a_b + uscale * u_b, the row above scaled by v_up (a slab's rows
// above global row 0 are 0, _tiled_rhs_kernel's `valid`).
__device__ __forceinline__ float adjoint_rows(BlockRows w0, BlockRows w1, BlockRows w2,
                                              float us, float v_up, int j, int m1, Scales sc) {
  const int jm = dec(j, m1);
  const float w0_c = w0.a[j] + us * w0.u[j], w0_l = w0.a[jm] + us * w0.u[jm];
  const float w0_u = (w0.a_up[j] + us * w0.u_up[j]) * v_up;
  const float w0_d = (w0.a_up[jm] + us * w0.u_up[jm]) * v_up;
  const float w1_c = w1.a[j] + us * w1.u[j], w1_l = w1.a[jm] + us * w1.u[jm];
  const float w2_c = w2.a[j] + us * w2.u[j];
  const float w2_u = (w2.a_up[j] + us * w2.u_up[j]) * v_up;
  const float t_mix = (w0_d - w0_u) - (w0_l - w0_c);
  const float t_ax1 = w1_l - w1_c;
  const float t_ax0 = w2_u - w2_c;
  return sc.mix * t_mix + sc.ax1 * t_ax1 + sc.ax0 * t_ax0;
}

// adjoint_rows at (i, j) of a whole lattice (circular neighbours).
__device__ __forceinline__ float adjoint_at(const float* __restrict__ a0,
                                            const float* __restrict__ a1,
                                            const float* __restrict__ a2,
                                            const float* __restrict__ u0,
                                            const float* __restrict__ u1,
                                            const float* __restrict__ u2, float us, int i,
                                            int j, Lat L, Scales sc) {
  const size_t r = size_t(i) * L.m1, ru = size_t(dec(i, L.m0)) * L.m1;
  return adjoint_rows(BlockRows{a0 + r, a0 + ru, u0 + r, u0 + ru},
                      BlockRows{a1 + r, a1 + ru, u1 + r, u1 + ru},
                      BlockRows{a2 + r, a2 + ru, u2 + r, u2 + ru}, us, 1.f, j, L.m1, sc);
}

// r = b - A x at (i, j) with b = oty + rho D'(alpha + us u) formed in
// registers (B2's b, never stored): _admm_chain's r0.  Pointers at the
// problem's lattices; oty_c and cnt the values at (i, j).
__device__ __forceinline__ float residual_formed_at(
    const float* __restrict__ x, float cnt, float oty_c, const float* __restrict__ a0,
    const float* __restrict__ a1, const float* __restrict__ a2, const float* __restrict__ u0,
    const float* __restrict__ u1, const float* __restrict__ u2, float rho, float us, int i, int j,
    Lat L, Scales sc) {
  const float bv = oty_c + rho * adjoint_at(a0, a1, a2, u0, u1, u2, us, i, j, L, sc);
  return bv - gram_apply_at(x, cnt, i, j, L, rho, sc);
}

}  // namespace mvtv
