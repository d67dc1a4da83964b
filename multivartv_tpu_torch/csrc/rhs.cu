// The x-update right-hand side and residual stencils.
//
// Replaces multivartv_tpu/ops/pallas_kernels.py:_rhs_kernel (rhs_2d, B2,
// and B11 rhs_tiled_2d, which computes the same function at any size) and
// _tiled_rhs_kernel with sharded=True (rhs_tiled_2d_shard, B11s, below):
//   b = oty + rho * (s_mix adj0(adj1(w0)) + s_ax1 adj1(w1) + s_ax0 adj0(w2)),
//   w_b = alpha_b + u_scale * u_b (rhs_kernel),
// and, in residual_kernel, the initial CG residual r0 = b - A x of
// _xupdate_kernel_packed (B3, b given) and of _admm_chain (B4, B5: b formed
// in registers and never stored, pallas_kernels.py:683-684), where
//   A x = counts * x + sum_b rho s_b^2 adj_b(fwd_b(x)).
//
// Bound on the H100: device-memory bandwidth.  Mode B_FORMED reads 9 lattices
// (x, counts, oty, 3 alpha, 3 u) and writes one: 40 bytes per element, about
// 10.5 MB at 512^2, ~3 us at 3.35 TB/s, and the whole state is L2-resident.
// B2 alone (rhs_kernel) reads 7 and writes b: 32 bytes per element, 0.0100 ms
// at 1023^2, where its one kernel already runs at about that bound; so B2 is
// one launch that reads rho and u_scale through their device pointers, and
// the rest of a call is its wrapper's host time.
// Design: one thread per element reads its 3x3 neighbourhood straight from
// global memory (neighbouring threads share the lines in L1/L2), so every
// lattice is read from device memory about once; no shared-memory halo (a
// 1023-float row is not 16-byte aligned, and the row march's 4-byte copies
// ran slower than this kernel on such rows).
#include "stencil.cuh"

namespace mvtv {

template <int MODE>
__global__ void __launch_bounds__(kThreads)
residual_kernel(const float* __restrict__ b, const float* __restrict__ x,
                const float* __restrict__ counts, const float* __restrict__ oty,
                const float* __restrict__ a0, const float* __restrict__ a1,
                const float* __restrict__ a2, const float* __restrict__ u0,
                const float* __restrict__ u1, const float* __restrict__ u2,
                const float* __restrict__ scal, Scales sc, float* __restrict__ out, Lat L,
                Batch bt) {
  if (frozen(bt)) return;
  const int j = blockIdx.x * TX + threadIdx.x;
  const int i = blockIdx.y * TY + threadIdx.y;
  if (i >= L.m0 || j >= L.m1) return;
  const size_t off = lat_offset(L), coff = counts_offset(bt);
  const size_t c = size_t(i) * L.m1 + j;
  scal += scal_offset(bt);
  const float rho = scal[S_RHO];
  if (MODE == B_GIVEN)
    out[off + c] = b[off + c] - gram_apply_at(x + off, counts[coff + c], i, j, L, rho, sc);
  else
    out[off + c] = residual_formed_at(x + off, counts[coff + c], oty[coff + c], a0 + off,
                                      a1 + off, a2 + off, u0 + off, u1 + off, u2 + off, rho,
                                      scal[S_USCALE], i, j, L, sc);
}

int launch_residual(ResidualMode mode, const float* b, const float* x, const float* counts,
                    const float* oty, const float* a0, const float* a1, const float* a2,
                    const float* u0, const float* u1, const float* u2, const float* scal,
                    Scales sc, float* out, Lat L, Batch bt, cudaStream_t s) {
  const dim3 grid = stencil_grid(L, bt.B), block(TX, TY);
  if (mode == B_GIVEN)
    residual_kernel<B_GIVEN><<<grid, block, 0, s>>>(b, x, counts, oty, a0, a1, a2, u0, u1, u2,
                                                    scal, sc, out, L, bt);
  else
    residual_kernel<B_FORMED><<<grid, block, 0, s>>>(b, x, counts, oty, a0, a1, a2, u0, u1, u2,
                                                     scal, sc, out, L, bt);
  MVTV_LAUNCHED();
  return 0;
}

// B2 and B11: b = oty + rho D'(alpha + u_scale u) on a whole lattice, rho
// and u_scale read through their pointers (u_scale null: 1), in
// residual_kernel's operation order.
__global__ void __launch_bounds__(kThreads)
rhs_kernel(const float* __restrict__ a0, const float* __restrict__ a1,
           const float* __restrict__ a2, const float* __restrict__ u0,
           const float* __restrict__ u1, const float* __restrict__ u2,
           const float* __restrict__ oty, const float* __restrict__ rho_p,
           const float* __restrict__ us_p, Scales sc, float* __restrict__ out, Lat L) {
  const int j = blockIdx.x * TX + threadIdx.x;
  const int i = blockIdx.y * TY + threadIdx.y;
  if (i >= L.m0 || j >= L.m1) return;
  const size_t c = size_t(i) * L.m1 + j;
  const float us = us_p ? *us_p : 1.f;
  out[c] = oty[c] + *rho_p * adjoint_at(a0, a1, a2, u0, u1, u2, us, i, j, L, sc);
}

// B11s (pallas_kernels.py:rhs_tiled_2d_shard, _tiled_rhs_kernel with
// sharded=True): b on one rank's row slab; the adjoints read the row above
// local row 0 from the halo rows of alpha_0, alpha_2, u_0 and u_2 (the
// previous rank's last rows), scaled to 0 above global row 0 as the TPU
// kernel's `valid`.  Bound: B2's 32 bytes per knot, plus four halo rows.
struct RhsHalo {
  const float *a0_top, *a2_top, *u0_top, *u2_top;
};

__global__ void __launch_bounds__(kThreads)
rhs_shard_kernel(const float* __restrict__ a0, const float* __restrict__ a1,
                 const float* __restrict__ a2, const float* __restrict__ u0,
                 const float* __restrict__ u1, const float* __restrict__ u2, RhsHalo h,
                 const float* __restrict__ oty, const float* __restrict__ rho_p,
                 const float* __restrict__ us_p, Scales sc, Slab sl, float* __restrict__ out,
                 Lat L) {
  const int j = blockIdx.x * TX + threadIdx.x;
  const int i = blockIdx.y * TY + threadIdx.y;
  if (i >= L.m0 || j >= L.m1) return;
  const size_t r = size_t(i) * L.m1;
  const BlockRows w0{a0 + r, slab_row(a0, h.a0_top, nullptr, i - 1, L), u0 + r,
                     slab_row(u0, h.u0_top, nullptr, i - 1, L)};
  const BlockRows w1{a1 + r, nullptr, u1 + r, nullptr};
  const BlockRows w2{a2 + r, slab_row(a2, h.a2_top, nullptr, i - 1, L), u2 + r,
                     slab_row(u2, h.u2_top, nullptr, i - 1, L)};
  out[r + j] = oty[r + j] + *rho_p * adjoint_rows(w0, w1, w2, *us_p,
                                                  valid_global(sl.row_off + i - 1), j, L.m1,
                                                  sc);
}

}  // namespace mvtv

// B2 entry point: b = oty + rho D'(alpha + u_scale u), one launch; rho and
// uscale are device pointers (uscale null: 1).
extern "C" int mvtv_rhs_2d(const float* a0, const float* a1, const float* a2, const float* u0,
                           const float* u1, const float* u2, const float* oty, const float* rho,
                           const float* uscale, float s_mix, float s_ax1, float s_ax0, float* b,
                           int m0, int m1, void* stream) {
  using namespace mvtv;
  const Lat L{m0, m1};
  rhs_kernel<<<stencil_grid(L), dim3(TX, TY), 0, static_cast<cudaStream_t>(stream)>>>(
      a0, a1, a2, u0, u1, u2, oty, rho, uscale, Scales{s_mix, s_ax1, s_ax0}, b, L);
  return int(cudaGetLastError());
}

// B11s entry point: b = oty + rho D'(alpha + u_scale u) on the (m0, m1) slab
// whose row 0 is global row row_off; a0_top .. u2_top are the rows above it.
extern "C" int mvtv_rhs_tiled_2d_shard(const float* a0, const float* a1, const float* a2,
                                       const float* u0, const float* u1, const float* u2,
                                       const float* a0_top, const float* a2_top,
                                       const float* u0_top, const float* u2_top,
                                       const float* oty, const float* rho, const float* uscale,
                                       float s_mix, float s_ax1, float s_ax0, int row_off,
                                       float* b, int m0, int m1, void* stream) {
  using namespace mvtv;
  const Lat L{m0, m1};
  rhs_shard_kernel<<<stencil_grid(L), dim3(TX, TY), 0, static_cast<cudaStream_t>(stream)>>>(
      a0, a1, a2, u0, u1, u2, RhsHalo{a0_top, a2_top, u0_top, u2_top}, oty, rho, uscale,
      Scales{s_mix, s_ax1, s_ax0}, Slab{row_off, 0}, b, L);
  return int(cudaGetLastError());
}
