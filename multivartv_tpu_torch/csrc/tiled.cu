// The large-lattice (above 2^20 knots) stencil kernels: B8, B9, B10.
//
// Replace multivartv_tpu/ops/pallas_kernels.py:
//   * dual_update_tiled_2d (B8, _tiled_dual_kernel): B1's z/dual stage with
//     the adjoint carries dta = D'alpha, dtu = D'u_new written out and the
//     alpha stores skipped (want_alpha=False) on the ADMM route;
//   * gram_residual_tiled_2d (B9, _tiled_gram_res_kernel): the spectral CG's
//     initial residual r0 = b - (counts + rho D'D) v, with b either given or
//     formed in registers as oty + rho (dta + u_scale dtu) (rhs_parts) and
//     never stored;
//   * gram_matvec_tiled_2d (B10, _tiled_gram_kernel): (counts + rho D'D) v,
//     the packed layout's matvec;
//   * gram_residual_tiled_2d_shard (B9s, _tiled_gram_res_kernel with
//     sharded=True): B9 on one rank's row slab of a lattice cut into row
//     slabs, v's rows above and below the slab given (the neighbours'
//     boundary rows, zeros at the global edges), every axis-0 mask on the
//     global row; in mode 0 the same kernel is the slab's matvec, the
//     sharded PCG's (the JAX package leaves that one to XLA's partitioner).
//     Bound: as B9 or B10, plus two halo rows.
//
// The TPU kernels stream row panels of T <= 512 rows with 8-row halos
// through VMEM (double-buffered manual DMA, _halo_copies/_halo_pingpong)
// because a 2048^2 lattice does not fit VMEM.  None of that carries over:
// B8 is B1's kernel (dual.cu: a march of 32 x 8 tiles, each with its halo
// in shared memory, each stage once, one launch), and B9 and B10 run one
// thread per knot reading its 3x3 neighbourhood straight from device
// memory (neighbouring threads share the lines in L1/L2), as B2 does, so
// the "tiled" kernels are the whole-lattice kernels launched on a larger
// grid.  What the halo code taught stays: every value outside the lattice
// is an explicit 0 under the padded-block convention (the edge() masks of
// stencil.cuh), so a wrapped neighbour never leaks in.
//
// Bound on the H100: device-memory bandwidth, one pass each.  B8 with alpha
// skipped reads theta and 3 u and writes 3 u_new, dta and dtu: 36 bytes per
// knot (plus the five per-CTA partial sums, which its last CTA adds up).
// B9 in fused mode reads v, counts, oty, dta and dtu and writes r0: 24
// bytes per knot.  B10 reads v and counts and writes one lattice: 12 bytes
// per knot.  The scalars (kappa, rho, u_scale) stay on the device.  B9 and
// B10 have no shared-memory tiling of the neighbourhood yet.
#include "stencil.cuh"

namespace mvtv {

enum GramMode : int { GRAM_MATVEC = 0, GRAM_RESIDUAL = 1, GRAM_RESIDUAL_FUSED = 2 };

// kSlab: the lattice is one rank's row slab (B9s and the slab matvec); its
// rows -1 and m0 are v_top and v_bot, and the axis-0 masks use the global
// row of sl.  Otherwise the neighbours are circular (B9, B10).
template <int MODE, bool kSlab>
__global__ void __launch_bounds__(kThreads)
gram_tiled_kernel(const float* __restrict__ v, const float* __restrict__ v_top,
                  const float* __restrict__ v_bot, const float* __restrict__ counts,
                  const float* __restrict__ b, const float* __restrict__ oty,
                  const float* __restrict__ dta, const float* __restrict__ dtu,
                  const float* __restrict__ rho_p, const float* __restrict__ us_p, Scales sc,
                  Slab sl, float* __restrict__ out, Lat L) {
  const int j = blockIdx.x * TX + threadIdx.x;
  const int i = blockIdx.y * TY + threadIdx.y;
  if (i >= L.m0 || j >= L.m1) return;
  const size_t c = size_t(i) * L.m1 + j;
  const float rho = *rho_p;
  // rho * s^2 per block, as _tiled_gram_res_kernel's scalars.
  const float g_mix = rho * (sc.mix * sc.mix);
  const float g_ax1 = rho * (sc.ax1 * sc.ax1);
  const float g_ax0 = rho * (sc.ax0 * sc.ax0);
  float gv;
  if (kSlab) {
    const int g = sl.row_off + i;
    gv = gram_rows(slab_row(v, v_top, v_bot, i - 1, L), v + size_t(i) * L.m1,
                   slab_row(v, v_top, v_bot, i + 1, L), j, L.m1, edge_global(g - 1, sl.m0g),
                   edge_global(g, sl.m0g), g_mix, g_ax1, g_ax0);
  } else {
    gv = gram_at(v, i, j, L, g_mix, g_ax1, g_ax0);
  }
  const float av = counts[c] * v[c] + gv;
  if (MODE == GRAM_MATVEC) {
    out[c] = av;
    return;
  }
  const float bv = MODE == GRAM_RESIDUAL ? b[c] : oty[c] + rho * (dta[c] + *us_p * dtu[c]);
  out[c] = bv - av;
}

template <bool kSlab>
int launch_gram(int mode, const float* v, const float* v_top, const float* v_bot,
                const float* counts, const float* b, const float* oty, const float* dta,
                const float* dtu, const float* rho, const float* uscale, Scales sc, Slab sl,
                float* out, Lat L, cudaStream_t s) {
  const dim3 grid = stencil_grid(L), block(TX, TY);
#define MVTV_GRAM(MODE)                                                                  \
  gram_tiled_kernel<MODE, kSlab><<<grid, block, 0, s>>>(v, v_top, v_bot, counts, b, oty, \
                                                        dta, dtu, rho, uscale, sc, sl, out, L)
  if (mode == GRAM_MATVEC)
    MVTV_GRAM(GRAM_MATVEC);
  else if (mode == GRAM_RESIDUAL)
    MVTV_GRAM(GRAM_RESIDUAL);
  else if (mode == GRAM_RESIDUAL_FUSED)
    MVTV_GRAM(GRAM_RESIDUAL_FUSED);
  else
    return int(cudaErrorInvalidValue);
#undef MVTV_GRAM
  return int(cudaGetLastError());
}

}  // namespace mvtv

// B8 entry point: the dual stage of B1 with B8's flags, one launch.
// alpha_out (3 lattices) is read only with want_alpha, dta/dtu only with
// want_adjoints; the 5 statistics land in scal[S_STATS .. S_STATS + 4];
// partials and tickets as mvtv_dual_update_2d's.
extern "C" int mvtv_dual_update_tiled_2d(const float* theta, const float* u0, const float* u1,
                                         const float* u2, const float* kappa,
                                         const float* uscale, float s_mix, float s_ax1,
                                         float s_ax0, int t0, int t1, int want_alpha,
                                         int want_adjoints, float* alpha_out, float* u_out,
                                         float* dta, float* dtu, float* partials,
                                         unsigned* tickets, float* scal, int m0, int m1,
                                         void* stream) {
  using namespace mvtv;
  const size_t n = size_t(m0) * m1;
  float* a[3] = {nullptr, nullptr, nullptr};
  if (want_alpha)
    for (int k = 0; k < 3; ++k) a[k] = alpha_out + k * n;
  MVTV_CHECK(launch_dual(want_alpha != 0, want_adjoints != 0, theta, u0, u1, u2, kappa, uscale,
                         scal, Scales{s_mix, s_ax1, s_ax0}, t0, t1, a[0], a[1], a[2], u_out,
                         u_out + n, u_out + 2 * n, dta, dtu, partials, tickets, Lat{m0, m1},
                         kOne, static_cast<cudaStream_t>(stream)));
  return int(cudaGetLastError());
}

// B9 (mode 1: b given; mode 2: b = oty + rho (dta + u_scale dtu)) and B10
// (mode 0: the matvec alone) entry point.  Pointers a mode does not read
// may be null.
extern "C" int mvtv_gram_tiled_2d(int mode, const float* v, const float* counts, const float* b,
                                  const float* oty, const float* dta, const float* dtu,
                                  const float* rho, const float* uscale, float s_mix,
                                  float s_ax1, float s_ax0, float* out, int m0, int m1,
                                  void* stream) {
  using namespace mvtv;
  return launch_gram<false>(mode, v, nullptr, nullptr, counts, b, oty, dta, dtu, rho, uscale,
                            Scales{s_mix, s_ax1, s_ax0}, Slab{0, m0}, out, Lat{m0, m1},
                            static_cast<cudaStream_t>(stream));
}

// B9s (modes 1 and 2) and the slab matvec (mode 0) on the (m0, m1) slab
// whose row 0 is global row row_off of m0g; v_top and v_bot are v's rows
// above and below the slab.
extern "C" int mvtv_gram_tiled_2d_shard(int mode, const float* v, const float* v_top,
                                        const float* v_bot, const float* counts, const float* b,
                                        const float* oty, const float* dta, const float* dtu,
                                        const float* rho, const float* uscale, float s_mix,
                                        float s_ax1, float s_ax0, int row_off, int m0g,
                                        float* out, int m0, int m1, void* stream) {
  using namespace mvtv;
  return launch_gram<true>(mode, v, v_top, v_bot, counts, b, oty, dta, dtu, rho, uscale,
                           Scales{s_mix, s_ax1, s_ax0}, Slab{row_off, m0g}, out, Lat{m0, m1},
                           static_cast<cudaStream_t>(stream));
}
