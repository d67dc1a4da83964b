// The z/dual ADMM stage with all five Boyd reductions.
//
// Replaces multivartv_tpu/ops/pallas_kernels.py:_dual_update_kernel
// (dual_update_2d, B1) and the z/dual half of _admm_chain (B4): the three
// scaled blocks of D theta, the soft-threshold of D theta - u_scale u at
// kappa (kappa * w on the true rows of a padded solve, _wmasks2), the primal
// residual r, u_new = u_scale u + r (stored unscaled: its scale is 1), and
// the sums |r|^2, |D theta|^2, |alpha|^2 (the last two on true rows only),
// |D'r|^2 and |D'u_new|^2.
//
// Bound on the H100: device-memory bandwidth: 4 lattices read (theta, 3 u),
// 6 written: 40 bytes per element.  dual_tile_kernel does the whole stage
// in one launch.  A CTA walks a column strip of 32 x 8 tiles, one thread
// per knot of a tile (dual_steps tiles, so that about 256 CTAs share the
// card).  For each tile it copies theta with a one-knot halo on every side
// (34 x 10, wrapped as jnp.roll wraps) and u at the tile and its upstream
// halo (33 x 9) into shared memory with cp.async, the next tile's copies
// in flight during this tile's work.  It computes the pointwise stage
// (dual_point: D theta, the prox, r, u_new) once at each knot (its thread)
// and once at each of the 41 points of the upstream halo (row i0 - 1 and
// column j0 - 1, the first 41 threads), and keeps r and u_new (and alpha,
// for the adjoint carry) of the 33 x 9 points in shared memory.  D'r and
// D'u_new at a knot come from its own values (registers) and its three
// upstream neighbours' (shared memory), as the TPU kernel keeps r and
// u_new in VMEM: each stage once, each value read once plus the halo (41
// of 297 stage points, 84 of 340 theta points, most of them L2 hits).
// u_new must not alias u (the halo reads the old u).  The five sums: per
// thread over its tiles, then per warp by shuffles, then once per CTA into
// five partials; the CTA that takes the last ticket (an atomic counter per
// problem, after __threadfence) sums every CTA's partials in
// launch_finish's fixed order (reduce.cu: thread t adds CTAs t, t + 256,
// ..., then the CTA sums its threads) into scal[S_STATS ..] and sets the
// ticket back to 0, so the next launch finds it 0.  No float
// atomics: a second run repeats bit for bit.  kappa and u_scale are read
// through their pointers: no set-up launch.  One launch covers a batch of
// problems (blockIdx.z), B5's CV folds among them; a frozen problem
// (Batch::act) writes nothing, its statistics included.
//
// Two template flags make the same kernel B8's (tiled.cu, the large-lattice
// route): kWantAdjoints also writes dta = D'alpha and dtu = D'u_new, and
// !kWantAlpha skips the three alpha stores, which nothing reads on that
// route.  B1 and B4/B5's chain are <true, false>.
//
// A third, kSlab, makes it B8s (pallas_kernels.py:dual_update_tiled_2d_shard,
// _tiled_dual_kernel with sharded=True): the same march on one rank's row
// slab of a lattice cut into row slabs, in one launch.  Only the rows a tile
// copies and the row masks change.  Local row -1 of theta and u comes from
// the top halo rows (the previous rank's last rows) and row m0 of theta from
// the bottom one (the next rank's first row), where B1 wraps; only the
// slab's first and last tiles reach those rows and choose a source per
// copied point, the others copy the slab's own rows, and no neighbour read
// chooses one.  Every mask uses the global row row_off + i (edge_global,
// valid_global, and the true_m masks), so the rows above global row 0 and
// the global last row are masked as the TPU kernel masks them.  The five
// sums are this slab's partial sums, added by the last CTA as B8's; the
// caller all-reduces them over the ranks.  The march's CTA count depends on
// the slab's shape alone, so on a one-rank slab (the whole lattice, zero
// halos) B8s sums in B8's order and equals it bit for bit.  Bound: as B8,
// plus the five halo rows read (theta above and below, u above).

#include "dual.cuh"

namespace mvtv {

template <bool kWantAlpha, bool kWantAdjoints, bool kSlab>
__global__ void __launch_bounds__(kThreads)
dual_tile_kernel(const float* __restrict__ theta, const float* __restrict__ u0,
                 const float* __restrict__ u1, const float* __restrict__ u2,
                 const float* kappa_p, const float* us_p, float* scal, Scales sc, int t0,
                 int t1, float* __restrict__ a0, float* __restrict__ a1, float* __restrict__ a2,
                 float* __restrict__ un0, float* __restrict__ un1, float* __restrict__ un2,
                 float* __restrict__ dta, float* __restrict__ dtu, float* partials,
                 unsigned* tickets, int steps, Lat L, Batch bt, DualHalo h, Slab sl) {
  __shared__ float smem[DualSmem<kWantAdjoints>::kFloats];
  __shared__ float ws[kWarps][5];
  __shared__ bool last;
  if (frozen(bt)) return;
  const size_t off = lat_offset(L);
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int r_first = blockIdx.y * steps, r_end = min(r_first + steps, (L.m0 + TY - 1) / TY);
  auto at = [&](float* x) { return x ? x + off : x; };
  const DualLats d{theta + off, u0 + off, u1 + off, u2 + off, at(a0), at(a1), at(a2), at(un0),
                   at(un1), at(un2), at(dta), at(dtu), kappa_p[scal_offset(bt)],
                   us_p[scal_offset(bt)]};
  float st[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  dual_march<kWantAlpha, kWantAdjoints, kSlab>(d, sc, t0, t1, blockIdx.x, r_first, r_end, L, h,
                                               sl, threadIdx.x, threadIdx.y,
                                               DualSmem<kWantAdjoints>(smem), st);
  // This CTA's five sums; the CTA that takes the problem's last ticket adds
  // every CTA's.
  cta_sum5(st, ws, tid);
  const int nb = gridDim.x * gridDim.y;
  partials += part_offset(bt);
  if (tid == 0) {
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;
#pragma unroll
    for (int v = 0; v < 5; ++v) partials[v * nb + blk] = st[v];
    __threadfence();
    last = atomicAdd(&tickets[blockIdx.z], 1u) == unsigned(nb - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float tot[5];
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    tot[v] = 0.f;
    for (int k = tid; k < nb; k += kThreads) tot[v] += __ldcg(partials + v * nb + k);
  }
  cta_sum5(tot, ws, tid);
  if (tid == 0) {
    float* stats = scal + scal_offset(bt) + S_STATS;
#pragma unroll
    for (int v = 0; v < 5; ++v) stats[v] = tot[v];
    tickets[blockIdx.z] = 0u;
  }
}

int launch_dual(bool want_alpha, bool want_adjoints, const float* theta, const float* u0,
                const float* u1, const float* u2, const float* kappa, const float* uscale,
                float* scal, Scales sc, int t0, int t1, float* a0, float* a1, float* a2,
                float* un0, float* un1, float* un2, float* dta, float* dtu, float* partials,
                unsigned* tickets, Lat L, Batch bt, cudaStream_t s, const DualHalo* halo,
                Slab sl) {
  const int steps = dual_steps(L);
  const dim3 grid((L.m1 + TX - 1) / TX, ((L.m0 + TY - 1) / TY + steps - 1) / steps, bt.B);
  const dim3 block(TX, TY);
  const DualHalo h = halo != nullptr ? *halo : DualHalo{};
#define MVTV_DUAL(WA, WD, SL)                                                           \
  dual_tile_kernel<WA, WD, SL><<<grid, block, 0, s>>>(theta, u0, u1, u2, kappa, uscale, \
                                                      scal, sc, t0, t1, a0, a1, a2, un0, \
                                                      un1, un2, dta, dtu, partials,      \
                                                      tickets, steps, L, bt, h, sl)
  // Only the pairs a route launches are compiled: B1's (alpha, no carries)
  // and the tiled ADMM loop's (carries, no alpha), each on a whole lattice
  // and on a row slab of one problem.
  if (want_alpha == want_adjoints || (halo != nullptr && bt.B != 1))
    return int(cudaErrorInvalidValue);
  if (want_alpha && halo != nullptr)
    MVTV_DUAL(true, false, true);
  else if (want_alpha)
    MVTV_DUAL(true, false, false);
  else if (halo != nullptr)
    MVTV_DUAL(false, true, true);
  else
    MVTV_DUAL(false, true, false);
#undef MVTV_DUAL
  MVTV_LAUNCHED();
  return 0;
}

}  // namespace mvtv

// B1 entry point.  alpha_out and u_out hold 3 lattices each; the 5
// statistics land in scal[S_STATS .. S_STATS + 4]; partials holds 5 floats
// per 32 x 8 tile; tickets points to one unsigned that is 0, and is 0 again
// when the launch ends.  One launch.
extern "C" int mvtv_dual_update_2d(const float* theta, const float* u0, const float* u1,
                                   const float* u2, const float* kappa, const float* uscale,
                                   float s_mix, float s_ax1, float s_ax0, int t0, int t1,
                                   float* alpha_out, float* u_out, float* partials,
                                   unsigned* tickets, float* scal, int m0, int m1,
                                   void* stream) {
  using namespace mvtv;
  const size_t n = size_t(m0) * m1;
  MVTV_CHECK(launch_dual(true, false, theta, u0, u1, u2, kappa, uscale, scal,
                         Scales{s_mix, s_ax1, s_ax0}, t0, t1, alpha_out, alpha_out + n,
                         alpha_out + 2 * n, u_out, u_out + n, u_out + 2 * n, nullptr, nullptr,
                         partials, tickets, Lat{m0, m1}, kOne,
                         static_cast<cudaStream_t>(stream)));
  return int(cudaGetLastError());
}

// B8s entry point: the stage of B8 on the (m0, m1) slab whose row 0 is global
// row row_off of m0g, with the halo rows th_top, th_bot (theta's rows above
// and below the slab) and u0_top .. u2_top (u's row above), one launch.
// Outputs, partials, tickets and scal as mvtv_dual_update_tiled_2d's; the 5
// statistics in scal[S_STATS ..] are this slab's partial sums.
extern "C" int mvtv_dual_update_tiled_2d_shard(
    const float* theta, const float* u0, const float* u1, const float* u2, const float* th_top,
    const float* th_bot, const float* u0_top, const float* u1_top, const float* u2_top,
    const float* kappa, const float* uscale, float s_mix, float s_ax1, float s_ax0, int t0,
    int t1, int row_off, int m0g, int want_alpha, int want_adjoints, float* alpha_out,
    float* u_out, float* dta, float* dtu, float* partials, unsigned* tickets, float* scal,
    int m0, int m1, void* stream) {
  using namespace mvtv;
  const size_t n = size_t(m0) * m1;
  float* a[3] = {nullptr, nullptr, nullptr};
  if (want_alpha)
    for (int k = 0; k < 3; ++k) a[k] = alpha_out + k * n;
  const DualHalo h{th_top, th_bot, u0_top, u1_top, u2_top};
  MVTV_CHECK(launch_dual(want_alpha != 0, want_adjoints != 0, theta, u0, u1, u2, kappa, uscale,
                         scal, Scales{s_mix, s_ax1, s_ax0}, t0, t1, a[0], a[1], a[2], u_out,
                         u_out + n, u_out + 2 * n, dta, dtu, partials, tickets, Lat{m0, m1},
                         kOne, static_cast<cudaStream_t>(stream), &h, Slab{row_off, m0g}));
  return int(cudaGetLastError());
}
