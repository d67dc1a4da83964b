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
// ticket back to 0, so a rerun and a graph replay find it 0.  No float
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
#include "common.cuh"

namespace mvtv {

struct DualPt {
  float dt[3], a[3], r[3], un[3];
};

// The pointwise stage at a point from theta there (th00), one column on
// (th01), one row on (th10) and both (th11), and u there: e0 and e1 mask
// the axis-0 and axis-1 differences (the lattice's last row and column),
// valid zeroes the ax1 block and u on rows above a slab's global row 0 (1
// elsewhere), (g, c) is the point's row and column for the true_m masks.
__device__ __forceinline__ DualPt dual_point(float th00, float th01, float th10, float th11,
                                             float u0, float u1, float u2, int c, float e0,
                                             float e1, float valid, int g, Scales sc,
                                             float kappa, float us, int t0, int t1) {
  const float d0 = (th10 - th00) * e0;   // fwd0 at (r, c)
  const float d0p = (th11 - th01) * e0;  // fwd0 at (r, c+1)
  DualPt q;
  q.dt[0] = sc.mix * ((d0p - d0) * e1);
  q.dt[1] = sc.ax1 * ((th01 - th00) * e1) * valid;
  q.dt[2] = sc.ax0 * d0;
  float k[3] = {kappa, kappa, kappa};
  if (t0 >= 0) {
    const float rA = g < t0 - 1 ? 1.f : 0.f, rB = g < t0 ? 1.f : 0.f;
    const float cA = c < t1 - 1 ? 1.f : 0.f, cB = c < t1 ? 1.f : 0.f;
    k[0] = kappa * (rA * cA);
    k[1] = kappa * (rB * cA);
    k[2] = kappa * (rA * cB);
  }
  const float ue[3] = {us * u0 * valid, us * u1 * valid, us * u2 * valid};
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    q.a[b] = soft(q.dt[b] - ue[b], k[b]);
    q.r[b] = q.a[b] - q.dt[b];
    q.un[b] = ue[b] + q.r[b];
  }
  return q;
}

// The outputs and the five sums at the element with flat index oc (global
// row g, column j) from the stage there and at its three upstream
// neighbours.
template <bool kWantAlpha, bool kWantAdjoints>
__device__ __forceinline__ void dual_store(const DualPt& p00, const DualPt& pm0,
                                           const DualPt& p0m, const DualPt& pmm, size_t oc,
                                           int g, int j, int t0, int t1, Scales sc,
                                           float* __restrict__ a0, float* __restrict__ a1,
                                           float* __restrict__ a2, float* __restrict__ un0,
                                           float* __restrict__ un1, float* __restrict__ un2,
                                           float* __restrict__ dta, float* __restrict__ dtu,
                                           float st[5]) {
  if (kWantAlpha) {
    a0[oc] = p00.a[0];
    a1[oc] = p00.a[1];
    a2[oc] = p00.a[2];
  }
  un0[oc] = p00.un[0];
  un1[oc] = p00.un[1];
  un2[oc] = p00.un[2];
  float w[3] = {1.f, 1.f, 1.f};
  if (t0 >= 0) {
    const float rA = g < t0 - 1 ? 1.f : 0.f, rB = g < t0 ? 1.f : 0.f;
    const float cA = j < t1 - 1 ? 1.f : 0.f, cB = j < t1 ? 1.f : 0.f;
    w[0] = rA * cA;
    w[1] = rB * cA;
    w[2] = rA * cB;
  }
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    st[0] += p00.r[b] * p00.r[b];
    const float sd = t0 >= 0 ? p00.dt[b] * w[b] : p00.dt[b];
    const float sa = t0 >= 0 ? p00.a[b] * w[b] : p00.a[b];
    st[1] += sd * sd;
    st[2] += sa * sa;
  }
  // s_mix adj0(adj1(x0)) + s_ax1 adj1(x1) + s_ax0 adj0(x2) for x = r, u_new
  const float dtr = sc.mix * ((pmm.r[0] - pm0.r[0]) - (p0m.r[0] - p00.r[0])) +
                    sc.ax1 * (p0m.r[1] - p00.r[1]) + sc.ax0 * (pm0.r[2] - p00.r[2]);
  const float dtun = sc.mix * ((pmm.un[0] - pm0.un[0]) - (p0m.un[0] - p00.un[0])) +
                     sc.ax1 * (p0m.un[1] - p00.un[1]) + sc.ax0 * (pm0.un[2] - p00.un[2]);
  st[3] = dtr * dtr;
  st[4] = dtun * dtun;
  if (kWantAdjoints) {
    dta[oc] = sc.mix * ((pmm.a[0] - pm0.a[0]) - (p0m.a[0] - p00.a[0])) +
              sc.ax1 * (p0m.a[1] - p00.a[1]) + sc.ax0 * (pm0.a[2] - p00.a[2]);
    dtu[oc] = dtun;
  }
}

// dual_tile_kernel's tile: TX x TY knots; stage points (the tile and its
// upstream halo) kSH rows of kSW, point (a, c) at global (i0 - 1 + a,
// j0 - 1 + c); theta points one more row and column on the far side.
constexpr int kSW = TX + 1, kSH = TY + 1, kSPts = kSW * kSH;
constexpr int kTW = TX + 2, kTPts = kTW * (TY + 2);
constexpr int kWarps = kThreads / 32;

// The sums x[0..4] over the CTA's threads in block_sum's fixed order (warp
// shuffles, then the warps in order), valid in thread 0; ws is shared
// scratch that no thread still reads.
__device__ __forceinline__ void cta_sum5(float (&x)[5], float (*ws)[5], int tid) {
#pragma unroll
  for (int v = 0; v < 5; ++v)
    for (int off = 16; off > 0; off >>= 1) x[v] += __shfl_down_sync(0xffffffffu, x[v], off);
  if ((tid & 31) == 0)
#pragma unroll
    for (int v = 0; v < 5; ++v) ws[tid >> 5][v] = x[v];
  __syncthreads();
  if (tid == 0)
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      x[v] = 0.f;
      for (int w = 0; w < kWarps; ++w) x[v] += ws[w][v];
    }
}

template <bool kWantAlpha, bool kWantAdjoints, bool kSlab>
__global__ void __launch_bounds__(kThreads)
dual_tile_kernel(const float* __restrict__ theta, const float* __restrict__ u0,
                 const float* __restrict__ u1, const float* __restrict__ u2,
                 const float* kappa_p, const float* us_p, float* scal, Scales sc, int t0,
                 int t1, float* __restrict__ a0, float* __restrict__ a1, float* __restrict__ a2,
                 float* __restrict__ un0, float* __restrict__ un1, float* __restrict__ un2,
                 float* __restrict__ dta, float* __restrict__ dtu, float* partials,
                 unsigned* tickets, int steps, Lat L, Batch bt, DualHalo h, Slab sl) {
  constexpr int NV = kWantAdjoints ? 9 : 6;  // r, u_new (and alpha) of the 3 blocks
  __shared__ float th_s[2][kTPts];           // theta's tile and halo, a ring of two tiles
  __shared__ float u_s[2][3][kSPts];         // u at the stage points, likewise
  __shared__ float sv_s[NV][kSPts];
  __shared__ float ws[kWarps][5];
  __shared__ bool last;
  if (frozen(bt)) return;
  const size_t off = lat_offset(L);
  const float* const uk[3] = {u0 + off, u1 + off, u2 + off};
  theta += off;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int j0 = blockIdx.x * TX;
  const int r_first = blockIdx.y * steps, r_end = min(r_first + steps, (L.m0 + TY - 1) / TY);
  const float kappa = kappa_p[scal_offset(bt)], us = us_p[scal_offset(bt)];
  // Tile row r (knot rows r TY ..) into ring slot r % 2: theta's points
  // and u at the stage points; points past the lattice's end are never
  // read and not copied.  row_of(x, top, bot, row) is the source of local
  // row `row` (-1 .. m0) of x.
  auto copy = [&](int i0, int slot, auto row_of) {
    for (int idx = tid; idx < kTPts; idx += kThreads) {
      const int a = idx / kTW, c = idx % kTW;
      if (a <= L.m0 - i0 + 1 && c <= L.m1 - j0 + 1)
        cp_async4(&th_s[slot][idx],
                  row_of(theta, h.th_top, h.th_bot, i0 - 1 + a) + wrap1(j0 - 1 + c, L.m1));
    }
    for (int idx = tid; idx < kSPts; idx += kThreads) {
      const int a = idx / kSW, c = idx % kSW;
      if (a <= L.m0 - i0 && c <= L.m1 - j0) {
        const int row = i0 - 1 + a, col = wrap1(j0 - 1 + c, L.m1);
        cp_async4(&u_s[slot][0][idx], row_of(uk[0], h.u0_top, nullptr, row) + col);
        cp_async4(&u_s[slot][1][idx], row_of(uk[1], h.u1_top, nullptr, row) + col);
        cp_async4(&u_s[slot][2][idx], row_of(uk[2], h.u2_top, nullptr, row) + col);
      }
    }
  };
  // The rows wrapped as jnp.roll wraps (a whole lattice); in slab mode a
  // slab's own rows, and at -1 and m0 its halo rows, which only the slab's
  // first and last tiles reach: the others copy without choosing.  (Whole
  // lattices keep the one wrapped copy: a third copy path there took B8 to
  // 78 registers and 3 CTAs per SM, 3 % slower on an H100.)
  auto wrapped = [&](const float* x, const float*, const float*, int row) {
    return x + size_t(wrap1(row, L.m0)) * L.m1;
  };
  auto with_halo = [&](const float* x, const float* top, const float* bot, int row) {
    return slab_row(x, top, bot, row, L);
  };
  auto own = [&](const float* x, const float*, const float*, int row) {
    return x + size_t(row) * L.m1;
  };
  auto load = [&](int r) {
    const int i0 = r * TY, slot = r & 1;
    if (!kSlab)
      copy(i0, slot, wrapped);
    else if (i0 == 0 || i0 + TY >= L.m0)
      copy(i0, slot, with_halo);
    else
      copy(i0, slot, own);
  };
  // This thread's knot (a, c) = (ty + 1, tx + 1) of a tile, and its halo
  // point: the first kSW threads take row i0 - 1, the next TY column j0 - 1.
  const int ha = tid < kSW ? 0 : tid - kSW + 1, hc = tid < kSW ? tid : 0;
  const int j = j0 + threadIdx.x, hcol = wrap1(j0 - 1 + hc, L.m1);
  float st[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  load(r_first);
  cp_async4_commit();
  for (int r = r_first; r < r_end; ++r) {
    // The next tile's reads, in flight during this tile's work.
    if (r + 1 < r_end) load(r + 1);
    cp_async4_commit();
    cp_async4_wait<1>();
    __syncthreads();
    const int i0 = r * TY, slot = r & 1, i = i0 + threadIdx.y;
    const bool own = i < L.m0 && j < L.m1;
    const bool halo = tid < kSW + TY && i0 - 1 + ha < L.m0 && j0 - 1 + hc < L.m1;
    // The stage at point (a, c), global row g, column col; its r, u_new
    // (and alpha) go to shared memory.  g is row_off + the local row in
    // slab mode, where the rows above the lattice have `valid` = 0, and
    // the wrapped row otherwise.
    auto stage = [&](int a, int c, int g, int col) {
      const float e0 = kSlab ? edge_global(g, sl.m0g) : edge(g, L.m0);
      const float* tq = &th_s[slot][a * kTW + c];
      const int pt = a * kSW + c;
      const DualPt q = dual_point(tq[0], tq[1], tq[kTW], tq[kTW + 1], u_s[slot][0][pt],
                                  u_s[slot][1][pt], u_s[slot][2][pt], col, e0, edge(col, L.m1),
                                  kSlab ? valid_global(g) : 1.f, g, sc, kappa, us, t0, t1);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        sv_s[b][pt] = q.r[b];
        sv_s[3 + b][pt] = q.un[b];
        if (kWantAdjoints) sv_s[NV - 3 + b][pt] = q.a[b];
      }
      return q;
    };
    DualPt p00;
    if (own) p00 = stage(threadIdx.y + 1, threadIdx.x + 1, kSlab ? sl.row_off + i : i, j);
    if (halo)
      stage(ha, hc, kSlab ? sl.row_off + i0 - 1 + ha : wrap1(i0 - 1 + ha, L.m0), hcol);
    __syncthreads();
    if (own) {
      const int pt = (threadIdx.y + 1) * kSW + threadIdx.x + 1;
      auto at = [&](int q) {
        DualPt p;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          p.r[b] = sv_s[b][q];
          p.un[b] = sv_s[3 + b][q];
          p.a[b] = kWantAdjoints ? sv_s[NV - 3 + b][q] : 0.f;
        }
        return p;
      };
      float sk[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
      dual_store<kWantAlpha, kWantAdjoints>(p00, at(pt - kSW), at(pt - 1), at(pt - kSW - 1),
                                            off + size_t(i) * L.m1 + j,
                                            kSlab ? sl.row_off + i : i, j, t0, t1, sc, a0, a1,
                                            a2, un0, un1, un2, dta, dtu, sk);
#pragma unroll
      for (int v = 0; v < 5; ++v) st[v] += sk[v];
    }
  }
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

// Tiles per CTA: about 256 CTAs per problem (two per SM), at most
// kDualSteps tiles each; fewer, longer marches measured faster than one
// tile per CTA at 512^2 to 2048^2 (fewer partials, each tile's copies
// hidden behind the previous tile's work).  It depends on the lattice
// alone, never on the batch, so a problem's sums run in the same order in
// a batch of any size.
constexpr int kDualSteps = 8;
inline int dual_steps(Lat L) {
  const int tiles = stencil_blocks(L);
  return tiles < 256 ? 1 : (tiles / 256 < kDualSteps ? tiles / 256 : kDualSteps);
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
