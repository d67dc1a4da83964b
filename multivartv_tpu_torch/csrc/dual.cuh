// The z/dual stage's device code, shared by dual_tile_kernel (dual.cu:
// B1, B8, B8s) and the persistent ADMM kernel of chain.cu (B4, B5): the
// pointwise stage, the stores and sums at a knot, and the march of one
// column strip of 32 x 8 tiles (the design is in dual.cu's header).
#pragma once

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

// The march's shared memory: theta's tile and halo and u at the stage
// points, each a ring of kRing tiles, and the stage values r, u_new (and
// alpha with kWantAdjoints) at the stage points.
template <bool kWantAdjoints, int kRing = 2>
struct DualSmem {
  static constexpr int NV = kWantAdjoints ? 9 : 6;
  static constexpr int kFloats = kRing * kTPts + kRing * 3 * kSPts + NV * kSPts;
  float (*th)[kTPts];     // [kRing][kTPts]
  float (*u)[3][kSPts];   // [kRing][3][kSPts]
  float (*sv)[kSPts];     // [NV][kSPts]
  __device__ explicit DualSmem(float* base)
      : th(reinterpret_cast<float (*)[kTPts]>(base)),
        u(reinterpret_cast<float (*)[3][kSPts]>(base + kRing * kTPts)),
        sv(reinterpret_cast<float (*)[kSPts]>(base + kRing * kTPts + kRing * 3 * kSPts)) {}
};

// One problem's lattices as the march reads and writes them (problem
// offset applied), and its scalars.
struct DualLats {
  const float *theta, *u0, *u1, *u2;
  float *a0, *a1, *a2, *un0, *un1, *un2, *dta, *dtu;
  float kappa, us;
};

// The march of one CTA (TX x TY threads, thread (tx, ty)) down column
// strip bx, tile rows r_first .. r_end - 1: the stage at every knot of
// those tiles, its outputs stored and this thread's five sums added to
// st, the reads of kRing - 1 tiles in flight ahead of the one in use.
// Threads may still read the march's shared memory when it returns.
template <bool kWantAlpha, bool kWantAdjoints, bool kSlab, int kRing = 2>
__device__ __forceinline__ void dual_march(const DualLats& d, Scales sc, int t0, int t1,
                                           int bx, int r_first, int r_end, Lat L,
                                           const DualHalo& h, Slab sl, int tx, int ty,
                                           DualSmem<kWantAdjoints, kRing> sm, float (&st)[5]) {
  constexpr int NV = DualSmem<kWantAdjoints, kRing>::NV;
  auto th_s = sm.th;
  auto u_s = sm.u;
  auto sv_s = sm.sv;
  const float* const uk[3] = {d.u0, d.u1, d.u2};
  const float* theta = d.theta;
  const int tid = ty * TX + tx;
  const int j0 = bx * TX;
  const float kappa = d.kappa, us = d.us;
  // Tile row r (knot rows r TY ..) into ring slot r % kRing: theta's points
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
    const int i0 = r * TY, slot = r % kRing;
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
  const int j = j0 + tx, hcol = wrap1(j0 - 1 + hc, L.m1);
#pragma unroll
  for (int q = 0; q < kRing - 1; ++q) {
    if (r_first + q < r_end) load(r_first + q);
    cp_async4_commit();
  }
  for (int r = r_first; r < r_end; ++r) {
    // The next tiles' reads, in flight during this tile's work.
    if (r + kRing - 1 < r_end) load(r + kRing - 1);
    cp_async4_commit();
    cp_async4_wait<kRing - 1>();
    __syncthreads();
    const int i0 = r * TY, slot = r % kRing, i = i0 + ty;
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
    if (own) p00 = stage(ty + 1, tx + 1, kSlab ? sl.row_off + i : i, j);
    if (halo)
      stage(ha, hc, kSlab ? sl.row_off + i0 - 1 + ha : wrap1(i0 - 1 + ha, L.m0), hcol);
    __syncthreads();
    if (own) {
      const int pt = (ty + 1) * kSW + tx + 1;
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
                                            size_t(i) * L.m1 + j,
                                            kSlab ? sl.row_off + i : i, j, t0, t1, sc, d.a0,
                                            d.a1, d.a2, d.un0, d.un1, d.un2, d.dta, d.dtu, sk);
#pragma unroll
      for (int v = 0; v < 5; ++v) st[v] += sk[v];
    }
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

}  // namespace mvtv
