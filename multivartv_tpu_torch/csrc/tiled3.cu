// The p = 3 stencil kernels of the tiled3 route (from 2^22 knots): B12,
// B13, B14; and B12s, B13s, the plane-slab modes of B12 and B13 on the
// sharded route.
//
// Replace multivartv_tpu/ops/pallas_kernels.py:
//   * dual_update_tiled_3d (B12, _tiled3_dual_kernel): the 7 forward
//     difference blocks of fd_binaries(3), the soft-threshold of
//     D theta - u_scale u at kappa (kappa * w on the true rows of a padded
//     solve, _wmasks3), u_new = u_scale u + r, the five Boyd sums, and with
//     want_adjoints the carries dta = D'alpha and dtu = D'u_new; the alpha
//     stores are skipped (want_alpha=False) on the ADMM route;
//   * gram_residual_tiled_3d (B13, _tiled3_gram_res_kernel): the spectral
//     CG's r0 = b - (counts + rho D'D) v, with b given or formed in
//     registers as oty + rho (dta + u_scale dtu) and never stored;
//   * rhs_tiled_3d (B14, _tiled3_rhs_kernel): b = oty + rho D'(alpha +
//     u_scale u), on no ADMM route (the loop reads the carries).
//
// The TPU kernels view the lattice as (m0 m1, m2) rows and stream row
// panels with an (m1 + 8)-row halo through VMEM, because 256^3 does not fit
// it.  None of that carries over.  B12 and B13 march planes: a CTA owns an
// 8 x 64 tile of the (x1, x2) plane and 32 planes of axis 0, and computes
// each block's stage once per point of the tile and its one-knot low halo,
// plane after plane (B12: D_b theta, the prox, the dual ascent; B13: D_b v).
// The adjoint of block b at knot x needs the block's values at the lower
// neighbours x - e, e <= b: the stage thread takes its axis-0 step from its
// own values one plane below (registers) and the knots read the rest from
// one plane of stage values in shared memory (B12: r, u_new (and alpha),
// ~90 KB with the adjoint carries, ~73 KB without; B13: one value per
// block, 16 KB, beside rings of 4 v planes and 3 planes of the knots'
// inputs, 51 KB in all fused, so two CTAs share an SM).
// The lattice read by the stencil (theta, u; v) streams in with cp.async
// ahead of the march (B12 one plane, B13 two), so each value is read
// once, plus the halo: 66 x 10
// theta (v) and 65 x 9 u points per 64 x 8 knots and one plane in 32 below
// the chunk, about 16 % more reads than B12's unique bytes, 6 % more than
// B13's (whose counts, b or oty, dta, dtu and r0 have no halo).  Neighbour
// indices wrap as jnp.roll does, along every axis and at the plane below a
// chunk that starts at 0: every halo row is a loaded row of the lattice,
// and the blocks' trailing edges are zero, so a wrapped neighbour only ever
// lands where an edge mask zeroes it.  Remainder tiles (m1 % 8, m2 % 64, m0
// % 32) skip the points past the lattice's end, which no knot reads.  B14
// runs one thread per knot in C order (m2 fastest, so neighbouring threads
// read neighbouring addresses), each thread reading the alpha and u blocks
// at its lower neighbours from L1/L2.
//
// Operation order is the TPU kernels': the forward chain differences axis
// 0, then 1, then 2, with one combined edge mask (_fchain3); the adjoint
// chain shifts up along the same axes in the same order (_achain3); the
// block sums add the blocks in fd_binaries(3) order.  Each knot's outputs
// are the plain version's per-knot arithmetic; only the Boyd sums' order
// of summation is the kernel's own (per thread, then per CTA, then the
// fixed-order finish pass).
//
// Bound on the H100: device-memory bandwidth, one pass each.  B12 with
// alpha skipped reads theta and 7 u and writes 7 u_new, dta and dtu: 68
// bytes per knot (plus the five per-CTA partial sums and their finish
// pass); 1.14 GB, 0.34 ms at 256^3 at the published 3.35 TB/s.  B13 in
// fused mode reads v, counts, oty, dta and dtu and writes r0: 24 bytes per
// knot, 0.12 ms at 256^3.  B14 reads 7 alpha, 7 u and oty and writes b: 64
// bytes per knot.  The scalars (kappa, rho, u_scale) stay on the device.
// B14 (on no ADMM path) has no shared-memory tiling of the neighbourhood
// yet.
//
// Slab modes (kSlab: B12s, B13s; the JAX package runs these stages under
// its SPMD partitioner, with no Pallas kernel): the lattice is one rank's
// plane slab, planes 0 .. m0 - 1 of a lattice of m0g planes whose plane 0
// is global plane `off` (parallel/sharding.py).  The march is B12's or
// B13's; only where a plane comes from changes: the plane below the slab
// (local -1) and, for theta and v, the plane above it (local m0) come from
// the halo planes the neighbouring ranks sent (Slab3; zeros at the global
// edges), in place of the wrapped planes of the whole lattice, and every
// mask reads the global plane, wrapped as the whole lattice's, so that the
// lattice's edges stay where they are.  A wrapped plane only ever feeds
// values that an edge mask zeroes (theta, v) or that the blocks' trailing
// edges hold at zero (u), so on one slab with zero halos B12s and B13s
// compute B12's and B13's outputs bit for bit.
//
// B13s's matvec, A v = (counts + rho D'D) v on a plane slab (the sharded
// p = 3 PCG's matvec, called once a CG step), is a kernel of its own, not
// bit-equal to B13: it needs none of the per-block values that B13's march
// keeps for the TPU kernel's operation order.  Each block's operator
// factors by axis.  With M_j the trailing-edge mask along axis j (on the
// global plane for axis 0) and Delta_j the circular forward difference, a
// mask along axis k commutes with Delta_j for j != k, so D_b'D_b =
// prod_{j in b} L_j with L_j = Delta_j' M_j Delta_j, the 1-D Neumann
// Laplacian.  Sorting fd_binaries(3)'s blocks by their axis-0 part:
//   A v = counts v + rho (P v + L_0 (Q v)),
//   P = s2(0,1,0) L_1 + s2(0,0,1) L_2 + s2(0,1,1) L_1 L_2,
//   Q = s2(1,0,0) + s2(1,1,0) L_1 + s2(1,0,1) L_2 + s2(1,1,1) L_1 L_2,
// each s2 = s_b^2 rounded to float32.  P and Q are 9-point stencils within
// a plane, L_0 a 3-plane stencil along the march, and every L_j is formed
// from differences, (L_j w)(x) = M_j(x) (w(x) - w(x + e_j)) + M_j(x - e_j)
// (w(x) - w(x - e_j)) with M_j(-1) = 0, so that no coefficient sum
// cancels.  The Laplacian march (lap3_matvec_kernel) gives each CTA a
// 32 x 64 tile of the (x1, x2) plane and a chunk of planes (sized so that
// the grid fills the SMs two CTAs deep in one wave: 32 planes at 256^3,
// 8 at 256 x 256 x 64), each thread a column of 8 knots along x1; v's
// planes with a one-knot halo and counts' tiles stream through a ring of 3
// with cp.async (16 bytes a copy on 16-byte aligned rows), two planes
// ahead; each thread keeps Q v of the plane below and the rest of that
// plane's sum in registers, so the march takes one barrier a plane.  The
// halo planes below and above the slab (Slab3) give Q v there from their
// own plane; points past the lattice's edges are zeros that the masks
// multiply.  Its bound is the bytes of one pass: v and counts read, A v
// written, 12 bytes a knot, 0.0603 ms at 256^3 (utils/roofline.py); the
// halo points (9.6 % more v within a plane, 2 planes a chunk) come mostly
// from L2.  About 40 floating-point operations a knot leave it far from
// the CUDA cores' peak.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace mvtv {

struct Lat3 {
  int m0, m1, m2;
};
struct Scales7 {
  float s[7];
};
struct In7 {
  const float* p[7];
};
// A slab's halo planes (lo: the plane below, hi: the plane above; u_lo: the
// u blocks' plane below, B12s only) and its place in the lattice.
struct Slab3 {
  const float* lo;
  const float* hi;
  In7 u_lo;
  int off, m0g;
};

// fd_binaries(3, True) as bit masks, bit j = axis j: (1,1,1), (0,0,1),
// (0,1,0), (0,1,1), (1,0,0), (1,0,1), (1,1,0).
constexpr int kBin0 = 7, kBin1 = 4, kBin2 = 2, kBin3 = 6, kBin4 = 1, kBin5 = 5, kBin6 = 3;

// A knot and its wrapped neighbours: c[j][0..2] = the index below, at and
// above x_j along axis j.
struct Knot3 {
  int c[3][3];
  size_t idx;
};

__device__ __forceinline__ Knot3 knot3(size_t idx, Lat3 L) {
  Knot3 k;
  k.idx = idx;
  const int x2 = int(idx % size_t(L.m2));
  const size_t r = idx / size_t(L.m2);
  const int x1 = int(r % size_t(L.m1));
  const int x0 = int(r / size_t(L.m1));
  const int x[3] = {x0, x1, x2};
  const int m[3] = {L.m0, L.m1, L.m2};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    k.c[j][0] = dec(x[j], m[j]);
    k.c[j][1] = x[j];
    k.c[j][2] = inc(x[j], m[j]);
  }
  return k;
}

// Flat index of the neighbour at offsets o_j in {-1, 0, 1}.
__device__ __forceinline__ size_t at3(const Knot3& k, int o0, int o1, int o2, Lat3 L) {
  return (size_t(k.c[0][o0 + 1]) * L.m1 + k.c[1][o1 + 1]) * L.m2 + k.c[2][o2 + 1];
}

// _achain3 of block B at x from the block's values v[e] at x - e, e <= B:
// chained (shift up - id) along axes 0, 1, 2.
template <int B>
__device__ __forceinline__ float achain3(float (&v)[8]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if (!((B >> j) & 1)) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (!(e & ~B) && !((e >> j) & 1)) v[e] = v[e | (1 << j)] - v[e];
  }
  return v[0];
}

// Flat index of y = x - e.
__device__ __forceinline__ size_t lower3(const Knot3& k, int e, Lat3 L) {
  return at3(k, -(e & 1), -((e >> 1) & 1), -((e >> 2) & 1), L);
}

// ---- B12: the plane march ----
//
// A CTA owns a kT1 x kT2 tile of the (x1, x2) plane (x2 fastest) and a
// chunk of kChunk planes along axis 0.  It marches from the plane below
// its chunk to its last plane.  At each plane p one thread per point of
// the tile and its one-knot low halo in axes 1 and 2 computes the stage of
// every block (D_b theta, the prox, the dual ascent) once.  The adjoint of
// block b at knot x combines the block's r, u_new (and alpha for the
// adjoint carry) at x - e, e <= b, first along axis 0 (_achain3's order):
// the thread keeps its point's values of plane p - 1 in registers and
// writes the axis-0 difference (p - 1 minus p) for the blocks with an
// axis-0 part, the value itself for the others, to shared memory; the
// knots of plane p then finish their adjoints along axes 1 and 2 from
// there.  theta of plane p + 2 (with a one-knot halo on both sides) and
// the u blocks of plane p + 1 (with the low halo) are copied in with
// cp.async behind plane p's work.
constexpr int kT1 = 8, kT2 = 64, kChunk = 32;
constexpr int kH1 = kT1 + 1, kH2 = kT2 + 1;     // stage points: tile + low halo
constexpr int kPts = kH1 * kH2;
constexpr int kTh1 = kT1 + 2, kTh2 = kT2 + 2;   // theta: low and high halo
constexpr int kThPts = kTh1 * kTh2;
// One thread per stage point (19 warps; the first kT1 kT2 threads also
// form the adjoints of the tile's knots, one each).
constexpr int kMarchThreads = (kPts + 31) / 32 * 32;
// B13's CTAs per SM: its 51 KB of shared memory would let 4 share an SM,
// threads 3; 2 leave each thread 48 registers (3 would leave 32, which the
// stage's point3 butterfly and the rings' offsets do not fit without
// spills) and 38 of the SM's 64 warps in flight.
constexpr int kGramMarchCtas = 2;
constexpr int kThPerThread = (kThPts + kMarchThreads - 1) / kMarchThreads;

// Shared memory of one CTA, in floats: 3 theta planes, 2 planes of the 7 u
// blocks, and nv stage values (r, u_new[, alpha]) per block.
constexpr int march_smem_floats(int nv) { return 3 * kThPts + 2 * 7 * kPts + 7 * nv * kPts; }

inline dim3 march_grid(Lat3 L) {
  return dim3((L.m2 + kT2 - 1) / kT2, (L.m1 + kT1 - 1) / kT1, (L.m0 + kChunk - 1) / kChunk);
}

__device__ __forceinline__ int wrap(int i, int m) { return ((i % m) + m) % m; }


// The values a stage point shares across the blocks: dif[S] = theta's
// chained forward differences along the axes of S (bit j = axis j) at y,
// each formed with _fchain3's operations in its order (axis 0, then 1,
// then 2), from the 8 values theta(y + f) in one butterfly; the edge masks
// edge[j] = (y_j < m_j - 1); and the true-region row masks wa[j] = (y_j <
// t_j) and wb[j] = (y_j < t_j - 1) of _wmasks3.
struct Point3 {
  float dif[8], edge[3], wa[3], wb[3];
};

__device__ __forceinline__ Point3 point3(const float* th0, const float* th1, int q,
                                         const int (&y)[3], const int (&m)[3],
                                         const int (&tm)[3]) {
  Point3 P;
#pragma unroll
  for (int f = 0; f < 8; ++f)
    P.dif[f] = (f & 1 ? th1 : th0)[q + ((f >> 1) & 1) * kTh2 + ((f >> 2) & 1)];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int f = 0; f < 8; ++f)
      if (!((f >> j) & 1)) P.dif[f | (1 << j)] = P.dif[f | (1 << j)] - P.dif[f];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    P.edge[j] = edge(y[j], m[j]);
    P.wa[j] = y[j] < tm[j] ? 1.f : 0.f;
    P.wb[j] = y[j] < tm[j] - 1 ? 1.f : 0.f;
  }
  return P;
}

// The stage of block B at a point: D_b theta with its combined edge mask,
// the prox at kappa (kappa * _wmasks3 on the true rows of a padded solve,
// masked when tm[0] >= 0), u_new = u_scale u + r.  sv receives the
// block's (r, u_new[, alpha]) at this point (nv arrays of kPts, indexed by
// pt); where B has an axis-0 part, their axis-0 adjoint difference instead,
// the values pv of the point one plane below minus these, and pv takes
// these.  An owned point (a knot of the tile at an owned plane) writes its
// outputs and adds its sums.
template <int B, bool kWantAlpha, bool kWantAdjoints>
__device__ __forceinline__ void stage3(const Point3& P, float uv, int pt, bool masked, float s,
                                       float kappa, float us, float* sv, float (&pv)[3],
                                       bool owned, float* __restrict__ a_out,
                                       float* __restrict__ un_out, size_t gidx,
                                       float (&st)[5]) {
  float mask = 1.f, w = 1.f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    if ((B >> j) & 1) mask *= P.edge[j];
    w *= (B >> j) & 1 ? P.wb[j] : P.wa[j];
  }
  const float d = s * (P.dif[B] * mask);
  const float ue = us * uv;
  const float a = soft(d - ue, masked ? kappa * w : kappa);
  const float r = a - d;
  const float un = ue + r;
  constexpr int NV = kWantAdjoints ? 3 : 2;
  float v[3] = {r, un, a};
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (B & 1) {
      const float dv = pv[k] - v[k];
      pv[k] = v[k];
      v[k] = dv;
    }
    sv[k * kPts + pt] = v[k];
  }
  if (owned) {
    if (kWantAlpha) a_out[gidx] = a;
    un_out[gidx] = un;
    const float sd = masked ? d * w : d;
    const float sa = masked ? a * w : a;
    st[0] += r * r;
    st[1] += sd * sd;
    st[2] += sa * sa;
  }
}

// _achain3 of block B at the knot whose stage point is pt, along axes 1
// and 2, from value k of the stage's shared values sv (the axis-0
// difference where B has an axis-0 part) at the lower neighbours x - e
// of plane p: sv[k * kPts + pt - e1 kH2 - e2].
template <int B>
__device__ __forceinline__ float achain12(const float* sv, int k, int pt) {
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; e += 2)
    if (!(e & ~B)) v[e] = sv[k * kPts + pt - ((e >> 1) & 1) * kH2 - ((e >> 2) & 1)];
#pragma unroll
  for (int j = 1; j < 3; ++j) {
    if (!((B >> j) & 1)) continue;
#pragma unroll
    for (int e = 0; e < 8; e += 2)
      if (!(e & ~B) && !((e >> j) & 1)) v[e] = v[e | (1 << j)] - v[e];
  }
  return v[0];
}

// Local plane j (-1 .. m0) of a lattice x: the wrapped plane of the whole
// lattice, or in a slab the halo planes below and above it.
template <bool kSlab>
__device__ __forceinline__ const float* plane_at(const float* x, const float* lo,
                                                 const float* hi, int j, Lat3 L) {
  const size_t plane = size_t(L.m1) * L.m2;
  if (kSlab) return j < 0 ? lo : (j >= L.m0 ? hi : x + size_t(j) * plane);
  return x + size_t(wrap(j, L.m0)) * plane;
}
// The global plane of local plane j, wrapped as the whole lattice's, which
// every mask reads.
template <bool kSlab>
__device__ __forceinline__ int global_plane(int j, Lat3 L, const Slab3& sl) {
  return kSlab ? wrap(sl.off + j, sl.m0g) : wrap(j, L.m0);
}

template <bool kWantAlpha, bool kWantAdjoints, bool kSlab>
__global__ void __launch_bounds__(kMarchThreads, 1)
dual3_march_kernel(const float* __restrict__ theta, In7 u, const float* __restrict__ scal,
                   Scales7 sc, int t0, int t1, int t2, float* __restrict__ alpha,
                   float* __restrict__ u_new, float* __restrict__ dta, float* __restrict__ dtu,
                   float* __restrict__ partials, Lat3 L, Slab3 sl) {
  constexpr int NV = kWantAdjoints ? 3 : 2;
  extern __shared__ __align__(16) float smem[];
  float* th_s = smem;                // [3][kThPts]: theta planes, a ring
  float* u_s = th_s + 3 * kThPts;    // [2][7][kPts]: u planes, a ring
  float* sv_s = u_s + 2 * 7 * kPts;  // [7][NV][kPts]: stage values

  const int tid = threadIdx.x;
  const int o1 = blockIdx.y * kT1, o2 = blockIdx.x * kT2;  // the tile's first knot
  const int c0 = blockIdx.z * kChunk, c1 = min(c0 + kChunk, L.m0);
  const int nsteps = c1 - c0 + 1;  // stage planes c0 - 1 .. c1 - 1
  const size_t plane = size_t(L.m1) * L.m2, n = plane * L.m0;
  const int m[3] = {kSlab ? sl.m0g : L.m0, L.m1, L.m2};
  const int tm[3] = {t0, t1, t2};
  const float kappa = scal[S_KAPPA], us = scal[S_USCALE];

  // This thread's theta points (local (a1, a2) = (i / kTh2, i % kTh2) at
  // global (o1 - 1 + a1, o2 - 1 + a2), wrapped) and its stage point (local
  // (l1, l2) = (tid / kH2, tid % kH2) likewise): in-plane offsets, -1 where
  // the point lies past the lattice's end (a remainder tile), never read.
  int th_off[kThPerThread];
#pragma unroll
  for (int i = 0; i < kThPerThread; ++i) {
    const int idx = tid + i * kMarchThreads, a1 = idx / kTh2, a2 = idx % kTh2;
    th_off[i] = -1;
    if (idx < kThPts && a1 <= L.m1 - o1 + 1 && a2 <= L.m2 - o2 + 1)
      th_off[i] = wrap(o1 - 1 + a1, L.m1) * L.m2 + wrap(o2 - 1 + a2, L.m2);
  }
  const int l1 = tid / kH2, l2 = tid % kH2;
  const bool pt_in = tid < kPts && l1 <= L.m1 - o1 && l2 <= L.m2 - o2;
  const bool pt_own = pt_in && l1 >= 1 && l2 >= 1;
  const int y1 = pt_in ? wrap(o1 - 1 + l1, L.m1) : 0, y2 = pt_in ? wrap(o2 - 1 + l2, L.m2) : 0;
  const int pt_off = y1 * L.m2 + y2;
  const int q = l1 * kTh2 + l2;  // the stage point's theta
  // theta plane c0 - 1 + j into ring slot j % 3; u plane c0 - 1 + s into s % 2.
  auto load_theta = [&](int j) {
    const float* src = plane_at<kSlab>(theta, sl.lo, sl.hi, c0 - 1 + j, L);
    float* dst = th_s + (j % 3) * kThPts;
#pragma unroll
    for (int i = 0; i < kThPerThread; ++i)
      if (th_off[i] >= 0) cp_async4(dst + tid + i * kMarchThreads, src + th_off[i]);
  };
  auto load_u = [&](int s) {
    if (!pt_in) return;
    float* dst = u_s + (s & 1) * 7 * kPts + tid;
#pragma unroll
    for (int b = 0; b < 7; ++b)
      cp_async4(dst + b * kPts, plane_at<kSlab>(u.p[b], sl.u_lo.p[b], nullptr, c0 - 1 + s, L) +
                                    pt_off);
  };
  load_theta(0);
  load_theta(1);
  load_u(0);
  cp_async4_commit();
  cp_async4_wait<0>();
  __syncthreads();

  float st[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float pv[7][3] = {};  // this point's values one plane below (blocks with an axis-0 part)
  const int k1 = tid / kT2, k2 = tid % kT2;  // this thread's knot of the tile
  const bool knot_in = tid < kT1 * kT2 && o1 + k1 < L.m1 && o2 + k2 < L.m2;
  for (int s = 0; s < nsteps; ++s) {
    // The next plane's theta and u, in flight during this plane's work.
    if (s + 2 <= nsteps) load_theta(s + 2);
    if (s + 1 < nsteps) load_u(s + 1);
    cp_async4_commit();
    // p: this step's local plane (an owned one from s = 1 on), pg: its
    // global plane for the masks.
    const int p = c0 - 1 + s, pg = global_plane<kSlab>(p, L, sl);
    if (pt_in) {
      const float* uc = u_s + (s & 1) * 7 * kPts + tid;
      const int y[3] = {pg, y1, y2};
      const Point3 P = point3(th_s + (s % 3) * kThPts, th_s + ((s + 1) % 3) * kThPts, q, y, m,
                              tm);
      const bool owned = s >= 1 && pt_own, masked = tm[0] >= 0;
      const size_t g = size_t(owned ? p : 0) * plane + pt_off;
#define MVTV_STAGE3(K, BIN)                                                                   \
  stage3<BIN, kWantAlpha, kWantAdjoints>(P, uc[K * kPts], tid, masked, sc.s[K], kappa, us,    \
                                         sv_s + K * NV * kPts, pv[K], owned,                  \
                                         kWantAlpha ? alpha + K * n : nullptr, u_new + K * n, \
                                         g, st)
      MVTV_STAGE3(0, kBin0);
      MVTV_STAGE3(1, kBin1);
      MVTV_STAGE3(2, kBin2);
      MVTV_STAGE3(3, kBin3);
      MVTV_STAGE3(4, kBin4);
      MVTV_STAGE3(5, kBin5);
      MVTV_STAGE3(6, kBin6);
#undef MVTV_STAGE3
    }
    __syncthreads();
    // The adjoints of plane p's knots (_achain3 along axes 1 and 2, blocks
    // in fd_binaries(3) order) from the stage's shared values.
    if (s >= 1 && knot_in) {
      const int pt = (k1 + 1) * kH2 + k2 + 1;
      float ar = 0.f, au = 0.f, aa = 0.f;
#define MVTV_ADJ3(K, BIN)                                                      \
  do {                                                                         \
    const float* v = sv_s + K * NV * kPts;                                     \
    ar += sc.s[K] * achain12<BIN>(v, 0, pt);                                   \
    au += sc.s[K] * achain12<BIN>(v, 1, pt);                                   \
    if (kWantAdjoints) aa += sc.s[K] * achain12<BIN>(v, 2, pt);                \
  } while (0)
      MVTV_ADJ3(0, kBin0);
      MVTV_ADJ3(1, kBin1);
      MVTV_ADJ3(2, kBin2);
      MVTV_ADJ3(3, kBin3);
      MVTV_ADJ3(4, kBin4);
      MVTV_ADJ3(5, kBin5);
      MVTV_ADJ3(6, kBin6);
#undef MVTV_ADJ3
      st[3] += ar * ar;
      st[4] += au * au;
      if (kWantAdjoints) {
        const size_t g = size_t(p) * plane + size_t(o1 + k1) * L.m2 + (o2 + k2);
        dta[g] = aa;
        dtu[g] = au;
      }
    }
    cp_async4_wait<0>();
    __syncthreads();
  }
  const int nb = gridDim.x * gridDim.y * gridDim.z;
  const int bid = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
#pragma unroll
  for (int v = 0; v < 5; ++v) {
    const float tot = block_sum(st[v]);
    if (tid == 0) partials[v * nb + bid] = tot;
  }
}

// ---- B13: the Gram residual as a plane march ----
//
// The same march as B12's, on its tile, chunk and helpers: at each plane p
// one thread per stage point forms the 7 blocks' forward chains D_b v (one
// point3 butterfly, each block with its combined edge mask) and writes to
// shared memory the value itself or, for the blocks with an axis-0 part,
// its axis-0 adjoint difference (the value one plane below, kept in a
// register, minus this one); the knots of plane p then finish _achain3
// along axes 1 and 2 (achain12) and add the blocks in fd_binaries(3) order
// with rho s_b^2.  Every read streams in with cp.async two steps ahead:
// v into a ring of 4 planes, the knots' counts and b (or oty, dta and dtu)
// into a ring of 3, so each copy has a step and a half of work to land
// behind.

// Block K's (fd_binaries(3) index, bits BIN) stage value at a point:
// _fchain3's D_b v (point3's butterfly, then one combined edge mask), or
// where BIN has an axis-0 part its axis-0 adjoint difference, the value
// one plane below (pv[K]) minus this one, which pv[K] then takes.
template <int K, int BIN>
__device__ __forceinline__ void gram_stage3(const Point3& P, float (&pv)[7], float* d_s,
                                            int pt) {
  float mask = 1.f;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    if ((BIN >> j) & 1) mask *= P.edge[j];
  float dv = P.dif[BIN] * mask;
  if (BIN & 1) {
    const float cur = dv;
    dv = pv[K] - cur;
    pv[K] = cur;
  }
  d_s[K * kPts + pt] = dv;
}

// b given: r0 = b - A v; fused: b = oty + rho (dta + u_scale dtu) formed
// in registers.  (Mode 0, B13s's matvec A v, is lap3_matvec_kernel below.)
enum Gram3Mode : int { GRAM3_MATVEC = 0, GRAM3_B_GIVEN = 1, GRAM3_FUSED = 2 };

// The knots' inputs besides v (counts, b; or counts, oty, dta, dtu) and
// B13's shared memory, in floats: 4 planes of v, one stage value per block
// and point, 3 planes of the knots' inputs.
__host__ __device__ constexpr int gram3_inputs(int mode) {
  return mode == GRAM3_B_GIVEN ? 2 : 4;
}
constexpr int gram3_smem_floats(int mode) {
  return 4 * kThPts + 7 * kPts + 3 * gram3_inputs(mode) * kT1 * kT2;
}

template <int MODE, bool kSlab>
__global__ void __launch_bounds__(kMarchThreads, kGramMarchCtas)
gram3_march_kernel(const float* __restrict__ v, const float* __restrict__ counts,
                   const float* __restrict__ b, const float* __restrict__ oty,
                   const float* __restrict__ dta, const float* __restrict__ dtu,
                   const float* __restrict__ rho_p, const float* __restrict__ us_p, Scales7 sc,
                   float* __restrict__ out, Lat3 L, Slab3 sl) {
  constexpr int NIN = gram3_inputs(MODE);
  extern __shared__ __align__(16) float smem[];
  float* v_s = smem;                 // [4][kThPts]: v planes, a ring
  float* d_s = v_s + 4 * kThPts;     // [7][kPts]: per block, D_b v or its axis-0 step
  float* in_s = d_s + 7 * kPts;      // [3][NIN][kT1 kT2]: the knots' other inputs, a ring

  const int tid = threadIdx.x;
  const int o1 = blockIdx.y * kT1, o2 = blockIdx.x * kT2;  // the tile's first knot
  const int c0 = blockIdx.z * kChunk, c1 = min(c0 + kChunk, L.m0);
  const int nsteps = c1 - c0 + 1;  // stage planes c0 - 1 .. c1 - 1
  const size_t plane = size_t(L.m1) * L.m2;
  const int m[3] = {kSlab ? sl.m0g : L.m0, L.m1, L.m2};
  const int no_tm[3] = {-1, -1, -1};
  const float rho = *rho_p;
  const float us = MODE == GRAM3_FUSED ? *us_p : 0.f;

  // v's points and this thread's stage point, as in dual3_march_kernel.
  int v_off[kThPerThread];
#pragma unroll
  for (int i = 0; i < kThPerThread; ++i) {
    const int idx = tid + i * kMarchThreads, a1 = idx / kTh2, a2 = idx % kTh2;
    v_off[i] = -1;
    if (idx < kThPts && a1 <= L.m1 - o1 + 1 && a2 <= L.m2 - o2 + 1)
      v_off[i] = wrap(o1 - 1 + a1, L.m1) * L.m2 + wrap(o2 - 1 + a2, L.m2);
  }
  const int l1 = tid / kH2, l2 = tid % kH2;
  const bool pt_in = tid < kPts && l1 <= L.m1 - o1 && l2 <= L.m2 - o2;
  const int y1 = pt_in ? wrap(o1 - 1 + l1, L.m1) : 0, y2 = pt_in ? wrap(o2 - 1 + l2, L.m2) : 0;
  const int q = l1 * kTh2 + l2;  // the stage point's v
  // v plane c0 - 1 + j into ring slot j % 4, if the march reads it.
  auto load_v = [&](int j) {
    if (j > nsteps) return;
    const float* src = plane_at<kSlab>(v, sl.lo, sl.hi, c0 - 1 + j, L);
    float* dst = v_s + (j & 3) * kThPts;
#pragma unroll
    for (int i = 0; i < kThPerThread; ++i)
      if (v_off[i] >= 0) cp_async4(dst + tid + i * kMarchThreads, src + v_off[i]);
  };
  const int k1 = tid / kT2, k2 = tid % kT2;  // this thread's knot of the tile
  const bool knot_in = tid < kT1 * kT2 && o1 + k1 < L.m1 && o2 + k2 < L.m2;
  const size_t knot_off = size_t(o1 + k1) * L.m2 + (o2 + k2);
  const float* ins[4] = {counts, MODE == GRAM3_B_GIVEN ? b : oty, dta, dtu};
  // The knots' inputs at stage step t >= 1 (plane c0 - 1 + t) into slot t % 3.
  auto load_in = [&](int t) {
    if (!knot_in || t >= nsteps) return;
    const size_t g = size_t(c0 - 1 + t) * plane + knot_off;
    float* dst = in_s + (t % 3) * NIN * (kT1 * kT2) + tid;
#pragma unroll
    for (int k = 0; k < NIN; ++k) cp_async4(dst + k * (kT1 * kT2), ins[k] + g);
  };
  // Two steps ahead: the planes of steps 0 and 1 land first; then each
  // step's copies (v of step + 3, the inputs of step + 2) have this step
  // and the next to land.
  load_v(0);
  load_v(1);
  cp_async4_commit();
  load_v(2);
  load_in(1);
  cp_async4_commit();
  cp_async4_wait<1>();
  __syncthreads();

  float pv[7] = {};  // this point's D_b v one plane below (blocks with an axis-0 part)
  for (int s = 0; s < nsteps; ++s) {
    load_v(s + 3);
    load_in(s + 2);
    cp_async4_commit();
    const int p = c0 - 1 + s;  // local; its global plane for the masks below
    if (pt_in) {
      const int y[3] = {global_plane<kSlab>(p, L, sl), y1, y2};
      const Point3 P = point3(v_s + (s & 3) * kThPts, v_s + ((s + 1) & 3) * kThPts, q, y, m,
                              no_tm);
      gram_stage3<0, kBin0>(P, pv, d_s, tid);
      gram_stage3<1, kBin1>(P, pv, d_s, tid);
      gram_stage3<2, kBin2>(P, pv, d_s, tid);
      gram_stage3<3, kBin3>(P, pv, d_s, tid);
      gram_stage3<4, kBin4>(P, pv, d_s, tid);
      gram_stage3<5, kBin5>(P, pv, d_s, tid);
      gram_stage3<6, kBin6>(P, pv, d_s, tid);
    }
    __syncthreads();
    // r0 at plane p's knots: the blocks' adjoint chains from the shared
    // values, added in fd_binaries(3) order with rho s_b^2 (s_b^2 rounded
    // first, pallas_kernels.py:2285).
    if (s >= 1 && knot_in) {
      const float* in = in_s + (s % 3) * NIN * (kT1 * kT2) + tid;
      const float cv = in[0];
      float bv = 0.f;
      if (MODE == GRAM3_B_GIVEN) bv = in[kT1 * kT2];
      if (MODE == GRAM3_FUSED)
        bv = in[kT1 * kT2] + rho * (in[2 * kT1 * kT2] + us * in[3 * kT1 * kT2]);
      const int pt = (k1 + 1) * kH2 + k2 + 1;
      float acc = 0.f;
      acc += rho * (sc.s[0] * sc.s[0]) * achain12<kBin0>(d_s + 0 * kPts, 0, pt);
      acc += rho * (sc.s[1] * sc.s[1]) * achain12<kBin1>(d_s + 1 * kPts, 0, pt);
      acc += rho * (sc.s[2] * sc.s[2]) * achain12<kBin2>(d_s + 2 * kPts, 0, pt);
      acc += rho * (sc.s[3] * sc.s[3]) * achain12<kBin3>(d_s + 3 * kPts, 0, pt);
      acc += rho * (sc.s[4] * sc.s[4]) * achain12<kBin4>(d_s + 4 * kPts, 0, pt);
      acc += rho * (sc.s[5] * sc.s[5]) * achain12<kBin5>(d_s + 5 * kPts, 0, pt);
      acc += rho * (sc.s[6] * sc.s[6]) * achain12<kBin6>(d_s + 6 * kPts, 0, pt);
      const float vc = v_s[(s & 3) * kThPts + (k1 + 1) * kTh2 + (k2 + 1)];
      out[size_t(p) * plane + knot_off] = bv - (cv * vc + acc);
    }
    cp_async4_wait<1>();
    __syncthreads();
  }
}

// ---- B13s's matvec: a march of per-axis Laplacians ----
//
// A v = counts v + rho (P v + L_0 (Q v)) on a plane slab (see the source
// note): P and Q are 9-point stencils within a plane, L_0 a 3-plane
// stencil along the march.  A CTA owns a kLapT1 x kLapT2 tile of the (x1,
// x2) plane and a chunk of planes along axis 0; each thread owns a column
// of kLapRows knots along x1 at one x2, so its x1 neighbours are its own
// registers and its x2 neighbours the next threads' values in shared
// memory.  v's planes (the tile and a one-knot halo) and counts' (the
// tile) stream through a ring of kLapRing slots with cp.async, two planes
// ahead; the points past the lattice's edges (and past a remainder
// tile's) are zeros, written once, which the masks multiply or no store
// reads.  At plane j each thread forms Q v and P v of its knots, finishes
// plane j - 1 with the forward term of L_0 and stores it, and keeps plane
// j's Q v and the rest of its sum in registers: one barrier a plane.
constexpr int kLapT1 = 32, kLapT2 = 64, kLapRows = 8;
constexpr int kLapThreads = kLapT2 * (kLapT1 / kLapRows);
// CTAs per SM the launch bounds ask for and the grid is sized to fill in
// one wave: two leave a thread 128 registers, which the columns use
// without spilling (127; four CTAs at 64 registers spilled and ran 21 %
// slower at 256^3, three at 80 registers 7 %); a chunk is at least
// kLapMinChunk planes (each chunk reads two halo planes).
constexpr int kLapCtas = 2, kLapMinChunk = 4;
// A slot: v's plane, kLapT1 + 2 rows of kLapStride floats with the tile's
// x2 = 0 at column kLapPad (16-byte aligned) and x2 = -1 before it, then
// counts' tile, kLapT1 rows of kLapT2.
constexpr int kLapPad = 4, kLapStride = kLapPad + kLapT2 + 4;
constexpr int kLapV = (kLapT1 + 2) * kLapStride, kLapSlot = kLapV + kLapT1 * kLapT2;
constexpr int kLapRing = 3;
constexpr int kLapSmemBytes = int(sizeof(float)) * kLapRing * kLapSlot;

__global__ void __launch_bounds__(kLapThreads, kLapCtas)
lap3_matvec_kernel(const float* __restrict__ v, const float* __restrict__ counts,
                   const float* __restrict__ rho_p, Scales7 sc, int chunk, int vec,
                   float* __restrict__ out, Lat3 L, Slab3 sl) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tx = tid % kLapT2, ty = tid / kLapT2;
  const int o1 = blockIdx.y * kLapT1, o2 = blockIdx.x * kLapT2;  // the tile's first knot
  const int c0 = blockIdx.z * chunk, c1 = min(c0 + chunk, L.m0);
  const int nsteps = c1 - c0 + 2;  // planes c0 - 1 .. c1
  const int plane = L.m1 * L.m2;   // in-plane offsets fit an int (checked at launch)

  for (int i = tid; i < kLapRing * kLapSlot; i += kLapThreads) smem[i] = 0.f;
  __syncthreads();

  // Rows x1 = r0 + r (r < rows) of a plane src, columns x2 = o2 + c for c
  // in [-halo, kLapT2 + halo), into dst + r stride + c: the points inside
  // the lattice only, 16 bytes a copy where vec allows.
  auto copy_tile = [&](float* dst, const float* src, int r0, int rows, int stride, int halo) {
    if (vec) {  // 16-byte copies of the tile's columns, 4-byte ones of the halo columns
      const int n16 = rows * (kLapT2 / 4);
      for (int i = tid; i < n16 + 2 * halo * rows; i += kLapThreads) {
        const bool wide = i < n16;
        const int r = wide ? i / (kLapT2 / 4) : (i - n16) >> 1;
        const int c = wide ? 4 * (i % (kLapT2 / 4)) : ((i - n16) & 1 ? kLapT2 : -1);
        const int x1 = r0 + r, x2 = o2 + c;
        if (x1 < 0 || x1 >= L.m1 || x2 < 0 || x2 >= L.m2) continue;
        if (wide)
          cp_async16f(dst + r * stride + c, src + x1 * L.m2 + x2);
        else
          cp_async4(dst + r * stride + c, src + x1 * L.m2 + x2);
      }
    } else {
      const int width = kLapT2 + 2 * halo;
      for (int i = tid; i < rows * width; i += kLapThreads) {
        const int r = i / width, c = i % width - halo;
        const int x1 = r0 + r, x2 = o2 + c;
        if (x1 >= 0 && x1 < L.m1 && x2 >= 0 && x2 < L.m2)
          cp_async4(dst + r * stride + c, src + x1 * L.m2 + x2);
      }
    }
  };
  // Step s's slot: local plane j = c0 - 1 + s of v (the halo planes past
  // the slab) and, on the chunk's planes, of counts.
  auto load = [&](int s) {
    if (s >= nsteps) return;
    const int j = c0 - 1 + s;
    float* slot = smem + (s % kLapRing) * kLapSlot;
    const float* src = j < 0 ? sl.lo : (j >= L.m0 ? sl.hi : v + size_t(j) * plane);
    copy_tile(slot + kLapPad, src, o1 - 1, kLapT1 + 2, kLapStride, 1);
    if (j >= c0 && j < c1)
      copy_tile(slot + kLapV, counts + size_t(j) * plane, o1, kLapT1, kLapT2, 0);
  };

  // This thread's knots: x1 = k1 + k (k < kLapRows) at x2; the masks of
  // L_2 at them, M_2(x) and M_2(x - e_2), with M_2(-1) = 0 (L_1's below).
  const int k1 = o1 + ty * kLapRows, x2 = o2 + tx;
  const bool col_in = x2 < L.m2;
  const float m2f = x2 < L.m2 - 1 ? 1.f : 0.f, m2b = x2 >= 1 ? 1.f : 0.f;
  const float rho = *rho_p;

  load(0);
  cp_async4_commit();
  load(1);
  cp_async4_commit();
  float qp[kLapRows] = {}, acc[kLapRows] = {};
  for (int s = 0; s < nsteps; ++s) {
    const int j = c0 - 1 + s, g = sl.off + j;  // local and global plane
    cp_async4_wait<1>();
    __syncthreads();  // plane j has landed; slot (s + 2) mod kLapRing is free
    load(s + 2);
    cp_async4_commit();

    // v and L_2 v on rows k1 - 1 .. k1 + kLapRows of this column.
    const float* slot = smem + (s % kLapRing) * kLapSlot;
    const float* col = slot + kLapPad + tx + ty * kLapRows * kLapStride;
    const float* cnt = slot + kLapV + tx + ty * kLapRows * kLapT2;
    float w[kLapRows + 2], t[kLapRows + 2];
#pragma unroll
    for (int i = 0; i < kLapRows + 2; ++i) {
      const float* q = col + i * kLapStride;
      w[i] = q[0];
      t[i] = m2f * (q[0] - q[1]) + m2b * (q[0] - q[-1]);
    }
    // Q v of plane j; P v too where j is a plane of this chunk.
    // e0 = M_0(g - 1), the mask of the axis-0 difference between planes
    // j - 1 and j: L_0's forward term at plane j - 1, its backward one at j.
    const bool mine = s >= 1 && s <= nsteps - 2;
    const float e0 = edge_global(g - 1, sl.m0g);
#pragma unroll
    for (int k = 0; k < kLapRows; ++k) {
      const float m1f = k1 + k < L.m1 - 1 ? 1.f : 0.f, m1b = k1 + k >= 1 ? 1.f : 0.f;
      const float l1 = m1f * (w[k + 1] - w[k + 2]) + m1b * (w[k + 1] - w[k]);
      const float l12 = m1f * (t[k + 1] - t[k + 2]) + m1b * (t[k + 1] - t[k]);
      // fd_binaries(3) order: s0 (1,1,1), s1 (0,0,1), s2 (0,1,0), s3 (0,1,1),
      // s4 (1,0,0), s5 (1,0,1), s6 (1,1,0); each s^2 rounded first.
      const float q = (sc.s[4] * sc.s[4]) * w[k + 1] + (sc.s[6] * sc.s[6]) * l1 +
                      (sc.s[5] * sc.s[5]) * t[k + 1] + (sc.s[0] * sc.s[0]) * l12;
      if (s >= 2 && col_in && k1 + k < L.m1)  // plane j - 1 is done: its forward L_0 term
        out[size_t(j - 1) * plane + (k1 + k) * L.m2 + x2] = acc[k] + rho * (e0 * (qp[k] - q));
      if (mine) {
        const float p = (sc.s[2] * sc.s[2]) * l1 + (sc.s[1] * sc.s[1]) * t[k + 1] +
                        (sc.s[3] * sc.s[3]) * l12;
        acc[k] = cnt[k * kLapT2] * w[k + 1] + rho * (p + e0 * (q - qp[k]));
      }
      qp[k] = q;
    }
  }
}

// Block B's term of the rhs adjoint at x: achain(alpha + u_scale u).
template <int B>
__device__ __forceinline__ float rhs_term3(const float* __restrict__ a,
                                           const float* __restrict__ u, float us,
                                           const Knot3& k, Lat3 L) {
  float w[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (e & ~B) continue;
    const size_t y = lower3(k, e, L);
    w[e] = a[y] + us * u[y];
  }
  return achain3<B>(w);
}

__global__ void __launch_bounds__(kThreads)
rhs3_kernel(In7 a, In7 u, const float* __restrict__ oty, const float* __restrict__ rho_p,
            const float* __restrict__ us_p, Scales7 sc, float* __restrict__ out, Lat3 L) {
  const size_t n = size_t(L.m0) * L.m1 * L.m2;
  const size_t idx = size_t(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= n) return;
  const Knot3 k = knot3(idx, L);
  const float us = *us_p;
  float acc = 0.f;
  acc += sc.s[0] * rhs_term3<kBin0>(a.p[0], u.p[0], us, k, L);
  acc += sc.s[1] * rhs_term3<kBin1>(a.p[1], u.p[1], us, k, L);
  acc += sc.s[2] * rhs_term3<kBin2>(a.p[2], u.p[2], us, k, L);
  acc += sc.s[3] * rhs_term3<kBin3>(a.p[3], u.p[3], us, k, L);
  acc += sc.s[4] * rhs_term3<kBin4>(a.p[4], u.p[4], us, k, L);
  acc += sc.s[5] * rhs_term3<kBin5>(a.p[5], u.p[5], us, k, L);
  acc += sc.s[6] * rhs_term3<kBin6>(a.p[6], u.p[6], us, k, L);
  out[idx] = oty[idx] + *rho_p * acc;
}

inline unsigned flat_blocks(Lat3 L) {
  const size_t n = size_t(L.m0) * L.m1 * L.m2;
  return unsigned((n + kThreads - 1) / kThreads);
}

}  // namespace mvtv

namespace mvtv {

// B12 and B12s: one launch of the plane march and the finish pass of its
// sums (exactly one of the two flags set).
template <bool kSlab>
int launch_dual3(const float* theta, In7 u, const float* kappa, const float* uscale, Scales7 sc,
                 int t0, int t1, int t2, int want_alpha, int want_adjoints, float* alpha_out,
                 float* u_out, float* dta, float* dtu, float* partials, long long partials_len,
                 float* scal, Lat3 L, const Slab3& sl, cudaStream_t s) {
  const dim3 grid = march_grid(L);
  const long long nb = (long long)grid.x * grid.y * grid.z;
  if ((want_alpha != 0) == (want_adjoints != 0) || partials_len < 5 * nb ||
      (long long)L.m1 * L.m2 > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  MVTV_CHECK(launch_init_scalars(scal, nullptr, nullptr, uscale, nullptr, kappa, kOne, s));
  const size_t bytes = sizeof(float) * march_smem_floats(want_adjoints ? 3 : 2);
  if (want_alpha) {
    MVTV_CHECK(int(cudaFuncSetAttribute(dual3_march_kernel<true, false, kSlab>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes))));
    dual3_march_kernel<true, false, kSlab><<<grid, kMarchThreads, bytes, s>>>(
        theta, u, scal, sc, t0, t1, t2, alpha_out, u_out, dta, dtu, partials, L, sl);
  } else {
    MVTV_CHECK(int(cudaFuncSetAttribute(dual3_march_kernel<false, true, kSlab>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes))));
    dual3_march_kernel<false, true, kSlab><<<grid, kMarchThreads, bytes, s>>>(
        theta, u, scal, sc, t0, t1, t2, alpha_out, u_out, dta, dtu, partials, L, sl);
  }
  MVTV_LAUNCHED();
  MVTV_CHECK(launch_finish(partials, int(nb), 5, scal + S_STATS, kOne, s));
  return int(cudaGetLastError());
}

// B13 and B13s: one launch of the gram march in a mode.
template <bool kSlab>
int launch_gram3(int mode, const float* v, const float* counts, const float* b, const float* oty,
                 const float* dta, const float* dtu, const float* rho, const float* uscale,
                 Scales7 sc, float* out, Lat3 L, const Slab3& sl, cudaStream_t s) {
  const dim3 grid = march_grid(L);
  if ((long long)L.m1 * L.m2 > 0x7fffffffLL) return int(cudaErrorInvalidValue);
#define MVTV_GRAM3(MODE)                                                                      \
  do {                                                                                        \
    const int bytes = int(sizeof(float)) * gram3_smem_floats(MODE);                           \
    MVTV_CHECK(int(cudaFuncSetAttribute(gram3_march_kernel<MODE, kSlab>,                      \
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes))); \
    gram3_march_kernel<MODE, kSlab><<<grid, kMarchThreads, bytes, s>>>(                       \
        v, counts, b, oty, dta, dtu, rho, uscale, sc, out, L, sl);                            \
  } while (0)
  if (mode == GRAM3_B_GIVEN)
    MVTV_GRAM3(GRAM3_B_GIVEN);
  else if (mode == GRAM3_FUSED)
    MVTV_GRAM3(GRAM3_FUSED);
  else
    return int(cudaErrorInvalidValue);
#undef MVTV_GRAM3
  return int(cudaGetLastError());
}

// B13s's matvec: one launch of the Laplacian march, its chunk of planes
// sized so that the grid fills the card's SMs kLapCtas deep in one wave.
int launch_lap3_matvec(const float* v, const float* counts, const float* rho, Scales7 sc,
                       float* out, Lat3 L, const Slab3& sl, cudaStream_t s) {
  if ((long long)L.m1 * L.m2 > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  static int sms[64] = {};
  int dev = 0;
  MVTV_CHECK(int(cudaGetDevice(&dev)));
  if (dev < 0 || dev >= 64) return int(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    int n = 0;
    MVTV_CHECK(int(cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)));
    MVTV_CHECK(int(cudaFuncSetAttribute(lap3_matvec_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        kLapSmemBytes)));
    sms[dev] = n;
  }
  const long long tiles =
      (long long)((L.m2 + kLapT2 - 1) / kLapT2) * ((L.m1 + kLapT1 - 1) / kLapT1);
  const long long chunks = std::max<long long>(1, (long long)sms[dev] * kLapCtas / tiles);
  const int chunk = int(std::max<long long>(kLapMinChunk, (L.m0 + chunks - 1) / chunks));
  auto aligned = [](const float* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = L.m2 % 4 == 0 && aligned(v) && aligned(sl.lo) && aligned(sl.hi) &&
                  aligned(counts);
  const dim3 grid((L.m2 + kLapT2 - 1) / kLapT2, (L.m1 + kLapT1 - 1) / kLapT1,
                  (L.m0 + chunk - 1) / chunk);
  lap3_matvec_kernel<<<grid, kLapThreads, kLapSmemBytes, s>>>(v, counts, rho, sc, chunk, vec,
                                                               out, L, sl);
  return int(cudaGetLastError());
}

}  // namespace mvtv

// B12 entry point.  u0..u6 are the 7 u blocks; alpha_out (7 lattices) is
// written only with want_alpha, u_out (7 lattices) always, dta/dtu only with
// want_adjoints.  t0 < 0: no true-region masks.  Exactly one of the two
// flags is set (the pairs that a route launches).  The 5 statistics land in
// scal[S_STATS .. S_STATS + 4]; partials (partials_len floats) holds 5 per
// CTA of the plane march (mvtv_dual_update_tiled_3d_blocks).
extern "C" int mvtv_dual_update_tiled_3d_blocks(int m0, int m1, int m2) {
  const dim3 g = mvtv::march_grid(mvtv::Lat3{m0, m1, m2});
  return int(g.x * g.y * g.z);
}

extern "C" int mvtv_dual_update_tiled_3d(
    const float* theta, const float* u0, const float* u1, const float* u2, const float* u3,
    const float* u4, const float* u5, const float* u6, const float* kappa, const float* uscale,
    float s0, float s1, float s2, float s3, float s4, float s5, float s6, int t0, int t1,
    int t2, int want_alpha, int want_adjoints, float* alpha_out, float* u_out, float* dta,
    float* dtu, float* partials, long long partials_len, float* scal, int m0, int m1, int m2,
    void* stream) {
  using namespace mvtv;
  return launch_dual3<false>(theta, In7{{u0, u1, u2, u3, u4, u5, u6}}, kappa, uscale,
                             Scales7{{s0, s1, s2, s3, s4, s5, s6}}, t0, t1, t2, want_alpha,
                             want_adjoints, alpha_out, u_out, dta, dtu, partials, partials_len,
                             scal, Lat3{m0, m1, m2}, Slab3{}, static_cast<cudaStream_t>(stream));
}

// B12s entry point: B12 on the (m0, m1, m2) plane slab whose plane 0 is
// global plane row_off of m0g, with the halo planes th_lo, th_hi (theta's
// planes below and above the slab) and ul0 .. ul6 (the u blocks' plane
// below); outputs, partials and scal as mvtv_dual_update_tiled_3d's, the 5
// statistics this slab's partial sums.
extern "C" int mvtv_dual_update_tiled_3d_shard(
    const float* theta, const float* u0, const float* u1, const float* u2, const float* u3,
    const float* u4, const float* u5, const float* u6, const float* th_lo, const float* th_hi,
    const float* ul0, const float* ul1, const float* ul2, const float* ul3, const float* ul4,
    const float* ul5, const float* ul6, const float* kappa, const float* uscale, float s0,
    float s1, float s2, float s3, float s4, float s5, float s6, int t0, int t1, int t2,
    int row_off, int m0g, int want_alpha, int want_adjoints, float* alpha_out, float* u_out,
    float* dta, float* dtu, float* partials, long long partials_len, float* scal, int m0, int m1,
    int m2, void* stream) {
  using namespace mvtv;
  if (row_off < 0 || m0 < 1 || row_off + m0 > m0g) return int(cudaErrorInvalidValue);
  const Slab3 sl{th_lo, th_hi, In7{{ul0, ul1, ul2, ul3, ul4, ul5, ul6}}, row_off, m0g};
  return launch_dual3<true>(theta, In7{{u0, u1, u2, u3, u4, u5, u6}}, kappa, uscale,
                            Scales7{{s0, s1, s2, s3, s4, s5, s6}}, t0, t1, t2, want_alpha,
                            want_adjoints, alpha_out, u_out, dta, dtu, partials, partials_len,
                            scal, Lat3{m0, m1, m2}, sl, static_cast<cudaStream_t>(stream));
}

// B13 entry point (mode 1: b given; mode 2: b = oty + rho (dta + u_scale
// dtu)).  Pointers a mode does not read may be null.
extern "C" int mvtv_gram_tiled_3d(int mode, const float* v, const float* counts, const float* b,
                                  const float* oty, const float* dta, const float* dtu,
                                  const float* rho, const float* uscale, float s0, float s1,
                                  float s2, float s3, float s4, float s5, float s6, float* out,
                                  int m0, int m1, int m2, void* stream) {
  using namespace mvtv;
  return launch_gram3<false>(mode, v, counts, b, oty, dta, dtu, rho, uscale,
                             Scales7{{s0, s1, s2, s3, s4, s5, s6}}, out, Lat3{m0, m1, m2},
                             Slab3{}, static_cast<cudaStream_t>(stream));
}

// B13s entry point: B13 on the (m0, m1, m2) plane slab whose plane 0 is
// global plane row_off of m0g, v_lo and v_hi v's planes below and above it;
// modes 1 and 2 as B13's (the plane march), mode 0 the matvec (counts +
// rho D'D) v (the Laplacian march; b, oty, dta, dtu and uscale unread).
extern "C" int mvtv_gram_tiled_3d_shard(int mode, const float* v, const float* v_lo,
                                        const float* v_hi, const float* counts, const float* b,
                                        const float* oty, const float* dta, const float* dtu,
                                        const float* rho, const float* uscale, float s0,
                                        float s1, float s2, float s3, float s4, float s5,
                                        float s6, int row_off, int m0g, float* out, int m0,
                                        int m1, int m2, void* stream) {
  using namespace mvtv;
  if (row_off < 0 || m0 < 1 || row_off + m0 > m0g) return int(cudaErrorInvalidValue);
  const Slab3 sl{v_lo, v_hi, In7{}, row_off, m0g};
  if (mode == GRAM3_MATVEC)
    return launch_lap3_matvec(v, counts, rho, Scales7{{s0, s1, s2, s3, s4, s5, s6}}, out,
                              Lat3{m0, m1, m2}, sl, static_cast<cudaStream_t>(stream));
  return launch_gram3<true>(mode, v, counts, b, oty, dta, dtu, rho, uscale,
                            Scales7{{s0, s1, s2, s3, s4, s5, s6}}, out, Lat3{m0, m1, m2}, sl,
                            static_cast<cudaStream_t>(stream));
}

// B14 entry point: a0..a6 and u0..u6 the alpha and u blocks.
extern "C" int mvtv_rhs_tiled_3d(const float* a0, const float* a1, const float* a2,
                                 const float* a3, const float* a4, const float* a5,
                                 const float* a6, const float* u0, const float* u1,
                                 const float* u2, const float* u3, const float* u4,
                                 const float* u5, const float* u6, const float* oty,
                                 const float* rho, const float* uscale, float s0, float s1,
                                 float s2, float s3, float s4, float s5, float s6, float* out,
                                 int m0, int m1, int m2, void* stream) {
  using namespace mvtv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Lat3 L{m0, m1, m2};
  const In7 a{{a0, a1, a2, a3, a4, a5, a6}};
  const In7 u{{u0, u1, u2, u3, u4, u5, u6}};
  const Scales7 sc{{s0, s1, s2, s3, s4, s5, s6}};
  rhs3_kernel<<<flat_blocks(L), kThreads, 0, s>>>(a, u, oty, rho, uscale, sc, out, L);
  return int(cudaGetLastError());
}
