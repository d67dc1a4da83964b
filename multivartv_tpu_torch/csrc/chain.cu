// K full ADMM iterations for each of B problems in one persistent launch,
// with no host synchronisation.
//
// Replaces multivartv_tpu/ops/pallas_kernels.py:_admm_iters_batched_kernel
// (admm_iters_2d_batched, B5) and, as its B = 1 case, _admm_iters_kernel
// (admm_iters_2d, B4); both run _admm_chain.  The TPU runs the K iterations
// inside one kernel on VMEM-resident state, one grid step per problem.
// Hopper has no 100 MB scratchpad: the state stays in device memory (15
// lattices a problem, about 15 MB at 512^2, which the 50 MB L2 holds; 300
// MB at 1024^2 with B = 5, which it does not), and one cooperative launch
// of resident CTAs (256 threads, up to two an SM; ops/kernels.py::
// chain_plan sizes the grid) walks the iteration's stages, a grid barrier
// between dependent ones.  An iteration, n_steps = 3:
//   residual r0 = oty + rho D'(alpha + u_scale u) - A theta, and the
//     preconditioner's bf16 fold of r0 (a thread forms r at the four mirror
//     points of its knot of the top left quadrant)                       1
//   3 x preconditioner z = M^-1 r, p = z (+ beta p): the four folded DCT
//     products of fold.cuh (B3's tile function with 8 warps; the
//     eigenvalues and the old p staged in shared memory with the first
//     k-tile), the spectral scale and <r, z> in the second's epilogue  12
//   3 x [matvec Ap and <p, Ap>; x += alpha p, r -= alpha Ap, and r's fold
//     for the next preconditioner (|r|^2 after the last step)]            6
//   z/dual stage and Boyd's sums (dual.cuh, B1's march with two tiles in
//     flight); the CTA that takes a problem's last ticket adds its sums
//     and adapts rho                                                     1
// = 20 barriers an iteration where the CUDA graph it replaced ran ~33
// stage kernels.  Each stage is a grid-stride loop over work items of all
// B problems (a 32 x 8 quadrant tile, a 32 x 32 product tile, a column
// strip of 8 dual tiles), so B5's folds cost the barriers of one problem.
// The CG dots are summed where they are needed: every CTA adds a problem's
// partials itself, in one fixed order, before its first item of that
// problem in the stage after the barrier (no finish pass).
//
// Bound on the H100: the products' operations (0.0065 ms at 512^2, K = 4).
// The pace is set by the 80 barriers a call (about 1 us each) and by each
// stage's critical path: one product tile or a few quadrant items a CTA,
// 2-5 us (scripts/chain_trace.py measures both, stage by stage).
//
// Every per-problem sum runs over partial slots that depend on the lattice
// alone, in slot order, and no item's result depends on the CTA that
// computes it: a run repeats bit for bit, B5's row b equals B4 on problem
// b, and the grid's size changes no bit.  No float atomics: the dual
// stage's tickets and the barrier's counters are integers, left 0.
//
// Per-problem operands: lambda, rho, u_scale, cbar (arrays of B), the state
// lattices (B, m0, m1), counts and oty at batch stride cstride (m0 * m1 per
// fold, 0 when a lambda sweep shares one problem), one row of the scalar
// buffer and of the partials each.  The DCT halves and the eigenvalues are
// shared.  act (null: all active) freezes problems: no item of a frozen
// problem runs, so its state rows are never written, its rho and u_scale
// pass through (the set-up copies them in for every problem), and its
// statistics read 0.
//
// The state is updated in place, as the JAX kernel aliases it.  u
// ping-pongs between the caller's u and a scratch copy because the dual
// stage reads neighbours of the old u; with an odd K the set-up copies u
// to the scratch first, so that the last iteration writes the caller's u.
#include <cstring>

#include "dual.cuh"
#include "fold.cuh"
#include "stencil.cuh"

namespace mvtv {

namespace {

using fold::bf16;

// How the stages cut B problems into items, and where each problem's
// partial sums go, from ops/kernels.py::chain_plan (in this order).
struct Plan {
  int grid;                               // CTAs, all resident
  int quad_cols, quad_items;              // 32 x 8 tiles of the top left quadrant
  int dual_cols, dual_steps, dual_items;  // the dual stage's column strips of 32 x 8 tiles
  int fold_n, fold_mh, fold_m;            // product tiles: N-tiles; M-tiles of m0/2 and m0
  int pstride;                            // partial floats a problem
  int p_rz, p_pap, p_rr, p_dual;          // offsets: <r, z>, <p, Ap>, |r|^2, the dual's 5
};
constexpr int kPlanInts = 14;
static_assert(sizeof(Plan) == kPlanInts * sizeof(int), "Plan is kPlanInts ints");

struct ChainArgs {
  float* theta;
  float* u[2][3];  // [0] the caller's u, [1] the scratch copy
  float *a0, *a1, *a2;
  const float *counts, *oty;
  long long cstride;
  const bf16 *te0, *to0, *te1, *to1;  // the unpadded halves
  const float *eigs, *lam, *rho, *uscale, *cbar;
  const int* act;
  Scales sc;
  float tau, band, tau_shrink;
  int k_iters, n_steps, adapt, t0, t1;
  float *r, *p, *ap;
  Folded fd;
  float* partials;
  unsigned* tickets;
  float* scal;
  int sstride, B;
  Lat L;
  Plan pl;
};

constexpr int kChainRing = 3;  // the dual march's ring: two tiles in flight

// FwdCols with the tile's eigenvalues staged in shared memory before the
// products (fold_tile's kStage), and cbar and rho read once a tile: the
// same epilogue.
struct FwdColsStaged : fold::FwdCols {
  float cbar, rho;
  __device__ void stage(float* s, int, int, int row0, int col0) const {
    for (int x = threadIdx.x; x < fold::kStageFloats; x += kThreads) {
      const int i = row0 + ((x >> 5) & 31), n = col0 + (x & 31);
      if (i < m0 && n < h1) cp_async4(s + x, eigs + size_t(i) * m1 + (x >> 10) * h1 + n);
    }
  }
  __device__ float out(int b, int i, int n, float c1, float c2, float e1, float e2) const {
    const float z1 = c1 / (cbar + rho * e1);
    const float z2 = c2 / (cbar + rho * e2);
    fold::bf16* y = f.scratch + size_t(b) * f.stride + size_t(i) * f.ld1 + n;
    fold::put(y, z1);
    fold::put(y + size_t(m0) * f.ld1, z2);
    return c1 * z1 + c2 * z2;
  }
  __device__ float store(int b, int, int i, int n, float c1, float c2, const float* s) const {
    return out(b, i, n, c1, c2, s[0], s[fold::kStageFloats / 2]);
  }
};

// InvCols with beta given (the CTA's own sum of <r, z>) in place of beta
// read from scal, and the old p staged in shared memory before the
// products (fold_tile's kStage): the same epilogue.
struct InvColsBeta : fold::InvCols {
  float beta;
  __device__ void stage(float* s, int b, int, int row0, int col0) const {
    if (rz_new < 0) return;
    for (int x = threadIdx.x; x < fold::kStageFloats; x += kThreads) {
      const int i = row0 + ((x >> 5) & 31), n = col0 + (x & 31);
      const float* o = out + size_t(b) * m0 * m1 + size_t(i) * m1;
      if (i < m0 && n < h1) cp_async4(s + x, o + ((x >> 10) ? m1 - 1 - n : n));
    }
  }
  __device__ float put2(int b, int i, int n, float c1, float c2, float o1, float o2) const {
    float* o = out + size_t(b) * m0 * m1 + size_t(i) * m1;
    if (rz_new < 0) {
      o[n] = c1 + c2;
      o[m1 - 1 - n] = c1 - c2;
    } else {
      o[n] = (c1 + c2) + beta * o1;
      o[m1 - 1 - n] = (c1 - c2) + beta * o2;
    }
    return 0.f;
  }
  __device__ float store(int b, int, int i, int n, float c1, float c2, const float* s) const {
    return put2(b, i, n, c1, c2, s[0], s[fold::kStageFloats / 2]);
  }
};

// The shared memory of the stages: a product tile's k-tile ring (the
// largest) and its staged epilogue inputs, or the dual march's tiles.
constexpr int kRingBytes =
    fold::smem_bytes<fold::InvRows, kThreads>() > fold::smem_bytes<fold::FwdCols, kThreads>()
        ? fold::smem_bytes<fold::InvRows, kThreads>()
        : fold::smem_bytes<fold::FwdCols, kThreads>();
constexpr int kChainSmem = kRingBytes + int(sizeof(float)) * fold::kStageFloats;
static_assert(kRingBytes >= fold::smem_bytes<fold::FwdRows, kThreads>() &&
                  kRingBytes >= fold::smem_bytes<fold::InvCols, kThreads>() &&
                  kChainSmem >= int(sizeof(float)) * DualSmem<false, kChainRing>::kFloats,
              "kChainSmem holds every stage's shared memory");

__device__ __forceinline__ bool active(const ChainArgs& a, int b) {
  return a.act == nullptr || a.act[b] != 0;
}

// Sum of n partials in finish_kernel's order (reduce.cu: thread t adds
// t, t + 256, ..., then block_sum), in every thread.  The partials were
// written by other CTAs before the last grid barrier: read past L1.
__device__ __forceinline__ float cta_total(const float* p, int n, float* bcast) {
  float acc = 0.f;
  for (int k = threadIdx.x; k < n; k += kThreads) acc += __ldcg(p + k);
  const float tot = block_sum(acc);
  if (threadIdx.x == 0) *bcast = tot;
  __syncthreads();
  return *bcast;
}

// The grid barrier: bar[0] counts every CTA's arrivals in the launch,
// released (red.release) after the CTA's writes; a CTA leaves barrier
// number `k` once the count reaches (k + 1) CTAs x the grid (acquire).
// The last CTA to leave the kernel resets the count (bar[1] counts the
// exits), so the caller keeps both at 0 between launches.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar) : "memory");
    unsigned now;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(now) : "l"(bar) : "memory");
    } while (now < target);
  }
  __syncthreads();
}

__device__ __forceinline__ void grid_exit(unsigned* bar) {
  if (threadIdx.x == 0 && atomicAdd(bar + 1, 1u) == gridDim.x - 1) {
    bar[0] = 0u;
    bar[1] = 0u;
  }
}

// A product stage: the items of Op over every active problem.  With
// kPartial, item t's partial of <r, z> goes to slot t of the problem's
// rz partials (fold_mma_kernel's blockIdx.y * gridDim.x + blockIdx.x).
template <class Op, bool kStage = false, class MakeOp>
__device__ __forceinline__ void product_stage(const ChainArgs& a, int M, int N, int ny,
                                              MakeOp make_op, bf16* smem) {
  const int nx = a.pl.fold_n, items = nx * ny;
  for (int it = blockIdx.x; it < a.B * items; it += gridDim.x) {
    const int b = it / items, t = it % items;
    if (!active(a, b)) continue;
    const Op op = make_op(b, t);
    const float tot = fold::fold_tile<Op, kThreads, kStage>(op, b, t / nx, t % nx, M, N, smem);
    if constexpr (Op::kPartial) {
      if (threadIdx.x == 0) a.partials[size_t(b) * a.pl.pstride + a.pl.p_rz + t] = tot;
    }
  }
}

// The items of the top left quadrant's 32 x 8 tiles over every active
// problem.  Each thread takes one quadrant knot (k, j), k < m0/2, j <
// m1/2, and its four mirror points (k, j), (k, m1-1-j), (m0-1-k, j),
// (m0-1-k, m1-1-j): x = get(b, i, j) reads a point's inputs, put(b, i, j,
// x) writes its outputs and returns a value; with kAll every point's reads
// come before any write (their loads in flight together), else one point
// after another.  Then every thread calls finish(b, t, k, j, v0, v1, v2,
// v3, in) with put's four values (in: the knot lies in the quadrant).
// before(b) once a CTA reaches a new problem; before and finish may
// synchronise the CTA.
template <bool kAll, class Before, class Get, class Put, class Finish>
__device__ __forceinline__ void quad_stage(const ChainArgs& a, Before before, Get get, Put put,
                                           Finish finish) {
  const int h0 = a.L.m0 / 2, h1 = a.L.m1 / 2, nq = a.pl.quad_items;
  int seen = -1;
  for (int it = blockIdx.x; it < a.B * nq; it += gridDim.x) {
    const int b = it / nq, t = it % nq;
    if (!active(a, b)) continue;
    if (b != seen) before(b);
    seen = b;
    const int k = (t / a.pl.quad_cols) * TY + (threadIdx.x >> 5);
    const int j = (t % a.pl.quad_cols) * TX + (threadIdx.x & 31);
    const bool in = k < h0 && j < h1;
    const int ii[4] = {k, k, a.L.m0 - 1 - k, a.L.m0 - 1 - k};
    const int jj[4] = {j, a.L.m1 - 1 - j, j, a.L.m1 - 1 - j};
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (in) {
      if constexpr (kAll) {
        decltype(get(0, 0, 0)) x[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = get(b, ii[q], jj[q]);
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = put(b, ii[q], jj[q], x[q]);
      } else {
#pragma unroll 1
        for (int q = 0; q < 4; ++q) {
          const int i = q < 2 ? k : ii[2], jq = q % 2 == 0 ? j : jj[1];
          const float y = put(b, i, jq, get(b, i, jq));
          v[0] = q == 0 ? y : v[0];
          v[1] = q == 1 ? y : v[1];
          v[2] = q == 2 ? y : v[2];
          v[3] = q == 3 ? y : v[3];
        }
      }
    }
    finish(b, t, k, j, v[0], v[1], v[2], v[3], in);
  }
}

struct MatvecPt {
  float v, p;
};
struct UpdatePt {
  float x, p, r, ap;
};

// Built with MVTV_CHAIN_TRACE (scripts/chain_trace.py), the kernel records
// at its s-th grid barrier the latest arrival of any CTA ([0][s], the
// global timer) and CTA 0's leaving ([1][s]), CTA 0's clock at arrival
// and leaving ([2][s], [3][s]), and the launch's start in slot 1023.
#ifdef MVTV_CHAIN_TRACE
__device__ unsigned long long g_chain_trace[4][1024];
__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// Every stage's code appears once: the step loop holds the one
// preconditioner apply and both CG update stages.
__global__ void __launch_bounds__(kThreads, 2) admm_chain_kernel(const ChainArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float ws[kWarps][5];
  __shared__ float bcast;
  __shared__ bool last;
  bf16* const smem = reinterpret_cast<bf16*>(smem_raw);
  unsigned* const bar = a.tickets + a.B;
  unsigned passed = 0;  // grid barriers behind this CTA
#ifdef MVTV_CHAIN_TRACE
  int stage = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    g_chain_trace[1][1023] = gtimer();
    g_chain_trace[3][1023] = clock64();
  }
  auto barrier = [&]() {
    __syncthreads();
    if (threadIdx.x == 0) {
      atomicMax(&g_chain_trace[0][stage], gtimer());
      if (blockIdx.x == 0) g_chain_trace[2][stage] = clock64();
    }
    grid_barrier(bar, ++passed * gridDim.x);
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      g_chain_trace[1][stage] = gtimer();
      g_chain_trace[3][stage] = clock64();
    }
    ++stage;
  };
#else
  auto barrier = [&]() { grid_barrier(bar, ++passed * gridDim.x); };
#endif
  const Lat L = a.L;
  const int tid = threadIdx.x, h0 = L.m0 / 2, h1 = L.m1 / 2;
  const size_t n = size_t(L.m0) * L.m1;
  const Folded& fd = a.fd;
  auto row = [&](int b) { return a.scal + size_t(b) * a.sstride; };
  auto parts = [&](int b) { return a.partials + size_t(b) * a.pl.pstride; };
  auto cnt = [&](int b) { return a.counts + size_t(b) * a.cstride; };

  // Set-up: every problem's scalars (init_scalars_kernel), the padded
  // halves with zero pads, the zero pads of the problems' staged operands
  // (never written by a product), and with an odd K the scratch copy of u.
  {
    const long long nth = (long long)gridDim.x * kThreads;
    const long long g0 = (long long)blockIdx.x * kThreads + tid;
    for (long long b = g0; b < a.B; b += nth) {
      float* r = row(int(b));
      r[S_LAM] = a.lam[b];
      r[S_RHO] = a.rho[b];
      r[S_USCALE] = a.uscale[b];
      r[S_CBAR] = a.cbar[b];
      r[S_KAPPA] = a.lam[b] / a.rho[b];
      for (int v = 0; v < 6; ++v) r[S_STATS + v] = 0.f;
    }
    const long long n0 = (long long)h0 * fd.ld0, n1 = (long long)h1 * fd.ld1;
    for (long long e = g0; e < 2 * (n0 + n1); e += nth) {
      const int z = e < 2 * n0 ? int(e / n0) : 2 + int((e - 2 * n0) / n1);
      const long long q = z < 2 ? e - z * n0 : e - 2 * n0 - (z - 2) * n1;
      const int h = z < 2 ? h0 : h1, ld = z < 2 ? fd.ld0 : fd.ld1;
      const int rr = int(q / ld), c = int(q % ld);
      const bf16* src = z == 0 ? a.te0 : z == 1 ? a.to0 : z == 2 ? a.te1 : a.to1;
      bf16* dst = z == 0 ? fd.te0 : z == 1 ? fd.to0 : z == 2 ? fd.te1 : fd.to1;
      dst[q] = c < h ? src[size_t(rr) * h + c] : __float2bfloat16_rn(0.f);
    }
    const int padw = fd.ld1 - h1;
    for (long long e = g0; e < (long long)a.B * 4 * L.m0 * padw; e += nth)
      fd.scratch[(e / padw) * fd.ld1 + h1 + e % padw] = __float2bfloat16_rn(0.f);
    if (a.k_iters % 2 == 1)
      for (long long e = g0; e < (long long)a.B * n; e += nth)
        if (active(a, int(e / n)))
          for (int k = 0; k < 3; ++k) a.u[1][k][e] = a.u[0][k][e];
  }
  barrier();

  for (int it = 0; it < a.k_iters; ++it) {
    // With an odd K the first iteration reads the scratch copy.
    const int src = (it + a.k_iters) % 2 == 1 ? 1 : 0;
    float* const* us_ = a.u[src];
    float* const* ud_ = a.u[1 - src];
    auto fold_r = [&](int b, int, int k, int j, float v0, float v1, float v2, float v3,
                      bool in) {
      if (in) fold::fold_in_at(fd, b, k, j, h0, v0, v1, v2, v3);
    };

    // r0 = b - A theta, b formed in registers, and r0's fold.
    float rho = 0.f, usc = 0.f;
    quad_stage<false>(
        a, [&](int b) { rho = row(b)[S_RHO], usc = row(b)[S_USCALE]; },
        [&](int b, int i, int j) {
          const size_t o = size_t(b) * n, e = size_t(i) * L.m1 + j;
          return residual_formed_at(a.theta + o, cnt(b)[e], a.oty[size_t(b) * a.cstride + e],
                                    a.a0 + o, a.a1 + o, a.a2 + o, us_[0] + o, us_[1] + o,
                                    us_[2] + o, rho, usc, i, j, L, a.sc);
        },
        [&](int b, int i, int j, float v) {
          a.r[size_t(b) * n + size_t(i) * L.m1 + j] = v;
          return v;
        },
        fold_r);
    barrier();

    for (int step = 0; step < a.n_steps; ++step) {
      // z = M^-1 r into p (the first step: p = z; then p = z + beta p) and
      // <r, z> into scal[rz]: the four products, a barrier after each.
      const int rz = S_CG + 2 * step;
      product_stage<fold::FwdRows>(
          a, h0, h1, 2 * a.pl.fold_mh,
          [&](int, int) { return fold::FwdRows{fd, L.m0, h0, h1}; }, smem);
      barrier();
      product_stage<FwdColsStaged, true>(
          a, L.m0, h1, a.pl.fold_m,
          [&](int b, int) {
            FwdColsStaged op;
            static_cast<fold::FwdCols&>(op) =
                fold::FwdCols{fd, a.eigs, a.scal, a.sstride, L.m0, L.m1, h1};
            op.cbar = row(b)[S_CBAR];
            op.rho = row(b)[S_RHO];
            return op;
          },
          smem);
      barrier();
      product_stage<fold::InvRows>(
          a, h0, h1, 2 * a.pl.fold_mh,
          [&](int, int) { return fold::InvRows{fd, L.m0, h0, h1}; }, smem);
      barrier();
      // beta = rz / max(rz_old, eps) from this CTA's sum of the problem's
      // <r, z> partials; the CTA with the problem's first item keeps rz in
      // scal for the CG update and the next preconditioner.
      int seen = -1;
      float beta = 0.f;
      product_stage<InvColsBeta, true>(
          a, L.m0, h1, a.pl.fold_m,
          [&](int b, int t) {
            if (b != seen) {
              const float z = cta_total(parts(b) + a.pl.p_rz, a.pl.fold_m * a.pl.fold_n, &bcast);
              if (t == 0 && tid == 0) row(b)[rz] = z;
              if (step > 0) beta = z / nan_max(row(b)[rz - 2], kEps);
              seen = b;
            }
            InvColsBeta op;
            static_cast<fold::InvCols&>(op) = fold::InvCols{
                fd, a.p, a.scal, a.sstride, step == 0 ? -1 : rz, rz - 2, L.m0, L.m1, h1};
            op.beta = beta;
            return op;
          },
          smem);
      barrier();

      // ap = A p and the partials of <p, Ap>, one a quadrant item (the sum
      // of its threads' four terms in block_sum's order).
      auto partial = [&](int slots) {
        return [&, slots](int b, int t, int, int, float v0, float v1, float v2, float v3, bool) {
          const float tot = block_sum(((v0 + v1) + v2) + v3);
          if (tid == 0) parts(b)[slots + t] = tot;
        };
      };
      quad_stage<true>(
          a, [&](int b) { rho = row(b)[S_RHO]; },
          [&](int b, int i, int j) {
            const size_t o = size_t(b) * n, e = size_t(i) * L.m1 + j;
            return MatvecPt{gram_apply_at(a.p + o, cnt(b)[e], i, j, L, rho, a.sc), a.p[o + e]};
          },
          [&](int b, int i, int j, MatvecPt q) {
            a.ap[size_t(b) * n + size_t(i) * L.m1 + j] = q.v;
            return q.p * q.v;
          },
          partial(a.pl.p_pap));
      barrier();

      // alpha = rz / max(pap, eps); theta += alpha p; r -= alpha ap; then
      // r's fold for the next preconditioner, or |r|^2's partials after
      // the last step.
      float al = 0.f;
      auto alpha = [&](int b) {
        const float s = cta_total(parts(b) + a.pl.p_pap, a.pl.quad_items, &bcast);
        al = row(b)[rz] / nan_max(s, kEps);
      };
      auto get = [&](int b, int i, int j) {
        const size_t o = size_t(b) * n + size_t(i) * L.m1 + j;
        return UpdatePt{a.theta[o], a.p[o], a.r[o], a.ap[o]};
      };
      auto update = [&](int b, int i, int j, UpdatePt q) {
        const size_t o = size_t(b) * n + size_t(i) * L.m1 + j;
        a.theta[o] = q.x + al * q.p;
        const float rn = q.r - al * q.ap;
        a.r[o] = rn;
        return rn;
      };
      if (step + 1 < a.n_steps)
        quad_stage<true>(a, alpha, get, update, fold_r);
      else
        quad_stage<true>(
            a, alpha, get,
            [&](int b, int i, int j, UpdatePt q) {
              const float rn = update(b, i, j, q);
              return rn * rn;
            },
            partial(a.pl.p_rr));
      barrier();
    }

    // The z/dual stage: alpha, u_new and the five sums; the CTA that takes
    // a problem's last ticket adds them (and |r|^2's partials) in the stage
    // kernels' order and adapts rho (rho_adapt in the chain it replaces).
    const int nd = a.pl.dual_items, rows = (L.m0 + TY - 1) / TY;
    for (int item = blockIdx.x; item < a.B * nd; item += gridDim.x) {
      const int b = item / nd, t = item % nd;
      if (!active(a, b)) continue;
      const size_t o = size_t(b) * n;
      float* sr = row(b);
      const DualLats d{a.theta + o, us_[0] + o, us_[1] + o, us_[2] + o, a.a0 + o, a.a1 + o,
                       a.a2 + o, ud_[0] + o, ud_[1] + o, ud_[2] + o, nullptr, nullptr,
                       sr[S_KAPPA], sr[S_USCALE]};
      const int r_first = (t / a.pl.dual_cols) * a.pl.dual_steps;
      float st[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
      dual_march<true, false, false, kChainRing>(
          d, a.sc, a.t0, a.t1, t % a.pl.dual_cols, r_first, min(r_first + a.pl.dual_steps, rows),
          L, DualHalo{}, Slab{0, 0}, tid & 31, tid >> 5,
          DualSmem<false, kChainRing>(reinterpret_cast<float*>(smem_raw)), st);
      cta_sum5(st, ws, tid);
      float* pd = parts(b) + a.pl.p_dual;
      if (tid == 0) {
#pragma unroll
        for (int v = 0; v < 5; ++v) pd[v * nd + t] = st[v];
        __threadfence();
        last = atomicAdd(&a.tickets[b], 1u) == unsigned(nd - 1);
      }
      __syncthreads();
      if (!last) continue;
      __threadfence();
      float tot[5];
#pragma unroll
      for (int v = 0; v < 5; ++v) {
        tot[v] = 0.f;
        for (int k = tid; k < nd; k += kThreads) tot[v] += __ldcg(pd + v * nd + k);
      }
      cta_sum5(tot, ws, tid);
      const float rsq = cta_total(parts(b) + a.pl.p_rr, a.pl.quad_items, &bcast);
      if (tid == 0) {
#pragma unroll
        for (int v = 0; v < 5; ++v) sr[S_STATS + v] = tot[v];
        sr[S_STATS + 5] = rsq;
        if (!a.adapt) {
          sr[S_USCALE] = 1.f;
        } else {
          const float rho0 = sr[S_RHO];
          const float pn = sqrtf(tot[0]);
          const float dn = rho0 * sqrtf(tot[3]);
          const bool grow = pn > a.band * dn, shrink = dn > a.band * pn;
          const float factor = grow ? a.tau : (shrink ? 1.f / a.tau_shrink : 1.f);
          const float rho_new = rho0 * factor;
          sr[S_RHO] = rho_new;
          sr[S_USCALE] = 1.f / factor;
          sr[S_KAPPA] = sr[S_LAM] / rho_new;
        }
        a.tickets[b] = 0u;
      }
    }
    if (it + 1 < a.k_iters) barrier();
  }
  grid_exit(bar);
}

// The most CTAs of admm_chain_kernel an SM keeps resident and the SMs of
// the current device, found (and the kernel's shared memory allowed) once
// per device.
int occupancy(int* per_sm, int* sms) {
  constexpr int kMaxDevices = 64;
  static int found[kMaxDevices][2] = {};
  int dev = 0;
  MVTV_CHECK(int(cudaGetDevice(&dev)));
  if (dev < 0 || dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  int* f = found[dev];
  if (f[0] == 0) {
    int coop = 0;
    MVTV_CHECK(int(cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)));
    if (!coop) return int(cudaErrorNotSupported);
    MVTV_CHECK(int(cudaFuncSetAttribute(admm_chain_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        kChainSmem)));
    MVTV_CHECK(int(cudaDeviceGetAttribute(&f[1], cudaDevAttrMultiProcessorCount, dev)));
    MVTV_CHECK(int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f[0], admm_chain_kernel,
                                                                 kThreads, kChainSmem)));
    if (f[0] == 0) return int(cudaErrorCooperativeLaunchTooLarge);
  }
  *per_sm = f[0];
  *sms = f[1];
  return 0;
}

}  // namespace
}  // namespace mvtv

// The most co-resident CTAs of the chain's kernel an SM holds (per_sm) and
// the SMs of the current device; cudaErrorNotSupported where the device
// has no cooperative launch.  ops/kernels.py::chain_plan sizes the grid
// from them.
extern "C" int mvtv_admm_iters_2d_batched_occupancy(int* per_sm, int* sms) {
  return mvtv::occupancy(per_sm, sms);
}

// B5 entry point (B4 is B = 1).  theta, u0..u2 and a0..a2 are (B, m0, m1)
// and are updated in place; work holds mvtv_admm_iters_2d_batched_work(B,
// m0, m1) floats: 6 x (B, m0, m1) lattices (u scratch x3, r, p, ap), then
// the folded products' padded bf16 operands (dct_fold.cu); partials B rows
// of plan's pstride floats, scal B rows of S_CG + 2 (n_steps + 1), tickets
// B + 2 unsigneds that are 0 (the dual stage's last-CTA tickets, then the
// grid barrier's counters; left 0).  plan (host memory): the 14 ints of
// ops/kernels.py::chain_plan in Plan's order, whose grid must be resident
// (mvtv_admm_iters_2d_batched_occupancy).  After the call
// row b of scal holds problem b's rho and u_scale after its last
// iteration and that iteration's 6 statistics.  t0 < 0: no true_m masks.
// adapt, tau, tau_shrink and band: the adaptive rho of the dual stage.
// One cooperative launch; a refused launch returns its error.
extern "C" long long mvtv_admm_iters_2d_batched_work(int B, int m0, int m1) {
  return mvtv::folded_work(6, B, m0, m1);
}

extern "C" int mvtv_admm_iters_2d_batched(
    float* theta, float* u0, float* u1, float* u2, float* a0, float* a1, float* a2,
    const float* counts, const float* oty, long long cstride, const void* te0, const void* to0,
    const void* te1, const void* to1, const float* eigs, const float* lam, const float* rho,
    const float* uscale, const float* cbar, const int* act, float s_mix, float s_ax1,
    float s_ax0, int k_iters, int n_steps, float tau, float band, float tau_shrink, int adapt,
    int t0, int t1, float* work, float* partials, unsigned* tickets, float* scal, int B, int m0,
    int m1, const int* plan, void* stream) {
  using namespace mvtv;
  int per_sm = 0, sms = 0;
  MVTV_CHECK(occupancy(&per_sm, &sms));
  ChainArgs a{};
  const Lat L{m0, m1};
  const size_t bn = size_t(B) * m0 * m1;
  a.theta = theta;
  float* const own[3] = {u0, u1, u2};
  for (int k = 0; k < 3; ++k) a.u[0][k] = own[k], a.u[1][k] = work + k * bn;
  a.a0 = a0, a.a1 = a1, a.a2 = a2;
  a.counts = counts, a.oty = oty, a.cstride = cstride;
  a.te0 = static_cast<const bf16*>(te0), a.to0 = static_cast<const bf16*>(to0);
  a.te1 = static_cast<const bf16*>(te1), a.to1 = static_cast<const bf16*>(to1);
  a.eigs = eigs, a.lam = lam, a.rho = rho, a.uscale = uscale, a.cbar = cbar, a.act = act;
  a.sc = Scales{s_mix, s_ax1, s_ax0};
  a.tau = tau, a.band = band, a.tau_shrink = tau_shrink;
  a.k_iters = k_iters, a.n_steps = n_steps, a.adapt = adapt, a.t0 = t0, a.t1 = t1;
  a.r = work + 3 * bn, a.p = work + 4 * bn, a.ap = work + 5 * bn;
  a.fd = folded_in_work(work, 6, L, B);
  a.partials = partials, a.tickets = tickets, a.scal = scal;
  a.sstride = S_CG + 2 * (n_steps + 1), a.B = B, a.L = L;
  std::memcpy(&a.pl, plan, sizeof(Plan));
  if (a.pl.grid < 1 || a.pl.grid > per_sm * sms) return int(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(admm_chain_kernel), dim3(a.pl.grid), dim3(kThreads), args,
      kChainSmem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) cudaGetLastError();  // leave no error behind for the next launch
  return int(e);
}
