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
//     Bound: as B9 or B10, plus two halo rows;
//   * gram_matvec_2d (B7, _gram_matvec_kernel, a whole lattice of at most
//     2^20 knots): B10's A v with B7's scalars (rho s) s, and <v, A v>.
//     Each CTA leaves its partial of the dot and the CTA that takes the last
//     ticket (B1's pattern, dual.cu) adds them in a fixed order: one launch,
//     where B7 was a scalar copy, the stage kernel and a finish pass.  The
//     dot costs the tail of the launch: the last CTA's loads of the
//     partials, issued 16 at a time.  Bound: B10's 12 bytes per knot.
//
// The TPU kernels stream row panels of T <= 512 rows with 8-row halos
// through VMEM (double-buffered manual DMA, _halo_copies/_halo_pingpong)
// because a 2048^2 lattice does not fit VMEM.  On the H100, B8 is B1's
// kernel (dual.cu: a march of 32 x 8 tiles, each with its halo in shared
// memory, each stage once, one launch) and B8s its slab mode.  B9s, the
// slab matvec and B10 (on 16-byte aligned rows) are one row march
// (gram_march_kernel), the TPU's row panels cut to one row: a CTA owns a
// strip of kGW columns, each thread taking 4 adjacent ones (1 where rows
// are not 16-byte aligned), and walks down a chunk of rows, keeping v's
// rows i - 1, i and i + 1 (the strip and one column on each side, wrapped
// as jnp.roll wraps) in a ring of shared-memory rows that cp.async fills
// kGAhead rows ahead; the knots' other inputs (counts, and b or oty, dta
// and dtu) stream through a ring of their own, as B13's plane march does
// in 3-D.  So a CTA reads each v row of its chunk and the two around it
// once, and each thread's 3 x 3 neighbourhoods come from shared memory.
// On a slab the chunk's rows -1 and m0 are the halo rows v_top and v_bot
// (the ring's first and last fills, the source chosen once per row) and
// the axis-0 masks use the global row; on a whole lattice those rows wrap.
// The chunk length follows the lattice's shape alone (about kGramCtas
// CTAs), never the data.  B9, and B10 on other rows, keep
// gram_knot_kernel: one thread per knot reading its neighbourhood from
// device memory, as B2 does; B7 on such rows runs gram_dot_knot_kernel,
// the same arithmetic, a CTA walking kDotSteps 32 x 8 tiles down a column
// strip, then the dot's last-CTA finish.  What the halo code taught
// stays: every value outside the lattice is an explicit 0 under the
// padded-block convention (the edge() masks of stencil.cuh), so a wrapped
// neighbour never leaks in.
//
// Bound on the H100: device-memory bandwidth, one pass each.  B8 with alpha
// skipped reads theta and 3 u and writes 3 u_new, dta and dtu: 36 bytes per
// knot (plus the five per-CTA partial sums, which its last CTA adds up).
// B9 in fused mode reads v, counts, oty, dta and dtu and writes r0: 24
// bytes per knot; with b given 16.  B10 reads v and counts and writes one
// lattice: 12 bytes per knot.  The scalars (kappa, rho, u_scale) stay on
// the device.
#include "stencil.cuh"

namespace mvtv {

enum GramMode : int {
  GRAM_MATVEC = 0,
  GRAM_RESIDUAL = 1,
  GRAM_RESIDUAL_FUSED = 2,
  GRAM_MATVEC_DOT = 3  // B7: GRAM_MATVEC with B7's scalars, and <v, A v>
};

constexpr int kGW = 256;         // columns per strip
constexpr int kGAhead = 3;       // rows a read runs ahead of the row it serves
constexpr int kGRing = 8;        // v rows in the ring (>= kGAhead + 3, a power of two)
constexpr int kGInRing = 4;      // input rows in theirs (>= kGAhead + 1, a power of two)
constexpr int kGramCtas = 1024;  // CTAs a lattice is cut into, about 8 per SM
constexpr int kDotSteps = 8;     // 32 x 8 tiles per CTA of B7's thread-per-knot kernel

__host__ __device__ constexpr int gram_inputs(int mode) {
  return (mode == GRAM_MATVEC || mode == GRAM_MATVEC_DOT) ? 1 : (mode == GRAM_RESIDUAL ? 2 : 4);
}

// B7's dot: where each CTA leaves its partial, the ticket (one unsigned,
// 0 before the launch and after it) and the total.
struct DotSink {
  float* partials;
  unsigned* ticket;
  float* out;
};

// This CTA's sum of d into its partial; the CTA that takes the last ticket
// adds every CTA's partial (thread t those at t, t + threads, ..., then the
// block in block_sum's fixed order), writes the total and sets the ticket
// back to 0.  Every thread of the CTA calls it.
__device__ __forceinline__ void dot_finish(float d, DotSink ds) {
  __shared__ bool last;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  const int nb = gridDim.x * gridDim.y;
  const float tot = block_sum(d);
  if (tid == 0) {
    ds.partials[blockIdx.y * gridDim.x + blockIdx.x] = tot;
    __threadfence();
    last = atomicAdd(ds.ticket, 1u) == unsigned(nb - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Thread tid adds partials tid, tid + nt, ... in that order, its loads
  // issued kBatch at a time (one after another they would cost a device-
  // memory latency each).
  constexpr int kBatch = 16;
  float acc = 0.f;
  for (int k0 = tid; k0 < nb; k0 += kBatch * nt) {
    float pv[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int k = k0 + q * nt;
      pv[q] = k < nb ? __ldcg(ds.partials + k) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (k0 + q * nt < nb) acc += pv[q];
  }
  const float all = block_sum(acc);
  if (tid == 0) {
    *ds.out = all;
    *ds.ticket = 0u;
  }
}

// kSlab: the lattice is one rank's row slab (B9s and the slab matvec); its
// rows -1 and m0 are v_top and v_bot, and the axis-0 masks use the global
// row of sl.  Otherwise the rows wrap (B10, B7).  A thread takes kVec
// adjacent columns (4: every row start and pointer 16-byte aligned, the
// copies 16 bytes wide; else 1), the CTA at (x, y) a strip of kGW columns
// and rows y rows ..  A ring row holds the strip's column j0 + c at 4 + c,
// the columns left and right of it (wrapped) at 3 and 4 + the strip's
// width.
template <int MODE, bool kSlab, int kVec>
__global__ void __launch_bounds__(kGW / kVec)
gram_march_kernel(const float* __restrict__ v, const float* __restrict__ v_top,
                  const float* __restrict__ v_bot, const float* __restrict__ counts,
                  const float* __restrict__ b, const float* __restrict__ oty,
                  const float* __restrict__ dta, const float* __restrict__ dtu,
                  const float* __restrict__ rho_p, const float* __restrict__ us_p, Scales sc,
                  Slab sl, float* __restrict__ out, Lat L, int rows, DotSink ds) {
  constexpr int NIN = gram_inputs(MODE);
  constexpr int W = kGW;
  __shared__ __align__(16) float v_s[kGRing][W + 8];      // v's rows, a ring
  __shared__ __align__(16) float in_s[kGInRing][NIN][W];  // the knots' inputs, a ring
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * W, jt = j0 + tid * kVec;    // the strip's and this thread's
  const int r0 = blockIdx.y * rows, r1 = min(r0 + rows, L.m0);
  const bool knot_in = jt < L.m1;
  const int width = min(W, L.m1 - j0);
  // v's local row r (r0 - 1 .. r1) into its ring slot, the source chosen
  // once per row.
  auto load_v = [&](int r) {
    if (r > r1) return;
    const float* src = kSlab ? slab_row(v, v_top, v_bot, r, L)
                             : v + size_t(wrap1(r, L.m0)) * L.m1;
    float* dst = v_s[r & (kGRing - 1)];
    if (knot_in) {
      if (kVec == 4)
        cp_async16f(dst + 4 + tid * 4, src + jt);
      else
        cp_async4(dst + 4 + tid, src + jt);
    }
    if (tid == 0) cp_async4(dst + 3, src + wrap1(j0 - 1, L.m1));
    if (tid == 1) cp_async4(dst + 4 + width, src + wrap1(j0 + width, L.m1));
  };
  const float* const ins[4] = {counts, MODE == GRAM_RESIDUAL ? b : oty, dta, dtu};
  // The knots' inputs at row r (r0 .. r1 - 1) into their ring slot.
  auto load_in = [&](int r) {
    if (!knot_in || r >= r1) return;
    const size_t g = size_t(r) * L.m1 + jt;
#pragma unroll
    for (int k = 0; k < NIN; ++k) {
      float* dst = &in_s[r & (kGInRing - 1)][k][tid * kVec];
      if (kVec == 4)
        cp_async16f(dst, ins[k] + g);
      else
        cp_async4(dst, ins[k] + g);
    }
  };
  // kGAhead groups in flight: the first holds row r0's three v rows and
  // inputs, each later one the v row and inputs kGAhead rows on.
  load_v(r0 - 1);
  load_v(r0);
  load_v(r0 + 1);
  load_in(r0);
  cp_async4_commit();
#pragma unroll
  for (int a = 1; a < kGAhead; ++a) {
    load_v(r0 + 1 + a);
    load_in(r0 + a);
    cp_async4_commit();
  }
  cp_async4_wait<kGAhead - 1>();
  __syncthreads();
  const float rho = *rho_p;
  const float us = MODE == GRAM_RESIDUAL_FUSED ? *us_p : 0.f;
  // rho * s^2 per block, as _tiled_gram_res_kernel's scalars; B7's are
  // (rho * s) * s, as _gram_matvec_kernel's.
  constexpr bool kB7 = MODE == GRAM_MATVEC_DOT;
  const float g_mix = kB7 ? rho * sc.mix * sc.mix : rho * (sc.mix * sc.mix);
  const float g_ax1 = kB7 ? rho * sc.ax1 * sc.ax1 : rho * (sc.ax1 * sc.ax1);
  const float g_ax0 = kB7 ? rho * sc.ax0 * sc.ax0 : rho * (sc.ax0 * sc.ax0);
  float dsum = 0.f;  // this thread's share of B7's <v, A v>
  // The axis-1 masks of this thread's columns: at the column left of each
  // knot and at its own.
  float e1m[kVec], e10[kVec];
#pragma unroll
  for (int q = 0; q < kVec; ++q) {
    const int j = knot_in ? jt + q : 0;
    e1m[q] = edge(dec(j, L.m1), L.m1);
    e10[q] = edge(j, L.m1);
  }
  for (int i = r0; i < r1; ++i) {
    load_v(i + 1 + kGAhead);
    load_in(i + kGAhead);
    cp_async4_commit();
    if (knot_in) {
      const int g = kSlab ? sl.row_off + i : i;
      const float e0m = kSlab ? edge_global(g - 1, sl.m0g) : edge(dec(i, L.m0), L.m0);
      const float e00 = kSlab ? edge_global(g, sl.m0g) : edge(i, L.m0);
      // v at rows i - 1, i, i + 1 and columns jt - 1 .. jt + kVec.
      float vm[kVec + 2], vc[kVec + 2], vp[kVec + 2];
      const int c0 = 3 + tid * kVec;
#pragma unroll
      for (int q = 0; q < kVec + 2; ++q) {
        vm[q] = v_s[(i - 1) & (kGRing - 1)][c0 + q];
        vc[q] = v_s[i & (kGRing - 1)][c0 + q];
        vp[q] = v_s[(i + 1) & (kGRing - 1)][c0 + q];
      }
      const float* in = &in_s[i & (kGInRing - 1)][0][tid * kVec];
      float o[kVec];
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        const float gv = gram_cols(vm, vc, vp, q, q + 1, q + 2, e1m[q], e10[q], e0m, e00,
                                   g_mix, g_ax1, g_ax0);
        const float av = in[q] * vc[q + 1] + gv;
        o[q] = av;
        if (kB7) dsum += vc[q + 1] * av;
        if (MODE == GRAM_RESIDUAL) o[q] = in[W + q] - av;
        if (MODE == GRAM_RESIDUAL_FUSED)
          o[q] = in[W + q] + rho * (in[2 * W + q] + us * in[3 * W + q]) - av;
      }
      float* dst = out + size_t(i) * L.m1 + jt;
      if (kVec == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[kVec > 1 ? 1 : 0],
                                                      o[kVec > 2 ? 2 : 0], o[kVec > 3 ? 3 : 0]);
      else
        dst[0] = o[0];
    }
    cp_async4_wait<kGAhead - 1>();
    __syncthreads();
  }
  if constexpr (kB7) dot_finish(dsum, ds);
}

// B9, and B10 where the march's 16-byte path does not apply: one thread per
// knot, its 3 x 3 neighbourhood read from device memory (neighbouring
// threads share the lines in L1/L2).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
gram_knot_kernel(const float* __restrict__ v, const float* __restrict__ counts,
                 const float* __restrict__ b, const float* __restrict__ oty,
                 const float* __restrict__ dta, const float* __restrict__ dtu,
                 const float* __restrict__ rho_p, const float* __restrict__ us_p, Scales sc,
                 float* __restrict__ out, Lat L) {
  const int j = blockIdx.x * TX + threadIdx.x;
  const int i = blockIdx.y * TY + threadIdx.y;
  if (i >= L.m0 || j >= L.m1) return;
  const size_t c = size_t(i) * L.m1 + j;
  const float rho = *rho_p;
  // rho * s^2 per block, as _tiled_gram_res_kernel's scalars.
  const float g_mix = rho * (sc.mix * sc.mix);
  const float g_ax1 = rho * (sc.ax1 * sc.ax1);
  const float g_ax0 = rho * (sc.ax0 * sc.ax0);
  const float av = counts[c] * v[c] + gram_at(v, i, j, L, g_mix, g_ax1, g_ax0);
  if (MODE == GRAM_MATVEC) {
    out[c] = av;
    return;
  }
  const float bv = MODE == GRAM_RESIDUAL ? b[c] : oty[c] + rho * (dta[c] + *us_p * dtu[c]);
  out[c] = bv - av;
}

// B7 where the march's 16-byte path does not apply: one thread per knot,
// gram_matvec_dot_kernel's arithmetic (xupdate.cu), a CTA taking kDotSteps
// tiles of 32 x 8 knots down its column strip (fewer CTAs, so fewer
// partials and tickets), then dot_finish.
__global__ void __launch_bounds__(kThreads)
gram_dot_knot_kernel(const float* __restrict__ v, const float* __restrict__ counts,
                     const float* __restrict__ rho_p, Scales sc, float* __restrict__ out,
                     DotSink ds, Lat L) {
  const int j = blockIdx.x * TX + threadIdx.x;
  const float rho = *rho_p;
  const float g_mix = rho * sc.mix * sc.mix;
  const float g_ax1 = rho * sc.ax1 * sc.ax1;
  const float g_ax0 = rho * sc.ax0 * sc.ax0;
  float d = 0.f;
#pragma unroll
  for (int t = 0; t < kDotSteps; ++t) {
    const int i = (blockIdx.y * kDotSteps + t) * TY + threadIdx.y;
    if (i < L.m0 && j < L.m1) {
      const size_t c = size_t(i) * L.m1 + j;
      const float av = counts[c] * v[c] + gram_at(v, i, j, L, g_mix, g_ax1, g_ax0);
      out[c] = av;
      d += v[c] * av;
    }
  }
  dot_finish(d, ds);
}

// gram_dot_knot_kernel's grid: a column of kDotSteps tiles per CTA.
inline dim3 gram_dot_knot_grid(Lat L) {
  const int ty = (L.m0 + TY - 1) / TY;
  return dim3((L.m1 + TX - 1) / TX, (ty + kDotSteps - 1) / kDotSteps);
}

// Rows per CTA: the lattice cut into about kGramCtas CTAs of kGW columns.
inline int gram_rows_per_cta(Lat L) {
  const int strips = (L.m1 + kGW - 1) / kGW;
  const int want = kGramCtas / strips < 1 ? 1 : kGramCtas / strips;
  const int chunks = want < L.m0 ? want : L.m0;
  return (L.m0 + chunks - 1) / chunks;
}

inline bool aligned16(const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; }

// One mode on a slab (the march) or on a whole lattice (the march for B10
// on 16-byte aligned rows; B9, and B10 elsewhere, keep gram_knot_kernel,
// which ran B9's fused mode 2 % faster than the march at 2048^2 on an
// H100, PERF.md).  Only the kernels a route can launch are compiled.
template <int MODE, bool kSlab>
int launch_gram_mode(bool vec, const float* v, const float* v_top, const float* v_bot,
                     const float* counts, const float* b, const float* oty, const float* dta,
                     const float* dtu, const float* rho, const float* uscale, Scales sc, Slab sl,
                     float* out, Lat L, cudaStream_t s) {
  const int rows = gram_rows_per_cta(L);
  const dim3 grid((L.m1 + kGW - 1) / kGW, (L.m0 + rows - 1) / rows);
#define MVTV_MARCH(VEC)                                                                 \
  gram_march_kernel<MODE, kSlab, VEC><<<grid, kGW / VEC, 0, s>>>(                       \
      v, v_top, v_bot, counts, b, oty, dta, dtu, rho, uscale, sc, sl, out, L, rows, DotSink{})
  if constexpr (kSlab) {
    if (vec)
      MVTV_MARCH(4);
    else
      MVTV_MARCH(1);
  } else if constexpr (MODE == GRAM_MATVEC) {
    if (vec)
      MVTV_MARCH(4);
    else
      gram_knot_kernel<MODE><<<stencil_grid(L), dim3(TX, TY), 0, s>>>(v, counts, b, oty, dta, dtu,
                                                                      rho, uscale, sc, out, L);
  } else {
    gram_knot_kernel<MODE><<<stencil_grid(L), dim3(TX, TY), 0, s>>>(v, counts, b, oty, dta, dtu,
                                                                    rho, uscale, sc, out, L);
  }
#undef MVTV_MARCH
  return int(cudaGetLastError());
}

template <bool kSlab>
int launch_gram(int mode, const float* v, const float* v_top, const float* v_bot,
                const float* counts, const float* b, const float* oty, const float* dta,
                const float* dtu, const float* rho, const float* uscale, Scales sc, Slab sl,
                float* out, Lat L, cudaStream_t s) {
  // 16-byte copies need every row start 16-byte aligned: m1 a multiple of
  // 4 and every lattice and halo row aligned (null pointers pass).
  const bool vec = L.m1 % 4 == 0 && aligned16(v) && aligned16(v_top) && aligned16(v_bot) &&
                   aligned16(counts) && aligned16(b) && aligned16(oty) && aligned16(dta) &&
                   aligned16(dtu) && aligned16(out);
#define MVTV_GRAM(MODE)                                                                     \
  launch_gram_mode<MODE, kSlab>(vec, v, v_top, v_bot, counts, b, oty, dta, dtu, rho, uscale, \
                                sc, sl, out, L, s)
  if (mode == GRAM_MATVEC) return MVTV_GRAM(GRAM_MATVEC);
  if (mode == GRAM_RESIDUAL) return MVTV_GRAM(GRAM_RESIDUAL);
  if (mode == GRAM_RESIDUAL_FUSED) return MVTV_GRAM(GRAM_RESIDUAL_FUSED);
#undef MVTV_GRAM
  return int(cudaErrorInvalidValue);
}

// B7's route: the march on 16-byte aligned rows, else gram_dot_knot_kernel.
inline bool gram_dot_march(Lat L, const float* v, const float* counts, const float* out) {
  return L.m1 % 4 == 0 && aligned16(v) && aligned16(counts) && aligned16(out);
}

// The CTAs of B7's launch on either route: the partials it needs at most.
inline int gram_dot_partials(Lat L) {
  const int rows = gram_rows_per_cta(L);
  const int march = ((L.m1 + kGW - 1) / kGW) * ((L.m0 + rows - 1) / rows);
  const dim3 g = gram_dot_knot_grid(L);
  const int knot = int(g.x * g.y);
  return march > knot ? march : knot;
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

// B7 entry point (gram_matvec_2d, pallas_kernels.py:143; kernel :124-140):
// out = counts v + sum_b (rho s_b s_b) adj_b(fwd_b(v)) and <v, out> into
// *dot, one launch, for any m0, m1.  partials holds
// mvtv_gram_matvec_2d_partials(m0, m1) floats; tickets points to one
// unsigned that is 0, and is 0 again after the launch.
extern "C" int mvtv_gram_matvec_2d_partials(int m0, int m1) {
  return mvtv::gram_dot_partials(mvtv::Lat{m0, m1});
}

extern "C" int mvtv_gram_matvec_2d(const float* v, const float* counts, const float* rho,
                                   float s_mix, float s_ax1, float s_ax0, float* out, float* dot,
                                   float* partials, unsigned* tickets, int m0, int m1,
                                   void* stream) {
  using namespace mvtv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Lat L{m0, m1};
  const Scales sc{s_mix, s_ax1, s_ax0};
  const DotSink ds{partials, tickets, dot};
  if (gram_dot_march(L, v, counts, out)) {
    const int rows = gram_rows_per_cta(L);
    const dim3 grid((m1 + kGW - 1) / kGW, (m0 + rows - 1) / rows);
    gram_march_kernel<GRAM_MATVEC_DOT, false, 4><<<grid, kGW / 4, 0, s>>>(
        v, nullptr, nullptr, counts, nullptr, nullptr, nullptr, nullptr, rho, nullptr, sc,
        Slab{0, m0}, out, L, rows, ds);
  } else {
    gram_dot_knot_kernel<<<gram_dot_knot_grid(L), dim3(TX, TY), 0, s>>>(v, counts, rho, sc, out,
                                                                      ds, L);
  }
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
