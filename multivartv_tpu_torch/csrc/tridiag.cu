// The exact p = 1 x-update: (diag(counts) + g T) x = b, g = (rho s) s.
//
// Replaces no TPU kernel: in the JAX package this solve is one fused XLA
// program (multivartv_tpu/solver/tridiag.py:208, xupdate_tridiag, cyclic
// reduction).  Run as eager PyTorch on the card it would cost about
// 2 log2(n) levels of ~8 launches each per ADMM iteration, so it is written
// here by hand (ops/kernels.py::xupdate_tridiag, T1).  T is the Neumann
// second difference: diagonal 2 with 1 at both ends (0 at n = 1), off-
// diagonals -1; the off-diagonals -g are formed in registers, never stored.
// rho is read through its device pointer, so it never goes to the host.
//
// Bound on the H100: device-memory bandwidth, 12 bytes a row (counts and b
// read once, x written once): 0.0038 ms at n = 2^20.
//
// Design.  The system is symmetric positive definite and weakly diagonally
// dominant (counts >= 0, some count > 0), so every elimination below keeps
// positive pivots and needs no pivoting.  The rows are cut into blocks of
// consecutive rows; eliminating a block's interior leaves two rows of a
// reduced system (its Schur complement, again symmetric positive definite
// and tridiagonal): the block's first row, coupled to the block before's
// last unknown and its own last, and its last row, coupled to its own
// first and the next block's first.  Two neighbouring blocks merge into one
// by eliminating their two inner unknowns (a 2 x 2 solve, `merge`); a
// merged block's inner unknowns follow from its two end values (`split`).
//
//   * The segment solve, one launch (n up to N_res, ~1.6 M rows on an
//     H100): G CTAs, each owning a segment of S = T C consecutive rows in
//     shared memory (T threads, C = 4 or 16 rows a thread), loaded once
//     with 16-byte loads.  Phase A: each thread eliminates its chunk of C
//     rows with two Thomas sweeps, one from each end (the multi-level
//     route's algebra; merging two-row blocks from the first level on
//     instead, as accurate or more, moved the capped fold solves of the
//     fused lasso's cross-validation off the JAX package's fit, PERF.md
//     §6); the CTA merges its T
//     chunks pairwise in a tree (log2 T levels, the lower ones within a
//     warp) to its segment's two end rows and writes them to a small global
//     scratch.  One grid barrier (a cooperative launch; none when G = 1).
//     Phase B: every CTA merges the G segments' rows the same way, in
//     shared memory, and one thread splits its way from the root down to
//     its own segment's two end values: the same instructions on the same
//     data in every CTA, so no second barrier.  Phase C: the CTA splits its
//     tree back down to every chunk's ends, recovers each chunk's interior
//     by a Thomas solve between them from the resident rows, and writes x
//     through shared memory with 16-byte stores.  Device memory sees the
//     12 bytes a row of the bound and 32 bytes a segment; the time is the
//     chains of dependent quotients, so they take the reciprocal unit's
//     approximation (quot<true>).
//   * Above N_res, a multi-level partition solve: reduce launches of
//     kChunk = 32 rows a thread leave reduced systems 16 times smaller
//     until one fits a CTA (<= kSmall rows), which the segment kernel
//     solves with G = 1 on the given rows; recover launches bring the
//     interiors back, level by level (7 launches at 4 M rows).
// Deterministic: no atomics, a fixed order of every operation, so a run
// repeats bit for bit.
//
// Segment mode (the sharded fit's p = 1 x-update, solver/tridiag.py::
// partition_xupdate): one rank holds a segment of the chain, and solves the
// segment's principal submatrix of the chain's system for three right-hand
// sides at once: b and the unit vectors e_0 and e_{n-1} at its two ends,
// which are formed in registers (rhs_at) and never read from memory.
// `open` marks the ends that lie inside the chain (bit 0 the first row,
// bit 1 the last): there T keeps its diagonal 2, as the chain's row does,
// and the coupling to the neighbour is left to the caller.  The systems
// share counts and rho; system r (0 b, 1 e_0, 2 e_{n-1}) writes row r of
// x.  The segment solve takes a second grid axis, one system a row of
// segments (R G CTAs, co-resident); above what fits, the multi-level route
// runs the systems one after another.  Device memory sees 20 bytes a row:
// counts and b read, three solutions written.
//
// Partition finish (the same solve's last step, after the ranks gather
// their segments' end values): every CTA's first thread solves the
// 2W-unknown interface system in float64 in shared memory (a band of two
// below and two above the diagonal, eliminated without pivoting: its rows
// are diagonally dominant), and the CTA writes this rank's
// x = y + (g x_{k-1}[L]) l + (g x_{k+1}[0]) r.  One launch in place of a
// dense library solve and its ~20 eager launches; 16 bytes a row.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace mvtv {
namespace tri {

namespace cg = cooperative_groups;

constexpr int kSmall = 4096;        // a CTA's largest system in the multi-level route
constexpr int kSegThreads = 256;    // most threads of a segment CTA
constexpr int kMaxGrid = 512;       // most segments of one segment solve
constexpr int kChunk = 32;          // multi-level route: rows a thread eliminates
constexpr int kChunkThreads = 64;   // threads of a reduce or recover CTA
constexpr int kCtaRows = kChunk * kChunkThreads;
constexpr int kStride = kChunk + 1;  // staged row stride: conflict-free banks

struct __align__(16) Row {
  float a, b, c, d;  // sub-, main and super-diagonal, right-hand side
};

// A level's system: four arrays of n rows (a[0] = c[n - 1] = 0).
struct Sys {
  float *a, *b, *c, *d;
};

// Row i of the first level, (diag(counts) + g T) x = rhs; rows past n are
// decoupled identity rows.  g t is exact for t in {0, 1, 2}.  open: the
// ends inside a longer chain (bit 0 row 0, bit 1 row n - 1), whose T
// diagonal stays 2.
__device__ __forceinline__ Row first_row(float cnt, float rhs, float g, int i, int n, int open) {
  if (i >= n) return Row{0.f, 1.f, 0.f, 0.f};
  float t = 2.f;
  if (i == 0 && !(open & 1)) t -= 1.f;
  if (i == n - 1 && !(open & 2)) t -= 1.f;
  return Row{i > 0 ? -g : 0.f, cnt + g * t, i < n - 1 ? -g : 0.f, rhs};
}

__device__ __forceinline__ float g_of(const float* rho, float s) { return (*rho * s) * s; }

// Row i of system `unit`'s right-hand side: rhs[i] for 0, the unit vector
// at row 0 for 1 and at row n - 1 for 2 (the segment mode's end columns).
__device__ __forceinline__ float rhs_at(const float* __restrict__ rhs, int unit, int i, int n) {
  if (unit == 0) return rhs[i];
  return i == (unit == 1 ? 0 : n - 1) ? 1.f : 0.f;
}

// a / b: the reciprocal unit's approximation (2 ulp at most) where kFast, the
// IEEE-rounded quotient otherwise.  The segment solve's quotients are its
// critical path; the multi-level route keeps the rounded ones.
template <bool kFast>
__device__ __forceinline__ float quot(float a, float b) {
  return kFast ? __fdividef(a, b) : a / b;
}

// ---------------------------------------------------------------------------
// The block algebra.
// ---------------------------------------------------------------------------

// Eliminate the interior rows 1 .. C - 2 of a chunk of C rows (row(k) gives
// local row k): its first and last rows become a block of the reduced
// system.
template <int C, bool kFast, class RowAt>
__device__ __forceinline__ void eliminate(const RowAt& row, Row& first_out, Row& last_out) {
  // Top-down: A x_0 + x_i + C x_{i+1} = D for i = 1 .. C - 2.
  Row r = row(1);
  float A = quot<kFast>(r.a, r.b), Cc = quot<kFast>(r.c, r.b), D = quot<kFast>(r.d, r.b);
#pragma unroll
  for (int k = 2; k <= C - 2; ++k) {
    r = row(k);
    const float inv = quot<kFast>(1.f, r.b - r.a * Cc);
    A = -r.a * A * inv;
    D = (r.d - r.a * D) * inv;
    Cc = r.c * inv;
  }
  // Bottom-up: A' x_{i-1} + x_i + C' x_{C-1} = D' for i = C - 2 .. 1.
  r = row(C - 2);
  float Ap = quot<kFast>(r.a, r.b), Cp = quot<kFast>(r.c, r.b), Dp = quot<kFast>(r.d, r.b);
#pragma unroll
  for (int k = C - 3; k >= 1; --k) {
    r = row(k);
    const float inv = quot<kFast>(1.f, r.b - r.c * Ap);
    Ap = r.a * inv;
    Cp = -r.c * Cp * inv;
    Dp = (r.d - r.c * Dp) * inv;
  }
  const Row first = row(0), last = row(C - 1);
  first_out = Row{first.a, first.b - first.c * Ap, -first.c * Cp, first.d - first.c * Dp};
  last_out = Row{-last.a * A, last.b - last.a * Cc, last.c, last.d - last.a * D};
}

// A chunk's x from its two end values x0, xl: a Thomas solve of rows 1 ..
// C - 2 with those values moved to the right-hand side; out[k] = x_k.
template <int C, bool kFast, class RowAt>
__device__ __forceinline__ void recover(const RowAt& row, float x0, float xl, float* out) {
  float cp[C], dp[C];
  float cprev = 0.f, dprev = 0.f;
#pragma unroll
  for (int k = 1; k <= C - 2; ++k) {
    const Row r = row(k);
    float a = r.a, c = r.c, d = r.d;
    if (k == 1) {
      d -= a * x0;
      a = 0.f;
    }
    if (k == C - 2) {
      d -= c * xl;
      c = 0.f;
    }
    const float inv = quot<kFast>(1.f, r.b - a * cprev);
    cp[k] = c * inv;
    dp[k] = (d - a * dprev) * inv;
    cprev = cp[k];
    dprev = dp[k];
  }
  out[0] = x0;
  out[C - 1] = xl;
  float nxt = dp[C - 2];
  out[C - 2] = nxt;
#pragma unroll
  for (int k = C - 3; k >= 1; --k) {
    nxt = dp[k] - cp[k] * nxt;
    out[k] = nxt;
  }
}

// Merge the neighbouring blocks (F1 .. L1) and (F2 .. L2) into (F1 .. L2):
// eliminate the inner unknowns x(L1), x(F2) from the outer rows.
__device__ __forceinline__ void merge(Row& F1, const Row L1, const Row F2, Row& L2) {
  const float inv = quot<true>(1.f, L1.b * F2.b - L1.c * F2.a);
  const float p = F1.c * inv, q = L2.a * inv;
  const Row f = F1, l = L2;
  F1 = Row{f.a, f.b - p * F2.b * L1.a, p * L1.c * F2.c, f.d - p * (F2.b * L1.d - L1.c * F2.d)};
  L2 = Row{q * F2.a * L1.a, l.b - q * L1.b * F2.c, l.c, l.d - q * (L1.b * F2.d - F2.a * L1.d)};
}

// The inner unknowns x1 = x(L1), x2 = x(F2) of a merged block from its end
// values xs = x(F1), xe = x(L2).
__device__ __forceinline__ void split(const Row L1, const Row F2, float xs, float xe, float& x1,
                                      float& x2) {
  const float inv = quot<true>(1.f, L1.b * F2.b - L1.c * F2.a);
  const float r1 = L1.d - L1.a * xs, r2 = F2.d - F2.c * xe;
  x1 = (F2.b * r1 - L1.c * r2) * inv;
  x2 = (L1.b * r2 - F2.a * r1) * inv;
}

// The end values of the whole system's block (F.a = L.c = 0).
__device__ __forceinline__ void solve_root(const Row F, const Row L, float& xs, float& xe) {
  const float inv = quot<true>(1.f, F.b * L.b - F.c * L.a);
  xs = (L.b * F.d - F.c * L.d) * inv;
  xe = (F.b * L.d - L.a * F.d) * inv;
}

// The widest merge of a tree over N blocks: the largest power of two
// below N (0 for N = 1).
__device__ __forceinline__ int top_width(int N) {
  if (N < 2) return 0;
  int w = 1;
  while (2 * w < N) w <<= 1;
  return w;
}

// After a tree level of width w, the next level reads what threads within
// a warp wrote while a node spans at most 32 blocks (thread s holds block
// s while N <= blockDim.x).
__device__ __forceinline__ void tree_sync(int span, int N) {
  if (span <= 32 && N <= int(blockDim.x))
    __syncwarp();
  else
    __syncthreads();
}

// Merge N blocks (f[j], l[j]) pairwise to one: at width w thread s merges
// [s, s + w) and [s + w, s + 2 w) (s a multiple of 2 w).  In place: a
// node's first row lives at f[s], its last at l[e - 1], and the inner rows
// of each merge stay as they were, for tree_split.  Ends with a CTA
// barrier.
__device__ void tree_reduce(Row* f, Row* l, int N) {
  for (int w = 1; w < N; w <<= 1) {
    for (int s = threadIdx.x; s < N; s += blockDim.x)
      if (!(s & (2 * w - 1)) && s + w < N)
        merge(f[s], l[s + w - 1], f[s + w], l[min(s + 2 * w, N) - 1]);
    tree_sync(4 * w, N);
  }
}

// From the root's end values (xf[0], xl[N - 1]) to every block's (xf[j],
// xl[j]), back down tree_reduce's levels.  Ends with a warp barrier: a
// thread then reads its own block's values.
__device__ void tree_split(const Row* f, const Row* l, float* xf, float* xl, int N) {
  for (int w = top_width(N); w >= 1; w >>= 1) {
    for (int s = threadIdx.x; s < N; s += blockDim.x)
      if (!(s & (2 * w - 1)) && s + w < N)
        split(l[s + w - 1], f[s + w], xf[s], xl[min(s + 2 * w, N) - 1], xl[s + w - 1], xf[s + w]);
    tree_sync(2 * w, N);
  }
}

// Block j's end values alone, from the root's (xs, xe), by one thread.
__device__ void path_split(const Row* f, const Row* l, int N, int j, float& xs, float& xe) {
  for (int w = top_width(N); w >= 1; w >>= 1) {
    const int s = j & ~(2 * w - 1);
    if (s + w >= N) continue;
    float x1, x2;
    split(l[s + w - 1], f[s + w], xs, xe, x1, x2);
    if (j < s + w)
      xe = x1;
    else
      xs = x2;
  }
}

// Four consecutive floats p[i .. i + 3] (16-byte aligned where vec), zeros
// past n.
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int i, int n, bool vec) {
  if (vec && i + 3 < n) return __ldg(reinterpret_cast<const float4*>(p + i));
  return make_float4(i < n ? p[i] : 0.f, i + 1 < n ? p[i + 1] : 0.f, i + 2 < n ? p[i + 2] : 0.f,
                     i + 3 < n ? p[i + 3] : 0.f);
}

// The unit vector with its 1 at row `at`, rows i .. i + 3.
__device__ __forceinline__ float4 unit4(int i, int at) {
  return make_float4(i == at ? 1.f : 0.f, i + 1 == at ? 1.f : 0.f, i + 2 == at ? 1.f : 0.f,
                     i + 3 == at ? 1.f : 0.f);
}

// ---------------------------------------------------------------------------
// The segment solve.  Shared memory, in floats: the staged rows (kArrays
// arrays of T (C + 1), row k of the segment at (k / C)(C + 1) + k % C),
// the chunk blocks (2 T rows), their end values (2 T) and the segments'
// blocks (2 G rows).
// ---------------------------------------------------------------------------
template <int C, bool kFirst>
constexpr size_t seg_smem(int threads, int grid) {
  return sizeof(float) * (size_t((kFirst ? 2 : 4) * threads * (C + 1)) + 10 * threads + 8 * grid);
}

// kFirst: the first level from counts and rhs, x written to x (16-byte
// loads where vec, stores where x's row is aligned too).  Otherwise the
// rows of `in` (G = 1), x to x.  ends: 8 floats a segment (G > 1: launched
// cooperatively).  blockIdx.y: the system (rhs_at's unit; x and ends row
// y).
template <int C, bool kFirst>
__global__ void __launch_bounds__(kSegThreads, 3)
segment_kernel(const float* __restrict__ counts, const float* __restrict__ rhs,
               const float* __restrict__ rho, float s, int open, Sys in,
               float* __restrict__ x0, float* __restrict__ ends0, int n, int vec) {
  static_assert(C % 4 == 0 && C >= 4, "chunks of whole float4s with an interior");
  constexpr int kArrays = kFirst ? 2 : 4;
  constexpr int kS = C + 1;
  extern __shared__ float4 seg_sm[];
  const int T = blockDim.x, t = threadIdx.x, G = gridDim.x;
  float* st = reinterpret_cast<float*>(seg_sm);
  Row* lf = reinterpret_cast<Row*>(st + kArrays * T * kS);
  Row* ll = lf + T;
  float* xf = reinterpret_cast<float*>(ll + T);
  float* xl = xf + T;
  Row* gf = reinterpret_cast<Row*>(xl + T);
  Row* gl = gf + G;
  const float g = kFirst ? g_of(rho, s) : 0.f;
  const int r0 = blockIdx.x * T * C;  // the segment's first row
  const int unit = blockIdx.y;
  float* x = x0 + size_t(unit) * n;
  const bool vec_x = vec && reinterpret_cast<size_t>(x) % 16 == 0;
  float* ends = ends0 == nullptr ? nullptr : ends0 + size_t(blockIdx.y) * 8 * G;

  // Phase A: stage the segment (C / 4 float4s of each array a thread).
  if constexpr (kFirst) {
    float4 cv[C / 4], bv[C / 4];
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const int k = 4 * (q * T + t);
      cv[q] = load4(counts, r0 + k, n, vec);
      bv[q] = unit == 0 ? load4(rhs, r0 + k, n, vec) : unit4(r0 + k, unit == 1 ? 0 : n - 1);
    }
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const int k = 4 * (q * T + t);
      float* dst = st + (k / C) * kS + k % C;
      dst[0] = cv[q].x, dst[1] = cv[q].y, dst[2] = cv[q].z, dst[3] = cv[q].w;
      dst += T * kS;
      dst[0] = bv[q].x, dst[1] = bv[q].y, dst[2] = bv[q].z, dst[3] = bv[q].w;
    }
  } else {
    for (int k = t; k < T * C; k += T) {
      const int i = r0 + k;
      float* dst = st + (k / C) * kS + k % C;
      const bool ok = i < n;
      dst[0] = ok ? in.a[i] : 0.f;
      dst[T * kS] = ok ? in.b[i] : 1.f;
      dst[2 * T * kS] = ok ? in.c[i] : 0.f;
      dst[3 * T * kS] = ok ? in.d[i] : 0.f;
    }
  }
  __syncthreads();
  const int c0 = r0 + t * C;  // this thread's chunk's first row
  const float* mine = st + t * kS;
  auto row = [&](int k) {
    const int i = c0 + k;
    if constexpr (kFirst) {
      return first_row(mine[k], mine[T * kS + k], g, i, n, open);
    } else {
      if (i >= n) return Row{0.f, 1.f, 0.f, 0.f};
      return Row{mine[k], mine[T * kS + k], mine[2 * T * kS + k], mine[3 * T * kS + k]};
    }
  };
  eliminate<C, true>(row, lf[t], ll[t]);
  __syncwarp();
  tree_reduce(lf, ll, T);

  // One barrier, then phase B: the segments' tree in every CTA.
  if (G > 1) {
    if (t == 0) {
      reinterpret_cast<float4*>(ends)[2 * blockIdx.x] =
          make_float4(lf[0].a, lf[0].b, lf[0].c, lf[0].d);
      reinterpret_cast<float4*>(ends)[2 * blockIdx.x + 1] =
          make_float4(ll[T - 1].a, ll[T - 1].b, ll[T - 1].c, ll[T - 1].d);
    }
    cg::this_grid().sync();
    for (int j = t; j < G; j += T) {
      const float4 f = __ldcg(reinterpret_cast<const float4*>(ends) + 2 * j);
      const float4 l = __ldcg(reinterpret_cast<const float4*>(ends) + 2 * j + 1);
      gf[j] = Row{f.x, f.y, f.z, f.w};
      gl[j] = Row{l.x, l.y, l.z, l.w};
    }
    __syncthreads();
    tree_reduce(gf, gl, G);
    if (t == 0) {
      float xs, xe;
      solve_root(gf[0], gl[G - 1], xs, xe);
      path_split(gf, gl, G, blockIdx.x, xs, xe);
      xf[0] = xs;
      xl[T - 1] = xe;
    }
  } else if (t == 0) {
    solve_root(lf[0], ll[T - 1], xf[0], xl[T - 1]);
  }
  __syncthreads();

  // Phase C: every chunk's ends, then its interior; x over the rhs slot.
  tree_split(lf, ll, xf, xl, T);
  recover<C, true>(row, xf[t], xl[t], st + (kArrays - 1) * T * kS + t * kS);
  __syncthreads();
  const float* xs = st + (kArrays - 1) * T * kS;
  if constexpr (kFirst) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const int k = 4 * (q * T + t);
      const int i = r0 + k;
      const float* src = xs + (k / C) * kS + k % C;
      if (vec_x && i + 3 < n) {
        *reinterpret_cast<float4*>(x + i) = make_float4(src[0], src[1], src[2], src[3]);
      } else {
        for (int e = 0; e < 4; ++e)
          if (i + e < n) x[i + e] = src[e];
      }
    }
  } else {
    for (int k = t; k < T * C; k += T)
      if (r0 + k < n) x[r0 + k] = xs[(k / C) * kS + k % C];
  }
}

// ---------------------------------------------------------------------------
// The multi-level route: a CTA stages kCtaRows rows (kChunk per thread) in
// shared memory, row i of thread t at t * kStride + i.
// ---------------------------------------------------------------------------
template <bool kFirst>
struct Stage {
  static constexpr int kArrays = kFirst ? 2 : 4;
  float v[kArrays][kChunkThreads * kStride];
};

// Copy the CTA's rows into shared memory, coalesced; rows past n are
// identity rows (row_at).
template <bool kFirst>
__device__ __forceinline__ void stage_rows(Stage<kFirst>& st, const float* counts,
                                           const float* rhs, int unit, Sys in, int n) {
  const int r0 = blockIdx.x * kCtaRows;
  for (int k = threadIdx.x; k < kCtaRows; k += kChunkThreads) {
    const int i = r0 + k;
    const int at = (k / kChunk) * kStride + k % kChunk;
    const bool ok = i < n;
    if constexpr (kFirst) {
      st.v[0][at] = ok ? counts[i] : 0.f;
      st.v[1][at] = ok ? rhs_at(rhs, unit, i, n) : 0.f;
    } else {
      st.v[0][at] = ok ? in.a[i] : 0.f;
      st.v[1][at] = ok ? in.b[i] : 1.f;
      st.v[2][at] = ok ? in.c[i] : 0.f;
      st.v[3][at] = ok ? in.d[i] : 0.f;
    }
  }
}

// Local row k (0 .. kChunk - 1) of this thread's chunk.
template <bool kFirst>
__device__ __forceinline__ Row row_at(const Stage<kFirst>& st, int k, float g, int n, int open) {
  const int at = threadIdx.x * kStride + k;
  const int i = (blockIdx.x * kChunkThreads + threadIdx.x) * kChunk + k;
  if constexpr (kFirst) {
    return first_row(st.v[0][at], st.v[1][at], g, i, n, open);
  } else {
    if (i >= n) return Row{0.f, 1.f, 0.f, 0.f};
    return Row{st.v[0][at], st.v[1][at], st.v[2][at], st.v[3][at]};
  }
}

// Eliminate every chunk's interior: chunk t's first and last rows become
// rows 2t and 2t + 1 of the reduced system `out`.
template <bool kFirst>
__global__ void __launch_bounds__(kChunkThreads)
reduce_kernel(const float* __restrict__ counts, const float* __restrict__ rhs, int unit,
              const float* __restrict__ rho, float s, int open, Sys in, Sys out, int n,
              int chunks) {
  __shared__ Stage<kFirst> st;
  const float g = kFirst ? g_of(rho, s) : 0.f;
  stage_rows<kFirst>(st, counts, rhs, unit, in, n);
  __syncthreads();
  const int t = blockIdx.x * kChunkThreads + threadIdx.x;
  if (t >= chunks) return;
  Row f, l;
  eliminate<kChunk, false>([&](int k) { return row_at<kFirst>(st, k, g, n, open); }, f, l);
  const int o = 2 * t;
  out.a[o] = f.a, out.b[o] = f.b, out.c[o] = f.c, out.d[o] = f.d;
  out.a[o + 1] = l.a, out.b[o + 1] = l.b, out.c[o + 1] = l.c, out.d[o + 1] = l.d;
}

// Recover every chunk's interior from its two end values xr[2t], xr[2t+1]
// (the reduced system's solution); x staged in shared memory for a
// coalesced store of rows < n.
template <bool kFirst>
__global__ void __launch_bounds__(kChunkThreads)
recover_kernel(const float* __restrict__ counts, const float* __restrict__ rhs, int unit,
               const float* __restrict__ rho, float s, int open, Sys in,
               const float* __restrict__ xr, float* __restrict__ x, int n, int chunks) {
  __shared__ Stage<kFirst> st;
  __shared__ float xs[kChunkThreads * kStride];
  const float g = kFirst ? g_of(rho, s) : 0.f;
  stage_rows<kFirst>(st, counts, rhs, unit, in, n);
  __syncthreads();
  const int t = blockIdx.x * kChunkThreads + threadIdx.x;
  if (t < chunks)
    recover<kChunk, false>([&](int k) { return row_at<kFirst>(st, k, g, n, open); }, xr[2 * t],
                           xr[2 * t + 1], xs + threadIdx.x * kStride);
  __syncthreads();
  const int r0 = blockIdx.x * kCtaRows;
  for (int k = threadIdx.x; k < kCtaRows; k += kChunkThreads) {
    const int i = r0 + k;
    if (i < n) x[i] = xs[(k / kChunk) * kStride + k % kChunk];
  }
}

// The sizes of the partition levels: n_0 = n, n_{l+1} = 2 ceil(n_l / kChunk)
// while n_l > kSmall.  Returns the number of levels after the first.
inline int level_sizes(int n, int* sizes) {
  int levels = 0;
  sizes[0] = n;
  while (sizes[levels] > kSmall) {
    const int chunks = (sizes[levels] + kChunk - 1) / kChunk;
    sizes[++levels] = 2 * chunks;
  }
  return levels;
}

constexpr int kMaxLevels = 16;
constexpr int kMaxDevices = 64;

// What the card allows, per device: the segment kernels' shared memory set
// once, the most co-resident CTAs of the C = 16 segment solve.
struct Device {
  bool ready = false;
  int sms = 0, grid16 = 0, coop = 0;
};

template <int C, bool kFirst>
cudaError_t allow_smem(int grid) {
  return cudaFuncSetAttribute(segment_kernel<C, kFirst>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(seg_smem<C, kFirst>(kSegThreads, grid)));
}

inline cudaError_t device_info(Device** out) {
  static Device devices[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Device& d = devices[dev];
  if (!d.ready) {
    int per_sm = 0;
    if ((e = allow_smem<4, true>(kMaxGrid)) != cudaSuccess) return e;
    if ((e = allow_smem<16, true>(kMaxGrid)) != cudaSuccess) return e;
    if ((e = allow_smem<16, false>(1)) != cudaSuccess) return e;
    if ((e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    if ((e = cudaDeviceGetAttribute(&d.coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, segment_kernel<16, true>, kSegThreads,
             seg_smem<16, true>(kSegThreads, kMaxGrid))) != cudaSuccess)
      return e;
    d.grid16 = per_sm * d.sms < kMaxGrid ? per_sm * d.sms : kMaxGrid;
    d.ready = true;
  }
  *out = &d;
  return cudaSuccess;
}

// How the segment solve cuts n rows of R systems: C rows a thread, T
// threads, G segments a system; G = 0 takes the multi-level route.  One
// segment up to kSmall rows; C = 4 (1,024-row segments) while the R G CTAs
// fit one per SM; C = 16 (4,096-row segments) while they can be
// co-resident.
struct Plan {
  int chunk, threads, grid;
};

inline Plan plan(int n, const Device& d, int R = 1) {
  auto threads = [](int rows, int c) {
    const int t = (rows + c - 1) / c;
    return t < 32 ? 32 : (t + 31) / 32 * 32;
  };
  if (n <= 4 * kSegThreads) return Plan{4, threads(n, 4), 1};
  if (n <= kSmall) return Plan{16, threads(n, 16), 1};
  const int g4 = (n + 4 * kSegThreads - 1) / (4 * kSegThreads);
  if (g4 * R <= d.sms && d.coop) return Plan{4, kSegThreads, g4};
  const int g16 = (n + 16 * kSegThreads - 1) / (16 * kSegThreads);
  if (g16 * R <= d.grid16 && d.coop) return Plan{16, kSegThreads, g16};
  return Plan{0, 0, 0};
}

template <int C>
cudaError_t launch_segments(const Plan& p, const float* counts, const float* b,
                            const float* rho, float s, int open, int R, float* x, float* ends,
                            int n, cudaStream_t st) {
  const size_t ptrs = reinterpret_cast<size_t>(counts) | reinterpret_cast<size_t>(b) |
                      reinterpret_cast<size_t>(x);
  const int vec = ptrs % 16 == 0;
  const size_t smem = seg_smem<C, true>(p.threads, p.grid);
  Sys none{};
  if (p.grid == 1) {
    segment_kernel<C, true><<<dim3(1, R), p.threads, smem, st>>>(counts, b, rho, s, open, none,
                                                                 x, ends, n, vec);
    return cudaGetLastError();
  }
  void* args[] = {&counts, &b, &rho, &s, &open, &none, &x, &ends, &n, const_cast<int*>(&vec)};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(segment_kernel<C, true>), dim3(p.grid, R), dim3(p.threads),
      args, smem, st);
  if (e != cudaSuccess) cudaGetLastError();  // leave no error behind for the next launch
  return e;
}

}  // namespace tri
}  // namespace mvtv

namespace mvtv {
namespace tri {

// Floats of scratch for n rows of R systems: 8 a segment, or four system
// arrays and a solution per level after the first (the R systems of the
// multi-level route run one after another on one scratch).
inline long long work_floats(int n, int R, const Device& d) {
  const Plan p = plan(n, d, R);
  if (p.grid > 0) return 8LL * p.grid * R;
  int sizes[kMaxLevels + 1];
  const int levels = level_sizes(n, sizes);
  long long total = 0;
  for (int l = 1; l <= levels; ++l) total += 5LL * sizes[l];
  return total;
}

// The multi-level route for one system (rhs_at's unit).
inline cudaError_t multi_level(const float* counts, const float* b, int unit, const float* rho,
                               float s, int open, float* x, float* work, int n,
                               cudaStream_t st) {
  int sizes[kMaxLevels + 1];
  const int levels = level_sizes(n, sizes);
  if (levels > kMaxLevels) return cudaErrorInvalidValue;
  Sys sys[kMaxLevels + 1] = {};
  float* xl[kMaxLevels + 1] = {};
  float* q = work;
  for (int l = 1; l <= levels; ++l) {
    const int m = sizes[l];
    sys[l] = Sys{q, q + m, q + 2 * m, q + 3 * m};
    xl[l] = q + 4 * m;
    q += 5 * m;
  }
  xl[0] = x;
  cudaError_t err;
  auto chunk_ctas = [](int m) { return (m + kCtaRows - 1) / kCtaRows; };
  // Eliminate down to one CTA's system.
  for (int l = 0; l < levels; ++l) {
    const int chunks = (sizes[l] + kChunk - 1) / kChunk;
    if (l == 0)
      reduce_kernel<true><<<chunk_ctas(sizes[0]), kChunkThreads, 0, st>>>(
          counts, b, unit, rho, s, open, Sys{}, sys[1], sizes[0], chunks);
    else
      reduce_kernel<false><<<chunk_ctas(sizes[l]), kChunkThreads, 0, st>>>(
          nullptr, nullptr, 0, nullptr, 0.f, 0, sys[l], sys[l + 1], sizes[l], chunks);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int m = sizes[levels];
  const int threads = ((m + 15) / 16 + 31) / 32 * 32;
  segment_kernel<16, false><<<1, threads, seg_smem<16, false>(threads, 1), st>>>(
      nullptr, nullptr, nullptr, 0.f, 0, sys[levels], xl[levels], nullptr, m, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // Recover the interiors, level by level back up.
  for (int l = levels - 1; l >= 0; --l) {
    const int chunks = (sizes[l] + kChunk - 1) / kChunk;
    if (l == 0)
      recover_kernel<true><<<chunk_ctas(sizes[0]), kChunkThreads, 0, st>>>(
          counts, b, unit, rho, s, open, Sys{}, xl[1], x, sizes[0], chunks);
    else
      recover_kernel<false><<<chunk_ctas(sizes[l]), kChunkThreads, 0, st>>>(
          nullptr, nullptr, 0, nullptr, 0.f, 0, sys[l], xl[l + 1], xl[l], sizes[l], chunks);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// R = 1: b; R = 3: b, e_0 and e_{n-1} (the segment mode).
inline int solve(const float* counts, const float* b, const float* rho, float s, int open,
                 int R, float* x, float* work, int n, cudaStream_t st) {
  Device* d = nullptr;
  const cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return int(err);
  if (n < 1 || (R != 1 && R != 3) || open < 0 || open > 3) return int(cudaErrorInvalidValue);
  const Plan p = plan(n, *d, R);
  if (p.chunk == 4) return int(launch_segments<4>(p, counts, b, rho, s, open, R, x, work, n, st));
  if (p.chunk == 16)
    return int(launch_segments<16>(p, counts, b, rho, s, open, R, x, work, n, st));
  for (int r = 0; r < R; ++r) {
    const cudaError_t e = multi_level(counts, b, r, rho, s, open, x + size_t(r) * n, work, n, st);
    if (e != cudaSuccess) return int(e);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The partition finish.
// ---------------------------------------------------------------------------
constexpr int kFinishThreads = 256;
constexpr int kMaxRanks = 256;  // 12 W doubles of shared memory: 24 KB

// This rank's two couplings (g x_{k-1}[L], g x_{k+1}[0]) from ends, W rows
// of (y[0], y[L], l[0], l[L], r[0], r[L], rho): the unknowns z[2j] = x_j[0],
// z[2j + 1] = x_j[L] solve z[2j + e] - g l_e z[2j - 1] - g r_e z[2j + 2] =
// y_e (e = 0 the first row, 1 the last; no terms past the chain's ends).
// band: 5 doubles a row, row r's entry of column c at 5 r + c - r + 2; rhs:
// 2 W doubles, overwritten by z.  g (l_e + r_e) <= 1, as A_j's row sums are
// at least g at its open ends, so no pivot is needed.
__device__ void interface_couplings(const float* __restrict__ ends, int W, int k, float s,
                                    double* band, double* rhs, double* out) {
  const int N = 2 * W;
  const double g = double(g_of(ends + 6, s));
  for (int r = 0; r < N; ++r) {
    const int j = r / 2, e = r % 2;
    const float* ej = ends + 7 * j;
    double* b = band + 5 * r;
    b[0] = b[1] = b[3] = b[4] = 0.0;
    b[2] = 1.0;
    if (j > 0) b[1 - e] = -g * double(ej[2 + e]);      // column 2j - 1
    if (j < W - 1) b[4 - e] = -g * double(ej[4 + e]);  // column 2j + 2
    rhs[r] = double(ej[e]);
  }
  for (int r = 0; r < N; ++r) {
    const double* br = band + 5 * r;
    for (int i = 1; i <= 2 && r + i < N; ++i) {
      double* bi = band + 5 * (r + i);
      const double f = bi[2 - i] / br[2];
      for (int c = 0; c <= 2; ++c) bi[2 - i + c] -= f * br[2 + c];
      rhs[r + i] -= f * rhs[r];
    }
  }
  for (int r = N - 1; r >= 0; --r) {
    double v = rhs[r];
    for (int c = 1; c <= 2 && r + c < N; ++c) v -= band[5 * r + 2 + c] * rhs[r + c];
    rhs[r] = v / band[5 * r + 2];
  }
  out[0] = k > 0 ? g * rhs[2 * k - 1] : 0.0;
  out[1] = k < W - 1 ? g * rhs[2 * k + 2] : 0.0;
}

// x = y + cl l + cr r over this rank's n rows (ylr: 3 rows of n), the
// couplings rounded to float once and the sums in torch's order, unfused.
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(const float* __restrict__ ends, int W, int k, float s,
              const float* __restrict__ ylr, float* __restrict__ x, int n) {
  extern __shared__ double fin_sm[];
  __shared__ float cpl[2];
  if (threadIdx.x == 0) {
    double out[2];
    interface_couplings(ends, W, k, s, fin_sm, fin_sm + 10 * W, out);
    cpl[0] = float(out[0]);
    cpl[1] = float(out[1]);
  }
  __syncthreads();
  const float cl = cpl[0], cr = cpl[1];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    x[i] = __fadd_rn(__fadd_rn(ylr[i], __fmul_rn(cl, ylr[n + i])),
                     __fmul_rn(cr, ylr[2 * size_t(n) + i]));
}

}  // namespace tri
}  // namespace mvtv

// Floats of scratch xupdate_tridiag needs for n rows on the current
// device: 8 a segment, or four system arrays and a solution per level
// after the first; negative (a cudaError) if the device cannot be read.
extern "C" long long mvtv_xupdate_tridiag_work(int n) {
  using namespace mvtv::tri;
  Device* d = nullptr;
  const cudaError_t e = device_info(&d);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  return work_floats(n, 1, *d);
}

// T1 entry point: x = (diag(counts) + g T)^{-1} b, g = (*rho s) s, n rows;
// work holds mvtv_xupdate_tridiag_work(n) floats.
extern "C" int mvtv_xupdate_tridiag(const float* counts, const float* b, const float* rho,
                                    float s, float* x, float* work, int n, void* stream) {
  return mvtv::tri::solve(counts, b, rho, s, 0, 1, x, work, n,
                          static_cast<cudaStream_t>(stream));
}

// The segment mode's scratch for n rows (three systems), as
// mvtv_xupdate_tridiag_work's.
extern "C" long long mvtv_xupdate_tridiag_segment_work(int n) {
  using namespace mvtv::tri;
  Device* d = nullptr;
  const cudaError_t e = device_info(&d);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  return work_floats(n, 3, *d);
}

// T1 in its segment mode: x (3 rows of n) with the segment's system
// (diag(counts) + g T_open) x_r = rhs_r for rhs_0 = b, rhs_1 = e_0 and
// rhs_2 = e_{n-1}, T_open keeping the diagonal 2 at the ends `open` marks
// (bit 0 the first row, bit 1 the last).  One launch while the segment
// solve holds the three systems.
extern "C" int mvtv_xupdate_tridiag_segment(const float* counts, const float* b,
                                            const float* rho, float s, int open, float* x,
                                            float* work, int n, void* stream) {
  return mvtv::tri::solve(counts, b, rho, s, open, 3, x, work, n,
                          static_cast<cudaStream_t>(stream));
}

// The partition finish on rank `rank` of W: x (n) from ends (W rows of 7
// floats, every rank's segment ends and rho, gathered) and this rank's
// segment solve ylr (3 rows of n).  One launch.
extern "C" int mvtv_partition_finish(const float* ends, int W, int rank, float s,
                                     const float* ylr, float* x, int n, void* stream) {
  using namespace mvtv::tri;
  if (W < 1 || W > kMaxRanks || rank < 0 || rank >= W || n < 1)
    return int(cudaErrorInvalidValue);
  const int blocks = (n + kFinishThreads - 1) / kFinishThreads;
  finish_kernel<<<blocks < 1024 ? blocks : 1024, kFinishThreads, sizeof(double) * 12 * W,
                  static_cast<cudaStream_t>(stream)>>>(ends, W, rank, s, ylr, x, n);
  return int(cudaGetLastError());
}
