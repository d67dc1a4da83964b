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
// decoupled identity rows.  g t is exact for t in {0, 1, 2}.
__device__ __forceinline__ Row first_row(float cnt, float rhs, float g, int i, int n) {
  if (i >= n) return Row{0.f, 1.f, 0.f, 0.f};
  float t = 2.f;
  if (i == 0) t -= 1.f;
  if (i == n - 1) t -= 1.f;
  return Row{i > 0 ? -g : 0.f, cnt + g * t, i < n - 1 ? -g : 0.f, rhs};
}

__device__ __forceinline__ float g_of(const float* rho, float s) { return (*rho * s) * s; }

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
// loads and stores where vec).  Otherwise the rows of `in` (G = 1), x to x.
// ends: 8 floats a segment (G > 1: launched cooperatively).
template <int C, bool kFirst>
__global__ void __launch_bounds__(kSegThreads, 3)
segment_kernel(const float* __restrict__ counts, const float* __restrict__ rhs,
               const float* __restrict__ rho, float s, Sys in, float* __restrict__ x,
               float* __restrict__ ends, int n, int vec) {
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

  // Phase A: stage the segment (C / 4 float4s of each array a thread).
  if constexpr (kFirst) {
    float4 cv[C / 4], bv[C / 4];
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const int k = 4 * (q * T + t);
      cv[q] = load4(counts, r0 + k, n, vec);
      bv[q] = load4(rhs, r0 + k, n, vec);
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
      return first_row(mine[k], mine[T * kS + k], g, i, n);
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
      if (vec && i + 3 < n) {
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
                                           const float* rhs, Sys in, int n) {
  const int r0 = blockIdx.x * kCtaRows;
  for (int k = threadIdx.x; k < kCtaRows; k += kChunkThreads) {
    const int i = r0 + k;
    const int at = (k / kChunk) * kStride + k % kChunk;
    const bool ok = i < n;
    if constexpr (kFirst) {
      st.v[0][at] = ok ? counts[i] : 0.f;
      st.v[1][at] = ok ? rhs[i] : 0.f;
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
__device__ __forceinline__ Row row_at(const Stage<kFirst>& st, int k, float g, int n) {
  const int at = threadIdx.x * kStride + k;
  const int i = (blockIdx.x * kChunkThreads + threadIdx.x) * kChunk + k;
  if constexpr (kFirst) {
    return first_row(st.v[0][at], st.v[1][at], g, i, n);
  } else {
    if (i >= n) return Row{0.f, 1.f, 0.f, 0.f};
    return Row{st.v[0][at], st.v[1][at], st.v[2][at], st.v[3][at]};
  }
}

// Eliminate every chunk's interior: chunk t's first and last rows become
// rows 2t and 2t + 1 of the reduced system `out`.
template <bool kFirst>
__global__ void __launch_bounds__(kChunkThreads)
reduce_kernel(const float* __restrict__ counts, const float* __restrict__ rhs,
              const float* __restrict__ rho, float s, Sys in, Sys out, int n, int chunks) {
  __shared__ Stage<kFirst> st;
  const float g = kFirst ? g_of(rho, s) : 0.f;
  stage_rows<kFirst>(st, counts, rhs, in, n);
  __syncthreads();
  const int t = blockIdx.x * kChunkThreads + threadIdx.x;
  if (t >= chunks) return;
  Row f, l;
  eliminate<kChunk, false>([&](int k) { return row_at<kFirst>(st, k, g, n); }, f, l);
  const int o = 2 * t;
  out.a[o] = f.a, out.b[o] = f.b, out.c[o] = f.c, out.d[o] = f.d;
  out.a[o + 1] = l.a, out.b[o + 1] = l.b, out.c[o + 1] = l.c, out.d[o + 1] = l.d;
}

// Recover every chunk's interior from its two end values xr[2t], xr[2t+1]
// (the reduced system's solution); x staged in shared memory for a
// coalesced store of rows < n.
template <bool kFirst>
__global__ void __launch_bounds__(kChunkThreads)
recover_kernel(const float* __restrict__ counts, const float* __restrict__ rhs,
               const float* __restrict__ rho, float s, Sys in, const float* __restrict__ xr,
               float* __restrict__ x, int n, int chunks) {
  __shared__ Stage<kFirst> st;
  __shared__ float xs[kChunkThreads * kStride];
  const float g = kFirst ? g_of(rho, s) : 0.f;
  stage_rows<kFirst>(st, counts, rhs, in, n);
  __syncthreads();
  const int t = blockIdx.x * kChunkThreads + threadIdx.x;
  if (t < chunks)
    recover<kChunk, false>([&](int k) { return row_at<kFirst>(st, k, g, n); }, xr[2 * t],
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

// How the segment solve cuts n rows: C rows a thread, T threads, G
// segments; G = 0 takes the multi-level route.  One segment up to kSmall
// rows; C = 4 (1,024-row segments) while G fits one CTA per SM; C = 16
// (4,096-row segments) while G CTAs can be co-resident.
struct Plan {
  int chunk, threads, grid;
};

inline Plan plan(int n, const Device& d) {
  auto threads = [](int rows, int c) {
    const int t = (rows + c - 1) / c;
    return t < 32 ? 32 : (t + 31) / 32 * 32;
  };
  if (n <= 4 * kSegThreads) return Plan{4, threads(n, 4), 1};
  if (n <= kSmall) return Plan{16, threads(n, 16), 1};
  const int g4 = (n + 4 * kSegThreads - 1) / (4 * kSegThreads);
  if (g4 <= d.sms && d.coop) return Plan{4, kSegThreads, g4};
  const int g16 = (n + 16 * kSegThreads - 1) / (16 * kSegThreads);
  if (g16 <= d.grid16 && d.coop) return Plan{16, kSegThreads, g16};
  return Plan{0, 0, 0};
}

template <int C>
cudaError_t launch_segments(const Plan& p, const float* counts, const float* b, const float* rho,
                            float s, float* x, float* ends, int n, cudaStream_t st) {
  const int vec = ((reinterpret_cast<size_t>(counts) | reinterpret_cast<size_t>(b) |
                    reinterpret_cast<size_t>(x)) % 16) == 0;
  const size_t smem = seg_smem<C, true>(p.threads, p.grid);
  Sys none{};
  if (p.grid == 1) {
    segment_kernel<C, true><<<1, p.threads, smem, st>>>(counts, b, rho, s, none, x, ends, n, vec);
    return cudaGetLastError();
  }
  void* args[] = {&counts, &b, &rho, &s, &none, &x, &ends, &n, const_cast<int*>(&vec)};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(segment_kernel<C, true>), dim3(p.grid), dim3(p.threads),
      args, smem, st);
  if (e != cudaSuccess) cudaGetLastError();  // leave no error behind for the next launch
  return e;
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
  const Plan p = plan(n, *d);
  if (p.grid > 0) return 8LL * p.grid;
  int sizes[kMaxLevels + 1];
  const int levels = level_sizes(n, sizes);
  long long total = 0;
  for (int l = 1; l <= levels; ++l) total += 5LL * sizes[l];
  return total;
}

// T1 entry point: x = (diag(counts) + g T)^{-1} b, g = (*rho s) s, n rows;
// work holds mvtv_xupdate_tridiag_work(n) floats.
extern "C" int mvtv_xupdate_tridiag(const float* counts, const float* b, const float* rho,
                                    float s, float* x, float* work, int n, void* stream) {
  using namespace mvtv::tri;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Device* d = nullptr;
  cudaError_t err = device_info(&d);
  if (err != cudaSuccess) return int(err);
  const Plan p = plan(n, *d);
  if (p.chunk == 4) return int(launch_segments<4>(p, counts, b, rho, s, x, work, n, st));
  if (p.chunk == 16) return int(launch_segments<16>(p, counts, b, rho, s, x, work, n, st));

  // The multi-level route.
  int sizes[kMaxLevels + 1];
  const int levels = level_sizes(n, sizes);
  if (levels > kMaxLevels) return int(cudaErrorInvalidValue);
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
  auto chunk_ctas = [](int m) { return (m + kCtaRows - 1) / kCtaRows; };
  // Eliminate down to one CTA's system.
  for (int l = 0; l < levels; ++l) {
    const int chunks = (sizes[l] + kChunk - 1) / kChunk;
    if (l == 0)
      reduce_kernel<true><<<chunk_ctas(sizes[0]), kChunkThreads, 0, st>>>(
          counts, b, rho, s, Sys{}, sys[1], sizes[0], chunks);
    else
      reduce_kernel<false><<<chunk_ctas(sizes[l]), kChunkThreads, 0, st>>>(
          nullptr, nullptr, nullptr, 0.f, sys[l], sys[l + 1], sizes[l], chunks);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  const int m = sizes[levels];
  const int threads = ((m + 15) / 16 + 31) / 32 * 32;
  segment_kernel<16, false><<<1, threads, seg_smem<16, false>(threads, 1), st>>>(
      nullptr, nullptr, nullptr, 0.f, sys[levels], xl[levels], nullptr, m, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  // Recover the interiors, level by level back up.
  for (int l = levels - 1; l >= 0; --l) {
    const int chunks = (sizes[l] + kChunk - 1) / kChunk;
    if (l == 0)
      recover_kernel<true><<<chunk_ctas(sizes[0]), kChunkThreads, 0, st>>>(
          counts, b, rho, s, Sys{}, xl[1], x, sizes[0], chunks);
    else
      recover_kernel<false><<<chunk_ctas(sizes[l]), kChunkThreads, 0, st>>>(
          nullptr, nullptr, nullptr, 0.f, sys[l], xl[l + 1], xl[l], sizes[l], chunks);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  return 0;
}
