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
// positive pivots and needs no pivoting.
//   * n <= kSmall (4,096; every default p = 1 mesh up to N ~ 1.6e7): one CTA
//     holds the whole system in shared memory and runs parallel cyclic
//     reduction (PCR), log2(n) steps with every row updated in each, then
//     x = d / b.  One launch.
//   * larger n (the fused lasso, m = N): a partition solve.  Each thread
//     owns a chunk of kChunk = 32 consecutive rows (staged through shared
//     memory for coalesced loads) and eliminates its interior with two
//     Thomas sweeps, one from each end, leaving the chunk's first and last
//     rows as rows of a reduced tridiagonal system of 2 n / 32 rows (the
//     Schur complement of the interiors, again symmetric positive
//     definite).  The reduced system is solved the same way until it fits
//     one CTA (PCR), then each level's interiors are recovered by a Thomas
//     solve between the chunk's two known end values, re-reading its rows
//     rather than storing elimination coefficients.  At n = 2^20: reduce,
//     reduce, PCR on 4,096 rows, recover, recover: 5 launches, deterministic
//     (no atomics), so a run repeats bit for bit.
#include <cuda_runtime.h>

namespace mvtv {
namespace tri {

constexpr int kSmall = 4096;        // largest system one CTA solves by PCR
constexpr int kPcrThreads = 1024;   // kSmall / kPcrThreads rows a thread
constexpr int kPcrRows = kSmall / kPcrThreads;
constexpr int kChunk = 32;          // rows a thread eliminates
constexpr int kChunkThreads = 64;   // threads of a reduce or recover CTA
constexpr int kCtaRows = kChunk * kChunkThreads;
constexpr int kStride = kChunk + 1;  // staged row stride: conflict-free banks

struct Row {
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

// ---------------------------------------------------------------------------
// One CTA: PCR on n <= kSmall rows in shared memory.
// ---------------------------------------------------------------------------
template <bool kFirst>
__global__ void __launch_bounds__(kPcrThreads)
pcr_kernel(const float* __restrict__ counts, const float* __restrict__ rhs,
           const float* __restrict__ rho, float s, Sys in, float* __restrict__ x, int n) {
  extern __shared__ float sm[];
  float *sa = sm, *sb = sm + n, *sc = sm + 2 * n, *sd = sm + 3 * n;
  const float g = kFirst ? g_of(rho, s) : 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    Row r;
    if constexpr (kFirst)
      r = first_row(counts[i], rhs[i], g, i, n);
    else
      r = Row{in.a[i], in.b[i], in.c[i], in.d[i]};
    sa[i] = r.a;
    sb[i] = r.b;
    sc[i] = r.c;
    sd[i] = r.d;
  }
  __syncthreads();
  for (int st = 1; st < n; st <<= 1) {
    Row nw[kPcrRows];
#pragma unroll
    for (int q = 0; q < kPcrRows; ++q) {
      const int i = threadIdx.x + q * blockDim.x;
      if (i >= n) break;
      const float ai = sa[i], ci = sc[i];
      float b = sb[i], d = sd[i], a = 0.f, c = 0.f;
      if (i - st >= 0) {
        const int j = i - st;
        const float alpha = -ai / sb[j];
        b += alpha * sc[j];
        d += alpha * sd[j];
        a = alpha * sa[j];
      }
      if (i + st < n) {
        const int j = i + st;
        const float gamma = -ci / sb[j];
        b += gamma * sa[j];
        d += gamma * sd[j];
        c = gamma * sc[j];
      }
      nw[q] = Row{a, b, c, d};
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPcrRows; ++q) {
      const int i = threadIdx.x + q * blockDim.x;
      if (i >= n) break;
      sa[i] = nw[q].a;
      sb[i] = nw[q].b;
      sc[i] = nw[q].c;
      sd[i] = nw[q].d;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[i] = sd[i] / sb[i];
}

// ---------------------------------------------------------------------------
// The partition solve: a CTA stages kCtaRows rows (kChunk per thread) in
// shared memory, row i of thread t at t * kStride + i.
// ---------------------------------------------------------------------------
template <bool kFirst>
struct Stage {
  static constexpr int kArrays = kFirst ? 2 : 4;
  float v[kArrays][kChunkThreads * kStride];
};

// Copy the CTA's rows into shared memory, coalesced; rows past n read as
// zeros and are made identity rows by row_at.
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
// rows 2t and 2t + 1 of the reduced system `out` (the Schur complement of
// the interior rows 1 .. kChunk - 2).
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
  // Top-down: A x_0 + x_i + C x_{i+1} = D for i = 1 .. kChunk - 2.
  Row r = row_at<kFirst>(st, 1, g, n);
  float A = r.a / r.b, C = r.c / r.b, D = r.d / r.b;
#pragma unroll
  for (int k = 2; k <= kChunk - 2; ++k) {
    r = row_at<kFirst>(st, k, g, n);
    const float inv = 1.f / (r.b - r.a * C);
    A = -r.a * A * inv;
    D = (r.d - r.a * D) * inv;
    C = r.c * inv;
  }
  const Row last = row_at<kFirst>(st, kChunk - 1, g, n);
  // Bottom-up: A' x_{i-1} + x_i + C' x_{kChunk-1} = D' for i = kChunk - 2 .. 1.
  r = row_at<kFirst>(st, kChunk - 2, g, n);
  float Ap = r.a / r.b, Cp = r.c / r.b, Dp = r.d / r.b;
#pragma unroll
  for (int k = kChunk - 3; k >= 1; --k) {
    r = row_at<kFirst>(st, k, g, n);
    const float inv = 1.f / (r.b - r.c * Ap);
    Ap = r.a * inv;
    Cp = -r.c * Cp * inv;
    Dp = (r.d - r.c * Dp) * inv;
  }
  const Row first = row_at<kFirst>(st, 0, g, n);
  const int o = 2 * t;
  out.a[o] = first.a;
  out.b[o] = first.b - first.c * Ap;
  out.c[o] = -first.c * Cp;
  out.d[o] = first.d - first.c * Dp;
  out.a[o + 1] = -last.a * A;
  out.b[o + 1] = last.b - last.a * C;
  out.c[o + 1] = last.c;
  out.d[o + 1] = last.d - last.a * D;
}

// Recover every chunk's interior from its two end values xr[2t], xr[2t+1]
// (the reduced system's solution): a Thomas solve of rows 1 .. kChunk - 2
// with those values moved to the right-hand side; x staged in shared memory
// for a coalesced store of rows < n.
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
  if (t < chunks) {
    const float x0 = xr[2 * t], xl = xr[2 * t + 1];
    float cp[kChunk], dp[kChunk];
    float cprev = 0.f, dprev = 0.f;
#pragma unroll
    for (int k = 1; k <= kChunk - 2; ++k) {
      const Row r = row_at<kFirst>(st, k, g, n);
      float a = r.a, c = r.c, d = r.d;
      if (k == 1) {
        d -= a * x0;
        a = 0.f;
      }
      if (k == kChunk - 2) {
        d -= c * xl;
        c = 0.f;
      }
      const float inv = 1.f / (r.b - a * cprev);
      cp[k] = c * inv;
      dp[k] = (d - a * dprev) * inv;
      cprev = cp[k];
      dprev = dp[k];
    }
    float* mine = xs + threadIdx.x * kStride;
    mine[0] = x0;
    mine[kChunk - 1] = xl;
    float nxt = dp[kChunk - 2];
    mine[kChunk - 2] = nxt;
#pragma unroll
    for (int k = kChunk - 3; k >= 1; --k) {
      nxt = dp[k] - cp[k] * nxt;
      mine[k] = nxt;
    }
  }
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

}  // namespace tri
}  // namespace mvtv

// Floats of scratch xupdate_tridiag needs for n rows: four system arrays
// and a solution per level after the first.
extern "C" long long mvtv_xupdate_tridiag_work(int n) {
  using namespace mvtv::tri;
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
  static bool configured = false;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!configured) {
    const int bytes = 4 * kSmall * int(sizeof(float));
    cudaError_t e =
        cudaFuncSetAttribute(pcr_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(pcr_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (e != cudaSuccess) return int(e);
    configured = true;
  }
  int sizes[kMaxLevels + 1];
  const int levels = level_sizes(n, sizes);
  if (levels > kMaxLevels) return int(cudaErrorInvalidValue);
  Sys sys[kMaxLevels + 1] = {};
  float* xl[kMaxLevels + 1] = {};
  float* p = work;
  for (int l = 1; l <= levels; ++l) {
    const int m = sizes[l];
    sys[l] = Sys{p, p + m, p + 2 * m, p + 3 * m};
    xl[l] = p + 4 * m;
    p += 5 * m;
  }
  xl[0] = x;
  auto pcr_threads = [](int m) {
    const int t = (m + kPcrRows - 1) / kPcrRows;
    return t < 32 ? 32 : ((t + 31) / 32) * 32;
  };
  auto chunk_ctas = [](int m) { return (m + kCtaRows - 1) / kCtaRows; };
  const int top = levels;
  const size_t pcr_bytes = 4 * size_t(sizes[top]) * sizeof(float);
  cudaError_t err;
  // Eliminate down to one CTA's system.
  for (int l = 0; l < top; ++l) {
    const int chunks = (sizes[l] + kChunk - 1) / kChunk;
    if (l == 0)
      reduce_kernel<true><<<chunk_ctas(sizes[0]), kChunkThreads, 0, st>>>(
          counts, b, rho, s, Sys{}, sys[1], sizes[0], chunks);
    else
      reduce_kernel<false><<<chunk_ctas(sizes[l]), kChunkThreads, 0, st>>>(
          nullptr, nullptr, nullptr, 0.f, sys[l], sys[l + 1], sizes[l], chunks);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  if (top == 0)
    pcr_kernel<true><<<1, pcr_threads(n), pcr_bytes, st>>>(counts, b, rho, s, Sys{}, x, n);
  else
    pcr_kernel<false><<<1, pcr_threads(sizes[top]), pcr_bytes, st>>>(
        nullptr, nullptr, nullptr, 0.f, sys[top], xl[top], sizes[top]);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  // Recover the interiors, level by level back up.
  for (int l = top - 1; l >= 0; --l) {
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
