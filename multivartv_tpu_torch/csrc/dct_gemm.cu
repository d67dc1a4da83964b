// The folded (packed) 2-D DCT-II and its inverse as bf16-operand,
// float32-accumulate products.
//
// Replaces the in-kernel transforms of multivartv_tpu/ops/pallas_kernels.py:
// _xupdate_kernel_packed and _admm_chain (B3, B4), i.e. ops/dct.py:
// dct2_packed / idct2_packed with mat_dtype = bf16.  Per axis the fold
// s = top + flip(bottom), d = top - flip(bottom) splits the dense product
// into two half-size products; the spectrum comes out in packed order.
// Operands are rounded to bf16 at exactly the JAX package's points (the
// axis-0 folds, the axis-1 folds of the first-axis result, the even/odd
// halves ye/yo and xe/xo of the inverse).  The flip is an index reversal:
// the JAX kernels' exchange-matrix product, which rounds the flipped half
// to bf16, is a TPU workaround.  bf16 x bf16 products are exact in float32,
// so this computes a.bfloat16().float() @ b.bfloat16().float() up to the
// order of the float32 sums.
//
// Bound on the H100: arithmetic.  One transform of an m x m lattice is 4
// products of m/2 x m x m/2 with two accumulators: m^3 multiply-adds, 0.27
// GFLOP at 512^2, and the x-update runs six per iteration.  This is a
// shared-memory SIMT GEMM (float32 FMA on bf16-rounded values, 32 x 32
// tiles, 2 x 2 outputs per thread and accumulator): simple and right, far
// from the tensor cores.  The folds and flips ride in the tile loaders and
// the +/- recombination in the epilogue, so no folded operand is stored.
// B6's dense (unfolded) transforms run on the tensor cores (dct_mma.cu);
// moving these folded ones onto that product, and then onto wgmma, is the
// next step for B3-B5.
#include "common.cuh"

namespace mvtv {

constexpr int BM = 32, BN = 32, BK = 32;
constexpr int kGemmThreads = 256;  // 16 x 16, 2 x 2 outputs each

__device__ __forceinline__ float bf(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// Each product op computes C1 = A1 B1 and C2 = A2 B2 over one (i, n) tile:
// load_a(i, k) gives (A1, A2)[i, k], load_b(k, n) gives (B1, B2)[k, n],
// store(i, n, c1, c2) writes the output.  A_K_FAST / B_K_FAST say which
// index is contiguous in memory, to pick coalesced tile loads.  at(off,
// soff) is the op of the batch's problem whose lattices start at off and
// whose scalar row starts at soff; the DCT matrices are shared.

// tmp[f, n] = (Te0 @ S0)[f, n], tmp[h0 + f, n] = (To0 @ D0)[f, n];
// S0/D0 = bf16(v[k] +/- v[m0-1-k]).
struct FwdAxis0 {
  static constexpr bool A_K_FAST = true, B_K_FAST = false;
  const float* v;
  const __nv_bfloat16 *te, *to;
  float* out;
  int m0, m1, h0;
  __device__ FwdAxis0 at(size_t off, size_t) const {
    FwdAxis0 o = *this;
    o.v += off;
    o.out += off;
    return o;
  }
  __device__ void load_a(int i, int k, float& a1, float& a2) const {
    a1 = bf(te, size_t(i) * h0 + k);
    a2 = bf(to, size_t(i) * h0 + k);
  }
  __device__ void load_b(int k, int n, float& b1, float& b2) const {
    const float top = v[size_t(k) * m1 + n], bot = v[size_t(m0 - 1 - k) * m1 + n];
    b1 = bf16_round(top + bot);
    b2 = bf16_round(top - bot);
  }
  __device__ void store(int i, int n, float c1, float c2) const {
    out[size_t(i) * m1 + n] = c1;
    out[size_t(h0 + i) * m1 + n] = c2;
  }
};

// out[i, f] = (S1 @ Te1^T)[i, f], out[i, h1 + f] = (D1 @ To1^T)[i, f];
// S1/D1 = bf16(tmp[:, k] +/- tmp[:, m1-1-k]).
struct FwdAxis1 {
  static constexpr bool A_K_FAST = true, B_K_FAST = true;
  const float* tmp;
  const __nv_bfloat16 *te, *to;
  float* out;
  int m1, h1;
  __device__ FwdAxis1 at(size_t off, size_t) const {
    FwdAxis1 o = *this;
    o.tmp += off;
    o.out += off;
    return o;
  }
  __device__ void load_a(int i, int k, float& a1, float& a2) const {
    const float left = tmp[size_t(i) * m1 + k], right = tmp[size_t(i) * m1 + (m1 - 1 - k)];
    a1 = bf16_round(left + right);
    a2 = bf16_round(left - right);
  }
  __device__ void load_b(int k, int n, float& b1, float& b2) const {
    b1 = bf(te, size_t(n) * h1 + k);
    b2 = bf(to, size_t(n) * h1 + k);
  }
  __device__ void store(int i, int n, float c1, float c2) const {
    out[size_t(i) * m1 + n] = c1;
    out[size_t(i) * m1 + h1 + n] = c2;
  }
};

// a = Te0^T bf16(y[:h0]), b = To0^T bf16(y[h0:]);
// x[i] = a[i] + b[i], x[m0-1-i] = a[i] - b[i].
struct InvAxis0 {
  static constexpr bool A_K_FAST = false, B_K_FAST = false;
  const float* y;
  const __nv_bfloat16 *te, *to;
  float* out;
  int m0, m1, h0;
  __device__ InvAxis0 at(size_t off, size_t) const {
    InvAxis0 o = *this;
    o.y += off;
    o.out += off;
    return o;
  }
  __device__ void load_a(int i, int k, float& a1, float& a2) const {
    a1 = bf(te, size_t(k) * h0 + i);
    a2 = bf(to, size_t(k) * h0 + i);
  }
  __device__ void load_b(int k, int n, float& b1, float& b2) const {
    b1 = bf16_round(y[size_t(k) * m1 + n]);
    b2 = bf16_round(y[size_t(h0 + k) * m1 + n]);
  }
  __device__ void store(int i, int n, float c1, float c2) const {
    out[size_t(i) * m1 + n] = c1 + c2;
    out[size_t(m0 - 1 - i) * m1 + n] = c1 - c2;
  }
};

// aa = bf16(x[:, :h1]) Te1, bb = bf16(x[:, h1:]) To1;
// out[:, n] = aa + bb, out[:, m1-1-n] = aa - bb, optionally + beta * out.
struct InvAxis1 {
  static constexpr bool A_K_FAST = true, B_K_FAST = false;
  const float* x;
  const __nv_bfloat16 *te, *to;
  float* out;
  const float* scal;
  int m1, h1, rz_new, rz_old;
  __device__ InvAxis1 at(size_t off, size_t soff) const {
    InvAxis1 o = *this;
    o.x += off;
    o.out += off;
    o.scal += soff;
    return o;
  }
  __device__ void load_a(int i, int k, float& a1, float& a2) const {
    a1 = bf16_round(x[size_t(i) * m1 + k]);
    a2 = bf16_round(x[size_t(i) * m1 + h1 + k]);
  }
  __device__ void load_b(int k, int n, float& b1, float& b2) const {
    b1 = bf(te, size_t(k) * h1 + n);
    b2 = bf(to, size_t(k) * h1 + n);
  }
  __device__ void store(int i, int n, float c1, float c2) const {
    const size_t lo = size_t(i) * m1 + n, hi = size_t(i) * m1 + (m1 - 1 - n);
    if (rz_new < 0) {
      out[lo] = c1 + c2;
      out[hi] = c1 - c2;
    } else {  // CG direction update p = z + beta p
      const float beta = scal[rz_new] / nan_max(scal[rz_old], kEps);
      out[lo] = (c1 + c2) + beta * out[lo];
      out[hi] = (c1 - c2) + beta * out[hi];
    }
  }
};

// kBatched = false is the single-problem launch (B = 1, no activity mask):
// the batch offsets compile away.  With them the GEMM used up to 21 more
// registers and B3/B4 ran 5 % slower at 512^2 on the H100 (PERF.md).
template <class Op, bool kBatched>
__global__ void __launch_bounds__(kGemmThreads)
dual_gemm_kernel(Op op_b0, int M, int N, int K, Batch bt, size_t lat) {
  __shared__ float As1[BK][BM], As2[BK][BM], Bs1[BK][BN], Bs2[BK][BN];
  if (kBatched && frozen(bt)) return;
  const Op op = kBatched ? op_b0.at(size_t(blockIdx.z) * lat, scal_offset(bt)) : op_b0;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc1[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, acc2[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int q = 0; q < (BM * BK) / kGemmThreads; ++q) {
      const int e = tid + q * kGemmThreads;
      const int ii = Op::A_K_FAST ? e / BK : e % BM;
      const int kk = Op::A_K_FAST ? e % BK : e / BM;
      float a1 = 0.f, a2 = 0.f;
      if (row0 + ii < M && k0 + kk < K) op.load_a(row0 + ii, k0 + kk, a1, a2);
      As1[kk][ii] = a1;
      As2[kk][ii] = a2;
    }
#pragma unroll
    for (int q = 0; q < (BK * BN) / kGemmThreads; ++q) {
      const int e = tid + q * kGemmThreads;
      const int nn = Op::B_K_FAST ? e / BK : e % BN;
      const int kk = Op::B_K_FAST ? e % BK : e / BN;
      float b1 = 0.f, b2 = 0.f;
      if (k0 + kk < K && col0 + nn < N) op.load_b(k0 + kk, col0 + nn, b1, b2);
      Bs1[kk][nn] = b1;
      Bs2[kk][nn] = b2;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float a1[2] = {As1[kk][ty], As1[kk][ty + 16]};
      const float b1[2] = {Bs1[kk][tx], Bs1[kk][tx + 16]};
      const float a2[2] = {As2[kk][ty], As2[kk][ty + 16]};
      const float b2[2] = {Bs2[kk][tx], Bs2[kk][tx + 16]};
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          acc1[r][c] += a1[r] * b1[c];
          acc2[r][c] += a2[r] * b2[c];
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int gi = row0 + ty + 16 * r, gn = col0 + tx + 16 * c;
      if (gi < M && gn < N) op.store(gi, gn, acc1[r][c], acc2[r][c]);
    }
}

template <class Op>
int launch_gemm(const Op& op, int M, int N, int K, Lat L, Batch bt, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, bt.B);
  if (bt.B == 1 && bt.act == nullptr)
    dual_gemm_kernel<Op, false><<<grid, kGemmThreads, 0, s>>>(op, M, N, K, bt, 0);
  else
    dual_gemm_kernel<Op, true><<<grid, kGemmThreads, 0, s>>>(op, M, N, K, bt,
                                                             size_t(L.m0) * L.m1);
  MVTV_LAUNCHED();
  return 0;
}

int launch_dct2_packed(const float* v, Halves hv, float* tmp, float* out, Lat L, Batch bt,
                       cudaStream_t s) {
  const int h0 = L.m0 / 2, h1 = L.m1 / 2;
  MVTV_CHECK(launch_gemm(FwdAxis0{v, hv.te0, hv.to0, tmp, L.m0, L.m1, h0}, h0, L.m1, h0, L, bt,
                         s));
  MVTV_CHECK(launch_gemm(FwdAxis1{tmp, hv.te1, hv.to1, out, L.m1, h1}, L.m0, h1, h1, L, bt, s));
  return 0;
}

int launch_idct2_packed(const float* y, Halves hv, float* tmp, float* out, const float* scal,
                        int rz_new, int rz_old, Lat L, Batch bt, cudaStream_t s) {
  const int h0 = L.m0 / 2, h1 = L.m1 / 2;
  MVTV_CHECK(launch_gemm(InvAxis0{y, hv.te0, hv.to0, tmp, L.m0, L.m1, h0}, h0, L.m1, h0, L, bt,
                         s));
  MVTV_CHECK(launch_gemm(InvAxis1{tmp, hv.te1, hv.to1, out, scal, L.m1, h1, rz_new, rz_old},
                         L.m0, h1, h1, L, bt, s));
  return 0;
}

}  // namespace mvtv
