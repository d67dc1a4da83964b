// The dense 2-D DCT-II and its inverse of B6 on the tensor cores: bf16
// operands, float32 accumulation, mma.sync.m16n8k16 from ldmatrix.
//
// Replaces the in-kernel transforms of multivartv_tpu/ops/pallas_kernels.py:
// _xupdate_kernel (xupdate_pcg_2d, B6; dct2/idct2 at :354-370), which run
// where an axis is odd and no folded halves exist.  Four products, each
// C = A B with operands rounded to bf16 at the JAX kernel's points:
//   forward  tmp = T0 bf16(v),     out = bf16(tmp) T1'
//   inverse  tmp = T0' bf16(y),    out = bf16(tmp) T1  (+ beta out: p = z + beta p)
// bf16 x bf16 products are exact in float32, so each product is
// a.bfloat16().float() @ b.bfloat16().float() up to the order of the float32
// sums (the tensor cores sum a k16 slice in their own order).
//
// Bound on the H100: the tensor cores.  One forward-inverse pair on an
// m0 x m1 lattice is 2 m0 m1 (m0 + m1) multiply-adds, 8.6 GFLOP at 1023^2,
// and B6 runs three (one per preconditioner solve): 25.7 GFLOP, 0.026 ms at
// the published 989 TFLOP/s.  Every operand lives in the 50 MB L2 (the
// lattices are 4 MB, the matrices 2 MB at 1023^2).
//
// Design.  Odd axes give rows of 2,046 B (bf16) or 4,092 B (float32), not
// 16-byte aligned, so the operands are first staged as padded bf16: a
// small pass writes T0 and T1 once per B6 call, and each transform's
// float32 input once, rounded to bf16, into rows of a multiple of 8
// elements with zero pads (pad_bf16_kernel, into B6's scratch); the first
// product of each pair writes its result straight in that layout, rounded
// to bf16 (the point where the JAX kernel rounds it).  The products then
// read only aligned bf16: one CTA of 8 warps per 128 x 64 output tile (128
// CTAs at 1023^2, one wave of the 132 SMs), each warp a 32 x 32 tile of
// 2 x 4 m16n8 accumulators; k-tiles of 64 through a ring of 4
// shared-memory stages filled by 16-byte cp.async (zero-filled past the
// operand), so three k-tiles are in flight while one is multiplied.  A
// k-tile's layout follows the operand's contiguous index and the
// transposed operands (T0' of the inverse, T1' of the forward) are
// ldmatrix.trans, not strided reads.  Shared rows are padded by 8 bf16, so
// the 8 row addresses of an ldmatrix hit 8 distinct 16-byte bank groups.
// Edges are zero-filled in the ring and masked in the epilogue, so any m0,
// m1 run.  No atomics and no split-K: a run repeats bit for bit.
//
// Why mma.sync and not wgmma: this is the first tensor-core step, kept to
// the warp-level product whose fragment layouts need no shared-memory
// descriptors; the padded bf16 layout it introduced is what a wgmma (or
// TMA) version needs, the next step for these products and for B3-B5's
// folded ones (dct_gemm.cu).
#include <cstdint>

#include "common.cuh"

namespace mvtv {

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128, kBN = 64, kBK = 64;  // CTA tile and k-tile
constexpr int kMmaThreads = 256;              // 8 warps, 32 x 32 outputs each
constexpr int kStages = 4;                    // cp.async ring depth
constexpr int kPad = 8;                       // bf16 per padded shared-memory row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  if constexpr (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
}

// c += a b over one m16n8k16 slice (a: 4 registers of bf16 pairs, b: 2).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One operand's k-tile in shared memory: element (o, k) (o = i for A, n
// for B) of the stored padded matrix p at p[o ld + k] (kKFast) or
// p[k ld + o].  The tile follows that contiguous index: kRows rows of kLen
// bf16, padded to kStride, filled in 16-byte chunks (kChunks per thread).
template <bool kKFast, int kOuter>
struct Tile {
  static constexpr int kRows = kKFast ? kOuter : kBK;
  static constexpr int kLen = kKFast ? kBK : kOuter;
  static constexpr int kStride = kLen + kPad;
  static constexpr int kElems = kRows * kStride;
  static constexpr int kRowChunks = kLen / 8;
  static constexpr int kChunks = kRows * kRowChunks / kMmaThreads;

  // Chunks outside the operand are zero-filled: rows o >= O (kKFast) or
  // k >= K, and 16-byte chunks past the padded row (whose pads are zero,
  // so the k >= K part of a K-fast chunk adds nothing).
  static __device__ __forceinline__ void load(bf16* tile, const bf16* __restrict__ p, int ld,
                                              int o0, int O, int k0, int K) {
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int ch = threadIdx.x + q * kMmaThreads;
      const int r = ch / kRowChunks, c = (ch % kRowChunks) * 8;
      const int o = o0 + (kKFast ? r : c), k = k0 + (kKFast ? c : r);
      const bool valid = kKFast ? (o < O && k < ld) : (k < K && o < ld);
      cp_async16(tile + r * kStride + c, valid ? p + (kKFast ? o * ld + k : k * ld + o) : p,
                 valid);
    }
  }
};

// C (M x N) = A (M x K) B (K x N) over one kBM x kBN tile per CTA, A and B
// padded bf16.  kOutBf16: C is a padded bf16 matrix (ldc a multiple of 8;
// columns N .. ldc - 1 written as zeros, so C can be the next product's
// K-fast operand); else C is float32 and, with rz_new >= 0, C = A B +
// beta C (beta = scal[rz_new] / max(scal[rz_old], eps)).
template <bool kAKFast, bool kBKFast, bool kOutBf16>
__global__ void __launch_bounds__(kMmaThreads)
dense_mma_kernel(const bf16* __restrict__ a, int lda, const bf16* __restrict__ b, int ldb,
                 void* __restrict__ cv, int ldc, const float* __restrict__ scal, int rz_new,
                 int rz_old, int M, int N, int K) {
  using TA = Tile<kAKFast, kBM>;
  using TB = Tile<kBKFast, kBN>;
  constexpr int WM = kBM / 32;  // warps along M
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [kStages][TA::kElems]
  bf16* Bs = As + kStages * TA::kElems;          // [kStages][TB::kElems]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;
  auto load = [&](int kt) {
    const int st = kt % kStages;
    TA::load(As + st * TA::kElems, a, lda, row0, M, kt * kBK, K);
    TB::load(Bs + st * TB::kElems, b, ldb, col0, N, kt * kBK, K);
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  // The ring: kStages - 1 k-tiles in flight ahead of the one in use.  One
  // commit per step, empty or not, keeps wait_group's count in step.
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < nk) load(kt);
    cp_async_commit();
  }
  // ldmatrix.x4: lane l addresses row l % 8 of 8 x 8 matrix l / 8.
  const int lr = lane & 7, lj = lane >> 3;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    // Tile kt has landed for every thread, and the stage refilled below was
    // last read in step kt - 1.
    __syncthreads();
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    cp_async_commit();
    const bf16* at = As + (kt % kStages) * TA::kElems;
    const bf16* bt = Bs + (kt % kStages) * TB::kElems;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int m = wm * 32 + mi * 16;
        // matrices: (m, k), (m + 8, k), (m, k + 8), (m + 8, k + 8)
        if constexpr (kAKFast)
          ldsm_x4<false>(af[mi], at + (m + lr + 8 * (lj & 1)) * TA::kStride + ks + 8 * (lj >> 1));
        else
          ldsm_x4<true>(af[mi], at + (ks + lr + 8 * (lj >> 1)) * TA::kStride + m + 8 * (lj & 1));
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int n = wn * 32 + nj * 16;
        // matrices: (n, k), (n, k + 8), (n + 8, k), (n + 8, k + 8)
        uint32_t r[4];
        if constexpr (kBKFast)
          ldsm_x4<false>(r, bt + (n + lr + 8 * (lj >> 1)) * TB::kStride + ks + 8 * (lj & 1));
        else
          ldsm_x4<true>(r, bt + (ks + lr + 8 * (lj & 1)) * TB::kStride + n + 8 * (lj >> 1));
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
  cp_async_wait<0>();

  // Accumulator (mi, ni): rows g and g + 8, columns 2t and 2t + 1 of its
  // m16n8 tile (g = lane / 4, t = lane % 4).
  const int g = lane >> 2, t = lane & 3;
  if constexpr (kOutBf16) {
    bf16* c = static_cast<bf16*>(cv);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = row0 + wm * 32 + mi * 16 + g + 8 * h;
          const int n = col0 + wn * 32 + ni * 8 + 2 * t;
          if (i < M && n < ldc)
            *reinterpret_cast<__nv_bfloat162*>(c + size_t(i) * ldc + n) = __floats2bfloat162_rn(
                n < N ? acc[mi][ni][2 * h] : 0.f, n + 1 < N ? acc[mi][ni][2 * h + 1] : 0.f);
        }
  } else {
    float* c = static_cast<float*>(cv);
    auto at = [&](int mi, int ni, int q) -> float* {
      const int i = row0 + wm * 32 + mi * 16 + g + 8 * (q >> 1);
      const int n = col0 + wn * 32 + ni * 8 + 2 * t + (q & 1);
      return i < M && n < N ? c + size_t(i) * ldc + n : nullptr;
    };
    if (rz_new >= 0) {
      // p = z + beta p: every old value is loaded before any store, so the
      // loads are in flight together.
      const float beta = scal[rz_new] / nan_max(scal[rz_old], kEps);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float* o = at(mi, ni, q);
            acc[mi][ni][q] += beta * (o ? *o : 0.f);
          }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (float* o = at(mi, ni, q)) *o = acc[mi][ni][q];
  }
}

template <bool kAKFast, bool kBKFast, bool kOutBf16>
int launch_mma(const bf16* a, int lda, const bf16* b, int ldb, void* c, int ldc,
               const float* scal, int rz_new, int rz_old, int M, int N, int K, cudaStream_t s) {
  constexpr int bytes =
      kStages * (Tile<kAKFast, kBM>::kElems + Tile<kBKFast, kBN>::kElems) * int(sizeof(bf16));
  auto kernel = dense_mma_kernel<kAKFast, kBKFast, kOutBf16>;
  MVTV_CHECK(int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      bytes)));
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kernel<<<grid, kMmaThreads, bytes, s>>>(a, lda, b, ldb, c, ldc, scal, rz_new, rz_old, M, N, K);
  MVTV_LAUNCHED();
  return 0;
}

// out (rows x ld, bf16) = in (rows x cols) rounded to bf16, columns cols ..
// ld - 1 zero.
template <class T>
__global__ void __launch_bounds__(kThreads)
pad_bf16_kernel(const T* __restrict__ in, int rows, int cols, bf16* __restrict__ out, int ld) {
  const int c = blockIdx.x * TX + threadIdx.x, r = blockIdx.y * TY + threadIdx.y;
  if (r >= rows || c >= ld) return;
  float v = 0.f;
  if (c < cols) {
    if constexpr (sizeof(T) == 2)
      v = __bfloat162float(in[size_t(r) * cols + c]);
    else
      v = in[size_t(r) * cols + c];
  }
  out[size_t(r) * ld + c] = __float2bfloat16_rn(v);
}

template <class T>
int launch_pad(const T* in, int rows, int cols, bf16* out, int ld, cudaStream_t s) {
  pad_bf16_kernel<T><<<dim3((ld + TX - 1) / TX, (rows + TY - 1) / TY), dim3(TX, TY), 0, s>>>(
      in, rows, cols, out, ld);
  MVTV_LAUNCHED();
  return 0;
}

int pad8(int m) { return (m + 7) / 8 * 8; }

}  // namespace

int dense_scratch_bytes(Lat L) {
  const int ld0 = pad8(L.m0), ld1 = pad8(L.m1);
  return int(sizeof(bf16)) * (L.m0 * ld0 + L.m1 * ld1 + 2 * L.m0 * ld1);
}

// Every buffer's size is a multiple of 16 bytes (rows of a multiple of 8
// bf16), so extra's alignment carries to all four.
Dense dense_layout(void* extra, Lat L) {
  Dense dn;
  dn.ld0 = pad8(L.m0);
  dn.ld1 = pad8(L.m1);
  dn.t0 = static_cast<bf16*>(extra);
  dn.t1 = dn.t0 + size_t(L.m0) * dn.ld0;
  dn.x = dn.t1 + size_t(L.m1) * dn.ld1;
  dn.tb = dn.x + size_t(L.m0) * dn.ld1;
  return dn;
}

int launch_dense_mats(const __nv_bfloat16* t0, const __nv_bfloat16* t1, Dense dn, Lat L,
                      cudaStream_t s) {
  MVTV_CHECK(launch_pad(t0, L.m0, L.m0, dn.t0, dn.ld0, s));
  return launch_pad(t1, L.m1, L.m1, dn.t1, dn.ld1, s);
}

// x = bf16(v), tb = T0 x, out = bf16(tb) T1'.
int launch_dct2_dense(const float* v, Dense dn, float* out, Lat L, Batch bt, cudaStream_t s) {
  if (bt.B != 1 || bt.act != nullptr) return int(cudaErrorInvalidValue);  // B6: one problem
  MVTV_CHECK(launch_pad(v, L.m0, L.m1, dn.x, dn.ld1, s));
  MVTV_CHECK((launch_mma<true, false, true>(dn.t0, dn.ld0, dn.x, dn.ld1, dn.tb, dn.ld1, nullptr,
                                            -1, -1, L.m0, L.m1, L.m0, s)));
  return launch_mma<true, true, false>(dn.tb, dn.ld1, dn.t1, dn.ld1, out, L.m1, nullptr, -1, -1,
                                       L.m0, L.m1, L.m1, s);
}

// x = bf16(y), tb = T0' x, out = bf16(tb) T1 (+ beta out).
int launch_idct2_dense(const float* y, Dense dn, float* out, const float* scal, int rz_new,
                       int rz_old, Lat L, Batch bt, cudaStream_t s) {
  if (bt.B != 1 || bt.act != nullptr) return int(cudaErrorInvalidValue);
  MVTV_CHECK(launch_pad(y, L.m0, L.m1, dn.x, dn.ld1, s));
  MVTV_CHECK((launch_mma<false, false, true>(dn.t0, dn.ld0, dn.x, dn.ld1, dn.tb, dn.ld1, nullptr,
                                             -1, -1, L.m0, L.m1, L.m0, s)));
  return launch_mma<true, false, false>(dn.tb, dn.ld1, dn.t1, dn.ld1, out, L.m1, scal, rz_new,
                                        rz_old, L.m0, L.m1, L.m1, s);
}

}  // namespace mvtv
