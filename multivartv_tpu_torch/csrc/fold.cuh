// The folded DCT products' device code, shared by fold_mma_kernel
// (dct_fold.cu: B3's stage kernels, 128 threads) and the persistent ADMM
// kernel of chain.cu (B4, B5, 256 threads): the four product ops (their
// operands and epilogues; the design is in dct_fold.cu's header) and one
// CTA's pair of products over one 32 x 32 output tile.
#pragma once

#include "mma.cuh"

namespace mvtv {
namespace fold {

using bf16 = __nv_bfloat16;

constexpr int kFM = 32, kFN = 32, kFK = 64;  // CTA tile and k-tile
constexpr int kFoldThreads = 128;            // 4 warps (2 x 2), 16 x 16 outputs each
constexpr int kFoldStages = 3;               // cp.async ring depth

template <bool kKFast, int kOuter, int kT = kFoldThreads>
using Tile = mma::Tile<kKFast, kOuter, kFK, kT>;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// The four operands of a CTA's pair of products, and their row strides.
struct Operands {
  const bf16 *a1, *a2, *b1, *b2;
  int lda, ldb;
};

// Each product op gives the pair's operands for problem b and part p
// (operands), the sizes M, N, K of one product, the parts (the grid's y is
// parts x M-tiles), the layout flags, and an epilogue store(b, p, i, n, c1,
// c2) per output element that returns its contribution to the CTA's
// partial sum (kPartial; 0 otherwise).

// P1: c1 = T0p F[p][left], c2 = T0p F[p][right] (T00 = Te0, T01 = To0);
// G_s[p h0 + i, n] = bf16(c1 + c2), G_d[...] = bf16(c1 - c2).
struct FwdRows {
  static constexpr bool kAKFast = true, kBKFast = false, kShareA = true, kPartial = false;
  static constexpr int kParts = 2;
  Folded f;
  int m0, h0, h1;
  __host__ __device__ int M() const { return h0; }
  __host__ __device__ int N() const { return h1; }
  __device__ int K() const { return h0; }
  __device__ Operands operands(int b, int p) const {
    const bf16* fb = f.scratch + size_t(b) * f.stride + size_t(2 * p) * h0 * f.ld1;
    const bf16* t = p ? f.to0 : f.te0;
    return {t, t, fb, fb + size_t(h0) * f.ld1, f.ld0, f.ld1};
  }
  __device__ float store(int b, int p, int i, int n, float c1, float c2) const {
    bf16* g = f.scratch + size_t(b) * f.stride + size_t(2) * m0 * f.ld1 +
              size_t(p * h0 + i) * f.ld1 + n;
    put(g, c1 + c2);
    put(g + size_t(m0) * f.ld1, c1 - c2);
    return 0.f;
  }
};

// P2: c1 = G_s Te1', c2 = G_d To1' is the packed spectrum rhat at (i, n) and
// (i, h1 + n); zhat = rhat / (cbar + rho eigs) goes to Y_0 and Y_1 as bf16,
// rhat zhat to the CTA's partial.
struct FwdCols {
  static constexpr bool kAKFast = true, kBKFast = true, kShareA = false, kPartial = true;
  static constexpr int kParts = 1;
  Folded f;
  const float* eigs;
  const float* scal;
  int sstride, m0, m1, h1;
  __host__ __device__ int M() const { return m0; }
  __host__ __device__ int N() const { return h1; }
  __device__ int K() const { return h1; }
  __device__ Operands operands(int b, int) const {
    const bf16* g = f.scratch + size_t(b) * f.stride + size_t(2) * m0 * f.ld1;
    return {g, g + size_t(m0) * f.ld1, f.te1, f.to1, f.ld1, f.ld1};
  }
  __device__ float store(int b, int, int i, int n, float c1, float c2) const {
    const float* row = scal + size_t(b) * sstride;
    const float* e = eigs + size_t(i) * m1 + n;
    const float z1 = c1 / (row[S_CBAR] + row[S_RHO] * e[0]);
    const float z2 = c2 / (row[S_CBAR] + row[S_RHO] * e[h1]);
    bf16* y = f.scratch + size_t(b) * f.stride + size_t(i) * f.ld1 + n;
    put(y, z1);
    put(y + size_t(m0) * f.ld1, z2);
    return c1 * z1 + c2 * z2;
  }
};

// P3, column half q: c1 = Te0' ye_q, c2 = To0' yo_q; X_q[i] = bf16(c1 + c2),
// X_q[m0-1-i] = bf16(c1 - c2).
struct InvRows {
  static constexpr bool kAKFast = false, kBKFast = false, kShareA = false, kPartial = false;
  static constexpr int kParts = 2;
  Folded f;
  int m0, h0, h1;
  __host__ __device__ int M() const { return h0; }
  __host__ __device__ int N() const { return h1; }
  __device__ int K() const { return h0; }
  __device__ Operands operands(int b, int q) const {
    const bf16* y = f.scratch + size_t(b) * f.stride + size_t(q) * m0 * f.ld1;
    return {f.te0, f.to0, y, y + size_t(h0) * f.ld1, f.ld0, f.ld1};
  }
  __device__ float store(int b, int q, int i, int n, float c1, float c2) const {
    bf16* x = f.scratch + size_t(b) * f.stride + size_t(2 + q) * m0 * f.ld1 + n;
    put(x + size_t(i) * f.ld1, c1 + c2);
    put(x + size_t(m0 - 1 - i) * f.ld1, c1 - c2);
    return 0.f;
  }
};

// P4: c1 = xe Te1, c2 = xo To1; out[i, n] = c1 + c2, out[i, m1-1-n] =
// c1 - c2, or (rz_new >= 0) the CG direction update p = z + beta p.
struct InvCols {
  static constexpr bool kAKFast = true, kBKFast = false, kShareA = false, kPartial = false;
  static constexpr int kParts = 1;
  Folded f;
  float* out;
  const float* scal;
  int sstride, rz_new, rz_old, m0, m1, h1;
  __host__ __device__ int M() const { return m0; }
  __host__ __device__ int N() const { return h1; }
  __device__ int K() const { return h1; }
  __device__ Operands operands(int b, int) const {
    const bf16* x = f.scratch + size_t(b) * f.stride + size_t(2) * m0 * f.ld1;
    return {x, x + size_t(m0) * f.ld1, f.te1, f.to1, f.ld1, f.ld1};
  }
  __device__ float store(int b, int, int i, int n, float c1, float c2) const {
    float* o = out + size_t(b) * m0 * m1 + size_t(i) * m1;
    if (rz_new < 0) {
      o[n] = c1 + c2;
      o[m1 - 1 - n] = c1 - c2;
    } else {
      const float* row = scal + size_t(b) * sstride;
      const float beta = row[rz_new] / nan_max(row[rz_old], kEps);
      o[n] = (c1 + c2) + beta * o[n];
      o[m1 - 1 - n] = (c1 - c2) + beta * o[m1 - 1 - n];
    }
    return 0.f;
  }
};

// fold_in at quadrant point (k, j) of problem b (k < h0, j < h1), from v
// at (k, j), (k, m1-1-j), (m0-1-k, j) and (m0-1-k, m1-1-j).
__device__ __forceinline__ void fold_in_at(const Folded& f, int b, int k, int j, int h0,
                                           float top_j, float top_jr, float bot_j,
                                           float bot_jr) {
  bf16* out = f.scratch + size_t(b) * f.stride + size_t(k) * f.ld1 + j;
  const size_t blk = size_t(h0) * f.ld1;
  put(out, top_j + bot_j);
  put(out + blk, top_jr + bot_jr);
  put(out + 2 * blk, top_j - bot_j);
  put(out + 3 * blk, top_jr - bot_jr);
}

// The shared memory of one tile's k-tile ring with kT threads.
template <class Op, int kT>
constexpr int smem_bytes() {
  using TA = Tile<Op::kAKFast, kFM, kT>;
  using TB = Tile<Op::kBKFast, kFN, kT>;
  return kFoldStages * ((Op::kShareA ? 1 : 2) * TA::kElems + 2 * TB::kElems) * int(sizeof(bf16));
}

// The pair of products of one Op over one kFM x kFN output tile: problem
// b, y = part * M-tiles + M-tile, x the N-tile; smem holds smem_bytes<Op,
// kT>().  Returns the tile's partial sum (kPartial; valid in thread 0) or
// 0.  With kT = 128 threads each of the 4 warps (2 x 2) computes its
// 16 x 16 outputs of both products; with kT = 256 warps 0-3 compute the
// first product and warps 4-7 the second, and hand it to warps 0-3
// through shared memory for the epilogue, and returns with every thread
// done with smem.  Every output is the same k-ordered sum of the same
// mma.sync steps either way, and the partial the same block_sum, so both
// give the same bits.
// With kStage the Op copies its epilogue's inputs for the tile into shared
// memory behind the ring (op.stage(s, b, part, row0, col0): 2 kFM x kFN
// floats, cp.async in the first k-tile's group, before the products) and
// its store reads them there.
constexpr int kStageFloats = 2 * kFM * kFN;

template <class Op, int kT, bool kStage = false>
__device__ __forceinline__ float fold_tile(const Op& op, int b, int y, int x, int M, int N,
                                           bf16* smem) {
  static_assert(kT == 128 || kT == 256, "4 or 8 warps");
  using TA = Tile<Op::kAKFast, kFM, kT>;
  using TB = Tile<Op::kBKFast, kFN, kT>;
  constexpr int nA = Op::kShareA ? 1 : 2;
  constexpr int kC = kT == 128 ? 2 : 1;  // products a warp computes
  bf16* As = smem;                                // [stages][nA][TA::kElems]
  bf16* Bs = As + kFoldStages * nA * TA::kElems;  // [stages][2][TB::kElems]

  const int mtiles = (M + kFM - 1) / kFM;
  const int part = y / mtiles;
  const int row0 = (y % mtiles) * kFM, col0 = x * kFN;
  const int K = op.K(), nk = (K + kFK - 1) / kFK;
  const Operands o = op.operands(b, part);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = (warp >> 1) & 1, c0 = kC == 2 ? 0 : warp >> 2;
  float* const staged = reinterpret_cast<float*>(Bs + kFoldStages * 2 * TB::kElems);
  if constexpr (kStage) op.stage(staged, b, part, row0, col0);
  auto load = [&](int kt) {
    bf16* as = As + (kt % kFoldStages) * nA * TA::kElems;
    bf16* bs = Bs + (kt % kFoldStages) * 2 * TB::kElems;
    TA::load(as, o.a1, o.lda, row0, M, kt * kFK, K);
    if constexpr (!Op::kShareA) TA::load(as + TA::kElems, o.a2, o.lda, row0, M, kt * kFK, K);
    TB::load(bs, o.b1, o.ldb, col0, N, kt * kFK, K);
    TB::load(bs + TB::kElems, o.b2, o.ldb, col0, N, kt * kFK, K);
  };

  float acc[kC][2][4];  // [product][n8 tile][fragment]
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[c][ni][q] = 0.f;

  // The ring: kFoldStages - 1 k-tiles in flight ahead of the one in use.
  // One commit per step, empty or not, keeps wait_group's count in step.
#pragma unroll
  for (int kt = 0; kt < kFoldStages - 1; ++kt) {
    if (kt < nk) load(kt);
    mma::cp_async_commit();
  }
  // ldmatrix.x4: lane l addresses row l % 8 of 8 x 8 matrix l / 8.
  const int lr = lane & 7, lj = lane >> 3;
  const int m = wm * 16, n = wn * 16;
  for (int kt = 0; kt < nk; ++kt) {
    mma::cp_async_wait<kFoldStages - 2>();
    // Tile kt has landed for every thread, and the stage refilled below was
    // last read in step kt - 1.
    __syncthreads();
    if (kt + kFoldStages - 1 < nk) load(kt + kFoldStages - 1);
    mma::cp_async_commit();
    const bf16* at = As + (kt % kFoldStages) * nA * TA::kElems;
    const bf16* bst = Bs + (kt % kFoldStages) * 2 * TB::kElems;
#pragma unroll
    for (int ks = 0; ks < kFK; ks += 16) {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int pc = c0 + c;
        const bf16* a = at + (Op::kShareA ? 0 : pc * TA::kElems);
        const bf16* bb = bst + pc * TB::kElems;
        uint32_t af[4], r[4];
        // A matrices: (m, k), (m + 8, k), (m, k + 8), (m + 8, k + 8)
        if constexpr (Op::kAKFast)
          mma::ldsm_x4<false>(af, a + (m + lr + 8 * (lj & 1)) * TA::kStride + ks + 8 * (lj >> 1));
        else
          mma::ldsm_x4<true>(af, a + (ks + lr + 8 * (lj >> 1)) * TA::kStride + m + 8 * (lj & 1));
        // B matrices: (n, k), (n, k + 8), (n + 8, k), (n + 8, k + 8)
        if constexpr (Op::kBKFast)
          mma::ldsm_x4<false>(r, bb + (n + lr + 8 * (lj >> 1)) * TB::kStride + ks + 8 * (lj & 1));
        else
          mma::ldsm_x4<true>(r, bb + (ks + lr + 8 * (lj & 1)) * TB::kStride + n + 8 * (lj >> 1));
        mma::mma_bf16(acc[c][0], af, r[0], r[1]);
        mma::mma_bf16(acc[c][1], af, r[2], r[3]);
      }
    }
  }
  mma::cp_async_wait<0>();

  // The second product's accumulators to warps 0-3 (kT = 256), through
  // the ring's shared memory once every warp is done with it.
  float c2[2][4];
  if constexpr (kC == 2) {
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) c2[ni][q] = acc[1][ni][q];
  } else {
    float* xch = reinterpret_cast<float*>(smem);  // [128][8]
    __syncthreads();
    if (warp >= 4)
#pragma unroll
      for (int v = 0; v < 8; ++v) xch[(threadIdx.x - 128) * 8 + v] = acc[0][v >> 2][v & 3];
    __syncthreads();
    if (warp < 4)
#pragma unroll
      for (int v = 0; v < 8; ++v) c2[v >> 2][v & 3] = xch[threadIdx.x * 8 + v];
    __syncthreads();
  }

  // Accumulator (ni, q): row g + 8 (q / 2), column 2t + (q % 2) of the warp's
  // n8 tile ni (g = lane / 4, t = lane % 4).
  const int g = lane >> 2, t = lane & 3;
  float part_sum = 0.f;
  if (kC == 2 || warp < 4)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = row0 + m + g + 8 * (q >> 1), j = col0 + n + ni * 8 + 2 * t + (q & 1);
        if (i < M && j < N) {
          if constexpr (kStage)
            part_sum += op.store(b, part, i, j, acc[0][ni][q], c2[ni][q],
                                 staged + (i - row0) * kFN + (j - col0));
          else
            part_sum += op.store(b, part, i, j, acc[0][ni][q], c2[ni][q]);
        }
      }
  if constexpr (Op::kPartial) return block_sum(part_sum);
  // The staged inputs stay in use until every thread's epilogue is done.
  if constexpr (kStage) __syncthreads();
  return 0.f;
}

}  // namespace fold
}  // namespace mvtv
