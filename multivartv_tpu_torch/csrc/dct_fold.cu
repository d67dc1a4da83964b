// The folded (packed) 2-D DCT-II and its inverse of B3-B5 on the tensor
// cores: bf16 operands, float32 accumulation, mma.sync.m16n8k16 from
// ldmatrix (mma.cuh).
//
// Replaces the in-kernel transforms of multivartv_tpu/ops/pallas_kernels.py:
// _xupdate_kernel_packed and _admm_chain (B3, B4, B5), i.e. ops/dct.py:
// dct2_packed / idct2_packed with mat_dtype = bf16 (:162-230), and, fused
// into the forward transform's last product, the spectral scale of the
// preconditioner solve (zhat = rhat / (cbar + rho eigs) and <rhat, zhat>).
// Per axis the fold s = top + flip(bottom), d = top - flip(bottom) splits
// the dense product into two half-size products; the spectrum is in packed
// order.  Operands are rounded to bf16 at exactly the JAX package's points:
// the axis-0 folds of the float32 input, the axis-1 folds of the float32
// first-axis result, the even/odd halves ye/yo of the spectrum and xe/xo of
// the inverse's first-axis result.  The flip is an index reversal (the JAX
// kernels' exchange-matrix product, which rounds the flipped half to bf16,
// is a TPU workaround).  bf16 x bf16 products are exact in float32, so each
// product is a.bfloat16().float() @ b.bfloat16().float() up to the order of
// the float32 sums.
//
// Bound on the H100: the tensor cores in principle (m0 m1 (m0 + m1)
// multiply-adds per forward-inverse pair: 0.27 GFLOP at 512^2, 0.6 us at
// 989 TFLOP/s), in practice latency: at 316^2 a product is ~2.5 MFLOP per
// problem, so each launch is a few hundred CTAs of a few k-tiles.  Every
// operand lives in the 50 MB L2.
//
// Design.  Every operand is staged as padded bf16, rows of a multiple of 8
// elements with zero pads (odd halves such as h = 159 give rows that are
// not 16-byte aligned otherwise), and every product writes its result
// straight in the layout and rounding the next one reads:
//   fold_in       v (f32) -> F: bf16(v[k] +- v[m0-1-k]) for the left half
//                 of the columns and for the right half flipped (4 blocks
//                 of h0 x h1);
//   FwdRows  (P1) part p (even: Te0 with the sums, odd: To0 with the
//                 differences): c1 = T F_left, c2 = T F_right, so the
//                 axis-1 fold of the first-axis result is c1 +- c2 in the
//                 epilogue (tmp[:, k] +- tmp[:, m1-1-k]), written as bf16
//                 G_s, G_d (m0 x h1);
//   FwdCols  (P2) c1 = G_s Te1', c2 = G_d To1': the packed spectrum, scaled
//                 in the epilogue to zhat, written as bf16 Y (the inverse's
//                 ye/yo, in two column halves), with each CTA's partial of
//                 <rhat, zhat> in a fixed slot (no float32 zhat is stored);
//   InvRows  (P3) part q (column half): c1 = Te0' ye, c2 = To0' yo, written
//                 as bf16 x[i] = c1 + c2, x[m0-1-i] = c1 - c2 into X_q
//                 (xe for q = 0, xo for q = 1);
//   InvCols  (P4) c1 = xe Te1, c2 = xo To1: out[:, n] = c1 + c2,
//                 out[:, m1-1-n] = c1 - c2, optionally + beta out.
// One CTA of 4 warps per 32 x 32 tile of both products of a pair (each warp
// 16 x 16 of each), k-tiles of 64 through a 3-stage cp.async ring,
// ldmatrix.trans for the transposed operands.  The batch is blockIdx.z with
// per-problem scratch; a frozen problem's CTAs return at once.  The tile
// shape does not depend on B, and there are no atomics and no split-K: a run
// repeats bit for bit and B5's row b equals B4 on problem b.
#include "fold.cuh"

namespace mvtv {

namespace {

using namespace fold;

// One CTA of kFoldThreads per output tile of an Op's pair of products:
// blockIdx.x the N-tile, blockIdx.y = part * M-tiles + M-tile, blockIdx.z
// the problem (fold.cuh, fold_tile).
template <class Op>
__global__ void __launch_bounds__(kFoldThreads)
fold_mma_kernel(Op op, int M, int N, float* __restrict__ partials, Batch bt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (frozen(bt)) return;
  const float tot = fold_tile<Op, kFoldThreads>(op, blockIdx.z, blockIdx.y, blockIdx.x, M, N,
                                                reinterpret_cast<bf16*>(smem_raw));
  if constexpr (Op::kPartial) {
    if (threadIdx.x == 0)
      partials[part_offset(bt) + blockIdx.y * gridDim.x + blockIdx.x] = tot;
  }
}

template <class Op>
int launch_fold(const Op& op, float* partials, Batch bt, cudaStream_t s) {
  constexpr int bytes = smem_bytes<Op, kFoldThreads>();
  static bool configured = false;
  if (!configured) {
    MVTV_CHECK(int(cudaFuncSetAttribute(fold_mma_kernel<Op>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)));
    configured = true;
  }
  const int M = op.M(), N = op.N();
  const dim3 grid(cdiv(N, kFN), cdiv(M, kFM) * Op::kParts, bt.B);
  fold_mma_kernel<Op><<<grid, kFoldThreads, bytes, s>>>(op, M, N, partials, bt);
  MVTV_LAUNCHED();
  return 0;
}

// F[p][q] (h0 x h1 each, p: 0 sums, 1 differences; q: 0 the left columns,
// 1 the right ones flipped) = bf16(v[k, j'] +- v[m0-1-k, j']), j' = j (left)
// or m1-1-j (right).
__global__ void __launch_bounds__(kThreads)
fold_in_kernel(const float* __restrict__ v, Folded f, Lat L, Batch bt) {
  if (frozen(bt)) return;
  const int h0 = L.m0 / 2, h1 = L.m1 / 2;
  const int j = blockIdx.x * TX + threadIdx.x;
  const int k = blockIdx.y * TY + threadIdx.y;
  if (k >= h0 || j >= h1) return;
  v += lat_offset(L);
  const float* top = v + size_t(k) * L.m1;
  const float* bot = v + size_t(L.m0 - 1 - k) * L.m1;
  const int jr = L.m1 - 1 - j;
  fold_in_at(f, blockIdx.z, k, j, h0, top[j], top[jr], bot[j], bot[jr]);
}

// The halves (h x h, unpadded bf16) into their padded copies; blockIdx.z
// picks Te0, To0, Te1, To1.  The pads stay as the scratch's memset left
// them: zero.
__global__ void __launch_bounds__(kThreads)
pad_halves_kernel(Halves hv, Folded f, Lat L) {
  const int z = blockIdx.z, h = z < 2 ? L.m0 / 2 : L.m1 / 2, ld = z < 2 ? f.ld0 : f.ld1;
  const int c = blockIdx.x * TX + threadIdx.x, r = blockIdx.y * TY + threadIdx.y;
  if (r >= h || c >= h) return;
  const bf16* src = z == 0 ? hv.te0 : z == 1 ? hv.to0 : z == 2 ? hv.te1 : hv.to1;
  bf16* dst = z == 0 ? f.te0 : z == 1 ? f.to0 : z == 2 ? f.te1 : f.to1;
  dst[size_t(r) * ld + c] = src[size_t(r) * h + c];
}

}  // namespace

// The layout in the scratch at extra (16-byte aligned, folded_scratch_bytes
// bytes): per problem 4 blocks of m0 x ld1 (F, then Y in the first two; G,
// then X in the last two), then the padded halves.  Every size is a
// multiple of 8 bf16, so extra's alignment carries to each buffer and row.
size_t folded_scratch_bytes(Lat L, int B) {
  const size_t ld0 = mma::pad8(L.m0 / 2), ld1 = mma::pad8(L.m1 / 2);
  return sizeof(bf16) * (size_t(B) * 4 * L.m0 * ld1 + L.m0 * ld0 + L.m1 * ld1);
}

Folded folded_layout(void* extra, Lat L, int B) {
  Folded f;
  f.ld0 = mma::pad8(L.m0 / 2);
  f.ld1 = mma::pad8(L.m1 / 2);
  f.stride = size_t(4) * L.m0 * f.ld1;
  f.scratch = static_cast<bf16*>(extra);
  bf16* h = f.scratch + size_t(B) * f.stride;
  f.te0 = h;
  f.to0 = f.te0 + size_t(L.m0 / 2) * f.ld0;
  f.te1 = f.to0 + size_t(L.m0 / 2) * f.ld0;
  f.to1 = f.te1 + size_t(L.m1 / 2) * f.ld1;
  return f;
}

int launch_folded_setup(Halves hv, Folded f, Lat L, int B, cudaStream_t s) {
  MVTV_CHECK(int(cudaMemsetAsync(f.scratch, 0, folded_scratch_bytes(L, B), s)));
  const int h = L.m0 > L.m1 ? L.m0 / 2 : L.m1 / 2;
  pad_halves_kernel<<<dim3(cdiv(h, TX), cdiv(h, TY), 4), dim3(TX, TY), 0, s>>>(hv, f, L);
  MVTV_LAUNCHED();
  return 0;
}

int folded_scale_blocks(Lat L) { return cdiv(L.m1 / 2, kFN) * cdiv(L.m0, kFM); }

int launch_dct2_folded_scaled(const float* v, Folded f, const float* eigs, const float* scal,
                              float* partials, Lat L, Batch bt, cudaStream_t s) {
  const int h0 = L.m0 / 2, h1 = L.m1 / 2;
  fold_in_kernel<<<dim3(cdiv(h1, TX), cdiv(h0, TY), bt.B), dim3(TX, TY), 0, s>>>(v, f, L, bt);
  MVTV_LAUNCHED();
  MVTV_CHECK(launch_fold(FwdRows{f, L.m0, h0, h1}, nullptr, bt, s));
  return launch_fold(FwdCols{f, eigs, scal, bt.sstride, L.m0, L.m1, h1}, partials, bt, s);
}

int launch_idct2_folded(Folded f, float* out, const float* scal, int rz_new, int rz_old, Lat L,
                        Batch bt, cudaStream_t s) {
  const int h0 = L.m0 / 2, h1 = L.m1 / 2;
  MVTV_CHECK(launch_fold(InvRows{f, L.m0, h0, h1}, nullptr, bt, s));
  return launch_fold(InvCols{f, out, scal, bt.sstride, rz_new, rz_old, L.m0, L.m1, h1}, nullptr,
                     bt, s);
}

}  // namespace mvtv
