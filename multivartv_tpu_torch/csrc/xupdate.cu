// The x-update: n_steps of PCG on (diag(counts) + rho D'D) x = b,
// preconditioned by the folded bf16 DCT solve of (cbar I + rho D'D).
//
// Replaces multivartv_tpu/ops/pallas_kernels.py:_xupdate_kernel_packed
// (xupdate_pcg_2d_packed, B3; _admm_chain's x-update, B4 and B5, is the
// same arithmetic in chain.cu's persistent kernel, from the device code of
// stencil.cuh and fold.cuh that these stage kernels also call); with
// the dense bf16 DCT matrices in place of the folded halves,
// _xupdate_kernel (xupdate_pcg_2d, B6: lattices with an odd axis).  Its
// matvec stage computes _gram_matvec_kernel's function (B7, the fused-dot
// PCG's matvec, whose own one-launch kernel is in tiled.cu).
// The TPU kernel keeps every CG vector in VMEM inside one kernel; on the
// H100 the vectors (r, p, Ap and the DCT operands: about 4 lattices, 4 MB
// at 512^2) stay in the 50 MB L2 across a chain of stage kernels:
//   residual (rhs.cu)  ->  precond  ->  n_steps x [gram_matvec_dot, cg_update,
//   precond (not on the last step: it would feed only the dead beta/p)],
// with precond = dct2 -> spectral scale and <rhat, zhat> -> finish -> idct2,
// whose last product also forms p = z + beta p.  The CG scalars (rz, p'Ap, alpha,
// beta) never leave the device: each kernel reads them from ``scal``, and
// pap and rz are guarded by eps = 1e-30 as in the TPU kernel.
//
// Bound on the H100: the DCT products, then launch latency: about 25
// launches per x-update.  B3's folded products (dct_fold.cu) and B6's dense
// ones (twice the folded multiply-adds, 25.7 GFLOP at 1023^2, 0.026 ms at
// 989 TFLOP/s; dct_mma.cu) run on the tensor cores (mma.sync from ldmatrix
// over padded bf16 operands), which leaves the stencil, CG and finish
// stages a large share of the time.  The folded forward transform ends in
// the spectral scale (its last product's epilogue); B6 keeps
// spectral_scale_dot_kernel.  The
// stencil and elementwise stages are bandwidth-bound passes over
// L2-resident lattices.  Every stage takes a batch of
// problems as blockIdx.z (common.cuh, Batch), so B problems cost the same
// launches as one.
#include <cstdint>

#include "stencil.cuh"

namespace mvtv {

__device__ __forceinline__ void write_partial(float v, float* partials) {
  const float tot = block_sum(v);
  if (threadIdx.x == 0 && threadIdx.y == 0)
    partials[blockIdx.y * gridDim.x + blockIdx.x] = tot;
}

// ap = A p and the partials of <p, Ap>.
__global__ void __launch_bounds__(kThreads)
gram_matvec_dot_kernel(const float* __restrict__ p, const float* __restrict__ counts,
                       const float* __restrict__ scal, Scales sc, float* __restrict__ ap,
                       float* __restrict__ partials, Lat L, Batch bt) {
  if (frozen(bt)) return;
  const size_t off = lat_offset(L);
  p += off;
  ap += off;
  counts += counts_offset(bt);
  const int j = blockIdx.x * TX + threadIdx.x;
  const int i = blockIdx.y * TY + threadIdx.y;
  float d = 0.f;
  if (i < L.m0 && j < L.m1) {
    const size_t c = size_t(i) * L.m1 + j;
    const float v = gram_apply_at(p, counts[c], i, j, L, scal[scal_offset(bt) + S_RHO], sc);
    ap[c] = v;
    d = p[c] * v;
  }
  write_partial(d, partials + part_offset(bt));
}

// alpha = rz / max(pap, eps); x_dst = x_src + alpha p; r -= alpha ap; and
// the partials of <r, r> (used after the last step).  x_dst may be x_src:
// each thread reads and writes only its own element.
__global__ void __launch_bounds__(kThreads)
cg_update_kernel(const float* x_src, float* x_dst, const float* __restrict__ p,
                 const float* __restrict__ ap, float* __restrict__ r,
                 const float* __restrict__ scal, int rz_slot, int pap_slot,
                 float* __restrict__ partials, Lat L, Batch bt) {
  if (frozen(bt)) return;
  const size_t off = lat_offset(L);
  const int j = blockIdx.x * TX + threadIdx.x;
  const int i = blockIdx.y * TY + threadIdx.y;
  float d = 0.f;
  if (i < L.m0 && j < L.m1) {
    scal += scal_offset(bt);
    const float al = scal[rz_slot] / nan_max(scal[pap_slot], kEps);
    const size_t c = off + size_t(i) * L.m1 + j;
    x_dst[c] = x_src[c] + al * p[c];
    const float rn = r[c] - al * ap[c];
    r[c] = rn;
    d = rn * rn;
  }
  write_partial(d, partials + part_offset(bt));
}

// zhat = rhat / (cbar + rho eigs) in place, and the partials of <rhat, zhat>.
// The eigenvalues are shared by the batch.
__global__ void __launch_bounds__(kThreads)
spectral_scale_dot_kernel(float* __restrict__ spec, const float* __restrict__ eigs,
                          const float* __restrict__ scal, float* __restrict__ partials, Lat L,
                          Batch bt) {
  if (frozen(bt)) return;
  const int j = blockIdx.x * TX + threadIdx.x;
  const int i = blockIdx.y * TY + threadIdx.y;
  float d = 0.f;
  if (i < L.m0 && j < L.m1) {
    scal += scal_offset(bt);
    const size_t c = size_t(i) * L.m1 + j;
    const float rhat = spec[lat_offset(L) + c];
    const float zhat = rhat / (scal[S_CBAR] + scal[S_RHO] * eigs[c]);
    spec[lat_offset(L) + c] = zhat;
    d = rhat * zhat;
  }
  write_partial(d, partials + part_offset(bt));
}

// z = M^-1 r, rz = <r, z> into scal[rz_new]; p = z (rz_old < 0) or
// p = z + (rz_new / max(rz_old, eps)) p.  The spectrum is in packed order
// with the folded halves (the scale fused into the forward transform's last
// product, dct_fold.cu) and in natural order with the dense matrices; eigs
// is in the same order.
static int precond(const float* r, float* p, Transforms tf, const float* eigs, float* scal,
                   int rz_new, int rz_old, PcgBuffers wb, float* partials, Lat L, Batch bt,
                   cudaStream_t s) {
  const int rz_p = rz_old < 0 ? -1 : rz_new;
  if (!tf.dn.t0) {
    MVTV_CHECK(launch_dct2_folded_scaled(r, tf.fd, eigs, scal, partials, L, bt, s));
    MVTV_CHECK(launch_finish(partials, folded_scale_blocks(L), 1, scal + rz_new, bt, s));
    return launch_idct2_folded(tf.fd, p, scal, rz_p, rz_old, L, bt, s);
  }
  MVTV_CHECK(launch_dct2_dense(r, tf.dn, wb.spec, L, bt, s));
  spectral_scale_dot_kernel<<<stencil_grid(L, bt.B), dim3(TX, TY), 0, s>>>(wb.spec, eigs, scal,
                                                                           partials, L, bt);
  MVTV_LAUNCHED();
  MVTV_CHECK(launch_finish(partials, stencil_blocks(L), 1, scal + rz_new, bt, s));
  return launch_idct2_dense(wb.spec, tf.dn, p, scal, rz_p, rz_old, L, bt, s);
}

int run_pcg(const float* x_src, float* x_dst, const float* counts, Transforms tf,
            const float* eigs, float* scal, Scales sc, int n_steps, PcgBuffers wb,
            float* partials, Lat L, Batch bt, cudaStream_t s) {
  const dim3 grid = stencil_grid(L, bt.B), block(TX, TY);
  const int nb = stencil_blocks(L);
  MVTV_CHECK(precond(wb.r, wb.p, tf, eigs, scal, S_CG, -1, wb, partials, L, bt, s));
  for (int step = 0; step < n_steps; ++step) {
    const int rz = S_CG + 2 * step, pap = rz + 1;
    gram_matvec_dot_kernel<<<grid, block, 0, s>>>(wb.p, counts, scal, sc, wb.ap, partials, L,
                                                  bt);
    MVTV_LAUNCHED();
    MVTV_CHECK(launch_finish(partials, nb, 1, scal + pap, bt, s));
    cg_update_kernel<<<grid, block, 0, s>>>(step == 0 ? x_src : x_dst, x_dst, wb.p, wb.ap,
                                            wb.r, scal, rz, pap, partials, L, bt);
    MVTV_LAUNCHED();
    if (step + 1 < n_steps)
      MVTV_CHECK(precond(wb.r, wb.p, tf, eigs, scal, rz + 2, rz, wb, partials, L, bt, s));
  }
  // |r|^2 after the last step (the partials of the last cg_update).
  return launch_finish(partials, nb, 1, scal + S_STATS + 5, bt, s);
}

// The floats of work for B = 1 (B3) or a batch (B4, B5: chain.cu):
// `lattices` float lattices per problem, then 4 floats of slack to align
// the tensor-core products' padded bf16 operands (dct_fold.cu) to 16 bytes.
long long folded_work(int lattices, int B, int m0, int m1) {
  return (long long)lattices * B * m0 * m1 + 4 +
         (long long)(mvtv::folded_scratch_bytes(mvtv::Lat{m0, m1}, B) + 3) / 4;
}

mvtv::Folded folded_in_work(float* work, int lattices, mvtv::Lat L, int B) {
  const uintptr_t extra =
      (reinterpret_cast<uintptr_t>(work + size_t(lattices) * B * L.m0 * L.m1) + 15) / 16 * 16;
  return mvtv::folded_layout(reinterpret_cast<void*>(extra), L, B);
}

}  // namespace mvtv

// B3 entry point.  work holds mvtv_xupdate_pcg_2d_packed_work(m0, m1)
// floats: 3 lattices (r, p, ap), then the folded products' padded bf16
// operands; ||r||^2 lands in scal[S_STATS + 5].
extern "C" long long mvtv_xupdate_pcg_2d_packed_work(int m0, int m1) {
  return mvtv::folded_work(3, 1, m0, m1);
}

extern "C" int mvtv_xupdate_pcg_2d_packed(const float* b, const float* x0, const float* counts,
                                          const void* te0, const void* to0, const void* te1,
                                          const void* to1, const float* eigs, const float* rho,
                                          const float* cbar, float s_mix, float s_ax1,
                                          float s_ax0, int n_steps, float* x, float* work,
                                          float* partials, float* scal, int m0, int m1,
                                          void* stream) {
  using namespace mvtv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Lat L{m0, m1};
  const size_t n = size_t(m0) * m1;
  const PcgBuffers wb{work, work + n, work + 2 * n, nullptr};
  const Halves hv{static_cast<const __nv_bfloat16*>(te0), static_cast<const __nv_bfloat16*>(to0),
                  static_cast<const __nv_bfloat16*>(te1), static_cast<const __nv_bfloat16*>(to1)};
  const Transforms tf{folded_in_work(work, 3, L, 1), Dense{}};
  const Scales sc{s_mix, s_ax1, s_ax0};
  MVTV_CHECK(launch_folded_setup(hv, tf.fd, L, 1, s));
  MVTV_CHECK(launch_init_scalars(scal, nullptr, rho, nullptr, cbar, nullptr, kOne, s));
  MVTV_CHECK(launch_residual(B_GIVEN, b, x0, counts, nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, scal, sc, wb.r, L, kOne, s));
  MVTV_CHECK(run_pcg(x0, x, counts, tf, eigs, scal, sc, n_steps, wb, partials, L, kOne, s));
  return int(cudaGetLastError());
}

// B6 entry point (xupdate_pcg_2d, pallas_kernels.py:505; kernel :319-398):
// B3's chain with the dense bf16 DCT matrices t0 (m0 x m0) and t1 (m1 x m1)
// and the Gram eigenvalues in natural order, for any m0, m1 (an odd axis
// has no folded halves).  work holds mvtv_xupdate_pcg_2d_work(m0, m1)
// floats: 4 lattices (r, p, ap, spec), then the tensor-core products'
// padded bf16 operands (dct_mma.cu); ||r||^2 lands in scal[S_STATS + 5].
extern "C" int mvtv_xupdate_pcg_2d_work(int m0, int m1) {
  // 4 floats of slack to align the bf16 buffers to 16 bytes
  return 4 * m0 * m1 + 4 + mvtv::dense_scratch_bytes(mvtv::Lat{m0, m1}) / 4;
}

extern "C" int mvtv_xupdate_pcg_2d(const float* b, const float* x0, const float* counts,
                                   const void* t0, const void* t1, const float* eigs,
                                   const float* rho, const float* cbar, float s_mix, float s_ax1,
                                   float s_ax0, int n_steps, float* x, float* work,
                                   float* partials, float* scal, int m0, int m1, void* stream) {
  using namespace mvtv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Lat L{m0, m1};
  const size_t n = size_t(m0) * m1;
  const PcgBuffers wb{work, work + n, work + 2 * n, work + 3 * n};
  const uintptr_t extra = (reinterpret_cast<uintptr_t>(work + 4 * n) + 15) / 16 * 16;
  const Transforms tf{Folded{}, dense_layout(reinterpret_cast<void*>(extra), L)};
  const Scales sc{s_mix, s_ax1, s_ax0};
  MVTV_CHECK(launch_dense_mats(static_cast<const __nv_bfloat16*>(t0),
                               static_cast<const __nv_bfloat16*>(t1), tf.dn, L, s));
  MVTV_CHECK(launch_init_scalars(scal, nullptr, rho, nullptr, cbar, nullptr, kOne, s));
  MVTV_CHECK(launch_residual(B_GIVEN, b, x0, counts, nullptr, nullptr, nullptr, nullptr, nullptr,
                             nullptr, nullptr, scal, sc, wb.r, L, kOne, s));
  MVTV_CHECK(run_pcg(x0, x, counts, tf, eigs, scal, sc, n_steps, wb, partials, L, kOne, s));
  return int(cudaGetLastError());
}
