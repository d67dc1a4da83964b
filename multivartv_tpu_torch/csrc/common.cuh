// Shared declarations of the Hopper kernels of the 2-D ADMM path.
//
// Conventions (ops/kernels.py mirrors them):
//   * lattices are float32, C-contiguous (m0, m1); element (i, j) at i*m1 + j;
//   * the difference blocks follow fd_binaries(2) = ((1,1), (0,1), (1,0)):
//     block 0 = mixed, 1 = axis-1 difference, 2 = axis-0 difference;
//   * blocks use the padded-block convention of ops/diff.py: forward
//     differences read the circular neighbour and are masked on the last
//     row/column, adjoints are plain circular shifts.  Neighbour indices wrap
//     exactly as jnp.roll does ((i - 1 + m) % m), and the masks multiply, so
//     a non-finite value in the wrapped row propagates as it does in JAX;
//   * scalars (lambda, rho, u_scale, cbar, kappa, the statistics and the CG
//     dots) live in a small device buffer ``scal`` that every kernel reads by
//     pointer, so no launch depends on a host copy of a device value;
//   * every reduction is two passes, per-block partials then a one-block
//     finish in a fixed order (a finish launch, or in the dual stage the
//     last CTA to finish): no float atomics, so a run repeats bit for bit;
//   * every stage kernel takes a batch of B problems as its third launch
//     dimension (blockIdx.z = b, struct Batch): problem b owns the lattices
//     at offset b * m0 * m1, counts and oty at b * cstride (0 when the
//     problems share them), row b of the scalar buffer and row b of the
//     partials.  The single-problem entry points are the B = 1 case.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mvtv {

// Slots of the scalar buffer.
enum Slot : int {
  S_LAM = 0,
  S_RHO = 1,
  S_USCALE = 2,
  S_CBAR = 3,
  S_KAPPA = 4,
  // 6 statistics: |r|^2, |D theta|^2, |alpha|^2, |D'r|^2, |D'u|^2, CG |r|^2
  S_STATS = 5,
  // CG dots: rz[j] at S_CG + 2j, pap[j] at S_CG + 2j + 1, j = 0..n_steps
  S_CG = 11,
};

constexpr float kEps = 1e-30f;
constexpr int TX = 32;  // stencil block: 32 x 8 threads, one per element
constexpr int TY = 8;
constexpr int kThreads = TX * TY;

struct Lat {
  int m0, m1;
};

struct Scales {
  float mix, ax1, ax0;  // fd_binaries(2) order
};

// A launch's batch of problems.  act (null: all active) freezes problems:
// every block of every stage reads act[b] first and returns if it is 0, so
// a frozen problem costs no memory traffic and its rows are never written.
struct Batch {
  int B;
  const int* act;
  long long cstride;  // batch stride of counts and oty (0: shared)
  int sstride;        // length of a row of the scalar buffer
  int pstride;        // length of a row of the partials
};
constexpr Batch kOne{1, nullptr, 0, 0, 0};

__device__ __forceinline__ bool frozen(const Batch& bt) {
  return bt.act != nullptr && bt.act[blockIdx.z] == 0;
}
__device__ __forceinline__ size_t lat_offset(Lat L) {
  return size_t(blockIdx.z) * size_t(L.m0) * size_t(L.m1);
}
__device__ __forceinline__ size_t scal_offset(const Batch& bt) {
  return size_t(blockIdx.z) * size_t(bt.sstride);
}
__device__ __forceinline__ size_t part_offset(const Batch& bt) {
  return size_t(blockIdx.z) * size_t(bt.pstride);
}
__device__ __forceinline__ size_t counts_offset(const Batch& bt) {
  return size_t(blockIdx.z) * size_t(bt.cstride);
}

__device__ __forceinline__ int dec(int i, int m) { return i == 0 ? m - 1 : i - 1; }
__device__ __forceinline__ int inc(int i, int m) { return i == m - 1 ? 0 : i + 1; }
__device__ __forceinline__ float edge(int i, int m) { return i < m - 1 ? 1.f : 0.f; }
// i in [-m, 2m) wrapped into [0, m), as jnp.roll wraps.
__device__ __forceinline__ int wrap1(int i, int m) { return i < 0 ? i + m : (i >= m ? i - m : i); }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// jnp.maximum(x, floor): a NaN x stays NaN (fmaxf would drop it).
__device__ __forceinline__ float nan_max(float x, float floor) {
  return (x > floor || x != x) ? x : floor;
}

// jnp.sign(z) * jnp.maximum(|z| - k, 0), NaN-propagating like jnp.
__device__ __forceinline__ float soft(float z, float k) {
  const float sg = z > 0.f ? 1.f : (z < 0.f ? -1.f : z);
  return sg * nan_max(fabsf(z) - k, 0.f);
}

// Sum of one value over the block (blockDim.x * blockDim.y threads, a
// multiple of 32, at most 1024); the result is valid in thread 0.  The order
// is fixed by the thread layout, so the sum repeats bit for bit.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nwarps = (blockDim.x * blockDim.y) / 32;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();  // warp_sums may still be read by a previous call
  if ((tid & 31) == 0) warp_sums[tid >> 5] = v;
  __syncthreads();
  float total = 0.f;
  if (tid == 0)
    for (int w = 0; w < nwarps; ++w) total += warp_sums[w];
  return total;
}

// 4 bytes global -> shared, asynchronous: the stencil kernels' tiles and
// halos (dual.cu, tiled3.cu), a group committed per stage and waited for
// until at most N groups are still in flight.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
// 16 bytes global -> shared, both 16-byte aligned (the row march of tiled.cu).
__device__ __forceinline__ void cp_async16f(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async4_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A row slab of a lattice cut into row slabs over ranks (B8s, B9s, B11s):
// local row r is global row row_off + r of m0g.  Its rows -1 and L.m0 are
// the neighbours' boundary rows, the halo rows (zeros at the global edges).
struct Slab {
  int row_off, m0g;
};
// B8s's halo rows: theta's above and below the slab, u's above it.
struct DualHalo {
  const float *th_top, *th_bot, *u0_top, *u1_top, *u2_top;
};

__device__ __forceinline__ const float* slab_row(const float* x, const float* top,
                                                 const float* bot, int r, Lat L) {
  return r < 0 ? top : (r >= L.m0 ? bot : x + size_t(r) * L.m1);
}
// The axis-0 forward difference's mask at global row g of m0g (0 on the last
// row and on the rows above the lattice), and the TPU kernels' `valid` (0 on
// the rows above the lattice).
__device__ __forceinline__ float edge_global(int g, int m0g) {
  return (g >= 0 && g < m0g - 1) ? 1.f : 0.f;
}
__device__ __forceinline__ float valid_global(int g) { return g >= 0 ? 1.f : 0.f; }

inline dim3 stencil_grid(Lat L, int B = 1) {
  return dim3((L.m1 + TX - 1) / TX, (L.m0 + TY - 1) / TY, B);
}
// Stencil blocks of one problem (the partials of one reduction).
inline int stencil_blocks(Lat L) {
  dim3 g = stencil_grid(L);
  return int(g.x * g.y);
}

// ---- host launchers shared by the entry points (each returns a cudaError_t) ----
// Pointers are those of problem 0; each launcher covers the bt.B problems.

// reduce.cu: dst[v] = sum over blocks of partials[v * nblocks + block], v < nv.
int launch_finish(const float* partials, int nblocks, int nv, float* dst, Batch bt,
                  cudaStream_t s);
// reduce.cu: copy problem b's scalars (element b of each given array; null =
// leave the slot) into row b, for frozen problems too, and zero the row's
// statistics; with kappa null and lam, rho given, kappa = lam / rho.
int launch_init_scalars(float* scal, const float* lam, const float* rho, const float* uscale,
                        const float* cbar, const float* kappa, Batch bt, cudaStream_t s);

// rhs.cu: the residual r = b - A x (mode 1: b given; mode 2: b formed from
// oty, alpha, u as in B2).
enum ResidualMode : int { B_GIVEN = 1, B_FORMED = 2 };
int launch_residual(ResidualMode mode, const float* b, const float* x, const float* counts,
                    const float* oty, const float* a0, const float* a1, const float* a2,
                    const float* u0, const float* u1, const float* u2, const float* scal,
                    Scales sc, float* out, Lat L, Batch bt, cudaStream_t s);

// dual.cu: the z/dual stage of B1 in one launch: alpha, u_new, and the 5
// statistics in scal[S_STATS ..] of each problem's row (the last CTA of a
// problem sums the per-CTA partials, found by tickets[b], which must be 0
// and is left 0).  kappa and uscale are read at the problem's row offset
// (scal_offset) like scal.  t0 < 0 means no true-region masks.  Without
// want_alpha a0..a2 may be null; with want_adjoints it also writes dta =
// D'alpha and dtu = D'u_new (B8's flags, tiled.cu).  Exactly one of the
// two flags is set (the pairs that a route launches); any other pair
// returns cudaErrorInvalidValue.  With halo given the lattice is the row
// slab sl (B8s, one problem): rows -1 and m0 come from the halo rows and
// every row mask is global; without it, rows wrap (B1, B4/B5, B8).
int launch_dual(bool want_alpha, bool want_adjoints, const float* theta, const float* u0,
                const float* u1, const float* u2, const float* kappa, const float* uscale,
                float* scal, Scales sc, int t0, int t1, float* a0, float* a1, float* a2,
                float* un0, float* un1, float* un2, float* dta, float* dtu, float* partials,
                unsigned* tickets, Lat L, Batch bt, cudaStream_t s,
                const DualHalo* halo = nullptr, Slab sl = Slab{0, 0});

// xupdate.cu: PCG of B3 from an already formed residual r (in work[0]).
struct PcgBuffers {
  float* r;
  float* p;
  float* ap;
  float* spec;  // the dense transforms' spectrum (B6); unused by the folded ones
};
struct Halves {
  const __nv_bfloat16 *te0, *to0, *te1, *to1;
};
// B6's operands on the tensor cores, each bf16 row zero-padded to a
// multiple of 8 elements (16 bytes, for cp.async) and each buffer 16-byte
// aligned: the dense DCT matrices T0 (m0 x ld0) and T1 (m1 x ld1), and
// scratch for a transform's input x and its first product tb (m0 x ld1).
struct Dense {
  __nv_bfloat16 *t0, *t1, *x, *tb;
  int ld0, ld1;
};
// B3-B5's operands on the tensor cores (dct_fold.cu), padded the same way:
// the halves Te0, To0 (h0 x ld0) and Te1, To1 (h1 x ld1), shared by the
// batch, and each problem's staged operands (4 blocks of m0 x ld1 at
// scratch + b * stride).
struct Folded {
  __nv_bfloat16 *te0, *to0, *te1, *to1;
  __nv_bfloat16* scratch;
  size_t stride;
  int ld0, ld1;
};
// The preconditioner's transforms: the folded halves (B3, B4, B5; even
// axes, the spectrum in packed order) or, with dn.t0 set, B6's dense
// matrices (any axes, natural order).
struct Transforms {
  Folded fd;
  Dense dn;
};
int run_pcg(const float* x_src, float* x_dst, const float* counts, Transforms tf,
            const float* eigs, float* scal, Scales sc, int n_steps, PcgBuffers wb,
            float* partials, Lat L, Batch bt, cudaStream_t s);

// dct_fold.cu: the folded packed 2-D DCT-II and its inverse on the tensor
// cores.  folded_layout places Folded's buffers in the scratch at extra
// (folded_scratch_bytes(L, B) bytes, 16-byte aligned) and
// launch_folded_setup zeroes it and fills the padded halves.  The forward
// transform of v ends in the spectral scale: zhat = rhat / (cbar + rho eigs)
// staged as the inverse's bf16 operand and the partials of <rhat, zhat>
// (folded_scale_blocks(L) per problem); the inverse writes out = z or,
// with rz_new >= 0, out = z + beta * out, beta = scal[rz_new] /
// max(scal[rz_old], eps).
size_t folded_scratch_bytes(Lat L, int B);
Folded folded_layout(void* extra, Lat L, int B);
int launch_folded_setup(Halves hv, Folded f, Lat L, int B, cudaStream_t s);
int folded_scale_blocks(Lat L);
int launch_dct2_folded_scaled(const float* v, Folded f, const float* eigs, const float* scal,
                              float* partials, Lat L, Batch bt, cudaStream_t s);
int launch_idct2_folded(Folded f, float* out, const float* scal, int rz_new, int rz_old, Lat L,
                        Batch bt, cudaStream_t s);
// xupdate.cu: the floats of a B3 or chain work buffer (`lattices` float
// lattices per problem, then the folded operands' scratch) and the Folded
// layout at its end.
long long folded_work(int lattices, int B, int m0, int m1);
Folded folded_in_work(float* work, int lattices, Lat L, int B);
// dct_mma.cu: the dense 2-D DCT-II T0 v T1' and its inverse T0' y T1 on the
// tensor cores, with the same epilogue as the folded inverse (one problem:
// any other bt returns cudaErrorInvalidValue); dense_layout places Dense's
// buffers in the scratch at extra (dense_scratch_bytes(L) bytes) and
// launch_dense_mats fills its padded T0 and T1 from the unpadded ones.
int dense_scratch_bytes(Lat L);
Dense dense_layout(void* extra, Lat L);
int launch_dense_mats(const __nv_bfloat16* t0, const __nv_bfloat16* t1, Dense dn, Lat L,
                      cudaStream_t s);
int launch_dct2_dense(const float* v, Dense dn, float* out, Lat L, Batch bt, cudaStream_t s);
int launch_idct2_dense(const float* y, Dense dn, float* out, const float* scal, int rz_new,
                       int rz_old, Lat L, Batch bt, cudaStream_t s);

}  // namespace mvtv

#define MVTV_CHECK(expr)                       \
  do {                                         \
    int _e = (expr);                           \
    if (_e != 0) return _e;                    \
  } while (0)

#define MVTV_LAUNCHED()                        \
  do {                                         \
    cudaError_t _e = cudaGetLastError();       \
    if (_e != cudaSuccess) return int(_e);     \
  } while (0)
