// K full ADMM iterations for each of B problems on the device, with no host
// synchronisation.
//
// Replaces multivartv_tpu/ops/pallas_kernels.py:_admm_iters_batched_kernel
// (admm_iters_2d_batched, B5) and, as its B = 1 case, _admm_iters_kernel
// (admm_iters_2d, B4); both run _admm_chain.  The TPU runs the K iterations
// inside one kernel on VMEM-resident state, one grid step per problem.
// Hopper has no 100 MB scratchpad, so each iteration is a chain of the stage
// kernels that B1 to B3 use, and the batch is their third launch dimension
// (blockIdx.z = b, common.cuh):
//   residual from (oty, alpha, u, theta)  (B2 folded into B3's r0)
//   -> PCG x-update (xupdate.cu)           -> theta
//   -> z/dual stage + Boyd sums (dual.cu)  -> alpha, u_new, stats (one launch)
//   -> rho_adapt (one thread per problem)  -> rho, u_scale, kappa
// So K iterations of B problems cost the same ~32 launches per iteration as
// one problem.  That is the point of the design on this card: at 316^2 one
// problem is 400 stencil blocks and a handful of DCT GEMM tiles, which
// leaves most of the 132 SMs idle between launches; five CV folds in one
// launch fill them.  At 1024^2 with B = 5 the state and the work lattices
// are about 15 x 5 x 4 MB = 300 MB of device memory.
//
// Per-problem operands: lambda, rho, u_scale, cbar (arrays of B), the state
// lattices (B, m0, m1), counts and oty at batch stride cstride (m0 * m1 per
// fold, 0 when a lambda sweep shares one problem), one row of the scalar
// buffer and of the partials each.  The DCT halves and the eigenvalues are
// shared.  act (null: all active) freezes problems: every block of every
// stage returns at once for a frozen problem, so its state rows are never
// written and its rho and u_scale pass through (init_scalars copies them in
// for every problem), and its statistics read 0.
//
// The state is updated in place, as the JAX kernel aliases it.  u
// ping-pongs between the caller's u and a scratch copy because the dual
// stage reads neighbours of the old u; an odd K ends with one copy back.
//
// The chain runs as a CUDA graph, captured once per argument set and
// replayed by one launch (launch_chain_graph): launched one by one, its ~33
// kernels per iteration left the card idle about half the time (PERF.md).
// Bound on the H100: the small stages between the x-update's DCT products,
// which run on the tensor cores (dct_fold.cu).  A persistent kernel is
// later work (ROADMAP B4).
#include <cstring>

#include "common.cuh"

namespace mvtv {

// Adaptive rho (reference adapt_step, solvers.cpp:77-94): the dual norm uses
// the pre-adaptation rho; the inverse dual rescale is carried as u_scale.
// rho grows by tau and shrinks by tau_shrink (the standalone C++ sibling's
// asymmetric rule; the TPU kernel's tau_shrink); without adapt rho stays and
// u_scale is 1 (the TPU kernel's adapt=False).
__global__ void rho_adapt_kernel(float* scal, int adapt, float tau, float tau_shrink, float band,
                                 Batch bt) {
  if (frozen(bt)) return;
  scal += scal_offset(bt);
  if (!adapt) {
    scal[S_USCALE] = 1.f;
    return;
  }
  const float rho = scal[S_RHO];
  const float pn = sqrtf(scal[S_STATS + 0]);
  const float dn = rho * sqrtf(scal[S_STATS + 3]);
  const bool grow = pn > band * dn, shrink = dn > band * pn;
  const float factor = grow ? tau : (shrink ? 1.f / tau_shrink : 1.f);
  const float rho_new = rho * factor;
  scal[S_RHO] = rho_new;
  scal[S_USCALE] = 1.f / factor;
  scal[S_KAPPA] = scal[S_LAM] / rho_new;
}

// dst_i = src_i for the three u blocks of every active problem.
__global__ void __launch_bounds__(kThreads)
copy_blocks_kernel(const float* __restrict__ s0, const float* __restrict__ s1,
                   const float* __restrict__ s2, float* __restrict__ d0, float* __restrict__ d1,
                   float* __restrict__ d2, Lat L, Batch bt) {
  if (frozen(bt)) return;
  const int j = blockIdx.x * TX + threadIdx.x;
  const int i = blockIdx.y * TY + threadIdx.y;
  if (i >= L.m0 || j >= L.m1) return;
  const size_t c = lat_offset(L) + size_t(i) * L.m1 + j;
  d0[c] = s0[c];
  d1[c] = s1[c];
  d2[c] = s2[c];
}

namespace {

// Every argument of one chain call.  A captured graph bakes in all of them,
// so the graph cache compares whole ChainArgs (zero-filled first, so that
// padding bytes compare equal).
struct ChainArgs {
  float *theta, *u0, *u1, *u2, *a0, *a1, *a2;
  const float *counts, *oty;
  long long cstride;
  const void *te0, *to0, *te1, *to1;
  const float *eigs, *lam, *rho, *uscale, *cbar;
  const int* act;
  float s_mix, s_ax1, s_ax0, tau, band, tau_shrink;
  int k_iters, n_steps, adapt, t0, t1;
  float *work, *partials, *scal;
  unsigned* tickets;
  int B, m0, m1, device;
};

int run_chain(const ChainArgs& a, cudaStream_t s) {
  const Lat L{a.m0, a.m1};
  const int B = a.B;
  const size_t bn = size_t(B) * L.m0 * L.m1;
  const int nb = stencil_blocks(L);
  const Batch bt{B, a.act, a.cstride, S_CG + 2 * (a.n_steps + 1), 5 * nb};
  float* const u_own[3] = {a.u0, a.u1, a.u2};
  float* const u_tmp[3] = {a.work, a.work + bn, a.work + 2 * bn};
  const PcgBuffers wb{a.work + 3 * bn, a.work + 4 * bn, a.work + 5 * bn, nullptr};
  const Halves hv{static_cast<const __nv_bfloat16*>(a.te0),
                  static_cast<const __nv_bfloat16*>(a.to0),
                  static_cast<const __nv_bfloat16*>(a.te1),
                  static_cast<const __nv_bfloat16*>(a.to1)};
  const Transforms tf{folded_in_work(a.work, 6, L, B), Dense{}};
  const Scales sc{a.s_mix, a.s_ax1, a.s_ax0};
  float* scal = a.scal;
  MVTV_CHECK(launch_folded_setup(hv, tf.fd, L, B, s));
  MVTV_CHECK(launch_init_scalars(scal, a.lam, a.rho, a.uscale, a.cbar, nullptr, bt, s));
  for (int k = 0; k < a.k_iters; ++k) {
    float* const* u_src = k % 2 == 0 ? u_own : u_tmp;
    float* const* u_dst = k % 2 == 0 ? u_tmp : u_own;
    MVTV_CHECK(launch_residual(B_FORMED, nullptr, a.theta, a.counts, a.oty, a.a0, a.a1, a.a2,
                               u_src[0], u_src[1], u_src[2], scal, sc, wb.r, L, bt, s));
    MVTV_CHECK(run_pcg(a.theta, a.theta, a.counts, tf, a.eigs, scal, sc, a.n_steps, wb,
                       a.partials, L, bt, s));
    MVTV_CHECK(launch_dual(true, false, a.theta, u_src[0], u_src[1], u_src[2],
                           scal + S_KAPPA, scal + S_USCALE, scal, sc, a.t0, a.t1, a.a0, a.a1,
                           a.a2, u_dst[0], u_dst[1], u_dst[2], nullptr, nullptr, a.partials,
                           a.tickets, L, bt, s));
    rho_adapt_kernel<<<dim3(1, 1, B), 1, 0, s>>>(scal, a.adapt, a.tau, a.tau_shrink, a.band, bt);
    MVTV_LAUNCHED();
  }
  if (a.k_iters % 2 == 1) {
    copy_blocks_kernel<<<stencil_grid(L, B), dim3(TX, TY), 0, s>>>(
        u_tmp[0], u_tmp[1], u_tmp[2], a.u0, a.u1, a.u2, L, bt);
    MVTV_LAUNCHED();
  }
  return 0;
}

// The chain as a CUDA graph: captured once per distinct ChainArgs on a
// capture stream of its own (the caller's may be the legacy default
// stream, which cannot capture), then replayed by one launch on the
// caller's stream.  Replays read every value (state, scalars, the
// activity mask) from device memory at run time; only the arguments
// themselves are baked in.  The last kGraphs argument sets are kept; a
// new one replaces the least recently used after the device has finished
// with it.
constexpr int kGraphs = 8;
struct GraphEntry {
  ChainArgs key;
  cudaGraphExec_t exec;
  unsigned long long used;
};
GraphEntry g_graphs[kGraphs] = {};
unsigned long long g_tick = 0;
constexpr int kMaxDevices = 16;
cudaStream_t g_capture[kMaxDevices] = {};

int capture_chain(const ChainArgs& a, cudaGraphExec_t* exec) {
  if (a.device < 0 || a.device >= kMaxDevices) return int(cudaErrorInvalidDevice);
  cudaStream_t& cs = g_capture[a.device];
  if (!cs) MVTV_CHECK(int(cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking)));
  MVTV_CHECK(int(cudaStreamBeginCapture(cs, cudaStreamCaptureModeRelaxed)));
  const int err = run_chain(a, cs);
  cudaGraph_t graph = nullptr;
  const int end = int(cudaStreamEndCapture(cs, &graph));
  const int inst = err || end ? 0 : int(cudaGraphInstantiate(exec, graph, 0));
  if (graph) cudaGraphDestroy(graph);
  MVTV_CHECK(err);
  MVTV_CHECK(end);
  return inst;
}

int launch_chain_graph(const ChainArgs& a, cudaStream_t s) {
  GraphEntry* hit = nullptr;
  GraphEntry* lru = &g_graphs[0];
  for (GraphEntry& e : g_graphs) {
    if (e.exec && std::memcmp(&e.key, &a, sizeof a) == 0) hit = &e;
    if (!e.exec || (lru->exec && e.used < lru->used)) lru = &e;
  }
  if (!hit) {
    if (lru->exec) {
      MVTV_CHECK(int(cudaDeviceSynchronize()));
      cudaGraphExecDestroy(lru->exec);
      lru->exec = nullptr;
    }
    cudaGraphExec_t exec = nullptr;
    MVTV_CHECK(capture_chain(a, &exec));
    lru->key = a;
    lru->exec = exec;
    hit = lru;
  }
  hit->used = ++g_tick;
  return int(cudaGraphLaunch(hit->exec, s));
}

}  // namespace
}  // namespace mvtv

// B5 entry point (B4 is B = 1).  theta, u0..u2 and a0..a2 are (B, m0, m1)
// and are updated in place; work holds mvtv_admm_iters_2d_batched_work(B,
// m0, m1) floats: 6 x (B, m0, m1) lattices (u scratch x3, r, p, ap), then
// the folded products' padded bf16 operands (dct_fold.cu); partials B rows
// of 5 * (stencil blocks of one problem), scal B rows of S_CG + 2 (n_steps
// + 1), tickets B unsigneds that are 0 (the dual stage's last-CTA tickets,
// left 0).  After the call row b of scal holds problem b's rho and u_scale
// after its last iteration and that iteration's 6 statistics.  t0 < 0: no
// true_m masks.  adapt, tau, tau_shrink and band: rho_adapt_kernel.  The
// chain replays a captured graph where every argument repeats, so callers
// keep work, partials, tickets, scal and their other inputs at the same
// addresses across the calls of one solve.
extern "C" long long mvtv_admm_iters_2d_batched_work(int B, int m0, int m1) {
  return mvtv::folded_work(6, B, m0, m1);
}

extern "C" int mvtv_admm_iters_2d_batched(
    float* theta, float* u0, float* u1, float* u2, float* a0, float* a1, float* a2,
    const float* counts, const float* oty, long long cstride, const void* te0, const void* to0,
    const void* te1, const void* to1, const float* eigs, const float* lam, const float* rho,
    const float* uscale, const float* cbar, const int* act, float s_mix, float s_ax1,
    float s_ax0, int k_iters, int n_steps, float tau, float band, float tau_shrink, int adapt,
    int t0, int t1, float* work, float* partials, unsigned* tickets, float* scal, int B, int m0,
    int m1, void* stream) {
  using namespace mvtv;
  ChainArgs a;
  std::memset(&a, 0, sizeof a);
  a.theta = theta, a.u0 = u0, a.u1 = u1, a.u2 = u2, a.a0 = a0, a.a1 = a1, a.a2 = a2;
  a.counts = counts, a.oty = oty, a.cstride = cstride;
  a.te0 = te0, a.to0 = to0, a.te1 = te1, a.to1 = to1;
  a.eigs = eigs, a.lam = lam, a.rho = rho, a.uscale = uscale, a.cbar = cbar, a.act = act;
  a.s_mix = s_mix, a.s_ax1 = s_ax1, a.s_ax0 = s_ax0, a.tau = tau, a.band = band;
  a.tau_shrink = tau_shrink;
  a.k_iters = k_iters, a.n_steps = n_steps, a.adapt = adapt, a.t0 = t0, a.t1 = t1;
  a.work = work, a.partials = partials, a.tickets = tickets, a.scal = scal;
  a.B = B, a.m0 = m0, a.m1 = m1;
  MVTV_CHECK(int(cudaGetDevice(&a.device)));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MVTV_CHECK(launch_chain_graph(a, s));
  return int(cudaGetLastError());
}
