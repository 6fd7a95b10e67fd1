// Restart-batched λ solve of the MMCTM E-step, fused into one kernel for
// Hopper (sm_90a).
//
// Replaces the TPU kernel multimodalmusig_tpu/ops/pallas/lambda_kernel.py
// (maximize_lambda_fused_restarts, body _lambda_solve; and
// maximize_lambda_fused, the same solve with one shared μ/Σ⁻¹, which is this
// kernel at R = 1). For every restart r and document d it runs the damped
// Newton/PCG solve of lambda_solve.cuh (which documents the solve, its two
// group layouts and their barrier rule) over MK ≤ 128 coordinates, and
// computes what ops/solvers.py maximize_lambda (the plain version) computes,
// step for step, in float32. The fused η-side kernel (estep_eta.cu) runs the
// same solve after its ζ and ν steps.
//
// Layout. One group of P lanes serves one (r, d) problem, one coordinate per
// lane; a block of 256 threads holds 256 / P documents of one restart:
// WarpGroup for MK ≤ 32 (Σ_r⁻¹ rows in registers), BlockGroup for MK ≤ 128
// (Σ_r⁻¹ in dynamic shared memory).
//
// Bounds. At the f32 CAVI budgets (Newton 3, PCG 4, polish 1) one problem
// costs about 12 kFLOP at MK = 14 and moves about 5·MK·4 bytes; at R = 100
// restarts of the D = 560, MK = 14 BRCA workload that is about 0.7 GFLOP and
// 16 MB per CAVI iteration, far below both the card's float32 rate and its
// memory bandwidth. The kernel is bound by latency (the dependent chains of
// PCG and the line search) and by its launch; the design keeps every
// intermediate on chip and launches once per λ solve instead of the hundreds
// of small kernels the plain version launches. The BlockGroup layout adds one
// block barrier per reduction and per matvec (about 110 per problem at the
// CAVI budgets), and re-reads Σ_r⁻¹ from L2 once per block of 256 / P
// documents. On an H100 80GB HBM3 at 700 W, R = 100 by D = 560 problems took
// 0.20 ms at MK = 14, 1.5 ms at MK = 40 and 5.2 ms at MK = 128.

#include "lambda_solve.cuh"

namespace {

using namespace lambda_solve;

// The solve for this thread's (r, d, j), shared by both layouts.
template <typename G>
__device__ __forceinline__ void solve(G& grp, const float* lam0, const float* nu,
                                      const float* ndz, const float* st, const float* mu,
                                      float* out, int r, int d, int j, int D, int MK,
                                      int n_iter, int cg_iter, int polish_iter) {
  const bool live = j < MK && d < D;
  const size_t off = (static_cast<size_t>(r) * D + d) * MK + j;
  const float lam = live ? lam0[off] : 0.f;
  const float nu_j = live ? nu[off] : 1.f;
  const float ndz_j = live ? ndz[off] : 0.f;
  const float st_j = live ? st[off] : 0.f;
  const float mu_j = live ? mu[static_cast<size_t>(r) * MK + j] : 0.f;
  const float out_j =
      solve_lane(grp, lam, nu_j, ndz_j, st_j, mu_j, n_iter, cg_iter, polish_iter);
  if (live) out[off] = out_j;
}

template <int P>
__global__ void __launch_bounds__(kThreads)
lambda_newton_warp_kernel(const float* __restrict__ lam0, const float* __restrict__ nu,
                          const float* __restrict__ ndz, const float* __restrict__ st,
                          const float* __restrict__ mu, const float* __restrict__ inv_sigma,
                          float* __restrict__ out, int D, int MK, int n_iter, int cg_iter,
                          int polish_iter) {
  __shared__ float S[P * P];
  const int r = blockIdx.y;
  stage_inv_sigma<P>(S, inv_sigma + static_cast<size_t>(r) * MK * MK, MK);

  const int j = threadIdx.x % P;
  const int d = blockIdx.x * (kThreads / P) + threadIdx.x / P;
  WarpGroup<P> grp;
  bind_warp_group<P>(grp, S, j);
  solve(grp, lam0, nu, ndz, st, mu, out, r, d, j, D, MK, n_iter, cg_iter, polish_iter);
}

template <int P>
__global__ void __launch_bounds__(kThreads)
lambda_newton_block_kernel(const float* __restrict__ lam0, const float* __restrict__ nu,
                           const float* __restrict__ ndz, const float* __restrict__ st,
                           const float* __restrict__ mu, const float* __restrict__ inv_sigma,
                           float* __restrict__ out, int D, int MK, int n_iter, int cg_iter,
                           int polish_iter) {
  extern __shared__ float smem[];
  const int r = blockIdx.y;
  stage_inv_sigma<P>(smem, inv_sigma + static_cast<size_t>(r) * MK * MK, MK);

  BlockGroup<P> grp;
  bind_block_group<P>(grp, smem);
  const int d = blockIdx.x * (kThreads / P) + threadIdx.x / P;
  solve(grp, lam0, nu, ndz, st, mu, out, r, d, grp.j, D, MK, n_iter, cg_iter, polish_iter);
}

template <int P>
int launch_warp(const float* lam0, const float* nu, const float* ndz, const float* st,
                const float* mu, const float* inv_sigma, float* out, int R, int D, int MK,
                int n_iter, int cg_iter, int polish_iter, cudaStream_t stream) {
  constexpr int kDocsPerBlock = kThreads / P;
  const dim3 grid((D + kDocsPerBlock - 1) / kDocsPerBlock, R);
  lambda_newton_warp_kernel<P><<<grid, kThreads, 0, stream>>>(
      lam0, nu, ndz, st, mu, inv_sigma, out, D, MK, n_iter, cg_iter, polish_iter);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_block(const float* lam0, const float* nu, const float* ndz, const float* st,
                 const float* mu, const float* inv_sigma, float* out, int R, int D, int MK,
                 int n_iter, int cg_iter, int polish_iter, cudaStream_t stream) {
  constexpr int kDocsPerBlock = kThreads / P;
  constexpr size_t smem = block_smem_bytes<P>();
  const cudaError_t rc = allow_smem(lambda_newton_block_kernel<P>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((D + kDocsPerBlock - 1) / kDocsPerBlock, R);
  lambda_newton_block_kernel<P><<<grid, kThreads, smem, stream>>>(
      lam0, nu, ndz, st, mu, inv_sigma, out, D, MK, n_iter, cg_iter, polish_iter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes (ops/lambda_kernel.py). All arrays are
// contiguous float32 on the current device: lam0/nu/ndz/st/out (R, D, MK),
// mu (R, MK), inv_sigma (R, MK, MK), 1 ≤ MK ≤ 128. Launches on `stream`
// without synchronising and returns the CUDA error code (0 = launched).
extern "C" int lambda_newton_launch(const float* lam0, const float* nu, const float* ndz,
                                    const float* st, const float* mu,
                                    const float* inv_sigma, float* out, int R, int D,
                                    int MK, int n_iter, int cg_iter, int polish_iter,
                                    void* stream) {
  if (R <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (MK < 1 || MK > kMaxMK || R > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (MK <= 16)
    return launch_warp<16>(lam0, nu, ndz, st, mu, inv_sigma, out, R, D, MK, n_iter, cg_iter,
                           polish_iter, s);
  if (MK <= 32)
    return launch_warp<32>(lam0, nu, ndz, st, mu, inv_sigma, out, R, D, MK, n_iter, cg_iter,
                           polish_iter, s);
  if (MK <= 64)
    return launch_block<64>(lam0, nu, ndz, st, mu, inv_sigma, out, R, D, MK, n_iter, cg_iter,
                            polish_iter, s);
  return launch_block<128>(lam0, nu, ndz, st, mu, inv_sigma, out, R, D, MK, n_iter, cg_iter,
                           polish_iter, s);
}
