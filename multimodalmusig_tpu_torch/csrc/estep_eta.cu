// The η side of the MMCTM E-step, restart-batched and fused into one kernel
// for Hopper (sm_90a): ζ, then N/ζ, then the ν solve, then the λ solve.
//
// Replaces the TPU kernel tools/pallas_experiments/estep_kernel.py
// (estep_eta_fused, body _estep_solve), which did the same for one shared
// μ/Σ⁻¹; here every restart r has its own μ_r and Σ_r⁻¹, as in the λ kernel.
// For every restart r and document d, with ζ and N/ζ from the incoming λ and
// ν (src/MMCTM.jl:172-181, 119-125):
//   ζ_dm    = Σ_{k ∈ block m} exp(λ_k + ν_k/2);
//   Ndivζ_k = N_dm / ζ_dm for k in block m;
//   ν'      = ops/solvers.py maximize_nu: nu_n_iter fixed-point sweeps
//             ν = max(1/(2a + b·e^{ν/2}), 1e-7), a = ½Σ⁻¹_kk, b = Ndivζ·e^λ,
//             with b·e^{ν/2} taken as 0 where b = 0 and its exponent clipped
//             at 60, then 4 guarded Newton steps; it reads the incoming λ;
//   λ'      = the λ solve of lambda_solve.cuh from the incoming λ, with ν'.
// It computes what ops/estep_kernel.py estep_eta_fused_plain (the port's
// update_zeta → calculate_Ndivzeta → maximize_nu → maximize_lambda) computes,
// step for step, in float32. Clamps propagate NaN as torch.clamp does, so a
// dead lane (an all-NaN Σ_r⁻¹) stays NaN; it cannot touch another restart,
// whose problems run in other blocks.
//
// Layout: the λ kernel's. One group of P lanes serves one (r, d) problem, one
// coordinate per lane; a block of 256 threads holds 256 / P documents of one
// restart; WarpGroup for MK ≤ 32, BlockGroup for MK ≤ 128. Inside a group:
//  * each lane finds its modality m_j from the block offsets, which come as a
//    kernel argument;
//  * ζ is a segmented sum over the group: one masked group sum per modality,
//    M of them in every group, so every thread of a BlockGroup block meets
//    every barrier; lane m writes ζ_dm;
//  * each lane forms its own Ndivζ and runs the ν solve elementwise in
//    registers;
//  * then the shared λ solve with the new ν.
// Padding lanes (j ≥ MK) and padding documents (d ≥ D) stay inert, as the
// TPU kernel keeps them: a = ½ (identity row), b = 0, ν = 1, λ = μ = 0.
//
// Bounds. The ζ and ν steps add about 40·MK exps and divisions per problem
// to the λ solve's 12 kFLOP (MK = 14, f32 CAVI budgets), and read N and ν
// and write ζ and ν besides the λ kernel's traffic: at R = 100 restarts of
// the D = 560, MK = 14 BRCA workload about 0.7 GFLOP and 25 MB per CAVI
// iteration, far below the card's float32 rate and its memory bandwidth. Like
// the λ kernel it is bound by latency and by its launch; what it saves is
// the hundred or so launches of the plain ζ/ν sequence (each sweep of the ν
// fixed point is several elementwise kernels) and the round trips of ζ,
// Ndivζ and ν through device memory.
//
// Full-precision float32 throughout: expf, and no --use_fast_math.

#include "lambda_solve.cuh"

namespace {

using namespace lambda_solve;

constexpr float kNuLowerBound = 1e-7f;  // solvers.NU_LOWER_BOUND
constexpr int kNuPolish = 4;            // solvers.NU_POLISH_ITERS

// The per-modality topic blocks: modality m holds coordinates
// [offset[m], offset[m + 1]); offset[M] = MK.
struct Blocks {
  int M;
  int offset[kMaxMK + 1];
};

// max(x, lo) and min(x, hi) that return a NaN x unchanged, as torch.clamp.
__device__ __forceinline__ float clamp_below(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_above(float x, float hi) { return x > hi ? hi : x; }

// ζ, ν' and λ' for this thread's (r, d, j), shared by both layouts.
template <typename G>
__device__ __forceinline__ void estep(G& grp, const float* lam0, const float* nu0,
                                      const float* N, const float* st, const float* mu,
                                      float* zeta_out, float* nu_out, float* lam_out,
                                      const Blocks& blk, int r, int d, int j, int D, int MK,
                                      int n_iter, int cg_iter, int polish_iter,
                                      int nu_n_iter) {
  const bool live = j < MK && d < D;
  const size_t row = static_cast<size_t>(r) * D + d;
  const size_t off = row * MK + j;
  const float lam = live ? lam0[off] : 0.f;
  const float nu_in = live ? nu0[off] : 1.f;
  const float st_j = live ? st[off] : 0.f;
  const float mu_j = live ? mu[static_cast<size_t>(r) * MK + j] : 0.f;

  int m_j = 0;
  for (int m = 1; m < blk.M; ++m) m_j += j >= blk.offset[m];

  // ζ from the incoming λ and ν; a padding lane adds 0 to every block.
  const float e = live ? expf(lam + 0.5f * nu_in) : 0.f;
  float zeta_j = 1.f;
  for (int m = 0; m < blk.M; ++m) {
    const float z = grp.sum(m_j == m ? e : 0.f);
    if (m_j == m) zeta_j = z;
    if (j == m && d < D) zeta_out[row * blk.M + m] = z;
  }
  const float ndz = live ? N[static_cast<size_t>(d) * blk.M + m_j] / zeta_j : 0.f;

  // ν (ops/solvers.py maximize_nu), elementwise, from the incoming λ.
  const float a = 0.5f * grp.diag;
  const float b = ndz * expf(lam);
  auto wexp = [&](float v) {
    return b > 0.f ? b * expf(clamp_above(0.5f * v, kExpClip)) : 0.f;
  };
  float nu = nu_in;
  for (int it = 0; it < nu_n_iter; ++it)
    nu = clamp_below(1.f / (2.f * a + wexp(nu)), kNuLowerBound);
  for (int it = 0; it < kNuPolish; ++it) {
    const float w = wexp(nu);
    const float g = -a - 0.5f * w + 0.5f / nu;
    const float hess = -0.25f * w - 0.5f / (nu * nu);
    const float step = clamp_below(nu - g / hess, kNuLowerBound);
    nu = isfinite(step) ? step : nu;
  }
  if (live) nu_out[off] = nu;

  // λ from the incoming λ, with the new ν.
  const float lam_new = solve_lane(grp, lam, nu, ndz, st_j, mu_j, n_iter, cg_iter, polish_iter);
  if (live) lam_out[off] = lam_new;
}

template <int P>
__global__ void __launch_bounds__(kThreads)
estep_eta_warp_kernel(const float* __restrict__ lam0, const float* __restrict__ nu0,
                      const float* __restrict__ N, const float* __restrict__ st,
                      const float* __restrict__ mu, const float* __restrict__ inv_sigma,
                      float* __restrict__ zeta, float* __restrict__ nu_out,
                      float* __restrict__ lam_out, const Blocks blk, int D, int MK, int n_iter,
                      int cg_iter, int polish_iter, int nu_n_iter) {
  __shared__ float S[P * P];
  const int r = blockIdx.y;
  stage_inv_sigma<P>(S, inv_sigma + static_cast<size_t>(r) * MK * MK, MK);

  const int j = threadIdx.x % P;
  const int d = blockIdx.x * (kThreads / P) + threadIdx.x / P;
  WarpGroup<P> grp;
  bind_warp_group<P>(grp, S, j);
  estep(grp, lam0, nu0, N, st, mu, zeta, nu_out, lam_out, blk, r, d, j, D, MK, n_iter, cg_iter,
        polish_iter, nu_n_iter);
}

template <int P>
__global__ void __launch_bounds__(kThreads)
estep_eta_block_kernel(const float* __restrict__ lam0, const float* __restrict__ nu0,
                       const float* __restrict__ N, const float* __restrict__ st,
                       const float* __restrict__ mu, const float* __restrict__ inv_sigma,
                       float* __restrict__ zeta, float* __restrict__ nu_out,
                       float* __restrict__ lam_out, const Blocks blk, int D, int MK,
                       int n_iter, int cg_iter, int polish_iter, int nu_n_iter) {
  extern __shared__ float smem[];
  const int r = blockIdx.y;
  stage_inv_sigma<P>(smem, inv_sigma + static_cast<size_t>(r) * MK * MK, MK);

  BlockGroup<P> grp;
  bind_block_group<P>(grp, smem);
  const int d = blockIdx.x * (kThreads / P) + threadIdx.x / P;
  estep(grp, lam0, nu0, N, st, mu, zeta, nu_out, lam_out, blk, r, d, grp.j, D, MK, n_iter,
        cg_iter, polish_iter, nu_n_iter);
}

struct Args {
  const float *lam0, *nu0, *N, *st, *mu, *inv_sigma;
  float *zeta, *nu_out, *lam_out;
  int R, D, MK, n_iter, cg_iter, polish_iter, nu_n_iter;
};

template <int P>
int launch_warp(const Args& a, const Blocks& blk, cudaStream_t stream) {
  constexpr int kDocsPerBlock = kThreads / P;
  const dim3 grid((a.D + kDocsPerBlock - 1) / kDocsPerBlock, a.R);
  estep_eta_warp_kernel<P><<<grid, kThreads, 0, stream>>>(
      a.lam0, a.nu0, a.N, a.st, a.mu, a.inv_sigma, a.zeta, a.nu_out, a.lam_out, blk, a.D,
      a.MK, a.n_iter, a.cg_iter, a.polish_iter, a.nu_n_iter);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_block(const Args& a, const Blocks& blk, cudaStream_t stream) {
  constexpr int kDocsPerBlock = kThreads / P;
  constexpr size_t smem = block_smem_bytes<P>();
  const cudaError_t rc = allow_smem(estep_eta_block_kernel<P>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((a.D + kDocsPerBlock - 1) / kDocsPerBlock, a.R);
  estep_eta_block_kernel<P><<<grid, kThreads, smem, stream>>>(
      a.lam0, a.nu0, a.N, a.st, a.mu, a.inv_sigma, a.zeta, a.nu_out, a.lam_out, blk, a.D,
      a.MK, a.n_iter, a.cg_iter, a.polish_iter, a.nu_n_iter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface, bound with ctypes (ops/estep_kernel.py). All arrays are
// contiguous float32 on the current device: lam0/nu/st and the outputs
// nu_out/lam_out (R, D, MK), N (D, M), mu (R, MK), inv_sigma (R, MK, MK), the
// output zeta (R, D, M). K (host memory) holds the M ≥ 1 topic counts, each
// ≥ 1, summing to MK ≤ 128. Launches on `stream` without synchronising and
// returns the CUDA error code (0 = launched).
extern "C" int estep_eta_launch(const float* lam0, const float* nu, const float* N,
                                const float* st, const float* mu, const float* inv_sigma,
                                float* zeta, float* nu_out, float* lam_out, const int* K, int M,
                                int R, int D, int MK, int n_iter, int cg_iter, int polish_iter,
                                int nu_n_iter, void* stream) {
  if (R <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (MK < 1 || MK > kMaxMK || R > 65535 || M < 1 || M > MK)
    return static_cast<int>(cudaErrorInvalidValue);
  Blocks blk;
  blk.M = M;
  blk.offset[0] = 0;
  for (int m = 0; m < M; ++m) {
    if (K[m] < 1) return static_cast<int>(cudaErrorInvalidValue);
    blk.offset[m + 1] = blk.offset[m] + K[m];
  }
  if (blk.offset[M] != MK) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{lam0, nu, N, st, mu, inv_sigma, zeta, nu_out, lam_out,
               R, D, MK, n_iter, cg_iter, polish_iter, nu_n_iter};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (MK <= 16) return launch_warp<16>(a, blk, s);
  if (MK <= 32) return launch_warp<32>(a, blk, s);
  if (MK <= 64) return launch_block<64>(a, blk, s);
  return launch_block<128>(a, blk, s);
}
