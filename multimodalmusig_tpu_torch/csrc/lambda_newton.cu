// Restart-batched λ solve of the MMCTM E-step, fused into one kernel for
// Hopper (sm_90a).
//
// Replaces the TPU kernel multimodalmusig_tpu/ops/pallas/lambda_kernel.py
// (maximize_lambda_fused_restarts, body _lambda_solve; and
// maximize_lambda_fused, the same solve with one shared μ/Σ⁻¹, which is this
// kernel at R = 1). For every restart r and document d it runs the damped
// Newton/PCG solve of lambda_solve.cuh (which documents the solve, its
// layouts and their barrier rule) over MK ≤ 128 coordinates, and computes
// what ops/solvers.py maximize_lambda (the plain version) computes, step for
// step, in float32. The fused η-side kernel (estep_eta.cu) runs the same
// solve after its ζ and ν steps.
//
// Layouts. The wrapper (ops/lambda_kernel.py launch_geometry) picks one from
// MK and the number of problems R·D and passes it, with P and the documents
// per block, to lambda_newton_launch:
//  * "thread": one thread per (r, d) problem, ThreadProblem<P> with P = MK
//    rounded up to even (up to 16; 20, 24, 28 or 32 above). A block is up to
//    64 documents of one restart, staged into shared-memory columns by
//    coalesced loads and written back the same way; Σ_r⁻¹, its diagonal and
//    μ_r sit in shared memory. No shuffles, no idle lanes.
//  * "pair": two neighbouring threads per problem, ThreadProblem<10, ·, 2>,
//    each holding 10 of the 20 ≥ MK coordinates in registers (MK 17–20,
//    PCAWG's MK 19); a matvec swaps the halves of its operand (10 shuffles)
//    and a dot product adds the two partial sums (one shuffle). Up to 64
//    documents (128 threads) a block.
//  * "warp": a WarpGroup<16 or 32> per problem, one coordinate per lane, a
//    block of `docs` problems; for calls with too few problems to fill the
//    card one per thread (the single-model entry), where the time is one
//    problem's chain of dependent exchanges, which the batched reductions of
//    the group solve keep short.
//  * "block": a BlockGroup<64 or 128> per problem (MK > 32), 256 threads a
//    block.
// Padding documents of the thread and pair layouts keep their restart's μ
// and solve a well-posed problem that is never written.
//
// Bounds. At the f32 CAVI budgets (Newton 3, PCG 4, polish 1) one problem
// costs about 12 kFLOP at MK = 14 and moves about 5·MK·4 bytes; at R = 100
// restarts of the D = 560, MK = 14 BRCA workload that is about 0.7 GFLOP and
// 16 MB per CAVI iteration, an operations bound of 13 µs (chip_smoke.py
// lambda_bound). The thread and pair layouts are bound by their instruction
// issue (the matvecs' FMAs and broadcast loads, the fast paths of the PCG
// divisions and of the line search's square roots, the exps), the group
// layouts by the latency of their shuffles and, in BlockGroup, block
// barriers (64 per problem at the CAVI budgets); all keep every
// intermediate on chip and launch once per λ solve instead of the hundreds
// of small kernels the plain version launches. PERF.md holds the times of
// every layout on an H100 (lambda_bench.py).
//
// Full-precision float32 throughout: expf, sqrtf and IEEE divisions, and no
// --use_fast_math.

#include "lambda_solve.cuh"

namespace {

using namespace lambda_solve;

constexpr int kMaxThreadDocs = 64;  // documents per block of the thread and pair layouts, at most

enum Layout { kThreadLayout = 0, kPairLayout = 1, kWarpLayout = 2, kBlockLayout = 3 };

// Column stride of the thread and pair layouts: a block's threads, plus one.
template <int Split>
__host__ __device__ constexpr int col_stride() { return kMaxThreadDocs * Split + 1; }

// Blocks an SM holds: in the thread layout 6 at P ≤ 14 (168 registers a
// thread), 5 at P = 16, as the η kernel's; the compiler's choice above; 3
// blocks of 128 threads in the pair layout.
__host__ __device__ constexpr int min_blocks(int P, int Split) {
  return Split == 2 ? 3 : P <= 14 ? 6 : P <= 16 ? 5 : 1;
}

// ---------------------------------------------------------------------------
// The thread and pair layouts.

template <int P, int Split>
__global__ void __launch_bounds__(kMaxThreadDocs * Split, min_blocks(P, Split))
lambda_newton_thread_kernel(const float* __restrict__ lam0, const float* __restrict__ nu,
                            const float* __restrict__ ndz, const float* __restrict__ st,
                            const float* __restrict__ mu, const float* __restrict__ inv_sigma,
                            float* __restrict__ out, int D, int MK, int n_iter, int cg_iter,
                            int polish_iter) {
  constexpr int Stride = col_stride<Split>();
  using Problem = ThreadProblem<P, Stride, Split>;
  constexpr int N = Problem::N, P4 = Problem::P4;
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);  // [N][P4]
  float* diag = S + N * P4;                    // [P4]
  float* mu_s = diag + P4;                     // [P4]
  float* cols = mu_s + P4;                     // [kColumns][P][Stride]
  const int T = blockDim.x, t = threadIdx.x, per_block = T / Split;
  const int r = blockIdx.y, d0 = blockIdx.x * per_block;
  const int docs = min(per_block, D - d0);  // live documents of this block
  // coordinate j of document doc: thread doc·Split + j / P, element j % P
  auto col = [&](int c, int j, int doc) -> float& {
    const int part = j / P;
    return cols[(c * P + j - part * P) * Stride + doc * Split + part];
  };

  const float* S_r = inv_sigma + static_cast<size_t>(r) * MK * MK;
  for (int idx = t; idx < N * P4; idx += T) {
    const int i = idx / P4, k = idx % P4;
    const float s = (i < MK && k < MK) ? S_r[i * MK + k] : (i == k ? 1.f : 0.f);
    S[idx] = s;
    if (i == k) diag[i] = s;
  }
  for (int j = t; j < P4; j += T) mu_s[j] = j < MK ? mu[static_cast<size_t>(r) * MK + j] : 0.f;
  for (int idx = t; idx < N * per_block; idx += T) {  // the inert padding
    const int j = idx / per_block, doc = idx % per_block;
    if (j >= MK || doc >= docs) {
      col(kLam, j, doc) = 0.f;
      col(kNu, j, doc) = 1.f;
      col(kNdz, j, doc) = 0.f;
      col(kSt, j, doc) = 0.f;
    }
  }
  const size_t base = (static_cast<size_t>(r) * D + d0) * MK;
  for (int idx = t; idx < docs * MK; idx += T) {  // coalesced: the block's rows are contiguous
    const int doc = idx / MK, j = idx - doc * MK;
    col(kLam, j, doc) = lam0[base + idx];
    col(kNu, j, doc) = nu[base + idx];
    col(kNdz, j, doc) = ndz[base + idx];
    col(kSt, j, doc) = st[base + idx];
  }
  __syncthreads();

  const int part = t % Split;
  Problem prob{S + part * P * P4, diag + part * P, mu_s + part * P, cols + t, part};
  prob.solve(n_iter, cg_iter, polish_iter);

  __syncthreads();
  for (int idx = t; idx < docs * MK; idx += T) {
    const int doc = idx / MK, j = idx - doc * MK;
    out[base + idx] = col(kLam, j, doc);
  }
}

// ---------------------------------------------------------------------------
// The group layouts.

// The solve for this thread's (r, d, j), shared by both group layouts.
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

// At least 3 blocks of 256 threads an SM: up to 80 registers a thread,
// which hold the Newton step's batch of 22 sums beside the 32-float Σ⁻¹
// row without a spill (without a block count ptxas took 64 and spilled;
// with 1 it took 88, 2 blocks an SM, and a call of 2,240 problems ran in
// two waves), and one wave on 132 SMs for every call below FEW_PROBLEMS.
template <int P>
__global__ void __launch_bounds__(kThreads, 3)
lambda_newton_warp_kernel(const float* __restrict__ lam0, const float* __restrict__ nu,
                          const float* __restrict__ ndz, const float* __restrict__ st,
                          const float* __restrict__ mu, const float* __restrict__ inv_sigma,
                          float* __restrict__ out, int D, int MK, int n_iter, int cg_iter,
                          int polish_iter) {
  __shared__ float S[P * P];
  const int r = blockIdx.y;
  stage_inv_sigma<P>(S, inv_sigma + static_cast<size_t>(r) * MK * MK, MK);

  const int j = threadIdx.x % P;
  const int d = blockIdx.x * (blockDim.x / P) + threadIdx.x / P;
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

// ---------------------------------------------------------------------------
// Launch.

struct Args {
  const float *lam0, *nu, *ndz, *st, *mu, *inv_sigma;
  float* out;
  int R, D, MK, n_iter, cg_iter, polish_iter;
};

template <typename Kernel>
int launch(Kernel kernel, const Args& a, int docs, int threads, size_t smem, cudaStream_t stream) {
  const cudaError_t rc = allow_smem(kernel, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((a.D + docs - 1) / docs, a.R);
  kernel<<<grid, threads, smem, stream>>>(a.lam0, a.nu, a.ndz, a.st, a.mu, a.inv_sigma, a.out,
                                          a.D, a.MK, a.n_iter, a.cg_iter, a.polish_iter);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int Split>
int launch_thread(const Args& a, int docs, cudaStream_t stream) {
  // Shared memory, not L1, bounds the blocks an SM holds: ask for its most.
  static const cudaError_t carveout = cudaFuncSetAttribute(
      lambda_newton_thread_kernel<P, Split>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carveout != cudaSuccess) return static_cast<int>(carveout);
  return launch(lambda_newton_thread_kernel<P, Split>, a, docs, docs * Split,
                sizeof(float) * thread_smem_floats<P, col_stride<Split>(), Split>(), stream);
}

int launch_thread_layout(int P, const Args& a, int docs, cudaStream_t s) {
  switch (P) {
    case 2: return launch_thread<2, 1>(a, docs, s);
    case 4: return launch_thread<4, 1>(a, docs, s);
    case 6: return launch_thread<6, 1>(a, docs, s);
    case 8: return launch_thread<8, 1>(a, docs, s);
    case 10: return launch_thread<10, 1>(a, docs, s);
    case 12: return launch_thread<12, 1>(a, docs, s);
    case 14: return launch_thread<14, 1>(a, docs, s);
    case 16: return launch_thread<16, 1>(a, docs, s);
    case 20: return launch_thread<20, 1>(a, docs, s);
    case 24: return launch_thread<24, 1>(a, docs, s);
    case 28: return launch_thread<28, 1>(a, docs, s);
    case 32: return launch_thread<32, 1>(a, docs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface, bound with ctypes (ops/lambda_kernel.py). All arrays are
// contiguous float32 on the current device: lam0/nu/ndz/st/out (R, D, MK),
// mu (R, MK), inv_sigma (R, MK, MK), 1 ≤ MK ≤ 128. (layout, P, docs) is the
// launch geometry of ops/lambda_kernel.py launch_geometry:
//  0 (thread): P ≥ MK one of 2, 4, …, 16, 20, 24, 28, 32; 1 ≤ docs ≤ 64;
//  1 (pair): P = 10, MK ≤ 20; docs 16, 32, 48 or 64 (whole warps of pairs);
//  2 (warp): P = 16 or 32, P ≥ MK; docs·P a multiple of 32, at most 256;
//  3 (block): P = 64 or 128, P ≥ MK; docs = 256 / P.
// Launches on `stream` without synchronising and returns the CUDA error code
// (0 = launched).
extern "C" int lambda_newton_launch(const float* lam0, const float* nu, const float* ndz,
                                    const float* st, const float* mu,
                                    const float* inv_sigma, float* out, int R, int D,
                                    int MK, int n_iter, int cg_iter, int polish_iter,
                                    int layout, int P, int docs, void* stream) {
  if (R <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (MK < 1 || MK > kMaxMK || R > 65535 || docs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{lam0, nu, ndz, st, mu, inv_sigma, out, R, D, MK, n_iter, cg_iter, polish_iter};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == kThreadLayout && P >= MK && docs <= kMaxThreadDocs)
    return launch_thread_layout(P, a, docs, s);
  if (layout == kPairLayout && P == 10 && MK <= 20 && docs <= kMaxThreadDocs && docs % 16 == 0)
    return launch_thread<10, 2>(a, docs, s);
  if (layout == kWarpLayout && (P == 16 || P == 32) && P >= MK && docs * P % 32 == 0 &&
      docs * P <= kThreads)
    return P == 16 ? launch(lambda_newton_warp_kernel<16>, a, docs, docs * P, 0, s)
                   : launch(lambda_newton_warp_kernel<32>, a, docs, docs * P, 0, s);
  if (layout == kBlockLayout && P == 64 && MK <= 64 && docs == kThreads / 64)
    return launch(lambda_newton_block_kernel<64>, a, docs, kThreads, block_smem_bytes<64>(), s);
  if (layout == kBlockLayout && P == 128 && docs == kThreads / 128)
    return launch(lambda_newton_block_kernel<128>, a, docs, kThreads, block_smem_bytes<128>(), s);
  return static_cast<int>(cudaErrorInvalidValue);
}
