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
//   λ'      = the λ solve of lambda_solve.cuh with ν', from the incoming λ,
//             or, given λ_prev (the previous CAVI iteration's λ) and c, from
//             the secant start λ + clamp(c·(λ − λ_prev), −4, 4) of
//             ops/solvers.py extrapolated_start (CTMBaseConfig.lambda_extrap;
//             the JAX package's solve_eta, models/ctm_base.py:405-408), formed
//             after ζ and ν have read the incoming λ. A null λ_prev runs the
//             kernel as it ran before it took one.
// It computes what ops/estep_kernel.py estep_eta_fused_plain (the port's
// update_zeta → calculate_Ndivzeta → maximize_nu → extrapolated_start →
// maximize_lambda) computes, step for step, in float32. Clamps propagate NaN as torch.clamp does, so a
// dead lane (an all-NaN Σ_r⁻¹) stays NaN; it cannot touch another restart,
// whose problems run in other blocks.
//
// Layouts. The wrapper (ops/estep_kernel.py launch_geometry) picks one from
// MK and the number of problems R·D and passes it, with P and the documents
// per block, to estep_eta_launch:
//  * "thread": one thread per (r, d) problem, ThreadProblem<P> of
//    lambda_solve.cuh with P = MK rounded up to even (up to 16; 20, 24, 28
//    or 32 above). A block is up to 64 documents of one restart (D = 560
//    fills 560 of 576 threads), staged into shared-memory columns by
//    coalesced loads and written back the same way. ζ is M sums inside the
//    thread over the modality blocks; N/ζ and the ν solve are elementwise,
//    the ν solve on the thread's P coordinates at once. No shuffles, no idle
//    lanes. At 168 registers an SM holds 6 blocks (384 problems) at
//    P ≤ 14, so R = 100 by D = 560 (56,000 problems) takes 1.1 waves on
//    132 SMs.
//  * "pair": two neighbouring threads per problem, ThreadProblem<P, ·, 2>,
//    each holding P of the 2P ≥ MK coordinates. A modality's coordinates
//    may straddle the two halves (K = (9, 9): the first thread holds all of
//    modality 0 and one coordinate of modality 1), so ζ_m is each thread's
//    partial sum over its own coordinates of block m plus one xor-shuffle
//    of the other's; both threads add the same two floats, so both hold the
//    same ζ bits, and N/ζ, the step choice and the NaN rule agree without a
//    vote. Up to 64 documents (128 threads) a block, whole warps of pairs.
//  * "split4", MK 33–64, and "split8", MK 65–128: 4 or 8 neighbouring
//    threads per problem, ThreadProblem<P, ·, Split>, P = 10, 12, 14 or 16
//    (the least with Split·P ≥ MK), up to 128 threads a block (32 or 16
//    documents of one restart). ζ is the pair's: each thread's partial sums,
//    then a butterfly of log2(Split) xor-shuffles that leaves every thread
//    the same bits. A block stages Σ_r⁻¹ once for its 16–32 documents, in
//    the tile of SigmaTile (part blocks on banks of their own; no separate
//    diagonal, so that two blocks at P = 16 fit an SM's 228 KB), and a
//    matvec reads it as 16-byte broadcasts in Split rounds of shuffled
//    operands (lambda_solve.cuh). No barrier inside the solve.
//  * "warp": one WarpGroup<16 or 32> per problem, one coordinate per lane,
//    `docs` problems a block; for calls with too few problems to fill the
//    card one per thread (stage 2, inference, single-model fits, ranks),
//    where the time is one problem's chain of dependent steps.
//  * "block", MK 33–128: one BlockGroup<64 or 128> per problem, 256 threads
//    a block; for calls of few problems above MK 32, where its short chain
//    (one coordinate a lane) beats a split layout's longer one.
//  In both group layouts each lane finds its modality from the block
//  offsets; ζ is one masked group sum per modality, M of them in every
//  group (in WarpGroup<16> a butterfly of width 16, inside the group), so
//  every thread of a BlockGroup block meets every barrier.
// Padding coordinates (j ≥ MK) and padding documents (d ≥ D) stay inert, as
// the TPU kernel keeps them: a = ½ (identity row), b = 0, ν = 1, λ = μ = 0
// (a padding document of the thread layout keeps its restart's μ and solves
// a well-posed problem that is never written).
//
// Bounds. At the f32 CAVI budgets (Newton 3, PCG 4, polish 1, ν sweeps 4) a
// problem at MK = 14 is about 12 kFLOP of λ solve plus about 1.3 kFLOP of ζ
// and ν, and it moves 5·MK·4 bytes (6·MK·4 with λ_prev): at R = 100 by
// D = 560, 0.75 GFLOP and 16 MB (19 MB), an operations bound of 14 µs
// (chip_smoke.py eta_bound). λ_prev is read once, coalesced, in every
// layout. The thread and pair layouts are bound by their instruction issue
// (the matvecs' FMAs and broadcast loads, the fast paths of the PCG and ν
// divisions and of the line search's square roots, the exps), below the
// card's rate; the warp layout by one problem's chain of shuffles. On an
// NVIDIA H100 80GB HBM3 at 700 W (lambda_bench.py --eta, device time from
// a CUDA graph of 20 calls, the CAVI budgets): 0.094 ms at (R, D, MK) =
// (100, 560, 14) on the thread layout, 6.7x the bound; 0.10–0.13 ms at
// MK 17–20 on the pair (P = 10), against 0.36–0.45 ms for the WarpGroup<32>
// it replaced there; 0.014 ms at R = 1, D = 560, MK 14 on WarpGroup<16>,
// against 0.034 ms for one thread per problem. Above MK 32 (lambda_bench.py
// --eta, the same card, PERF.md §6): split4 0.40 ms at (100, 560, (20, 20)),
// 5.0x its bound, against 1.45 ms for BlockGroup<64>; split8 3.46 ms at
// (100, 560, (64, 64)), 5.0x, against 5.44 ms for BlockGroup<128>. The
// split layouts are bound like the pair. The matvec's operand written to a
// per-problem shared vector and read back as 16-byte loads, in place of
// the shuffles, ran no faster at Split 4 and slower at Split 8, P = 12
// and 16, where the vector costs a block an SM: it was not kept.
//
// Full-precision float32 throughout: expf, sqrtf and IEEE divisions, and no
// --use_fast_math.

#include "lambda_solve.cuh"

namespace {

using namespace lambda_solve;

constexpr float kNuLowerBound = 1e-7f;  // solvers.NU_LOWER_BOUND
constexpr int kNuPolish = 4;            // solvers.NU_POLISH_ITERS
constexpr float kExtrapClip = 4.f;      // solvers.EXTRAP_CLIP
constexpr int kMaxThreadDocs = 64;     // documents a block of the thread and pair layouts, at most

enum Layout {
  kThreadLayout = 0, kPairLayout = 1, kWarpLayout = 2, kBlockLayout = 3, kSplit4Layout = 4,
  kSplit8Layout = 5
};

// Documents a block of ThreadProblem<·, ·, Split>s, at most: 64 in the
// thread and pair layouts; blocks of 128 threads at Split 4 and 8.
__host__ __device__ constexpr int max_docs(int Split) {
  return Split <= 2 ? kMaxThreadDocs : 128 / Split;
}

// Column stride of the ThreadProblem layouts: a block's threads, plus one.
template <int Split>
__host__ __device__ constexpr int col_stride() { return max_docs(Split) * Split + 1; }

// Blocks an SM holds: in the thread layout 6 at P ≤ 14 (168 registers a
// thread), 5 at P = 16, the compiler's choice at P = 32 (255 registers, 4
// blocks: shared memory bounds it); in the pair layout 3 blocks of 128
// threads at P = 10 (156 registers), 2 above (167, 193 and 212 at P = 12,
// 14, 16). ptxas reports no spill in any instantiation. At Split 4 and 8,
// 3 blocks of 128 threads at P ≤ 12, 2 above (ptxas: 127, 167, 168 and
// 227 registers at Split 4, P = 10, 12, 14, 16; 117, 167, 167 and 227 at
// Split 8); shared memory allows as many (at Split 8, P = 16, 2 × 113 KB:
// the whole 228 KB of an SM).
__host__ __device__ constexpr int min_blocks(int P, int Split) {
  if (Split >= 4) return P <= 12 ? 3 : 2;
  return Split == 2 ? (P <= 10 ? 3 : 2) : P <= 14 ? 6 : P <= 16 ? 5 : 1;
}

// The per-modality topic blocks: modality m holds coordinates
// [offset[m], offset[m + 1]); offset[M] = MK.
struct Blocks {
  int M;
  int offset[kMaxMK + 1];
};

// max(x, lo) and min(x, hi) that return a NaN x unchanged, as torch.clamp.
__device__ __forceinline__ float clamp_below(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_above(float x, float hi) { return x > hi ? hi : x; }

// The secant start λ + clamp(c·(λ − λ_prev), −4, 4) (solvers.extrapolated_start),
// its clamp propagating NaN as torch.clamp does.
__device__ __forceinline__ float secant_start(float lam, float lam_prev, float c) {
  return lam + clamp_above(clamp_below(c * (lam - lam_prev), -kExtrapClip), kExtrapClip);
}

// ν (ops/solvers.py maximize_nu) of P coordinates at once, from a = ½Σ⁻¹_jj,
// b = Ndivζ_j·e^{λ_j} and the incoming ν, all in registers; each division by
// div_fast, and a sweep in which any element left its range is redone with
// IEEE divisions.
template <int P>
__device__ __forceinline__ void nu_solve_vec(const float (&a)[P], const float (&b)[P],
                                             float (&nu)[P], int nu_n_iter) {
  auto wexp = [&](int j, float v) {
    const float w = b[j] * expf(clamp_above(0.5f * v, kExpClip));
    return b[j] > 0.f ? w : 0.f;
  };
  float t[P];
  for (int it = 0; it < nu_n_iter; ++it) {
    bool ok = true;
#pragma unroll
    for (int j = 0; j < P; ++j)
      t[j] = clamp_below(div_fast(1.f, 2.f * a[j] + wexp(j, nu[j]), ok), kNuLowerBound);
    if (!ok) {
#pragma unroll
      for (int j = 0; j < P; ++j)
        t[j] = clamp_below(div_ieee(1.f, 2.f * a[j] + wexp(j, nu[j])), kNuLowerBound);
    }
#pragma unroll
    for (int j = 0; j < P; ++j) nu[j] = t[j];
  }
  for (int it = 0; it < kNuPolish; ++it) {
    bool ok = true;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float w = wexp(j, nu[j]);
      const float g = -a[j] - 0.5f * w + div_fast(0.5f, nu[j], ok);
      const float hess = -0.25f * w - div_fast(0.5f, nu[j] * nu[j], ok);
      t[j] = clamp_below(nu[j] - div_fast(g, hess, ok), kNuLowerBound);
    }
    if (!ok) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float w = wexp(j, nu[j]);
        const float g = -a[j] - 0.5f * w + div_ieee(0.5f, nu[j]);
        const float hess = -0.25f * w - div_ieee(0.5f, nu[j] * nu[j]);
        t[j] = clamp_below(nu[j] - div_ieee(g, hess), kNuLowerBound);
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) nu[j] = isfinite(t[j]) ? t[j] : nu[j];
  }
}

// ---------------------------------------------------------------------------
// The thread and pair layouts.

template <int P, int Split>
__global__ void __launch_bounds__(max_docs(Split) * Split, min_blocks(P, Split))
estep_eta_thread_kernel(const float* __restrict__ lam0, const float* __restrict__ nu0,
                        const float* __restrict__ N, const float* __restrict__ st,
                        const float* __restrict__ mu, const float* __restrict__ inv_sigma,
                        const float* __restrict__ lam_prev, float* __restrict__ zeta,
                        float* __restrict__ nu_out, float* __restrict__ lam_out,
                        const Blocks blk, int D, int MK, int n_iter, int cg_iter,
                        int polish_iter, int nu_n_iter, float extrap) {
  constexpr int Stride = col_stride<Split>();
  using Problem = ThreadProblem<P, Stride, Split>;
  using Tile = typename Problem::Tile;
  constexpr int NP = Problem::N, P4 = Problem::P4;
  extern __shared__ float4 smem4[];
  float* S = reinterpret_cast<float*>(smem4);  // the Σ⁻¹ tile
  float* diag = S + Tile::kFloats;             // [P4] (Split 1 and 2)
  float* mu_s = diag + Tile::kDiagFloats;      // [P4]
  float* cols = mu_s + P4;                     // [kColumns][P][Stride]
  const int T = blockDim.x, t = threadIdx.x, per_block = T / Split;
  const int r = blockIdx.y, d0 = blockIdx.x * per_block;
  const int docs = min(per_block, D - d0);  // live documents of this block
  // coordinate j of document doc: thread doc·Split + j / P, element j % P
  auto col = [&](int c, int j, int doc) -> float& {
    const int part = Split == 1 ? 0 : j / P;
    return cols[(c * P + j - part * P) * Stride + doc * Split + part];
  };

  const float* S_r = inv_sigma + static_cast<size_t>(r) * MK * MK;
#pragma unroll 4
  for (int idx = t; idx < Tile::kFloats; idx += T) {
    int i, k;
    const bool element = Tile::element(idx, i, k);
    const float s = !element ? 0.f : (i < MK && k < MK) ? S_r[i * MK + k] : (i == k ? 1.f : 0.f);
    S[idx] = s;
    if (Split <= 2 && i == k) diag[i] = s;
  }
  for (int j = t; j < P4; j += T) mu_s[j] = j < MK ? mu[static_cast<size_t>(r) * MK + j] : 0.f;
  for (int idx = t; idx < NP * per_block; idx += T) {  // the inert padding
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
    col(kNu, j, doc) = nu0[base + idx];
    col(kSt, j, doc) = st[base + idx];
  }
  __syncthreads();

  const int part = t % Split;
  Problem prob{S + part * Tile::PS, diag + part * P, mu_s + part * P, cols + t, part};
  const bool live = t / Split < docs;
  const int d = d0 + t / Split;

  // ζ and N/ζ from the incoming λ and ν. This thread holds coordinates
  // [part·P, part·P + P); in a pair each ζ_m is the two threads' partial
  // sums added, the same float in both.
  float e[P];  // a padding coordinate's e is never summed
#pragma unroll
  for (int j = 0; j < P; ++j) e[j] = expf(prob.at(kLam, j) + 0.5f * prob.at(kNu, j));
  for (int m = 0; m < blk.M; ++m) {
    const int lo = blk.offset[m] - part * P, hi = blk.offset[m + 1] - part * P;
    float z = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (j >= lo && j < hi) z += e[j];
    z = prob.sum(z);
    if (live && part == 0) zeta[(static_cast<size_t>(r) * D + d) * blk.M + m] = z;
    const float n = live ? N[static_cast<size_t>(d) * blk.M + m] : 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (j >= lo && j < hi) prob.at(kNdz, j) = n / z;
  }

  // ν from the incoming λ, elementwise (a padding coordinate keeps ν = 1).
  float a[P], b[P], nu[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    a[j] = 0.5f * prob.dg(j);
    b[j] = prob.at(kNdz, j) * expf(prob.at(kLam, j));
    nu[j] = prob.at(kNu, j);
  }
  nu_solve_vec<P>(a, b, nu, nu_n_iter);
#pragma unroll
  for (int j = 0; j < P; ++j) prob.at(kNu, j) = nu[j];

  // With λ_prev, the λ column becomes the secant start, coalesced as it was
  // staged, once every thread has read its incoming λ (the branch is the
  // same for the whole block); padding keeps λ = 0.
  if (lam_prev != nullptr) {
    __syncthreads();
    for (int idx = t; idx < docs * MK; idx += T) {
      const int doc = idx / MK, j = idx - doc * MK;
      col(kLam, j, doc) = secant_start(col(kLam, j, doc), lam_prev[base + idx], extrap);
    }
    __syncthreads();
  }

  // λ from its start, with the new ν.
  prob.solve(n_iter, cg_iter, polish_iter);

  __syncthreads();
  for (int idx = t; idx < docs * MK; idx += T) {
    const int doc = idx / MK, j = idx - doc * MK;
    lam_out[base + idx] = col(kLam, j, doc);
    nu_out[base + idx] = col(kNu, j, doc);
  }
}

// ---------------------------------------------------------------------------
// The group layouts.

// ζ, ν' and λ' for this thread's (r, d, j), shared by both group layouts.
template <typename G>
__device__ __forceinline__ void estep(G& grp, const float* lam0, const float* nu0,
                                      const float* N, const float* st, const float* mu,
                                      const float* lam_prev, float* zeta_out, float* nu_out,
                                      float* lam_out, const Blocks& blk, int r, int d, int j,
                                      int D, int MK, int n_iter, int cg_iter, int polish_iter,
                                      int nu_n_iter, float extrap) {
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

  // ν from the incoming λ, elementwise.
  const float a[1] = {0.5f * grp.diag}, b[1] = {ndz * expf(lam)};
  float nu_v[1] = {nu_in};
  nu_solve_vec<1>(a, b, nu_v, nu_n_iter);
  const float nu = nu_v[0];
  if (live) nu_out[off] = nu;

  // λ from the incoming λ, or with λ_prev from the secant start (a padding
  // lane keeps λ = 0), with the new ν.
  const float lam_start =
      lam_prev != nullptr && live ? secant_start(lam, lam_prev[off], extrap) : lam;
  const float lam_new =
      solve_lane(grp, lam_start, nu, ndz, st_j, mu_j, n_iter, cg_iter, polish_iter);
  if (live) lam_out[off] = lam_new;
}

// At least 3 blocks of 256 threads an SM, as the λ kernel's warp layout
// (without a block count ptxas gave that kernel too few registers and it
// spilled).
template <int P>
__global__ void __launch_bounds__(kThreads, 3)
estep_eta_warp_kernel(const float* __restrict__ lam0, const float* __restrict__ nu0,
                      const float* __restrict__ N, const float* __restrict__ st,
                      const float* __restrict__ mu, const float* __restrict__ inv_sigma,
                      const float* __restrict__ lam_prev, float* __restrict__ zeta,
                      float* __restrict__ nu_out, float* __restrict__ lam_out, const Blocks blk,
                      int D, int MK, int n_iter, int cg_iter, int polish_iter, int nu_n_iter,
                      float extrap) {
  __shared__ float S[P * P];
  const int r = blockIdx.y;
  stage_inv_sigma<P>(S, inv_sigma + static_cast<size_t>(r) * MK * MK, MK);

  const int j = threadIdx.x % P;
  const int d = blockIdx.x * (blockDim.x / P) + threadIdx.x / P;
  WarpGroup<P> grp;
  bind_warp_group<P>(grp, S, j);
  estep(grp, lam0, nu0, N, st, mu, lam_prev, zeta, nu_out, lam_out, blk, r, d, j, D, MK, n_iter,
        cg_iter, polish_iter, nu_n_iter, extrap);
}

template <int P>
__global__ void __launch_bounds__(kThreads)
estep_eta_block_kernel(const float* __restrict__ lam0, const float* __restrict__ nu0,
                       const float* __restrict__ N, const float* __restrict__ st,
                       const float* __restrict__ mu, const float* __restrict__ inv_sigma,
                       const float* __restrict__ lam_prev, float* __restrict__ zeta,
                       float* __restrict__ nu_out, float* __restrict__ lam_out,
                       const Blocks blk, int D, int MK, int n_iter, int cg_iter,
                       int polish_iter, int nu_n_iter, float extrap) {
  extern __shared__ float smem[];
  const int r = blockIdx.y;
  stage_inv_sigma<P>(smem, inv_sigma + static_cast<size_t>(r) * MK * MK, MK);

  BlockGroup<P> grp;
  bind_block_group<P>(grp, smem);
  const int d = blockIdx.x * (kThreads / P) + threadIdx.x / P;
  estep(grp, lam0, nu0, N, st, mu, lam_prev, zeta, nu_out, lam_out, blk, r, d, grp.j, D, MK,
        n_iter, cg_iter, polish_iter, nu_n_iter, extrap);
}

// ---------------------------------------------------------------------------
// Launch.

struct Args {
  const float *lam0, *nu0, *N, *st, *mu, *inv_sigma, *lam_prev;
  float *zeta, *nu_out, *lam_out;
  int R, D, MK, n_iter, cg_iter, polish_iter, nu_n_iter;
  float extrap;
};

template <typename Kernel>
int launch(Kernel kernel, const Args& a, const Blocks& blk, int docs, int threads, size_t smem,
           cudaStream_t stream) {
  const cudaError_t rc = allow_smem(kernel, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((a.D + docs - 1) / docs, a.R);
  kernel<<<grid, threads, smem, stream>>>(a.lam0, a.nu0, a.N, a.st, a.mu, a.inv_sigma,
                                          a.lam_prev, a.zeta, a.nu_out, a.lam_out, blk, a.D,
                                          a.MK, a.n_iter, a.cg_iter, a.polish_iter, a.nu_n_iter,
                                          a.extrap);
  return static_cast<int>(cudaGetLastError());
}

template <int P, int Split>
int launch_thread(const Args& a, const Blocks& blk, int docs, cudaStream_t stream) {
  // Shared memory, not L1, bounds the blocks an SM holds: ask for its most.
  static const cudaError_t carveout = cudaFuncSetAttribute(
      estep_eta_thread_kernel<P, Split>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (carveout != cudaSuccess) return static_cast<int>(carveout);
  return launch(estep_eta_thread_kernel<P, Split>, a, blk, docs, docs * Split,
                sizeof(float) * thread_smem_floats<P, col_stride<Split>(), Split>(), stream);
}

int launch_thread_layout(int P, const Args& a, const Blocks& blk, int docs, cudaStream_t s) {
  switch (P) {
    case 2: return launch_thread<2, 1>(a, blk, docs, s);
    case 4: return launch_thread<4, 1>(a, blk, docs, s);
    case 6: return launch_thread<6, 1>(a, blk, docs, s);
    case 8: return launch_thread<8, 1>(a, blk, docs, s);
    case 10: return launch_thread<10, 1>(a, blk, docs, s);
    case 12: return launch_thread<12, 1>(a, blk, docs, s);
    case 14: return launch_thread<14, 1>(a, blk, docs, s);
    case 16: return launch_thread<16, 1>(a, blk, docs, s);
    case 32: return launch_thread<32, 1>(a, blk, docs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The pair, Split 4 and Split 8 layouts: P = 10, 12, 14 or 16 each.
template <int Split>
int launch_split_layout(int P, const Args& a, const Blocks& blk, int docs, cudaStream_t s) {
  switch (P) {
    case 10: return launch_thread<10, Split>(a, blk, docs, s);
    case 12: return launch_thread<12, Split>(a, blk, docs, s);
    case 14: return launch_thread<14, Split>(a, blk, docs, s);
    case 16: return launch_thread<16, Split>(a, blk, docs, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface, bound with ctypes (ops/estep_kernel.py). All arrays are
// contiguous float32 on the current device: lam0/nu/st and the outputs
// nu_out/lam_out (R, D, MK), N (D, M), mu (R, MK), inv_sigma (R, MK, MK), the
// output zeta (R, D, M); lam_prev (R, D, MK), or null for no secant start,
// and extrap its coefficient c. K (host memory) holds the M ≥ 1 topic counts, each
// ≥ 1, summing to MK ≤ 128. (layout, P, docs) is the launch geometry of
// ops/estep_kernel.py launch_geometry:
//  0 (thread): P ≥ MK one of 2, 4, …, 16, 32; 1 ≤ docs ≤ 64;
//  1 (pair): P one of 10, 12, 14, 16, 2P ≥ MK; docs 16, 32, 48 or 64;
//  2 (warp): P = 16 or 32, P ≥ MK; docs·P a multiple of 32, at most 256;
//  3 (block): P = 64 or 128, P ≥ MK; docs = 256 / P;
//  4 (split4), 5 (split8): P one of 10, 12, 14, 16, Split·P ≥ MK; docs·Split
//    a multiple of 32, at most 128.
// Launches on `stream` without synchronising and returns the CUDA error code
// (0 = launched).
extern "C" int estep_eta_launch(const float* lam0, const float* nu, const float* N,
                                const float* st, const float* mu, const float* inv_sigma,
                                const float* lam_prev, float* zeta, float* nu_out,
                                float* lam_out, const int* K, int M, int R, int D, int MK,
                                int n_iter, int cg_iter, int polish_iter, int nu_n_iter,
                                float extrap, int layout, int P, int docs, void* stream) {
  if (R <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (MK < 1 || MK > kMaxMK || R > 65535 || M < 1 || M > MK || docs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Blocks blk;
  blk.M = M;
  blk.offset[0] = 0;
  for (int m = 0; m < M; ++m) {
    if (K[m] < 1) return static_cast<int>(cudaErrorInvalidValue);
    blk.offset[m + 1] = blk.offset[m] + K[m];
  }
  if (blk.offset[M] != MK) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{lam0, nu, N, st, mu, inv_sigma, lam_prev, zeta, nu_out, lam_out,
               R, D, MK, n_iter, cg_iter, polish_iter, nu_n_iter, extrap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == kThreadLayout && P >= MK && docs <= kMaxThreadDocs)
    return launch_thread_layout(P, a, blk, docs, s);
  if (layout == kPairLayout && 2 * P >= MK && docs <= kMaxThreadDocs && docs % 16 == 0)
    return launch_split_layout<2>(P, a, blk, docs, s);
  // whole warps of problems, up to the instantiation's documents a block
  if (layout == kSplit4Layout && 4 * P >= MK && docs <= max_docs(4) && docs % 8 == 0)
    return launch_split_layout<4>(P, a, blk, docs, s);
  if (layout == kSplit8Layout && 8 * P >= MK && docs <= max_docs(8) && docs % 4 == 0)
    return launch_split_layout<8>(P, a, blk, docs, s);
  if (layout == kWarpLayout && (P == 16 || P == 32) && P >= MK && docs * P % 32 == 0 &&
      docs * P <= kThreads)
    return P == 16 ? launch(estep_eta_warp_kernel<16>, a, blk, docs, docs * P, 0, s)
                   : launch(estep_eta_warp_kernel<32>, a, blk, docs, docs * P, 0, s);
  if (layout == kBlockLayout && P == 64 && MK <= 64 && docs == kThreads / 64)
    return launch(estep_eta_block_kernel<64>, a, blk, docs, kThreads, block_smem_bytes<64>(), s);
  if (layout == kBlockLayout && P == 128 && docs == kThreads / 128)
    return launch(estep_eta_block_kernel<128>, a, blk, docs, kThreads, block_smem_bytes<128>(),
                  s);
  return static_cast<int>(cudaErrorInvalidValue);
}
