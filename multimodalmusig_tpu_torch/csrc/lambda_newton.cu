// Restart-batched λ solve of the MMCTM E-step, fused into one kernel for
// Hopper (sm_90a).
//
// Replaces the TPU kernel multimodalmusig_tpu/ops/pallas/lambda_kernel.py
// (maximize_lambda_fused_restarts, body _lambda_solve; and
// maximize_lambda_fused, the same solve with one shared μ/Σ⁻¹, which is this
// kernel at R = 1). For every restart r and document d it maximizes
//
//   f(λ) = -½(λ-μ_r)ᵀ Σ_r⁻¹ (λ-μ_r) + λ·sumθ - Σ Ndivζ·exp(λ + ν/2)
//
// over MK coordinates: n_iter damped Newton steps, each solving
// (Σ_r⁻¹ + diag(w)) δ = g by cg_iter Jacobi-PCG iterations and taking the
// best step of {8, 4, 2, 1, ½, ..., 2⁻¹², 0} on the expanded quadratic, then
// polish_iter guarded Newton steps under a 2.0 trust region. It computes
// what ops/solvers.py maximize_lambda (the plain version) computes, step for
// step, in float32.
//
// Layout. One group of P lanes (P = 16 or 32, the next power of two ≥ MK)
// serves one (r, d) problem, one coordinate per lane. A block of 256
// threads holds 256 / P documents of one restart, stages Σ_r⁻¹ in shared
// memory once, and every lane keeps its row of Σ_r⁻¹ in registers (Σ⁻¹ is
// symmetric, so the row is also the column). A matvec is P __shfl_sync
// broadcasts of v_i times that row; a reduction over coordinates is an
// xor-shuffle butterfly, after which every lane of the group holds the
// bit-identical sum. That matters: the step choice, the trust region and
// the all-finite check must agree across the group's lanes. Padding lanes
// (j ≥ MK) and padding documents (d ≥ D) are inert: identity row,
// Ndivζ = sumθ = 0, ν = 1, λ = μ = 0, so their gradient and step are 0.
//
// Bounds. At the f32 CAVI budgets (Newton 3, PCG 4, polish 1) one problem
// costs about 12 kFLOP and moves about 5·MK·4 bytes; at R = 100 restarts of
// the D = 560, MK = 14 BRCA workload that is about 0.7 GFLOP and 16 MB per
// CAVI iteration, far below both the card's float32 rate and its memory
// bandwidth. The kernel is bound by latency (the dependent shuffle chains
// of PCG and the line search) and by its launch; the design keeps every
// intermediate in registers and launches once per λ solve instead of the
// hundreds of small kernels the plain version issues.
//
// Full-precision float32 throughout: expf and sqrtf, and no --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBacktrack = 13;       // solvers.N_BACKTRACK
constexpr float kExpClip = 60.f;     // solvers.EXP_CLIP
constexpr float kPolishMaxStep = 2.f;  // solvers.POLISH_MAX_STEP
constexpr float kTiny = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

template <int P>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = P / 2; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off, P);
  return x;
}

template <int P>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = P / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off, P));
  return x;
}

// (Σ⁻¹ v)_j for this lane's coordinate j: row = Σ⁻¹[j, :].
template <int P>
__device__ __forceinline__ float matvec(const float (&row)[P], float v) {
  float out = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) out += row[i] * __shfl_sync(kFull, v, i, P);
  return out;
}

// Jacobi-PCG for (Σ⁻¹ + diag(w)) δ = g; returns this lane's δ_j.
template <int P>
__device__ __forceinline__ float pcg(const float (&row)[P], float diag, float w,
                                     float g, int cg_iter) {
  const float M = diag + w;
  float x = 0.f, r = g, z = r / M, p = z;
  float rz = group_sum<P>(r * z);
  for (int k = 0; k < cg_iter; ++k) {
    const float Ap = matvec<P>(row, p) + w * p;
    const float alpha = rz / (group_sum<P>(p * Ap) + kTiny);
    x += alpha * p;
    r -= alpha * Ap;
    z = r / M;
    const float rz_new = group_sum<P>(r * z);
    const float beta = rz_new / (rz + kTiny);
    p = z + beta * p;
    rz = rz_new;
  }
  return x;
}

template <int P>
__device__ __forceinline__ float newton_step(const float (&row)[P], float diag,
                                             float lam, float nu, float ndz,
                                             float st, float mu, int cg_iter) {
  const float w = ndz * expf(lam + 0.5f * nu);
  const float diff = lam - mu;
  const float Sdiff = matvec<P>(row, diff);
  const float delta = pcg<P>(row, diag, w, -Sdiff + st - w, cg_iter);
  const float Sdelta = matvec<P>(row, delta);
  const float q0 = group_sum<P>(diff * Sdiff);
  const float b = group_sum<P>(delta * Sdiff);
  const float c2 = group_sum<P>(delta * Sdelta);
  const float lin0 = group_sum<P>(lam * st);
  const float lind = group_sum<P>(delta * st);
  float best_f = -0.5f * q0 + lin0 - group_sum<P>(w);  // s = 0: stay put
  float best_s = 0.f;
  // Every lane of the group computes the same f, so the branch is uniform
  // within the group; the shuffles sit outside it.
  auto consider = [&](float s, float e_s) {
    const float f = -0.5f * (q0 + 2.f * s * b + s * s * c2) + lin0 + s * lind -
                    group_sum<P>(w * e_s);
    if (isfinite(f) && f > best_f) {
      best_f = f;
      best_s = s;
    }
  };
  consider(8.f, expf(fminf(8.f * delta, kExpClip)));
  consider(4.f, expf(fminf(4.f * delta, kExpClip)));
  consider(2.f, expf(fminf(2.f * delta, kExpClip)));
  float e_s = expf(fminf(delta, kExpClip));
  float s = 1.f;
  for (int k = 0; k < kBacktrack; ++k) {
    consider(s, e_s);
    e_s = sqrtf(e_s);
    s *= 0.5f;
  }
  return lam + best_s * delta;
}

template <int P>
__device__ __forceinline__ float polish_step(const float (&row)[P], float diag,
                                             float lam, float nu, float ndz,
                                             float st, float mu, int cg_iter) {
  const float w = ndz * expf(lam + 0.5f * nu);
  const float g = -matvec<P>(row, lam - mu) + st - w;
  float delta = pcg<P>(row, diag, w, g, cg_iter);
  const float dmax = group_max<P>(fabsf(delta));
  delta *= fminf(1.f, kPolishMaxStep / fmaxf(dmax, kTiny));
  const float step = lam + delta;
  const float n_bad = group_sum<P>(isfinite(step) ? 0.f : 1.f);
  return n_bad == 0.f ? step : lam;
}

template <int P>
__global__ void __launch_bounds__(kThreads)
lambda_newton_kernel(const float* __restrict__ lam0, const float* __restrict__ nu,
                     const float* __restrict__ ndz, const float* __restrict__ st,
                     const float* __restrict__ mu, const float* __restrict__ inv_sigma,
                     float* __restrict__ out, int D, int MK, int n_iter, int cg_iter,
                     int polish_iter) {
  __shared__ float S[P * P];
  const int r = blockIdx.y;
  const float* S_r = inv_sigma + static_cast<size_t>(r) * MK * MK;
  for (int idx = threadIdx.x; idx < P * P; idx += kThreads) {
    const int i = idx / P, k = idx % P;
    S[idx] = (i < MK && k < MK) ? S_r[i * MK + k] : (i == k ? 1.f : 0.f);
  }
  __syncthreads();

  const int j = threadIdx.x % P;
  const int d = blockIdx.x * (kThreads / P) + threadIdx.x / P;
  float row[P];
#pragma unroll
  for (int i = 0; i < P; ++i) row[i] = S[j * P + i];
  const float diag = S[j * P + j];

  const bool live = j < MK && d < D;
  const size_t off = (static_cast<size_t>(r) * D + d) * MK + j;
  float lam = live ? lam0[off] : 0.f;
  const float nu_j = live ? nu[off] : 1.f;
  const float ndz_j = live ? ndz[off] : 0.f;
  const float st_j = live ? st[off] : 0.f;
  const float mu_j = live ? mu[static_cast<size_t>(r) * MK + j] : 0.f;

  for (int it = 0; it < n_iter; ++it)
    lam = newton_step<P>(row, diag, lam, nu_j, ndz_j, st_j, mu_j, cg_iter);
  for (int it = 0; it < polish_iter; ++it)
    lam = polish_step<P>(row, diag, lam, nu_j, ndz_j, st_j, mu_j, cg_iter);
  if (live) out[off] = lam;
}

template <int P>
void launch(const float* lam0, const float* nu, const float* ndz, const float* st,
            const float* mu, const float* inv_sigma, float* out, int R, int D, int MK,
            int n_iter, int cg_iter, int polish_iter, cudaStream_t stream) {
  constexpr int kDocsPerBlock = kThreads / P;
  const dim3 grid((D + kDocsPerBlock - 1) / kDocsPerBlock, R);
  lambda_newton_kernel<P><<<grid, kThreads, 0, stream>>>(
      lam0, nu, ndz, st, mu, inv_sigma, out, D, MK, n_iter, cg_iter, polish_iter);
}

}  // namespace

// C interface, bound with ctypes (ops/lambda_kernel.py). All arrays are
// contiguous float32 on the current device: lam0/nu/ndz/st/out (R, D, MK),
// mu (R, MK), inv_sigma (R, MK, MK). Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 = launched).
extern "C" int lambda_newton_launch(const float* lam0, const float* nu, const float* ndz,
                                    const float* st, const float* mu,
                                    const float* inv_sigma, float* out, int R, int D,
                                    int MK, int n_iter, int cg_iter, int polish_iter,
                                    void* stream) {
  if (R <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (MK < 1 || MK > 32 || R > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (MK <= 16)
    launch<16>(lam0, nu, ndz, st, mu, inv_sigma, out, R, D, MK, n_iter, cg_iter,
               polish_iter, s);
  else
    launch<32>(lam0, nu, ndz, st, mu, inv_sigma, out, R, D, MK, n_iter, cg_iter,
               polish_iter, s);
  return static_cast<int>(cudaGetLastError());
}
