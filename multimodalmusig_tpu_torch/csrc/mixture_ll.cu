// Restart-batched per-modality mixture log-likelihoods, fused into one
// kernel for Hopper (sm_90a), without storing the (R, D, V) mixture.
//
// Replaces no TPU kernel: the JAX package leaves this sum to XLA
// (multimodalmusig_tpu/models/mmctm.py modality_loglikelihoods). In the
// port PyTorch formed props @ ϕ as an (R, D, V) tensor per modality, then
// passed over it with two selects, a log, a multiply and a sum, about ten
// passes over the largest tensor of a CAVI step's tail. For every restart
// r and modality m this kernel computes
//
//   ll[r,m] = Σ_d Σ_{v: X_m[d,v] ≠ 0} X_m[d,v]·log(Σ_k props_m[r,d,k]·ϕ_m[r,k,v])
//
// with the semantics of ops/special.py safe_xlogy: a zero count adds an
// exact 0 whatever its mixture (so a document with no counts in a modality
// adds 0), a nonzero count on a zero mixture gives −inf, and a NaN lane
// (NaN props or ϕ) gives NaN.
//
// Layout. Block (r, b, m) serves restart lane r (blockIdx.x), modality m
// (blockIdx.z) and the documents [b·DB, (b+1)·DB) (blockIdx.y). It stages
// its documents' counts (Xs, DB × V), ϕ_m[r] (Fs, K × V) and the
// documents' props (Ps, K rows of DB + 4, so four consecutive documents'
// props of one topic are one 16-byte read that every lane of a warp
// shares) in shared memory. Each of the 8 warps takes four documents at a
// time; its lanes take the items v = lane, lane + 32, ...: a lane forms
// the four documents' K-term mixtures by fused multiply-adds (one shared
// read of ϕ and one broadcast read of props per topic), then, for each of
// the four cells whose count is nonzero, x·logf(mixture). Zero cells take
// no log and add nothing. The four cells' terms are summed in float32 in
// document order and added to the lane's float64 sum; the 32 lanes' sums
// are added by a shuffle tree, the warps' in warp order, into one float64
// partial per (m, r, b). A second kernel adds each (r, m)'s partials in
// block order and rounds once to float32. No float atomics: two launches
// on the same inputs give the same bits, and a restart lane's result
// depends only on its own inputs and D (not on R or the lanes beside it).
// Consecutive blocks serve the restart lanes of one document block, so its
// counts are read from L2 after the first.
//
// Bounds. At PCAWG's shapes (R = 100, D = 2,780, K = (7, 7, 5), V = (96,
// 48, 83)) the call does 6.3e7 cells: 4.4e8 multiply-adds and up to 6.3e7
// full-precision logfs, and reads props once (21 MB) and the counts once
// per lane (2.5 MB, through L2). The issue rate of the logfs and
// multiply-adds bounds it, not the bytes; chip_smoke.py's bound counts
// 2·K·V + 2·V operations a cell at 67 TFLOP/s.
//
// Full-precision float32: logf and fmaf, no --use_fast_math, no TF32.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kDocs = 4;       // documents a warp takes at a time
constexpr int kMaxM = 16;      // modalities a launch takes (ops/ll_kernel.py LL_MAX_M)
constexpr int kMaxK = 128;     // topics of a modality (LL_MAX_K)
constexpr int kMaxV = 128;     // items of a modality (LL_MAX_V)
constexpr int kMaxDocs = 128;  // documents a block serves (MAX_BLOCK_DOCS)
constexpr int kMaxCards = 64;

struct Modality {
  const float* props;  // (R, D, K)
  const float* phi;    // (R, K, V)
  const float* X;      // (D, V)
  int K, V;
};

struct Params {
  Modality mod[kMaxM];
  double* partial;  // (M, R, n_blocks)
  int R, D, docs, n_blocks;
};

// Shared memory in bytes of a block of modality (K, V): the warps' sums
// (float64), then Ps, Fs and Xs (float32).
size_t smem_bytes(int K, int V, int docs) {
  return sizeof(double) * kWarps +
         sizeof(float) * (static_cast<size_t>(K) * (docs + 4) + K * V + docs * V);
}

__global__ void __launch_bounds__(kThreads)
    mixture_ll_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Modality md = p.mod[blockIdx.z];
  const int K = md.K, V = md.V, DB = p.docs, DBP = DB + 4;
  const long long r = blockIdx.x;
  const int d0 = blockIdx.y * DB;
  const int nd = min(DB, p.D - d0);
  double* wsum = reinterpret_cast<double*>(smem);     // [kWarps]
  float* Ps = reinterpret_cast<float*>(wsum + kWarps);  // [K][DB + 4]
  float* Fs = Ps + K * DBP;                            // [K][V]
  float* Xs = Fs + K * V;                              // [DB][V]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const float* Xg = md.X + static_cast<long long>(d0) * V;
  for (int t = tid; t < DB * V; t += kThreads) Xs[t] = t < nd * V ? Xg[t] : 0.f;
  const float* Fg = md.phi + r * K * V;
  for (int t = tid; t < K * V; t += kThreads) Fs[t] = Fg[t];
  const float* Pg = md.props + (r * p.D + d0) * K;
  for (int t = tid; t < DB * K; t += kThreads) {
    const int dd = t / K, k = t - dd * K;
    Ps[k * DBP + dd] = dd < nd ? Pg[t] : 0.f;
  }
  __syncthreads();

  double acc = 0.0;
  for (int d = warp * kDocs; d < nd; d += kWarps * kDocs) {
    for (int v = lane; v < V; v += 32) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float f = Fs[k * V + v];
        const float4 pk = *reinterpret_cast<const float4*>(Ps + k * DBP + d);
        a0 = fmaf(pk.x, f, a0);
        a1 = fmaf(pk.y, f, a1);
        a2 = fmaf(pk.z, f, a2);
        a3 = fmaf(pk.w, f, a3);
      }
      const float* x = Xs + d * V + v;  // documents past D hold zero counts
      float s = 0.f;
      if (x[0] != 0.f) s += x[0] * logf(a0);
      if (x[V] != 0.f) s += x[V] * logf(a1);
      if (x[2 * V] != 0.f) s += x[2 * V] * logf(a2);
      if (x[3 * V] != 0.f) s += x[3 * V] * logf(a3);
      acc += static_cast<double>(s);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if (lane == 0) wsum[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += wsum[w];
    p.partial[(static_cast<long long>(blockIdx.z) * p.R + r) * p.n_blocks + blockIdx.y] = s;
  }
}

__global__ void mixture_ll_finish(const double* partial, float* out, int M, int R,
                                  int n_blocks) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= R * M) return;
  const int r = t / M, m = t - r * M;
  const double* pp = partial + (static_cast<long long>(m) * R + r) * n_blocks;
  double s = 0.0;
  for (int b = 0; b < n_blocks; ++b) s += pp[b];
  out[t] = static_cast<float>(s);
}

}  // namespace

// C interface, bound with ctypes (ops/ll_kernel.py). props, phi and X are
// host arrays of M device addresses: props[m] (R, D, K[m]), phi[m] (R,
// K[m], V[m]) and X[m] (D, V[m]), float32, contiguous, on the current
// device. docs (a multiple of 4, at most 128) documents a block:
// ops/ll_kernel.py launch_geometry. partial is float64 scratch of
// M·R·⌈D/docs⌉; out is (R, M) float32. Two launches on `stream`, without
// synchronising; returns the CUDA error code (0 = launched).
extern "C" int mixture_ll_launch(const unsigned long long* props, const unsigned long long* phi,
                                 const unsigned long long* X, const int* K, const int* V, int M,
                                 int R, int D, int docs, double* partial, float* out,
                                 void* stream) {
  if (R <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  if (M < 1 || M > kMaxM || docs < kDocs || docs > kMaxDocs || docs % kDocs ||
      (D + docs - 1) / docs > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  size_t smem = 0;
  for (int m = 0; m < M; ++m) {
    if (K[m] < 1 || K[m] > kMaxK || V[m] < 1 || V[m] > kMaxV)
      return static_cast<int>(cudaErrorInvalidValue);
    p.mod[m] = Modality{reinterpret_cast<const float*>(props[m]),
                        reinterpret_cast<const float*>(phi[m]),
                        reinterpret_cast<const float*>(X[m]), K[m], V[m]};
    const size_t b = smem_bytes(K[m], V[m], docs);
    if (b > smem) smem = b;
  }
  p.partial = partial;
  p.R = R;
  p.D = D;
  p.docs = docs;
  p.n_blocks = (D + docs - 1) / docs;
  // A block's dynamic shared memory above 48 KB needs an opt-in, made once
  // per card for the largest size asked for so far.
  static size_t opted[kMaxCards];
  int card = 0;
  cudaError_t rc = cudaGetDevice(&card);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (card < 0 || card >= kMaxCards) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > 48 * 1024 && smem > opted[card]) {
    rc = cudaFuncSetAttribute(mixture_ll_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
    opted[card] = smem;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  mixture_ll_kernel<<<dim3(R, p.n_blocks, M), kThreads, smem, st>>>(p);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int n = R * M;
  mixture_ll_finish<<<(n + 255) / 256, 256, 0, st>>>(partial, out, M, R, p.n_blocks);
  return static_cast<int>(cudaGetLastError());
}
