// chol_core.cuh: the factorization core of the small-K kernels, shared by
// csrc/mh_rounds.cu (K1) and csrc/chol_smallk.cu (K5, K6, K7), with the
// SE-mixture Gram build (K1, K6, K7) and the log-posterior and
// first-acceptance scan (K1, K7) that come before and after it.
//
// K symmetric n x n matrices, each stored as its packed upper triangle
// (row i holds columns i..n-1 and starts at rowbase(i, n)), with the two
// right-hand sides y and 1 behind them, are factored by ONE thread block:
// a right-looking Cholesky with the forward solve of [y, 1] fused in.
// Pivot j reads d_j = M[j][j], dinv = rsqrt(d_j), and downdates
// M[i][c] -= (M[j][i] dinv)(M[j][c] dinv) for j < i <= c; the solve
// updates ry[i] -= (M[j][i] dinv)(ry[j] dinv). logdet and the quadratics
// qyy = y'R^-1 y, qoy = 1'R^-1 y, qoo = 1'R^-1 1 accumulate pivot by pivot
// (`_chol_quad_core_shrink` in ccgp_tpu/ops/pallas_chol_smallk.py). One
// __syncthreads() per pivot. A negative pivot gives NaN (rsqrt and log of
// a negative number), which flows into the quadratics: nothing raises.
//
// After the core, row j of M (scaled by DINV[j]) holds column j of L, WY
// holds L^-1 y and WO L^-1 1.
//
// Arithmetic: every add, multiply and divide is an explicitly rounded
// intrinsic, so no multiply-add is contracted, and the operations run in
// the order of the plain PyTorch version (`_factor_plain` in
// ops/chol_smallk.py). exp / log / log1p / rsqrt are the CUDA math
// library's, as PyTorch's elementwise kernels use.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int MAX_K = 16;
constexpr int MAX_D = 128;           // input dimensions (the JAX kernels' TILE)
constexpr int MAX_DIM = MAX_D + 2;   // unconstrained state: d rates, phi, zeta
constexpr int NT = 1024;
constexpr int WARPS = NT / 32;
constexpr int UNROLL = 4;
constexpr size_t SMEM_PER_BLOCK = 232448;   // 227 KB opt-in on sm_90

// Packed upper triangle of an n x n matrix: row i holds columns i..n-1 and
// starts at i n - i (i - 1) / 2; rowbase(i) + c addresses (i, c), c >= i.
__device__ __forceinline__ size_t rowbase(int i, int n) {
  return (size_t)i * (2 * n - i - 1) / 2;
}

// K packed n x n triangles plus five K x n vectors (RY, RO, WY, WO, DINV);
// ops/chol_smallk.py allocates the same number of elements
inline size_t workspace_elems(int n, int K) {
  return (size_t)K * n * (n + 1) / 2 + (size_t)5 * K * n;
}

template <typename T> struct Ar;

template <> struct Ar<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float exp_(float a) { return expf(a); }
  static __device__ __forceinline__ float log_(float a) { return logf(a); }
  static __device__ __forceinline__ float log1p_(float a) { return log1pf(a); }
  static __device__ __forceinline__ float rsqrt_(float a) { return rsqrtf(a); }
};

template <> struct Ar<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double exp_(double a) { return exp(a); }
  static __device__ __forceinline__ double log_(double a) { return log(a); }
  static __device__ __forceinline__ double log1p_(double a) { return log1p(a); }
  static __device__ __forceinline__ double rsqrt_(double a) { return rsqrt(a); }
};

// The block's view of one factorization: the workspace (M, then RY, RO,
// WY, WO, DINV, each K x n) and the per-matrix accumulators in shared
// memory (s_dinv double-buffered by pivot: 2 x MAX_K).
template <typename T>
struct Factors {
  T* M;
  T* RY;
  T* RO;
  T* WY;
  T* WO;
  T* DINV;
  T* s_ld;
  T* s_qyy;
  T* s_qoy;
  T* s_qoo;
  T* s_dinv;

  __device__ Factors(T* ws, int n, int K, T* ld, T* qyy, T* qoy, T* qoo,
                     T* dinv2)
      : s_ld(ld), s_qyy(qyy), s_qoy(qoy), s_qoo(qoo), s_dinv(dinv2) {
    const size_t nn = (size_t)n * (n + 1) / 2;
    M = ws;
    RY = M + (size_t)K * nn;
    RO = RY + (size_t)K * n;
    WY = RO + (size_t)K * n;
    WO = WY + (size_t)K * n;
    DINV = WO + (size_t)K * n;
  }
};

// Factor the K matrices in M with the right-hand sides RY, RO (all written
// and visible to the block before the call). Every thread of the block
// must call it; it ends with a barrier.
template <typename T>
__device__ void factor_quadratics(const Factors<T>& f, int n, int K) {
  using A = Ar<T>;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t nn = (size_t)n * (n + 1) / 2;
  T* M = f.M;
  T* RY = f.RY;
  T* RO = f.RO;
  if (tid < K) {
    f.s_dinv[tid] = A::rsqrt_(M[(size_t)tid * nn]);
    f.s_ld[tid] = T(0);
    f.s_qyy[tid] = T(0);
    f.s_qoy[tid] = T(0);
    f.s_qoo[tid] = T(0);
  }
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    const int b = j & 1;
    const T* dinv_b = f.s_dinv + b * MAX_K;
    T* dinv_next = f.s_dinv + (b ^ 1) * MAX_K;
    if (tid < K) {
      const int k = tid;
      const T dj = M[(size_t)k * nn + rowbase(j, n) + j];
      const T dinv = dinv_b[k];
      const T wyj = A::mul(RY[(size_t)k * n + j], dinv);
      const T woj = A::mul(RO[(size_t)k * n + j], dinv);
      f.s_ld[k] = A::add(f.s_ld[k], A::log_(dj));
      f.WY[(size_t)k * n + j] = wyj;
      f.WO[(size_t)k * n + j] = woj;
      f.DINV[(size_t)k * n + j] = dinv;
      f.s_qyy[k] = A::add(f.s_qyy[k], A::mul(wyj, wyj));
      f.s_qoy[k] = A::add(f.s_qoy[k], A::mul(wyj, woj));
      f.s_qoo[k] = A::add(f.s_qoo[k], A::mul(woj, woj));
    }
    const int w = n - j - 1;
    // the solve: one thread per (matrix, row below the pivot)
    for (int e = tid; e < K * w; e += NT) {
      const int k = e / w, i = j + 1 + (e - k * w);
      const T dinv = dinv_b[k];
      const T li = A::mul(M[(size_t)k * nn + rowbase(j, n) + i], dinv);
      T* ry = RY + (size_t)k * n;
      T* ro = RO + (size_t)k * n;
      ry[i] = A::sub(ry[i], A::mul(li, A::mul(ry[j], dinv)));
      ro[i] = A::sub(ro[i], A::mul(li, A::mul(ro[j], dinv)));
    }
    // the downdate: a warp per row, each lane loading all of its columns
    // before it stores any (UNROLL * 32 columns per pass)
    for (int k = 0; k < K; ++k) {
      const T dinv = dinv_b[k];
      const T* Mj = M + (size_t)k * nn + rowbase(j, n);
      for (int i = j + 1 + warp; i < n; i += WARPS) {
        T* Mi = M + (size_t)k * nn + rowbase(i, n);
        const T li = A::mul(Mj[i], dinv);
        for (int c0 = i + lane; c0 < n; c0 += 32 * UNROLL) {
          T mi[UNROLL], mj[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int c = c0 + 32 * u;
            if (c < n) {
              mi[u] = Mi[c];
              mj[u] = Mj[c];
            }
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            const int c = c0 + 32 * u;
            if (c < n) {
              const T v = A::sub(mi[u], A::mul(li, A::mul(mj[u], dinv)));
              Mi[c] = v;
              if (c == j + 1) dinv_next[k] = A::rsqrt_(v);  // next pivot
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

// The K SE-mixture correlations built from x (n, d) into the packed upper
// triangles of f.M, with the right-hand sides y and 1 behind them:
//   R = (w1 exp(-sum_a r1_a dx_a^2) + w2 exp(-sum_a r2_a dx_a^2)) / wsum
//       (+ jitter on the diagonal),
// w1 = p^2, w2 = (1-p)^2, wsum = w1 + w2, the sums accumulated axis by axis
// (`_se_mix_gram_plain` in ops/chol_smallk.py). A warp per matrix row.
// Every thread of the block must call it once r1, r2, w1, w2 and wsum are
// visible; the caller syncs the block before it factors.
template <typename T>
__device__ void build_se_mix_grams(const Factors<T>& f,
                                   const T* __restrict__ x,
                                   const T* __restrict__ y,
                                   const T (*r1)[MAX_D], const T (*r2)[MAX_D],
                                   const T* w1, const T* w2, const T* wsum,
                                   int n, int d, int K, T jitter) {
  using A = Ar<T>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t nn = (size_t)n * (n + 1) / 2;
  for (int row = warp; row < K * n; row += WARPS) {
    const int k = row / n, i = row - k * n;
    T* Mi = f.M + (size_t)k * nn + rowbase(i, n);
    for (int c = i + lane; c < n; c += 32) {
      T dist1 = T(0), dist2 = T(0);
      for (int a = 0; a < d; ++a) {
        const T df = A::sub(x[(size_t)i * d + a], x[(size_t)c * d + a]);
        const T d2 = A::mul(df, df);
        dist1 = A::add(dist1, A::mul(d2, r1[k][a]));
        dist2 = A::add(dist2, A::mul(d2, r2[k][a]));
      }
      T v = A::div(A::add(A::mul(w1[k], A::exp_(-dist1)),
                          A::mul(w2[k], A::exp_(-dist2))), wsum[k]);
      if (c == i && jitter != T(0)) v = A::add(v, jitter);
      Mi[c] = v;
    }
    if (lane == 0) {
      f.RY[(size_t)k * n + i] = y[i];
      f.RO[(size_t)k * n + i] = T(1);
    }
  }
}

// Each candidate's log-posterior from the quadratics `factor_quadratics`
// left in f, quad = qyy - qoy^2 / qoo, beta = qoy / qoo,
//   val_k = -0.5 (n log 2pi + logdet_k + n log_scale_k
//                 + quad_k e^-log_scale_k) + extra_k,
// and the first k with (val_k - lpv) > log_u[k]; a NaN log-posterior
// compares false and so rejects. Returns that k and sets val_sel and
// beta_sel to its val and beta, or returns -1 and leaves them as they were.
// One thread calls it.
template <typename T>
__device__ int logpost_first_acceptance(const Factors<T>& f, const T* extra,
                                        const T* log_scale, const T* log_u,
                                        T lpv, int n, int K, T n_log2pi,
                                        T& val_sel, T& beta_sel) {
  using A = Ar<T>;
  for (int k = 0; k < K; ++k) {
    const T qoo = f.s_qoo[k], qoy = f.s_qoy[k];
    const T beta = A::div(qoy, qoo);
    const T quad = A::sub(f.s_qyy[k], A::div(A::mul(qoy, qoy), qoo));
    const T ls = log_scale[k];
    const T inner = A::add(
        A::add(A::add(n_log2pi, f.s_ld[k]), A::mul((T)n, ls)),
        A::mul(quad, A::exp_(-ls)));
    const T val = A::add(A::mul(T(-0.5), inner), extra[k]);
    if (A::sub(val, lpv) > log_u[k]) {
      val_sel = val;
      beta_sel = beta;
      return k;
    }
  }
  return -1;
}

// Launch `kernel<T, true>` with the workspace in dynamic shared memory when
// it fits beside the kernel's static arrays, else `kernel<T, false>` on the
// global workspace. Returns the launch's error code (a refused launch never
// runs, and its error is cleared so no later check reports it).
template <typename KSmem, typename KGlobal, typename Launch>
int launch_smem_or_global(KSmem ks, KGlobal kg, size_t ws_bytes,
                          Launch&& launch) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, ks);
  if (err != cudaSuccess) return (int)err;
  if (attr.sharedSizeBytes + ws_bytes <= SMEM_PER_BLOCK) {
    err = cudaFuncSetAttribute(ks, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)ws_bytes);
    if (err != cudaSuccess) return (int)err;
    launch(ks, ws_bytes);
  } else {
    launch(kg, (size_t)0);
  }
  return (int)cudaGetLastError();
}

}  // namespace
