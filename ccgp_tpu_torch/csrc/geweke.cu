// Geweke's stopping test on the card: the p-value of `geweke_pvalue`
// (ccgp_tpu_torch/infer/geweke.py; coda's `geweke.diag` with
// `spectrum0.ar`) for B windows, one thread block per window, one p-value
// written per window.
//
// Replaces no TPU kernel: the JAX package runs the same test as XLA ops
// inside its sampling loop (ccgp_tpu/infer/geweke.py), with no Pallas
// kernel. Here a check is one launch, where as torch ops it would be
// several hundred small launches, or a read-back and as many host ops.
//
// What each block computes, in the window's type T (float or double), for
// the window's first n1 rows (part a) and its last n2 rows (part b) and
// each of its dim columns (2 dim problems):
//   mean; the autocovariances c_0..c_km with denominator m (the part's
//   length, km = min(m - 1, int(10 log10 m)), given by the caller); the
//   Levinson-Durbin recursion over orders k = 1..km,
//     acc = sum_{i<k-1} phi_i c_{k-1-i},  refl = (c_k - acc) / v,
//     phi_i <- phi_i - refl phi_{k-2-i},  phi_{k-1} = refl,
//     v <- v (1 - refl^2),  s_k = sum_{i<k} phi_i;
//   var_pred_k = v_k m / (m - (k + 1)), aic_k = m log(max(v_k, 1e-300)) +
//   2k (1e-300 rounded to T: 0 in float; NaN stays NaN), best = argmin
//   with torch.argmin's rules (the first of equal values, the first NaN
//   before anything), spec0 = var_pred_best / (1 - s_best)^2.
// Then per column z = (mean_a - mean_b) / sqrt(spec0_a / n1 + spec0_b /
// n2), p = 2 (1 - (1 + erf(|z| sqrt(1/2))) / 2) (torch.special.ndtr's
// formula), a non-finite p counting as 0, and the least p over columns.
//
// What bounds it on this card: serial latency. A check is ~600 dim values
// and ~1e5 operations; its floor is one launch plus the recursion's ~km^2
// dependent operations. So one block per window; a warp per (part,
// column) problem, looping when there are more problems than warps. Each
// warp reads its column where it lies (any strides: the chain buffer's
// rows in place, no copy) into its own shared-memory slice, sums it by
// shuffles, centres it, and its lane l accumulates lag l (four partial
// sums to break the add chain). Lane 0 then runs the recursion and the
// AIC scan, with phi, c, v and s in shared memory. Warp 0 combines the
// columns. Nothing is allocated, nothing synchronises.
//
// Arithmetic: every add, multiply and divide is an explicitly rounded
// intrinsic (`Ar`, csrc/chol_core.cuh), so no multiply-add is contracted;
// log and erf are the CUDA math library's. Sums run in another order than
// PyTorch's, so the p-value agrees with the plain version to rounding
// (float64) or to ~1e-5 (float32), not bit for bit.

#include <math.h>
#include <stdint.h>

#include "chol_core.cuh"

namespace {

constexpr int GEWEKE_MAX_THREADS = 1024;

template <typename T> __device__ __forceinline__ T erf_(T x);
template <> __device__ __forceinline__ float erf_(float x) { return erff(x); }
template <> __device__ __forceinline__ double erf_(double x) { return erf(x); }

// clamp_min's 1e-300 in T: it rounds to 0 in float, as the scalar does in
// torch.clamp_min of a float tensor
template <typename T> __device__ __forceinline__ T aic_floor();
template <> __device__ __forceinline__ float aic_floor() { return 0.0f; }
template <> __device__ __forceinline__ double aic_floor() { return 1e-300; }

// the sum over the warp, the same on every lane (a butterfly: each step
// adds the same two numbers on both lanes of a pair)
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = Ar<T>::add(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// shared memory of one warp: the part's column, then c, v, s and phi
__host__ __device__ inline size_t warp_elems(int n1, int n2, int km1,
                                             int km2) {
  return (size_t)(n1 > n2 ? n1 : n2) + 4 * (size_t)((km1 > km2 ? km1 : km2)
                                                    + 1);
}

// spec0 and mean of one column of one part: src points at the part's
// first row, column j; m rows `ld` apart; km the AIC's largest order
template <typename T>
__device__ void part_spectrum(const T* __restrict__ src, long long ld, int m,
                              int km, T* col, T* c, T* vs, T* ss, T* phi,
                              T* mean_out, T* spec_out, int lane) {
  using A = Ar<T>;
  T part = T(0);
#pragma unroll 4
  for (int i = lane; i < m; i += 32) {
    const T v = src[(long long)i * ld];
    col[i] = v;
    part = A::add(part, v);
  }
  const T mean = A::div(warp_sum(part), (T)m);
  for (int i = lane; i < m; i += 32) col[i] = A::sub(col[i], mean);
  __syncwarp();
  // autocovariances: lane l accumulates lag l, in four partial sums
  for (int l = lane; l <= km; l += 32) {
    const int len = m - l;
    T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
    int i = 0;
    for (; i + 4 <= len; i += 4) {
      a0 = A::add(a0, A::mul(col[i], col[i + l]));
      a1 = A::add(a1, A::mul(col[i + 1], col[i + 1 + l]));
      a2 = A::add(a2, A::mul(col[i + 2], col[i + 2 + l]));
      a3 = A::add(a3, A::mul(col[i + 3], col[i + 3 + l]));
    }
    for (; i < len; ++i) a0 = A::add(a0, A::mul(col[i], col[i + l]));
    c[l] = A::div(A::add(A::add(a0, a1), A::add(a2, a3)), (T)m);
  }
  __syncwarp();
  if (lane != 0) return;
  // Levinson-Durbin over orders 1..km
  T v = c[0];
  vs[0] = v;
  ss[0] = T(0);
  for (int k = 1; k <= km; ++k) {
    T acc = T(0);
    for (int i = 0; i < k - 1; ++i)
      acc = A::add(acc, A::mul(phi[i], c[k - 1 - i]));
    const T refl = A::div(A::sub(c[k], acc), v);
    for (int i = 0, h = k - 2; i <= h; ++i, --h) {
      const T pi = phi[i], ph = phi[h];
      phi[i] = A::sub(pi, A::mul(refl, ph));
      if (h != i) phi[h] = A::sub(ph, A::mul(refl, pi));
    }
    phi[k - 1] = refl;
    v = A::mul(v, A::sub(T(1), A::mul(refl, refl)));
    T s = T(0);
    for (int i = 0; i < k; ++i) s = A::add(s, phi[i]);
    vs[k] = v;
    ss[k] = s;
  }
  // AIC's order: the first NaN, else the first least value
  const T lo = aic_floor<T>();
  const T mt = (T)m;
  int best = 0;
  T best_aic = T(0);
  for (int k = 0; k <= km; ++k) {
    const T vk = vs[k];
    const T aic = A::add(A::mul(mt, A::log_(vk < lo ? lo : vk)),
                         A::mul(T(2), (T)k));
    if (isnan(aic)) {
      best = k;
      break;
    }
    if (k == 0 || aic < best_aic) {
      best = k;
      best_aic = aic;
    }
  }
  const T var_pred = A::mul(vs[best],
                            A::div(mt, A::sub(mt, A::add((T)best, T(1)))));
  const T d = A::sub(T(1), ss[best]);
  *mean_out = mean;
  *spec_out = A::div(var_pred, A::mul(d, d));
}

// Window b's element (r, j) is x[b ws + r ld + j cs]; out[b] its p-value.
template <typename T>
__global__ void __launch_bounds__(GEWEKE_MAX_THREADS)
geweke_kernel(const T* __restrict__ x, T* __restrict__ out, long long ws,
              long long ld, long long cs, int n, int dim, int n1, int n2,
              int km1, int km2) {
  using A = Ar<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nmax = n1 > n2 ? n1 : n2;
  const int kmax = km1 > km2 ? km1 : km2;
  T* col = sm + (size_t)warp * warp_elems(n1, n2, km1, km2);
  T* c = col + nmax;
  T* vs = c + kmax + 1;
  T* ss = vs + kmax + 1;
  T* phi = ss + kmax + 1;
  T* means = sm + (size_t)warps * warp_elems(n1, n2, km1, km2);   // [2][dim]
  T* specs = means + 2 * dim;
  const T* win = x + (long long)blockIdx.x * ws;
  // problem p: part p / dim (a, then b), column p % dim
  for (int p = warp; p < 2 * dim; p += warps) {
    const int b = p >= dim, j = p - b * dim;
    part_spectrum<T>(win + (b ? (long long)(n - n2) * ld : 0)
                         + (long long)j * cs,
                     ld, b ? n2 : n1, b ? km2 : km1, col, c, vs, ss, phi,
                     means + p, specs + p, lane);
    __syncwarp();
  }
  __syncthreads();
  if (warp != 0) return;
  const T sqrt1_2 = (T)0.70710678118654752440;
  T pmin = (T)INFINITY;
  for (int j = lane; j < dim; j += 32) {
    const T z = A::div(A::sub(means[j], means[dim + j]),
                       A::sqrt_(A::add(A::div(specs[j], (T)n1),
                                       A::div(specs[dim + j], (T)n2))));
    const T ndtr = A::mul(A::add(T(1), erf_(A::mul(fabs(z), sqrt1_2))),
                          (T)0.5);
    T pv = A::mul(T(2), A::sub(T(1), ndtr));
    if (!isfinite(pv)) pv = T(0);
    pmin = pv < pmin ? pv : pmin;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T other = __shfl_xor_sync(0xffffffffu, pmin, o);
    pmin = other < pmin ? other : pmin;
  }
  if (lane == 0) out[blockIdx.x] = pmin;
}

template <typename T>
int launch(const void* x, void* out, long long ws, long long ld,
           long long cs, int B, int n, int dim, int n1, int n2, int km1,
           int km2, int warps, void* stream) {
  if (B < 1 || dim < 1 || n1 < 1 || n2 < 1 || n1 > n || n2 > n || km1 < 0
      || km2 < 0 || km1 >= n1 || km2 >= n2 || warps < 1
      || warps * 32 > GEWEKE_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = ((size_t)warps * warp_elems(n1, n2, km1, km2)
                        + 4 * (size_t)dim) * sizeof(T);
  if (bytes > SMEM_PER_BLOCK) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    // above 48 KB the block must opt in; a refusal is returned and cleared
    const cudaError_t err = cudaFuncSetAttribute(
        geweke_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
  }
  geweke_kernel<T><<<B, warps * 32, bytes, (cudaStream_t)stream>>>(
      (const T*)x, (T*)out, ws, ld, cs, n, dim, n1, n2, km1, km2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ccgp_geweke_f32(const void* x, void* out, long long ws,
                               long long ld, long long cs, int B, int n,
                               int dim, int n1, int n2, int km1, int km2,
                               int warps, void* stream) {
  return launch<float>(x, out, ws, ld, cs, B, n, dim, n1, n2, km1, km2,
                       warps, stream);
}

extern "C" int ccgp_geweke_f64(const void* x, void* out, long long ws,
                               long long ld, long long cs, int B, int n,
                               int dim, int n1, int n2, int km1, int km2,
                               int warps, void* stream) {
  return launch<double>(x, out, ws, ld, cs, B, n, dim, n1, n2, km1, km2,
                        warps, stream);
}
