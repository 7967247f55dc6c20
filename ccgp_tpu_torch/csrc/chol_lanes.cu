// chol_lanes: a batch of B Cholesky factorizations with the forward solve of
// [y, 1] fused in. Out: logdet, y'R^-1 y, 1'R^-1 y, 1'R^-1 1 per matrix
// and, with the factor output on, L (lower), L^-1 y and L^-1 1.
//
// Replaces both Pallas kernels of ccgp_tpu/ops/pallas_chol_lanes.py:
//   K3 `chol_quadratics_lanes` (body `_kernel`, :34-92; wrapper :236-298),
//   K4 `chol_factors_lanes` (body `_kernel_factors`, :95-151; wrapper
//      :154-233),
// as one template with the factor output as a compile-time flag.
//
// The TPU kernel puts 128 matrices across the VPU lanes and pads n and B to
// 128 with identity blocks. None of that carries over: here one thread
// block owns one matrix, held in shared memory (n x n row-major; only the
// lower triangle is loaded from the Gram and read), with no padding of n or
// B. Per pivot j:
//   phase 1: d = sqrt(M[j][j]); COL[i] = M[i][j] / d for i > j; one thread
//            forms L^-1 y and L^-1 1 at row j (RY[j] / d, RO[j] / d) and
//            accumulates logdet += 2 log d and the three quadratics;
//   phase 2: the right-hand sides RY[i] -= COL[i] wy_j (and RO), and the
//            trailing lower triangle M[i][c] -= COL[i] COL[c] for
//            j < c <= i, a warp per row (lanes along the row, so shared
//            memory is read along contiguous addresses).
// Two __syncthreads() per pivot. Column j below the diagonal is never
// written after step j - 1, so the factor is read off at the end as
// L[i][c] = M[i][c] / d_c and written out row by row (coalesced).
//
// A non-PD Gram takes the square root of a negative pivot: NaN, which
// flows into logdet and the quadratics (a log-posterior of -inf, i.e. a
// rejection). No clamp, no error.
//
// What bounds it on the card, at the slice's shapes (H100 SXM: 3.35 TB/s,
// 67 TFLOP/s f32 and 34 TFLOP/s f64 outside the tensor cores): memory.
// The bytes are the Grams' lower triangles, n (n + 1) / 2 entries each,
// plus the outputs (K4's factor is dense, n x n with zeros above).
//   K3, MAP cloud, B = 128, n = 100, f32: 2.6 MB read, ~0.77 us; 45 MFLOP,
//       ~0.68 us.
//   K4, lazy predict chunk, B = 64, n = 100, f32: 1.3 MB in, 2.6 MB out,
//       ~1.2 us.
//   K3, EB row, B = 1728, n = 14, f64: 1.5 MB, ~0.45 us.
// The design reads each Gram's lower triangle once and writes each output
// once, so it moves no more than the bound's bytes (up to the 32-byte
// sectors that a row's ends share with the upper triangle). It is still
// far from the bound:
// a factorization is n sequential pivot steps, each ending in a block
// barrier, so a block's time is ~n barrier-separated steps of a few
// shared-memory passes. At n = 14 a block of 64 threads works on at most
// 13 x 13 trailing entries and is mostly idle; the EB rows fill the card
// with 1728 blocks instead. Speed (several matrices per block at small n,
// register-tiled panels at n = 100) is later work.
//
// Arithmetic: every add, multiply and divide is an explicitly rounded
// intrinsic (no contracted multiply-add), in the order of the plain
// PyTorch version (`_factor_plain` in ops/chol_lanes.py); sqrt is IEEE.
// log is the CUDA math library's, as PyTorch's elementwise kernel uses.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_THREADS = 512;

template <typename T> struct Ar;

template <> struct Ar<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float sqrt_(float a) { return __fsqrt_rn(a); }
  static __device__ __forceinline__ float log_(float a) { return logf(a); }
};

template <> struct Ar<double> {
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double sqrt_(double a) { return __dsqrt_rn(a); }
  static __device__ __forceinline__ double log_(double a) { return log(a); }
};

// threads per block: enough warps for the first trailing triangle
int threads_for(int n) {
  if (n <= 16) return 64;
  if (n <= 32) return 128;
  if (n <= 64) return 256;
  return MAX_THREADS;
}

template <typename T, bool FACTORS>
__global__ void __launch_bounds__(MAX_THREADS)
chol_lanes_kernel(const T* __restrict__ grams, const T* __restrict__ y,
                  T* __restrict__ q, T* __restrict__ chol,
                  T* __restrict__ wy_out, T* __restrict__ wo_out, int n,
                  T jitter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = Ar<T>;
  __shared__ T s_ld, s_qyy, s_qoy, s_qoo;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = nt >> 5;
  const size_t nn = (size_t)n * n;
  T* M = (T*)smem_raw;     // the Gram, then the downdated lower triangle
  T* RY = M + nn;          // right-hand sides, downdated
  T* RO = RY + n;
  T* COL = RO + n;         // the current pivot column over its pivot
  T* D = COL + n;          // pivots d_j = sqrt of the downdated diagonal
  T* WY = D + n;           // L^-1 y
  T* WO = WY + n;          // L^-1 1

  // only the lower triangle is loaded (a warp per row, lanes along it);
  // the upper triangle of M is never read
  const T* g = grams + (size_t)blockIdx.x * nn;
  for (int i = warp; i < n; i += warps) {
    const T* gi = g + (size_t)i * n;
    T* Mi = M + (size_t)i * n;
    for (int c = lane; c <= i; c += 32) {
      const T v = gi[c];
      Mi[c] = c == i ? A::add(v, jitter) : v;
    }
  }
  for (int i = tid; i < n; i += nt) {
    RY[i] = y[i];
    RO[i] = T(1);
  }
  if (tid == 0) {
    s_ld = T(0);
    s_qyy = T(0);
    s_qoy = T(0);
    s_qoo = T(0);
  }
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    // phase 1: the pivot, its column, row j of the solve, the quadratics
    const T d = A::sqrt_(M[(size_t)j * n + j]);
    for (int i = j + 1 + tid; i < n; i += nt)
      COL[i] = A::div(M[(size_t)i * n + j], d);
    if (tid == 0) {
      const T wyj = A::div(RY[j], d);
      const T woj = A::div(RO[j], d);
      WY[j] = wyj;
      WO[j] = woj;
      D[j] = d;
      s_ld = A::add(s_ld, A::mul(T(2), A::log_(d)));
      s_qyy = A::add(s_qyy, A::mul(wyj, wyj));
      s_qoy = A::add(s_qoy, A::mul(wyj, woj));
      s_qoo = A::add(s_qoo, A::mul(woj, woj));
    }
    __syncthreads();

    // phase 2: downdate the right-hand sides and the trailing triangle
    const T wyj = WY[j], woj = WO[j];
    for (int i = j + 1 + tid; i < n; i += nt) {
      RY[i] = A::sub(RY[i], A::mul(COL[i], wyj));
      RO[i] = A::sub(RO[i], A::mul(COL[i], woj));
    }
    for (int i = j + 1 + warp; i < n; i += warps) {
      const T li = COL[i];
      T* Mi = M + (size_t)i * n;
      for (int c = j + 1 + lane; c <= i; c += 32)
        Mi[c] = A::sub(Mi[c], A::mul(li, COL[c]));
    }
    __syncthreads();
  }

  const int b = blockIdx.x;
  if (tid == 0) {
    T* qb = q + (size_t)b * 4;
    qb[0] = s_ld;
    qb[1] = s_qyy;
    qb[2] = s_qoy;
    qb[3] = s_qoo;
  }
  if (FACTORS) {
    T* L = chol + (size_t)b * nn;
    for (int e = tid; e < (int)nn; e += nt) {
      const int i = e / n, c = e - i * n;
      L[e] = c < i ? A::div(M[e], D[c]) : (c == i ? D[i] : T(0));
    }
    for (int i = tid; i < n; i += nt) {
      wy_out[(size_t)b * n + i] = WY[i];
      wo_out[(size_t)b * n + i] = WO[i];
    }
  }
}

// the Gram plus six n-vectors (RY, RO, COL, D, WY, WO)
size_t smem_bytes(int n, size_t elem) {
  return ((size_t)n * n + (size_t)6 * n) * elem;
}

template <typename T, bool FACTORS>
int launch_t(const void* grams, const void* y, void* q, void* chol, void* wy,
             void* wo, int B, int n, double jitter, void* stream) {
  const size_t bytes = smem_bytes(n, sizeof(T));
  // above 48 KB the block must opt in; a request past the card's limit is
  // refused here (and cleared, so that no later launch check reports it)
  cudaError_t err = cudaFuncSetAttribute(
      chol_lanes_kernel<T, FACTORS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  chol_lanes_kernel<T, FACTORS><<<B, threads_for(n), bytes,
                                  (cudaStream_t)stream>>>(
      (const T*)grams, (const T*)y, (T*)q, (T*)chol, (T*)wy, (T*)wo, n,
      (T)jitter);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* grams, const void* y, void* q, void* chol, void* wy,
           void* wo, int B, int n, int factors, double jitter, void* stream) {
  if (B < 1 || n < 1) return (int)cudaErrorInvalidValue;
  if (factors)
    return launch_t<T, true>(grams, y, q, chol, wy, wo, B, n, jitter, stream);
  return launch_t<T, false>(grams, y, q, chol, wy, wo, B, n, jitter, stream);
}

}  // namespace

extern "C" int ccgp_chol_lanes_f32(const void* grams, const void* y, void* q,
                                   void* chol, void* wy, void* wo, int B,
                                   int n, int factors, double jitter,
                                   void* stream) {
  return launch<float>(grams, y, q, chol, wy, wo, B, n, factors, jitter,
                       stream);
}

extern "C" int ccgp_chol_lanes_f64(const void* grams, const void* y, void* q,
                                   void* chol, void* wy, void* wo, int B,
                                   int n, int factors, double jitter,
                                   void* stream) {
  return launch<double>(grams, y, q, chol, wy, wo, B, n, factors, jitter,
                        stream);
}
