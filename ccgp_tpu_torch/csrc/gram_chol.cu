// gram_chol: the fused mixture-Gram -> Cholesky -> quadratics kernel K8.
// For each lane b of a batch,
//   C_b = scale_b (w1 e^{-D1} + w2 e^{-D2}) / (w1 + w2) + shift_b J
//         + jitter I,
//   D1 = sum_k r1[b, k] (x_ik - x_jk)^2, D2 the same with r2[b],
//   w1 = p_b^2, w2 = (1 - p_b)^2,
// is built in shared memory and factored, with the forward solve of [y, 1]
// fused in -> {logdet, y'C^-1 y, 1'C^-1 y, 1'C^-1 1} per lane. No Gram
// exists in device memory.
//
// Replaces the Pallas kernel `fused_mix_quadratics`
// (ccgp_tpu/ops/pallas_gram_chol.py:121, body `_kernel` :45-118), which
// puts 128 lanes across the TPU's vector lanes, pads n to 128 and the batch
// to a multiple of 128, and stages the per-axis squared differences d2
// (d, n, n) in VMEM. Here one thread block owns one lane, with no padding:
// it stages the lane's rates, weights, scale and shift, builds the packed
// upper triangle of C from x (n, d) directly (csrc/chol_core.cuh's
// `build_se_mix_grams`, the SE-mixture builder of K1, K6 and K7, with its
// scale and shift), and factors it with the same core's
// `factor_quadratics` (right-looking, the forward solve fused into the
// pivot loop, logdet and the quadratics accumulated pivot by pivot; the
// TPU body's `step`, :85-107). K6 (`fused_mix_quadratics_smallk`, one
// block for K <= 16 candidates) is its latency sibling.
//
// A non-PD C takes rsqrt and log of a negative pivot: NaN in that lane's
// outputs only. No clamp, no error.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 67 TFLOP/s f32, 34
// TFLOP/s f64 outside the tensor cores): operations. Per lane it reads d
// rates twice and three scalars, and writes four numbers; x is shared. At
// an EB row (B = 1728, n = 14, d = 2, f64) the Gram build (2 exp and ~5 d
// + 8 operations per entry of the upper triangle) and the factorization
// (n^3 / 3 + 2 n^2) are ~4 MFLOP, ~0.12 us at the f64 peak; the bytes
// ~0.1 MB. The kernel is far from that: each lane is n pivot steps, each
// ending in a barrier of a 1024-thread block of which at n = 14 a few
// threads work. Several lanes per block at small n are later work.
//
// Arithmetic: explicitly rounded intrinsics in the order of the plain
// PyTorch version (`fused_mix_quadratics_plain` in ops/gram_chol.py; see
// csrc/chol_core.cuh).

#include "chol_core.cuh"

namespace {

constexpr int GRAM_CHOL_MAX_N = 128;  // the TPU tile
constexpr int GRAM_CHOL_MAX_D = 16;   // the TPU kernel's _RATE_ROWS

template <typename T>
__global__ void __launch_bounds__(NT)
gram_chol_kernel(const T* __restrict__ x, const T* __restrict__ y,
                 const T* __restrict__ r1, const T* __restrict__ r2,
                 const T* __restrict__ p, const T* __restrict__ scale,
                 const T* __restrict__ shift, T* __restrict__ q, int n,
                 int d, T jitter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = Ar<T>;
  __shared__ T s_r1[1][MAX_D], s_r2[1][MAX_D];
  __shared__ T s_w1[1], s_w2[1], s_ws[1], s_scale[1], s_shift[1];
  __shared__ T s_ld[1], s_qyy[1], s_qoy[1], s_qoo[1];
  __shared__ T s_dinv[2 * MAX_K];

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const Factors<T> f((T*)smem_raw, n, 1, s_ld, s_qyy, s_qoy, s_qoo, s_dinv);
  if (tid < d) {
    s_r1[0][tid] = r1[(size_t)b * d + tid];
    s_r2[0][tid] = r2[(size_t)b * d + tid];
  }
  if (tid == 0) {
    const T pb = p[b];
    const T qb = A::sub(T(1), pb);
    s_w1[0] = A::mul(pb, pb);
    s_w2[0] = A::mul(qb, qb);
    s_ws[0] = A::add(s_w1[0], s_w2[0]);
    s_scale[0] = scale[b];
    s_shift[0] = shift[b];
  }
  __syncthreads();
  build_se_mix_grams<T>(f, x, y, s_r1, s_r2, s_w1, s_w2, s_ws, n, d, 1,
                        jitter, s_scale, s_shift);
  __syncthreads();
  factor_quadratics<T>(f, n, 1);
  if (tid == 0) {
    T* o = q + (size_t)b * 4;
    o[0] = s_ld[0];
    o[1] = s_qyy[0];
    o[2] = s_qoy[0];
    o[3] = s_qoo[0];
  }
}

template <typename T>
int launch(const void* x, const void* y, const void* r1, const void* r2,
           const void* p, const void* scale, const void* shift, void* q,
           int B, int n, int d, double jitter, void* stream) {
  if (B < 1 || n < 1 || n > GRAM_CHOL_MAX_N || d < 1 || d > GRAM_CHOL_MAX_D)
    return (int)cudaErrorInvalidValue;
  // one packed triangle and five n-vectors: at n = 128 in f64 71 KB, so the
  // block opts in above 48 KB; a refusal is returned and cleared
  const size_t bytes = workspace_elems(n, 1) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      gram_chol_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  gram_chol_kernel<T><<<B, NT, bytes, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)y, (const T*)r1, (const T*)r2, (const T*)p,
      (const T*)scale, (const T*)shift, (T*)q, n, d, (T)jitter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ccgp_gram_chol_f32(const void* x, const void* y,
                                  const void* r1, const void* r2,
                                  const void* p, const void* scale,
                                  const void* shift, void* q, int B, int n,
                                  int d, double jitter, void* stream) {
  return launch<float>(x, y, r1, r2, p, scale, shift, q, B, n, d, jitter,
                       stream);
}

extern "C" int ccgp_gram_chol_f64(const void* x, const void* y,
                                  const void* r1, const void* r2,
                                  const void* p, const void* scale,
                                  const void* shift, void* q, int B, int n,
                                  int d, double jitter, void* stream) {
  return launch<double>(x, y, r1, r2, p, scale, shift, q, B, n, d, jitter,
                        stream);
}
