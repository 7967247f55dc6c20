// chol_nll: a batch of B Cholesky factorizations, each followed by a
// separate forward substitution of [y, 1]. Out: logdet, y'R^-1 y, 1'R^-1 y,
// 1'R^-1 1 per matrix.
//
// Replaces the Pallas kernel `_chol_nll_pallas`
// (ccgp_tpu/ops/pallas_chol.py:186) in its default body,
// `_chol_nll_kernel_blocked` (:107-183): per matrix, L = chol(G + jitter I)
// by LEFT-looking 8-column panels, then W = L^-1 [y, 1] by the same panels,
// then logdet = 2 sum log L_jj and the three quadratics sum W_y^2,
// sum W_y W_o, sum W_o^2.
//
// The TPU kernel pads every matrix to 128 with an identity block and
// unrolls the 16 panels at trace time. Here one thread block owns one
// matrix, with no padding (the identity block adds 0 to every output):
//   load:   the lower triangle of G (+ jitter on the diagonal) into shared
//           memory, column-major with a leading dimension of n + 1 (so a
//           warp walking down a column hits 32 banks);
//   panel:  columns r0..r0+7. Downdate: each entry (i, r0 + jj), i >=
//           r0 + jj, minus sum_{c < r0} L[i][c] L[r0+jj][c], one thread per
//           entry, the sum accumulated in c order (the TPU kernel's
//           `slab - prev @ prev_rows.T`). Then the in-panel recursion,
//           column by column: d = sqrt(pivot), the column below it / d,
//           then the panel's later columns minus col_i * col_pivot; two
//           __syncthreads() per column;
//   solve:  per panel, 2 x 8 threads downdate the right-hand sides by the
//           finished rows, then one thread per right-hand side runs the
//           in-panel recursion;
//   out:    one thread sums 2 log L_jj and the quadratics in row order.
// Only the lower triangle is read: an entry above the diagonal changes no
// output. This is a different design from csrc/chol_lanes.cu (K3, right-
// looking with the solve fused into the pivot loop): the left-looking
// panels touch each finished column again for every later panel.
//
// A non-PD matrix takes the square root of a negative pivot: NaN, which
// flows into that matrix's outputs only. No clamp, no error.
//
// What bounds it on the card (H100 SXM: 3.35 TB/s, 67 TFLOP/s f32, 34
// TFLOP/s f64 outside the tensor cores): at the MAP cloud's shape (B = 128,
// n = 100, f32) the lower triangles are 2.6 MB, ~0.77 us, and the
// n^3 / 3 + 2 n^2 operations 45 MFLOP, ~0.68 us. The kernel is far from
// both: each panel is a chain of barriers, and the downdate's dot products
// (up to 120 terms) run one per thread. The design reads each lower
// triangle once and writes four numbers per matrix.
//
// Arithmetic: every add, multiply, divide and square root is an explicitly
// rounded intrinsic (no contracted multiply-add; csrc/chol_core.cuh's
// `Ar`), in the order of the plain PyTorch version (`chol_nll_plain` in
// ops/chol_nll.py); log is the CUDA math library's, as PyTorch's
// elementwise kernel uses.

#include "chol_core.cuh"

namespace {

constexpr int NLL_THREADS = 256;
constexpr int PANEL = 8;    // the TPU kernel's nb
constexpr int MAX_N = 128;  // the TPU tile

template <typename T>
__global__ void __launch_bounds__(NLL_THREADS)
chol_nll_kernel(const T* __restrict__ grams, const T* __restrict__ y,
                T* __restrict__ q, int n, T jitter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = Ar<T>;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = NLL_THREADS / 32;
  const int ld = n + 1;
  T* Lc = (T*)smem_raw;              // L[i][c] at Lc[c * ld + i], i >= c
  T* W = Lc + (size_t)n * ld;        // W[i][s] at W[2 i + s]: s = 0 y, 1 ones
  auto L = [&](int i, int c) -> T& { return Lc[(size_t)c * ld + i]; };

  // the lower triangle, a warp per row (contiguous global reads)
  const T* g = grams + (size_t)blockIdx.x * n * n;
  for (int i = warp; i < n; i += warps) {
    const T* gi = g + (size_t)i * n;
    for (int c = lane; c <= i; c += 32) {
      const T v = gi[c];
      L(i, c) = c == i ? A::add(v, jitter) : v;
    }
  }
  __syncthreads();

  // the factorization, left-looking panels of PANEL columns
  for (int r0 = 0; r0 < n; r0 += PANEL) {
    const int nb = min(PANEL, n - r0);
    const int rows = n - r0;
    if (r0) {
      for (int e = tid; e < nb * rows; e += NLL_THREADS) {
        const int jj = e / rows, i = r0 + (e - jj * rows);
        const int p = r0 + jj;
        if (i < p) continue;
        T acc = T(0);
        for (int c = 0; c < r0; ++c)
          acc = A::add(acc, A::mul(L(i, c), L(p, c)));
        L(i, p) = A::sub(L(i, p), acc);
      }
      __syncthreads();
    }
    for (int j = 0; j < nb; ++j) {
      const int p = r0 + j;
      // the column below the pivot over d (the diagonal is read, not written)
      const T d = A::sqrt_(L(p, p));
      for (int i = p + 1 + tid; i < n; i += NLL_THREADS)
        L(i, p) = A::div(L(i, p), d);
      __syncthreads();
      // the panel's later columns, and the pivot itself (no one reads it now)
      const int later = nb - j - 1;
      for (int e = tid; e < later * rows; e += NLL_THREADS) {
        const int k = e / rows, i = r0 + (e - k * rows);
        const int c = p + 1 + k;
        if (i < c) continue;
        L(i, c) = A::sub(L(i, c), A::mul(L(i, p), L(c, p)));
      }
      if (tid == 0) L(p, p) = d;
      __syncthreads();
    }
  }

  // the forward substitution W = L^-1 [y, 1], the same panels
  for (int r0 = 0; r0 < n; r0 += PANEL) {
    const int nb = min(PANEL, n - r0);
    if (tid < 2 * nb) {
      const int p = r0 + (tid >> 1), s = tid & 1;
      T b = s ? T(1) : y[p];
      if (r0) {
        T acc = T(0);
        for (int c = 0; c < r0; ++c)
          acc = A::add(acc, A::mul(L(p, c), W[2 * c + s]));
        b = A::sub(b, acc);
      }
      W[2 * p + s] = b;
    }
    __syncthreads();
    if (tid < 2) {
      const int s = tid;
      for (int j = 0; j < nb; ++j) {
        const int p = r0 + j;
        T acc = T(0);
        for (int c = r0; c < p; ++c)
          acc = A::add(acc, A::mul(L(p, c), W[2 * c + s]));
        W[2 * p + s] = A::div(A::sub(W[2 * p + s], acc), L(p, p));
      }
    }
    __syncthreads();
  }

  if (tid == 0) {
    T ld_ = T(0), qyy = T(0), qoy = T(0), qoo = T(0);
    for (int p = 0; p < n; ++p) {
      const T wy = W[2 * p], wo = W[2 * p + 1];
      ld_ = A::add(ld_, A::log_(L(p, p)));
      qyy = A::add(qyy, A::mul(wy, wy));
      qoy = A::add(qoy, A::mul(wy, wo));
      qoo = A::add(qoo, A::mul(wo, wo));
    }
    T* qb = q + (size_t)blockIdx.x * 4;
    qb[0] = A::mul(T(2), ld_);
    qb[1] = qyy;
    qb[2] = qoy;
    qb[3] = qoo;
  }
}

// L (n x (n + 1), column-major) and W (n x 2)
size_t smem_bytes(int n, size_t elem) {
  return ((size_t)n * (n + 1) + (size_t)2 * n) * elem;
}

template <typename T>
int launch(const void* grams, const void* y, void* q, int B, int n,
           double jitter, void* stream) {
  if (B < 1 || n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(n, sizeof(T));
  // above 48 KB the block must opt in; a refusal is returned and cleared
  cudaError_t err = cudaFuncSetAttribute(
      chol_nll_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  chol_nll_kernel<T><<<B, NLL_THREADS, bytes, (cudaStream_t)stream>>>(
      (const T*)grams, (const T*)y, (T*)q, n, (T)jitter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ccgp_chol_nll_f32(const void* grams, const void* y, void* q,
                                 int B, int n, double jitter, void* stream) {
  return launch<float>(grams, y, q, B, n, jitter, stream);
}

extern "C" int ccgp_chol_nll_f64(const void* grams, const void* y, void* q,
                                 int B, int n, double jitter, void* stream) {
  return launch<double>(grams, y, q, B, n, jitter, stream);
}
