// mh_rounds: R whole speculative Metropolis rounds of the SE-mixture
// combined-GP sampler in ONE launch.
//
// Replaces the Pallas kernel `fused_mix_mh_rounds` (body
// `_make_mh_rounds_kernel`, ccgp_tpu/ops/pallas_chol_smallk.py:1187-1492)
// with both of its factorization cores: the single-tile
// `_chol_quad_core_shrink` (n <= 128) and the multi-tile blocked-Schur
// `_chol_quad_core_multitile` (128 < n <= 1024). On the TPU the matrix
// lives in VMEM and the core is chosen by tile count; here one loop covers
// the whole dispatch envelope (n <= 1024, K <= 16, K * tiles^2 <= 256).
//
// Per round r, for the K candidates z + delta[r, k]:
//   1. the candidate model (unconstrained -> constrained transform,
//      log-Jacobian, priors; `CandModel`), one thread per candidate;
//   2. the SE-mixture Gram from x directly,
//        R = (p^2 exp(-sum_a r1_a dx_a^2) + (1-p)^2 exp(-sum_a r2_a dx_a^2))
//            / (p^2 + (1-p)^2)  (+ jitter on the diagonal),
//      stored as its upper triangle (`build_se_mix_grams`);
//   3. a right-looking Cholesky with the forward solve of [y, 1] fused in
//      (`factor_quadratics`):
//      pivot j reads d_j = M[j][j], dinv = rsqrt(d_j), and downdates
//      M[i][c] -= (M[j][i] dinv)(M[j][c] dinv) for j < i <= c; the
//      solve updates ry[i] -= (M[j][i] dinv)(ry[j] dinv). One
//      __syncthreads() per pivot;
//   4. logdet and the quadratics qyy, qoy, qoo (accumulated pivot by
//      pivot), beta = qoy / qoo and the log-posterior;
//   5. the first-acceptance scan: (val_k - lp_val) > log_u[r, k]; a NaN
//      log-posterior compares false and so rejects
//      (`logpost_first_acceptance`);
//   steps 2-5 are the device functions of csrc/chol_core.cuh, shared with
//   the K5-K7 kernels of csrc/chol_smallk.cu;
//   6. one rec row [z | beta | logpost], one info row [acc, consumed],
//      and, with the stash on, the accepted candidate's row-scaled factor
//      rows (row j: L[i][j] at column i >= j), L^-1 y and L^-1 1.
//
// What bounds it on the card: latency, not FLOPs or bytes. The chain is
// sequential across rounds and a factorization is sequential across its
// n pivots, each ending in a block barrier; at the bench shape (n = 100,
// K = 4) one pivot's downdate is at most ~20k multiply-subtracts. The
// design is therefore ONE thread block of 1024 threads per launch that
// loops over all R rounds and carries the chain state (z, lp_val,
// lp_beta) in shared memory: no per-round launch, no host round trip.
// In a pivot step a warp owns a matrix row at a time, so the pivot row
// and the updated row are read along contiguous addresses, and each lane
// issues all of its loads before its stores, so that a row's loads are in
// flight together. The K matrices are stored as packed upper triangles
// (K n(n+1)/2 values) with the right-hand sides behind them, in shared
// memory whenever they fit beside the kernel's static arrays (89 KB at
// the bench shape in f32, 178 KB in f64) and otherwise in a global
// workspace the wrapper allocates (up to 17 MB at the envelope's edge in
// f64, held in the 50 MB L2). One block uses 1 of the card's 132 SMs.
// Measured on an NVIDIA H100 80GB HBM3 (700 W power limit) at the bench
// shape in f32: ~390 us per round, which fits ~2.3 us per pivot step plus
// a K n^3 term. The per-step part is instruction issue and the barrier on
// that one SM: moving the workspace from L2 to shared memory saved ~5%,
// loading before storing ~40%. Using more SMs (a cluster of K blocks,
// warp-level pivots) is later work.
//
// Arithmetic: every add, multiply and divide is an explicitly rounded
// intrinsic, so no multiply-add is contracted, and the operations run in
// the order of the plain PyTorch version (`fused_mix_mh_rounds_plain` in
// ops/chol_smallk.py). exp / log / log1p / rsqrt are the CUDA math
// library's, as PyTorch's elementwise kernels use.

#include <stdint.h>

#include "chol_core.cuh"

namespace {

// must match ops/chol_smallk.py CandModel
struct CandModel {
  int anisotropic;
  int ndim;
  int tied;
  int prior_code[3];   // theta1, theta2, p
  double prior_a[3];
  double prior_b[3];
};

enum { PRIOR_NONE = 0, PRIOR_INVGAMMA, PRIOR_LOGNORMAL, PRIOR_UNIFORM01,
       PRIOR_JEFFREYS };

template <typename T>
__device__ T sigmoid(T x) {
  using A = Ar<T>;
  return A::div(T(1), A::add(T(1), A::exp_(-x)));
}

// -(max(-x, 0) + log1p(exp(-|x|)))
template <typename T>
__device__ T log_sigmoid(T x) {
  using A = Ar<T>;
  T m = -x > T(0) ? -x : T(0);
  return -A::add(m, A::log1p_(A::exp_(-fabs(x))));
}

template <typename T>
__device__ T prior_kernel(int code, double a, double b, T x) {
  using A = Ar<T>;
  switch (code) {
    case PRIOR_INVGAMMA:   // -(a+1) log x - b / x
      return A::sub(A::mul(-(T)(a + 1.0), A::log_(x)), A::div((T)b, x));
    case PRIOR_LOGNORMAL: {  // -log x - 0.5 ((log x - mu) / sigma)^2
      T lx = A::log_(x);
      T t = A::div(A::sub(lx, (T)a), (T)b);
      return A::sub(-lx, A::mul(T(0.5), A::mul(t, t)));
    }
    case PRIOR_UNIFORM01:
      return T(0);
    case PRIOR_JEFFREYS:   // -0.5 (log x + log1p(-x))
      return A::mul(T(-0.5), A::add(A::log_(x), A::log1p_(-x)));
    default:
      return T(0);
  }
}

// Candidate model for the candidate z + dl (see
// ops/chol_smallk.cand_model_plain).
template <typename T>
__device__ void cand_model(const CandModel& m, const T* z, const T* dl, T s2,
                           T* r1, T* r2, T& p, T& extra, T& log_scale) {
  using A = Ar<T>;
  const auto cz = [&](int c) { return A::add(z[c], dl[c]); };
  const int d = m.ndim;
  T th2, log_jac, theta1 = T(0);
  if (m.anisotropic) {
    T psi_sum = cz(0);
    r1[0] = A::exp_(psi_sum);
    for (int a = 1; a < d; ++a) {
      const T za = cz(a);
      r1[a] = A::exp_(za);
      psi_sum = A::add(psi_sum, za);
    }
    const T phi = cz(d), zeta = cz(d + 1);
    th2 = A::exp_(zeta);
    p = sigmoid(phi);
    log_jac = A::add(A::add(psi_sum, zeta),
                     A::add(log_sigmoid(phi), log_sigmoid(-phi)));
  } else {
    const T psi1 = cz(0), psi2 = cz(1), phi = cz(2);
    theta1 = A::exp_(psi1);
    th2 = A::exp_(psi2);
    p = sigmoid(phi);
    log_jac = A::add(A::add(psi1, psi2),
                     A::add(log_sigmoid(phi), log_sigmoid(-phi)));
    for (int a = 0; a < d; ++a) r1[a] = theta1;
  }
  const T lam1 = A::add(T(1), th2);
  for (int a = 0; a < d; ++a) r2[a] = m.tied ? A::mul(lam1, r1[a]) : th2;

  T log_prior = T(0);
  if (m.prior_code[0]) {
    T lp1;
    if (m.anisotropic) {
      lp1 = prior_kernel<T>(m.prior_code[0], m.prior_a[0], m.prior_b[0], r1[0]);
      for (int a = 1; a < d; ++a)
        lp1 = A::add(lp1, prior_kernel<T>(m.prior_code[0], m.prior_a[0],
                                          m.prior_b[0], r1[a]));
    } else {
      lp1 = prior_kernel<T>(m.prior_code[0], m.prior_a[0], m.prior_b[0], theta1);
    }
    log_prior = A::add(log_prior, lp1);
  }
  if (m.prior_code[1])
    log_prior = A::add(log_prior, prior_kernel<T>(m.prior_code[1], m.prior_a[1],
                                                  m.prior_b[1], th2));
  if (m.prior_code[2])
    log_prior = A::add(log_prior, prior_kernel<T>(m.prior_code[2], m.prior_a[2],
                                                  m.prior_b[2], p));
  extra = A::add(log_jac, log_prior);
  const T q = A::sub(T(1), p);
  const T s = A::add(A::mul(p, p), A::mul(q, q));
  log_scale = A::log_(A::mul(s, s2));
}

template <typename T, bool SMEM>
__global__ void __launch_bounds__(NT)
mh_rounds_kernel(const T* __restrict__ x, const T* __restrict__ y,
                 const T* __restrict__ z0, const T* __restrict__ st,
                 const T* __restrict__ deltas, const T* __restrict__ log_u,
                 T* __restrict__ rec, int* __restrict__ info,
                 T* __restrict__ stash, T* __restrict__ ws,
                 const CandModel model, int n, int d, int dim, int R, int K,
                 T jitter, T n_log2pi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using A = Ar<T>;
  // candidate k is s_z + deltas[r, k], recomputed where it is read (a
  // K x MAX_DIM copy would not fit the 48 KB of static shared memory in f64)
  __shared__ T s_z[MAX_DIM];
  __shared__ T s_r1[MAX_K][MAX_D];
  __shared__ T s_r2[MAX_K][MAX_D];
  __shared__ T s_w1[MAX_K], s_w2[MAX_K], s_ws[MAX_K];
  __shared__ T s_extra[MAX_K], s_logscale[MAX_K];
  __shared__ T s_ld[MAX_K], s_qyy[MAX_K], s_qoy[MAX_K], s_qoo[MAX_K];
  __shared__ T s_dinv[2 * MAX_K];   // pivot rsqrt, double-buffered by pivot
  __shared__ T s_lpv, s_lpb;
  __shared__ int s_sel;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t nn = (size_t)n * (n + 1) / 2;
  // K packed upper triangles, the right-hand sides (downdated), L^-1 y,
  // L^-1 1 and the rsqrt of each pivot
  const Factors<T> f(SMEM ? (T*)smem_raw : ws, n, K, s_ld, s_qyy, s_qoy,
                     s_qoo, s_dinv);
  T* M = f.M;
  const T s2 = st[2];

  for (int c = tid; c < dim; c += NT) s_z[c] = z0[c];
  if (tid == 0) {
    s_lpv = st[0];
    s_lpb = st[1];
  }
  __syncthreads();

  for (int r = 0; r < R; ++r) {
    // 1. candidates and their model terms
    if (tid < K) {
      const int k = tid;
      const T* dl = deltas + ((size_t)r * K + k) * dim;
      T p, extra, ls;
      cand_model<T>(model, s_z, dl, s2, s_r1[k], s_r2[k], p, extra, ls);
      const T q = A::sub(T(1), p);
      s_w1[k] = A::mul(p, p);
      s_w2[k] = A::mul(q, q);
      s_ws[k] = A::add(s_w1[k], s_w2[k]);
      s_extra[k] = extra;
      s_logscale[k] = ls;
    }
    __syncthreads();

    // 2. the K Grams (upper triangles) and right-hand sides
    build_se_mix_grams<T>(f, x, y, s_r1, s_r2, s_w1, s_w2, s_ws, n, d, K,
                          jitter);
    __syncthreads();

    // 3.-4. right-looking factorization, forward solve, quadratics
    factor_quadratics<T>(f, n, K);

    // 5. log-posteriors and the first-acceptance scan
    if (tid == 0) {
      T val_sel = T(0), beta_sel = T(0);
      const int sel = logpost_first_acceptance<T>(
          f, s_extra, s_logscale, log_u + (size_t)r * K, s_lpv, n, K,
          n_log2pi, val_sel, beta_sel);
      if (sel >= 0) {
        const T* dl = deltas + ((size_t)r * K + sel) * dim;
        for (int c = 0; c < dim; ++c) s_z[c] = A::add(s_z[c], dl[c]);
        s_lpv = val_sel;
        s_lpb = beta_sel;
      }
      T* rr = rec + (size_t)r * (dim + 2);
      for (int c = 0; c < dim; ++c) rr[c] = s_z[c];
      rr[dim] = s_lpb;
      rr[dim + 1] = s_lpv;
      info[2 * r] = sel >= 0 ? 1 : 0;
      info[2 * r + 1] = sel >= 0 ? sel + 1 : K;
      s_sel = sel;
    }
    __syncthreads();

    // 6. the accepted candidate's factors
    const int sel = s_sel;
    if (stash != nullptr && sel >= 0) {
      T* out = stash + (size_t)r * (n + 2) * n;
      const T* Ms = M + (size_t)sel * nn;
      for (int row = warp; row < n + 2; row += WARPS) {
        T* o = out + (size_t)row * n;
        if (row < n) {
          const T dinv = f.DINV[(size_t)sel * n + row];
          for (int c = lane; c < n; c += 32)
            o[c] = c >= row ? A::mul(Ms[rowbase(row, n) + c], dinv) : T(0);
        } else {
          const T* v = (row == n ? f.WY : f.WO) + (size_t)sel * n;
          for (int c = lane; c < n; c += 32) o[c] = v[c];
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, const void* y, const void* z, const void* st,
           const void* deltas, const void* log_u, void* rec, void* info,
           void* stash, void* ws, const void* model, int n, int d, int dim,
           int R, int K, double jitter, void* stream) {
  if (K < 1 || K > MAX_K || d < 1 || d > MAX_D || dim > MAX_DIM || n < 1)
    return (int)cudaErrorInvalidValue;
  const CandModel m = *(const CandModel*)model;
  const T n_log2pi = (T)(n * 1.8378770664093453);   // n * log(2 pi)
  // the workspace goes to shared memory when it fits beside the static
  // arrays (see workspace_elems for its size)
  cudaStream_t s = (cudaStream_t)stream;
  return launch_smem_or_global(
      mh_rounds_kernel<T, true>, mh_rounds_kernel<T, false>,
      workspace_elems(n, K) * sizeof(T), [&](auto kern, size_t bytes) {
        kern<<<1, NT, bytes, s>>>(
            (const T*)x, (const T*)y, (const T*)z, (const T*)st,
            (const T*)deltas, (const T*)log_u, (T*)rec, (int*)info,
            (T*)stash, (T*)ws, m, n, d, dim, R, K, (T)jitter, n_log2pi);
      });
}

}  // namespace

extern "C" int ccgp_mh_rounds_f32(const void* x, const void* y, const void* z,
                                  const void* st, const void* deltas,
                                  const void* log_u, void* rec, void* info,
                                  void* stash, void* ws, const void* model,
                                  int n, int d, int dim, int R, int K,
                                  double jitter, void* stream) {
  return launch<float>(x, y, z, st, deltas, log_u, rec, info, stash, ws, model,
                       n, d, dim, R, K, jitter, stream);
}

extern "C" int ccgp_mh_rounds_f64(const void* x, const void* y, const void* z,
                                  const void* st, const void* deltas,
                                  const void* log_u, void* rec, void* info,
                                  void* stash, void* ws, const void* model,
                                  int n, int d, int dim, int R, int K,
                                  double jitter, void* stream) {
  return launch<double>(x, y, z, st, deltas, log_u, rec, info, stash, ws,
                        model, n, d, dim, R, K, jitter, stream);
}
